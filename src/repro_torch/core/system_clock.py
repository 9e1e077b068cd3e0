"""Event-driven simulated wall-clock for the system-realism layer.

The port's own copy of ``src/repro/core/system_clock.py`` (pure numpy:
the same seeded draws in the same order, so its axes equal the
reference's bit for bit).

The closed-form pricing of :mod:`repro_torch.core.comm_model` assumes every
node computes in lockstep and every gossip round costs one max-over-
neighbours message time — adequate for the paper's Sec. V figures, but
unable to express stragglers, heterogeneous compute, or nodes that drop
out mid-run.  This module replaces it (whenever an
:class:`~repro_torch.api.spec.SystemSpec` is present on the experiment) with a
genuine discrete-event simulation: a priority queue of compute-completion
and message-delivery events, advanced per outer iteration.

Semantics, mirroring what the solvers actually execute:

  * the OUTER iteration is a barrier (the drivers are synchronous
    loop steps): iteration τ+1 starts when the slowest LIVE node
    finishes iteration τ;
  * within an iteration, a live node first computes (base
    ``compute_s_per_iter`` × its speed multiplier × an optional
    straggler factor), then runs ``rounds_per_iter`` gossip rounds; its
    round-ρ sends leave when it has BOTH finished round ρ−1 and received
    every round-(ρ−1) message from its live neighbours (per-link wire
    times, jittered individually — the event-driven part: one slow link
    delays exactly its receivers, not the whole fleet);
  * nodes that are down this iteration send nothing, receive nothing,
    and do not gate the barrier (an all-down iteration prices one bare
    compute tick);
  * ``send_fraction`` (the event rule's measured per-iteration trigger
    rate) makes each message pay its wire time only with that
    probability — a skipped re-broadcast still gates round progression
    (gossip is synchronous) but crosses no wire.

Degenerate anchor: with availability ≡ 1, unit speeds, no stragglers
and zero jitter, every round costs exactly ``latency + bytes/bandwidth``
and the axis equals ``comm_model.decentralized_time_axis`` to the last
bit; with jitter the two agree within the jitter scale (both draw from
the same model, in different orders).
"""
from __future__ import annotations

import heapq

import numpy as np

from repro_torch.core.comm_model import NetworkModel


def _iteration_seconds(live, neighbors, rounds: int, compute, model,
                       n_entries: int, bytes_per_entry, rng,
                       send_fraction) -> float:
    """One outer iteration's simulated duration (the barrier: max over
    live nodes' finish times).  ``live``: node ids up this iteration;
    ``compute``: {node: seconds until its sends can start};
    ``neighbors``: {node: live neighbour ids}."""
    if not live:
        # every node down: the barrier still ticks one bare compute unit
        return float(max(compute.values(), default=0.0))
    if rounds == 0:
        return float(max(compute[g] for g in live))

    need = {g: len(neighbors[g]) for g in live}
    got = {(g, rd): 0 for g in live for rd in range(rounds)}
    latest = {(g, rd): 0.0 for g in live for rd in range(rounds)}
    ready = {}                  # (g, rd) -> time node g entered round rd
    done = {}
    heap = []
    seq = 0
    for g in live:
        heapq.heappush(heap, (compute[g], seq, "ready", g, 0))
        seq += 1

    def advance(g, rd):
        """Node g leaves round rd once it entered it AND heard every
        live neighbour's round-rd message."""
        nonlocal seq
        if (g, rd) in ready and got[(g, rd)] == need[g]:
            t = max(ready[(g, rd)], latest[(g, rd)])
            heapq.heappush(heap, (t, seq, "ready", g, rd + 1))
            seq += 1
            got[(g, rd)] = -1               # fire once

    while heap:
        t, _, _, g, rd = heapq.heappop(heap)
        if rd == rounds:
            done.setdefault(g, t)
            continue
        if (g, rd) in ready:
            continue
        ready[(g, rd)] = t
        for j in neighbors[g]:
            wire = 0.0
            if send_fraction is None or rng is None \
                    or rng.random() < send_fraction:
                wire = model.message_time(n_entries, rng,
                                          bytes_per_entry=bytes_per_entry)
            arr = t + wire
            got[(j, rd)] += 1
            latest[(j, rd)] = max(latest[(j, rd)], arr)
            advance(j, rd)
        advance(g, rd)

    return float(max(done[g] for g in live))


def simulated_time_axis(*, avail: np.ndarray, rounds_per_iter: int,
                        adj: np.ndarray | None = None,
                        model: NetworkModel,
                        compute_s_per_iter: float,
                        speeds: np.ndarray | None = None,
                        straggler_prob: float = 0.0,
                        straggler_factor: float = 1.0,
                        n_entries: int, bytes_per_entry: int | None = None,
                        rng: np.random.Generator | None = None,
                        send_fraction: np.ndarray | None = None,
                        neighbors=None) -> np.ndarray:
    """Cumulative simulated seconds after each outer iteration.

    ``avail``: (T_GD, L) bool availability mask (the SAME array the
    dropout-tolerant solvers consume, so time and trajectory see one
    fault schedule); ``adj``: (L, L) 0/1 adjacency, or pass ``neighbors``
    (per-node neighbour-id lists, e.g. ``SparseGraph.neighbor_lists()``)
    to avoid densifying a large sparse topology; ``speeds``: per-node
    compute multipliers; ``send_fraction``: optional (T_GD,) measured
    per-iteration send rate (the event rule's telemetry) replacing the
    static always-send pricing.  ``rng`` drives jitter, stragglers and
    send coin-flips — pass a seeded generator for reproducible axes.
    """
    avail = np.asarray(avail, dtype=bool)
    n_iters, L = avail.shape
    if neighbors is not None:
        if len(neighbors) != L:
            raise ValueError(f"neighbor lists cover {len(neighbors)} nodes "
                             f"but the mask has {L}")
        all_nbrs = [list(map(int, ns)) for ns in neighbors]
    else:
        if adj is None:
            raise ValueError("simulated_time_axis needs either adj or "
                             "neighbors")
        adj = np.asarray(adj)
        if adj.shape != (L, L):
            raise ValueError(f"adjacency {adj.shape} does not match the "
                             f"mask's {L} nodes")
        all_nbrs = [np.nonzero(adj[g])[0].tolist() for g in range(L)]
    speeds = np.ones(L) if speeds is None else np.asarray(speeds, float)

    out = np.empty(n_iters)
    total = 0.0
    for t in range(n_iters):
        live = [g for g in range(L) if avail[t, g]]
        live_set = set(live)
        nbrs = {g: [j for j in all_nbrs[g] if j in live_set] for g in live}
        compute = {}
        for g in live:
            c = compute_s_per_iter * speeds[g]
            if straggler_prob > 0 and rng is not None \
                    and rng.random() < straggler_prob:
                c *= straggler_factor
            compute[g] = c
        if not live:
            compute = {0: compute_s_per_iter}
            nbrs = {}
            live_for_iter = []
        else:
            live_for_iter = live
        sf = None if send_fraction is None else float(send_fraction[t])
        total += _iteration_seconds(live_for_iter, nbrs, rounds_per_iter,
                                    compute, model, n_entries,
                                    bytes_per_entry, rng, sf)
        out[t] = total
    return out
