"""Communication wall-clock model of the paper's Sec. V simulations.

The port's own copy of ``src/repro/core/comm_model.py`` (pure numpy).

The paper emulates a 1 Gbps / 5 ms network: per AGREE message
    t_comm = 5·10⁻³ + 8·d·r / 10⁹ + jitter   seconds
(double precision, 8 bytes/entry), with parallel send/receive — only the
max over a node's concurrent transfers counts.  We reproduce that model so
Fig. 1/2 "execution time" x-axes are comparable, and extend it with the
TPU-fabric constants used by the roofline analysis (50 GB/s/link ICI) so
the same experiment can be re-costed on the production target.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    bandwidth_bytes: float = 1e9 / 8     # 1 Gbps, in bytes/s
    latency_s: float = 5e-3
    jitter_std_s: float = 2e-4
    bytes_per_entry: int = 8             # double precision

    def message_time(self, n_entries: int, rng: np.random.Generator | None
                     = None, bytes_per_entry: int | None = None) -> float:
        """t_comm for one message of ``n_entries`` scalars (paper Sec. V).
        ``bytes_per_entry`` overrides the model's native wire precision
        for compressed payloads (a CommSignature's f32/bf16/int8 wire)."""
        bpe = self.bytes_per_entry if bytes_per_entry is None \
            else bytes_per_entry
        t = self.latency_s + bpe * n_entries / self.bandwidth_bytes
        if rng is not None and self.jitter_std_s > 0:
            t += float(abs(rng.normal(0.0, self.jitter_std_s)))
        return t


ETHERNET_1GBPS = NetworkModel()                         # the paper's network
TPU_ICI = NetworkModel(bandwidth_bytes=50e9, latency_s=1e-6,
                       jitter_std_s=0.0, bytes_per_entry=2)   # bf16 on ICI


def agree_round_time(d: int, r: int, max_deg: int, model: NetworkModel,
                     rng: np.random.Generator | None = None,
                     parallel: bool = True, *, n_entries: int | None = None,
                     bytes_per_entry: int | None = None) -> float:
    """Wall-clock of ONE gossip round exchanging a message with every
    neighbour — a dense d×r matrix unless ``n_entries`` /
    ``bytes_per_entry`` describe a compressed payload.  With parallel
    send/receive (the paper's assumption) only the slowest concurrent
    message counts; otherwise they serialize."""
    n = d * r if n_entries is None else n_entries
    times = [model.message_time(n, rng, bytes_per_entry=bytes_per_entry)
             for _ in range(max_deg)]
    return max(times) if parallel else sum(times)


def agree_round_time_degrees(d: int, r: int, degrees, model: NetworkModel,
                             rng: np.random.Generator | None = None, *,
                             n_entries: int | None = None,
                             bytes_per_entry: int | None = None) -> float:
    """Degree-weighted gossip round: node g exchanges ``degrees[g]``
    messages — one per incident edge, Σ_g deg_g = 2·|E| wire messages
    total, derived from the (sparse) edge set instead of a uniform
    ``max_deg`` assumption — and the synchronous round barrier is the
    max over every message."""
    n = d * r if n_entries is None else n_entries
    t = 0.0
    for deg in degrees:
        for _ in range(int(deg)):
            t = max(t, model.message_time(n, rng,
                                          bytes_per_entry=bytes_per_entry))
    return t


def decentralized_time_axis(n_iters: int, T_con: int, d: int, r: int,
                            max_deg: int, compute_time_per_iter: float,
                            model: NetworkModel = ETHERNET_1GBPS,
                            seed: int = 0, *, n_entries: int | None = None,
                            bytes_per_entry: int | None = None,
                            rng: np.random.Generator | None = None,
                            degrees=None) -> np.ndarray:
    """Cumulative wall-clock after each outer iteration for a decentralized
    run: per iteration, T_con gossip rounds + local compute.  ``rng``
    threads a caller-seeded generator (e.g. ``CommSpec.rng()``) through
    every jitter draw; without one, ``seed`` builds it here — either way
    the axis is reproducible.  ``degrees`` (per-node, from the graph's
    edge set) switches the round pricing to the degree-weighted message
    count of :func:`agree_round_time_degrees`."""
    rng = np.random.default_rng(seed) if rng is None else rng

    def round_time():
        if degrees is not None:
            return agree_round_time_degrees(
                d, r, degrees, model, rng, n_entries=n_entries,
                bytes_per_entry=bytes_per_entry)
        return agree_round_time(d, r, max_deg, model, rng,
                                n_entries=n_entries,
                                bytes_per_entry=bytes_per_entry)

    per_iter = np.array([
        sum(round_time() for _ in range(T_con)) + compute_time_per_iter
        for _ in range(n_iters)])
    return np.cumsum(per_iter)


def time_axis_from_signature(sig, n_iters: int, d: int, r: int, L: int,
                             max_deg: int, compute_s_per_iter: float,
                             model: NetworkModel = ETHERNET_1GBPS,
                             seed: int = 0, *,
                             rng: np.random.Generator | None = None,
                             degrees=None) -> np.ndarray:
    """Price a solver's wall-clock axis from its CombineRule
    :class:`~repro_torch.distributed.consensus.CommSignature`: ``"central"``
    is a gather + broadcast per iteration, ``"none"`` is compute only,
    and the decentralized patterns cost ``rounds_per_iter`` gossip
    rounds with every neighbour.  The signature's payload fields
    (``entries_per_round``/``bytes_per_entry``) override the dense d×r
    exchange at the model's native precision, so compressed combine
    rules price their actual wire format.  ``rng`` threads one seeded
    generator through every jitter draw (``seed`` builds one
    otherwise).  ``degrees`` prices each round's message count from the
    graph's edge set (2·|E| messages, degree-weighted) instead of the
    uniform ``max_deg`` — dense and sparse representations of the same
    graph report identical degrees, so their axes agree draw for draw
    (the pricing-consistency regression)."""
    if sig.pattern == "central":
        return centralized_time_axis(n_iters, d, r, L, compute_s_per_iter,
                                     model=model, seed=seed, rng=rng)
    if sig.pattern == "none" or sig.rounds_per_iter == 0:
        return np.cumsum(np.full(n_iters, compute_s_per_iter))
    return decentralized_time_axis(
        n_iters, sig.rounds_per_iter, d, r, max_deg, compute_s_per_iter,
        model=model, seed=seed, rng=rng,
        n_entries=getattr(sig, "entries_per_round", None),
        bytes_per_entry=getattr(sig, "bytes_per_entry", None),
        degrees=degrees)


def centralized_time_axis(n_iters: int, d: int, r: int, L: int,
                          compute_time_per_iter: float,
                          model: NetworkModel = ETHERNET_1GBPS,
                          seed: int = 0, *,
                          rng: np.random.Generator | None = None
                          ) -> np.ndarray:
    """Centralized AltGDmin: one gather of gradients (L parallel uploads) +
    one broadcast of U per iteration."""
    rng = np.random.default_rng(seed) if rng is None else rng
    per_iter = np.array([
        max(model.message_time(d * r, rng) for _ in range(L))     # gather
        + max(model.message_time(d * r, rng) for _ in range(L))   # broadcast
        + compute_time_per_iter
        for _ in range(n_iters)])
    return np.cumsum(per_iter)
