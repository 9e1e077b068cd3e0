"""Admission control + deadline batching for the serving engine.

Port of ``src/repro/serving/queue.py``.  The serving loop is a
discrete-event simulation of a single-server batching frontend, the
standard datacenter shape (max_batch × max_wait deadline batcher over a
bounded FIFO):

  * requests arrive on a (seeded) Poisson process, carrying few-shot
    personalization data (X_new, y_new) drawn from the paper's model
    y = X U* b* + noise — the closed-loop generator below;
  * a batch launches when ``max_batch`` requests are queued OR the
    oldest queued request has waited ``max_wait_s``, whichever first
    (never before the server is free — one outstanding batch);
  * the queue is bounded: an arrival that lands on a full queue is
    SHED (counted, never silently dropped);
  * between batches the loop polls an optional hot-swap source for a
    fresher representation (the drifting-U continual mode).

Time is virtual for arrivals/queueing (deterministic, seeded) while the
service time of each batch is either MEASURED wall-clock of the actual
packed solve (the benchmark mode) or a supplied model (the deterministic
test mode).  Per-request telemetry — queue wait, end-to-end latency,
batch size, the U version that served it, and the recovery error when
ground truth is attached — comes back as :class:`ServeRecord` rows.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass
class ServeRequest:
    """One few-shot personalization request."""
    rid: int
    X: np.ndarray                    # (T_new, d) user design
    y: np.ndarray                    # (T_new,) responses
    t_arrival: float                 # seconds on the virtual clock
    theta_star: Optional[np.ndarray] = None   # (d,) ground truth, if known


@dataclasses.dataclass
class ServeRecord:
    """Per-request telemetry emitted by :func:`run_closed_loop`."""
    rid: int
    t_arrival: float
    t_launch: float
    t_done: float
    batch_size: int
    version: int                     # U checkpoint step that served it
    err: Optional[float] = None      # ||Ub̂ − θ*|| / ||θ*||

    @property
    def latency(self) -> float:
        return self.t_done - self.t_arrival

    @property
    def queue_wait(self) -> float:
        return self.t_launch - self.t_arrival


@dataclasses.dataclass
class ServeReport:
    """One closed-loop run: telemetry + counters."""
    records: list
    n_shed: int
    depth_trace: list                # queue depth sampled at each launch
    batch_sizes: list

    def latency_percentiles(self, qs=(50, 99)):
        lat = np.array([r.latency for r in self.records])
        return {f"p{q}": float(np.percentile(lat, q)) for q in qs}

    @property
    def mean_err(self) -> float:
        errs = [r.err for r in self.records if r.err is not None]
        return float(np.mean(errs)) if errs else float("nan")


class RequestGenerator:
    """Seeded closed-loop load: new users drawn from the paper's model.

    Each request is a fresh task θ* = U* b* with b* ~ N(0, I_r), a
    Gaussian design X ∈ R^{T_new × d}, and y = X θ* + noise.  ``t_new``
    may be an int (uniform) or a sequence to sample from (heterogeneous
    few-shot budgets — the ragged-batch path).  Arrivals are Poisson at
    ``rate_hz`` on the virtual clock."""

    def __init__(self, U_star, *, t_new=16, rate_hz: float = 200.0,
                 noise_std: float = 0.0, seed: int = 0):
        self.U_star = (U_star.detach().cpu().numpy()
                       if torch.is_tensor(U_star) else np.asarray(U_star))
        self.t_new = (t_new,) if isinstance(t_new, int) else tuple(t_new)
        self.rate_hz = float(rate_hz)
        self.noise_std = float(noise_std)
        self.rng = np.random.default_rng(seed)
        self._clock = 0.0
        self._next_rid = 0

    def generate(self, n: int) -> list:
        d, r = self.U_star.shape
        out = []
        for _ in range(n):
            self._clock += self.rng.exponential(1.0 / self.rate_hz)
            t_i = int(self.rng.choice(self.t_new))
            b_star = self.rng.standard_normal(r)
            theta = self.U_star @ b_star
            X = self.rng.standard_normal((t_i, d))
            y = X @ theta
            if self.noise_std > 0:
                y = y + self.noise_std * self.rng.standard_normal(t_i)
            out.append(ServeRequest(rid=self._next_rid, X=X, y=y,
                                    t_arrival=self._clock,
                                    theta_star=theta))
            self._next_rid += 1
        return out


def run_closed_loop(engine, requests, *, max_batch: int | None = None,
                    max_wait_s: float = 2e-3, queue_capacity: int = 256,
                    swap_source=None,
                    service_time: Optional[Callable[[int], float]] = None
                    ) -> ServeReport:
    """Drive ``engine`` through the deadline batcher over ``requests``.

    ``service_time``: None → measure the wall-clock of each packed solve
    (benchmark mode); a callable ``batch_size -> seconds`` makes the
    whole simulation deterministic (test mode; the solve still runs so
    recovery errors are real).  ``swap_source`` (an object with
    ``poll() -> (step, U) | None``, e.g.
    :class:`repro_torch.serving.publisher.HotSwapSource`) is consulted
    before each batch launch — the drifting-U mode."""
    max_batch = engine.max_batch if max_batch is None else max_batch
    if max_batch > engine.max_batch:
        raise ValueError(f"max_batch={max_batch} exceeds the engine's "
                         f"packed capacity {engine.max_batch}")
    if queue_capacity < max_batch:
        raise ValueError(f"queue_capacity={queue_capacity} cannot hold "
                         f"one full batch of {max_batch}")
    arr = sorted(requests, key=lambda q: q.t_arrival)
    q: deque = deque()
    i = 0                       # next arrival index
    t_free = 0.0                # server free time
    n_shed = 0
    records, depth_trace, batch_sizes = [], [], []

    def admit_until(t, shed_overflow=True):
        nonlocal i, n_shed
        while i < len(arr) and arr[i].t_arrival <= t:
            if len(q) < queue_capacity:
                q.append(arr[i])
            elif shed_overflow:
                n_shed += 1
            i += 1

    while i < len(arr) or q:
        if not q:                       # idle: jump to the next arrival
            admit_until(arr[i].t_arrival)
        # batching window: launch at max_batch or the head's deadline
        if len(q) < max_batch:
            deadline = max(t_free, q[0].t_arrival + max_wait_s)
            while len(q) < max_batch and i < len(arr) \
                    and arr[i].t_arrival <= deadline:
                q.append(arr[i])
                i += 1
        # full → launch the moment the max_batch-th request landed (or
        # the server freed); short → launch at the head's deadline
        t_launch = (max(t_free, q[max_batch - 1].t_arrival)
                    if len(q) >= max_batch else deadline)
        batch = [q.popleft() for _ in range(min(max_batch, len(q)))]
        depth_trace.append(len(q))
        batch_sizes.append(len(batch))

        if swap_source is not None:     # drifting U: between batches only
            fresh = swap_source.poll()
            if fresh is not None:
                step, U = fresh
                engine.update_representation(U, version=step)

        t0 = time.perf_counter()
        B, theta, version = engine.solve([b.X for b in batch],
                                         [b.y for b in batch])
        if B.is_cuda:                   # the service time covers the work
            torch.cuda.synchronize(B.device)
        measured = time.perf_counter() - t0
        service = measured if service_time is None \
            else float(service_time(len(batch)))
        t_done = t_launch + service
        t_free = t_done
        theta = theta.to(torch.float64).cpu().numpy()
        for j, req in enumerate(batch):
            err = None
            if req.theta_star is not None:
                err = float(np.linalg.norm(theta[j] - req.theta_star)
                            / max(np.linalg.norm(req.theta_star), 1e-30))
            records.append(ServeRecord(
                rid=req.rid, t_arrival=req.t_arrival, t_launch=t_launch,
                t_done=t_done, batch_size=len(batch), version=version,
                err=err))
        # arrivals that landed while the batch was in flight
        admit_until(t_done)

    records.sort(key=lambda rec: rec.rid)
    return ServeReport(records=records, n_shed=n_shed,
                       depth_trace=depth_trace, batch_sizes=batch_sizes)
