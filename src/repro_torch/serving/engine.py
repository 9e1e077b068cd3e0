"""Batched min-B inference: the serving-side solve.

Port of ``src/repro/serving/engine.py``.  The learned low-rank basis U
turns a new user's d-dimensional regression into an r-dimensional one:
given the user's few-shot data (X_new, y_new), the personalized head is
b_new = (X_new U)† y_new — the min-B step of Algorithm 3 with one shared
U in place of the per-node bases.

:class:`ServingEngine` treats that solve as a request workload.  R
in-flight requests are padded and packed into ONE call of the training
engine's min-B path (:meth:`repro_torch.core.engine.AltgdminEngine.
minimize_B` at L = 1: one ``node_task_gram`` launch and a batched r×r
Cholesky on ``cuda``, the ``ref_minimize_B`` oracle on ``torch-ref``),
so serving is the training side's fold solve by construction.

Packing is exact, not approximate:

  * ragged sample counts (heterogeneous T_new) are right-padded with
    ZERO rows of X and y — a zero row adds exact zeros to the Gram AᵀA
    and to Aᵀy, so the padded solve equals the unpadded one bit for bit;
  * a short batch (R < max_batch) is padded with dummy slots that
    replicate request 0's design and carry y = 0 — their solution is
    exactly 0 and the Gram stays SPD (no NaN lanes), while the real
    slots are untouched.

Fixed padded shapes (``max_batch`` slots × bucketed T_new) keep the
operand shapes of a serving loop to a few (batch capacity, sample
bucket) pairs.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.api.runner import resolve_device
from repro_torch.core.engine import AltgdminEngine


def pack_requests(X_list, y_list, *, max_batch: int, pad_n_to: int = 8,
                  dtype=None, device=None):
    """Pad/pack R ragged requests into fixed-shape tensors.

    X_list[i]: (T_i, d); y_list[i]: (T_i,), arrays or tensors.  Returns
    (X (max_batch, n_pad, d), y (max_batch, n_pad), R) on ``device``
    (None: the card) in ``dtype`` (None: request 0's), where n_pad is
    the max T_i rounded up to a multiple of ``pad_n_to``.  Slots ≥ R
    replicate request 0's design with zero responses (solution exactly
    0, Gram SPD)."""
    R = len(X_list)
    if R == 0:
        raise ValueError("pack_requests needs at least one request")
    if R > max_batch:
        raise ValueError(f"got {R} requests but max_batch={max_batch}; "
                         f"the admission queue must cap batches")
    device = resolve_device(device)
    d = np.shape(X_list[0])[-1]
    n_pad = -(-max(np.shape(x)[0] for x in X_list) // pad_n_to) * pad_n_to
    dt = dtype or torch.as_tensor(X_list[0]).dtype
    X = torch.zeros((max_batch, n_pad, d), dtype=dt)
    y = torch.zeros((max_batch, n_pad), dtype=dt)
    for i, (Xi, yi) in enumerate(zip(X_list, y_list)):
        t = np.shape(Xi)[0]
        if np.shape(yi)[0] != t:
            raise ValueError(f"request {i}: X has {t} rows but y has "
                             f"{np.shape(yi)[0]}")
        X[i, :t] = torch.as_tensor(Xi, dtype=dt)
        y[i, :t] = torch.as_tensor(yi, dtype=dt)
    X[R:] = X[0]                       # dummy slots: SPD Gram, b = 0
    return X.to(device), y.to(device), R


class ServingEngine:
    """The frozen-or-drifting-U request solver.

    One instance holds the current representation U (d, r) and an
    :class:`AltgdminEngine` backend binding; :meth:`solve` is the
    request-facing entry (ragged list in, per-request b_new out) and
    :meth:`solve_packed` the fixed-shape hot path.
    :meth:`update_representation` hot-swaps U between batches (the
    drifting-U continual mode) under a lock, so a publisher thread can
    push while the serving loop drains.  U lives on its own device when
    it is a tensor, else on ``device`` (None: the card); requests are
    brought there.
    """

    def __init__(self, U, *, max_batch: int = 32, backend: str | None = None,
                 pad_n_to: int = 8, version: int = 0, device=None):
        self.device = (U.device if torch.is_tensor(U)
                       else resolve_device(device))
        self.engine = AltgdminEngine(backend, device=self.device)
        self.max_batch = int(max_batch)
        self.pad_n_to = int(pad_n_to)
        self._lock = threading.Lock()
        self.n_dispatches = 0
        self.n_requests = 0
        self.update_representation(U, version=version)

    # ------------------------------------------------------------ U life

    def update_representation(self, U, *, version: int | None = None):
        """Hot-swap the representation (e.g. a fresher checkpoint)."""
        U = torch.as_tensor(U, device=self.device)
        if U.ndim != 2:
            raise ValueError(f"serving wants a single (d, r) basis, got "
                             f"shape {tuple(U.shape)}")
        with self._lock:
            self.U = U
            if version is not None:
                self.version = int(version)

    @property
    def d(self) -> int:
        return self.U.shape[0]

    @property
    def r(self) -> int:
        return self.U.shape[1]

    # ------------------------------------------------------------ solve

    def _current(self):
        with self._lock:
            return self.U, self.version

    def _dispatch(self, U, X, y):
        # the training-side min-B path verbatim: one node, R tasks
        B = self.engine.minimize_B(U[None], X[None], y[None])[0]
        self.n_dispatches += 1
        return B

    def solve_packed(self, X, y):
        """Fixed-shape hot path.  X: (R, n, d); y: (R, n) → (b (R, r),
        version).  Rows beyond a request's true T_new must be zero
        (exact padding); the training engine's fold solve."""
        U, version = self._current()
        X, y = (torch.as_tensor(t, device=U.device) for t in (X, y))
        B = self._dispatch(U, X, y)
        self.n_requests += X.shape[0]
        return B, version

    def solve(self, X_list, y_list):
        """Ragged request list in, per-request solutions out.

        Returns (B (R, r), theta (R, d), version): b_new per request and
        the personalized regressors θ̂ = U b_new (the basis-invariant
        quantity a drifting U is scored on), both from the one U the
        batch was solved with."""
        U, version = self._current()
        for i, Xi in enumerate(X_list):
            if np.shape(Xi)[0] < U.shape[1]:
                raise ValueError(
                    f"request {i} has T_new={np.shape(Xi)[0]} < "
                    f"r={U.shape[1]} samples; the r-dimensional system is "
                    f"underdetermined")
        X, y, R = pack_requests(X_list, y_list, max_batch=self.max_batch,
                                pad_n_to=self.pad_n_to, dtype=U.dtype,
                                device=U.device)
        B = self._dispatch(U, X, y)[:R]
        self.n_requests += R                       # real requests only
        return B, B @ U.T, version
