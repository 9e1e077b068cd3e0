"""Fused node-batched AltGDmin iteration engine.

Port of ``src/repro/core/engine.py``.  The simulator's hot loop
(Algorithm 3 lines 8–14) factors into three phases per outer iteration:
min-B (per-task least squares), the gradient of f_g w.r.t. U_g, and the
AGREE combine.  This module binds those phases to a backend:

  * ``torch-ref`` — the unfused plain paths below, dtype-preserving
                    (float64 stays float64); the numerics every other
                    backend is tested against;
  * ``cuda``      — one launch of the fused ``node_fused_iter`` kernel
                    per iteration (A = X_t U built once per task), the
                    final B through the ``node_task_gram`` kernel, and
                    AGREE as one ``mix_rows`` launch on the precomputed
                    ``W^{T_con}``.  On sample-split data (``n_folds >
                    1``) min-B and the gradient see different folds, so
                    an iteration is two launches: ``node_task_gram`` on
                    the min fold, ``node_task_grad_tiles`` on the
                    gradient fold.  The kernels compute in f32 at any
                    input dtype; their outputs are cast back to U's.

Backend selection: explicit argument → ``backend_scope`` →
``REPRO_TORCH_ENGINE_BACKEND`` → ``REPRO_TORCH_KERNEL_BACKEND`` → the
device: ``cuda`` for CUDA tensors, ``torch-ref`` for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.consensus import get_rule
from repro_torch.kernels import ops
from repro_torch.kernels.ref import solve_spd


# ----------------------------------------------------------------------
# reference phase implementations (the unfused simulator paths)
# ----------------------------------------------------------------------

def ref_minimize_B(U_nodes, Xg, yg):
    """Min step (Algorithm 3 line 8): column-wise least squares
    b_t = (X_t U_g)† y_t, batched over nodes and local tasks, via the
    normal equations and a Cholesky solve.  → (L, tpn, r)."""
    A = Xg @ U_nodes[:, None]                         # (L, tpn, n, r)
    G = A.mT @ A
    c = (A.mT @ yg[..., None])[..., 0]
    return solve_spd(G, c)


def ref_grad_U(U_nodes, B_nodes, Xg, yg):
    """Local gradient (Algorithm 3 line 11):
    ∇f_g = Σ_{t∈S_g} X_tᵀ (X_t U_g b_t − y_t) b_tᵀ.  → (L, d, r)."""
    resid = torch.einsum("gtnd,gdr,gtr->gtn", Xg, U_nodes, B_nodes) - yg
    return torch.einsum("gtnd,gtn,gtr->gdr", Xg, resid, B_nodes)


def default_engine_backend(device=None) -> str:
    """ops.default_backend's chain (override → env → device) with the
    engine's own env variable first."""
    return ops.default_backend(device, extra_env="REPRO_TORCH_ENGINE_BACKEND")


class AltgdminEngine:
    """Binds the AltGDmin phases to a backend.  Construct with
    ``backend=`` to choose, or leave None for env/device selection
    (``device`` is where the run's tensors live)."""

    def __init__(self, backend: str | None = None, *, device=None):
        if backend is None:
            backend = default_engine_backend(device)
        if backend not in ops.BACKENDS:
            raise ValueError(f"unknown engine backend {backend!r}; "
                             f"expected one of {ops.BACKENDS}")
        self.backend = backend

    @property
    def fused(self) -> bool:
        return self.backend != "torch-ref"

    # ------------------------------------------------------------ phases

    def minimize_B(self, U_nodes, Xg, yg):
        """(L, tpn, r) min-B solutions."""
        if not self.fused:
            return ref_minimize_B(U_nodes, Xg, yg)
        B = ops.altgdmin_node_minimize_B(Xg, U_nodes, yg,
                                         backend=self.backend)
        return B.to(U_nodes.dtype)

    def grad_U(self, U_nodes, B_nodes, Xg, yg):
        """(L, d, r) local gradients for a given B (sample-split path)."""
        if not self.fused:
            return ref_grad_U(U_nodes, B_nodes, Xg, yg)
        G = ops.altgdmin_node_gradient(Xg, U_nodes, B_nodes, yg,
                                       backend=self.backend)
        return G.to(U_nodes.dtype)

    def min_grad(self, U_nodes, X_min, y_min, X_grad, y_grad, *,
                 same_data: bool):
        """Min-B on (X_min, y_min) then ∇f on (X_grad, y_grad).  When both
        halves see the same data (the paper's simulations) the cuda
        backend does both in ONE kernel launch; otherwise A must be
        rebuilt on the gradient fold and the two-launch path runs."""
        if self.fused and same_data:
            B, G = ops.altgdmin_fused_step(X_min, U_nodes, y_min,
                                           backend=self.backend)
            return B.to(U_nodes.dtype), G.to(U_nodes.dtype)
        B = self.minimize_B(U_nodes, X_min, y_min)
        return B, self.grad_U(U_nodes, B, X_grad, y_grad)

    # ----------------------------------------------------------- combine

    def make_mixer(self, W, T_con: int, *, rule: str = "gossip"):
        """The AGREE phase as a callable Z ↦ consensus(Z), lowered by the
        named combine rule (torch-ref: the exact sequential product;
        cuda: one mix_rows launch on W^{T_con}, float64 kept exact)."""
        return get_rule(rule).make_sim_mixer(W, T_con, backend=self.backend)

    def make_neighbor_mixer(self, M):
        """DGD's row-stochastic neighbour average Z ↦ M Z (single round,
        no self weight — M comes in precomputed)."""
        return get_rule("neighbor").make_sim_mixer(M, backend=self.backend)

    def make_state_mixer(self, W, T_con: int, *, rule: str, **rule_kw):
        """Stateful combine for the compressed/event-triggered rules:
        ``(Z, state) ↦ (Z', state')``.  ``rule_kw`` carries the rule's
        spec knobs (``compression_k``, ``compression``,
        ``event_threshold``, ``consensus_gamma``); the state itself
        comes from the rule's ``init_state`` and rides the solver
        loop."""
        return get_rule(rule).make_sim_state_mixer(
            W, T_con, backend=self.backend, **rule_kw)


def resolve_engine(engine=None, backend: str | None = None, *,
                   device=None) -> AltgdminEngine:
    """Normalize the (engine, backend) pair: pass an engine through, else
    build one from ``backend``.  Passing both with disagreeing backends
    is an error."""
    if engine is not None:
        if backend is not None and backend != engine.backend:
            raise ValueError(
                f"conflicting engine selection: engine.backend="
                f"{engine.backend!r} but backend={backend!r}")
        return engine
    return AltgdminEngine(backend, device=device)
