"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its CUDA kernel computes, with ordinary
tensor operations, and is what the ``torch-ref`` backend runs: on CPU
tensors by default, and on the card where a caller asks for it by name
(the chip smoke check compares every kernel with its plain version on
the same inputs).  Deliberately naive — clarity over speed.

Node-batched layouts, as the kernels take them: X (L, tpn, n, d),
U (L, d, r), y (L, tpn, n).  The least-squares functions compute in
float32 whatever the input dtype, as the kernels do.
"""
from __future__ import annotations

import torch

f32 = torch.float32


def ref_task_gram(X, U, y):
    """Per task: A = X_t U_g, G = AᵀA, c = Aᵀy_t.
    → G (L, tpn, r, r), c (L, tpn, r), float32."""
    A = X.to(f32) @ U.to(f32)[:, None]                  # (L, tpn, n, r)
    G = A.mT @ A
    c = (A.mT @ y.to(f32)[..., None])[..., 0]
    return G, c


def solve_spd(G, c):
    """b = G⁻¹c for a batch of SPD systems (Cholesky; no host sync)."""
    Lc, _ = torch.linalg.cholesky_ex(G)
    return torch.cholesky_solve(c[..., None], Lc)[..., 0]


def ref_grad_tiles(X, U, B, y):
    """Per task the gradient contribution X_tᵀ(X_t U_g b_t − y_t) b_tᵀ.
    → (L, tpn, d, r), float32."""
    Xf, Bf = X.to(f32), B.to(f32)
    resid = ((Xf @ U.to(f32)[:, None]) @ Bf[..., None])[..., 0] - y.to(f32)
    return (Xf.mT @ resid[..., None]) * Bf[:, :, None, :]


def ref_altgdmin_grad(X, U, B, y):
    """∇f_g = Σ_t X_tᵀ(X_t U_g b_t − y_t) b_tᵀ → (L, d, r), float32."""
    return ref_grad_tiles(X, U, B, y).sum(dim=1)


def ref_fused_iter(X, U, y):
    """What ``node_fused_iter`` computes: the min-B solutions and the
    per-task gradient tiles.  → B (L, tpn, r), tiles (L, tpn, d, r)."""
    B = solve_spd(*ref_task_gram(X, U, y))
    return B, ref_grad_tiles(X, U, B, y)


def ref_mix_rows(W, Z):
    """Z ← W Z over the leading node axis, f32 accumulation, Z's dtype
    out.  W (L, L); Z (L, M)."""
    return (W.to(f32) @ Z.to(f32)).to(Z.dtype)
