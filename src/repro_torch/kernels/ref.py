"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its CUDA kernel computes, with ordinary
tensor operations, and is what the ``torch-ref`` backend runs: on CPU
tensors by default, and on the card where a caller asks for it by name
(the chip smoke check compares every kernel with its plain version on
the same inputs).  Deliberately naive — clarity over speed.

Node-batched layouts, as the kernels take them: X (L, tpn, n, d),
U (L, d, r), y (L, tpn, n).  The least-squares functions compute in
float32 whatever the input dtype, as the kernels do.  The wire-
compression functions take node blocks M (N, d, r) and keep the
operand's precision where the kernels take f32 (float64 operands never
reach those kernels).
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


def ref_node_grad_tiles(X, U, B, y):
    """What ``node_task_grad_tiles`` computes: per task, for a given B,
    the gradient contribution X_tᵀ(X_t U_g b_t − y_t) b_tᵀ.
    → (L, tpn, d, r), float32."""
    Xf, Bf = X.to(f32), B.to(f32)
    resid = ((Xf @ U.to(f32)[:, None]) @ Bf[..., None])[..., 0] - y.to(f32)
    return (Xf.mT @ resid[..., None]) * Bf[:, :, None, :]


def ref_altgdmin_grad(X, U, B, y):
    """∇f_g = Σ_t X_tᵀ(X_t U_g b_t − y_t) b_tᵀ → (L, d, r), float32."""
    return ref_node_grad_tiles(X, U, B, y).sum(dim=1)


def ref_fused_iter(X, U, y):
    """What ``node_fused_iter`` computes: the min-B solutions and the
    per-task gradient tiles.  → B (L, tpn, r), tiles (L, tpn, d, r)."""
    B = solve_spd(*ref_task_gram(X, U, y))
    return B, ref_node_grad_tiles(X, U, B, y)


def ref_mix_rows(W, Z):
    """Z ← W Z over the leading node axis, f32 accumulation, Z's dtype
    out.  W (L, L); Z (L, M)."""
    return (W.to(f32) @ Z.to(f32)).to(Z.dtype)


def ref_gossip_combine(z, neighbors, weights):
    """z ← w₀·z + Σ_k w_{k+1}·neighbors[k]: float32 weights and
    accumulation, the sum taken over k in order, z's dtype out.  z of
    any shape; neighbors (K, *z.shape); weights (K+1,), a sequence of
    Python floats or a tensor on z's device."""
    w = torch.as_tensor(weights, dtype=f32, device=z.device)
    acc = w[0] * z.to(f32)
    for k in range(neighbors.shape[0]):
        acc = acc + w[k + 1] * neighbors[k].to(f32)
    return acc.to(z.dtype)


def ref_compress_topk(M, k: int):
    """What ``compress_topk`` computes: per (d, r) block the k rows of
    largest squared row norm, descending, ties to the lowest index.
    The norms are summed over r in column order, in float32 for float32
    and bfloat16 blocks and in float64 for float64 ones, so the kernel
    matches this bit for bit; the stable sort keeps equal norms in index
    order.  M (N, d, r) → (vals (N, k, r) in M's dtype, idx (N, k)
    int32)."""
    Mf = M.to(torch.promote_types(M.dtype, f32))
    s = Mf[..., 0] * Mf[..., 0]
    for c in range(1, M.shape[-1]):
        s = s + Mf[..., c] * Mf[..., c]
    order = torch.sort(s, dim=-1, descending=True, stable=True).indices
    idx = order[:, :k]
    vals = torch.gather(M, 1, idx[..., None].expand(-1, -1, M.shape[2]))
    return vals, idx.to(torch.int32)


def ref_dequant(q, scale):
    """What ``dequant`` computes: the int8 wire payload decoded as
    q · scale per node block, in the scale's dtype.  q (N, d, r);
    scale (N, 1, 1)."""
    return q.to(scale.dtype) * scale
