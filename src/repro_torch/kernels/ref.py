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
reach those kernels).  The LM kernels' versions, ``ref_attention`` and
``ref_ssd``, compute in float32 and return the operand's dtype, as the
kernels do.
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


def ref_single_task_gram(X, U, y):
    """What ``task_gram`` computes: the Gram pairs of T tasks against
    ONE basis.  X (T, n, d), U (d, r), y (T, n) → G (T, r, r),
    c (T, r), float32 (the node-batched version at L = 1)."""
    G, c = ref_task_gram(X[None], U[None], y[None])
    return G[0], c[0]


def ref_single_grad_tiles(X, U, B, y):
    """What ``task_grad_tiles`` computes: per task, for a given B and
    ONE basis, X_tᵀ(X_t U b_t − y_t) b_tᵀ.  X (T, n, d), U (d, r),
    B (T, r), y (T, n) → (T, d, r), float32."""
    return ref_node_grad_tiles(X[None], U[None], B[None], y[None])[0]


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
    order and puts a NaN norm above every number, as ``lax.top_k`` does
    in the JAX package's version.  M (N, d, r) → (vals (N, k, r) in
    M's dtype, idx (N, k) int32)."""
    Mf = M.to(torch.promote_types(M.dtype, f32))
    s = Mf[..., 0] * Mf[..., 0]
    for c in range(1, M.shape[-1]):
        s = s + Mf[..., c] * Mf[..., c]
    order = torch.sort(s, dim=-1, descending=True, stable=True).indices
    idx = order[:, :k]
    vals = torch.gather(M, 1, idx[..., None].expand(-1, -1, M.shape[2]))
    return vals, idx.to(torch.int32)


TOPK_SPECIAL_KINDS = ("nan_few", "nan_many", "inf", "equal", "ties")


def topk_special_block(M, kind: str):
    """A copy of the (N, d, r) float block M whose row norms test the
    order of :func:`ref_compress_topk`: NaN rows every third
    (``nan_few``: fewer non-NaN rows than k = d/2) or every seventh row
    (``nan_many``: more), +inf and NaN rows among ties (``inf``), every
    row equal (``equal``), every third row a copy of row 0 (``ties``)."""
    M, r = M.clone(), M.shape[-1]
    if kind == "nan_few":
        M[:, ::3, 0] = float("nan")
        M[:, 1::3, r - 1] = float("nan")
    elif kind == "nan_many":
        M[:, ::7, r - 1] = float("nan")
    elif kind == "inf":
        M[:, ::5, 0] = float("inf")
        M[:, 3::5, r - 1] = -float("inf")
        M[:, 2::11, 0] = float("nan")
        M[:, 1::4] = M[:, 1:2]
    elif kind == "equal":
        M[:] = M[:, :1]
    elif kind == "ties":
        M[:, 1::3] = M[:, :1]
    else:
        raise ValueError(f"kind must be one of {TOPK_SPECIAL_KINDS}, "
                         f"got {kind!r}")
    return M


def ref_dequant(q, scale):
    """What ``dequant`` computes: the int8 wire payload decoded as
    q · scale per node block, in the scale's dtype.  q (N, d, r);
    scale (N, 1, 1)."""
    return q.to(scale.dtype) * scale


def ref_int8_scale(delta):
    """The int8 wire's per-node scale of node blocks delta (N, d, r):
    max(amax|delta| / 127, tiny) in delta's dtype, NaN carried through.
    The 127 is a tensor on delta's device, so the division is an IEEE
    division on any device: PyTorch's CUDA division by a Python number
    may multiply by its reciprocal instead (its CPU one divides), which
    can differ from the kernel's division in the last bit."""
    amax = torch.amax(torch.abs(delta), dim=(-2, -1), keepdim=True)
    return torch.clamp(amax / delta.new_full((), 127.0),
                       min=torch.finfo(delta.dtype).tiny)


def ref_int8_round(Z, xhat, u=None):
    """What ``int8_round`` computes: one round of the int8 wire of the
    ``quantized_gossip`` rule for node blocks Z, xhat (N, d, r).
    delta = Z − xhat is quantized with :func:`ref_int8_scale` to
    q = clamp(round(delta / scale), −127, 127), half to even, or, given
    the stochastic wire's dither u (N, d, r), to clamp(floor(delta /
    scale + u), −127, 127); the public copy takes the decoded increment,
    xhat + ref_dequant(q, scale).  → (q int8, scale (N, 1, 1),
    xhat_new), in Z's dtype."""
    delta = Z - xhat                     # accumulated compression error
    scale = ref_int8_scale(delta)
    if u is None:
        qf = torch.round(delta / scale)            # half to even
    else:
        qf = torch.floor(delta / scale + u)
    q = torch.clamp(qf, -127, 127).to(torch.int8)
    return q, scale, xhat + ref_dequant(q, scale)


# ------------------------------------------------------------ LM kernels

def ref_attention(q, k, v, *, causal=True, window=None, scale=None):
    """What ``flash_attention`` computes.  q (B, H, Sq, D), k/v
    (B, Hkv, Skv, D) → (B, H, Sq, D) in q's dtype: GQA by head grouping
    (query head h reads KV head h // (H / Hkv)), float32 softmax, the
    causal and window masks aligned at the ends (query i sits at key
    position i + Skv − Sq).  A query row that sees no key (Sq > Skv, or
    a window past every key) comes out 0, as from the kernel; the JAX
    package's ``ref_attention`` gives such a row the mean of V instead.
    """
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.to(f32).reshape(B, Hkv, G, Sq, D) * scale
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.to(f32))
    qi = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    ki = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= (qi - ki) < window
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1) * mask
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(f32))
    return o.reshape(B, H, Sq, D).to(q.dtype)


def ref_ssd(x, dt, A, Bm, Cm, D):
    """What ``ssd_scan`` computes, as the token-by-token SSD recurrence
    h_t = exp(dt_t·A) h_{t−1} + dt_t · x_t ⊗ B_t, y_t = h_t C_t + D·x_t,
    in float32.  x (B, S, H, P); dt (B, S, H); A, D (H,); Bm/Cm
    (B, S, N), one group shared by every head → (y (B, S, H, P) in x's
    dtype, h_final (B, H, P, N) float32)."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    xf, dtf = x.to(f32), dt.to(f32)
    Bf, Cf = Bm.to(f32), Cm.to(f32)
    A, D = A.to(f32), D.to(f32)
    h = torch.zeros((Bb, H, P, N), dtype=f32, device=x.device)
    ys = []
    for t in range(S):
        a = torch.exp(dtf[:, t] * A)                              # (B, H)
        h = (a[..., None, None] * h
             + (dtf[:, t, :, None] * xf[:, t])[..., None]
             * Bf[:, t, None, None, :])
        ys.append(torch.einsum("bn,bhpn->bhp", Cf[:, t], h))
    y = torch.stack(ys, dim=1) + xf * D[:, None]
    return y.to(x.dtype), h
