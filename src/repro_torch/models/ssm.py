"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) sequence mixer.

Port of ``src/repro/models/ssm.py``.  Layer structure (Mamba2):
  in_proj → [z | x | B | C | dt]; causal conv1d (width K) over [x|B|C];
  SSD recurrence  h_t = exp(dt_t·A) h_{t-1} + dt_t · B_t ⊗ x_t,
                  y_t = C_t·h_t + D·x_t        (A scalar per head);
  gated RMSNorm  y ← norm(y · silu(z));  out_proj.

The full-sequence SSD is the paper's chunked algorithm: within a chunk
of Q tokens the recurrence is unrolled into a masked quadratic form,
across chunks a loop carries the (H, P, N) state.  On the ``cuda``
kernel backend ``mamba2_forward`` runs it through ``ops.ssd_scan`` —
the hand-written kernel replacing the TPU one, which adds the D skip
term itself — wrapped by ``ops.with_plain_backward``, whose backward
differentiates ``ssd_chunked`` recomputed on the saved inputs; elsewhere
it runs the plain ``ssd_chunked``, as the JAX package does (and
differentiates).  Decode is the O(1)-per-token recurrent step on an
SSMCache, plain torch on every backend.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import (
    he_normal, init_linear, init_rms_norm, linear,
)

f32 = torch.float32


class SSMCache(NamedTuple):
    conv: torch.Tensor    # (B, K−1, conv_channels) rolling conv window
    state: torch.Tensor   # (B, H, P, N) SSD state, float32


# ----------------------------------------------------------------- params

def init_mamba2(generator, cfg, device, lead=()):
    d, di, N, H, P = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_headdim)
    if H * P != di:
        raise ValueError(f"ssm_heads*headdim must equal d_inner "
                         f"({H}·{P}≠{di})")
    dt = getattr(torch, cfg.param_dtype)
    conv_ch = di + 2 * N

    def per_head(values):        # one value a head, the same every layer
        return values.to(f32).to(device).expand(*lead, H).clone()
    f64 = torch.float64
    return {
        "in_proj": init_linear(generator, d, 2 * di + 2 * N + H, dt, device,
                               lead=lead),
        "conv_w": he_normal(generator, (*lead, cfg.ssm_conv, conv_ch),
                            cfg.ssm_conv, dt, device),
        "conv_b": torch.zeros((*lead, conv_ch), dtype=dt, device=device),
        "A_log": per_head(torch.log(torch.linspace(1.0, 16.0, H, dtype=f64))),
        "dt_bias": per_head(torch.log(torch.expm1(
            torch.logspace(-3.0, -1.0, H, dtype=f64)))),
        "D": per_head(torch.ones(H, dtype=f64)),
        "norm": init_rms_norm(di, dt, device, lead),
        "out_proj": init_linear(generator, di, d, dt, device, lead=lead),
    }


def _split_in_proj(p, x, cfg):
    di, N = cfg.d_inner, cfg.ssm_state
    zxbcdt = linear(p["in_proj"], x)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * N]
    dt_raw = zxbcdt[..., di + di + 2 * N:]
    return z, xbc, dt_raw


def _gated_out(p, y, z, cfg):
    g = y * F.silu(z)
    gf = g.to(f32)
    var = torch.mean(gf * gf, dim=-1, keepdim=True)
    g = (gf * torch.rsqrt(var + cfg.norm_eps)
         * p["norm"]["scale"].to(f32)).to(y.dtype)
    return linear(p["out_proj"], g)


# ----------------------------------------------------------------- SSD

def ssd_chunked(x, dt, A, Bm, Cm, D, chunk: int, h0=None):
    """Chunked SSD.  x: (B,S,H,P); dt: (B,S,H) (post-softplus); A: (H,)
    negative reals; Bm/Cm: (B,S,N); D: (H,).  Returns (y float32,
    h_final).

    Every chunk's quadratic form and state at once (a chunk axis c);
    only the carry of the state across chunks loops, three operations a
    chunk: the backward of the kernel route recomputes this function
    under autograd, and its cost is the number of operations it
    launches."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-S) % chunk
    xf, dtf, Bf, Cf = x.to(f32), dt.to(f32), Bm.to(f32), Cm.to(f32)
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    Q = chunk
    nc = (S + pad) // Q
    A = A.to(f32)
    D = D.to(f32)
    xq = xf.reshape(Bb, nc, Q, H, P)
    dtq = dtf.reshape(Bb, nc, Q, H)
    Bq, Cq = Bf.reshape(Bb, nc, Q, N), Cf.reshape(Bb, nc, Q, N)
    idx = torch.arange(Q, device=x.device)
    causal = idx[:, None] >= idx[None, :]                     # (Q, Q)
    cum = torch.cumsum(dtq * A, dim=2)                        # (B,c,Q,H) ≤ 0
    seg = cum[:, :, -1]                                       # (B,c,H)
    # intra-chunk quadratic form.  The mask goes in before the exp:
    # above the diagonal cum_i − cum_j > 0 overflows to inf at real dt·A
    # (mamba2-130m: −205 over a chunk), and where(mask, exp, 0) would
    # give 0·inf = NaN gradients there (the JAX package's form); the
    # values are the same
    L = torch.exp(torch.where(causal[:, :, None],
                              cum[:, :, :, None] - cum[:, :, None, :],
                              -torch.inf))                    # (B,c,Q,Q,H)
    scores = torch.einsum("bcin,bcjn->bcij", Cq, Bq)          # (B,c,Q,Q)
    M = scores[..., None] * L * dtq[:, :, None]               # (B,c,Q,Q,H)
    y = torch.einsum("bcijh,bcjhp->bcihp", M, xq)
    # each chunk's own state, then the carry: h entering chunk c
    decay = torch.exp(seg[:, :, None] - cum) * dtq            # (B,c,Q,H)
    S_c = torch.einsum("bcqh,bcqn,bcqhp->bchpn", decay, Bq, xq)
    h = (h0.to(f32) if h0 is not None
         else torch.zeros((Bb, H, P, N), dtype=f32, device=x.device))
    carried = []
    for c in range(nc):
        carried.append(h)
        h = torch.exp(seg[:, c])[..., None, None] * h + S_c[:, c]
    # inter-chunk contribution from the carried state
    y = y + torch.einsum("bcin,bchpn->bcihp", Cq,
                         torch.stack(carried, dim=1)) \
        * torch.exp(cum)[..., None]
    y = y.reshape(Bb, nc * Q, H, P)[:, :S]
    y = y + xf[:, :S] * D[:, None]
    return y, h


def kernel_ssd(x, dt, A, Bm, Cm, D, chunk: int):
    """The chunked SSD of a full sequence from a zero state through the
    ``ssd_scan`` kernel → y in x's dtype (the D skip term included),
    differentiable: the backward runs :func:`ssd_chunked` on the saved
    inputs a second time and returns its gradients
    (``ops.with_plain_backward``)."""
    def plain(x, dt, A, Bm, Cm, D):
        return ssd_chunked(x, dt, A, Bm, Cm, D, chunk)[0].to(x.dtype)
    return ops.with_plain_backward(
        lambda *a: ops.ssd_scan(*a, chunk=chunk, backend="cuda")[0],
        plain, x, dt, A, Bm, Cm, D)


def ssd_step(h, x_t, dt_t, A, B_t, C_t, D):
    """One-token SSD update. h: (B,H,P,N); x_t: (B,H,P); dt_t: (B,H);
    B_t/C_t: (B,N)."""
    a = torch.exp(dt_t * A)                                   # (B,H)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt_t, B_t.to(f32), x_t.to(f32))
    h = a[..., None, None] * h + upd
    y = torch.einsum("bn,bhpn->bhp", C_t.to(f32), h)
    return h, y + x_t.to(f32) * D[:, None]


# ----------------------------------------------------------------- layer

def _conv_inputs(p, x, cfg):
    """in_proj, the causal depthwise conv (width-K shifted adds) and the
    SSD operands of a full sequence."""
    B, S, _ = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    z, xbc, dt_raw = _split_in_proj(p, x, cfg)
    K = cfg.ssm_conv
    # tap i reads the input K − 1 − i tokens back; summed in the JAX
    # package's order (tap 0 first), with one pad and one cast
    padded = F.pad(xbc.to(f32), (0, 0, K - 1, 0))
    w = p["conv_w"].to(f32)
    conv = padded[:, :S] * w[0]
    for i in range(1, K):
        conv = conv + padded[:, i:i + S] * w[i]
    xbc = F.silu(conv + p["conv_b"].to(f32)).to(x.dtype)
    xin = xbc[..., :di].reshape(B, S, H, P)
    Bm, Cm = xbc[..., di:di + N], xbc[..., di + N:]
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    return z, xin, dt, A, Bm, Cm


def mamba2_forward(p, x, cfg):
    """Full-sequence Mamba2 mixer. x: (B,S,d) → (B,S,d)."""
    B, S, _ = x.shape
    z, xin, dt, A, Bm, Cm = _conv_inputs(p, x, cfg)
    if ops.resolve_backend(None, x.device) == "cuda":
        y = kernel_ssd(xin, dt, A, Bm, Cm, p["D"], cfg.ssm_chunk)
    else:
        y = ssd_chunked(xin, dt, A, Bm, Cm, p["D"], cfg.ssm_chunk)[0]
    y = y.to(x.dtype).reshape(B, S, cfg.d_inner)
    return _gated_out(p, y, z, cfg)


def mamba2_init_cache(cfg, batch, dtype, device, lead=()):
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    return SSMCache(
        conv=torch.zeros((*lead, batch, cfg.ssm_conv - 1, di + 2 * N),
                         dtype=dtype, device=device),
        state=torch.zeros((*lead, batch, H, P, N), dtype=f32, device=device))


def mamba2_decode(p, x, cfg, cache: SSMCache):
    """One-token recurrent step. x: (B,1,d) → ((B,1,d), cache).  The cache
    is updated IN PLACE (the JAX package returns an updated copy); the
    returned cache is the same object."""
    B = x.shape[0]
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    z, xbc, dt_raw = _split_in_proj(p, x[:, 0], cfg)         # (B, ·)
    window = torch.cat([cache.conv, xbc[:, None]], dim=1)    # (B,K,ch)
    conv = (torch.einsum("bkc,kc->bc", window.to(f32), p["conv_w"].to(f32))
            + p["conv_b"].to(f32))
    xbc_t = F.silu(conv).to(x.dtype)
    x_t = xbc_t[..., :di].reshape(B, H, P)
    B_t, C_t = xbc_t[..., di:di + N], xbc_t[..., di + N:]
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    h, y = ssd_step(cache.state, x_t, dt, A, B_t, C_t, p["D"])
    y = _gated_out(p, y.to(x.dtype).reshape(B, 1, di), z[:, None], cfg)
    cache.conv.copy_(window[:, 1:])
    cache.state.copy_(h)
    return y, cache
