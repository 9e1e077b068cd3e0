"""Plain PyTorch pieces of the references: float32 throughout, TF32 off,
no kernel and no cache.  Nothing here imports the program.

Every matrix product of a layer goes through :class:`Matmul`, which
computes it in float32 or, for the lower-precision control, as an FP8
product (operands rounded to ``float8_e4m3fn`` with one scale a tensor,
the gradient to ``float8_e5m2``, accumulation in float32): the step a
later change to the program could be tempted to take below bfloat16.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

f32 = torch.float32
PRECISIONS = ("float32", "fp8")
_FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2,
                                                      57344.0)}


def strict_float32() -> None:
    """Matrix products in true float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x, kind: str = "e4m3"):
    """``x`` rounded to an FP8 format with one scale for the tensor
    (its largest magnitude onto the format's largest), back in
    float32."""
    dtype, top = _FP8[kind]
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x.float() / scale).to(dtype).float() * scale


class _Fp8Product(torch.autograd.Function):
    """a (M, K) @ b (K, N) on FP8-rounded operands; the backward's
    products on the FP8-rounded gradient (e5m2) and saved operands."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8_round(g, "e5m2")
        return qg @ qb.T, qa.T @ qg


class Matmul:
    """``x (..., K) @ w (K, N)`` in the reference's precision."""

    def __init__(self, precision: str = "float32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.precision = precision

    def __call__(self, x, w):
        x, w = x.float(), w.float()
        if self.precision == "float32":
            return x @ w
        lead = x.shape[:-1]
        y = _Fp8Product.apply(x.reshape(-1, x.shape[-1]), w)
        return y.reshape(*lead, w.shape[-1])


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x, theta: float):
    """Rotary embedding over the whole head dim, rotate-half convention,
    positions 0..S−1. x: (B, S, H, D)."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=f32, device=x.device)
                           / half))
    ang = torch.arange(S, dtype=f32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, window=None, block: int = 1024):
    """softmax(q kᵀ / √D) v under the causal (and window) mask, keys and
    values shared by groups of query heads; computed a block of queries
    at a time.  q: (B, S, H, D), k and v: (B, S, Hkv, D)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, D) * D ** -0.5
    pos = torch.arange(S, device=q.device)
    out = []
    for i0 in range(0, S, block):
        i1 = min(i0 + block, S)
        # the keys some query of the block can see
        lo = 0 if window is None else max(i0 - window + 1, 0)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg[:, i0:i1], k[:, lo:i1])
        rel = pos[i0:i1, None] - pos[None, lo:i1]
        visible = rel >= 0
        if window is not None:
            visible = visible & (rel < window)
        s = s.masked_fill(~visible, -math.inf)
        p = torch.softmax(s, dim=-1)
        out.append(torch.einsum("bhgqk,bkhd->bqhgd", p, v[:, lo:i1]))
    return torch.cat(out, dim=1).reshape(B, S, H, D)


def gqa(p, h, cfg, mm: Matmul):
    """The attention mixer: q, k, v projections, RoPE, the core, wo."""
    B, S, _ = h.shape
    H, Hkv = cfg["n_heads"], cfg["n_kv_heads"]
    Dh = cfg.get("d_head") or cfg["d_model"] // H
    q = mm(h, p["wq/w"]).reshape(B, S, H, Dh)
    k = mm(h, p["wk/w"]).reshape(B, S, Hkv, Dh)
    v = mm(h, p["wv/w"]).reshape(B, S, Hkv, Dh)
    theta = cfg.get("rope_theta", 10000.0)
    o = causal_attention(rope(q, theta), rope(k, theta), v,
                         cfg.get("sliding_window"))
    return mm(o.reshape(B, S, H * Dh), p["wo/w"])


def swiglu(p, h, mm: Matmul):
    return mm(F.silu(mm(h, p["gate/w"])) * mm(h, p["up/w"]), p["down/w"])


def sub(params: dict, prefix: str, index=()) -> dict:
    """The leaves under ``prefix/`` with the prefix taken off, each
    indexed by ``index`` (a layer's slice of a stacked leaf)."""
    n = len(prefix) + 1
    return {k[n:]: (v[index] if index else v) for k, v in params.items()
            if k.startswith(prefix + "/")}


def next_token_loss(logits, labels):
    """Mean next-token negative log-likelihood over every position."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - picked)


def adamw_step(p, g, m, v, step: int, opt: dict):
    """One AdamW update in float32, the schedule a linear warm-up to
    ``lr`` over ``warmup_steps`` then a cosine to 0 at ``total_steps``;
    the decay taken on the parameter before the step (decoupled), the
    whole update formed before it is added.  Returns (p, m, v)."""
    lr = schedule(step, opt)
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    mhat = m / (1 - b1 ** step)
    vhat = v / (1 - b2 ** step)
    update = -lr * mhat / (torch.sqrt(vhat) + eps) - lr * wd * p
    return p + update, m, v


def schedule(step: int, opt: dict) -> float:
    warm, total, peak = opt["warmup_steps"], opt["total_steps"], opt["lr"]
    if step < warm:
        return peak * step / warm
    t = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return 0.5 * peak * (1 + math.cos(math.pi * t))


def ring_mix(stacked, shifts, self_weight=None):
    """One round of the ring's equal-weight gossip over the leading node
    axis: node g takes w·z_g + Σ_s w·z_{g+s}, w = 1/(1 + len(shifts))."""
    w = 1.0 / (1 + len(shifts)) if self_weight is None else self_weight
    wn = (1.0 - w) / len(shifts)
    out = w * stacked
    for s in shifts:
        out = out + wn * torch.roll(stacked, -s, dims=0)
    return out
