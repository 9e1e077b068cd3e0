"""Primitive layers shared by every architecture.

Port of ``src/repro/models/layers.py``: parameters are plain dicts of
tensors (or the :class:`~repro_torch.models.transformer.ParamTree` of
:class:`repro_torch.models.transformer.LanguageModel`, which indexes the
same way), layers are ``(params, x) -> y`` functions.  Initializers draw
from an explicit :class:`torch.Generator` (truncated-normal fan-in, as
the JAX package's ``he_normal``); they cannot replay ``jax.random``, so
cross-package tests carry the JAX package's weights across
(:mod:`repro_torch.models.convert`).

Every ``init_*`` takes ``lead``, a shape prefix: the transformer draws a
segment's ``n`` identical layers at once with ``lead=(n,)``, the layout
in which the JAX package stacks a segment's leaves.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

f32 = torch.float32


def truncated_normal(generator, shape, device):
    """Standard normal truncated to [−2, 2], float32: the inverse CDF of a
    uniform draw, as ``jax.random.truncated_normal`` computes it."""
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))      # Φ(2)
    lo = 1.0 - hi
    u = torch.rand(shape, generator=generator, device=device, dtype=f32)
    # in place, one buffer: an expert stack of deepseek-v3 is 15 GB at f32
    u.mul_(hi - lo).add_(lo).mul_(2.0).sub_(1.0)
    return u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)


def he_normal(generator, shape, in_axis_size, dtype, device):
    return truncated_normal(generator, shape, device).mul_(
        in_axis_size ** -0.5).to(dtype)


def init_linear(generator, d_in, d_out, dtype, device, bias=False, lead=()):
    """Weight ``(*lead, d_in, d_out)``: the JAX package's ``x @ w``
    layout (the transpose of :class:`torch.nn.Linear`'s)."""
    p = {"w": he_normal(generator, (*lead, d_in, d_out), d_in, dtype,
                        device)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=device)
    return p


def linear(p, x):
    """Weights are stored in param_dtype (f32) and cast to the activation
    dtype at use — activations stay in cfg.dtype (bf16) end to end."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def init_rms_norm(d, dtype, device, lead=()):
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rms_norm(p, x, eps: float):
    # compute in f32 for stability regardless of activation dtype
    xf = x.to(f32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(f32)).to(x.dtype)


def init_embedding(generator, vocab, d, dtype, device):
    return {"table": torch.randn((vocab, d), generator=generator,
                                 device=device, dtype=f32).mul_(0.02).to(dtype)}


def embed(p, tokens):
    return p["table"][tokens]


def unembed(p, x):
    """Tied logits: x @ tableᵀ (f32 accumulation for the softmax)."""
    return x.to(f32) @ p["table"].to(f32).T


# ---------------------------------------------------------------- SwiGLU

def init_swiglu(generator, d_model, d_ff, dtype, device, bias=False,
                lead=()):
    return {"gate": init_linear(generator, d_model, d_ff, dtype, device,
                                bias, lead),
            "up": init_linear(generator, d_model, d_ff, dtype, device, bias,
                              lead),
            "down": init_linear(generator, d_ff, d_model, dtype, device,
                                bias, lead)}


def swiglu(p, x):
    return linear(p["down"], F.silu(linear(p["gate"], x))
                  * linear(p["up"], x))


# ---------------------------------------------------------------- RoPE

def rope_frequencies(d_head: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for the even half of the head dim (f32)."""
    half = d_head // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=f32, device=device)
                            / half))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, Dh) with rotate-half convention; positions: (..., S).

    Computed in f32 and cast back.
    """
    inv = rope_frequencies(x.shape[-1], theta, x.device)       # (Dh/2,)
    ang = positions[..., :, None].to(f32) * inv                # (..., S, Dh/2)
    cos = torch.cos(ang)[..., None, :]                         # (..., S, 1, Dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(f32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
