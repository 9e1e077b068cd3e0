"""Decoder blocks: an (attn | mamba2) mixer + a (dense SwiGLU | none) FFN
with pre-norm residuals, and command-r's parallel attn ∥ ffn variant.

Port of ``src/repro/models/blocks.py`` for the blocks of the ``scan``
plans.  Each forward returns (x, aux), aux the MoE load-balance loss
contribution (0 for dense).  MoE FFNs and zamba's shared-attention block
are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    init_rms_norm, init_swiglu, rms_norm, swiglu,
)

LATER = "a later slice of the port"


def _unported(what: str):
    raise NotImplementedError(f"{what} is not ported yet: {LATER}")


# ----------------------------------------------------------------- init

def init_block(generator, cfg, kind, device, lead=()):
    """kind = (mixer, ffn) with mixer ∈ {attn, ssm}, ffn ∈ {dense, none}
    ('none' ⇒ mixer-only block, mamba2 style); every leaf has the shape
    prefix ``lead``."""
    mixer, ffn = kind
    dt = getattr(torch, cfg.param_dtype)
    p = {"norm1": init_rms_norm(cfg.d_model, dt, device, lead)}
    if mixer == "attn":
        if cfg.attn_impl == "mla":
            _unported("MLA attention")
        p["mixer"] = attn.init_gqa(generator, cfg, device, lead)
    else:
        p["mixer"] = ssm_mod.init_mamba2(generator, cfg, device, lead)
    if ffn == "none":
        return p
    if ffn != "dense":
        _unported("the MoE FFN")
    if not cfg.parallel_block:
        p["norm2"] = init_rms_norm(cfg.d_model, dt, device, lead)
    p["ffn"] = init_swiglu(generator, cfg.d_model, cfg.d_ff, dt, device,
                           cfg.mlp_bias, lead)
    return p


# ----------------------------------------------------------------- fwd

def _mixer_fwd(p, h, cfg, kind_mixer, positions):
    if kind_mixer == "attn":
        return attn.gqa_forward(p["mixer"], h, cfg, positions)
    return ssm_mod.mamba2_forward(p["mixer"], h, cfg)


def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def block_forward(p, x, cfg, kind, positions):
    mixer, ffn = kind
    h = rms_norm(p["norm1"], x, cfg.norm_eps)
    if ffn == "none":
        return x + _mixer_fwd(p, h, cfg, mixer, positions), _zero(x)
    if cfg.parallel_block:
        a = _mixer_fwd(p, h, cfg, mixer, positions)
        return x + a + swiglu(p["ffn"], h), _zero(x)
    x = x + _mixer_fwd(p, h, cfg, mixer, positions)
    h = rms_norm(p["norm2"], x, cfg.norm_eps)
    return x + swiglu(p["ffn"], h), _zero(x)


# ----------------------------------------------------------------- decode

def block_init_cache(cfg, kind, batch, capacity, dtype, device, lead=()):
    if kind[0] == "attn":
        return attn.gqa_init_cache(cfg, batch, capacity, dtype, device, lead)
    return ssm_mod.mamba2_init_cache(cfg, batch, dtype, device, lead)


def _mixer_decode(p, h, cfg, kind_mixer, cache, pos):
    if kind_mixer == "attn":
        return attn.gqa_decode(p["mixer"], h, cfg, cache, pos)
    return ssm_mod.mamba2_decode(p["mixer"], h, cfg, cache)


def block_decode(p, x, cfg, kind, cache, pos):
    """One token through one block; the cache is updated in place."""
    mixer, ffn = kind
    h = rms_norm(p["norm1"], x, cfg.norm_eps)
    a, cache = _mixer_decode(p, h, cfg, mixer, cache, pos)
    if ffn == "none":
        return x + a, cache
    if cfg.parallel_block:
        return x + a + swiglu(p["ffn"], h), cache
    x = x + a
    h = rms_norm(p["norm2"], x, cfg.norm_eps)
    return x + swiglu(p["ffn"], h), cache
