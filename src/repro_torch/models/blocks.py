"""Decoder blocks: an (attn | mamba2) mixer + a (dense SwiGLU | MoE |
none) FFN with pre-norm residuals, command-r's parallel attn ∥ ffn
variant, and zamba's weight-tied shared attention block.

Port of ``src/repro/models/blocks.py``.  Each forward returns (x, aux),
aux the MoE load-balance loss contribution (0 for dense); decode returns
(x, cache), the cache updated in place.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    init_rms_norm, init_swiglu, rms_norm, swiglu,
)


# ----------------------------------------------------------------- init

def init_block(generator, cfg, kind, device, lead=()):
    """kind = (mixer, ffn) with mixer ∈ {attn, ssm}, ffn ∈ {dense, moe,
    none} ('none' ⇒ mixer-only block, mamba2 style); every leaf has the
    shape prefix ``lead``."""
    mixer, ffn = kind
    dt = getattr(torch, cfg.param_dtype)
    p = {"norm1": init_rms_norm(cfg.d_model, dt, device, lead)}
    if mixer == "attn":
        init_attn = attn.init_mla if cfg.attn_impl == "mla" else attn.init_gqa
        p["mixer"] = init_attn(generator, cfg, device, lead)
    else:
        p["mixer"] = ssm_mod.init_mamba2(generator, cfg, device, lead)
    if ffn == "none":
        return p
    if not cfg.parallel_block:
        p["norm2"] = init_rms_norm(cfg.d_model, dt, device, lead)
    if ffn == "dense":
        p["ffn"] = init_swiglu(generator, cfg.d_model, cfg.d_ff, dt, device,
                               cfg.mlp_bias, lead)
    else:
        p["ffn"] = moe_mod.init_moe(generator, cfg, device, lead)
    return p


def init_shared_attn(generator, cfg, device):
    """Zamba2: ONE weight-tied attention + MLP block reused every
    ``shared_attn_period`` layers (the backbone's d_ff belongs here)."""
    dt = getattr(torch, cfg.param_dtype)
    return {"norm": init_rms_norm(cfg.d_model, dt, device),
            "attn": attn.init_gqa(generator, cfg, device),
            "norm2": init_rms_norm(cfg.d_model, dt, device),
            "ffn": init_swiglu(generator, cfg.d_model, cfg.d_ff, dt, device,
                               cfg.mlp_bias)}


# ----------------------------------------------------------------- fwd

def _mixer_fwd(p, h, cfg, kind_mixer, positions):
    if kind_mixer == "attn":
        if cfg.attn_impl == "mla":
            return attn.mla_forward(p["mixer"], h, cfg, positions)
        return attn.gqa_forward(p["mixer"], h, cfg, positions)
    return ssm_mod.mamba2_forward(p["mixer"], h, cfg)


def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _ffn_fwd(p, h, cfg, kind_ffn):
    if kind_ffn == "dense":
        return swiglu(p["ffn"], h), _zero(h)
    return moe_mod.moe_forward(p["ffn"], h, cfg)


def block_forward(p, x, cfg, kind, positions):
    mixer, ffn = kind
    h = rms_norm(p["norm1"], x, cfg.norm_eps)
    if ffn == "none":
        return x + _mixer_fwd(p, h, cfg, mixer, positions), _zero(x)
    if cfg.parallel_block:
        a = _mixer_fwd(p, h, cfg, mixer, positions)
        f, aux = _ffn_fwd(p, h, cfg, ffn)
        return x + a + f, aux
    x = x + _mixer_fwd(p, h, cfg, mixer, positions)
    h = rms_norm(p["norm2"], x, cfg.norm_eps)
    f, aux = _ffn_fwd(p, h, cfg, ffn)
    return x + f, aux


def shared_attn_forward(p_shared, x, cfg, positions):
    h = rms_norm(p_shared["norm"], x, cfg.norm_eps)
    x = x + attn.gqa_forward(p_shared["attn"], h, cfg, positions)
    h = rms_norm(p_shared["norm2"], x, cfg.norm_eps)
    return x + swiglu(p_shared["ffn"], h)


# ----------------------------------------------------------------- decode

def block_init_cache(cfg, kind, batch, capacity, dtype, device, lead=()):
    if kind[0] == "attn":
        init = (attn.mla_init_cache if cfg.attn_impl == "mla"
                else attn.gqa_init_cache)
        return init(cfg, batch, capacity, dtype, device, lead)
    return ssm_mod.mamba2_init_cache(cfg, batch, dtype, device, lead)


def _mixer_decode(p, h, cfg, kind_mixer, cache, pos):
    if kind_mixer == "attn":
        if cfg.attn_impl == "mla":
            return attn.mla_decode(p["mixer"], h, cfg, cache, pos)
        return attn.gqa_decode(p["mixer"], h, cfg, cache, pos)
    return ssm_mod.mamba2_decode(p["mixer"], h, cfg, cache)


def block_decode(p, x, cfg, kind, cache, pos):
    """One token through one block; the cache is updated in place.  The
    MoE aux term is dropped, as the JAX package's decode drops it."""
    mixer, ffn = kind
    h = rms_norm(p["norm1"], x, cfg.norm_eps)
    a, cache = _mixer_decode(p, h, cfg, mixer, cache, pos)
    if ffn == "none":
        return x + a, cache
    if cfg.parallel_block:
        return x + a + _ffn_fwd(p, h, cfg, ffn)[0], cache
    x = x + a
    h = rms_norm(p["norm2"], x, cfg.norm_eps)
    return x + _ffn_fwd(p, h, cfg, ffn)[0], cache


def shared_attn_decode(p_shared, x, cfg, cache, pos):
    h = rms_norm(p_shared["norm"], x, cfg.norm_eps)
    a, cache = attn.gqa_decode(p_shared["attn"], h, cfg, cache, pos)
    x = x + a
    h = rms_norm(p_shared["norm2"], x, cfg.norm_eps)
    return x + swiglu(p_shared["ffn"], h), cache
