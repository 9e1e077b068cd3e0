"""Attention mixers: GQA/MQA/MHA (+ RoPE, qk-norm, sliding window) and MLA
(multi-head latent attention, DeepSeek-V3), with a full-sequence path
(prefill) and a KV-cache single-token path (decode).

Port of ``src/repro/models/attention.py``.  The softmax
core has the JAX package's two plain implementations:
  * ``attention_core`` — materializes the score matrix (short S);
  * ``chunked_attention`` — a loop over KV chunks with an online softmax
    (flash-attention math in plain torch), above ``CHUNK_THRESHOLD``.
On the ``cuda`` kernel backend, ``gqa_forward`` sends its core through
``ops.flash_attention`` instead — the hand-written kernel replacing the
TPU one, which the JAX package holds equal to both cores
(tests/test_kernels.py::test_flash_matches_model_chunked_attention) —
wrapped by ``ops.with_plain_backward``: its gradient is the plain core's
(``attention_dispatch``), recomputed in the backward, as the JAX package
differentiates that core.
There every row's positions are ``arange(S)`` (``transformer.
embed_inputs``), which is what the kernel's index-based causal and
window masks express.  ``gqa_decode`` keeps the plain core on every
backend: its query faces a ring buffer with explicit positions and −1
(empty) slots.  ``mla_forward`` goes the same way, with V padded from
the value head dim up to the query-key one (the kernel takes one head
dim) and the scale (dn + dr)^-1/2; ``mla_decode`` is the absorbed-matmul
decode against the latent cache, plain torch as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import (
    apply_rope, init_linear, init_rms_norm, linear, rms_norm,
)

f32 = torch.float32
NEG_INF = -1e30
CHUNK_THRESHOLD = 2048      # use the chunked path above this KV length


# ======================================================================
# softmax cores
# ======================================================================

def _build_mask(q_pos, k_pos, window):
    """(B, Sq, Skv) bool — causal, optionally sliding-window, k valid."""
    m = (k_pos[:, None, :] <= q_pos[:, :, None]) & (k_pos[:, None, :] >= 0)
    if window is not None:
        m &= (q_pos[:, :, None] - k_pos[:, None, :]) < window
    return m


def attention_core(q, k, v, q_pos, k_pos, *, window=None, scale=None):
    """Reference core.  q: (B,Sq,H,D), k/v: (B,Skv,Hkv,D);
    q_pos: (B,Sq) int, k_pos: (B,Skv) int (−1 ⇒ invalid slot)."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = (q.to(f32) * scale).reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(f32))
    mask = _build_mask(q_pos, k_pos, window)[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(f32))
    return o.reshape(B, Sq, H, D).to(q.dtype)


def chunked_attention(q, k, v, q_pos, k_pos, *, window=None, scale=None,
                      chunk=1024):
    """Online-softmax attention over KV chunks (flash math).

    Same signature/semantics as :func:`attention_core`; activation memory
    is O(B·H·Sq·chunk) instead of O(B·H·Sq·Skv).
    """
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = (q.to(f32) * scale).reshape(B, Sq, Hkv, G, D)
    o = torch.zeros((B, Hkv, G, Sq, D), dtype=f32, device=q.device)
    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), dtype=f32, device=q.device)
    for c0 in range(0, Skv, chunk):
        # a ragged last chunk is the padded chunk's valid part: padded
        # slots (position −1) contribute exp(−1e30 − m) = 0 there
        kci = k[:, c0:c0 + chunk].to(f32)
        vci = v[:, c0:c0 + chunk].to(f32)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kci)
        mask = _build_mask(q_pos, k_pos[:, c0:c0 + chunk], window)[:, None,
                                                                    None]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        l = l * alpha + torch.sum(p, dim=-1)
        o = o * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vci)
        m = m_new
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def attention_dispatch(q, k, v, q_pos, k_pos, *, window=None, scale=None):
    if k.shape[1] > CHUNK_THRESHOLD:
        return chunked_attention(q, k, v, q_pos, k_pos, window=window,
                                 scale=scale)
    return attention_core(q, k, v, q_pos, k_pos, window=window, scale=scale)


def kernel_attention(q, k, v, positions, *, window=None, scale=None):
    """Causal attention of a full sequence through the ``flash_attention``
    kernel, differentiable: the backward runs ``attention_dispatch`` (the
    plain core) on the saved q, k, v a second time and returns its
    gradients (``ops.with_plain_backward``).  ``positions`` (B, S), each
    row ``arange(S)``, is what the kernel's index-based masks express;
    ``scale`` defaults to D^-1/2."""
    def plain(q, k, v):
        return attention_dispatch(q, k, v, positions, positions,
                                  window=window, scale=scale)
    return ops.with_plain_backward(
        lambda q, k, v: ops.flash_attention(q, k, v, causal=True,
                                            window=window, scale=scale,
                                            backend="cuda"),
        plain, q, k, v)


def full_attention(q, k, v, positions, *, window=None, scale=None):
    """The causal core of a full sequence: the kernel on the ``cuda``
    backend (:func:`kernel_attention`), the plain ``attention_dispatch``
    elsewhere."""
    if ops.resolve_backend(None, q.device) == "cuda":
        return kernel_attention(q, k, v, positions, window=window,
                                scale=scale)
    return attention_dispatch(q, k, v, positions, positions, window=window,
                              scale=scale)


# ======================================================================
# GQA (covers MHA / MQA / GQA; qk-norm; sliding window)
# ======================================================================

class KVCache(NamedTuple):
    k: torch.Tensor           # (B, capacity, Hkv, D)
    v: torch.Tensor           # (B, capacity, Hkv, D)
    positions: torch.Tensor   # (B, capacity) int64, −1 ⇒ empty slot


def init_gqa(generator, cfg, device, lead=()):
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = getattr(torch, cfg.param_dtype)
    p = {"wq": init_linear(generator, d, H * Dh, dt, device, cfg.attn_bias,
                           lead),
         "wk": init_linear(generator, d, Hkv * Dh, dt, device, cfg.attn_bias,
                           lead),
         "wv": init_linear(generator, d, Hkv * Dh, dt, device, cfg.attn_bias,
                           lead),
         "wo": init_linear(generator, H * Dh, d, dt, device, cfg.attn_bias,
                           lead)}
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(Dh, dt, device, lead)
        p["k_norm"] = init_rms_norm(Dh, dt, device, lead)
    return p


def _qkv(p, x, cfg, positions):
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = linear(p["wq"], x).reshape(B, S, H, Dh)
    k = linear(p["wk"], x).reshape(B, S, Hkv, Dh)
    v = linear(p["wv"], x).reshape(B, S, Hkv, Dh)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(p, x, cfg, positions):
    """Full-sequence path (prefill). x: (B,S,d); positions: (B,S), each
    row ``arange(S)``."""
    q, k, v = _qkv(p, x, cfg, positions)
    o = full_attention(q, k, v, positions, window=cfg.sliding_window)
    return linear(p["wo"], o.reshape(x.shape[0], x.shape[1], -1))


def gqa_init_cache(cfg, batch, capacity, dtype, device, lead=()):
    Hkv, Dh = cfg.n_kv_heads, cfg.d_head
    shape = (*lead, batch, capacity, Hkv, Dh)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        positions=torch.full((*lead, batch, capacity), -1, dtype=torch.long,
                             device=device))


def gqa_decode(p, x, cfg, cache: KVCache, pos: int):
    """One-token decode. x: (B,1,d); pos: the current position.  The
    cache is a ring buffer of ``capacity`` slots, written IN PLACE at
    slot ``pos % capacity`` (the JAX package returns an updated copy);
    the returned cache is the same object."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    slot = pos % cache.k.shape[1]
    cache.k[:, slot] = k[:, 0]
    cache.v[:, slot] = v[:, 0]
    cache.positions[:, slot] = pos
    o = attention_dispatch(q, cache.k, cache.v, positions, cache.positions,
                           window=cfg.sliding_window)
    return linear(p["wo"], o.reshape(B, 1, -1)), cache


# ======================================================================
# MLA — multi-head latent attention (DeepSeek-V3)
# ======================================================================

class MLACache(NamedTuple):
    ckv: torch.Tensor         # (B, capacity, kv_lora) compressed latent
    k_rope: torch.Tensor      # (B, capacity, rope_dim) shared rope key
    positions: torch.Tensor   # (B, capacity) int64, −1 ⇒ empty slot


def init_mla(generator, cfg, device, lead=()):
    d, H = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    dt = getattr(torch, cfg.param_dtype)

    def lin(d_in, d_out):
        return init_linear(generator, d_in, d_out, dt, device, lead=lead)
    return {
        "wdq": lin(d, qr),
        "q_norm": init_rms_norm(qr, dt, device, lead),
        "wuq": lin(qr, H * (dn + dr)),
        "wdkv": lin(d, kvr + dr),
        "kv_norm": init_rms_norm(kvr, dt, device, lead),
        "wuk": lin(kvr, H * dn),
        "wuv": lin(kvr, H * dv),
        "wo": lin(H * dv, d),
    }


def _mla_q(p, x, cfg, positions):
    B, S, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim
    cq = rms_norm(p["q_norm"], linear(p["wdq"], x), cfg.norm_eps)
    q = linear(p["wuq"], cq).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(p, x, cfg, positions):
    kvr = cfg.kv_lora_rank
    dkv = linear(p["wdkv"], x)
    ckv = rms_norm(p["kv_norm"], dkv[..., :kvr], cfg.norm_eps)
    k_rope = apply_rope(dkv[..., kvr:][:, :, None], positions,
                        cfg.rope_theta)[:, :, 0]              # (B,S,dr)
    return ckv, k_rope


def mla_forward(p, x, cfg, positions):
    """Full-sequence MLA: the latent expanded to per-head K/V (prefill).
    x: (B,S,d); positions: (B,S), each row ``arange(S)``."""
    B, S, _ = x.shape
    H, dn, dr, dv = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                     cfg.v_head_dim)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    ckv, k_rope = _mla_latent(p, x, cfg, positions)
    k_nope = linear(p["wuk"], ckv).reshape(B, S, H, dn)
    v = linear(p["wuv"], ckv).reshape(B, S, H, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, dr)], dim=-1)
    # V padded up to the query-key head dim so the shared cores (and the
    # kernel) apply, then sliced
    o = full_attention(q, k, F.pad(v, (0, dn + dr - dv)), positions,
                       window=cfg.sliding_window, scale=(dn + dr) ** -0.5)
    return linear(p["wo"], o[..., :dv].reshape(B, S, H * dv))


def mla_init_cache(cfg, batch, capacity, dtype, device, lead=()):
    return MLACache(
        ckv=torch.zeros((*lead, batch, capacity, cfg.kv_lora_rank),
                        dtype=dtype, device=device),
        k_rope=torch.zeros((*lead, batch, capacity, cfg.rope_head_dim),
                           dtype=dtype, device=device),
        positions=torch.full((*lead, batch, capacity), -1, dtype=torch.long,
                             device=device))


def mla_decode(p, x, cfg, cache: MLACache, pos: int):
    """Absorbed-matmul decode: scores against the latent cache directly,
    never materializing per-head K/V.  x: (B,1,d).  The cache is written
    IN PLACE at slot ``pos % capacity``, as ``gqa_decode``'s; the
    returned cache is the same object."""
    B = x.shape[0]
    H, dn, dr, dv = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                     cfg.v_head_dim)
    kvr = cfg.kv_lora_rank
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)        # (B,1,H,dn/dr)
    ckv_t, k_rope_t = _mla_latent(p, x, cfg, positions)  # (B,1,kvr/dr)
    slot = pos % cache.ckv.shape[1]
    cache.ckv[:, slot] = ckv_t[:, 0]
    cache.k_rope[:, slot] = k_rope_t[:, 0]
    cache.positions[:, slot] = pos
    ckv = cache.ckv.to(f32)
    # W_uk absorbed into q: q_lat (B,1,H,kvr)
    wuk = p["wuk"]["w"].reshape(kvr, H, dn).to(f32)
    q_lat = torch.einsum("bqhn,khn->bqhk", q_nope.to(f32), wuk)
    s = (torch.einsum("bqhk,bsk->bhqs", q_lat, ckv)
         + torch.einsum("bqhr,bsr->bhqs", q_rope.to(f32),
                        cache.k_rope.to(f32))) * (dn + dr) ** -0.5
    mask = _build_mask(positions, cache.positions,
                       cfg.sliding_window)[:, None]
    a = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)   # (B,H,1,S)
    o_lat = torch.einsum("bhqs,bsk->bqhk", a, ckv)
    wuv = p["wuv"]["w"].reshape(kvr, H, dv).to(f32)
    o = torch.einsum("bqhk,khv->bqhv", o_lat, wuv)
    return linear(p["wo"], o.reshape(B, 1, H * dv).to(x.dtype)), cache
