"""Mixture-of-Experts FFN with sort-based capacity dispatch — covers
Arctic (128 experts top-2 + a dense residual) and DeepSeek-V3 (1 shared +
256 routed experts top-8, sigmoid router scores).

Port of ``src/repro/models/moe.py``.  Dispatch (token-dropping,
GShard-style capacity):
  1. router scores → top-k (expert, gate) per token;
  2. the (tokens × k) assignments sorted by expert id (stable);
  3. each assignment's position within its expert; positions at or past
     the capacity C = ceil(tokens·k/E · capacity_factor) (rounded up to
     8) are dropped into a bin at row E·C;
  4. tokens scattered into an (E·C + 1, d) buffer, every expert's SwiGLU
     run on its contiguous C rows as batched products over the stacked
     expert weights, gathered back with gate weighting and scatter-added
     to their tokens.

The JAX package computes the expert products as plain XLA einsums
outside any Pallas kernel, so the port's are plain ``torch.bmm``.
``torch.topk``'s order on tied scores is not specified where
``jax.lax.top_k`` keeps the lower index first; ties do not occur on
random f32 scores.  :func:`moe_forward_dense_fallback` evaluates every
expert densely: the oracle of the tests, never a serving path.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import he_normal, init_swiglu, swiglu

f32 = torch.float32


def init_moe(generator, cfg, device, lead=()):
    d, E, dff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    dt = getattr(torch, cfg.param_dtype)
    p = {
        "router": he_normal(generator, (*lead, d, E), d, f32, device),
        "experts": {
            "gate": he_normal(generator, (*lead, E, d, dff), d, dt, device),
            "up": he_normal(generator, (*lead, E, d, dff), d, dt, device),
            "down": he_normal(generator, (*lead, E, dff, d), dff, dt,
                              device),
        },
    }
    if cfg.n_shared_experts:
        p["shared"] = init_swiglu(generator, d,
                                  cfg.n_shared_experts * cfg.d_ff, dt,
                                  device, lead=lead)
    if cfg.dense_residual:
        p["dense"] = init_swiglu(generator, d, cfg.d_ff, dt, device,
                                 lead=lead)
    return p


def capacity(n_tokens: int, cfg) -> int:
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)          # round up to 8, at least 8


def router_probs(x, router_w, cfg):
    """(N, E) routing scores in f32, and the router logits."""
    logits = x.to(f32) @ router_w.to(f32)
    if cfg.router_score == "sigmoid_norm":     # deepseek-v3
        return torch.sigmoid(logits), logits
    return torch.softmax(logits, dim=-1), logits


def _route(xf, p, cfg):
    """Top-k gates (N, K) (sigmoid_norm: renormalized to sum 1), expert
    ids (N, K), and the router logits."""
    scores, logits = router_probs(xf, p["router"], cfg)
    gate_vals, expert_idx = torch.topk(scores, cfg.top_k, dim=-1)
    if cfg.router_score == "sigmoid_norm":
        gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    return gate_vals, expert_idx, logits


def _experts(w, h):
    """Every expert's SwiGLU on its rows: h (E, C, d) → (E, C, d)."""
    return torch.bmm(F.silu(torch.bmm(h, w["gate"])) * torch.bmm(h, w["up"]),
                     w["down"])


def _branches(p, xf, y):
    if "shared" in p:
        y = y + swiglu(p["shared"], xf)
    if "dense" in p:
        y = y + swiglu(p["dense"], xf)
    return y


def moe_forward(p, x, cfg):
    """x: (B, S, d) → (y (B, S, d), aux_loss f32 scalar): routed experts,
    plus the optional shared expert(s) and dense residual branch."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * S
    xf = x.reshape(N, d)
    gate_vals, expert_idx, logits = _route(xf, p, cfg)

    # ---- load-balance auxiliary loss (Switch-style) --------------------
    probs_mean = torch.mean(torch.softmax(logits, dim=-1), dim=0)   # (E,)
    flat_e = expert_idx.reshape(-1)                                 # (N·K,)
    # a scatter-add, not bincount: bincount reads its input's max on the
    # host, a device synchronize every layer
    counts = flat_e.new_zeros(E).scatter_add_(0, flat_e,
                                              torch.ones_like(flat_e))
    frac = counts.to(f32) / (N * K)
    aux = cfg.router_aux_coef * E * torch.sum(frac * probs_mean)

    # ---- sort-based dispatch -------------------------------------------
    C = capacity(N, cfg)
    flat_g = gate_vals.reshape(-1)
    flat_t = torch.arange(N, device=x.device).repeat_interleave(K)
    order = torch.argsort(flat_e, stable=True)
    se, sg, st = flat_e[order], flat_g[order], flat_t[order]
    start = torch.cumsum(counts, 0) - counts            # first row/expert
    pos = torch.arange(N * K, device=x.device) - start[se]
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)       # E·C = drop bin

    buf = x.new_zeros((E * C + 1, d)).index_put((slot,), xf[st])
    w = {k: v.to(x.dtype) for k, v in p["experts"].items()}
    out_rows = _experts(w, buf[:E * C].reshape(E, C, d)).reshape(E * C, d)
    gathered = torch.where(keep[:, None],
                           out_rows[torch.clamp(slot, max=E * C - 1)],
                           0.0) * sg[:, None].to(x.dtype)
    y = x.new_zeros((N, d)).index_add(0, st, gathered)
    return _branches(p, xf, y).reshape(B, S, d), aux


def moe_forward_dense_fallback(p, x, cfg):
    """Every expert evaluated densely and mixed by the top-k gates —
    what the dispatch computes when nothing is dropped.  O(E·N·d·dff):
    the tests' oracle at smoke shapes."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    gate_vals, expert_idx, _ = _route(xf, p, cfg)
    w = {k: v.to(x.dtype) for k, v in p["experts"].items()}
    h = (F.silu(torch.einsum("nd,edf->nef", xf, w["gate"]))
         * torch.einsum("nd,edf->nef", xf, w["up"]))      # (N, E, F)
    all_out = torch.einsum("nef,efd->ned", h, w["down"])  # (N, E, d)
    onehot = F.one_hot(expert_idx, cfg.n_experts).to(gate_vals.dtype)
    mix = torch.einsum("nk,nke->ne", gate_vals, onehot)
    y = torch.einsum("ne,ned->nd", mix.to(x.dtype), all_out)
    return _branches(p, xf, y).reshape(B, S, d)
