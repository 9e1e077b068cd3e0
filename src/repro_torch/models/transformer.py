"""Decoder-only language model assembly, generic over the architecture
zoo.

Port of ``src/repro/models/transformer.py``.  The layer stack is
described by a *plan*: a list of segments, each a contiguous run of
layers with identical block structure:
  ("scan", kind, n)            — n identical (mixer, ffn) blocks;
  ("zamba", n_groups, period)  — n_groups × [period ssm blocks + ONE
                                 weight-tied shared-attention block]
                                 (Zamba2; the shared block's weights live
                                 once at the top level, "shared_attn").
A segment's parameters and caches keep the JAX package's layout, every
leaf stacked along the segment's layer axes — (n,) for a scan, (n_groups,
period) for a zamba segment; the JAX package scans over them, the port
loops.

Parameters are a nested dict of tensors (the JAX package's pytree, leaf
for leaf: linear weights ``(d_in, d_out)``), on which the functions
here work; :class:`LanguageModel` is the same tree as an
:class:`torch.nn.Module`.  They are drawn from a ``torch.Generator``
(:func:`init_params`) or carried across from the JAX package
(:func:`repro_torch.models.convert.params_from_jax`).

Modalities (stub frontends, :mod:`repro_torch.models.frontends`): text
and audio are token ids (B, S) through the embedding table; vlm
prepends pre-projected patch embeddings ``vis_embed`` (B, S_vis, d) to
the text's token embeddings.  Decode is token-only.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.api.runner import resolve_device
from repro_torch.models import blocks as blk
from repro_torch.models.layers import (
    embed, init_embedding, init_linear, init_rms_norm, linear, rms_norm,
    unembed,
)

f32 = torch.float32


# ----------------------------------------------------------------- plan

SSM_ONLY = ("ssm", "none")


def build_plan(cfg):
    """Segment the layer stack into homogeneous runs."""
    if cfg.block_pattern == "zamba":
        period = cfg.shared_attn_period
        n_groups, rest = divmod(cfg.n_layers, period)
        plan = []
        if n_groups:
            plan.append(("zamba", n_groups, period))
        if rest:
            plan.append(("scan", SSM_ONLY, rest))
        return plan
    if cfg.block_pattern == "ssm":
        return [("scan", SSM_ONLY, cfg.n_layers)]
    # attention backbones, possibly with leading dense layers before MoE
    if not cfg.n_experts:
        return [("scan", ("attn", "dense"), cfg.n_layers)]
    k = min(cfg.first_dense_layers, cfg.n_layers)
    plan = [("scan", ("attn", "dense"), k)] if k else []
    return plan + [("scan", ("attn", "moe"), cfg.n_layers - k)]


def layer_axes(seg) -> tuple[int, ...]:
    """The layer axes that lead every leaf of segment ``seg``: (n,) for a
    scan, (n_groups, period) for a zamba segment."""
    return (seg[2],) if seg[0] == "scan" else (seg[1], seg[2])


def _index(tree, i):
    """Entry ``i`` of a segment's leading layer axis: every leaf indexed
    (views).  A segment given as a list holds one tree an entry (the
    trainer's per-layer leaves, see
    :func:`repro_torch.launch.steps.node_value_and_grad`) and is read as
    it is."""
    if isinstance(tree, (list, torch.Tensor)):
        return tree[i]
    if isinstance(tree, tuple):                    # a cache NamedTuple
        return type(tree)(*(t[i] for t in tree))
    return {k: _index(v, i) for k, v in tree.items()}


# ----------------------------------------------------------------- params

def init_params(cfg, *, seed: int = 0, generator=None, device=None):
    """Random weights for ``cfg`` in its ``param_dtype``, drawn on
    ``device`` (the card unless asked otherwise) from ``generator`` or a
    generator seeded with ``seed``.  The draws are the port's own: they
    cannot replay the JAX package's ``jax.random`` stream."""
    device = resolve_device(device)
    g = generator
    if g is None and device.type != "meta":
        g = torch.Generator(device=device).manual_seed(seed)
    plan = build_plan(cfg)
    dt = getattr(torch, cfg.param_dtype)
    params: dict[str, Any] = {
        "embed": init_embedding(g, cfg.vocab_size, cfg.d_model, dt, device),
        "final_norm": init_rms_norm(cfg.d_model, dt, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(g, cfg.d_model, cfg.vocab_size, dt,
                                        device)
    if cfg.block_pattern == "zamba":
        params["shared_attn"] = blk.init_shared_attn(g, cfg, device)
    for i, seg in enumerate(plan):
        kind = seg[1] if seg[0] == "scan" else SSM_ONLY
        params[f"seg{i}"] = blk.init_block(g, cfg, kind, device,
                                           lead=layer_axes(seg))
    return params


def leaves(tree, prefix=""):
    """(path, tensor) of every leaf, depth first, keys in order."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    return [leaf for k, v in tree.items()
            for leaf in leaves(v, f"{prefix}/{k}" if prefix else k)]


def count_params(params) -> int:
    return sum(t.numel() for _, t in leaves(params))


def serving_params(params, cfg):
    """``params`` with every linear weight and bias and the MoE expert
    stacks cast to the activation dtype ``cfg.dtype``, once, as the JAX
    package's serving specs do (``launch/specs.py``).  ``linear`` and
    ``moe_forward`` cast them at use anyway, so results do not change;
    norm scales, the embedding table (which ``unembed`` reads in f32),
    the MoE router (f32 by design), the conv and the SSM's f32 leaves
    keep their dtype.

    The cast is IN PLACE, one leaf at a time: each cast leaf replaces
    its entry in ``params`` (nested dicts), which is returned, so the
    old leaf is freed as soon as its copy exists if nothing else holds
    it — a model whose weights and their cast copy would not fit
    together (a MoE cut at full width) still gets its serving copy."""
    dt = getattr(torch, cfg.dtype)

    def cast(tree, name):
        is_linear = "w" in tree
        for k, v in tree.items():
            if not isinstance(v, torch.Tensor):
                cast(v, k)
            elif name == "experts" or (is_linear and k in ("w", "b")):
                tree[k] = v.to(dt)
        return tree
    return cast(params, "")


# ----------------------------------------------------------------- forward

def embed_inputs(params, batch, cfg):
    """batch: {"tokens": (B, S)} or vlm {"tokens": (B, S_text),
    "vis_embed": (B, S_vis, d)} → (x (B, S, d) in cfg.dtype, the patch
    embeddings first; positions (B, S), each row arange(S))."""
    dt = getattr(torch, cfg.dtype)
    x = embed(params["embed"], batch["tokens"]).to(dt)
    if cfg.modality == "vlm" and "vis_embed" in batch:
        x = torch.cat([batch["vis_embed"].to(dt), x], dim=1)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    return x, positions


def logits_of(params, x, cfg):
    """The LM head on final-normed hidden states → f32 logits."""
    if cfg.tie_embeddings:
        return unembed(params["embed"], x)
    return linear(params["lm_head"], x).to(f32)


# the matrix products that remat policy "dots" keeps (the JAX package's
# dots_saveable: every dot_general's output); ``x @ w`` and einsum reach
# autograd as these
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots():
    return create_selective_checkpoint_contexts(list(_DOTS))


def _remat(fn, cfg, *args):
    """``fn(*args)`` — one block, or one zamba group — checkpointed as
    ``cfg.remat`` / ``cfg.remat_policy`` ask while autograd records:
    "all" keeps only its inputs and recomputes the rest in the backward,
    "dots" keeps the matrix products' outputs too.  Recomputation runs
    the forward, its kernels included, a second time; values do not
    change."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    context_fn = _save_dots if cfg.remat_policy == "dots" else noop_context_fn
    return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)


def _zamba_group(p_group, p_shared, x, cfg, period, positions):
    """``period`` SSM blocks, then the shared attention block."""
    aux = torch.zeros((), dtype=f32, device=x.device)
    for j in range(period):
        x, da = blk.block_forward(_index(p_group, j), x, cfg, SSM_ONLY,
                                  positions)
        aux = aux + da
    return blk.shared_attn_forward(p_shared, x, cfg, positions), aux


def hidden_states(params, batch, cfg):
    """The full-sequence stack up to the final norm → (x (B, S, d),
    aux_loss scalar)."""
    x, positions = embed_inputs(params, batch, cfg)
    aux = torch.zeros((), dtype=f32, device=x.device)
    for s, seg in enumerate(build_plan(cfg)):
        seg_params = params[f"seg{s}"]
        for i in range(layer_axes(seg)[0]):
            if seg[0] == "scan":
                x, da = _remat(blk.block_forward, cfg, _index(seg_params, i),
                               x, cfg, seg[1], positions)
            else:
                x, da = _remat(_zamba_group, cfg, _index(seg_params, i),
                               params["shared_attn"], x, cfg, seg[2],
                               positions)
            aux = aux + da
    return rms_norm(params["final_norm"], x, cfg.norm_eps), aux


def forward(params, batch, cfg):
    """Full-sequence forward → (logits (B,S,V) f32, aux_loss scalar)."""
    x, aux = hidden_states(params, batch, cfg)
    return logits_of(params, x, cfg), aux


# ----------------------------------------------------------------- decode

class DecodeState(NamedTuple):
    caches: Any           # per segment: a cache stacked like its params
    shared_caches: Any    # zamba: the shared block's KV cache, one a
    #                       group (leading axis n_groups); else None
    pos: int              # next position to write


def init_cache(cfg, batch, capacity, dtype=None, *, device=None):
    """Allocate the full decode state. ``capacity`` = KV slots (SSM
    caches are O(1) anyway); ``dtype`` a dtype name, default
    ``cfg.dtype``."""
    device = resolve_device(device)
    dtype = getattr(torch, dtype or cfg.dtype)
    caches, shared = [], None
    for seg in build_plan(cfg):
        kind = seg[1] if seg[0] == "scan" else SSM_ONLY
        caches.append(blk.block_init_cache(cfg, kind, batch, capacity, dtype,
                                           device, lead=layer_axes(seg)))
        if seg[0] == "zamba":
            shared = blk.block_init_cache(cfg, ("attn", "dense"), batch,
                                          capacity, dtype, device,
                                          lead=(seg[1],))
    return DecodeState(caches=caches, shared_caches=shared, pos=0)


def decode_step(params, state: DecodeState, tokens, cfg):
    """One decode step. tokens: (B, 1) → (logits (B,1,V), new state).
    The caches are updated in place: the new state holds the same cache
    tensors and ``pos + 1``."""
    x = embed(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    pos = state.pos
    for s, seg in enumerate(build_plan(cfg)):
        seg_params, cache = params[f"seg{s}"], state.caches[s]
        if seg[0] == "scan":
            for j in range(seg[2]):
                x, _ = blk.block_decode(_index(seg_params, j), x, cfg,
                                        seg[1], _index(cache, j), pos)
            continue
        _, n_groups, period = seg
        for i in range(n_groups):
            p_group, c_group = _index(seg_params, i), _index(cache, i)
            for j in range(period):
                x, _ = blk.block_decode(_index(p_group, j), x, cfg, SSM_ONLY,
                                        _index(c_group, j), pos)
            x, _ = blk.shared_attn_decode(params["shared_attn"], x, cfg,
                                          _index(state.shared_caches, i),
                                          pos)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return logits_of(params, x, cfg), DecodeState(
        caches=state.caches, shared_caches=state.shared_caches, pos=pos + 1)


# ----------------------------------------------------------------- module

class ParamTree(nn.Module):
    """A nested dict of tensors as a module: tensors become (frozen)
    parameters, dicts submodules; ``tree[key]``, ``key in tree`` and
    ``items()`` work as on the dict, so the functions above take it."""

    def __init__(self, tree):
        super().__init__()
        self._keys = tuple(tree)
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))
            else:
                self.add_module(k, ParamTree(v))

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key):
        return key in self._keys

    def items(self):
        return ((k, self[k]) for k in self._keys)


class LanguageModel(nn.Module):
    """A configuration and its parameters: the model the serving path
    runs.  ``params`` is the nested dict of :func:`init_params` (or of
    :func:`~repro_torch.models.convert.params_from_jax`), kept as it is
    (no copy) in a :class:`ParamTree`."""

    def __init__(self, cfg, params):
        super().__init__()
        build_plan(cfg)
        self.cfg = cfg
        self.params = ParamTree(params)

    @property
    def device(self) -> torch.device:
        return self.params["embed"]["table"].device

    def forward(self, tokens):
        """tokens (B, S) → logits (B, S, V) f32."""
        return forward(self.params, {"tokens": tokens}, self.cfg)[0]

    def init_cache(self, batch, capacity):
        return init_cache(self.cfg, batch, capacity, device=self.device)

    def decode_step(self, state, tokens):
        return decode_step(self.params, state, tokens, self.cfg)
