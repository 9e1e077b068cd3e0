"""Decoder-only language model assembly, generic over the architecture
zoo.

Port of ``src/repro/models/transformer.py`` for the ``scan`` plans.  The
layer stack is described by a *plan*: a list of segments, each a
contiguous run of ``n`` identical (mixer, ffn) blocks, ``("scan", kind,
n)``.  A segment's parameters and caches keep the JAX package's layout,
every leaf stacked along a leading layer axis of size ``n``; the JAX
package scans over that axis, the port loops over it.

Parameters are a nested dict of tensors (the JAX package's pytree, leaf
for leaf: linear weights ``(d_in, d_out)``), on which the functions
here work; :class:`LanguageModel` is the same tree as an
:class:`torch.nn.Module`.  They are drawn from a ``torch.Generator``
(:func:`init_params`) or carried across from the JAX package
(:func:`repro_torch.models.convert.params_from_jax`).

Text and audio (a token stream) are ported.  The zamba plan (a shared
attention block every few SSM layers), MoE FFNs, MLA attention and the
vlm frontend are not, and raise NotImplementedError naming the later
slice: that covers arctic-480b, deepseek-v3-671b, zamba2-7b and
llava-next-mistral-7b.
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

def build_plan(cfg):
    """Segment the layer stack into homogeneous runs."""
    if cfg.block_pattern == "zamba":
        blk._unported(f"the zamba plan ({cfg.name})")
    if cfg.n_experts:
        blk._unported(f"the MoE FFN ({cfg.name})")
    if cfg.attn_impl == "mla":
        blk._unported(f"MLA attention ({cfg.name})")
    if cfg.modality == "vlm":
        blk._unported(f"the vlm frontend ({cfg.name})")
    if cfg.block_pattern == "ssm":
        return [("scan", ("ssm", "none"), cfg.n_layers)]
    return [("scan", ("attn", "dense"), cfg.n_layers)]


def _index(tree, i):
    """Layer ``i`` of a stacked segment: every leaf indexed (views)."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, tuple):                    # a cache NamedTuple
        return type(tree)(*(t[i] for t in tree))
    return {k: _index(v, i) for k, v in tree.items()}


def _layers(params, plan):
    """(kind, layer params) of every layer, in order.  A segment given as
    a list holds one tree a layer (the trainer's per-layer leaves, see
    :func:`repro_torch.launch.steps.node_value_and_grad`) and is read as
    it is."""
    out = []
    for s, (_, kind, n) in enumerate(plan):
        seg = params[f"seg{s}"]
        out += [(kind, seg[j] if isinstance(seg, list) else _index(seg, j))
                for j in range(n)]
    return out


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
    for i, (_, kind, n) in enumerate(plan):
        params[f"seg{i}"] = blk.init_block(g, cfg, kind, device, lead=(n,))
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
    """``params`` with every linear weight and bias cast to the
    activation dtype ``cfg.dtype``, once, as the JAX package's serving
    specs do (``launch/specs.py``).  ``linear`` casts them at use anyway,
    so results do not change; norm scales, the embedding table (which
    ``unembed`` reads in f32), the conv and the SSM's f32 leaves keep
    their dtype."""
    dt = getattr(torch, cfg.dtype)

    def cast(tree):
        is_linear = "w" in tree
        return {k: (v.to(dt) if is_linear and k in ("w", "b") else v)
                if isinstance(v, torch.Tensor) else cast(v)
                for k, v in tree.items()}
    return cast(params)


# ----------------------------------------------------------------- forward

def embed_inputs(params, batch, cfg):
    """batch: {"tokens": (B, S)} → (x (B, S, d) in cfg.dtype,
    positions (B, S), each row arange(S))."""
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
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


def _block(p_layer, x, cfg, kind, positions):
    """One block, checkpointed as ``cfg.remat`` / ``cfg.remat_policy``
    ask while autograd records: "all" keeps only the block's inputs and
    recomputes the rest in the backward, "dots" keeps the matrix
    products' outputs too.  Recomputation runs the block's forward, its
    kernels included, a second time; values do not change."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return blk.block_forward(p_layer, x, cfg, kind, positions)
    context_fn = _save_dots if cfg.remat_policy == "dots" else noop_context_fn
    return checkpoint(blk.block_forward, p_layer, x, cfg, kind, positions,
                      use_reentrant=False, context_fn=context_fn)


def hidden_states(params, batch, cfg):
    """The full-sequence stack up to the final norm → (x (B, S, d),
    aux_loss scalar)."""
    x, positions = embed_inputs(params, batch, cfg)
    aux = torch.zeros((), dtype=f32, device=x.device)
    for kind, p_layer in _layers(params, build_plan(cfg)):
        x, da = _block(p_layer, x, cfg, kind, positions)
        aux = aux + da
    return rms_norm(params["final_norm"], x, cfg.norm_eps), aux


def forward(params, batch, cfg):
    """Full-sequence forward → (logits (B,S,V) f32, aux_loss scalar)."""
    x, aux = hidden_states(params, batch, cfg)
    return logits_of(params, x, cfg), aux


# ----------------------------------------------------------------- decode

class DecodeState(NamedTuple):
    caches: Any           # per segment: a cache with a leading layer axis
    shared_caches: Any    # zamba shared-attn caches (None: not ported)
    pos: int              # next position to write


def init_cache(cfg, batch, capacity, dtype=None, *, device=None):
    """Allocate the full decode state. ``capacity`` = KV slots (SSM
    caches are O(1) anyway); ``dtype`` a dtype name, default
    ``cfg.dtype``."""
    device = resolve_device(device)
    dtype = getattr(torch, dtype or cfg.dtype)
    caches = [blk.block_init_cache(cfg, kind, batch, capacity, dtype, device,
                                   lead=(n,))
              for _, kind, n in build_plan(cfg)]
    return DecodeState(caches=caches, shared_caches=None, pos=0)


def decode_step(params, state: DecodeState, tokens, cfg):
    """One decode step. tokens: (B, 1) → (logits (B,1,V), new state).
    The caches are updated in place: the new state holds the same cache
    tensors and ``pos + 1``."""
    x = embed(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    pos = state.pos
    plan = build_plan(cfg)
    for s, (_, kind, n) in enumerate(plan):
        seg = params[f"seg{s}"]
        for j in range(n):
            x, _ = blk.block_decode(_index(seg, j), x, cfg, kind,
                                    _index(state.caches[s], j), pos)
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
