"""Sharding rules: Megatron-style tensor parallelism over the 'model'
axis, and the decentralized node axis over ('pod', 'data') for
training.  Port of ``src/repro/launch/sharding.py``.

A spec is a plain tuple with one entry a dimension: ``None``, an axis
name, or a tuple of axis names — the reference's ``PartitionSpec`` read
as a tuple (a one-name tuple collapses to the name, as a
``PartitionSpec`` normalizes it).  Parameter leaves are classified by
their path (``transformer.leaves``' ``seg0/mixer/wq/w``):
  column-parallel (output dim on 'model'): wq wk wv wuq wuk wuv gate up
      in_proj lm_head
  row-parallel (input dim on 'model'):     wo down out_proj
  expert-parallel (expert dim on 'model'): experts/{gate,up,down}
  vocab-sharded:                           embed table
  replicated:                              norms, biases, router, conv,
                                           A_log, dt_bias, D

Leaves may carry leading [node] and/or [layer-stack] axes before the
matrix dims; rules always address the TRAILING dims, so they compose
with the stacked segments and the node axis.  :func:`local_shape` is one
device's block of a leaf under its spec, which the dry run reads in
place of XLA's partitioner.
"""
from __future__ import annotations

import re

import torch

from repro_torch.utils.trees import tree_map_with_path

COL_PAT = re.compile(
    r"(wq|wk|wv|wuq|wuk|wuv|wdq|wdkv|in_proj|lm_head|gate|up)(/w)?$")
ROW_PAT = re.compile(r"(wo|down|out_proj)(/w)?$")
EMBED_PAT = re.compile(r"embed/table$")
EXPERT_PAT = re.compile(r"experts/(gate|up|down)$")


def _entry(e):
    """One spec entry as a ``PartitionSpec`` keeps it: a one-name tuple
    is the name."""
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def spec(*entries) -> tuple:
    return tuple(_entry(e) for e in entries)


def axis_names(entry) -> tuple:
    """The mesh axes a spec entry names: () for None."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _pad_spec(leaf_ndim: int, trailing: tuple, lead) -> tuple:
    """[lead] on axis 0 (or None), None-padding, then the trailing
    entries on the last len(trailing) dims."""
    out = [None] * leaf_ndim
    if lead is not None and leaf_ndim > 0:
        out[0] = lead
    for i, s in enumerate(trailing):
        idx = leaf_ndim - len(trailing) + i
        if idx == 0 and lead is not None:
            continue            # never double-assign dim 0
        if s is not None:
            out[idx] = s
    return spec(*out)


def param_spec_for(path: str, shape: tuple, model_size: int,
                   lead=None) -> tuple:
    """``lead``: mesh axes for the node dimension (dim 0), or None
    (serving).

    Divisibility-aware: a rule fires only if its target dim divides
    evenly by the 'model' axis size, else it falls back (col → row →
    replicate): mamba2's in_proj output (2·d_inner+2N+H) is never a
    multiple of 16, so it shards its INPUT dim (row-parallel) instead."""
    ndim = len(shape)

    def div(dim_from_end: int) -> bool:
        idx = ndim - dim_from_end
        return idx >= 0 and shape[idx] % model_size == 0

    if EXPERT_PAT.search(path):
        if div(3):                   # experts (E, d, ff): E on 'model'
            return _pad_spec(ndim, ("model", None, None), lead)
        return _pad_spec(ndim, (), lead)
    if EMBED_PAT.search(path):
        if div(2):                   # vocab-sharded
            return _pad_spec(ndim, ("model", None), lead)
        if div(1):                   # fallback: shard d_model
            return _pad_spec(ndim, (None, "model"), lead)
        return _pad_spec(ndim, (), lead)
    if COL_PAT.search(path):
        if div(1):
            return _pad_spec(ndim, (None, "model"), lead)
        if div(2):                   # fallback row-parallel
            return _pad_spec(ndim, ("model", None), lead)
        return _pad_spec(ndim, (), lead)
    if ROW_PAT.search(path):
        if div(2):
            return _pad_spec(ndim, ("model", None), lead)
        if div(1):
            return _pad_spec(ndim, (None, "model"), lead)
        return _pad_spec(ndim, (), lead)
    return _pad_spec(ndim, (), lead)


def _add_fsdp(s: tuple, shape: tuple, fsdp_axes: tuple,
              fsdp_size: int) -> tuple:
    """Serving FSDP: fill ONE unsharded trailing matrix dim (of the last
    three) with the data axes, largest first — the weights then shard
    over the whole mesh, the only layout in which the big archs fit."""
    entries = list(s) + [None] * (len(shape) - len(s))
    cand = [i for i in range(max(len(shape) - 3, 0), len(shape))
            if entries[i] is None and shape[i] % fsdp_size == 0
            and shape[i] >= fsdp_size]
    if cand:
        i = max(cand, key=lambda j: shape[j])
        entries[i] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
    return spec(*entries)


def param_specs(params, lead=None, model_size: int = 16, fsdp_axes=None,
                fsdp_size: int = 16):
    """The spec tree of ``params`` (a tree of tensors, meta ones
    included: the parameters, or an optimizer state over them).

    ``lead``: node-axis mesh axes on dim 0 of every leaf (the training
    layout — each node holds its own replica, sharded over 'model'
    only).  ``fsdp_axes``: the serving layout — one matrix dim of every
    weight of at least 2**16 entries also sharded over the data axes."""
    lead_ = tuple(lead) if lead else None
    fsdp = tuple(fsdp_axes) if fsdp_axes else None

    def one(path, leaf):
        shape = tuple(leaf.shape)
        s = param_spec_for(path, shape, model_size, lead_)
        if fsdp and leaf.ndim >= 2 and leaf.numel() >= 1 << 16:
            s = _add_fsdp(s, shape, fsdp, fsdp_size)
        return s
    return tree_map_with_path(one, params)


def batch_specs(batch, lead):
    """Batch spec tree: the leading (node or batch) dim over ``lead``."""
    lead_ = tuple(lead) if lead else None
    return tree_map_with_path(lambda _, leaf: _pad_spec(leaf.ndim, (), lead_),
                              batch)


def cache_specs(state, batch_axes, cfg, shard_heads: bool = True,
                shard_slots: bool = False):
    """Decode-state specs, built structurally from the decode plan
    (:func:`repro_torch.models.transformer.build_plan`): a
    :class:`~repro_torch.models.transformer.DecodeState` of
    :class:`~repro_torch.models.attention.KVCache`,
    :class:`~repro_torch.models.attention.MLACache` and
    :class:`~repro_torch.models.ssm.SSMCache` of specs.  ``state`` is
    not read (the reference's signature).

    Per cache class (after its leading layer axes):
      KVCache   k/v (…,B,cap,Hkv,Dh) → batch on data axes, heads on 'model'
      MLACache  ckv/k_rope (…,B,cap,r) → batch only (a per-token latent:
                nothing per head to shard)
      SSMCache  conv (…,B,K−1,ch) → batch; state (…,B,H,P,N) → batch +
                heads on 'model'
    ``shard_slots`` puts the KV capacity dim on 'model' instead of the
    heads (the same axis, so the two exclude each other)."""
    from repro_torch.models.attention import KVCache, MLACache
    from repro_torch.models.ssm import SSMCache
    from repro_torch.models.transformer import DecodeState, build_plan

    lead = tuple(batch_axes) if batch_axes else None
    slots = "model" if shard_slots else None
    model = "model" if (shard_heads and not shard_slots) else None

    def kv(extra: int):
        e = (None,) * extra
        return KVCache(k=spec(*e, lead, slots, model, None),
                       v=spec(*e, lead, slots, model, None),
                       positions=spec(*e, lead, slots))

    def mla(extra: int):
        e = (None,) * extra
        return MLACache(ckv=spec(*e, lead, slots, None),
                        k_rope=spec(*e, lead, slots, None),
                        positions=spec(*e, lead, slots))

    def ssm(extra: int):
        e = (None,) * extra
        return SSMCache(conv=spec(*e, lead, None, None),
                        state=spec(*e, lead, model, None, None))

    caches, shared = [], None
    for seg in build_plan(cfg):
        if seg[0] == "scan":
            if seg[1][0] == "attn":
                caches.append(mla(1) if cfg.attn_impl == "mla" else kv(1))
            else:
                caches.append(ssm(1))
        else:
            caches.append(ssm(2))              # (n_groups, period, …)
            shared = kv(1)                     # (n_groups, …)
    return DecodeState(caches=caches, shared_caches=shared, pos=())


def local_shape(shape, s: tuple, mesh) -> tuple:
    """One device's block of a leaf of ``shape`` under spec ``s`` on
    ``mesh``: each dim divided (rounded up) by the sizes of the axes its
    entry names."""
    sizes = mesh.shape
    out = list(shape)
    for i, e in enumerate(s):
        for a in axis_names(e):
            out[i] = -(-out[i] // sizes[a])
    return tuple(out)


def local_bytes(leaf: torch.Tensor, s: tuple, mesh) -> int:
    """Bytes of one device's block of ``leaf`` under spec ``s``."""
    n = 1
    for d in local_shape(tuple(leaf.shape), s, mesh):
        n *= d
    return n * leaf.element_size()
