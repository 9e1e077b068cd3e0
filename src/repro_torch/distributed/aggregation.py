"""Aggregation strategies — the paper's technique as a first-class feature
of the deep-net trainer.  Port of ``src/repro/distributed/aggregation.py``.

Every strategy operates on trees whose leaves carry a leading **node
axis** (n_nodes, ...), all on one device: the replicas of one process.
Gossip rounds are :func:`~repro_torch.distributed.gossip.roll_gossip`
rounds; 'allreduce' is the exact node mean (the fusion-center baseline).

| strategy    | paper algorithm        | comm per step              |
|-------------|------------------------|----------------------------|
| allreduce   | AltGDmin [10]          | 1 all-reduce (exact mean)  |
| consensus   | Dec-AltGDmin [9]       | T_con rounds of *grads*    |
| diffusion   | Dif-AltGDmin (paper)   | T_con rounds of *params*   |
| dgd         | DGD-variant (Exp. 1)   | 1 round of params          |
| topk        | Dif-AltGDmin + top-k   | T_con rounds, k entries    |
| quantized   | Dif-AltGDmin + quant   | T_con rounds, low-bit      |
| local       | no communication       | —                          |

The compressed strategies are the trainer-side counterparts of the
``topk_gossip`` / ``quantized_gossip`` CombineRules: the exchange runs
the stateless form of the compressor (top-k magnitude sparsification of
the sent copy; bfloat16 wire cast), and :func:`comm_bytes_per_step`
prices the step from the rule's :class:`CommSignature`.

The gossip rounds run on the kernel backend that the leaves' device
resolves to (:func:`repro_torch.kernels.ops.resolve_backend`): on CUDA
tensors at float32 or bfloat16 every round of a communicated leaf is ONE
``gossip_combine`` launch (the ring's circulant weights are shared
scalars); float64 and the torch-ref backend keep the exact sequential
chain.  The reference passes no backend, so it always takes its plain
chain.

The *federated carve-out*: leaves whose path matches one of
``local_patterns`` (task heads, embeddings) are never communicated —
they remain node-local, mirroring the paper's B_g that never leaves the
node.  Only the communicated leaves are mixed (the reference mixes every
leaf, then keeps the local ones as they were: the same values).
"""
from __future__ import annotations

import dataclasses
import re

import torch

from repro_torch.distributed import consensus as _consensus
from repro_torch.distributed.gossip import roll_gossip
from repro_torch.kernels import ops
from repro_torch.utils.trees import (tree_leaves, tree_map, tree_map_with_path,
                                     tree_unflatten)

STRATEGIES = ("allreduce", "diffusion", "consensus", "dgd", "topk",
              "quantized", "local")

# every strategy is one CombineRule applied to grads or params; the rule's
# CommSignature prices the wire cost (comm_bytes_per_step below)
RULE_FOR_STRATEGY = {"allreduce": "central", "diffusion": "gossip",
                     "consensus": "gossip", "dgd": "neighbor",
                     "topk": "topk_gossip", "quantized": "quantized_gossip",
                     "local": "none"}


@dataclasses.dataclass(frozen=True)
class AggregationConfig:
    strategy: str = "diffusion"
    t_con: int = 1                   # gossip rounds per step
    shifts: tuple = (-1, 1)          # ring topology by default
    self_weight: float | None = None
    local_patterns: tuple = ()       # param path regexes kept node-local
    wire_dtype: str | None = None    # cast to this dtype for the exchange
    #   (e.g. "bfloat16": halves gossip bytes; mixing still in f32)
    compression_k: int = 0           # topk: entries kept per leaf (0 → ¼)
    compression: str | None = None   # quantized: wire format (None → bf16)

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}; "
                             f"choose from {STRATEGIES}")
        if self.compression_k and self.strategy != "topk":
            raise ValueError("compression_k only applies to the 'topk' "
                             f"strategy, not {self.strategy!r}")
        if self.compression is not None and self.strategy != "quantized":
            raise ValueError("compression only applies to the 'quantized' "
                             f"strategy, not {self.strategy!r}")


def _split_local(tree, patterns):
    """Mask: True leaves are communicated, False stay local."""
    if not patterns:
        return tree_map(lambda _: True, tree)
    regs = [re.compile(p) for p in patterns]
    return tree_map_with_path(
        lambda path, _: not any(r.search(path) for r in regs), tree)


def _mix(tree, mask, mix_fn, wire_dtype=None):
    """``mix_fn`` (list of node-stacked tensors → list) over the
    communicated leaves, cast to ``wire_dtype`` for the exchange and back;
    the local leaves come back as they are."""
    leaves, keep = tree_leaves(tree), tree_leaves(mask)
    sent = [x for x, m in zip(leaves, keep, strict=True) if m]
    if wire_dtype is not None:
        wd = getattr(torch, wire_dtype)
        mixed = [m.to(x.dtype)
                 for m, x in zip(mix_fn([x.to(wd) for x in sent]), sent)]
    else:
        mixed = mix_fn(sent)
    it = iter(mixed)
    return tree_unflatten(tree, [next(it) if m else x
                                 for x, m in zip(leaves, keep)])


def _topk_sparsify(tree, k: int):
    """Stateless top-k compressor for the trainer exchange: every node
    keeps only its ``k`` largest-magnitude entries per leaf (0 → a
    quarter of the leaf, the ``topk_gossip`` rule's ``d // 4`` default)
    and sends zeros elsewhere; entries tied with the k-th are kept."""
    def spars(x):
        flat = x.reshape(x.shape[0], -1)          # (nodes, m)
        m = flat.shape[1]
        kk = min(int(k) or max(1, m // 4), m)
        if kk == m:
            return x
        mag = flat.abs()
        kth = torch.topk(mag, kk, dim=1, sorted=False).values.amin(
            dim=1, keepdim=True)
        return torch.where(mag >= kth, flat, 0.0).reshape(x.shape)
    return tree_map(spars, tree)


def _node_mean(tree):
    """Exact mean over the node axis, broadcast back (→ all-reduce)."""
    return tree_map(_consensus.node_mean, tree)


def _backend(tree) -> str:
    """The kernel backend of the tree's device (scope, env or auto)."""
    return ops.resolve_backend(None, tree_leaves(tree)[0].device)


def aggregate_gradients(grads, agg: AggregationConfig):
    """Pre-optimizer gradient communication (allreduce / consensus)."""
    mask = _split_local(grads, agg.local_patterns)
    if agg.strategy == "allreduce":
        return _mix(grads, mask, _node_mean, agg.wire_dtype)
    if agg.strategy == "consensus":
        backend = _backend(grads)
        return _mix(grads, mask,
                    lambda t: roll_gossip(t, agg.t_con, agg.shifts,
                                          agg.self_weight, backend=backend),
                    agg.wire_dtype)
    return grads          # diffusion / dgd / local: no grad communication


def aggregate_params(params, agg: AggregationConfig):
    """Post-optimizer parameter communication (diffusion / dgd)."""
    mask = _split_local(params, agg.local_patterns)
    backend = _backend(params)
    if agg.strategy in ("diffusion", "topk", "quantized"):
        wire = agg.wire_dtype
        if agg.strategy == "quantized" and wire is None:
            wire = "bfloat16"        # the rule's default bf16 wire format

        def mix_fn(t):
            if agg.strategy == "topk":
                t = _topk_sparsify(t, agg.compression_k)
            return roll_gossip(t, agg.t_con, agg.shifts, agg.self_weight,
                               backend=backend)
        return _mix(params, mask, mix_fn, wire)
    if agg.strategy == "dgd":
        # neighbour average EXCLUDING self (paper Experiment 1 formula)
        return _mix(params, mask,
                    lambda t: roll_gossip(t, 1, agg.shifts, self_weight=0.0,
                                          backend=backend),
                    agg.wire_dtype)
    return params         # allreduce / consensus / local


def pre_update(grads, agg: AggregationConfig):
    return aggregate_gradients(grads, agg)


def post_update(params, agg: AggregationConfig):
    return aggregate_params(params, agg)


def comm_bytes_per_step(n_params_communicated: int, itemsize: int,
                        agg: AggregationConfig, n_nodes: int) -> int:
    """Analytic per-step communication volume: bytes sent per node per
    step, from the strategy's CombineRule signature (gossip: t_con
    rounds × deg messages; neighbor: one exchange; central: the ring
    all-reduce volume).  The communicated entry count and the config's
    compression knobs go to the rule's ``signature``, so the compressed
    strategies price their actual wire format — top-k: k values + k
    indices per round; quantized: bf16/int8 entries."""
    sig = _consensus.get_rule(RULE_FOR_STRATEGY[agg.strategy]).signature(
        agg.t_con, d=n_params_communicated, r=1,
        compression_k=agg.compression_k, compression=agg.compression)
    return sig.bytes_per_iter(n_params_communicated, itemsize, n_nodes,
                              degree=len(agg.shifts))
