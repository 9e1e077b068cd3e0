"""Gossip over the leading (node) axis of one process — the AGREE
protocol's circulant round

    Z_g ← w_self · Z_g + Σ_k w_k · Z_{g+s_k (mod L)}

(= ``Z ← W Z`` for the circulant W of :mod:`repro_torch.distributed.mixing`),
each shift a ``torch.roll``.  Port of ``roll_gossip`` of
``src/repro/distributed/gossip.py``; its mesh form, one node per rank,
is the gossip rule's mesh mixer
(:meth:`repro_torch.distributed.consensus.CombineRule.make_mesh_mixer`).
Both bottom out in the consensus layer's (K+1)-way combine
(:func:`repro_torch.distributed.consensus.combine_blocks`): one
``gossip_combine`` launch per round on the cuda backend.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.distributed.consensus import (CombineRule, _fused_wanted,
                                               get_rule, place_weights)


def _tree_map(fn, tree):
    """``fn`` on every tensor of a tensor or a (nested) dict, list or
    tuple of tensors."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def roll_gossip(tree, T_con: int, shifts: Sequence[int] = (-1, 1),
                self_weight: float | None = None, *, W=None,
                backend: str = "torch-ref"):
    """T_con gossip rounds over the leading (node) axis of every tensor
    of ``tree`` (a tensor, or a dict, list or tuple of them, on one
    device).

    Without ``W`` this is the uniform circulant mixer of ``shifts`` /
    ``self_weight``.  Pass ``W=`` — any concrete (L, L) mixing matrix —
    to gossip with the matrix's own weights: it decomposes into cyclic
    shifts plus per-node weight rows; a circulant matrix collapses to
    shared scalar weights, which take the ``gossip_combine`` kernel on
    cuda (weights uploaded once per call), while an irregular matrix
    rolls with an (L, K+1) table on the sequential chain.  Tensors whose
    leading axis disagrees with W's size raise ValueError."""
    if T_con == 0:
        return tree
    rule = get_rule("gossip")
    leaves = _leaves(tree)
    if W is not None:
        L = W.shape[0]
        shifts, weights = rule._mesh_weights(L, (), None, W)
        bad = sorted({x.shape[0] for x in leaves if x.shape[:1] != (L,)})
        if bad:
            raise ValueError(
                f"roll_gossip W= is {L}×{L} but tensors have leading (node) "
                f"axes {bad} — every tensor must carry one row per node")
    else:
        sw, wn = CombineRule._ring_weights(shifts, self_weight)
        weights = (sw,) + (wn,) * len(shifts)
    if isinstance(weights, tuple):
        exact, f32 = place_weights(weights, leaves[0].device)
    else:
        exact = f32 = torch.as_tensor(weights, device=leaves[0].device)

    def one(x):
        w = f32 if _fused_wanted(backend, x.dtype) else exact
        return rule.roll_round(x, shifts, w, backend=backend)

    for _ in range(T_con):
        tree = _tree_map(one, tree)
    return tree

