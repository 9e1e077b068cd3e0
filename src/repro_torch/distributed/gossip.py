"""Gossip over the leading (node) axis of one process — the AGREE
protocol's circulant round

    Z_g ← w_self · Z_g + Σ_k w_k · Z_{g+s_k (mod L)}

(= ``Z ← W Z`` for the circulant W of :mod:`repro_torch.distributed.mixing`),
in two forms.  Port of ``src/repro/distributed/gossip.py``:

  * :func:`roll_gossip` — nodes are the leading axis of one process's
    tensors; each shift a ``torch.roll`` (the trainer's form);
  * :func:`mesh_gossip` — nodes are the ranks of a
    :class:`~repro_torch.distributed.mesh.NodeMesh`, each holding its own
    block; each shift one ``ppermute`` (the counterpart of the
    reference's ``shard_map_gossip``), through the gossip rule's mesh
    mixer (:meth:`repro_torch.distributed.consensus.CombineRule.make_mesh_mixer`).

Both bottom out in the consensus layer's (K+1)-way combine
(:func:`repro_torch.distributed.consensus.combine_blocks`): one
``gossip_combine`` launch per round on the cuda backend.  Production
topologies are rings and tori; arbitrary graphs pass ``W=``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.distributed.consensus import (CombineRule, _fused_wanted,
                                               get_rule, place_weights)
from repro_torch.utils.trees import tree_leaves, tree_map


def ring_weights(shifts: Sequence[int] = (-1, 1),
                 self_weight: float | None = None):
    """(self weight, weight of each shift) of a symmetric circulant
    mixer: equal weights 1/(k+1) by default, the paper's equal-neighbour
    rule on a regular ring."""
    return CombineRule._ring_weights(shifts, self_weight)


def torus_shifts(rows: int, cols: int):
    """Neighbour shifts of a rows×cols torus flattened row-major: ±1 (same
    row, the wrap a flat modular shift) and ±cols."""
    return (-1, 1, -cols, cols)


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
    leaves = tree_leaves(tree)
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
        tree = tree_map(one, tree)
    return tree



def mesh_gossip(Z, mesh, T_con: int, shifts: Sequence[int] = (-1, 1),
                self_weight: float | None = None, *, W=None,
                backend: str = "torch-ref"):
    """AGREE over the ranks of ``mesh`` (a
    :class:`~repro_torch.distributed.mesh.NodeMesh`, one node a rank):
    ``Z`` is this rank's block; each of the ``T_con`` rounds fetches the
    neighbours' blocks by ``ppermute`` and combines them (one
    ``gossip_combine`` launch a round on cuda).  Pass ``W=`` (a concrete
    (L, L) mixing matrix, L the rank count) to gossip over any weighted
    topology instead of the uniform circulant of ``shifts``.  Every rank
    calls it together."""
    mixer = get_rule("gossip").make_mesh_mixer(
        mesh, T_con, shifts, self_weight, W=W, backend=backend)
    return mixer(Z)


def axis_mean(tree, mesh):
    """The fusion-center baseline on the mesh: every tensor of ``tree``
    replaced by its exact mean over the ranks (``psum`` / size)."""
    mix = get_rule("central").make_mesh_mixer(mesh, 0)
    return tree_map(mix, tree)
