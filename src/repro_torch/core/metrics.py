"""Subspace-distance and recovery metrics (paper Sec. II, Notations).

Port of ``src/repro/core/metrics.py``.  Every function takes a leading
batch axis where the JAX package vmaps (``subspace_distance`` of
(L, d, r) node bases against one U*), and returns tensors on the
operands' device, so a solver loop can keep its traces on the card.
"""
from __future__ import annotations

import torch


def subspace_distance(U1, U2):
    """SD₂(U1, U2) := ||(I − U1 U1ᵀ) U2||₂ (spectral norm), batched over
    U1's leading axes.  U1 and U2 must have orthonormal columns.
    Computed without forming the d×d projector:
    ||(I − P)U2||₂ = ||U2 − U1 (U1ᵀU2)||₂."""
    M = U2 - U1 @ (U1.mT @ U2)
    return torch.linalg.matrix_norm(M, ord=2)


def subspace_distance_F(U1, U2):
    """Frobenius-norm variant."""
    M = U2 - U1 @ (U1.mT @ U2)
    return torch.linalg.matrix_norm(M)


def task_error(theta_hat, theta_star):
    """Relative per-task error max_t ||θ̂_t − θ*_t|| / ||θ*_t||
    (Theorem 1.1).  theta_*: (d, T)."""
    num = torch.linalg.vector_norm(theta_hat - theta_star, dim=0)
    den = torch.linalg.vector_norm(theta_star, dim=0)
    return torch.max(num / den)


# Above this node count the exact pairwise diameter is replaced by the
# O(L·d·r) consensus radius (max deviation from the node mean), so no
# (L, L) buffer is ever built.
SPREAD_EXACT_MAX = 4096


def consensus_spread(U_nodes):
    """max_{g,g'} ||U_g − U_g'||_F over the node axis (UconsErr of
    Sec. IV).  U_nodes: (L, d, r).

    Above ``SPREAD_EXACT_MAX`` nodes this returns the consensus *radius*
    ``max_g ||U_g − Ū||_F`` instead of the pairwise diameter — the same
    quantity within a factor of 2 at O(L·d·r) memory."""
    if U_nodes.shape[0] <= SPREAD_EXACT_MAX:
        diff = U_nodes[:, None] - U_nodes[None, :]
        return torch.max(torch.sqrt(torch.sum(diff ** 2, dim=(-2, -1))))
    dev = U_nodes - torch.mean(U_nodes, dim=0, keepdim=True)
    return torch.max(torch.sqrt(torch.sum(dev ** 2, dim=(-2, -1))))
