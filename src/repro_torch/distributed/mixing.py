"""Doubly-stochastic mixing (weight) matrices W for the AGREE protocol.

The port's own copy of the dense builders of
``src/repro/distributed/mixing.py`` (pure numpy, bit-identical matrices
for the same graph).  The paper (Sec. III) uses the equal-neighbor rule
``W_gj = 1/deg_g`` for j ∈ N_g; Metropolis–Hastings weights are doubly
stochastic on *any* graph.  ``gamma(W) = max(|λ₂|, |λ_L|)`` is the
consensus contraction factor of Proposition 1.

The sparse representation (``SparseWeights`` and the ``*_sparse``
builders) belongs to the sparse tier, which this package does not have
yet.
"""
from __future__ import annotations

import numpy as np

from repro_torch.distributed.graphs import Graph


def equal_neighbor_weights(graph: Graph) -> np.ndarray:
    """The paper's AGREE update written as a mixing matrix:
    W = I - D^{-1} L_graph  (row-stochastic always; doubly stochastic iff the
    graph is regular)."""
    a = graph.adj.astype(np.float64)
    deg = np.maximum(a.sum(axis=1), 1.0)
    w = a / deg[:, None]
    w[np.diag_indices_from(w)] = 1.0 - w.sum(axis=1)
    return w


def metropolis_weights(graph: Graph) -> np.ndarray:
    """Metropolis–Hastings weights: symmetric & doubly stochastic on any
    connected graph.  W_ij = 1/(1+max(d_i,d_j)) for edges."""
    a = graph.adj.astype(np.float64)
    deg = a.sum(axis=1)
    L = graph.n_nodes
    w = np.zeros((L, L))
    ii, jj = np.nonzero(np.triu(a, 1))
    for i, j in zip(ii, jj):
        w[i, j] = w[j, i] = 1.0 / (1.0 + max(deg[i], deg[j]))
    w[np.diag_indices_from(w)] = 1.0 - w.sum(axis=1)
    return w


def lazy_weights(graph: Graph, beta: float = 0.5) -> np.ndarray:
    """Lazy variant W_lazy = (1-beta) I + beta W_metropolis — guarantees
    gamma < 1 even on bipartite graphs."""
    w = metropolis_weights(graph)
    return (1.0 - beta) * np.eye(graph.n_nodes) + beta * w


def circulant_weights(L: int, shifts: tuple[int, ...] = (-1, 1),
                      self_weight: float | None = None) -> np.ndarray:
    """Circulant mixing matrix on a ring-like topology: node i averages with
    i+s for s in shifts.  Default: symmetric ring with weights
    (1-sw)/len(shifts) per neighbour."""
    k = len(shifts)
    sw = self_weight if self_weight is not None else 1.0 / (k + 1)
    wn = (1.0 - sw) / k
    w = np.eye(L) * sw
    for s in shifts:
        idx = (np.arange(L) + s) % L
        w[np.arange(L), idx] += wn
    return w


def gamma(w: np.ndarray) -> float:
    """gamma(W) := max(|λ₂|, |λ_L|) — the consensus contraction factor."""
    ev = np.linalg.eigvals(w)
    ev = np.sort(np.abs(ev))[::-1]
    if len(ev) == 1:
        return 0.0
    return float(ev[1])


def is_doubly_stochastic(w: np.ndarray, tol: float = 1e-9) -> bool:
    return (np.all(w >= -tol)
            and np.allclose(w.sum(axis=0), 1.0, atol=1e-8)
            and np.allclose(w.sum(axis=1), 1.0, atol=1e-8))
