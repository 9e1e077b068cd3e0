"""Doubly-stochastic mixing (weight) matrices W for the AGREE protocol.

The port's own copy of the dense builders of
``src/repro/distributed/mixing.py`` (pure numpy, bit-identical matrices
for the same graph).  The paper (Sec. III) uses the equal-neighbor rule
``W_gj = 1/deg_g`` for j ∈ N_g; Metropolis–Hastings weights are doubly
stochastic on *any* graph.  ``gamma(W) = max(|λ₂|, |λ_L|)`` is the
consensus contraction factor of Proposition 1.

:class:`SparseWeights` — COO off-diagonal edges and a separate diagonal,
host numpy, the reference's arrays bit for bit — is the form the
virtual-node mesh tier decomposes (``SparseWeights.from_dense``).  The
``*_sparse`` builders, which make one straight from a sparse graph,
belong to the sparse tier, which this package does not have yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.distributed.graphs import DENSE_MATERIALIZE_MAX, Graph


@dataclasses.dataclass(frozen=True)
class SparseWeights:
    """A mixing matrix in sparse form (host numpy, static metadata).

    ``rows``/``cols``/``vals`` are the off-diagonal entries in COO
    layout, sorted by (row, col); ``diag`` is the (L,) diagonal kept
    separate (the self weight never crosses a wire, and every combine
    rule treats it specially).  The sparsity PATTERN must be symmetric
    (undirected graphs); the values need not be."""
    n: int
    rows: np.ndarray   # (nnz,) int32 — receiver
    cols: np.ndarray   # (nnz,) int32 — sender
    vals: np.ndarray   # (nnz,) float64
    diag: np.ndarray   # (L,)  float64

    def __post_init__(self):
        rows = np.asarray(self.rows, dtype=np.int32)
        cols = np.asarray(self.cols, dtype=np.int32)
        vals = np.asarray(self.vals, dtype=np.float64)
        diag = np.asarray(self.diag, dtype=np.float64)
        order = np.lexsort((cols, rows))
        if not np.array_equal(order, np.arange(order.size)):
            rows, cols, vals = rows[order], cols[order], vals[order]
        for name, arr in (("rows", rows), ("cols", cols), ("vals", vals)):
            object.__setattr__(self, name, arr)
        object.__setattr__(self, "diag", diag)
        if not (rows.shape == cols.shape == vals.shape):
            raise ValueError("rows/cols/vals must share a shape")
        if diag.shape != (self.n,):
            raise ValueError(f"diag must be ({self.n},), got {diag.shape}")
        if rows.size:
            if rows.min() < 0 or rows.max() >= self.n \
                    or cols.min() < 0 or cols.max() >= self.n:
                raise ValueError("edge index out of range")
            if np.any(rows == cols):
                raise ValueError("diagonal entries belong in .diag")

    @classmethod
    def from_dense(cls, W) -> "SparseWeights":
        """The nonzero off-diagonal entries of a square host matrix."""
        Wn = np.asarray(W, dtype=np.float64)
        if Wn.ndim != 2 or Wn.shape[0] != Wn.shape[1]:
            raise ValueError(f"mixing matrix must be square, got {Wn.shape}")
        off = Wn - np.diag(np.diag(Wn))
        rows, cols = np.nonzero(off)
        return cls(n=Wn.shape[0], rows=rows.astype(np.int32),
                   cols=cols.astype(np.int32), vals=off[rows, cols],
                   diag=np.diag(Wn).copy())

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def nnz(self) -> int:
        return self.vals.size

    @property
    def n_edges(self) -> int:
        """Undirected edge count of the sparsity pattern."""
        return self.nnz // 2

    @property
    def density(self) -> float:
        return self.nnz / (self.n * (self.n - 1)) if self.n > 1 else 0.0

    def row_sums(self) -> np.ndarray:
        return self.diag + np.bincount(self.rows, weights=self.vals,
                                       minlength=self.n)

    def col_sums(self) -> np.ndarray:
        return self.diag + np.bincount(self.cols, weights=self.vals,
                                       minlength=self.n)

    def to_dense(self) -> np.ndarray:
        if self.n > DENSE_MATERIALIZE_MAX:
            raise ValueError(
                f"refusing to densify a {self.n}×{self.n} mixing matrix "
                f"(> DENSE_MATERIALIZE_MAX={DENSE_MATERIALIZE_MAX})")
        W = np.zeros((self.n, self.n))
        W[self.rows, self.cols] = self.vals
        W[np.diag_indices(self.n)] = self.diag
        return W


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
