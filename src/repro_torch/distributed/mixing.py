"""Doubly-stochastic mixing (weight) matrices W for the AGREE protocol.

The port's own copy of the dense builders of
``src/repro/distributed/mixing.py`` (pure numpy, bit-identical matrices
for the same graph).  The paper (Sec. III) uses the equal-neighbor rule
``W_gj = 1/deg_g`` for j ∈ N_g; Metropolis–Hastings weights are doubly
stochastic on *any* graph.  ``gamma(W) = max(|λ₂|, |λ_L|)`` is the
consensus contraction factor of Proposition 1.

:class:`SparseWeights` — COO off-diagonal edges and a separate diagonal,
host numpy, the reference's arrays bit for bit — is the form of the
sparse consensus tier and the one the virtual-node mesh tier
decomposes.  The ``*_sparse`` builders make one straight from a sparse
graph in O(E), never allocating (L, L), and equal the reference's bit
for bit; :meth:`SparseWeights.power` is the ``W^{T_con}`` hoist (scipy
on the host), which declines past its fill budget.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.distributed.graphs import (DENSE_MATERIALIZE_MAX, Graph,
                                            SparseGraph)


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
        # the sparse tier's device operands and W^T hoists, made once per
        # instance (not a field: no part of equality or repr)
        object.__setattr__(self, "_cache", {})
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

    def __getstate__(self):
        # a pickled copy starts with an empty cache (no device tensors)
        return {**self.__dict__, "_cache": {}}

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

    def scipy_csr(self):
        """scipy.sparse CSR view (diagonal included) — the host-side
        form the ``W^{T_con}`` power hoist multiplies in."""
        import scipy.sparse as sp
        idx = np.arange(self.n, dtype=np.int32)
        return sp.csr_matrix(
            (np.concatenate([self.vals, self.diag]),
             (np.concatenate([self.rows, idx]),
              np.concatenate([self.cols, idx]))), shape=self.shape)

    def power(self, T: int, max_fill_factor: float = 8.0):
        """``W^T`` as a SparseWeights, or ``None`` when the power's
        fill-in exceeds ``max_fill_factor × max(nnz, L)`` stored entries
        — the budget past which hoisting T_con rounds into one product
        stops paying and the caller keeps the per-round sparse product."""
        if T < 1:
            raise ValueError(f"power needs T >= 1, got {T}")
        budget = max_fill_factor * max(self.nnz, self.n)
        A = self.scipy_csr()
        P = A
        for _ in range(T - 1):
            P = (P @ A).tocsr()
            P.eliminate_zeros()
            if P.nnz > budget:
                return None
        P = P.tocoo()
        off = P.row != P.col
        diag = np.zeros(self.n)
        diag[P.row[~off]] = P.data[~off]
        return SparseWeights(n=self.n, rows=P.row[off].astype(np.int32),
                             cols=P.col[off].astype(np.int32),
                             vals=P.data[off].astype(np.float64), diag=diag)


def _graph_csr(graph) -> tuple[SparseGraph, np.ndarray, np.ndarray]:
    """(sparse graph, COO rows, COO cols) for either graph flavour."""
    sg = graph if isinstance(graph, SparseGraph) else graph.to_sparse()
    return sg, sg._row_idx().astype(np.int32), sg.col_idx


def equal_neighbor_weights_sparse(graph) -> SparseWeights:
    """Sparse :func:`equal_neighbor_weights`: W_gj = 1/deg_g on edges,
    diagonal 1 − rowsum (zero except isolated nodes)."""
    sg, rows, cols = _graph_csr(graph)
    deg = np.maximum(sg.degrees.astype(np.float64), 1.0)
    vals = 1.0 / deg[rows]
    diag = 1.0 - np.bincount(rows, weights=vals, minlength=sg.n_nodes)
    return SparseWeights(n=sg.n_nodes, rows=rows, cols=cols, vals=vals,
                         diag=diag)


def metropolis_weights_sparse(graph) -> SparseWeights:
    """Sparse :func:`metropolis_weights`: W_ij = 1/(1+max(d_i, d_j)) on
    edges, computed per edge from the CSR degrees, O(E)."""
    sg, rows, cols = _graph_csr(graph)
    deg = sg.degrees.astype(np.float64)
    vals = 1.0 / (1.0 + np.maximum(deg[rows], deg[cols]))
    diag = 1.0 - np.bincount(rows, weights=vals, minlength=sg.n_nodes)
    return SparseWeights(n=sg.n_nodes, rows=rows, cols=cols, vals=vals,
                         diag=diag)


def lazy_weights_sparse(graph, beta: float = 0.5) -> SparseWeights:
    """Sparse :func:`lazy_weights`: (1−β)I + β·W_metropolis."""
    w = metropolis_weights_sparse(graph)
    return SparseWeights(n=w.n, rows=w.rows, cols=w.cols,
                         vals=beta * w.vals,
                         diag=(1.0 - beta) + beta * w.diag)


def circulant_weights_sparse(L: int, shifts: tuple[int, ...] = (-1, 1),
                             self_weight: float | None = None
                             ) -> SparseWeights:
    """Sparse :func:`circulant_weights`: per-shift uniform weights,
    colliding shifts accumulated as the dense builder does (shifts ≡ 0
    mod L fold into the diagonal)."""
    k = len(shifts)
    sw = self_weight if self_weight is not None else 1.0 / (k + 1)
    wn = (1.0 - sw) / k if k else 0.0
    i = np.arange(L, dtype=np.int64)
    rows = np.concatenate([i for _ in shifts]) if k else i[:0]
    cols = np.concatenate([(i + s) % L for s in shifts]) if k else i[:0]
    diag = np.full(L, float(sw))
    off = rows != cols
    diag += np.bincount(rows[~off], minlength=L) * wn
    key, inv = np.unique(rows[off] * L + cols[off], return_inverse=True)
    vals = np.bincount(inv, minlength=key.size) * wn
    return SparseWeights(n=L, rows=(key // L).astype(np.int32),
                         cols=(key % L).astype(np.int32), vals=vals,
                         diag=diag)


def neighbor_average_weights_sparse(graph) -> SparseWeights:
    """Sparse DGD neighbour average M = D⁻¹A (zero diagonal), the
    sparse form of ``consensus.neighbor_average_matrix``."""
    sg, rows, cols = _graph_csr(graph)
    deg = np.maximum(sg.degrees.astype(np.float64), 1.0)
    return SparseWeights(n=sg.n_nodes, rows=rows, cols=cols,
                         vals=1.0 / deg[rows],
                         diag=np.zeros(sg.n_nodes))


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
