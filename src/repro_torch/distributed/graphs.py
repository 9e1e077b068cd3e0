"""Network topologies for the decentralized runtime.

The port's own copy of ``src/repro/distributed/graphs.py`` (pure numpy):
the same seeds give bit-identical graphs in both packages.

Topology is static host-side metadata (numpy, never traced).  The native
representation is :class:`SparseGraph` — CSR neighbour lists — because at
the node scales the roadmap targets (L ≈ 10⁵–10⁶) an (L, L) adjacency is
pure overhead: real relatedness graphs are sparse and skewed.  Every
generator emits a SparseGraph built from an edge list; no generator ever
allocates an (L, L) matrix (``erdos_renyi`` keeps its historical dense
draw only below ``ER_DENSE_MAX`` nodes, where it is both cheap and the
seed-compatibility anchor — the same numpy RNG stream produces the same
graph as every previous release).

The dense :class:`Graph` wrapper remains for small-L call sites (mixing-
matrix builders, parity tests): ``SparseGraph.adj`` materializes a dense
adjacency on demand but refuses above ``DENSE_MATERIALIZE_MAX`` nodes so
an accidental densification of a 100k-node graph fails loudly instead of
allocating 10 GB.

The paper's experiments use Erdős–Rényi graphs; the mesh runtimes prefer
ring/torus/hypercube because those embed in the ICI fabric with
nearest-neighbour collective-permutes.  The scale families —
:func:`barabasi_albert` (scale-free preferential attachment),
:func:`hierarchical` (b-ary aggregation tree), and
:func:`cluster_of_cliques` (dense pods bridged in a ring) — model the
skewed real-world relatedness graphs the sparse consensus path exists
for.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Largest L for which SparseGraph.adj will materialize a dense matrix
# (4096² int8 = 16 MB; beyond that a dense adjacency is a bug).
DENSE_MATERIALIZE_MAX = 4096

# erdos_renyi keeps the historical dense (L, L) uniform draw below this
# many nodes: identical RNG consumption → bit-identical graphs for every
# existing seeded test/benchmark.  Above it the G(L, M) edge-count
# sampler runs (no (L, L) allocation).
ER_DENSE_MAX = 2048


def _ranges(counts: np.ndarray) -> np.ndarray:
    """[0..c₀-1, 0..c₁-1, ...] — vectorized per-segment aranges."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    out = np.arange(total, dtype=np.int64)
    offs = np.repeat(np.cumsum(counts) - counts, counts)
    return out - offs


@dataclasses.dataclass(frozen=True)
class SparseGraph:
    """Undirected graph on L nodes in CSR form (host numpy).

    ``indptr``: (L+1,) int64 row pointers; ``col_idx``: (nnz,) int32
    neighbour indices, sorted within each row.  Both directions of every
    edge are stored (nnz = 2·|E|), the diagonal never is.  Exposes the
    same read interface as the dense :class:`Graph` (``n_nodes`` /
    ``degrees`` / ``max_degree`` / ``n_edges`` / ``neighbors`` /
    ``is_connected`` / ``adj``) so small-L call sites work unchanged.
    """
    indptr: np.ndarray
    col_idx: np.ndarray

    def __post_init__(self):
        indptr = np.asarray(self.indptr, dtype=np.int64)
        col = np.asarray(self.col_idx, dtype=np.int32)
        object.__setattr__(self, "indptr", indptr)
        object.__setattr__(self, "col_idx", col)
        if indptr.ndim != 1 or indptr.size < 1:
            raise ValueError(f"indptr must be (L+1,), got {indptr.shape}")
        L = indptr.size - 1
        if indptr[0] != 0 or indptr[-1] != col.size:
            raise ValueError("indptr must start at 0 and end at nnz")
        if np.any(np.diff(indptr) < 0):
            raise ValueError("indptr must be nondecreasing")
        if col.size:
            if col.min() < 0 or col.max() >= L:
                raise ValueError("col_idx out of range")
        rows = self._row_idx()
        if np.any(rows == col.astype(np.int64)):
            raise ValueError("no self loops allowed")
        # symmetry: the (row, col) key multiset must equal its transpose
        fwd = np.sort(rows * L + col)
        rev = np.sort(col.astype(np.int64) * L + rows)
        if not np.array_equal(fwd, rev):
            raise ValueError("adjacency must be symmetric (undirected graph)")

    def _row_idx(self) -> np.ndarray:
        """(nnz,) row index of every stored entry (COO expansion)."""
        return np.repeat(np.arange(self.n_nodes, dtype=np.int64),
                         np.diff(self.indptr))

    # ------------------------------------------------------ construction

    @classmethod
    def from_edges(cls, L: int, u, v) -> "SparseGraph":
        """Build from a (directed or undirected) edge list: self loops
        dropped, duplicates merged, both directions stored."""
        u = np.asarray(u, dtype=np.int64).ravel()
        v = np.asarray(v, dtype=np.int64).ravel()
        if u.size and (min(u.min(), v.min()) < 0
                       or max(u.max(), v.max()) >= L):
            raise ValueError(f"edge endpoints out of range for L={L}")
        keep = u != v
        u, v = u[keep], v[keep]
        key = np.unique(np.concatenate([u * L + v, v * L + u]))
        rows = key // L
        cols = (key % L).astype(np.int32)
        counts = np.bincount(rows, minlength=L)
        indptr = np.zeros(L + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return cls(indptr=indptr, col_idx=cols)

    @classmethod
    def from_dense(cls, adj) -> "SparseGraph":
        a = np.asarray(adj)
        rows, cols = np.nonzero(a)          # row-major → CSR-sorted
        L = a.shape[0]
        counts = np.bincount(rows, minlength=L)
        indptr = np.zeros(L + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return cls(indptr=indptr, col_idx=cols.astype(np.int32))

    # -------------------------------------------------------- interface

    @property
    def n_nodes(self) -> int:
        return self.indptr.size - 1

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max()) if self.n_nodes else 0

    @property
    def n_edges(self) -> int:
        return self.col_idx.size // 2

    @property
    def density(self) -> float:
        """Fraction of possible (off-diagonal) entries present."""
        L = self.n_nodes
        return self.col_idx.size / (L * (L - 1)) if L > 1 else 0.0

    def neighbors(self, g: int) -> np.ndarray:
        return self.col_idx[self.indptr[g]:self.indptr[g + 1]]

    def neighbor_lists(self) -> list:
        """Per-node neighbour arrays (the event-clock's input — no dense
        adjacency needed)."""
        return [self.neighbors(g) for g in range(self.n_nodes)]

    def edges(self) -> tuple[np.ndarray, np.ndarray]:
        """Canonical (u, v) with u < v, one row per undirected edge."""
        rows = self._row_idx()
        keep = rows < self.col_idx
        return rows[keep], self.col_idx[keep].astype(np.int64)

    def is_connected(self) -> bool:
        L = self.n_nodes
        if L <= 1:
            return True
        seen = np.zeros(L, dtype=bool)
        seen[0] = True
        frontier = np.array([0], dtype=np.int64)
        while frontier.size:
            starts = self.indptr[frontier]
            counts = np.diff(self.indptr)[frontier]
            nbrs = self.col_idx[np.repeat(starts, counts) + _ranges(counts)]
            new = np.unique(nbrs[~seen[nbrs]])
            seen[new] = True
            frontier = new
        return bool(seen.all())

    @property
    def adj(self) -> np.ndarray:
        """Dense (L, L) int8 adjacency — small graphs only (guarded)."""
        L = self.n_nodes
        if L > DENSE_MATERIALIZE_MAX:
            raise ValueError(
                f"refusing to densify a {L}-node graph "
                f"(> DENSE_MATERIALIZE_MAX={DENSE_MATERIALIZE_MAX}); the "
                f"sparse consensus path never needs the dense adjacency")
        a = np.zeros((L, L), dtype=np.int8)
        a[self._row_idx(), self.col_idx] = 1
        return a

    def to_dense(self) -> "Graph":
        return Graph(self.adj)


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected graph on L nodes. ``adj`` is a symmetric 0/1 matrix with
    zero diagonal.  Small-L view; generators emit :class:`SparseGraph`."""
    adj: np.ndarray  # (L, L) int8

    def __post_init__(self):
        a = np.asarray(self.adj)
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"adjacency must be square, got {a.shape}")
        if not np.array_equal(a, a.T):
            raise ValueError("adjacency must be symmetric (undirected graph)")
        if np.any(np.diag(a) != 0):
            raise ValueError("no self loops allowed")

    @property
    def n_nodes(self) -> int:
        return self.adj.shape[0]

    @property
    def degrees(self) -> np.ndarray:
        return self.adj.sum(axis=1)

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max())

    @property
    def n_edges(self) -> int:
        return int(self.adj.sum()) // 2

    @property
    def density(self) -> float:
        L = self.n_nodes
        return int(self.adj.sum()) / (L * (L - 1)) if L > 1 else 0.0

    def neighbors(self, g: int) -> np.ndarray:
        return np.nonzero(self.adj[g])[0]

    def neighbor_lists(self) -> list:
        return [self.neighbors(g) for g in range(self.n_nodes)]

    def to_sparse(self) -> SparseGraph:
        return SparseGraph.from_dense(self.adj)

    def is_connected(self) -> bool:
        L = self.n_nodes
        seen = np.zeros(L, dtype=bool)
        stack = [0]
        seen[0] = True
        while stack:
            u = stack.pop()
            for v in np.nonzero(self.adj[u])[0]:
                if not seen[v]:
                    seen[v] = True
                    stack.append(int(v))
        return bool(seen.all())


def _sample_pair_set(rng: np.random.Generator, L: int, M: int,
                     forbid_key=None) -> tuple[np.ndarray, np.ndarray]:
    """M distinct unordered node pairs, uniform over the C(L, 2) set —
    the G(L, M) sampler.  Draws (u, v) uniformly (every unordered pair
    has equal mass 2/L²), canonicalizes, dedupes, and tops up until M
    distinct pairs exist; never touches an (L, L) array."""
    n_pairs = L * (L - 1) // 2
    if M > n_pairs:
        raise ValueError(f"cannot sample {M} distinct pairs from {n_pairs}")
    keys = np.zeros(0, dtype=np.int64)
    while keys.size < M:
        chunk = max(1024, int(1.2 * (M - keys.size)))
        u = rng.integers(0, L, size=chunk)
        v = rng.integers(0, L, size=chunk)
        ok = u != v
        lo, hi = np.minimum(u[ok], v[ok]), np.maximum(u[ok], v[ok])
        keys = np.unique(np.concatenate([keys, lo * L + hi]))
    if keys.size > M:
        keys = keys[rng.choice(keys.size, M, replace=False)]
    return keys // L, keys % L


def erdos_renyi(L: int, p: float, seed: int = 0,
                ensure_connected: bool = True,
                max_tries: int = 1000) -> SparseGraph:
    """G(L, p) as in the paper's simulations.  If ``ensure_connected``,
    resample until connected (the paper's Assumption 3), falling back to
    overlaying a ring if p is too small to connect within ``max_tries``.

    Below ``ER_DENSE_MAX`` nodes the historical dense (L, L) uniform
    draw runs (bit-identical graphs for existing seeds); above it the
    edge COUNT is drawn Binomial(C(L,2), p) and that many distinct edges
    are sampled uniformly — the G(L, M) variant, equal in distribution,
    with O(E) memory instead of O(L²)."""
    rng = np.random.default_rng(seed)
    g = None
    for _ in range(max_tries):
        if L <= ER_DENSE_MAX:
            u = rng.random((L, L))
            upper = np.triu(np.ones((L, L), dtype=bool), 1)
            a = ((u < p) & upper).astype(np.int8)
            g = SparseGraph.from_dense(a + a.T)
        else:
            M = int(rng.binomial(L * (L - 1) // 2, p))
            g = SparseGraph.from_edges(L, *_sample_pair_set(rng, L, M))
        if not ensure_connected or g.is_connected():
            return g
    # fall back: overlay a ring to force connectivity
    u, v = g.edges()
    ru = np.arange(L, dtype=np.int64)
    return SparseGraph.from_edges(L, np.concatenate([u, ru]),
                                  np.concatenate([v, (ru + 1) % L]))


def circulant(L: int, shifts: tuple[int, ...] = (-1, 1)) -> SparseGraph:
    """Circulant graph: node i adjacent to i+s (mod L) for each shift —
    the topology a circulant mixing matrix actually gossips over (each
    shift = one collective-permute on the mesh runtime)."""
    i = np.arange(L, dtype=np.int64)
    u = np.concatenate([i for _ in shifts]) if shifts else i[:0]
    v = np.concatenate([(i + s) % L for s in shifts]) if shifts else i[:0]
    return SparseGraph.from_edges(L, u, v)


def ring(L: int) -> SparseGraph:
    if L == 1:
        return SparseGraph.from_edges(1, [], [])
    i = np.arange(L, dtype=np.int64)
    return SparseGraph.from_edges(L, i, (i + 1) % L)


def path_graph(L: int) -> SparseGraph:
    i = np.arange(L - 1, dtype=np.int64)
    return SparseGraph.from_edges(L, i, i + 1)


def torus2d(rows: int, cols: int) -> SparseGraph:
    """2-D torus — the natural embedding of a TPU ICI mesh slice."""
    L = rows * cols
    r, c = np.divmod(np.arange(L, dtype=np.int64), cols)
    down = ((r + 1) % rows) * cols + c
    right = r * cols + (c + 1) % cols
    i = np.arange(L, dtype=np.int64)
    return SparseGraph.from_edges(L, np.concatenate([i, i]),
                                  np.concatenate([down, right]))


def hypercube(dim: int) -> SparseGraph:
    L = 1 << dim
    i = np.arange(L, dtype=np.int64)
    u = np.concatenate([i for _ in range(dim)])
    v = np.concatenate([i ^ (1 << b) for b in range(dim)])
    return SparseGraph.from_edges(L, u, v)


def complete(L: int) -> SparseGraph:
    u, v = np.triu_indices(L, 1)
    return SparseGraph.from_edges(L, u, v)


def star(L: int) -> SparseGraph:
    v = np.arange(1, L, dtype=np.int64)
    return SparseGraph.from_edges(L, np.zeros_like(v), v)


# ----------------------------------------------------------------------
# scale families (sparse-born: no (L, L) allocation ever)
# ----------------------------------------------------------------------

def barabasi_albert(L: int, m: int = 2, seed: int = 0) -> SparseGraph:
    """Scale-free preferential attachment (Barabási–Albert): start from
    an (m+1)-clique, then each new node attaches to m distinct existing
    nodes drawn proportionally to degree (the repeated-endpoints trick).
    Connected by construction; degree distribution is the skewed
    power-law real relatedness graphs show."""
    if m < 1:
        raise ValueError(f"barabasi_albert needs m >= 1, got {m}")
    if L < m + 1:
        raise ValueError(f"barabasi_albert needs L >= m+1={m + 1}, "
                         f"got L={L}")
    rng = np.random.default_rng(seed)
    seed_u, seed_v = np.triu_indices(m + 1, 1)
    us = [seed_u.astype(np.int64)]
    vs = [seed_v.astype(np.int64)]
    # every edge endpoint appears once → sampling the list IS sampling
    # proportionally to degree
    repeated = list(np.concatenate([seed_u, seed_v]))
    for new in range(m + 1, L):
        targets: set = set()
        while len(targets) < m:
            targets.add(repeated[rng.integers(0, len(repeated))])
        t = np.fromiter(targets, dtype=np.int64, count=m)
        us.append(np.full(m, new, dtype=np.int64))
        vs.append(t)
        repeated.extend(t)
        repeated.extend([new] * m)
    return SparseGraph.from_edges(L, np.concatenate(us), np.concatenate(vs))


def hierarchical(L: int, branching: int = 4) -> SparseGraph:
    """Hierarchical aggregation tree: node i > 0 links to its parent
    ⌊(i−1)/b⌋ — the b-ary tree overlay of datacenter/edge aggregation
    tiers.  L−1 edges, diameter O(log_b L), connected by construction."""
    if branching < 1:
        raise ValueError(f"hierarchical needs branching >= 1, got "
                         f"{branching}")
    i = np.arange(1, L, dtype=np.int64)
    return SparseGraph.from_edges(L, i, (i - 1) // branching)


def cluster_of_cliques(L: int, clique: int = 8, seed: int = 0) -> SparseGraph:
    """Cluster-of-cliques: dense pods of ``clique`` nodes (the last pod
    takes the remainder), bridged in a ring by one seeded representative
    pair per adjacent pod — the "tight teams, thin backbone" shape of
    federated silos.  Connected whenever L ≥ 1."""
    if clique < 2:
        raise ValueError(f"cluster_of_cliques needs clique >= 2, got "
                         f"{clique}")
    rng = np.random.default_rng(seed)
    n_pods = max(1, -(-L // clique))
    us, vs = [], []
    cu, cv = np.triu_indices(clique, 1)
    for k in range(n_pods):
        lo, hi = k * clique, min((k + 1) * clique, L)
        size = hi - lo
        if size >= 2:
            keep = (cu < size) & (cv < size)
            us.append(lo + cu[keep].astype(np.int64))
            vs.append(lo + cv[keep].astype(np.int64))
    if n_pods > 1:
        for k in range(n_pods):
            k2 = (k + 1) % n_pods
            lo, hi = k * clique, min((k + 1) * clique, L)
            lo2, hi2 = k2 * clique, min((k2 + 1) * clique, L)
            us.append(np.array([rng.integers(lo, hi)], dtype=np.int64))
            vs.append(np.array([rng.integers(lo2, hi2)], dtype=np.int64))
    if not us:
        return SparseGraph.from_edges(L, [], [])
    return SparseGraph.from_edges(L, np.concatenate(us), np.concatenate(vs))


# ----------------------------------------------------------------------
# bandwidth-reducing relabeling (mesh shift-count pruning)
# ----------------------------------------------------------------------

def reverse_cuthill_mckee(graph) -> np.ndarray:
    """Reverse Cuthill–McKee node permutation ``perm`` (new→old): BFS
    from a minimum-degree node, visiting each frontier's neighbours in
    increasing-degree order, then reversed.  Relabeling an irregular
    graph by ``perm`` concentrates its adjacency near the diagonal, so
    the mesh lowering's ``mesh_weights_from_matrix`` sees
    far fewer distinct cyclic shifts — each shift is one
    collective-permute on the mesh runtime, making this the shift-count
    pruning knob.  Handles disconnected graphs (each component appended
    in turn).  Works on :class:`SparseGraph` and dense :class:`Graph`.
    """
    sg = graph if isinstance(graph, SparseGraph) else graph.to_sparse()
    L = sg.n_nodes
    deg = sg.degrees
    visited = np.zeros(L, dtype=bool)
    order = np.empty(L, dtype=np.int64)
    pos = 0
    for start in np.argsort(deg, kind="stable"):
        if visited[start]:
            continue
        visited[start] = True
        queue = [int(start)]
        while queue:
            u = queue.pop(0)
            order[pos] = u
            pos += 1
            nbrs = sg.neighbors(u)
            nbrs = nbrs[~visited[nbrs]]
            nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
            visited[nbrs] = True
            queue.extend(int(x) for x in nbrs)
    return order[::-1].copy()
