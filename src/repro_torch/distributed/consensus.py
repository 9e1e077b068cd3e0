"""The consensus layer — every ``Z ← W Z`` in one place.

Port of ``src/repro/distributed/consensus.py`` for the paper's
``gossip`` rule, the stateless rules of the other programs
(``neighbor``, ``central``, ``none``, ``exact_diffusion``,
``beyond_central``) and the compressed wire rules ``topk_gossip`` /
``quantized_gossip`` / ``event_gossip``.  A rule is lowered two ways:

  * **simulator** — node variables stacked on a leading axis,
    ``Z: (L, ...)``.  The ``torch-ref`` lowering is the exact sequential
    product (T_con rounds of ``W @ Z``, dtype-preserving, the numerics
    anchor); the ``cuda`` lowering hoists the T_con rounds of ``gossip``
    onto a precomputed ``W^{T_con}`` applied by the ``mix_rows`` kernel
    in one launch.  The compressed rules mix round by round (their
    refresh depends on the data), one ``mix_rows`` launch per round,
    with the ``compress_topk`` / ``dequant`` kernels as the encode and
    decode.
  * **mesh** — one node per rank of a
    :class:`~repro_torch.distributed.mesh.NodeMesh`.  Each gossip round
    fetches the neighbour blocks by ``ppermute`` (one per distinct
    cyclic shift of W's sparsity pattern, :func:`mesh_weights_from_matrix`)
    and combines them with the node's own W row in ONE (K+1)-way
    :func:`combine_blocks`: the ``gossip_combine`` kernel on ``cuda``,
    the sequential chain on ``torch-ref``.  :meth:`CombineRule.roll_round`
    is the same round on the single-process form, the node axis leading.

Precision policy: the kernels accumulate in f32, so float64 operands
always take the exact sequential product, the exact chain and the plain
encoders, on every backend.

The dropout-tolerant rules ``partial_gossip`` / ``stale_gossip`` /
``push_sum_gossip`` take the current outer iteration's availability
mask (:class:`MaskedGossipCombine`).  Their masked matrix depends on
the data, so their simulator lowering mixes round by round: one
``mix_rows`` launch a round on cuda (two for push-sum, whose weight
column rides the same matrix), the exact ``Weff @ flat`` chain on
torch-ref and for float64, so that an always-on mask reproduces dense
gossip bit for bit.

On the mesh the compressed rules keep, beside the node's own public
copy, a copy of each shift-neighbour's (built from that neighbour's
payloads alone); a round refreshes the own copy, sends the compact
payload (:meth:`NodeMesh.ppermute_many` of its leaves), applies what
arrives to the stored copies and combines the exact self block with
them in one :func:`combine_blocks`.  The masked rules derive the node's
(K+1,) combine weights from the iteration's mask on the device.

The virtual-node mesh tier (:class:`VirtualTopology`) gives each of D
ranks a contiguous block of V = L / D nodes: a round mixes the
co-located edges on the device (a padded-COO segment sum, ``index_add_``)
and sends the whole block once a cross-rank edge class (all classes in
one :meth:`NodeMesh.ppermute_many`).  Each rule's ``make_virtual_mesh_*``
mixer runs there, the compressed rules refreshing the whole block in one
call (one ``compress_topk`` / ``int8_round`` launch a round on cuda).

The sparse tier (:func:`maybe_sparsify`, above ``SPARSE_MIN_NODES``
nodes at or below 25 % density, or a :class:`SparseWeights` passed in)
lowers every simulator rule to padded-COO segment sums over the edge
list (``index_add_``, :func:`sparse_round`), so no (L, L) matrix exists.
The padding entries point at a dummy segment L with weight exactly 0.0
and are arithmetically invisible.  The fused gossip lowering hoists
``W^{T_con}`` (a scipy product on the host) while its fill stays within
:meth:`SparseWeights.power`'s budget, and otherwise keeps the T_con
per-round products; no sparse round launches a mixing kernel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.distributed.graphs import (Graph, SparseGraph,
                                            reverse_cuthill_mckee)
from repro_torch.distributed.mixing import (SparseWeights,
                                            neighbor_average_weights_sparse)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ref_int8_scale


@dataclasses.dataclass(frozen=True)
class CommSignature:
    """What a combine rule costs on the wire, per outer iteration.

    ``pattern`` prices the exchange shape: ``"gossip"`` /``"neighbor"``
    send the iterate to every graph neighbour ``rounds_per_iter`` times;
    ``"central"`` is one gather + one broadcast; ``"none"`` is silent.
    ``entries_per_round`` / ``bytes_per_entry`` describe the payload of
    one message; ``None`` means the dense d×r iterate at the network
    model's native precision.
    """
    pattern: str                 # "gossip" | "neighbor" | "central" | "none"
    rounds_per_iter: int
    entries_per_round: Optional[int] = None   # None → dense d·r
    bytes_per_entry: Optional[int] = None     # None → the model's native

    def bytes_per_iter(self, n_entries: int, itemsize: int, n_nodes: int,
                       degree: int) -> int:
        """Bytes sent per node per outer iteration (the trainer's
        :func:`~repro_torch.distributed.aggregation.comm_bytes_per_step`).
        The signature's own payload fields override the dense
        ``n_entries`` / ``itemsize`` arguments when set."""
        n = (self.entries_per_round if self.entries_per_round is not None
             else n_entries)
        bpe = (self.bytes_per_entry if self.bytes_per_entry is not None
               else itemsize)
        if self.pattern == "central":
            # ring all-reduce equivalent: 2·(L−1)/L · size
            return int(2 * (n_nodes - 1) / n_nodes * n * bpe)
        return int(self.rounds_per_iter * degree * n * bpe)


# ----------------------------------------------------------------------
# the combine primitives
# ----------------------------------------------------------------------

def _acc_dtype(dtype):
    return torch.promote_types(dtype, torch.float32)


def _fused_wanted(backend: str, dtype) -> bool:
    """The mixing kernel accumulates in f32: take it only on the cuda
    backend and never for float64 operands (x64 policy)."""
    return backend != "torch-ref" and dtype != torch.float64


def stacked_product(Z, W, T_con: int):
    """The exact sequential simulator product: T_con rounds of ``W @ Z``
    over the leading node axis, dtype-preserving.  A
    :class:`SparseWeights` ``W`` takes :func:`stacked_sparse_product`."""
    if isinstance(W, SparseWeights):
        return stacked_sparse_product(Z, W, T_con)
    if T_con == 0:
        return Z
    W = W.to(Z.dtype)
    flat = Z.reshape(Z.shape[0], -1)
    for _ in range(T_con):
        flat = W @ flat
    return flat.reshape(Z.shape)


def stacked_dense_mix(Z, M, *, backend: str):
    """Single combine ``Z ← M Z`` for a precomputed mixer (e.g.
    ``W^{T_con}``): the ``mix_rows`` kernel on cuda, an einsum on
    torch-ref and for float64.  A :class:`SparseWeights` mixer takes one
    sparse round instead, on any backend."""
    if isinstance(M, SparseWeights):
        return stacked_sparse_product(Z, M, 1)
    if _fused_wanted(backend, Z.dtype):
        return ops.mix_nodes(Z, M.to(torch.float32),
                             backend=backend).to(Z.dtype)
    return torch.einsum("gh,h...->g...", M.to(Z.dtype), Z)


def combine_blocks(z, neighbors, weights, *, backend: str = "torch-ref"):
    """ONE (K+1)-way weighted combine ``z ← w₀·z + Σ_k w_{k+1}·nbr_k`` —
    the primitive under every mesh lowering (mesh gossip rounds, the
    single-process roll rounds).  ``neighbors`` is a sequence of K
    blocks or a (K, *z.shape) stack; ``weights`` a length-K+1 tuple of
    Python floats (uniform circulant weights) or a (K+1,) tensor on z's
    device (a device's own W row).  On the cuda backend one
    ``gossip_combine`` launch (f32 accumulation); on torch-ref and for
    float64 the sequential chain in the promoted accumulator dtype."""
    if len(neighbors) and _fused_wanted(backend, z.dtype):
        stack = (neighbors if torch.is_tensor(neighbors)
                 else torch.stack(list(neighbors)))
        return ops.gossip_combine(z, stack, weights, backend=backend)
    acc_dt = _acc_dtype(z.dtype)
    w = weights if isinstance(weights, tuple) else weights.to(acc_dt)
    acc = w[0] * z.to(acc_dt)
    for k, nbr in enumerate(neighbors):
        acc = acc + w[k + 1] * nbr.to(acc_dt)
    return acc.to(z.dtype)


# ----------------------------------------------------------------------
# the sparse tier
# ----------------------------------------------------------------------
#
# Above a node-count/density cutoff the (L, L) mixing matrix is pure
# overhead: every combine rule lowers to "gather sender rows by col,
# weight, segment-sum into receivers" on the padded edge list of a
# SparseWeights.  The edge arrays are padded to a multiple of
# _SPARSE_PAD entries; the padding entries point at the dummy segment L
# with weight exactly 0.0, so they are arithmetically invisible.  Edges
# are sorted by receiver row, the padding at the end.

SPARSE_MIN_NODES = 512
SPARSE_DENSITY_THRESHOLD = 0.25
_SPARSE_PAD = 1024


def maybe_sparsify(W):
    """The sparse tier's policy for a concrete dense mixing matrix (a
    tensor or a host array): above :data:`SPARSE_MIN_NODES` nodes AND at
    or below :data:`SPARSE_DENSITY_THRESHOLD` off-diagonal density, the
    equivalent :class:`SparseWeights`; otherwise (small L, a dense
    graph, anything that is not a square matrix) ``W`` unchanged.  A
    :class:`SparseWeights` passes straight through: a caller that built
    one has already chosen the representation."""
    if W is None or isinstance(W, SparseWeights):
        return W
    shape = tuple(W.shape) if hasattr(W, "shape") else np.shape(W)
    if len(shape) != 2 or shape[0] != shape[1] or shape[0] < SPARSE_MIN_NODES:
        return W
    L = shape[0]
    Wn = W.detach().cpu().numpy() if torch.is_tensor(W) else np.asarray(W)
    off = np.count_nonzero(Wn) - np.count_nonzero(np.diag(Wn))
    if off / (L * (L - 1)) > SPARSE_DENSITY_THRESHOLD:
        return W
    return SparseWeights.from_dense(Wn)


def _padded_coo(rows, cols, vals, n: int):
    """Pad host COO arrays to a multiple of :data:`_SPARSE_PAD` entries:
    padding rows point at the dummy segment ``n``, padding cols at 0,
    and padding weights are exactly 0.0."""
    nnz = int(vals.size)
    total = max(_SPARSE_PAD, -(-nnz // _SPARSE_PAD) * _SPARSE_PAD)
    pad = total - nnz
    return (np.concatenate([rows, np.full(pad, n, np.int32)]),
            np.concatenate([cols, np.zeros(pad, np.int32)]),
            np.concatenate([vals, np.zeros(pad)]))


def _sparse_arrays(sw: SparseWeights):
    """(rows, cols, vals, diag): the padded host arrays of ``sw``."""
    rows, cols, vals = _padded_coo(sw.rows, sw.cols, sw.vals, sw.n)
    return rows, cols, vals, sw.diag


def sparse_operands(sw: SparseWeights, device, dtype):
    """:func:`_sparse_arrays` on ``device``: the indices int64, the
    weights and the diagonal in ``dtype`` (cast from float64 once, as
    the dense path's ``W.to(Z.dtype)``).  Made once per device and dtype
    and kept on ``sw``, so a mixer moves them there once, not every
    round."""
    key = ("operands", str(torch.device(device)), dtype)
    if key not in sw._cache:
        rows, cols, vals, diag = _sparse_arrays(sw)

        def idx(a):
            return torch.as_tensor(a, dtype=torch.int64, device=device)

        def val(a):
            return torch.as_tensor(a, dtype=torch.float64,
                                   device=device).to(dtype)
        sw._cache[key] = (idx(rows), idx(cols), val(vals), val(diag))
    return sw._cache[key]


def _sparse_power(sw: SparseWeights, T: int):
    """``sw.power(T)`` (None past its fill budget), made once per
    ``sw``: the host-side W^{T_con} hoist of the fused gossip mixer."""
    key = ("power", T)
    if key not in sw._cache:
        sw._cache[key] = sw.power(T)
    return sw._cache[key]


def _segment_sum(vals, seg, V: int):
    """``jax.ops.segment_sum(vals, seg, num_segments=V + 1)[:V]``: rows
    of ``vals`` added into a (V+1, ...) accumulator at their segment,
    then the padding segment V dropped."""
    acc = vals.new_zeros((V + 1,) + tuple(vals.shape[1:]))
    return acc.index_add_(0, seg, vals)[:V]


def sparse_round(Zf, rows, cols, vals, diag, L: int):
    """ONE ``Z ← W Z`` on the padded edge list, ``Zf: (L, F)``: gather
    the sender rows by ``cols``, weight them, segment-sum them into the
    receiver rows (the dummy segment L takes the padding), then add the
    separate diagonal term.  ``vals`` / ``diag`` in ``Zf.dtype``."""
    return (sparse_offdiag_apply(Zf, rows, cols, vals, L)
            + diag[:, None] * Zf)


def sparse_offdiag_apply(Zf, rows, cols, vals, L: int):
    """The off-diagonal half of :func:`sparse_round`, ``(W − diag) Z``,
    for combines that treat the self term apart (the compressed rules'
    exact self term)."""
    return _segment_sum(vals[:, None] * Zf[cols], rows, L)


def stacked_sparse_product(Z, sw: SparseWeights, T_con: int):
    """T_con sequential rounds of the sparse ``Z ← W Z``: the sparse
    twin of :func:`stacked_product`, dtype-preserving."""
    if T_con == 0:
        return Z
    L = sw.n
    rows, cols, vals, diag = sparse_operands(sw, Z.device, Z.dtype)
    flat = Z.reshape(L, -1)
    for _ in range(T_con):
        flat = sparse_round(flat, rows, cols, vals, diag, L)
    return flat.reshape(Z.shape)


def node_mean(Z):
    """Fusion-center combine: the exact mean over the node axis,
    broadcast back."""
    m = torch.mean(Z.to(_acc_dtype(Z.dtype)), dim=0, keepdim=True)
    return torch.broadcast_to(m, Z.shape).to(Z.dtype)


def neighbor_average_matrix(adj):
    """DGD's row-stochastic neighbour average M = D⁻¹A (zero diagonal,
    isolated nodes guarded to degree 1).  ONE derivation shared by the
    simulator and the mesh lowering, whose agreement depends on both
    using the same matrix.  ``adj`` an (L, L) tensor, or a dense
    :class:`~repro_torch.distributed.graphs.Graph` (float64); a
    :class:`~repro_torch.distributed.graphs.SparseGraph` gives the
    equivalent :class:`SparseWeights` (the same 1/deg values a stored
    edge, never densified)."""
    if isinstance(adj, SparseGraph):
        return neighbor_average_weights_sparse(adj)
    if isinstance(adj, Graph):
        # reprolint: allow=RL002 — dense-Graph input tier; a SparseGraph returns SparseWeights above
        adj = torch.as_tensor(adj.adj, dtype=torch.float64)
    deg = torch.clamp(torch.sum(adj, dim=1), min=1.0)
    return adj / deg[:, None]


def mesh_weights_from_matrix(W) -> tuple[tuple[int, ...], np.ndarray]:
    """Decompose a concrete (L, L) mixing matrix into cyclic-shift form:
    ``(shifts, table)`` with ``table[i] = [W_ii, W_{i,(i+s1)%L}, ...]``.

    Every entry of W lies on exactly one cyclic diagonal (edge (i, j) on
    shift ``(j−i) mod L``), so ANY weighted graph lowers to one
    ``ppermute`` per distinct shift plus one (K+1)-way weighted combine
    — a circulant matrix needs exactly its own |shifts|, an irregular
    graph up to L−1.  Shifts are signed representatives in
    (−L/2, L/2], sorted, so a symmetric ring decomposes to (−1, 1).
    Pure numpy on the host (a tensor is copied there first); the table
    keeps W's dtype.  A :class:`SparseWeights` densifies first: the
    one-node-a-rank mesh is small-L by construction (the large-L mesh
    form is :class:`VirtualTopology`)."""
    if isinstance(W, SparseWeights):
        # reprolint: allow=RL002 — one-node-per-rank mesh tier is small-L by construction; large L uses VirtualTopology
        W = W.to_dense()
    Wn = W.detach().cpu().numpy() if torch.is_tensor(W) else np.asarray(W)
    if Wn.ndim != 2 or Wn.shape[0] != Wn.shape[1]:
        raise ValueError(f"mixing matrix must be square, got {Wn.shape}")
    L = Wn.shape[0]
    idx = np.arange(L)
    shifts = sorted(
        (s if s <= L // 2 else s - L)
        for s in range(1, L) if np.any(Wn[idx, (idx + s) % L] != 0))
    table = np.empty((L, len(shifts) + 1), dtype=Wn.dtype)
    table[:, 0] = np.diag(Wn)
    for k, s in enumerate(shifts):
        table[:, k + 1] = Wn[idx, (idx + s) % L]
    return tuple(shifts), table


def place_weights(weights, device):
    """A mesh or roll mixer's combine weights, put on ``device`` once when
    the mixer is built: ``(exact, f32)``.  ``exact`` is what the
    sequential chain multiplies by — the shared Python floats, or the
    (L, K+1) table as a tensor — and ``f32`` the same in float32 on the
    device, what the ``gossip_combine`` kernel reads (a (K+1,) vector,
    or the table)."""
    if isinstance(weights, tuple):
        return weights, torch.tensor(weights, dtype=torch.float32,
                                     device=device)
    table = torch.as_tensor(weights, device=device)
    # reprolint: allow=JX003 — the kernel's copy: read only where _fused_wanted admits the operands, never for float64 ones
    return table, table.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class RelabeledMeshWeights:
    """:func:`mesh_weights_from_matrix` after RCM shift-count pruning.

    ``perm`` (new→old) relabels the node axis; ``shifts``/``table``
    decompose the RELABELED matrix ``W[perm][:, perm]``.  A mesh run
    would permute its node-major inputs by ``perm`` (rank k hosting old
    node ``perm[k]``), gossip with the pruned shift set and un-permute
    the outputs: a relabeling is a similarity transform by a permutation
    matrix, so the mixing arithmetic is the same.  ``shifts_before`` /
    ``shifts_after`` report the pruning (each shift is one ``ppermute``
    a gossip round)."""
    perm: np.ndarray
    shifts: tuple
    table: np.ndarray
    shifts_before: int
    shifts_after: int


def mesh_weights_relabeled(W, *, verify: bool = True
                           ) -> RelabeledMeshWeights:
    """Shift-count pruning for :func:`mesh_weights_from_matrix` by a
    bandwidth-reducing relabeling (reverse Cuthill–McKee on the support
    of W): an irregular graph's decomposition can need up to L−1 shifts,
    RCM gathers the support near the diagonal, so the relabeled matrix
    needs only the shifts its bandwidth spans.  Keeps the identity
    relabeling when RCM does not strictly reduce the shift count (a
    circulant is already optimal).  ``verify`` checks the round trip:
    the table rebuilt densely equals the relabeled matrix entry for
    entry, and un-permuting recovers W."""
    if isinstance(W, SparseWeights):
        # reprolint: allow=RL002 — one-node-per-rank mesh tier is small-L by construction; large L uses VirtualTopology
        W = W.to_dense()
    Wn = W.detach().cpu().numpy() if torch.is_tensor(W) else np.asarray(W)
    L = Wn.shape[0]
    shifts0, table0 = mesh_weights_from_matrix(Wn)
    off = (Wn != 0) | (Wn != 0).T
    np.fill_diagonal(off, False)
    rows, cols = np.nonzero(off)
    perm = reverse_cuthill_mckee(SparseGraph.from_edges(L, rows, cols))
    Wp = Wn[np.ix_(perm, perm)]
    shifts, table = mesh_weights_from_matrix(Wp)
    if len(shifts) >= len(shifts0):           # pruning did not help
        perm, Wp = np.arange(L, dtype=np.int64), Wn
        shifts, table = shifts0, table0
    if verify:
        idx = np.arange(L)
        R = np.zeros_like(Wp)
        R[idx, idx] = table[:, 0]
        for k, s in enumerate(shifts):
            R[idx, (idx + s) % L] = table[:, k + 1]
        if not np.array_equal(R, Wp):
            raise AssertionError("RCM decomposition round-trip failed")
        inv = np.empty(L, dtype=np.int64)
        inv[perm] = np.arange(L)
        if not np.array_equal(Wp[np.ix_(inv, inv)], Wn):
            raise AssertionError("RCM relabeling round-trip failed")
    return RelabeledMeshWeights(perm=perm, shifts=tuple(shifts),
                                table=table, shifts_before=len(shifts0),
                                shifts_after=len(shifts))


# ----------------------------------------------------------------------
# the virtual-node mesh tier
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VirtualTopology:
    """Rank × local-block decomposition of a sparse mixing matrix: the
    mesh form of the node axis past one node per rank.

    Node ``i`` lives on rank ``i // block`` as local node ``i % block``
    (contiguous blocks).  Every stored edge falls in exactly one RANK
    shift class ``s = (rank_j − rank_i) mod D``:

      * class 0 (``local_*``): both endpoints on one rank — its gossip
        is an on-device segment sum, no message;
      * each nonzero class (``cross_*``, one slot an entry of
        ``dev_shifts``): ONE send of the whole local block a round, then
        a sparse apply at the receiver.

    Edge arrays are padded per rank (dummy receiver row ``block``,
    weight exactly 0) and sorted by receiver row; ``diag`` is the
    separate (D, block) self-weight plane.  Host numpy, the reference's
    arrays bit for bit."""
    n_dev: int
    block: int
    dev_shifts: tuple[int, ...]
    local_rows: np.ndarray   # (D, E0) int32 — receiver local row
    local_cols: np.ndarray   # (D, E0) int32 — sender local row
    local_vals: np.ndarray   # (D, E0) float64
    cross_rows: np.ndarray   # (S, D, E1) int32
    cross_cols: np.ndarray   # (S, D, E1) int32 — sender-local, in the
    cross_vals: np.ndarray   # (S, D, E1)        sending rank's block
    diag: np.ndarray         # (D, block) float64

    @staticmethod
    def _group(dev, lr, lc, v, D: int, V: int):
        """Per-rank padded (rows, cols, vals): entries sorted by (rank,
        local row, local col), padding (row V, weight 0) at the end."""
        order = np.lexsort((lc, lr, dev))
        dev, lr, lc, v = dev[order], lr[order], lc[order], v[order]
        counts = np.bincount(dev, minlength=D)
        E = max(int(counts.max()) if counts.size else 0, 1)
        rows = np.full((D, E), V, np.int32)
        cols = np.zeros((D, E), np.int32)
        vals = np.zeros((D, E))
        starts = np.cumsum(counts) - counts
        pos = np.arange(dev.size) - np.repeat(starts, counts)
        rows[dev, pos] = lr
        cols[dev, pos] = lc
        vals[dev, pos] = v
        return rows, cols, vals

    @classmethod
    def from_weights(cls, W, n_dev: int) -> "VirtualTopology":
        """Decompose ``W`` (a :class:`SparseWeights`, or a dense host
        matrix) over ``n_dev`` ranks; ``n_dev`` must divide L."""
        sw = W if isinstance(W, SparseWeights) \
            else SparseWeights.from_dense(W)
        L, D = sw.n, int(n_dev)
        if D < 1 or L % D:
            raise ValueError(f"virtual-node tier needs n_dev to divide "
                             f"L, got L={L}, n_dev={D}")
        V = L // D
        di = (sw.rows // V).astype(np.int64)
        dj = (sw.cols // V).astype(np.int64)
        s = (dj - di) % D
        ss = np.where(s <= D // 2, s, s - D)
        lr = (sw.rows % V).astype(np.int64)
        lc = (sw.cols % V).astype(np.int64)
        loc = s == 0
        l_rows, l_cols, l_vals = cls._group(di[loc], lr[loc], lc[loc],
                                            sw.vals[loc], D, V)
        shifts = tuple(int(x) for x in np.unique(ss[~loc]))
        groups = []
        for sk in shifts:
            sel = ss == sk
            groups.append(cls._group(di[sel], lr[sel], lc[sel], sw.vals[sel],
                                     D, V))
        E1 = max((grp[0].shape[1] for grp in groups), default=1)

        def stack(i, fill, dtype):
            out = np.full((len(shifts), D, E1), fill, dtype)
            for k, grp in enumerate(groups):
                out[k, :, :grp[i].shape[1]] = grp[i]
            return out
        return cls(
            n_dev=D, block=V, dev_shifts=shifts,
            local_rows=l_rows, local_cols=l_cols, local_vals=l_vals,
            cross_rows=stack(0, V, np.int32),
            cross_cols=stack(1, 0, np.int32),
            cross_vals=stack(2, 0.0, np.float64),
            diag=np.asarray(sw.diag, np.float64).reshape(D, V).copy())

    @property
    def n_nodes(self) -> int:
        return self.n_dev * self.block

    @property
    def n_local_entries(self) -> int:
        return int(np.count_nonzero(self.local_rows != self.block))

    @property
    def n_cross_entries(self) -> int:
        return int(np.count_nonzero(self.cross_rows != self.block))

    @property
    def block_sends_per_round(self) -> int:
        """Whole-block sends one round costs a rank (co-located gossip
        is free)."""
        return len(self.dev_shifts)


def virtual_arrays(vt: VirtualTopology, device):
    """vt's edge arrays on ``device``, put there once when a mixer is
    built: the indices as int64, the weights in float64 (cast to the
    iterate's dtype by :func:`_device_slice`)."""
    def idx(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    def val(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)
    return (idx(vt.local_rows), idx(vt.local_cols), val(vt.local_vals),
            idx(vt.cross_rows), idx(vt.cross_cols), val(vt.cross_vals),
            val(vt.diag))


def _device_slice(arrays, g: int, dtype):
    """Rank ``g``'s slice of :func:`virtual_arrays`, weights in
    ``dtype``: ``(lr, lc, lv, [cr_k...], [cc_k...], [cv_k...], dg)``,
    the form every virtual round variant (plain, masked, stateful)
    consumes."""
    lr, lc, lv, cr, cc, cv, dg = arrays
    S = cr.shape[0]
    return (lr[g], lc[g], lv[g].to(dtype),
            [cr[k, g] for k in range(S)],
            [cc[k, g] for k in range(S)],
            [cv[k, g].to(dtype) for k in range(S)],
            dg[g].to(dtype))


def _virtual_combine(zf, recv, vt: VirtualTopology, sel, *, z_diag=None):
    """One round's combine on the virtual tier from the blocks already
    received: ``zf (V, F)`` is the rank's flattened block, the
    off-diagonal operand; ``recv (S, V, F)`` the block of each cross
    class (in ``dev_shifts`` order); ``sel`` the rank's selected edge
    arrays (:func:`_device_slice` layout, possibly mask-folded);
    ``z_diag`` (default ``zf``) the diagonal's operand, split out for
    the compressed rules' exact self term.  Adds the diagonal, the
    co-located sum, then each class, the reference's order."""
    lr, lc, lv, crs, ccs, cvs, dg = sel
    V = vt.block
    acc = dg[:, None] * (zf if z_diag is None else z_diag)
    acc = acc + _segment_sum(lv[:, None] * zf[lc], lr, V)
    for k in range(len(vt.dev_shifts)):
        acc = acc + _segment_sum(cvs[k][:, None] * recv[k][ccs[k]],
                                 crs[k], V)
    return acc


def _virtual_recv(zf, vt: VirtualTopology, mesh):
    """The blocks of every cross class, all in flight together in ONE
    ``ppermute_many`` (each class's block is rank g + s's); none without
    a message when the tier has no cross class (one rank)."""
    if vt.dev_shifts:
        return mesh.ppermute_many(zf, vt.dev_shifts)
    return tuple([] for _ in zf) if isinstance(zf, tuple) else []


def _virtual_selected_round(zf, vt: VirtualTopology, mesh, sel, *,
                            z_diag=None):
    """One combine round on the virtual tier with PRE-SELECTED (possibly
    mask-folded) edge arrays ``sel``: the cross classes' blocks by one
    ``ppermute_many`` of ``zf``, then :func:`_virtual_combine`."""
    return _virtual_combine(zf, _virtual_recv(zf, vt, mesh), vt, sel,
                            z_diag=z_diag)


def virtual_mesh_round(zf, vt: VirtualTopology, mesh, arrays):
    """One gossip round on the virtual tier: ``zf (V, F)`` this rank's
    flattened block, ``arrays`` from :func:`virtual_arrays`."""
    return _virtual_selected_round(
        zf, vt, mesh, _device_slice(arrays, mesh.axis_index(), zf.dtype))


def _virtual_masked_fold(vt: VirtualTopology, sel, g: int, mf, *,
                         fold_diag: bool = True):
    """Edge-level availability fold of rank ``g``'s selected arrays: a
    link is live iff BOTH endpoints are (receiver rows ``mf[g]``, sender
    rows ``mf[(g+s) mod D]`` per cross class), a dead link's weight
    folds into the receiver's diagonal (``fold_diag=False`` keeps the
    original diagonal, for push-sum, which renormalizes instead).
    ``mf`` is the (D, V) mask in the weights' dtype.  Padding carries
    weight exactly 0, so its gathers contribute nothing."""
    lr, lc, lv, crs, ccs, cvs, dg = sel
    V, D = vt.block, vt.n_dev
    mg = torch.cat([mf[g], mf.new_zeros(1)])    # the padding row V: dead
    keep = mg[lr] * mg[lc]
    lv_m = lv * keep
    lost = _segment_sum(lv * (1.0 - keep), lr, V)
    cvs_m = []
    for k, s in enumerate(vt.dev_shifts):
        ms = mf[(g + s) % D]                    # the class's sender block
        keep_k = mg[crs[k]] * ms[ccs[k]]
        cvs_m.append(cvs[k] * keep_k)
        lost = lost + _segment_sum(cvs[k] * (1.0 - keep_k), crs[k], V)
    dg_eff = dg + lost if fold_diag else dg
    return (lr, lc, lv_m, crs, ccs, cvs_m, dg_eff)


def _vt_edges(vt: VirtualTopology):
    """The GLOBAL off-diagonal COO (rows, cols, vals) a VirtualTopology
    encodes, padding excluded (host metadata for structural checks)."""
    D, V = vt.n_dev, vt.block
    rows, cols, vals = [], [], []
    for g in range(D):
        live = vt.local_rows[g] != V
        rows.append(g * V + vt.local_rows[g][live])
        cols.append(g * V + vt.local_cols[g][live])
        vals.append(vt.local_vals[g][live])
    for k, s in enumerate(vt.dev_shifts):
        for g in range(D):
            live = vt.cross_rows[k, g] != V
            rows.append(g * V + vt.cross_rows[k, g][live])
            cols.append(((g + s) % D) * V + vt.cross_cols[k, g][live])
            vals.append(vt.cross_vals[k, g][live])
    return (np.concatenate(rows).astype(np.int64),
            np.concatenate(cols).astype(np.int64),
            np.concatenate(vals))


def _vt_is_symmetric(vt: VirtualTopology) -> bool:
    """Whether the encoded mixing matrix is symmetric: the sorted edge
    list equals the sorted transposed one (values to float tolerance),
    never densified."""
    r, c, v = _vt_edges(vt)
    o1 = np.lexsort((c, r))       # (r, c) order of the edge list
    o2 = np.lexsort((r, c))       # (c, r) order = (r, c) of the transpose
    return (np.array_equal(r[o1], c[o2])
            and np.array_equal(c[o1], r[o2])
            and np.allclose(v[o1], v[o2]))


# ----------------------------------------------------------------------
# combine rules
# ----------------------------------------------------------------------

class CombineRule:
    """One consensus/combine scheme, lowered three ways.

    ``make_sim_mixer(W, T_con, backend=...)`` returns the simulator
    closure ``Z (L, ...) ↦ combined Z``; ``make_mesh_mixer(mesh, T_con,
    ...)`` the per-rank closure ``z ↦ combined z`` on a
    :class:`~repro_torch.distributed.mesh.NodeMesh` — pass ``W=`` for an
    arbitrary weighted topology (each distinct cyclic shift of W's
    sparsity pattern one ``ppermute``, each node combining with its own
    W row), or ``shifts``/``self_weight`` for the uniform circulant
    form; ``make_virtual_mesh_mixer(mesh, vt, T_con)`` the per-rank
    closure ``z (V, ...) ↦ z'`` on a block of the virtual tier (``vt`` a
    :class:`VirtualTopology`); ``signature(T_con)`` the comm cost.
    Subclasses override the pieces that differ."""

    name: str = "base"

    def make_sim_mixer(self, W, T_con: int, *,
                       backend: str = "torch-ref") -> Callable:
        raise NotImplementedError

    def make_mesh_mixer(self, mesh, T_con: int, shifts=(-1, 1),
                        self_weight: float | None = None, *, W=None,
                        backend: str = "torch-ref") -> Callable:
        raise NotImplementedError

    def make_virtual_mesh_mixer(self, mesh, vt: VirtualTopology, T_con: int,
                                *, backend: str = "torch-ref") -> Callable:
        raise NotImplementedError(
            f"combine rule {self.name!r} has no virtual-mesh lowering")

    def signature(self, T_con: int, **params) -> CommSignature:
        raise NotImplementedError

    # ---------------------------------------------------------- shared

    @staticmethod
    def _ring_weights(shifts, self_weight: float | None):
        k = len(shifts)
        sw = self_weight if self_weight is not None else 1.0 / (k + 1)
        return sw, (1.0 - sw) / k

    @classmethod
    def _mesh_weights(cls, L: int, shifts, self_weight: float | None, W):
        """The mesh lowering's (shifts, weights) pair.  With ``W``:
        decompose the mixing matrix — identical rows collapse to shared
        Python-float weights (the circulant case), otherwise the full
        (L, K+1) numpy table is kept and each node selects its row in
        the round.  Without ``W``: the uniform circulant weights of
        ``shifts`` / ``self_weight``."""
        if W is None:
            sw, wn = cls._ring_weights(shifts, self_weight)
            return tuple(shifts), (sw,) + (wn,) * len(shifts)
        shifts_, table = mesh_weights_from_matrix(W)
        if table.shape[0] != L:
            raise ValueError(f"mixing matrix is {table.shape[0]}×"
                             f"{table.shape[0]} but the mesh has {L} nodes")
        if np.all(table == table[0]):
            return shifts_, tuple(float(x) for x in table[0])
        return shifts_, table

    @staticmethod
    def _node_weights(placed, mesh, backend: str, dtype):
        """This node's combine weights from :func:`place_weights`'s pair:
        the float32 ones where the kernel combines, else the exact ones;
        a per-node table's row indexed by the node's rank on the device,
        never read back to the host."""
        exact, f32 = placed
        w = f32 if _fused_wanted(backend, dtype) else exact
        if not isinstance(w, tuple) and w.ndim == 2:
            w = w[mesh.axis_index()]
        return w

    @classmethod
    def _mesh_round(cls, z, mesh, shifts, placed, backend: str):
        """One gossip round on the mesh: the K neighbour blocks fetched by
        ``ppermute``, then ONE (K+1)-way combine (the kernel on cuda)."""
        w = cls._node_weights(placed, mesh, backend, z.dtype)
        nbrs = mesh.ppermute_many(z, shifts)
        return combine_blocks(z, nbrs, w, backend=backend)

    @classmethod
    def roll_round(cls, x, shifts, weights, *, backend: str = "torch-ref"):
        """One gossip round in the single-process form: neighbour blocks
        come from ``torch.roll`` over the leading node axis.  ``weights``:
        a length-K+1 tuple of Python floats shared by every node, the
        same as a (K+1,) float32 tensor on x's device (placed once by
        :func:`place_weights` for the kernel), or a per-node (L, K+1)
        table (column k+1 = each node's weight on its shift-``shifts[k]``
        neighbour — the :func:`mesh_weights_from_matrix` layout).  Shared
        weights take the fused combine on cuda; a table takes the
        sequential chain in the promoted accumulator dtype (the kernel
        takes one weight row for all of its elements)."""
        nbrs = [torch.roll(x, -s, dims=0) for s in shifts]
        if isinstance(weights, (tuple, list)):
            return combine_blocks(x, nbrs, tuple(weights), backend=backend)
        w = torch.as_tensor(weights, device=x.device)
        if w.ndim != 2:
            return combine_blocks(x, nbrs, w, backend=backend)
        if w.shape[0] != x.shape[0]:
            raise ValueError(
                f"per-node weight table has {w.shape[0]} rows but the "
                f"leading node axis is {x.shape[0]} — roll_round mixes "
                f"over the leading axis, one table row per node")
        acc_dt = _acc_dtype(x.dtype)
        col = (slice(None),) + (None,) * (x.ndim - 1)
        wt = w.to(acc_dt)
        acc = wt[:, 0][col] * x.to(acc_dt)
        for k, nbr in enumerate(nbrs):
            acc = acc + wt[:, k + 1][col] * nbr.to(acc_dt)
        return acc.to(x.dtype)


class GossipCombine(CombineRule):
    """The paper's AGREE combine: T_con rounds of the mixing product
    ``Z ← W Z`` (Algorithm 1)."""

    name = "gossip"

    def make_sim_mixer(self, W, T_con: int, *,
                       backend: str = "torch-ref") -> Callable:
        W = maybe_sparsify(W)
        if T_con == 0:
            return lambda Z: Z
        if isinstance(W, SparseWeights):
            return self._make_sparse_sim_mixer(W, T_con, backend)
        if backend == "torch-ref" or W.dtype == torch.float64:
            # sequential exact product: the plain backend, and float64
            # operands on any backend (decided on W's dtype up front, so
            # no f32 W^{T_con} is built for a float64 run)
            return lambda Z: stacked_product(Z, W, T_con)
        Wp = torch.linalg.matrix_power(W.to(torch.float32), T_con)

        def mix(Z):
            if Z.dtype == torch.float64:
                # the kernel accumulates in f32: keep float64 runs exact
                return stacked_product(Z, W, T_con)
            return stacked_dense_mix(Z, Wp, backend=backend)
        return mix

    @staticmethod
    def _make_sparse_sim_mixer(sw: SparseWeights, T_con: int, backend: str):
        """The sparse twin of the hoist policy: the fused backend takes
        ``W^{T_con}`` (:meth:`SparseWeights.power`, on the host) in ONE
        segment-sum round while the power's fill stays within its
        budget; past it, on torch-ref and for float64 operands, the
        T_con per-round sparse products."""
        hoisted = None
        if backend != "torch-ref" and T_con > 1:
            hoisted = _sparse_power(sw, T_con)      # None: over budget

        def mix(Z):
            if hoisted is None or Z.dtype == torch.float64:
                return stacked_sparse_product(Z, sw, T_con)
            return stacked_sparse_product(Z, hoisted, 1)
        return mix

    def make_mesh_mixer(self, mesh, T_con, shifts=(-1, 1), self_weight=None,
                        *, W=None, backend="torch-ref"):
        """Per-rank closure ``z ↦ z'``: T_con mesh rounds, each K
        ``ppermute``s and one combine.  The weights are placed on the
        node's device here, once."""
        shifts_, weights = self._mesh_weights(mesh.size, shifts, self_weight,
                                              W)
        if T_con == 0:
            return lambda z: z
        placed = place_weights(weights, mesh.device)

        def gossip(z):
            for _ in range(T_con):
                z = self._mesh_round(z, mesh, shifts_, placed, backend)
            return z
        return gossip

    def make_virtual_mesh_mixer(self, mesh, vt, T_con, *,
                                backend="torch-ref"):
        """Per-rank closure ``z (V, ...) ↦ z'`` on the virtual tier:
        T_con rounds, each the co-located segment sum and one
        ``ppermute_many`` of the block over the cross classes.  Always
        round by round: a ``W^{T_con}`` hoist would create new cross
        classes."""
        if T_con == 0:
            return lambda z: z
        arrays = virtual_arrays(vt, mesh.device)

        def gossip(z):
            sel = _device_slice(arrays, mesh.axis_index(), z.dtype)
            zf = z.reshape(vt.block, -1)
            for _ in range(T_con):
                zf = _virtual_selected_round(zf, vt, mesh, sel)
            return zf.reshape(z.shape)
        return gossip

    def signature(self, T_con: int, **params) -> CommSignature:
        return CommSignature("gossip", T_con)


class NeighborCombine(CombineRule):
    """DGD's combine: ONE row-stochastic neighbour average that excludes
    the node itself (Experiment 1's ``(1/deg_g) Σ_{g'∈N_g} U_g'``).  The
    simulator form takes the precomputed neighbour-average matrix M, a
    :class:`SparseWeights` on the sparse tier (one segment-sum round)."""

    name = "neighbor"

    def make_sim_mixer(self, M, T_con: int = 1, *,
                       backend: str = "torch-ref"):
        M = maybe_sparsify(M)
        return lambda Z: stacked_dense_mix(Z, M, backend=backend)

    def make_mesh_mixer(self, mesh, T_con=1, shifts=(-1, 1), self_weight=None,
                        *, W=None, backend="torch-ref"):
        """ONE neighbour-average round.  Without ``W`` the circulant
        graph of ``shifts`` is K-regular, so the average is the
        equal-weight shift combine with a zero self weight; with ``W``
        (the row-stochastic neighbour matrix, zero diagonal) each node
        combines with its own row."""
        if W is None:
            shifts_ = tuple(shifts)
            weights = (0.0,) + (1.0 / len(shifts),) * len(shifts)
        else:
            shifts_, weights = self._mesh_weights(mesh.size, shifts,
                                                  self_weight, W)
        placed = place_weights(weights, mesh.device)
        return lambda z: self._mesh_round(z, mesh, shifts_, placed, backend)

    def make_virtual_mesh_mixer(self, mesh, vt, T_con=1, *,
                                backend="torch-ref"):
        """ONE neighbour-average round on the virtual tier, whatever
        ``T_con`` says; ``vt`` decomposes the neighbour matrix, whose
        zero diagonal stays a zero ``diag`` plane."""
        arrays = virtual_arrays(vt, mesh.device)
        return lambda z: virtual_mesh_round(
            z.reshape(vt.block, -1), vt, mesh, arrays).reshape(z.shape)

    def signature(self, T_con: int, **params) -> CommSignature:
        return CommSignature("neighbor", 1)


class CentralCombine(CombineRule):
    """Fusion-center combine: the exact node mean (AltGDmin [10])."""

    name = "central"

    def make_sim_mixer(self, W=None, T_con: int = 0, *,
                       backend: str = "torch-ref"):
        return node_mean

    def make_mesh_mixer(self, mesh, T_con=0, shifts=(), self_weight=None,
                        *, W=None, backend="torch-ref"):
        return lambda z: mesh.psum(z) / mesh.size

    def signature(self, T_con: int, **params) -> CommSignature:
        return CommSignature("central", 1)


class NoCombine(CombineRule):
    """Local training: no communication (identity combine)."""

    name = "none"

    def make_sim_mixer(self, W=None, T_con: int = 0, *,
                       backend: str = "torch-ref"):
        return lambda Z: Z

    def make_mesh_mixer(self, mesh, T_con=0, shifts=(), self_weight=None,
                        *, W=None, backend="torch-ref"):
        return lambda z: z

    def signature(self, T_con: int, **params) -> CommSignature:
        return CommSignature("none", 0)


class ExactDiffusionCombine(GossipCombine):
    """The projection-corrected combine of Exact Subspace Diffusion
    (arXiv:2304.07358).  The mixing product is standard AGREE, but each
    application first bias-corrects the adapt iterate with the previous
    correction state:

        φ_g^τ = ψ_g^τ + U_g^{τ-1} − ψ_g^{τ-1}        (correction)
        Ũ_g^τ = Σ_j W_gj φ_j^τ  (T_con rounds)        (combine)

    so the combine tracks the exact (bias-free) fixed point instead of
    the diffusion limit point; the solver carries ``(ψ_prev, U_prev)``
    and retracts Ũ onto the Grassmannian afterwards."""

    name = "exact_diffusion"

    @staticmethod
    def correct(psi, psi_prev, U_prev):
        """φ = ψ + U_prev − ψ_prev (vanishes at τ=0 when ψ_prev=U_prev)."""
        return psi + U_prev - psi_prev


class BeyondCentralCombine(GossipCombine):
    """The communication-efficient combine of Beyond Centralization
    (arXiv:2512.22675): nodes take several *local* adapt steps between
    consensus exchanges and then combine with ONE gossip round — per
    outer iteration the wire carries a single d×r exchange instead of
    the T_con-round AGREE chain."""

    name = "beyond_central"

    def make_sim_mixer(self, W, T_con: int = 1, *,
                       backend: str = "torch-ref"):
        # a single mixing round regardless of T_con — that IS the rule
        return super().make_sim_mixer(W, 1, backend=backend)

    def make_mesh_mixer(self, mesh, T_con=1, shifts=(-1, 1), self_weight=None,
                        *, W=None, backend="torch-ref"):
        return super().make_mesh_mixer(mesh, 1, shifts, self_weight, W=W,
                                       backend=backend)

    def make_virtual_mesh_mixer(self, mesh, vt, T_con=1, *,
                                backend="torch-ref"):
        return super().make_virtual_mesh_mixer(mesh, vt, 1, backend=backend)

    def signature(self, T_con: int, **params) -> CommSignature:
        return CommSignature("gossip", 1)


# ----------------------------------------------------------------------
# compressed / event-triggered wire rules
# ----------------------------------------------------------------------

def _scatter_replace_rows(xhat, vals, idx):
    """Replace rows ``idx`` of each (d, r) block with ``vals`` (top-k
    refresh).  Indices from top-k are unique, so the scatter does not
    depend on order, and a FULL index set makes the result exactly
    ``vals``'s source — the bit-identity anchor of ``k = d``."""
    index = idx.long()[..., None].expand(-1, -1, xhat.shape[2])
    return xhat.scatter(1, index, vals)


_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer hash (xor-shift / multiply rounds) of values in
    [0, 2³²), on Python ints or int64 tensors alike.  The multiplier is
    below 2³¹, so every product fits in int64."""
    for _ in range(2):
        x = x ^ (x >> 16)
        x = (x * 0x45D9F3B) & _M32
    return x ^ (x >> 16)


def _mantissa_bits(dtype) -> int:
    """Significand bits of a floating dtype (24 for float32)."""
    eps = torch.finfo(dtype).eps
    return 1 - int(round(math.log2(eps)))


def stochastic_dither(count: int, node_ids, shape, dtype):
    """The uniform [0, 1) dither of the stochastic int8 wire for round
    ``count``: one draw per (count, node id, entry) of a counter-based
    hash, on ``node_ids``' device, in ``dtype`` with as many random bits
    as its significand holds (32 at most).  A node's draws depend on
    nothing but its id and the count — not on N, nor on which other
    nodes are drawn with it — so a per-node lowering can reproduce
    them.  These are not the JAX package's ``jax.random`` draws."""
    seed = _mix32((count * 0x9E3779B1 + 0x7F4A7C15) & _M32)   # host int
    n_entries = math.prod(shape)
    entries = torch.arange(n_entries, dtype=torch.int64,
                           device=node_ids.device)
    key = _mix32(seed ^ _mix32(node_ids.to(torch.int64)))
    h = _mix32(key[:, None] ^ _mix32(entries)[None, :])
    bits = min(32, _mantissa_bits(dtype))
    u = (h >> (32 - bits)).to(dtype) * 2.0 ** -bits
    return u.reshape((node_ids.shape[0],) + tuple(shape))


class CompressedGossipCombine(GossipCombine):
    """Base of the compressed-communication gossip rules.

    Every node keeps a PUBLIC COPY ``x̂_g`` of its iterate — the value
    the network believes — and each round refreshes the copy's stalest
    content with a compact payload (the reference-copy error-feedback
    scheme of CHOCO-SGD / EF21):

        payload, x̂_g' = refresh(Z_g, x̂_g)      # what crosses the wire
        x̂_j'          = apply(payload_j, x̂_j)  # neighbours' copies
        Z_g'           = W_gg·Z_g + Σ_{j≠g} W_gj·x̂_j'

    ``Z − x̂`` is exactly the accumulated compression error, re-injected
    into every later payload.  The SELF term never crosses a wire, so the
    simulator computes ``W @ X̂' + diag(W)·(Z − X̂')``: one dense combine
    on the refreshed copies (the ``mix_rows`` kernel on cuda, one launch
    per round) plus the exact-self correction.  A lossless refresh
    (k = d, θ = 0) makes ``X̂' = Z`` exactly, and the round IS the dense
    ``W @ Z`` product bit for bit on the exact (torch-ref / float64)
    lowering.  The cuda lowering agrees with dense gossip to f32
    round-off only: dense gossip hoists its T_con rounds onto one
    ``W^{T_con}``, a compressed rule mixes round by round.

    Precision policy (the shared ``_fused_wanted`` gate): float64
    operands take the plain encoder AND the exact dense product.

    The stateless ``make_sim_mixer`` raises (it would silently drop the
    state); callers use ``make_sim_state_mixer`` and seed the state with
    ``init_state``.  On the sparse tier a round is one segment sum with
    the exact self term built in, ``(W − diag) X̂' + diag·Z``.
    """

    # ------------------------------------------------- rule interface

    def resolve_params(self, d: int, r: int, **kw) -> dict:
        """Static per-run parameters from the spec knobs + problem dims."""
        raise NotImplementedError

    def refresh(self, Z, xhat, node_ids, count, *, backend, **params):
        """One round's wire encode for stacked blocks ``Z (N, d, r)``:
        returns ``(payload, xhat_new)`` — the compact payload that
        crosses the wire and the node's refreshed public copy."""
        raise NotImplementedError

    def apply(self, payload, xhat, *, backend, **params):
        """A receiver's side of ``refresh``: update a stored neighbour
        copy from a received payload; reproduces ``refresh``'s
        ``xhat_new`` bit for bit given the same payload and copy."""
        raise NotImplementedError

    # ------------------------------------------------------- state

    def init_state(self, Z_nodes, **kw):
        """The stacked public copies ``x̂`` (zero — the network starts
        with no beliefs), plus the round counter, a Python int, for the
        stochastic rules."""
        xhat = torch.zeros_like(Z_nodes)
        return (xhat, 0) if self._stochastic(**kw) else xhat

    def init_mesh_state(self, z_local, n_shifts: int, **kw):
        """A rank's mesh state: ``(x̂_own (1, d, r), x̂_nbrs (n_shifts, 1,
        d, r))`` — the node's public copy and its copy of each
        shift-neighbour's (what that neighbour's payloads have built up),
        all zero — plus the round counter for the stochastic rules."""
        own = torch.zeros_like(z_local[None])
        nbrs = own.new_zeros((n_shifts,) + tuple(own.shape))
        return (own, nbrs, 0) if self._stochastic(**kw) else (own, nbrs)

    def _stochastic(self, **kw) -> bool:
        return False

    # ----------------------------------------------------- lowerings

    def make_sim_mixer(self, W, T_con, *, backend="torch-ref"):
        raise TypeError(f"combine rule {self.name!r} is stateful; use "
                        f"make_sim_state_mixer / init_state")

    def make_mesh_mixer(self, mesh, T_con, shifts=(-1, 1), self_weight=None,
                        *, W=None, backend="torch-ref"):
        raise TypeError(f"combine rule {self.name!r} is stateful; use "
                        f"make_mesh_state_mixer / init_mesh_state")

    def make_virtual_mesh_mixer(self, mesh, vt, T_con, *,
                                backend="torch-ref"):
        raise TypeError(f"combine rule {self.name!r} is stateful; use "
                        f"make_virtual_mesh_state_mixer / init_state")

    def make_sim_state_mixer(self, W, T_con: int, *,
                             backend: str = "torch-ref", **kw) -> Callable:
        """Simulator closure ``(Z (L, d, r), state) ↦ (Z', state')``:
        T_con rounds of refresh + dense combine on the public copies +
        exact-self correction.  ``consensus_gamma`` (CHOCO step size,
        default 1) relaxes each round toward the combined value,
        ``Z ← Z + γ(combined − Z)``; γ = 1 is skipped, so default
        trajectories stay bit-identical."""
        gamma = float(kw.pop("consensus_gamma", 1.0))
        stochastic = self._stochastic(**kw)
        W = maybe_sparsify(W)
        sparse = isinstance(W, SparseWeights)
        if T_con == 0:
            return lambda Z, state: (Z, state)

        def mix(Z, state):
            N = Z.shape[0]
            params = self.resolve_params(Z.shape[1], Z.shape[2], **kw)
            ids = torch.arange(N, device=Z.device)
            fused = _fused_wanted(backend, Z.dtype)
            if sparse:
                rows, cols, vals, diag = sparse_operands(W, Z.device,
                                                         Z.dtype)
                w_diag = diag[:, None, None]
            else:
                Wz = W.to(torch.float32 if fused else Z.dtype)
                w_diag = torch.diagonal(W).to(Z.dtype)[:, None, None]
            for _ in range(T_con):
                xhat, count = state if stochastic else (state, None)
                _, xhat2 = self.refresh(Z, xhat, ids, count,
                                        backend=backend, **params)
                if sparse:
                    # the exact self term built in: (W − diag) x̂' +
                    # diag·Z equals W x̂' + diag·(Z − x̂') without the
                    # add-and-subtract round trip
                    off = sparse_offdiag_apply(xhat2.reshape(N, -1), rows,
                                               cols, vals, N)
                    Z2 = off.reshape(Z.shape) + w_diag * Z
                else:
                    if fused:
                        Z2 = stacked_dense_mix(xhat2, Wz, backend=backend)
                    else:
                        # the dense product on the refreshed copies,
                        # arithmetic-identical to stacked_product's round
                        Z2 = (Wz @ xhat2.reshape(N, -1)).reshape(Z.shape)
                    # exact-self correction: the node's own block never
                    # crosses a wire; a lossless refresh makes Z − xhat2
                    # exactly zero, so the round stays W @ Z bit for bit
                    Z2 = Z2 + w_diag * (Z - xhat2)
                if gamma != 1.0:
                    Z2 = Z + gamma * (Z2 - Z)      # CHOCO relaxation
                Z = Z2
                state = (xhat2, count + 1) if stochastic else xhat2
            return Z, state
        return mix

    def make_mesh_state_mixer(self, mesh, T_con: int, shifts=(-1, 1),
                              self_weight: float | None = None, *, W=None,
                              backend: str = "torch-ref",
                              **kw) -> Callable:
        """Per-rank closure ``(z (d, r), state) ↦ (z', state')`` with
        ``state`` from :meth:`init_mesh_state`.  Each round: ``refresh``
        of the node's own copy (node id = the rank, so the stochastic
        wire draws the simulator's dither for this node), ONE
        ``ppermute_many`` of the payload's leaves over the distinct
        shifts, ``apply`` to each stored neighbour copy, then ONE
        (K+1)-way combine of the exact self block and the K refreshed
        copies (one ``gossip_combine`` launch on cuda).
        ``consensus_gamma`` relaxes each round as on the simulator
        (γ = 1 skipped)."""
        gamma = float(kw.pop("consensus_gamma", 1.0))
        stochastic = self._stochastic(**kw)
        shifts_, weights = self._mesh_weights(mesh.size, shifts, self_weight,
                                              W)
        if T_con == 0:
            return lambda z, state: (z, state)
        placed = place_weights(weights, mesh.device)
        ids = torch.tensor([mesh.axis_index()], device=mesh.device)

        def mix(z, state):
            params = self.resolve_params(z.shape[0], z.shape[1], **kw)
            w = self._node_weights(placed, mesh, backend, z.dtype)
            for _ in range(T_con):
                own, copies = state[:2]
                count = state[2] if stochastic else None
                payload, own2 = self.refresh(z[None], own, ids, count,
                                             backend=backend, **params)
                recv = mesh.ppermute_many(payload, shifts_)
                copies2 = torch.stack([
                    self.apply(tuple(leaf[k] for leaf in recv), copies[k],
                               backend=backend, **params)
                    for k in range(len(shifts_))]) if shifts_ else copies
                # the node's own block goes in exact, its neighbours as
                # their refreshed public copies
                z2 = combine_blocks(z, copies2[:, 0], w, backend=backend)
                if gamma != 1.0:
                    z2 = z + gamma * (z2 - z)      # CHOCO relaxation
                z = z2
                state = ((own2, copies2, count + 1) if stochastic
                         else (own2, copies2))
            return z, state
        return mix

    def make_virtual_mesh_state_mixer(self, mesh, vt: VirtualTopology,
                                      T_con: int, *,
                                      backend: str = "torch-ref",
                                      **kw) -> Callable:
        """Per-rank closure ``(z (V, d, r), state) ↦ (z', state')`` on
        the virtual tier, ``state`` the block's public copies from
        :meth:`init_state` (zero, one a node).  Each round refreshes the
        whole block in ONE ``refresh`` call — with the GLOBAL node ids
        g·V + [0, V), so the stochastic wire draws the simulator's
        dither — then one virtual round on the refreshed copies with the
        diagonal on the EXACT iterate (the simulator's ``W x̂' +
        diag·(Z − x̂')``).  A cross class ships the whole refreshed
        block, one send a round.  ``consensus_gamma`` relaxes each round
        as on the other lowerings (γ = 1 skipped)."""
        gamma = float(kw.pop("consensus_gamma", 1.0))
        stochastic = self._stochastic(**kw)
        if T_con == 0:
            return lambda z, state: (z, state)
        arrays = virtual_arrays(vt, mesh.device)
        V, g = vt.block, mesh.axis_index()
        ids = g * V + torch.arange(V, device=mesh.device)

        def mix(z, state):
            params = self.resolve_params(z.shape[1], z.shape[2], **kw)
            sel = _device_slice(arrays, g, z.dtype)
            for _ in range(T_con):
                xhat, count = state if stochastic else (state, None)
                _, xhat2 = self.refresh(z, xhat, ids, count,
                                        backend=backend, **params)
                z2 = _virtual_selected_round(
                    xhat2.reshape(V, -1), vt, mesh, sel,
                    z_diag=z.reshape(V, -1)).reshape(z.shape)
                if gamma != 1.0:
                    z2 = z + gamma * (z2 - z)      # CHOCO relaxation
                z = z2
                state = (xhat2, count + 1) if stochastic else xhat2
            return z, state
        return mix


class TopkGossipCombine(CompressedGossipCombine):
    """``topk_gossip`` — top-k ROW refresh: per round each node
    re-broadcasts the ``compression_k`` rows of its iterate whose public
    copy drifted the most (largest ``‖Z − x̂‖`` row norms — the
    ``compress_topk`` kernel selects them; the wire carries the ABSOLUTE
    ``Z`` rows + int32 indices; receivers replace those copy rows).
    ``compression_k = 0`` defaults to d/4; ``compression_k = d``
    recovers dense gossip bit-identically on the exact path.

    Wire pricing: k·r f32 payload values plus k int32 row indices, 4
    bytes each."""

    name = "topk_gossip"

    def resolve_params(self, d, r, compression_k: int = 0, **_):
        k = int(compression_k) or max(1, d // 4)
        if not 1 <= k <= d:
            raise ValueError(f"topk_gossip needs 1 <= compression_k <= d, "
                             f"got k={k} for d={d}")
        return {"k": k}

    def refresh(self, Z, xhat, node_ids, count, *, backend, k):
        delta = Z - xhat                     # accumulated compression error
        cb = backend if _fused_wanted(backend, Z.dtype) else "torch-ref"
        _, idx = ops.compress_topk(delta, k, backend=cb)   # stalest rows
        vals = torch.gather(Z, 1, idx.long()[..., None].expand(
            -1, -1, Z.shape[2]))
        return (vals, idx), _scatter_replace_rows(xhat, vals, idx)

    def apply(self, payload, xhat, *, backend, k):
        vals, idx = payload
        return _scatter_replace_rows(xhat, vals, idx)

    def signature(self, T_con: int, *, d=None, r=None, compression_k=0,
                  **_) -> CommSignature:
        if d is None or r is None:
            return CommSignature("gossip", T_con)
        k = self.resolve_params(d, r, compression_k)["k"]
        # f32 wire values (k·r) + int32 row indices (k): 4 bytes each
        return CommSignature("gossip", T_con,
                             entries_per_round=k * (r + 1),
                             bytes_per_entry=4)


class QuantizedGossipCombine(CompressedGossipCombine):
    """``quantized_gossip`` — low-precision wire with full-precision
    accumulation: the DIFFERENCE ``Z − x̂`` is quantized and added onto
    the public copies, so the quantization error contracts with
    consensus.  Wire formats (``compression``):

      * ``"bf16"`` (default) — round-to-nearest-even bfloat16 cast;
      * ``"int8"`` — per-message max-abs scale, round-half-to-even int8
        (on cuda a sender's round, encode, decode and accumulate, is one
        ``int8_round`` launch; a receiver's ``apply`` decodes with the
        ``dequant`` kernel);
      * ``"int8_stochastic"`` — int8 with stochastic rounding, dithered
        by :func:`stochastic_dither` (a counter-based draw per round
        count and node id; not the JAX package's ``jax.random`` bits).
    """

    name = "quantized_gossip"

    WIRES = ("bf16", "int8", "int8_stochastic")

    def resolve_params(self, d, r, compression=None, **_):
        wire = compression or "bf16"
        if wire not in self.WIRES:
            raise ValueError(f"unknown quantized_gossip wire format "
                             f"{wire!r}; expected one of {self.WIRES}")
        return {"wire": wire}

    def _stochastic(self, compression=None, **_):
        return (compression or "bf16") == "int8_stochastic"

    _int8_scale = staticmethod(ref_int8_scale)

    @staticmethod
    def _dequant(q, scale, *, backend):
        cb = backend if _fused_wanted(backend, scale.dtype) else "torch-ref"
        return ops.dequant(q, scale, backend=cb)

    def refresh(self, Z, xhat, node_ids, count, *, backend, wire):
        if wire == "bf16":
            q = (Z - xhat).to(torch.bfloat16)   # accumulated compression error
            return (q,), xhat + q.to(Z.dtype)
        # the whole int8 round (encode, decode, accumulate): one
        # int8_round launch on cuda, ref_int8_round on torch-ref and f64
        u = (stochastic_dither(count, node_ids, Z.shape[1:], Z.dtype)
             if wire == "int8_stochastic" else None)
        cb = backend if _fused_wanted(backend, Z.dtype) else "torch-ref"
        q, scale, xhat2 = ops.int8_round(Z, xhat, u, backend=cb)
        return (q, scale), xhat2

    def apply(self, payload, xhat, *, backend, wire):
        if wire == "bf16":
            return xhat + payload[0].to(xhat.dtype)
        q, scale = payload
        return xhat + self._dequant(q, scale, backend=backend)

    def signature(self, T_con: int, *, d=None, r=None, compression=None,
                  **_) -> CommSignature:
        if d is None or r is None:
            return CommSignature("gossip", T_con)
        wire = self.resolve_params(d, r, compression)["wire"]
        if wire == "bf16":
            return CommSignature("gossip", T_con, entries_per_round=d * r,
                                 bytes_per_entry=2)
        # int8 payload + one f32 scale (4 one-byte entries)
        return CommSignature("gossip", T_con, entries_per_round=d * r + 4,
                             bytes_per_entry=1)


class EventGossipCombine(CompressedGossipCombine):
    """``event_gossip`` — event-triggered exchange: a node re-broadcasts
    its full iterate only when its public copy went stale,
    ``‖Z_g − x̂_g‖_F > θ·‖Z_g‖_F`` (θ = ``event_threshold``); otherwise
    neighbours keep combining with the last-sent copy.  θ = 0 always
    triggers and recovers dense gossip bit-identically on the exact
    path.  The static signature prices the θ = 0 worst case; the
    measured send fraction is :meth:`send_fraction`."""

    name = "event_gossip"

    def resolve_params(self, d, r, event_threshold: float = 0.0, **_):
        if event_threshold < 0:
            raise ValueError(f"event_threshold must be >= 0, got "
                             f"{event_threshold}")
        return {"threshold": float(event_threshold)}

    @staticmethod
    def _trigger(Z, xhat, threshold):
        """Per-node send decision ``‖Z − x̂‖_F > θ·‖Z‖_F`` — one
        definition shared by the round encode and the send fraction."""
        moved = torch.sqrt(torch.sum((Z - xhat) ** 2, dim=(-2, -1)))
        scale = torch.sqrt(torch.sum(Z ** 2, dim=(-2, -1)))
        return moved > threshold * scale

    def refresh(self, Z, xhat, node_ids, count, *, backend, threshold):
        trig = self._trigger(Z, xhat, threshold)
        S = torch.where(trig[:, None, None], Z, xhat)   # absolute resend
        return (S,), S

    def apply(self, payload, xhat, *, backend, threshold):
        return payload[0]

    def send_fraction(self, Z, xhat, threshold: float):
        """Measured trigger rate of one round, a 0-d float32 tensor on
        the device (no host sync)."""
        return torch.mean(self._trigger(Z, xhat, threshold)
                          .to(torch.float32))

    def signature(self, T_con: int, **_) -> CommSignature:
        # static pricing cannot see the trigger rate: θ = 0 worst case
        return CommSignature("gossip", T_con)


# ----------------------------------------------------------------------
# dropout-tolerant rules (availability-masked gossip)
# ----------------------------------------------------------------------

def _index_order_sum(A, dim: int):
    """The sum of a square matrix along ``dim`` taken in index order (the
    last entry of a cumulative sum, sequential on the CPU): the order in
    which the JAX package's reduction sums these masses on the CPU at
    the node counts of the parity tests (L = 8 and 20), so the float64
    masked matrices equal the reference's bit for bit there.  A plain
    ``torch.sum`` vectorizes and may part in the last bit."""
    return torch.cumsum(A, dim=dim).select(dim, -1)


def masked_mixing_matrix(W, mask):
    """Per-round effective mixing matrix under a participation mask
    ``mask: (L,)`` (truthy = live).  A link is live iff BOTH endpoints
    are; a dead link's weight folds back into the SELF weight (mass
    redistribution over the live neighbourhood rather than row division),
    which (a) keeps W(m) doubly stochastic whenever W is — so partial
    gossip stays an unbiased averaging operator in expectation — and
    (b) makes the full mask return W bit for bit (multiply by exact
    ones, add exact zeros): the degenerate regression anchor.  A fully
    isolated down node's row degenerates to ``e_g`` (its lost weight is
    its whole off-diagonal mass), freezing its iterate.  The lost mass
    is summed in index order (:func:`_index_order_sum`)."""
    m = mask.to(W.dtype)
    eye = torch.eye(W.shape[0], dtype=W.dtype, device=W.device)
    keep = m[:, None] * m[None, :] * (1.0 - eye) + eye   # self link stays
    lost = _index_order_sum(W * (1.0 - keep), dim=1)
    return W * keep + torch.diag(lost)


def push_sum_matrix(W, mask):
    """Column-stochastic masked mixing matrix for push-sum: live sender
    j distributes its mass over its LIVE out-neighbours + itself, each
    column renormalized by its live mass ``c_j = W_jj + Σ_{i≠j} m_i m_j
    W_ij`` — exactly column-stochastic by construction, whatever the
    mask does to the graph (the directed, non-doubly-stochastic regime
    push-sum's weight carry corrects).  The column mass is summed in
    index order (:func:`_index_order_sum`)."""
    m = mask.to(W.dtype)
    eye = torch.eye(W.shape[0], dtype=W.dtype, device=W.device)
    keep = m[:, None] * m[None, :] * (1.0 - eye) + eye
    Wm = W * keep
    c = _index_order_sum(Wm, dim=0)                      # live column mass
    return Wm / torch.where(c > 0, c, torch.ones_like(c))[None, :]


def _sparse_masked_fold(rows, cols, vals, diag, m, L: int):
    """Edge-level :func:`masked_mixing_matrix`: a link is live iff BOTH
    endpoints are (``keep = m_i · m_j`` a stored edge), and a dead
    link's weight folds into the receiver's diagonal.  ``m`` is the (L,)
    mask in the weights' dtype; the padding row L reads a dead mask
    entry appended here, and its weight is exactly 0 either way, so the
    padding adds nothing to either term."""
    mg = torch.cat([m, m.new_zeros(1)])         # the padding row L: dead
    keep = mg[rows] * mg[cols]
    lost = _segment_sum(vals * (1.0 - keep), rows, L)
    return vals * keep, diag + lost


def _sparse_masked_gossip_mixer(sw: SparseWeights, T_con: int):
    """The sparse lowering of ``partial_gossip``'s simulator mixer: the
    mask folded once a call, then T_con segment-sum rounds (no
    ``W^{T_con}`` hoist: the fold depends on the data), on any
    backend."""
    L = sw.n

    def mix(Z, m):
        rows, cols, vals, diag = sparse_operands(sw, Z.device, Z.dtype)
        vals_eff, diag_eff = _sparse_masked_fold(rows, cols, vals, diag,
                                                 m.to(Z.dtype), L)
        flat = Z.reshape(L, -1)
        for _ in range(T_con):
            flat = sparse_round(flat, rows, cols, vals_eff, diag_eff, L)
        return flat.reshape(Z.shape)
    return mix


class MaskedGossipCombine(GossipCombine):
    """Base of the dropout-tolerant gossip rules: per-iteration
    availability masks enter the combine, so the stateless
    ``make_sim_mixer`` / ``make_mesh_mixer`` entry points are forbidden
    (they would silently drop the mask) — drivers use the ``*_masked_*``
    forms and pass the (L,) mask of the CURRENT outer iteration (all
    T_con rounds of one iteration share it; node churn is an
    outer-iteration phenomenon, not a per-round one)."""

    def make_sim_mixer(self, W, T_con, *, backend="torch-ref"):
        raise TypeError(f"combine rule {self.name!r} is availability-"
                        f"masked; use make_sim_masked_mixer")

    def make_mesh_mixer(self, mesh, T_con, shifts=(-1, 1), self_weight=None,
                        *, W=None, backend="torch-ref"):
        raise TypeError(f"combine rule {self.name!r} is availability-"
                        f"masked; use make_mesh_masked_mixer")

    def make_virtual_mesh_mixer(self, mesh, vt, T_con, *,
                                backend="torch-ref"):
        raise TypeError(f"combine rule {self.name!r} is availability-"
                        f"masked; use make_virtual_mesh_masked_mixer")

    def signature(self, T_con: int, **params) -> CommSignature:
        # static pricing cannot see the mask: full-participation worst
        # case (the event-driven clock measures the real cost)
        return CommSignature("gossip", T_con)

    # ---------------------------------------------------- mesh shared

    @classmethod
    def _mesh_node(cls, mesh, shifts_, weights, backend: str):
        """What a masked mesh mixer fixes when it is built, on the node's
        device: ``node(m, dtype) -> (w, keep)``, the node's dense (K+1,)
        weight row (float32 where the kernel combines, else exact) and
        the liveness of each of its shift links under the (L,) mask ``m``,
        keep_k = m_g · m_{(g+s_k) mod L}, in ``w``'s dtype.  Both stay on
        the device: the mask is indexed by the rank there and never read
        back to the host."""
        placed = place_weights(weights, mesh.device)
        if isinstance(placed[0], tuple):
            placed = (torch.tensor(placed[0], dtype=torch.float64,
                                   device=mesh.device), placed[1])
        g = mesh.axis_index()
        nbr = torch.tensor([(g + s) % mesh.size for s in shifts_],
                           dtype=torch.long, device=mesh.device)

        def node(m, dtype):
            w = cls._node_weights(placed, mesh, backend, dtype)
            mf = m.to(w.dtype)
            return w, mf[g] * mf[nbr]
        return node

    @staticmethod
    def _fold(w, keep):
        """The node's row of :func:`masked_mixing_matrix` in shift form:
        dead links zeroed, their weight folded into the self weight.
        Under a full mask ``w·1`` and ``w₀ + 0`` keep the dense weights
        bit for bit."""
        return torch.cat([w[:1] + torch.sum(w[1:] * (1.0 - keep)),
                          w[1:] * keep])


class PartialGossipCombine(MaskedGossipCombine):
    """``partial_gossip`` — per-round participation masking: only links
    whose BOTH endpoints are live carry weight, the dead weight folds
    into the self weight (see :func:`masked_mixing_matrix`), and down
    nodes' rows collapse toward identity (the driver freezes their
    iterate anyway).  With availability ≡ 1 the effective matrix IS W
    bit for bit, so on the exact lowering trajectories reproduce dense
    ``dif_altgdmin`` exactly — the regression anchor of the fault
    layer."""

    name = "partial_gossip"

    def make_sim_masked_mixer(self, W, T_con: int, *,
                              backend: str = "torch-ref") -> Callable:
        """Simulator closure ``(Z (L, ...), m (L,)) ↦ Z'``: T_con rounds
        of the masked matrix, no ``W^{T_con}`` hoist (it depends on the
        data) — one ``mix_rows`` launch a round on cuda; on torch-ref
        and for float64 the flattened ``Weff @ flat`` chain,
        arithmetic-identical to :func:`stacked_product`'s rounds.  On the
        sparse tier :func:`_sparse_masked_gossip_mixer`."""
        W = maybe_sparsify(W)
        if T_con == 0:
            return lambda Z, m: Z
        if isinstance(W, SparseWeights):
            return _sparse_masked_gossip_mixer(W, T_con)

        def mix(Z, m):
            Weff = masked_mixing_matrix(W.to(Z.dtype), m)
            if _fused_wanted(backend, Z.dtype):
                for _ in range(T_con):
                    Z = stacked_dense_mix(Z, Weff, backend=backend)
                return Z
            flat = Z.reshape(Z.shape[0], -1)
            for _ in range(T_con):
                flat = Weff @ flat
            return flat.reshape(Z.shape)
        return mix

    def make_mesh_masked_mixer(self, mesh, T_con: int, shifts=(-1, 1),
                               self_weight: float | None = None, *, W=None,
                               backend: str = "torch-ref") -> Callable:
        """Per-rank closure ``(z (d, r), m (L,)) ↦ z'``: T_con rounds,
        each the K neighbour blocks by ``ppermute`` and ONE combine under
        the node's folded weights (one ``gossip_combine`` launch on
        cuda), derived from the iteration's mask once a call."""
        shifts_, weights = self._mesh_weights(mesh.size, shifts, self_weight,
                                              W)
        if T_con == 0:
            return lambda z, m: z
        node = self._mesh_node(mesh, shifts_, weights, backend)

        def mix(z, m):
            w_eff = self._fold(*node(m, z.dtype))
            for _ in range(T_con):
                nbrs = mesh.ppermute_many(z, shifts_)
                z = combine_blocks(z, nbrs, w_eff, backend=backend)
            return z
        return mix

    def make_virtual_mesh_masked_mixer(self, mesh, vt: VirtualTopology,
                                       T_con: int, *,
                                       backend: str = "torch-ref"
                                       ) -> Callable:
        """Per-rank closure ``(z (V, d, r), m (L,)) ↦ z'`` on the virtual
        tier: the edge-level fold (:func:`_virtual_masked_fold`, the COO
        form of :func:`masked_mixing_matrix`) once a call, then T_con
        plain virtual rounds on the folded arrays.  Full mask: every
        keep is 1 and the rounds ARE the dense virtual rounds bit for
        bit."""
        if T_con == 0:
            return lambda z, m: z
        arrays = virtual_arrays(vt, mesh.device)
        g = mesh.axis_index()

        def mix(z, m):
            mf = m.to(z.dtype).reshape(vt.n_dev, vt.block)
            sel = _virtual_masked_fold(
                vt, _device_slice(arrays, g, z.dtype), g, mf)
            zf = z.reshape(vt.block, -1)
            for _ in range(T_con):
                zf = _virtual_selected_round(zf, vt, mesh, sel)
            return zf.reshape(z.shape)
        return mix


class StaleGossipCombine(MaskedGossipCombine):
    """``stale_gossip`` — dropout tolerance on the reference-copy
    machinery of the compressed rules: every node's PUBLIC COPY x̂
    persists across iterations (the state rides the solver loop); a
    LIVE node re-publishes its iterate each round (x̂ ← Z), a DOWN node
    sends nothing new — its last-delivered copy sits in the neighbours'
    receive queue and mixes in ONCE, in the iteration's first AGREE
    round.  Rounds 2..T_con have no fresh packet from a down node to
    deliver, so the down link's weight folds to the receiver's diagonal
    exactly like ``partial_gossip``.  Down nodes neither combine (the
    driver freezes them).  Full mask: every copy refreshes to Z, the
    fold is a no-op, and on the exact lowering every round IS dense
    ``W @ Z`` bit for bit."""

    name = "stale_gossip"

    def init_state(self, Z_nodes, **kw):
        """Stacked public copies x̂ (L, d, r), zero — the network starts
        with no beliefs, exactly like the compressed rules."""
        return torch.zeros_like(Z_nodes)

    def init_mesh_state(self, z_local, n_shifts: int = 0, **kw):
        """A rank's mesh state: its own public copy (1, d, r), zero.  No
        neighbour copies are kept: a round's payload IS the sender's
        current copy."""
        return torch.zeros_like(z_local[None])

    def make_sim_masked_state_mixer(self, W, T_con: int, *,
                                    backend: str = "torch-ref",
                                    **kw) -> Callable:
        """Simulator closure ``(Z, x̂, m) ↦ (Z', x̂')``: each round live
        nodes publish, the copies mix (round 0 under the dense W — the
        queued stale packet delivers once — later rounds under the
        masked fold; one ``mix_rows`` launch a round on cuda), and down
        nodes freeze."""
        W = maybe_sparsify(W)
        if T_con == 0:
            return lambda Z, state, m: (Z, state)
        if isinstance(W, SparseWeights):
            return self._make_sparse_masked_state_mixer(W, T_con)

        def mix(Z, state, m):
            N = Z.shape[0]
            Wd = W.to(Z.dtype)
            Weff = masked_mixing_matrix(Wd, m)
            mrow = m.to(torch.bool)[:, None, None]
            fused = _fused_wanted(backend, Z.dtype)
            xhat = state
            for rd in range(T_con):
                xhat = torch.where(mrow, Z, xhat)     # live nodes publish
                Wr = Wd if rd == 0 else Weff
                if fused:
                    Z2 = stacked_dense_mix(xhat, Wr, backend=backend)
                else:
                    Z2 = (Wr @ xhat.reshape(N, -1)).reshape(Z.shape)
                # live g's own copy is exact (x̂_g = Z_g), so no self
                # correction is needed; down nodes freeze outright
                Z = torch.where(mrow, Z2, Z)
            return Z, xhat
        return mix

    @staticmethod
    def _make_sparse_masked_state_mixer(sw: SparseWeights, T_con: int):
        """Sparse stale-gossip rounds: round 0 applies the unmasked edge
        values to the published copies (the queued stale packet delivers
        once), later rounds the edge-level fold."""
        L = sw.n

        def mix(Z, xhat, m):
            rows, cols, vals, diag = sparse_operands(sw, Z.device, Z.dtype)
            vals_eff, diag_eff = _sparse_masked_fold(rows, cols, vals, diag,
                                                     m.to(Z.dtype), L)
            mrow = m.to(torch.bool)[:, None, None]
            for rd in range(T_con):
                xhat = torch.where(mrow, Z, xhat)     # live nodes publish
                v, dg = (vals, diag) if rd == 0 else (vals_eff, diag_eff)
                Z2 = sparse_round(xhat.reshape(L, -1), rows, cols, v, dg,
                                  L).reshape(Z.shape)
                Z = torch.where(mrow, Z2, Z)          # down: freeze
            return Z, xhat
        return mix

    def make_mesh_masked_state_mixer(self, mesh, T_con: int, shifts=(-1, 1),
                                     self_weight: float | None = None, *,
                                     W=None, backend: str = "torch-ref",
                                     **kw) -> Callable:
        """Per-rank closure ``(z, x̂_own, m) ↦ (z', x̂_own')``: each round
        a live node publishes z into its copy and every node sends its
        copy (a down node's carries its last-published value); round 0
        combines the exact self block with the K delivered copies under
        the dense weights (the queued stale packet delivers once), later
        rounds under the folded ones; a down node freezes."""
        shifts_, weights = self._mesh_weights(mesh.size, shifts, self_weight,
                                              W)
        if T_con == 0:
            return lambda z, state, m: (z, state)
        node = self._mesh_node(mesh, shifts_, weights, backend)
        g = mesh.axis_index()

        def mix(z, own, m):
            w, keep = node(m, z.dtype)
            w_fold = self._fold(w, keep)
            live = m.to(torch.bool)[g]
            for rd in range(T_con):
                own = torch.where(live, z[None], own)      # publish if live
                nbrs = mesh.ppermute_many(own[0], shifts_)
                z2 = combine_blocks(z, nbrs, w if rd == 0 else w_fold,
                                    backend=backend)
                z = torch.where(live, z2, z)               # down: freeze
            return z, own
        return mix

    def make_virtual_mesh_masked_state_mixer(self, mesh, vt: VirtualTopology,
                                             T_con: int, *,
                                             backend: str = "torch-ref",
                                             **kw) -> Callable:
        """Per-rank closure ``(z (V, d, r), x̂ (V, d, r), m (L,)) ↦ (z',
        x̂')`` on the virtual tier: live nodes of the block publish into
        their copies, round 0 mixes the copies under the UNMASKED edge
        values (the queued stale packet delivers once), later rounds
        under the edge-level fold; down nodes freeze."""
        if T_con == 0:
            return lambda z, state, m: (z, state)
        arrays = virtual_arrays(vt, mesh.device)
        V, g = vt.block, mesh.axis_index()

        def mix(z, xhat, m):
            sel = _device_slice(arrays, g, z.dtype)
            sel_m = _virtual_masked_fold(
                vt, sel, g, m.to(z.dtype).reshape(vt.n_dev, V))
            mrow = m.to(torch.bool).reshape(vt.n_dev, V)[g][:, None, None]
            for rd in range(T_con):
                xhat = torch.where(mrow, z, xhat)      # live nodes publish
                acc = _virtual_selected_round(xhat.reshape(V, -1), vt, mesh,
                                              sel if rd == 0 else sel_m)
                z = torch.where(mrow, acc.reshape(z.shape), z)
            return z, xhat
        return mix


class PushSumGossipCombine(MaskedGossipCombine):
    """``push_sum_gossip`` — ratio consensus for the DIRECTED mixing
    matrices dropout induces: the masked matrix (:func:`push_sum_matrix`)
    is only column-stochastic, so plain gossip would drift toward a
    weighted (biased) average; push-sum carries a companion weight w
    through the same matrix (z ← Cz, w ← Cw, w₀ = 1) and reads out the
    bias-corrected ratio z/w after the T_con rounds.  The weight resets
    to 1 each outer iteration, so no cross-iteration state is carried.
    Full mask on a doubly stochastic W: C ≈ W and w ≈ 1 up to the row
    sums' round-off — dense gossip to machine precision, not bit for
    bit.  On cuda a round is two ``mix_rows`` launches: the iterate and
    the (L, 1) weight column."""

    name = "push_sum_gossip"

    def make_sim_masked_mixer(self, W, T_con: int, *,
                              backend: str = "torch-ref") -> Callable:
        W = maybe_sparsify(W)
        if T_con == 0:
            return lambda Z, m: Z
        if isinstance(W, SparseWeights):
            return self._make_sparse_masked_mixer(W, T_con)

        def mix(Z, m):
            N = Z.shape[0]
            C = push_sum_matrix(W.to(Z.dtype), m)
            flat = Z.reshape(N, -1)
            wv = torch.ones((N, 1), dtype=Z.dtype, device=Z.device)
            fused = _fused_wanted(backend, Z.dtype)
            for _ in range(T_con):
                if fused:
                    flat = stacked_dense_mix(flat, C, backend=backend)
                    wv = stacked_dense_mix(wv, C, backend=backend)
                else:
                    flat, wv = C @ flat, C @ wv
            out = flat / torch.where(wv > 0, wv, torch.ones_like(wv))
            return out.reshape(Z.shape)
        return mix

    @staticmethod
    def _make_sparse_masked_mixer(sw: SparseWeights, T_con: int):
        """Sparse push-sum: the column normalizer is a segment sum over
        the SENDER columns of the masked edge values (``c_j = W_jj +
        Σ_{i≠j} m_i m_j W_ij``, the self link always kept, as in
        :func:`push_sum_matrix`), the column-stochastic edge values are
        ``vals_m / c[col]``, and the weight column rides the same
        rounds."""
        L = sw.n

        def mix(Z, m):
            rows, cols, vals, diag = sparse_operands(sw, Z.device, Z.dtype)
            mf = m.to(Z.dtype)
            mg = torch.cat([mf, mf.new_zeros(1)])   # the padding row L
            vals_m = vals * mg[rows] * mf[cols]
            # live column mass: the padding cols point at 0 with weight 0
            c = diag + diag.new_zeros(L).index_add_(0, cols, vals_m)
            c = torch.where(c > 0, c, torch.ones_like(c))
            vals_c, diag_c = vals_m / c[cols], diag / c
            flat = Z.reshape(L, -1)
            wv = torch.ones((L, 1), dtype=Z.dtype, device=Z.device)
            for _ in range(T_con):
                flat = sparse_round(flat, rows, cols, vals_c, diag_c, L)
                wv = sparse_round(wv, rows, cols, vals_c, diag_c, L)
            out = flat / torch.where(wv > 0, wv, torch.ones_like(wv))
            return out.reshape(Z.shape)
        return mix

    def make_mesh_masked_mixer(self, mesh, T_con: int, shifts=(-1, 1),
                               self_weight: float | None = None, *, W=None,
                               backend: str = "torch-ref") -> Callable:
        """Per-rank push-sum ``(z (d, r), m (L,)) ↦ z'``: the sender
        normalizes by its OWN column's live mass c (from its row, which
        is its column because W must be symmetric), sends the pre-scaled
        pair (z/c, w/c) in one ``ppermute_many``, and receivers combine
        under their masked row (``gossip_combine`` on cuda for z, the
        chain for the weight); after T_con rounds z/w.  Raises
        ValueError on an asymmetric W, or on shifts not closed under
        negation: the sender-side column exchange that those would need
        is not implemented."""
        if W is not None:
            if isinstance(W, SparseWeights):
                # reprolint: allow=RL002 — one-node-per-rank mesh tier is small-L by construction; large L uses VirtualTopology
                Wn = W.to_dense()
            else:
                Wn = W.detach().cpu().numpy() if torch.is_tensor(W) \
                    else np.asarray(W)
            if not np.allclose(Wn, Wn.T):
                raise ValueError(
                    "push_sum_gossip's mesh lowering computes each "
                    "sender's column normalizer from its own row, which "
                    "requires a symmetric mixing matrix")
        elif set(shifts) != {-s for s in shifts}:
            raise ValueError(
                f"push_sum_gossip's mesh lowering needs symmetric "
                f"circulant shifts (closed under negation), got "
                f"{tuple(shifts)}")
        shifts_, weights = self._mesh_weights(mesh.size, shifts, self_weight,
                                              W)
        if T_con == 0:
            return lambda z, m: z
        node = self._mesh_node(mesh, shifts_, weights, backend)

        def mix(z, m):
            w, keep = node(m, z.dtype)
            c = w[0] + torch.sum(w[1:] * keep)     # own column's live mass
            c = torch.where(c > 0, c, torch.ones_like(c)).to(z.dtype)
            w_eff = torch.cat([w[:1], w[1:] * keep])
            wv = torch.ones((1,), dtype=z.dtype, device=z.device)
            for _ in range(T_con):
                zs, ws = z / c, wv / c             # pre-scaled payload
                nz, nw = mesh.ppermute_many((zs, ws), shifts_)
                z = combine_blocks(zs, nz, w_eff, backend=backend)
                wv = combine_blocks(ws, nw, w_eff, backend="torch-ref")
            return z / torch.where(wv > 0, wv, torch.ones_like(wv))
        return mix

    def make_virtual_mesh_masked_mixer(self, mesh, vt: VirtualTopology,
                                       T_con: int, *,
                                       backend: str = "torch-ref"
                                       ) -> Callable:
        """Per-rank push-sum ``(z (V, d, r), m (L,)) ↦ z'`` on the
        virtual tier: each node's column normalizer is its own RECEIVER-
        side live mass (its row is its column: W must be symmetric,
        checked here), the pre-scaled pair (z/c, w/c) crosses in ONE
        ``ppermute_many`` a round (two sends a class) and mixes under the
        masked edge values with the ORIGINAL diagonal — the simulator's
        column-stochastic rounds, since vals_C·z[col] = vals_m·(z/c)[col]
        and diag_C·z = diag·(z/c)."""
        if not _vt_is_symmetric(vt):
            raise ValueError(
                "push_sum_gossip's virtual-mesh lowering computes each "
                "sender's column normalizer from its own receiver-side "
                "mass, which requires a symmetric mixing matrix")
        if T_con == 0:
            return lambda z, m: z
        arrays = virtual_arrays(vt, mesh.device)
        V, g = vt.block, mesh.axis_index()

        def mix(z, m):
            # masked edges, ORIGINAL diagonal: the self link always stays
            # live, as in push_sum_matrix
            sel_m = _virtual_masked_fold(
                vt, _device_slice(arrays, g, z.dtype), g,
                m.to(z.dtype).reshape(vt.n_dev, V), fold_diag=False)
            lr, _, lv_m, crs, _, cvs_m, dg = sel_m
            c = dg + _segment_sum(lv_m, lr, V)     # own column's live mass
            for k in range(len(vt.dev_shifts)):
                c = c + _segment_sum(cvs_m[k], crs[k], V)
            c = torch.where(c > 0, c, torch.ones_like(c))[:, None]
            zf = z.reshape(V, -1)
            wv = torch.ones((V, 1), dtype=z.dtype, device=z.device)
            for _ in range(T_con):
                zs, ws = zf / c, wv / c            # pre-scaled payload
                rz, rw = _virtual_recv((zs, ws), vt, mesh)
                zf = _virtual_combine(zs, rz, vt, sel_m)
                wv = _virtual_combine(ws, rw, vt, sel_m)
            out = zf / torch.where(wv > 0, wv, torch.ones_like(wv))
            return out.reshape(z.shape)
        return mix


# ----------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------

COMBINE_RULES: dict[str, CombineRule] = {}


def register_rule(rule):
    if rule.name in COMBINE_RULES:
        raise ValueError(f"combine rule {rule.name!r} already registered")
    COMBINE_RULES[rule.name] = rule
    return rule


def get_rule(name: str):
    try:
        return COMBINE_RULES[name]
    except KeyError:
        raise ValueError(f"unknown combine rule {name!r}; registered: "
                         f"{sorted(COMBINE_RULES)}") from None


for _rule in (GossipCombine(), NeighborCombine(), CentralCombine(),
              NoCombine(), ExactDiffusionCombine(), BeyondCentralCombine(),
              TopkGossipCombine(), QuantizedGossipCombine(),
              EventGossipCombine(), PartialGossipCombine(),
              StaleGossipCombine(), PushSumGossipCombine()):
    register_rule(_rule)
del _rule
