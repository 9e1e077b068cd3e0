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

Not ported yet, and raising where a caller would reach them: the sparse
tier (padded-COO segment-sum rounds above ``SPARSE_MIN_NODES``), the
virtual-node mesh tier (``VirtualTopology``), the compressed rules'
mesh mixers, and the masked rules.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.distributed.graphs import Graph, SparseGraph
from repro_torch.kernels import ops


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
    over the leading node axis, dtype-preserving."""
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
    torch-ref and for float64."""
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


SPARSE_MIN_NODES = 512
SPARSE_DENSITY_THRESHOLD = 0.25


def maybe_sparsify(W):
    """The identity below the sparse tier.  Above
    :data:`SPARSE_MIN_NODES` nodes at or below
    :data:`SPARSE_DENSITY_THRESHOLD` off-diagonal density the JAX
    package switches to its padded-COO lowering, which this package does
    not have yet, so such a matrix raises."""
    if W is None or W.ndim != 2 or W.shape[0] != W.shape[1]:
        return W
    L = W.shape[0]
    if L < SPARSE_MIN_NODES:
        return W
    off = int(torch.count_nonzero(W)) - int(torch.count_nonzero(
        torch.diagonal(W)))
    if off / (L * (L - 1)) > SPARSE_DENSITY_THRESHOLD:
        return W
    raise NotImplementedError(
        f"a sparse {L}-node mixing matrix takes the sparse consensus tier "
        f"(SPARSE_MIN_NODES={SPARSE_MIN_NODES}), which a later slice of "
        f"the port brings")


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
    :class:`~repro_torch.distributed.graphs.Graph` (float64)."""
    if isinstance(adj, SparseGraph):
        raise NotImplementedError(
            "the neighbour average of a SparseGraph belongs to the sparse "
            "tier, which a later slice of the port brings")
    if isinstance(adj, Graph):
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
    keeps W's dtype."""
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
    return table, table.to(torch.float32)


# ----------------------------------------------------------------------
# combine rules
# ----------------------------------------------------------------------

class CombineRule:
    """One consensus/combine scheme, lowered two ways.

    ``make_sim_mixer(W, T_con, backend=...)`` returns the simulator
    closure ``Z (L, ...) ↦ combined Z``; ``make_mesh_mixer(mesh, T_con,
    ...)`` the per-rank closure ``z ↦ combined z`` on a
    :class:`~repro_torch.distributed.mesh.NodeMesh` — pass ``W=`` for an
    arbitrary weighted topology (each distinct cyclic shift of W's
    sparsity pattern one ``ppermute``, each node combining with its own
    W row), or ``shifts``/``self_weight`` for the uniform circulant
    form; ``signature(T_con)`` the comm cost.  Subclasses override the
    pieces that differ."""

    name: str = "base"

    def make_sim_mixer(self, W, T_con: int, *,
                       backend: str = "torch-ref") -> Callable:
        raise NotImplementedError

    def make_mesh_mixer(self, mesh, T_con: int, shifts=(-1, 1),
                        self_weight: float | None = None, *, W=None,
                        backend: str = "torch-ref") -> Callable:
        raise NotImplementedError

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

    @classmethod
    def _mesh_round(cls, z, mesh, shifts, placed, backend: str):
        """One gossip round on the mesh: the K neighbour blocks fetched by
        ``ppermute``, then ONE (K+1)-way combine (the kernel on cuda).
        ``placed`` is :func:`place_weights`'s pair; a per-node table is
        indexed by the node's rank on the device, never read back to the
        host."""
        exact, f32 = placed
        w = f32 if _fused_wanted(backend, z.dtype) else exact
        if not isinstance(w, tuple) and w.ndim == 2:
            w = w[mesh.axis_index()]
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

    def signature(self, T_con: int, **params) -> CommSignature:
        return CommSignature("gossip", T_con)


class NeighborCombine(CombineRule):
    """DGD's combine: ONE row-stochastic neighbour average that excludes
    the node itself (Experiment 1's ``(1/deg_g) Σ_{g'∈N_g} U_g'``).  The
    simulator form takes the precomputed neighbour-average matrix M."""

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
    ``init_state``.  Only the dense lowering is ported: a mixing matrix
    of the sparse tier raises in ``maybe_sparsify``.
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

    def _stochastic(self, **kw) -> bool:
        return False

    # ----------------------------------------------------- lowerings

    def make_sim_mixer(self, W, T_con, *, backend="torch-ref"):
        raise TypeError(f"combine rule {self.name!r} is stateful; use "
                        f"make_sim_state_mixer / init_state")

    def make_mesh_mixer(self, mesh, T_con, shifts=(-1, 1), self_weight=None,
                        *, W=None, backend="torch-ref"):
        raise TypeError(f"combine rule {self.name!r} is stateful; its mesh "
                        f"state mixer comes with a later slice of the port")

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
        if T_con == 0:
            return lambda Z, state: (Z, state)

        def mix(Z, state):
            N = Z.shape[0]
            params = self.resolve_params(Z.shape[1], Z.shape[2], **kw)
            ids = torch.arange(N, device=Z.device)
            fused = _fused_wanted(backend, Z.dtype)
            Wz = W.to(torch.float32 if fused else Z.dtype)
            w_diag = torch.diagonal(W).to(Z.dtype)[:, None, None]
            for _ in range(T_con):
                xhat, count = state if stochastic else (state, None)
                _, xhat2 = self.refresh(Z, xhat, ids, count,
                                        backend=backend, **params)
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
        (decoded by the ``dequant`` kernel on cuda);
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

    @staticmethod
    def _int8_scale(delta):
        scale = torch.amax(torch.abs(delta), dim=(-2, -1),
                           keepdim=True) / 127.0
        return torch.clamp(scale, min=torch.finfo(delta.dtype).tiny)

    @staticmethod
    def _dequant(q, scale, *, backend):
        cb = backend if _fused_wanted(backend, scale.dtype) else "torch-ref"
        return ops.dequant(q, scale, backend=cb)

    def refresh(self, Z, xhat, node_ids, count, *, backend, wire):
        delta = Z - xhat                     # accumulated compression error
        if wire == "bf16":
            q = delta.to(torch.bfloat16)
            payload = (q,)
            inc = q.to(Z.dtype)
        else:
            scale = self._int8_scale(delta)
            if wire == "int8_stochastic":
                u = stochastic_dither(count, node_ids, Z.shape[1:], Z.dtype)
                qf = torch.floor(delta / scale + u)
            else:
                qf = torch.round(delta / scale)        # half to even
            q = torch.clamp(qf, -127, 127).to(torch.int8)
            payload = (q, scale)
            inc = self._dequant(q, scale, backend=backend)
        return payload, xhat + inc

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
# registry
# ----------------------------------------------------------------------

# The JAX package's other combine rules, each brought by a later slice.
LATER_SLICE_RULES = ("partial_gossip", "stale_gossip", "push_sum_gossip")
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
        if name in LATER_SLICE_RULES:
            raise NotImplementedError(
                f"combine rule {name!r} is not ported yet; a later slice "
                f"of the port brings it") from None
        raise ValueError(f"unknown combine rule {name!r}; registered: "
                         f"{sorted(COMBINE_RULES)}") from None


for _rule in (GossipCombine(), NeighborCombine(), CentralCombine(),
              NoCombine(), ExactDiffusionCombine(), BeyondCentralCombine(),
              TopkGossipCombine(), QuantizedGossipCombine(),
              EventGossipCombine()):
    register_rule(_rule)
del _rule
