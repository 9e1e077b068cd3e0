"""The consensus layer — every simulator ``Z ← W Z`` in one place.

Port of the simulator half of ``src/repro/distributed/consensus.py`` for
the paper's ``gossip`` rule.  Node variables are stacked on a leading
axis, ``Z: (L, ...)``.  The ``torch-ref`` lowering is the exact
sequential product (T_con rounds of ``W @ Z``, dtype-preserving, the
numerics anchor); the ``cuda`` lowering hoists the T_con rounds onto a
precomputed ``W^{T_con}`` applied by the ``mix_rows`` kernel in one
launch.

Precision policy: the kernel accumulates in f32, so float64 operands
always take the exact sequential product, on every backend.

Not ported yet, and raising NotImplementedError where a caller would
reach them: the sparse tier (padded-COO segment-sum rounds above
``SPARSE_MIN_NODES``), the mesh lowerings, and every combine rule other
than ``gossip``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

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


# ----------------------------------------------------------------------
# combine rules
# ----------------------------------------------------------------------

class GossipCombine:
    """The paper's AGREE combine: T_con rounds of the mixing product
    ``Z ← W Z`` (Algorithm 1).  A combine rule has a simulator lowering
    (``make_sim_mixer``) and a comm signature."""

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

    def signature(self, T_con: int, **params) -> CommSignature:
        return CommSignature("gossip", T_con)


# ----------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------

# The JAX package's other combine rules, each brought by a later slice.
LATER_SLICE_RULES = ("neighbor", "central", "none", "exact_diffusion",
                     "beyond_central", "topk_gossip", "quantized_gossip",
                     "event_gossip", "partial_gossip", "stale_gossip",
                     "push_sum_gossip")

COMBINE_RULES: dict[str, GossipCombine] = {}


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


register_rule(GossipCombine())
