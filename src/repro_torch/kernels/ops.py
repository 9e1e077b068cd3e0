"""Public wrappers around the hand-written kernels, plus the backend
dispatch registry.

Every op routes through one of two named backends:

  * ``cuda``      — the hand-written CUDA kernels (``csrc/``), built for
                    sm_90a at first use; CUDA tensors only;
  * ``torch-ref`` — the plain PyTorch versions in
                    :mod:`repro_torch.kernels.ref`, on any device.

Selection order: explicit ``backend=`` argument → ``set_default_backend``
/ ``backend_scope`` → ``REPRO_TORCH_KERNEL_BACKEND`` → auto, which is
``cuda`` for CUDA tensors and ``torch-ref`` for CPU tensors.  A CUDA
tensor thus reaches a kernel unless ``torch-ref`` is asked for by name
(for comparisons), and ``cuda`` on CPU tensors raises ValueError.
Nothing falls back: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import altgdmin_ls as _ls
from repro_torch.kernels import compress as _cp
from repro_torch.kernels import gossip_axpy as _ga
from repro_torch.kernels import ref as _ref
from repro_torch.utils import env as env_registry

BACKENDS = ("cuda", "torch-ref")
_default_backend: str | None = None


def _validate(name: str) -> str:
    if name not in BACKENDS:
        raise ValueError(f"unknown kernel backend {name!r}; "
                         f"expected one of {BACKENDS}")
    return name


def default_backend(device=None, *, extra_env: str | None = None) -> str:
    """The backend used when an op gets ``backend=None``: programmatic
    override (set_default_backend / backend_scope) → ``extra_env`` (if
    given) → ``REPRO_TORCH_KERNEL_BACKEND`` → ``cuda`` for a CUDA
    ``device``, ``torch-ref`` otherwise."""
    if _default_backend is not None:
        return _default_backend
    for var in (extra_env, "REPRO_TORCH_KERNEL_BACKEND"):
        env = env_registry.read_choice(var, BACKENDS) if var else None
        if env:
            return env
    is_cuda = device is not None and torch.device(device).type == "cuda"
    return "cuda" if is_cuda else "torch-ref"


def set_default_backend(name: str | None) -> None:
    """Process-wide override (None restores env/auto selection)."""
    global _default_backend
    _default_backend = None if name is None else _validate(name)


@contextlib.contextmanager
def backend_scope(name: str):
    """Temporarily select a backend for every op in the ``with`` body."""
    global _default_backend
    prev = _default_backend
    set_default_backend(name)
    try:
        yield
    finally:
        _default_backend = prev


def resolve_backend(backend: str | None, device=None) -> str:
    return (default_backend(device) if backend is None
            else _validate(backend))


def _resolve_for(backend, *tensors) -> str:
    """Resolve the backend for operands on one device; ``cuda`` needs
    CUDA tensors."""
    name = resolve_backend(backend, tensors[0].device)
    if name == "cuda" and not all(t.is_cuda for t in tensors):
        raise ValueError("backend 'cuda' needs CUDA tensors; got "
                         f"{sorted({str(t.device) for t in tensors})}")
    return name


# ---------------------------------------------- MTRL LS (node-batched)

def altgdmin_node_minimize_B(X, U, y, *, backend=None):
    """Node-batched min step: all L·tpn task systems in one launch.
    X (L, tpn, n, d); U (L, d, r); y (L, tpn, n) → B (L, tpn, r) f32.
    The r×r SPD solves after the Gram kernel stay plain torch."""
    if _resolve_for(backend, X, U, y) == "torch-ref":
        G, c = _ref.ref_task_gram(X, U, y)
    else:
        G, c = _ls.node_task_gram(X, U, y)
    return _ref.solve_spd(G, c)


def altgdmin_node_gradient(X, U, B, y, *, backend=None):
    """Node-batched gradients for a given B (the sample-split path's
    second launch).  X (L, tpn, n, d); U (L, d, r); B (L, tpn, r);
    y (L, tpn, n) → (L, d, r) f32; the tiles are summed over tpn by
    torch.sum."""
    if _resolve_for(backend, X, U, B, y) == "torch-ref":
        return _ref.ref_altgdmin_grad(X, U, B, y)
    return torch.sum(_ls.node_task_grad_tiles(X, U, B, y), dim=1)


def altgdmin_fused_step(X, U, y, *, backend=None):
    """The fused engine iteration (min-B + gradient, one A build, one
    launch).  X (L, tpn, n, d); U (L, d, r); y (L, tpn, n) →
    (B (L, tpn, r), grad (L, d, r)), f32."""
    if _resolve_for(backend, X, U, y) == "torch-ref":
        G, c = _ref.ref_task_gram(X, U, y)
        B = _ref.solve_spd(G, c)
        return B, _ref.ref_altgdmin_grad(X, U, B, y)
    B, tiles = _ls.node_fused_iter(X, U, y)
    return B, torch.sum(tiles, dim=1)


# ------------------------------------------------------- compression

def compress_topk(M, k, *, backend=None):
    """Rank-preserving top-k ROW sparsification of node blocks: per
    (d, r) block the k rows with the largest squared row norms.
    M (N, d, r) → (vals (N, k, r) in M's dtype, descending row-norm
    order; idx (N, k) int32), ties to the lowest index."""
    k = int(k)
    if M.ndim != 3:
        raise ValueError(f"compress_topk wants node-batched (N, d, r) "
                         f"blocks, got shape {tuple(M.shape)}")
    if not 1 <= k <= M.shape[1]:
        raise ValueError(f"compress_topk needs 1 <= k <= d, got k={k}, "
                         f"d={M.shape[1]}")
    if _resolve_for(backend, M) == "torch-ref":
        return _ref.ref_compress_topk(M, k)
    return _cp.compress_topk(M, k)


def dequant(q, scale, *, backend=None):
    """Decode an int8 wire payload: q · scale per node block.
    q (N, d, r) int8; scale (N, 1, 1) → (N, d, r) in scale's dtype."""
    if q.ndim != 3 or tuple(scale.shape) != (q.shape[0], 1, 1):
        raise ValueError(f"dequant needs a per-node (N, 1, 1) scale, got "
                         f"{tuple(scale.shape)} for q {tuple(q.shape)}")
    if _resolve_for(backend, q, scale) == "torch-ref":
        return _ref.ref_dequant(q, scale)
    return _cp.dequant(q, scale)


# ------------------------------------------------------------ gossip

def mix_nodes(Z, W, *, backend=None):
    """Consensus combine Z ← W Z over the leading node axis for a dense
    precomputed mixer (e.g. W^{T_con}): the whole AGREE phase in one
    launch.  Z (L, ...); W (L, L) → same shape and dtype as Z (f32
    accumulation)."""
    L = Z.shape[0]
    flat = Z.reshape(L, -1)
    if _resolve_for(backend, Z, W) == "torch-ref":
        out = _ref.ref_mix_rows(W, flat)
    else:
        out = _ga.mix_rows(W, flat)
    return out.reshape(Z.shape)


def gossip_combine(z, neighbors, weights, *, backend=None):
    """One gossip round's (K+1)-way combine z ← w₀·z + Σ_k
    w_{k+1}·neighbors[k] over z of any shape, in one launch: float32
    weights and accumulation, z's dtype out.  ``neighbors`` (K,
    *z.shape); ``weights`` a length-K+1 sequence of Python floats
    (uploaded on each call: callers that combine every round upload
    theirs once) or a (K+1,) tensor on z's device (a device's own row
    of a W table, never read back to the host)."""
    if not torch.is_tensor(weights):
        weights = torch.tensor(tuple(float(w) for w in weights),
                               dtype=torch.float32, device=z.device)
    K = neighbors.shape[0] if neighbors.ndim else 0
    if tuple(neighbors.shape[1:]) != tuple(z.shape):
        raise ValueError(f"want neighbors (K, *{tuple(z.shape)}); got "
                         f"{tuple(neighbors.shape)}")
    if tuple(weights.shape) != (K + 1,):
        raise ValueError(f"want {K + 1} weights for K={K} neighbours, got "
                         f"shape {tuple(weights.shape)}")
    if _resolve_for(backend, z, neighbors, weights) == "torch-ref":
        return _ref.ref_gossip_combine(z, neighbors, weights)
    return _ga.gossip_combine(z, neighbors, weights)
