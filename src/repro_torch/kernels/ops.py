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

from repro_torch.kernels import _build
from repro_torch.kernels import altgdmin_ls as _ls
from repro_torch.kernels import compress as _cp
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gossip_axpy as _ga
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd_scan as _ssd
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
    if name == "cuda" and not all(_build.on_card(t) for t in tensors):
        raise ValueError("backend 'cuda' needs CUDA tensors; got "
                         f"{sorted({str(t.device) for t in tensors})}")
    return name


# ------------------------------------------------------------ autograd

class _PlainBackward(torch.autograd.Function):
    """``kernel(*inputs)`` forward; the backward runs ``plain(*inputs)``
    — the same function in plain torch — a second time under autograd
    and returns its input gradients."""

    @staticmethod
    def forward(ctx, kernel, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [x.detach().requires_grad_(need)
                  for x, need in zip(ctx.saved_tensors,
                                     ctx.needs_input_grad[2:])]
        wanted = [x for x in inputs if x.requires_grad]
        with torch.enable_grad():
            out = ctx.plain(*inputs)
        grads = iter(torch.autograd.grad(out, wanted, grad_out,
                                         allow_unused=True))
        return (None, None, *(next(grads) if x.requires_grad else None
                              for x in inputs))


def with_plain_backward(kernel, plain, *inputs):
    """``kernel(*inputs)``, a hand-written kernel's call returning one
    tensor, made differentiable: the forward is the kernel; the backward
    recomputes ``plain(*inputs)`` — the model's plain core, which must
    return the kernel's function in the kernel's output dtype — under
    autograd on the saved inputs and returns its gradients, so it runs
    the core's forward a second time.  The JAX package computes this
    gradient by differentiating the same plain core (its model forward
    reaches no Pallas kernel), and has no backward kernel.  A ctypes
    call alone returns a tensor with no autograd graph: every parameter
    upstream of it would get no gradient."""
    return _PlainBackward.apply(kernel, plain, *inputs)


# ------------------------------------------------------------ attention

def flash_attention(q, k, v, *, causal=True, window=None, scale=None,
                    backend=None):
    """Model layout: q (B, Sq, H, D); k, v (B, Skv, Hkv, D) →
    (B, Sq, H, D) in q's dtype.  Causal and window masks are aligned at
    the ends (query i sits at key position i + Skv − Sq); GQA by head
    grouping; float32 softmax.  A query row that sees no key is 0."""
    if _resolve_for(backend, q, k, v) == "torch-ref":
        o = _ref.ref_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window, scale=scale)
        return o.transpose(1, 2)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)


# ------------------------------------------------------------ SSD

def ssd_scan(x, dt, A, Bm, Cm, D, *, chunk=128, backend=None):
    """Model layout: x (B, S, H, P); dt (B, S, H); A, D (H,); Bm/Cm
    (B, S, N) → (y (B, S, H, P) in x's dtype, the D skip term included;
    h_final (B, H, P, N) float32).  The torch-ref route is the
    token-by-token recurrence, which has no chunk."""
    if _resolve_for(backend, x, dt, A, Bm, Cm, D) == "torch-ref":
        return _ref.ref_ssd(x, dt, A, Bm, Cm, D)
    return _ssd.ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk)


# ------------------------------------------------------------ MTRL LS

def altgdmin_minimize_B(X, U, y, *, backend=None):
    """b_t = (X_t U)† y_t for T tasks sharing one basis: the Gram kernel,
    then the r×r SPD solves in plain torch.  X (T, n, d); U (d, r);
    y (T, n) → B (T, r) f32."""
    if _resolve_for(backend, X, U, y) == "torch-ref":
        G, c = _ref.ref_single_task_gram(X, U, y)
    else:
        G, c = _ls.task_gram(X, U, y)
    return _ref.solve_spd(G, c)


def altgdmin_gradient(X, U, B, y, *, backend=None):
    """∇_U f = Σ_t X_tᵀ(X_t U b_t − y_t) b_tᵀ for T tasks sharing one
    basis.  X (T, n, d); U (d, r); B (T, r); y (T, n) → (d, r) f32; the
    tiles are summed over T by torch.sum."""
    if _resolve_for(backend, X, U, B, y) == "torch-ref":
        tiles = _ref.ref_single_grad_tiles(X, U, B, y)
    else:
        tiles = _ls.task_grad_tiles(X, U, B, y)
    return torch.sum(tiles, dim=0)


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


def int8_round(Z, xhat, u=None, *, backend=None):
    """One round of the int8 wire: delta = Z − xhat encoded with a
    per-node max-abs scale to int8 (half to even, or floor(delta /
    scale + u) given the stochastic wire's dither u), decoded and added
    onto xhat.  Z, xhat (and u) (N, d, r) → (q int8, scale (N, 1, 1),
    xhat_new), in Z's dtype."""
    tensors = (Z, xhat) if u is None else (Z, xhat, u)
    if _resolve_for(backend, *tensors) == "torch-ref":
        return _ref.ref_int8_round(Z, xhat, u)
    return _cp.int8_round(Z, xhat, u)


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
