"""CUDA wrappers of the consensus kernels (``csrc/gossip_axpy.cu``).

:func:`mix_rows` replaces ``mix_rows`` of
``src/repro/kernels/gossip_axpy.py`` (``_mix_kernel``): Z ← W Z over the
node axis for a precomputed dense mixer (W^{T_con}), the whole AGREE
phase in one launch: one trip to memory a CTA where a tile of Z and its
rows of W fit its shared memory (``mix_tile_kernel``), an h-tiled loop
past that (``mix_rows_kernel``); the C entry reports which it launched
(:data:`repro_torch.kernels._build.KERNEL_LAUNCHES`).
:func:`gossip_combine` replaces ``gossip_combine``
(``_combine_kernel``) of the same file: one mesh gossip round's
(K+1)-way weighted combine of a node's block with its K neighbour
blocks, one trip to memory a CTA (``combine_tile_kernel``: a tile of
the K+1 rows and the weights in shared memory, in one stage, or in
double-buffered stages of 64 rows past that; ``combine_regs_kernel``
where K+1 <= 8, the rows in registers; the C entry reports which,
``combine_tile_kernel``, ``combine_tile_kernel/staged`` or
``combine_regs_kernel``).  At the
paper's shapes both have little data to move, so a launch is bound by
its latency.  The plain versions are
:func:`repro_torch.kernels.ref.ref_mix_rows` and
:func:`~repro_torch.kernels.ref.ref_gossip_combine`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "gossip_mix_rows": (_I, [_P, _P, _P, _I, _I, _I, _I, _P, _P]),
    "gossip_combine": (_I, [_P, _P, _P, _P, _LL, _I, _I, _I, _P, _P]),
    "gossip_error_string": (ctypes.c_char_p, [_I]),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernels gossip_mix_rows reports in its launched[] slots
_MIX_KERNELS = ("mix_tile_kernel", "mix_rows_kernel")
# the forms gossip_combine reports in its launched[] slots: the K+1 rows
# in one shared-memory stage, in stages of 64, or in registers (K+1 <= 8)
_COMBINE_FORMS = ("combine_tile_kernel", "combine_tile_kernel/staged",
                  "combine_regs_kernel")


def mix_rows(W, Z):
    """W (L, L), Z (L, M) on the card → W Z (L, M) in Z's dtype, f32
    accumulation.  Z in float32 or bfloat16 (float64 is computed in f32
    and returned as float64, as the TPU kernel does); W is used as f32."""
    for name, t in (("W", W), ("Z", Z)):
        if not _build.on_card(t):
            raise ValueError(f"the CUDA kernel needs {name} on a CUDA "
                             f"device, got {t.device}")
    if W.device != Z.device:
        raise ValueError(f"W is on {W.device} but Z on {Z.device}")
    if Z.ndim != 2 or W.shape != (Z.shape[0], Z.shape[0]):
        raise ValueError(f"want W (L, L) and Z (L, M); got "
                         f"{tuple(W.shape)}, {tuple(Z.shape)}")
    L, M = Z.shape
    if min(L, M) < 1:
        raise ValueError(f"empty operand Z {tuple(Z.shape)}")
    if M >= 2**31 or L > 65535 * 8:     # grid (M/128, L/8)
        raise ValueError(f"Z {tuple(Z.shape)} exceeds one launch grid")
    if Z.dtype not in _DTYPE_CODE and Z.dtype != torch.float64:
        raise ValueError(f"unsupported Z dtype {Z.dtype}")
    dt = Z.dtype if Z.dtype in _DTYPE_CODE else torch.float32
    Zk = Z.to(dt).contiguous()
    Wk = W.to(torch.float32).contiguous()
    out = torch.empty((L, M), dtype=dt, device=Z.device)
    launched = (ctypes.c_int * len(_MIX_KERNELS))()
    if _build.recorded(Wk, Zk):
        out.copy_(_ref.ref_mix_rows(Wk, Zk))
    else:
        lib = _build.load("gossip_axpy", _SIGNATURES)
        with torch.cuda.device(Z.device):
            stream = torch.cuda.current_stream(Z.device).cuda_stream
            err = lib.gossip_mix_rows(Wk.data_ptr(), Zk.data_ptr(),
                                      out.data_ptr(), L, M, _DTYPE_CODE[dt],
                                      Z.device.index, stream, launched)
        _build.check(lib, "gossip_error_string", err, "gossip_mix_rows")
    _build.LAUNCHES["mix_rows"] += 1
    _build.count_kernels(_MIX_KERNELS, launched)
    return out.to(Z.dtype)


def gossip_combine(z, neighbors, weights):
    """z (any shape), neighbors (K, *z.shape) and weights (K+1,) on the
    card → w₀·z + Σ_k w_{k+1}·neighbors[k] in z's dtype, float32 weights
    and accumulation.  z in float32 or bfloat16 (float64 is computed in
    f32 and returned as float64, as :func:`mix_rows` does); the weights
    are read on the device, in float32."""
    for name, t in (("z", z), ("neighbors", neighbors),
                    ("weights", weights)):
        if not _build.on_card(t):
            raise ValueError(f"the CUDA kernel needs {name} on a CUDA "
                             f"device, got {t.device}")
        if t.device != z.device:
            raise ValueError(f"{name} is on {t.device} but z on {z.device}")
    K = neighbors.shape[0] if neighbors.ndim else 0
    if K < 1 or tuple(neighbors.shape[1:]) != tuple(z.shape):
        raise ValueError(f"want neighbors (K >= 1, *{tuple(z.shape)}); got "
                         f"{tuple(neighbors.shape)}")
    if tuple(weights.shape) != (K + 1,):
        raise ValueError(f"want {K + 1} weights for K={K} neighbours, got "
                         f"shape {tuple(weights.shape)}")
    n = z.numel()
    if n < 1:
        raise ValueError(f"empty operand z {tuple(z.shape)}")
    # grid (n/64,): a device's; the dry run's meta tensors are the mesh's
    if n > (2**31 - 1) * 64 and not z.is_meta:
        raise ValueError(f"z of {n} elements exceeds one launch grid")
    if z.dtype not in _DTYPE_CODE and z.dtype != torch.float64:
        raise ValueError(f"unsupported z dtype {z.dtype}")
    if neighbors.dtype != z.dtype:
        raise ValueError(f"neighbors are {neighbors.dtype} but z is "
                         f"{z.dtype}")
    dt = z.dtype if z.dtype in _DTYPE_CODE else torch.float32
    zk = z.to(dt).contiguous()
    nk = neighbors.to(dt).contiguous()
    wk = weights.to(torch.float32).contiguous()
    out = torch.empty_like(zk)
    launched = (ctypes.c_int * len(_COMBINE_FORMS))()
    if zk.is_meta:
        _build.meta_call("gossip_combine", zk, nk, wk)
    elif _build.recorded(zk, nk, wk):
        out.copy_(_ref.ref_gossip_combine(zk, nk, wk))
    else:
        lib = _build.load("gossip_axpy", _SIGNATURES)
        with torch.cuda.device(z.device):
            stream = torch.cuda.current_stream(z.device).cuda_stream
            err = lib.gossip_combine(zk.data_ptr(), nk.data_ptr(),
                                     wk.data_ptr(), out.data_ptr(), n, K,
                                     _DTYPE_CODE[dt], z.device.index, stream,
                                     launched)
        _build.check(lib, "gossip_error_string", err, "gossip_combine")
    _build.LAUNCHES["gossip_combine"] += 1
    _build.count_kernels(_COMBINE_FORMS, launched)
    return out.to(z.dtype)


def combine_cost(z, neighbors, weights) -> tuple[int, int]:
    """(operations, bytes) of one :func:`gossip_combine`: a multiply-add
    a row and element, the K+1 rows and the weights read once, the
    output written once."""
    K = neighbors.shape[0]
    n_bytes = sum(t.numel() * t.element_size()
                  for t in (z, neighbors, weights, z))
    return 2 * (K + 1) * z.numel(), n_bytes
