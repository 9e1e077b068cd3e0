"""CUDA wrappers of the wire-compression kernels (``csrc/compress.cu``).

* :func:`compress_topk` replaces ``compress_topk`` of
  ``src/repro/kernels/compress.py`` (``_topk_kernel``): per node block,
  the k rows of largest squared row norm, descending, NaN above every
  number, ties to the lowest index — the encode of the ``topk_gossip``
  rule.  The kernel is a one-pass rank select (each row counts the rows
  that rank above it); it equals its plain version
  :func:`repro_torch.kernels.ref.ref_compress_topk` bit for bit, NaN
  and inf rows included.
* :func:`int8_round` and :func:`dequant` replace ``dequant``
  (``_dequant_kernel``), the decode of the ``quantized_gossip`` rule's
  int8 wires.  :func:`int8_round` is the whole round of those wires as
  a sender's refresh runs it — encode Z − x̂ to int8 with a per-node
  max-abs scale, decode, accumulate onto x̂ — in one launch
  (``int8_round_kernel``); it equals
  :func:`repro_torch.kernels.ref.ref_int8_round` bit for bit, NaN and
  inf blocks included.  :func:`dequant` is the decode alone, q · scale
  per node block (``dequant_kernel``), as a receiver applies a payload;
  it equals :func:`repro_torch.kernels.ref.ref_dequant` exactly.  Both
  count their launches as ``dequant`` in
  :data:`repro_torch.kernels._build.LAUNCHES`, and under their
  ``__global__`` function's name in ``KERNEL_LAUNCHES``.

At the compressed paths' shapes each moves a fraction of a megabyte, so
a launch is bound by launch latency (see the source for the designs).
All take float32 or bfloat16; the consensus layer sends float64 operands
to the plain versions, and so do these wrappers' callers — a float64
operand raises here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

D_MAX = 12000            # the kernel's shared-memory bound on d (kDMax)
_DEQUANT_PER = 1024      # dequant: values a block (kDequantPer)
_ROUND_MAX_CTAS = 8      # int8_round: CTAs a node at most (kRoundMaxCtas)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "compress_topk": (_I, [_P, _P, _P] + [_I] * 6 + [_P]),
    "compress_dequant": (_I, [_P, _P, _P] + [_I] * 4 + [_P]),
    "compress_int8_round": (_I, [_P] * 6 + [_I] * 4 + [_P]),
    "compress_error_string": (ctypes.c_char_p, [_I]),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _on_card(**tensors):
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if not _build.on_card(t):
            raise ValueError(f"the CUDA kernel needs {name} on a CUDA "
                             f"device, got {t.device}")
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, not {first.device}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def compress_topk(M, k: int):
    """M (N, d, r) float32 or bfloat16 on the card → (vals (N, k, r) in
    M's dtype, descending row-norm order, a NaN norm above every
    number; idx (N, k) int32), ties to the lowest index.  Needs
    1 ≤ k ≤ d ≤ :data:`D_MAX`."""
    _on_card(M=M)
    if M.ndim != 3:
        raise ValueError(f"compress_topk wants node-batched (N, d, r) "
                         f"blocks, got shape {tuple(M.shape)}")
    N, d, r = M.shape
    if not 1 <= k <= d:
        raise ValueError(f"compress_topk needs 1 <= k <= d, got k={k}, "
                         f"d={d}")
    if d > D_MAX:
        raise ValueError(f"d={d} exceeds the kernel's D_MAX={D_MAX}")
    if min(N, r) < 1 or N >= 2**31:
        raise ValueError(f"bad block shape {tuple(M.shape)}")
    if M.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {M.dtype} (float64 takes the "
                         f"plain version)")
    M = M.contiguous()
    vals = torch.empty((N, k, r), dtype=M.dtype, device=M.device)
    idx = torch.empty((N, k), dtype=torch.int32, device=M.device)
    if _build.recorded(M):
        for t, plain in zip((vals, idx), _ref.ref_compress_topk(M, k)):
            t.copy_(plain)
    else:
        lib = _build.load("compress", _SIGNATURES)
        with torch.cuda.device(M.device):
            err = lib.compress_topk(M.data_ptr(), vals.data_ptr(),
                                    idx.data_ptr(), N, d, r, k,
                                    _DTYPE_CODE[M.dtype], M.device.index,
                                    _stream(M.device))
        _build.check(lib, "compress_error_string", err, "compress_topk")
    _build.LAUNCHES["compress_topk"] += 1
    return vals, idx


def dequant(q, scale):
    """q (N, d, r) int8, scale (N, 1, 1) float32 or bfloat16 on the card
    → float(q) · float(scale) per node block, in the scale's dtype."""
    _on_card(q=q, scale=scale)
    if q.ndim != 3 or scale.shape != (q.shape[0], 1, 1):
        raise ValueError(f"dequant needs a per-node (N, 1, 1) scale, got "
                         f"{tuple(scale.shape)} for q {tuple(q.shape)}")
    if q.dtype != torch.int8:
        raise ValueError(f"dequant wants an int8 payload, got {q.dtype}")
    if scale.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported scale dtype {scale.dtype} (float64 "
                         f"takes the plain version)")
    q, scale = q.contiguous(), scale.contiguous()
    out = torch.empty(q.shape, dtype=scale.dtype, device=q.device)
    N, per_node = q.shape[0], q.shape[1] * q.shape[2]
    if q.numel() == 0:
        return out
    if N >= 2**31 or per_node > 65535 * _DEQUANT_PER:
        raise ValueError(f"q {tuple(q.shape)} exceeds one launch grid")
    if _build.recorded(q, scale):
        out.copy_(_ref.ref_dequant(q, scale))
    else:
        lib = _build.load("compress", _SIGNATURES)
        with torch.cuda.device(q.device):
            err = lib.compress_dequant(q.data_ptr(), scale.data_ptr(),
                                       out.data_ptr(), N, per_node,
                                       _DTYPE_CODE[scale.dtype],
                                       q.device.index, _stream(q.device))
        _build.check(lib, "compress_error_string", err, "compress_dequant")
    _build.LAUNCHES["dequant"] += 1
    _build.KERNEL_LAUNCHES["dequant_kernel"] += 1
    return out


def int8_round(Z, xhat, u=None):
    """One round of the int8 wire for node blocks Z, xhat (N, d, r) in
    float32 or bfloat16 on the card: delta = Z − xhat, the per-node
    scale = max(amax|delta| / 127, tiny), q = clamp(round(delta /
    scale), −127, 127) (half to even), or clamp(floor(delta / scale + u),
    −127, 127) given the stochastic wire's dither u (N, d, r) in Z's
    dtype, and xhat + q · scale → (q int8, scale (N, 1, 1), xhat_new),
    both in Z's dtype."""
    tensors = {"Z": Z, "xhat": xhat} | ({} if u is None else {"u": u})
    _on_card(**tensors)
    for name, t in tensors.items():
        if t.shape != Z.shape or t.dtype != Z.dtype:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}, want "
                             f"Z's {Z.dtype} {tuple(Z.shape)}")
    if Z.ndim != 3 or min(Z.shape[1:]) < 1:
        raise ValueError(f"int8_round wants node-batched (N, d, r) blocks, "
                         f"got shape {tuple(Z.shape)}")
    if Z.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {Z.dtype} (float64 takes the "
                         f"plain version)")
    N, per_node = Z.shape[0], Z.shape[1] * Z.shape[2]
    if N * _ROUND_MAX_CTAS >= 2**31 or per_node >= 2**31:
        raise ValueError(f"Z {tuple(Z.shape)} exceeds one launch grid")
    Z, xhat = Z.contiguous(), xhat.contiguous()
    u = None if u is None else u.contiguous()
    q = torch.empty(Z.shape, dtype=torch.int8, device=Z.device)
    scale = torch.empty((N, 1, 1), dtype=Z.dtype, device=Z.device)
    xhat_new = torch.empty_like(Z)
    if N == 0:
        return q, scale, xhat_new
    if _build.recorded(*tensors.values()):
        for t, plain in zip((q, scale, xhat_new),
                            _ref.ref_int8_round(Z, xhat, u)):
            t.copy_(plain)
    else:
        lib = _build.load("compress", _SIGNATURES)
        with torch.cuda.device(Z.device):
            err = lib.compress_int8_round(
                Z.data_ptr(), xhat.data_ptr(),
                None if u is None else u.data_ptr(), q.data_ptr(),
                scale.data_ptr(), xhat_new.data_ptr(), N, per_node,
                _DTYPE_CODE[Z.dtype], Z.device.index, _stream(Z.device))
        _build.check(lib, "compress_error_string", err,
                     "compress_int8_round")
    _build.LAUNCHES["dequant"] += 1
    _build.KERNEL_LAUNCHES["int8_round_kernel"] += 1
    return q, scale, xhat_new
