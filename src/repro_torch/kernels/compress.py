"""CUDA wrappers of the wire-compression kernels (``csrc/compress.cu``).

* :func:`compress_topk` replaces ``compress_topk`` of
  ``src/repro/kernels/compress.py`` (``_topk_kernel``): per node block,
  the k rows of largest squared row norm, descending, ties to the lowest
  index — the encode of the ``topk_gossip`` rule.  It equals its plain
  version :func:`repro_torch.kernels.ref.ref_compress_topk` bit for bit.
* :func:`dequant` replaces ``dequant`` (``_dequant_kernel``): the int8
  wire payload decoded as q · scale per node block — the decode of the
  ``quantized_gossip`` rule's int8 wires; it equals
  :func:`repro_torch.kernels.ref.ref_dequant` exactly.

At the compressed paths' shapes both move a fraction of a megabyte, so a
launch is bound by launch latency (see the source for the design).  Both
take float32 or bfloat16; the consensus layer sends float64 operands to
the plain versions, and so do these wrappers' callers — a float64
operand raises here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

D_MAX = 12000            # the kernel's shared-memory bound on d (kDMax)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "compress_topk": (_I, [_P, _P, _P] + [_I] * 6 + [_P]),
    "compress_dequant": (_I, [_P, _P, _P, _LL, _LL, _I, _I, _P]),
    "compress_error_string": (ctypes.c_char_p, [_I]),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _on_card(**tensors):
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"the CUDA kernel needs {name} on a CUDA "
                             f"device, got {t.device}")
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, not {first.device}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def compress_topk(M, k: int):
    """M (N, d, r) float32 or bfloat16 on the card → (vals (N, k, r) in
    M's dtype, descending row-norm order; idx (N, k) int32), ties to
    the lowest index.  Needs 1 ≤ k ≤ d ≤ :data:`D_MAX`."""
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
    total = q.numel()
    if total == 0:
        return out
    if (total + 255) // 256 >= 2**31:
        raise ValueError(f"q {tuple(q.shape)} exceeds one launch grid")
    lib = _build.load("compress", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.compress_dequant(q.data_ptr(), scale.data_ptr(),
                                   out.data_ptr(), total // q.shape[0],
                                   total, _DTYPE_CODE[scale.dtype],
                                   q.device.index, _stream(q.device))
    _build.check(lib, "compress_error_string", err, "compress_dequant")
    _build.LAUNCHES["dequant"] += 1
    return out
