"""CUDA wrapper of the flash-attention kernels
(``csrc/flash_attention.cu``).

:func:`flash_attention` replaces ``flash_attention`` of
``src/repro/kernels/flash_attention.py`` (``_flash_kernel``): online-
softmax attention, causal and/or sliding-window masks aligned at the
ends of the query and key sequences, GQA head grouping, float32 softmax
and accumulation, the output in q's dtype.  It takes the model layout
(q (B, Sq, H, D), k/v (B, Skv, Hkv, D)) as it is: no transpose and no
padded copy, the kernel masks ragged tiles itself.  bfloat16 runs on the
tensor cores (``mma.sync``), with P rounded to bfloat16 before the P V
product; float32 runs on the CUDA cores.  Both take 64 query rows a
block.  The plain version is :func:`repro_torch.kernels.ref.ref_attention`
(in the (B, H, S, D) layout), which agrees with the kernel everywhere,
rows that see no key included (both give 0).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

D_MAX = 256                 # 217 KB of shared memory a block at D = 256
_BLOCK_Q = 64               # query rows a block (the q-tile of both kernels)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flash_attention_fwd": (_I, [_P] * 4 + [_I] * 8 + [ctypes.c_float]
                            + [_I, _I, _P]),
    "flash_attention_error_string": (ctypes.c_char_p, [_I]),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q, k, v, *, causal=True, window=None, scale=None):
    """q (B, Sq, H, D), k and v (B, Skv, Hkv, D) on the card, one dtype
    (float32 or bfloat16), H a multiple of Hkv, D ≤ 256 → (B, Sq, H, D)
    in q's dtype.  ``window`` (keys with q_pos − k_pos ≥ window are
    masked) is None or ≥ 1; ``scale`` defaults to D^-1/2."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _build.on_card(t):
            raise ValueError(f"the CUDA kernel needs {name} on a CUDA "
                             f"device, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device} but q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} but q is {q.dtype}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {q.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,Sq,H,D), k and v (B,Skv,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv < 1 or H % Hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} (H must be a multiple of Hkv)")
    if min(B, Sq, Skv, H, D) < 1:
        raise ValueError(f"empty operand: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if D > D_MAX:
        raise ValueError(f"head dim D={D} exceeds the kernel's D_MAX={D_MAX}")
    if (max(H, B) > 65535 or Sq > 2**30 or max(Sq, Skv) * H * D >= 2**62
            or -(-Sq // _BLOCK_Q) * H * B >= 2**31):
        raise ValueError(f"q {tuple(q.shape)} exceeds one launch grid")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    scale = D ** -0.5 if scale is None else float(scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if _build.recorded(q, k, v):
        out.copy_(_ref.ref_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, scale=scale).transpose(1, 2))
    else:
        lib = _build.load("flash_attention", _SIGNATURES)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                Sq, Skv, H, Hkv, D, int(bool(causal)),
                0 if window is None else int(window), scale,
                _DTYPE_CODE[q.dtype], q.device.index, stream)
        _build.check(lib, "flash_attention_error_string", err,
                     "flash_attention_fwd")
    _build.LAUNCHES["flash_attention"] += 1
    return out
