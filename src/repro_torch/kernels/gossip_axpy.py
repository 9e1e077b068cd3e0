"""CUDA wrapper of the consensus mixing kernel (``csrc/gossip_axpy.cu``).

:func:`mix_rows` replaces ``mix_rows`` of
``src/repro/kernels/gossip_axpy.py`` (``_mix_kernel``): Z ← W Z over the
node axis for a precomputed dense mixer (W^{T_con}), the whole AGREE
phase in one launch.  At the paper's shapes it has little data to move,
so a launch is bound by launch latency.  The plain version is
:func:`repro_torch.kernels.ref.ref_mix_rows`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gossip_mix_rows": (_I, [_P, _P, _P, _I, _I, _I, _I, _P]),
    "gossip_error_string": (ctypes.c_char_p, [_I]),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def mix_rows(W, Z):
    """W (L, L), Z (L, M) on the card → W Z (L, M) in Z's dtype, f32
    accumulation.  Z in float32 or bfloat16 (float64 is computed in f32
    and returned as float64, as the TPU kernel does); W is used as f32."""
    for name, t in (("W", W), ("Z", Z)):
        if not t.is_cuda:
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
    lib = _build.load("gossip_axpy", _SIGNATURES)
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        err = lib.gossip_mix_rows(Wk.data_ptr(), Zk.data_ptr(),
                                  out.data_ptr(), L, M, _DTYPE_CODE[dt],
                                  Z.device.index, stream)
    _build.check(lib, "gossip_error_string", err, "gossip_mix_rows")
    _build.LAUNCHES["mix_rows"] += 1
    return out.to(Z.dtype)
