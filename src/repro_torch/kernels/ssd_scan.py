"""CUDA wrapper of the Mamba-2 SSD chunked-scan kernel
(``csrc/ssd_scan.cu``).

:func:`ssd_scan` replaces ``ssd_scan`` of ``src/repro/kernels/ssd_scan.py``
(``_ssd_kernel``): per (batch, head) the chunks in order, each a masked
quadratic form, with the (P, N) float32 state carried across chunks; the
D skip term is added in the kernel.  It takes the model layout (x
(B, S, H, P), dt (B, S, H), Bm/Cm (B, S, N) shared by every head) as it
is: no transpose and no padded copy.  The plain version is
:func:`repro_torch.kernels.ref.ref_ssd`, the token-by-token recurrence.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SMEM_MAX = 232_448          # bytes of shared memory one block may take

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ssd_scan_fwd": (_I, [_P] * 8 + [_I] * 8 + [_P]),
    "ssd_scan_smem_bytes": (ctypes.c_longlong, [_I, _I, _I]),
    "ssd_scan_error_string": (ctypes.c_char_p, [_I]),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def ssd_scan(x, dt, A, Bm, Cm, D, *, chunk=128):
    """x (B, S, H, P), dt (B, S, H), A and D (H,), Bm and Cm (B, S, N) on
    the card → (y (B, S, H, P) in x's dtype, h_final (B, H, P, N)
    float32).  x, Bm and Cm share one dtype (float32 or bfloat16); dt, A
    and D are used as float32.  ``chunk`` is the SSD chunk Q."""
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm),
                    ("D", D)):
        if not t.is_cuda:
            raise ValueError(f"the CUDA kernel needs {name} on a CUDA "
                             f"device, got {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device} but x on {x.device}")
    if x.dtype not in _DTYPE_CODE or Bm.dtype != x.dtype \
            or Cm.dtype != x.dtype:
        raise ValueError(f"want x, Bm, Cm of one dtype in float32/bfloat16; "
                         f"got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if x.ndim != 4:
        raise ValueError(f"want x (B,S,H,P), got {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if (tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,)
            or tuple(D.shape) != (H,) or tuple(Bm.shape) != (B, S, N)
            or tuple(Cm.shape) != (B, S, N)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, D "
                         f"{tuple(D.shape)}")
    if min(B, S, H, P, N) < 1:
        raise ValueError(f"empty operand: x {tuple(x.shape)}, Bm "
                         f"{tuple(Bm.shape)}")
    Q = int(chunk)
    if Q < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if max(H, B) > 65535 or B * S * H * P >= 2**62:
        raise ValueError(f"x {tuple(x.shape)} exceeds one launch grid")
    lib = _build.load("ssd_scan", _SIGNATURES)
    smem = lib.ssd_scan_smem_bytes(P, N, Q)
    if smem > SMEM_MAX:
        raise ValueError(f"P={P}, N={N}, chunk={Q} need {smem} bytes of "
                         f"shared memory a block, above {SMEM_MAX}")
    f32 = torch.float32
    x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
    dt, A, D = (t.to(f32).contiguous() for t in (dt, A, D))
    y = torch.empty_like(x)
    h = torch.empty((B, H, P, N), dtype=f32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr(), y.data_ptr(), h.data_ptr(), B, S, H,
            P, N, Q, _DTYPE_CODE[x.dtype], x.device.index, stream)
    _build.check(lib, "ssd_scan_error_string", err, "ssd_scan_fwd")
    _build.LAUNCHES["ssd_scan"] += 1
    return y, h
