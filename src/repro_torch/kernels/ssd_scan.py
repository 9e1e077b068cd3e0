"""CUDA wrapper of the Mamba-2 SSD chunked-scan kernels
(``csrc/ssd_scan.cu``).

:func:`ssd_scan` replaces ``ssd_scan`` of ``src/repro/kernels/ssd_scan.py``
(``_ssd_kernel``): per (batch, head) the chunks of the sequence, each a
masked quadratic form, with a (P, N) float32 state carried across chunks;
the D skip term is added in the kernel.  It takes the model layout (x
(B, S, H, P), dt (B, S, H), Bm/Cm (B, S, N) shared by every head) as it
is: no transpose and no padded copy.  bfloat16 runs three tensor-core
launches over (chunk, head, batch) -- chunk states, the pass of states
across chunks, chunk outputs -- with float32 and bfloat16 scratch that
this wrapper allocates, where P <= 128, N <= 256 and their blocks fit
shared memory; float32, and bfloat16 past that, run the CUDA-core
kernel, one launch.  Either way one call counts one launch in
``_build.LAUNCHES``; the CUDA launches, by kernel, go to
``_build.KERNEL_LAUNCHES`` as the C entry reports them.  The plain
version is :func:`repro_torch.kernels.ref.ref_ssd`, the token-by-token
recurrence.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

SMEM_MAX = 232_448          # bytes of shared memory one block may take

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ssd_scan_fwd": (_I, [_P] * 11 + [_I] * 8 + [_P, _P]),
    "ssd_scan_tensor_cores": (_I, [_I, _I, _I]),
    "ssd_scan_smem_bytes": (ctypes.c_longlong, [_I, _I, _I, _I]),
    "ssd_scan_error_string": (ctypes.c_char_p, [_I]),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernels ssd_scan_fwd reports in its launched[] slots
_KERNELS = ("ssd_kernel", "chunk_state_kernel", "state_pass_kernel",
            "chunk_out_kernel")


def ssd_scan(x, dt, A, Bm, Cm, D, *, chunk=128):
    """x (B, S, H, P), dt (B, S, H), A and D (H,), Bm and Cm (B, S, N) on
    the card → (y (B, S, H, P) in x's dtype, h_final (B, H, P, N)
    float32).  x, Bm and Cm share one dtype (float32 or bfloat16); dt, A
    and D are used as float32.  ``chunk`` is the SSD chunk Q; any P, N
    and Q whose block fits shared memory."""
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm),
                    ("D", D)):
        if not _build.on_card(t):
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
    # a device's launch grid; the dry run's meta tensors are the mesh's
    if not x.is_meta and (max(H, B) > 65535 or B * S * H * P >= 2**62):
        raise ValueError(f"x {tuple(x.shape)} exceeds one launch grid")
    launched = (ctypes.c_int * len(_KERNELS))()
    if x.is_meta:
        _build.meta_call("ssd_scan", x, dt, A, Bm, Cm, D)
        y = torch.empty_like(x)
        h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    elif _build.recorded(x, dt, A, Bm, Cm, D):
        y, h = _ref.ref_ssd(x, dt, A, Bm, Cm, D)
    else:
        y, h = _launch(x, dt, A, Bm, Cm, D, Q, launched)
    _build.LAUNCHES["ssd_scan"] += 1
    _build.count_kernels(_KERNELS, launched)
    return y, h


def cost(x, dt, A, Bm, Cm, D) -> tuple[int, int]:
    """(operations, bytes) of one call: the recurrence's 5·P·N operations
    a token and head (3 for the state update, 2 for the readout), each
    input read once, y and h_final written once."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    n_bytes = sum(t.numel() * t.element_size() for t in (x, dt, A, Bm, Cm,
                                                         D, x))
    return 5 * B * S * H * P * N, n_bytes + B * H * P * N * 4


def _launch(x, dt, A, Bm, Cm, D, Q, launched):
    """Launch the scan on validated operands; → (y, h_final)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    lib = _build.load("ssd_scan", _SIGNATURES)
    code = _DTYPE_CODE[x.dtype]
    smem = lib.ssd_scan_smem_bytes(P, N, Q, code)
    if smem > SMEM_MAX:
        raise ValueError(f"P={P}, N={N}, chunk={Q} need {smem} bytes of "
                         f"shared memory a block, above {SMEM_MAX}")
    f32 = torch.float32
    x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
    dt, A, D = (t.to(f32).contiguous() for t in (dt, A, D))
    y = torch.empty_like(x)
    h = torch.empty((B, H, P, N), dtype=f32, device=x.device)
    scratch = (None, None, None)
    if x.dtype == torch.bfloat16 and lib.ssd_scan_tensor_cores(P, N, Q):
        # chunk states, h_c, seg
        nc = -(-S // Q)
        scratch = (
            torch.empty((B, H, nc, P, N), dtype=f32, device=x.device),
            torch.empty((B, H, nc, P, N), dtype=x.dtype, device=x.device),
            torch.empty((B, H, nc), dtype=f32, device=x.device))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr(), y.data_ptr(), h.data_ptr(),
            *(t.data_ptr() if t is not None else None for t in scratch),
            B, S, H, P, N, Q, code, x.device.index, stream, launched)
    _build.check(lib, "ssd_scan_error_string", err, "ssd_scan_fwd")
    return y, h
