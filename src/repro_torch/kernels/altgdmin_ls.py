"""CUDA wrappers of the AltGDmin least-squares kernels
(``csrc/altgdmin_ls.cu``).

* :func:`node_fused_iter` replaces ``node_fused_iter`` of
  ``src/repro/kernels/altgdmin_ls.py`` (``_fused_iter_kernel``): one
  launch computes, for every task of every node, the min-B solution and
  the gradient tile, building A = X_t U_g once.
* :func:`node_task_gram` replaces ``node_task_gram``
  (``_gram_kernel_nb``): the Gram pair (G, c) of every task.
* :func:`node_task_grad_tiles` replaces ``node_task_grad_tiles``
  (``_grad_kernel_nb``): the gradient tiles for a GIVEN B, the second
  launch of the sample-split path; A = X_t U_g is rebuilt on the
  gradient fold's data with the fused kernel's own device code.

All three are bound by the bytes of X: one block per task streams its X_t
row by row (see the source for the design).  X, U and y are taken in
float32 or bfloat16; float64 inputs are converted to float32 first,
which is what the TPU kernel's ``astype(float32)`` does in its body.
B is taken as float32 whatever its dtype, as the TPU body converts it.
The plain versions are :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

R_MAX = 16

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "altgdmin_node_fused_iter": (_I, [_P] * 5 + [_I] * 7 + [_P]),
    "altgdmin_node_task_gram": (_I, [_P] * 5 + [_I] * 7 + [_P]),
    "altgdmin_node_grad_tiles": (_I, [_P] * 5 + [_I] * 7 + [_P]),
    "altgdmin_error_string": (ctypes.c_char_p, [_I]),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _operands(X, U, y):
    """Validate shapes and device; bring X, U, y to one kernel dtype
    (f32 or bf16), contiguous.  Returns (X, U, y, dims, dtype code)."""
    for name, t in (("X", X), ("U", U), ("y", y)):
        if not t.is_cuda:
            raise ValueError(f"the CUDA kernel needs {name} on a CUDA "
                             f"device, got {t.device}")
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device} but X on {X.device}")
    if X.ndim != 4 or U.ndim != 3 or y.ndim != 3:
        raise ValueError(f"want X (L,tpn,n,d), U (L,d,r), y (L,tpn,n); got "
                         f"{tuple(X.shape)}, {tuple(U.shape)}, "
                         f"{tuple(y.shape)}")
    L, tpn, n, d = X.shape
    r = U.shape[2]
    if U.shape[:2] != (L, d) or y.shape != (L, tpn, n):
        raise ValueError(f"shape mismatch: X {tuple(X.shape)}, U "
                         f"{tuple(U.shape)}, y {tuple(y.shape)}")
    if min(L, tpn, n, d, r) < 1:
        raise ValueError(f"empty operand: X {tuple(X.shape)}, U "
                         f"{tuple(U.shape)}")
    if r > R_MAX:
        raise ValueError(f"rank r={r} exceeds the kernel's R_MAX={R_MAX}")
    if L * tpn >= 2**31:
        raise ValueError(f"L·tpn={L * tpn} tasks exceed one launch grid")
    dtypes = {X.dtype, U.dtype, y.dtype}
    if len(dtypes) == 1 and X.dtype in _DTYPE_CODE:
        dt = X.dtype
    elif dtypes <= {torch.float32, torch.bfloat16, torch.float64}:
        dt = torch.float32              # exact for bf16, f64 → f32 rounding
    else:
        raise ValueError(f"unsupported dtypes {sorted(map(str, dtypes))}")
    X, U, y = (t.to(dt).contiguous() for t in (X, U, y))
    return X, U, y, (L, tpn, n, d, r), _DTYPE_CODE[dt]


def _launch(fn: str, tensors, dims, code):
    lib = _build.load("altgdmin_ls", _SIGNATURES)
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*(t.data_ptr() for t in tensors), *dims, code,
                               device.index, stream)
    _build.check(lib, "altgdmin_error_string", err, fn)


def node_fused_iter(X, U, y):
    """One fused AltGDmin iteration for all nodes and tasks, one launch.
    X (L, tpn, n, d), U (L, d, r), y (L, tpn, n) on the card →
    B (L, tpn, r) and tiles (L, tpn, d, r), float32, where
    tiles[g, t] = X_tᵀ(X_t U_g b_t − y_t) b_tᵀ."""
    X, U, y, dims, code = _operands(X, U, y)
    L, tpn, n, d, r = dims
    B = torch.empty((L, tpn, r), dtype=torch.float32, device=X.device)
    tiles = torch.empty((L, tpn, d, r), dtype=torch.float32, device=X.device)
    _launch("altgdmin_node_fused_iter", (X, U, y, B, tiles), dims, code)
    _build.LAUNCHES["node_fused_iter"] += 1
    return B, tiles


def node_task_gram(X, U, y):
    """The Gram systems of all tasks, one launch.  Same operands as
    :func:`node_fused_iter` → G (L, tpn, r, r), c (L, tpn, r), float32."""
    X, U, y, dims, code = _operands(X, U, y)
    L, tpn, n, d, r = dims
    G = torch.empty((L, tpn, r, r), dtype=torch.float32, device=X.device)
    c = torch.empty((L, tpn, r), dtype=torch.float32, device=X.device)
    _launch("altgdmin_node_task_gram", (X, U, y, G, c), dims, code)
    _build.LAUNCHES["node_task_gram"] += 1
    return G, c


def node_task_grad_tiles(X, U, B, y):
    """The gradient tiles of all tasks for a given B, one launch.  Same
    X, U, y as :func:`node_fused_iter`, plus B (L, tpn, r) on the card →
    tiles (L, tpn, d, r) float32, tiles[g, t] = X_tᵀ(X_t U_g b_t − y_t)
    b_tᵀ."""
    X, U, y, dims, code = _operands(X, U, y)
    L, tpn, n, d, r = dims
    if not B.is_cuda or B.device != X.device:
        raise ValueError(f"B must be on {X.device} with X, got {B.device}")
    if B.shape != (L, tpn, r):
        raise ValueError(f"want B (L, tpn, r) = {(L, tpn, r)}, got "
                         f"{tuple(B.shape)}")
    if not B.is_floating_point():
        raise ValueError(f"unsupported B dtype {B.dtype}")
    B = B.to(torch.float32).contiguous()
    tiles = torch.empty((L, tpn, d, r), dtype=torch.float32, device=X.device)
    _launch("altgdmin_node_grad_tiles", (X, U, B, y, tiles), dims, code)
    _build.LAUNCHES["node_task_grad_tiles"] += 1
    return tiles
