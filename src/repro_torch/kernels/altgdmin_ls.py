"""CUDA wrappers of the AltGDmin least-squares kernels
(``csrc/altgdmin_ls.cu``).

* :func:`node_fused_iter` replaces ``node_fused_iter`` of
  ``src/repro/kernels/altgdmin_ls.py`` (``_fused_iter_kernel``): one
  launch computes, for every task of every node, the min-B solution and
  the gradient tile, building A = X_t U_g once.  Where a task's X_t fits
  the shared memory of its CTAs the launch reads X once
  (``fused_resident_kernel``); past that budget it streams X twice
  (``fused_iter_kernel``).  Both kernels are hand-written; the choice is
  made in ``csrc/altgdmin_ls.cu``, which reports the kernel it launched
  (:data:`repro_torch.kernels._build.KERNEL_LAUNCHES`).
* :func:`node_task_gram` replaces ``node_task_gram``
  (``_gram_kernel_nb``): the Gram pair (G, c) of every task, one CTA a
  task streaming X once and holding none of it (``stream_gram_kernel``),
  with U_g's rows in shared memory where they fit and read through L1
  where they do not; the C entry reports which.
* :func:`node_task_grad_tiles` replaces ``node_task_grad_tiles``
  (``_grad_kernel_nb``): the gradient tiles for a GIVEN B, the second
  launch of the sample-split path; A = X_t U_g is rebuilt on the
  gradient fold's data.  Where X_t fits the shared memory of its CTAs
  it runs the resident kernel's gradient form, which reads X once
  (``fused_resident_kernel/grad``), else the two-pass
  ``grad_tiles_kernel``; the C entry reports which.
* :func:`task_gram` and :func:`task_grad_tiles` replace ``task_gram``
  (``_gram_kernel``) and ``task_grad_tiles`` (``_grad_kernel``): the
  same Gram pair and gradient tiles with ONE basis U (d, r) shared by
  all T tasks (X (T, n, d), no node axis), the layout of the serving
  side and of ``ops.altgdmin_minimize_B`` / ``ops.altgdmin_gradient``.
  They launch the node Gram and gradient kernels with one node (L = 1,
  tpn = T), where every block's basis is that U, and keep their own
  launch counts.

All five are bound by the bytes of X (see the source for each design).
X, U and y are taken in float32 or bfloat16; float64 inputs are
converted to float32 first, which is what the TPU kernel's
``astype(float32)`` does in its body.
B is taken as float32 whatever its dtype, as the TPU body converts it.
The plain versions are :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

R_MAX = 16

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "altgdmin_node_fused_iter": (_I, [_P] * 5 + [_I] * 7 + [_P, _I, _P]),
    "altgdmin_node_task_gram": (_I, [_P] * 5 + [_I] * 7 + [_P, _P]),
    "altgdmin_node_grad_tiles": (_I, [_P] * 5 + [_I] * 7 + [_P, _I, _P]),
    "altgdmin_error_string": (ctypes.c_char_p, [_I]),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernels altgdmin_node_fused_iter reports in its launched[] slots
_FUSED_KERNELS = ("fused_resident_kernel", "fused_iter_kernel")
# altgdmin_node_task_gram's: U_g's rows in shared memory, or through L1
_GRAM_KERNELS = ("stream_gram_kernel", "stream_gram_kernel/u_from_l1")
# altgdmin_node_grad_tiles': the resident kernel's gradient form, or the
# two-pass kernel
_GRAD_KERNELS = ("fused_resident_kernel/grad", "grad_tiles_kernel")


def _operands(X, U, y):
    """Validate shapes and device; bring X, U, y to one kernel dtype
    (f32 or bf16), contiguous.  Returns (X, U, y, dims, dtype code)."""
    for name, t in (("X", X), ("U", U), ("y", y)):
        if not _build.on_card(t):
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
    if 2 * L * tpn >= 2**31:     # two CTAs a task in the resident kernel
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


def _single_operands(X, U, y):
    """:func:`_operands` for one basis shared by T tasks: X (T, n, d),
    U (d, r), y (T, n), returned in the node layout with one node
    (L = 1, tpn = T), the dims (1, T, n, d, r) and the dtype code."""
    if X.ndim != 3 or U.ndim != 2 or y.ndim != 2:
        raise ValueError(f"want X (T,n,d), U (d,r), y (T,n); got "
                         f"{tuple(X.shape)}, {tuple(U.shape)}, "
                         f"{tuple(y.shape)}")
    if U.shape[0] != X.shape[2] or y.shape != X.shape[:2]:
        raise ValueError(f"shape mismatch: X {tuple(X.shape)}, U "
                         f"{tuple(U.shape)}, y {tuple(y.shape)}")
    return _operands(X[None], U[None], y[None])


def _checked_B(B, X, shape):
    """B on X's card, of ``shape``, as contiguous float32."""
    if not _build.on_card(B) or B.device != X.device:
        raise ValueError(f"B must be on {X.device} with X, got {B.device}")
    if tuple(B.shape) != shape:
        raise ValueError(f"want B of shape {shape}, got {tuple(B.shape)}")
    if not B.is_floating_point():
        raise ValueError(f"unsupported B dtype {B.dtype}")
    return B.to(torch.float32).contiguous()


def _plain_fused(X, U, y, B, tiles):
    B_, tiles_ = _ref.ref_fused_iter(X, U, y)
    B.copy_(B_)
    tiles.copy_(tiles_)


def _plain_gram(X, U, y, G, c):
    G_, c_ = _ref.ref_task_gram(X, U, y)
    G.copy_(G_)
    c.copy_(c_)


def _plain_grad(X, U, B, y, tiles):
    tiles.copy_(_ref.ref_node_grad_tiles(X, U, B, y))


# what each C entry computes, in plain torch into the same outputs: run
# in place of the launch inside _build.recording()
_PLAIN = {"altgdmin_node_fused_iter": _plain_fused,
          "altgdmin_node_task_gram": _plain_gram,
          "altgdmin_node_grad_tiles": _plain_grad}


def _launch(fn: str, tensors, dims, code, *extra):
    if _build.recorded(*tensors):
        _PLAIN[fn](*tensors)
        return
    lib = _build.load("altgdmin_ls", _SIGNATURES)
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*(t.data_ptr() for t in tensors), *dims, code,
                               device.index, stream, *extra)
    _build.check(lib, "altgdmin_error_string", err, fn)


def _check_ctas(ctas_per_task):
    if ctas_per_task not in (None, 1, 2):
        raise ValueError(f"ctas_per_task must be None, 1 or 2, got "
                         f"{ctas_per_task}")


def node_fused_iter(X, U, y, *, ctas_per_task=None):
    """One fused AltGDmin iteration for all nodes and tasks, one launch.
    X (L, tpn, n, d), U (L, d, r), y (L, tpn, n) on the card →
    B (L, tpn, r) and tiles (L, tpn, d, r), float32, where
    tiles[g, t] = X_tᵀ(X_t U_g b_t − y_t) b_tᵀ.  The resident kernel
    splits a task's columns of X over the CTAs of a cluster; the kernel
    picks one or two CTAs a task from the task's shared memory (``None``),
    or ``ctas_per_task`` (1 or 2) forces it, to time the pick against the
    other form."""
    _check_ctas(ctas_per_task)
    X, U, y, dims, code = _operands(X, U, y)
    L, tpn, n, d, r = dims
    B = torch.empty((L, tpn, r), dtype=torch.float32, device=X.device)
    tiles = torch.empty((L, tpn, d, r), dtype=torch.float32, device=X.device)
    launched = (ctypes.c_int * len(_FUSED_KERNELS))()
    _launch("altgdmin_node_fused_iter", (X, U, y, B, tiles), dims, code,
            ctas_per_task or 0, launched)
    _build.LAUNCHES["node_fused_iter"] += 1
    _build.count_kernels(_FUSED_KERNELS, launched)
    return B, tiles


def _gram(X, U, y, dims, code):
    """Launch the Gram kernel on the node layout; G, c of all tasks."""
    L, tpn, n, d, r = dims
    G = torch.empty((L, tpn, r, r), dtype=torch.float32, device=X.device)
    c = torch.empty((L, tpn, r), dtype=torch.float32, device=X.device)
    launched = (ctypes.c_int * len(_GRAM_KERNELS))()
    _launch("altgdmin_node_task_gram", (X, U, y, G, c), dims, code, launched)
    _build.count_kernels(_GRAM_KERNELS, launched)
    return G, c


def node_task_gram(X, U, y):
    """The Gram systems of all tasks, one launch.  Same operands as
    :func:`node_fused_iter` → G (L, tpn, r, r), c (L, tpn, r), float32."""
    G, c = _gram(*_operands(X, U, y))
    _build.LAUNCHES["node_task_gram"] += 1
    return G, c


def _grad_tiles(X, U, B, y, dims, code, ctas_per_task):
    """Launch the gradient kernel on the node layout; the tiles of all
    tasks."""
    _check_ctas(ctas_per_task)
    L, tpn, n, d, r = dims
    tiles = torch.empty((L, tpn, d, r), dtype=torch.float32, device=X.device)
    launched = (ctypes.c_int * len(_GRAD_KERNELS))()
    _launch("altgdmin_node_grad_tiles", (X, U, B, y, tiles), dims, code,
            ctas_per_task or 0, launched)
    _build.count_kernels(_GRAD_KERNELS, launched)
    return tiles


def node_task_grad_tiles(X, U, B, y, *, ctas_per_task=None):
    """The gradient tiles of all tasks for a given B, one launch.  Same
    X, U, y as :func:`node_fused_iter`, plus B (L, tpn, r) on the card →
    tiles (L, tpn, d, r) float32, tiles[g, t] = X_tᵀ(X_t U_g b_t − y_t)
    b_tᵀ.  The resident form picks one or two CTAs a task (``None``),
    or ``ctas_per_task`` forces it; the tiles are the same bits either
    way."""
    X, U, y, dims, code = _operands(X, U, y)
    L, tpn, n, d, r = dims
    B = _checked_B(B, X, (L, tpn, r))
    tiles = _grad_tiles(X, U, B, y, dims, code, ctas_per_task)
    _build.LAUNCHES["node_task_grad_tiles"] += 1
    return tiles


def task_gram(X, U, y):
    """The Gram systems of T tasks against one basis, one launch.
    X (T, n, d), U (d, r), y (T, n) on the card → G (T, r, r),
    c (T, r), float32."""
    G, c = _gram(*_single_operands(X, U, y))
    _build.LAUNCHES["task_gram"] += 1
    return G[0], c[0]


def task_grad_tiles(X, U, B, y, *, ctas_per_task=None):
    """The gradient tiles of T tasks against one basis for a given B,
    one launch.  X (T, n, d), U (d, r), B (T, r), y (T, n) on the card →
    tiles (T, d, r) float32, tiles[t] = X_tᵀ(X_t U b_t − y_t) b_tᵀ;
    ``ctas_per_task`` as for :func:`node_task_grad_tiles`."""
    X, U, y, dims, code = _single_operands(X, U, y)
    _, T, n, d, r = dims
    B = _checked_B(B, X, (T, r))[None]
    tiles = _grad_tiles(X, U, B, y, dims, code, ctas_per_task)
    _build.LAUNCHES["task_grad_tiles"] += 1
    return tiles[0]
