"""Build and load the hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded through ``ctypes``
(no PyTorch headers, so a build takes seconds).  Libraries are built at
first use into ``build/repro_torch/`` at the repository root, named by a
hash of their source, the shared headers (``csrc/*.cuh``) and the flags,
so an edited source or header is rebuilt and an unchanged one is loaded
as it is.  :func:`build` starts one ``nvcc`` per missing library, all at
once.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
kernel wrappers raise on anything but 0 and count their launches in
:data:`LAUNCHES`, one a call.  Where a call picks one of several
``__global__`` functions or launches several, its C entry reports which
and how often, and the wrapper adds that to :data:`KERNEL_LAUNCHES`.

:func:`recording` is the counterpart of Pallas interpret mode for the
static checks (``repro_torch.analysis``): inside it a kernel wrapper
given CPU tensors runs its plain version in place of the launch, and
counts in :data:`LAUNCHES` where the launch counts, so a run on the CPU
takes the ``cuda`` route's structure and its count is the card's.
Outside it the ``cuda`` route refuses CPU tensors, as always.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("altgdmin_ls", "gossip_axpy", "compress", "flash_attention",
           "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches per kernel, counted by each wrapper right after its launch.
LAUNCHES: collections.Counter = collections.Counter()
# CUDA launches per __global__ function, as the C entries report them.
KERNEL_LAUNCHES: collections.Counter = collections.Counter()

_loaded: dict[str, ctypes.CDLL] = {}
_recording = False


@contextlib.contextmanager
def recording():
    """Inside the ``with`` body, a kernel wrapper called on CPU tensors
    runs the kernel's plain version (:mod:`repro_torch.kernels.ref`) in
    place of the launch and counts it in :data:`LAUNCHES` as the launch
    would be counted; nothing is built or loaded.  Only the static
    checks enter it."""
    global _recording
    prev, _recording = _recording, True
    try:
        yield
    finally:
        _recording = prev


def recorded(*tensors) -> bool:
    """Whether a wrapper call on ``tensors`` runs the plain version in
    place of its launch: inside :func:`recording`, on CPU tensors."""
    return _recording and not any(t.is_cuda for t in tensors)


def on_card(t) -> bool:
    """Whether a wrapper may take ``t``: a CUDA tensor, or a CPU tensor
    inside :func:`recording`."""
    return t.is_cuda or recorded(t)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return nvcc


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, every header of
    ``csrc/`` (a source may include any of them) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every library of ``names`` not built yet, one ``nvcc``
    each, all started together.  Raises with the compiler's output if any
    build fails.  Returns the library paths."""
    paths = {name: library_path(name) for name in names}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name, p in todo.items():
            tmp = p.with_suffix(f".tmp{os.getpid()}")
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            todo[name].with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"nvcc {name}.cu exited {proc.returncode}:\n{log}")
            else:
                os.replace(tmp, todo[name])     # atomic: no half-built .so
        if failed:
            raise RuntimeError("\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills per kernel) of the library's last build, or ''."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, with the
    ``argtypes``/``restype`` of ``signatures`` (``{fn: (restype,
    argtypes)}``) declared on its functions."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _loaded[name] = lib
    return lib


def count_kernels(names, launched) -> None:
    """Add a C entry's launch report (``launched[i]`` launches of the
    ``__global__`` function ``names[i]``) to :data:`KERNEL_LAUNCHES`."""
    for name, k in zip(names, launched, strict=True):
        if k:
            KERNEL_LAUNCHES[name] += k


def check(lib: ctypes.CDLL, err_fn: str, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = getattr(lib, err_fn)(err).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {err} "
                           f"({msg})")
