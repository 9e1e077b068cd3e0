"""Build and load the hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded through ``ctypes``
(no PyTorch headers, so a build takes seconds).  Libraries are built at
first use into ``build/repro_torch/`` at the repository root, named by a
hash of their source and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  :func:`build` starts one ``nvcc`` per
missing library, all at once.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
kernel wrappers raise on anything but 0 and count their launches in
:data:`LAUNCHES`.
"""
from __future__ import annotations

import collections
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

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return nvcc


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


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


def check(lib: ctypes.CDLL, err_fn: str, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = getattr(lib, err_fn)(err).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {err} "
                           f"({msg})")
