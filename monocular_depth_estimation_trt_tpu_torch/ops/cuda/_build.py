"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, under ``<package>/_build/``, and
loaded with ``ctypes``. The library's name carries a hash of the sources and
flags, so an edited source builds anew and an unchanged one loads at once.
The build runs at the first kernel launch of a process, never at import.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


class BuildInfo:
    """What the last build or load of the library did."""

    def __init__(self, path: str, seconds: float, built: bool, log: str):
        self.path = path
        self.seconds = seconds
        self.built = built
        self.log = log


_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_INFO: Optional[BuildInfo] = None


def sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError(
        "nvcc not found on PATH or under /usr/local/cuda/bin; the CUDA "
        "toolkit is needed to build the kernels in csrc/"
    )


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build(srcs, target: str) -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(
            f"nvcc exited with {proc.returncode}: {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    return proc.stdout + proc.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has none."""
    global _LIB, _INFO
    with _LOCK:
        if _LIB is not None:
            return _LIB
        srcs = sources()
        if not srcs:
            raise KernelBuildError(f"no CUDA sources under {CSRC_DIR}")
        target = os.path.join(BUILD_DIR, f"libmdet_kernels_{_digest(srcs)}.so")
        t0 = time.perf_counter()
        built = not os.path.exists(target)
        log = _build(srcs, target) if built else ""
        lib = ctypes.CDLL(target)
        _declare(lib)
        _INFO = BuildInfo(target, time.perf_counter() - t0, built, log)
        _LIB = lib
        return lib


def build_info() -> Optional[BuildInfo]:
    return _INFO


def _declare(lib: ctypes.CDLL) -> None:
    attn = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p)
    for name in ("mdet_flash_attention_packed_bf16",
                 "mdet_flash_attention_packed_f32"):
        fn = getattr(lib, name)
        fn.argtypes = attn
        fn.restype = ctypes.c_int
