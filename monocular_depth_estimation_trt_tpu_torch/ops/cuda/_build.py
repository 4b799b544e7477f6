"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` for ``sm_90a``,
all of them at once, and the objects are linked into one shared library
with a plain C interface, under ``<package>/_build/``, loaded with
``ctypes``. The library's name carries a hash of the sources,
the headers they share (``csrc/*.cuh``) and the flags, so an edited source
builds anew and an unchanged one loads at once.
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
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for path in [*srcs, *headers]:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc exited with {proc.returncode}: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def _build(srcs, target: str) -> str:
    """One nvcc per source, all started together, then one link."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(src) + ".o") for src in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src] for src, obj in zip(srcs, objs)]
        with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
            logs = list(pool.map(_run, cmds))
        lib = os.path.join(tmp, "lib.so")
        logs.append(_run([nvcc, "-shared", "-o", lib, *objs]))
        os.replace(lib, target)  # atomic: a concurrent loader sees all or nothing
    return "".join(logs)


def library_path() -> str:
    """Where the library of the current sources is, or will be, built."""
    srcs = sources()
    if not srcs:
        raise KernelBuildError(f"no CUDA sources under {CSRC_DIR}")
    return os.path.join(BUILD_DIR, f"libmdet_kernels_{_digest(srcs)}.so")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has none."""
    global _LIB, _INFO
    with _LOCK:
        if _LIB is not None:
            return _LIB
        srcs = sources()
        target = library_path()
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
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    bhnd = (ptr, ptr, ptr, ptr, ctypes.POINTER(ctypes.c_int64), i32, i32, i32, i32,
            ctypes.c_float, i32, ptr)
    signatures = {
        # K1: qkv, out, batch, n, heads, scale, tile, stream
        "mdet_flash_attention_packed": (ptr, ptr, i32, i32, i32, ctypes.c_float, i32, ptr),
        # K2 and K3: q, k, v, out, 12 int64 strides, batch, heads, n, head_dim, scale,
        # tile, stream
        "mdet_flash_attention": bhnd,
        "mdet_flash_attention_batched": bhnd,
        # K4: x, weight_q, qmul, out_scale, bias (or null), out, m, n, k, tile width,
        # stream
        "mdet_w8a8_matmul": (ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr),
    }
    for stem, argtypes in signatures.items():
        for suffix in ("_bf16", "_f32"):
            fn = getattr(lib, stem + suffix)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
