"""ctypes binding of the repository's native host-IO library
(``native/hostio.cpp``; counterpart of the JAX package's
``runtime/native.py``, which binds the same library).

The native layer owns frame acquisition: threaded JPEG/PNG/video decode,
BGR->RGB and resize run in C++ worker threads on preallocated stable buffers
(the host-side analogue of the reference's pinned ``HostDeviceMem`` buffers,
``common_runtime.py:43-89``), off the Python GIL. Python maps the buffers
without a copy and copies each frame out before it goes to the card.

The library builds with ``make -C native`` at first use where it is
missing; where it does not build or load (no C++ toolchain or no OpenCV
headers), :func:`native_available` is False and the callers
(``apps/offline.py``'s decode, ``cli.py``'s JPEG writes) take the Python IO
path of ``utils/imageio.py``, which is host code too.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, List, Optional, Tuple

import numpy as np

from monocular_depth_estimation_trt_tpu_torch.utils.logging import log

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libmdet_hostio.so")

_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception as e:
            log(f"native hostio build unavailable ({e!r}); using Python IO",
                tag="WARN")
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        log(f"native hostio load failed ({e!r}); using Python IO", tag="WARN")
        return None

    lib.mdet_pump_create_images.restype = ctypes.c_void_p
    lib.mdet_pump_create_images.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.mdet_pump_create_video.restype = ctypes.c_void_p
    lib.mdet_pump_create_video.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.mdet_pump_acquire.restype = ctypes.c_int
    lib.mdet_pump_acquire.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_double,
    ]
    lib.mdet_pump_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mdet_pump_decoded.restype = ctypes.c_int64
    lib.mdet_pump_decoded.argtypes = [ctypes.c_void_p]
    lib.mdet_pump_destroy.argtypes = [ctypes.c_void_p]
    lib.mdet_decode_resize.restype = ctypes.c_int
    lib.mdet_decode_resize.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.c_int,
    ]
    lib.mdet_encode_jpg.restype = ctypes.c_int
    lib.mdet_encode_jpg.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


class FramePump:
    """Ordered multi-threaded frame source over files or a video.

    Usage::

        with FramePump.from_images(paths, out_hw=(518, 518)) as pump:
            for idx, frame in pump:          # frame: (H, W, 3) RGB uint8 view
                run(frame)                   # copy/ship before next iteration
    """

    def __init__(self, handle, out_hw: Tuple[int, int]):
        self._h = handle
        self.out_hw = out_hw
        self._lib = _load()

    @classmethod
    def from_images(
        cls, paths: List[str], out_hw: Tuple[int, int], *, ring: int = 4,
        threads: int = 4,
    ) -> "FramePump":
        lib = _load()
        if lib is None:
            raise RuntimeError("native hostio unavailable")
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        h = lib.mdet_pump_create_images(
            arr, len(paths), ring, out_hw[1], out_hw[0], threads
        )
        return cls(h, out_hw)

    @classmethod
    def from_video(
        cls, path: str, out_hw: Tuple[int, int], *, ring: int = 4
    ) -> "FramePump":
        lib = _load()
        if lib is None:
            raise RuntimeError("native hostio unavailable")
        h = lib.mdet_pump_create_video(path.encode(), ring, out_hw[1], out_hw[0])
        return cls(h, out_hw)

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        hgt, wid = self.out_hw
        nbytes = hgt * wid * 3
        while True:
            data = ctypes.POINTER(ctypes.c_uint8)()
            fidx = ctypes.c_int64()
            slot = self._lib.mdet_pump_acquire(
                self._h, ctypes.byref(data), ctypes.byref(fidx), 30.0
            )
            if slot == -1:
                return
            if slot == -2:
                continue
            buf = np.ctypeslib.as_array(data, shape=(nbytes,))
            frame = buf.reshape(hgt, wid, 3)
            try:
                yield int(fidx.value), frame
            finally:
                self._lib.mdet_pump_release(self._h, slot)

    @property
    def decoded(self) -> int:
        return int(self._lib.mdet_pump_decoded(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.mdet_pump_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def decode_resize(path: str, out_hw: Tuple[int, int]) -> Optional[np.ndarray]:
    """Native single-image decode+resize to RGB (None if unavailable/fail)."""
    lib = _load()
    if lib is None:
        return None
    h, w = out_hw
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.mdet_decode_resize(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h
    )
    return out if rc == 0 else None


def encode_jpg(path: str, rgb: np.ndarray, quality: int = 95) -> bool:
    lib = _load()
    if lib is None:
        return False
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]
    rc = lib.mdet_encode_jpg(
        path.encode(), rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w, h, quality,
    )
    return rc == 0
