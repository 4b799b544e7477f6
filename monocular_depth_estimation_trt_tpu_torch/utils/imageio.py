"""Image files and buffers on the host: read, write, encode, decode, resize.

Where ``cv2`` imports, every function here uses it, as the JAX package does
(``cv2.imread``/``imwrite``/``imdecode``/``imencode``/``resize``, with the
BGR <-> RGB swaps). Where it does not, as on a machine with only the port's
dependencies, the module falls back to codecs of its own:

* 8-bit PNG (gray, gray + alpha, RGB, RGBA, palette; not interlaced), read
  and written with ``zlib`` and the five row filters of the PNG standard,
  and 16-bit PNG read (depth ground truth, :func:`read_unchanged`);
* ``.npy`` arrays through numpy;
* bilinear resize with cv2's ``INTER_LINEAR`` sampling and area resize with
  cv2's ``INTER_AREA`` rule, both within one uint8 step of cv2.

JPEG has no fallback: reading or encoding one without cv2 raises
:class:`CodecUnavailable`, which names the missing codec, and
:func:`write_image` writes a ``.png`` where a ``.jpg`` was asked for (it
logs that, and returns the path it wrote). Video has none either: the
reader and writer (:func:`open_video`, :func:`read_video`,
:class:`VideoWriter`; ``cv2.VideoCapture`` and an mp4v ``cv2.VideoWriter``,
as in the JAX package) raise :class:`CodecUnavailable` without cv2.

Arrays are RGB(A) ``uint8`` ``(H, W, C)`` or gray ``(H, W)``.
"""

from __future__ import annotations

import functools
import os
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from monocular_depth_estimation_trt_tpu_torch.utils.logging import log

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG color type -> samples per pixel


class CodecUnavailable(RuntimeError):
    """The format needs a codec that is not importable here (JPEG or MP4
    video without cv2)."""


@functools.lru_cache(maxsize=1)
def _cv2():
    """The cv2 module, or None where it does not import."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def jpeg_available() -> bool:
    """Whether JPEG can be read and written here (it needs cv2)."""
    return _cv2() is not None


def _no_jpeg(what: str) -> CodecUnavailable:
    return CodecUnavailable(
        f"{what}: JPEG needs the cv2 (OpenCV) codec, which is not importable here; "
        "give a PNG or a .npy frame")


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """An 8-bit PNG of a gray (H, W), gray + alpha, RGB or RGBA (H, W, C)
    uint8 array; every row unfiltered (filter type 0)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}.get(c)
    if color is None or h < 1 or w < 1:
        raise ValueError(f"encode_png takes (H, W) or (H, W, 1..4), got {img.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth)."""
    if len(raw) < h * (stride + 1):
        raise ValueError("truncated PNG image data")
    data = np.frombuffer(raw, np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(data[y, 0]), data[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum per byte of the pixel, mod 256
            cur = (np.cumsum(line.reshape(-1, bpp).astype(np.uint64), axis=0) % 256
                   ).astype(np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):
            buf, up = bytearray(line.tobytes()), prev.tobytes()
            for i in range(stride):
                a = buf[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:  # Average
                    pred = (a + b) >> 1
                else:  # Paeth
                    c = up[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                buf[i] = (buf[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of a non-interlaced PNG: (H, W) for gray, (H, W, 2)
    gray + alpha, (H, W, 3) RGB (palette images too), (H, W, 4) RGBA;
    uint8, or uint16 for a 16-bit image (depth ground truth)."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG")
    pos, header, palette, idat = len(PNG_SIGNATURE), None, None, []
    while pos + 8 <= len(data):
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth not in (8, 16) or (depth == 16 and color == 3) or color not in _CHANNELS \
            or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, color type {color}, "
                         f"interlace {interlace} (8- or 16-bit, not interlaced only)")
    c = _CHANNELS[color]
    bpp = c * depth // 8
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:  # big-endian samples
        px = px.view(">u2").astype(np.uint16)
    px = px.reshape(h, w, c)
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        return palette[px[..., 0]]
    return px[..., 0] if c == 1 else px


def _to_rgb(px: np.ndarray) -> np.ndarray:
    """cv2.IMREAD_COLOR's view of decoded pixels: 3 channels, no alpha,
    8 bits (a 16-bit sample's high byte)."""
    if px.dtype == np.uint16:
        px = (px >> 8).astype(np.uint8)
    if px.ndim == 2:
        return np.repeat(px[..., None], 3, axis=-1)
    if px.shape[-1] == 2:
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


# ---------------------------------------------------------------------------
# files and buffers
# ---------------------------------------------------------------------------


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """An encoded image (bytes) as RGB uint8 (H, W, 3); None when it cannot
    be decoded. A JPEG without cv2 raises :class:`CodecUnavailable`."""
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if data.startswith(PNG_SIGNATURE):
        try:
            return _to_rgb(decode_png(data))
        except (ValueError, zlib.error, struct.error):
            return None
    if data.startswith(JPEG_SIGNATURE):
        raise _no_jpeg("cannot decode the image")
    return None


def read_image(path: str) -> np.ndarray:
    """An image file (or a ``.npy`` uint8 (H, W, 3) array) as RGB uint8."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"[MDET] image not found: {path}")
    if path.lower().endswith(".npy"):
        img = np.load(path)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(f"{path}: want a uint8 (H, W, 3) array, got {img.dtype} "
                             f"{img.shape}")
        return img
    cv2 = _cv2()
    if cv2 is not None:
        raw = cv2.imread(path)
        if raw is None:
            raise FileNotFoundError(f"[MDET] image not found: {path}")
        return cv2.cvtColor(raw, cv2.COLOR_BGR2RGB)
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(JPEG_SIGNATURE):
        raise _no_jpeg(path)
    img = decode_image(data)
    if img is None:
        raise ValueError(f"{path}: not a PNG this codec reads (8-bit, not interlaced)")
    return img


def read_unchanged(path: str) -> np.ndarray:
    """An image file's samples as stored (``cv2.IMREAD_UNCHANGED``): a
    16-bit depth PNG as uint16, color channels in cv2's BGR order. Without
    cv2, PNG only."""
    cv2 = _cv2()
    if cv2 is not None:
        arr = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if arr is None:
            raise IOError(f"unreadable image {path}")
        return arr
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        raise CodecUnavailable(f"{path}: only PNG reads without the cv2 (OpenCV) codec")
    px = decode_png(data)
    if px.ndim == 3 and px.shape[-1] >= 3:  # RGB(A) -> BGR(A), as cv2 stores it
        px = np.concatenate([px[..., 2::-1], px[..., 3:]], axis=-1)
    return px


def encode_image(img: np.ndarray, ext: str = ".png") -> bytes:
    """RGB uint8 -> encoded bytes (``.png`` or ``.jpg``)."""
    cv2 = _cv2()
    if cv2 is not None:
        ok, enc = cv2.imencode(ext, cv2.cvtColor(np.asarray(img), cv2.COLOR_RGB2BGR))
        if not ok:
            raise ValueError(f"cv2 could not encode {ext}")
        return enc.tobytes()
    if ext.lower() == ".png":
        return encode_png(np.asarray(img))
    raise _no_jpeg(f"cannot encode {ext}")


def write_image(path: str, img: np.ndarray) -> str:
    """Write RGB uint8 ``img``; returns the path written. Without cv2 a
    ``.jpg``/``.jpeg`` path is written as PNG beside it (logged)."""
    stem, ext = os.path.splitext(path)
    cv2 = _cv2()
    if cv2 is not None:
        if not cv2.imwrite(path, cv2.cvtColor(np.asarray(img), cv2.COLOR_RGB2BGR)):
            raise IOError(f"could not write {path}")
        return path
    if ext.lower() in (".jpg", ".jpeg"):
        png = stem + ".png"
        log(f"cv2 is not importable (no JPEG codec): writing {png} in place of {path}")
        path = png
    elif ext.lower() != ".png":
        raise _no_jpeg(f"cannot write {path} (only .png without cv2)")
    with open(path, "wb") as f:
        f.write(encode_png(np.asarray(img)))
    return path


def write_gray(path: str, img: np.ndarray) -> str:
    """Write a gray uint8 (H, W) image (``.png``; ``.jpg`` as with
    :func:`write_image`)."""
    cv2 = _cv2()
    if cv2 is not None:
        if not cv2.imwrite(path, np.asarray(img)):
            raise IOError(f"could not write {path}")
        return path
    return write_image(path, np.repeat(np.asarray(img)[..., None], 3, axis=-1))


# ---------------------------------------------------------------------------
# video (cv2 only)
# ---------------------------------------------------------------------------


def video_cv2(what: str):
    """The cv2 module for video work, or :class:`CodecUnavailable` naming the
    missing codec."""
    cv2 = _cv2()
    if cv2 is None:
        raise CodecUnavailable(
            f"{what}: video (MP4/mp4v) needs the cv2 (OpenCV) codec, which is not "
            "importable here")
    return cv2


def open_video(source):
    """An opened ``cv2.VideoCapture`` of a file path or a camera (index or
    URL); :class:`CodecUnavailable` without cv2, ``FileNotFoundError`` when
    it does not open."""
    cv2 = video_cv2(f"cannot read {source!r}")
    cap = cv2.VideoCapture(source)
    if not cap.isOpened():
        raise FileNotFoundError(f"[MDET] cannot open video: {source}")
    return cap


def video_fps(cap) -> float:
    """The capture's frame rate (30 where the container gives none)."""
    return cap.get(_cv2().CAP_PROP_FPS) or 30.0


def iter_video(cap, max_frames: Optional[int] = None):
    """The capture's frames as RGB uint8 (H, W, 3), at most ``max_frames``;
    releases the capture at the end."""
    cv2 = _cv2()
    n = 0
    try:
        while not max_frames or n < max_frames:
            ok, bgr = cap.read()
            if not ok:
                break
            yield cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
            n += 1
    finally:
        cap.release()


def read_video(path: str, max_frames: Optional[int] = None) -> Tuple[np.ndarray, float]:
    """A video file as RGB uint8 (T, H, W, 3) and its frame rate."""
    cap = open_video(path)
    fps = video_fps(cap)
    frames = list(iter_video(cap, max_frames))
    if not frames:
        raise ValueError(f"[MDET] no frames decoded from {path}")
    return np.stack(frames), fps


class VideoWriter:
    """An mp4v MP4 of BGR uint8 frames (cv2's order) at ``(width, height)``;
    a frame of another size is resized to it (bilinear)."""

    def __init__(self, path: str, fps: float, size_wh: Tuple[int, int]):
        cv2 = video_cv2(f"cannot write {path}")
        self.size_wh = tuple(size_wh)
        self._writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, self.size_wh)

    def write_bgr(self, bgr: np.ndarray) -> None:
        if (bgr.shape[1], bgr.shape[0]) != self.size_wh:
            bgr = _cv2().resize(bgr, self.size_wh)
        self._writer.write(bgr)

    def release(self) -> None:
        self._writer.release()


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------


def _linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of cv2's INTER_LINEAR: half-pixel centers,
    edge taps clamped."""
    scale = n_in / n_out
    src = (np.arange(n_out) + 0.5) * scale - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = src - lo
    frac = np.where(lo < 0, 0.0, frac)
    lo = np.clip(lo, 0, n_in - 1)
    hi = np.clip(lo + 1, 0, n_in - 1)
    frac = np.where(lo >= n_in - 1, 0.0, frac)
    mat = np.zeros((n_out, n_in))
    np.add.at(mat, (np.arange(n_out), lo), 1.0 - frac)
    np.add.at(mat, (np.arange(n_out), hi), frac)
    return mat


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of cv2's INTER_AREA when shrinking: each output
    pixel averages the input over its footprint [i s, (i + 1) s)."""
    scale = n_in / n_out
    lo = np.arange(n_out)[:, None] * scale
    hi = lo + scale
    j = np.arange(n_in)[None, :]
    overlap = np.clip(np.minimum(hi, j + 1) - np.maximum(lo, j), 0.0, None)
    return overlap / scale


def _area_upscale_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of cv2's INTER_AREA when enlarging: linear
    interpolation between pixel sx and sx + 1 with cv2's area coefficient."""
    scale, inv = n_in / n_out, n_out / n_in
    mat = np.zeros((n_out, n_in))
    for dx in range(n_out):
        sx = int(np.floor(dx * scale))
        fx = (dx + 1) - (sx + 1) * inv
        fx = 0.0 if fx <= 0 else fx - np.floor(fx)
        if sx >= n_in - 1:
            sx, fx = n_in - 1, 0.0
        mat[dx, sx] += 1.0 - fx
        if fx:
            mat[dx, sx + 1] += fx
    return mat


def _separable(img: np.ndarray, wy: np.ndarray, wx: np.ndarray) -> np.ndarray:
    x = np.asarray(img, np.float64)
    gray = x.ndim == 2
    if gray:
        x = x[..., None]
    y = np.einsum("oh,hwc->owc", wy, x)
    y = np.einsum("pw,owc->opc", wx, y)
    y = np.clip(np.floor(y + 0.5), 0, 255).astype(np.uint8)
    return y[..., 0] if gray else y


def resize_linear(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of a uint8 image to ``hw`` = (H, W) with cv2's
    INTER_LINEAR sampling (half-pixel centers, no antialiasing)."""
    h, w = img.shape[:2]
    return _separable(img, _linear_weights(h, hw[0]), _linear_weights(w, hw[1]))


def resize_area(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Area resize of a uint8 image to ``hw`` = (H, W) by cv2's INTER_AREA
    rule: a footprint average where both sides shrink (or stay), cv2's
    area-weighted linear interpolation otherwise."""
    h, w = img.shape[:2]
    oh, ow = hw
    if h >= oh and w >= ow:
        return _separable(img, _area_weights(h, oh), _area_weights(w, ow))
    return _separable(img, _area_upscale_weights(h, oh), _area_upscale_weights(w, ow))


def resize(img: np.ndarray, hw: Tuple[int, int], interpolation: str = "linear") -> np.ndarray:
    """``cv2.resize(img, (W, H), interpolation=INTER_LINEAR | INTER_AREA)``
    where cv2 imports, else :func:`resize_linear` / :func:`resize_area`."""
    if interpolation not in ("linear", "area"):
        raise ValueError(f"unknown interpolation {interpolation!r}")
    if tuple(img.shape[:2]) == tuple(hw):
        return img
    cv2 = _cv2()
    if cv2 is not None:
        flag = cv2.INTER_LINEAR if interpolation == "linear" else cv2.INTER_AREA
        return cv2.resize(img, (hw[1], hw[0]), interpolation=flag)
    return (resize_linear if interpolation == "linear" else resize_area)(img, hw)


def resize_float(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """A float32 image (H, W, C) resized to ``hw`` with INTER_LINEAR sampling
    and no rounding: ``cv2.resize`` where cv2 imports, else cv2's weights
    (:func:`_linear_weights`) in float64."""
    img = np.asarray(img, np.float32)
    if tuple(img.shape[:2]) == tuple(hw):
        return img
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR)
    y = np.einsum("oh,hwc->owc", _linear_weights(img.shape[0], hw[0]), img.astype(np.float64))
    return np.einsum("pw,owc->opc", _linear_weights(img.shape[1], hw[1]), y).astype(np.float32)
