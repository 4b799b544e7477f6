"""Image files and buffers on the host: read, write, encode, decode, resize.

Where ``cv2`` imports, every function here uses it, as the JAX package does
(``cv2.imread``/``imwrite``/``imdecode``/``imencode``/``resize``, with the
BGR <-> RGB swaps). Where it does not, as on a machine with only the port's
dependencies, the module falls back to codecs of its own:

* 8-bit PNG (gray, gray + alpha, RGB, RGBA, palette; not interlaced), read
  and written with ``zlib`` and the five row filters of the PNG standard;
* ``.npy`` arrays through numpy;
* bilinear resize with cv2's ``INTER_LINEAR`` sampling and area resize with
  cv2's ``INTER_AREA`` rule, both within one uint8 step of cv2.

JPEG has no fallback: reading or encoding one without cv2 raises
:class:`CodecUnavailable`, which names the missing codec, and
:func:`write_image` writes a ``.png`` where a ``.jpg`` was asked for (it
logs that, and returns the path it wrote).

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
    """The format needs a codec that is not importable here (JPEG without cv2)."""


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
    """The pixels of an 8-bit, non-interlaced PNG: (H, W) for gray, (H, W, 2)
    gray + alpha, (H, W, 3) RGB (palette images too), (H, W, 4) RGBA."""
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
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, color type {color}, "
                         f"interlace {interlace} (8-bit, not interlaced only)")
    c = _CHANNELS[color]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c).reshape(h, w, c)
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        return palette[px[..., 0]]
    return px[..., 0] if c == 1 else px


def _to_rgb(px: np.ndarray) -> np.ndarray:
    """cv2.IMREAD_COLOR's view of decoded pixels: 3 channels, no alpha."""
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
