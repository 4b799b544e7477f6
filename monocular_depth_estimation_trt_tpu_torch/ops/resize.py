"""Separable image resizing as two matrix contractions.

Counterpart of the JAX package's ``ops/resize.py``: the same dense
``(out, in)`` resampling matrices (Keys cubic a=-0.75, half-pixel linear,
``align_corners``, antialias, nearest, edge clamping), applied to
channels-last tensors as two fp32 ``torch.einsum`` contractions. The port
matches these matrices, not ``F.interpolate``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel (cv2/torch use a=-0.75)."""
    x = np.abs(x)
    x2 = x * x
    x3 = x2 * x
    w = np.where(
        x <= 1.0,
        (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0,
        np.where(x < 2.0, a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a, 0.0),
    )
    return w


def _linear_kernel(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


@functools.lru_cache(maxsize=256)
def resample_matrix(
    in_size: int,
    out_size: int,
    method: str = "cubic",
    align_corners: bool = False,
    antialias: bool = False,
    a: float = -0.75,
) -> np.ndarray:
    """Dense (out_size, in_size) float32 resampling matrix.

    Edge handling replicates cv2/torch: tap indices are clamped to the valid
    range (their weights accumulate onto the border pixel). The cached array
    is shared by every caller; do not write to it.
    """
    if in_size == out_size and not align_corners:
        # half-pixel resampling at identical size is the identity
        return np.eye(in_size, dtype=np.float32)

    if method == "cubic":
        # torch's antialiased bicubic mirrors PIL (a=-0.5); the plain path
        # and cv2 INTER_CUBIC use a=-0.75.
        if antialias and not align_corners:
            a = -0.5
        kernel, support = functools.partial(_cubic_kernel, a=a), 2.0
    elif method == "linear":
        kernel, support = _linear_kernel, 1.0
    elif method == "nearest":
        kernel, support = None, 0.5
    else:
        raise ValueError(f"unknown method {method!r}")

    out_idx = np.arange(out_size, dtype=np.float64)
    if align_corners:
        if out_size == 1:
            src = np.zeros(1)
        else:
            src = out_idx * (in_size - 1) / (out_size - 1)
        scale = (in_size - 1) / max(out_size - 1, 1)
    else:
        scale = in_size / out_size
        src = (out_idx + 0.5) * scale - 0.5

    if method == "nearest":
        # cv2 INTER_NEAREST and torch 'nearest' truncate i * scale
        nearest = np.floor(out_idx * (in_size / out_size)).astype(np.int64)
        nearest = np.clip(nearest, 0, in_size - 1)
        mat = np.zeros((out_size, in_size), dtype=np.float32)
        mat[np.arange(out_size), nearest] = 1.0
        return mat

    # Antialias: widen the kernel by the downscale factor (torch semantics).
    filter_scale = max(scale, 1.0) if (antialias and not align_corners) else 1.0
    eff_support = support * filter_scale

    left = np.floor(src - eff_support).astype(np.int64) + 1
    n_taps = int(np.ceil(2.0 * eff_support)) + 1
    taps = left[:, None] + np.arange(n_taps)[None, :]  # (out, taps)
    dist = (src[:, None] - taps) / filter_scale
    weights = kernel(dist)
    if antialias and not align_corners:
        # torch/PIL antialias semantics: out-of-bounds taps are dropped
        # before normalization.
        weights = np.where((taps >= 0) & (taps < in_size), weights, 0.0)
    wsum = weights.sum(axis=1, keepdims=True)
    wsum = np.where(np.abs(wsum) < 1e-12, 1.0, wsum)
    weights = weights / wsum

    taps_clamped = np.clip(taps, 0, in_size - 1)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(mat, (np.repeat(np.arange(out_size), n_taps), taps_clamped.ravel()),
              weights.ravel())
    return mat.astype(np.float32)


def resample_tensor(in_size: int, out_size: int, method: str = "cubic",
                    align_corners: bool = False, antialias: bool = False, *,
                    device=None, dtype=torch.float32) -> torch.Tensor:
    """:func:`resample_matrix` as a tensor on ``device``."""
    mat = resample_matrix(in_size, out_size, method, align_corners, antialias)
    return torch.from_numpy(mat).to(device=device, dtype=dtype)


def _apply_separable(img: torch.Tensor, wh: torch.Tensor,
                     ww: torch.Tensor) -> torch.Tensor:
    """img: (..., H, W, C) -> (..., out_H, out_W, C), contracted in fp32."""
    in_dtype = img.dtype
    x = img.float()
    x = torch.einsum("oh,...hwc->...owc", wh, x)
    x = torch.einsum("pw,...owc->...opc", ww, x)
    return x.to(in_dtype) if in_dtype.is_floating_point else x


def resize(
    img: torch.Tensor,
    out_hw: Tuple[int, int],
    method: str = "cubic",
    align_corners: bool = False,
    antialias: bool = False,
) -> torch.Tensor:
    """Resize channels-last image(s) ``(..., H, W, C)`` to ``out_hw``."""
    h, w = img.shape[-3], img.shape[-2]
    oh, ow = out_hw
    if (h, w) == (oh, ow) and not align_corners:
        return img
    wh = resample_tensor(h, oh, method, align_corners, antialias, device=img.device)
    ww = resample_tensor(w, ow, method, align_corners, antialias, device=img.device)
    return _apply_separable(img, wh, ww)


def resize_hw(
    x: torch.Tensor,
    out_hw: Tuple[int, int],
    method: str = "linear",
    align_corners: bool = True,
) -> torch.Tensor:
    """Resize a 2D map ``(..., H, W)`` (no channel axis), e.g. a depth map."""
    y = resize(x[..., None], out_hw, method=method, align_corners=align_corners)
    return y[..., 0]


# Reference "lower_bound" sizing logic (Depth_Anything_V2/onnx2trt.py:87-116)


def constrain_to_multiple_of(
    x: float, min_val: int = 0, max_val: Optional[int] = None, multiple: int = 14
) -> int:
    y = int(np.round(x / multiple) * multiple)
    if max_val is not None and y > max_val:
        y = int(np.floor(x / multiple) * multiple)
    if y < min_val:
        y = int(np.ceil(x / multiple) * multiple)
    return y


def lower_bound_size(
    h: int, w: int, target: int, multiple: int = 14
) -> Tuple[int, int]:
    """Aspect-keeping resize target where the short side is >= ``target`` and
    both sides are multiples of ``multiple`` (DPT 'lower_bound' policy)."""
    scale_h = target / h
    scale_w = target / w
    if scale_w > scale_h:
        scale_h = scale_w
    else:
        scale_w = scale_h
    new_h = constrain_to_multiple_of(scale_h * h, min_val=target, multiple=multiple)
    new_w = constrain_to_multiple_of(scale_w * w, min_val=target, multiple=multiple)
    return new_h, new_w
