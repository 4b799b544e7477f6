"""On-device image preprocessing (counterpart of the JAX package's
``ops/preprocess.py``), channels-last: uint8 ``(..., H, W, 3)`` in, float32
``(..., H', W', 3)`` out.

Ported so far: :func:`to_float_rgb`, :func:`normalize`,
:func:`preprocess_lower_bound` (the Depth Anything family) and
:func:`preprocess_pad_square` (VGGT). The resize and keep-ratio-pad variants
come with the families that use them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from monocular_depth_estimation_trt_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from monocular_depth_estimation_trt_tpu_torch.ops.constants import device_constant
from monocular_depth_estimation_trt_tpu_torch.ops.resize import lower_bound_size, resize


def to_float_rgb(img: torch.Tensor, bgr: bool = False) -> torch.Tensor:
    """uint8 (..., H, W, 3) -> float32 RGB in [0, 1]."""
    x = img.float() / 255.0
    if bgr:
        x = x.flip(-1)
    return x


def normalize(
    img: torch.Tensor,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
) -> torch.Tensor:
    mean_t = device_constant(mean, img.dtype, img.device)
    std_t = device_constant(std, img.dtype, img.device)
    return (img - mean_t) / std_t


def preprocess_lower_bound(
    img_u8: torch.Tensor,
    target: int = 518,
    multiple: int = 14,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    *,
    bgr: bool = False,
    method: str = "cubic",
) -> torch.Tensor:
    """DPT 'lower_bound' preprocessing: uint8 (H, W, 3) -> float32
    (1, H', W', 3), with H', W' the lower-bound multiple-of-``multiple``
    size (reference ``Depth_Anything_V2/onnx2trt.py:98-130``). A leading
    batch axis is kept as it is."""
    h, w = img_u8.shape[-3], img_u8.shape[-2]
    new_h, new_w = lower_bound_size(h, w, target, multiple)
    x = to_float_rgb(img_u8, bgr=bgr)
    x = resize(x, (new_h, new_w), method=method)
    x = normalize(x, mean, std)
    if x.dim() == 3:
        x = x[None]
    return x


def pad_square_size(h: int, w: int) -> Tuple[int, int, int]:
    """(pad_top, pad_left, side) for centered pad-to-square."""
    side = max(h, w)
    return (side - h) // 2, (side - w) // 2, side


def preprocess_pad_square(
    img_u8: torch.Tensor,
    out_size: int = 518,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    *,
    bgr: bool = False,
    pad_value: float = 1.0,
    method: str = "cubic",
) -> torch.Tensor:
    """VGGT preprocessing: center-pad to square (white, ``pad_value`` in
    [0, 1] space), resize straight to ``out_size``, normalize (reference
    ``VGGT/onnx2trt.py:80-110``, resampled once as the JAX package does).
    uint8 (H, W, 3) -> float32 (1, out, out, 3); a leading batch axis is
    kept as it is."""
    h, w = img_u8.shape[-3], img_u8.shape[-2]
    top, left, side = pad_square_size(h, w)
    x = to_float_rgb(img_u8, bgr=bgr)
    x = F.pad(x, (0, 0, left, side - w - left, top, side - h - top), value=pad_value)
    x = resize(x, (out_size, out_size), method=method)
    x = normalize(x, mean, std)
    if x.dim() == 3:
        x = x[None]
    return x
