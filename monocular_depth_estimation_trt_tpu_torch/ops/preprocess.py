"""On-device image preprocessing (counterpart of the JAX package's
``ops/preprocess.py``), channels-last: uint8 ``(..., H, W, 3)`` in, float32
``(..., H', W', 3)`` out.

Ported so far: :func:`to_float_rgb`, :func:`normalize`,
:func:`preprocess_lower_bound` (the Depth Anything family),
:func:`preprocess_pad_square` (VGGT) and :func:`preprocess_keep_ratio_pad`
(Metric3D V2). The plain resize variant comes with the families that use
it.
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


def preprocess_keep_ratio_pad(
    img_u8: torch.Tensor,
    canvas_hw: Tuple[int, int],
    mean255: Sequence[float] = (123.675, 116.28, 103.53),
    std255: Sequence[float] = (58.395, 57.12, 57.375),
    *,
    bgr: bool = False,
    method: str = "linear",
):
    """Metric3D V2 preprocessing: keep-ratio resize into a fixed canvas, pad
    the borders with the dataset mean, normalize in 0-255 space (reference
    ``Metric3D_V2/infer.py:73-96``). The scale and the rounding of the new
    size are host Python, as in the JAX package; the mean is subtracted
    before the padding, so the pad is zero.

    Returns (batched tensor, pad_info=(top, bottom, left, right), scale)."""
    h, w = img_u8.shape[-3], img_u8.shape[-2]
    ch, cw = canvas_hw
    scale = min(ch / h, cw / w)
    new_h, new_w = round(h * scale), round(w * scale)
    x = img_u8.float()
    if bgr:
        x = x.flip(-1)
    x = resize(x, (new_h, new_w), method=method)
    pad_t = (ch - new_h) // 2
    pad_b = ch - new_h - pad_t
    pad_l = (cw - new_w) // 2
    pad_r = cw - new_w - pad_l
    x = x - device_constant(mean255, x.dtype, x.device)
    x = F.pad(x, (0, 0, pad_l, pad_r, pad_t, pad_b))
    x = x / device_constant(std255, x.dtype, x.device)
    if x.dim() == 3:
        x = x[None]
    return x, (pad_t, pad_b, pad_l, pad_r), scale
