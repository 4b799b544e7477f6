"""On-device depth postprocessing (counterpart of the JAX package's
``ops/postprocess.py``).

The normalizations reduce over the last two axes, so that a batch of depth
maps ``(B, H, W)`` is normalized frame by frame, as the JAX package's
``vmap``-ed batch program does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from monocular_depth_estimation_trt_tpu_torch.ops.resize import resize_hw


def upsample_depth(
    depth: torch.Tensor,
    out_hw: Tuple[int, int],
    clamp: Optional[Tuple[float, float]] = (1e-3, 1e3),
    align_corners: bool = True,
) -> torch.Tensor:
    """(..., h, w) depth -> bilinear (align_corners=True) resize + clamp."""
    d = resize_hw(depth.float(), out_hw, "linear", align_corners)
    if clamp is not None:
        d = torch.clamp(d, clamp[0], clamp[1])
    return d


def _frame_min(x: torch.Tensor) -> torch.Tensor:
    return x.amin(dim=(-2, -1), keepdim=True)


def _frame_max(x: torch.Tensor) -> torch.Tensor:
    return x.amax(dim=(-2, -1), keepdim=True)


def normalize_depth_for_viz(depth: torch.Tensor) -> torch.Tensor:
    """Relative-depth min-max normalization of each (H, W) frame to [0, 1]
    (reference ``Depth_Anything_V2/infer.py:116-117``)."""
    dmin = _frame_min(depth)
    dmax = _frame_max(depth)
    return (depth - dmin) / torch.clamp(dmax - dmin, min=1e-12)


def inverse_depth_normalize(
    depth: torch.Tensor, near: float = 0.1, far: float = 250.0
) -> torch.Tensor:
    """Metric-depth visualization: normalized inverse depth of each frame,
    clipped to the [near, far] range (reference ``onnx2trt.py:228-231``)."""
    inv = 1.0 / torch.clamp(depth, min=1e-12)
    max_inv = torch.clamp(_frame_max(inv), max=1.0 / near)
    min_inv = torch.clamp(_frame_min(inv), min=1.0 / far)
    return (inv - min_inv) / torch.clamp(max_inv - min_inv, min=1e-12)


def quantile_normalize(
    value: torch.Tensor, lo_q: float = 0.001, hi_q: float = 0.99
) -> torch.Tensor:
    """MoGe-style robust normalization by quantiles over the whole tensor
    (reference ``MoGe_2/infer.py:164-168``)."""
    flat = value.flatten().float()
    lo = torch.quantile(flat, lo_q).to(value.dtype)
    hi = torch.quantile(flat, hi_q).to(value.dtype)
    return torch.clamp((value - lo) / torch.clamp(hi - lo, min=1e-12), 0.0, 1.0)


def crop_pad(x: torch.Tensor, pad: Tuple[int, int, int, int]) -> torch.Tensor:
    """Remove (top, bottom, left, right) padding from (..., H, W)."""
    t, b, l, r = pad
    h, w = x.shape[-2], x.shape[-1]
    return x[..., t : h - b if b else h, l : w - r if r else w]
