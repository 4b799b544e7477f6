"""Turbo colormap on device (counterpart of the JAX package's
``ops/colormap.py``): a 256 x 3 table and one gather.

The table is embedded data (``ops/_turbo_data.py``), equal to matplotlib's
``turbo``; the port never builds it from matplotlib. ``spectral_colormap``
comes with the DINOv3 family.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from monocular_depth_estimation_trt_tpu_torch.ops._turbo_data import TURBO_RGB


@functools.lru_cache(maxsize=1)
def turbo_lut() -> np.ndarray:
    """(256, 3) float32 RGB table in [0, 1]; shared, do not write to it."""
    return np.asarray(TURBO_RGB, dtype=np.float32)


def turbo_colormap(norm01: torch.Tensor, as_uint8: bool = True) -> torch.Tensor:
    """Map (..., H, W) values in [0, 1] to turbo RGB (..., H, W, 3).

    Quantizes to uint8 indices first, as the reference's
    ``(depth_norm * 255).astype(uint8)`` then ``cmap(idx)``; both casts
    truncate, and the clamp keeps them in range.
    """
    lut = torch.from_numpy(turbo_lut()).to(norm01.device)
    idx = torch.clamp(norm01.float() * 255.0, 0.0, 255.0).to(torch.uint8)
    rgb = lut[idx.long()]
    if as_uint8:
        return (rgb * 255.0).to(torch.uint8)
    return rgb
