"""Turbo and Spectral colormaps on device (counterpart of the JAX package's
``ops/colormap.py``): a 256 x 3 table and one gather.

The tables are embedded data (``ops/_turbo_data.py``, ``ops/_spectral_data.py``),
equal to matplotlib's ``turbo`` and ``Spectral``; the port never builds them
from matplotlib.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from monocular_depth_estimation_trt_tpu_torch.ops._spectral_data import SPECTRAL_RGB
from monocular_depth_estimation_trt_tpu_torch.ops._turbo_data import TURBO_RGB
from monocular_depth_estimation_trt_tpu_torch.ops.constants import device_cached


@functools.lru_cache(maxsize=1)
def turbo_lut() -> np.ndarray:
    """(256, 3) float32 RGB table in [0, 1]; shared, do not write to it."""
    return np.asarray(TURBO_RGB, dtype=np.float32)


@functools.lru_cache(maxsize=1)
def spectral_lut() -> np.ndarray:
    """(256, 3) float32 RGB table in [0, 1] of matplotlib's ``Spectral`` (the
    DINOv3 depther figures' colormap); shared, do not write to it."""
    return np.asarray(SPECTRAL_RGB, dtype=np.float32)


@device_cached
def _lut_on(name: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy({"turbo": turbo_lut, "spectral": spectral_lut}[name]()).to(device)


def _colormap(name: str, norm01: torch.Tensor, as_uint8: bool) -> torch.Tensor:
    """Quantize to uint8 indices first, as the reference's
    ``(depth_norm * 255).astype(uint8)`` then ``cmap(idx)``; both casts
    truncate, and the clamp keeps them in range."""
    lut = _lut_on(name, norm01.device)
    idx = torch.clamp(norm01.float() * 255.0, 0.0, 255.0).to(torch.uint8)
    rgb = lut[idx.long()]
    if as_uint8:
        return (rgb * 255.0).to(torch.uint8)
    return rgb


def turbo_colormap(norm01: torch.Tensor, as_uint8: bool = True) -> torch.Tensor:
    """Map (..., H, W) values in [0, 1] to turbo RGB (..., H, W, 3)."""
    return _colormap("turbo", norm01, as_uint8)


def spectral_colormap(norm01: torch.Tensor, as_uint8: bool = True) -> torch.Tensor:
    """Map (..., H, W) values in [0, 1] to Spectral RGB (..., H, W, 3), by
    the same uint8 quantization as :func:`turbo_colormap`."""
    return _colormap("spectral", norm01, as_uint8)
