"""Optical-flow visualization: the Middlebury color wheel (counterpart of the
JAX package's ``ops/flow_viz.py``).

The reference encodes RAFT / NeuFlow / MeFlow / MEMFOF MP4 outputs with the
standard ``flow_viz`` color wheel (``RAFT/onnx2trt.py:150-196``; Baker et
al., "A Database and Evaluation Methodology for Optical Flow"). Here it runs
on the flow's device: the wheel is a device-cached (55, 3) table, the rest
elementwise, so it can sit inside a captured engine.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from monocular_depth_estimation_trt_tpu_torch.ops.constants import device_cached


@functools.lru_cache(maxsize=1)
def color_wheel() -> np.ndarray:
    """(55, 3) RGB color wheel in 0-255; shared, do not write to it."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col: col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col: col + YG, 1] = 255
    col += YG
    wheel[col: col + GC, 1] = 255
    wheel[col: col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col: col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col: col + CB, 2] = 255
    col += CB
    wheel[col: col + BM, 2] = 255
    wheel[col: col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col: col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col: col + MR, 0] = 255
    return wheel.astype(np.float32)


@device_cached
def _wheel_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(color_wheel() / 255.0).to(device)


def flow_to_color(flow: torch.Tensor, clip: Optional[float] = None) -> torch.Tensor:
    """(H, W, 2) flow -> (H, W, 3) uint8 RGB, normalized by the largest
    magnitude: hue from the direction (the wheel indexed by ``floor`` and
    blended with the next entry), white toward zero motion, and the
    reference's truncating ``(col * 255)`` cast to uint8."""
    u = flow[..., 0].float()
    v = flow[..., 1].float()
    if clip is not None:
        u = torch.clamp(u, -clip, clip)
        v = torch.clamp(v, -clip, clip)
    rad = torch.sqrt(u * u + v * v)
    rad_max = torch.clamp(rad.max(), min=1e-5)
    u = u / rad_max
    v = v / rad_max
    rad = rad / rad_max

    wheel = _wheel_on(flow.device)
    ncols = wheel.shape[0]
    a = torch.atan2(-v, -u) / math.pi  # [-1, 1]
    fk = (a + 1.0) / 2.0 * (ncols - 1)
    k0 = torch.floor(fk).long()
    k1 = (k0 + 1) % ncols
    f = (fk - k0)[..., None]
    col = (1.0 - f) * wheel[k0] + f * wheel[k1]
    col = 1.0 - rad[..., None] * (1.0 - col)  # saturate toward white for small motion
    return (col * 255.0).to(torch.uint8)
