"""Bilinear sampling and correlation lookups for optical flow (counterpart of
the JAX package's ``ops/flow_sampler.py``).

The reference replaces ``grid_sample`` with a gather-based bilinear sampler
(``RAFT/wrapper.py:11-70``): four gathers and a weighted sum, samples
outside the image contributing zero. :func:`bilinear_sample_nhwc` is that
formulation with ``torch.gather``. The layouts are the JAX package's,
channels-last: feature maps ``(B, H, W, C)``, pixel coordinates
``(B, H, W, 2)`` as (x, y), a correlation pyramid level ``(B*H*W, h2, w2,
1)``.

The all-pairs correlation is one fp32 ``torch.matmul``; the window lookup
comes in the gather form (:func:`corr_lookup`, the reference's) and the
separable hat-weight form (:func:`corr_lookup_separable`, two batched
matmuls a level, what RAFT, NeuFlow and MEMFOF run). Both give the same
taps in the same order.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def bilinear_sample_nhwc(fmap: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample ``fmap`` (B, H, W, C) at pixel coordinates ``x``/``y`` (B, ...).

    Returns (B, ..., C). Out-of-range samples contribute zero (the
    reference's validity-mask semantics, ``RAFT/wrapper.py:36-70``)."""
    b, h, w, c = fmap.shape
    out_shape = x.shape[1:]
    xf = x.reshape(b, -1)
    yf = y.reshape(b, -1)

    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    wx = xf - x0
    wy = yf - y0
    weights = ((1.0 - wx) * (1.0 - wy), wx * (1.0 - wy), (1.0 - wx) * wy, wx * wy)

    def valid(v, size):
        return (v >= 0) & (v <= size - 1)

    def index(v, size):
        return torch.clamp(v, 0, size - 1).long()

    flat = fmap.reshape(b, h * w, c)
    out = None
    for (yv, xv), wt in zip(((y0, x0), (y0, x1), (y1, x0), (y1, x1)), weights):
        idx = index(yv, h) * w + index(xv, w)  # (B, N)
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))  # (B, N, C)
        m = (valid(xv, w) & valid(yv, h)).to(fmap.dtype)[..., None]
        term = v * wt[..., None].to(fmap.dtype) * m
        out = term if out is None else out + term
    return out.reshape(b, *out_shape, c)


def avg_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H//2, W//2, C), 2x2 mean (an odd trailing row or
    column dropped, as torch's ``avg_pool2d(2, 2)``)."""
    b, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    x = x[:, : h2 * 2, : w2 * 2]
    return x.reshape(b, h2, 2, w2, 2, c).mean(dim=(2, 4))


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = 4) -> Tuple[torch.Tensor, ...]:
    """All-pairs correlation pyramid from (B, H, W, C) feature maps (the
    ``CorrBlockONNX`` construction, ``RAFT/wrapper.py:72-85,117-126``): one
    fp32 matmul scaled by 1/sqrt(C), then a chain of 2x2 average pools.
    Returns per level (B*H*W, h2, w2, 1)."""
    b, h, w, c = fmap1.shape
    corr = torch.matmul(fmap1.reshape(b, h * w, c).float(),
                        fmap2.reshape(b, h * w, c).float().transpose(1, 2)) / math.sqrt(c)
    corr = corr.reshape(b * h * w, h, w, 1)  # (b*h1*w1) as batch, (h2, w2) spatial
    pyramid = [corr]
    for _ in range(num_levels - 1):
        corr = avg_pool2x2(corr)
        pyramid.append(corr)
    return tuple(pyramid)


def corr_lookup(pyramid: Tuple[torch.Tensor, ...], coords: torch.Tensor,
                radius: int = 4) -> torch.Tensor:
    """Windowed pyramid lookup, the gather form: coords (B, H, W, 2) (x, y)
    at level 0 -> (B, H, W, L*(2r+1)^2) (``RAFT/wrapper.py:87-115``).

    Tap order (RAFT's): x takes the offset of tap axis 0, y that of tap axis
    1 (``RAFT/wrapper.py:96-108``), so that the channels match pretrained
    update blocks."""
    r = radius
    t = 2 * r + 1
    b, h, w, _ = coords.shape
    n = b * h * w
    d = torch.arange(-r, r + 1, dtype=coords.dtype, device=coords.device)
    off0, off1 = torch.meshgrid(d, d, indexing="ij")
    out = []
    for lvl, corr in enumerate(pyramid):
        centroid = coords.reshape(n, 1, 1, 2) / (2.0 ** lvl)
        xg = centroid[..., 0] + off0[None]
        yg = centroid[..., 1] + off1[None]
        sampled = bilinear_sample_nhwc(corr, xg, yg)  # (n, T, T, 1)
        out.append(sampled.reshape(b, h, w, t * t))
    return torch.cat(out, dim=-1)


def hat_weights(grid_size: int, pos: torch.Tensor) -> torch.Tensor:
    """pos (n, T) -> linear-interpolation weights (n, T, grid_size):
    ``relu(1 - |i - pos|)``, zero outside the grid."""
    g = torch.arange(grid_size, dtype=torch.float32, device=pos.device)
    return torch.clamp(1.0 - torch.abs(g[None, None, :] - pos[:, :, None]), min=0.0)


def corr_lookup_separable(pyramid: Tuple[torch.Tensor, ...], coords: torch.Tensor,
                          radius: int = 4) -> torch.Tensor:
    """:func:`corr_lookup` without gathers, the same taps in the same order.

    Bilinear sampling of a regular (2r+1)^2 window is separable: per pixel
    ``p`` with correlation slab ``C_p`` (h2, w2), the window is ``Rx_p (T,
    w2) @ (Ry_p (T, h2) @ C_p)^T`` with hat-weight rows ``R[t, i] = relu(1 -
    |i - (c + d_t)|)``, zero outside the slab (the zero-padded out-of-range
    semantics). Two batched matmuls a level, in fp32."""
    r = radius
    t = 2 * r + 1
    b, h, w, _ = coords.shape
    n = b * h * w
    d = torch.arange(-r, r + 1, dtype=torch.float32, device=coords.device)
    out = []
    for lvl, corr in enumerate(pyramid):
        c = coords.reshape(n, 2).float() / (2.0 ** lvl)
        ry = hat_weights(corr.shape[1], c[:, 1:2] + d[None, :])  # (n, T, h2)
        rx = hat_weights(corr.shape[2], c[:, 0:1] + d[None, :])  # (n, T, w2)
        tmp = torch.bmm(ry, corr[..., 0])  # (n, y-tap, w2)
        win = torch.bmm(rx, tmp.transpose(1, 2))  # (n, x-tap (axis 0), y-tap (axis 1))
        out.append(win.reshape(b, h, w, t * t))
    return torch.cat(out, dim=-1)


class CorrPyramid:
    """:func:`build_corr_pyramid` with :func:`corr_lookup`."""

    def __init__(self, fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4,
                 radius: int = 4):
        self.radius = radius
        self.pyramid = build_corr_pyramid(fmap1, fmap2, num_levels)

    def lookup(self, coords: torch.Tensor) -> torch.Tensor:
        return corr_lookup(self.pyramid, coords, self.radius)
