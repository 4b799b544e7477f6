"""MeFlow: memory-efficient flow through alternating 1D correlations
(counterpart of the JAX package's ``models/flow/meflow.py``).

Serving contract (reference ``MeFlow/``): a frame pair (B, 288, 512, 3) raw
0-255 -> ``flow_low`` (1/8) and ``flow_up`` (full size), 20 refinement steps
(``onnx_export.py:53-54``). RAFT-structured, as the reference wrapper's
forward (``MeFlow/wrapper.py:238-305``):

* ``fnet``/``cnet``: RAFT BasicEncoders (instance / batch norm);
* 1D window attention on the second frame's features per scale, after the
  average pools (``Attention1DOnnx``, wrapper.py:11-57, 249-259): a (2r+1)
  window softmax along one axis, keys and values as static shifts;
* the horizontal correlation samples the vertically attended features and
  the other way round (wrapper.py:261-262); each step concatenates both
  17-tap 1D profiles (34 channels) into one RAFT update block;
* learned 8x convex upsampling of the final flow.

The taps are 1-axis bilinear samples of three all-pairs correlation matrices
(full size and two pooled scales), computed once by fp32 matmuls and sampled
by hat weights. The window attention is plain, with its softmax in fp32.

``use_scan`` is kept for the artifact name (the ``scan1`` key): in the JAX
package it picks ``nn.scan`` over an unrolled loop; here both settings run
the same Python loop, captured whole in one graph.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from monocular_depth_estimation_trt_tpu_torch.models.flow.raft import (
    BasicEncoder,
    BasicUpdateBlock,
    coords_grid,
    nchw,
    nhwc,
    normalize_frames,
    upsample_flow_convex,
)
from monocular_depth_estimation_trt_tpu_torch.ops.flow_sampler import hat_weights


def _corr_matrix(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) x (B, h2, w2, C) -> (B*H*W, h2, w2) all-pairs
    correlation over sqrt(C), in fp32."""
    b, h, w, c = f1.shape
    _, h2, w2, _ = f2.shape
    corr = torch.matmul(f1.reshape(b, h * w, c).float(),
                        f2.reshape(b, h2 * w2, c).float().transpose(1, 2)) / math.sqrt(c)
    return corr.reshape(b * h * w, h2, w2)


_hat = hat_weights  # pos (n, T) -> hat weights (n, T, grid_size), zero outside


def corr_1d_lookup(corr: torch.Tensor, coords: torch.Tensor, offsets: torch.Tensor,
                   scale: float, horizontal: bool) -> torch.Tensor:
    """1D taps of a correlation slab set: corr (n, h2, w2); coords (B, H, W,
    2) at level 0; ``offsets`` (T,) along x (``horizontal``) or y, applied
    after the coordinates are divided by ``scale`` (the reference's ``x_base
    / 2 + delta``, wrapper.py:186-191). Returns (B, H, W, T)."""
    b, h, w, _ = coords.shape
    n = b * h * w
    c = coords.reshape(n, 2).float() / scale
    if horizontal:
        tx, ty = c[:, 0:1] + offsets[None, :], c[:, 1:2]
    else:
        tx, ty = c[:, 0:1], c[:, 1:2] + offsets[None, :]
    tmp = torch.bmm(_hat(corr.shape[1], ty), corr)  # (n, Ty, w2)
    out = torch.bmm(tmp, _hat(corr.shape[2], tx).transpose(1, 2))  # (n, Ty, Tx); one is 1
    return out.reshape(b, h, w, offsets.shape[0])


def meflow_corr(pyr: Tuple[torch.Tensor, torch.Tensor, torch.Tensor], coords: torch.Tensor,
                radius: int, horizontal: bool) -> torch.Tensor:
    """The 17-tap 1D correlation profile, in the reference's layout
    (``MeFlow/wrapper.py:219-228``): [first 2 of the 1/4 scale, first 2 of
    the 1/2 scale, the 2r+1 main taps, last 2 of 1/2, last 2 of 1/4]."""
    c0, c1, c2 = pyr
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    ends = torch.cat([d[0:2], d[-2:]])
    main = corr_1d_lookup(c0, coords, d, 1.0, horizontal)
    d1 = corr_1d_lookup(c1, coords, ends, 2.0, horizontal)
    d2 = corr_1d_lookup(c2, coords, ends, 4.0, horizontal)
    return torch.cat([d2[..., 0:2], d1[..., 0:2], main, d1[..., 2:4], d2[..., 2:4]], dim=-1)


class Window1DAttention(nn.Module):
    """1D window self-attention (reference ``Attention1DOnnx``): each query
    attends to the (2r+1) zero-padded keys around it along one axis; the
    values are the raw feature windows. NCHW in and out."""

    def __init__(self, channels: int, horizontal: bool = True, r: int = 4):
        super().__init__()
        self.channels = channels
        self.horizontal = horizontal
        self.r = r
        self.query_conv = nn.Conv2d(channels, channels, 1)
        self.key_conv = nn.Conv2d(channels, channels, 1)

    def _windows(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) -> (B, C, H, W, 2r+1), zero-padded shifts."""
        r, (h, w) = self.r, x.shape[-2:]
        if self.horizontal:
            p = F.pad(x, (r, r, 0, 0))
            return torch.stack([p[..., i: i + w] for i in range(2 * r + 1)], dim=-1)
        p = F.pad(x, (0, 0, r, r))
        return torch.stack([p[..., i: i + h, :] for i in range(2 * r + 1)], dim=-1)

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        q = self.query_conv(feature)
        k_win = self._windows(self.key_conv(feature))
        scores = torch.einsum("bchw,bchwt->bhwt", q, k_win).float() / math.sqrt(self.channels)
        p = torch.softmax(scores, dim=-1).to(feature.dtype)
        return torch.einsum("bhwt,bchwt->bchw", p, self._windows(feature))


class MeFlow(nn.Module):
    """``forward(image1, image2)``: raw 0-255 (B, H, W, 3), H and W multiples
    of 32 -> (flow_low (B, H/8, W/8, 2), flow_up (B, H, W, 2)), fp32."""

    def __init__(self, iters: int = 20, dim: int = 128, radius: int = 4,
                 use_scan: bool = False):
        super().__init__()
        self.iters = iters
        self.dim = dim
        self.radius = radius
        self.use_scan = use_scan  # the artifact key only (module docstring)
        self.fnet = BasicEncoder(128, "instance")
        self.cnet = BasicEncoder(2 * dim, "batch")
        self.attn_h = Window1DAttention(128, True, radius)
        self.attn_v = Window1DAttention(128, False, radius)
        self.update_block = BasicUpdateBlock(dim, 2 * (2 * radius + 1 + 8))

    def forward(self, image1: torch.Tensor, image2: torch.Tensor):
        dtype = self.fnet.conv1.weight.dtype
        img1 = normalize_frames(image1, dtype)
        f1, f2 = self.fnet(torch.cat([img1, normalize_frames(image2, dtype)])).chunk(2)
        # the same attention modules at every scale, after the pools
        scales = (f2, F.avg_pool2d(f2, 2), F.avg_pool2d(F.avg_pool2d(f2, 2), 2))
        f1_t = nhwc(f1)
        # the horizontal correlation reads the vertically attended features
        pyr_h = tuple(_corr_matrix(f1_t, nhwc(self.attn_v(s))) for s in scales)
        pyr_v = tuple(_corr_matrix(f1_t, nhwc(self.attn_h(s))) for s in scales)

        net, inp = self.cnet(img1).chunk(2, dim=1)
        net, inp = torch.tanh(net), F.relu(inp)

        b, _, h8, w8 = f1.shape
        coords0 = coords_grid(b, h8, w8, device=image1.device)
        flow = torch.zeros_like(coords0)
        for _ in range(self.iters):
            coords = coords0 + flow
            corr = torch.cat([meflow_corr(pyr_h, coords, self.radius, True),
                              meflow_corr(pyr_v, coords, self.radius, False)], dim=-1)
            net, delta = self.update_block(net, inp, nchw(corr.to(dtype)), nchw(flow.to(dtype)))
            flow = flow + nhwc(delta).float()
        mask = nhwc(self.update_block.upsample_mask(net)).float()
        return flow, upsample_flow_convex(flow, mask)
