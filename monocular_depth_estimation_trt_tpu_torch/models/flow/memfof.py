"""MEMFOF: memory-efficient three-frame bidirectional optical flow
(counterpart of the JAX package's ``models/flow/memfof.py``).

Serving contract (reference ``MEMFOF/wrapper.py:136-293``): a frame triplet
(B, 3, H, W, 3) raw 0-255 -> bidirectional flow (B, 2, H, W, 2), center to
previous and center to next (``onnx2trt.py:140``), refined ``iters=8`` times
at 1/16 with 16x learned convex upsampling, plus the encoder feature-map
cache that a video reuses across steps (``wrapper.py:210-232,277-281``).
SEA-RAFT at 1/16 with GMA attention, as the wrapper's forward:

* ``cnet`` over the channel-concatenated triplet (9 channels) ->
  ``init_conv`` -> split (net, context), no activations;
* ``att``: one-head GMA attention map from the context, once;
* the first prediction from ``flow_head(net)``: 12 channels, [flow21 (2),
  info21 (4), flow23 (2), info23 (4)];
* ``fnet`` per frame at 1/16, or the cached maps; two 4-level radius-4
  correlation pyramids (center -> previous, center -> next);
* per step: both windows and both flows -> ``update_block`` (motion
  encoder, GMA aggregation, SepConvGRU), then the ``flow_head`` deltas;
* two 16x convex upsamplings from the halves of ``0.25 *
  upsample_weight(net)``.

The GMA attention and its aggregation are plain matmuls with an fp32
softmax, in the JAX package's order. Module names are the layout of
``weights/manifests/memfof.json``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from monocular_depth_estimation_trt_tpu_torch.models.flow.raft import (
    BasicEncoder,
    BasicMotionEncoder,
    SepConvGRU,
    convex_upsample,
    coords_grid,
    nchw,
    nhwc,
)
from monocular_depth_estimation_trt_tpu_torch.ops.flow_sampler import (
    build_corr_pyramid,
    corr_lookup_separable,
)

UPSAMPLE = 16  # the flow grid's stride


def upsample_convex_16(x: torch.Tensor, mask: torch.Tensor,
                       scale_values: float = 16.0) -> torch.Tensor:
    """16x learned convex upsampling, channels-last: x (B, h, w, C), mask
    (B, h, w, 9*256) -> (B, 16h, 16w, C), the values scaled by
    ``scale_values`` (16 for a flow, 1 for its uncertainty)."""
    return convex_upsample(x, mask, UPSAMPLE, scale_values)


class Down16Encoder(nn.Module):
    """A BasicEncoder to 1/8 and one more stride-2 conv: NCHW to 1/16."""

    def __init__(self, output_dim: int = 256, norm: str = "instance", in_ch: int = 3):
        super().__init__()
        self.enc8 = BasicEncoder(output_dim, norm, in_ch)
        self.down = nn.Conv2d(output_dim, output_dim, 3, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(self.enc8(x))


class GMAAttention(nn.Module):
    """One-head GMA attention map of the context (the wrapper's
    ``self.att(context)``): (B, N, N) fp32."""

    def __init__(self, dim: int = 128, dim_head: int = 128):
        super().__init__()
        self.dim_head = dim_head
        self.to_q = nn.Linear(dim, dim_head, bias=False)
        self.to_k = nn.Linear(dim, dim_head, bias=False)

    def forward(self, context: torch.Tensor) -> torch.Tensor:
        t = context.flatten(2).transpose(1, 2)  # (B, N, C)
        s = torch.matmul(self.to_q(t), self.to_k(t).transpose(1, 2)).float()
        return torch.softmax(s / math.sqrt(self.dim_head), dim=-1)


class MEMFOFUpdateBlock(nn.Module):
    """``update_block(net, context, corr, flow, attention)``: the motion
    encoder over both directions, GMA global aggregation of the motion
    features (``motion + gamma * attention @ to_v(motion)``), SepConvGRU."""

    def __init__(self, dim: int = 128, cor_planes: int = 2 * 4 * 81):
        super().__init__()
        self.encoder = BasicMotionEncoder(cor_planes, flow_ch=4)
        self.aggregator_to_v = nn.Linear(128, 128, bias=False)
        self.aggregator_gamma = nn.Parameter(torch.zeros(1))
        self.gru = SepConvGRU(dim, dim + 2 * 128)

    def init_constants_(self) -> None:
        """gamma's initial value, 0 (random weights: ``weights/store.py``)."""
        with torch.no_grad():
            self.aggregator_gamma.zero_()

    def forward(self, net, context, corr, flow, attention):
        motion = self.encoder(flow, corr)
        b, c, h, w = motion.shape
        v = self.aggregator_to_v(motion.flatten(2).transpose(1, 2))  # (B, N, C)
        glob = torch.matmul(attention.to(v.dtype), v).transpose(1, 2).reshape(b, c, h, w)
        motion_global = motion + self.aggregator_gamma.to(motion.dtype) * glob
        return self.gru(net, torch.cat([context, motion, motion_global], dim=1))


class MEMFOF(nn.Module):
    """``forward(images, fmap_cache=None)``: images (B, 3, H, W, 3) raw
    0-255, H and W multiples of 16 -> dict of ``flow`` (B, 2, H, W, 2),
    ``info`` (B, 2, H, W, 4), fp32, and ``fmap_cache``, the three frames'
    1/16 feature maps (B, 256, H/16, W/16) NCHW. ``fmap_cache``: three maps
    or None each; only the missing ones are encoded."""

    def __init__(self, iters: int = 8, dim: int = 128, corr_levels: int = 4,
                 corr_radius: int = 4):
        super().__init__()
        self.iters = iters
        self.dim = dim
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.cnet = Down16Encoder(256, "instance", in_ch=9)
        self.init_conv = nn.Conv2d(256, 2 * dim, 3, 1, 1)
        self.att = GMAAttention(dim, dim)
        self.fnet = Down16Encoder(256, "instance")
        self.update_block = MEMFOFUpdateBlock(dim, 2 * corr_levels * (2 * corr_radius + 1) ** 2)
        self.flow_head = nn.Sequential(nn.Conv2d(dim, 256, 3, 1, 1), nn.ReLU(),
                                       nn.Conv2d(256, 12, 3, 1, 1))
        self.upsample_weight = nn.Sequential(nn.Conv2d(dim, 256, 3, 1, 1), nn.ReLU(),
                                             nn.Conv2d(256, 2 * 256 * 9, 1))

    def forward(self, images: torch.Tensor,
                fmap_cache: Optional[Sequence[Optional[torch.Tensor]]] = None):
        dtype = self.init_conv.weight.dtype
        b, _, hh, ww, _ = images.shape
        x = 2.0 * (images.to(dtype) / 255.0) - 1.0

        # context over the concatenated triplet (wrapper.py:185-187; no activation)
        cnet = self.init_conv(self.cnet(nchw(torch.cat([x[:, 0], x[:, 1], x[:, 2]], dim=-1))))
        net, context = cnet.split([self.dim, cnet.shape[1] - self.dim], dim=1)
        attention = self.att(context)

        def flow_head(n):
            return nhwc(self.flow_head(n)).float()  # (B, h, w, 12)

        fu = flow_head(net)  # the first prediction (wrapper.py:191-198)
        flow21, flow23 = fu[..., 0:2], fu[..., 6:8]

        # the feature net per frame, only where the cache has no map
        # (wrapper.py:210-232)
        cache = list(fmap_cache) if fmap_cache is not None else [None, None, None]
        missing = [i for i in range(3) if cache[i] is None]
        if missing:
            frames = torch.stack([x[:, i] for i in missing], dim=1)
            fm = self.fnet(nchw(frames.reshape(b * len(missing), hh, ww, 3)))
            fm = fm.reshape(b, len(missing), *fm.shape[1:])
            for j, i in enumerate(missing):
                cache[i] = fm[:, j]
        f1, f2, f3 = cache
        pyr21 = build_corr_pyramid(nhwc(f2), nhwc(f1), self.corr_levels)
        pyr23 = build_corr_pyramid(nhwc(f2), nhwc(f3), self.corr_levels)

        coords0 = coords_grid(b, f2.shape[2], f2.shape[3], device=images.device)
        for _ in range(self.iters):
            corr = torch.cat([corr_lookup_separable(pyr21, coords0 + flow21, self.corr_radius),
                              corr_lookup_separable(pyr23, coords0 + flow23, self.corr_radius)],
                             dim=-1)
            flow16 = torch.cat([flow21, flow23], dim=-1)
            net = self.update_block(net, context, nchw(corr.to(dtype)), nchw(flow16.to(dtype)),
                                    attention)
            fu = flow_head(net)
            flow21 = flow21 + fu[..., 0:2]
            flow23 = flow23 + fu[..., 6:8]
        info21, info23 = fu[..., 2:6], fu[..., 8:12]

        w16x = 0.25 * nhwc(self.upsample_weight(net)).float()
        m21, m23 = w16x[..., : 256 * 9], w16x[..., 256 * 9:]
        return {
            "flow": torch.stack([upsample_convex_16(flow21, m21),
                                 upsample_convex_16(flow23, m23)], dim=1),
            "info": torch.stack([upsample_convex_16(info21, m21, 1.0),
                                 upsample_convex_16(info23, m23, 1.0)], dim=1),
            "fmap_cache": (f1, f2, f3),
        }
