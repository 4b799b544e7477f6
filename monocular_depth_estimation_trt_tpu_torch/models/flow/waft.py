"""WAFT: Warping-Alone Field Transforms for optical flow (counterpart of the
JAX package's ``models/flow/waft.py``).

The reference (``later/WAFT/``, upstream princeton-vl/WAFT,
arXiv:2506.21526) replaces RAFT's correlation volume by warping: each
refinement step warps the second frame's features by the current flow and
feeds the warped and target features to a recurrent update block, over a
DINOv2 backbone. The JAX package's reconstruction, kept here:

* the backbone, the port's ``models/vit.py::DinoViT``, over both frames in
  one batch, its layers ``depth/2 - 1`` and ``depth - 1`` concatenated: at
  ViT-S 280x504 two frames of 721 tokens through the packed-qkv attention
  kernel K1, (2, 721, 6 heads), 12 launches;
* feature and context necks: a 1x1 projection and a 2x transposed conv to a
  1/7 grid of 128 channels (features: both frames; context: the first,
  split into the GRU state and its input);
* per step, no correlation volume: ``f2`` warped by the flow through the
  zero-padded bilinear sampler (``ops/flow_sampler.py``), ``[f1, warped,
  f1 * warped, flow]`` -> two convs -> SepConvGRU -> delta flow;
* the convex-upsampling mask from the last step's hidden state, learned 7x
  upsampling to the input size.

Module names are the layout of ``weights/manifests/waft_vits.json``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from monocular_depth_estimation_trt_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from monocular_depth_estimation_trt_tpu_torch.models.flow.raft import (
    SepConvGRU,
    convex_upsample,
    coords_grid,
    nchw,
    nhwc,
)
from monocular_depth_estimation_trt_tpu_torch.models.vit import VIT_CONFIGS, DinoViT, ViTConfig
from monocular_depth_estimation_trt_tpu_torch.ops.flow_sampler import bilinear_sample_nhwc
from monocular_depth_estimation_trt_tpu_torch.ops.preprocess import normalize

UP = 7  # the flow grid's stride: ViT patch 14 / the 2x transposed conv


def upsample_flow_convex_k(flow: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """Learned convex k-fold upsampling (RAFT's ``upsample_flow``
    generalized): flow (B, h, w, 2), mask (B, h, w, 9*k*k) -> (B, k*h, k*w,
    2)."""
    return convex_upsample(flow, mask, k, float(k))


class WarpUpdateBlock(nn.Module):
    """One warp-refine update: motion features of the warped feature pair
    (no cost volume) -> SepConvGRU -> delta flow; ``upsample_mask(net)``
    the convex-mask head (upstream computes it every step, the last one
    counts)."""

    def __init__(self, hidden: int = 128, feat: int = 128):
        super().__init__()
        self.enc_conv1 = nn.Conv2d(3 * feat + 2, 192, 3, 1, 1)
        self.enc_conv2 = nn.Conv2d(192, 126, 3, 1, 1)
        self.gru = SepConvGRU(hidden, hidden + 128)
        self.flow_head_conv1 = nn.Conv2d(hidden, 256, 3, 1, 1)
        self.flow_head_conv2 = nn.Conv2d(256, 2, 3, 1, 1)
        self.mask_conv0 = nn.Conv2d(hidden, 256, 3, 1, 1)
        self.mask_conv2 = nn.Conv2d(256, UP * UP * 9, 1)

    def forward(self, net, inp, f1, warped, flow):
        """NCHW; ``flow`` in the compute dtype -> (new state, delta flow)."""
        x = torch.cat([f1, warped, f1 * warped, flow], dim=1)
        m = F.relu(self.enc_conv2(F.relu(self.enc_conv1(x))))
        net = self.gru(net, torch.cat([inp, m, flow], dim=1))
        return net, self.flow_head_conv2(F.relu(self.flow_head_conv1(net)))

    def upsample_mask(self, net: torch.Tensor) -> torch.Tensor:
        return 0.25 * self.mask_conv2(F.relu(self.mask_conv0(net)))


class WAFT(nn.Module):
    """``forward(image1, image2)``: raw 0-255 (B, H, W, 3), H and W multiples
    of 14 -> (flow_low (B, H/7, W/7, 2), flow_up (B, H, W, 2)), fp32.
    ``vit_config``: a backbone override (tests)."""

    def __init__(self, iters: int = 8, hidden: int = 128, encoder: str = "vits",
                 attn_impl: str = "auto", vit_config: Optional[ViTConfig] = None):
        super().__init__()
        cfg = vit_config or VIT_CONFIGS[encoder]
        self.cfg = cfg
        self.iters = iters
        self.hidden = hidden
        self.pretrained = DinoViT(cfg, out_indices=(cfg.depth // 2 - 1, cfg.depth - 1),
                                  attn_impl=attn_impl)
        self.feat_proj = nn.Conv2d(2 * cfg.dim, 256, 1)
        self.feat_up = nn.ConvTranspose2d(256, 128, 2, 2)
        self.ctx_proj = nn.Conv2d(2 * cfg.dim, 256, 1)
        self.ctx_up = nn.ConvTranspose2d(256, 2 * hidden, 2, 2)
        self.update_block = WarpUpdateBlock(hidden)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor):
        b, hh, ww, _ = image1.shape
        ph, pw = hh // self.cfg.patch_size, ww // self.cfg.patch_size
        h, w = 2 * ph, 2 * pw
        dtype = self.feat_proj.weight.dtype

        x = normalize(torch.cat([image1, image2]).float() / 255.0, IMAGENET_MEAN, IMAGENET_STD)
        tok = torch.cat([t[0] for t in self.pretrained(x)], dim=-1)  # (2B, N, 2D)
        grid = nchw(tok.reshape(2 * b, ph, pw, tok.shape[-1]).to(dtype))
        f1, f2 = self.feat_up(self.feat_proj(grid)).chunk(2)
        ctx = self.ctx_up(self.ctx_proj(grid[:b]))
        net = torch.tanh(ctx[:, : self.hidden])
        inp = F.relu(ctx[:, self.hidden:])

        g = coords_grid(b, h, w, device=image1.device)
        gx, gy = g[..., 0], g[..., 1]
        f2_t = nhwc(f2).contiguous()  # the sampler's layout, once
        flow = torch.zeros((b, h, w, 2), dtype=torch.float32, device=image1.device)
        for _ in range(self.iters):
            warped = bilinear_sample_nhwc(f2_t, gx + flow[..., 0], gy + flow[..., 1])
            net, delta = self.update_block(net, inp, f1, nchw(warped.to(dtype)),
                                           nchw(flow.to(dtype)))
            flow = flow + nhwc(delta).float()
        mask = nhwc(self.update_block.upsample_mask(net)).float()
        return flow, upsample_flow_convex_k(flow, mask, UP)
