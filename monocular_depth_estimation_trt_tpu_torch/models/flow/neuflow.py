"""NeuFlow v2: global matching + lightweight refinement (counterpart of the
JAX package's ``models/flow/neuflow.py``).

Serving contract (reference ``NeuFlow/``): a frame pair (B, 288, 512, 3) raw
0-255 -> ``flow`` (B, 288, 512, 2) (``onnx_export.py:65-66``). The JAX
package's reconstruction: a double-conv backbone to 1/8 and 1/16 (dim 128),
one bidirectional cross-attention layer at 1/16, global matching by the
softmax-correlation expectation, ConvGRU refinement at 1/16 and at 1/8 (8
steps each, single-level radius-4 correlation, ``NeuFlow/wrapper.py:70-125``),
learned 8x convex upsampling.

The cross-attention and the global matching are plain matmuls with an fp32
softmax, in the JAX package's order. Module names are the layout of
``weights/manifests/neuflow.json`` (the GRU's ``convz``/``convr`` split, the
GroupNorms' ``weight``/``bias``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from monocular_depth_estimation_trt_tpu_torch.models.flow.raft import (
    SepConvGRU,
    coords_grid,
    nchw,
    nhwc,
    normalize_frames,
    upsample_flow_convex,
)
from monocular_depth_estimation_trt_tpu_torch.ops.flow_sampler import (
    build_corr_pyramid,
    corr_lookup_separable,
)


class ConvBlock(nn.Module):
    """conv-GroupNorm(8)-relu twice; the first conv strided."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, features, 3, stride, 1)
        self.norm1 = nn.GroupNorm(8, features, eps=1e-5)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1)
        self.norm2 = nn.GroupNorm(8, features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm1(self.conv1(x)))
        return F.relu(self.norm2(self.conv2(x)))


class Backbone(nn.Module):
    """1/8 and 1/16 feature maps, NCHW."""

    def __init__(self, dim: int = 128):
        super().__init__()
        self.block1 = ConvBlock(3, 64, 2)
        self.block2 = ConvBlock(64, 96, 2)
        self.block8 = ConvBlock(96, dim, 2)
        self.block16 = ConvBlock(dim, dim, 2)

    def forward(self, x: torch.Tensor):
        f8 = self.block8(self.block2(self.block1(x)))
        return f8, self.block16(f8)


class CrossAttention(nn.Module):
    """One bidirectional cross-attention layer at 1/16: each view's tokens
    attend to the other view's; a residual and a LayerNorm. NCHW in and out;
    the scores and softmax in fp32, P cast to V's dtype before P·V."""

    def __init__(self, dim: int = 128):
        super().__init__()
        self.dim = dim
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def attend(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        xt = x.flatten(2).transpose(1, 2)  # (B, N, C)
        ct = ctx.flatten(2).transpose(1, 2)
        cv = self.v(ct)
        s = torch.matmul(self.q(xt), self.k(ct).transpose(1, 2)).float() / math.sqrt(self.dim)
        o = torch.matmul(torch.softmax(s, dim=-1).to(cv.dtype), cv)
        y = self.norm(xt + self.proj(o))
        return y.transpose(1, 2).reshape(b, c, h, w)

    def forward(self, fa: torch.Tensor, fb: torch.Tensor):
        return self.attend(fa, fb), self.attend(fb, fa)


class RefineStage(nn.Module):
    """ConvGRU refinement at one scale on a single-level radius-r
    correlation (the wrapper's ``CorrBlockONNX(radius=4, levels=1)``)."""

    def __init__(self, dim: int = 128, iters: int = 8, radius: int = 4):
        super().__init__()
        self.iters = iters
        self.radius = radius
        self.init = nn.Conv2d(dim, dim, 3, 1, 1)
        self.gru = SepConvGRU(dim, dim)
        self.enc = nn.Conv2d((2 * radius + 1) ** 2 + 2, dim, 1)
        self.head1 = nn.Conv2d(dim, 256, 3, 1, 1)
        self.head2 = nn.Conv2d(256, 2, 3, 1, 1)

    def forward(self, f1: torch.Tensor, pyr, flow: torch.Tensor):
        """f1 NCHW, flow (B, h, w, 2) fp32 -> (hidden state, refined flow)."""
        b, _, h, w = f1.shape
        dtype = f1.dtype
        coords0 = coords_grid(b, h, w, device=f1.device)
        net = torch.tanh(self.init(f1))
        for _ in range(self.iters):
            corr = corr_lookup_separable(pyr, coords0 + flow, self.radius)
            inp = nchw(torch.cat([corr.to(dtype), flow.to(dtype)], dim=-1))
            net = self.gru(net, self.enc(inp))
            flow = flow + nhwc(self.head2(F.relu(self.head1(net)))).float()
        return net, flow


class NeuFlow(nn.Module):
    """``forward(image1, image2)``: raw 0-255 (B, H, W, 3), H and W multiples
    of 16 -> flow (B, H, W, 2)."""

    def __init__(self, dim: int = 128, refine_iters_16: int = 8, refine_iters_8: int = 8,
                 radius: int = 4):
        super().__init__()
        self.backbone = Backbone(dim)
        self.cross_attn = CrossAttention(dim)
        self.refine16 = RefineStage(dim, refine_iters_16, radius)
        self.merge8 = nn.Conv2d(dim, dim, 3, 1, 1)
        self.refine8 = RefineStage(dim, refine_iters_8, radius)
        self.mask8 = nn.Conv2d(dim, 64 * 9, 1)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor) -> torch.Tensor:
        dtype = self.merge8.weight.dtype
        both = torch.cat([normalize_frames(image1, dtype), normalize_frames(image2, dtype)])
        f8, f16 = self.backbone(both)
        f8_1, f8_2 = f8.chunk(2)
        f16_1, f16_2 = self.cross_attn(*f16.chunk(2))
        b, c, h16, w16 = f16_1.shape

        # global matching at 1/16: the softmax-correlation expectation
        fa = f16_1.flatten(2).transpose(1, 2)
        fb = f16_2.flatten(2).transpose(1, 2)
        corr = torch.matmul(fa, fb.transpose(1, 2)).float() / math.sqrt(c)
        grid = coords_grid(b, h16, w16, device=image1.device).reshape(b, h16 * w16, 2)
        matched = torch.matmul(torch.softmax(corr, dim=-1), grid)
        flow16 = (matched - grid).reshape(b, h16, w16, 2)

        # refinement at 1/16 (single-level corr, r=4: NeuFlow/wrapper.py:121-125)
        pyr16 = build_corr_pyramid(nhwc(f16_1), nhwc(f16_2), num_levels=1)
        _, flow16 = self.refine16(f16_1, pyr16, flow16)

        # upsample to 1/8 (half-pixel bilinear), merge with the 1/8 features
        h8, w8 = f8_1.shape[-2:]
        flow8 = 2.0 * nhwc(F.interpolate(nchw(flow16), size=(h8, w8), mode="bilinear",
                                         align_corners=False))
        merged = F.relu(self.merge8(f8_1))
        pyr8 = build_corr_pyramid(nhwc(f8_1), nhwc(f8_2), num_levels=1)
        net8, flow8 = self.refine8(merged, pyr8, flow8)
        mask = 0.25 * self.mask8(net8)
        return upsample_flow_convex(flow8, nhwc(mask).float())
