"""RAFT optical flow (counterpart of the JAX package's ``models/flow/raft.py``).

The reference's ONNX wrapper is the serving spec (``RAFT/wrapper.py:128-191``):
a raw 0-255 frame pair in, normalization in the graph, 20 recurrent
refinement steps, outputs ``flow_low`` (H/8, W/8, 2) and ``flow_up`` (H, W,
2). Standard RAFT (Teed & Deng, ECCV 2020): BasicEncoder feature and context
networks at 1/8, a 4-level correlation pyramid of radius 4
(``ops/flow_sampler.py``, the separable lookup), BasicMotionEncoder +
SepConvGRU update block, learned convex 8x upsampling.

Module names are the upstream layout of ``weights/manifests/raft.json``:
the GRU keeps upstream's separate ``convz*``/``convr*`` (the JAX module fuses
them into ``convzr*``, ``weights/from_jax.py`` splits it back), and the
context net's BatchNorm keeps upstream's ``weight``/``bias``/running
statistics (the JAX module holds the folded scale and bias).

Images come in channels-last, ``(B, H, W, 3)``, flows go out channels-last,
as in the JAX package; the convolutions run NCHW. The refinement steps are
a Python loop (one captured graph holds all of them); the convex-upsampling
mask is computed once, from the last step's hidden state, which is the mask
the JAX scan carries out of its last step.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from monocular_depth_estimation_trt_tpu_torch.ops.flow_sampler import (
    build_corr_pyramid,
    corr_lookup_separable,
)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def normalize_frames(image: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Raw 0-255 (B, H, W, 3) -> [-1, 1] in ``dtype``, NCHW (reference
    ``RAFT/wrapper.py:135-136``)."""
    return nchw(2.0 * (image.to(dtype) / 255.0) - 1.0)


class InstanceNorm(nn.Module):
    """``nn.InstanceNorm2d(affine=False)``: per sample and channel, no
    parameters; the statistics in fp32."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.instance_norm(x.float(), eps=self.eps).to(x.dtype)


class FoldedBatchNorm(nn.BatchNorm2d):
    """Inference BatchNorm with upstream's keys (``weight``, ``bias``,
    ``running_mean``, ``running_var``), applied as the JAX package's folded
    affine: ``scale = weight / sqrt(running_var + eps)``, ``bias - mean *
    scale``, folded in fp32 and applied in the input's dtype. The training
    counter ``num_batches_tracked`` is neither kept nor required: a
    checkpoint that carries it loads all the same."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__(features, eps=eps)
        self.num_batches_tracked = None

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        nn.Module._load_from_state_dict(self, state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        bias = self.bias.float() - self.running_mean.float() * scale
        return x * scale.to(x.dtype)[:, None, None] + bias.to(x.dtype)[:, None, None]


def _norm(kind: str, features: int) -> nn.Module:
    if kind == "instance":
        return InstanceNorm()
    if kind == "batch":
        return FoldedBatchNorm(features)
    return nn.Identity()


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm: str, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1)
        self.norm1 = _norm(norm, planes)
        self.norm2 = _norm(norm, planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride),
                                            _norm(norm, planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """Feature / context encoder to 1/8: a 7x7 stride-2 stem, three stages
    of two residual blocks (64, 96 and 128 wide; the last two stride 2), a
    1x1 projection to ``output_dim``. NCHW in and out."""

    def __init__(self, output_dim: int = 256, norm: str = "instance", in_ch: int = 3):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, 64, 7, 2, 3)
        self.norm1 = _norm(norm, 64)
        stages, prev = [], 64
        for planes, stride in ((64, 1), (96, 2), (128, 2)):
            stages.append(nn.Sequential(ResidualBlock(prev, planes, norm, stride),
                                        ResidualBlock(planes, planes, norm, 1)))
            prev = planes
        self.layer1, self.layer2, self.layer3 = stages
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class BasicMotionEncoder(nn.Module):
    """Correlation and flow features -> ``128 - flow_ch`` channels, with the
    flow appended (RAFT: 2 flow channels; MEMFOF's two directions: 4)."""

    def __init__(self, corr_planes: int = 4 * 81, flow_ch: int = 2):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, 1, 1)
        self.convf1 = nn.Conv2d(flow_ch, 128, 7, 1, 3)
        self.convf2 = nn.Conv2d(128, 64, 3, 1, 1)
        self.conv = nn.Conv2d(192 + 64, 128 - flow_ch, 3, 1, 1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([c, f], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    """RAFT's separable-kernel ConvGRU: a (1, 5) pass, then a (5, 1) pass,
    each with upstream's ``convz``/``convr``/``convq`` (the JAX module runs z
    and r as one conv; the same function)."""

    def __init__(self, hidden: int = 128, input_dim: int = 256):
        super().__init__()
        for tag, ks, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in ("z", "r", "q"):
                setattr(self, f"conv{gate}{tag}", nn.Conv2d(hidden + input_dim, hidden, ks, 1, pad))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for tag in ("1", "2"):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{tag}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{tag}")(hx))
            q = torch.tanh(getattr(self, f"convq{tag}")(torch.cat([r * h, x], dim=1)))
            h = (1.0 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, hidden: int = 128, mid: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(hidden, mid, 3, 1, 1)
        self.conv2 = nn.Conv2d(mid, 2, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    """Motion encoder + SepConvGRU + flow head; ``mask(net)`` is the convex
    upsampling mask head (scaled 0.25, as in RAFT)."""

    def __init__(self, hidden: int = 128, corr_planes: int = 4 * 81):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes)
        self.gru = SepConvGRU(hidden, 128 + hidden)
        self.flow_head = FlowHead(hidden)
        self.mask = nn.Sequential(nn.Conv2d(hidden, 256, 3, 1, 1), nn.ReLU(),
                                  nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow) -> Tuple[torch.Tensor, torch.Tensor]:
        """NCHW: hidden state, context input, correlation, flow -> (new
        hidden state, delta flow)."""
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, self.flow_head(net)

    def upsample_mask(self, net: torch.Tensor) -> torch.Tensor:
        return 0.25 * self.mask(net)


def coords_grid(b: int, h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(B, h, w, 2) pixel coordinates (x, y)."""
    y, x = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                          torch.arange(w, dtype=dtype, device=device), indexing="ij")
    return torch.stack([x, y], dim=-1)[None].expand(b, h, w, 2)


def convex_upsample(x: torch.Tensor, mask: torch.Tensor, k: int, scale: float) -> torch.Tensor:
    """Learned convex k-fold upsampling, channels-last: x (B, h, w, C), mask
    (B, h, w, 9*k*k) -> (B, k*h, k*w, C). The mask is tap-major (tap ``j``
    of the 3x3 neighbourhood, row-major, at channels ``[j*k*k, (j+1)*k*k)``);
    the softmax over the 9 taps runs in the mask's dtype, and the
    neighbours of ``scale * x`` (zero-padded) are weighted by it."""
    b, h, w, c = x.shape
    m = torch.softmax(mask.reshape(b, h, w, 9, k * k), dim=3)
    padded = F.pad(scale * x, (0, 0, 1, 1, 1, 1))
    patches = torch.stack([padded[:, dy: dy + h, dx: dx + w] for dy in range(3)
                           for dx in range(3)], dim=3)  # (B, h, w, 9, C)
    up = torch.einsum("bhwkq,bhwkc->bhwqc", m, patches.to(m.dtype))  # (B, h, w, k*k, C)
    up = up.reshape(b, h, w, k, k, c).permute(0, 1, 3, 2, 4, 5)
    return up.reshape(b, k * h, k * w, c)


def upsample_flow_convex(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """RAFT's ``upsample_flow``: flow (B, h, w, 2), mask (B, h, w, 576) ->
    (B, 8h, 8w, 2)."""
    return convex_upsample(flow, mask, 8, 8.0)


class RAFT(nn.Module):
    """``forward(image1, image2)``: raw 0-255 (B, H, W, 3), H and W multiples
    of 8 -> (flow_low (B, H/8, W/8, 2), flow_up (B, H, W, 2))."""

    def __init__(self, iters: int = 20, hidden_dim: int = 128, context_dim: int = 128,
                 corr_levels: int = 4, corr_radius: int = 4):
        super().__init__()
        self.iters = iters
        self.hidden_dim = hidden_dim
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(hidden_dim + context_dim, "batch")
        self.update_block = BasicUpdateBlock(hidden_dim,
                                             corr_levels * (2 * corr_radius + 1) ** 2)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor):
        dtype = self.fnet.conv1.weight.dtype
        img1 = normalize_frames(image1, dtype)
        img2 = normalize_frames(image2, dtype)
        fmap1, fmap2 = self.fnet(torch.cat([img1, img2])).chunk(2)
        pyramid = build_corr_pyramid(nhwc(fmap1), nhwc(fmap2), self.corr_levels)

        net, inp = self.cnet(img1).split([self.hidden_dim, self.cnet.conv2.out_channels
                                          - self.hidden_dim], dim=1)
        net, inp = torch.tanh(net), F.relu(inp)

        b, _, h8, w8 = fmap1.shape
        # the coordinates in the compute dtype, as the JAX module keeps them
        coords0 = coords_grid(b, h8, w8, dtype, image1.device)
        coords1 = coords0
        for _ in range(self.iters):
            corr = corr_lookup_separable(pyramid, coords1, self.corr_radius).to(dtype)
            net, delta = self.update_block(net, inp, nchw(corr), nchw(coords1 - coords0))
            coords1 = coords1 + nhwc(delta)
        flow_low = coords1 - coords0
        flow_up = upsample_flow_convex(flow_low, nhwc(self.update_block.upsample_mask(net)))
        return flow_low, flow_up
