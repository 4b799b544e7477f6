"""Depth Anything V3 (the DA3METRIC-LARGE serving contract; counterpart of
the JAX package's ``models/depth_anything_v3.py``).

Input (B, H, W, 3) ImageNet-normalized; outputs metric ``depth`` (B, H, W)
through ``exp`` (the head predicts log-depth) and a ``sky`` map (B, H, W)
through ``sigmoid``. The encoder is the DINOv2 ViT, the head a DPT fusion
pyramid shared by two output branches. Module names are the upstream
layout of ``weights/manifests/depth_anything_v3_vitl.json`` (``backbone``,
``head.projects``, ``head.resize_layers``, ``head.layer{i}_rn``,
``head.refinenet{i}``, ``head.output_conv1``, ``head.{depth,sky}_branch``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from monocular_depth_estimation_trt_tpu_torch.models.depth_anything_v2 import (
    HEAD_CONFIGS,
    INTERMEDIATE_LAYER_IDX,
)
from monocular_depth_estimation_trt_tpu_torch.models.dpt import DPTHead
from monocular_depth_estimation_trt_tpu_torch.models.vit import VIT_CONFIGS, DinoViT, ViTConfig
from monocular_depth_estimation_trt_tpu_torch.ops.quant import linear_paths


def _branch(features: int) -> nn.Sequential:
    """conv3x3 -> relu -> conv1x1 to one channel."""
    return nn.Sequential(nn.Conv2d(features // 2, 32, 3, 1, 1), nn.ReLU(),
                         nn.Conv2d(32, 1, 1))


class DualDPTHead(DPTHead):
    """The DPT trunk (fusion modules on the head itself) with two output
    branches, depth and sky, in place of ``output_conv2``. Returns the two
    raw maps (B, ph*14, pw*14) in float32."""

    def __init__(self, in_channels: int, features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024), patch_size: int = 14):
        super().__init__(in_channels, features, out_channels, patch_size, final_act="none",
                         nested_scratch=False)
        del self.output_conv2
        self.depth_branch = _branch(features)
        self.sky_branch = _branch(features)

    def forward(self, features, patch_hw: Tuple[int, int]):
        out = self.fuse(features, patch_hw)
        return self.depth_branch(out)[:, 0].float(), self.sky_branch(out)[:, 0].float()


class DepthAnythingV3(nn.Module):
    """Input (B, H, W, 3) normalized, H and W multiples of 14; returns
    (depth (B, H, W) metric, sky (B, H, W) in [0, 1]), float32.

    ``vit_config``, ``head_features``, ``head_out_channels`` and
    ``out_indices`` override the encoder presets (tests), as the JAX
    module's ``DA3Config``."""

    def __init__(self, encoder: str = "vitl", attn_impl: str = "auto",
                 vit_config: Optional[ViTConfig] = None,
                 head_features: Optional[int] = None,
                 head_out_channels: Optional[Sequence[int]] = None,
                 out_indices: Optional[Sequence[int]] = None):
        super().__init__()
        vit_cfg = vit_config or VIT_CONFIGS[encoder]
        head_cfg = HEAD_CONFIGS.get(encoder, {})
        self.patch_size = vit_cfg.patch_size
        self.backbone = DinoViT(vit_cfg, out_indices=out_indices or INTERMEDIATE_LAYER_IDX[encoder],
                                attn_impl=attn_impl)
        self.head = DualDPTHead(vit_cfg.dim, head_features or head_cfg["features"],
                                head_out_channels or head_cfg["out_channels"],
                                vit_cfg.patch_size)

    def int8_targets(self):
        """Every ``nn.Linear`` of the encoder (the JAX ``QuantDense`` set);
        the head keeps the compute type."""
        return linear_paths(self, "backbone")

    def forward(self, x: torch.Tensor):
        ph, pw = x.shape[1] // self.patch_size, x.shape[2] // self.patch_size
        depth, sky = self.head(self.backbone(x), (ph, pw))
        return torch.exp(depth), torch.sigmoid(sky)
