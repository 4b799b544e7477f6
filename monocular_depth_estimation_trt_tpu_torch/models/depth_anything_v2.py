"""Depth Anything V2 — DINOv2 encoder + DPT head, relative and metric depth
(counterpart of the JAX package's ``models/depth_anything_v2.py``).

Submodules are named ``pretrained`` and ``depth_head`` as in the upstream
checkpoints, so ``depth_anything_v2_{enc}.pth`` loads with a plain strict
``load_state_dict`` (``weights/store.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from monocular_depth_estimation_trt_tpu_torch.models.dpt import DPTHead
from monocular_depth_estimation_trt_tpu_torch.models.vit import (
    VIT_CONFIGS,
    DinoViT,
    ViTConfig,
)
from monocular_depth_estimation_trt_tpu_torch.ops.quant import linear_paths

# features / out_channels per encoder (reference Depth_Anything_V2/infer.py:48-53)
HEAD_CONFIGS = {
    "vits": dict(features=64, out_channels=(48, 96, 192, 384)),
    "vitb": dict(features=128, out_channels=(96, 192, 384, 768)),
    "vitl": dict(features=256, out_channels=(256, 512, 1024, 1024)),
    "vitg": dict(features=384, out_channels=(1536, 1536, 1536, 1536)),
}

# DINOv2 intermediate layers tapped by the DPT head (upstream DA-V2 dpt.py)
INTERMEDIATE_LAYER_IDX = {
    "vits": (2, 5, 8, 11),
    "vitb": (2, 5, 8, 11),
    "vitl": (4, 11, 17, 23),
    "vitg": (9, 19, 29, 39),
}


class DepthAnythingV2(nn.Module):
    """Input: preprocessed images (B, H, W, 3), H/W multiples of 14.
    Output: depth (B, H, W) float32 — relative (>=0) or metric (meters).

    ``vit_config``, ``head_features``, ``head_out_channels`` and
    ``out_indices`` override the encoder presets (tests, non-preset
    variants), as in the JAX module."""

    def __init__(self, encoder: str = "vits", metric: bool = False,
                 max_depth: float = 20.0, attn_impl: str = "auto",
                 vit_config: Optional[ViTConfig] = None,
                 head_features: Optional[int] = None,
                 head_out_channels: Optional[Sequence[int]] = None,
                 out_indices: Optional[Sequence[int]] = None):
        super().__init__()
        vit_cfg = vit_config or VIT_CONFIGS[encoder]
        head_cfg = HEAD_CONFIGS.get(encoder, {})
        self.metric = metric
        self.max_depth = max_depth
        self.patch_size = vit_cfg.patch_size
        self.pretrained = DinoViT(
            vit_cfg,
            out_indices=out_indices or INTERMEDIATE_LAYER_IDX[encoder],
            attn_impl=attn_impl,
        )
        self.depth_head = DPTHead(
            in_channels=vit_cfg.dim,
            features=head_features or head_cfg["features"],
            out_channels=head_out_channels or head_cfg["out_channels"],
            patch_size=vit_cfg.patch_size,
            final_act="sigmoid" if metric else "relu",
        )

    def int8_targets(self):
        """The layers that int8 serving quantizes: every ``nn.Linear`` of the
        encoder (qkv, proj, fc1 and fc2, or w12 and w3, of each block), the
        JAX package's ``QuantDense`` layers. The DPT head keeps the compute
        type."""
        return linear_paths(self, "pretrained")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph, pw = x.shape[1] // self.patch_size, x.shape[2] // self.patch_size
        depth = self.depth_head(self.pretrained(x), (ph, pw))
        if self.metric:
            return depth * self.max_depth
        # upstream applies relu after the head (already >=0; kept for parity)
        return F.relu(depth)
