"""DINOv3 backbones and the DPT depther (counterpart of the JAX package's
``models/dinov3.py``).

DINOv3 against DINOv2, as options of the port's ``DinoViT``: patch 16; 2D
axial RoPE on the patch tokens of every attention, coordinates normalized to
[-1, 1], and no learned position table (``rope=True, pos_embed=False``): so
every attention goes to kernel K2 after the rotation, at head_dim 64
(vits16, vitl16) or 128 (vit7b16); 4 register tokens; LayerScale; SwiGLU on
the 7B tier. The depther (the hub's ``dinov3_*_dd``) is the backbone and a
DPT head: preprocessed (B, H, W, 3), H and W multiples of 16 -> depth
(B, H, W) >= 0. Parameter names are upstream's
(``weights/manifests/dinov3_vits16.json``, ``dinov3_vitl16.json``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from monocular_depth_estimation_trt_tpu_torch.models.dpt import DPTHead
from monocular_depth_estimation_trt_tpu_torch.models.vit import DinoViT, ViTConfig

# backbone tiers (the public DINOv3 release names)
DINOV3_CONFIGS = {
    "vits16": ViTConfig(dim=384, depth=12, num_heads=6, patch_size=16,
                        num_register_tokens=4, rope=True, pos_embed=False,
                        pretrain_img_size=1024),
    "vitl16": ViTConfig(dim=1024, depth=24, num_heads=16, patch_size=16,
                        num_register_tokens=4, rope=True, pos_embed=False,
                        pretrain_img_size=1024),
    "vit7b16": ViTConfig(dim=4096, depth=40, num_heads=32, patch_size=16,
                         num_register_tokens=4, rope=True, pos_embed=False,
                         ffn="swiglu", pretrain_img_size=1024),
}

DINOV3_HEAD_CONFIGS = {
    "vits16": dict(features=64, out_channels=(48, 96, 192, 384), idxs=(2, 5, 8, 11)),
    "vitl16": dict(features=256, out_channels=(256, 512, 1024, 1024), idxs=(4, 11, 17, 23)),
    "vit7b16": dict(features=384, out_channels=(1536, 1536, 1536, 1536),
                    idxs=(9, 19, 29, 39)),
}


class DINOv3Depther(nn.Module):
    """DINOv3 encoder + DPT depth head. ``vit_config``, ``head_features``,
    ``head_out_channels``, ``out_indices``: overrides of the ``encoder``
    presets (test sizes)."""

    def __init__(self, encoder: str = "vitl16", attn_impl: str = "auto",
                 vit_config: Optional[ViTConfig] = None, head_features: Optional[int] = None,
                 head_out_channels: Optional[Sequence[int]] = None,
                 out_indices: Optional[Sequence[int]] = None):
        super().__init__()
        cfg = vit_config or DINOV3_CONFIGS[encoder]
        head = DINOV3_HEAD_CONFIGS.get(encoder, {})
        self.cfg = cfg
        self.backbone = DinoViT(cfg, out_indices=out_indices or head["idxs"],
                                attn_impl=attn_impl)
        self.head = DPTHead(cfg.dim, head_features or head["features"],
                            tuple(head_out_channels or head["out_channels"]), cfg.patch_size,
                            final_act="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph, pw = x.shape[1] // self.cfg.patch_size, x.shape[2] // self.cfg.patch_size
        return self.head(self.backbone(x), (ph, pw))
