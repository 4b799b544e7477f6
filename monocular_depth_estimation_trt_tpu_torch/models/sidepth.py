"""SIDepth: scale-invariant monocular depth via SSI depth (counterpart of the
JAX package's ``models/sidepth.py``).

Two DINOv2 + DPT stacks in one forward: ``ssi`` estimates relative
disparity from the RGB alone; ``si`` takes ``[rgb, ssi / (max + 1e-6)]``
through a 4-channel patch embed and predicts log SI depth,
``depth = exp(clip(r, -6, 6))``: metric up to one global scale. Module names
are the upstream layout of ``weights/manifests/sidepth_vits.json``
(``ssi``, ``ssi_head``, ``si``, ``si_head``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from monocular_depth_estimation_trt_tpu_torch.models.depth_anything_v2 import (
    HEAD_CONFIGS,
    INTERMEDIATE_LAYER_IDX,
)
from monocular_depth_estimation_trt_tpu_torch.models.dpt import DPTHead
from monocular_depth_estimation_trt_tpu_torch.models.vit import VIT_CONFIGS, DinoViT, ViTConfig


def dino_dpt_stack(encoder: str, attn_impl: str, final_act: str, *, in_chans: int = 3,
                   num_outputs: int = 1, vit_config: Optional[ViTConfig] = None,
                   head_features: Optional[int] = None,
                   head_out_channels: Optional[Sequence[int]] = None,
                   out_indices: Optional[Sequence[int]] = None):
    """A DINOv2 encoder and its DPT head at the encoder's presets (or the
    overrides): the building block of SIDepth, GeoCalib and Prior Depth
    Anything, as in the JAX modules."""
    vit_cfg = vit_config or VIT_CONFIGS[encoder]
    head_cfg = HEAD_CONFIGS.get(encoder, {})
    vit = DinoViT(vit_cfg, out_indices=out_indices or INTERMEDIATE_LAYER_IDX[encoder],
                  attn_impl=attn_impl, in_chans=in_chans)
    head = DPTHead(vit_cfg.dim, features=head_features or head_cfg["features"],
                   out_channels=head_out_channels or head_cfg["out_channels"],
                   patch_size=vit_cfg.patch_size, final_act=final_act, num_outputs=num_outputs)
    return vit, head


def run_stack(vit: DinoViT, head: DPTHead, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> the head's float32 output at (H, W)."""
    p = vit.cfg.patch_size
    return head(vit(x), (x.shape[1] // p, x.shape[2] // p))


class SIDepth(nn.Module):
    """Preprocessed image (B, H, W, 3), H/W multiples of 14 -> dict(ssi
    (B, H, W) relative disparity, depth (B, H, W) SI depth), float32.

    ``vit_config``, ``head_features``, ``head_out_channels`` and
    ``out_indices`` override the encoder presets (tests)."""

    def __init__(self, encoder: str = "vits", attn_impl: str = "auto", **overrides):
        super().__init__()
        self.ssi, self.ssi_head = dino_dpt_stack(encoder, attn_impl, "relu", **overrides)
        self.si, self.si_head = dino_dpt_stack(encoder, attn_impl, "none", in_chans=4,
                                               **overrides)

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        ssi = run_stack(self.ssi, self.ssi_head, image)  # fp32
        norm = ssi / (ssi.amax(dim=(1, 2), keepdim=True) + 1e-6)
        cond = torch.cat([image.float(), norm[..., None]], dim=-1)
        r = run_stack(self.si, self.si_head, cond)
        return {"ssi": ssi, "depth": torch.exp(torch.clamp(r, -6.0, 6.0))}
