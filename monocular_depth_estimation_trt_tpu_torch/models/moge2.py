"""MoGe-2 family: affine-invariant point map, normal, mask and metric scale
(counterpart of the JAX package's ``models/moge2.py``; Metric Anything's
student_pointmap is the same architecture without the normal branch).

Input (B, H, W, 3) ImageNet-normalized at an aspect-preserving resolution
(291x518 for MoGe-2, 518x518 for Metric Anything) and a static token
budget. The image is resized to the token grid's pixel size
(:func:`grid_for_tokens`, multiples of 14), encoded by DINOv2 (4 normed
taps), and decoded by :class:`MoGeHead`: per-tap projections summed at the
patch grid, three 2x deconvolution stages with a residual block each, and
the output branches, resized back to (H, W). ``scale_head`` maps the last
tap's class token to the metric scale. Both resizes read their resampling
matrices from the device cache (``ops/resize.py``).

Module names are the upstream layout of ``weights/manifests/moge2_vits.json``
(``backbone``, ``head.projects``, ``head.upsample_blocks.{j}.{0,1}``,
``head.{points,normal,mask}_out.{0,2}``, ``scale_head.{0,2}``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from monocular_depth_estimation_trt_tpu_torch.models.depth_anything_v2 import (
    INTERMEDIATE_LAYER_IDX,
)
from monocular_depth_estimation_trt_tpu_torch.models.dpt import ResidualConvUnit
from monocular_depth_estimation_trt_tpu_torch.models.vit import VIT_CONFIGS, DinoViT, ViTConfig
from monocular_depth_estimation_trt_tpu_torch.ops.quant import linear_paths
from monocular_depth_estimation_trt_tpu_torch.ops.resize import resize


def grid_for_tokens(h: int, w: int, num_tokens: int, patch: int = 14) -> Tuple[int, int]:
    """Aspect-preserving (grid_h, grid_w) with grid_h * grid_w ~= num_tokens."""
    aspect = w / h
    gh = max(int(round(math.sqrt(num_tokens / aspect))), 1)
    gw = max(int(round(gh * aspect)), 1)
    return gh, gw


def _branch(dim: int, out: int) -> nn.Sequential:
    """conv3x3 -> relu -> conv1x1 to ``out`` channels."""
    return nn.Sequential(nn.Conv2d(dim, dim, 3, 1, 1), nn.ReLU(), nn.Conv2d(dim, out, 1))


class MoGeHead(nn.Module):
    """Projections, the upsampling pyramid and the output branches. Returns
    float32 channels-last maps at ``out_hw``: points (B, H, W, 3), normal
    (B, H, W, 3) where predicted, mask (B, H, W, 1)."""

    def __init__(self, num_levels: int, dim_in: int, proj_dim: int, up_dims: Sequence[int],
                 predict_normal: bool):
        super().__init__()
        self.predict_normal = predict_normal
        self.projects = nn.ModuleList(nn.Conv2d(dim_in, proj_dim, 1) for _ in range(num_levels))
        blocks, prev = [], proj_dim
        for d in up_dims:
            blocks.append(nn.Sequential(nn.ConvTranspose2d(prev, d, 2, 2), ResidualConvUnit(d)))
            prev = d
        self.upsample_blocks = nn.ModuleList(blocks)
        last = up_dims[-1]
        self.points_out = _branch(last, 3)
        if predict_normal:
            self.normal_out = _branch(last, 3)
        self.mask_out = _branch(last, 1)

    def forward(self, feats, patch_hw: Tuple[int, int],
                out_hw: Tuple[int, int]) -> Dict[str, torch.Tensor]:
        gh, gw = patch_hw
        x = 0.0
        for proj, (tokens, _cls) in zip(self.projects, feats):
            # a 1x1 conv on the patch grid is a dense layer on the tokens
            w = proj.weight
            x = x + F.linear(tokens.to(w.dtype), w.view(w.shape[0], -1), proj.bias)
        x = x.reshape(x.shape[0], gh, gw, -1).permute(0, 3, 1, 2)
        for blk in self.upsample_blocks:
            x = blk(x)
        names = ["points"] + (["normal"] if self.predict_normal else []) + ["mask"]
        return {name: resize(getattr(self, f"{name}_out")(x).float().permute(0, 2, 3, 1),
                             out_hw, method="linear")
                for name in names}


@dataclasses.dataclass(frozen=True)
class MoGeConfig:
    """Overrides of the presets (tests), as the JAX module's."""

    vit_config: Optional[ViTConfig] = None
    proj_dim: Optional[int] = None
    up_dims: Optional[Tuple[int, ...]] = None
    out_indices: Optional[Tuple[int, ...]] = None


class MoGe2(nn.Module):
    """Returns dict(points (B, H, W, 3), normal (B, H, W, 3) where
    predicted, mask (B, H, W) in [0, 1], metric_scale (B,)), float32, at the
    input resolution."""

    def __init__(self, encoder: str = "vits", num_tokens: int = 1800,
                 predict_normal: bool = True, attn_impl: str = "auto",
                 cfg: MoGeConfig = MoGeConfig()):
        super().__init__()
        vit_cfg = cfg.vit_config or VIT_CONFIGS[encoder]
        out_indices = cfg.out_indices or INTERMEDIATE_LAYER_IDX[encoder]
        self.num_tokens = num_tokens
        self.predict_normal = predict_normal
        self.patch_size = vit_cfg.patch_size
        self.backbone = DinoViT(vit_cfg, out_indices=out_indices, attn_impl=attn_impl)
        self.head = MoGeHead(len(out_indices), vit_cfg.dim, cfg.proj_dim or 512,
                             tuple(cfg.up_dims or (256, 128, 64)), predict_normal)
        self.scale_head = nn.Sequential(nn.Linear(vit_cfg.dim, 256), nn.GELU(approximate="none"),
                                        nn.Linear(256, 1))

    def int8_targets(self):
        """Every ``nn.Linear`` of the encoder, as in the JAX package; the head
        and the scale MLP keep the compute type."""
        return linear_paths(self, "backbone")

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        _, H, W, _ = x.shape
        p = self.patch_size
        gh, gw = grid_for_tokens(H, W, self.num_tokens, p)
        feats = self.backbone(resize(x, (gh * p, gw * p), method="linear"))
        dense = self.head(feats, (gh, gw), (H, W))

        points = dense["points"]
        # z through exp: MoGe's positive-depth parametrization before the shift
        out = {"points": torch.cat([points[..., :2],
                                    torch.exp(torch.clamp(points[..., 2:], -10, 10))], dim=-1)}
        if self.predict_normal:
            normal = dense["normal"]
            out["normal"] = normal / torch.clamp(
                torch.linalg.vector_norm(normal, dim=-1, keepdim=True), min=1e-8)
        out["mask"] = torch.sigmoid(dense["mask"][..., 0])
        s = self.scale_head(feats[-1][1])
        out["metric_scale"] = torch.exp(torch.clamp(s[:, 0].float(), -10, 10))
        return out
