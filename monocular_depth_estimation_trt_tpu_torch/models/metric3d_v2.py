"""Metric3D V2: canonical-camera metric depth, surface normals and confidence
(counterpart of the JAX package's ``models/metric3d_v2.py``).

Input (B, 616, 1064, 3) normalized in 0-255 space on a keep-ratio
mean-padded canvas (``ops/preprocess.py::preprocess_keep_ratio_pad``);
outputs ``depth`` (B, H, W) in the canonical camera (focal 1000),
``normal`` (B, H, W, 3) and ``confidence`` (B, H, W), float32.

* ``encoder``: DINOv2 ViT with 4 register tokens and 4 normed taps;
* ``neck``: DPT projections and the fusion pyramid down to ``refinenet2``,
  a context map at twice the patch grid;
* ``context_conv`` -> the GRU's hidden state (tanh) and static input (relu);
  ``init_head`` -> the first (depth logit, normal) prediction;
* ``iters`` refinement steps: ``pred_encoder`` embeds the prediction, the
  ConvGRU updates the hidden state, ``delta_head`` adds a correction;
* ``mask_head`` -> the learned convex ``k``-fold upsampling of the
  prediction and ``conf_head``'s confidence to the input size.

Module names are the upstream layout of
``weights/manifests/metric3d_v2_vitl.json``; the GRU keeps upstream's
separate ``convz``/``convr`` (the JAX module fuses them into ``convzr``,
``weights/from_jax.py`` splits it back).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from monocular_depth_estimation_trt_tpu_torch.models.depth_anything_v2 import (
    HEAD_CONFIGS,
    INTERMEDIATE_LAYER_IDX,
)
from monocular_depth_estimation_trt_tpu_torch.models.dpt import (
    FeatureFusionBlock,
    project_levels,
    resize_layers,
)
from monocular_depth_estimation_trt_tpu_torch.models.vit import VIT_CONFIGS, DinoViT, ViTConfig
from monocular_depth_estimation_trt_tpu_torch.ops.quant import linear_paths

# canonical-space depth range (metric, at the 1000 px canonical focal)
DEPTH_RANGE = (0.3, 150.0)
NUM_REGISTER_TOKENS = 4  # the register-token DINOv2 ("vit_large_reg")


def convex_upsample(x: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """Learned convex ``k``-fold upsampling (RAFT's ``upsample_flow``
    generalized), NCHW: x (B, C, h, w), mask (B, 9*k*k, h, w) ->
    (B, C, k*h, k*w).

    The mask is tap-major, as in the JAX package: tap ``j`` of all k*k
    sub-pixels sits at channels ``[j*k*k, (j+1)*k*k)``, taps in row-major
    order of the 3x3 neighbourhood. The softmax over the 9 taps runs in
    fp32 and its weights are cast to x's dtype; the 9 weighted neighbours
    are summed in x's dtype, tap by tap, as the JAX function does."""
    b, c, h, w = x.shape
    kk = k * k
    weights = torch.softmax(mask.float().view(b, 9, kk, h, w), dim=1).to(x.dtype)
    padded = F.pad(x, (1, 1, 1, 1))
    acc = None
    for j in range(9):
        dy, dx = divmod(j, 3)
        term = weights[:, None, j] * padded[:, :, None, dy:dy + h, dx:dx + w]  # (B, C, kk, h, w)
        acc = term if acc is None else acc + term
    # sub-pixel (ky, kx) of cell (y, x) lands at (y*k + ky, x*k + kx)
    up = acc.view(b, c, k, k, h, w).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(b, c, k * h, k * w)


class ConvGRU(nn.Module):
    """3x3 convolutional GRU cell (upstream ``gru.convz/convr/convq``).
    The gates' statistics are taken in fp32, as in the JAX module."""

    def __init__(self, hidden: int, in_ch: int):
        super().__init__()
        self.convz = nn.Conv2d(hidden + in_ch, hidden, 3, 1, 1)
        self.convr = nn.Conv2d(hidden + in_ch, hidden, 3, 1, 1)
        self.convq = nn.Conv2d(hidden + in_ch, hidden, 3, 1, 1)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx).float()).to(h.dtype)
        r = torch.sigmoid(self.convr(hx).float()).to(h.dtype)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)).float()).to(h.dtype)
        return (1.0 - z) * h + z * q


class DPTNeck(nn.Module):
    """DPT projections and fusion down to ``refinenet2``: context features
    (B, features, 2*ph, 2*pw)."""

    def __init__(self, in_channels: int, features: int, out_channels: Sequence[int]):
        super().__init__()
        oc = list(out_channels)
        self.projects = nn.ModuleList(nn.Conv2d(in_channels, c, 1) for c in oc)
        self.resize_layers = resize_layers(oc)
        for i, c in enumerate(oc):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(c, features, 3, 1, 1, bias=False))
        for i in (2, 3, 4):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(features))

    def forward(self, features, patch_hw: Tuple[int, int]) -> torch.Tensor:
        ph, pw = patch_hw
        l1, l2, l3, l4 = (getattr(self, f"layer{i + 1}_rn")(x)
                          for i, x in enumerate(project_levels(self, features, patch_hw)))
        p4 = self.refinenet4(l4, size=l3.shape[-2:])
        p3 = self.refinenet3(p4, l3, size=l2.shape[-2:])
        return self.refinenet2(p3, l2, size=(2 * ph, 2 * pw))


@dataclasses.dataclass(frozen=True)
class Metric3DConfig:
    """Overrides of the encoder presets (tests), as the JAX module's."""

    vit_config: Optional[ViTConfig] = None
    features: Optional[int] = None
    out_channels: Optional[Tuple[int, ...]] = None
    out_indices: Optional[Tuple[int, ...]] = None
    hidden: Optional[int] = None
    upsample_factor: int = 7


class Metric3DV2(nn.Module):
    """Returns dict(depth (B, H, W) canonical metric, normal (B, H, W, 3),
    confidence (B, H, W)). H and W must be ``2 * k`` times the patch grid
    (616x1064: 44x76 patches, refinement at 88x152, 7x upsample)."""

    def __init__(self, encoder: str = "vitl", iters: int = 4, attn_impl: str = "auto",
                 cfg: Metric3DConfig = Metric3DConfig()):
        super().__init__()
        vit_cfg = dataclasses.replace(cfg.vit_config or VIT_CONFIGS[encoder],
                                      num_register_tokens=NUM_REGISTER_TOKENS)
        head_cfg = (HEAD_CONFIGS[encoder] if cfg.features is None
                    else dict(features=cfg.features, out_channels=cfg.out_channels))
        hidden = cfg.hidden or 128
        features = head_cfg["features"]
        self.iters = iters
        self.k = cfg.upsample_factor
        self.hidden = hidden
        self.patch_size = vit_cfg.patch_size
        self.encoder = DinoViT(vit_cfg, out_indices=cfg.out_indices
                               or INTERMEDIATE_LAYER_IDX[encoder], attn_impl=attn_impl)
        self.neck = DPTNeck(vit_cfg.dim, features, head_cfg["out_channels"])
        self.context_conv = nn.Conv2d(features, 2 * hidden, 3, 1, 1)
        self.init_head = nn.Conv2d(features, 4, 3, 1, 1)
        self.gru = ConvGRU(hidden, 2 * hidden)
        self.pred_encoder = nn.Conv2d(4, hidden, 3, 1, 1)
        self.delta_head = nn.Conv2d(hidden, 4, 3, 1, 1)
        self.mask_head = nn.Conv2d(hidden, 9 * self.k * self.k, 1)
        self.conf_head = nn.Conv2d(hidden, 1, 3, 1, 1)

    def int8_targets(self):
        """Every ``nn.Linear`` of the ViT encoder, as in the JAX package; the
        RAFT-DPT decoder keeps the compute type."""
        return linear_paths(self, "encoder")

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        b, H, W, _ = x.shape
        ph, pw = H // self.patch_size, W // self.patch_size
        if 2 * ph * self.k != H or 2 * pw * self.k != W:
            raise ValueError(f"input {H}x{W} incompatible with patch {self.patch_size} and "
                             f"upsample factor {self.k}")
        ctx = self.neck(self.encoder(x), (ph, pw))
        h, inp = torch.split(self.context_conv(ctx), [self.hidden, self.hidden], dim=1)
        h = torch.tanh(h.float()).to(ctx.dtype)
        inp = F.relu(inp)
        pred = self.init_head(ctx).float()  # 1 depth logit + 3 normal
        for _ in range(self.iters):
            e = F.relu(self.pred_encoder(pred.to(ctx.dtype)))
            h = self.gru(h, torch.cat([inp, e], dim=1))
            pred = pred + self.delta_head(h).float()
        mask = self.mask_head(h)
        conf = self.conf_head(h).float()
        up = convex_upsample(torch.cat([pred, conf], dim=1).to(ctx.dtype), mask,
                             self.k).float()  # (B, 5, H, W)
        d_min, d_max = DEPTH_RANGE
        depth = d_min + (d_max - d_min) * torch.sigmoid(up[:, 0])
        normal = up[:, 1:4].permute(0, 2, 3, 1)
        normal = normal / torch.clamp(torch.linalg.vector_norm(normal, dim=-1, keepdim=True),
                                      min=1e-6)
        return {"depth": depth, "normal": normal, "confidence": torch.sigmoid(up[:, 4])}
