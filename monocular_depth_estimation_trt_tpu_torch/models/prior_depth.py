"""Prior Depth Anything: depth refinement conditioned on a metric prior
(counterpart of the JAX package's ``models/prior_depth.py``).

:class:`PriorDARefiner` takes an image, a metric depth prior and its
confidence:

1. a frozen relative MDE (``mde`` + ``mde_head``) on the RGB alone;
2. a confidence-weighted least-squares scale and shift of the MDE onto the
   prior (:func:`scale_shift_align`), then the blend
   ``comp = b * prior + (1 - b) * aligned`` with b the confidence over its
   maximum;
3. a conditioned stack (``cond`` + ``refine_head``) whose patch embed takes
   six channels ``[rgb, comp_norm, b, mde_norm]`` and predicts a bounded
   log-residual: ``refined = comp * exp(clip(r, -3, 3))``.

:class:`PriorDepthAnything` serves it on VGGT's depth and confidence (the
registry's ``prior_depth_anything``). Module names are the upstream layout
of ``weights/manifests/prior_depth_anything_vits.json``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from monocular_depth_estimation_trt_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from monocular_depth_estimation_trt_tpu_torch.models.sidepth import dino_dpt_stack, run_stack
from monocular_depth_estimation_trt_tpu_torch.models.vggt import VGGT
from monocular_depth_estimation_trt_tpu_torch.ops.preprocess import normalize


def scale_shift_align(pred: torch.Tensor, prior: torch.Tensor, weight: torch.Tensor,
                      eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image weighted least squares: (s, t) minimizing
    ``sum w * (s*pred + t - prior)^2``. Inputs (B, H, W); per-image (B,)
    results, by the closed-form 2x2 solve in fp32, as the JAX function."""
    p, q, w = pred.float(), prior.float(), weight.float()
    ax = (1, 2)
    sw = torch.sum(w, ax) + eps
    swp = torch.sum(w * p, ax)
    swq = torch.sum(w * q, ax)
    swpp = torch.sum(w * p * p, ax)
    swpq = torch.sum(w * p * q, ax)
    det = sw * swpp - swp * swp
    det = torch.where(torch.abs(det) < eps, eps, det)
    return (sw * swpq - swp * swq) / det, (swpp * swq - swp * swpq) / det


def _max_normalized(x: torch.Tensor) -> torch.Tensor:
    return x / (x.amax(dim=(1, 2), keepdim=True) + 1e-6)


class PriorDARefiner(nn.Module):
    """``(image (B, H, W, 3) preprocessed, prior (B, H, W), confidence
    (B, H, W)) -> refined metric depth (B, H, W)`` float32.
    ``vit_config``, ``head_features``, ``head_out_channels`` and
    ``out_indices`` override the encoder presets (tests)."""

    def __init__(self, encoder: str = "vits", attn_impl: str = "auto", **overrides):
        super().__init__()
        self.mde, self.mde_head = dino_dpt_stack(encoder, attn_impl, "relu", **overrides)
        self.cond, self.refine_head = dino_dpt_stack(encoder, attn_impl, "none", in_chans=6,
                                                     **overrides)

    def forward(self, image: torch.Tensor, prior: torch.Tensor,
                confidence: torch.Tensor) -> torch.Tensor:
        mde = run_stack(self.mde, self.mde_head, image)  # fp32, relative
        prior = prior.float()
        conf = torch.clamp(confidence.float(), min=0.0)
        s, t = scale_shift_align(mde, prior, conf)
        aligned = s[:, None, None] * mde + t[:, None, None]
        b = _max_normalized(conf)
        comp = b * prior + (1.0 - b) * aligned
        cond = torch.cat([image.float(), _max_normalized(comp)[..., None], b[..., None],
                          _max_normalized(mde)[..., None]], dim=-1)
        r = run_stack(self.cond, self.refine_head, cond)
        return comp * torch.exp(torch.clamp(r, -3.0, 3.0))


class PriorDepthAnything(nn.Module):
    """VGGT's depth head (S = 1, no camera head) and the refiner in one
    forward: a pad-square VGGT input (B, side, side, 3) -> (refined depth,
    VGGT depth, VGGT confidence), each (B, side, side). The refiner reads
    the same square view normalized once more with the ImageNet statistics,
    as the JAX pipeline does."""

    def __init__(self, vggt: VGGT, refiner: PriorDARefiner):
        super().__init__()
        self.vggt = vggt
        self.refiner = refiner

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        out = self.vggt(x[:, None])
        depth, conf = out["depth"][:, 0], out["depth_conf"][:, 0]
        rgb = normalize(x, IMAGENET_MEAN, IMAGENET_STD)
        return self.refiner(rgb, depth, conf), depth, conf
