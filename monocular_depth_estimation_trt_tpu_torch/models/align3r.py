"""Align3R: pairwise depth, point maps and pose for dynamic videos
(counterpart of the JAX package's ``models/align3r.py``).

A DUSt3R-style two-view transformer conditioned on monocular depth priors:

* encoder: a patch-16 ViT-L over both frames in one batch (the port's
  ``DinoViT``; its attention on kernel K1);
* depth-prior injection: each view's prior depth, standardized per image,
  patch-16 conv-embedded and added to its decoder input tokens;
* twin decoders in lockstep: at layer i each view runs self-attention, then
  cross-attention to the other view's tokens of layer i - 1, then an MLP
  (pre-LN in fp32, separate weights per view). Their attention is plain
  (scores in the compute type, fp32 softmax, P cast back), as in the JAX
  package, which has no kernel there: :func:`decoder_attention`;
* one 4-channel DPT head per view (4 decoder taps): points by ``inv_log``
  and confidence by ``1 + exp``, both in view 1's frame.

Parameter names are the upstream layout's (``weights/manifests/align3r.json``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from monocular_depth_estimation_trt_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from monocular_depth_estimation_trt_tpu_torch.models.dpt import DPTHead
from monocular_depth_estimation_trt_tpu_torch.models.vggt import pts_conf
from monocular_depth_estimation_trt_tpu_torch.models.vit import DinoViT, ViTConfig
from monocular_depth_estimation_trt_tpu_torch.ops.constants import device_constant

ALIGN3R_ENCODER = ViTConfig(dim=1024, depth=24, num_heads=16, patch_size=16,
                            pretrain_img_size=512)


def decoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., H, N, d) plain attention: scores in the operand type, then fp32
    divided by sqrt(d), fp32 softmax, P cast back before P.V (the JAX
    ``CrossBlock._attn``)."""
    a = torch.einsum("...qd,...kd->...qk", q, k).float()
    p = torch.softmax(a / math.sqrt(q.shape[-1]), dim=-1)
    return torch.einsum("...qk,...kd->...qd", p.to(v.dtype), v)


def _ln(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in fp32 (statistics and affine), cast back to x's type."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(x.dtype)


class CrossBlock(nn.Module):
    """DUSt3R decoder block: pre-LN self-attention, cross-attention to the
    other view, MLP."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        for tag in ("self", "cross"):
            self.add_module(f"{tag}_q", nn.Linear(dim, dim))
            self.add_module(f"{tag}_kv", nn.Linear(dim, 2 * dim))
            self.add_module(f"{tag}_proj", nn.Linear(dim, dim))
        for name in ("norm1", "norm2", "norm_y", "norm3"):
            self.add_module(name, nn.LayerNorm(dim, eps=1e-6))
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def _attn(self, q_tok: torch.Tensor, kv_tok: torch.Tensor, tag: str) -> torch.Tensor:
        c = q_tok.shape[-1]
        hd = c // self.num_heads

        def heads(u):
            return u.reshape(*u.shape[:-1], self.num_heads, hd).transpose(-3, -2)

        k, v = getattr(self, f"{tag}_kv")(kv_tok).chunk(2, dim=-1)
        o = decoder_attention(heads(getattr(self, f"{tag}_q")(q_tok)), heads(k), heads(v))
        return getattr(self, f"{tag}_proj")(o.transpose(-3, -2).reshape(*q_tok.shape[:-1], c))

    def forward(self, x: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
        h = _ln(self.norm1, x)
        x = x + self._attn(h, h, "self")
        x = x + self._attn(_ln(self.norm2, x), _ln(self.norm_y, other), "cross")
        y = self.fc2(F.gelu(self.fc1(_ln(self.norm3, x)), approximate="none"))
        return x + y


class Align3R(nn.Module):
    """(img1, img2 raw 0-255 (B, H, W, 3), prior1, prior2 (B, H, W)) ->
    dict(pts1, conf1, pts2, conf2): point maps (B, H, W, 3) in view 1's frame
    and their confidence, at the input resolution."""

    def __init__(self, enc: ViTConfig = ALIGN3R_ENCODER, dec_dim: int = 768,
                 dec_depth: int = 12, dec_heads: int = 12, head_features: int = 128,
                 head_out_channels: Sequence[int] = (96, 192, 384, 768),
                 out_indices: Optional[Sequence[int]] = None, attn_impl: str = "auto"):
        super().__init__()
        self.enc = enc
        p = enc.patch_size
        # 4 evenly spaced decoder taps for the DPT heads (the last included)
        self.taps = tuple(out_indices) if out_indices else (
            dec_depth // 4 - 1, dec_depth // 2 - 1, 3 * dec_depth // 4 - 1, dec_depth - 1)
        self.encoder = DinoViT(enc, out_indices=(enc.depth - 1,), attn_impl=attn_impl)
        self.decoder_embed = nn.Linear(enc.dim, dec_dim)
        self.prior_embed = nn.Conv2d(1, dec_dim, p, p)
        self.dec1 = nn.ModuleList(CrossBlock(dec_dim, dec_heads) for _ in range(dec_depth))
        self.dec2 = nn.ModuleList(CrossBlock(dec_dim, dec_heads) for _ in range(dec_depth))
        for name in ("head1", "head2"):
            self.add_module(name, DPTHead(dec_dim, head_features, tuple(head_out_channels), p,
                                          final_act="none", num_outputs=4,
                                          nested_scratch=False))

    def forward(self, img1: torch.Tensor, img2: torch.Tensor, prior1: torch.Tensor,
                prior2: torch.Tensor) -> Dict[str, torch.Tensor]:
        b, H, W, _ = img1.shape
        p = self.enc.patch_size
        ph, pw = H // p, W // p
        dtype = self.decoder_embed.weight.dtype
        mean = device_constant(IMAGENET_MEAN, torch.float32, img1.device)
        std = device_constant(IMAGENET_STD, torch.float32, img1.device)
        x = (torch.cat([img1, img2]).float() / 255.0 - mean) / std
        tok = self.decoder_embed(self.encoder(x)[0][0])  # (2B, N, dec_dim)

        # the depth priors, standardized per image, conv-embedded, added
        pri = torch.cat([prior1, prior2])[:, None].float()  # (2B, 1, H, W)
        mu = pri.mean(dim=(1, 2, 3), keepdim=True)
        sd = pri.std(dim=(1, 2, 3), keepdim=True, unbiased=False) + 1e-6
        pri_tok = self.prior_embed(((pri - mu) / sd).to(dtype))
        tok = tok + pri_tok.flatten(2).transpose(1, 2)

        x1, x2 = tok[:b], tok[b:]
        taps1, taps2 = [], []
        for i, (blk1, blk2) in enumerate(zip(self.dec1, self.dec2)):
            # lockstep: the cross-attention reads the other view's last layer
            x1, x2 = blk1(x1, x2), blk2(x2, x1)
            if i in self.taps:
                taps1.append((x1, None))
                taps2.append((x2, None))
        pts1, conf1 = pts_conf(self.head1(taps1, (ph, pw)))
        pts2, conf2 = pts_conf(self.head2(taps2, (ph, pw)))
        return {"pts1": pts1, "conf1": conf1, "pts2": pts2, "conf2": conf2}
