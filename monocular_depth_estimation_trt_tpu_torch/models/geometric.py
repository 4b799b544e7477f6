"""Camera-aware monocular 3D models: UniDepth V2 and UniK3D (counterpart of the
JAX package's ``models/geometric.py``).

Input (B, H, W, 3) ImageNet-normalized (518² on the served path); outputs
``pts_3d`` (B, H, W, 3), ``confidence`` (B, H, W) and ``intrinsics``
(B, 3, 3), float32:

* ``pixel_encoder``: DINOv2 with 4 register tokens (N = 37·37 + 5 = 1374 at
  518²), four normed taps; its attention runs on the kernels
  (``models/vit.py``);
* ``adapters`` + ``adapter_norm``: a linear per tap to the decoder width,
  summed, LayerNorm;
* ``camera``: 4 learned latents cross-attend to the tokens, one
  self-attention block, a linear head -> fx = W/2·exp, fy = H/2·exp,
  cx = W·sigmoid, cy = H·sigmoid, in fp32;
* ``ray_embed``: unit rays through the patch centers, a degree-8 real SH
  basis (``ops/spherical_harmonics.py``), a two-layer MLP;
* ``depth_module``: ray-conditioned self-attention blocks, two pixel-shuffle
  (ConvTranspose2d k = s = 2) upsamples, a 2-channel head resized
  half-pixel to (H, W): value ``exp(clip(., ±10))`` and confidence
  ``sigmoid``;
* ``rays_module`` (UniK3D): a dense unit-ray field; points = rays · distance.
  UniDepth unprojects the z-depth through the predicted pinhole.

The decoder's attention is plain ``torch.matmul`` with the softmax in fp32 on
every device, as the JAX package's einsums: no Pallas kernel there, so none
here. Module names are the upstream layout of
``weights/manifests/unidepth_vit{s,b,l}.json`` and ``unik3d_vit{b,l}.json``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from monocular_depth_estimation_trt_tpu_torch.models.depth_anything_v2 import (
    INTERMEDIATE_LAYER_IDX,
)
from monocular_depth_estimation_trt_tpu_torch.models.vit import VIT_CONFIGS, DinoViT, ViTConfig
from monocular_depth_estimation_trt_tpu_torch.ops.camera import pixel_grid
from monocular_depth_estimation_trt_tpu_torch.ops.quant import linear_paths
from monocular_depth_estimation_trt_tpu_torch.ops.resize import resize, resize_hw
from monocular_depth_estimation_trt_tpu_torch.ops.spherical_harmonics import (
    num_sh_components,
    real_spherical_harmonics,
)

# Decoder widths per encoder size (hidden = half the ViT width, head_dim 64).
DECODER_DIMS = {"vits": 256, "vitb": 384, "vitl": 512, "vitg": 512}

SH_DEGREE = 8  # upstream rsh_cart_8


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def decoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The decoder's attention over (B, H, N, d) operands: scores in the
    compute type, then fp32 for the scale and the softmax, P cast back
    before P·V, the JAX block's order. Plain matmuls on every device."""
    s = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(q.shape[-1])
    return torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)


class CrossAttentionBlock(nn.Module):
    """Pre-LN attention block: cross-attention when ``context`` is given
    (``norm_context`` exists only then), self-attention otherwise."""

    def __init__(self, dim: int, num_heads: int, cross: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        if cross:
            self.norm_context = nn.LayerNorm(dim, eps=1e-6)
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.norm1(x)
        c = h if context is None else self.norm_context(context)
        b, nq, dim = h.shape
        nk, hd = c.shape[1], dim // self.num_heads
        q = self.q(h).view(b, nq, self.num_heads, hd).transpose(1, 2)
        k, v = self.kv(c).view(b, nk, 2, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        o = decoder_attention(q, k, v).transpose(1, 2).reshape(b, nq, dim)
        x = x + self.proj(o)
        return x + self.fc2(_gelu(self.fc1(self.norm2(x))))


class CameraModule(nn.Module):
    """Learned camera latents -> pinhole intrinsics (B, 3, 3) fp32."""

    normal_init = ("latents",)  # weights/store.py::init_random_

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.latents = nn.Parameter(torch.zeros(1, 4, dim))
        self.cross = CrossAttentionBlock(dim, num_heads, cross=True)
        self.self_block = CrossAttentionBlock(dim, num_heads)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.out = nn.Linear(dim, 1)

    def forward(self, tokens: torch.Tensor, input_hw: Tuple[int, int]) -> torch.Tensor:
        b = tokens.shape[0]
        x = self.latents.expand(b, -1, -1)
        x = self.self_block(self.cross(x, tokens))
        p = self.out(self.norm(x))[..., 0].float()  # (B, 4)
        h, w = input_hw
        fx = 0.5 * w * torch.exp(p[:, 0])
        fy = 0.5 * h * torch.exp(p[:, 1])
        cx = w * torch.sigmoid(p[:, 2])
        cy = h * torch.sigmoid(p[:, 3])
        zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
        return torch.stack([torch.stack([fx, zeros, cx], dim=-1),
                            torch.stack([zeros, fy, cy], dim=-1),
                            torch.stack([zeros, zeros, ones], dim=-1)], dim=-2)


def patch_center_rays(K: torch.Tensor, input_hw: Tuple[int, int],
                      patch_hw: Tuple[int, int]) -> torch.Tensor:
    """Unit rays through the patch centers for a batch of intrinsics:
    K (B, 3, 3) fp32 -> (B, ph*pw, 3)."""
    (H, W), (ph, pw) = input_hw, patch_hw
    u = (torch.arange(pw, dtype=torch.float32, device=K.device) + 0.5) * (W / pw)
    v = (torch.arange(ph, dtype=torch.float32, device=K.device) + 0.5) * (H / ph)
    uu = u[None, :].expand(ph, pw).reshape(-1)
    vv = v[:, None].expand(ph, pw).reshape(-1)
    rx = (uu[None] - K[:, 0, 2, None]) / K[:, 0, 0, None]
    ry = (vv[None] - K[:, 1, 2, None]) / K[:, 1, 1, None]
    rays = torch.stack([rx, ry, torch.ones_like(rx)], dim=-1)
    return rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)


class RayEmbedding(nn.Module):
    """SH(rays) -> decoder-width conditioning."""

    def __init__(self, dim: int, degree: int = SH_DEGREE):
        super().__init__()
        self.degree = degree
        self.fc1 = nn.Linear(num_sh_components(degree), dim)
        self.fc2 = nn.Linear(dim, dim)

    def forward(self, rays: torch.Tensor) -> torch.Tensor:
        sh = real_spherical_harmonics(rays, self.degree)  # fp32
        return self.fc2(_gelu(self.fc1(sh.to(self.fc1.weight.dtype))))


class DepthModule(nn.Module):
    """Ray-conditioned dense head: tokens -> (value, confidence) (B, H, W)
    fp32, decoded at 4x the patch grid and resized half-pixel to (H, W)."""

    def __init__(self, dim: int, num_heads: int, layers: int = 2):
        super().__init__()
        self.blocks = nn.ModuleList(CrossAttentionBlock(dim, num_heads) for _ in range(layers))
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.up1 = nn.ConvTranspose2d(dim, dim // 2, 2, 2)
        self.conv1 = nn.Conv2d(dim // 2, dim // 2, 3, 1, 1)
        self.up2 = nn.ConvTranspose2d(dim // 2, dim // 4, 2, 2)
        self.conv2 = nn.Conv2d(dim // 4, dim // 4, 3, 1, 1)
        self.out = nn.Conv2d(dim // 4, 2, 1)

    def forward(self, tokens: torch.Tensor, ray_emb: torch.Tensor, patch_hw: Tuple[int, int],
                out_hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
        ph, pw = patch_hw
        x = tokens + ray_emb
        for blk in self.blocks:
            x = blk(x)
        g = self.norm(x).reshape(x.shape[0], ph, pw, -1).permute(0, 3, 1, 2)
        g = _gelu(self.conv1(self.up1(g)))
        g = _gelu(self.conv2(self.up2(g)))
        out = resize_hw(self.out(g).float(), out_hw, "linear", align_corners=False)
        return torch.exp(torch.clamp(out[:, 0], -10.0, 10.0)), torch.sigmoid(out[:, 1])


class RaysModule(nn.Module):
    """Dense unit-ray field (UniK3D): conditioned tokens -> (B, H, W, 3)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.block0 = CrossAttentionBlock(dim, num_heads)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.out = nn.Linear(dim, 3)

    def forward(self, tokens: torch.Tensor, ray_emb: torch.Tensor, patch_hw: Tuple[int, int],
                out_hw: Tuple[int, int]) -> torch.Tensor:
        ph, pw = patch_hw
        r = self.out(self.norm(self.block0(tokens + ray_emb))).float()
        r = resize(r.reshape(r.shape[0], ph, pw, 3), out_hw, "linear", align_corners=False)
        return r / torch.clamp(torch.linalg.vector_norm(r, dim=-1, keepdim=True), min=1e-6)


@dataclasses.dataclass(frozen=True)
class GeometricConfig:
    """Overrides of the presets (tests), as the JAX module's."""

    vit_config: Optional[ViTConfig] = None
    decoder_dim: Optional[int] = None
    out_indices: Optional[Tuple[int, ...]] = None


class GeometricDepthModel(nn.Module):
    """``mode="unidepth"``: points from the pinhole unprojection of the
    predicted z-depth; ``mode="unik3d"``: unit rays x euclidean distance."""

    def __init__(self, encoder: str = "vitb", mode: str = "unidepth", attn_impl: str = "auto",
                 cfg: GeometricConfig = GeometricConfig()):
        super().__init__()
        if mode not in ("unidepth", "unik3d"):
            raise ValueError(f"unknown mode {mode!r}")
        # upstream UniDepth/UniK3D use DINOv2 with 4 register tokens
        vit_cfg = dataclasses.replace(cfg.vit_config or VIT_CONFIGS[encoder],
                                      num_register_tokens=4)
        dim = cfg.decoder_dim or DECODER_DIMS[encoder]
        num_heads = max(dim // 64, 1)
        out_indices = cfg.out_indices or INTERMEDIATE_LAYER_IDX[encoder]
        self.mode = mode
        self.patch_size = vit_cfg.patch_size
        self.pixel_encoder = DinoViT(vit_cfg, out_indices=out_indices, attn_impl=attn_impl)
        self.adapters = nn.ModuleList(nn.Linear(vit_cfg.dim, dim) for _ in out_indices)
        self.adapter_norm = nn.LayerNorm(dim, eps=1e-6)
        self.camera = CameraModule(dim, num_heads)
        self.ray_embed = RayEmbedding(dim)
        self.depth_module = DepthModule(dim, num_heads)
        if mode == "unik3d":
            self.rays_module = RaysModule(dim, num_heads)

    def int8_targets(self):
        """Every ``nn.Linear`` of the pixel encoder, as in the JAX package; the
        decoder keeps the compute type."""
        return linear_paths(self, "pixel_encoder")

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        _, H, W, _ = x.shape
        ph, pw = H // self.patch_size, W // self.patch_size
        feats = self.pixel_encoder(x)
        tokens = 0.0
        for adapter, (patch_tokens, _cls) in zip(self.adapters, feats):
            tokens = tokens + adapter(patch_tokens)
        tokens = self.adapter_norm(tokens)

        K = self.camera(tokens, (H, W))
        ray_emb = self.ray_embed(patch_center_rays(K, (H, W), (ph, pw)))
        value, confidence = self.depth_module(tokens, ray_emb, (ph, pw), (H, W))
        if self.mode == "unik3d":
            pts = self.rays_module(tokens, ray_emb, (ph, pw), (H, W)) * value[..., None]
        else:
            u, v = pixel_grid(H, W, torch.float32, x.device)
            rx = (u[None] - K[:, 0, 2, None, None]) / K[:, 0, 0, None, None]
            ry = (v[None] - K[:, 1, 2, None, None]) / K[:, 1, 1, None, None]
            pts = torch.stack([rx * value, ry * value, value], dim=-1)
        return {"pts_3d": pts, "confidence": confidence, "intrinsics": K}
