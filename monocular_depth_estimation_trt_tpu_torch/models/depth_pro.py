"""Apple Depth Pro: a multi-scale ViT patch encoder, a DPT-style decoder and
a field-of-view head (counterpart of the JAX package's
``models/depth_pro.py``).

Serving contract of the reference (``Depth_Pro/onnx2trt.py:96-165``): a
(1, 1536, 1536, 3) image normalized with mean = std = 0.5 in; the canonical
inverse depth (1, 1536, 1536) and the horizontal field of view in degrees
(1,) out, both float32.

A 3-level pyramid (1536 / 768 / 384): the two finer levels are split into
overlapping 384x384 windows (5x5 at full resolution, 3x3 at half), which go
with the 384 view through one shared ViT-L/16@384 patch encoder as one batch
of 35 windows of 577 tokens: 35 x 16 heads, the regime of attention kernel
K3 (``models/vit.py``). Raw taps at blocks 5 and 11 and the final normed
tap are merged back seam-free, projected and upsampled into a 5-level
pyramid, fused with a separate image encoder at 384 (its attention, one
window of 16 heads, goes to K1), decoded coarse to fine and finished by an
upconv head at 1536. The FoV head pools decoder features with the image
encoder's class token.

Module and parameter names are the key set of
``weights/manifests/depth_pro.json`` (780 keys), so a checkpoint in that
layout loads with a strict ``load_state_dict``. The image arrives
channels-last, as in the JAX package; the splits and merges work
channels-last, the convolutions NCHW.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from monocular_depth_estimation_trt_tpu_torch.models.dpt import FeatureFusionBlock
from monocular_depth_estimation_trt_tpu_torch.models.vit import DinoViT, ViTConfig
from monocular_depth_estimation_trt_tpu_torch.ops.quant import linear_paths
from monocular_depth_estimation_trt_tpu_torch.ops.resize import resize

VIT_L16_384 = ViTConfig(dim=1024, depth=24, num_heads=16, patch_size=16, pretrain_img_size=384)

# raw intermediate taps of the patch encoder (apple ml-depth-pro hook_block_ids, ViT-L)
HOOK_BLOCK_IDS = (5, 11)


def split_overlapping(x: torch.Tensor, patch: int, stride: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*k*k, patch, patch, C), windows in row-major order."""
    k = (x.shape[1] - patch) // stride + 1
    return torch.cat([x[:, i * stride:i * stride + patch, j * stride:j * stride + patch]
                      for i in range(k) for j in range(k)], dim=0)


def merge_overlapping(feats: torch.Tensor, k: int, stride_f: int) -> torch.Tensor:
    """Inverse of :func:`split_overlapping` in feature space: (k*k, h, h, C)
    window features that overlap by ``h - stride_f`` -> (1, k*stride_f + 2p,
    k*stride_f + 2p, C), with the margin ``p = (h - stride_f) / 2`` cropped
    from every interior seam."""
    kk, h = feats.shape[0], feats.shape[1]
    if kk != k * k:
        raise ValueError(f"{kk} windows for a {k}x{k} grid")
    p = (h - stride_f) // 2
    rows = []
    for i in range(k):
        top, bottom = (0 if i == 0 else p), (h if i == k - 1 else h - p)
        tiles = [feats[i * k + j, top:bottom, (0 if j == 0 else p):(h if j == k - 1 else h - p)]
                 for j in range(k)]
        rows.append(torch.cat(tiles, dim=1))
    return torch.cat(rows, dim=0)[None]


class ProjectUpsample(nn.Module):
    """1x1 projection without bias, then ``upsamples`` stride-2 transposed
    convolutions with kernel 2 (the JAX package's ``PixelShuffleUpsample``)."""

    def __init__(self, dim_in: int, dim_out: int, upsamples: int):
        super().__init__()
        self.proj = nn.Conv2d(dim_in, dim_out, 1, bias=False)
        self.ups = nn.ModuleList(nn.ConvTranspose2d(dim_out, dim_out, 2, 2)
                                 for _ in range(upsamples))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x)
        for up in self.ups:
            x = up(x)
        return x


class MultiresConvDecoder(nn.Module):
    """Projects each level (fine -> coarse) to ``features`` channels with a
    3x3 convolution where its width differs, then fuses from the coarsest
    level up."""

    def __init__(self, dims_in: Sequence[int], features: int = 256):
        super().__init__()
        self.convs = nn.ModuleDict({str(i): nn.Conv2d(d, features, 3, 1, 1, bias=False)
                                    for i, d in enumerate(dims_in) if d != features})
        self.fusions = nn.ModuleList(FeatureFusionBlock(features) for _ in dims_in)

    def forward(self, levels: Sequence[torch.Tensor]) -> torch.Tensor:
        x = [self.convs[str(i)](t) if str(i) in self.convs else t for i, t in enumerate(levels)]
        n = len(x)
        out = self.fusions[n - 1](x[-1], size=x[-2].shape[-2:])
        for i in range(n - 2, 0, -1):
            out = self.fusions[i](out, x[i], size=x[i - 1].shape[-2:])
        return self.fusions[0](out, x[0], size=x[0].shape[-2:])


class FOVNetwork(nn.Module):
    """Field-of-view head: decoder features and the image encoder's class
    token -> one angle in degrees per image, float32."""

    def __init__(self, features: int, vit_dim: int, grid: int):
        super().__init__()
        f = features
        self.down0 = nn.Conv2d(f, f // 2, 3, 2, 1)
        self.fov_proj = nn.Linear(vit_dim, f // 2)
        self.down1 = nn.Conv2d(f // 2, f // 4, 3, 2, 1)
        self.down2 = nn.Conv2d(f // 4, f // 8, 3, 2, 1)
        side = ((grid + 1) // 2 + 1) // 2  # after down1 and down2
        self.head = nn.Linear((f // 8) * side * side, 1)

    def forward(self, decoder_feat: torch.Tensor, fov_global: torch.Tensor,
                grid_hw: Tuple[int, int]) -> torch.Tensor:
        x = F.relu(self.down0(decoder_feat))
        # pool to the encoder grid: half-pixel linear, no antialias, as the JAX head
        x = resize(x.permute(0, 2, 3, 1), grid_hw, method="linear").permute(0, 3, 1, 2)
        x = x + self.fov_proj(fov_global)[:, :, None, None]
        x = F.relu(self.down1(x))
        x = F.relu(self.down2(x))
        # NCHW flatten: the head Linear is stored against (C, H, W) order
        return self.head(x.flatten(1))[:, 0].float()


@dataclasses.dataclass(frozen=True)
class DepthProConfig:
    """Geometry of the pyramid. The default is the upstream ViT-L/16@384
    layout (1536 input, 384 windows, 25 + 9 + 1 views); smaller presets keep
    every ratio (window = 4x the stride margins, 5x5 and 3x3 grids)."""

    img_size: int = 1536
    window: int = 384
    stride0: int = 288  # full-resolution split stride (25 windows)
    stride1: int = 192  # half-resolution split stride (9 windows)
    vit_config: Optional[ViTConfig] = None
    hook_block_ids: Tuple[int, int] = HOOK_BLOCK_IDS

    @property
    def vit(self) -> ViTConfig:
        return self.vit_config or VIT_L16_384


class DepthPro(nn.Module):
    """Input (1, S, S, 3) normalized (mean = std = 0.5), S = ``cfg.img_size``.
    Returns (canonical_inverse_depth (1, S, S), fov_deg (1,)), float32."""

    def __init__(self, cfg: DepthProConfig = DepthProConfig(), decoder_features: int = 256,
                 dims_encoder: Sequence[int] = (256, 512, 1024, 1024),
                 attn_impl: str = "auto"):
        super().__init__()
        self.cfg = cfg
        vit = cfg.vit
        self.grid = cfg.window // vit.patch_size  # encoder grid (24)
        final = vit.depth - 1
        self.patch_encoder = DinoViT(vit, out_indices=(*cfg.hook_block_ids, final),
                                     attn_impl=attn_impl, raw_indices=cfg.hook_block_ids)
        self.image_encoder = DinoViT(vit, out_indices=(final,), attn_impl=attn_impl)
        de = tuple(dims_encoder)
        self.upsample_latent0 = ProjectUpsample(vit.dim, de[0], 3)  # 768
        self.upsample_latent1 = ProjectUpsample(vit.dim, de[0], 2)  # 384
        self.upsample0 = ProjectUpsample(vit.dim, de[1], 1)  # 192
        self.upsample1 = ProjectUpsample(vit.dim, de[2], 1)  # 96
        self.upsample2 = ProjectUpsample(vit.dim, de[3], 1)  # 48
        self.upsample_lowres = nn.ConvTranspose2d(vit.dim, de[3], 2, 2)
        self.fuse_lowres = nn.Conv2d(2 * de[3], de[3], 1)
        f = decoder_features
        self.decoder = MultiresConvDecoder((de[0], de[0], de[1], de[2], de[3]), f)
        self.head_conv0 = nn.Conv2d(f, f // 2, 3, 1, 1)
        self.head_up = nn.ConvTranspose2d(f // 2, f // 2, 2, 2)
        self.head_conv1 = nn.Conv2d(f // 2, 32, 3, 1, 1)
        self.head_conv2 = nn.Conv2d(32, 1, 1)
        self.fov = FOVNetwork(f, vit.dim, self.grid)

    def int8_targets(self):
        """The layers that int8 serving quantizes: every ``nn.Linear`` of
        the two ViT encoders, as in the JAX package. The decoder and the FoV
        network keep the compute type."""
        return linear_paths(self, "patch_encoder", "image_encoder")

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        if tuple(x.shape[1:3]) != (c.img_size, c.img_size):
            raise ValueError(f"Depth Pro takes (1, {c.img_size}, {c.img_size}, 3), "
                             f"got {tuple(x.shape)}")
        g = self.grid
        patch = c.vit.patch_size
        s0f, s1f = c.stride0 // patch, c.stride1 // patch  # merge strides (18, 12)
        k0 = (c.img_size - c.window) // c.stride0 + 1  # 5
        k1 = (c.img_size // 2 - c.window) // c.stride1 + 1  # 3
        n0, n1 = k0 * k0, k1 * k1

        # image pyramid: half-pixel linear, no antialias
        x1 = resize(x, (c.img_size // 2, c.img_size // 2), method="linear")
        x2 = resize(x, (c.window, c.window), method="linear")
        patches = torch.cat([split_overlapping(x, c.window, c.stride0),
                             split_overlapping(x1, c.window, c.stride1), x2], dim=0)
        (h0, _), (h1, _), (fin, _) = self.patch_encoder(patches)

        def grid(t):  # tokens (B, g*g, C) -> (B, g, g, C)
            return t.reshape(t.shape[0], g, g, t.shape[-1])

        def nchw(t):
            return t.permute(0, 3, 1, 2)

        latent0 = nchw(merge_overlapping(grid(h0[:n0]), k0, s0f))
        latent1 = nchw(merge_overlapping(grid(h1[:n0]), k0, s0f))
        f0 = nchw(merge_overlapping(grid(fin[:n0]), k0, s0f))
        f1 = nchw(merge_overlapping(grid(fin[n0:n0 + n1]), k1, s1f))
        f_global = nchw(grid(fin[n0 + n1:]))

        img_feat, img_cls = self.image_encoder(x2)[0]
        lowres = self.upsample_lowres(nchw(grid(img_feat)))
        levels: List[torch.Tensor] = [
            self.upsample_latent0(latent0),
            self.upsample_latent1(latent1),
            self.upsample0(f0),
            self.upsample1(f1),
            self.fuse_lowres(torch.cat([self.upsample2(f_global), lowres], dim=1)),
        ]
        decoded = self.decoder(levels)  # (1, f, 768, 768)

        y = self.head_up(self.head_conv0(decoded))  # 768 -> 1536
        y = F.relu(self.head_conv1(y))
        canonical_inverse_depth = F.relu(self.head_conv2(y))[:, 0].float()
        fov_deg = self.fov(decoded, img_cls, (g, g))
        return canonical_inverse_depth, fov_deg
