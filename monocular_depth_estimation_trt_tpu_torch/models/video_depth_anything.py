"""Video Depth Anything: temporally consistent video depth (counterpart of
the JAX package's ``models/video_depth_anything.py``).

A DA-V2 DINOv2 encoder runs on every frame of a window, the T frames folded
into the batch (at 518² one pass of kernel K1 at (T, 1370, heads) per
block), and a DPT head with a pre-norm residual attention block over the
frame axis after each fusion stage (``temporal4`` .. ``temporal1``, the
stage each follows). Long videos run as overlapping windows stitched with a
least-squares scale/shift on the overlap and a linear cross-fade, on the
host (:func:`align_scale_shift`, :func:`stitch_window`,
:func:`window_starts`).

The temporal attention runs over T <= 32 frames with head_dim 8 (vits) or
32 (vitl) at every pixel of a fusion level: the JAX package runs it as
plain einsums outside any Pallas kernel, and so does the port, as plain
matmuls with the JAX numerics: the position encoding added in the compute
type, LayerNorm in fp32, the scores and the softmax in fp32 and the
probabilities cast back before P·V.

Module names follow the upstream layout of ``tests/torch_mirror_vda.py``
(``weights/manifests/video_depth_anything_vits.json``): ``pretrained``,
``depth_head.projects``/``resize_layers``/``scratch`` as DA-V2's, and
``depth_head.temporal{1..4}.{norm1,qkv,proj,norm2,fc1,fc2}``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from monocular_depth_estimation_trt_tpu_torch.models.depth_anything_v2 import (
    HEAD_CONFIGS,
    INTERMEDIATE_LAYER_IDX,
)
from monocular_depth_estimation_trt_tpu_torch.models.dpt import (
    _bilinear_ac,
    _Scratch,
    project_levels,
    resize_layers,
)
from monocular_depth_estimation_trt_tpu_torch.models.vit import VIT_CONFIGS, DinoViT, ViTConfig
from monocular_depth_estimation_trt_tpu_torch.ops.constants import device_cached

# upstream run.py serving constants (32-frame training window, 10-frame
# stitching overlap for super-long videos)
WINDOW = 32
OVERLAP = 10


def temporal_pos_encoding(t: int, dim: int) -> np.ndarray:
    """Sinusoidal position encoding over the frame axis, (T, dim) float32."""
    pos = np.arange(t, dtype=np.float32)[:, None]
    i = np.arange(dim // 2, dtype=np.float32)[None, :]
    freq = pos / np.power(10000.0, 2.0 * i / dim)
    pe = np.zeros((t, dim), np.float32)
    pe[:, 0::2] = np.sin(freq)
    pe[:, 1::2] = np.cos(freq)
    return pe


@device_cached
def _pos_encoding_on(t: int, dim: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(temporal_pos_encoding(t, dim)).to(device=device, dtype=dtype)


def _layernorm_fp32(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in fp32 (statistics and affine), cast back to x's type."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(x.dtype)


class TemporalAttentionBlock(nn.Module):
    """Pre-norm residual attention over the frame axis: (B, T, C, H, W) ->
    the same; every pixel attends over its own T steps ((B*H*W) sequences
    of length T)."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: int = 4):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = nn.Linear(dim, mlp_ratio * dim)
        self.fc2 = nn.Linear(mlp_ratio * dim, dim)

    def attention(self, y: torch.Tensor) -> torch.Tensor:
        """(S, T, C) normed tokens -> (S, T, C): scores in the compute type,
        then fp32 for the scale and the softmax, P cast back before P·V."""
        s, t, c = y.shape
        hd = c // self.num_heads
        q, k, v = self.qkv(y).view(s, t, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        a = torch.matmul(q, k.transpose(-1, -2)).float()
        p = torch.softmax(a / math.sqrt(hd), dim=-1).to(v.dtype)
        return torch.matmul(p, v).transpose(1, 2).reshape(s, t, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c, h, w = x.shape
        tok = x.permute(0, 3, 4, 1, 2).reshape(b * h * w, t, c)
        tok = tok + _pos_encoding_on(t, c, tok.dtype, tok.device)[None]
        tok = tok + self.proj(self.attention(_layernorm_fp32(self.norm1, tok)))
        y = F.gelu(self.fc1(_layernorm_fp32(self.norm2, tok)), approximate="none")
        tok = tok + self.fc2(y)
        return tok.reshape(b, h, w, t, c).permute(0, 3, 4, 1, 2)


class VDAHead(nn.Module):
    """DA-V2's DPT head with a temporal attention block after each fusion
    stage: the four taps' tokens of B*T frames -> depth (B*T, H, W) fp32,
    relu."""

    def __init__(self, in_channels: int, features: int = 64,
                 out_channels: Sequence[int] = (48, 96, 192, 384), patch_size: int = 14,
                 num_heads: int = 8):
        super().__init__()
        oc = list(out_channels)
        self.patch_size = patch_size
        self.projects = nn.ModuleList(nn.Conv2d(in_channels, c, 1) for c in oc)
        self.resize_layers = resize_layers(oc)
        self.scratch = _Scratch(oc, features, 1)
        for i in (1, 2, 3, 4):
            setattr(self, f"temporal{i}", TemporalAttentionBlock(features, num_heads))

    def _temporal(self, i: int, path: torch.Tensor, frames: int) -> torch.Tensor:
        bt, c, h, w = path.shape
        out = getattr(self, f"temporal{i}")(path.reshape(bt // frames, frames, c, h, w))
        return out.reshape(bt, c, h, w)

    def forward(self, features, patch_hw: Tuple[int, int], frames: int) -> torch.Tensor:
        ph, pw = patch_hw
        s = self.scratch
        l1, l2, l3, l4 = (getattr(s, f"layer{i + 1}_rn")(x)
                          for i, x in enumerate(project_levels(self, features, patch_hw)))
        path4 = self._temporal(4, s.refinenet4(l4, size=l3.shape[-2:]), frames)
        path3 = self._temporal(3, s.refinenet3(path4, l3, size=l2.shape[-2:]), frames)
        path2 = self._temporal(2, s.refinenet2(path3, l2, size=l1.shape[-2:]), frames)
        path1 = self._temporal(1, s.refinenet1(path2, l1), frames)
        out = _bilinear_ac(s.output_conv1(path1), (ph * self.patch_size, pw * self.patch_size))
        return F.relu(s.output_conv2(out).float())[:, 0]


class VideoDepthAnything(nn.Module):
    """One window: preprocessed video (B, T, H, W, 3) -> depth (B, T, H, W)
    float32. ``vit_config``, ``head_features``, ``head_out_channels`` and
    ``out_indices`` override the encoder presets (tests), as in the JAX
    module."""

    def __init__(self, encoder: str = "vits", num_heads: int = 8, attn_impl: str = "auto",
                 vit_config: Optional[ViTConfig] = None, head_features: Optional[int] = None,
                 head_out_channels: Optional[Sequence[int]] = None,
                 out_indices: Optional[Sequence[int]] = None):
        super().__init__()
        vit_cfg = vit_config or VIT_CONFIGS[encoder]
        head_cfg = HEAD_CONFIGS.get(encoder, {})
        self.patch_size = vit_cfg.patch_size
        self.pretrained = DinoViT(vit_cfg, out_indices=out_indices or INTERMEDIATE_LAYER_IDX[encoder],
                                  attn_impl=attn_impl)
        self.depth_head = VDAHead(vit_cfg.dim, head_features or head_cfg["features"],
                                  head_out_channels or head_cfg["out_channels"],
                                  vit_cfg.patch_size, num_heads)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        b, t, h, w, _ = video.shape
        ph, pw = h // self.patch_size, w // self.patch_size
        feats = self.pretrained(video.reshape(b * t, h, w, 3))
        depth = self.depth_head(feats, (ph, pw), t)
        return depth.reshape(b, t, *depth.shape[-2:])


def align_scale_shift(pred, target) -> Tuple[float, float]:
    """Least-squares (a, b) minimizing ||a*pred + b - target||² over every
    element of the overlap block; closed form, host numpy."""
    x = np.asarray(pred, np.float32).ravel()
    y = np.asarray(target, np.float32).ravel()
    n = x.size
    sx, sy = float(x.sum()), float(y.sum())
    sxx, sxy = float(x @ x), float(x @ y)
    det = n * sxx - sx * sx
    a = (n * sxy - sx * sy) / det if abs(det) > 1e-8 else 1.0
    b = (sy - a * sx) / n
    return a, b


def stitch_window(prev_tail, new, overlap: int) -> np.ndarray:
    """Scale/shift-align ``new`` (T_w, H, W) to the previous window on its
    first ``overlap`` frames (which re-predict ``prev_tail``, the previous
    window's last ``overlap`` frames), then cross-fade the overlap linearly.
    Returns the aligned window, ``new``'s shape."""
    prev_tail = np.asarray(prev_tail, np.float32)
    new = np.asarray(new, np.float32)
    a, b = align_scale_shift(new[:overlap], prev_tail)
    aligned = a * new + b
    wts = np.linspace(0.0, 1.0, overlap + 2, dtype=np.float32)[1:-1, None, None]
    faded = prev_tail * (1.0 - wts) + aligned[:overlap] * wts
    return np.concatenate([faded, aligned[overlap:]], axis=0)


def window_starts(n_frames: int, window: int, overlap: int) -> list:
    """Start indices of the overlapping windows covering ``n_frames``
    (upstream run.py slides by ``window - overlap``; the last window is
    right-aligned so that no frame index passes the video)."""
    if n_frames <= window:
        return [0]
    step = window - overlap
    starts = list(range(0, n_frames - window, step))
    starts.append(n_frames - window)
    return starts
