"""CoTracker3: online grid point tracking over sliding windows (counterpart
of the JAX package's ``models/cotracker3.py``).

Capability parity with reference ``later/CoTracker3/infer.py``: the online
model starts with ``(video_chunk, is_first_step=True, grid_size)`` and is
then called on chunks of ``2 * step`` frames, returning ``pred_tracks (B, T,
N, 2)`` and ``pred_visibility (B, T, N, 1)`` (``infer.py:22-28``;
``cotracker.step = window // 2``; the session is ``registry.py``'s
``CoTrackerPipeline``).

The published CoTracker design, as the JAX package reconstructs it:

* a stride-4 conv encoder per frame;
* per-track features sampled at the query points on the first frame;
* iterative transformer updates: multi-scale correlation between the track
  feature and a (2r+1)^2 window around the current estimate
  (:func:`corr_features`, the zero-padded bilinear gather of
  ``ops/flow_sampler.py``), factorized attention (over time per track, then
  over tracks per frame), then heads emitting coordinate, visibility and
  track-feature deltas.

Module names are the torch mirror's layout (``weights/manifests/
cotracker3.json``). Layouts are the JAX package's: frames ``(B, T, H, W,
3)`` in [0, 1], channels-last feature maps; the convolutions run NCHW. The
4 refinement iterations share one set of modules (a Python loop). Each
layer computes in the model's dtype on the parameters cast to it, but
``head_coord`` and ``head_vis``, which keep fp32 parameters and compute in
fp32 (:meth:`CoTracker3.cast`). The time and track attentions (head_dim 32)
are plain matmuls with the scores and softmax in fp32, as the JAX einsums;
no kernel is on this path.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from monocular_depth_estimation_trt_tpu_torch.ops.flow_sampler import (
    avg_pool2x2,
    bilinear_sample_nhwc,
)


class TrackerEncoder(nn.Module):
    """Per-frame stride-4 feature extractor: (B, H, W, 3) -> (B, H/4, W/4, dim)."""

    def __init__(self, dim: int = 128):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        self.conv2 = nn.Conv2d(64, 64, 3, 1, 1)
        self.conv3 = nn.Conv2d(64, 96, 3, 2, 1)
        self.conv4 = nn.Conv2d(96, 96, 3, 1, 1)
        self.conv5 = nn.Conv2d(96, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.conv1.weight.dtype).permute(0, 3, 1, 2)
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            x = F.relu(conv(x))
        return self.conv5(x).permute(0, 2, 3, 1)


def _window_offsets(radius: int, device) -> tuple:
    d = torch.arange(2 * radius + 1, dtype=torch.float32, device=device) - radius
    oy, ox = torch.meshgrid(d, d, indexing="ij")
    return ox.reshape(-1), oy.reshape(-1)  # (k*k,)


def corr_features(fmaps: torch.Tensor, coords: torch.Tensor, track_feat: torch.Tensor,
                  levels: int = 4, radius: int = 3) -> torch.Tensor:
    """Multi-scale correlation between each track's feature and windows
    around its current position.

    fmaps (BT, h, w, C) stride-4 features; coords (BT, N, 2) feature-grid
    (x, y); track_feat (BT, N, C). Returns (BT, N, levels*(2r+1)^2) fp32:
    the contraction and the division by sqrt(C) in fp32."""
    ox, oy = _window_offsets(radius, fmaps.device)
    c = fmaps.shape[-1]
    tf = track_feat.float()
    outs = []
    fm = fmaps
    for lvl in range(levels):
        scale = 2.0 ** lvl
        x = coords[..., 0:1] / scale + ox[None, None]
        y = coords[..., 1:2] / scale + oy[None, None]
        patches = bilinear_sample_nhwc(fm, x, y)  # (BT, N, K, C)
        outs.append((patches.float() @ tf[..., None])[..., 0] / math.sqrt(c))
        if lvl + 1 < levels:
            fm = avg_pool2x2(fm)
    return torch.cat(outs, dim=-1)


class FactorizedBlock(nn.Module):
    """Pre-norm attention over time (per track), then over tracks (per
    frame), then an MLP: the CoTracker factorized transformer block.
    LayerNorm eps 1e-6, exact GELU."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.norm_time = nn.LayerNorm(dim, eps=1e-6)
        self.time_qkv = nn.Linear(dim, 3 * dim)
        self.time_proj = nn.Linear(dim, dim)
        self.norm_track = nn.LayerNorm(dim, eps=1e-6)
        self.track_qkv = nn.Linear(dim, 3 * dim)
        self.track_proj = nn.Linear(dim, dim)
        self.norm_mlp = nn.LayerNorm(dim, eps=1e-6)
        self.mlp_fc1 = nn.Linear(dim, 4 * dim)
        self.mlp_fc2 = nn.Linear(4 * dim, dim)

    def _attn(self, x: torch.Tensor, qkv_mod: nn.Linear, proj_mod: nn.Linear) -> torch.Tensor:
        b, n, d = x.shape
        hd = d // self.num_heads
        q, k, v = qkv_mod(x).reshape(b, n, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
        att = (q @ k.transpose(-1, -2)).float()  # (b, h, n, n), scores in fp32
        att = torch.softmax(att / math.sqrt(hd), dim=-1)
        o = (att.to(v.dtype) @ v).transpose(1, 2).reshape(b, n, d)
        return proj_mod(o)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, N, D)."""
        b, t, n, d = x.shape
        # time attention: tokens (B*N, T, d)
        h = self.norm_time(x).transpose(1, 2).reshape(b * n, t, d)
        h = self._attn(h, self.time_qkv, self.time_proj)
        x = x + h.reshape(b, n, t, d).transpose(1, 2)
        # track attention: tokens (B*T, N, d)
        h = self._attn(self.norm_track(x).reshape(b * t, n, d), self.track_qkv, self.track_proj)
        x = x + h.reshape(b, t, n, d)
        h = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm_mlp(x))))
        return x + h


class CoTracker3(nn.Module):
    """One window: frames (B, T, H, W, 3) in [0, 1], queries (B, N, 2) pixel
    (x, y) on frame 0 -> dict(tracks (B, T, N, 2) pixels, visibility (B, T,
    N, 1) in [0, 1], track_feat (B, N, C)).

    ``init_coords``/``init_vis`` (B, T, N, 2)/(B, T, N) seed the estimates
    (sliding-window continuation, ``init_vis`` as log-odds);
    ``track_feat`` (B, N, C) overrides the frame-0 feature sample (tracks
    born in an earlier window)."""

    FP32_HEADS = ("head_coord", "head_vis")

    def __init__(self, dim: int = 128, d_model: int = 256, iters: int = 4, blocks: int = 3,
                 levels: int = 4, radius: int = 3, num_heads: int = 8, stride: int = 4):
        super().__init__()
        self.dim, self.iters = dim, iters
        self.levels, self.radius, self.stride = levels, radius, stride
        k2 = levels * (2 * radius + 1) ** 2
        self.encoder = TrackerEncoder(dim)
        self.in_proj = nn.Linear(k2 + 3 + dim, d_model)
        self.blocks = nn.ModuleList([FactorizedBlock(d_model, num_heads) for _ in range(blocks)])
        self.head_coord = nn.Linear(d_model, 2)
        self.head_vis = nn.Linear(d_model, 1)
        self.head_feat = nn.Linear(d_model, dim)

    def cast(self, device, dtype: torch.dtype) -> "CoTracker3":
        """Move to ``device``; every layer's parameters to ``dtype`` but the
        fp32 heads' (the JAX module's per-layer ``dtype``)."""
        for name, mod in self.named_children():
            mod.to(device=device, dtype=torch.float32 if name in self.FP32_HEADS else dtype)
        return self

    @property
    def dtype(self) -> torch.dtype:
        return self.in_proj.weight.dtype

    def forward(self, frames: torch.Tensor, queries: torch.Tensor,
                init_coords: Optional[torch.Tensor] = None, init_vis: Optional[torch.Tensor] = None,
                track_feat: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        b, t, H, W, _ = frames.shape
        n = queries.shape[1]
        dtype = self.dtype
        fmaps = self.encoder(frames.reshape(b * t, H, W, 3) * 2.0 - 1.0)  # (B*T, h, w, C)
        h, w = fmaps.shape[1:3]

        q_grid = queries / self.stride  # feature-grid coords
        if track_feat is None:
            f0 = fmaps.reshape(b, t, h, w, self.dim)[:, 0]
            track_feat = bilinear_sample_nhwc(f0, q_grid[..., 0], q_grid[..., 1])  # (B, N, C)
        if init_coords is None:
            coords = q_grid[:, None].expand(b, t, n, 2)
        else:
            coords = init_coords / self.stride
        vis = (torch.zeros((b, t, n), dtype=torch.float32, device=frames.device)
               if init_vis is None else init_vis.float())

        k2 = self.levels * (2 * self.radius + 1) ** 2
        norm = torch.stack([torch.full((), float(w), device=frames.device),
                            torch.full((), float(h), device=frames.device)])
        for _ in range(self.iters):
            # (B*T, N, C): each batch's features repeated over its T frames
            tf_rep = torch.repeat_interleave(track_feat, t, dim=0)
            corr = corr_features(fmaps, coords.reshape(b * t, n, 2), tf_rep, self.levels,
                                 self.radius)  # (B*T, N, k2) fp32
            rel = (coords - coords[:, :1]) / norm  # displacement from the query frame
            tokens = torch.cat([corr.reshape(b, t, n, k2), rel, vis[..., None],
                                track_feat[:, None].float().expand(b, t, n, self.dim)], dim=-1)
            z = self.in_proj(tokens.to(dtype))
            for blk in self.blocks:
                z = blk(z)
            coords = coords + self.head_coord(z.float())
            vis = vis + self.head_vis(z.float())[..., 0]
            df = self.head_feat(torch.mean(z, dim=1))  # (B, N, C)
            track_feat = track_feat + df.to(track_feat.dtype)

        return {"tracks": coords * self.stride, "visibility": torch.sigmoid(vis)[..., None],
                "track_feat": track_feat}
