"""VGGT: multi-view geometry transformer, aggregator + depth and camera heads
(counterpart of the JAX package's ``models/vggt.py``).

Views ``(B, S, H, W, 3)``, normalized, channels-last, go through:

* a DINOv2 ViT-L/14 patch embed (the port's ``DinoViT``, attention by
  kernel K1), one frame at a time (batch ``B*S``);
* 1 camera token + 4 register tokens + the patch tokens per view (1374 at
  518²), and 24 alternating-attention blocks: *frame* attention within each
  view (batch ``B*S``), then *global* attention over all views of a batch
  item (batch ``B``, ``S*1374`` tokens). Both rotate q and k of the patch
  tokens with 2D RoPE (integer grid coordinates) and attend through kernel
  K2; the special tokens stay unrotated;
* a DPT head over the frame‖global concatenation of blocks (4, 11, 17, 23):
  depth ``exp`` and confidence ``1 + exp`` per view;
* an iterative adaLN camera head on the camera token: ``pose_enc`` =
  [tx ty tz, qx qy qz qw, fov_h fov_w] per view (quaternion scalar-last);
* optionally the upstream point head (STream3R): world points by the
  sign-preserving ``inv_log`` and their confidence.

``VGGTConfig(causal=True)`` makes the global attention view-causal
(StreamVGGT, STream3R): a token of view s attends to views <= s. K2 takes no
mask, so that attention runs plain, on every device, as in the JAX package;
over one view the mask allows everything and the attention stays on K2.
``models/streamvggt.py`` steps the same weights one view at a time.

Module and parameter names follow the upstream checkpoint
(``weights/manifests/vggt.json``, ``stream3r.json`` with the point head),
so a VGGT ``state_dict`` loads with a plain ``load_state_dict``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from monocular_depth_estimation_trt_tpu_torch.models.dpt import DPTHead
from monocular_depth_estimation_trt_tpu_torch.ops.constants import device_cached
from monocular_depth_estimation_trt_tpu_torch.models.vit import (
    VIT_CONFIGS,
    DinoViT,
    LayerScale,
    Mlp,
    _apply_rope,
)
from monocular_depth_estimation_trt_tpu_torch.ops.cuda.flash_attention import (
    attention_reference,
    flash_attention,
)
from monocular_depth_estimation_trt_tpu_torch.ops.quant import linear_paths


def rope_2d_freqs(ph: int, pw: int, head_dim: int, base: float = 100.0,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """2D rotary position tables for a (ph, pw) patch grid at integer
    coordinates. Half the head dims rotate with y, half with x. Returns fp32
    (cos, sin), each (ph*pw, head_dim//2), made once per arguments and
    shared: do not write to them."""
    return _rope_2d_freqs(ph, pw, head_dim, float(base), torch.device(device or "cpu"))


@device_cached
def _rope_tables(ph: int, pw: int, head_dim: int, dtype: torch.dtype, device: torch.device):
    """The tables as RopeAttention broadcasts them: (P, 1, 1, d/2) in ``dtype``."""
    cos, sin = rope_2d_freqs(ph, pw, head_dim, device=device)
    return cos.to(dtype)[:, None, None], sin.to(dtype)[:, None, None]


@device_cached
def _rope_2d_freqs(ph: int, pw: int, head_dim: int, base: float, device: torch.device):
    d4 = head_dim // 4
    freqs = torch.tensor(1.0 / (base ** (np.arange(d4) / d4)), dtype=torch.float32,
                         device=device)
    ys = torch.arange(ph, dtype=torch.float32, device=device).repeat_interleave(pw)
    xs = torch.arange(pw, dtype=torch.float32, device=device).repeat(ph)
    ang = torch.cat([ys[:, None] * freqs[None], xs[:, None] * freqs[None]], dim=-1)
    return torch.cos(ang), torch.sin(ang)


# the rotation of the rope ViT, under the JAX module's public name
apply_rope = _apply_rope


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     allowed: torch.Tensor) -> torch.Tensor:
    """Plain attention on ``(B, H, N, d)`` with a boolean mask that
    broadcasts against the (B, H, Nq, Nk) scores: scores in the operand
    type, then fp32 divided by sqrt(d), -inf where the mask is False, fp32
    softmax, P cast back before P.V (the JAX package's masked attention in
    ``models/vggt.py`` and ``models/streamvggt.py``). No kernel takes a
    mask; this runs on every device."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float()  # a new fp32 tensor: scaled in place
    s.div_(math.sqrt(q.shape[-1])).masked_fill_(~allowed, float("-inf"))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


@device_cached
def _view_causal_mask(views: int, n_view: int, device: torch.device) -> torch.Tensor:
    """(N, N) bool, N = views * n_view: True where the key's view is not
    after the query's."""
    vid = torch.arange(views * n_view, device=device) // n_view
    return vid[:, None] >= vid[None, :]


class RopeAttention(nn.Module):
    """Self-attention with 2D RoPE on the patch tokens of each view; the
    leading ``num_special`` tokens of a view (camera + registers) stay
    unrotated.

    Routes: ``attn_impl="xla"`` is the plain attention of the JAX package's
    CPU path; any other value goes to kernel K2 (on a CPU tensor its plain
    version). The rotation works on the qkv output's own layout, and K2
    reads q, k and v as strided views of it: no per-head copy is made.
    ``causal`` over more than one view takes :func:`masked_attention` with
    the view-causal mask, whatever ``attn_impl``."""

    def __init__(self, dim: int, num_heads: int, num_special: int,
                 attn_impl: str = "auto"):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.num_special = num_special
        self.attn_impl = attn_impl
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def rotated_qkv(self, x: torch.Tensor, grid_hw: Tuple[int, int], views: int = 1):
        """(q, k, v), each (B, H, N, d): q and k rotated, all three strided
        views of the qkv output or of the rotated copy."""
        b, n, _ = x.shape
        h, hd = self.num_heads, self.dim // self.num_heads
        ph, pw = grid_hw
        n_view = self.num_special + ph * pw
        qkv = self.qkv(x).view(b, n, 3, h, hd)

        cos, sin = _rope_tables(ph, pw, hd, x.dtype, x.device)  # over (q|k, heads)
        qk = qkv[:, :, :2].view(b, views, n_view, 2, h, hd)
        special, patches = qk[:, :, : self.num_special], qk[:, :, self.num_special:]
        qk = torch.cat([special, apply_rope(patches, cos, sin)], dim=2).view(b, n, 2, h, hd)
        return (qk[:, :, 0].transpose(1, 2), qk[:, :, 1].transpose(1, 2),
                qkv[:, :, 2].transpose(1, 2))

    def forward(self, x: torch.Tensor, grid_hw: Tuple[int, int],
                views: int = 1, causal: bool = False) -> torch.Tensor:
        b, n, _ = x.shape
        q, k, v = self.rotated_qkv(x, grid_hw, views)
        if causal and views > 1:
            allowed = _view_causal_mask(views, n // views, x.device)
            o = masked_attention(q, k, v, allowed)
        elif self.attn_impl == "xla":
            o = attention_reference(q, k, v)
        else:
            o = flash_attention(q, k, v)
        return self.proj(o.transpose(1, 2).reshape(b, n, self.dim))


class AASubBlock(nn.Module):
    """One pre-norm transformer block with RoPE attention (frame or global)."""

    def __init__(self, dim: int, num_heads: int, num_special: int,
                 attn_impl: str = "auto", attn_cls: type = RopeAttention):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = attn_cls(dim, num_heads, num_special, attn_impl)
        self.ls1 = LayerScale(dim, 0.01)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, dim * 4)
        self.ls2 = LayerScale(dim, 0.01)

    def forward(self, x: torch.Tensor, grid_hw: Tuple[int, int],
                views: int = 1, causal: bool = False) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x), grid_hw, views, causal))
        x = x + self.ls2(self.mlp(self.norm2(x)))
        return x


@dataclasses.dataclass(frozen=True)
class VGGTConfig:
    dim: int = 1024
    depth: int = 24  # alternating-attention blocks (each = frame + global)
    num_heads: int = 16
    patch_size: int = 14
    num_register_tokens: int = 4
    head_layers: Tuple[int, ...] = (4, 11, 17, 23)
    encoder: str = "vitl"  # DINOv2 patch-feature extractor
    # explicit ViT override for tiny test configs; None -> VIT_CONFIGS[encoder]
    vit_config: Any = None
    head_features: int = 256
    head_out_channels: Tuple[int, ...] = (256, 512, 1024, 1024)
    # view-causal global attention (StreamVGGT, STream3R); the KV-cache
    # stream of models/streamvggt.py computes the same thing view by view
    causal: bool = False


class Aggregator(nn.Module):
    """Views (B, S, H, W, 3) normalized -> list of per-selected-layer tokens
    (B, S, n_view, 2*dim) (the frame‖global concatenation) and (ph, pw)."""

    # parameters that random init draws from normal(0.02), as the JAX
    # module's initializers do (weights/store.py::init_random_)
    normal_init = ("camera_token", "register_tokens")

    def __init__(self, cfg: VGGTConfig = VGGTConfig(), attn_impl: str = "auto",
                 global_block: type = AASubBlock):
        super().__init__()
        c = cfg
        self.cfg = cfg
        vit_cfg = c.vit_config or VIT_CONFIGS[c.encoder]
        self.patch_embed = DinoViT(vit_cfg, out_indices=(vit_cfg.depth - 1,),
                                   attn_impl=attn_impl)
        if vit_cfg.dim != c.dim:
            self.input_proj = nn.Linear(vit_cfg.dim, c.dim)
        self.camera_token = nn.Parameter(torch.zeros(1, 1, c.dim))
        self.register_tokens = nn.Parameter(torch.zeros(1, c.num_register_tokens, c.dim))
        num_special = 1 + c.num_register_tokens
        self.frame_blocks = nn.ModuleList(
            AASubBlock(c.dim, c.num_heads, num_special, attn_impl) for _ in range(c.depth))
        self.global_blocks = nn.ModuleList(
            global_block(c.dim, c.num_heads, num_special, attn_impl) for _ in range(c.depth))

    def tokens(self, frames: torch.Tensor) -> torch.Tensor:
        """Frames (F, H, W, 3) -> the camera, register and patch tokens of
        each, (F, n_view, dim)."""
        c = self.cfg
        f = frames.shape[0]
        patch_tokens = self.patch_embed(frames)[0][0]
        if hasattr(self, "input_proj"):
            patch_tokens = self.input_proj(patch_tokens)
        return torch.cat([
            self.camera_token.expand(f, 1, c.dim),
            self.register_tokens.expand(f, c.num_register_tokens, c.dim),
            patch_tokens,
        ], dim=1)

    def forward(self, views: torch.Tensor) -> Tuple[List[torch.Tensor], Tuple[int, int]]:
        c = self.cfg
        b, s, H, W, _ = views.shape
        ph, pw = H // c.patch_size, W // c.patch_size
        tokens = self.tokens(views.reshape(b * s, H, W, 3))  # (B*S, n_view, dim)
        n_view = tokens.shape[1]

        saved: Dict[int, torch.Tensor] = {}
        x = tokens
        for i in range(c.depth):
            x = self.frame_blocks[i](x, (ph, pw), views=1)  # within each view
            frame_out = x
            xg = self.global_blocks[i](x.reshape(b, s * n_view, c.dim), (ph, pw), views=s,
                                       causal=c.causal)
            x = xg.reshape(b * s, n_view, c.dim)
            if i in c.head_layers:
                saved[i] = torch.cat([frame_out, x], dim=-1).reshape(b, s, n_view, 2 * c.dim)
        # duplicates and any order allowed, as in DinoViT's taps
        return [saved[i] for i in c.head_layers], (ph, pw)


class CameraBlock(nn.Module):
    """One trunk block of the camera head. Its attention runs over the S
    camera tokens (head_dim 128), outside any kernel, as in the JAX package;
    ``key_mask`` (S,) bool leaves out the keys where it is False (the
    streaming session's empty ring slots)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.ls1 = LayerScale(dim, 0.01)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, dim * 4)
        self.ls2 = LayerScale(dim, 0.01)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, dim = x.shape
        hd = dim // self.num_heads
        qkv = self.qkv(self.norm1(x)).view(b, s, 3, self.num_heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # (B, H, S, d)
        if key_mask is None:
            o = attention_reference(q, k, v)
        else:
            o = masked_attention(q, k, v, key_mask)
        o = o.transpose(1, 2).reshape(b, s, dim)
        x = x + self.ls1(self.proj(o))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PoseBranch(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim // 2)
        self.fc2 = nn.Linear(dim // 2, 9)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class CameraHead(nn.Module):
    """Iterative camera head (upstream VGGT ``camera_head.py`` design): the
    camera tokens pass through a trunk whose input is adaLN-modulated by an
    embedding of the current pose estimate; each iteration adds a pose
    delta. Output (B, S, 9): [tx ty tz, qx qy qz qw, fov_h fov_w], trans and
    quat linear, fov relu; the quaternion is left unnormalized."""

    def __init__(self, dim: int = 2048, trunk_depth: int = 4, num_heads: int = 16,
                 num_iterations: int = 4):
        super().__init__()
        self.num_iterations = num_iterations
        self.token_norm = nn.LayerNorm(dim, eps=1e-6)
        self.embed_pose = nn.Linear(9, dim)
        self.poseLN_modulation = nn.Linear(dim, 3 * dim)
        self.adaln_norm = nn.LayerNorm(dim, eps=1e-6, elementwise_affine=False)
        self.trunk = nn.ModuleList(CameraBlock(dim, num_heads) for _ in range(trunk_depth))
        self.pose_branch = PoseBranch(dim)

    def forward(self, tokens: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens: the last aggregated layer (B, S, N, 2dim), whose first
        token per view is the camera token, or camera tokens (B, S, 2dim);
        ``key_mask`` (S,) bool: the views the trunk's attention may read (the
        streaming session's filled ring slots)."""
        cam = tokens[:, :, 0] if tokens.dim() == 4 else tokens
        b, s, _ = cam.shape
        pose_tokens = self.token_norm(cam)
        pred = torch.zeros((b, s, 9), dtype=torch.float32, device=cam.device)
        for _ in range(self.num_iterations):
            emb = F.silu(self.embed_pose(pred.to(pose_tokens.dtype)))
            shift, scale, gate = self.poseLN_modulation(emb).chunk(3, dim=-1)
            x = pose_tokens + gate * (self.adaln_norm(pose_tokens) * (1.0 + scale) + shift)
            for blk in self.trunk:
                x = blk(x, key_mask)
            pred = pred + self.pose_branch(x).float()
        t, quat, fov = pred[..., :3], pred[..., 3:7], pred[..., 7:9]
        return torch.cat([t, quat, F.relu(fov)], dim=-1)


def apply_view_dpt(dpt: DPTHead, agg_tokens: Sequence[torch.Tensor],
                   patch_hw: Tuple[int, int], num_special: int):
    """Run a DPT trunk over multi-view aggregated tokens: fold (B, S) into
    the batch and drop the special tokens. Returns the raw head output
    (B*S, ph*p, pw*p, C) and (b, s)."""
    ph, pw = patch_hw
    b, s = agg_tokens[0].shape[:2]
    feats = [(t[:, :, num_special:].reshape(b * s, ph * pw, t.shape[-1]), None)
             for t in agg_tokens]
    return dpt(feats, (ph, pw)), b, s


class VGGTDepthHead(nn.Module):
    """One 2-channel DPT head over the aggregated tokens: depth
    ``exp(clip(., ±10))`` and confidence ``1 + exp(clip(., ±10))`` per view."""

    def __init__(self, in_channels: int, features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 patch_size: int = 14):
        super().__init__()
        self.dpt = DPTHead(in_channels, features, out_channels, patch_size,
                           final_act="none", num_outputs=2, nested_scratch=False)

    def forward(self, agg_tokens, patch_hw: Tuple[int, int], num_special: int):
        ph, pw = patch_hw
        out, b, s = apply_view_dpt(self.dpt, agg_tokens, patch_hw, num_special)
        depth = torch.exp(torch.clamp(out[..., 0], -10.0, 10.0))
        conf = 1.0 + torch.exp(torch.clamp(out[..., 1], -10.0, 10.0))
        hw = (ph * self.dpt.patch_size, pw * self.dpt.patch_size)
        return depth.reshape(b, s, *hw), conf.reshape(b, s, *hw)


def pts_conf(out4: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A 4-channel dense output (..., 4) -> points ``sign(u) * expm1(|u|)``
    (``inv_log``, |u| clipped to 10) and confidence ``1 + exp(clip(., ±10))``."""
    xyz = out4[..., :3]
    pts = torch.sign(xyz) * torch.expm1(torch.clamp(xyz.abs(), 0.0, 10.0))
    return pts, 1.0 + torch.exp(torch.clamp(out4[..., 3], -10.0, 10.0))


class VGGTPointHead(nn.Module):
    """Upstream VGGT's second dense head (STream3R's per-frame point maps):
    a 4-channel DPT head -> world points (B, S, H, W, 3) by :func:`pts_conf`
    and their confidence (B, S, H, W)."""

    def __init__(self, in_channels: int, features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 patch_size: int = 14):
        super().__init__()
        self.dpt = DPTHead(in_channels, features, out_channels, patch_size,
                           final_act="none", num_outputs=4, nested_scratch=False)

    def forward(self, agg_tokens, patch_hw: Tuple[int, int], num_special: int):
        ph, pw = patch_hw
        out, b, s = apply_view_dpt(self.dpt, agg_tokens, patch_hw, num_special)
        pts, conf = pts_conf(out)
        hw = (ph * self.dpt.patch_size, pw * self.dpt.patch_size)
        return pts.reshape(b, s, *hw, 3), conf.reshape(b, s, *hw)


class VGGT(nn.Module):
    """Views (B, S, H, W, 3) -> dict(depth (B, S, H, W), depth_conf,
    world_points (B, S, H, W, 3) and world_points_conf when
    ``with_point_head``, and pose_enc (B, S, 9) when ``with_camera``)."""

    def __init__(self, cfg: VGGTConfig = VGGTConfig(), attn_impl: str = "auto",
                 with_camera: bool = True, with_point_head: bool = False,
                 global_block: type = AASubBlock):
        super().__init__()
        self.cfg = cfg
        self.with_camera = with_camera
        self.with_point_head = with_point_head
        self.aggregator = Aggregator(cfg, attn_impl, global_block)
        self.depth_head = VGGTDepthHead(2 * cfg.dim, cfg.head_features,
                                        cfg.head_out_channels, cfg.patch_size)
        if with_point_head:
            self.point_head = VGGTPointHead(2 * cfg.dim, cfg.head_features,
                                            cfg.head_out_channels, cfg.patch_size)
        if with_camera:
            self.camera_head = CameraHead(2 * cfg.dim, num_heads=cfg.num_heads)

    def int8_targets(self):
        """The layers that int8 serving quantizes: every ``nn.Linear`` of the
        aggregator (the DINOv2 patch embed's blocks, ``input_proj`` where it
        exists, the frame and global blocks), as in the JAX package. The
        depth and camera heads keep the compute type."""
        return linear_paths(self, "aggregator")

    def forward(self, views: torch.Tensor) -> Dict[str, torch.Tensor]:
        agg, patch_hw = self.aggregator(views)
        num_special = 1 + self.cfg.num_register_tokens
        depth, conf = self.depth_head(agg, patch_hw, num_special)
        out = {"depth": depth, "depth_conf": conf}
        if self.with_point_head:
            out["world_points"], out["world_points_conf"] = self.point_head(
                agg, patch_hw, num_special)
        if self.with_camera:
            out["pose_enc"] = self.camera_head(agg[-1])
        return out


def build_stage_pipeline(model: VGGT):
    """The reference's three-engine chain (``VGGT/onnx2trt2.py:155-208``) as a
    :class:`~monocular_depth_estimation_trt_tpu_torch.runtime.pipeline.DevicePipeline`
    on ``model``'s weights: aggregator -> (depth_head, camera_head), the
    tokens of the head layers stacked into one device tensor (4, B, S, n,
    2 * dim) between the stages. Views (B, S, H, W, 3), normalized and
    square (the heads read the patch grid off the token count, as the JAX
    stages do)."""
    from monocular_depth_estimation_trt_tpu_torch.runtime.pipeline import DevicePipeline, Stage

    num_special = 1 + model.cfg.num_register_tokens

    def patch_hw(tokens: torch.Tensor) -> Tuple[int, int]:
        side = int(round((tokens.shape[3] - num_special) ** 0.5))
        return side, side

    def aggregator(views):
        return torch.stack(model.aggregator(views)[0])

    def depth_head(tokens):
        return model.depth_head(list(tokens), patch_hw(tokens), num_special)

    stages = [Stage("aggregator", aggregator, ["views"], ["tokens"]),
              Stage("depth_head", depth_head, ["tokens"], ["depth", "depth_conf"])]
    if model.with_camera:
        stages.append(Stage("camera_head", lambda tokens: model.camera_head(tokens[-1]),
                            ["tokens"], ["pose_enc"]))
    return DevicePipeline(stages)
