"""MapAnything: multi-view metric 3D reconstruction (counterpart of the JAX
package's ``models/map_anything.py`` and of the ``compose`` step of its
``map_anything`` registry entry).

Geometry is factored as rays x depth-along-ray x one metric scale:

* the VGGT aggregator (frame/global alternating attention, 2D RoPE) as the
  multi-view trunk, its patch embed on kernel K1 and its attention on K2;
* a 6-channel DPT head: ray directions (unit, +z forward), log
  depth-along-ray, confidence (``1 + exp``) and mask logits per view;
* the VGGT camera head (cam2world pose encodings, XYZW quaternion);
* a scalar metric-scale head on the views' mean camera token (``exp``), in
  fp32 as in the JAX package (its weights in the module's own type).

:func:`compose` turns these into the reference's per-view output set
(``later/Map_Anything/infer.py:43-68``) on the device. Parameter names are
upstream's (``weights/manifests/map_anything.json``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from monocular_depth_estimation_trt_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from monocular_depth_estimation_trt_tpu_torch.models.dpt import DPTHead
from monocular_depth_estimation_trt_tpu_torch.models.vggt import (
    Aggregator,
    CameraHead,
    VGGTConfig,
    apply_view_dpt,
)
from monocular_depth_estimation_trt_tpu_torch.ops.camera import extrinsics_from_quat_trans
from monocular_depth_estimation_trt_tpu_torch.ops.constants import device_constant
from monocular_depth_estimation_trt_tpu_torch.ops.quant import linear_paths


class MapAnythingDenseHead(nn.Module):
    """6-channel DPT over the aggregated tokens -> per view ray directions
    (B, S, H, W, 3), depth along the ray, confidence and mask logits
    (B, S, H, W)."""

    def __init__(self, in_channels: int, features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024), patch_size: int = 14):
        super().__init__()
        self.dpt = DPTHead(in_channels, features, out_channels, patch_size,
                           final_act="none", num_outputs=6, nested_scratch=False)

    def forward(self, agg_tokens, patch_hw: Tuple[int, int], num_special: int):
        ph, pw = patch_hw
        out, b, s = apply_view_dpt(self.dpt, agg_tokens, patch_hw, num_special)
        hw = (ph * self.dpt.patch_size, pw * self.dpt.patch_size)
        ray = torch.cat([out[..., 0:2], F.softplus(out[..., 2:3]) + 1e-3], dim=-1)
        ray = ray / torch.linalg.vector_norm(ray, dim=-1, keepdim=True)
        dar = torch.exp(torch.clamp(out[..., 3], -10.0, 10.0))
        conf = 1.0 + torch.exp(torch.clamp(out[..., 4], -10.0, 10.0))
        return (ray.reshape(b, s, *hw, 3), dar.reshape(b, s, *hw), conf.reshape(b, s, *hw),
                out[..., 5].reshape(b, s, *hw))


class MapAnything(nn.Module):
    """Views (B, S, H, W, 3), normalized -> dict(ray_directions,
    depth_along_ray, conf, mask_logits, pose_enc (B, S, 9; cam2world),
    metric_scaling_factor (B,))."""

    def __init__(self, cfg: VGGTConfig = VGGTConfig(), attn_impl: str = "auto"):
        super().__init__()
        self.cfg = cfg
        self.aggregator = Aggregator(cfg, attn_impl)
        self.dense_head = MapAnythingDenseHead(2 * cfg.dim, cfg.head_features,
                                               cfg.head_out_channels, cfg.patch_size)
        self.camera_head = CameraHead(2 * cfg.dim, num_heads=cfg.num_heads)
        self.scale_fc1 = nn.Linear(2 * cfg.dim, 256)
        self.scale_fc2 = nn.Linear(256, 1)

    def int8_targets(self):
        """Every ``nn.Linear`` of the aggregator, as in the JAX package; the
        dense, camera and scale heads keep their type."""
        return linear_paths(self, "aggregator")

    def forward(self, views: torch.Tensor) -> Dict[str, torch.Tensor]:
        agg, patch_hw = self.aggregator(views)
        num_special = 1 + self.cfg.num_register_tokens
        ray, dar, conf, logits = self.dense_head(agg, patch_hw, num_special)
        pose_enc = self.camera_head(agg[-1])
        # one metric scale per scene from the mean camera token, in fp32
        pooled = agg[-1][:, :, 0].float().mean(dim=1)
        h = F.linear(pooled, self.scale_fc1.weight.float(), self.scale_fc1.bias.float())
        msf = F.linear(F.gelu(h, approximate="none"), self.scale_fc2.weight.float(),
                       self.scale_fc2.bias.float())
        return {"ray_directions": ray, "depth_along_ray": dar, "conf": conf,
                "mask_logits": logits, "pose_enc": pose_enc,
                "metric_scaling_factor": torch.exp(torch.clamp(msf[..., 0], -10.0, 10.0))}


def compose(out: Dict[str, torch.Tensor], views: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The model's raw outputs and its normalized input views (B, S, H, W, 3)
    -> the reference's per-view output set: world and camera points, z depth,
    depth along the ray (metric), ray directions, intrinsics from the fovs,
    cam2world poses (4x4, translation scaled), quaternions, confidence,
    masks and logits, the scale, and the de-normalized image."""
    b, s, H, W, _ = views.shape
    msf = out["metric_scaling_factor"][:, None]  # (B, 1)
    ray = out["ray_directions"]
    dar = out["depth_along_ray"] * msf[..., None, None]
    pts_cam = ray * dar[..., None]
    pose = out["pose_enc"]
    rt = extrinsics_from_quat_trans(pose[..., 3:7], pose[..., :3])
    rot, trans = rt[..., :3], rt[..., 3] * msf[..., None]
    pts_world = torch.einsum("bsij,bshwj->bshwi", rot, pts_cam) + trans[:, :, None, None]
    fy = H / (2.0 * torch.tan(torch.clamp(pose[..., 7], min=1e-3) / 2.0))
    fx = W / (2.0 * torch.tan(torch.clamp(pose[..., 8], min=1e-3) / 2.0))
    zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
    K = torch.stack([
        torch.stack([fx, zeros, torch.full_like(fx, W / 2.0)], -1),
        torch.stack([zeros, fy, torch.full_like(fy, H / 2.0)], -1),
        torch.stack([zeros, zeros, ones], -1),
    ], dim=-2)
    logits = out["mask_logits"]
    nam = logits > 0.0
    bottom = device_constant((0.0, 0.0, 0.0, 1.0), rot.dtype, rot.device)
    mean = device_constant(IMAGENET_MEAN, views.dtype, views.device)
    std = device_constant(IMAGENET_STD, views.dtype, views.device)
    return {
        "pts3d": pts_world,
        "pts3d_cam": pts_cam,
        "depth_z": pts_cam[..., 2:3],
        "depth_along_ray": dar[..., None],
        "ray_directions": ray,
        "intrinsics": K,
        "camera_poses": torch.cat([torch.cat([rot, trans[..., None]], dim=-1),
                                   bottom.expand(b, s, 1, 4)], dim=-2),
        "cam_trans": trans,
        "cam_quats": pose[..., 3:7],
        "conf": out["conf"],
        "mask": (nam & (dar > 1e-6))[..., None],
        "non_ambiguous_mask": nam,
        "non_ambiguous_mask_logits": logits,
        "metric_scaling_factor": out["metric_scaling_factor"],
        "img_no_norm": torch.clamp(views * std + mean, 0.0, 1.0),
    }
