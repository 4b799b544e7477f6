"""VGGT 3D export: depth + pose -> world-space point cloud (counterpart of
the JAX package's ``apps/vggt_3d.py``; reference
``VGGT/onnx2trt2.py:240-292``)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from monocular_depth_estimation_trt_tpu_torch.apps.ply import write_ply
from monocular_depth_estimation_trt_tpu_torch.ops.camera import (
    extrinsics_from_quat_trans,
    fov_to_focal,
    unproject_to_world,
)
from monocular_depth_estimation_trt_tpu_torch.utils.imageio import resize
from monocular_depth_estimation_trt_tpu_torch.utils.logging import log


def world_points_from_output(out: dict, image_rgb: Optional[np.ndarray], *,
                             conf_threshold: float = 1.5, stride: int = 2):
    """``out`` is a single-view VGGT result (depth, depth_conf, extrinsic,
    focal_px). Unprojects depth through the predicted camera into world
    space; returns ``(points (N, 3), colors (N, 3) | None)``.

    ``depth_conf`` follows the upstream ``expp1`` activation (range
    [1, inf)); the default threshold 1.5 mirrors the reference's
    conf-percentile filtering (``VGGT/onnx2trt2.py:274-292``)."""
    depth = torch.as_tensor(np.ascontiguousarray(np.asarray(out["depth"])[::stride, ::stride]))
    h, w = depth.shape
    f = float(out["focal_px"]) / stride
    K = torch.tensor([[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]],
                     dtype=torch.float32)
    E = torch.as_tensor(np.asarray(out["extrinsic"]), dtype=torch.float32)
    pts = unproject_to_world(depth, K, E).numpy().reshape(-1, 3)

    colors = None
    if image_rgb is not None:
        colors = resize(np.asarray(image_rgb), (h, w)).reshape(-1, 3).astype(np.uint8)

    if "depth_conf" in out:
        conf = np.asarray(out["depth_conf"])[::stride, ::stride].reshape(-1)
        keep = conf > conf_threshold
        pts = pts[keep]
        if colors is not None:
            colors = colors[keep]
    return pts, colors


def export_world_points(out: dict, image_rgb: Optional[np.ndarray], path: str, *,
                        conf_threshold: float = 1.5, stride: int = 2) -> str:
    """Single-view world-point export -> colored ``.ply``."""
    pts, colors = world_points_from_output(out, image_rgb, conf_threshold=conf_threshold,
                                           stride=stride)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_ply(path, pts, colors)
    log(f"wrote {len(pts)} world points -> {path}")
    return path


def export_multi_view_points(mv_out: dict, images_rgb, path: str, input_size: int = 518, *,
                             conf_threshold: float = 1.5, stride: int = 2) -> str:
    """Merged world-space cloud from a ``VGGTPipeline.multi_view`` result
    (depth (S, H, W), depth_conf, pose_enc (S, 9)): every view unprojects
    through its own predicted camera into the shared world frame."""
    all_pts, all_colors = [], []
    s = np.asarray(mv_out["depth"]).shape[0]
    for i in range(s):
        pose = torch.as_tensor(np.asarray(mv_out["pose_enc"][i]), dtype=torch.float32)
        view = {
            "depth": mv_out["depth"][i],
            "depth_conf": mv_out["depth_conf"][i],
            "extrinsic": extrinsics_from_quat_trans(pose[3:7], pose[:3]).numpy(),
            "focal_px": float(fov_to_focal(torch.rad2deg(pose[7]), input_size)),
        }
        img = images_rgb[i] if images_rgb is not None else None
        pts, colors = world_points_from_output(view, img, conf_threshold=conf_threshold,
                                               stride=stride)
        all_pts.append(pts)
        if colors is not None:
            all_colors.append(colors)
    pts = np.concatenate(all_pts)
    colors = np.concatenate(all_colors) if all_colors else None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_ply(path, pts, colors)
    log(f"wrote {len(pts)} world points from {s} views -> {path}")
    return path
