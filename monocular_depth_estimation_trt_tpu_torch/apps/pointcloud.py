"""Depth -> point-cloud export (counterpart of the JAX package's
``apps/pointcloud.py``; reference ``onnx2trt_pointcloud.py`` family).

The reference unprojects on the host with numpy and writes via open3d
(``Depth_Anything_V2/onnx2trt_pointcloud.py:60-84``); here the
unprojection is ``ops/camera.py`` on the host array's tensor and the
PLY/GLB write is dependency-free (``apps/ply.py``). The colorbar figure of
the JAX module (matplotlib) is not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from monocular_depth_estimation_trt_tpu_torch.apps.ply import (
    image_mesh_faces,
    write_glb_mesh,
    write_glb_pointcloud,
    write_ply,
    write_ply_mesh,
)
from monocular_depth_estimation_trt_tpu_torch.ops.camera import (
    unproject_depth,
    unproject_intrinsics,
)


def depth_to_pointcloud(depth: np.ndarray, image_rgb: Optional[np.ndarray] = None, *,
                        focal: float = 470.4, intrinsics: Optional[np.ndarray] = None,
                        z_limit: Optional[float] = None, stride: int = 1):
    """Returns (points (N, 3), colors (N, 3) uint8 or None).

    The focal default is the reference's hard-coded value for 518-sized maps
    (``Depth_Anything_V2/onnx2trt_pointcloud.py``); ``z_limit`` drops far
    points; ``stride`` subsamples for interactive viewing."""
    d = torch.as_tensor(np.ascontiguousarray(np.asarray(depth)[::stride, ::stride]))
    if intrinsics is not None:
        K = torch.as_tensor(np.asarray(intrinsics), dtype=torch.float32).clone()
        if stride != 1:
            K[:2] = K[:2] / stride
        pts = unproject_intrinsics(d, K)
    else:
        pts = unproject_depth(d, focal / stride)
    pts = pts.numpy().reshape(-1, 3)

    colors = None
    if image_rgb is not None:
        colors = np.asarray(image_rgb[::stride, ::stride]).reshape(-1, 3)
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255, 0, 255).astype(np.uint8)

    if z_limit is not None:
        keep = pts[:, 2] < z_limit
        pts = pts[keep]
        if colors is not None:
            colors = colors[keep]
    return pts, colors


def depth_to_pointcloud_file(depth: np.ndarray, image_rgb: Optional[np.ndarray], path: str, *,
                             focal: float = 470.4, intrinsics: Optional[np.ndarray] = None,
                             z_limit: Optional[float] = None, stride: int = 1) -> str:
    pts, colors = depth_to_pointcloud(depth, image_rgb, focal=focal, intrinsics=intrinsics,
                                      z_limit=z_limit, stride=stride)
    if path.endswith(".glb"):
        return write_glb_pointcloud(path, pts, colors)
    return write_ply(path, pts, colors)


def points_to_mesh_file(points: np.ndarray, image_rgb: Optional[np.ndarray], path: str, *,
                        mask: Optional[np.ndarray] = None) -> str:
    """Triangulated image-grid mesh export (the reference MoGe-2 path,
    ``MoGe_2/onnx2trt.py:269-317``). points: (H, W, 3) point map (inf/nan
    entries are invalid); mask: optional (H, W) bool validity (ANDed with
    finiteness)."""
    from monocular_depth_estimation_trt_tpu_torch.utils.imageio import resize

    pts = np.asarray(points, dtype=np.float32)
    h, w, _ = pts.shape
    finite = np.isfinite(pts).all(axis=-1)
    valid = finite if mask is None else (finite & np.asarray(mask, bool))
    faces = image_mesh_faces(h, w, valid)

    colors = None
    if image_rgb is not None:
        colors = resize(np.asarray(image_rgb), (h, w)).reshape(-1, 3).astype(np.uint8)

    flat = np.where(valid[..., None], pts, 0.0).reshape(-1, 3)
    if path.endswith(".glb"):
        return write_glb_mesh(path, flat, faces, colors)
    return write_ply_mesh(path, flat, faces, colors)
