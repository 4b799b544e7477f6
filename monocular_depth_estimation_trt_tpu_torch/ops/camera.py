"""Camera geometry ops (counterpart of the JAX package's ``ops/camera.py``).

Ported so far: the pinhole unprojections (:func:`unproject_depth`,
:func:`unproject_intrinsics`, :func:`unproject_to_world`, reference
``Depth_Anything_V2/onnx2trt_pointcloud.py:70-84`` and
``VGGT/onnx2trt2.py:240-243``), :func:`fov_to_focal` and
:func:`extrinsics_from_quat_trans`, which decode VGGT's pose encoding. The
intrinsics and focal-recovery ops come with the families that use them.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch


def pixel_grid(h: int, w: int, dtype=torch.float32,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u, v) pixel coordinate grids of shape (H, W)."""
    u = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w)
    v = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w)
    return u, v


def unproject_depth(depth: torch.Tensor, focal_px: Union[torch.Tensor, float],
                    cx: Optional[float] = None, cy: Optional[float] = None) -> torch.Tensor:
    """Depth (H, W) -> points (H, W, 3) under a centered pinhole camera
    (reference ``Depth_Anything_V2/onnx2trt_pointcloud.py:70-78``)."""
    h, w = depth.shape[-2], depth.shape[-1]
    u, v = pixel_grid(h, w, depth.dtype, depth.device)
    cx = (w / 2.0) if cx is None else cx
    cy = (h / 2.0) if cy is None else cy
    x = (u - cx) * depth / focal_px
    y = (v - cy) * depth / focal_px
    return torch.stack([x, y, depth], dim=-1)


def unproject_intrinsics(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Depth (H, W) + intrinsics (3, 3) -> points (H, W, 3)."""
    h, w = depth.shape[-2], depth.shape[-1]
    u, v = pixel_grid(h, w, depth.dtype, depth.device)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    x = (u - cx) * depth / fx
    y = (v - cy) * depth / fy
    return torch.stack([x, y, depth], dim=-1)


def unproject_to_world(depth: torch.Tensor, K: torch.Tensor,
                       extrinsic: torch.Tensor) -> torch.Tensor:
    """Depth map (H, W) + intrinsics + world-to-cam (3, 4) -> world points
    (H, W, 3) (VGGT world-point computation, ``VGGT/onnx2trt2.py:240-243``):
    world = R^T (cam - t)."""
    cam = unproject_intrinsics(depth, K)
    rot, trans = extrinsic[:3, :3], extrinsic[:3, 3]
    return torch.einsum("ji,hwj->hwi", rot, cam - trans)


def fov_to_focal(fov_deg: Union[torch.Tensor, float], width: int) -> torch.Tensor:
    """Horizontal FoV (degrees) -> focal length in pixels."""
    fov_rad = torch.deg2rad(torch.as_tensor(fov_deg, dtype=torch.float32))
    return 0.5 * width / torch.tan(0.5 * fov_rad)


def extrinsics_from_quat_trans(quat: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(x, y, z, w) quaternion + translation -> (..., 3, 4) world-to-cam
    matrix (VGGT pose-encoding decode, reference ``VGGT/onnx2trt2.py:240-243``).

    Scalar-last (XYZW), as upstream VGGT's ``quat_to_mat``; the quaternion
    need not be normalized."""
    x, y, z, w = quat.unbind(-1)
    n = w * w + x * x + y * y + z * z
    s = torch.where(n > 0, 2.0 / torch.clamp(n, min=1e-12), torch.zeros_like(n))
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    rot = torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
    ], dim=-2)
    return torch.cat([rot, trans[..., :, None]], dim=-1)
