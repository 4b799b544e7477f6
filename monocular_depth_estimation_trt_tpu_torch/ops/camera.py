"""Camera geometry ops (counterpart of the JAX package's ``ops/camera.py``).

Ported so far: :func:`fov_to_focal` and :func:`extrinsics_from_quat_trans`,
the two that decode VGGT's pose encoding. The unprojection, intrinsics and
focal-recovery ops come with the families that use them.
"""

from __future__ import annotations

from typing import Union

import torch


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
