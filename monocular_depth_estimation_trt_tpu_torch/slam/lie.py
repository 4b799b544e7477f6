"""SO(3)/SE(3) primitives for pose optimization, batched (counterpart of the
JAX package's ``slam/lie.py``).

The reference's SLAM staging recipes lean on CUDA lie-group extensions
(``later/WildGS-SLAM/README.md``: ``pip install -e thirdparty/lietorch``);
here the same role is a handful of closed-form fp32 expressions.

Conventions: poses are (4, 4) camera-to-world matrices; tangent vectors are
``xi = [rho(3), phi(3)]`` (translation first). ``se3_retract`` is the
left-multiplicative retraction ``exp(xi) @ T`` of the Gauss-Newton loop in
:mod:`.ba`, whose Jacobians ``torch.func.jacfwd`` takes straight through
it.

The small-angle guards are the JAX package's: both branches are computed
and ``torch.where`` selects one. At theta = 0 the large-angle branch is 0/0,
and ``where`` selects the tangents as it selects the values, so forward-mode
AD at a zero delta carries the series branch's tangent and no NaN.
"""

from __future__ import annotations

import math

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1),
                        torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def _eye(n: int, like: torch.Tensor, batch_shape) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device).expand(*batch_shape, n, n)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation, fp32, with the
    series fallbacks near theta = 0 selected by ``where``."""
    w = w.float()
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    W = hat(w)
    return (_eye(3, w, W.shape[:-2]) + a[..., None, None] * W
            + b[..., None, None] * (W @ W))


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle (principal branch)."""
    R = R.float()
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], -1)
    # theta / (2 sin theta) with the small-angle limit 1/2
    s = torch.where(theta < 1e-6, 0.5 + theta ** 2 / 12.0,
                    theta / (2.0 * torch.sin(torch.clamp(theta, min=1e-12))))
    return s[..., None] * vee


def _bottom_row(top: torch.Tensor) -> torch.Tensor:
    """(..., 1, 4) rows [0, 0, 0, 1], from fill kernels (no host data, which
    a capture refuses)."""
    row = torch.zeros_like(top[..., :1, :])
    row[..., 3:4] = 1.0
    return row


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) [rho, phi] -> (..., 4, 4) by the exact SE(3) exponential
    (the V-matrix coupling of rotation and translation)."""
    xi = xi.float()
    rho, phi = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < 1e-8
    R = so3_exp(phi)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    W = hat(phi)
    V = _eye(3, xi, R.shape[:-2]) + b[..., None, None] * W + c[..., None, None] * (W @ W)
    t = (V @ rho[..., None])[..., 0]
    top = torch.cat([R, t[..., :, None]], dim=-1)  # (..., 3, 4)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) rigid inverse (transpose-based; no linear solve)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    ti = -(Rt @ T[..., :3, 3:4])
    top = torch.cat([Rt, ti], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def se3_apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) applied to points (..., N, 3) -> (..., N, 3)."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def se3_retract(xi: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative retraction: ``exp(xi) @ T``."""
    return se3_exp(xi) @ T


def rotation_geodesic_deg(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Angle (degrees) between two rotations: the pose-error metric."""
    w = so3_log(Ra @ Rb.transpose(-1, -2))
    return torch.linalg.vector_norm(w, dim=-1) * (180.0 / math.pi)
