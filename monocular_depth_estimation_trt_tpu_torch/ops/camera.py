"""Camera geometry ops (counterpart of the JAX package's ``ops/camera.py``).

Ported so far: the pinhole unprojections (:func:`unproject_depth`,
:func:`unproject_intrinsics`, :func:`unproject_to_world`, reference
``Depth_Anything_V2/onnx2trt_pointcloud.py:70-84`` and
``VGGT/onnx2trt2.py:240-243``), :func:`fov_to_focal`,
:func:`extrinsics_from_quat_trans`, which decode VGGT's pose encoding, and
MoGe's view-plane grid and focal/shift solver
(:func:`normalized_view_plane_uv`, :func:`recover_focal_shift`), and
UniDepth's intrinsics rescaling (:func:`rescale_intrinsics`).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from monocular_depth_estimation_trt_tpu_torch.ops.constants import device_cached, device_constant


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


def rescale_intrinsics(K: torch.Tensor, from_hw: Tuple[int, int],
                       to_hw: Tuple[int, int]) -> torch.Tensor:
    """Scale fx/cx by the W ratio and fy/cy by the H ratio (reference
    ``Uni_Depth_V2/onnx2trt.py:78-94``)."""
    sy = to_hw[0] / from_hw[0]
    sx = to_hw[1] / from_hw[1]
    scale = device_constant((sx, 1.0, sx, 1.0, sy, sy, 1.0, 1.0, 1.0), K.dtype, K.device)
    return K * scale.view(3, 3)


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


@device_cached
def _view_plane_uv(h: int, w: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    diag = float(np.sqrt(h * h + w * w))
    u = ((np.arange(w) + 0.5) / w * 2.0 - 1.0) * (w / diag)
    v = ((np.arange(h) + 0.5) / h * 2.0 - 1.0) * (h / diag)
    uv = np.stack(np.broadcast_arrays(u[None, :], v[:, None]), axis=-1)
    return torch.from_numpy(uv.astype(np.float32)).to(device=device, dtype=dtype)


def normalized_view_plane_uv(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(H, W, 2) view-plane coordinates spanning [-w/diag, w/diag] x
    [-h/diag, h/diag] at pixel centers (MoGe convention). Made in numpy
    and kept on the device (``ops/constants.py``): shared, do not write."""
    return _view_plane_uv(h, w, dtype, torch.device(device or "cpu"))


@device_cached
def _shift_exponents(n: int, device: torch.device) -> torch.Tensor:
    return torch.linspace(-1.0, 4.0, n, device=device)


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis, keepdim; the mean of the two middle
    values for an even count, as ``jnp.median`` (``torch.median`` returns
    the lower one)."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    if n % 2:
        return s[..., n // 2: n // 2 + 1]
    return 0.5 * (s[..., n // 2 - 1: n // 2] + s[..., n // 2: n // 2 + 1])


def recover_focal_shift(points: torch.Tensor, mask: Optional[torch.Tensor] = None,
                        downsample: int = 64, num_shift_candidates: int = 128,
                        gn_steps: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recover (focal, z-shift) from an affine-invariant point map (the
    MoGe-2 postprocess, reference ``MoGe_2/onnx2trt.py:179``): a log-spaced
    search over shift candidates with the closed-form focal of each, then
    ``gn_steps`` Gauss-Newton steps on the shift (finite differences), as
    the JAX package's function. Runs on the device with no host sync, so
    that a captured graph can hold it.

    The candidates are the JAX package's, in the points' dtype; the losses
    are summed in float64. A Gauss-Newton step divides differences of sums
    of thousands of residuals by eps^2 = 1e-6, so in fp32 the rounding of
    the sums sets the step: XLA's and PyTorch's fp32 summation orders gave
    focals 1.2 % apart on one map, float64 within 4e-4 of XLA's.

    points: (B, H, W, 3); mask: optional (B, H, W) bool.
    Returns (focal (B,), shift (B,)) in the points' dtype."""
    b, h, w, _ = points.shape
    sh, sw = max(h // downsample, 1), max(w // downsample, 1)
    pts = points[:, ::sh, ::sw, :]
    f64 = torch.float64
    uv = normalized_view_plane_uv(pts.shape[1], pts.shape[2], f64, points.device)
    if mask is not None:
        m = mask[:, ::sh, ::sw].to(f64)
    else:
        m = torch.ones(pts.shape[:3], dtype=f64, device=points.device)
    pz = pts[..., 2].reshape(b, -1)
    px, py, pz64 = (pts[..., i].reshape(b, -1).to(f64) for i in range(3))
    u, v = uv[..., 0].reshape(1, -1), uv[..., 1].reshape(1, -1)
    mm = m.reshape(b, -1)

    def loss_and_focal(shift):
        """shift (B, K) -> loss (B, K), focal (B, K): K candidates at once."""
        z = torch.clamp(pz64[:, None] + shift[..., None], min=1e-4)
        a, c = px[:, None] / z, py[:, None] / z
        num = torch.sum(mm[:, None] * (u * a + v * c), dim=-1)
        den = torch.sum(mm[:, None] * (a * a + c * c), dim=-1) + 1e-12
        f = num / den  # the optimal focal for the shift (closed form)
        r = mm[:, None] * ((f[..., None] * a - u) ** 2 + (f[..., None] * c - v) ** 2)
        return torch.sum(r, dim=-1), f

    z_med = _median(pz)
    spread = torch.clamp(pz.amax(dim=-1, keepdim=True) - pz.amin(dim=-1, keepdim=True),
                         min=1e-2)
    t = _shift_exponents(num_shift_candidates, points.device).to(points.dtype)[None]
    candidates = (-z_med + spread * torch.pow(10.0, t) * 0.1).to(f64)  # (B, K)
    losses, _ = loss_and_focal(candidates)
    best = torch.argmin(losses, dim=-1, keepdim=True)  # the first minimum, as jnp
    shift = torch.gather(candidates, 1, best)  # (B, 1)

    floor = (-pz.amin(dim=-1, keepdim=True) + 1e-3).to(f64)
    eps = 1e-3
    for _ in range(gn_steps):  # jax.lax.scan over gn_steps
        l0, _ = loss_and_focal(shift)
        l1, _ = loss_and_focal(shift + eps)
        l_1, _ = loss_and_focal(shift - eps)
        g = (l1 - l_1) / (2 * eps)
        hdiag = (l1 - 2 * l0 + l_1) / (eps * eps)
        step = torch.where(hdiag.abs() > 1e-8, g / torch.clamp(hdiag, min=1e-8),
                           torch.zeros_like(g))
        new = torch.maximum(shift - torch.clamp(step, -1.0, 1.0), floor)
        lnew, _ = loss_and_focal(new)
        shift = torch.where(lnew < l0, new, shift)
    _, focal = loss_and_focal(shift)
    return focal[:, 0].to(points.dtype), shift[:, 0].to(points.dtype)
