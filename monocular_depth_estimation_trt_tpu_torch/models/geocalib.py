"""GeoCalib: single-image camera calibration via perspective fields
(counterpart of the JAX package's ``models/geocalib.py``).

A DINOv2 encoder and a 5-channel DPT head predict the up-vector field (2),
the latitude field (1) and two confidence logits; :func:`fit_camera` then
fits (roll, pitch, focal) to the fields by a fixed number of Gauss-Newton
steps, with Laplace uncertainties from the last Hessian. Module names are
the upstream layout of ``weights/manifests/geocalib_vits.json``
(``backbone``, ``head``).

Camera model (pinhole, square pixels, centred principal point): with
gravity-up ``g`` in camera coordinates and a centred pixel (u, v),
latitude = asin(<d, g>) for d = normalize([u/f, v/f, 1]), and the up field
is normalize([g_x - u g_z / f, g_y - v g_z / f]).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn as nn

from monocular_depth_estimation_trt_tpu_torch.models.sidepth import dino_dpt_stack, run_stack
from monocular_depth_estimation_trt_tpu_torch.ops.constants import device_cached, device_constant


def gravity_in_camera(roll: torch.Tensor, pitch: torch.Tensor) -> torch.Tensor:
    """Unit gravity-up direction in camera coordinates for a camera rolled by
    ``roll`` and pitched by ``pitch`` (radians); +x right, +y down, +z
    forward, world up is -y at roll = pitch = 0."""
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    return torch.stack([sr * cp, -cr * cp, -sp], dim=-1)


@device_cached
def _centred_grid(h: int, w: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    v = torch.arange(h, dtype=torch.float32, device=device) - (h - 1) / 2
    u = torch.arange(w, dtype=torch.float32, device=device) - (w - 1) / 2
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    return vv, uu


def perspective_fields(roll: torch.Tensor, pitch: torch.Tensor, focal: torch.Tensor,
                       hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Analytic up-vector field (H, W, 2) and latitude field (H, W) of a
    pinhole camera; differentiable in (roll, pitch, focal)."""
    v, u = _centred_grid(hw[0], hw[1], roll.device)
    g = gravity_in_camera(roll, pitch)
    up = torch.stack([g[0] - u * g[2] / focal, g[1] - v * g[2] / focal], dim=-1)
    up = up / (torch.linalg.vector_norm(up, dim=-1, keepdim=True) + 1e-8)
    d = torch.stack([u / focal, v / focal, torch.ones_like(u)], dim=-1)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    lat = torch.asin(torch.clamp(d @ g, -1.0, 1.0))
    return up, lat


def fields_and_jacobian(theta: torch.Tensor, hw: Tuple[int, int]):
    """:func:`perspective_fields` at theta = (roll, pitch, log focal) and
    their derivatives in theta, by the chain rule written out: up (H, W, 2),
    latitude (H, W), d up (H, W, 2, 3), d latitude (H, W, 3). The JAX
    package differentiates with ``jax.jacfwd``; written out, the Jacobian
    needs no autodiff transform, which a captured graph could not hold on
    every PyTorch build (``torch.func.jacfwd``'s batching of
    ``_make_dual`` fails on some)."""
    v, u = _centred_grid(hw[0], hw[1], theta.device)
    roll, pitch, logf = theta.unbind()
    f = torch.exp(logf)
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    zero = torch.zeros_like(cr)
    g = torch.stack([sr * cp, -cr * cp, -sp])
    g_roll = torch.stack([cr * cp, sr * cp, zero])
    g_pitch = torch.stack([-sr * sp, cr * sp, -cp])
    # up field: a / (|a| + 1e-8), a = (g0 - u g2 / f, g1 - v g2 / f)
    a = torch.stack([g[0] - u * g[2] / f, g[1] - v * g[2] / f], dim=-1)
    da = torch.stack([
        torch.stack([g_roll[0].expand_as(u), g_pitch[0] - u * g_pitch[2] / f,
                     u * g[2] / f], dim=-1),
        torch.stack([g_roll[1].expand_as(v), g_pitch[1] - v * g_pitch[2] / f,
                     v * g[2] / f], dim=-1)], dim=-2)  # (H, W, 2, 3)
    n = torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    ne = n + 1e-8
    up = a / ne
    dn = (a[..., None] * da).sum(dim=-2) / n  # (H, W, 3)
    dup = da / ne[..., None] - a[..., None] * (dn / ne ** 2)[..., None, :]
    # latitude: asin(<d, g>), d = (u / f, v / f, 1) / m
    dt = torch.stack([u / f, v / f, torch.ones_like(u)], dim=-1)
    m = torch.linalg.vector_norm(dt, dim=-1, keepdim=True)
    d = dt / m
    ddt = torch.stack([-u / f, -v / f, torch.zeros_like(u)], dim=-1)
    dm = (dt * ddt).sum(dim=-1, keepdim=True) / m
    dd = ddt / m - dt * dm / m ** 2
    s = torch.clamp(d @ g, -1.0, 1.0)
    ds = torch.stack([d @ g_roll, d @ g_pitch, dd @ g], dim=-1)
    lat = torch.asin(s)
    dlat = ds * torch.rsqrt(1.0 - s * s)[..., None]
    return up, lat, dup, dlat


def _inverse_3x3(m: torch.Tensor) -> torch.Tensor:
    """The inverse of a 3x3 matrix by its adjugate, in float64: no pivoting
    and no host-side check of the factorization, so that a captured graph
    can hold it (``torch.linalg.solve`` and ``inv`` read their status on the
    host)."""
    a = m.double()
    c = [[None] * 3 for _ in range(3)]  # c[i][j]: the cofactor of a[j, i]
    for i in range(3):
        for j in range(3):
            r0, r1 = [k for k in range(3) if k != j]
            s0, s1 = [k for k in range(3) if k != i]
            c[i][j] = (-1) ** (i + j) * (a[r0, s0] * a[r1, s1] - a[r0, s1] * a[r1, s0])
    adj = torch.stack([torch.stack(row) for row in c])
    det = a[0, 0] * c[0][0] + a[0, 1] * c[1][0] + a[0, 2] * c[2][0]
    return adj / det


def fit_camera(up_obs: torch.Tensor, lat_obs: torch.Tensor, w_up: torch.Tensor,
               w_lat: torch.Tensor, hw: Tuple[int, int], iters: int = 10
               ) -> Dict[str, torch.Tensor]:
    """Gauss-Newton fit of (roll, pitch, focal) to observed fields:
    ``up_obs`` (H, W, 2) unit vectors, ``lat_obs`` (H, W) radians,
    ``w_up``/``w_lat`` (H, W) non-negative confidences; ``iters`` fixed
    steps from roll = pitch = 0 and focal = max(H, W), focal as log(f).
    Returns 0-d fp32 tensors: the estimate, the fields of view, and Laplace
    uncertainties from the last Hessian. The Jacobian is the chain rule
    written out (:func:`fields_and_jacobian`; the JAX package's
    ``jax.jacfwd``), the 3x3 systems are solved by the adjugate in float64,
    and nothing reads a device value on the host, so that a captured graph
    can hold the fit."""
    h, w = hw
    su, sl = torch.sqrt(w_up)[..., None], torch.sqrt(w_lat)
    ridge = 1e-6 * torch.eye(3, dtype=torch.float32, device=up_obs.device)

    def normal_equations(theta):
        up, lat, dup, dlat = fields_and_jacobian(theta, hw)
        r = torch.cat([((up - up_obs) * su).reshape(-1), ((lat - lat_obs) * sl).reshape(-1)])
        J = torch.cat([(dup * su[..., None]).reshape(-1, 3),
                       (dlat * sl[..., None]).reshape(-1, 3)])  # (M, 3), residuals' order
        return r, J.T @ J + ridge, J.T @ r

    theta = device_constant((0.0, 0.0, math.log(max(h, w))), torch.float32, up_obs.device)
    for _ in range(iters):  # jax.lax.scan over iters
        _, H, g = normal_equations(theta)
        theta = theta - (_inverse_3x3(H) @ g.double()).float()
    roll, pitch, logf = theta.unbind()
    focal = torch.exp(logf)

    r, H, _ = normal_equations(theta)
    sigma2 = torch.sum(r * r) / max(r.shape[0] - 3, 1)
    cov = sigma2 * _inverse_3x3(H).float()
    std = torch.sqrt(torch.clamp(torch.diagonal(cov), min=0.0))
    dvfov_dlogf = -h * focal / (focal ** 2 + (h / 2.0) ** 2)
    return {
        "roll": roll,
        "pitch": pitch,
        "focal": focal,
        "vfov": 2.0 * torch.atan(h / (2.0 * focal)),
        "hfov": 2.0 * torch.atan(w / (2.0 * focal)),
        "roll_uncertainty": std[0],
        "pitch_uncertainty": std[1],
        "focal_uncertainty": std[2] * focal,  # d f / d logf = f
        "vfov_uncertainty": torch.abs(dvfov_dlogf) * std[2],
    }


class GeoCalib(nn.Module):
    """Input: preprocessed (B, H, W, 3), H/W multiples of 14. Output: the
    perspective fields and their confidences, float32; feed them to
    :func:`fit_camera`. ``vit_config``, ``head_features``,
    ``head_out_channels`` and ``out_indices`` override the presets."""

    def __init__(self, encoder: str = "vits", attn_impl: str = "auto", **overrides):
        super().__init__()
        self.backbone, self.head = dino_dpt_stack(encoder, attn_impl, "none", num_outputs=5,
                                                  **overrides)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = run_stack(self.backbone, self.head, x)  # (B, H, W, 5) fp32
        up = out[..., 0:2]
        up = up / (torch.linalg.vector_norm(up, dim=-1, keepdim=True) + 1e-8)
        return {"up_field": up,
                "latitude_field": (math.pi / 2.0) * torch.tanh(out[..., 2]),
                "up_confidence": torch.sigmoid(out[..., 3]),
                "latitude_confidence": torch.sigmoid(out[..., 4])}
