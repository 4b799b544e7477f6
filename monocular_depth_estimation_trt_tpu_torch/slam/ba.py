"""Dense-flow bundle adjustment: one Levenberg-Marquardt solve (counterpart
of the JAX package's ``slam/ba.py``).

The reference's SLAM staging recipes clone CUDA BA cores
(``later/MegaSaM/README.md`` builds mega-sam's ``base`` extension;
``later/WildGS-SLAM/README.md`` builds lietorch). Here poses, per-keyframe
disparity scale/shift and optionally a shared focal are refined against
dense optical-flow correspondences in a fixed number of LM iterations:
static shapes, fp32 normal equations, no host round-trip, so that the
whole solve is one captured graph on the card (``recipes.py``: one
:class:`~monocular_depth_estimation_trt_tpu_torch.runtime.engine.Engine`
per problem shape (K, E, P)).

The parameterization follows MegaSaM (arXiv 2412.04463): mono depth enters
as *disparity* with a per-frame affine correction ``disp' = exp(s) * disp +
q``, and moving objects are down-weighted by a per-pixel motion probability,
here the forward/backward flow-consistency weight of
:func:`flow_consistency_weights`.

Design, as the JAX package's:
  * The state is small (D = 8K+1 parameters for K keyframes) while the
    residuals are dense (E edges x P grid points x 2). ``torch.func.jacfwd``
    over the state gives the exact (M, D) Jacobian as D batched forward
    passes (the JAX ``jax.jacfwd``). The LM loop of ``lax.scan`` is a
    Python loop, unrolled into the captured graph.
  * Gauge freedom (global SE(3) + global scale) is removed by a large
    diagonal prior pinning keyframe 0's pose and disparity affine and a weak
    zero-prior on the other log-scales, not by slicing parameters out.
  * LM accept/reject is branch-free: the candidate is kept through
    ``torch.where`` on the cost comparison.
  * The (D, D) system goes through :func:`solve_normal_equations`. The prior
    of 1e8 makes the fp32 system badly conditioned, so the accept/reject
    can flip between frameworks at the last bits; the tests hold parity on
    the residuals and Jacobian, on one step, and on the recovery of a known
    trajectory.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from monocular_depth_estimation_trt_tpu_torch.slam.lie import se3_apply, se3_inv, se3_retract


class BAConfig(NamedTuple):
    """Static solver configuration (hashable: it keys the solve's engines)."""

    iters: int = 24
    huber_px: float = 4.0
    optimize_focal: bool = False
    optimize_affine: bool = True
    min_disparity: float = 1e-4
    # gauge / regularization priors (units: squared-pixel cost per unit delta)
    pose0_prior: float = 1e8
    scale_prior: float = 1e-2
    shift_prior: float = 1e-1
    focal_prior: float = 1e-1
    lam_init: float = 1e-3


class BAProblem(NamedTuple):
    """Dense-flow BA inputs at a coarse grid.

    points_uv: (P, 2) grid pixel coords shared by every keyframe.
    idepth:    (K, P) mono disparity sampled at ``points_uv``.
    edges:     (E, 2) int64 keyframe index pairs (i, j).
    flow:      (E, P, 2) flow_i->j at ``points_uv`` (pixels).
    weight:    (E, P) nonnegative per-correspondence confidence.
    """

    points_uv: torch.Tensor
    idepth: torch.Tensor
    edges: torch.Tensor
    flow: torch.Tensor
    weight: torch.Tensor


class BAState(NamedTuple):
    """Optimized state: c2w poses + disparity affine + log focal multiplier."""

    poses: torch.Tensor  # (K, 4, 4) camera-to-world
    log_scale: torch.Tensor  # (K,)
    shift: torch.Tensor  # (K,)
    log_focal: torch.Tensor  # () multiplier on the initial focal


def init_state(num_keyframes: int, device=None) -> BAState:
    k = num_keyframes
    return BAState(
        poses=torch.eye(4, dtype=torch.float32, device=device).expand(k, 4, 4).contiguous(),
        log_scale=torch.zeros((k,), dtype=torch.float32, device=device),
        shift=torch.zeros((k,), dtype=torch.float32, device=device),
        log_focal=torch.zeros((), dtype=torch.float32, device=device),
    )


def flow_consistency_weights(flow_fwd: torch.Tensor, flow_bwd_at_fwd: torch.Tensor,
                             sigma_px: float = 1.5) -> torch.Tensor:
    """Motion-probability proxy from a forward/backward flow check.

    ``flow_bwd_at_fwd`` is the backward flow sampled at ``p + flow_fwd``. A
    static scene point satisfies ``flow_fwd + flow_bwd ~ 0``; moving objects
    and occlusions violate it, and their Gaussian down-weighting is the
    recipe-level analog of MegaSaM's learned motion-probability map.
    Shapes: (..., 2) -> (...,) in [0, 1]."""
    err2 = torch.sum((flow_fwd + flow_bwd_at_fwd) ** 2, dim=-1)
    return torch.exp(-err2 / (2.0 * sigma_px * sigma_px))


def _unflatten(delta: torch.Tensor, k: int):
    return (delta[: 6 * k].reshape(k, 6), delta[6 * k: 7 * k], delta[7 * k: 8 * k],
            delta[8 * k])


def _apply_delta(state: BAState, delta: torch.Tensor, cfg: BAConfig) -> BAState:
    k = state.poses.shape[0]
    dpose, dscale, dshift, dfocal = _unflatten(delta, k)
    aff = 1.0 if cfg.optimize_affine else 0.0
    foc = 1.0 if cfg.optimize_focal else 0.0
    return BAState(poses=se3_retract(dpose, state.poses),
                   log_scale=state.log_scale + aff * dscale,
                   shift=state.shift + aff * dshift,
                   log_focal=state.log_focal + foc * dfocal)


def _residuals(state: BAState, prob: BAProblem, focal_init: torch.Tensor,
               center_uv: Tuple[float, float], cfg: BAConfig) -> torch.Tensor:
    """Reprojection residuals (E, P, 2) in pixels.

    For edge (i, j): unproject keyframe i's grid points with its corrected
    disparity, transform through ``T_j^-1 T_i``, project, and compare with
    the flow-displaced grid. ``center_uv``: the principal point (cx, cy)."""
    f = focal_init * torch.exp(state.log_focal)
    cx, cy = center_uv

    disp = torch.exp(state.log_scale)[:, None] * prob.idepth + state.shift[:, None]
    depth = 1.0 / torch.clamp(disp, min=cfg.min_disparity)  # (K, P)

    u, v = prob.points_uv[:, 0], prob.points_uv[:, 1]
    rays = torch.stack([(u - cx) / f, (v - cy) / f, torch.ones_like(u)], dim=-1)

    i_idx, j_idx = prob.edges[:, 0], prob.edges[:, 1]
    pts_i = rays[None, :, :] * depth[i_idx][:, :, None]  # (E, P, 3)
    T_rel = se3_inv(state.poses[j_idx]) @ state.poses[i_idx]
    pts_j = se3_apply(T_rel, pts_i)  # (E, P, 3)
    z = torch.clamp(pts_j[..., 2], min=1e-3)
    proj = torch.stack([f * pts_j[..., 0] / z + cx, f * pts_j[..., 1] / z + cy], dim=-1)
    return proj - (prob.points_uv[None, :, :] + prob.flow)


def _prior_diag(k: int, cfg: BAConfig, device) -> torch.Tensor:
    """Gauge-fixing diagonal: keyframe 0 pins BOTH the world frame (its 6
    pose dofs) and the global depth scale (its disparity scale/shift): the
    map is expressed in units of keyframe 0's mono disparity. Slice fills
    only (an element assignment copies a host scalar, which a capture
    refuses)."""
    prior = torch.zeros((8 * k + 1,), dtype=torch.float32, device=device)
    for start, stop, value in ((6 * k, 7 * k, cfg.scale_prior), (7 * k, 8 * k, cfg.shift_prior),
                               (8 * k, 8 * k + 1, cfg.focal_prior), (0, 6, cfg.pose0_prior),
                               (6 * k, 6 * k + 1, cfg.pose0_prior),
                               (7 * k, 7 * k + 1, cfg.pose0_prior)):
        prior[start:stop] = value
    return prior


def solve_normal_equations(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with A x = b for the damped (D, D) normal equations, by LU with
    partial pivoting as the JAX package's ``jnp.linalg.solve``.
    ``solve_ex`` (not ``solve``): its status stays on the device, where
    ``solve`` would read it on the host, which a capture refuses."""
    return torch.linalg.solve_ex(A, b[:, None])[0][:, 0]


def _where_state(ok: torch.Tensor, a: BAState, b: BAState) -> BAState:
    return BAState(*(torch.where(ok, x, y) for x, y in zip(a, b)))


def _huber_cost(r: torch.Tensor, w_conf: torch.Tensor, huber_px: float) -> torch.Tensor:
    """sum w * rho(|r|), Huber rho on each residual 2-vector's norm."""
    rn = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-12)  # (E, P)
    h = torch.where(rn <= huber_px, 0.5 * rn * rn, huber_px * (rn - 0.5 * huber_px))
    return torch.sum(w_conf * h)


def normal_equations(s: BAState, prob: BAProblem, focal_init: torch.Tensor,
                     center_uv: Tuple[float, float], cfg: BAConfig, prior: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LM iteration's Gauss-Newton system at ``s``, undamped: H (D, D)
    with the prior on its diagonal and g (D,), IRLS-weighted by the Huber
    weights of the residuals at ``s`` and the correspondence confidences;
    J from ``torch.func.jacfwd`` at a zero delta."""
    d = prior.shape[0]

    def resid_flat(delta):
        return _residuals(_apply_delta(s, delta, cfg), prob, focal_init, center_uv,
                          cfg).reshape(-1)

    zero = torch.zeros((d,), dtype=torch.float32, device=prior.device)
    r0 = resid_flat(zero)  # (M,)
    # IRLS Huber weights on the 2-vector residual norm, fixed for this step
    rn = torch.sqrt(torch.sum(r0.reshape(-1, 2) ** 2, dim=-1) + 1e-12)  # (E*P,)
    w_rob = torch.where(rn <= cfg.huber_px, 1.0, cfg.huber_px / rn)
    w = (torch.clamp(prob.weight, min=0.0).reshape(-1) * w_rob).repeat_interleave(2)
    J = torch.func.jacfwd(resid_flat)(zero)  # (M, D)
    Jw = J * w[:, None]
    return J.T @ Jw + torch.diag(prior), Jw.T @ r0


def run_ba(prob: BAProblem, state: BAState, focal_init, image_hw: Tuple[int, int],
           cfg: BAConfig = BAConfig()) -> Tuple[BAState, dict]:
    """Damped Gauss-Newton over ``cfg.iters`` LM iterations on the device of
    ``state``. ``focal_init``: a float or a 0-d tensor. Returns the refined
    state and ``{"cost": (iters,), "rms_px": ()}``. Reads no device value on
    the host, so that a captured graph can hold the whole solve."""
    # jacfwd needs autograd's forward mode, which inference mode (where an
    # Engine runs and captures its function) refuses
    with torch.inference_mode(False), torch.no_grad():
        k = state.poses.shape[0]
        d = 8 * k + 1
        dev = state.poses.device
        focal_init = torch.as_tensor(focal_init, dtype=torch.float32).to(dev)
        center = (image_hw[1] / 2.0, image_hw[0] / 2.0)
        prior = _prior_diag(k, cfg, dev)
        eye = torch.eye(d, dtype=torch.float32, device=dev)
        w_conf = torch.clamp(prob.weight, min=0.0)

        def cost_of(s: BAState) -> torch.Tensor:
            return _huber_cost(_residuals(s, prob, focal_init, center, cfg), w_conf, cfg.huber_px)

        s = state
        lam = torch.full((), cfg.lam_init, dtype=torch.float32, device=dev)
        costs = []
        for _ in range(cfg.iters):  # jax.lax.scan over the LM iterations
            H, g = normal_equations(s, prob, focal_init, center, cfg, prior)
            cost0 = cost_of(s)
            cand = _apply_delta(s, -solve_normal_equations(H + lam * eye, g), cfg)
            cost1 = cost_of(cand)
            ok = cost1 < cost0
            s = _where_state(ok, cand, s)
            lam = torch.where(ok, torch.clamp(lam * 0.5, min=1e-6), lam * 4.0)
            costs.append(torch.minimum(cost0, cost1))

        r = _residuals(s, prob, focal_init, center, cfg)
        wsum = torch.sum(w_conf) + 1e-8
        rms = torch.sqrt(torch.sum(w_conf * torch.sum(r * r, dim=-1)) / wsum)
        return s, {"cost": torch.stack(costs), "rms_px": rms}


def align_disparity(disp: torch.Tensor, target_depth: torch.Tensor,
                    weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form weighted least squares ``min_{s,q} sum w (s*disp + q -
    1/target_depth)^2``.

    The per-frame affine disparity correction used (a) to propagate the
    BA-consistent keyframe depth to in-between frames (MegaSaM's consistent
    video depth stage) and (b) to snap relative disparity onto a metric
    estimate (ViPE's metric alignment). Batched over leading axes.

    disp/target_depth/weight: (..., N). Returns (scale, shift) each (...,)."""
    y = 1.0 / torch.clamp(target_depth, min=1e-6)
    w = torch.clamp(weight, min=0.0)
    sw = torch.sum(w, dim=-1) + 1e-8
    sx = torch.sum(w * disp, dim=-1)
    sy = torch.sum(w * y, dim=-1)
    sxx = torch.sum(w * disp * disp, dim=-1)
    sxy = torch.sum(w * disp * y, dim=-1)
    det = sw * sxx - sx * sx
    s = torch.where(torch.abs(det) > 1e-10, (sw * sxy - sx * sy) / det, 1.0)
    q = (sy - s * sx) / sw
    return s, q
