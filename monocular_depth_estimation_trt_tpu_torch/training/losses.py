"""Depth training losses: affine-invariant, metric and distillation
(counterpart of the JAX package's ``training/losses.py``).

Plain functions on tensors, differentiable with ``torch.autograd``. They
compute in fp32 whatever the input type, with closed-form least-squares
alignment (no masked medians) and masks as float weights.

Conventions: predictions and targets are ``(B, H, W)``; ``mask`` is an
optional ``(B, H, W)`` tensor (1 = valid). Relative-depth families (DA-V2,
Distill-Any-Depth, DA-AC) work in disparity space; metric families
(Metric3D, UniDepth, Depth Pro) in log-depth space.

Gradients follow JAX's conventions at the kinks, so that a training step
here matches the JAX package's: the derivative of ``|x|`` at 0 is +1 (JAX's;
``torch.abs`` gives 0), through :func:`_abs`, and ``torch.maximum`` splits a
tie evenly, as ``jnp.maximum`` does. Exact zeros are common in this
workload: a relu'd depth and a clamped teacher give flat regions, whose
finite differences are 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_EPS = 1e-6


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with JAX's derivative at 0 (+1)."""
    return x * torch.where(x >= 0, 1.0, -1.0)


def _maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.maximum(x, c)``: a tie splits the gradient evenly."""
    return torch.maximum(x, torch.tensor(c, dtype=x.dtype, device=x.device))


def _sum_hw(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=(-2, -1))


def _masked(x: torch.Tensor, mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights, count) as fp32; a missing mask is all ones."""
    if mask is None:
        w = torch.ones(x.shape, dtype=torch.float32, device=x.device)
    else:
        w = mask.to(torch.float32)
    n = torch.clamp(_sum_hw(w), min=1.0)
    return w, n


def align_scale_shift(pred: torch.Tensor, target: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image closed-form least-squares (scale, shift) aligning pred to
    target: ``min_{s,t} sum w (s * pred + t - target)^2`` through the 2x2
    normal equations (the MiDaS ssi-MSE alignment). Returns ``(s, t)``, each
    ``(B,)``. A constant prediction falls back to ``s = 1`` and a shift."""
    pred = pred.float()
    target = target.float()
    w, n = _masked(pred, mask)
    sum_p = _sum_hw(w * pred)
    sum_t = _sum_hw(w * target)
    sum_pp = _sum_hw(w * pred * pred)
    sum_pt = _sum_hw(w * pred * target)
    det = n * sum_pp - sum_p * sum_p
    ok = det > _EPS
    safe_det = torch.where(ok, det, 1.0)
    s = torch.where(ok, (n * sum_pt - sum_p * sum_t) / safe_det, 1.0)
    t = torch.where(ok, (sum_pp * sum_t - sum_p * sum_pt) / safe_det, (sum_t - sum_p) / n)
    return s, t


def _aligned(pred: torch.Tensor, target: torch.Tensor,
             mask: Optional[torch.Tensor]) -> torch.Tensor:
    s, t = align_scale_shift(pred, target, mask)
    return s[:, None, None] * pred + t[:, None, None]


def ssi_loss(pred: torch.Tensor, target: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
             alignment: str = "lstsq") -> torch.Tensor:
    """Scale-and-shift-invariant loss (MiDaS / Depth Anything): the masked
    mean absolute error after least-squares affine alignment, divided by the
    target's masked mean absolute deviation, so that it is also invariant to
    affine maps of the target. ``alignment="none"`` skips the alignment."""
    pred = pred.float()
    target = target.float()
    if alignment == "lstsq":
        pred = _aligned(pred, target, mask)
    w, n = _masked(pred, mask)
    err = _sum_hw(w * _abs(pred - target)) / n
    mean_t = _sum_hw(w * target) / n
    spread = _sum_hw(w * _abs(target - mean_t[:, None, None])) / n
    return torch.mean(err / _maximum(spread, _EPS))


def gradient_matching_loss(pred: torch.Tensor, target: torch.Tensor,
                           mask: Optional[torch.Tensor] = None, *, scales: int = 4,
                           align: bool = True) -> torch.Tensor:
    """Multi-scale gradient matching (MiDaS R_grad): ``|dx R| + |dy R|`` of
    the aligned residual R at ``scales`` resolutions, each taken by striding
    2x."""
    pred = pred.float()
    target = target.float()
    if align:
        pred = _aligned(pred, target, mask)
    w = torch.ones(pred.shape, dtype=torch.float32, device=pred.device) if mask is None \
        else mask.to(torch.float32)
    total = 0.0
    r, wk = pred - target, w
    for _ in range(scales):
        dx = _abs(r[:, :, 1:] - r[:, :, :-1])
        wx = wk[:, :, 1:] * wk[:, :, :-1]
        dy = _abs(r[:, 1:, :] - r[:, :-1, :])
        wy = wk[:, 1:, :] * wk[:, :-1, :]
        nx = torch.clamp(_sum_hw(wx), min=1.0)
        ny = torch.clamp(_sum_hw(wy), min=1.0)
        total = total + torch.mean(_sum_hw(wx * dx) / nx + _sum_hw(wy * dy) / ny)
        r, wk = r[:, ::2, ::2], wk[:, ::2, ::2]
    return total / scales


def silog_loss(pred_depth: torch.Tensor, target_depth: torch.Tensor,
               mask: Optional[torch.Tensor] = None, *, lam: float = 0.85,
               alpha: float = 10.0) -> torch.Tensor:
    """Scale-invariant log loss (Eigen et al.) for metric depth:
    ``d = log(pred) - log(target)``, ``alpha * sqrt(mean d^2 - lam (mean
    d)^2)``, with depths clamped positive."""
    pred = _maximum(pred_depth.float(), _EPS)
    target = _maximum(target_depth.float(), _EPS)
    d = torch.log(pred) - torch.log(target)
    w, n = _masked(d, mask)
    m1 = _sum_hw(w * d) / n
    m2 = _sum_hw(w * d * d) / n
    # the sqrt's infinite derivative at 0 would turn an exact fit or a fully
    # masked sample into NaN gradients: keep its argument positive
    var = _maximum(m2 - lam * m1 * m1, 0.0)
    return torch.mean(alpha * torch.sqrt(var + 1e-12))


def distillation_loss(student: torch.Tensor, teacher: torch.Tensor,
                      mask: Optional[torch.Tensor] = None, *, grad_weight: float = 0.5,
                      grad_scales: int = 4) -> torch.Tensor:
    """Teacher-to-student disparity distillation: SSI plus multi-scale
    gradient matching (the Distill-Any-Depth objective): the student matches
    the teacher's relative structure, not its scale."""
    return ssi_loss(student, teacher, mask) + grad_weight * gradient_matching_loss(
        student, teacher, mask, scales=grad_scales)
