"""Depth and optical-flow evaluation metrics (counterpart of the JAX
package's ``training/metrics.py``), for checking fine-tunes, checkpoint
conversions and int8 serving (``eval``, ``quantcheck``):

* monocular depth: AbsRel, SqRel, RMSE, RMSE_log, SiLog and the
  delta < 1.25^k accuracies, optionally after per-image affine (scale and
  shift) or median-scale alignment, the protocols relative-depth models are
  scored with;
* optical flow: end-point error and n-px accuracies.

Mask-weighted, fp32, on whatever device the tensors are.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from monocular_depth_estimation_trt_tpu_torch.training.losses import (
    _EPS,
    _masked,
    _sum_hw,
    align_scale_shift,
)


def _median_scale(pred: torch.Tensor, target: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Masked median(target) / median(pred) per image (the Zhou / KITTI
    protocol for scale-ambiguous models): a sort with masked entries at the
    float32 maximum, read at index count // 2, as the JAX package does
    (``torch.median`` takes the lower median, which differs)."""
    b = pred.shape[0]
    flat_w = w.reshape(b, -1)
    big = torch.finfo(torch.float32).max
    n = flat_w.sum(dim=-1).to(torch.int64)
    idx = torch.clamp(n // 2, min=0)

    def med(x):
        x = torch.where(flat_w > 0, x.reshape(b, -1), big)
        x = torch.sort(x, dim=-1).values
        return torch.gather(x, -1, idx[:, None])[:, 0]

    return med(target) / torch.clamp(med(pred), min=_EPS)


def depth_metrics(pred: torch.Tensor, target: torch.Tensor, mask: Optional[torch.Tensor] = None,
                  *, align: str = "none") -> Dict[str, torch.Tensor]:
    """Batch mean of the monocular-depth metric suite, each a 0-d tensor.

    ``align="affine"`` applies per-image least-squares scale and shift (the
    relative-depth protocol), ``"median"`` median scaling (the
    metric-from-mono protocol). Only positive target depths are scored (the
    mask is intersected with ``target > 0``)."""
    if align not in ("none", "affine", "median"):
        raise ValueError(f"unknown align {align!r}; want none|affine|median")
    pred = pred.float()
    target = target.float()
    w, _ = _masked(pred, mask)
    w = w * (target > 0)

    if align == "affine":
        s, t = align_scale_shift(pred, target, w)
        pred = s[:, None, None] * pred + t[:, None, None]
    elif align == "median":
        pred = _median_scale(pred, target, w)[:, None, None] * pred

    pred = torch.clamp(pred, min=_EPS)
    n = torch.clamp(_sum_hw(w), min=1.0)

    def mean(x):
        return torch.mean(_sum_hw(w * x) / n)

    safe_t = torch.clamp(target, min=_EPS)
    err = pred - target
    ratio = torch.maximum(pred / safe_t, target / torch.clamp(pred, min=_EPS))
    log_d = torch.log(pred) - torch.log(safe_t)
    m1 = _sum_hw(w * log_d) / n
    m2 = _sum_hw(w * log_d * log_d) / n
    return {
        "abs_rel": mean(err.abs() / safe_t),
        "sq_rel": mean(err * err / safe_t),
        "rmse": torch.mean(torch.sqrt(_sum_hw(w * err * err) / n)),
        "rmse_log": torch.mean(torch.sqrt(torch.clamp(m2, min=0.0))),
        "silog": torch.mean(100.0 * torch.sqrt(torch.clamp(m2 - m1 * m1, min=0.0))),
        "delta1": mean((ratio < 1.25).float()),
        "delta2": mean((ratio < 1.25 ** 2).float()),
        "delta3": mean((ratio < 1.25 ** 3).float()),
    }


def flow_metrics(pred: torch.Tensor, target: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Optical-flow EPE and n-px accuracies. ``pred``/``target``:
    ``(B, H, W, 2)``; ``mask``: ``(B, H, W)``."""
    pred = pred.float()
    target = target.float()
    epe = torch.sqrt(torch.sum((pred - target) ** 2, dim=-1) + 1e-12)
    w, n = _masked(epe, mask)

    def mean(x):
        return torch.mean(_sum_hw(w * x) / n)

    return {
        "epe": mean(epe),
        "acc_1px": mean((epe < 1.0).float()),
        "acc_3px": mean((epe < 3.0).float()),
        "acc_5px": mean((epe < 5.0).float()),
    }
