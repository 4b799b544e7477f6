"""Teacher-to-student depth distillation (counterpart of the JAX package's
``training/distill.py``).

A frozen teacher labels each batch once with disparity pseudo-labels and a
student trains against them with the SSI + gradient-matching objective
(``losses.distillation_loss``), on the device its parameters live on. Kept
small: images arrive as an iterable of ``(B, H, W, 3)`` uint8 batches;
decoding and resizing belong to the caller.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Tuple

import numpy as np
import torch

from monocular_depth_estimation_trt_tpu_torch.training.losses import distillation_loss
from monocular_depth_estimation_trt_tpu_torch.training.trainer import (
    TrainState,
    adamw,
    create_train_state,
    make_train_step,
    warmup_cosine_decay_schedule,
)
from monocular_depth_estimation_trt_tpu_torch.utils.logging import log


def make_distill_step(student_apply: Callable[[Dict[str, torch.Tensor], torch.Tensor],
                                              torch.Tensor],
                      *, grad_weight: float = 0.5, accum_steps: int = 1, remat: bool = False):
    """Train step for distillation: ``student_apply(params, images_u8) ->
    depth (B, h, w)``; the batch is an ``(images, teacher_depth)`` pair, the
    teacher's depth already at the student's output size."""

    def loss_fn(params, batch):
        images, teacher = batch
        return distillation_loss(student_apply(params, images), teacher,
                                 grad_weight=grad_weight)

    return make_train_step(loss_fn, accum_steps=accum_steps, remat=remat)


def depth_student(model: torch.nn.Module, size: int):
    """``student_apply`` of a DA-V2-family ``model`` at ``size`` x ``size``
    uint8 frames: ImageNet normalization, the model on the given parameters
    (``torch.func.functional_call``), the depth resized to the frames' size
    with no clamp (the serving clamp's zero gradient outside (1e-3, 1e3)
    would freeze sky and far pixels)."""
    from torch.func import functional_call

    from monocular_depth_estimation_trt_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
    from monocular_depth_estimation_trt_tpu_torch.ops.postprocess import upsample_depth
    from monocular_depth_estimation_trt_tpu_torch.ops.preprocess import normalize, to_float_rgb

    def student_apply(params, imgs_u8):
        x = normalize(to_float_rgb(imgs_u8), IMAGENET_MEAN, IMAGENET_STD)
        return upsample_depth(functional_call(model, params, (x,)), (size, size), clamp=None)

    return student_apply


def _cycle(src):
    """(position, item) over ``src`` once, then over the items seen, for
    ever: teacher labels are made once per batch position."""
    seen = []
    for item in src:
        seen.append(item)
        yield len(seen) - 1, item
    if not seen:
        raise ValueError("batches iterator was empty")
    while True:
        yield from enumerate(seen)


def distill(teacher_fn: Callable[[np.ndarray], Any],
            student_apply: Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor],
            init_params: Dict[str, torch.Tensor], batches: Iterable[np.ndarray], *, steps: int,
            learning_rate: float = 3e-4, weight_decay: float = 1e-4, warmup: int = 10,
            grad_weight: float = 0.5, accum_steps: int = 1,
            log_every: int = 10) -> Tuple[TrainState, List[float]]:
    """Run the distillation loop; returns (final state, loss history).

    ``teacher_fn(images_u8) -> depth`` is the frozen teacher (a serving
    pipeline's ``batch_call``; numpy or a tensor); ``batches`` yields
    ``(B, H, W, 3)`` uint8 batches and is cycled until ``steps`` updates
    are done. Each position's images and labels stay on the student's
    device once made. AdamW with linear warmup and cosine decay, the
    schedule the DA family fine-tunes with. The losses stay on the device
    until a log point reads them."""
    device = next(iter(init_params.values())).device
    sched = warmup_cosine_decay_schedule(0.0, learning_rate, warmup_steps=max(warmup, 1),
                                         decay_steps=max(steps, warmup + 1))
    state = create_train_state(init_params, adamw(sched, weight_decay=weight_decay))
    step_fn = make_distill_step(student_apply, grad_weight=grad_weight,
                                accum_steps=accum_steps)

    history = []
    on_device: dict = {}
    it = _cycle(iter(batches))
    for i in range(steps):
        pos, imgs = next(it)
        if pos not in on_device:  # frozen teacher: label each batch once
            # a copy made here: a serving engine's output is an inference
            # tensor, which autograd refuses to record
            teacher = torch.as_tensor(teacher_fn(imgs)).to(device, torch.float32, copy=True)
            on_device[pos] = (torch.as_tensor(np.asarray(imgs)).to(device), teacher)
        state, metrics = step_fn(state, on_device[pos])
        history.append(metrics["loss"])
        if log_every and (i % log_every == 0 or i == steps - 1):
            log(f"distill step {i + 1}/{steps}: loss={float(metrics['loss']):.5f} "
                f"grad_norm={float(metrics['grad_norm']):.4f}")
    return state, torch.stack(history).tolist()
