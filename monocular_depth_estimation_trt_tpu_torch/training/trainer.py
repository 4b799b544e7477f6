"""Training loop: train state, train step with gradient accumulation and
rematerialization, save and resume (counterpart of the JAX package's
``training/trainer.py``).

* :class:`TrainState` holds the step, the fp32 master parameters (a dict of
  leaf tensors, upstream-named, as a model's ``named_parameters``) and the
  optimizer with its state and its learning-rate schedule.
* A loss is a function ``loss_fn(params, batch) -> scalar``: the model runs
  through ``torch.func.functional_call`` on ``params``.
* :func:`adamw` is optax's ``adamw`` on ``torch.optim.AdamW``: the same
  defaults (betas 0.9 / 0.999, eps 1e-8 outside the square root, weight
  decay 1e-4 on every parameter, no mask), torch's default implementation
  (``foreach=None, fused=None``: the multi-tensor kernels on the card, the
  per-tensor loop on the CPU, never the fused kernel; an explicit
  ``fused=False`` would also turn the multi-tensor path off), and the
  schedule as a ``LambdaLR`` over a base rate of 1, so that the rate of
  step ``k`` is the schedule's value at ``k`` (optax reads its count before
  incrementing it: 0 for the first update).
* :func:`save_train_state` / :func:`load_train_state` use ``torch.save``: a
  resumed run continues bit for bit.
* :func:`shard_train_state` lays the state out over a mesh (the serving
  rules place the parameters, AdamW's moments follow their parameter) and
  :func:`shard_batch_tree` splits a batch over the ``data`` axis. A step on
  a split batch runs each rank's rows and averages the loss and the
  gradients over ``data``, as the JAX step's mean over the global batch.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
import os
from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from monocular_depth_estimation_trt_tpu_torch.utils.logging import log

Schedule = Callable[[int], float]


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int) -> Schedule:
    """optax's ``warmup_cosine_decay_schedule`` (end value 0), evaluated in
    float32 as optax does: linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to 0 at ``decay_steps``, which
    includes the warmup."""
    f32 = np.float32
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")

    def schedule(step: int) -> float:
        if step < warmup_steps:
            count = f32(min(max(step, 0), warmup_steps))
            frac = f32(1) - count / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        count = f32(min(step - warmup_steps, span))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * count / f32(span)))
        return float(f32(peak_value) * cosine)

    return schedule


def adamw(learning_rate, *, weight_decay: float = 1e-4):
    """optax's ``adamw(learning_rate, weight_decay=...)`` with its defaults
    (b1 0.9, b2 0.999, eps 1e-8) as a factory ``tx(params) -> (optimizer,
    scheduler)``; ``learning_rate`` is a number or a schedule (step ->
    rate)."""
    sched = learning_rate if callable(learning_rate) else (lambda _step: learning_rate)

    def tx(params):
        opt = torch.optim.AdamW(params, lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, sched)

    return tx


@dataclasses.dataclass
class TrainState:
    """The step, the fp32 master parameters and the optimizer (with its
    moments) and schedule that update them in place."""

    step: int
    params: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler


def create_train_state(params: Mapping[str, torch.Tensor], tx) -> TrainState:
    """A fresh state from initial parameters (copied to fp32 leaves, on
    their device) and an optimizer factory (:func:`adamw`)."""
    master = {k: v.detach().to(torch.float32).clone().requires_grad_(True)
              for k, v in params.items()}
    opt, sched = tx(list(master.values()))
    return TrainState(step=0, params=master, optimizer=opt, scheduler=sched)


def _split_micro(batch, accum_steps: int):
    """A tuple of tensors -> ``accum_steps`` tuples of consecutive rows."""
    for t in batch:
        if t.shape[0] % accum_steps:
            raise ValueError(f"batch {t.shape[0]} not divisible by accum_steps {accum_steps}")
    return list(zip(*(t.chunk(accum_steps) for t in batch)))


def global_norm(tensors) -> torch.Tensor:
    """The L2 norm of all tensors together (``optax.global_norm``), from
    per-tensor norms taken by ``foreach`` kernels: a few launches, not two a
    tensor. A sharded (DTensor) tensor counts with all its shards."""
    tensors = list(tensors)
    sharded = [torch.linalg.vector_norm(t).full_tensor() for t in tensors
               if isinstance(t, DTensor)]
    plain = [t for t in tensors if not isinstance(t, DTensor)]
    if not sharded:
        return torch.nn.utils.get_total_norm(plain, 2.0)
    parts = sharded + ([torch.nn.utils.get_total_norm(plain, 2.0)] if plain else [])
    return torch.linalg.vector_norm(torch.stack(parts))


def make_train_step(loss_fn: Callable[[Dict[str, torch.Tensor], Any], torch.Tensor], *,
                    accum_steps: int = 1, remat: bool = False
                    ) -> Callable[[TrainState, Any], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """A full training step: loss, gradients, the update by the state's own
    optimizer, in place (the JAX step takes its optax ``tx`` here; a torch
    optimizer is bound to its parameters, so it lives in the state).

    The batch is a tuple of tensors. With ``accum_steps > 1`` their leading
    axis is split into that many microbatches, and the loss and gradients
    are the microbatches' mean, as the JAX package's ``lax.scan`` computes
    them. ``remat=True`` runs the loss under ``torch.utils.checkpoint``
    (non-reentrant): activations are recomputed in the backward pass.
    Returns ``{"loss", "grad_norm"}`` as 0-d tensors on the device, the
    norm of the averaged gradients."""

    def value_and_grad(params, batch):
        leaves = list(params.values())
        if remat:
            loss = checkpoint(loss_fn, params, batch, use_reentrant=False)
        else:
            loss = loss_fn(params, batch)
        # a parameter the loss never reads (the upstream DPT head's unused
        # refinenet4.resConfUnit1) gets no gradient, and AdamW leaves it
        return loss.detach(), torch.autograd.grad(loss, leaves, allow_unused=True)

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        data_group = None
        if any(isinstance(t, DTensor) for t in batch):  # split over "data" (shard_batch_tree)
            mesh = next(t for t in batch if isinstance(t, DTensor)).device_mesh
            if mesh.size(mesh.mesh_dim_names.index("data")) > 1:
                data_group = mesh.get_group("data")
            batch = tuple(t.to_local() if isinstance(t, DTensor) else t for t in batch)
        if accum_steps == 1:
            loss, grads = value_and_grad(state.params, batch)
        else:
            loss, grads = None, None
            for mb in _split_micro(batch, accum_steps):
                lo, g = value_and_grad(state.params, mb)
                loss = lo if loss is None else loss + lo
                grads = g if grads is None else [None if a is None else a + b
                                                 for a, b in zip(grads, g)]
            loss = loss / accum_steps
            grads = [None if g is None else g / accum_steps for g in grads]
        if data_group is not None:
            loss, grads = _mean_over(data_group, loss, grads)
        grads = [_like_param(p, g) for p, g in zip(state.params.values(), grads)]
        for p, g in zip(state.params.values(), grads):
            p.grad = g
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.scheduler.step()
        state.step += 1
        return state, {"loss": loss, "grad_norm": global_norm(g for g in grads if g is not None)}

    return step_fn


def _mean_over(group, loss, grads):
    """The loss and the gradients averaged over the ranks of ``group``
    (each rank's from its rows of the batch)."""
    n = dist.get_world_size(group)
    dist.all_reduce(loss, group=group)
    for g in grads:
        if g is not None:  # a sharded gradient's local part is the same part on every rank
            dist.all_reduce(g.to_local() if isinstance(g, DTensor) else g, group=group)
    return loss / n, [None if g is None else g / n for g in grads]


def _like_param(p: torch.Tensor, g):
    """A DTensor gradient in its parameter's placements (autograd may give
    a row-split weight a replicated gradient)."""
    if isinstance(g, DTensor) and isinstance(p, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def shard_train_state(mesh, rules, state: TrainState) -> TrainState:
    """The state laid out over ``mesh``: parameters placed by the serving
    ``ShardingRules`` (``parallel/sharding.py``), AdamW's moments
    (``exp_avg``, ``exp_avg_sq``) in their parameter's placements, the step
    and the schedule position kept. On a one-device mesh the state is
    returned as it is.

    The model the loss runs must have its layers prepared by
    ``rules.apply(mesh, model)``: ``functional_call`` then hands the
    sharded parameters to their tensor-parallel forwards. The optimizer is
    rebuilt with the sharded and the replicated parameters in two groups, so
    that each multi-tensor update sees one kind of tensor."""
    if mesh.size() == 1:
        return state
    old_opt = state.optimizer
    params = {k: rules.place(mesh, k, v.detach().clone()).requires_grad_(True)
              for k, v in state.params.items()}
    sharded = [p for p in params.values() if isinstance(p, DTensor)]
    plain = [p for p in params.values() if not isinstance(p, DTensor)]
    accepted = inspect.signature(type(old_opt)).parameters
    hyper = {k: v for k, v in old_opt.defaults.items() if k in accepted and k != "lr"}
    opt = type(old_opt)([g for g in ({"params": sharded}, {"params": plain}) if g["params"]],
                        lr=1.0, **hyper)
    for old_p, (name, p) in zip(state.params.values(), params.items()):
        moments = old_opt.state.get(old_p)
        if moments:
            opt.state[p] = {k: (rules.place(mesh, name, v) if torch.is_tensor(v)
                                and v.shape == old_p.shape else v)
                            for k, v in moments.items()}
    for group in opt.param_groups:
        group["initial_lr"] = 1.0  # the schedule's base rate (adamw)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, state.scheduler.lr_lambdas[0],
                                              last_epoch=state.scheduler.last_epoch - 1)
    return TrainState(step=state.step, params=params, optimizer=opt, scheduler=sched)


def shard_batch_tree(mesh, batch, axis: str = "data"):
    """Every tensor's leading (batch) axis split over ``axis`` (the batch
    as it is on a one-device mesh)."""
    from monocular_depth_estimation_trt_tpu_torch.parallel.sharding import shard_batch

    return tuple(shard_batch(mesh, t, axis) for t in batch)


def save_train_state(path: str, state: TrainState) -> str:
    """Write the whole state (step, parameters, optimizer moments and
    schedule position) with ``torch.save``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"step": state.step,
                "params": {k: v.detach().cpu() for k, v in state.params.items()},
                "optimizer": state.optimizer.state_dict(),
                "scheduler": state.scheduler.state_dict()}, tmp)
    os.replace(tmp, path)
    log(f"saved train state (step {state.step}) -> {path}")
    return path


def load_train_state(path: str, like: TrainState) -> TrainState:
    """Restore a state written by :func:`save_train_state` into ``like`` (a
    fresh state of the same model and optimizer), in place: training
    resumes where it stopped."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if sorted(saved["params"]) != sorted(like.params):
        raise ValueError(f"{path}: the saved parameters are not the model's")
    with torch.no_grad():
        for k, p in like.params.items():
            p.copy_(saved["params"][k])
    like.optimizer.load_state_dict(saved["optimizer"])
    like.scheduler.load_state_dict(saved["scheduler"])
    like.step = int(saved["step"])
    return like

