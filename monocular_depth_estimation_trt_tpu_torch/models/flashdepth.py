"""FlashDepth: streaming video depth with a Mamba temporal module
(counterpart of the JAX package's ``models/flashdepth.py``).

A DINOv2 encoder and DA-V2's DPT fusion pyramid, with a pre-norm residual
Mamba-1 block on the bottleneck fusion output (``path4``, the patch grid):
a per-token recurrence over the frames, whose state (the causal conv's FIFO
and the SSM's hidden state) carries from one frame to the next. The final
head has no activation; the depth is clipped at 0 (the reference wrapper's
``clip(min=0)``).

The module is one step, ``(frame, state) -> (depth, new state)``: a clip
runs as a Python loop of steps (:func:`flashdepth_video`, the JAX package's
``lax.scan``), and a streaming session (``apps/streaming.py``) keeps the
state in static device buffers that its captured step overwrites in place.
``mamba_ssm`` is not a dependency: the selective scan is written out in
torch. The SSM runs in fp32 as in the JAX package: :class:`MambaBlock`
keeps its parameters in fp32 when the model is cast to bf16 (``dt`` feeds
``exp``), and its matmuls need TF32 off, which the pipeline's build checks.

Module names follow the upstream layout of ``tests/torch_mirror_flashdepth.py``
(``weights/manifests/flashdepth_vits.json``); the Mamba parameters are
``mamba_ssm``'s: ``in_proj``, ``conv1d``, ``x_proj``, ``dt_proj``, ``A_log``,
``D`` and ``out_proj``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from monocular_depth_estimation_trt_tpu_torch.models.depth_anything_v2 import (
    HEAD_CONFIGS,
    INTERMEDIATE_LAYER_IDX,
)
from monocular_depth_estimation_trt_tpu_torch.models.dpt import (
    _bilinear_ac,
    _Scratch,
    project_levels,
    resize_layers,
)
from monocular_depth_estimation_trt_tpu_torch.models.vit import VIT_CONFIGS, DinoViT, ViTConfig

State = Dict[str, torch.Tensor]


class MambaBlock(nn.Module):
    """One selective-SSM (Mamba-1) step over the frame axis: tokens (B, N,
    d_model) and the state ``conv`` (B, N, d_conv - 1, d_inner), the causal
    depthwise conv's FIFO, and ``ssm`` (B, N, d_inner, d_state), fp32 ->
    (B, N, d_model) fp32 and the new state."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4, expand: int = 2):
        super().__init__()
        self.d_state, self.d_conv = d_state, d_conv
        self.d_inner = expand * d_model
        self.dt_rank = math.ceil(d_model / 16)
        self.in_proj = nn.Linear(d_model, 2 * self.d_inner, bias=False)
        self.conv1d = nn.Conv1d(self.d_inner, self.d_inner, d_conv, groups=self.d_inner)
        self.x_proj = nn.Linear(self.d_inner, self.dt_rank + 2 * d_state, bias=False)
        self.dt_proj = nn.Linear(self.dt_rank, self.d_inner)
        self.A_log = nn.Parameter(torch.empty(self.d_inner, d_state))
        self.D = nn.Parameter(torch.empty(self.d_inner))
        self.out_proj = nn.Linear(self.d_inner, d_model, bias=False)
        self.init_constants_()

    @torch.no_grad()
    def init_constants_(self) -> None:
        """``A_log = log(1 .. d_state)`` on every channel and ``D = 1``: the
        JAX (and ``mamba_ssm``) initial values; random weights keep them."""
        a = torch.arange(1, self.d_state + 1, dtype=torch.float32, device=self.A_log.device)
        self.A_log.copy_(torch.log(a).expand_as(self.A_log))
        self.D.fill_(1.0)

    def _apply(self, fn, recurse=True):
        """Moves keep fp32: a cast of the model (to bf16) moves the block's
        tensors to the cast's device and leaves their type."""
        probe = fn(torch.zeros(1))
        if probe.dtype == torch.float32:
            return super()._apply(fn, recurse)
        return super()._apply(lambda t: t.to(probe.device) if t.is_floating_point() else fn(t),
                              recurse)

    def forward(self, x: torch.Tensor, state: State) -> Tuple[torch.Tensor, State]:
        x = x.float()
        xi, z = self.in_proj(x).chunk(2, dim=-1)
        # causal depthwise conv over time: d_conv - 1 cached steps + this one
        window = torch.cat([state["conv"].float(), xi[:, :, None]], dim=2)
        w = self.conv1d.weight[:, 0, :].t()  # (d_conv, d_inner)
        xc = F.silu((window * w).sum(dim=2) + self.conv1d.bias)
        dt, b, c = torch.split(self.x_proj(xc), [self.dt_rank, self.d_state, self.d_state],
                               dim=-1)
        dt = F.softplus(self.dt_proj(dt))  # (B, N, d_inner)
        a = -torch.exp(self.A_log)
        h = torch.exp(dt[..., None] * a) * state["ssm"].float() \
            + dt[..., None] * b[:, :, None, :] * xc[..., None]  # ZOH discretization
        y = (h * c[:, :, None, :]).sum(dim=-1) + self.D * xc
        out = self.out_proj(y * F.silu(z))
        return out, {"conv": window[:, :, 1:], "ssm": h}


class TemporalDPTHead(nn.Module):
    """DA-V2's DPT head with a pre-norm residual Mamba block on ``path4``:
    the four taps' tokens and the state -> depth (B, H, W) fp32 without an
    activation, and the new state."""

    def __init__(self, in_channels: int, features: int = 64,
                 out_channels: Sequence[int] = (48, 96, 192, 384), patch_size: int = 14,
                 d_state: int = 16, d_conv: int = 4, expand: int = 2):
        super().__init__()
        oc = list(out_channels)
        self.patch_size = patch_size
        self.projects = nn.ModuleList(nn.Conv2d(in_channels, c, 1) for c in oc)
        self.resize_layers = resize_layers(oc)
        self.scratch = _Scratch(oc, features, 1)
        self.temporal_norm = nn.LayerNorm(features, eps=1e-6)
        self.mamba = MambaBlock(features, d_state, d_conv, expand)

    def forward(self, features, patch_hw: Tuple[int, int],
                state: State) -> Tuple[torch.Tensor, State]:
        ph, pw = patch_hw
        s = self.scratch
        l1, l2, l3, l4 = (getattr(s, f"layer{i + 1}_rn")(x)
                          for i, x in enumerate(project_levels(self, features, patch_hw)))
        path4 = s.refinenet4(l4, size=l3.shape[-2:])
        b, c, hh, ww = path4.shape
        tok = path4.flatten(2).transpose(1, 2).float()  # (B, N, C)
        normed = F.layer_norm(tok, (c,), self.temporal_norm.weight.float(),
                              self.temporal_norm.bias.float(), self.temporal_norm.eps)
        m, new_state = self.mamba(normed, state)
        path4 = (tok + m).to(path4.dtype).transpose(1, 2).reshape(b, c, hh, ww)
        path3 = s.refinenet3(path4, l3, size=l2.shape[-2:])
        path2 = s.refinenet2(path3, l2, size=l1.shape[-2:])
        path1 = s.refinenet1(path2, l1)
        out = _bilinear_ac(s.output_conv1(path1), (ph * self.patch_size, pw * self.patch_size))
        return s.output_conv2(out).float()[:, 0], new_state


class FlashDepth(nn.Module):
    """One temporal step: a preprocessed frame (B, H, W, 3), H and W
    multiples of 14, and the state -> depth (B, H, W) float32 clipped at 0,
    and the new state. A fresh sequence (upstream
    ``start_new_sequence()``) starts from :func:`flashdepth_init_state`."""

    def __init__(self, encoder: str = "vits", d_state: int = 16, d_conv: int = 4,
                 expand: int = 2, attn_impl: str = "auto",
                 vit_config: Optional[ViTConfig] = None, head_features: Optional[int] = None,
                 head_out_channels: Optional[Sequence[int]] = None,
                 out_indices: Optional[Sequence[int]] = None):
        super().__init__()
        vit_cfg = vit_config or VIT_CONFIGS[encoder]
        head_cfg = HEAD_CONFIGS.get(encoder, {})
        self.patch_size = vit_cfg.patch_size
        self.pretrained = DinoViT(vit_cfg, out_indices=out_indices or INTERMEDIATE_LAYER_IDX[encoder],
                                  attn_impl=attn_impl)
        self.depth_head = TemporalDPTHead(vit_cfg.dim, head_features or head_cfg["features"],
                                          head_out_channels or head_cfg["out_channels"],
                                          vit_cfg.patch_size, d_state, d_conv, expand)

    def forward(self, frame: torch.Tensor, state: State) -> Tuple[torch.Tensor, State]:
        ph, pw = frame.shape[1] // self.patch_size, frame.shape[2] // self.patch_size
        depth, new_state = self.depth_head(self.pretrained(frame), (ph, pw), state)
        return torch.clamp(depth, min=0.0), new_state


def flashdepth_init_state(model: FlashDepth, batch: int, patch_hw: Tuple[int, int],
                          device=None) -> State:
    """The zero temporal state (upstream ``mamba.start_new_sequence()``), fp32."""
    mamba = model.depth_head.mamba
    n = patch_hw[0] * patch_hw[1]
    return {
        "conv": torch.zeros((batch, n, mamba.d_conv - 1, mamba.d_inner), device=device),
        "ssm": torch.zeros((batch, n, mamba.d_inner, mamba.d_state), device=device),
    }


def flashdepth_video(model: FlashDepth, frames: torch.Tensor,
                     state: Optional[State] = None) -> Tuple[torch.Tensor, State]:
    """A clip (B, S, H, W, 3), preprocessed, one step a frame (the JAX
    package's ``lax.scan``, the reference's Python loop) -> depths (B, S,
    H, W) and the final state."""
    if state is None:
        ph, pw = frames.shape[2] // model.patch_size, frames.shape[3] // model.patch_size
        state = flashdepth_init_state(model, frames.shape[0], (ph, pw), frames.device)
    depths = []
    for s in range(frames.shape[1]):
        depth, state = model(frames[:, s], state)
        depths.append(depth)
    return torch.stack(depths, dim=1), state
