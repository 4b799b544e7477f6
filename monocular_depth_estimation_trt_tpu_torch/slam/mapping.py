"""Uncertainty-aware Gaussian mapping, the WildGS-SLAM optimization loop
(counterpart of the JAX package's ``slam/mapping.py``).

WildGS-SLAM (arXiv 2504.03886; reference recipe ``later/WildGS-SLAM/
README.md``) trains a shallow per-sequence uncertainty predictor and uses
its per-pixel ``beta`` to down-weight dynamic regions in the rendering
loss. Here:

  * :class:`UncertaintyNet`: a small conv head over the RGB frame (the
    per-sequence online-trained module);
  * :func:`mapping_loss`: heteroscedastic L1 photometric + depth-anchor
    loss, ``|I - I_hat| / beta^2 + lambda log beta``, masked by the rendered
    coverage;
  * :func:`make_mapping_step`: one Adam step over (gaussians, uncertainty
    net) jointly: ``torch.func.grad_and_value`` over the map's tensors and
    the net's parameters (``torch.func.functional_call``), the masked
    gradients, and optax's Adam written out as tensor ops. The recipes
    capture the whole step (forward, backward, update) as one engine; the
    state goes in and comes out as tensors, as the JAX step's does (no
    donation).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from monocular_depth_estimation_trt_tpu_torch.slam.gaussians import GaussianMap, RenderOut, render


class UncertaintyNet(nn.Module):
    """Per-pixel uncertainty head (online-trained, per sequence): two 3x3
    convolutions with ReLU and a 1x1 one, then ``0.3 + softplus`` (beta in
    [0.3, ~20], bounded below so that the loss cannot explode). The JAX
    module's ``Conv_0``/``Conv_1``/``Conv_2`` are ``conv0``/``conv1``/``conv2``
    here. ``in_channels``: 3, plus the channels of optional ``features``."""

    def __init__(self, width: int = 32, in_channels: int = 3):
        super().__init__()
        self.conv0 = nn.Conv2d(in_channels, width, 3, padding=1)
        self.conv1 = nn.Conv2d(width, width, 3, padding=1)
        self.conv2 = nn.Conv2d(width, 1, 1)

    def forward(self, rgb: torch.Tensor, features: Optional[torch.Tensor] = None) -> torch.Tensor:
        """rgb (H, W, 3) or (1, H, W, 3) -> beta (H, W)."""
        x = rgb[None] if rgb.dim() == 3 else rgb
        if features is not None:
            x = torch.cat([x, features[None] if features.dim() == 3 else features], dim=-1)
        x = F.relu(conv_nhwc(F.relu(conv_nhwc(x, self.conv0)), self.conv1))
        return 0.3 + F.softplus(conv_nhwc(x, self.conv2))[0, ..., 0]


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` (stride 1, 'same' padding, odd kernel) on NHWC ``x`` as one
    matmul over the kernel's shifted windows. Its gradients are matmuls and
    slices, which replay bit for bit, where cuDNN's weight-gradient kernels
    accumulate with atomics: an eager mapping step and its graph's replay
    would differ at the last bits."""
    kh, kw = conv.kernel_size
    h, w = x.shape[1:3]
    xp = F.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    cols = torch.cat([xp[:, i:i + h, j:j + w] for i in range(kh) for j in range(kw)], dim=-1)
    # (O, I, kh, kw) -> (kh * kw * I, O), in the order of the windows
    return cols @ conv.weight.permute(2, 3, 1, 0).reshape(-1, conv.out_channels) + conv.bias


class MappingConfig(NamedTuple):
    lr: float = 5e-3
    lr_uncertainty: float = 1e-3
    depth_weight: float = 0.5
    beta_reg: float = 0.5
    tile: int = 16
    k_per_tile: int = 32


def mapping_loss(gmap: GaussianMap, unc_params: Dict[str, torch.Tensor], unc_net: UncertaintyNet,
                 frame_rgb: torch.Tensor, depth_anchor: torch.Tensor, c2w: torch.Tensor, focal,
                 cfg: MappingConfig) -> Tuple[torch.Tensor, RenderOut]:
    out = render(gmap, c2w, focal, tuple(frame_rgb.shape[:2]), tile=cfg.tile,
                 k_per_tile=cfg.k_per_tile)
    beta = torch.func.functional_call(unc_net, unc_params, (frame_rgb,))  # (H, W)
    cover = torch.clamp(out.alpha, 0.0, 1.0)
    ib2 = 1.0 / (beta * beta)
    l_rgb = torch.mean(cover * torch.sum(torch.abs(out.color - frame_rgb), -1) * ib2)
    l_depth = torch.mean(cover * torch.abs(out.depth - depth_anchor) * ib2)
    l_beta = torch.mean(torch.log(beta))
    return l_rgb + cfg.depth_weight * l_depth + cfg.beta_reg * l_beta, out


class AdamState(NamedTuple):
    """optax ``scale_by_adam``'s state for one parameter group."""

    count: torch.Tensor  # () int32, steps taken
    mu: Tuple[torch.Tensor, ...]
    nu: Tuple[torch.Tensor, ...]


class MappingOptState(NamedTuple):
    """The two groups of ``optax.multi_transform``: the map's and the net's."""

    gauss: AdamState
    unc: AdamState


def adam_init(params) -> AdamState:
    return AdamState(count=torch.zeros((), dtype=torch.int32, device=params[0].device),
                     mu=tuple(torch.zeros_like(p) for p in params),
                     nu=tuple(torch.zeros_like(p) for p in params))


def adam_update(params, grads, state: AdamState, lr: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8):
    """``optax.adam(lr)`` written out (the JAX step's optimizer): moments
    ``(1 - b) * g + b * m``; bias correction by ``1 - b ** count`` from
    count 1; ``eps`` outside the square root, ``eps_root`` 0; the update
    ``-lr * mu_hat / (sqrt(nu_hat) + eps)`` added to the parameter.
    Returns the new parameters and state."""
    count = state.count + 1
    c = count.float()
    bc1, bc2 = 1.0 - torch.pow(b1, c), 1.0 - torch.pow(b2, c)
    mu = tuple((1.0 - b1) * g + b1 * m for g, m in zip(grads, state.mu))
    nu = tuple((1.0 - b2) * (g * g) + b2 * n for g, n in zip(grads, state.nu))
    new = tuple(p + (-lr) * ((m / bc1) / (torch.sqrt(n / bc2) + eps))
                for p, m, n in zip(params, mu, nu))
    return new, AdamState(count=count, mu=mu, nu=nu)


def ggrad_mask(g: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return g * valid.reshape((-1,) + (1,) * (g.dim() - 1))


def make_mapping_step(unc_net: UncertaintyNet, cfg: MappingConfig):
    """Returns (init_opt, step):
    ``step(gmap, unc_params, opt_state, frame_rgb, depth_anchor, c2w, focal)
    -> (gmap, unc_params, opt_state, loss, RenderOut)``, with ``unc_params``
    a dict of the net's parameters by name. Reads no device value on the
    host, so that a captured graph can hold it; deterministic (the
    uncertainty net's convolutions by :func:`conv_nhwc`), so that the
    graph's replay equals the eager step bit for bit."""

    def init_opt(gmap: GaussianMap, unc_params: Dict[str, torch.Tensor]) -> MappingOptState:
        return MappingOptState(gauss=adam_init(tuple(gmap)),
                               unc=adam_init(tuple(unc_params.values())))

    def step(gmap: GaussianMap, unc_params: Dict[str, torch.Tensor], opt_state: MappingOptState,
             frame_rgb, depth_anchor, c2w, focal):
        # autograd, which inference mode (where an Engine runs and captures
        # its function) refuses; grad_and_value ignores the outer no_grad
        with torch.inference_mode(False), torch.no_grad():
            return _step(gmap, unc_params, opt_state, frame_rgb, depth_anchor, c2w, focal)

    def _step(gmap, unc_params, opt_state, frame_rgb, depth_anchor, c2w, focal):
        names = tuple(unc_params)

        def lossfn(pair):
            g, u = pair
            loss, out = mapping_loss(GaussianMap(*g), dict(zip(names, u)), unc_net, frame_rgb,
                                     depth_anchor, c2w, focal, cfg)
            return loss, out

        (ggrad, ugrad), (loss, out) = torch.func.grad_and_value(lossfn, has_aux=True)(
            (tuple(gmap), tuple(unc_params.values())))
        ggrad = GaussianMap(*ggrad)
        # frozen slots: zero gradients where the slot is unoccupied
        mask = gmap.valid
        ggrad = GaussianMap(means=ggrad_mask(ggrad.means, mask),
                            log_scales=ggrad_mask(ggrad.log_scales, mask),
                            quats=ggrad_mask(ggrad.quats, mask),
                            colors_logit=ggrad_mask(ggrad.colors_logit, mask),
                            opacity_logit=ggrad.opacity_logit * mask,
                            valid=torch.zeros_like(ggrad.valid))
        new_g, gstate = adam_update(tuple(gmap), tuple(ggrad), opt_state.gauss, cfg.lr)
        new_u, ustate = adam_update(tuple(unc_params.values()), ugrad, opt_state.unc,
                                    cfg.lr_uncertainty)
        return (GaussianMap(*new_g), dict(zip(names, new_u)), MappingOptState(gstate, ustate),
                loss, out)

    return init_opt, step
