"""Checkpoint policy (counterpart of the JAX package's ``weights/store.py``).

An upstream Depth Anything V2 ``.pth`` loads as it is, with a strict
``load_state_dict``: the port's module names are the upstream ones, so there
is no converter and no converted-params cache. Checkpoints come from local
paths only; ``hf:org/repo/file`` URIs resolve from a local mirror or raise
:class:`MissingCheckpointError`. Nothing is downloaded.

Without a checkpoint the default is an error. Deterministic random weights
(seeded ``torch.Generator``; numerics meaningless, FLOPs and layout real)
are an explicit opt-in: :func:`set_allow_random_weights` or the
:func:`allow_random_weights` context.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Mapping, Optional

import torch
import torch.nn as nn

from monocular_depth_estimation_trt_tpu_torch.config import cache_dir
from monocular_depth_estimation_trt_tpu_torch.utils.logging import log

_ALLOW_RANDOM_DEFAULT = False

# Upstream DINOv2 checkpoints carry the masked-image-modelling token, which
# inference never reads and the key manifests do not list.
DROPPED_KEYS = ("pretrained.mask_token",)

RANDOM_LAYERSCALE = 0.1  # LayerScale gamma of random weights (init_random_)


def set_allow_random_weights(allow: bool) -> None:
    """Process-wide default for the random-weights fallback policy."""
    global _ALLOW_RANDOM_DEFAULT
    _ALLOW_RANDOM_DEFAULT = bool(allow)


@contextlib.contextmanager
def allow_random_weights(allow: bool = True):
    """Scoped override of the random-weights fallback policy."""
    global _ALLOW_RANDOM_DEFAULT
    prev = _ALLOW_RANDOM_DEFAULT
    _ALLOW_RANDOM_DEFAULT = bool(allow)
    try:
        yield
    finally:
        _ALLOW_RANDOM_DEFAULT = prev


class MissingCheckpointError(FileNotFoundError):
    """No checkpoint given or found, and random weights not allowed."""


def resolve_checkpoint(path_or_uri: str) -> str:
    """Resolve a checkpoint reference to an existing local file.

    Plain paths must exist. ``hf:org/repo/file`` resolves to
    ``$MDET_HF_CACHE/org/repo/file`` (default ``cache_dir()/hf/...``), a
    manually populated local mirror."""
    if not path_or_uri.startswith("hf:"):
        if not os.path.exists(path_or_uri):
            raise MissingCheckpointError(
                f"checkpoint path {path_or_uri!r} does not exist")
        return path_or_uri
    parts = path_or_uri[3:].lstrip("/").split("/")
    if len(parts) < 3:
        raise MissingCheckpointError(
            f"malformed hf URI {path_or_uri!r}; expected hf:org/repo/file")
    mirror = os.environ.get("MDET_HF_CACHE") or os.path.join(cache_dir(), "hf")
    local = os.path.join(mirror, *parts)
    if os.path.exists(local):
        return local
    raise MissingCheckpointError(
        f"cannot resolve {path_or_uri!r}: not in the local mirror ({local}). "
        f"Nothing is downloaded; place the file there and retry."
    )


def load_state_dict(model: nn.Module, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Strict load of an upstream-named state dict. The keys of
    :data:`DROPPED_KEYS` are dropped; any other extra or missing key raises."""
    sd = {k: v for k, v in state_dict.items() if k not in DROPPED_KEYS}
    model.load_state_dict(sd, strict=True)


def load_checkpoint(model: nn.Module, path_or_uri: str) -> None:
    path = resolve_checkpoint(path_or_uri)
    log(f"Load checkpoint {path}")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    load_state_dict(model, sd)


@torch.no_grad()
def init_random_(model: nn.Module, seed: int = 0) -> None:
    """Deterministic random init from a seeded CPU ``torch.Generator``:
    lecun-normal weights and zero biases for Linear/Conv layers, identity
    LayerNorms, normal(0.02) position table, zero class and register tokens,
    normal(0.02) for the parameters a module lists in its ``normal_init``
    (VGGT's camera and register tokens): the JAX modules' initializers.
    LayerScale gammas are set to
    :data:`RANDOM_LAYERSCALE` rather than the untrained 1e-5, so that every
    attention and MLP branch moves the output, as in a trained DINOv2, and
    a whole-path comparison of two attention routes compares something."""
    g = torch.Generator().manual_seed(seed)

    def normal_(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=g, dtype=torch.float32) * std)

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight
            if isinstance(mod, nn.ConvTranspose2d):  # (in, out, kh, kw)
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            else:
                fan_in = w[0].numel()
            normal_(w, 1.0 / math.sqrt(fan_in))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm) and mod.elementwise_affine:
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    for pname, p in model.named_parameters():
        if pname.endswith(("ls1.gamma", "ls2.gamma")):
            p.fill_(RANDOM_LAYERSCALE)
        elif pname.endswith("pos_embed"):
            normal_(p, 0.02)
        elif pname.endswith(("cls_token", "register_tokens")):
            p.zero_()
    for mod in model.modules():
        for name in getattr(mod, "normal_init", ()):
            normal_(getattr(mod, name), 0.02)


def resolve_weights(model: nn.Module, name: str, *,
                    checkpoint: Optional[str] = None,
                    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                    seed: int = 0,
                    allow_random: Optional[bool] = None) -> None:
    """Fill ``model`` in place: an explicit ``state_dict``, else
    ``checkpoint``, else deterministic random weights when allowed, else
    :class:`MissingCheckpointError`."""
    if state_dict is not None:
        load_state_dict(model, state_dict)
        return
    if checkpoint:
        load_checkpoint(model, checkpoint)
        return
    allowed = _ALLOW_RANDOM_DEFAULT if allow_random is None else allow_random
    if not allowed:
        raise MissingCheckpointError(
            f"no checkpoint given for {name!r}. Pass checkpoint=<path>, or opt "
            "into benchmark-only random weights with "
            "weights.store.set_allow_random_weights(True)."
        )
    log(
        f"No checkpoint for {name!r}: using deterministic random weights "
        "(outputs are not meaningful; performance is)",
        tag="WARN",
    )
    init_random_(model, seed)
