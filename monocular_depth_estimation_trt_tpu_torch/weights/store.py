"""Checkpoint policy and the params cache (counterpart of the JAX package's
``weights/store.py``).

An upstream checkpoint loads as it is, with a strict ``load_state_dict``:
the port's module names are the upstream ones, so there is no converter.
Checkpoints come from local paths only; ``hf:org/repo/file`` URIs resolve
from a local mirror or raise :class:`MissingCheckpointError`. Nothing is
downloaded.

The params cache holds upstream-named fp32 state dicts,
``cache_dir()/params/<artifact>.pt`` (:func:`params_path`), beside the JAX
package's orbax directories ``params/<artifact>``, which it never touches.
``convert`` and ``distill --promote`` write it; :func:`resolve_weights`
reads it when it is given no state dict and no checkpoint. An explicit
checkpoint wins over the cache, and a load never writes it: a stale cache
must not shadow the file a user names (the JAX package reads its cache
first and writes it on every conversion).

Without a checkpoint or a cache entry the default is an error.
Deterministic random weights (seeded ``torch.Generator``; numerics
meaningless, FLOPs and layout real) are an explicit opt-in:
:func:`set_allow_random_weights` or the :func:`allow_random_weights`
context.
"""

from __future__ import annotations

import contextlib
import math
import os
import re
from typing import Any, Dict, List, Mapping, Optional

import torch
import torch.nn as nn

from monocular_depth_estimation_trt_tpu_torch.config import cache_dir
from monocular_depth_estimation_trt_tpu_torch.utils.logging import log

_ALLOW_RANDOM_DEFAULT = False
_LOADS: Optional[List[Dict[str, Any]]] = None  # checkpoint_loads()' record
_REPORT_ONLY = False

# Upstream DINOv2 checkpoints carry the masked-image-modelling token, which
# inference never reads and the key manifests do not list.
DROPPED_KEYS = ("pretrained.mask_token",)

RANDOM_LAYERSCALE = 0.1  # LayerScale gamma of random weights (init_random_)


def set_allow_random_weights(allow: bool) -> None:
    """Process-wide default for the random-weights fallback policy."""
    global _ALLOW_RANDOM_DEFAULT
    _ALLOW_RANDOM_DEFAULT = bool(allow)


def random_weights_allowed() -> bool:
    """The current random-weights fallback policy."""
    return _ALLOW_RANDOM_DEFAULT


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


def load_state_dict(model: nn.Module, state_dict: Mapping[str, torch.Tensor],
                    allowed_unconsumed: Optional[str] = None) -> None:
    """Strict load of an upstream-named state dict. A ``module.`` prefix on
    every key (a checkpoint saved from ``nn.DataParallel``, as RAFT's
    released ones are) is removed; the keys of :data:`DROPPED_KEYS` are
    dropped, and so are keys the model does not hold that match the regex
    ``allowed_unconsumed`` (with a warning); any other extra or missing key
    raises."""
    sd = _normalized(state_dict)
    if allowed_unconsumed:
        held = set(model.state_dict())
        extra = [k for k in sd if k not in held and re.search(allowed_unconsumed, k)]
        if extra:
            log(f"checkpoint: {len(extra)} keys the model does not use are dropped "
                f"(allowed: {allowed_unconsumed!r}), e.g. {extra[0]!r}", tag="WARN")
        sd = {k: v for k, v in sd.items() if k not in extra}
    try:
        model.load_state_dict(sd, strict=True)
    except RuntimeError as e:
        raise StateDictMismatchError(str(e)) from e


class StateDictMismatchError(RuntimeError):
    """A strict load found missing, extra or misshapen tensors."""


def _normalized(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    if state_dict and all(k.startswith("module.") for k in state_dict):
        state_dict = {k[len("module."):]: v for k, v in state_dict.items()}
    return {k: v for k, v in state_dict.items() if k not in DROPPED_KEYS}


def audit_state_dict(model: nn.Module, state_dict: Mapping[str, torch.Tensor],
                     allowed_unconsumed: Optional[str] = None) -> Dict[str, Any]:
    """What a strict :func:`load_state_dict` of ``state_dict`` into
    ``model`` would consume, without loading: ``consumed`` (the count of
    checkpoint tensors the model holds), ``missing`` (the model's tensors the
    checkpoint lacks), ``extra`` (checkpoint tensors the model does not hold,
    bookkeeping tensors and the declared ``allowed_unconsumed`` ones aside)
    and ``shape_mismatch``."""
    from monocular_depth_estimation_trt_tpu_torch.weights.manifest import AUDIT_IGNORE

    sd = _normalized(state_dict)
    held = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    extra = sorted(k for k in sd if k not in held and not AUDIT_IGNORE.search(k)
                   and not (allowed_unconsumed and re.search(allowed_unconsumed, k)))
    missing = sorted(k for k in held if k not in sd)
    mismatch = {k: {"checkpoint": list(sd[k].shape), "model": list(held[k])}
                for k in held if k in sd and tuple(sd[k].shape) != held[k]}
    return {"total": len(state_dict), "consumed": sum(k in held for k in sd),
            "missing": missing, "extra": extra, "shape_mismatch": mismatch}


@contextlib.contextmanager
def checkpoint_loads(report_only: bool = False):
    """Record each checkpoint load that :func:`resolve_weights` makes in the
    scope, as a dict of ``name`` (the artifact), ``path``, ``audit``
    (:func:`audit_state_dict`) and ``state_dict`` (the model's fp32 tensors
    just after the load). With ``report_only`` a load is audited and not
    made: the model keeps what it held, and ``state_dict`` is None."""
    global _LOADS, _REPORT_ONLY
    prev = _LOADS, _REPORT_ONLY
    _LOADS, _REPORT_ONLY = [], bool(report_only)
    try:
        yield _LOADS
    finally:
        _LOADS, _REPORT_ONLY = prev


def params_path(name: str) -> str:
    """The params cache file of artifact ``name``: ``.pt`` beside the JAX
    package's orbax directory of the same name, never the same path."""
    return os.path.join(cache_dir(), "params", name + ".pt")


def save_params(name: str, state_dict: Mapping[str, torch.Tensor]) -> str:
    """Write an upstream-named state dict (floating tensors as fp32, on the
    host) to the params cache of ``name``; returns the path."""
    path = params_path(name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    host = {k: (v.detach().to("cpu", torch.float32) if v.is_floating_point()
                else v.detach().cpu()) for k, v in state_dict.items()}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(host, tmp)
    os.replace(tmp, path)
    log(f"saved params -> {path}")
    return path


def load_params(name: str) -> Optional[Dict[str, torch.Tensor]]:
    """The cached state dict of ``name``, or None where there is none."""
    path = params_path(name)
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


@torch.no_grad()
def init_random_(model: nn.Module, seed: int = 0) -> None:
    """Deterministic random init from a seeded ``torch.Generator``:
    lecun-normal weights and zero biases for Linear/Conv layers, identity
    LayerNorms, GroupNorms and BatchNorms (the flow models' folded identity:
    unit scale, zero mean, ``var + eps`` = 1), normal(0.02) position table, zero class and register tokens,
    normal(0.02) for the parameters a module lists in its ``normal_init``
    (VGGT's camera and register tokens), and a module's own
    ``init_constants_()`` (the Mamba block's A_log and D): the JAX modules'
    initializers.
    LayerScale gammas are set to
    :data:`RANDOM_LAYERSCALE` rather than the untrained 1e-5, so that every
    attention and MLP branch moves the output, as in a trained DINOv2, and
    a whole-path comparison of two attention routes compares something.

    The generator lives where the parameters do: a model that lives on the
    card (too large to build on the host) is filled there, from a seeded
    CUDA generator, whose numbers differ from the CPU's."""
    device = next(model.parameters()).device
    g = torch.Generator(device=device).manual_seed(seed)

    def normal_(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=g, dtype=torch.float32, device=device) * std)

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d)):
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
        elif isinstance(mod, nn.GroupNorm) and mod.affine:
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):  # the folded identity: var + eps = 1
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0 - mod.eps)
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
        if hasattr(mod, "init_constants_"):
            mod.init_constants_()


def resolve_weights(model: nn.Module, name: str, *,
                    checkpoint: Optional[str] = None,
                    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                    seed: int = 0,
                    allow_random: Optional[bool] = None,
                    allowed_unconsumed: Optional[str] = None) -> None:
    """Fill ``model`` in place: an explicit ``state_dict``, else
    ``checkpoint``, else the params cache of ``name``, else deterministic
    random weights when allowed, else :class:`MissingCheckpointError`.
    ``allowed_unconsumed``: see :func:`load_state_dict`."""
    if state_dict is not None:
        load_state_dict(model, state_dict, allowed_unconsumed)
        return
    if checkpoint:
        path = resolve_checkpoint(checkpoint)
        log(f"Load checkpoint {path}")
        sd = torch.load(path, map_location="cpu", weights_only=True)
        entry = {"name": name, "path": path, "state_dict": None}
        if _LOADS is not None:
            entry["audit"] = audit_state_dict(model, sd, allowed_unconsumed)
            _LOADS.append(entry)
        if not _REPORT_ONLY:
            load_state_dict(model, sd, allowed_unconsumed)
            if _LOADS is not None:
                # the model is fp32 until the registry casts it, which
                # leaves these tensors as they are
                entry["state_dict"] = {k: v.detach() for k, v in model.state_dict().items()}
        return
    try:
        cached = load_params(name)
    except (OSError, RuntimeError, ValueError) as e:
        log(f"params cache of {name!r} unreadable ({e!r}); falling through", tag="WARN")
        cached = None
    if cached is not None:
        try:
            load_state_dict(model, cached, allowed_unconsumed)
            log(f"Load params from cache ({params_path(name)})")
            return
        except StateDictMismatchError as e:
            log(f"params cache of {name!r} does not fit the model ({e}); falling through",
                tag="WARN")
    allowed = _ALLOW_RANDOM_DEFAULT if allow_random is None else allow_random
    if not allowed:
        raise MissingCheckpointError(
            f"no checkpoint given and none cached for {name!r}. Pass checkpoint=<path> "
            "(or install weights with `convert`), or opt "
            "into benchmark-only random weights with "
            "weights.store.set_allow_random_weights(True)."
        )
    log(
        f"No checkpoint for {name!r}: using deterministic random weights "
        "(outputs are not meaningful; performance is)",
        tag="WARN",
    )
    init_random_(model, seed)
