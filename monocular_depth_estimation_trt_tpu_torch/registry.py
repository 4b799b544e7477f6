"""Model registry: name -> pipeline factory (counterpart of the JAX package's
``registry.py``)::

    pipe = build_pipeline("depth_anything_v2", encoder="vits")
    out = pipe(image_rgb_u8)

Ported so far: the Depth Anything family (``depth_anything_v2``,
``distill_any_depth``, ``depth_anything_ac``, ``dkt``, ``bridge``), which
shares one serving graph. Every factory takes ``device``; ``None`` means
``"cuda"``, and a missing card is an error, never a quiet move to the CPU.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import torch

from monocular_depth_estimation_trt_tpu_torch.config import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ModelSpec,
)
from monocular_depth_estimation_trt_tpu_torch.pipelines import (
    DepthPipeline,
    depth_forward_factory,
)

_REGISTRY: Dict[str, Callable] = {}
_FIDELITY: Dict[str, str] = {}


def register(name: str, fidelity: str = "approximated"):
    if fidelity not in ("converter-verified", "architecture-matched",
                        "approximated"):
        raise ValueError(f"unknown fidelity {fidelity!r}")

    def deco(fn):
        _REGISTRY[name] = fn
        _FIDELITY[name] = fidelity
        return fn

    return deco


def get_fidelity(name: str) -> str:
    return _FIDELITY.get(name, "approximated")


def list_models():
    return sorted(_REGISTRY)


def build_pipeline(name: str, **kwargs) -> DepthPipeline:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {list_models()}")
    return _REGISTRY[name](**kwargs)


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``"cuda"``. A CUDA device without a card raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    return device


def resolve_int8_precision(model_name: str, encoder: str, precision: str) -> str:
    """int8 (w8a8 serving, kernel K4) is not ported yet: refuse it clearly."""
    if precision == "int8":
        raise NotImplementedError(
            f"{model_name} {encoder}: precision='int8' needs the w8a8 matmul "
            "kernel K4 (ops/pallas/quant_matmul.py::_w8a8_kernel), which is "
            "not ported to CUDA yet; use bf16, fp16 or fp32"
        )
    return precision


# ---------------------------------------------------------------------------
# Depth Anything family (DA-V2 / Distill / AC / DKT / BRIDGE share the graph)
# ---------------------------------------------------------------------------


def _build_da_family(
    model_name: str,
    encoder: str,
    *,
    input_size: int = 518,
    metric: bool = False,
    dataset: str = "hypersim",
    max_depth: Optional[float] = None,
    precision: str = "bf16",
    attn_impl: str = "auto",
    checkpoint: Optional[str] = None,
    params: Optional[Mapping[str, torch.Tensor]] = None,
    viz: Optional[str] = None,
    resize_mode: str = "square",  # "square" | "lower_bound"
    device=None,
    model_kw: Optional[Dict[str, Any]] = None,
) -> DepthPipeline:
    """``params``: an upstream-named state dict (e.g. from
    ``weights.from_jax.state_dict_from_jax``); ``model_kw``: overrides of
    the encoder presets passed to ``DepthAnythingV2`` (``vit_config``,
    ``head_features``, ``head_out_channels``, ``out_indices``)."""
    from monocular_depth_estimation_trt_tpu_torch.config import compute_dtype
    from monocular_depth_estimation_trt_tpu_torch.models.depth_anything_v2 import (
        DepthAnythingV2,
    )
    from monocular_depth_estimation_trt_tpu_torch.ops.preprocess import (
        normalize,
        preprocess_lower_bound,
        to_float_rgb,
    )
    from monocular_depth_estimation_trt_tpu_torch.ops.resize import resize
    from monocular_depth_estimation_trt_tpu_torch.weights.store import resolve_weights

    if resize_mode not in ("square", "lower_bound"):
        raise ValueError(f"unknown resize_mode {resize_mode!r}")
    device = resolve_device(device)
    if max_depth is None:
        # hypersim (indoor) 20 m, vkitti (outdoor) 80 m
        # (reference Depth_Anything_V2/infer_metric.py:54-58)
        max_depth = 20.0 if dataset == "hypersim" else 80.0

    precision = resolve_int8_precision(model_name, encoder, precision)
    spec = ModelSpec(
        model=model_name,
        encoder=encoder,
        input_hw=(input_size, input_size),
        precision=precision,
        metric=metric,
        dataset=dataset if metric else "",
    )
    dtype = compute_dtype(precision)
    if dtype == torch.float32 and device.type == "cuda":
        # cuDNN fp32 convolutions default to TF32 (about 3 decimal digits);
        # precision="fp32" means full fp32, process-wide from here on.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    model = DepthAnythingV2(encoder=encoder, metric=metric, max_depth=max_depth,
                            attn_impl=attn_impl, **(model_kw or {}))
    resolve_weights(model, spec.artifact_name(), checkpoint=checkpoint,
                    state_dict=params)
    # parameters are held in the compute dtype (bf16 on the default path)
    model = model.to(device=device, dtype=dtype).eval()

    def preprocess(img_u8: torch.Tensor) -> torch.Tensor:
        if resize_mode == "lower_bound":
            # aspect-preserving DPT policy (reference infer.py transform)
            return preprocess_lower_bound(img_u8, target=input_size)
        # reference square path: resize to (518, 518) + ImageNet normalize
        x = to_float_rgb(img_u8)
        x = resize(x, spec.input_hw, method="linear")
        return normalize(x, IMAGENET_MEAN, IMAGENET_STD)

    forward = depth_forward_factory(model, preprocess)
    return DepthPipeline(spec, forward, device=device, model=model,
                         viz=viz or ("metric" if metric else "relative"))


@register("depth_anything_v2", fidelity="converter-verified")
def depth_anything_v2(encoder: str = "vits", **kw) -> DepthPipeline:
    return _build_da_family("depth_anything_v2", encoder, **kw)


@register("distill_any_depth", fidelity="converter-verified")
def distill_any_depth(encoder: str = "vits", **kw) -> DepthPipeline:
    """Distilled DA-V2 (reference ``Distill_Any_Depth/``): same architecture
    and square-resize preprocessing."""
    return _build_da_family("distill_any_depth", encoder, **kw)


@register("depth_anything_ac", fidelity="converter-verified")
def depth_anything_ac(encoder: str = "vits", **kw) -> DepthPipeline:
    """DA-V2 variant robust to adverse conditions (reference
    ``Depth_Anything_AC/``); identical serving graph."""
    return _build_da_family("depth_anything_ac", encoder, **kw)


@register("dkt", fidelity="converter-verified")
def dkt(encoder: str = "vits", metric: bool = True, dataset: str = "hypersim",
        **kw) -> DepthPipeline:
    """DKT (transparent-object depth) served as the stock DA-V2 graph,
    metric hypersim by default (reference ``later/DKT/onnx_export.py``)."""
    return _build_da_family("dkt", encoder, metric=metric, dataset=dataset, **kw)


@register("bridge", fidelity="converter-verified")
def bridge(encoder: str = "vits", **kw) -> DepthPipeline:
    """BRIDGE: DA-V2-style DPT serving graph at 518^2 with the family's
    ``clamp(1e-3, 1e3)`` postprocess (reference ``later/BRIDGE/``)."""
    return _build_da_family("bridge", encoder, **kw)
