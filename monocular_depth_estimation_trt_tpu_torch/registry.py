"""Model registry: name -> pipeline factory (counterpart of the JAX package's
``registry.py``)::

    pipe = build_pipeline("depth_anything_v2", encoder="vits")
    out = pipe(image_rgb_u8)

The registry holds every name of the JAX package's: the Depth Anything
family (``depth_anything_v2``, ``distill_any_depth``, ``depth_anything_ac``,
``dkt``, ``bridge``), which shares one serving graph, ``vggt``, ``depth_pro``, the single-image
metric and point-map families ``depth_anything_v3``, ``metric3d_v2``,
``moge2`` and ``metric_anything``, the camera-aware ``unidepth_v2`` and
``unik3d``, ``sidepth``, ``geocalib`` and ``prior_depth_anything``, and the
multi-view and rope families ``streamvggt`` (with its KV-cache stream),
``stream3r``, ``litevggt``, ``map_anything``, ``align3r`` (two frames) and
``dinov3``, the video families ``video_depth_anything`` (windows of
frames, ``video_depth``) and ``flashdepth`` (a Mamba state, ``stream()``),
the optical-flow models ``raft``, ``neuflow``, ``meflow``, ``waft`` (a
frame pair, :class:`FlowPipeline`) and ``memfof`` (a triplet, with its
cached video step, ``stream()``), the point tracker ``cotracker3`` (the
upstream online API, :class:`CoTrackerPipeline`), and the SLAM recipes
``megasam``, ``vipe`` and ``wildgs_slam`` (``slam/recipes.py``).
Every factory takes ``device``;
``None`` means ``"cuda"``, and a missing card is an error, never a quiet
move to the CPU. ``precision="int8"`` serves the bf16 graph with the
family's encoder linears quantized (``ops/quant.py``, kernel K4),
calibrated at build time on ``calib_images`` or on
:func:`_calibration_images`.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from monocular_depth_estimation_trt_tpu_torch.config import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    BenchmarkConfig,
    ModelSpec,
)
from monocular_depth_estimation_trt_tpu_torch.pipelines import (
    DepthPipeline,
    FlowPipeline,
    PairPipeline,
    VGGTPipeline,
    depth_forward_factory,
    pointmap_forward_factory,
)
from monocular_depth_estimation_trt_tpu_torch.runtime.benchmark import BenchmarkReport, benchmark
from monocular_depth_estimation_trt_tpu_torch.runtime.engine import Engine
from monocular_depth_estimation_trt_tpu_torch.runtime.transfer import tree_get_chunked

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


# Families with an int8 w8a8 serving path, of those the port has registered
# (dkt and bridge reach it through _build_da_family as well).
INT8_FAMILIES = frozenset({
    "depth_anything_v2", "distill_any_depth", "depth_anything_ac", "depth_pro", "vggt",
    "depth_anything_v3", "metric3d_v2", "moge2", "metric_anything", "unidepth_v2", "unik3d",
    "streamvggt", "map_anything",
})

# Encoders for which precision="int8" builds the bf16 graph unless
# MDET_FORCE_INT8=1: on one H100, DA-V2 vits int8 at batch 1 is slower than
# vits bf16 (PERF.md, section 6, from chip_smoke.py's speed phase).
INT8_MEMORY_BOUND_ENCODERS = frozenset({"vits", "vits16", "small"})


def resolve_int8_precision(model_name: str, encoder: str, precision: str) -> str:
    """Build-time int8 routing guard: for an encoder of
    :data:`INT8_MEMORY_BOUND_ENCODERS`, ``int8`` becomes ``bf16`` with a
    warning; ``MDET_FORCE_INT8=1`` keeps int8 (to measure it, or for
    batched offline serving)."""
    from monocular_depth_estimation_trt_tpu_torch.utils.logging import log

    if precision != "int8" or encoder not in INT8_MEMORY_BOUND_ENCODERS:
        return precision
    if os.environ.get("MDET_FORCE_INT8", "") == "1":
        log(f"{model_name} {encoder}: int8 on a small encoder is slower than bf16 at batch 1 "
            "on the H100 (PERF.md); forced by MDET_FORCE_INT8=1", tag="WARN")
        return precision
    log(f"{model_name} {encoder}: auto-routing int8 -> bf16: int8 on a small encoder is "
        "slower than bf16 at batch 1 on the H100 (PERF.md). Set MDET_FORCE_INT8=1 to "
        "override.", tag="WARN")
    return "bf16"


def _full_fp32(dtype: torch.dtype, device: torch.device) -> None:
    """cuDNN fp32 convolutions default to TF32 (about 3 decimal digits);
    precision="fp32" means full fp32, process-wide from here on."""
    if dtype == torch.float32 and device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


# ---------------------------------------------------------------------------
# int8 serving: calibration images, weights and the quantized layers
# ---------------------------------------------------------------------------

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read_rgb(path: str) -> Optional[np.ndarray]:
    """An image file as uint8 RGB (``utils/imageio.py``: cv2 as in the JAX
    package, else its own codecs); None when it is missing or unreadable,
    or (with a warning) when no codec here reads it."""
    from monocular_depth_estimation_trt_tpu_torch.utils.imageio import (
        CodecUnavailable,
        read_image,
    )
    from monocular_depth_estimation_trt_tpu_torch.utils.logging import log

    if not os.path.exists(path):
        return None
    try:
        return read_image(path)
    except CodecUnavailable as e:
        log(f"int8 calibration skips {path}: {e}", tag="WARN")
    except (OSError, ValueError):  # an unreadable file
        pass
    return None


def _calibration_images(input_hw, n_synthetic: int = 2):
    """Images for int8 activation-scale calibration: the repository's example
    photo where it can be decoded, padded with deterministic synthetic
    textures (so that a bare checkout still calibrates; a deployment should
    calibrate on its own images through ``calib_images=[...]``). The JAX
    package's set: the same seed, sizes and count rule.

    ``input_hw``: (H, W) target resolution, or one int for a square."""
    from monocular_depth_estimation_trt_tpu_torch.utils.imageio import resize

    if isinstance(input_hw, int):
        input_hw = (input_hw, input_hw)
    h, w = input_hw
    imgs = []
    photo = _read_rgb(os.path.join(_REPO_ROOT, "data", "example.jpg"))
    if photo is not None:
        imgs.append(resize(photo, (h, w)))
    rng = np.random.default_rng(0)
    for _ in range(max(n_synthetic - len(imgs), 1)):
        base = rng.integers(0, 255, (h // 7, w // 7, 3), dtype=np.uint8)
        imgs.append(resize(base, (h, w)))
    return imgs


def _int8_bundle(model: torch.nn.Module, masters, make_sample: Callable, *,
                 calib_images: Optional[Sequence[np.ndarray]], input_size) -> None:
    """Calibrate ``model`` (cast, on its device) on ``calib_images`` or the
    default set, each through ``make_sample`` (uint8 (H, W, 3) on the device
    -> the model's input), and swap in the quantized layers built from
    ``masters`` (path -> full-precision weight and bias)."""
    from monocular_depth_estimation_trt_tpu_torch.ops.quant import quantize_model_bundle

    device = next(model.parameters()).device

    def samples():
        images = calib_images if calib_images is not None else _calibration_images(input_size)
        for img in images:
            yield make_sample(torch.from_numpy(np.ascontiguousarray(img)).to(device))

    quantize_model_bundle(model, masters, samples())


INT8_BUNDLE_SUFFIX = "_int8bundle_v2"  # the JAX package's name (SmoothQuant scheme v2)


def int8_bundle_path(spec: ModelSpec) -> str:
    """Where the int8 serving bundle of ``spec`` is cached: beside the
    weights, under the bf16 artifact's name (JAX ``registry.py:156-234``)."""
    from monocular_depth_estimation_trt_tpu_torch.config import cache_dir

    name = spec.with_(precision="bf16").artifact_name() + INT8_BUNDLE_SUFFIX
    return os.path.join(cache_dir(), "params", name + ".pt")


def _int8_bundle_key(model: torch.nn.Module, checkpoint: Optional[str], name: str,
                     dtype: torch.dtype) -> Dict[str, Any]:
    """What a cached bundle must have been made from: the checkpoint file,
    else the params cache file of ``name`` (path, size, modification time),
    else the seeded random weights; the model's layout (every key, shape
    and type before the cast) and the compute type."""
    import hashlib

    from monocular_depth_estimation_trt_tpu_torch.weights.store import (
        params_path,
        resolve_checkpoint,
    )

    def file_source(kind, path):
        path = os.path.realpath(path)
        return {kind: path, "size": os.path.getsize(path),
                "mtime_ns": os.stat(path).st_mtime_ns}

    if checkpoint:
        source = file_source("checkpoint", resolve_checkpoint(checkpoint))
    elif os.path.exists(params_path(name)):
        source = file_source("params_cache", params_path(name))
    else:
        source = {"random_seed": 0}
    layout = hashlib.sha256(repr([(k, tuple(v.shape), str(v.dtype))
                                  for k, v in model.state_dict().items()]).encode())
    return {"source": source, "layout": layout.hexdigest(), "dtype": str(dtype)}


def _load_int8_bundle(model: torch.nn.Module, path: str, key: Dict[str, Any], device,
                      dtype) -> Optional[torch.nn.Module]:
    """``model`` (built, weights not yet written) as the cached bundle at
    ``path`` holds it: the quantized layers installed, every tensor loaded.
    None when there is no bundle or it was made from other weights."""
    from monocular_depth_estimation_trt_tpu_torch.ops.quant import install_q8
    from monocular_depth_estimation_trt_tpu_torch.utils.logging import log

    if not os.path.exists(path):
        return None
    try:
        bundle = torch.load(path, map_location="cpu", weights_only=True)
    except (OSError, RuntimeError) as e:
        log(f"int8 bundle {path} unreadable ({e!r}); calibrating", tag="WARN")
        return None
    if bundle.get("key") != key:
        return None
    model = model.to(device=device, dtype=dtype).eval()
    placeholders = {}
    for path_ in model.int8_targets():
        lin = model.get_submodule(path_)
        n, k = lin.weight.shape
        placeholders[path_] = {
            "weight_q": torch.empty((n, k), dtype=torch.int8), "qmul": torch.empty(k),
            "out_scale": torch.empty(n), "bias": None if lin.bias is None else torch.empty(n)}
    install_q8(model, placeholders)
    model.load_state_dict(bundle["state_dict"], strict=True)
    log(f"int8: loaded cached serving bundle ({os.path.basename(path)})")
    return model


def _save_int8_bundle(model: torch.nn.Module, path: str, key: Dict[str, Any]) -> None:
    """The calibrated int8 model's whole state (the quantized layers and
    every other tensor, in the compute type), written to ``path``."""
    from monocular_depth_estimation_trt_tpu_torch.utils.logging import log

    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"key": key, "state_dict": {k: v.detach().cpu()
                                           for k, v in model.state_dict().items()}}, tmp)
    os.replace(tmp, path)
    log(f"int8: cached the serving bundle -> {path}")


def _new_model(make: Callable[[], torch.nn.Module]) -> torch.nn.Module:
    """``make()`` on the meta device, given uninitialized CPU storage: every
    parameter is written after, by a strict load or by ``init_random_``
    (which writes each one: ``tests/test_torch_weights.py``), so the default
    init of up to 1.2 B parameters is not computed to be thrown away."""
    with torch.device("meta"):
        model = make()
    return model.to_empty(device="cpu")


def _params_for(model: torch.nn.Module, spec: ModelSpec, *, params, checkpoint, device,
                dtype, make_sample: Callable, input_size, calib_images=None,
                allowed_unconsumed: Optional[str] = None) -> torch.nn.Module:
    """Fill ``model``'s weights (``params``, else ``checkpoint``, else random
    weights where allowed; int8 reads the bf16 artifact's weights, as in the
    JAX package), cast it to ``device`` and ``dtype``, and for
    ``spec.precision == "int8"`` calibrate it and swap its
    ``int8_targets()`` for ``QuantLinear`` layers quantized from the
    full-precision weights."""
    from monocular_depth_estimation_trt_tpu_torch.ops.quant import full_precision
    from monocular_depth_estimation_trt_tpu_torch.weights.store import resolve_weights

    quant = spec.precision == "int8"
    name = spec.with_(precision="bf16").artifact_name() if quant else spec.artifact_name()
    # the int8 bundle is cached only for weights that a later build finds
    # again (a checkpoint file, the params cache, or the seeded random
    # weights) calibrated on
    # the default images: an int8 cold start that finds it never calibrates
    cacheable = (quant and params is None and calib_images is None
                 and torch.device(device).type in ("cuda", "cpu"))
    if cacheable:
        from monocular_depth_estimation_trt_tpu_torch.weights.store import (
            params_path,
            random_weights_allowed,
        )

        cacheable = (bool(checkpoint) or os.path.exists(params_path(name))
                     or random_weights_allowed())
    if cacheable:
        key, bundle = _int8_bundle_key(model, checkpoint, name, dtype), int8_bundle_path(spec)
        loaded = _load_int8_bundle(model, bundle, key, device, dtype)
        if loaded is not None:
            return loaded
    resolve_weights(model, name, checkpoint=checkpoint, state_dict=params,
                    allowed_unconsumed=allowed_unconsumed)
    masters = full_precision(model, model.int8_targets()) if quant else None
    model = model.to(device=device, dtype=dtype).eval()
    if quant:
        _int8_bundle(model, masters, make_sample, calib_images=calib_images,
                     input_size=input_size)
        if cacheable:
            _save_int8_bundle(model, bundle, key)
    return model


def _plain_dtype(precision: str, device: torch.device) -> torch.dtype:
    """The compute type of a family without an int8 path (int8 raises, as in
    the JAX package)."""
    from monocular_depth_estimation_trt_tpu_torch.config import compute_dtype

    dtype = compute_dtype(precision)
    _full_fp32(dtype, device)
    return dtype


def _dtype_for(precision: str, device: torch.device) -> torch.dtype:
    """The compute type: int8 serves a bf16 graph."""
    return _plain_dtype("bf16" if precision == "int8" else precision, device)


def _imagenet_square(input_hw):
    """uint8 (..., H, W, 3) -> linear resize to ``input_hw`` + ImageNet
    normalize (the square path of the DA family, DA3 and the MoGe pair)."""
    from monocular_depth_estimation_trt_tpu_torch.ops.preprocess import normalize, to_float_rgb
    from monocular_depth_estimation_trt_tpu_torch.ops.resize import resize

    def preprocess(img_u8: torch.Tensor) -> torch.Tensor:
        return normalize(resize(to_float_rgb(img_u8), tuple(input_hw), method="linear"),
                         IMAGENET_MEAN, IMAGENET_STD)

    return preprocess


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
    calib_images: Optional[Sequence[np.ndarray]] = None,  # uint8 (H, W, 3), for int8 scales
) -> DepthPipeline:
    """``params``: an upstream-named state dict (e.g. from
    ``weights.from_jax.state_dict_from_jax``); ``model_kw``: overrides of
    the encoder presets passed to ``DepthAnythingV2`` (``vit_config``,
    ``head_features``, ``head_out_channels``, ``out_indices``)."""
    from monocular_depth_estimation_trt_tpu_torch.models.depth_anything_v2 import (
        DepthAnythingV2,
    )
    from monocular_depth_estimation_trt_tpu_torch.ops.preprocess import preprocess_lower_bound

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
    # int8 = w8a8 encoder serving: the bf16 graph, with the encoder's linear
    # layers quantized (ops/quant.py, kernel K4)
    dtype = _dtype_for(precision, device)
    square = _imagenet_square(spec.input_hw)

    def preprocess(img_u8: torch.Tensor) -> torch.Tensor:
        if resize_mode == "lower_bound":
            # aspect-preserving DPT policy (reference infer.py transform)
            return preprocess_lower_bound(img_u8, target=input_size)
        # reference square path: resize to (518, 518) + ImageNet normalize
        return square(img_u8)

    model = _new_model(lambda: DepthAnythingV2(encoder=encoder, metric=metric,
                                               max_depth=max_depth, attn_impl=attn_impl,
                                               **(model_kw or {})))
    # parameters are held in the compute dtype (bf16 on the default path)
    model = _params_for(model, spec, params=params, checkpoint=checkpoint, device=device,
                        dtype=dtype, make_sample=lambda img: preprocess(img[None]),
                        input_size=input_size, calib_images=calib_images)

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


# ---------------------------------------------------------------------------
# Multi-view geometry transformers (reference VGGT/)
# ---------------------------------------------------------------------------


def _square_crop(out_hw, input_size: int):
    """(rows, columns) of a frame of size ``out_hw`` in its pad-square view
    resized to ``input_size``, with the JAX pipelines' rounding."""
    h0, w0 = out_hw
    side = max(h0, w0)
    top = int(round((side - h0) / 2 / side * input_size))
    left = int(round((side - w0) / 2 / side * input_size))
    hh = max(int(round(h0 / side * input_size)), 1)
    ww = max(int(round(w0 / side * input_size)), 1)
    return slice(top, top + hh), slice(left, left + ww)


def _crop_to_frame(out_hw, input_size: int):
    """fn(square map (B, S, side, side[, C])) -> the frame's rows and columns
    of its pad-square view (``_square_crop``), view 0."""
    rows, cols = _square_crop(out_hw, input_size)
    return lambda a: a[:, 0, rows, cols]


def _build_vggt(
    model_name: str,
    *,
    input_size: int = 518,
    precision: str = "bf16",
    attn_impl: str = "auto",
    params: Optional[Mapping[str, torch.Tensor]] = None,
    vggt_cfg: Any = None,
    with_camera: bool = True,
    checkpoint: Optional[str] = None,
    device=None,
    calib_images: Optional[Sequence[np.ndarray]] = None,
    allowed_unconsumed: Optional[str] = None,
    pipeline_cls: type = VGGTPipeline,
) -> VGGTPipeline:
    """``params``: an upstream-named state dict (e.g. from
    ``weights.from_jax.vggt_from_jax``); ``vggt_cfg``: a ``VGGTConfig``
    override (tests); ``allowed_unconsumed``: a regex of checkpoint keys that
    the model does not hold and the load may drop (LiteVGGT's token-merge
    extras); any other extra key raises."""
    from monocular_depth_estimation_trt_tpu_torch.models.vggt import VGGT, VGGTConfig
    from monocular_depth_estimation_trt_tpu_torch.ops.camera import (
        extrinsics_from_quat_trans,
        fov_to_focal,
    )
    from monocular_depth_estimation_trt_tpu_torch.ops.postprocess import upsample_depth
    from monocular_depth_estimation_trt_tpu_torch.ops.preprocess import preprocess_pad_square

    device = resolve_device(device)
    cfg = vggt_cfg or VGGTConfig()
    spec = ModelSpec(
        model=model_name, input_hw=(input_size, input_size), precision=precision,
        metric=True,
        # vggt's depth-only and with-camera variants have different weights;
        # streamvggt is always depth-only and keeps the plain name
        variant="depth" if (model_name == "vggt" and not with_camera) else "",
    )
    # int8 = w8a8 aggregator serving; calibrated on S=1 views (the scales
    # are per layer, so S > 1 serving reuses them)
    dtype = _dtype_for(precision, device)
    model = _params_for(
        _new_model(lambda: VGGT(cfg, attn_impl, with_camera)), spec,
        params=params, checkpoint=checkpoint,
        device=device, dtype=dtype,
        make_sample=lambda img: preprocess_pad_square(img[None], input_size)[:, None],
        input_size=input_size, calib_images=calib_images,
        allowed_unconsumed=allowed_unconsumed)

    def forward(img_u8: torch.Tensor, out_hw):
        """Pad to square, S=1 through the model, crop the padding, resample
        to the frame (reference ``VGGT/onnx2trt.py:80-110, 184-189``)."""
        single = img_u8.dim() == 3
        x = preprocess_pad_square(img_u8[None] if single else img_u8, input_size)
        out = model(x[:, None])
        crop = _crop_to_frame(out_hw, input_size)
        result = {
            "depth": upsample_depth(crop(out["depth"]), out_hw, clamp=(1e-3, 1e3)),
            "depth_conf": upsample_depth(crop(out["depth_conf"]), out_hw, clamp=None),
        }
        if with_camera:
            pose = out["pose_enc"][:, 0]  # (B, 9)
            result["pose_enc"] = pose
            result["extrinsic"] = extrinsics_from_quat_trans(pose[..., 3:7], pose[..., :3])
            result["focal_px"] = fov_to_focal(torch.rad2deg(pose[..., 7]), input_size)
        return {k: v[0] for k, v in result.items()} if single else result

    def views_forward(views_u8: torch.Tensor):
        out = model(preprocess_pad_square(views_u8, input_size)[None])
        return {k: v[0] for k, v in out.items()}

    return pipeline_cls(spec, forward, views_forward, device=device, model=model,
                        viz="metric")


@register("vggt", fidelity="converter-verified")
def vggt(input_size: int = 518, precision: str = "bf16", attn_impl: str = "auto",
         params: Optional[Mapping[str, torch.Tensor]] = None, depth_only: bool = False,
         checkpoint: Optional[str] = None, device=None,
         vggt_cfg: Any = None,
         calib_images: Optional[Sequence[np.ndarray]] = None) -> VGGTPipeline:
    """VGGT-1B multi-view geometry transformer (reference ``VGGT/``):
    aggregator + one 2-channel DPT depth head + iterative adaLN camera head,
    single-image (``__call__``) or multi-view (``multi_view``)."""
    return _build_vggt("vggt", input_size=input_size, precision=precision,
                       attn_impl=attn_impl, params=params, vggt_cfg=vggt_cfg,
                       with_camera=not depth_only, checkpoint=checkpoint, device=device,
                       calib_images=calib_images)


def _stream_session(pipe: DepthPipeline, window: int, epilogue=None):
    from monocular_depth_estimation_trt_tpu_torch.apps.streaming import VGGTStreamingSession

    return VGGTStreamingSession(pipe.model, window=window, input_size=pipe.spec.input_hw[0],
                                epilogue=epilogue, name=pipe.spec.artifact_name() + "_stream")


class StreamVGGTPipeline(VGGTPipeline):
    """The VGGT pipeline plus ``stream(window)``: a causal KV-cache session
    per video (``apps/streaming.py``), each step one captured graph that
    also crops, resamples and colormaps."""

    def _stream_session(self, window: int, epilogue=None):
        return _stream_session(self, window, epilogue)

    def _stream_viz(self, out: Dict[str, torch.Tensor], out_hw) -> Dict[str, torch.Tensor]:
        """One step's depth cropped out of its pad-square view, resampled to
        the frame and colormapped (the JAX ``_stream_viz``)."""
        from monocular_depth_estimation_trt_tpu_torch.ops.postprocess import upsample_depth

        rows, cols = _square_crop(out_hw, self.spec.input_hw[0])
        depth = upsample_depth(out["depth"][None, rows, cols], out_hw, clamp=(1e-3, 1e3))[0]
        return self._with_viz_epilogue({"depth": depth}, True)

    def stream(self, window: int = 4):
        """fn(frame (H, W, 3) uint8, viz=...) -> host {"depth", "viz"} of that
        frame after the frames before it in this stream."""
        sess = self._stream_session(window, self._stream_viz)

        def runner(rgb, viz: bool = False):
            return tree_get_chunked(sess.step(rgb))

        runner.session = sess
        return runner

    def stream_export_bundle(self, window: int = 4, in_hw=None):
        """(step, state, modules) for the stream module of
        ``runtime/export.py`` (the JAX ``stream_export_bundle``):
        ``step(frame_u8 (H, W, 3), state) -> ({"depth", "viz"}, state')``,
        one causal step as a function of its inputs (the cache left as it
        was, ``state'`` new tensors), through a ``StreamingVGGT`` on this
        pipeline's tensors, with the depth cropped, resampled and
        colormapped as :meth:`stream` does; ``state``: the zero cache as a
        list (each global layer's K and V rings, the camera ring, the step
        count); ``modules``: the streaming model."""
        from monocular_depth_estimation_trt_tpu_torch.models.streamvggt import StreamingVGGT
        from monocular_depth_estimation_trt_tpu_torch.ops.preprocess import (
            preprocess_pad_square,
        )

        size = self.spec.input_hw[0]
        in_hw = tuple(in_hw or self.spec.input_hw)
        model = StreamingVGGT.sharing(self.model, window)
        param = next(self.model.parameters())
        cache = model.init_cache(1, (size // model.cfg.patch_size,) * 2, param.dtype,
                                 param.device)
        depth = model.cfg.depth

        def pack(c):
            return [t for kv in c["kv"] for t in kv] + [c["cam"], c["t"]]

        def step(frame_u8: torch.Tensor, state):
            cache_in = {"kv": [(state[2 * i], state[2 * i + 1]) for i in range(depth)],
                        "cam": state[-2], "t": state[-1]}
            out, cache_out = model.advance(preprocess_pad_square(frame_u8[None], size), cache_in)
            return self._stream_viz({k: v[0] for k, v in out.items()}, in_hw), pack(cache_out)

        return step, pack(cache), {"stream": model}


@register("streamvggt", fidelity="converter-verified")
def streamvggt(input_size: int = 518, precision: str = "bf16", attn_impl: str = "auto",
               params: Optional[Mapping[str, torch.Tensor]] = None,
               checkpoint: Optional[str] = None, device=None, vggt_cfg: Any = None,
               calib_images: Optional[Sequence[np.ndarray]] = None) -> StreamVGGTPipeline:
    """StreamVGGT (reference ``StreamVGGT/``): the single-frame depth
    wrapper that the reference exports (``onnx_export.py:25-55``), served as
    depth-only VGGT, plus the causal KV-cache stream that it could not
    export: ``pipe.stream(window)`` over the same weights."""
    return _build_vggt("streamvggt", input_size=input_size, precision=precision,
                       attn_impl=attn_impl, params=params, vggt_cfg=vggt_cfg,
                       with_camera=False, checkpoint=checkpoint, device=device,
                       calib_images=calib_images, pipeline_cls=StreamVGGTPipeline)


# LiteVGGT checkpoints carry the token-merge extras of its speed-up, which the
# stock VGGT graph does not use (reference later/LiteVGGT/infer.py loads them
# with strict=False)
LITEVGGT_UNCONSUMED = r"(^|\.)(te|te_dict|token_merge|merge)[._]"


@register("litevggt", fidelity="converter-verified")
def litevggt(input_size: int = 518, precision: str = "bf16", attn_impl: str = "auto",
             params: Optional[Mapping[str, torch.Tensor]] = None,
             checkpoint: Optional[str] = None, device=None, vggt_cfg: Any = None,
             calib_images: Optional[Sequence[np.ndarray]] = None) -> VGGTPipeline:
    """LiteVGGT (reference ``later/LiteVGGT/infer.py:26-31``): distilled VGGT
    weights through the stock VGGT graph, camera and depth. Its checkpoint's
    token-merge keys (:data:`LITEVGGT_UNCONSUMED`) are dropped on load; any
    other key the model does not hold raises."""
    return _build_vggt("litevggt", input_size=input_size, precision=precision,
                       attn_impl=attn_impl, params=params, vggt_cfg=vggt_cfg,
                       with_camera=True, checkpoint=checkpoint, device=device,
                       calib_images=calib_images, allowed_unconsumed=LITEVGGT_UNCONSUMED)


class Stream3RPipeline(DepthPipeline):
    """Single frames through the causal model (S = 1), and
    ``stream_session(window)``: the KV-cache session with the camera and the
    point head (``apps/streaming.py``)."""

    def stream_session(self, window: int = 4):
        return _stream_session(self, window)


@register("stream3r", fidelity="converter-verified")
def stream3r(input_size: int = 518, precision: str = "bf16", attn_impl: str = "auto",
             params: Optional[Mapping[str, torch.Tensor]] = None,
             checkpoint: Optional[str] = None, device=None,
             vggt_cfg: Any = None) -> Stream3RPipeline:
    """STream3R (reference ``later/STream3R/``): a causal VGGT-family
    transformer streaming images into per-frame point maps: depth, world
    points (``inv_log``) and their confidence, and the camera, each cropped
    out of the pad-square view and resampled to the frame (points
    half-pixel linear, as the JAX package)."""
    from monocular_depth_estimation_trt_tpu_torch.models.vggt import VGGT, VGGTConfig
    from monocular_depth_estimation_trt_tpu_torch.ops.postprocess import upsample_depth
    from monocular_depth_estimation_trt_tpu_torch.ops.preprocess import preprocess_pad_square
    from monocular_depth_estimation_trt_tpu_torch.ops.resize import resize

    device = resolve_device(device)
    cfg = vggt_cfg or VGGTConfig(causal=True)
    spec = ModelSpec(model="stream3r", input_hw=(input_size, input_size), precision=precision,
                     metric=True)
    dtype = _plain_dtype(precision, device)
    model = _params_for(
        _new_model(lambda: VGGT(cfg, attn_impl, with_camera=True, with_point_head=True)),
        spec, params=params, checkpoint=checkpoint, device=device, dtype=dtype,
        make_sample=None, input_size=input_size)

    def forward(img_u8: torch.Tensor, out_hw):
        single = img_u8.dim() == 3
        out = model(preprocess_pad_square(img_u8[None] if single else img_u8,
                                          input_size)[:, None])  # S=1
        crop = _crop_to_frame(out_hw, input_size)
        result = {"depth": upsample_depth(crop(out["depth"]), out_hw, clamp=(1e-3, 1e3)),
                  "world_points": resize(crop(out["world_points"]), out_hw, method="linear"),
                  "world_points_conf": upsample_depth(crop(out["world_points_conf"]), out_hw,
                                                      clamp=None),
                  "pose_enc": out["pose_enc"][:, 0]}
        return {k: v[0] for k, v in result.items()} if single else result

    return Stream3RPipeline(spec, forward, device=device, model=model, viz="metric")


# ---------------------------------------------------------------------------
# Apple Depth Pro (reference Depth_Pro/)
# ---------------------------------------------------------------------------


@register("depth_pro", fidelity="converter-verified")
def depth_pro(precision: str = "bf16", attn_impl: str = "auto",
              params: Optional[Mapping[str, torch.Tensor]] = None,
              f_px: Optional[float] = None, checkpoint: Optional[str] = None, device=None,
              model_kw: Optional[Dict[str, Any]] = None,
              calib_images: Optional[Sequence[np.ndarray]] = None) -> DepthPipeline:
    """Apple Depth Pro serving contract (reference ``Depth_Pro/onnx2trt.py``):
    a 1536^2 input; canonical inverse depth and the predicted FoV -> metric
    depth at the frame's own size, plus the focal estimate ``f_px`` (or the
    caller's ``f_px``). One frame per call.

    ``params``: an upstream-named state dict (e.g. from
    ``weights.from_jax.depth_pro_from_jax``); ``model_kw``: overrides passed
    to ``DepthPro`` (``cfg``, ``decoder_features``, ``dims_encoder``)."""
    from monocular_depth_estimation_trt_tpu_torch.config import HALF_MEAN, HALF_STD
    from monocular_depth_estimation_trt_tpu_torch.models.depth_pro import DepthPro
    from monocular_depth_estimation_trt_tpu_torch.ops.camera import fov_to_focal
    from monocular_depth_estimation_trt_tpu_torch.ops.constants import device_constant
    from monocular_depth_estimation_trt_tpu_torch.ops.preprocess import normalize, to_float_rgb
    from monocular_depth_estimation_trt_tpu_torch.ops.resize import resize, resize_hw

    device = resolve_device(device)
    model = _new_model(lambda: DepthPro(attn_impl=attn_impl, **(model_kw or {})))
    size = model.cfg.img_size
    spec = ModelSpec(model="depth_pro", input_hw=(size, size), precision=precision)
    # int8 = w8a8 serving of both ViT encoders
    dtype = _dtype_for(precision, device)

    def preprocess(img_u8: torch.Tensor) -> torch.Tensor:
        # reference: ToTensor + Normalize(0.5) + bilinear resize to 1536
        x = normalize(to_float_rgb(img_u8), HALF_MEAN, HALF_STD)
        return resize(x[None], (size, size), method="linear")

    model = _params_for(model, spec, params=params, checkpoint=checkpoint, device=device,
                        dtype=dtype, make_sample=preprocess, input_size=size,
                        calib_images=calib_images)

    def forward(img_u8: torch.Tensor, out_hw):
        if img_u8.dim() != 3:
            raise ValueError(f"depth_pro takes one (H, W, 3) frame, got {tuple(img_u8.shape)}")
        cid, fov_deg = model(preprocess(img_u8))
        # postprocess (reference :152-165): W is the frame's own width
        width = out_hw[1]
        if f_px is None:
            focal = fov_to_focal(fov_deg[0], width)
        else:
            focal = device_constant(f_px, torch.float32, cid.device)
        inverse_depth = resize_hw(cid[0] * (width / focal), out_hw, "linear",
                                  align_corners=False)
        return {"depth": 1.0 / torch.clamp(inverse_depth, 1e-4, 1e4), "f_px": focal}

    return DepthPipeline(spec, forward, device=device, model=model, viz="metric")


# ---------------------------------------------------------------------------
# Single-image metric and point-map families (reference Depth_Anything_V3/,
# Metric3D_V2/, MoGe_2/, Metric_Anything/)
# ---------------------------------------------------------------------------


@register("depth_anything_v3", fidelity="converter-verified")
def depth_anything_v3(encoder: str = "vitl", input_size: int = 518, precision: str = "bf16",
                      attn_impl: str = "auto",
                      params: Optional[Mapping[str, torch.Tensor]] = None,
                      checkpoint: Optional[str] = None, device=None,
                      model_kw: Optional[Dict[str, Any]] = None,
                      calib_images: Optional[Sequence[np.ndarray]] = None) -> DepthPipeline:
    """DA3METRIC-LARGE contract (reference ``Depth_Anything_V3/``): metric
    depth (``exp``) and a sky map (``sigmoid``) at the frame's size, the
    depth resized align-corners and clamped as the DA-V2 template, the sky
    resized align-corners.

    ``params``: an upstream-named state dict (e.g. from
    ``weights.from_jax.da3_from_jax``); ``model_kw``: overrides passed to
    ``DepthAnythingV3`` (``vit_config``, ``head_features``,
    ``head_out_channels``, ``out_indices``)."""
    from monocular_depth_estimation_trt_tpu_torch.models.depth_anything_v3 import (
        DepthAnythingV3,
    )
    from monocular_depth_estimation_trt_tpu_torch.ops.postprocess import upsample_depth
    from monocular_depth_estimation_trt_tpu_torch.ops.resize import resize_hw

    device = resolve_device(device)
    precision = resolve_int8_precision("depth_anything_v3", encoder, precision)
    spec = ModelSpec(model="da3metric", encoder=encoder, input_hw=(input_size, input_size),
                     precision=precision, metric=True)
    dtype = _dtype_for(precision, device)
    preprocess = _imagenet_square(spec.input_hw)
    model = _params_for(_new_model(lambda: DepthAnythingV3(encoder=encoder, attn_impl=attn_impl,
                                                           **(model_kw or {}))),
                        spec, params=params, checkpoint=checkpoint, device=device, dtype=dtype,
                        make_sample=lambda img: preprocess(img[None]), input_size=input_size,
                        calib_images=calib_images)

    def forward(img_u8: torch.Tensor, out_hw):
        single = img_u8.dim() == 3
        depth, sky = model(preprocess(img_u8[None] if single else img_u8))
        result = {"depth": upsample_depth(depth, out_hw),
                  "sky": resize_hw(sky, out_hw, "linear", align_corners=True)}
        return {k: v[0] for k, v in result.items()} if single else result

    return DepthPipeline(spec, forward, device=device, model=model, viz="metric")


METRIC3D_CANVAS = (616, 1064)


@register("metric3d_v2", fidelity="converter-verified")
def metric3d_v2(encoder: str = "vitl", precision: str = "bf16", attn_impl: str = "auto",
                params: Optional[Mapping[str, torch.Tensor]] = None,
                focal: Optional[float] = None, iters: int = 4,
                checkpoint: Optional[str] = None, device=None,
                model_kw: Optional[Dict[str, Any]] = None,
                calib_images: Optional[Sequence[np.ndarray]] = None) -> DepthPipeline:
    """Metric3D V2 (reference ``Metric3D_V2/infer.py:73-125``,
    ``onnx2trt.py:176-190``): canonical-camera metric depth and its
    confidence on a 616x1064 keep-ratio mean-padded canvas; the pad cropped,
    both maps resized (half-pixel) to the frame, the depth scaled by
    ``focal * scale / 1000`` when the caller gives its ``focal`` (the
    de-canonical transform) and clipped to [0, 300].

    ``params``: an upstream-named state dict (e.g. from
    ``weights.from_jax.metric3d_v2_from_jax``); ``model_kw``: overrides
    passed to ``Metric3DV2`` (``cfg``)."""
    from monocular_depth_estimation_trt_tpu_torch.models.metric3d_v2 import Metric3DV2
    from monocular_depth_estimation_trt_tpu_torch.ops.postprocess import crop_pad
    from monocular_depth_estimation_trt_tpu_torch.ops.preprocess import (
        preprocess_keep_ratio_pad,
    )
    from monocular_depth_estimation_trt_tpu_torch.ops.resize import resize_hw

    device = resolve_device(device)
    canvas = METRIC3D_CANVAS
    precision = resolve_int8_precision("metric3d_v2", encoder, precision)
    spec = ModelSpec(model="metric3d_v2", encoder=encoder, input_hw=canvas, precision=precision,
                     metric=True)
    dtype = _dtype_for(precision, device)
    model = _params_for(_new_model(lambda: Metric3DV2(encoder=encoder, iters=iters,
                                                      attn_impl=attn_impl, **(model_kw or {}))),
                        spec, params=params, checkpoint=checkpoint, device=device, dtype=dtype,
                        make_sample=lambda img: preprocess_keep_ratio_pad(img, canvas)[0],
                        input_size=canvas, calib_images=calib_images)

    def forward(img_u8: torch.Tensor, out_hw):
        single = img_u8.dim() == 3
        x, pad, scale = preprocess_keep_ratio_pad(img_u8, canvas)
        out = model(x)
        depth = resize_hw(crop_pad(out["depth"], pad), out_hw, "linear", align_corners=False)
        if focal is not None:
            # de-canonical transform (reference Metric3D_V2/infer.py:107-125)
            depth = depth * (focal * scale / 1000.0)
        depth = torch.clamp(depth, 0.0, 300.0)
        conf = resize_hw(crop_pad(out["confidence"], pad), out_hw, "linear",
                         align_corners=False)
        result = {"depth": depth, "confidence": conf}
        return {k: v[0] for k, v in result.items()} if single else result

    return DepthPipeline(spec, forward, device=device, model=model, viz="metric")


def _build_moge(model_name: str, encoder: str, input_hw, num_tokens: int, precision: str,
                attn_impl: str, params, *, predict_normal: bool, checkpoint: Optional[str],
                device, model_kw: Optional[Dict[str, Any]],
                calib_images: Optional[Sequence[np.ndarray]]) -> DepthPipeline:
    """The MoGe-2 architecture's pipeline: the frame resized to ``input_hw``,
    the model, then the focal/shift postprocess (reference
    ``MoGe_2/onnx2trt.py:169-206``) in the same forward, so that one captured
    graph per (H, W) and batch bucket holds both (``pipelines.py``). The
    outputs are at ``input_hw``, as in the JAX package."""
    from monocular_depth_estimation_trt_tpu_torch.models.moge2 import MoGe2

    device = resolve_device(device)
    precision = resolve_int8_precision(model_name, encoder, precision)
    spec = ModelSpec(model=model_name, encoder=encoder, input_hw=tuple(input_hw),
                     precision=precision, variant="normal" if predict_normal else "",
                     metric=True)
    dtype = _dtype_for(precision, device)
    preprocess = _imagenet_square(spec.input_hw)
    model = _params_for(_new_model(lambda: MoGe2(encoder=encoder, num_tokens=num_tokens,
                                                 predict_normal=predict_normal,
                                                 attn_impl=attn_impl, **(model_kw or {}))),
                        spec, params=params, checkpoint=checkpoint, device=device, dtype=dtype,
                        make_sample=lambda img: preprocess(img[None]),
                        input_size=tuple(input_hw), calib_images=calib_images)
    return DepthPipeline(spec, pointmap_forward_factory(model, preprocess), device=device,
                         model=model, viz="none")


@register("moge2", fidelity="converter-verified")
def moge2(encoder: str = "vits", input_hw: tuple = (291, 518), num_tokens: int = 1800,
          precision: str = "bf16", attn_impl: str = "auto",
          params: Optional[Mapping[str, torch.Tensor]] = None,
          checkpoint: Optional[str] = None, device=None,
          model_kw: Optional[Dict[str, Any]] = None,
          calib_images: Optional[Sequence[np.ndarray]] = None) -> DepthPipeline:
    """MoGe-2 (reference ``MoGe_2/``): affine-invariant point map, normal,
    mask and metric scale -> metric depth, points, mask, normal,
    metric_scale and the normalized focal. ``params``: e.g. from
    ``weights.from_jax.moge2_from_jax``; ``model_kw``: ``cfg`` for
    ``MoGe2``."""
    return _build_moge("moge2", encoder, input_hw, num_tokens, precision, attn_impl, params,
                       predict_normal=True, checkpoint=checkpoint, device=device,
                       model_kw=model_kw, calib_images=calib_images)


@register("metric_anything", fidelity="converter-verified")
def metric_anything(encoder: str = "vitl", input_hw: tuple = (518, 518),
                    num_tokens: int = 3600, precision: str = "bf16", attn_impl: str = "auto",
                    params: Optional[Mapping[str, torch.Tensor]] = None,
                    checkpoint: Optional[str] = None, device=None,
                    model_kw: Optional[Dict[str, Any]] = None,
                    calib_images: Optional[Sequence[np.ndarray]] = None) -> DepthPipeline:
    """Metric Anything's student_pointmap (reference
    ``Metric_Anything/infer.py:12-14``): the MoGe-2 architecture at 3600
    tokens without the normal branch."""
    return _build_moge("metric_anything", encoder, input_hw, num_tokens, precision, attn_impl,
                       params, predict_normal=False, checkpoint=checkpoint, device=device,
                       model_kw=model_kw, calib_images=calib_images)


# ---------------------------------------------------------------------------
# Camera-aware 3D, scale-invariant depth, calibration and prior-conditioned
# refinement (reference Uni_Depth_V2/, UniK3D/, later/SIDepth/,
# later/GeoCalib/, later/Prior_Depth_Anything/)
# ---------------------------------------------------------------------------


def _build_geometric(model_name: str, mode: str, encoder: str, input_size: int, precision: str,
                     attn_impl: str, params, *, checkpoint: Optional[str], device,
                     model_kw: Optional[Dict[str, Any]],
                     calib_images: Optional[Sequence[np.ndarray]]) -> DepthPipeline:
    """UniDepth V2 / UniK3D: the frame resized to the square input, the model,
    then (reference ``Uni_Depth_V2/onnx2trt.py:170-183``) points and
    confidence resized half-pixel to the frame, depth = z clamped to
    [1e-3, 1e3], the intrinsics rescaled to the frame (``:78-94``). int8
    quantizes the pixel encoder's linears."""
    from monocular_depth_estimation_trt_tpu_torch.models.geometric import GeometricDepthModel
    from monocular_depth_estimation_trt_tpu_torch.ops.camera import rescale_intrinsics
    from monocular_depth_estimation_trt_tpu_torch.ops.resize import resize, resize_hw

    device = resolve_device(device)
    precision = resolve_int8_precision(model_name, encoder, precision)
    spec = ModelSpec(model=model_name, encoder=encoder, input_hw=(input_size, input_size),
                     precision=precision, metric=True)
    dtype = _dtype_for(precision, device)
    preprocess = _imagenet_square(spec.input_hw)
    model = _params_for(_new_model(lambda: GeometricDepthModel(encoder, mode, attn_impl,
                                                               **(model_kw or {}))),
                        spec, params=params, checkpoint=checkpoint, device=device, dtype=dtype,
                        make_sample=lambda img: preprocess(img[None]), input_size=input_size,
                        calib_images=calib_images)

    def forward(img_u8: torch.Tensor, out_hw):
        single = img_u8.dim() == 3
        out = model(preprocess(img_u8[None] if single else img_u8))
        pts = resize(out["pts_3d"], out_hw, method="linear", align_corners=False)
        result = {"depth": torch.clamp(pts[..., 2], 1e-3, 1e3), "pts_3d": pts,
                  "confidence": resize_hw(out["confidence"], out_hw, "linear",
                                          align_corners=False),
                  "intrinsics": rescale_intrinsics(out["intrinsics"], spec.input_hw, out_hw)}
        return {k: v[0] for k, v in result.items()} if single else result

    return DepthPipeline(spec, forward, device=device, model=model, viz="metric")


@register("unidepth_v2", fidelity="converter-verified")
def unidepth_v2(encoder: str = "vitb", input_size: int = 518, precision: str = "bf16",
                attn_impl: str = "auto", params: Optional[Mapping[str, torch.Tensor]] = None,
                checkpoint: Optional[str] = None, device=None,
                model_kw: Optional[Dict[str, Any]] = None,
                calib_images: Optional[Sequence[np.ndarray]] = None) -> DepthPipeline:
    """UniDepth V2 (reference ``Uni_Depth_V2/``): metric points, confidence and
    predicted intrinsics. ``params``: e.g. from
    ``weights.from_jax.geometric_from_jax``; ``model_kw``: ``cfg`` for
    ``GeometricDepthModel``."""
    return _build_geometric("unidepth_v2", "unidepth", encoder, input_size, precision,
                            attn_impl, params, checkpoint=checkpoint, device=device,
                            model_kw=model_kw, calib_images=calib_images)


@register("unik3d", fidelity="converter-verified")
def unik3d(encoder: str = "vitb", input_size: int = 518, precision: str = "bf16",
           attn_impl: str = "auto", params: Optional[Mapping[str, torch.Tensor]] = None,
           checkpoint: Optional[str] = None, device=None,
           model_kw: Optional[Dict[str, Any]] = None,
           calib_images: Optional[Sequence[np.ndarray]] = None) -> DepthPipeline:
    """UniK3D (reference ``UniK3D/``): universal-camera 3D, unit rays x
    distance."""
    return _build_geometric("unik3d", "unik3d", encoder, input_size, precision, attn_impl,
                            params, checkpoint=checkpoint, device=device, model_kw=model_kw,
                            calib_images=calib_images)


@register("sidepth", fidelity="converter-verified")
def sidepth(encoder: str = "vits", input_size: int = 518, precision: str = "bf16",
            attn_impl: str = "auto", params: Optional[Mapping[str, torch.Tensor]] = None,
            checkpoint: Optional[str] = None, device=None,
            model_kw: Optional[Dict[str, Any]] = None) -> DepthPipeline:
    """SIDepth (reference ``later/SIDepth/``): the SSI relative stage and the
    conditioned SI stage in one forward; the SI depth (metric up to one
    global scale) resized align-corners and clamped, the SSI map beside it.
    ``model_kw``: the encoder-preset overrides of ``SIDepth``."""
    from monocular_depth_estimation_trt_tpu_torch.models.sidepth import SIDepth
    from monocular_depth_estimation_trt_tpu_torch.ops.postprocess import upsample_depth

    device = resolve_device(device)
    spec = ModelSpec(model="sidepth", encoder=encoder, input_hw=(input_size, input_size),
                     precision=precision)
    dtype = _plain_dtype(precision, device)
    preprocess = _imagenet_square(spec.input_hw)
    model = _params_for(_new_model(lambda: SIDepth(encoder, attn_impl, **(model_kw or {}))),
                        spec, params=params, checkpoint=checkpoint, device=device, dtype=dtype,
                        make_sample=None, input_size=input_size)

    def forward(img_u8: torch.Tensor, out_hw):
        single = img_u8.dim() == 3
        out = model(preprocess(img_u8[None] if single else img_u8))
        result = {"depth": upsample_depth(out["depth"], out_hw, clamp=(1e-3, 1e3)),
                  "ssi": upsample_depth(out["ssi"], out_hw, clamp=None)}
        return {k: v[0] for k, v in result.items()} if single else result

    return DepthPipeline(spec, forward, device=device, model=model, viz="relative")


@register("geocalib", fidelity="converter-verified")
def geocalib(encoder: str = "vits", input_size: int = 322, precision: str = "bf16",
             attn_impl: str = "auto", params: Optional[Mapping[str, torch.Tensor]] = None,
             checkpoint: Optional[str] = None, iters: int = 10, device=None,
             model_kw: Optional[Dict[str, Any]] = None) -> DepthPipeline:
    """GeoCalib (reference ``later/GeoCalib/``): perspective fields and their
    confidences, then the Gauss-Newton camera fit in the same forward:
    roll, pitch, vfov and hfov (radians) and the focal, with uncertainties,
    beside the four fields at the input size. The angles carry over from the
    square network view; the focal is in pixels of the frame's height, by its
    vertical FoV. One frame per call, no depth and no viz."""
    from monocular_depth_estimation_trt_tpu_torch.models.geocalib import GeoCalib, fit_camera

    device = resolve_device(device)
    spec = ModelSpec(model="geocalib", encoder=encoder, input_hw=(input_size, input_size),
                     precision=precision)
    dtype = _plain_dtype(precision, device)
    preprocess = _imagenet_square(spec.input_hw)
    model = _params_for(_new_model(lambda: GeoCalib(encoder, attn_impl, **(model_kw or {}))),
                        spec, params=params, checkpoint=checkpoint, device=device, dtype=dtype,
                        make_sample=None, input_size=input_size)

    def forward(img_u8: torch.Tensor, out_hw):
        if img_u8.dim() != 3:
            raise ValueError(f"geocalib takes one (H, W, 3) frame, got {tuple(img_u8.shape)}")
        fields = {k: v[0] for k, v in model(preprocess(img_u8[None])).items()}
        est = fit_camera(fields["up_field"], fields["latitude_field"], fields["up_confidence"],
                         fields["latitude_confidence"], spec.input_hw, iters=iters)
        est["focal"] = out_hw[0] / (2.0 * torch.tan(est["vfov"] / 2.0))
        est["focal_uncertainty"] = est["focal_uncertainty"] * out_hw[0] / input_size
        est["hfov"] = 2.0 * torch.atan(out_hw[1] / (2.0 * est["focal"]))
        return {**est, **fields}

    return DepthPipeline(spec, forward, device=device, model=model, viz="none")


@register("prior_depth_anything", fidelity="converter-verified")
def prior_depth_anything(encoder: str = "vits", input_size: int = 518, precision: str = "bf16",
                         attn_impl: str = "auto",
                         params: Optional[Mapping[str, Mapping[str, torch.Tensor]]] = None,
                         checkpoint: Optional[str] = None,
                         vggt_checkpoint: Optional[str] = None, device=None,
                         vggt_cfg: Any = None,
                         model_kw: Optional[Dict[str, Any]] = None) -> DepthPipeline:
    """Prior Depth Anything (reference ``later/Prior_Depth_Anything/infer.py:
    190-217``): VGGT's depth and confidence (S = 1, depth only) refined by
    the prior-conditioned stacks, one forward; the pad-square crop and
    resample of the VGGT pipeline, giving ``depth`` (refined), ``depth_vggt``
    and ``confidence``. ``params``: ``{"vggt": ..., "refiner": ...}`` state
    dicts (``weights.from_jax.prior_depth_anything_from_jax``);
    ``checkpoint`` loads the refiner, ``vggt_checkpoint`` VGGT;
    ``vggt_cfg`` and ``model_kw`` override the presets (tests)."""
    from monocular_depth_estimation_trt_tpu_torch.models.prior_depth import (
        PriorDARefiner,
        PriorDepthAnything,
    )
    from monocular_depth_estimation_trt_tpu_torch.models.vggt import VGGT, VGGTConfig
    from monocular_depth_estimation_trt_tpu_torch.ops.postprocess import upsample_depth
    from monocular_depth_estimation_trt_tpu_torch.ops.preprocess import preprocess_pad_square
    from monocular_depth_estimation_trt_tpu_torch.weights.store import resolve_weights

    device = resolve_device(device)
    spec = ModelSpec(model="prior_depth_anything", encoder=encoder,
                     input_hw=(input_size, input_size), precision=precision, metric=True)
    dtype = _plain_dtype(precision, device)
    vggt_sd, refiner_sd = (None, None) if params is None else (params["vggt"], params["refiner"])
    vggt = _new_model(lambda: VGGT(vggt_cfg or VGGTConfig(), attn_impl, with_camera=False))
    refiner = _new_model(lambda: PriorDARefiner(encoder, attn_impl, **(model_kw or {})))
    # the JAX package's weight names: the depth-only VGGT's and the refiner's
    vggt_name = ModelSpec(model="vggt", input_hw=(input_size, input_size), precision=precision,
                          metric=True).artifact_name() + "_depthonly"
    resolve_weights(vggt, vggt_name, checkpoint=vggt_checkpoint, state_dict=vggt_sd)
    resolve_weights(refiner, spec.artifact_name() + "_refiner", checkpoint=checkpoint,
                    state_dict=refiner_sd)
    model = PriorDepthAnything(vggt, refiner).to(device=device, dtype=dtype).eval()

    def forward(img_u8: torch.Tensor, out_hw):
        single = img_u8.dim() == 3
        refined, depth, conf = model(preprocess_pad_square(img_u8[None] if single else img_u8,
                                                           input_size))
        # crop the square padding out and resample, as the vggt pipeline does
        crop = (slice(None), *_square_crop(out_hw, input_size))
        result = {"depth": upsample_depth(refined[crop], out_hw, clamp=(1e-3, 1e3)),
                  "depth_vggt": upsample_depth(depth[crop], out_hw, clamp=(1e-3, 1e3)),
                  "confidence": upsample_depth(conf[crop], out_hw, clamp=None)}
        return {k: v[0] for k, v in result.items()} if single else result

    return DepthPipeline(spec, forward, device=device, model=model, viz="metric")


# ---------------------------------------------------------------------------
# Multi-view metric mapping, two-view reconstruction and DINOv3 (reference
# later/Map_Anything/, later/Align3R/, later/DINOv3/)
# ---------------------------------------------------------------------------


class MapAnythingPipeline(DepthPipeline):
    """Single frames (S = 1) through the standard pipeline, and
    ``reconstruct(frames)``: the joint multi-view pass, one engine per
    (S, H, W)."""

    def __init__(self, spec: ModelSpec, forward: Callable, views_forward: Callable, **kw):
        super().__init__(spec, forward, **kw)
        self._views_forward = views_forward

    def reconstruct_engine(self, s: int, src_hw) -> Engine:
        """The engine of ``s`` views of size ``src_hw``."""
        h, w = src_hw
        return self._engine(f"{self.spec.artifact_name()}_s{s}_{h}x{w}", self._views_forward,
                            (s, h, w, 3))

    def reconstruct(self, frames_u8, *, device_out: bool = False) -> Dict[str, Any]:
        """frames (S, H, W, 3) uint8 -> the full output set of the S views
        with cross-view attention (the reference's ``model.infer(views)``),
        each with a leading batch axis of 1."""
        s, h, w = frames_u8.shape[:3]
        out = self.reconstruct_engine(s, (h, w))(self._as_tensor(frames_u8))
        return out if device_out else tree_get_chunked(out)


@register("map_anything", fidelity="converter-verified")
def map_anything(input_size: int = 518, precision: str = "bf16", attn_impl: str = "auto",
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 checkpoint: Optional[str] = None, device=None, vggt_cfg: Any = None,
                 calib_images: Optional[Sequence[np.ndarray]] = None) -> MapAnythingPipeline:
    """MapAnything metric 3D mapping (reference ``later/Map_Anything/
    infer.py:30-68``): per view world and camera points, z depth, depth along
    the ray, rays, intrinsics, cam2world poses, confidence, masks, the metric
    scale and the de-normalized image, composed on the device; the depth is
    also cropped out of the pad-square view and resampled to the frame.
    ``precision="int8"`` quantizes the aggregator's linears (kernel K4)."""
    from monocular_depth_estimation_trt_tpu_torch.models.map_anything import (
        MapAnything,
        compose,
    )
    from monocular_depth_estimation_trt_tpu_torch.models.vggt import VGGTConfig
    from monocular_depth_estimation_trt_tpu_torch.ops.postprocess import upsample_depth
    from monocular_depth_estimation_trt_tpu_torch.ops.preprocess import preprocess_pad_square

    device = resolve_device(device)
    cfg = vggt_cfg or VGGTConfig()
    spec = ModelSpec(model="map_anything", input_hw=(input_size, input_size),
                     precision=precision, metric=True)
    dtype = _dtype_for(precision, device)
    model = _params_for(
        _new_model(lambda: MapAnything(cfg, attn_impl)), spec,
        params=params, checkpoint=checkpoint, device=device, dtype=dtype,
        make_sample=lambda img: preprocess_pad_square(img[None], input_size)[:, None],
        input_size=input_size, calib_images=calib_images)

    def forward(img_u8: torch.Tensor, out_hw):
        single = img_u8.dim() == 3
        x = preprocess_pad_square(img_u8[None] if single else img_u8, input_size)[:, None]
        full = compose(model(x), x)
        crop = _crop_to_frame(out_hw, input_size)
        depth = upsample_depth(crop(full["depth_z"][..., 0]), out_hw, clamp=(1e-3, 1e3))
        if single:  # the JAX layout: views (S = 1) lead, the scale keeps its batch axis
            return {"depth": depth[0], **{k: v[0] for k, v in full.items()
                                          if k != "metric_scaling_factor"},
                    "metric_scaling_factor": full["metric_scaling_factor"]}
        return {"depth": depth, **full}

    def views_forward(frames_u8: torch.Tensor):
        views = preprocess_pad_square(frames_u8, input_size)[None]
        return compose(model(views), views)

    return MapAnythingPipeline(spec, forward, views_forward, device=device, model=model,
                               viz="metric")


ALIGN3R_PRIOR_ENCODER = "vits"  # the frozen DA-V2 prior


@register("align3r", fidelity="converter-verified")
def align3r(input_size: int = 512, precision: str = "bf16", attn_impl: str = "auto",
            params: Optional[Mapping[str, Mapping[str, torch.Tensor]]] = None,
            checkpoint: Optional[str] = None, device=None,
            model_kw: Optional[Dict[str, Any]] = None,
            prior_params: Optional[Mapping[str, torch.Tensor]] = None,
            prior_kw: Optional[Dict[str, Any]] = None) -> PairPipeline:
    """Align3R pairwise dynamic-scene reconstruction (reference
    ``later/Align3R/``): two images -> both views' point maps and confidence
    in view 1's frame, view 1's depth and the relative camera (frame 2 ->
    frame 1). One forward on the device: the frozen DA-V2 vits prior of both
    frames at the nearest multiple of 14 below the input, both pair orders as
    one batch of two, and the pose by confidence-weighted Procrustes
    (``ops/procrustes.py``) on view 2's points in the two frames.

    ``params``: ``{"align3r": ..., "prior": ...}`` state dicts (e.g.
    ``weights.from_jax.align3r_from_jax`` and ``state_dict_from_jax``);
    else ``checkpoint`` (Align3R) and ``prior_params`` (the prior), else
    random weights where allowed. ``model_kw`` / ``prior_kw``: overrides of
    ``Align3R`` / ``DepthAnythingV2`` (test sizes)."""
    from monocular_depth_estimation_trt_tpu_torch.models.align3r import Align3R
    from monocular_depth_estimation_trt_tpu_torch.models.depth_anything_v2 import (
        DepthAnythingV2,
    )
    from monocular_depth_estimation_trt_tpu_torch.ops.preprocess import normalize
    from monocular_depth_estimation_trt_tpu_torch.ops.procrustes import weighted_procrustes
    from monocular_depth_estimation_trt_tpu_torch.ops.resize import resize
    from monocular_depth_estimation_trt_tpu_torch.weights.store import resolve_weights

    device = resolve_device(device)
    spec = ModelSpec(model="align3r", input_hw=(input_size, input_size), precision=precision,
                     metric=True)
    dtype = _plain_dtype(precision, device)
    # the frozen prior runs on a /14 grid: the nearest multiple of 14 below
    prior_size = max((input_size // 14) * 14, 14)
    pspec = ModelSpec(model="depth_anything_v2", encoder=ALIGN3R_PRIOR_ENCODER,
                      input_hw=(prior_size, prior_size), precision=precision)
    a3r_sd, prior_sd = (None, prior_params) if params is None else (params["align3r"],
                                                                   params["prior"])
    model = _new_model(lambda: Align3R(attn_impl=attn_impl, **(model_kw or {})))
    prior = _new_model(lambda: DepthAnythingV2(encoder=ALIGN3R_PRIOR_ENCODER,
                                               attn_impl=attn_impl, **(prior_kw or {})))
    resolve_weights(model, spec.artifact_name(), checkpoint=checkpoint, state_dict=a3r_sd)
    resolve_weights(prior, pspec.artifact_name(), state_dict=prior_sd)
    model = model.to(device=device, dtype=dtype).eval()
    prior = prior.to(device=device, dtype=dtype).eval()

    def pair_forward(img1_u8: torch.Tensor, img2_u8: torch.Tensor):
        in_hw = spec.input_hw
        x1, x2 = (resize(img.float(), in_hw, method="linear")[None] for img in (img1_u8, img2_u8))
        # the frozen DA-V2 priors of both frames in one batch
        both = torch.cat([x1, x2]) / 255.0
        pri = prior(normalize(resize(both, (prior_size, prior_size), method="linear"),
                              IMAGENET_MEAN, IMAGENET_STD))
        pri = resize(pri[..., None], in_hw, method="linear")[..., 0]
        # both pair orders as one batch of two: row 0 = (1, 2), row 1 = (2, 1)
        out = model(torch.cat([x1, x2]), torch.cat([x2, x1]), pri, pri.flip(0))
        pts1, conf1 = out["pts1"][0], out["conf1"][0]  # view 1 in frame 1
        pts2, conf2 = out["pts2"][0], out["conf2"][0]  # view 2 in frame 1
        pts2_own, conf2_own = out["pts1"][1], out["conf1"][1]  # view 2 in frame 2
        # the relative pose frame 2 -> frame 1 from the shared physical points
        rot, trans = weighted_procrustes(pts2_own.reshape(1, -1, 3), pts2.reshape(1, -1, 3),
                                         (conf2 * conf2_own).reshape(1, -1))
        return {"depth": torch.clamp(pts1[..., 2], min=1e-3), "pts1": pts1, "conf1": conf1,
                "pts2": pts2, "conf2": conf2, "rotation": rot[0], "translation": trans[0]}

    return PairPipeline(spec, pair_forward, device=device, model=model, prior=prior)


def _model_on_device(make: Callable[[], torch.nn.Module], spec: ModelSpec, *, params,
                     checkpoint, device: torch.device, dtype: torch.dtype) -> torch.nn.Module:
    """A model whose random weights are made where it runs: with neither
    ``params`` nor ``checkpoint`` it is built on the meta device, given
    uninitialized storage of ``dtype`` on ``device`` and filled there
    (``init_random_`` draws from a generator on that device), so that the
    host never holds a full-precision copy of DINOv3 vit7b16 (8.1 B
    parameters); else as ``_params_for``."""
    from monocular_depth_estimation_trt_tpu_torch.weights.store import resolve_weights

    if params is not None or checkpoint:
        return _params_for(_new_model(make), spec, params=params,
                           checkpoint=checkpoint, device=device, dtype=dtype, make_sample=None,
                           input_size=spec.input_hw)
    with torch.device("meta"):
        model = make()
    model = model.to(dtype).to_empty(device=device)
    resolve_weights(model, spec.artifact_name())
    return model.eval()


@register("dinov3", fidelity="converter-verified")
def dinov3(encoder: str = "vitl16", input_size: int = 1024, precision: str = "bf16",
           attn_impl: str = "auto", params: Optional[Mapping[str, torch.Tensor]] = None,
           checkpoint: Optional[str] = None, device=None,
           model_kw: Optional[Dict[str, Any]] = None) -> DepthPipeline:
    """DINOv3 depther (reference ``later/DINOv3/infer.py:25-45``): the
    RoPE-only patch-16 backbone and a DPT head at 1024², antialiased resize
    and ImageNet normalization, the depth resized to the frame unclamped,
    Spectral viz. ``encoder``: vits16, vitl16 (default) or vit7b16, whose
    random weights are made on the card. ``model_kw``: overrides passed to
    ``DINOv3Depther`` (``vit_config``, ``head_features``,
    ``head_out_channels``, ``out_indices``)."""
    from monocular_depth_estimation_trt_tpu_torch.models.dinov3 import DINOv3Depther
    from monocular_depth_estimation_trt_tpu_torch.ops.postprocess import upsample_depth
    from monocular_depth_estimation_trt_tpu_torch.ops.preprocess import normalize, to_float_rgb
    from monocular_depth_estimation_trt_tpu_torch.ops.resize import resize

    device = resolve_device(device)
    spec = ModelSpec(model="dinov3", encoder=encoder, input_hw=(input_size, input_size),
                     precision=precision)
    dtype = _plain_dtype(precision, device)
    model = _model_on_device(lambda: DINOv3Depther(encoder, attn_impl, **(model_kw or {})),
                             spec, params=params, checkpoint=checkpoint, device=device,
                             dtype=dtype)

    def preprocess(img_u8: torch.Tensor) -> torch.Tensor:
        # torchvision Resize(antialias=True) + ImageNet normalize
        # (reference later/DINOv3/infer.py:16-24)
        x = resize(to_float_rgb(img_u8), spec.input_hw, method="linear", antialias=True)
        return normalize(x, IMAGENET_MEAN, IMAGENET_STD)

    return DepthPipeline(spec, depth_forward_factory(model, preprocess, clamp=None),
                         device=device, model=model, viz="spectral")


# ---------------------------------------------------------------------------
# Video families (reference later/FlashDepth/, later/Video_Depth_Anything/)
# ---------------------------------------------------------------------------


class FlashDepthPipeline(DepthPipeline):
    """Single frames (each its own sequence, from a zero state that is a
    constant of the engine's graph), and ``stream()``: a
    :class:`~monocular_depth_estimation_trt_tpu_torch.apps.streaming.FlashDepthSession`
    whose Mamba state stays on the card between frames."""

    def __init__(self, spec: ModelSpec, forward: Callable, forward_state: Callable,
                 init_state: Callable, *, device: torch.device, model: torch.nn.Module):
        super().__init__(spec, forward, device=device, model=model, viz="relative")
        self._forward_state = forward_state
        self._init_state = init_state

    def stream(self):
        """A fresh stateful session (upstream ``start_new_sequence()``):
        ``sess(frame, viz=...)`` -> host outputs of that frame."""
        from monocular_depth_estimation_trt_tpu_torch.apps.streaming import FlashDepthSession

        return FlashDepthSession(self._forward_state, self._init_state,
                                 lambda out: self._with_viz_epilogue(out, True),
                                 device=self.device, name=self.spec.artifact_name() + "_stream")


@register("flashdepth", fidelity="converter-verified")
def flashdepth(encoder: str = "vits", input_size: int = 518, precision: str = "bf16",
               attn_impl: str = "auto", params: Optional[Mapping[str, torch.Tensor]] = None,
               checkpoint: Optional[str] = None, device=None,
               model_kw: Optional[Dict[str, Any]] = None) -> FlashDepthPipeline:
    """FlashDepth streaming video depth (reference ``later/FlashDepth/``): a
    DA-style DPT with a Mamba temporal module whose state persists across
    frames (``wrapper.py:9-25``, ``infer.py:104-130``). The frame is resized
    cubic to ``input_size``² and ImageNet-normalized (``infer.py:32-67``);
    the depth is resized align-corners to the frame, clipped at 0.
    ``model_kw``: overrides passed to ``FlashDepth`` (``vit_config``,
    ``head_features``, ``head_out_channels``, ``out_indices``)."""
    from monocular_depth_estimation_trt_tpu_torch.models.flashdepth import (
        FlashDepth,
        flashdepth_init_state,
    )
    from monocular_depth_estimation_trt_tpu_torch.ops.constants import device_cached
    from monocular_depth_estimation_trt_tpu_torch.ops.postprocess import upsample_depth
    from monocular_depth_estimation_trt_tpu_torch.ops.preprocess import normalize, to_float_rgb
    from monocular_depth_estimation_trt_tpu_torch.ops.resize import resize

    device = resolve_device(device)
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError("flashdepth: the Mamba SSM needs full fp32 matmuls (dt feeds exp); "
                         "turn torch.backends.cuda.matmul.allow_tf32 off")
    spec = ModelSpec(model="flashdepth", encoder=encoder, input_hw=(input_size, input_size),
                     precision=precision)
    dtype = _plain_dtype(precision, device)
    model = _params_for(_new_model(lambda: FlashDepth(encoder, attn_impl=attn_impl,
                                                      **(model_kw or {}))),
                        spec, params=params, checkpoint=checkpoint, device=device, dtype=dtype,
                        make_sample=None, input_size=input_size)
    patch = (input_size // model.patch_size,) * 2

    def preprocess(img_u8: torch.Tensor) -> torch.Tensor:
        x = resize(to_float_rgb(img_u8), spec.input_hw, method="cubic")
        return normalize(x, IMAGENET_MEAN, IMAGENET_STD)

    def forward_state(img_u8: torch.Tensor, out_hw, state):
        single = img_u8.dim() == 3
        depth, new_state = model(preprocess(img_u8[None] if single else img_u8), state)
        depth = torch.clamp(upsample_depth(depth, out_hw, clamp=None), min=0.0)
        return {"depth": depth[0] if single else depth}, new_state

    @device_cached
    def zero_state(batch: int, dev: torch.device):
        return flashdepth_init_state(model, batch, patch, dev)

    def forward(img_u8: torch.Tensor, out_hw):
        # stateless serving: every image is its own sequence
        batch = 1 if img_u8.dim() == 3 else img_u8.shape[0]
        return forward_state(img_u8, out_hw, zero_state(batch, img_u8.device))[0]

    return FlashDepthPipeline(spec, forward, forward_state,
                              lambda dev: flashdepth_init_state(model, 1, patch, dev),
                              device=device, model=model)


class VDAPipeline(DepthPipeline):
    """Single images as 1-frame windows, plus the windowed video protocol:
    ``video_depth(frames_u8)``, one engine per (source size, window).

    ``window_forward``: fn(frames_u8 (T, H, W, 3) on the device) ->
    {"depth": (T, ih, iw)} at the model's input size."""

    def __init__(self, spec: ModelSpec, forward: Callable, window_forward: Callable, *,
                 window: int, overlap: int, device: torch.device, model: torch.nn.Module,
                 viz: str):
        super().__init__(spec, forward, device=device, model=model, viz=viz)
        self._window_forward = window_forward
        self.window = window
        self.overlap = overlap

    def window_engine(self, src_hw: Tuple[int, int]) -> Engine:
        """The engine for a window of frames of size ``src_hw``."""
        t, (h, w) = self.window, tuple(src_hw)
        return self._engine(f"{self.spec.artifact_name()}_win{t}_{h}x{w}", self._window_forward,
                            (t, h, w, 3))

    def video_depth(self, video_u8) -> np.ndarray:
        """video (T, H, W, 3) uint8 -> depth (T, ih, iw) float32 at the
        model's input size (upstream run.py): a clip of at most one window
        is padded with its last frame to the window and trimmed after, so
        that every clip length reuses the one engine; a longer clip runs
        overlapping windows (``window_starts``), each aligned to the one
        before by a least-squares scale and shift on their overlap and
        cross-faded there, on the host."""
        from monocular_depth_estimation_trt_tpu_torch.models.video_depth_anything import (
            stitch_window,
            window_starts,
        )

        video_u8 = np.asarray(video_u8)
        t_total, window = video_u8.shape[0], self.window
        eng = self.window_engine(video_u8.shape[1:3])
        if t_total <= window:
            padded = np.concatenate([video_u8, np.repeat(video_u8[-1:], window - t_total, 0)])
            return tree_get_chunked(eng(self._as_tensor(padded)))["depth"][:t_total]
        out = np.zeros((t_total, *self.spec.input_hw), np.float32)
        prev_end = 0
        for s in window_starts(t_total, window, self.overlap):
            d = tree_get_chunked(eng(self._as_tensor(video_u8[s:s + window])))["depth"]
            if prev_end == 0:
                out[:window] = d
            else:  # the overlap is the configured one but at the last window
                out[s:s + window] = stitch_window(out[s:prev_end], d, prev_end - s)
            prev_end = s + window
        return out

    def benchmark(self, in_hw: Optional[Tuple[int, int]] = None,
                  config: Optional[BenchmarkConfig] = None) -> BenchmarkReport:
        """The window engine's throughput in frames/s: each iteration is one
        ``window``-frame window (uint8 frames on the card, the depth D2H into
        a pinned buffer), so the report has ``frames_per_iteration =
        window``; its latencies are per window."""
        h, w = tuple(in_hw or self.spec.input_hw)
        eng = self.window_engine((h, w))
        rng = np.random.default_rng(0)
        frames = torch.from_numpy(
            rng.integers(0, 255, (self.window, h, w, 3), dtype=np.uint8)).to(self.device)
        depth = eng(frames)["depth"]
        host_out = torch.empty(depth.shape, dtype=depth.dtype)
        if self.device.type == "cuda":
            host_out = host_out.pin_memory()

        def step():
            host_out.copy_(eng(frames)["depth"], non_blocking=True)

        rep = benchmark(step, device=self.device, config=config, name=self.spec.artifact_name())
        rep.frames_per_iteration = self.window
        return rep


@register("video_depth_anything", fidelity="converter-verified")
def video_depth_anything(encoder: str = "vits", input_size: int = 518, metric: bool = False,
                         window: int = 0, overlap: int = 0, precision: str = "bf16",
                         attn_impl: str = "auto",
                         params: Optional[Mapping[str, torch.Tensor]] = None,
                         checkpoint: Optional[str] = None, device=None,
                         model_kw: Optional[Dict[str, Any]] = None) -> VDAPipeline:
    """Video Depth Anything (reference ``later/Video_Depth_Anything/``):
    temporally consistent video depth, a DA-V2 encoder and a DPT head with
    temporal attention, on 32-frame windows; long videos stitch overlapping
    windows (upstream ``run.py``). ``metric`` selects the Metric-VDA
    checkpoints (the same graph, depth in meters). ``model_kw``: overrides
    passed to ``VideoDepthAnything`` (``vit_config``, ``head_features``,
    ``head_out_channels``, ``out_indices``, ``num_heads``)."""
    from monocular_depth_estimation_trt_tpu_torch.models.video_depth_anything import (
        OVERLAP,
        WINDOW,
        VideoDepthAnything,
    )
    from monocular_depth_estimation_trt_tpu_torch.ops.postprocess import upsample_depth

    device = resolve_device(device)
    spec = ModelSpec(model="video_depth_anything", encoder=encoder,
                     input_hw=(input_size, input_size), precision=precision, metric=metric,
                     dataset="metric" if metric else "")
    dtype = _plain_dtype(precision, device)
    model = _params_for(_new_model(lambda: VideoDepthAnything(encoder, attn_impl=attn_impl,
                                                              **(model_kw or {}))),
                        spec, params=params, checkpoint=checkpoint, device=device, dtype=dtype,
                        make_sample=None, input_size=input_size)
    # upstream run.py: the DA transform per frame, on the card over the window
    prep_frames = _imagenet_square(spec.input_hw)

    def forward(img_u8: torch.Tensor, out_hw):
        # one image = a 1-frame window (temporal attention over T = 1)
        single = img_u8.dim() == 3
        d = model(prep_frames(img_u8[None] if single else img_u8)[:, None])[:, 0]
        depth = torch.clamp(upsample_depth(d, out_hw, clamp=None), min=0.0)
        return {"depth": depth[0] if single else depth}

    def window_forward(frames_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"depth": torch.clamp(model(prep_frames(frames_u8)[None])[0], min=0.0)}

    return VDAPipeline(spec, forward, window_forward, window=window or WINDOW,
                       overlap=overlap or OVERLAP, device=device, model=model,
                       viz="metric" if metric else "relative")


# ---------------------------------------------------------------------------
# Optical flow (reference RAFT/, NeuFlow/, MeFlow/, MEMFOF/, later/WAFT/)
# ---------------------------------------------------------------------------


def _flow_model(make: Callable[[], torch.nn.Module], spec: ModelSpec, *, params, checkpoint,
                device: torch.device) -> torch.nn.Module:
    """A flow model of ``spec``'s precision on ``device``, its weights from
    ``params``, ``checkpoint`` or random weights where allowed."""
    return _params_for(_new_model(make), spec, params=params, checkpoint=checkpoint,
                       device=device, dtype=_plain_dtype(spec.precision, device),
                       make_sample=None, input_size=spec.input_hw)


def _pair_flow_forward(model: torch.nn.Module, in_hw: Tuple[int, int]) -> Callable:
    """The pair forward of the JAX flow factories: each frame resized
    (linear) to ``in_hw`` on the device (the reference resizes on the host,
    ``onnx2trt.py:100-111``), the model, batch 1 dropped: ``flow`` and, for a
    model that returns both, ``flow_low``."""
    from monocular_depth_estimation_trt_tpu_torch.ops.resize import resize

    def forward(img1_u8: torch.Tensor, img2_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        x1, x2 = (resize(img.float(), in_hw, method="linear")[None] for img in (img1_u8, img2_u8))
        out = model(x1, x2)
        if isinstance(out, tuple):
            return {"flow_low": out[0][0], "flow": out[1][0]}
        return {"flow": out[0]}

    return forward


@register("raft", fidelity="converter-verified")
def raft(iters: int = 20, input_hw: tuple = (288, 512), precision: str = "fp32",
         params: Optional[Mapping[str, torch.Tensor]] = None, checkpoint: Optional[str] = None,
         device=None) -> FlowPipeline:
    """RAFT optical flow (reference ``RAFT/``): a frame pair at 288x512 ->
    ``flow_low`` (1/8) and ``flow`` (full size). fp32 by default, as the
    reference keeps its correlation volume (TF32 off)."""
    from monocular_depth_estimation_trt_tpu_torch.models.flow.raft import RAFT

    device = resolve_device(device)
    spec = ModelSpec(model="raft", input_hw=tuple(input_hw), precision=precision,
                     extra=(("iters", iters),))
    model = _flow_model(lambda: RAFT(iters=iters), spec, params=params, checkpoint=checkpoint,
                        device=device)
    return FlowPipeline(spec, _pair_flow_forward(model, spec.input_hw), device=device,
                        model=model)


@register("waft", fidelity="converter-verified")
def waft(iters: int = 8, input_hw: tuple = (280, 504), encoder: str = "vits",
         precision: str = "bf16", attn_impl: str = "auto",
         params: Optional[Mapping[str, torch.Tensor]] = None, checkpoint: Optional[str] = None,
         device=None, model_kw: Optional[Dict[str, Any]] = None) -> FlowPipeline:
    """WAFT warping-alone flow (reference ``later/WAFT/``): a frame pair ->
    ``flow_low`` on a 1/7 grid and ``flow`` at full size, no correlation
    volume; the DINOv2 backbone's attention on kernel K1. ``input_hw``:
    multiples of 14 (the patch). ``model_kw``: overrides passed to ``WAFT``
    (``vit_config``)."""
    from monocular_depth_estimation_trt_tpu_torch.models.flow.waft import WAFT

    device = resolve_device(device)
    spec = ModelSpec(model="waft", encoder=encoder, input_hw=tuple(input_hw),
                     precision=precision, extra=(("iters", iters),))
    model = _flow_model(lambda: WAFT(iters=iters, encoder=encoder, attn_impl=attn_impl,
                                     **(model_kw or {})),
                        spec, params=params, checkpoint=checkpoint, device=device)
    return FlowPipeline(spec, _pair_flow_forward(model, spec.input_hw), device=device,
                        model=model)


@register("neuflow", fidelity="converter-verified")
def neuflow(input_hw: tuple = (288, 512), precision: str = "bf16",
            params: Optional[Mapping[str, torch.Tensor]] = None, checkpoint: Optional[str] = None,
            device=None) -> FlowPipeline:
    """NeuFlow v2 (reference ``NeuFlow/``): global matching at 1/16 and
    windowed refinement; one ``flow`` output."""
    from monocular_depth_estimation_trt_tpu_torch.models.flow.neuflow import NeuFlow

    device = resolve_device(device)
    spec = ModelSpec(model="neuflow", input_hw=tuple(input_hw), precision=precision)
    model = _flow_model(NeuFlow, spec, params=params, checkpoint=checkpoint, device=device)
    return FlowPipeline(spec, _pair_flow_forward(model, spec.input_hw), device=device,
                        model=model)


@register("meflow", fidelity="converter-verified")
def meflow(iters: int = 20, input_hw: tuple = (288, 512), precision: str = "bf16",
           params: Optional[Mapping[str, torch.Tensor]] = None, use_scan: bool = False,
           checkpoint: Optional[str] = None, device=None) -> FlowPipeline:
    """MeFlow (reference ``MeFlow/``): alternating 1D correlations.
    ``use_scan`` names the JAX package's scanned build (``scan1`` in the
    artifact name); the port runs the same loop either way."""
    from monocular_depth_estimation_trt_tpu_torch.models.flow.meflow import MeFlow

    device = resolve_device(device)
    spec = ModelSpec(model="meflow", input_hw=tuple(input_hw), precision=precision,
                     extra=(("iters", iters),) + ((("scan", 1),) if use_scan else ()))
    model = _flow_model(lambda: MeFlow(iters=iters, use_scan=use_scan), spec, params=params,
                        checkpoint=checkpoint, device=device)
    return FlowPipeline(spec, _pair_flow_forward(model, spec.input_hw), device=device,
                        model=model)


class TripletFlowPipeline:
    """MEMFOF's three-frame pipeline (the JAX package's
    ``TripletFlowPipeline``): ``pipe(f1, f2, f3)`` -> bidirectional ``flow``
    (2, h, w, 2) at the model's input size (center -> previous, center ->
    next) and the device-resident ``fmap_cache``; one engine per frame size.
    ``stream()``: a :class:`MEMFOFSession`, whose steps after the first
    encode only the newest frame through a second engine (``cached_engine``)
    that takes the two cached feature maps as inputs.

    ``forward``: fn(frames_u8 (3, H, W, 3) on ``device``) -> dict;
    ``cached_forward``: fn(f1, f2, f3 (h, w, 3) uint8 at the input size,
    c1, c2 cached maps of f1 and f2) -> dict."""

    def __init__(self, spec: ModelSpec, forward: Callable, cached_forward: Callable, *,
                 device: torch.device, model: torch.nn.Module):
        self.spec = spec
        self.device = torch.device(device)
        self.model = model
        self._forward = forward
        self._cached_forward = cached_forward
        self._engines: Dict[Any, Engine] = {}

    def _run(self, frames_u8: torch.Tensor):
        """The eager forward that the engines capture."""
        with torch.inference_mode():
            return self._forward(frames_u8)

    def engine_for(self, in_hw: Tuple[int, int]) -> Engine:
        """The engine for three frames of size ``in_hw``."""
        h, w = tuple(in_hw)
        if (h, w) not in self._engines:
            example = torch.empty((3, h, w, 3), dtype=torch.uint8, device="meta")
            self._engines[(h, w)] = Engine(self._forward, (example,),
                                           name=f"{self.spec.artifact_name()}_in{h}x{w}",
                                           device=self.device)
        return self._engines[(h, w)]

    def cached_engine(self) -> Engine:
        """The video step's engine: three frames at the input size and the
        first two frames' cached feature maps in."""
        if "cached" not in self._engines:
            h, w = self.spec.input_hw
            frame = torch.empty((h, w, 3), dtype=torch.uint8, device="meta")
            fmap = torch.empty((1, self.model.fnet.down.out_channels, h // 16, w // 16),
                               dtype=self.model.init_conv.weight.dtype, device="meta")
            self._engines["cached"] = Engine(
                self._cached_forward, (frame, frame, frame, fmap, fmap),
                name=f"{self.spec.artifact_name()}_stream", device=self.device)
        return self._engines["cached"]

    def release_engines(self) -> None:
        for eng in self._engines.values():
            eng.release()
        self._engines.clear()

    def __call__(self, f1, f2, f3, *, device_out: bool = False) -> Dict[str, Any]:
        """Three (H, W, 3) RGB uint8 frames -> ``flow`` as host numpy (device
        tensors if ``device_out``) and ``fmap_cache`` on the device."""
        frames = torch.stack([DepthPipeline._as_tensor(f) for f in (f1, f2, f3)])
        out = self.engine_for(tuple(frames.shape[1:3]))(frames)
        if device_out:
            return out
        return {"flow": tree_get_chunked(out["flow"]), "fmap_cache": out["fmap_cache"]}

    def benchmark(self, in_hw: Optional[Tuple[int, int]] = None,
                  config: Optional[BenchmarkConfig] = None) -> BenchmarkReport:
        """Time a triplet on the card: three pinned uint8 frames in, the
        engine, the flow D2H into a pinned buffer."""
        h, w = tuple(in_hw or self.spec.input_hw)
        eng = self.engine_for((h, w))
        rng = np.random.default_rng(0)
        frames = torch.from_numpy(rng.integers(0, 255, (3, h, w, 3), dtype=np.uint8)).pin_memory()
        flow = eng(frames)["flow"]
        host_out = torch.empty(flow.shape, dtype=flow.dtype).pin_memory()

        def step():
            host_out.copy_(eng(frames)["flow"], non_blocking=True)

        return benchmark(step, device=self.device, config=config, name=self.spec.artifact_name())

    def stream(self) -> MEMFOFSession:
        return MEMFOFSession(self)


class MEMFOFSession:
    """Video mode (the JAX package's ``MEMFOFSession``, reference
    ``MEMFOF/wrapper.py:210-232,277-281``): each pushed frame is resized to
    the input size and truncated to uint8 on the device; from the third
    frame on, each step returns the bidirectional flow of the frame before
    the newest. The first step runs the whole triplet; every later one
    encodes only the newest frame, the two older maps coming from the
    previous step's cache (cloned out of the graph, so the next replay does
    not overwrite it)."""

    def __init__(self, pipe: TripletFlowPipeline):
        self.pipe = pipe
        self._frames = []  # the last three frames at the input size, on the device
        self._cache = None

    def _prepare(self, frame_u8) -> torch.Tensor:
        from monocular_depth_estimation_trt_tpu_torch.ops.resize import resize

        x = DepthPipeline._as_tensor(frame_u8).to(self.pipe.device)
        with torch.inference_mode():
            return resize(x.float(), self.pipe.spec.input_hw, method="linear").to(torch.uint8)

    def step(self, frame_u8) -> Optional[np.ndarray]:
        """Push one (H, W, 3) RGB uint8 frame; the flow (2, h, w, 2) of the
        previous frame as host numpy once three frames are in, else None."""
        self._frames = (self._frames + [self._prepare(frame_u8)])[-3:]
        if len(self._frames) < 3:
            return None
        if self._cache is None:
            out = self.pipe(*self._frames, device_out=True)
        else:
            out = self.pipe.cached_engine()(*self._frames, *self._cache[1:])
        self._cache = out["fmap_cache"]
        return tree_get_chunked(out["flow"])


@register("memfof", fidelity="converter-verified")
def memfof(iters: int = 8, input_hw: tuple = (288, 512), precision: str = "bf16",
           params: Optional[Mapping[str, torch.Tensor]] = None, checkpoint: Optional[str] = None,
           device=None) -> TripletFlowPipeline:
    """MEMFOF three-frame bidirectional flow with the encoder feature cache
    (reference ``MEMFOF/``): call with three frames; ``stream()`` for a
    video."""
    from monocular_depth_estimation_trt_tpu_torch.models.flow.memfof import MEMFOF
    from monocular_depth_estimation_trt_tpu_torch.ops.resize import resize

    device = resolve_device(device)
    in_hw = tuple(input_hw)
    spec = ModelSpec(model="memfof", input_hw=in_hw, precision=precision,
                     extra=(("iters", iters),))
    model = _flow_model(lambda: MEMFOF(iters=iters), spec, params=params,
                        checkpoint=checkpoint, device=device)

    def forward(frames_u8: torch.Tensor) -> Dict[str, Any]:
        out = model(resize(frames_u8.float(), in_hw, method="linear")[None])
        return {"flow": out["flow"][0], "fmap_cache": out["fmap_cache"]}

    def cached_forward(f1, f2, f3, c1, c2) -> Dict[str, Any]:
        out = model(torch.stack([f1, f2, f3]).float()[None], fmap_cache=(c1, c2, None))
        return {"flow": out["flow"][0], "fmap_cache": out["fmap_cache"]}

    return TripletFlowPipeline(spec, forward, cached_forward, device=device, model=model)


# ---------------------------------------------------------------------------
# Point tracking (reference later/CoTracker3/)
# ---------------------------------------------------------------------------


def grid_queries(grid_size: int, h: int, w: int) -> np.ndarray:
    """(1, grid_size^2, 2) pixel (x, y) queries on an interior grid, as
    upstream ``get_points_on_a_grid``: margins of one cell on each side."""
    ys = np.linspace(h / (grid_size + 1), h * grid_size / (grid_size + 1), grid_size,
                     dtype=np.float32)
    xs = np.linspace(w / (grid_size + 1), w * grid_size / (grid_size + 1), grid_size,
                     dtype=np.float32)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)[None]


class CoTrackerPipeline:
    """CoTracker3's online session (the JAX package's ``CoTrackerPipeline``,
    reference ``later/CoTracker3/infer.py:19-28``): the pipeline object IS
    the online model. ``pipe(None, is_first_step=True, grid_size=...)``
    starts a video; each later call takes a chunk of up to ``window`` frames
    and returns the chunk's (tracks (1, T, N, 2), visibility (1, T, N, 1))
    as host numpy. ``step = window // 2``: consecutive chunks overlap by
    ``window - step`` frames.

    Two engines: ``_first`` (frames, queries) and ``_cont`` (frames,
    queries, and the window seed: the previous window's tracks shifted by
    ``step`` and padded with its last estimate, the visibility as log-odds,
    the track features). The seed is computed and kept on the device
    between the engines. Frames are resized on the host to the model's
    input size (``utils/imageio.resize_float``, cv2's INTER_LINEAR as in the
    JAX package)."""

    def __init__(self, spec: ModelSpec, model: torch.nn.Module, *, window: int, grid_size: int,
                 device: torch.device):
        self.spec = spec
        self.model = model
        self.device = torch.device(device)
        self.window = window
        self.step = window // 2
        self.grid_size = grid_size
        self._engines: Dict[str, Engine] = {}
        self._queries: Optional[torch.Tensor] = None
        self._state = None  # (tracks (1, W, N, 2), visibility log-odds (1, W, N), feat (1, N, C))

    @property
    def num_queries(self) -> int:
        return self.grid_size * self.grid_size

    def _prep(self, chunk) -> np.ndarray:
        """(T, H, W, 3) frames -> float32 in [0, 1] at the model's input size."""
        from monocular_depth_estimation_trt_tpu_torch.utils.imageio import resize_float

        frames = np.asarray(chunk, dtype=np.float32)
        if frames.max() > 1.5:
            frames = frames / 255.0
        if frames.shape[1:3] != tuple(self.spec.input_hw):
            frames = np.stack([resize_float(f, self.spec.input_hw) for f in frames])
        return frames

    def _forward(self, frames, queries, coords=None, vis=None, feat=None) -> Dict[str, torch.Tensor]:
        out = self.model(frames, queries, init_coords=coords, init_vis=vis, track_feat=feat)
        return {**out, "track_feat": out["track_feat"].float()}

    def engine(self, first: bool) -> Engine:
        """The first window's engine, or the continuation's."""
        key = "first" if first else "cont"
        if key not in self._engines:
            n, w = self.num_queries, self.window
            meta = dict(dtype=torch.float32, device="meta")
            example = [torch.empty((1, w, *self.spec.input_hw, 3), **meta),
                       torch.empty((1, n, 2), **meta)]
            if not first:
                example += [torch.empty((1, w, n, 2), **meta), torch.empty((1, w, n), **meta),
                            torch.empty((1, n, self.model.dim), **meta)]
            self._engines[key] = Engine(self._forward, example,
                                        name=f"{self.spec.artifact_name()}_{key}",
                                        device=self.device)
        return self._engines[key]

    def release_engines(self) -> None:
        for eng in self._engines.values():
            eng.release()
        self._engines.clear()

    def _keep(self, out: Dict[str, torch.Tensor]) -> None:
        """Keep a window's outputs for the next window's seed, the
        visibility as its log-odds."""
        v = out["visibility"][..., 0]
        vis_logit = (torch.log(torch.clamp(v, 1e-6, 1 - 1e-6))
                     - torch.log(torch.clamp(1 - v, 1e-6, 1 - 1e-6)))
        self._state = (out["tracks"], vis_logit, out["track_feat"])

    def _seed(self):
        """The continuation's seed from the previous window, on the device:
        the (window - step) overlap frames reuse its estimates, the ``step``
        new frames start from its last one (``window`` frames in all)."""
        tracks, vis_logit, feat = self._state
        s = self.step
        init_c = torch.cat([tracks[:, s:], tracks[:, -1:].expand(-1, s, -1, -1)], dim=1)
        init_v = torch.cat([vis_logit[:, s:], vis_logit[:, -1:].expand(-1, s, -1)], dim=1)
        return init_c, init_v, feat

    def __call__(self, video_chunk=None, is_first_step: bool = False, grid_size: int = 0):
        """The upstream online API (``later/CoTracker3/infer.py:24-28``)."""
        if is_first_step:
            if grid_size and grid_size != self.grid_size:
                # the query count is fixed in the engines' shapes: refuse
                # rather than answer for another grid
                raise ValueError(
                    f"[MDET] grid_size={grid_size} differs from the pipeline's compiled "
                    f"grid_size={self.grid_size}; rebuild with build_pipeline('cotracker3', "
                    f"grid_size={grid_size})")
            self._queries = torch.from_numpy(grid_queries(self.grid_size, *self.spec.input_hw))
            self._state = None
            return None
        chunk = np.asarray(video_chunk)
        frames = self._prep(chunk[0] if chunk.ndim == 5 else chunk)
        t = frames.shape[0]
        if t < self.window:  # pad by repeating the last frame (static shapes)
            frames = np.concatenate([frames, np.repeat(frames[-1:], self.window - t, axis=0)])
        fr = torch.from_numpy(np.ascontiguousarray(frames[None]))
        if self._state is None:
            out = self.engine(True)(fr, self._queries)
        else:
            out = self.engine(False)(fr, self._queries, *self._seed())
        self._keep(out)
        tracks, vis = tree_get_chunked((out["tracks"], out["visibility"]))
        return tracks[:, :t], vis[:, :t]

    def track_video(self, video):
        """Full-video convenience: video (T, H, W, 3) -> (tracks (1, T, N, 2),
        visibility (1, T, N, 1)) over all frames (the reference's loop,
        ``infer.py:27-28``)."""
        video = self._prep(video)
        self(None, is_first_step=True)
        t_total = video.shape[0]
        n = self.num_queries
        all_tracks = np.zeros((1, t_total, n, 2), np.float32)
        all_vis = np.zeros((1, t_total, n, 1), np.float32)
        pos = 0
        while pos < t_total:
            chunk = video[pos: pos + self.window]
            tr, vi = self(chunk)
            t = chunk.shape[0]
            all_tracks[:, pos: pos + t] = tr[:, :t]
            all_vis[:, pos: pos + t] = vi[:, :t]
            pos += self.step if pos + self.window < t_total else t
        return all_tracks, all_vis

    def benchmark(self, in_hw: Optional[Tuple[int, int]] = None,
                  config: Optional[BenchmarkConfig] = None) -> BenchmarkReport:
        """Time a first window on the card: pinned fp32 frames H2D, the
        engine, tracks and visibility D2H into pinned buffers.
        ``frames_per_iteration`` is ``step``, the new frames a window adds
        in the online loop."""
        eng = self.engine(True)
        rng = np.random.default_rng(0)
        fr = torch.from_numpy(rng.uniform(0, 1, (1, self.window, *self.spec.input_hw, 3))
                              .astype(np.float32)).pin_memory()
        q = torch.from_numpy(grid_queries(self.grid_size, *self.spec.input_hw))
        out = eng(fr, q)
        host = {k: torch.empty(out[k].shape, dtype=out[k].dtype).pin_memory()
                for k in ("tracks", "visibility")}

        def step():
            res = eng(fr, q)
            for k, buf in host.items():
                buf.copy_(res[k], non_blocking=True)

        rep = benchmark(step, device=self.device, config=config, name=self.spec.artifact_name())
        rep.frames_per_iteration = self.step
        return rep


@register("cotracker3", fidelity="converter-verified")
def cotracker3(window: int = 16, grid_size: int = 10, input_hw: tuple = (384, 512),
               precision: str = "bf16", params: Optional[Mapping[str, torch.Tensor]] = None,
               checkpoint: Optional[str] = None, model_kw: Optional[Dict[str, Any]] = None,
               device=None) -> CoTrackerPipeline:
    """CoTracker3 online point tracking (reference ``later/CoTracker3/
    infer.py:19-28``): grid queries, sliding windows of ``2 * step`` frames
    (``step = window // 2``); returns (tracks (B, T, N, 2), visibility (B,
    T, N, 1)). ``model_kw``: overrides passed to ``CoTracker3``."""
    from monocular_depth_estimation_trt_tpu_torch.models.cotracker3 import CoTracker3
    from monocular_depth_estimation_trt_tpu_torch.weights.store import resolve_weights

    device = resolve_device(device)
    spec = ModelSpec(model="cotracker3", input_hw=tuple(input_hw), precision=precision,
                     extra=(("win", window), ("grid", grid_size)))
    dtype = _plain_dtype(precision, device)
    model = _new_model(lambda: CoTracker3(**(model_kw or {})))
    resolve_weights(model, spec.artifact_name(), checkpoint=checkpoint, state_dict=params)
    return CoTrackerPipeline(spec, model.cast(device, dtype).eval(), window=window,
                             grid_size=grid_size, device=device)


# ---------------------------------------------------------------------------
# SLAM recipes (reference later/MegaSaM, later/VIPE, later/WildGS-SLAM)
# ---------------------------------------------------------------------------
# The reference vendors no code for these three staging dirs: each README is
# a clone-and-run recipe around networks served above. The systems live in
# slam/ (dense-flow LM-BA, Gaussian-splat mapping); the registry entries wire
# them to the port's flow, depth and calibration pipelines. Fidelity is
# "approximated", as in the JAX package: there is no reference graph to
# verify against, only the papers' problem definitions.


@register("megasam", fidelity="approximated")
def megasam(**kw):
    """MegaSaM casual-video structure + motion (``later/MegaSaM/README.md``;
    arXiv 2412.04463): DA disparity + RAFT flow -> keyframe LM bundle
    adjustment with focal refinement -> consistent video depth. Use
    ``slam megasam --video ...`` or ``pipe.run(frames)``."""
    from monocular_depth_estimation_trt_tpu_torch.slam.recipes import MegaSaMPipeline

    return MegaSaMPipeline(**kw)


@register("vipe", fidelity="approximated")
def vipe(**kw):
    """ViPE video pose engine (``later/VIPE/README.md``): GeoCalib
    intrinsics + flow BA + UniDepth metric promotion -> poses, intrinsics,
    metric depth. Use ``slam vipe --video ...``."""
    from monocular_depth_estimation_trt_tpu_torch.slam.recipes import ViPEPipeline

    return ViPEPipeline(**kw)


@register("wildgs_slam", fidelity="approximated")
def wildgs_slam(**kw):
    """WildGS-SLAM (``later/WildGS-SLAM/README.md``; arXiv 2504.03886):
    flow-BA tracking + uncertainty-weighted Gaussian-splat mapping, robust to
    dynamic scenes. Use ``slam wildgs_slam --video ...``."""
    from monocular_depth_estimation_trt_tpu_torch.slam.recipes import WildGSSLAMPipeline

    return WildGSSLAMPipeline(**kw)
