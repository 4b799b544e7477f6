"""Model registry: name -> pipeline factory (counterpart of the JAX package's
``registry.py``)::

    pipe = build_pipeline("depth_anything_v2", encoder="vits")
    out = pipe(image_rgb_u8)

Ported so far: the Depth Anything family (``depth_anything_v2``,
``distill_any_depth``, ``depth_anything_ac``, ``dkt``, ``bridge``), which
shares one serving graph, ``vggt``, ``depth_pro``, the single-image
metric and point-map families ``depth_anything_v3``, ``metric3d_v2``,
``moge2`` and ``metric_anything``, the camera-aware ``unidepth_v2`` and
``unik3d``, ``sidepth``, ``geocalib`` and ``prior_depth_anything``. Every
factory takes ``device``;
``None`` means ``"cuda"``, and a missing card is an error, never a quiet
move to the CPU. ``precision="int8"`` serves the bf16 graph with the
family's encoder linears quantized (``ops/quant.py``, kernel K4),
calibrated at build time on ``calib_images`` or on
:func:`_calibration_images`.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from monocular_depth_estimation_trt_tpu_torch.config import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ModelSpec,
)
from monocular_depth_estimation_trt_tpu_torch.pipelines import (
    DepthPipeline,
    VGGTPipeline,
    depth_forward_factory,
    pointmap_forward_factory,
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


# Families with an int8 w8a8 serving path, of those the port has registered
# (dkt and bridge reach it through _build_da_family as well).
INT8_FAMILIES = frozenset({
    "depth_anything_v2", "distill_any_depth", "depth_anything_ac", "depth_pro", "vggt",
    "depth_anything_v3", "metric3d_v2", "moge2", "metric_anything", "unidepth_v2", "unik3d",
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
    ``masters`` (path -> full-precision weight and bias). No bundle is
    cached on disk yet."""
    from monocular_depth_estimation_trt_tpu_torch.ops.quant import quantize_model_bundle

    device = next(model.parameters()).device

    def samples():
        images = calib_images if calib_images is not None else _calibration_images(input_size)
        for img in images:
            yield make_sample(torch.from_numpy(np.ascontiguousarray(img)).to(device))

    quantize_model_bundle(model, masters, samples())


def _new_model(make: Callable[[], torch.nn.Module], params, checkpoint) -> torch.nn.Module:
    """``make()``. When ``params`` or ``checkpoint`` will overwrite every
    parameter (a strict load), the module is made on the meta device and
    given uninitialized CPU storage, so that the default init of up to 1.2 B
    parameters is not computed to be thrown away; random weights need the
    ordinary construction."""
    if params is None and not checkpoint:
        return make()
    with torch.device("meta"):
        model = make()
    return model.to_empty(device="cpu")


def _params_for(model: torch.nn.Module, spec: ModelSpec, *, params, checkpoint, device,
                dtype, make_sample: Callable, input_size, calib_images=None) -> torch.nn.Module:
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
    resolve_weights(model, name, checkpoint=checkpoint, state_dict=params)
    masters = full_precision(model, model.int8_targets()) if quant else None
    model = model.to(device=device, dtype=dtype).eval()
    if quant:
        _int8_bundle(model, masters, make_sample, calib_images=calib_images,
                     input_size=input_size)
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
                                               **(model_kw or {})), params, checkpoint)
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
) -> VGGTPipeline:
    """``params``: an upstream-named state dict (e.g. from
    ``weights.from_jax.vggt_from_jax``); ``vggt_cfg``: a ``VGGTConfig``
    override (tests)."""
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
        # the depth-only and with-camera variants have different weights
        variant="" if with_camera else "depth",
    )
    # int8 = w8a8 aggregator serving; calibrated on S=1 views (the scales
    # are per layer, so S > 1 serving reuses them)
    dtype = _dtype_for(precision, device)
    model = _params_for(
        _new_model(lambda: VGGT(cfg, attn_impl, with_camera), params, checkpoint), spec,
        params=params, checkpoint=checkpoint,
        device=device, dtype=dtype,
        make_sample=lambda img: preprocess_pad_square(img[None], input_size)[:, None],
        input_size=input_size, calib_images=calib_images)

    def forward(img_u8: torch.Tensor, out_hw):
        """Pad to square, S=1 through the model, crop the padding, resample
        to the frame (reference ``VGGT/onnx2trt.py:80-110, 184-189``)."""
        single = img_u8.dim() == 3
        x = preprocess_pad_square(img_u8[None] if single else img_u8, input_size)
        out = model(x[:, None])
        crop = (slice(None), 0, *_square_crop(out_hw, input_size))
        result = {
            "depth": upsample_depth(out["depth"][crop], out_hw, clamp=(1e-3, 1e3)),
            "depth_conf": upsample_depth(out["depth_conf"][crop], out_hw, clamp=None),
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

    return VGGTPipeline(spec, forward, views_forward, device=device, model=model,
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
    model = _new_model(lambda: DepthPro(attn_impl=attn_impl, **(model_kw or {})), params,
                       checkpoint)
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
                                                           **(model_kw or {})), params, checkpoint),
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
                                                      attn_impl=attn_impl, **(model_kw or {})),
                                   params, checkpoint),
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
                                                 attn_impl=attn_impl, **(model_kw or {})),
                                   params, checkpoint),
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
                                                               **(model_kw or {})),
                                   params, checkpoint),
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
    model = _params_for(_new_model(lambda: SIDepth(encoder, attn_impl, **(model_kw or {})),
                                   params, checkpoint),
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
    model = _params_for(_new_model(lambda: GeoCalib(encoder, attn_impl, **(model_kw or {})),
                                   params, checkpoint),
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
    vggt = _new_model(lambda: VGGT(vggt_cfg or VGGTConfig(), attn_impl, with_camera=False),
                      vggt_sd, vggt_checkpoint)
    refiner = _new_model(lambda: PriorDARefiner(encoder, attn_impl, **(model_kw or {})),
                         refiner_sd, checkpoint)
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
