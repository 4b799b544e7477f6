"""End-to-end depth pipeline: decode on the host, everything else on the card
(counterpart of the JAX package's ``pipelines.py``).

One uint8 RGB frame goes to the device; preprocess, model, upsample + clamp
and the optional colormap run there. Each input signature is served by one
:class:`~monocular_depth_estimation_trt_tpu_torch.runtime.engine.Engine`,
keyed by the JAX package's engine names: on the card a CUDA graph captured
from the pipeline's eager forward (the role of the JAX package's compiled
programs and of the reference's TensorRT engines), on the CPU that forward
itself.

Public layouts follow the JAX package: uint8 ``(H, W, 3)`` in, depth
``(H, W)`` float32 out, viz ``(H, W, 3)`` uint8; ``batch_call`` adds a
leading frame axis. Other outputs of a forward (VGGT's confidence and
camera, Depth Pro's focal) come back beside the depth. :class:`VGGTPipeline` adds the
multi-view protocol; :class:`PairPipeline` serves a model of two frames
(Align3R), :class:`FlowPipeline` an optical-flow model of a frame pair.
The MoGe pair's forward (:func:`pointmap_forward_factory`)
holds the model and its focal/shift postprocess, so that one engine per
(H, W) and batch bucket captures both: the JAX package splits them into two
programs only because the fused one faulted a TPU worker.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from monocular_depth_estimation_trt_tpu_torch.config import BenchmarkConfig, ModelSpec
from monocular_depth_estimation_trt_tpu_torch.ops.camera import (
    normalized_view_plane_uv,
    recover_focal_shift,
)
from monocular_depth_estimation_trt_tpu_torch.ops.colormap import (
    spectral_colormap,
    turbo_colormap,
)
from monocular_depth_estimation_trt_tpu_torch.ops.flow_viz import flow_to_color
from monocular_depth_estimation_trt_tpu_torch.ops.postprocess import (
    inverse_depth_normalize,
    normalize_depth_for_viz,
    upsample_depth,
)
from monocular_depth_estimation_trt_tpu_torch.runtime.benchmark import (
    BenchmarkReport,
    benchmark,
)
from monocular_depth_estimation_trt_tpu_torch.runtime.engine import Engine
from monocular_depth_estimation_trt_tpu_torch.runtime.transfer import tree_get_chunked


class DepthPipeline:
    """Single-image depth pipeline around a (preprocess, model, postprocess)
    forward.

    Parameters
    ----------
    spec: ModelSpec for naming.
    forward: fn(image_u8 (..., H0, W0, 3) on ``device``, out_hw) -> dict of
        outputs with the same leading axes.
    device: the device the forward runs on.
    model: the ``nn.Module`` behind ``forward`` (kept for inspection).
    """

    def __init__(self, spec: ModelSpec, forward: Callable, *,
                 device: torch.device, model: Optional[torch.nn.Module] = None,
                 viz: str = "relative"):  # "relative" | "metric" | "spectral" | "none"
        self.spec = spec
        self.device = torch.device(device)
        self.model = model
        self._forward = forward
        self.viz = viz
        self._engines: Dict[str, Engine] = {}

    # -- multi-device -------------------------------------------------------
    def apply_mesh(self, mesh, rules=None) -> "DepthPipeline":
        """Shard this pipeline's modules over a device mesh (in place).

        ``rules`` defaults to this family's table
        (``parallel/sharding.py::rules_for_family``): ViT tensor parallelism
        (column-parallel qkv/fc1, row-parallel proj/fc2 over the ``model``
        axis) plus the family's decoder rules; everything else replicated.
        On a one-device mesh every placement collapses to the plain tensor:
        the same engines, graphs and kernel launches as without a mesh. With
        more devices each tensor-parallel layer, or pair of layers, takes a
        replicated input and gives a replicated output (the collectives run
        inside it), so the engines capture as usual. Engines built before
        are dropped."""
        if mesh is None:
            return self
        from monocular_depth_estimation_trt_tpu_torch.parallel.sharding import (
            rules_for_family,
        )
        from monocular_depth_estimation_trt_tpu_torch.utils.logging import log

        rules = rules or rules_for_family(getattr(self.spec, "model", None))
        for module in self.export_modules().values():
            rules.apply(mesh, module)
        self.release_engines()
        self.mesh = mesh
        log(f"params sharded over mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        return self

    def _with_viz_epilogue(self, out: Dict[str, torch.Tensor], with_viz: bool):
        """Colormap epilogue shared by single-frame and batched calls; the
        normalizations work frame by frame."""
        if with_viz and self.viz != "none" and "depth" in out:
            if self.viz == "metric":
                norm = inverse_depth_normalize(out["depth"])
            else:
                norm = normalize_depth_for_viz(out["depth"])
            # the DINOv3 depther's figures use Spectral, every other model turbo
            colormap = spectral_colormap if self.viz == "spectral" else turbo_colormap
            out["viz"] = colormap(norm)
        return out

    def _eager(self, img: torch.Tensor, in_hw: Tuple[int, int], with_viz: bool):
        return self._with_viz_epilogue(self._forward(img, in_hw), with_viz)

    def _run(self, img: torch.Tensor, in_hw: Tuple[int, int], with_viz: bool):
        """The eager forward that the engines capture (one call, no graph)."""
        with torch.inference_mode():
            return self._eager(img, in_hw, with_viz)

    def _engine(self, name: str, fn: Callable, shape) -> Engine:
        if name not in self._engines:
            example = torch.empty(shape, dtype=torch.uint8, device="meta")
            self._engines[name] = Engine(fn, (example,), name=name, device=self.device)
        return self._engines[name]

    def engine_for(self, in_hw: Tuple[int, int], with_viz: bool = False) -> Engine:
        """The engine for one frame of size ``in_hw``."""
        h, w = in_hw
        name = f"{self.spec.artifact_name()}_in{h}x{w}" + ("_viz" if with_viz else "")
        return self._engine(name, functools.partial(self._eager, in_hw=(h, w),
                                                    with_viz=with_viz), (h, w, 3))

    def batch_engine_for(self, in_hw: Tuple[int, int], batch: int,
                         with_viz: bool = False) -> Engine:
        """The engine for a batch of ``batch`` frames (B, H, W, 3): the
        throughput-serving mode (the reference pins batch 1); the viz of
        each frame is normalized by that frame's own range."""
        h, w = in_hw
        name = (f"{self.spec.artifact_name()}_in{h}x{w}_b{batch}"
                + ("_viz" if with_viz else ""))
        return self._engine(name, functools.partial(self._eager, in_hw=(h, w),
                                                    with_viz=with_viz), (batch, h, w, 3))

    def release_engines(self) -> None:
        """Drop every engine and, on the card, its graph's memory."""
        for eng in self._engines.values():
            eng.release()
        self._engines.clear()

    def export_modules(self) -> Dict[str, torch.nn.Module]:
        """The modules that the forward runs, whose tensors an exported
        artifact stores once (``runtime/export.py``)."""
        return {"model": self.model} if self.model is not None else {}

    @staticmethod
    def _as_tensor(frames) -> torch.Tensor:
        if isinstance(frames, torch.Tensor):
            return frames
        return torch.from_numpy(np.ascontiguousarray(frames))

    def __call__(self, image_u8, *, viz: bool = False,
                 device_out: bool = False) -> Dict[str, Any]:
        """image_u8: (H, W, 3) RGB uint8 (numpy or tensor). Returns a dict of
        host numpy outputs (device tensors if ``device_out``)."""
        h, w = image_u8.shape[:2]
        out = self.engine_for((h, w), viz)(self._as_tensor(image_u8))
        return out if device_out else tree_get_chunked(out)

    def batch_call(self, frames, *, viz: bool = False, device_out: bool = False):
        """frames: (B, H, W, 3) RGB uint8 -> dict of stacked outputs; the
        viz of each frame is normalized by that frame's own range."""
        b, h, w = frames.shape[:3]
        out = self.batch_engine_for((h, w), b, viz)(self._as_tensor(frames))
        return out if device_out else tree_get_chunked(out)

    def benchmark(self, in_hw: Tuple[int, int],
                  config: Optional[BenchmarkConfig] = None) -> BenchmarkReport:
        """Time the whole per-frame path on the card: uint8 H2D from a pinned
        host buffer, preprocess + model + postprocess, the depth (for a model
        without one, as GeoCalib, every output) D2H into pinned host
        buffers."""
        eng = self.engine_for(tuple(in_hw), False)
        rng = np.random.default_rng(0)
        frame = rng.integers(0, 255, size=(in_hw[0], in_hw[1], 3), dtype=np.uint8)
        pinned = self.device.type == "cuda"
        host_in = torch.from_numpy(frame)
        host_in = host_in.pin_memory() if pinned else host_in
        # the outputs' own sizes (the MoGe pair answers at its input size)
        out = eng(host_in)
        keys = ["depth"] if "depth" in out else sorted(out)
        host_out = {k: torch.empty(out[k].shape, dtype=out[k].dtype, pin_memory=pinned)
                    for k in keys}

        def step():  # the engine queues the H2D copy into its static input
            res = eng(host_in)
            for k, buf in host_out.items():
                buf.copy_(res[k], non_blocking=True)

        return benchmark(step, device=self.device, config=config,
                         name=self.spec.artifact_name())


class VGGTPipeline(DepthPipeline):
    """The single-image pipeline plus the multi-view (S-axis) protocol: one
    forward over S views with cross-view global attention.

    ``views_forward``: fn(views_u8 (S, H, W, 3) on ``device``) -> dict of
    per-view outputs (depth and depth_conf (S, h, w), pose_enc (S, 9))."""

    def __init__(self, spec: ModelSpec, forward: Callable, views_forward: Callable, *,
                 device: torch.device, model: Optional[torch.nn.Module] = None,
                 viz: str = "metric"):
        super().__init__(spec, forward, device=device, model=model, viz=viz)
        self._views_forward = views_forward

    def views_engine(self, s: int, src_hw: Optional[Tuple[int, int]] = None) -> Engine:
        """The engine for ``s`` views of size ``src_hw`` (default: the
        model's input size): fn(views_u8 (S, H, W, 3)) -> dict. Each (S,
        size) is an engine of its own, as in the JAX package."""
        h, w = tuple(src_hw or self.spec.input_hw)
        name = f"{self.spec.artifact_name()}_views{s}_{h}x{w}"
        return self._engine(name, self._views_forward, (s, h, w, 3))

    def multi_view(self, views_u8, *, device_out: bool = False) -> Dict[str, Any]:
        """views_u8: (S, H, W, 3) RGB uint8 -> depth and depth_conf (S, 518,
        518), pose_enc (S, 9), as host numpy (device tensors if
        ``device_out``)."""
        s, h, w = views_u8.shape[:3]
        out = self.views_engine(s, (h, w))(self._as_tensor(views_u8))
        return out if device_out else tree_get_chunked(out)

    def benchmark_views(self, s: int,
                        config: Optional[BenchmarkConfig] = None) -> BenchmarkReport:
        """Per-frame throughput of the S-view engine on device-resident
        uint8 views (tokens scale with S; global attention is quadratic in
        S·tokens)."""
        rng = np.random.default_rng(0)
        views = torch.from_numpy(
            rng.integers(0, 255, (s, *self.spec.input_hw, 3), dtype=np.uint8)).to(self.device)
        eng = self.views_engine(s)
        rep = benchmark(lambda: eng(views), device=self.device, config=config,
                        name=f"{self.spec.artifact_name()}_s{s}")
        rep.frames_per_iteration = s
        return rep


def depth_forward_factory(
    model: Callable,
    preprocess: Callable,
    *,
    clamp: Optional[Tuple[float, float]] = (1e-3, 1e3),
) -> Callable:
    """Standard single-depth-output forward: preprocess -> model ->
    upsample(align_corners=True) to the input size -> clamp (reference
    ``Depth_Anything_V2/onnx2trt.py:208-211``). Takes one frame (H, W, 3)
    or a batch (B, H, W, 3)."""

    def forward(img_u8: torch.Tensor, out_hw: Tuple[int, int]):
        single = img_u8.dim() == 3
        x = preprocess(img_u8[None] if single else img_u8)  # (B, h, w, 3)
        depth = upsample_depth(model(x), out_hw, clamp=clamp)  # (B, H, W)
        return {"depth": depth[0] if single else depth}

    return forward


def pointmap_postprocess(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """MoGe's postprocess on the device (reference ``MoGe_2/onnx2trt.py:169-206``,
    the JAX package's ``registry._build_moge``): recover the focal and z
    shift from the affine-invariant points where the mask exceeds 0.5,
    shift z, re-unproject on the view-plane grid, scale by the metric
    scale, and set the depth and points outside the mask (or behind the
    camera) to inf, the normal there to 0. Batched: (B, H, W, ...) in and
    out, the focal and scale (B,)."""
    points = out["points"]
    mask = out["mask"] > 0.5
    focal, shift = recover_focal_shift(points, mask)
    z = points[..., 2] + shift[:, None, None]
    mask = mask & (z > 0)
    uv = normalized_view_plane_uv(points.shape[1], points.shape[2], points.dtype,
                                  points.device)
    pts = torch.cat([uv[None] * z[..., None] / focal[:, None, None, None], z[..., None]],
                    dim=-1)
    scale = out["metric_scale"]
    pts = pts * scale[:, None, None, None]
    inf = float("inf")
    result = {"depth": torch.where(mask, z * scale[:, None, None], inf),
              "points": torch.where(mask[..., None], pts, inf),
              "mask": mask, "metric_scale": scale, "focal": focal}
    if "normal" in out:
        result["normal"] = torch.where(mask[..., None], out["normal"], 0.0)
    return result


def pointmap_forward_factory(model: Callable, preprocess: Callable) -> Callable:
    """The MoGe pair's forward: preprocess -> model -> :func:`pointmap_postprocess`,
    one program. Takes one frame (H, W, 3) or a batch (B, H, W, 3); the
    outputs are at the model's input size whatever ``out_hw``."""

    def forward(img_u8: torch.Tensor, out_hw: Tuple[int, int]):
        single = img_u8.dim() == 3
        result = pointmap_postprocess(model(preprocess(img_u8[None] if single else img_u8)))
        return {k: v[0] for k, v in result.items()} if single else result

    return forward


class PairPipeline:
    """Two-image pipeline (the JAX package's ``Align3RPipeline``):
    ``pipe(frame1, frame2)`` -> dict of host outputs. One engine per frame
    size holds both images' whole forward.

    ``forward``: fn(frame1_u8, frame2_u8 (H, W, 3) on ``device``) -> dict;
    ``model`` and ``prior``: the modules it runs (Align3R and its frozen
    depth prior), kept for inspection."""

    timed_output = "depth"  # what ``benchmark`` fetches

    def __init__(self, spec: ModelSpec, forward: Callable, *, device: torch.device,
                 model: Optional[torch.nn.Module] = None,
                 prior: Optional[torch.nn.Module] = None):
        self.spec = spec
        self.device = torch.device(device)
        self.model = model
        self.prior = prior
        self._forward = forward
        self._engines: Dict[Tuple[int, int], Engine] = {}

    def _run(self, frame1: torch.Tensor, frame2: torch.Tensor):
        """The eager forward that the engines capture (one call, no graph)."""
        with torch.inference_mode():
            return self._forward(frame1, frame2)

    def engine_for(self, in_hw: Tuple[int, int]) -> Engine:
        """The engine for two frames of size ``in_hw``."""
        h, w = in_hw
        if (h, w) not in self._engines:
            example = torch.empty((h, w, 3), dtype=torch.uint8, device="meta")
            self._engines[(h, w)] = Engine(self._forward, (example, example),
                                           name=f"{self.spec.artifact_name()}_in{h}x{w}",
                                           device=self.device)
        return self._engines[(h, w)]

    def release_engines(self) -> None:
        for eng in self._engines.values():
            eng.release()
        self._engines.clear()

    def export_modules(self) -> Dict[str, torch.nn.Module]:
        """The modules that the forward runs (``runtime/export.py``)."""
        return {k: m for k, m in (("model", self.model), ("prior", self.prior))
                if m is not None}

    def __call__(self, frame1, frame2, *, device_out: bool = False) -> Dict[str, Any]:
        if tuple(frame1.shape) != tuple(frame2.shape):
            raise ValueError(f"the two frames differ in size: {tuple(frame1.shape)} and "
                             f"{tuple(frame2.shape)}")
        eng = self.engine_for(tuple(frame1.shape[:2]))
        out = eng(DepthPipeline._as_tensor(frame1), DepthPipeline._as_tensor(frame2))
        return out if device_out else tree_get_chunked(out)

    def benchmark(self, in_hw: Optional[Tuple[int, int]] = None,
                  config: Optional[BenchmarkConfig] = None) -> BenchmarkReport:
        """Time a pair on the card: two pinned uint8 frames in, the engine,
        the depth (a flow model's flow) D2H into a pinned buffer."""
        h, w = tuple(in_hw or self.spec.input_hw)
        eng = self.engine_for((h, w))
        rng = np.random.default_rng(0)
        frames = [torch.from_numpy(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).pin_memory()
                  for _ in range(2)]
        out = eng(*frames)[self.timed_output]
        host_out = torch.empty(out.shape, dtype=out.dtype).pin_memory()

        def step():
            host_out.copy_(eng(*frames)[self.timed_output], non_blocking=True)

        return benchmark(step, device=self.device, config=config,
                         name=self.spec.artifact_name())



class FlowPipeline(PairPipeline):
    """Two-frame optical flow (the JAX package's ``FlowPipeline``; the
    RAFT / NeuFlow / MeFlow / WAFT template, reference
    ``RAFT/onnx2trt.py:150-196``): a frame pair in, the flow at the model's
    input size and, with ``viz``, its color-wheel image out, computed on the
    card. One engine per (frame size, viz).

    ``forward``: fn(frame1_u8, frame2_u8 (H, W, 3) on ``device``) -> dict
    with ``flow`` (h, w, 2) (and ``flow_low``); ``model``: the module it
    runs, kept for inspection."""

    timed_output = "flow"

    def _eager(self, frame1: torch.Tensor, frame2: torch.Tensor, with_viz: bool = False):
        out = self._forward(frame1, frame2)
        if with_viz:
            out["viz"] = flow_to_color(out["flow"])
        return out

    def _run(self, frame1: torch.Tensor, frame2: torch.Tensor, with_viz: bool = False):
        """The eager forward that the engines capture (one call, no graph)."""
        with torch.inference_mode():
            return self._eager(frame1, frame2, with_viz)

    def engine_for(self, in_hw: Tuple[int, int], with_viz: bool = False) -> Engine:
        """The engine for two frames of size ``in_hw``."""
        key = (tuple(in_hw), bool(with_viz))
        if key not in self._engines:
            h, w = key[0]
            example = torch.empty((h, w, 3), dtype=torch.uint8, device="meta")
            name = f"{self.spec.artifact_name()}_in{h}x{w}" + ("_viz" if with_viz else "")
            self._engines[key] = Engine(functools.partial(self._eager, with_viz=key[1]),
                                        (example, example), name=name, device=self.device)
        return self._engines[key]

    def __call__(self, frame1, frame2, *, viz: bool = False,
                 device_out: bool = False) -> Dict[str, Any]:
        """frame1, frame2: (H, W, 3) RGB uint8 -> dict of host numpy outputs
        (device tensors if ``device_out``): ``flow`` (h, w, 2) at the
        model's input size, ``flow_low`` where the model has it, ``viz``."""
        if tuple(frame1.shape) != tuple(frame2.shape):
            raise ValueError(f"the two frames differ in size: {tuple(frame1.shape)} and "
                             f"{tuple(frame2.shape)}")
        eng = self.engine_for(tuple(frame1.shape[:2]), viz)
        out = eng(DepthPipeline._as_tensor(frame1), DepthPipeline._as_tensor(frame2))
        return out if device_out else tree_get_chunked(out)
