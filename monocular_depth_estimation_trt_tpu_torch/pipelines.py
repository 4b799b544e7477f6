"""End-to-end depth pipeline: decode on the host, everything else on the card
(counterpart of the JAX package's ``pipelines.py``).

One uint8 RGB frame goes to the device; preprocess, model, upsample + clamp
and the optional colormap run there, eagerly under ``torch.inference_mode()``.
The forward of each (H, W) is built once and cached under its artifact name,
in the role of the JAX package's compiled ``Engine``s.

Public layouts follow the JAX package: uint8 ``(H, W, 3)`` in, depth
``(H, W)`` float32 out, viz ``(H, W, 3)`` uint8; ``batch_call`` adds a
leading frame axis.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from monocular_depth_estimation_trt_tpu_torch.config import BenchmarkConfig, ModelSpec
from monocular_depth_estimation_trt_tpu_torch.ops.colormap import turbo_colormap
from monocular_depth_estimation_trt_tpu_torch.ops.postprocess import (
    inverse_depth_normalize,
    normalize_depth_for_viz,
    upsample_depth,
)
from monocular_depth_estimation_trt_tpu_torch.runtime.benchmark import (
    BenchmarkReport,
    benchmark,
)


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
                 viz: str = "relative"):  # "relative" | "metric" | "none"
        self.spec = spec
        self.device = torch.device(device)
        self.model = model
        self._forward = forward
        self.viz = viz
        self._engines: Dict[str, Callable] = {}

    def _with_viz_epilogue(self, out: Dict[str, torch.Tensor], with_viz: bool):
        """Colormap epilogue shared by single-frame and batched calls; the
        normalizations work frame by frame."""
        if with_viz and self.viz != "none" and "depth" in out:
            if self.viz == "metric":
                norm = inverse_depth_normalize(out["depth"])
            else:
                norm = normalize_depth_for_viz(out["depth"])
            out["viz"] = turbo_colormap(norm)
        return out

    def _run(self, img: torch.Tensor, in_hw: Tuple[int, int], with_viz: bool):
        with torch.inference_mode():
            return self._with_viz_epilogue(self._forward(img, in_hw), with_viz)

    def engine_for(self, in_hw: Tuple[int, int], with_viz: bool = False) -> Callable:
        """The cached forward for frames of size ``in_hw``."""
        name = f"{self.spec.artifact_name()}_in{in_hw[0]}x{in_hw[1]}" + (
            "_viz" if with_viz else "")
        if name not in self._engines:
            self._engines[name] = functools.partial(
                self._run, in_hw=tuple(in_hw), with_viz=with_viz)
        return self._engines[name]

    def _to_device(self, frames) -> torch.Tensor:
        if isinstance(frames, torch.Tensor):
            return frames.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)

    @staticmethod
    def _to_host(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in out.items()}

    def __call__(self, image_u8, *, viz: bool = False,
                 device_out: bool = False) -> Dict[str, Any]:
        """image_u8: (H, W, 3) RGB uint8 (numpy or tensor). Returns a dict of
        host numpy outputs (device tensors if ``device_out``)."""
        h, w = image_u8.shape[:2]
        out = self.engine_for((h, w), viz)(self._to_device(image_u8))
        return out if device_out else self._to_host(out)

    def batch_call(self, frames, *, viz: bool = False, device_out: bool = False):
        """frames: (B, H, W, 3) RGB uint8 -> dict of stacked outputs; the
        viz of each frame is normalized by that frame's own range."""
        h, w = frames.shape[1:3]
        out = self.engine_for((h, w), viz)(self._to_device(frames))
        return out if device_out else self._to_host(out)

    def benchmark(self, in_hw: Tuple[int, int],
                  config: Optional[BenchmarkConfig] = None) -> BenchmarkReport:
        """Time the whole per-frame path on the card: uint8 H2D from a pinned
        host buffer, preprocess + model + postprocess, depth D2H into a
        pinned host buffer."""
        eng = self.engine_for(tuple(in_hw), False)
        rng = np.random.default_rng(0)
        frame = rng.integers(0, 255, size=(in_hw[0], in_hw[1], 3), dtype=np.uint8)
        host_in = torch.from_numpy(frame).pin_memory()
        host_out = torch.empty(tuple(in_hw), dtype=torch.float32).pin_memory()

        def step():
            dev = host_in.to(self.device, non_blocking=True)
            host_out.copy_(eng(dev)["depth"], non_blocking=True)

        return benchmark(step, device=self.device, config=config,
                         name=self.spec.artifact_name())


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
