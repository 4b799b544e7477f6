"""KV-cache causal streaming on VGGT weights (counterpart of the JAX
package's ``apps/streaming.py::VGGTStreamingSession``; the video runners and
the ``video`` command are not ported yet).

Per step ONE view runs through the aggregator; the global blocks read the
cached keys and values of the views before it (``models/streamvggt.py``),
so a step's cost does not grow with the stream. The cache is a ring of
static device buffers that each step updates in place, so that on the card
one captured CUDA graph (``runtime/engine.py``) serves every step of a
session: the step counter, the slot write and the valid-key mask live on the
device and nothing is read back on the host between steps.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from monocular_depth_estimation_trt_tpu_torch.models.streamvggt import StreamingVGGT
from monocular_depth_estimation_trt_tpu_torch.models.vggt import VGGT
from monocular_depth_estimation_trt_tpu_torch.ops.preprocess import preprocess_pad_square
from monocular_depth_estimation_trt_tpu_torch.ops.quant import QuantLinear
from monocular_depth_estimation_trt_tpu_torch.runtime.engine import Engine


def _cache_tensors(cache: Dict):
    yield from (t for kv in cache["kv"] for t in kv)
    yield cache["cam"]
    yield cache["t"]


class VGGTStreamingSession:
    """A stream of frames through a VGGT-family model, one causal step each.

    ``model``: the joint ``VGGT`` (on its device, cast), whose parameters the
    session shares; ``window``: the ring's capacity in views (a sliding
    window past it); ``epilogue``: fn(step outputs of one view, frame (H, W))
    -> dict, run inside the same captured step (the pipeline's crop,
    upsample and viz). Frames of one size share an engine; the state carries
    across sizes."""

    def __init__(self, model: VGGT, *, window: int = 4, input_size: int = 518,
                 epilogue: Optional[Callable] = None, name: str = "vggt_stream"):
        if any(isinstance(m, QuantLinear) for m in model.modules()):
            raise NotImplementedError(
                "streaming an int8 VGGT is not ported yet; build the pipeline in bf16 or fp32")
        param = next(model.parameters())
        self.device, self.dtype = param.device, param.dtype
        self.window = window
        self.input_size = input_size
        self.name = f"{name}_w{window}"
        self.model = StreamingVGGT.sharing(model, window)
        grid = (input_size // model.cfg.patch_size,) * 2
        with torch.inference_mode(False):  # reset() writes to it outside inference mode
            self._cache = self.model.init_cache(1, grid, self.dtype, self.device)
        self._epilogue = epilogue
        self._engines: Dict[Tuple[int, int], Engine] = {}

    @property
    def steps(self) -> torch.Tensor:
        """The number of steps since the last reset (a device tensor)."""
        return self._cache["t"]

    def reset(self) -> None:
        """Empty the ring (in place, so the captured graphs stay valid)."""
        with torch.no_grad():
            for t in _cache_tensors(self._cache):
                t.zero_()

    def pure_step(self, frame_u8: torch.Tensor, cache: Dict,
                  in_hw: Optional[Tuple[int, int]] = None) -> Tuple[Dict, Dict]:
        """One causal step on an explicit ``cache`` (updated in place and
        returned): the function that the session's engines capture.
        ``frame_u8``: (H, W, 3) uint8 on the session's device."""
        x = preprocess_pad_square(frame_u8[None], self.input_size)
        out = {k: v[0] for k, v in self.model.step(x, cache).items()}
        if self._epilogue is not None:
            out = self._epilogue(out, tuple(in_hw or frame_u8.shape[:2]))
        return out, cache

    def _forward(self, frame_u8: torch.Tensor, in_hw: Tuple[int, int]) -> Dict:
        return self.pure_step(frame_u8, self._cache, in_hw)[0]

    def engine_for(self, in_hw: Tuple[int, int]) -> Engine:
        """The step's engine for frames of size ``in_hw``, built now: its
        warm-up and capture run the step, so the state is saved before and
        put back after."""
        in_hw = tuple(in_hw)
        if in_hw not in self._engines:
            h, w = in_hw
            eng = Engine(functools.partial(self._forward, in_hw=in_hw),
                         (torch.empty((h, w, 3), dtype=torch.uint8, device="meta"),),
                         name=f"{self.name}_in{h}x{w}", device=self.device)
            saved = [t.clone() for t in _cache_tensors(self._cache)]
            eng.compile()
            with torch.no_grad():
                for t, s in zip(_cache_tensors(self._cache), saved):
                    t.copy_(s)
            self._engines[in_hw] = eng
        return self._engines[in_hw]

    def step(self, frame_u8) -> Dict[str, torch.Tensor]:
        """frame_u8: (H, W, 3) RGB uint8 (numpy or tensor) -> this view's
        outputs as device tensors: depth and depth_conf at the model's input
        size (or what the epilogue makes of them), world_points and
        world_points_conf with the point head, pose_enc with the camera."""
        if not isinstance(frame_u8, torch.Tensor):
            frame_u8 = torch.from_numpy(np.ascontiguousarray(frame_u8))
        return self.engine_for(frame_u8.shape[:2])(frame_u8)

    def release_engines(self) -> None:
        for eng in self._engines.values():
            eng.release()
        self._engines.clear()
