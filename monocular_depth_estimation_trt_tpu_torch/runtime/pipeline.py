"""Multi-stage device-resident pipelines (counterpart of the JAX package's
``runtime/pipeline.py``).

The reference's one graph of engines is VGGT's: an aggregator engine
feeding depth-head and camera-head engines, chained with device-to-device
copies on one stream so that the tokens never reach the host (reference
``VGGT/onnx2trt2.py:155-208``). A :class:`DevicePipeline` is that
structure over named tensors: each :class:`Stage` is its own
:class:`~monocular_depth_estimation_trt_tpu_torch.runtime.engine.Engine`
per input signature (on the card a captured CUDA graph, whose input copy
is the device-to-device chaining), so that heads can run or be skipped per
request; :meth:`DevicePipeline.fused` gives the whole chain as one
function, to capture as one engine.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

import torch

from monocular_depth_estimation_trt_tpu_torch.runtime.engine import Engine


@dataclasses.dataclass
class Stage:
    name: str
    fn: Callable  # tensors of ``inputs`` -> a tensor or a tuple of tensors of ``outputs``
    inputs: Sequence[str]
    outputs: Sequence[str]


def _as_tuple(result, stage: Stage) -> tuple:
    if not isinstance(result, (tuple, list)):
        result = (result,)
    if len(result) != len(stage.outputs):
        raise ValueError(f"stage {stage.name!r} returned {len(result)} outputs, "
                         f"declared {len(stage.outputs)}")
    return tuple(result)


class DevicePipeline:
    """Named-tensor dataflow over stages; the intermediates stay on the
    device. The VGGT pattern::

        pipe = DevicePipeline([
            Stage("aggregator", agg_fn, ["views"], ["tokens"]),
            Stage("depth_head", depth_fn, ["tokens"], ["depth", "depth_conf"]),
            Stage("camera_head", cam_fn, ["tokens"], ["pose_enc"]),
        ])
        out = pipe({"views": views})  # no host round trip
    """

    def __init__(self, stages: Sequence[Stage]):
        self.stages = list(stages)
        self._engines: Dict = {}

    def _run(self, stage: Stage, args: Sequence[torch.Tensor]):
        key = (stage.name, tuple((tuple(a.shape), a.dtype, a.device) for a in args))
        if key not in self._engines:
            shapes = "_".join("x".join(map(str, a.shape)) for a in args)
            self._engines[key] = Engine(
                stage.fn, [torch.empty(a.shape, dtype=a.dtype, device="meta") for a in args],
                name=f"stage_{stage.name}_{shapes}", device=args[0].device)
        return self._engines[key](*args)

    def __call__(self, feeds: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Run every stage in order on ``feeds``; returns every named tensor."""
        env = dict(feeds)
        for s in self.stages:
            env.update(zip(s.outputs, _as_tuple(self._run(s, [env[k] for k in s.inputs]), s)))
        return env

    def fused(self, output_names: Sequence[str]) -> Callable:
        """One function ``feeds -> {name: tensor}`` computing ``output_names``
        through every stage, to capture as one engine."""

        def run(feeds: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            env = dict(feeds)
            for s in self.stages:
                env.update(zip(s.outputs, _as_tuple(s.fn(*[env[k] for k in s.inputs]), s)))
            return {k: env[k] for k in output_names}

        return run

    def release_engines(self) -> None:
        for eng in self._engines.values():
            eng.release()
        self._engines.clear()
