"""Captured engines: the card's counterpart of a TensorRT engine (and of the
JAX package's ``runtime/engine.py``, an AOT-compiled program per shape).

Reference behavior being replaced (``Depth_Anything_V2/onnx2trt.py:24-85``):
an engine is built once for fixed input shapes and then executed with
preallocated device buffers. Here an :class:`Engine` is one
``torch.cuda.CUDAGraph`` per input signature: ``compile()`` runs the
function eagerly a few times on a side stream (which builds the kernels,
reads the per-device launch facts, creates the cuBLAS handles and fills the
device-constant caches, none of which a capture may do), then captures one
call with static input and output tensors. A call copies its inputs into
the static inputs, replays the graph on the caller's current stream and
returns copies of the static outputs, made on that stream, so that a result
outlives the next replay (the server dispatches group N before it fetches
group N-1).

On a CPU device there is no graph: the engine calls the function under
``torch.inference_mode()``. A failed capture raises; nothing falls back to
eager execution on the card.

:class:`EngineRegistry` keeps the JAX package's human-readable record of
built engines (one JSON file per engine name under the cache directory).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from monocular_depth_estimation_trt_tpu_torch.config import cache_dir
from monocular_depth_estimation_trt_tpu_torch.utils.logging import log

WARMUP_CALLS = 2  # eager calls before the capture


def _launch_counters() -> Dict[str, Callable]:
    """The kernel wrappers whose ``launches`` count their kernels' launches
    (K3, K1, K2, K4)."""
    from monocular_depth_estimation_trt_tpu_torch.ops.cuda import flash_attention as fa
    from monocular_depth_estimation_trt_tpu_torch.ops.cuda import quant_matmul as qm

    return {"flash_attention_batched": fa.flash_attention_batched,
            "flash_attention_packed": fa.flash_attention_packed,
            "flash_attention": fa.flash_attention, "w8a8_matmul": qm.w8a8_matmul}


def _launches() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _launch_counters().items()}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


class Engine:
    """One function of device tensors at fixed input shapes.

    Parameters
    ----------
    fn:
        Function of tensors returning a tensor or a dict/list/tuple of
        tensors; it must allocate no host memory for the device and read no
        device value on the host (a capture refuses both).
    example_args:
        Tensors fixing the input signature (shape and dtype; ``meta``
        tensors will do); their values are not used.
    name:
        Registry key; the pipelines use ``ModelSpec.artifact_name()`` plus
        the input size, the JAX package's keys.
    device:
        Where the engine runs (default: the device of the first example).
    """

    def __init__(self, fn: Callable, example_args: Sequence[torch.Tensor], *,
                 name: str = "engine", device=None):
        self.name = name
        self._fn = fn
        self._example = tuple(example_args)
        if not self._example or not all(isinstance(a, torch.Tensor) for a in self._example):
            raise TypeError("example_args must be one or more tensors")
        self.device = torch.device(device) if device is not None else self._example[0].device
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"engine {name!r}: no CUDA device is available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"engine {name!r}: unsupported device {self.device}")
        self.build_seconds: Optional[float] = None
        # kernel launches made by the captured call (the replays make the
        # same launches on the device but go through no wrapper)
        self.captured_launches: Optional[Dict[str, int]] = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._static_in: Optional[tuple] = None
        self._static_out: Any = None
        self._compiled = False

    # -- build ------------------------------------------------------------
    def compile(self) -> "Engine":
        """Warm up and capture now (the reference's engine build)."""
        if self._compiled:
            return self
        log(f"Build engine ({self.name})")
        begin = time.perf_counter()
        if self.device.type == "cuda":
            self._capture()
        self.build_seconds = time.perf_counter() - begin
        self._compiled = True
        log(f"Engine build done! ({self.build_seconds:.2f} [sec])")
        try:
            EngineRegistry().record(self)
        except OSError as e:  # the registry is metadata; the engine is built
            log(f"engine registry write failed: {e!r}", tag="WARN")
        return self

    def _capture(self) -> None:
        with torch.cuda.device(self.device):
            self._static_in = tuple(torch.zeros(a.shape, dtype=a.dtype, device=self.device)
                                    for a in self._example)
            caller = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(caller)
            with torch.cuda.stream(side), torch.inference_mode():
                for _ in range(WARMUP_CALLS):
                    self._fn(*self._static_in)
            caller.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            before = _launches()
            # thread_local: other threads (a server's handlers) may keep
            # working while this one captures
            with torch.inference_mode(), torch.cuda.graph(
                    graph, stream=side, capture_error_mode="thread_local"):
                self._static_out = self._fn(*self._static_in)
            after = _launches()
            caller.wait_stream(side)
        self.captured_launches = {k: after[k] - before[k] for k in after}
        self._graph = graph

    # -- execution --------------------------------------------------------
    def __call__(self, *args):
        """Outputs of ``fn(*args)``; on the card, fresh tensors that the next
        call does not overwrite."""
        if not self._compiled:
            self.compile()
        if len(args) != len(self._example):
            raise TypeError(f"engine {self.name!r} takes {len(self._example)} arguments, "
                            f"got {len(args)}")
        for a, ex in zip(args, self._example):
            if tuple(a.shape) != tuple(ex.shape) or a.dtype != ex.dtype:
                raise ValueError(
                    f"engine {self.name!r} was built for {tuple(ex.shape)} {ex.dtype}, "
                    f"got {tuple(a.shape)} {a.dtype}")
        if self._graph is None:
            with torch.inference_mode():
                return self._fn(*(a.to(self.device) for a in args))
        with torch.cuda.device(self.device):
            for dst, src in zip(self._static_in, args):
                dst.copy_(src, non_blocking=True)
            self._graph.replay()
            return _tree_map(lambda t: t.clone(), self._static_out)

    def static_outputs(self):
        """The capture's own output tensors, which every replay overwrites
        (for tests that poison them before a replay; they are inference
        tensors, written under ``torch.inference_mode()``)."""
        if not self._compiled:
            self.compile()
        return self._static_out

    def release(self) -> None:
        """Drop the graph and its memory pool."""
        self._graph = self._static_in = self._static_out = None
        self._compiled = False

    # -- introspection ----------------------------------------------------
    def io_signature(self):
        return [{"shape": list(a.shape), "dtype": str(a.dtype).replace("torch.", "")}
                for a in self._example]


class EngineRegistry:
    """Human-readable record of built engines (JSON files under the cache
    directory), as the JAX package's: what was built, for which shapes, and
    how long the build took. The graphs themselves live in the process."""

    def __init__(self, root: Optional[str] = None):
        self.root = root or os.path.join(cache_dir(), "engines")
        os.makedirs(self.root, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.root, f"{name}.json")

    def record(self, engine: Engine) -> str:
        backend = "cpu"
        if engine.device.type == "cuda":
            backend = f"cuda ({torch.cuda.get_device_name(engine.device)})"
        entry = {
            "name": engine.name,
            "build_seconds": engine.build_seconds,
            "inputs": engine.io_signature(),
            "backend": backend,
            "torch_version": torch.__version__,
            "captured_launches": engine.captured_launches,
            "timestamp": time.time(),
        }
        p = self.path(engine.name)
        tmp = f"{p}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(entry, f, indent=2)
        os.replace(tmp, p)  # atomic: a concurrent reader sees all or nothing
        return p

    def load(self, name: str):
        p = self.path(name)
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)

    def list(self):
        return sorted(
            os.path.splitext(f)[0] for f in os.listdir(self.root) if f.endswith(".json")
        )
