"""Profiling and tracing helpers (counterpart of the JAX package's
``runtime/profiler.py``).

The reference's observability is TensorRT's DETAILED profiling verbosity
plus wall-clock loops (``Depth_Anything_V2/onnx2trt.py:40,199-204``). Here
:func:`trace` records ``torch.profiler`` CPU and CUDA activity around a
block into a Chrome trace (open it in Perfetto or ``chrome://tracing``): on
the card it names every kernel launched, the port's own (K1 to K4) among
them; :class:`StageTimer` accumulates named wall-clock sections.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from monocular_depth_estimation_trt_tpu_torch.utils.logging import log


@contextlib.contextmanager
def trace(logdir: str = "mdet_trace"):
    """Record a trace around a block::

        with profiler.trace("traces/") as path:
            engine(frame)

    Yields the path of the Chrome trace written into ``logdir`` when the
    block ends (``trace_<pid>_<time>.json``); CUDA activity is recorded
    where a card is available."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    log(f"trace written -> {path} (open with Perfetto or chrome://tracing)")


class StageTimer:
    """Accumulating named wall-clock sections (the reference's dual FPS
    counters, ``Depth_Pro/onnx2trt_webcam.py:104,151``). ``sync``: a tensor
    (or a dict, list or tuple of them) on the card to wait for before the
    section's clock stops."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def section(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            leaves = sync.values() if isinstance(sync, dict) else (
                sync if isinstance(sync, (list, tuple)) else [sync])
            devices = {t.device for t in leaves
                       if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
            for device in devices:
                torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict:
        return {
            name: {
                "total_s": round(t, 4),
                "count": self.counts[name],
                "avg_ms": round(t / self.counts[name] * 1e3, 3),
            }
            for name, t in self.totals.items()
        }

    def print(self):
        for name, row in self.report().items():
            log(f"{name}: {row['avg_ms']:.2f} ms avg over {row['count']}")
