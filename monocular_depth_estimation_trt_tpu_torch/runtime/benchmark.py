"""Warmup + timed-loop benchmark protocol on the card (counterpart of the
JAX package's ``runtime/benchmark.py``).

``benchmark(step)`` runs ``step()`` — one whole iteration, e.g. H2D +
forward + D2H — ``warmup`` times, then times ``iterations`` back-to-back
calls between two CUDA events (the device executes every frame; the host
only enqueues), then a separate pass of ``latency_iterations`` calls, each
ended by ``torch.cuda.synchronize()`` and timed on the host clock, for
p50/p99. It measures only on a CUDA device and raises anywhere else.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from monocular_depth_estimation_trt_tpu_torch.config import BenchmarkConfig
from monocular_depth_estimation_trt_tpu_torch.utils.logging import log


@dataclasses.dataclass
class BenchmarkReport:
    name: str
    iterations: int
    total_seconds: float
    times: List[float]
    h2d_ms: Optional[float] = None
    d2h_ms: Optional[float] = None
    mode: str = "sync"
    # frames produced per iteration; ``fps`` is per frame
    frames_per_iteration: int = 1
    # per-iteration synchronised latencies from the separate latency pass
    latency_times: Optional[List[float]] = None

    @property
    def avg_seconds(self) -> float:
        return self.total_seconds / max(self.iterations, 1)

    @property
    def fps(self) -> float:
        if self.avg_seconds <= 0:
            return float("inf")
        return self.frames_per_iteration / self.avg_seconds

    @property
    def avg_ms(self) -> float:
        return self.avg_seconds * 1000.0

    def _measured_times(self) -> Optional[List[float]]:
        if self.mode == "sync" and self.times:
            return self.times
        return self.latency_times or None

    def percentile_ms(self, q: float) -> Optional[float]:
        ts = self._measured_times()
        if not ts:
            return None
        return float(np.percentile(np.asarray(ts), q) * 1000.0)

    def print(self) -> None:
        """Reference-format report (``onnx2trt.py:214-217``)."""
        log(f"{self.iterations} iterations time: {self.total_seconds:.4f} [sec]")
        if self.frames_per_iteration > 1:
            log(
                f"Average FPS: {self.fps:.2f} [fps] "
                f"({self.frames_per_iteration} frames/iteration)"
            )
        else:
            log(f"Average FPS: {self.fps:.2f} [fps]")
        log(f"Average inference time: {self.avg_ms:.2f} [msec]")
        p50 = self.percentile_ms(50)
        if self.mode == "pipelined" and p50 is not None:
            log(
                f"sync-mode latency: p50 {p50:.2f} / p99 "
                f"{self.percentile_ms(99):.2f} [msec] "
                f"({len(self.latency_times)} measured iterations)"
            )

    def to_dict(self):
        return {
            "name": self.name,
            "iterations": self.iterations,
            "total_seconds": self.total_seconds,
            "fps": self.fps,
            "avg_ms": self.avg_ms,
            "frames_per_iteration": self.frames_per_iteration,
            "mode": self.mode,
            "p50_ms": self.percentile_ms(50),
            "p99_ms": self.percentile_ms(99),
            "h2d_ms": self.h2d_ms,
            "d2h_ms": self.d2h_ms,
        }


def benchmark(
    step: Callable[[], object],
    *,
    device: torch.device,
    config: Optional[BenchmarkConfig] = None,
    name: str = "model",
) -> BenchmarkReport:
    """Run the protocol against ``step()`` on CUDA ``device``."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"benchmark measures on a CUDA device, got {device}")
    config = config or BenchmarkConfig()
    with torch.cuda.device(device):
        for _ in range(config.warmup):
            step()
        torch.cuda.synchronize()

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(config.iterations):
            step()
        end.record()
        torch.cuda.synchronize()
        total = start.elapsed_time(end) / 1e3

        latency_times: List[float] = []
        for _ in range(min(config.latency_iterations, config.iterations)):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            latency_times.append(time.perf_counter() - t0)
    return BenchmarkReport(
        name=name,
        iterations=config.iterations,
        total_seconds=total,
        times=[],
        mode="pipelined",
        latency_times=latency_times,
    )
