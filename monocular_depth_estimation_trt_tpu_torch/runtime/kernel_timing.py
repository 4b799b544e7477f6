"""The kernel yardstick: what one call of a function costs the card and the
host, on a CUDA device.

- :func:`device_ms`: the card's time per call. CUDA events around ``iters``
  back-to-back calls queued behind a spin kernel (``torch.cuda._sleep``)
  twice as long as the host took to issue them, so that the card runs them
  one after the other whatever a call costs the host (a small kernel behind
  its tensor-map encodes). The card's gaps between launches count, the
  host's time does not. This is the time a kernel gate is judged on.
- :func:`event_ms`: CUDA events around ``iters`` back-to-back calls, issued
  as fast as the host can. Where a call's host time exceeds its kernel's,
  it reads the host's pace, not the kernel's.
- :func:`host_us`: the host's time per call, the card busy behind it: what
  a wrapper costs (checks, argument packing, tensor maps, the launch).

Each returns the median of its repeats. ``chip_smoke.py`` imports this
module; ``scripts/torch_kernel_ab.py`` loads it by path from its own
checkout, so that every checkout it compares is timed the same way.
Imports only torch.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch

# the most cycles a second that the spin kernel may count: the H100's top clock
SPIN_HZ = 2e9


def event_ms(fn: Callable[[], object], iters: int = 50, repeats: int = 1,
             warmup: int = 5) -> float:
    """ms per call from CUDA events around back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ms(fn: Callable[[], object], iters: int = 20, repeats: int = 3) -> float:
    """The card's ms per call, the host's time hidden behind a spin kernel."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_cycles = int(2 * issue_s * SPIN_HZ) + 100_000
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def host_us(fn: Callable[[], object], calls: int = 20) -> float:
    """The host's median µs per call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6
