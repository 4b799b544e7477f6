"""Device-resident constants, built once per (values, shape, dtype, device).

A forward that rebuilt its constants (normalization statistics, resampling
matrices, the colormap table, rotary tables) from host data on every call
would make a pageable host-to-device copy each time: a cost on every frame,
and an operation that CUDA graph capture refuses. :func:`device_cached`
keeps the first result of such a function per argument tuple instead. The
cached tensors are shared by every caller: never write to one. A constant
first asked for inside a ``torch.export`` trace is built outside the
trace's modes, so that the cache holds a real tensor (which the exported
graph keeps as a constant), never a traced one.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence, Union

import torch


def device_cached(make: Callable) -> Callable:
    """Decorator: memoize ``make(*args)`` (hashable arguments: sizes,
    dtypes, devices). The tensors are built outside inference mode, so that
    code that records autograd may use them too, and outside any tracing
    mode."""
    from torch.utils._python_dispatch import (
        _disable_current_modes,
        _get_current_dispatch_mode_stack,
    )

    @functools.lru_cache(maxsize=None)
    def cached(*args):
        if _get_current_dispatch_mode_stack():
            # inside a trace: no grad-mode switch, which the trace would record
            with _disable_current_modes():
                return make(*args)
        with torch.inference_mode(False), torch.no_grad():
            return make(*args)

    functools.update_wrapper(cached, make)
    return cached


@device_cached
def _constant(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def device_constant(values: Union[float, Sequence[float]], dtype: torch.dtype,
                    device) -> torch.Tensor:
    """``torch.tensor(values, dtype, device)``, made once per arguments: a
    float gives a 0-d tensor, a sequence a 1-d one."""
    key = (tuple(float(v) for v in values) if isinstance(values, (list, tuple))
           else float(values))
    return _constant(key, dtype, torch.device(device))
