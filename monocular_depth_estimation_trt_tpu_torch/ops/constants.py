"""Device-resident constants, built once per (values, shape, dtype, device).

A forward that rebuilt its constants (normalization statistics, resampling
matrices, the colormap table, rotary tables) from host data on every call
would make a pageable host-to-device copy each time: a cost on every frame,
and an operation that CUDA graph capture refuses. :func:`device_cached`
keeps the first result of such a function per argument tuple instead. The
cached tensors are shared by every caller: never write to one.

Inside a trace (any dispatch mode) a constant is built outside the trace's
modes, so that the cache holds a real tensor (which an exported graph keeps
as a constant), never a traced one. On fake tensors (``torch.export``) it is
built on the host and the trace moves it to the traced device: a trace for
``cuda`` may run on a host with no card, and the exporter folds the move
into the constant (``runtime/export.py``).
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence, Union

import torch
from torch.utils._pytree import tree_map_only


_IN_TRACE_BUILD = [0]  # > 0 while a constant asked for in a trace is being built


def device_cached(make: Callable) -> Callable:
    """Decorator: memoize ``make(*args)`` (hashable arguments: sizes,
    dtypes, devices). The tensors are built outside inference mode, so that
    code that records autograd may use them too, and outside any tracing
    mode: in a trace on fake tensors, on the host, and moved to the device
    of the ``torch.device`` argument in the trace."""
    from torch.utils._python_dispatch import (
        _disable_current_modes,
        _get_current_dispatch_mode_stack,
    )

    def in_trace() -> bool:
        # a constant that another one builds in a trace sees no mode (they
        # are disabled) and is in the trace all the same
        return bool(_IN_TRACE_BUILD[0] or _get_current_dispatch_mode_stack())

    @functools.lru_cache(maxsize=None)
    def cached(*args):
        if in_trace():
            # no grad-mode switch, which the trace would record
            _IN_TRACE_BUILD[0] += 1
            try:
                with _disable_current_modes():
                    return make(*args)
            finally:
                _IN_TRACE_BUILD[0] -= 1
        with torch.inference_mode(False), torch.no_grad():
            return make(*args)

    def call(*args):
        target = next((a for a in args if isinstance(a, torch.device) and a.type != "cpu"),
                      None)
        # a trace on fake tensors may have no card for the device it traces
        if target is None or torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is None:
            return cached(*args)
        host = cached(*(torch.device("cpu") if isinstance(a, torch.device) else a
                        for a in args))
        return tree_map_only(torch.Tensor, lambda t: t.to(target), host)

    functools.update_wrapper(call, make)
    return call


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
