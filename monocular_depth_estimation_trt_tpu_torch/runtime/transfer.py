"""Host <-> device transfers (counterpart of the JAX package's
``runtime/transfer.py``).

The JAX package splits large transfers into chunks to get past a remote
TPU link's cliff; a card on PCIe has no such cliff, so under the same names
a transfer here is one copy through pinned host memory: the host-to-device
copy is queued without waiting, and a fetch queues its device-to-host
copies and then waits once. :func:`tree_fetch_async` splits a fetch in two
(queue now, wait later), which lets a server queue group N's copies right
after its launch and wait for them after launching group N+1.
"""

from __future__ import annotations

import inspect
from typing import Any, Optional

import numpy as np
import torch


def supports_device_out(fn) -> bool:
    """True if ``fn(..., device_out=True)`` is accepted: the serving
    surfaces use this one probe to pick the pipelined dispatch/fetch path.
    Works for plain functions and callable instances."""
    try:
        return "device_out" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


def device_put_chunked(arr, device=None) -> torch.Tensor:
    """A host array (numpy or tensor) on ``device`` (default: the current
    CUDA device), through one pinned buffer and a copy queued on the current
    stream. A CPU ``device`` returns a CPU tensor."""
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(arr))
    device = torch.device(device or "cuda")
    if device.type == "cpu" or t.device == device:
        return t.to(device)
    if t.device.type == "cpu" and not t.is_pinned():
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


class _Fetch:
    """Device-to-host copies in flight: :meth:`result` waits for them."""

    def __init__(self, tree, event: Optional[torch.cuda.Event]):
        self._tree = tree
        self._event = event

    def result(self):
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return _map(lambda t: t.numpy() if isinstance(t, torch.Tensor) else t, self._tree)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def tree_fetch_async(tree) -> _Fetch:
    """Queue the copy of every CUDA tensor of ``tree`` (a dict, list or
    tuple of tensors, arrays and scalars) into pinned host memory on the
    current stream, and record an event after them. ``.result()`` waits for
    that event and returns the tree with numpy arrays in place of tensors."""
    event = None

    def start(x: Any):
        nonlocal event
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach()
        if x.device.type != "cuda":
            return x.cpu()
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        if event is None:
            event = torch.cuda.Event()
        return host

    host_tree = _map(start, tree)
    if event is not None:
        event.record()
    return _Fetch(host_tree, event)


def tree_get_chunked(tree):
    """The host copy of ``tree``: numpy arrays in place of tensors, after
    one wait for the copies."""
    return tree_fetch_async(tree).result()
