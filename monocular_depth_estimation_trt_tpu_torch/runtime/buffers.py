"""Named input/output buffers over pinned host memory (counterpart of the
JAX package's ``runtime/buffers.py``).

API of the reference's pinned-memory runtime (``common_runtime.py``):
``HostDeviceMem`` pairs a pinned host array with a device allocation
(``:43-89``), ``allocate_buffers`` walks an engine's IO tensors
(``:94-143``), and ``do_inference`` does async H2D -> execute -> async D2H
-> stream sync (``:164-188``). Here a :class:`DeviceBuffer` is a pinned host
tensor and a device tensor of one shape and dtype; both copies are queued on
the current stream without waiting, and ``d2h(sync=True)`` waits once.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def _torch_dtype(dtype: Any) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


class DeviceBuffer:
    """One named IO tensor: a pinned host mirror and a device tensor.

    Assign ``.host`` then call ``.h2d()``; read back with ``.d2h()``. On a
    CPU device the host mirror is an ordinary tensor and the copies are
    plain copies."""

    def __init__(self, shape: Sequence[int], dtype: Any, *, name: str = "",
                 device=None):
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.dtype = _torch_dtype(dtype)
        self.device_type = torch.device(device or "cuda")
        pin = self.device_type.type == "cuda"
        self._host = torch.zeros(self.shape, dtype=self.dtype, pin_memory=pin)
        self._device: Optional[torch.Tensor] = None

    # -- host side --------------------------------------------------------
    @property
    def host(self) -> np.ndarray:
        return self._host.numpy()

    @host.setter
    def host(self, data) -> None:
        arr = np.asarray(data)
        if arr.size != self._host.numel():
            raise ValueError(
                f"buffer {self.name!r}: size mismatch {arr.size} vs {self._host.numel()}")
        self._host.copy_(torch.from_numpy(np.ascontiguousarray(arr).reshape(self.shape))
                         .to(self.dtype))

    # -- transfers --------------------------------------------------------
    def h2d(self) -> torch.Tensor:
        """Host -> device copy queued on the current stream (reference
        ``cudaMemcpyAsync`` H2D, ``common_runtime.py:167``)."""
        if self._device is None:
            self._device = torch.empty(self.shape, dtype=self.dtype, device=self.device_type)
        self._device.copy_(self._host, non_blocking=True)
        return self._device

    def set_device(self, tensor: torch.Tensor) -> None:
        """Adopt a device tensor produced by an engine (keeps data on the
        device, the D2D chaining of ``VGGT/onnx2trt2.py:201-205``)."""
        self._device = tensor

    @property
    def device(self) -> torch.Tensor:
        if self._device is None:
            return self.h2d()
        return self._device

    def d2h(self, *, sync: bool = True) -> np.ndarray:
        """Device -> host copy queued on the current stream; ``sync`` waits
        for it."""
        if self._device is None:
            return self.host
        self._host.copy_(self._device.reshape(self.shape), non_blocking=True)
        if sync and self.device_type.type == "cuda":
            torch.cuda.current_stream(self.device_type).synchronize()
        return self.host

    def free(self) -> None:
        """Release the device tensor (``free_buffers``, reference
        ``common_runtime.py:147-152``)."""
        self._device = None


class IOBinding:
    """Named input and output buffers for one engine: construct from
    signature dicts, assign ``.inputs[name].host``, :meth:`run` the engine,
    read ``.outputs[name]`` (reference ``allocate_buffers``,
    ``common_runtime.py:94-143``)."""

    def __init__(self, input_sig: Dict[str, Tuple[Sequence[int], Any]],
                 output_sig: Dict[str, Tuple[Sequence[int], Any]], device=None):
        self.inputs = {n: DeviceBuffer(s, d, name=n, device=device)
                       for n, (s, d) in input_sig.items()}
        self.outputs = {n: DeviceBuffer(s, d, name=n, device=device)
                        for n, (s, d) in output_sig.items()}

    def h2d_all(self):
        return [b.h2d() for b in self.inputs.values()]

    def run(self, engine) -> Dict[str, np.ndarray]:
        """H2D -> execute -> D2H -> one sync (``do_inference``,
        ``common_runtime.py:164-188``). The engine returns a tensor, a
        sequence of tensors in the order of the outputs, or a dict keyed by
        output name."""
        results = engine(*self.h2d_all())
        if isinstance(results, dict):
            results = [results[n] for n in self.outputs]
        elif not isinstance(results, (tuple, list)):
            results = (results,)
        for buf, t in zip(self.outputs.values(), results):
            buf.set_device(t)
        out = {n: b.d2h(sync=False) for n, b in self.outputs.items()}
        if any(b.device_type.type == "cuda" for b in self.outputs.values()):
            torch.cuda.current_stream().synchronize()
        return out

    def free(self) -> None:
        for b in list(self.inputs.values()) + list(self.outputs.values()):
            b.free()
