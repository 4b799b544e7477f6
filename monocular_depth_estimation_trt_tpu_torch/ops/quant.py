"""Int8 (w8a8) serving with static calibration (counterpart of the JAX
package's ``ops/quant.py``).

The JAX package threads a ``quant=`` mode through every module; here the
model stays as it is and two passes act on its ``nn.Linear`` layers:

* :func:`calibrate` records, with forward pre-hooks, the per-input-channel
  absmax of each target layer's input over the calibration samples
  (max-reduced across calls; the JAX ``calib`` mode);
* :func:`build_q8` turns a layer's full-precision weight and those
  statistics into the int8 serving artifacts with SmoothQuant smoothing at
  alpha = 0.5 (Xiao et al. 2023), the JAX rule exactly;
* :func:`install_q8` swaps each target for a :class:`QuantLinear`, which
  holds the int8 weight and the fp32 scales and bias, and runs kernel K4
  (``ops/cuda/quant_matmul.py``). The bf16 weight goes with the swapped
  layer: one copy of each quantized weight stays on the card.

:func:`quantize_model_bundle` chains the three. The JAX ``qat`` mode waits
for the training port.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch
import torch.nn as nn

from monocular_depth_estimation_trt_tpu_torch.ops.cuda.quant_matmul import QMAX, w8a8_matmul


class QuantLinear(nn.Module):
    """Serve-mode int8 ``nn.Linear``: ``y = w8a8_matmul(x, weight_q, qmul,
    out_scale, bias)`` in ``out_dtype``.

    ``weight_q`` is int8 (N, K), ``nn.Linear``'s weight layout (the JAX
    ``kernel_q`` transposed); ``qmul`` (K,), ``out_scale`` and ``bias`` (N,)
    are fp32, as JAX serve mode reads them, and stay fp32 when the module is
    cast: ``model.to(torch.bfloat16)`` moves them but keeps their type, and
    makes bf16 the output type, as it does the compute type of the layers
    around it."""

    def __init__(self, weight_q: torch.Tensor, qmul: torch.Tensor, out_scale: torch.Tensor,
                 bias: Optional[torch.Tensor], out_dtype: torch.dtype):
        super().__init__()
        self.out_features, self.in_features = weight_q.shape
        self.out_dtype = out_dtype
        self.register_buffer("weight_q", weight_q.to(torch.int8).contiguous())
        self.register_buffer("qmul", qmul.float().contiguous())
        self.register_buffer("out_scale", out_scale.float().contiguous())
        self.register_buffer("bias", None if bias is None else bias.float().contiguous())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return w8a8_matmul(x, self.weight_q, self.qmul, self.out_scale, self.bias,
                           self.out_dtype)

    def _apply(self, fn, recurse=True):
        fp32 = {name: b for name, b in self._buffers.items()
                if b is not None and b.dtype == torch.float32}
        self.out_dtype = fn(torch.empty(0, dtype=self.out_dtype)).dtype
        super()._apply(fn, recurse)
        for name, b in fp32.items():
            moved = self._buffers[name]
            if moved.dtype != torch.float32:  # a cast: move the fp32 buffer instead
                self._buffers[name] = b.to(moved.device)
        return self

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"bias={self.bias is not None}, out_dtype={self.out_dtype}")


def quantize_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of an (N, K) weight: returns
    (weight_q (N, K) int8, w_scale (N,) fp32)."""
    w = weight.float()
    w_scale = torch.clamp(w.abs().amax(dim=1), min=1e-8) / QMAX
    weight_q = torch.clamp(torch.round(w / w_scale[:, None]), -QMAX, QMAX).to(torch.int8)
    return weight_q, w_scale


def build_q8(weight: torch.Tensor, absmax: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One layer's serving artifacts from its full-precision (N, K) weight
    and the per-input-channel absmax of its input (K,).

    SmoothQuant, alpha = 0.5: ``s_k = sqrt(absmax_k) / sqrt(max_n |W[n, k]|)``
    (1 where either is 0, clipped to [1e-4, 1e4]) moves activation outliers
    into the weight; the smoothed weight ``W * s`` quantizes per output
    channel; the smoothed activations take the scale ``a = max_k(absmax_k /
    s_k) / 127`` (1 for a layer that never fired). Returns ``weight_q``,
    ``qmul = 1 / (s * a)`` and ``out_scale = a * w_scale``."""
    w = weight.float()
    ch = absmax.float().reshape(w.shape[1])
    w_row = w.abs().amax(dim=0)  # (K,)
    one = torch.ones((), dtype=torch.float32, device=w.device)
    s = torch.where((ch > 0) & (w_row > 0),
                    torch.sqrt(ch) / torch.sqrt(torch.clamp(w_row, min=1e-12)), one)
    s = torch.clamp(s, 1e-4, 1e4)
    weight_q, w_scale = quantize_weight(w * s[None, :])
    smoothed_max = torch.max(ch / s)
    a = torch.where(smoothed_max > 0, smoothed_max / QMAX, one)
    return {"weight_q": weight_q, "qmul": 1.0 / (s * a), "out_scale": a * w_scale}


@torch.no_grad()
def calibrate(model: nn.Module, targets: Iterable[str], samples: Iterable) -> Dict[str, torch.Tensor]:
    """Run ``model`` over ``samples`` (model inputs, a tuple for several
    arguments) and return, for each
    target ``nn.Linear`` path, the per-input-channel absmax of its input in
    fp32, max-reduced over every call; zeros for a layer that never ran."""
    stats: Dict[str, torch.Tensor] = {}
    hooks = []

    def record(name):
        def hook(_module, args):
            x = args[0]
            cur = x.abs().amax(dim=tuple(range(x.dim() - 1))).float()
            torch.maximum(stats[name], cur, out=stats[name])
        return hook

    for name in targets:
        lin = model.get_submodule(name)
        if not isinstance(lin, nn.Linear):
            raise TypeError(f"{name} is a {type(lin).__name__}, not an nn.Linear")
        stats[name] = torch.zeros(lin.in_features, dtype=torch.float32, device=lin.weight.device)
        hooks.append(lin.register_forward_pre_hook(record(name)))
    try:
        for sample in samples:
            model(*sample) if isinstance(sample, tuple) else model(sample)
    finally:
        for h in hooks:
            h.remove()
    return stats


def install_q8(model: nn.Module, q8: Mapping[str, Mapping[str, torch.Tensor]]) -> nn.Module:
    """Replace each ``nn.Linear`` at a path of ``q8`` by a
    :class:`QuantLinear` of that entry's ``weight_q``, ``qmul`` and
    ``out_scale``, on the layer's device, writing the layer's compute type;
    the bias is the entry's ``bias`` where it has one, else the layer's."""
    for path, entry in q8.items():
        lin = model.get_submodule(path)
        if not isinstance(lin, nn.Linear):
            raise TypeError(f"{path} is a {type(lin).__name__}, not an nn.Linear")
        bias = entry["bias"] if "bias" in entry else lin.bias
        dev = lin.weight.device
        q = QuantLinear(entry["weight_q"].to(dev), entry["qmul"].to(dev),
                        entry["out_scale"].to(dev), None if bias is None else bias.to(dev),
                        out_dtype=lin.weight.dtype)
        parent, _, child = path.rpartition(".")
        setattr(model.get_submodule(parent) if parent else model, child, q)
    return model


def quantize_model_bundle(model: nn.Module,
                          targets: Mapping[str, Tuple[torch.Tensor, Optional[torch.Tensor]]],
                          samples: Iterable) -> nn.Module:
    """Calibrate ``model`` (in its compute type, on its device) over
    ``samples``, then swap every target for a :class:`QuantLinear` built
    from the full-precision weight and bias given for it in ``targets``
    (path -> (weight, bias), as held before the model was cast; the JAX
    package quantizes its fp32 params). In place; returns ``model``."""
    stats = calibrate(model, targets, samples)
    q8 = {}
    for path, (weight, bias) in targets.items():
        dev = stats[path].device
        q8[path] = build_q8(weight.to(dev), stats[path])
        q8[path]["bias"] = None if bias is None else bias.to(dev)
    return install_q8(model, q8)


def linear_paths(model: nn.Module, *roots: str):
    """The paths of every ``nn.Linear`` under the submodules ``roots``."""
    return [name for name, m in model.named_modules()
            if isinstance(m, nn.Linear) and name.split(".")[0] in roots]


def full_precision(model: nn.Module, paths: Iterable[str]):
    """path -> (weight, bias) of the ``nn.Linear`` layers at ``paths``: the
    tensors themselves, to read before a cast replaces them."""
    out = {}
    for path in paths:
        lin = model.get_submodule(path)
        out[path] = (lin.weight.detach(), None if lin.bias is None else lin.bias.detach())
    return out
