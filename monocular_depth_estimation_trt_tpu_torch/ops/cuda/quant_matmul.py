"""Fused static-scale int8 matmul, kernel K4 (counterpart of
``monocular_depth_estimation_trt_tpu/ops/pallas/quant_matmul.py``).

:func:`w8a8_matmul` computes, in one kernel (CUDA source
``csrc/w8a8_matmul.cu``)::

    xq  = clip(round(x * qmul), -127, 127)     int8, qmul per input channel
    acc = xq @ weight_q.T                      int8 x int8 -> int32
    out = acc * out_scale (+ bias)             fp32, cast to the output type

with ``weight_q`` in ``nn.Linear``'s ``(N, K)`` layout. On a CUDA tensor it
launches the kernel or raises; on a CPU tensor it runs the plain version,
:func:`w8a8_matmul_reference`, which computes the same numbers bit for bit.
Both activation types (bf16 for int8 serving, fp32 for the parity route)
run one persistent TMA + wgmma GEMM whose consumer warpgroups quantize each
landed x tile straight into the register A operand of the int8 wgmma; the
fp32 form writes its output with TMA stores.

The launch is the operator ``torch.ops.mdet.w8a8_matmul`` on ``(M, K)``
activations, so that ``torch.export`` keeps the kernel in a graph
(``runtime/export.py``): its CPU implementation is the plain version, its
CUDA implementation the ctypes launch (counted in the wrapper's
``launches``), its fake implementation the output's shape and type. The
wrapper's checks, the flattening to 2-D and the K padding stay outside it,
as traced tensor code.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from monocular_depth_estimation_trt_tpu_torch.ops.cuda import autotune

QMAX = 127.0
K_ALIGN = 16  # the kernel's K granule: one 16-byte row of int8 weight

_C_FUNCS = {
    torch.bfloat16: "mdet_w8a8_matmul_bf16",
    torch.float32: "mdet_w8a8_matmul_f32",
}


def _check(x, weight_q, qmul, out_scale, bias) -> None:
    if weight_q.dim() != 2 or weight_q.dtype != torch.int8:
        raise TypeError(f"weight_q must be an (N, K) int8 tensor, got {weight_q.dtype} "
                        f"{tuple(weight_q.shape)}")
    n, k = weight_q.shape
    if k < 1:
        raise ValueError(f"weight_q must have K >= 1 columns, got shape {tuple(weight_q.shape)}")
    if x.dim() < 1 or x.shape[-1] != k:
        raise ValueError(f"x must be (..., {k}), got shape {tuple(x.shape)}")
    for name, t, size in (("qmul", qmul, k), ("out_scale", out_scale, n), ("bias", bias, n)):
        if t is None:
            continue
        if t.shape != (size,) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a ({size},) float32 tensor, got {t.dtype} "
                            f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if weight_q.device != x.device:
        raise ValueError(f"weight_q on {weight_q.device}, x on {x.device}")


def w8a8_matmul(x: torch.Tensor, weight_q: torch.Tensor, qmul: torch.Tensor,
                out_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``(..., K) -> (..., N)``: ``x`` bf16 or fp32, ``weight_q`` (N, K)
    int8, ``qmul`` (K,), ``out_scale`` and ``bias`` (N,) fp32. Any M, K,
    N >= 1.

    A CUDA tensor launches K4 on the current stream (counted in
    ``w8a8_matmul.launches``); its output type is the type of ``x``, and
    another ``out_dtype`` raises. A K that is no multiple of 16 is
    zero-padded to one first. A CPU tensor goes to the plain version."""
    _check(x, weight_q, qmul, out_scale, bias)
    out_dtype = out_dtype or x.dtype
    n, k = weight_q.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if x.device.type == "cuda":
        if x.dtype not in _C_FUNCS:
            raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
        if out_dtype != x.dtype:
            raise TypeError(f"the kernel writes the type of x ({x.dtype}), not {out_dtype}")
        x2 = x2.contiguous()
        weight_q, qmul, out_scale = (t.contiguous() for t in (weight_q, qmul, out_scale))
        if k % K_ALIGN:
            # the weight's TMA map needs rows of a multiple of 16 bytes: zero
            # columns add nothing to the int32 sum (no model layer has such a K)
            pad = K_ALIGN - k % K_ALIGN
            x2, weight_q, qmul = (F.pad(t, (0, pad)) for t in (x2, weight_q, qmul))
        if bias is not None:
            bias = bias.contiguous()
    elif x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    out = torch.ops.mdet.w8a8_matmul(x2, weight_q, qmul, out_scale, bias, out_dtype)
    return out.reshape(*lead, n)


@torch.library.custom_op("mdet::w8a8_matmul", mutates_args=(), device_types="cpu")
def _k4_op(x: torch.Tensor, weight_q: torch.Tensor, qmul: torch.Tensor,
           out_scale: torch.Tensor, bias: Optional[torch.Tensor],
           out_dtype: torch.dtype) -> torch.Tensor:
    return w8a8_matmul_reference(x, weight_q, qmul, out_scale, bias, out_dtype)


@_k4_op.register_fake
def _(x, weight_q, qmul, out_scale, bias, out_dtype):
    return x.new_empty((x.shape[0], weight_q.shape[0]), dtype=out_dtype)


@_k4_op.register_kernel("cuda")
def _(x, weight_q, qmul, out_scale, bias, out_dtype):
    # the kernel reads x, weight_q and qmul from 16-byte aligned addresses
    x, weight_q, qmul = (t.clone() if t.data_ptr() % 16 else t for t in (x, weight_q, qmul))
    m, k = x.shape
    n = weight_q.shape[0]
    if m * n == 0:
        return torch.empty((m, n), dtype=x.dtype, device=x.device)

    from monocular_depth_estimation_trt_tpu_torch.ops.cuda._build import library

    fn = getattr(library(), _C_FUNCS[x.dtype])

    def launch(tile_n):
        out = torch.empty((m, n), dtype=x.dtype, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(x.data_ptr(), weight_q.data_ptr(), qmul.data_ptr(), out_scale.data_ptr(),
                     None if bias is None else bias.data_ptr(), out.data_ptr(),
                     m, n, k, tile_n, stream)
        if err:
            raise RuntimeError(f"w8a8_matmul kernel launch failed (tile width {tile_n}): "
                               f"cudaError {err}")
        return out

    tile_n = autotune.tile_for(
        "w8a8_matmul", x.dtype, (m, n, k), x.device, k, launch,
        lambda: w8a8_matmul_reference(x, weight_q, qmul, out_scale, bias, out_dtype))
    out = launch(tile_n)
    w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0


def w8a8_matmul_reference(x: torch.Tensor, weight_q: torch.Tensor, qmul: torch.Tensor,
                          out_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version of K4, the same numbers bit for bit: the
    quantize step in fp32, rounding half to even (``jnp.round``'s rule);
    the quantized product in float64, which holds every int32 sum exactly
    (|acc| <= 127^2 * K), on the CPU and on the card alike; its conversion
    to fp32 rounds as the kernel's int32 -> fp32 does; then the rescale and
    the bias as two separate fp32 roundings."""
    xq = torch.clamp(torch.round(x.float() * qmul), -QMAX, QMAX)
    acc = torch.matmul(xq.double(), weight_q.double().t())
    y = acc.float() * out_scale
    if bias is not None:
        y = y + bias
    return y.to(out_dtype or x.dtype)
