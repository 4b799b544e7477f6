"""Fused attention kernels K1, K2 and K3 (counterpart of
``monocular_depth_estimation_trt_tpu/ops/pallas/flash_attention.py``).

* K1, :func:`flash_attention_packed` (``_attn_kernel_packed``): straight
  from the qkv matmul's ``(B, N, 3*H*d)`` output — q|k|v regions each
  ``H*d`` wide, head-major — to ``(B, N, H*d)``, the proj matmul's input,
  with no per-head transposes in memory. CUDA source
  ``csrc/flash_attention_packed.cu``.
* K2, :func:`flash_attention` (``_attn_kernel``): ``(B, H, N, d)`` operands,
  for the attentions that rotate q and k before attending (2D RoPE) and for
  ``attn_impl="flash"``. CUDA source ``csrc/flash_attention.cu``.
* K3, :func:`flash_attention_batched` (``_attn_kernel_batched``): the same
  ``(B, H, N, d)`` operands in the many-short-heads regime (N <= 1024), with
  the TPU kernel's exact softmax (P divided by the row sum before its cast).
  CUDA source ``csrc/flash_attention_batched.cu``.

In bf16, K1, K2 and K3 run the Hopper mainloop of
``csrc/attention_sm90.cuh`` (TMA loads through one tensor map per operand,
wgmma, warp specialisation): K1 and K2 with an online softmax, K3 with two
passes over the keys, at head widths 64 and 128 (narrower heads are
zero-padded to one of them). The fp32 K1, K2 and K3 share the fp32 Hopper
mainloop of ``csrc/attention_sm90_f32.cuh``: the same TMA loads (fp32
boxes), a ring of K/V tiles, both products on the TF32 tensor cores as split
("3xTF32") wgmma products, accurate to fp32, in the online mode. In either
type K2 and K3 zero-pad a head wider than 128 to a multiple of 64 (the JAX
entry pads to 128: zero columns change no result) and run it on their
mainloop's wide form: the S reduction over every region of the head, the
output in chunks (256 columns in bf16, 128 in fp32), S recomputed for
each chunk. On a CUDA tensor each wrapper launches its
kernel or raises; on a CPU tensor it runs its plain PyTorch version
(:func:`flash_attention_packed_reference`, :func:`flash_attention_reference`
for K2 and K3). :func:`attention_reference` is the plain attention of the
JAX package's ``attention_reference`` (the ``attn_impl="xla"`` route).

Each launch is an operator of the ``mdet`` namespace
(``torch.ops.mdet.flash_attention_packed``, ``.flash_attention``,
``.flash_attention_batched``), so that ``torch.export`` keeps the kernels
in a graph (``runtime/export.py``): its CPU implementation is the plain
version, its CUDA implementation the ctypes launch, which counts the
wrapper's ``launches``, and its fake implementation gives the output's
shape and type. The wrappers' checks and K2/K3's zero-padding stay outside
the operators, as traced tensor code; the address checks, which a traced
tensor cannot answer, are the CUDA implementation's.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from monocular_depth_estimation_trt_tpu_torch.ops.cuda import autotune

HEAD_DIM = 64  # K1's one head width: every DINOv2 encoder and VGGT
WIDE_STEP = 64  # K2 and K3 pad a head wider than 128 to a multiple of this, in either type
BATCHED_MAX_N = 1024  # K3's regime: the TPU kernel's many short heads

_C_FUNCS = {
    torch.bfloat16: "mdet_flash_attention_packed_bf16",
    torch.float32: "mdet_flash_attention_packed_f32",
}
_K2_C_FUNCS = {
    torch.bfloat16: "mdet_flash_attention_bf16",
    torch.float32: "mdet_flash_attention_f32",
}
_K3_C_FUNCS = {
    torch.bfloat16: "mdet_flash_attention_batched_bf16",
    torch.float32: "mdet_flash_attention_batched_f32",
}


def _check(qkv: torch.Tensor, num_heads: int) -> int:
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (B, N, 3*H*d), got shape {tuple(qkv.shape)}")
    if num_heads < 1 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(
            f"last dim {qkv.shape[-1]} is not 3*H*d for H={num_heads}"
        )
    head_dim = qkv.shape[-1] // (3 * num_heads)
    if head_dim != HEAD_DIM:
        raise ValueError(f"head_dim must be {HEAD_DIM}, got {head_dim}")
    if qkv.dtype not in _C_FUNCS:
        raise TypeError(f"qkv dtype must be bfloat16 or float32, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    return head_dim


def flash_attention_packed(
    qkv: torch.Tensor, num_heads: int, scale: Optional[float] = None
) -> torch.Tensor:
    """Non-causal multi-head attention, ``(B, N, 3*H*64)`` -> ``(B, N, H*64)``.

    Takes bf16 or fp32, any B, N >= 1 and H >= 1. A CUDA tensor launches the
    kernel on the current stream (counted in ``flash_attention_packed.launches``);
    a CPU tensor goes to the plain version."""
    head_dim = _check(qkv, num_heads)
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {qkv.device}")
    return torch.ops.mdet.flash_attention_packed(qkv, num_heads, float(scale))


@torch.library.custom_op("mdet::flash_attention_packed", mutates_args=(), device_types="cpu")
def _k1_op(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    return flash_attention_packed_reference(qkv, num_heads, scale)


@_k1_op.register_fake
def _(qkv, num_heads, scale):
    b, n, three_hd = qkv.shape
    return qkv.new_empty((b, n, three_hd // 3))


@_k1_op.register_kernel("cuda")
def _(qkv, num_heads, scale):
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned")
    b, n, three_hd = qkv.shape
    if b * n * three_hd == 0:
        return torch.empty((b, n, three_hd // 3), dtype=qkv.dtype, device=qkv.device)

    from monocular_depth_estimation_trt_tpu_torch.ops.cuda._build import library

    fn = getattr(library(), _C_FUNCS[qkv.dtype])

    def launch(tile):
        out = torch.empty((b, n, three_hd // 3), dtype=qkv.dtype, device=qkv.device)
        with torch.cuda.device(qkv.device):
            stream = torch.cuda.current_stream(qkv.device).cuda_stream
            err = fn(qkv.data_ptr(), out.data_ptr(), b, n, num_heads, scale, tile, stream)
        if err:
            raise RuntimeError(
                f"flash_attention_packed kernel launch failed (tile {tile}): cudaError {err}"
            )
        return out

    tile = autotune.tile_for(
        "flash_attention_packed", qkv.dtype, (b, n, num_heads, HEAD_DIM), qkv.device, HEAD_DIM,
        launch, lambda: flash_attention_packed_reference(qkv, num_heads, scale))
    out = launch(tile)
    flash_attention_packed.launches += 1
    return out


flash_attention_packed.launches = 0


def flash_attention_packed_reference(
    qkv: torch.Tensor, num_heads: int, scale: Optional[float] = None
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with its numerics: fp32 scores
    and softmax, the exponentials cast to the operand type before P.V, fp32
    accumulation, the division by the row sum after P.V."""
    b, n, three_hd = qkv.shape
    head_dim = three_hd // 3 // num_heads
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    q, k, v = qkv.view(b, n, 3, num_heads, head_dim).unbind(2)  # (B, N, H, d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", e.to(qkv.dtype).float(), v.float())
    o = o / denom
    return o.transpose(1, 2).reshape(b, n, num_heads * head_dim).to(qkv.dtype)


def _check_bhnd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, H, N, d), got shape {tuple(t.shape)}")
    if not q.shape == k.shape == v.shape:
        raise ValueError(
            f"q, k, v shapes differ: {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if q.dtype not in _K2_C_FUNCS or not q.dtype == k.dtype == v.dtype:
        raise TypeError(
            f"q, k, v must all be bfloat16 or all float32, got {q.dtype} {k.dtype} {v.dtype}")
    if q.shape[-1] < 1:
        raise ValueError(f"head_dim must be at least 1, got shape {tuple(q.shape)}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on different devices: {q.device} {k.device} {v.device}")


def _aligned(t: torch.Tensor) -> bool:
    """Unit stride on d, and rows that load as 16-byte vectors."""
    size = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st * size % 16 == 0 for st in t.stride()[:3]))


def _kernel_head_dim(d: int) -> int:
    """The head width K2 and K3 compute ``d`` at, in either type: 64 where
    d <= 64, 128 where d <= 128, else the next multiple of 64 (their
    mainloop's wide form)."""
    if d <= HEAD_DIM:
        return HEAD_DIM
    if d <= 2 * HEAD_DIM:
        return 2 * HEAD_DIM
    return -(-d // WIDE_STEP) * WIDE_STEP


def _padded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q, k, v zero-padded on d to the width K2 and K3 compute at."""
    d = q.shape[-1]
    width = _kernel_head_dim(d)
    if d < width:
        q, k, v = (F.pad(t, (0, width - d)) for t in (q, k, v))
    return q, k, v


def _bhnd_op(name: str, c_funcs):
    """The ``mdet`` operator of K2 or K3 (their C entries share one
    signature): ``(B, H, N, w)`` operands, ``w`` a width the kernel takes on
    a card, -> a fresh ``(B, N, H, w)`` buffer. The CPU implementation is
    the plain version at any w; the CUDA one launches the kernel and counts
    the wrapper ``name`` of this module."""

    @torch.library.custom_op(f"mdet::{name}", mutates_args=(), device_types="cpu")
    def op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
        return flash_attention_reference(q, k, v, scale).transpose(1, 2).contiguous()

    @op.register_fake
    def _(q, k, v, scale):
        b, h, n, w = q.shape
        return q.new_empty((b, n, h, w))

    @op.register_kernel("cuda")
    def _(q, k, v, scale):
        b, h, n, width = q.shape
        for label, t in (("q", q), ("k", k), ("v", v)):
            if not _aligned(t):
                raise ValueError(
                    f"{label} must have unit stride on d and 16-byte aligned rows, "
                    f"got strides {t.stride()}")
        if b * h * n * width == 0:
            return torch.empty((b, n, h, width), dtype=q.dtype, device=q.device)

        from monocular_depth_estimation_trt_tpu_torch.ops.cuda._build import library

        fn = getattr(library(), c_funcs[q.dtype])

        def launch(tile):
            out = torch.empty((b, n, h, width), dtype=q.dtype, device=q.device)
            strides = (ctypes.c_int64 * 12)(
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                out.stride(0), out.stride(2), out.stride(1))
            with torch.cuda.device(q.device):
                stream = torch.cuda.current_stream(q.device).cuda_stream
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
                         b, h, n, width, scale, tile, stream)
            if err:
                raise RuntimeError(f"{name} kernel launch failed (tile {tile}): cudaError {err}")
            return out

        tile = autotune.tile_for(
            name, q.dtype, (b, h, n, width), q.device, width, launch,
            lambda: flash_attention_reference(q, k, v, scale).transpose(1, 2))
        out = launch(tile)
        globals()[name].launches += 1
        return out

    return op


_bhnd_op("flash_attention", _K2_C_FUNCS)
_bhnd_op("flash_attention_batched", _K3_C_FUNCS)


def _attend_bhnd(op, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """K2 or K3's operator on CPU or CUDA operands (padded on a card);
    returns its ``(B, N, H, d)`` output seen as ``(B, H, N, d)``."""
    d = q.shape[-1]
    if q.device.type == "cuda":
        q, k, v = _padded(q, k, v)
    elif q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    out = op(q, k, v, float(scale)).transpose(1, 2)
    return out if out.shape[-1] == d else out[..., :d]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal multi-head attention, ``(B, H, N, d)`` -> ``(B, H, N, d)``.

    bf16 or fp32, any B, H, N >= 1 and d >= 1, with the scale of the
    unpadded d, as the JAX entry does. The operands may be strided views
    (unit stride on d, 16-byte aligned rows). A CUDA tensor launches the
    kernel on the current stream (counted in ``flash_attention.launches``)
    at any d (d < 64 zero-padded to 64, 64 < d < 128 to 128, a wider d to a
    multiple of 64) and returns a ``(B, N, H, d)``
    buffer seen as ``(B, H, N, d)``, so that the reshape before the proj
    matmul is free; a CPU tensor goes to the plain version at any d."""
    _check_bhnd(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _attend_bhnd(torch.ops.mdet.flash_attention, q, k, v, scale)


flash_attention.launches = 0


def flash_attention_batched(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: Optional[float] = None) -> torch.Tensor:
    """K3: non-causal multi-head attention, ``(B, H, N, d)`` ->
    ``(B, H, N, d)``, for many short heads: N <= 1024 (the TPU kernel's
    regime), any B and H.

    K2's signature and layout rules: bf16 or fp32, any d >= 1 with the
    scale of the unpadded d (on a card zero-padded as K2 pads it),
    strided views with unit stride on d and 16-byte aligned rows, output
    written ``(B, N, H, d)`` and returned as a ``(B, H, N, d)`` view. N > 1024 raises on every device: that bound is
    the kernel's regime. A CUDA tensor launches the kernel on the current
    stream (counted in ``flash_attention_batched.launches``); a CPU tensor
    goes to the plain version, :func:`flash_attention_reference`: the two
    JAX kernels compute one function on different grids, so K2's plain
    version, with the TPU's division of P before its cast, is K3's too."""
    _check_bhnd(q, k, v)
    if q.shape[2] > BATCHED_MAX_N:
        raise ValueError(
            f"flash_attention_batched takes N <= {BATCHED_MAX_N} tokens, got shape "
            f"{tuple(q.shape)}; longer sequences go to flash_attention")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _attend_bhnd(torch.ops.mdet.flash_attention_batched, q, k, v, scale)


flash_attention_batched.launches = 0


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of K2 and K3 with the TPU kernels' numerics: fp32
    scores of the operands times ``scale``, row max, ``exp``, division by
    the row sum, P cast to the operand type, P.V accumulated in fp32, cast
    to the output type. Nothing is padded here, so no key needs a mask.
    The score matrix is updated in place to halve its memory at long N."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)).mul_(scale)
    s = s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    p = s.div_(s.sum(dim=-1, keepdim=True)).to(q.dtype)
    del s
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain attention on ``(B, H, N, d)``: scores computed in the operand
    type, softmax in fp32, P cast back before P.V (the JAX package's
    ``attention_reference``)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)
