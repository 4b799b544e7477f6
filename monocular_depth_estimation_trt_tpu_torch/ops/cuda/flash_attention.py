"""Attention straight from the packed qkv tensor (kernel K1).

Counterpart of ``monocular_depth_estimation_trt_tpu/ops/pallas/flash_attention.py``
(``flash_attention_packed`` / ``_attn_kernel_packed``): ``(B, N, 3*H*d)`` —
the qkv matmul's output, q|k|v regions each ``H*d`` wide, head-major — to
``(B, N, H*d)``, the proj matmul's input, with no per-head transposes in
memory.

On a CUDA tensor :func:`flash_attention_packed` launches the hand-written
kernel in ``csrc/flash_attention_packed.cu`` or raises; on a CPU tensor it
runs :func:`flash_attention_packed_reference`, the plain PyTorch version
with the same numerics. :func:`attention_reference` is the plain attention
of the JAX package's ``attention_reference`` (the ``attn_impl="xla"`` route).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

HEAD_DIM = 64  # the kernel's one head width: every DINOv2 encoder

_C_FUNCS = {
    torch.bfloat16: "mdet_flash_attention_packed_bf16",
    torch.float32: "mdet_flash_attention_packed_f32",
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
    if qkv.device.type == "cpu":
        return flash_attention_packed_reference(qkv, num_heads, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned")
    b, n, _ = qkv.shape
    out = torch.empty((b, n, num_heads * head_dim), dtype=qkv.dtype,
                      device=qkv.device)
    if out.numel() == 0:
        return out

    from monocular_depth_estimation_trt_tpu_torch.ops.cuda._build import library

    fn = getattr(library(), _C_FUNCS[qkv.dtype])
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(qkv.data_ptr(), out.data_ptr(), b, n, num_heads, float(scale),
                 stream)
    if err:
        raise RuntimeError(
            f"flash_attention_packed kernel launch failed: cudaError {err}"
        )
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
