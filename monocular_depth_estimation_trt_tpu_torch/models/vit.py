"""DINOv2-style Vision Transformer encoder (counterpart of the JAX package's
``models/vit.py``).

Module and parameter names follow the upstream DINOv2 checkpoints
(``patch_embed.proj``, ``blocks.N.attn.qkv``, ``blocks.N.ls1.gamma`` ...), so
an upstream ``state_dict`` loads with a plain ``load_state_dict``. Images
come in channels-last, ``(B, H, W, 3)``, as in the JAX package.

Parameters are held in the compute dtype: the pipeline casts the whole
module with ``.to(dtype)``. ``F.layer_norm`` takes its statistics in fp32 for
bf16 inputs and returns bf16, as Flax's ``LayerNorm(dtype=bf16)`` does.

Attention routes (``attn_impl``), the same on every device (on a CPU
tensor each kernel wrapper runs its plain version):

* ``"auto"``: a non-rope attention of many short heads, ``B*H >= 256`` and
  ``N <= 1024`` (Depth Pro's 35 windows x 16 heads of 577 tokens), goes to
  the whole-row kernel K3: the regime in which the JAX package runs its
  batched kernel. Every other non-rope attention of head_dim 64 goes to the
  packed-qkv kernel K1, ViT-S included; another head_dim to K2, which
  zero-pads it;
* ``"packed"``: every non-rope attention through K1;
* ``"flash"``, and every rope attention whatever ``attn_impl`` other than
  ``"xla"``: the ``(B, H, N, d)`` kernel K2, after the rotation of q and k.
  The TPU's head-count and length gates for K1 and K2 are v5e findings and
  are not carried over;
* ``"xla"``: plain attention equal to the JAX package's
  ``attention_reference`` (the caller's explicit choice).

The kernels are in ``ops/cuda/flash_attention.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from monocular_depth_estimation_trt_tpu_torch.ops.cuda.flash_attention import (
    BATCHED_MAX_N,
    HEAD_DIM,
    attention_reference,
    flash_attention,
    flash_attention_batched,
    flash_attention_packed,
)
from monocular_depth_estimation_trt_tpu_torch.ops.constants import device_cached
from monocular_depth_estimation_trt_tpu_torch.ops.resize import resample_tensor


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    dim: int
    depth: int
    num_heads: int
    patch_size: int = 14
    mlp_ratio: float = 4.0
    ffn: str = "mlp"  # "mlp" | "swiglu"
    num_register_tokens: int = 0
    pretrain_img_size: int = 518
    layerscale_init: float = 1e-5
    qkv_bias: bool = True
    # DINOv3-style 2D axial RoPE on the patch tokens of every attention
    rope: bool = False
    rope_base: float = 100.0
    pos_embed: bool = True

    @property
    def pretrain_grid(self) -> int:
        return self.pretrain_img_size // self.patch_size


# The four DINOv2 encoder sizes (reference Depth_Anything_V2/infer.py:48-53).
VIT_CONFIGS = {
    "vits": ViTConfig(dim=384, depth=12, num_heads=6),
    "vitb": ViTConfig(dim=768, depth=12, num_heads=12),
    "vitl": ViTConfig(dim=1024, depth=24, num_heads=16),
    "vitg": ViTConfig(dim=1536, depth=40, num_heads=24, ffn="swiglu"),
}


def swiglu_hidden(dim: int, mlp_ratio: float = 4.0) -> int:
    """DINOv2 SwiGLUFFNFused hidden width: 2/3 * 4d rounded up to 8."""
    h = int(dim * mlp_ratio)
    return (int(h * 2 / 3) + 7) // 8 * 8


# "auto" sends a non-rope attention of at least this many (batch x head)
# problems of at most BATCHED_MAX_N tokens to K3 (the JAX package's
# many-small-heads regime, ops/pallas/autotune.py::default_block).
BATCHED_MIN_HEADS = 256


def rope_2d_normalized(ph: int, pw: int, head_dim: int, base: float = 100.0,
                       device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """2D axial RoPE tables over a patch grid with coordinates normalized to
    [-1, 1] (the DINOv3 convention). Half the head dims rotate with y, half
    with x. Returns fp32 (cos, sin), each (ph*pw, head_dim//2), made once
    per arguments and shared: do not write to them."""
    return _rope_2d_normalized(ph, pw, head_dim, float(base), torch.device(device or "cpu"))


@device_cached
def _rope_2d_normalized(ph: int, pw: int, head_dim: int, base: float, device: torch.device):
    d4 = head_dim // 4
    freqs = torch.tensor(base ** (-np.arange(d4) / d4), dtype=torch.float32, device=device)
    ys = torch.arange(ph, dtype=torch.float32, device=device).repeat_interleave(pw)
    xs = torch.arange(pw, dtype=torch.float32, device=device).repeat(ph)
    ys = (ys + 0.5) / ph * 2 - 1
    xs = (xs + 0.5) / pw * 2 - 1
    ang = math.pi * torch.cat([ys[:, None] * freqs[None], xs[:, None] * freqs[None]], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def _apply_rope(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """t: (..., d); rotate (even, odd) pairs by angles (cos, sin) that
    broadcast against (..., d//2), e.g. (N, d//2) for t (..., N, d)."""
    t1, t2 = t[..., 0::2], t[..., 1::2]
    return torch.stack([t1 * cos - t2 * sin, t1 * sin + t2 * cos], dim=-1).reshape(t.shape)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_impl: str = "auto"):
        super().__init__()
        if attn_impl not in ("auto", "packed", "xla", "flash"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        self.dim = dim
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim, bias=True)

    def forward(self, x: torch.Tensor, rope=None) -> torch.Tensor:
        """``rope``: optional ((cos, sin), num_prefix), rotary tables for the
        trailing patch tokens; the ``num_prefix`` leading tokens (cls and
        registers) stay unrotated."""
        qkv = self.qkv(x)  # (B, N, 3*H*d): q | k | v, head-major
        b, n, _ = qkv.shape
        head_dim = self.dim // self.num_heads
        impl = self.attn_impl
        if rope is None and impl == "auto":
            if b * self.num_heads >= BATCHED_MIN_HEADS and n <= BATCHED_MAX_N:
                impl = "batched"
            elif head_dim == HEAD_DIM:
                impl = "packed"
        if rope is None and impl == "packed":
            return self.proj(flash_attention_packed(qkv, self.num_heads))
        # (B, H, N, d) views of the qkv output
        q, k, v = qkv.view(b, n, 3, self.num_heads, head_dim).permute(2, 0, 3, 1, 4)
        if rope is not None:
            (cos, sin), prefix = rope
            cos, sin = cos.to(q.dtype), sin.to(q.dtype)
            q, k = (torch.cat([t[:, :, :prefix], _apply_rope(t[:, :, prefix:], cos, sin)],
                              dim=2) for t in (q, k))
        if impl == "xla":
            o = attention_reference(q, k, v)
        elif impl == "batched":
            o = flash_attention_batched(q, k, v)
        else:
            o = flash_attention(q, k, v)
        return self.proj(o.transpose(1, 2).reshape(b, n, self.dim))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class SwiGLU(nn.Module):
    """DINOv2 SwiGLUFFNFused (ViT-g)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w12 = nn.Linear(dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, attn_impl: str = "auto"):
        super().__init__()
        c = cfg
        self.norm1 = nn.LayerNorm(c.dim, eps=1e-6)
        self.attn = Attention(c.dim, c.num_heads, c.qkv_bias, attn_impl)
        self.ls1 = LayerScale(c.dim, c.layerscale_init)
        self.norm2 = nn.LayerNorm(c.dim, eps=1e-6)
        if c.ffn == "swiglu":
            self.mlp = SwiGLU(c.dim, swiglu_hidden(c.dim, c.mlp_ratio))
        else:
            self.mlp = Mlp(c.dim, int(c.dim * c.mlp_ratio))
        self.ls2 = LayerScale(c.dim, c.layerscale_init)

    def forward(self, x: torch.Tensor, rope=None) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x), rope=rope))
        x = x + self.ls2(self.mlp(self.norm2(x)))
        return x


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch_size: int, in_ch: int = 3):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, dim, patch_size, patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class DinoViT(nn.Module):
    """DINOv2 encoder returning selected intermediate layers.

    ``forward(images)`` with images (B, H, W, ``in_chans``) already
    preprocessed returns a list of (patch_tokens (B, N, D), cls_token (B, D))
    for ``out_indices``, each with the final LayerNorm applied unless
    ``norm_out`` is False or the index is in ``raw_indices`` (DINOv2
    ``get_intermediate_layers``). ``in_chans`` is 3 for an image; the
    conditioned stacks of SIDepth (4) and Prior Depth Anything (6) take the
    image and their extra channels (the JAX patch embed infers it).
    """

    def __init__(self, cfg: ViTConfig, out_indices: Sequence[int] = (),
                 attn_impl: str = "auto", norm_out: bool = True,
                 raw_indices: Sequence[int] = (), in_chans: int = 3):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.out_indices = tuple(out_indices)
        self.norm_out = norm_out
        self.raw_indices = tuple(raw_indices)
        self.patch_embed = PatchEmbed(c.dim, c.patch_size, in_chans)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.dim))
        if c.pos_embed:
            n0 = c.pretrain_grid * c.pretrain_grid
            self.pos_embed = nn.Parameter(torch.zeros(1, n0 + 1, c.dim))
        if c.num_register_tokens:
            self.register_tokens = nn.Parameter(
                torch.zeros(1, c.num_register_tokens, c.dim))
        self.blocks = nn.ModuleList([Block(c, attn_impl) for _ in range(c.depth)])
        self.norm = nn.LayerNorm(c.dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        c = self.cfg
        b, h, w, _ = x.shape
        ph, pw = h // c.patch_size, w // c.patch_size
        dtype = self.cls_token.dtype

        x = x.to(dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW for the conv
        x = self.patch_embed(x).flatten(2).transpose(1, 2)  # (B, ph*pw, D)
        x = torch.cat([self.cls_token.expand(b, 1, c.dim), x], dim=1)
        if c.pos_embed:
            x = x + interpolate_pos_embed(
                self.pos_embed, c.pretrain_grid, (ph, pw)).to(dtype)
        if c.num_register_tokens:
            reg = self.register_tokens.expand(b, c.num_register_tokens, c.dim)
            x = torch.cat([x[:, :1], reg, x[:, 1:]], dim=1)

        want = [i if i >= 0 else c.depth + i
                for i in (self.out_indices or (c.depth - 1,))]
        saved = {}
        prefix = 1 + c.num_register_tokens
        rope = None
        if c.rope:
            tables = rope_2d_normalized(ph, pw, c.dim // c.num_heads, c.rope_base,
                                        device=x.device)
            rope = (tables, prefix)
        for i, blk in enumerate(self.blocks):
            x = blk(x, rope=rope)
            if i in want:
                use_norm = self.norm_out and i not in self.raw_indices
                y = self.norm(x) if use_norm else x
                saved[i] = (y[:, prefix:], y[:, 0])
        # duplicates and arbitrary order allowed (DINOv2 semantics)
        return [saved[i] for i in want]


def interpolate_pos_embed(pos_embed: torch.Tensor, pretrain_grid: int,
                          grid_hw: Tuple[int, int]) -> torch.Tensor:
    """Bicubic (Keys a=-0.75, half-pixel) interpolation of the patch-position
    table to a new grid, in fp32 (DINOv2 ``interpolate_pos_encoding``).
    Identity when the grid matches (the 518x518 path)."""
    ph, pw = grid_hw
    m = pretrain_grid
    if (ph, pw) == (m, m):
        return pos_embed
    dim = pos_embed.shape[-1]
    grid = pos_embed[0, 1:].float().reshape(m, m, dim)
    wh = resample_tensor(m, ph, "cubic", device=pos_embed.device)
    ww = resample_tensor(m, pw, "cubic", device=pos_embed.device)
    grid = torch.einsum("oh,hwd->owd", wh, grid)
    grid = torch.einsum("pw,owd->opd", ww, grid)
    out = grid.reshape(1, ph * pw, dim).to(pos_embed.dtype)
    return torch.cat([pos_embed[:, :1], out], dim=1)
