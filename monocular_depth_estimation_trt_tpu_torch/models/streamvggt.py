"""StreamVGGT: causal KV-cache streaming over the VGGT aggregator
(counterpart of the JAX package's ``models/streamvggt.py``).

Per new view, the frame blocks run on that view's tokens (kernel K2, one
view at a time) and the global blocks attend to the cached keys and values
of the views before it and of itself, so a step's cost does not grow with
the stream. Stepping with the cache computes the view-causal VGGT
(``VGGTConfig(causal=True)``) on the whole sequence, as long as the stream
fits the window; past it the oldest view's slots are overwritten (a sliding
window). RoPE is per view, so evicting a view leaves the other slots valid.

The cache is a set of static device buffers that a step updates in place:
the step counter ``t`` is a device tensor, the slot write an
``index_copy_`` at ``(t mod W) * n`` on the device and the valid-key mask
``arange(C) < min(t + 1, W) * n`` is computed there too, so that no step
reads a value on the host and one captured CUDA graph serves every step of
a window. The cached attention takes a mask, which no kernel does: it runs
plain (fp32 scores and softmax), as in the JAX package.

Submodule names are ``VGGT``'s (``aggregator.patch_embed``,
``aggregator.frame_blocks.i``, ``aggregator.global_blocks.i``,
``depth_head``, ``point_head``, ``camera_head``): one state dict serves the
joint and the streaming model, and :meth:`StreamingVGGT.sharing` builds one
on the very tensors of a joint model: an int8 joint model's
``QuantLinear`` layers (kernel K4) are the streaming model's too, so that
its calibrated scales serve every step, as the JAX session serves the
pipeline's ``{"params", "q8"}`` bundle.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from monocular_depth_estimation_trt_tpu_torch.models.vggt import (
    AASubBlock,
    RopeAttention,
    VGGT,
    VGGTConfig,
    masked_attention,
)
from monocular_depth_estimation_trt_tpu_torch.ops.quant import QuantLinear


def init_stream_cache(cfg: VGGTConfig, batch: int, grid_hw: Tuple[int, int], max_views: int,
                      dtype: torch.dtype = torch.bfloat16, device=None) -> Dict:
    """Zeroed per-global-layer K/V ring buffers (B, H, max_views * n_view, d)
    in ``dtype``, the camera-token ring (B, max_views, 2 * dim) in fp32 and
    the step counter ``t`` (a 0-d int64), all on ``device``."""
    ph, pw = grid_hw
    n_view = 1 + cfg.num_register_tokens + ph * pw
    hd = cfg.dim // cfg.num_heads
    shape = (batch, cfg.num_heads, max_views * n_view, hd)
    return {
        "kv": [(torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device)) for _ in range(cfg.depth)],
        "cam": torch.zeros((batch, max_views, 2 * cfg.dim), dtype=torch.float32, device=device),
        "t": torch.zeros((), dtype=torch.int64, device=device),
    }


class CachedRopeAttention(RopeAttention):
    """RopeAttention over one new view whose keys and values go into a ring
    cache first; the queries attend to the cache's valid slots."""

    def step(self, x: torch.Tensor, grid_hw: Tuple[int, int], cache_k: torch.Tensor,
             cache_v: torch.Tensor, rows: torch.Tensor, key_ok: torch.Tensor,
             inplace: bool = True):
        """``rows``: the cache rows of this view's slot (n,) int64;
        ``key_ok``: (C,) bool, the valid cache rows after the write. Returns
        the output and the written cache (``cache_k`` and ``cache_v``
        themselves, or new tensors where ``inplace`` is False)."""
        b, n, _ = x.shape
        q, k, v = self.rotated_qkv(x, grid_hw)
        write = torch.Tensor.index_copy_ if inplace else torch.Tensor.index_copy
        cache_k = write(cache_k, 2, rows, k.to(cache_k.dtype))
        cache_v = write(cache_v, 2, rows, v.to(cache_v.dtype))
        o = masked_attention(q, cache_k.to(q.dtype), cache_v.to(v.dtype), key_ok)
        return self.proj(o.transpose(1, 2).reshape(b, n, self.dim)), cache_k, cache_v


class CachedGlobalBlock(AASubBlock):
    """AASubBlock whose attention reads and writes the ring cache, for one new
    view; its submodule names are AASubBlock's."""

    def __init__(self, dim: int, num_heads: int, num_special: int, attn_impl: str = "auto"):
        super().__init__(dim, num_heads, num_special, attn_impl, attn_cls=CachedRopeAttention)

    def step(self, x: torch.Tensor, grid_hw: Tuple[int, int], cache_k: torch.Tensor,
             cache_v: torch.Tensor, rows: torch.Tensor, key_ok: torch.Tensor,
             inplace: bool = True):
        o, cache_k, cache_v = self.attn.step(self.norm1(x), grid_hw, cache_k, cache_v, rows,
                                             key_ok, inplace)
        x = x + self.ls1(o)
        return x + self.ls2(self.mlp(self.norm2(x))), cache_k, cache_v


class StreamingVGGT(VGGT):
    """One causal step: a view (B, H, W, 3), normalized, and the cache ->
    this view's depth and depth_conf (B, H, W), world_points (B, H, W, 3) and
    world_points_conf with the point head, pose_enc (B, 9) with the camera;
    the cache advances in place. A ``VGGT`` whose global blocks also step
    (its ``forward`` is the joint model's with the cache: :meth:`step`)."""

    def __init__(self, cfg: VGGTConfig = VGGTConfig(), max_views: int = 8,
                 attn_impl: str = "auto", with_camera: bool = False,
                 with_point_head: bool = False):
        super().__init__(cfg, attn_impl, with_camera=with_camera,
                         with_point_head=with_point_head, global_block=CachedGlobalBlock)
        self.max_views = max_views

    @classmethod
    def sharing(cls, model: VGGT, max_views: int) -> "StreamingVGGT":
        """A streaming model on the very parameter tensors of ``model`` (no
        copy; built on the meta device, then given them). The joint model's
        ``QuantLinear`` layers (int8 serving) are put in at their paths
        first, so that both models hold the same modules there and the
        rest of the state dict loads as the joint model's."""
        attn = model.aggregator.frame_blocks[0].attn.attn_impl
        with torch.device("meta"):
            self = cls(model.cfg, max_views, attn, with_camera=model.with_camera,
                       with_point_head=model.with_point_head)
        for path, module in model.named_modules():
            if isinstance(module, QuantLinear):
                parent, _, child = path.rpartition(".")
                setattr(self.get_submodule(parent) if parent else self, child, module)
        self.load_state_dict(model.state_dict(), strict=True, assign=True)
        return self.train(model.training)

    def init_cache(self, batch: int, grid_hw: Tuple[int, int], dtype: torch.dtype,
                   device) -> Dict:
        return init_stream_cache(self.cfg, batch, grid_hw, self.max_views, dtype, device)

    def step(self, view: torch.Tensor, cache: Dict) -> Dict[str, torch.Tensor]:
        """One view's outputs; the cache advances in place."""
        return self.advance(view, cache, inplace=True)[0]

    def advance(self, view: torch.Tensor, cache: Dict,
                inplace: bool = False) -> Tuple[Dict[str, torch.Tensor], Dict]:
        """(outputs, cache'): one step. With ``inplace`` False a function of
        its inputs, the cache left as it was and ``cache'`` new tensors (the
        exported stream step, ``runtime/export.py``); with ``inplace`` the
        cache's own buffers, written (the captured session)."""
        c, w = self.cfg, self.max_views
        b, H, W, _ = view.shape
        grid = (H // c.patch_size, W // c.patch_size)
        num_special = 1 + c.num_register_tokens
        agg = self.aggregator
        x = agg.tokens(view)  # (B, n, dim)
        n = x.shape[1]
        t = cache["t"]
        slot = torch.remainder(t, w)
        rows = slot * n + torch.arange(n, device=view.device)
        capacity = cache["kv"][0][0].shape[2]
        key_ok = torch.arange(capacity, device=view.device) < torch.clamp(t + 1, max=w) * n

        saved, kv = {}, []
        for i in range(c.depth):
            x = agg.frame_blocks[i](x, grid, views=1)
            frame_out = x
            cache_k, cache_v = cache["kv"][i]
            x, cache_k, cache_v = agg.global_blocks[i].step(x, grid, cache_k, cache_v, rows,
                                                            key_ok, inplace)
            kv.append((cache_k, cache_v))
            if i in c.head_layers:
                saved[i] = torch.cat([frame_out, x], dim=-1)[:, None]  # (B, 1, n, 2dim)
        outs = [saved[i] for i in c.head_layers]

        depth, conf = self.depth_head(outs, grid, num_special)
        out = {"depth": depth[:, 0], "depth_conf": conf[:, 0]}
        if self.with_point_head:
            pts, pconf = self.point_head(outs, grid, num_special)
            out["world_points"], out["world_points_conf"] = pts[:, 0], pconf[:, 0]
        # the camera-token ring: the camera head attends across the filled
        # slots, and this step's pose is read at its slot
        write = torch.Tensor.index_copy_ if inplace else torch.Tensor.index_copy
        cam = write(cache["cam"], 1, slot[None], outs[-1][:, 0, :1].float())
        if self.with_camera:
            valid = torch.arange(w, device=view.device) < torch.clamp(t + 1, max=w)
            poses = self.camera_head(cam.to(x.dtype), key_mask=valid)
            out["pose_enc"] = poses.index_select(1, slot[None])[:, 0]
        t = t.add_(1) if inplace else t + 1
        return out, {"kv": kv, "cam": cam, "t": t}

