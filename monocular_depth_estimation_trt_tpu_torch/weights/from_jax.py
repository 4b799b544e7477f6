"""JAX params tree -> the port's ``state_dict``.

The exact inverse of the JAX package's ``weights/convert.py``
(``convert_dinovit``, ``convert_dpt_head``), so that the parity tests can
feed one set of weights to both packages:

* Dense kernel (in, out)                 -> Linear weight (out, in)
* Conv kernel (kh, kw, in, out)          -> Conv2d weight (out, in, kh, kw)
* ConvTranspose kernel (kh, kw, in, out) -> ConvTranspose2d weight (in, out, kh, kw)
* LayerNorm scale / bias                 -> weight / bias

Leaves may be numpy or JAX arrays; they are read with ``np.asarray`` and
nothing of JAX is imported.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _linear(p: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _conv(p: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _conv_transpose(p: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(2, 3, 0, 1))
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _layernorm(p: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def _join(prefix: str, name: str) -> str:
    return name if not prefix else f"{prefix}.{name}"


def dinovit_from_jax(p: Mapping, prefix: str = "pretrained") -> Dict[str, torch.Tensor]:
    """JAX ``DinoViT`` params -> ``DinoViT`` state-dict entries under ``prefix``."""
    out: Dict[str, torch.Tensor] = {}
    for name in ("cls_token", "pos_embed", "register_tokens"):
        if name in p:
            out[_join(prefix, name)] = _t(p[name])
    _conv(p["patch_embed"], _join(prefix, "patch_embed.proj"), out)
    _layernorm(p["norm"], _join(prefix, "norm"), out)
    depth = sum(1 for k in p if k.startswith("blocks_"))
    for i in range(depth):
        blk = p[f"blocks_{i}"]
        b = _join(prefix, f"blocks.{i}")
        _layernorm(blk["norm1"], f"{b}.norm1", out)
        _linear(blk["attn"]["qkv"], f"{b}.attn.qkv", out)
        _linear(blk["attn"]["proj"], f"{b}.attn.proj", out)
        out[f"{b}.ls1.gamma"] = _t(blk["ls1"]["gamma"])
        _layernorm(blk["norm2"], f"{b}.norm2", out)
        for name, sub in blk["mlp"].items():  # fc1/fc2, or w12/w3 (SwiGLU)
            _linear(sub, f"{b}.mlp.{name}", out)
        out[f"{b}.ls2.gamma"] = _t(blk["ls2"]["gamma"])
    return out


def dpt_head_from_jax(p: Mapping, prefix: str = "depth_head") -> Dict[str, torch.Tensor]:
    """JAX ``DPTHead`` params -> ``DPTHead`` state-dict entries under ``prefix``.

    ``refinenet4`` has no skip input, so its ``resConfUnit1`` never runs and
    Flax's ``init`` creates no params for it; the upstream checkpoints carry
    it all the same. A tree without it gets zeros there, which inference
    never reads."""
    out: Dict[str, torch.Tensor] = {}
    for i in range(4):
        _conv(p[f"project_{i}"], _join(prefix, f"projects.{i}"), out)
    _conv_transpose(p["resize_0"], _join(prefix, "resize_layers.0"), out)
    _conv_transpose(p["resize_1"], _join(prefix, "resize_layers.1"), out)
    _conv(p["resize_3"], _join(prefix, "resize_layers.3"), out)
    sc = _join(prefix, "scratch")
    for i in range(1, 5):
        _conv(p[f"layer{i}_rn"], f"{sc}.layer{i}_rn", out)
    for i in range(1, 5):
        rf = p[f"refinenet{i}"]
        for unit in ("resConfUnit1", "resConfUnit2"):
            for conv in ("conv1", "conv2"):
                key = f"{sc}.refinenet{i}.{unit}.{conv}"
                if unit in rf:
                    _conv(rf[unit][conv], key, out)
                else:  # the unused unit: zeros shaped like its twin
                    kh, kw, cin, cout = np.shape(rf["resConfUnit2"][conv]["kernel"])
                    out[f"{key}.weight"] = torch.zeros(cout, cin, kh, kw)
                    out[f"{key}.bias"] = torch.zeros(cout)
        _conv(rf["out_conv"], f"{sc}.refinenet{i}.out_conv", out)
    _conv(p["output_conv1"], f"{sc}.output_conv1", out)
    _conv(p["output_conv2_0"], f"{sc}.output_conv2.0", out)
    _conv(p["output_conv2_2"], f"{sc}.output_conv2.2", out)
    return out


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``DepthAnythingV2`` params (``{"pretrained": ..., "depth_head":
    ...}``, optionally under a ``"params"`` key) -> the port's
    ``DepthAnythingV2.state_dict()``, fp32 CPU tensors."""
    if "params" in params:
        params = params["params"]
    return {
        **dinovit_from_jax(params["pretrained"], "pretrained"),
        **dpt_head_from_jax(params["depth_head"], "depth_head"),
    }
