"""JAX params tree -> the port's ``state_dict``.

The exact inverse of the JAX package's ``weights/convert.py``
(``convert_dinovit``, ``convert_dpt_head``, ``convert_vggt``,
``convert_depth_pro``, ``convert_depth_anything_v3``,
``convert_metric3d_v2``, ``convert_moge2``, ``convert_geometric``,
``convert_sidepth``, ``convert_geocalib``, ``convert_prior_depth``), so that
the parity tests can feed one set of weights to both packages:

* Dense kernel (in, out)                 -> Linear weight (out, in)
* Conv kernel (kh, kw, in, out)          -> Conv2d weight (out, in, kh, kw)
* ConvTranspose kernel (kh, kw, in, out) -> ConvTranspose2d weight (in, out, kh, kw)
* Dense kernel (in, out) on tokens       -> Conv2d 1x1 weight (out, in, 1, 1) (MoGe's projections)
* fused GRU ``convzr`` (.., 2*hidden)    -> ``convz`` and ``convr`` (Metric3D V2)
* LayerNorm scale / bias                 -> weight / bias
* q8 kernel_q (in, out) int8             -> QuantLinear weight_q (out, in) (:func:`q8_from_jax`)

Leaves may be numpy or JAX arrays; they are read with ``np.asarray`` and
nothing of JAX is imported.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

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


def _conv1x1_from_dense(p: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T[:, :, None, None])
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


def _fusion_from_jax(p: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    """One ``FeatureFusionBlock``. A block without a skip input never runs
    its ``resConfUnit1``, so Flax's ``init`` creates no params for it; the
    upstream layout carries it all the same, and gets zeros shaped like its
    twin, which inference never reads."""
    for unit in ("resConfUnit1", "resConfUnit2"):
        for conv in ("conv1", "conv2"):
            key = f"{prefix}.{unit}.{conv}"
            if unit in p:
                _conv(p[unit][conv], key, out)
            else:
                kh, kw, cin, cout = np.shape(p["resConfUnit2"][conv]["kernel"])
                out[f"{key}.weight"] = torch.zeros(cout, cin, kh, kw)
                out[f"{key}.bias"] = torch.zeros(cout)
    _conv(p["out_conv"], f"{prefix}.out_conv", out)


def _dpt_levels_from_jax(p: Mapping, prefix: str, out: Dict[str, torch.Tensor],
                         rn_prefix: Optional[str] = None) -> None:
    """The projections and resize layers of a DPT trunk under ``prefix``, its
    ``layer{i}_rn`` under ``rn_prefix`` (default ``prefix``)."""
    for i in range(4):
        _conv(p[f"project_{i}"], _join(prefix, f"projects.{i}"), out)
    _conv_transpose(p["resize_0"], _join(prefix, "resize_layers.0"), out)
    _conv_transpose(p["resize_1"], _join(prefix, "resize_layers.1"), out)
    _conv(p["resize_3"], _join(prefix, "resize_layers.3"), out)
    for i in range(1, 5):
        _conv(p[f"layer{i}_rn"], _join(prefix if rn_prefix is None else rn_prefix,
                                       f"layer{i}_rn"), out)


def dpt_head_from_jax(p: Mapping, prefix: str = "depth_head",
                      nested_scratch: bool = True) -> Dict[str, torch.Tensor]:
    """JAX ``DPTHead`` params -> ``DPTHead`` state-dict entries under
    ``prefix``; ``nested_scratch=False`` for VGGT's layout, whose fusion
    modules have no ``scratch.`` level.

    ``refinenet4`` has no skip input: a tree without its ``resConfUnit1``
    gets zeros there (:func:`_fusion_from_jax`)."""
    out: Dict[str, torch.Tensor] = {}
    sc = _join(prefix, "scratch") if nested_scratch else prefix
    _dpt_levels_from_jax(p, prefix, out, rn_prefix=sc)
    for i in range(1, 5):
        _fusion_from_jax(p[f"refinenet{i}"], _join(sc, f"refinenet{i}"), out)
    _conv(p["output_conv1"], _join(sc, "output_conv1"), out)
    _conv(p["output_conv2_0"], _join(sc, "output_conv2.0"), out)
    _conv(p["output_conv2_2"], _join(sc, "output_conv2.2"), out)
    return out


def _block_from_jax(p: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    """One pre-norm block: qkv/proj under ``attn`` (the aggregator's
    blocks) or beside the norms (the camera trunk)."""
    attn = p["attn"] if "attn" in p else p
    attn_prefix = f"{prefix}.attn" if "attn" in p else prefix
    _layernorm(p["norm1"], f"{prefix}.norm1", out)
    _linear(attn["qkv"], f"{attn_prefix}.qkv", out)
    _linear(attn["proj"], f"{attn_prefix}.proj", out)
    out[f"{prefix}.ls1.gamma"] = _t(p["ls1"]["gamma"])
    _layernorm(p["norm2"], f"{prefix}.norm2", out)
    _linear(p["mlp"]["fc1"], f"{prefix}.mlp.fc1", out)
    _linear(p["mlp"]["fc2"], f"{prefix}.mlp.fc2", out)
    out[f"{prefix}.ls2.gamma"] = _t(p["ls2"]["gamma"])


def vggt_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``VGGT`` params (``aggregator`` / ``depth_head`` / optional
    ``camera_head``, optionally under a ``"params"`` key) -> the port's
    ``VGGT.state_dict()`` in the upstream layout, fp32 CPU tensors. The
    inverse of ``convert_vggt``; the camera trunk's flat Flax names
    (``trunk_{i}_qkv``, ``trunk_{i}_ls1`` ...) become ``trunk.{i}.*``."""
    if "params" in params:
        params = params["params"]
    if "point_head" in params:
        raise ValueError("the point head is not ported (it comes with stream3r)")
    agg = params["aggregator"]
    out = dinovit_from_jax(agg["patch_embed"], "aggregator.patch_embed")
    out["aggregator.camera_token"] = _t(agg["camera_token"])
    out["aggregator.register_tokens"] = _t(agg["register_tokens"])
    if "input_proj" in agg:
        _linear(agg["input_proj"], "aggregator.input_proj", out)
    depth = sum(1 for k in agg if k.startswith("frame_"))
    for i in range(depth):
        _block_from_jax(agg[f"frame_{i}"], f"aggregator.frame_blocks.{i}", out)
        _block_from_jax(agg[f"global_{i}"], f"aggregator.global_blocks.{i}", out)
    out.update(dpt_head_from_jax(params["depth_head"]["dpt"], "depth_head.dpt",
                                 nested_scratch=False))
    if "camera_head" in params:
        cam = params["camera_head"]
        _layernorm(cam["token_norm"], "camera_head.token_norm", out)
        _linear(cam["embed_pose"], "camera_head.embed_pose", out)
        _linear(cam["poseLN_modulation"], "camera_head.poseLN_modulation", out)
        _linear(cam["pose_branch_fc1"], "camera_head.pose_branch.fc1", out)
        _linear(cam["pose_branch_fc2"], "camera_head.pose_branch.fc2", out)
        trunk_depth = sum(1 for k in cam if k.endswith("_norm1"))
        for i in range(trunk_depth):
            blk = {name: cam[f"trunk_{i}_{name}"]
                   for name in ("norm1", "qkv", "proj", "ls1", "norm2", "mlp", "ls2")}
            _block_from_jax(blk, f"camera_head.trunk.{i}", out)
    return out


def depth_pro_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``DepthPro`` params (optionally under a ``"params"`` key) -> the
    port's ``DepthPro.state_dict()`` in the layout of
    ``weights/manifests/depth_pro.json``, fp32 CPU tensors. The inverse of
    ``convert_depth_pro``; the coarsest fusion block, which has no skip
    input, gets a zero ``resConfUnit1``."""
    if "params" in params:
        params = params["params"]
    out = {**dinovit_from_jax(params["patch_encoder"], "patch_encoder"),
           **dinovit_from_jax(params["image_encoder"], "image_encoder")}
    for name in ("upsample_latent0", "upsample_latent1", "upsample0", "upsample1",
                 "upsample2"):
        p = params[name]
        _conv(p["proj"], f"{name}.proj", out)
        for i in range(sum(1 for k in p if k.startswith("up_"))):
            _conv_transpose(p[f"up_{i}"], f"{name}.ups.{i}", out)
    _conv_transpose(params["upsample_lowres"], "upsample_lowres", out)
    _conv(params["fuse_lowres"], "fuse_lowres", out)
    dec = params["decoder"]
    for i in range(sum(1 for k in dec if k.startswith("fusion_"))):
        if f"conv_{i}" in dec:
            _conv(dec[f"conv_{i}"], f"decoder.convs.{i}", out)
        _fusion_from_jax(dec[f"fusion_{i}"], f"decoder.fusions.{i}", out)
    for name in ("head_conv0", "head_conv1", "head_conv2"):
        _conv(params[name], name, out)
    _conv_transpose(params["head_up"], "head_up", out)
    fov = params["fov"]
    for name in ("down0", "down1", "down2"):
        _conv(fov[name], f"fov.{name}", out)
    _linear(fov["fov_proj"], "fov.fov_proj", out)
    _linear(fov["head"], "fov.head", out)
    return out


def da3_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``DepthAnythingV3`` params (optionally under a ``"params"`` key)
    -> the port's state dict in the layout of
    ``weights/manifests/depth_anything_v3_vitl.json``, fp32 CPU tensors. The
    inverse of ``convert_depth_anything_v3``; ``refinenet4`` gets a zero
    ``resConfUnit1``."""
    if "params" in params:
        params = params["params"]
    out = dinovit_from_jax(params["backbone"], "backbone")
    head = params["head"]
    _dpt_levels_from_jax(head, "head", out)
    for i in range(1, 5):
        _fusion_from_jax(head[f"refinenet{i}"], f"head.refinenet{i}", out)
    _conv(head["output_conv1"], "head.output_conv1", out)
    for branch in ("depth", "sky"):
        _conv(head[f"{branch}_conv0"], f"head.{branch}_branch.0", out)
        _conv(head[f"{branch}_conv2"], f"head.{branch}_branch.2", out)
    return out


def metric3d_v2_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``Metric3DV2`` params (optionally under a ``"params"`` key) -> the
    port's state dict in the layout of ``weights/manifests/metric3d_v2_vitl.json``,
    fp32 CPU tensors. The inverse of ``convert_metric3d_v2``: the fused
    ``gru.convzr`` splits back into upstream's ``gru.convz`` (the first
    ``hidden`` output channels) and ``gru.convr``; ``refinenet4`` gets a zero
    ``resConfUnit1``."""
    if "params" in params:
        params = params["params"]
    out = dinovit_from_jax(params["encoder"], "encoder")
    neck = params["neck"]
    _dpt_levels_from_jax(neck, "neck", out)
    for i in (2, 3, 4):
        _fusion_from_jax(neck[f"refinenet{i}"], f"neck.refinenet{i}", out)
    for name in ("context_conv", "init_head", "pred_encoder", "delta_head", "mask_head",
                 "conf_head"):
        _conv(params[name], name, out)
    zr = params["gru"]["convzr"]
    kernel, bias = np.asarray(zr["kernel"]), np.asarray(zr["bias"])
    hidden = kernel.shape[-1] // 2
    _conv({"kernel": kernel[..., :hidden], "bias": bias[:hidden]}, "gru.convz", out)
    _conv({"kernel": kernel[..., hidden:], "bias": bias[hidden:]}, "gru.convr", out)
    _conv(params["gru"]["convq"], "gru.convq", out)
    return out


def moge2_from_jax(params: Mapping[str, Any],
                   predict_normal: Optional[bool] = None) -> Dict[str, torch.Tensor]:
    """JAX ``MoGe2`` params (optionally under a ``"params"`` key) -> the
    port's state dict in the layout of ``weights/manifests/moge2_vits.json``
    (``metric_anything.json`` without the normal branch), fp32 CPU tensors.
    The inverse of ``convert_moge2``; the projections, Dense layers on the
    tokens there, become upstream's 1x1 convolutions. ``predict_normal``
    defaults to whether the tree has the normal branch."""
    if "params" in params:
        params = params["params"]
    head = params["head"]
    if predict_normal is None:
        predict_normal = "normal_conv0" in head
    out = dinovit_from_jax(params["backbone"], "backbone")
    for i in range(sum(1 for k in head if k.startswith("project_"))):
        _conv1x1_from_dense(head[f"project_{i}"], f"head.projects.{i}", out)
    for j in range(sum(1 for k in head if k.endswith("_deconv"))):
        _conv_transpose(head[f"upsample_{j}_deconv"], f"head.upsample_blocks.{j}.0", out)
        for conv in ("conv1", "conv2"):
            _conv(head[f"upsample_{j}_res"][conv], f"head.upsample_blocks.{j}.1.{conv}", out)
    for branch in ["points", "mask"] + (["normal"] if predict_normal else []):
        _conv(head[f"{branch}_conv0"], f"head.{branch}_out.0", out)
        _conv(head[f"{branch}_conv1"], f"head.{branch}_out.2", out)
    _linear(params["scale_fc1"], "scale_head.0", out)
    _linear(params["scale_fc2"], "scale_head.2", out)
    return out


def _xattn_block_from_jax(p: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    """One ``CrossAttentionBlock`` (``norm_context`` only on a cross block)."""
    for name in ("norm1", "norm2", "norm_context"):
        if name in p:
            _layernorm(p[name], f"{prefix}.{name}", out)
    for name in ("q", "kv", "proj", "fc1", "fc2"):
        _linear(p[name], f"{prefix}.{name}", out)


def geometric_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``GeometricDepthModel`` params of either mode (optionally under a
    ``"params"`` key) -> the port's state dict in the layout of
    ``weights/manifests/unidepth_vit*.json`` (``unik3d_vit*.json`` with the
    rays module), fp32 CPU tensors. The inverse of ``convert_geometric``."""
    if "params" in params:
        params = params["params"]
    out = dinovit_from_jax(params["pixel_encoder"], "pixel_encoder")
    for i in range(sum(1 for k in params if k.startswith("adapter_") and k[8:].isdigit())):
        _linear(params[f"adapter_{i}"], f"adapters.{i}", out)
    _layernorm(params["adapter_norm"], "adapter_norm", out)
    cam = params["camera"]
    out["camera.latents"] = _t(cam["latents"])
    _xattn_block_from_jax(cam["cross"], "camera.cross", out)
    _xattn_block_from_jax(cam["self"], "camera.self_block", out)
    _layernorm(cam["norm"], "camera.norm", out)
    _linear(cam["out"], "camera.out", out)
    _linear(params["ray_embed"]["fc1"], "ray_embed.fc1", out)
    _linear(params["ray_embed"]["fc2"], "ray_embed.fc2", out)
    dm = params["depth_module"]
    for i in range(sum(1 for k in dm if k.startswith("block_"))):
        _xattn_block_from_jax(dm[f"block_{i}"], f"depth_module.blocks.{i}", out)
    _layernorm(dm["norm"], "depth_module.norm", out)
    for name in ("up1", "up2"):
        _conv_transpose(dm[name], f"depth_module.{name}", out)
    for name in ("conv1", "conv2", "out"):
        _conv(dm[name], f"depth_module.{name}", out)
    if "rays_module" in params:
        rm = params["rays_module"]
        _xattn_block_from_jax(rm["block_0"], "rays_module.block0", out)
        _layernorm(rm["norm"], "rays_module.norm", out)
        _linear(rm["out"], "rays_module.out", out)
    return out


def _dino_dpt_from_jax(params: Mapping[str, Any], *stacks) -> Dict[str, torch.Tensor]:
    """(encoder, head) pairs of DINOv2 + DPT stacks under their own names."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for vit, head in stacks:
        out.update(dinovit_from_jax(params[vit], vit))
        out.update(dpt_head_from_jax(params[head], head))
    return out


def sidepth_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``SIDepth`` params -> the port's state dict in the layout of
    ``weights/manifests/sidepth_vits.json``. The inverse of
    ``convert_sidepth``."""
    return _dino_dpt_from_jax(params, ("ssi", "ssi_head"), ("si", "si_head"))


def geocalib_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``GeoCalib`` params -> the port's state dict in the layout of
    ``weights/manifests/geocalib_vits.json``. The inverse of
    ``convert_geocalib``."""
    return _dino_dpt_from_jax(params, ("backbone", "head"))


def prior_refiner_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``PriorDARefiner`` params -> the port's state dict in the layout of
    ``weights/manifests/prior_depth_anything_vits.json``. The inverse of
    ``convert_prior_depth``."""
    return _dino_dpt_from_jax(params, ("mde", "mde_head"), ("cond", "refine_head"))


def prior_depth_anything_from_jax(params: Mapping[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX ``prior_depth_anything`` pipeline's params (``{"vggt": depth-only
    VGGT, "refiner": PriorDARefiner}``) -> the same two keys holding the
    port's state dicts, the ``params`` of its ``prior_depth_anything``."""
    return {"vggt": vggt_from_jax(params["vggt"]),
            "refiner": prior_refiner_from_jax(params["refiner"])}


# the submodules whose Dense layers each family's int8 serving quantizes
Q8_ROOTS = {
    "depth_anything_v2": ("pretrained",),
    "vggt": ("aggregator",),
    "depth_pro": ("patch_encoder", "image_encoder"),
    "depth_anything_v3": ("backbone",),
    "metric3d_v2": ("encoder",),
    "moge2": ("backbone",),
    "metric_anything": ("backbone",),
    "unidepth_v2": ("pixel_encoder",),
    "unik3d": ("pixel_encoder",),
}
# Flax module names -> the port's module paths
_Q8_NAMES = (("blocks_", "blocks."), ("frame_", "frame_blocks."), ("global_", "global_blocks."))


def _q8_path(keys) -> str:
    parts = []
    for key in keys:
        for flax, port in _Q8_NAMES:
            if key.startswith(flax) and key[len(flax):].isdigit():
                key = port + key[len(flax):]
                break
        parts.append(key)
    return ".".join(parts)


def q8_from_jax(q8: Mapping[str, Any], family: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's ``q8`` collection (optionally under a ``"q8"`` key)
    -> ``{port module path: {"weight_q", "qmul", "out_scale"}}``, the input
    of ``ops.quant.install_q8``: ``kernel_q`` (K, N) becomes ``weight_q``
    (N, K) int8, the scales fp32. ``family`` (a key of :data:`Q8_ROOTS`)
    names the submodules the collection may hold."""
    if "q8" in q8:
        q8 = q8["q8"]
    roots = Q8_ROOTS[family]
    out: Dict[str, Dict[str, torch.Tensor]] = {}

    def walk(node, keys):
        if "kernel_q" in node:
            out[_q8_path(keys)] = {
                "weight_q": torch.from_numpy(np.ascontiguousarray(np.asarray(node["kernel_q"]).T)),
                "qmul": _t(node["qmul"]),
                "out_scale": _t(node["out_scale"]),
            }
            return
        for key, sub in node.items():
            walk(sub, keys + (key,))

    for root, sub in q8.items():
        if root not in roots:
            raise ValueError(f"q8 entry {root!r} is outside {family}'s quantized modules {roots}")
        walk(sub, (root,))
    return out


def state_dict_from_jax(params: Mapping[str, Any]):
    """JAX params of a ported family (optionally under a ``"params"`` key)
    -> the port's state dict, fp32 CPU tensors. The family is read from the
    tree's top-level modules: ``pretrained`` (``DepthAnythingV2``),
    ``aggregator`` (VGGT), ``patch_encoder`` (Depth Pro), ``encoder``
    (Metric3D V2), ``pixel_encoder`` (UniDepth V2, UniK3D), ``ssi``/``si``
    (SIDepth), ``mde``/``cond`` (Prior Depth Anything's refiner), ``backbone``
    with ``scale_fc1`` (MoGe-2, Metric Anything), with a plain DPT ``head`` of
    five outputs (GeoCalib) or with a two-branch ``head`` (Depth Anything
    V3). The composite ``{"vggt", "refiner"}`` of ``prior_depth_anything``
    gives those two keys, each a state dict."""
    if "params" in params:
        params = params["params"]
    if "refiner" in params and "vggt" in params:
        return prior_depth_anything_from_jax(params)
    if "aggregator" in params:
        return vggt_from_jax(params)
    if "patch_encoder" in params:
        return depth_pro_from_jax(params)
    if "encoder" in params:
        return metric3d_v2_from_jax(params)
    if "pixel_encoder" in params:
        return geometric_from_jax(params)
    if "ssi" in params:
        return sidepth_from_jax(params)
    if "mde" in params:
        return prior_refiner_from_jax(params)
    if "backbone" in params:
        if "scale_fc1" in params:
            return moge2_from_jax(params)
        if "output_conv2_2" not in params["head"]:  # DA3's two branches
            return da3_from_jax(params)
        outputs = np.shape(params["head"]["output_conv2_2"]["kernel"])[-1]
        if outputs != 5:
            raise ValueError(f"a DINOv2 + DPT tree with {outputs} outputs: no ported family")
        return geocalib_from_jax(params)
    return {
        **dinovit_from_jax(params["pretrained"], "pretrained"),
        **dpt_head_from_jax(params["depth_head"], "depth_head"),
    }
