"""The port's DINOv3 depther (``models/dinov3.py``), its ``dinov3`` pipeline
and ``ops/colormap.py::spectral_colormap`` against the JAX package on the
CPU, fp32, with one set of seeded weights.

The backbone is cut to a vits16-shaped tiny config (dim 64, 2 heads, patch
16, 4 registers, RoPE and no position table), once with the MLP and once
with SwiGLU (the vit7b16 block); every attention is a rope attention, so the
port routes it to K2 (its plain version on the CPU). The full tiers are
built on the meta device only: their key sets against the manifests, and
vit7b16's 8.2 B parameters, head_dim 128, built where the model runs."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu import registry as jreg
from monocular_depth_estimation_trt_tpu.models import dinov3 as jdinov3
from monocular_depth_estimation_trt_tpu.models.vit import ViTConfig as JViTConfig
from monocular_depth_estimation_trt_tpu.ops import colormap as jcolormap
from monocular_depth_estimation_trt_tpu_torch import registry as treg
from monocular_depth_estimation_trt_tpu_torch.models import dinov3 as tdinov3
from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig as TViTConfig
from monocular_depth_estimation_trt_tpu_torch.ops import colormap as tcolormap
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import flash_attention as fa
from monocular_depth_estimation_trt_tpu_torch.weights import store
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import (
    dinov3_from_jax,
    state_dict_from_jax,
)

from torch_port_params import random_params, rel_err

torch.set_num_threads(1)

REL_TOL = 2e-3  # fp32 on both sides
VIT = dict(dim=64, depth=2, num_heads=2, patch_size=16, num_register_tokens=4, rope=True,
           pos_embed=False, pretrain_img_size=64)
HEAD = dict(head_features=16, head_out_channels=(8, 16, 32, 32), out_indices=(0, 1, 0, 1))
MANIFESTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "monocular_depth_estimation_trt_tpu", "weights", "manifests")


def _models(ffn):
    jm = jdinov3.DINOv3Depther(encoder="vits16", dtype=jnp.float32, attn_impl="xla",
                               vit_config=JViTConfig(**VIT, ffn=ffn), **HEAD)
    params = random_params(jm, jnp.zeros((1, 64, 64, 3)), seed=51)
    tm = tdinov3.DINOv3Depther("vits16", vit_config=TViTConfig(**VIT, ffn=ffn), **HEAD)
    tm.load_state_dict(dinov3_from_jax(params), strict=True)
    assert set(state_dict_from_jax(params)) == set(tm.state_dict())
    return jm, params, tm.eval()


@pytest.mark.parametrize("ffn", ["mlp", "swiglu"])
def test_depther_matches_jax(rng, ffn):
    """A non-square 48x64 input: a 3x4 grid of normalized rope coordinates."""
    jm, params, tm = _models(ffn)
    x = (rng.standard_normal((1, 48, 64, 3)) * 0.5).astype(np.float32)
    ref = jax.jit(lambda p, v: jm.apply({"params": p}, v))(params, jnp.asarray(x))
    before = fa.flash_attention.launches
    with torch.no_grad():
        ours = tm(torch.from_numpy(x))
    assert fa.flash_attention.launches == before  # CPU: K2's plain version
    assert ours.shape == ref.shape == (1, 48, 64)
    assert rel_err(ours.numpy(), ref) < REL_TOL
    assert float(ours.min()) >= 0.0


def test_spectral_colormap_is_bit_equal_to_jax(rng):
    norm = np.concatenate([rng.uniform(0.0, 1.0, 4093), [0.0, 1.0, -0.5, 1.5, 0.999]])
    norm = norm.astype(np.float32).reshape(2, 2049)
    ref = jcolormap.spectral_colormap(jnp.asarray(norm))
    ours = tcolormap.spectral_colormap(torch.from_numpy(norm))
    assert ours.dtype == torch.uint8 and ours.shape == (2, 2049, 3)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tcolormap.spectral_lut(), jcolormap.spectral_lut())
    np.testing.assert_array_equal(
        tcolormap.spectral_colormap(torch.from_numpy(norm), as_uint8=False).numpy(),
        np.asarray(jcolormap.spectral_colormap(jnp.asarray(norm), as_uint8=False)))


def test_pipeline_matches_jax(monkeypatch, rng):
    """The registry entry (antialiased resize, normalize, unclamped depth,
    Spectral viz) on a test-size tier registered on both sides."""
    jm, params, _ = _models("mlp")
    jcfg = dict(features=16, out_channels=(8, 16, 32, 32), idxs=(0, 1, 0, 1))
    monkeypatch.setitem(jdinov3.DINOV3_CONFIGS, "tiny16", JViTConfig(**VIT))
    monkeypatch.setitem(jdinov3.DINOV3_HEAD_CONFIGS, "tiny16", jcfg)
    monkeypatch.setitem(tdinov3.DINOV3_CONFIGS, "tiny16", TViTConfig(**VIT))
    monkeypatch.setitem(tdinov3.DINOV3_HEAD_CONFIGS, "tiny16", jcfg)
    jpipe = jreg.build_pipeline("dinov3", encoder="tiny16", input_size=64, precision="fp32",
                                attn_impl="xla", params=params)
    tpipe = treg.build_pipeline("dinov3", encoder="tiny16", input_size=64, precision="fp32",
                                device="cpu", params=dinov3_from_jax(params))
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name()
    assert tpipe.viz == jpipe.viz == "spectral"
    frame = rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)
    ref, ours = jpipe(frame, viz=True), tpipe(frame, viz=True)
    assert sorted(ours) == sorted(ref) == ["depth", "viz"]
    assert ours["depth"].shape == (90, 120) and ours["viz"].shape == (90, 120, 3)
    assert rel_err(ours["depth"], ref["depth"]) < REL_TOL
    assert np.mean(np.any(ours["viz"] != np.asarray(ref["viz"]), axis=-1)) < 0.01


@pytest.mark.parametrize("encoder", ["vits16", "vitl16"])
def test_keys_equal_the_manifests(encoder):
    with open(os.path.join(MANIFESTS, f"dinov3_{encoder}.json")) as f:
        want = json.load(f)["keys"]
    with torch.device("meta"):
        got = {k: list(v.shape) for k, v in tdinov3.DINOv3Depther(encoder).state_dict().items()}
    assert got == want


def test_vit7b16_builds_where_it_runs(monkeypatch):
    """Random weights of the 7B tier are made on the target device in bf16
    (here the meta device, the fill skipped): no host copy."""
    filled = []
    monkeypatch.setattr(store, "resolve_weights", lambda model, name, **kw: filled.append(name))
    pipe = treg.build_pipeline("dinov3", encoder="vit7b16", device="meta")
    assert filled == [pipe.spec.artifact_name()] == ["dinov3_vit7b16_1024x1024_bf16"]
    params = list(pipe.model.parameters())
    assert {p.device.type for p in params} == {"meta"} and {p.dtype for p in params} == {
        torch.bfloat16}
    assert 8.1e9 < sum(p.numel() for p in params) < 8.3e9
    blk = pipe.model.backbone.blocks[0]
    assert blk.attn.num_heads == 32 and blk.attn.dim // blk.attn.num_heads == 128
    assert blk.mlp.w3.in_features == 10928
