"""Weights of the torch port: upstream key names, the JAX params tree round
trip, strict loading and the checkpoint policy."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monocular_depth_estimation_trt_tpu.models.depth_anything_v2 as jda
import monocular_depth_estimation_trt_tpu.models.vit as jvit
from monocular_depth_estimation_trt_tpu.weights.convert import (
    convert_dinovit,
    convert_dpt_head,
)
from monocular_depth_estimation_trt_tpu_torch.models.depth_anything_v2 import (
    DepthAnythingV2,
)
from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig
from monocular_depth_estimation_trt_tpu_torch.registry import build_pipeline
from monocular_depth_estimation_trt_tpu_torch.weights import store
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import state_dict_from_jax

from torch_mirror import TorchDepthAnythingV2
from torch_port_params import random_params

torch.set_num_threads(1)

MANIFESTS = os.path.join(os.path.dirname(jda.__file__), "..", "weights", "manifests")
TINY_KW = dict(vit_config=ViTConfig(dim=64, depth=2, num_heads=2, pretrain_img_size=70),
               head_features=16, head_out_channels=(8, 16, 32, 32), out_indices=(0, 1, 0, 1))


def _tiny_port(metric=False):
    return DepthAnythingV2(encoder="tiny", metric=metric, attn_impl="xla", **TINY_KW)


def _mirror(ffn="mlp", seed=7):
    torch.manual_seed(seed)
    m = TorchDepthAnythingV2(dim=64, depth=2, num_heads=2, features=16,
                             out_channels=(8, 16, 32, 32), idxs=(0, 1, 0, 1),
                             pretrain_img=70, ffn=ffn)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(torch.randn_like(p) * 0.02)
    return m


@pytest.mark.parametrize("encoder", ["vits", "vitb", "vitl"])
def test_state_dict_keys_and_shapes_equal_upstream_manifest(encoder):
    with open(os.path.join(MANIFESTS, f"depth_anything_v2_{encoder}.json")) as f:
        manifest = json.load(f)["keys"]
    with torch.device("meta"):  # full widths, no memory
        model = DepthAnythingV2(encoder=encoder)
    ours = {k: list(v.shape) for k, v in model.state_dict().items()}
    assert sorted(ours) == sorted(manifest)
    assert ours == manifest
    if encoder == "vits":
        assert len(ours) == 238


@pytest.mark.parametrize("ffn", ["mlp", "swiglu"])
def test_from_jax_inverts_the_jax_converter_exactly(ffn):
    sd = _mirror(ffn).state_dict()
    params = {"pretrained": convert_dinovit(sd, "pretrained", depth=2),
              "depth_head": convert_dpt_head(sd, "depth_head")}
    back = state_dict_from_jax({"params": params})
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].dtype == torch.float32
        assert torch.equal(back[k], v), k


def test_port_loads_the_upstream_named_state_dict_as_it_is():
    sd = _mirror().state_dict()
    model = DepthAnythingV2(encoder="tiny", **TINY_KW)
    store.load_state_dict(model, sd)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k])


def test_from_jax_fills_the_unused_fusion_unit_of_an_init_tree(monkeypatch):
    """Flax creates no params for refinenet4's resConfUnit1 (it never runs);
    the port's upstream layout has them, as zeros."""
    monkeypatch.setitem(jvit.VIT_CONFIGS, "tiny", jvit.ViTConfig(
        dim=64, depth=2, num_heads=2, pretrain_img_size=70))
    monkeypatch.setitem(jda.HEAD_CONFIGS, "tiny", dict(features=16,
                                                       out_channels=(8, 16, 32, 32)))
    monkeypatch.setitem(jda.INTERMEDIATE_LAYER_IDX, "tiny", (0, 1, 0, 1))
    jm = jda.DepthAnythingV2(encoder="tiny", dtype=jnp.float32)
    params = random_params(jm, jnp.zeros((1, 70, 70, 3)))
    assert "resConfUnit1" not in params["depth_head"]["refinenet4"]
    model = _tiny_port()
    store.load_state_dict(model, state_dict_from_jax(params))
    unit = model.depth_head.scratch.refinenet4.resConfUnit1
    assert all(not p.detach().any() for p in unit.parameters())


def test_strict_load_drops_mask_token_and_rejects_other_mismatches():
    model = _tiny_port()
    sd = dict(model.state_dict())
    store.load_state_dict(model, {**sd, "pretrained.mask_token": torch.zeros(1, 64)})
    with pytest.raises(RuntimeError, match="Unexpected"):
        store.load_state_dict(model, {**sd, "pretrained.extra": torch.zeros(1)})
    missing = dict(sd)
    missing.pop("depth_head.scratch.output_conv2.2.bias")
    with pytest.raises(RuntimeError, match="Missing"):
        store.load_state_dict(model, missing)


def test_random_weights_need_the_opt_in_and_are_seeded(capsys):
    with store.allow_random_weights(False):
        with pytest.raises(store.MissingCheckpointError):
            store.resolve_weights(_tiny_port(), "tiny_model")
    with store.allow_random_weights(True):
        a, b, c = _tiny_port(), _tiny_port(), _tiny_port()
        store.resolve_weights(a, "tiny_model", seed=0)
        store.resolve_weights(b, "tiny_model", seed=0)
        store.resolve_weights(c, "tiny_model", seed=1)
    assert "[WARN] No checkpoint for 'tiny_model'" in capsys.readouterr().out
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["pretrained.blocks.0.attn.qkv.weight"],
                           sc["pretrained.blocks.0.attn.qkv.weight"])
    with store.allow_random_weights(False):
        with pytest.raises(store.MissingCheckpointError):
            build_pipeline("depth_anything_v2", encoder="tiny", device="cpu",
                           model_kw=TINY_KW)


def test_checkpoint_from_a_local_path_and_the_hf_mirror(tmp_path, monkeypatch, rng):
    sd = _mirror().state_dict()
    sd["pretrained.mask_token"] = torch.zeros(1, 64)  # as upstream files carry it
    path = tmp_path / "org" / "repo" / "depth_anything_v2_tiny.pth"
    path.parent.mkdir(parents=True)
    torch.save(sd, path)
    frame = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    kw = dict(encoder="tiny", device="cpu", precision="fp32", attn_impl="xla",
              input_size=70, model_kw=TINY_KW)
    with store.allow_random_weights(False):
        by_path = build_pipeline("depth_anything_v2", checkpoint=str(path), **kw)
        monkeypatch.setenv("MDET_HF_CACHE", str(tmp_path))
        by_uri = build_pipeline("depth_anything_v2",
                                checkpoint="hf:org/repo/depth_anything_v2_tiny.pth", **kw)
        np.testing.assert_array_equal(by_path(frame)["depth"], by_uri(frame)["depth"])
        for bad in ("hf:org/repo/absent.pth", "hf:org/only", str(tmp_path / "absent.pth")):
            with pytest.raises(store.MissingCheckpointError):
                store.resolve_checkpoint(bad)
