"""The torch port's Depth Anything V3 against the JAX package's, on the CPU,
fp32, one set of seeded weights on both sides (``torch_port_params`` and
``weights/from_jax.py``):

* ``DualDPTHead`` and the whole ``DepthAnythingV3`` at
  ``tests/test_parity_da3.py``'s tiny config (dim 64, depth 4, 2 heads), the
  JAX side under ``jax.jit`` with its plain attention;
* K1's route: at dim 128 / 2 heads (head_dim 64) the port's ``"auto"``
  attention goes to the packed-qkv kernel's wrapper, its plain version on
  the CPU, and still equals the JAX model;
* the full-size key set against ``weights/manifests/depth_anything_v3_vitl.json``
  and the JAX artifact names;
* the ``depth_anything_v3`` pipeline against the JAX pipeline at a frame of
  another size (depth and sky resized to it).

Readings on a CPU: rel errors 4.5e-7 to 1.0e-6 (bar 2e-3).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu import registry as jreg
from monocular_depth_estimation_trt_tpu.models import depth_anything_v2 as jda2
from monocular_depth_estimation_trt_tpu.models import depth_anything_v3 as jda3
from monocular_depth_estimation_trt_tpu.models import vit as jvit
from monocular_depth_estimation_trt_tpu_torch import registry as treg
from monocular_depth_estimation_trt_tpu_torch.models import depth_anything_v3 as tda3
from monocular_depth_estimation_trt_tpu_torch.models import vit as tvit
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import flash_attention as fa
from monocular_depth_estimation_trt_tpu_torch.weights import store
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import (
    da3_from_jax,
    state_dict_from_jax,
)

from torch_port_params import random_params, rel_err

torch.set_num_threads(1)

REL_TOL = 2e-3  # fp32 on both sides
MANIFESTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "monocular_depth_estimation_trt_tpu", "weights", "manifests")
HEAD = dict(features=16, out_channels=(8, 16, 32, 32))
TAPS = (0, 1, 2, 3)
VITS = {"tiny": dict(dim=64, depth=4, num_heads=2, pretrain_img_size=70),
        # head_dim 64: the port's "auto" route reaches K1
        "k1": dict(dim=128, depth=4, num_heads=2, pretrain_img_size=70)}


def _jax_model(vit):
    return jda3.DepthAnythingV3(
        encoder="tiny", dtype=jnp.float32, attn_impl="xla",
        cfg=jda3.DA3Config(vit_config=jvit.ViTConfig(**VITS[vit]), out_indices=TAPS, **HEAD))


def _port_kw(vit):
    return dict(vit_config=tvit.ViTConfig(**VITS[vit]), head_features=HEAD["features"],
                head_out_channels=HEAD["out_channels"], out_indices=TAPS)


@pytest.fixture(scope="module")
def tiny():
    x = np.random.default_rng(31).standard_normal((1, 70, 84, 3)).astype(np.float32)
    jm = _jax_model("tiny")
    params = random_params(jm, jnp.asarray(x), seed=3)
    depth, sky = jax.jit(lambda p, y: jm.apply({"params": p}, y))(params, jnp.asarray(x))
    return dict(params=params, x=x, depth=np.asarray(depth), sky=np.asarray(sky))


def test_dual_dpt_head_matches_jax(tiny):
    """The tiny model's head on seeded tap features of a 5x6 patch grid."""
    rng = np.random.default_rng(2)
    feats = [(rng.standard_normal((1, 30, 64)).astype(np.float32),
              rng.standard_normal((1, 64)).astype(np.float32)) for _ in range(4)]
    jh = jda3.DualDPTHead(in_channels=64, dtype=jnp.float32, **HEAD)
    jfeats = [tuple(jnp.asarray(t) for t in f) for f in feats]
    ref = jax.jit(lambda p, f: jh.apply({"params": p}, f, (5, 6)))(tiny["params"]["head"],
                                                                   jfeats)
    head = tda3.DualDPTHead(64, **HEAD)
    sd = da3_from_jax(tiny["params"])
    head.load_state_dict({k[5:]: v for k, v in sd.items() if k.startswith("head.")},
                         strict=True)
    with torch.no_grad():
        ours = head([tuple(torch.from_numpy(t) for t in f) for f in feats], (5, 6))
    for got, want in zip(ours, ref):
        assert got.shape == (1, 70, 84) and got.dtype == torch.float32
        assert rel_err(got.numpy(), np.asarray(want)) < REL_TOL


def test_da3_matches_jax(tiny):
    model = tda3.DepthAnythingV3(attn_impl="xla", **_port_kw("tiny"))
    model.load_state_dict(da3_from_jax(tiny["params"]), strict=True)
    with torch.no_grad():
        depth, sky = model.eval()(torch.from_numpy(tiny["x"]))
    assert depth.shape == sky.shape == (1, 70, 84)
    assert rel_err(depth.numpy(), tiny["depth"]) < REL_TOL
    assert rel_err(sky.numpy(), tiny["sky"]) < REL_TOL
    assert sorted(state_dict_from_jax(tiny["params"])) == sorted(model.state_dict())


def test_da3_auto_route_reaches_k1_and_matches_jax():
    x = np.random.default_rng(8).standard_normal((1, 70, 70, 3)).astype(np.float32)
    jm = _jax_model("k1")
    params = random_params(jm, jnp.asarray(x), seed=6)
    depth_ref, sky_ref = jax.jit(lambda p, y: jm.apply({"params": p}, y))(params,
                                                                         jnp.asarray(x))
    model = tda3.DepthAnythingV3(attn_impl="auto", **_port_kw("k1"))
    model.load_state_dict(da3_from_jax(params), strict=True)
    before = fa.flash_attention_packed.launches
    calls = []
    plain = fa.flash_attention_packed

    def spy(qkv, num_heads):
        calls.append(tuple(qkv.shape))
        return plain(qkv, num_heads)

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr("monocular_depth_estimation_trt_tpu_torch.models.vit."
                   "flash_attention_packed", spy)
        depth, sky = model.eval()(torch.from_numpy(x))
    assert calls == [(1, 26, 3 * 128)] * 4  # one call per block, 25 patches + cls
    assert fa.flash_attention_packed.launches == before  # CPU: the plain version
    assert rel_err(depth.numpy(), np.asarray(depth_ref)) < REL_TOL
    assert rel_err(sky.numpy(), np.asarray(sky_ref)) < REL_TOL


def test_full_size_keys_equal_the_manifest():
    with open(os.path.join(MANIFESTS, "depth_anything_v3_vitl.json")) as f:
        manifest = json.load(f)["keys"]
    with torch.device("meta"):
        sd = tda3.DepthAnythingV3().state_dict()
    assert {k: list(v.shape) for k, v in sd.items()} == manifest


def test_full_size_da3_builds_with_the_jax_artifact_names(monkeypatch):
    kw = {"precision": "fp32", "input_size": 364}
    monkeypatch.setattr(jreg, "_params_for", lambda *a, **k: {})
    monkeypatch.setattr(store, "resolve_weights", lambda *a, **k: None)
    jpipe = jreg.build_pipeline("depth_anything_v3", **kw)
    tpipe = treg.build_pipeline("depth_anything_v3", device="meta", **kw)
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name() \
        == "da3metric_vitl_364x364_metric_fp32"
    assert tpipe.viz == jpipe.viz == "metric"
    assert tpipe.model.backbone.blocks[0].attn.num_heads == 16


def test_da3_pipeline_matches_jax(monkeypatch, tiny):
    """``build_pipeline("depth_anything_v3", device="cpu")`` against the JAX
    pipeline, the tiny encoder patched into the JAX presets, at 70x70 on a
    96x128 frame: depth (clamped, align-corners) and sky at the frame's size."""
    monkeypatch.setitem(jvit.VIT_CONFIGS, "tiny", jvit.ViTConfig(**VITS["tiny"]))
    monkeypatch.setitem(jda2.HEAD_CONFIGS, "tiny", HEAD)
    monkeypatch.setitem(jda2.INTERMEDIATE_LAYER_IDX, "tiny", TAPS)
    jpipe = jreg.build_pipeline("depth_anything_v3", encoder="tiny", input_size=70,
                                precision="fp32", attn_impl="xla", params=tiny["params"])
    tpipe = treg.build_pipeline("depth_anything_v3", encoder="tiny", input_size=70,
                                precision="fp32", attn_impl="xla", device="cpu",
                                params=da3_from_jax(tiny["params"]),
                                model_kw=_port_kw("tiny"))
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name() \
        == "da3metric_tiny_70x70_metric_fp32"
    frame = np.random.default_rng(5).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    ref, ours = jpipe(frame, viz=True), tpipe(frame, viz=True)
    assert sorted(ours) == sorted(ref) == ["depth", "sky", "viz"]
    for key in ("depth", "sky"):
        assert ours[key].shape == (96, 128) and ours[key].dtype == np.float32
        assert rel_err(ours[key], ref[key]) < REL_TOL, key
    assert int(np.abs(ours["viz"].astype(int) - ref["viz"].astype(int)).max()) <= 1
    batch = tpipe.batch_call(np.stack([frame, frame[::-1]]))
    assert batch["depth"].shape == batch["sky"].shape == (2, 96, 128)
    assert rel_err(batch["depth"][0], ours["depth"]) < 1e-6


def test_models_command_lists_the_metric_families(capsys):
    """``python -m monocular_depth_estimation_trt_tpu_torch models``: the four
    families with the JAX fidelity and their int8 path."""
    from monocular_depth_estimation_trt_tpu_torch import cli as tcli

    assert tcli.main(["models"]) == 0
    lines = dict(line.split("  ", 1) for line in capsys.readouterr().out.splitlines())
    for name in ("depth_anything_v3", "metric3d_v2", "moge2", "metric_anything"):
        assert lines[name] == f"[{jreg.get_fidelity(name)}, int8]"
