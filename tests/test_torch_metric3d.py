"""The torch port's Metric3D V2 against the JAX package's, on the CPU, fp32,
one set of seeded weights on both sides (``torch_port_params`` and
``weights/from_jax.py``):

* ``preprocess_keep_ratio_pad`` at odd frame sizes: the same pad and scale,
  the same values;
* ``convex_upsample`` (the JAX tap-major mask layout) and ``ConvGRU`` with
  upstream's ``convz``/``convr`` split from the JAX ``convzr``;
* the whole ``Metric3DV2`` at ``tests/test_parity_metric3d.py``'s tiny config
  (dim 64, depth 4, 2 heads) on a canvas that factors (56x84), and its
  full-size key set against ``weights/manifests/metric3d_v2_vitl.json``;
* the ``metric3d_v2`` pipeline at the 616x1064 canvas with the tiny model,
  with and without the caller's focal;
* int8 of the tiny model with the JAX ``q8`` collection carried over;
* ``run metric3d_v2`` through the port's CLI on the CPU.

The JAX side runs under ``jax.jit`` with its plain attention
(``attn_impl="xla"``). Readings on a CPU: rel errors 4.2e-8 to 5.9e-6 (bar
2e-3).
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu import registry as jreg
from monocular_depth_estimation_trt_tpu.models import metric3d_v2 as jm3
from monocular_depth_estimation_trt_tpu.models import vit as jvit
from monocular_depth_estimation_trt_tpu.ops import preprocess as jpre
from monocular_depth_estimation_trt_tpu.ops import quant as jquant
from monocular_depth_estimation_trt_tpu_torch import cli as tcli
from monocular_depth_estimation_trt_tpu_torch import registry as treg
from monocular_depth_estimation_trt_tpu_torch.models import metric3d_v2 as tm3
from monocular_depth_estimation_trt_tpu_torch.models import vit as tvit
from monocular_depth_estimation_trt_tpu_torch.ops import preprocess as tpre
from monocular_depth_estimation_trt_tpu_torch.ops import quant as tquant
from monocular_depth_estimation_trt_tpu_torch.weights import store
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import (
    metric3d_v2_from_jax,
    q8_from_jax,
    state_dict_from_jax,
)

from torch_port_params import random_params, rel_err

torch.set_num_threads(1)

REL_TOL = 2e-3  # fp32 on both sides: summation order and exp/tanh only
MANIFESTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "monocular_depth_estimation_trt_tpu", "weights", "manifests")
VIT = dict(dim=64, depth=4, num_heads=2, pretrain_img_size=70)
HEAD = dict(features=16, out_channels=(8, 16, 32, 32), out_indices=(0, 1, 2, 3), hidden=32,
            upsample_factor=7)
HW = (56, 84)  # 4x6 patches, refinement at 8x12, 7x upsample back


def _jax_cfg():
    return jm3.Metric3DConfig(vit_config=jvit.ViTConfig(**VIT), **HEAD)


def _port_cfg():
    return tm3.Metric3DConfig(vit_config=tvit.ViTConfig(**VIT), **HEAD)


def _jax_model(quant="none", iters=2):
    return jm3.Metric3DV2(encoder="tiny", iters=iters, dtype=jnp.float32, attn_impl="xla",
                          quant=quant, cfg=_jax_cfg())


@pytest.fixture(scope="module")
def tiny():
    """The tiny JAX model's params, an input, and the JAX outputs."""
    x = np.random.default_rng(3).standard_normal((1, *HW, 3)).astype(np.float32)
    jm = _jax_model()
    params = random_params(jm, jnp.zeros((1, *HW, 3)), seed=11)
    out = jax.jit(lambda p, y: jm.apply({"params": p}, y))(params, jnp.asarray(x))
    return dict(params=params, x=x, out={k: np.asarray(v) for k, v in out.items()})


# --- ops ---------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(37, 53), (480, 641), (701, 233), (616, 1064)])
def test_keep_ratio_pad_matches_jax(hw):
    img = np.random.default_rng(hw[1]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    ref, ref_pad, ref_scale = jpre.preprocess_keep_ratio_pad(jnp.asarray(img), (616, 1064))
    ours, pad, scale = tpre.preprocess_keep_ratio_pad(torch.from_numpy(img), (616, 1064))
    assert pad == tuple(ref_pad) and scale == ref_scale
    assert ours.shape == (1, 616, 1064, 3) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=2e-4)
    t, b, l, r = pad  # the pad is zero: the mean was subtracted before it
    assert not ours[0, :t].any() and not ours[0, 616 - b:].any()
    assert not ours[0, :, :l].any() and not ours[0, :, 1064 - r:].any()


@pytest.mark.parametrize("k,c", [(7, 5), (4, 2)])
def test_convex_upsample_matches_jax(k, c):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 6, 9, c)).astype(np.float32)
    mask = 3.0 * rng.standard_normal((2, 6, 9, 9 * k * k)).astype(np.float32)
    ref = np.asarray(jm3.convex_upsample(jnp.asarray(x), jnp.asarray(mask), k))
    ours = tm3.convex_upsample(torch.from_numpy(x).permute(0, 3, 1, 2),
                               torch.from_numpy(mask).permute(0, 3, 1, 2), k)
    assert ours.shape == (2, c, 6 * k, 9 * k)
    assert rel_err(ours.permute(0, 2, 3, 1).numpy(), ref) < 1e-5


def test_conv_gru_matches_jax_with_convzr_split(tiny):
    """The tiny model's GRU (hidden 32, input 64): upstream's convz and convr
    are the JAX ``convzr``'s two halves."""
    rng = np.random.default_rng(5)
    h = np.tanh(rng.standard_normal((1, 8, 12, 32))).astype(np.float32)
    x = rng.standard_normal((1, 8, 12, 64)).astype(np.float32)
    jg = jm3.ConvGRU(32, jnp.float32)
    params = tiny["params"]["gru"]
    ref = np.asarray(jax.jit(lambda p, a, b: jg.apply({"params": p}, a, b))(
        params, jnp.asarray(h), jnp.asarray(x)))
    sd = metric3d_v2_from_jax(tiny["params"])
    gru = tm3.ConvGRU(32, 64)
    gru.load_state_dict({k[4:]: v for k, v in sd.items() if k.startswith("gru.")}, strict=True)
    zr = np.asarray(params["convzr"]["kernel"], np.float32)
    np.testing.assert_array_equal(gru.convz.weight.detach().permute(2, 3, 1, 0).numpy(), zr[..., :32])
    np.testing.assert_array_equal(gru.convr.weight.detach().permute(2, 3, 1, 0).numpy(), zr[..., 32:])
    with torch.no_grad():
        ours = gru(torch.from_numpy(h).permute(0, 3, 1, 2), torch.from_numpy(x).permute(0, 3, 1, 2))
    assert rel_err(ours.permute(0, 2, 3, 1).numpy(), ref) < REL_TOL


# --- the model ---------------------------------------------------------------


def test_metric3d_matches_jax(tiny):
    model = tm3.Metric3DV2(iters=2, attn_impl="xla", cfg=_port_cfg())
    model.load_state_dict(metric3d_v2_from_jax(tiny["params"]), strict=True)
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(tiny["x"]))
    for key in ("depth", "normal", "confidence"):
        assert ours[key].shape == tiny["out"][key].shape, key
        assert rel_err(ours[key].numpy(), tiny["out"][key]) < REL_TOL, key


def test_metric3d_refuses_a_canvas_that_does_not_factor():
    model = tm3.Metric3DV2(iters=1, attn_impl="xla", cfg=_port_cfg())
    with pytest.raises(ValueError, match="incompatible"):
        model(torch.zeros(1, 63, 84, 3))


def test_full_size_keys_equal_the_manifest():
    with open(os.path.join(MANIFESTS, "metric3d_v2_vitl.json")) as f:
        manifest = json.load(f)["keys"]
    with torch.device("meta"):
        sd = tm3.Metric3DV2().state_dict()
    assert {k: list(v.shape) for k, v in sd.items()} == manifest


def test_state_dict_from_jax_dispatches_metric3d(tiny):
    assert sorted(state_dict_from_jax({"params": tiny["params"]})) == sorted(
        metric3d_v2_from_jax(tiny["params"]))


# --- the pipeline --------------------------------------------------------------


FOCAL = 721.5


@pytest.fixture(scope="module")
def pipes(tiny):
    """The JAX pipeline with the caller's focal; the port's with and
    without it."""
    with pytest.MonkeyPatch.context() as mp:  # the JAX registry builds Metric3DV2 by name
        mp.setattr(jm3, "Metric3DV2", functools.partial(jm3.Metric3DV2, cfg=_jax_cfg()))
        jpipe = jreg.build_pipeline("metric3d_v2", encoder="tiny", precision="fp32",
                                    attn_impl="xla", iters=2, params=tiny["params"],
                                    focal=FOCAL)
    sd = metric3d_v2_from_jax(tiny["params"])
    tpipes = {f: treg.build_pipeline("metric3d_v2", encoder="tiny", precision="fp32",
                                     attn_impl="xla", iters=2, params=sd, focal=f,
                                     device="cpu", model_kw=dict(cfg=_port_cfg()))
              for f in (None, FOCAL)}
    return jpipe, tpipes


def test_metric3d_pipeline_matches_jax(pipes):
    """The JAX pipeline against the port's at the 616x1064 canvas, the
    caller's focal applied (the de-canonical scale); without it the port's
    depth is the canonical one, ``focal * scale / 1000`` times smaller."""
    jpipe, tpipes = pipes
    tpipe = tpipes[FOCAL]
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name() \
        == "metric3d_v2_tiny_616x1064_metric_fp32"
    assert tpipe.viz == jpipe.viz == "metric"
    frame = np.random.default_rng(9).integers(0, 256, (123, 301, 3), dtype=np.uint8)
    ref, ours = jpipe(frame, viz=True), tpipe(frame, viz=True)
    assert sorted(ours) == sorted(ref) == ["confidence", "depth", "viz"]
    for key in ("depth", "confidence"):
        assert ours[key].shape == (123, 301) and ours[key].dtype == np.float32
        assert rel_err(ours[key], ref[key]) < REL_TOL, key
    assert ours["depth"].min() >= 0.0 and ours["depth"].max() <= 300.0
    assert int(np.abs(ours["viz"].astype(int) - ref["viz"].astype(int)).max()) <= 1
    canonical = tpipes[None](frame)
    scale = min(616 / 123, 1064 / 301)
    want = np.clip(canonical["depth"] * (FOCAL * scale / 1000.0), 0.0, 300.0)
    assert rel_err(ours["depth"], want) < 1e-6
    np.testing.assert_array_equal(canonical["confidence"], ours["confidence"])


def test_full_size_metric3d_builds_with_the_jax_artifact_names(monkeypatch):
    monkeypatch.setattr(jreg, "_params_for", lambda *a, **k: {})
    monkeypatch.setattr(store, "resolve_weights", lambda *a, **k: None)
    jpipe = jreg.build_pipeline("metric3d_v2", iters=3)
    tpipe = treg.build_pipeline("metric3d_v2", device="meta", iters=3)
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name() \
        == "metric3d_v2_vitl_616x1064_metric_bf16"
    assert tpipe.model.iters == 3 and tpipe.model.k == 7
    assert tpipe.model.encoder.register_tokens.shape == (1, 4, 1024)


# --- int8 ----------------------------------------------------------------------


def test_metric3d_with_the_jax_q8_matches_jax(tiny):
    xs = [tiny["x"], np.random.default_rng(4).standard_normal((1, *HW, 3)).astype(np.float32)]
    serve = _jax_model("serve")
    q8 = jquant.quantize_vit_pipeline(_jax_model("calib"), serve, tiny["params"],
                                      tuple(jnp.asarray(x) for x in xs))
    ref = jax.jit(lambda v, y: serve.apply(v, y))({"params": tiny["params"], "q8": q8},
                                                  jnp.asarray(xs[0]))
    model = tm3.Metric3DV2(iters=2, attn_impl="xla", cfg=_port_cfg())
    model.load_state_dict(metric3d_v2_from_jax(tiny["params"]), strict=True)
    ported = q8_from_jax(q8, "metric3d_v2")
    assert sorted(ported) == sorted(model.int8_targets())
    assert len(ported) == 4 * VIT["depth"]
    tquant.install_q8(model, ported)
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(xs[0]))
    for key in ("depth", "normal", "confidence"):
        assert rel_err(ours[key].numpy(), np.asarray(ref[key])) < REL_TOL, key


# --- the command line ----------------------------------------------------------


def test_cli_run_metric3d_writes_depth_and_confidence(monkeypatch, tmp_path, tiny):
    """``run metric3d_v2`` on the CPU (the tiny model swapped in through
    ``build_pipeline``): the npz holds the depth and the confidence equal to
    the pipeline's, beside the viz."""
    from monocular_depth_estimation_trt_tpu_torch.utils import imageio

    sd = metric3d_v2_from_jax(tiny["params"])
    build = treg.build_pipeline

    def tiny_build(name, **kw):
        assert name == "metric3d_v2"
        return build(name, params=sd, iters=2, attn_impl="xla",
                     model_kw=dict(cfg=_port_cfg()), **kw)

    monkeypatch.setattr(treg, "build_pipeline", tiny_build)
    frame = np.random.default_rng(1).integers(0, 256, (90, 160, 3), dtype=np.uint8)
    png = str(tmp_path / "frame.png")
    imageio.write_image(png, frame)
    out = tmp_path / "out"
    assert tcli.main(["--device", "cpu", "run", "metric3d_v2", "--encoder", "tiny",
                      "--image", png, "--out", str(out), "--precision", "fp32"]) == 0
    name = "frame_metric3d_v2_tiny_616x1064_metric_fp32"
    got = np.load(out / f"{name}.npz")
    want = tiny_build("metric3d_v2", encoder="tiny", precision="fp32", device="cpu")(frame)
    assert sorted(got.files) == ["confidence", "depth"]
    for key in got.files:
        np.testing.assert_array_equal(got[key], want[key])
    assert any(f.startswith(name) and f.endswith((".jpg", ".png")) for f in os.listdir(out))


def test_dataclass_configs_match_jax():
    assert [f.name for f in dataclasses.fields(tm3.Metric3DConfig)] == [
        f.name for f in dataclasses.fields(jm3.Metric3DConfig)]
    assert tm3.DEPTH_RANGE == jm3.DEPTH_RANGE
