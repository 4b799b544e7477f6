"""The torch port's SIDepth and GeoCalib against the JAX package's, on the CPU,
fp32, one set of seeded weights on both sides (``torch_port_params`` and
``weights/from_jax.py``):

* ``SIDepth`` (the SSI stage and the 4-channel SI stage) and ``GeoCalib``'s
  fields at ``tests/test_parity_sidepth.py``'s and
  ``test_parity_geocalib.py``'s tiny config (dim 64, depth 4, 2 heads, DPT
  16 / (8, 16, 32, 32)), the JAX side under ``jax.jit`` with its plain
  attention;
* ``gravity_in_camera``, ``perspective_fields`` and ``fit_camera``: the fit
  recovers a synthetic camera (the JAX ``test_fit_camera_recovers_synthetic``
  set-up) and equals the JAX fit on noisy, unevenly weighted fields, with
  its uncertainties;
* the full-size key sets against ``weights/manifests/sidepth_vits.json`` and
  ``geocalib_vits.json``; ``state_dict_from_jax`` tells GeoCalib's tree
  (``backbone`` + a five-output DPT ``head``) from Depth Anything V3's;
  the JAX artifact names, and no int8 path, as in the JAX package;
* the ``sidepth`` and ``geocalib`` pipelines against the JAX pipelines;
* ``run geocalib`` through the port's CLI on the CPU: the calibration lines
  and the npz.

Readings on a CPU: rel errors below 1e-4 (bar 2e-3).
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu import registry as jreg
from monocular_depth_estimation_trt_tpu.models import depth_anything_v3 as jda3
from monocular_depth_estimation_trt_tpu.models import geocalib as jgc
from monocular_depth_estimation_trt_tpu.models import sidepth as jsi
from monocular_depth_estimation_trt_tpu.models import vit as jvit
from monocular_depth_estimation_trt_tpu_torch import cli as tcli
from monocular_depth_estimation_trt_tpu_torch import registry as treg
from monocular_depth_estimation_trt_tpu_torch.models import geocalib as tgc
from monocular_depth_estimation_trt_tpu_torch.models import sidepth as tsi
from monocular_depth_estimation_trt_tpu_torch.models import vit as tvit
from monocular_depth_estimation_trt_tpu_torch.weights import store
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import (
    da3_from_jax,
    geocalib_from_jax,
    sidepth_from_jax,
    state_dict_from_jax,
)

from test_torch_geometric import MANIFESTS
from torch_port_params import random_params, rel_err

torch.set_num_threads(1)

REL_TOL = 2e-3  # fp32 on both sides
VIT = dict(dim=64, depth=4, num_heads=2, pretrain_img_size=70)
HEAD = dict(head_features=16, head_out_channels=(8, 16, 32, 32), out_indices=(0, 1, 2, 3))
SIDE = 70
FIELDS = ("up_field", "latitude_field", "up_confidence", "latitude_confidence")
ESTIMATES = ("roll", "pitch", "focal", "vfov", "hfov", "roll_uncertainty",
             "pitch_uncertainty", "focal_uncertainty", "vfov_uncertainty")


def _jax_kw():
    return dict(vit_config=jvit.ViTConfig(**VIT), **HEAD)


def _port_kw():
    return dict(vit_config=tvit.ViTConfig(**VIT), **HEAD)


# Weight seeds. The fit of random fields mostly runs the focal off to inf or
# NaN in both packages alike (seeds 4, 5, 8 and 9 read NaN in both); the
# GeoCalib seed is one whose fit of the pipeline's frame converges, so that
# the comparison holds numbers.
SEEDS = {"sidepth": 7, "geocalib": 10}


@functools.lru_cache(maxsize=None)
def _tiny(name):
    """The tiny JAX model's params, an input, and the JAX outputs."""
    cls = {"sidepth": jsi.SIDepth, "geocalib": jgc.GeoCalib}[name]
    jm = cls(dtype=jnp.float32, attn_impl="xla", **_jax_kw())
    x = np.random.default_rng(4).standard_normal((1, SIDE, 84, 3)).astype(np.float32) * 0.4
    params = random_params(jm, jnp.asarray(x), seed=SEEDS[name])
    out = jax.jit(lambda p, y: jm.apply({"params": p}, y))(params, jnp.asarray(x))
    return dict(params=params, x=x, out={k: np.asarray(v) for k, v in out.items()})


# --- the models ----------------------------------------------------------------


def test_sidepth_matches_jax():
    tiny = _tiny("sidepth")
    model = tsi.SIDepth("tiny", "xla", **_port_kw())
    model.load_state_dict(sidepth_from_jax(tiny["params"]), strict=True)
    assert model.si.patch_embed.proj.weight.shape == (64, 4, 14, 14)
    assert sorted(state_dict_from_jax(tiny["params"])) == sorted(model.state_dict())
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(tiny["x"]))
    assert sorted(ours) == sorted(tiny["out"]) == ["depth", "ssi"]
    for key, want in tiny["out"].items():
        assert ours[key].shape == want.shape == (1, SIDE, 84), key
        assert rel_err(ours[key].numpy(), want) < REL_TOL, key
    assert float(ours["depth"].min()) > 0.0


def test_geocalib_fields_match_jax():
    tiny = _tiny("geocalib")
    model = tgc.GeoCalib("tiny", "xla", **_port_kw())
    model.load_state_dict(geocalib_from_jax(tiny["params"]), strict=True)
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(tiny["x"]))
    assert sorted(ours) == sorted(tiny["out"]) == sorted(FIELDS)
    for key, want in tiny["out"].items():
        assert ours[key].shape == want.shape, key
        assert rel_err(ours[key].numpy(), want) < REL_TOL, key
    np.testing.assert_allclose(torch.linalg.vector_norm(ours["up_field"], dim=-1).numpy(), 1.0,
                               rtol=1e-5)


def test_geocalib_tree_is_not_taken_for_da3():
    """GeoCalib's JAX tree has ``backbone`` and ``head``, as Depth Anything
    V3's: the dispatch reads the head (a plain DPT head of five outputs)."""
    params = _tiny("geocalib")["params"]
    sd = state_dict_from_jax(params)
    assert sorted(sd) == sorted(geocalib_from_jax(params))
    assert "head.scratch.output_conv2.2.weight" in sd
    assert not any("branch" in k for k in sd)
    with pytest.raises(KeyError):
        da3_from_jax(params)  # what the dispatch used to call
    jm = jda3.DepthAnythingV3(encoder="tiny", dtype=jnp.float32, attn_impl="xla",
                              cfg=jda3.DA3Config(vit_config=jvit.ViTConfig(**VIT),
                                                 out_indices=(0, 1, 2, 3), features=16,
                                                 out_channels=(8, 16, 32, 32)))
    da3 = random_params(jm, jnp.zeros((1, SIDE, SIDE, 3)), seed=1)
    assert sorted(state_dict_from_jax(da3)) == sorted(da3_from_jax(da3))


# --- the camera fit ------------------------------------------------------------


def test_perspective_fields_match_jax():
    roll, pitch, focal = 0.3, -0.2, 71.0
    for r, p in ((roll, pitch), (-1.1, 0.6)):
        ref = np.asarray(jgc.gravity_in_camera(jnp.float32(r), jnp.float32(p)))
        ours = tgc.gravity_in_camera(torch.tensor(r), torch.tensor(p))
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-7)
    ref_up, ref_lat = jgc.perspective_fields(jnp.float32(roll), jnp.float32(pitch),
                                             jnp.float32(focal), (40, 52))
    up, lat = tgc.perspective_fields(torch.tensor(roll), torch.tensor(pitch),
                                     torch.tensor(focal), (40, 52))
    assert up.shape == (40, 52, 2) and lat.shape == (40, 52)
    assert rel_err(up.numpy(), np.asarray(ref_up)) < 1e-5
    assert rel_err(lat.numpy(), np.asarray(ref_lat)) < 1e-5


@pytest.mark.parametrize("theta", [(0.1, -0.2, 40.0), (1.2, 0.5, 300.0), (-2.0, 0.05, 5.0)])
def test_written_out_jacobian_matches_autodiff(theta):
    """The fit's Jacobian, the chain rule written out, against forward-mode
    autodiff of ``perspective_fields`` (the JAX fit's ``jax.jacfwd``)."""
    hw = (23, 31)
    t = torch.tensor([theta[0], theta[1], np.log(theta[2])], dtype=torch.float32)
    up, lat, dup, dlat = tgc.fields_and_jacobian(t, hw)

    def fields(x):
        return torch.cat([f.reshape(-1) for f in tgc.perspective_fields(x[0], x[1],
                                                                         torch.exp(x[2]), hw)])

    ref = torch.func.jacfwd(fields)(t)
    assert rel_err(torch.cat([up.reshape(-1), lat.reshape(-1)]).numpy(), fields(t).numpy()) < 1e-6
    assert rel_err(torch.cat([dup.reshape(-1, 3), dlat.reshape(-1, 3)]).numpy(),
                   ref.numpy()) < 1e-5


def test_fit_camera_recovers_synthetic():
    """The JAX test's set-up: perfect fields, 12 steps."""
    hw = (60, 80)
    roll, pitch, focal = 0.12, -0.25, 95.0
    up, lat = tgc.perspective_fields(torch.tensor(roll), torch.tensor(pitch),
                                     torch.tensor(focal), hw)
    w = torch.ones(hw)
    est = tgc.fit_camera(up, lat, w, w, hw, iters=12)
    assert sorted(est) == sorted(ESTIMATES)
    assert all(v.shape == () and v.dtype == torch.float32 for v in est.values())
    assert abs(float(est["roll"]) - roll) < 1e-3
    assert abs(float(est["pitch"]) - pitch) < 1e-3
    assert abs(float(est["focal"]) - focal) / focal < 1e-3
    assert float(est["roll_uncertainty"]) < 1e-3  # perfect observations
    assert abs(float(est["vfov"]) - 2 * np.arctan(hw[0] / (2 * focal))) < 1e-3


def test_fit_camera_matches_jax_on_noisy_weighted_fields():
    hw = (48, 64)
    rng = np.random.default_rng(12)
    up, lat = jgc.perspective_fields(jnp.float32(-0.08), jnp.float32(0.18), jnp.float32(80.0),
                                     hw)
    up = np.asarray(up) + 0.05 * rng.standard_normal((*hw, 2)).astype(np.float32)
    up /= np.linalg.norm(up, axis=-1, keepdims=True)
    lat = np.asarray(lat) + 0.03 * rng.standard_normal(hw).astype(np.float32)
    w_up, w_lat = (rng.uniform(0.1, 1.0, hw).astype(np.float32) for _ in range(2))
    ref = jax.jit(functools.partial(jgc.fit_camera, hw=hw, iters=10))(
        *(jnp.asarray(a) for a in (up, lat, w_up, w_lat)))
    ours = tgc.fit_camera(*(torch.from_numpy(a) for a in (up, lat, w_up, w_lat)), hw, iters=10)
    assert sorted(ours) == sorted(ref) == sorted(ESTIMATES)
    for key in ESTIMATES:
        assert rel_err(ours[key].numpy(), np.asarray(ref[key])) < REL_TOL, key
    assert abs(float(ours["pitch"]) - 0.18) < 0.02  # still near the camera


# --- sizes, names and routes ---------------------------------------------------


@pytest.mark.parametrize("name,make", [("sidepth_vits", tsi.SIDepth),
                                       ("geocalib_vits", tgc.GeoCalib)])
def test_full_size_keys_equal_the_manifest(name, make):
    import json
    import os

    with open(os.path.join(MANIFESTS, f"{name}.json")) as f:
        manifest = json.load(f)["keys"]
    with torch.device("meta"):
        sd = make().state_dict()
    assert {k: list(v.shape) for k, v in sd.items()} == manifest


@pytest.mark.parametrize("name,want", [("sidepth", "sidepth_vits_518x518_bf16"),
                                       ("geocalib", "geocalib_vits_322x322_bf16")])
def test_full_size_builds_with_the_jax_artifact_names(monkeypatch, name, want):
    """On the meta device, no weights; int8 raises on both sides, as neither
    family has an int8 path."""
    monkeypatch.setattr(store, "resolve_weights", lambda *a, **k: None)
    from monocular_depth_estimation_trt_tpu.weights import store as jstore

    monkeypatch.setattr(jstore, "get_or_convert_params", lambda *a, **k: {})
    jpipe = jreg.build_pipeline(name)
    tpipe = treg.build_pipeline(name, device="meta")
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name() == want
    assert tpipe.viz == jpipe.viz
    with pytest.raises(ValueError, match="int8"):
        treg.build_pipeline(name, device="meta", precision="int8")
    with pytest.raises(ValueError, match="int8"):
        jreg.build_pipeline(name, precision="int8")


# --- the pipelines -------------------------------------------------------------


def _pipes(name, monkeypatch, **kw):
    params = _tiny(name)["params"]
    module, cls = {"sidepth": (jsi, "SIDepth"), "geocalib": (jgc, "GeoCalib")}[name]
    monkeypatch.setattr(module, cls, functools.partial(getattr(module, cls), **_jax_kw()))
    kw = dict(encoder="tiny", input_size=SIDE, precision="fp32", attn_impl="xla", **kw)
    jpipe = jreg.build_pipeline(name, params=params, **kw)
    convert = sidepth_from_jax if name == "sidepth" else geocalib_from_jax
    tpipe = treg.build_pipeline(name, params=convert(params), device="cpu", model_kw=_port_kw(),
                                **kw)
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name()
    return jpipe, tpipe


def test_sidepth_pipeline_matches_jax(monkeypatch):
    jpipe, tpipe = _pipes("sidepth", monkeypatch)
    frame = np.random.default_rng(3).integers(0, 256, (45, 61, 3), dtype=np.uint8)
    ref, ours = jpipe(frame, viz=True), tpipe(frame, viz=True)
    assert sorted(ours) == sorted(ref) == ["depth", "ssi", "viz"]
    for key in ("depth", "ssi"):
        assert ours[key].shape == (45, 61) and ours[key].dtype == np.float32, key
        assert rel_err(ours[key], ref[key]) < REL_TOL, key
    assert ours["depth"].min() >= 1e-3
    batch = tpipe.batch_call(np.stack([frame, frame]))
    assert rel_err(batch["depth"][1], ours["depth"]) < 1e-6


def _geocalib_frame():
    return np.random.default_rng(9).integers(0, 256, (48, 64, 3), dtype=np.uint8)


def test_geocalib_pipeline_matches_jax(monkeypatch):
    """The fields at the input size, the fit and the focal in the frame's
    pixels; no depth, no viz."""
    jpipe, tpipe = _pipes("geocalib", monkeypatch, iters=10)
    frame = _geocalib_frame()
    ref, ours = jpipe(frame, viz=True), tpipe(frame, viz=True)
    assert sorted(ours) == sorted(ref) == sorted(ESTIMATES + FIELDS)
    assert ours["up_field"].shape == (SIDE, SIDE, 2)
    for key in ESTIMATES + FIELDS:
        assert np.shape(ours[key]) == np.shape(ref[key]), key
        assert np.isfinite(ref[key]).all(), key
        assert rel_err(ours[key], ref[key]) < REL_TOL, key
    assert np.isclose(ours["focal"], 48 / (2 * np.tan(ours["vfov"] / 2)), rtol=1e-6)
    with pytest.raises(ValueError, match="one"):
        tpipe.batch_call(np.stack([frame, frame]))


def test_cli_run_geocalib_prints_the_calibration(monkeypatch, tmp_path, capsys):
    """``run geocalib`` on the CPU (the tiny model swapped in through
    ``build_pipeline``): the Roll / Pitch / vFoV / Focal lines of the JAX
    CLI and the npz of every output, equal to the pipeline's."""
    from monocular_depth_estimation_trt_tpu_torch.utils import imageio

    sd = geocalib_from_jax(_tiny("geocalib")["params"])
    build = treg.build_pipeline

    def tiny_build(name, **kw):
        assert name == "geocalib"
        return build(name, params=sd, input_size=SIDE, attn_impl="xla", model_kw=_port_kw(),
                     **kw)

    monkeypatch.setattr(treg, "build_pipeline", tiny_build)
    frame = _geocalib_frame()
    png = str(tmp_path / "frame.png")
    imageio.write_image(png, frame)
    out = tmp_path / "out"
    capsys.readouterr()
    assert tcli.main(["--device", "cpu", "run", "geocalib", "--encoder", "tiny", "--image", png,
                      "--out", str(out), "--precision", "fp32"]) == 0
    printed = capsys.readouterr().out
    want = tiny_build("geocalib", encoder="tiny", precision="fp32", device="cpu")(frame)
    deg = 180.0 / np.pi
    for line in (f"Roll:  {float(want['roll']) * deg:.1f}° "
                 f"(± {float(want['roll_uncertainty']) * deg:.1f})°",
                 f"Focal: {float(want['focal']):.1f} px "
                 f"(± {float(want['focal_uncertainty']):.1f} px)"):
        assert f"[MDET] {line}" in printed.splitlines()
    assert re.search(r"^\[MDET\] Pitch: .*°$", printed, re.M)
    assert re.search(r"^\[MDET\] vFoV: .*°$", printed, re.M)
    got = np.load(out / "frame_geocalib_tiny_70x70_fp32.npz")
    assert sorted(got.files) == sorted(want)
    for key in got.files:
        np.testing.assert_array_equal(got[key], want[key])
