"""The torch port's MoGe-2 and Metric Anything against the JAX package's, on
the CPU, fp32, one set of seeded weights on both sides (``torch_port_params``
and ``weights/from_jax.py``):

* ``grid_for_tokens``, ``normalized_view_plane_uv`` and the median of an
  even count (``jnp.median`` averages the two middle values);
* ``recover_focal_shift`` on seeded point maps with an even sample count,
  with and without a holed mask;
* ``MoGeHead`` and the whole ``MoGe2``, with and without the normal branch,
  at ``tests/test_parity_geometric.py``'s tiny config (dim 64, depth 4, 2
  heads, 25 tokens), the JAX side under ``jax.jit`` with its plain
  attention;
* the full-size key sets against ``weights/manifests/moge2_vits.json``,
  ``moge2_vitl.json`` and ``metric_anything.json``; the int8 guard
  (MoGe-2 vits serves bf16) and the JAX artifact names;
* the ``moge2`` and ``metric_anything`` pipelines against the JAX pipelines
  (model and focal/shift postprocess): equal masks, values compared on the
  mask, inf off it;
* ``run moge2 --mesh --mesh-format glb`` through the port's CLI on the CPU.

Readings on a CPU: rel errors 1.2e-7 to 8.5e-6 (bar 2e-3); the focal/shift
solve alone 6.6e-5 to 8.8e-4 (the JAX side's fp32 sums round the
Gauss-Newton step, ``ops/camera.py``).
"""

import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu import registry as jreg
from monocular_depth_estimation_trt_tpu.models import moge2 as jmoge
from monocular_depth_estimation_trt_tpu.models import vit as jvit
from monocular_depth_estimation_trt_tpu.ops import camera as jcam
from monocular_depth_estimation_trt_tpu_torch import cli as tcli
from monocular_depth_estimation_trt_tpu_torch import registry as treg
from monocular_depth_estimation_trt_tpu_torch.models import moge2 as tmoge
from monocular_depth_estimation_trt_tpu_torch.models import vit as tvit
from monocular_depth_estimation_trt_tpu_torch.ops import camera as tcam
from monocular_depth_estimation_trt_tpu_torch.ops import quant as tquant
from monocular_depth_estimation_trt_tpu_torch.weights import store
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import (
    moge2_from_jax,
    state_dict_from_jax,
)

from torch_port_params import random_params, rel_err

torch.set_num_threads(1)

REL_TOL = 2e-3  # fp32 on both sides
MANIFESTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "monocular_depth_estimation_trt_tpu", "weights", "manifests")
VIT = dict(dim=64, depth=4, num_heads=2, pretrain_img_size=70)
CFG = dict(proj_dim=32, up_dims=(16, 16, 8), out_indices=(0, 1, 2, 3))
TOKENS = 25
HW = (63, 112)
# Random weights leave the mask logit near 0, where the focal solve can read
# no pixel at all: a mask output bias of 1.5 keeps most pixels in the mask
# and some out of it.
MASK_BIAS = 1.5


def _jax_cfg():
    return jmoge.MoGeConfig(vit_config=jvit.ViTConfig(**VIT), **CFG)


def _port_cfg():
    return tmoge.MoGeConfig(vit_config=tvit.ViTConfig(**VIT), **CFG)


def _jax_model(normal):
    return jmoge.MoGe2(encoder="tiny", num_tokens=TOKENS, predict_normal=normal,
                       dtype=jnp.float32, attn_impl="xla", cfg=_jax_cfg())


@functools.lru_cache(maxsize=None)
def _tiny(normal):
    """The tiny JAX model's params (mask bias lifted), an input, and the JAX
    outputs."""
    x = np.random.default_rng(7).standard_normal((1, *HW, 3)).astype(np.float32) * 0.5
    jm = _jax_model(normal)
    params = random_params(jm, jnp.asarray(x), seed=5 + normal)
    params["head"]["mask_conv1"]["bias"] = np.full(1, MASK_BIAS, np.float32)
    out = jax.jit(lambda p, y: jm.apply({"params": p}, y))(params, jnp.asarray(x))
    return dict(normal=normal, params=params, x=x,
                out={k: np.asarray(v) for k, v in out.items()})


@pytest.fixture(params=[True, False], ids=["moge2", "metric_anything"])
def tiny(request):
    return _tiny(request.param)


# --- ops ---------------------------------------------------------------------


@pytest.mark.parametrize("hw,tokens", [((291, 518), 1800), ((518, 518), 3600),
                                       ((63, 112), 25), ((480, 640), 1200), ((700, 301), 999)])
def test_grid_for_tokens_matches_jax(hw, tokens):
    assert tmoge.grid_for_tokens(*hw, tokens) == jmoge.grid_for_tokens(*hw, tokens)


def test_main_path_token_counts():
    """K1's sequence lengths on the two families' main paths (plus cls)."""
    gh, gw = tmoge.grid_for_tokens(291, 518, 1800)
    assert (gh, gw, gh * gw + 1) == (32, 57, 1825)
    gh, gw = tmoge.grid_for_tokens(518, 518, 3600)
    assert (gh, gw, gh * gw + 1) == (60, 60, 3601)


@pytest.mark.parametrize("hw", [(5, 9), (291, 518), (64, 64)])
def test_view_plane_uv_matches_jax(hw):
    ours = tcam.normalized_view_plane_uv(*hw)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jcam.normalized_view_plane_uv(*hw)))
    assert tcam.normalized_view_plane_uv(*hw) is ours  # made once, kept


@pytest.mark.parametrize("n", [1, 2, 7, 4096])
def test_median_matches_jnp_median(n):
    x = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    ours = tcam._median(torch.from_numpy(x))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jnp.median(x, axis=-1,
                                                                      keepdims=True)))


def _point_map(seed, b=2, hw=(128, 192)):
    """Seeded affine-invariant point maps from known focals and shifts, with
    noise; a mask with holes (a block and scattered pixels)."""
    rng = np.random.default_rng(seed)
    uv = np.asarray(jcam.normalized_view_plane_uv(*hw))
    pts, masks = [], []
    for i in range(b):
        z = 2.0 + 2.0 * rng.random(hw) + 0.3 * np.sin(np.arange(hw[1]) / 9.0)[None]
        focal, shift = 0.6 + 0.4 * i, 0.8 + 0.5 * i
        p = np.stack([uv[..., 0] * z / focal, uv[..., 1] * z / focal, z - shift], axis=-1)
        pts.append(p + 0.01 * rng.standard_normal(p.shape))
        m = rng.random(hw) > 0.2
        m[20:60, 30:90] = False
        masks.append(m)
    return np.stack(pts).astype(np.float32), np.stack(masks)


@pytest.mark.parametrize("with_mask", [True, False])
def test_recover_focal_shift_matches_jax(with_mask):
    """128x192 maps downsample to 64x64 = 4096 samples: an even count, so
    the candidate search sits on the mean of the two middle z values."""
    pts, mask = _point_map(3)
    jmask = jnp.asarray(mask) if with_mask else None
    ref_f, ref_s = jax.jit(jcam.recover_focal_shift)(jnp.asarray(pts), jmask)
    f, s = tcam.recover_focal_shift(torch.from_numpy(pts),
                                    torch.from_numpy(mask) if with_mask else None)
    assert f.shape == s.shape == (2,)
    assert rel_err(f.numpy(), np.asarray(ref_f)) < REL_TOL
    assert rel_err(s.numpy(), np.asarray(ref_s)) < REL_TOL
    # near the known focals: the solver's own accuracy on these noisy maps
    # (both packages read about 0.57 and 0.95)
    np.testing.assert_allclose(f.numpy(), [0.6, 1.0], rtol=0.1)


# --- the model ---------------------------------------------------------------


def test_moge_head_matches_jax(tiny):
    rng = np.random.default_rng(2)
    feats = [(rng.standard_normal((1, 20, 64)).astype(np.float32),
              rng.standard_normal((1, 64)).astype(np.float32)) for _ in range(4)]
    jh = jmoge.MoGeHead(num_levels=4, proj_dim=CFG["proj_dim"], up_dims=CFG["up_dims"],
                        predict_normal=tiny["normal"], dtype=jnp.float32)
    jfeats = [tuple(jnp.asarray(t) for t in f) for f in feats]
    ref = jax.jit(lambda p, f: jh.apply({"params": p}, f, (4, 5), (37, 41)))(
        tiny["params"]["head"], jfeats)
    head = tmoge.MoGeHead(4, 64, CFG["proj_dim"], CFG["up_dims"], tiny["normal"])
    sd = moge2_from_jax(tiny["params"])
    head.load_state_dict({k[5:]: v for k, v in sd.items() if k.startswith("head.")},
                         strict=True)
    with torch.no_grad():
        ours = head([tuple(torch.from_numpy(t) for t in f) for f in feats], (4, 5), (37, 41))
    assert sorted(ours) == sorted(ref)
    for key, want in ref.items():
        assert ours[key].shape == want.shape, key
        assert rel_err(ours[key].numpy(), np.asarray(want)) < REL_TOL, key


def test_moge2_matches_jax(tiny):
    model = tmoge.MoGe2(num_tokens=TOKENS, predict_normal=tiny["normal"], attn_impl="xla",
                        cfg=_port_cfg())
    model.load_state_dict(moge2_from_jax(tiny["params"]), strict=True)
    assert sorted(state_dict_from_jax(tiny["params"])) == sorted(model.state_dict())
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(tiny["x"]))
    assert sorted(ours) == sorted(tiny["out"])
    for key, want in tiny["out"].items():
        assert ours[key].shape == want.shape, key
        assert rel_err(ours[key].numpy(), want) < REL_TOL, key


@pytest.mark.parametrize("name,kw", [("moge2_vits", {}), ("moge2_vitl", {"encoder": "vitl"}),
                                     ("metric_anything", {"encoder": "vitl", "num_tokens": 3600,
                                                          "predict_normal": False})])
def test_full_size_keys_equal_the_manifest(name, kw):
    with open(os.path.join(MANIFESTS, f"{name}.json")) as f:
        manifest = json.load(f)["keys"]
    with torch.device("meta"):
        sd = tmoge.MoGe2(**kw).state_dict()
    assert {k: list(v.shape) for k, v in sd.items()} == manifest


@pytest.mark.parametrize("name,precision,want", [("moge2", "int8", "bf16"),
                                                 ("metric_anything", "int8", "int8"),
                                                 ("moge2", "fp32", "fp32")])
def test_full_size_builds_with_the_jax_artifact_names(monkeypatch, name, precision, want):
    """On the meta device, no weights; int8 routes MoGe-2 vits to bf16 as in
    JAX, and quantizes Metric Anything's encoder linears (calibration, which
    runs the model, is stubbed)."""
    monkeypatch.setattr(jreg, "_params_for", lambda *a, **k: {})
    monkeypatch.setattr(store, "resolve_weights", lambda *a, **k: None)
    monkeypatch.setattr(tquant, "calibrate", lambda model, targets, samples: {
        t: torch.zeros(model.get_submodule(t).in_features, device="meta") for t in targets})
    jpipe = jreg.build_pipeline(name, precision=precision)
    tpipe = treg.build_pipeline(name, device="meta", precision=precision)
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name()
    assert tpipe.spec.precision == jpipe.spec.precision == want
    assert tpipe.viz == jpipe.viz == "none"
    swapped = {n.split(".")[0] for n, m in tpipe.model.named_modules()
               if isinstance(m, tquant.QuantLinear)}
    assert swapped == ({"backbone"} if want == "int8" else set())


# --- the pipelines -------------------------------------------------------------


def _pipes(tiny, monkeypatch):
    name = "moge2" if tiny["normal"] else "metric_anything"
    kw = dict(encoder="tiny", input_hw=HW, num_tokens=TOKENS, precision="fp32",
              attn_impl="xla")
    monkeypatch.setattr(jmoge, "MoGe2", functools.partial(jmoge.MoGe2, cfg=_jax_cfg()))
    jpipe = jreg.build_pipeline(name, params=tiny["params"], **kw)
    tpipe = treg.build_pipeline(name, params=moge2_from_jax(tiny["params"]), device="cpu",
                                model_kw=dict(cfg=_port_cfg()), **kw)
    return name, jpipe, tpipe


def test_pointmap_pipeline_matches_jax(monkeypatch, tiny):
    """Model and focal/shift postprocess in one forward on the port's side,
    two programs on the JAX side: the same mask, the same values on it, inf
    depth and points (and zero normal) off it; outputs at the input size."""
    name, jpipe, tpipe = _pipes(tiny, monkeypatch)
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name()
    frame = np.random.default_rng(11).integers(0, 256, (90, 150, 3), dtype=np.uint8)
    ref, ours = jpipe(frame), tpipe(frame)
    keys = sorted(["depth", "focal", "mask", "metric_scale", "points"]
                  + (["normal"] if tiny["normal"] else []))
    assert sorted(ours) == sorted(ref) == keys
    mask = ours["mask"]
    assert mask.shape == HW and mask.dtype == np.bool_
    np.testing.assert_array_equal(mask, ref["mask"])
    assert 0.1 < mask.mean() < 1.0  # some pixels on each side
    assert ours["focal"].shape == ours["metric_scale"].shape == ()
    for key in ("focal", "metric_scale"):
        assert rel_err(ours[key], ref[key]) < REL_TOL, key
    for key in ("depth", "points") + (("normal",) if tiny["normal"] else ()):
        assert ours[key].shape[:2] == HW, key
        assert rel_err(ours[key][mask], ref[key][mask]) < REL_TOL, key
    assert np.isinf(ours["depth"][~mask]).all() and np.isinf(ours["points"][~mask]).all()
    assert np.isfinite(ours["depth"][mask]).all()
    if tiny["normal"]:
        assert not ours["normal"][~mask].any()
    batch = tpipe.batch_call(np.stack([frame, frame]))
    np.testing.assert_array_equal(batch["mask"][1], mask)
    assert rel_err(batch["depth"][1][mask], ours["depth"][mask]) < 1e-6


def test_cli_run_moge2_writes_the_mesh(monkeypatch, tmp_path):
    """``run moge2 --mesh --mesh-format glb`` on the CPU (the tiny model
    swapped in through ``build_pipeline``): the npz holds every output equal
    to the pipeline's, the ``.glb`` mesh and the ``_fov.json`` are written."""
    from monocular_depth_estimation_trt_tpu_torch.utils import imageio

    sd = moge2_from_jax(_tiny(True)["params"])
    build = treg.build_pipeline

    def tiny_build(name, **kw):
        assert name == "moge2"
        return build(name, params=sd, input_hw=HW, num_tokens=TOKENS, attn_impl="xla",
                     model_kw=dict(cfg=_port_cfg()), **kw)

    monkeypatch.setattr(treg, "build_pipeline", tiny_build)
    frame = np.random.default_rng(4).integers(0, 256, (90, 150, 3), dtype=np.uint8)
    png = str(tmp_path / "frame.png")
    imageio.write_image(png, frame)
    out = tmp_path / "out"
    assert tcli.main(["--device", "cpu", "run", "moge2", "--encoder", "tiny", "--image", png,
                      "--out", str(out), "--precision", "fp32", "--mesh",
                      "--mesh-format", "glb"]) == 0
    stem = "frame_moge2_tiny_normal_63x112_metric_fp32"
    got = np.load(out / f"{stem}.npz")
    want = tiny_build("moge2", encoder="tiny", precision="fp32", device="cpu")(frame)
    assert sorted(got.files) == sorted(want) == ["depth", "focal", "mask", "metric_scale",
                                                 "normal", "points"]
    for key in got.files:
        np.testing.assert_array_equal(got[key], want[key])
    with open(out / f"{stem}.glb", "rb") as f:
        assert f.read(4) == b"glTF"
    # the fov of the normalized focal, on the view plane of the 63x112 output
    f, diag = float(want["focal"]), math.hypot(*HW)
    assert f > 0
    with open(out / f"{stem}_fov.json") as fh:
        assert json.load(fh) == {
            "fov_x": round(math.degrees(2 * math.atan(HW[1] / diag / f)), 2),
            "fov_y": round(math.degrees(2 * math.atan(HW[0] / diag / f)), 2)}
