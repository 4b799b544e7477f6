"""The torch port's UniDepth V2 and UniK3D against the JAX package's, on the
CPU, fp32, one set of seeded weights on both sides (``torch_port_params``
and ``weights/from_jax.py``):

* the degree-8 real SH basis, ``CrossAttentionBlock`` (cross and self),
  ``patch_center_rays`` and ``rescale_intrinsics``;
* the whole ``GeometricDepthModel`` in both modes at
  ``tests/test_parity_geometric.py``'s tiny config (dim 64, depth 4, 2 heads,
  decoder 64, 70x84), and at head_dim 64 (dim 128, 2 heads), where the
  port's ``"auto"`` attention takes K1's wrapper (its plain version on the
  CPU), the JAX side under ``jax.jit`` with its plain attention;
* int8 with the JAX ``q8`` collection carried over;
* the full-size key sets against ``weights/manifests/unidepth_vit{s,b,l}.json``
  and ``unik3d_vit{b,l}.json``, ``state_dict_from_jax``'s dispatch, the JAX
  artifact names (int8 too);
* the ``unidepth_v2`` and ``unik3d`` pipelines against the JAX pipelines at
  a frame of another size (points, confidence, depth, rescaled intrinsics);
* ``run unidepth_v2`` through the port's CLI on the CPU (npz and
  ``_fov.json``).

Readings on a CPU: rel errors below 1e-5 (bar 2e-3).
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
from monocular_depth_estimation_trt_tpu.models import geometric as jgeo
from monocular_depth_estimation_trt_tpu.models import vit as jvit
from monocular_depth_estimation_trt_tpu.ops import camera as jcam
from monocular_depth_estimation_trt_tpu.ops import quant as jquant
from monocular_depth_estimation_trt_tpu.ops import spherical_harmonics as jsh
from monocular_depth_estimation_trt_tpu_torch import cli as tcli
from monocular_depth_estimation_trt_tpu_torch import registry as treg
from monocular_depth_estimation_trt_tpu_torch.models import geometric as tgeo
from monocular_depth_estimation_trt_tpu_torch.models import vit as tvit
from monocular_depth_estimation_trt_tpu_torch.ops import camera as tcam
from monocular_depth_estimation_trt_tpu_torch.ops import quant as tquant
from monocular_depth_estimation_trt_tpu_torch.ops import spherical_harmonics as tsh
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import flash_attention as fa
from monocular_depth_estimation_trt_tpu_torch.weights import store
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import (
    _xattn_block_from_jax,
    geometric_from_jax,
    q8_from_jax,
    state_dict_from_jax,
)

from torch_port_params import random_params, rel_err

torch.set_num_threads(1)

REL_TOL = 2e-3  # fp32 on both sides
MANIFESTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "monocular_depth_estimation_trt_tpu", "weights", "manifests")
VITS = {"tiny": dict(dim=64, depth=4, num_heads=2, pretrain_img_size=70),
        # head_dim 64: the port's "auto" route reaches K1
        "k1": dict(dim=128, depth=4, num_heads=2, pretrain_img_size=70)}
DEC = 64
TAPS = (0, 1, 2, 3)
HW = (70, 84)
MODES = {"unidepth_v2": "unidepth", "unik3d": "unik3d"}


def _jax_cfg(vit="tiny"):
    return jgeo.GeometricConfig(vit_config=jvit.ViTConfig(**VITS[vit]), decoder_dim=DEC,
                                out_indices=TAPS)


def _port_cfg(vit="tiny"):
    return tgeo.GeometricConfig(vit_config=tvit.ViTConfig(**VITS[vit]), decoder_dim=DEC,
                                out_indices=TAPS)


def _jax_model(mode, vit="tiny", quant="none"):
    return jgeo.GeometricDepthModel(encoder="tiny", mode=mode, dtype=jnp.float32,
                                    attn_impl="xla", quant=quant, cfg=_jax_cfg(vit))


@functools.lru_cache(maxsize=None)
def _tiny(mode, vit="tiny"):
    """The tiny JAX model's params, an input, and the JAX outputs."""
    x = np.random.default_rng(5).standard_normal((1, *HW, 3)).astype(np.float32) * 0.5
    jm = _jax_model(mode, vit)
    params = random_params(jm, jnp.asarray(x), seed=21 + len(mode))
    out = jax.jit(lambda p, y: jm.apply({"params": p}, y))(params, jnp.asarray(x))
    return dict(params=params, x=x, out={k: np.asarray(v) for k, v in out.items()})


def _port_model(mode, params, vit="tiny", attn_impl="xla"):
    model = tgeo.GeometricDepthModel("tiny", mode, attn_impl, cfg=_port_cfg(vit))
    model.load_state_dict(geometric_from_jax(params), strict=True)
    return model.eval()


# --- ops ---------------------------------------------------------------------


def test_spherical_harmonics_match_jax():
    v = np.random.default_rng(0).standard_normal((257, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    ref = np.asarray(jsh.real_spherical_harmonics(jnp.asarray(v), 8))
    ours = tsh.real_spherical_harmonics(torch.from_numpy(v), 8)
    assert ours.dtype == torch.float32 and ours.shape == (257, tsh.num_sh_components(8)) \
        == (257, 81)
    assert rel_err(ours.numpy(), ref) < 1e-5
    assert tsh.num_sh_components(3) == jsh.num_sh_components(3) == 16


@pytest.mark.parametrize("cross", [True, False], ids=["cross", "self"])
def test_cross_attention_block_matches_jax(cross):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, DEC)).astype(np.float32)
    ctx = rng.standard_normal((2, 31, DEC)).astype(np.float32) if cross else None
    jb = jgeo.CrossAttentionBlock(DEC, 2, jnp.float32)
    args = (jnp.asarray(x),) + ((jnp.asarray(ctx),) if cross else ())
    params = random_params(jb, *args, seed=4)
    ref = jax.jit(lambda p, *a: jb.apply({"params": p}, *a))(params, *args)
    block = tgeo.CrossAttentionBlock(DEC, 2, cross=cross)
    sd = {}
    _xattn_block_from_jax(params, "b", sd)
    block.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        ours = block(torch.from_numpy(x), None if ctx is None else torch.from_numpy(ctx))
    assert rel_err(ours.numpy(), np.asarray(ref)) < 1e-5


def test_patch_center_rays_and_intrinsics_rescale_match_jax():
    K = np.array([[[300.0, 0, 250.0], [0, 280.0, 270.0], [0, 0, 1]],
                  [[90.0, 0, 20.0], [0, 120.0, 33.0], [0, 0, 1]]], np.float32)
    ref = np.asarray(jgeo.patch_center_rays(jnp.asarray(K), (518, 518), (37, 37)))
    ours = tgeo.patch_center_rays(torch.from_numpy(K), (518, 518), (37, 37))
    assert ours.shape == (2, 37 * 37, 3)
    assert rel_err(ours.numpy(), ref) < 1e-6
    np.testing.assert_allclose(torch.linalg.vector_norm(ours, dim=-1).numpy(), 1.0, rtol=1e-6)
    ref = np.asarray(jcam.rescale_intrinsics(jnp.asarray(K[0]), (518, 518), (480, 640)))
    np.testing.assert_array_equal(
        tcam.rescale_intrinsics(torch.from_numpy(K[0]), (518, 518), (480, 640)).numpy(), ref)


# --- the model ---------------------------------------------------------------


@pytest.mark.parametrize("mode,vit", [("unidepth", "tiny"), ("unik3d", "tiny"),
                                      ("unidepth", "k1")])
def test_geometric_model_matches_jax(mode, vit):
    tiny = _tiny(mode, vit)
    model = _port_model(mode, tiny["params"], vit, attn_impl="auto" if vit == "k1" else "xla")
    assert sorted(state_dict_from_jax(tiny["params"])) == sorted(model.state_dict())
    assert hasattr(model, "rays_module") == (mode == "unik3d")
    before = fa.flash_attention_packed.launches
    calls = []
    plain = fa.flash_attention_packed

    def spy(qkv, num_heads):
        calls.append(tuple(qkv.shape))
        return plain(qkv, num_heads)

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr("monocular_depth_estimation_trt_tpu_torch.models.vit."
                   "flash_attention_packed", spy)
        ours = model(torch.from_numpy(tiny["x"]))
    # at head_dim 64 each encoder block goes through K1's wrapper (5x6
    # patches, cls and 4 registers); the decoder's attention is plain on
    # every device
    assert calls == ([(1, 35, 3 * 128)] * 4 if vit == "k1" else [])
    assert fa.flash_attention_packed.launches == before  # CPU: the plain version
    assert sorted(ours) == sorted(tiny["out"]) == ["confidence", "intrinsics", "pts_3d"]
    for key, want in tiny["out"].items():
        assert ours[key].shape == want.shape and ours[key].dtype == torch.float32, key
        assert rel_err(ours[key].numpy(), want) < REL_TOL, key


def test_unidepth_with_the_jax_q8_matches_jax():
    tiny = _tiny("unidepth")
    xs = [tiny["x"], np.random.default_rng(6).standard_normal((1, *HW, 3)).astype(np.float32)]
    serve = _jax_model("unidepth", quant="serve")
    q8 = jquant.quantize_vit_pipeline(_jax_model("unidepth", quant="calib"), serve,
                                      tiny["params"], tuple(jnp.asarray(x) for x in xs))
    ref = jax.jit(lambda v, y: serve.apply(v, y))({"params": tiny["params"], "q8": q8},
                                                  jnp.asarray(xs[0]))
    model = _port_model("unidepth", tiny["params"])
    ported = q8_from_jax(q8, "unidepth_v2")
    assert sorted(ported) == sorted(model.int8_targets())
    assert len(ported) == 4 * VITS["tiny"]["depth"]
    assert q8_from_jax(q8, "unik3d").keys() == ported.keys()
    tquant.install_q8(model, ported)
    with torch.no_grad():
        ours = model(torch.from_numpy(xs[0]))
    for key in ("pts_3d", "confidence", "intrinsics"):
        assert rel_err(ours[key].numpy(), np.asarray(ref[key])) < REL_TOL, key


@pytest.mark.parametrize("name,kw", [
    ("unidepth_vits", dict(encoder="vits")), ("unidepth_vitb", {}),
    ("unidepth_vitl", dict(encoder="vitl")), ("unik3d_vitb", dict(mode="unik3d")),
    ("unik3d_vitl", dict(encoder="vitl", mode="unik3d"))])
def test_full_size_keys_equal_the_manifest(name, kw):
    with open(os.path.join(MANIFESTS, f"{name}.json")) as f:
        manifest = json.load(f)["keys"]
    with torch.device("meta"):
        sd = tgeo.GeometricDepthModel(**kw).state_dict()
    assert {k: list(v.shape) for k, v in sd.items()} == manifest


def test_main_path_token_count_and_decoder_heads():
    """vitb at 518²: 37x37 patches, a class token and 4 registers (K1's N =
    1374 at 12 heads); decoder width 384 at 6 heads of 64."""
    with torch.device("meta"):
        model = tgeo.GeometricDepthModel()
    assert model.pixel_encoder.register_tokens.shape == (1, 4, 768)
    assert model.pixel_encoder.blocks[0].attn.num_heads == 12
    assert 37 * 37 + 1 + 4 == 1374
    assert model.camera.cross.num_heads == 6 and tgeo.DECODER_DIMS == jgeo.DECODER_DIMS
    assert tgeo.SH_DEGREE == jgeo.SH_DEGREE == 8


@pytest.mark.parametrize("name,precision", [("unidepth_v2", "bf16"), ("unidepth_v2", "int8"),
                                            ("unik3d", "int8"), ("unik3d", "fp32")])
def test_full_size_builds_with_the_jax_artifact_names(monkeypatch, name, precision):
    """On the meta device, no weights; int8 quantizes the pixel encoder's
    linears (calibration, which runs the model, is stubbed)."""
    monkeypatch.setattr(jreg, "_params_for", lambda *a, **k: {})
    monkeypatch.setattr(store, "resolve_weights", lambda *a, **k: None)
    monkeypatch.setattr(tquant, "calibrate", lambda model, targets, samples: {
        t: torch.zeros(model.get_submodule(t).in_features, device="meta") for t in targets})
    jpipe = jreg.build_pipeline(name, precision=precision)
    with torch.device("meta"):
        tpipe = treg.build_pipeline(name, device="meta", precision=precision)
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name() \
        == f"{name}_vitb_518x518_metric_{precision}"
    assert tpipe.viz == jpipe.viz == "metric"
    swapped = [n for n, m in tpipe.model.named_modules() if isinstance(m, tquant.QuantLinear)]
    assert len(swapped) == (48 if precision == "int8" else 0)
    assert {n.split(".")[0] for n in swapped} <= {"pixel_encoder"}


# --- the pipelines -------------------------------------------------------------


def _pipes(name, monkeypatch):
    mode = MODES[name]
    params = _tiny(mode)["params"]
    monkeypatch.setattr(jgeo, "GeometricDepthModel",
                        functools.partial(jgeo.GeometricDepthModel, cfg=_jax_cfg()))
    kw = dict(encoder="tiny", input_size=HW[0], precision="fp32", attn_impl="xla")
    jpipe = jreg.build_pipeline(name, params=params, **kw)
    tpipe = treg.build_pipeline(name, params=geometric_from_jax(params), device="cpu",
                                model_kw=dict(cfg=_port_cfg()), **kw)
    return jpipe, tpipe


@pytest.mark.parametrize("name", sorted(MODES))
def test_geometric_pipeline_matches_jax(monkeypatch, name):
    jpipe, tpipe = _pipes(name, monkeypatch)
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name()
    frame = np.random.default_rng(8).integers(0, 256, (45, 61, 3), dtype=np.uint8)
    ref, ours = jpipe(frame, viz=True), tpipe(frame, viz=True)
    assert sorted(ours) == sorted(ref) == ["confidence", "depth", "intrinsics", "pts_3d", "viz"]
    assert ours["pts_3d"].shape == (45, 61, 3) and ours["intrinsics"].shape == (3, 3)
    for key in ("depth", "pts_3d", "confidence", "intrinsics"):
        assert ours[key].dtype == np.float32, key
        assert rel_err(ours[key], ref[key]) < REL_TOL, key
    assert ours["viz"].shape == (45, 61, 3) and ours["viz"].dtype == np.uint8
    batch = tpipe.batch_call(np.stack([frame, frame]))
    assert rel_err(batch["pts_3d"][1], ours["pts_3d"]) < 1e-6


def test_cli_run_unidepth_writes_points_and_fov(monkeypatch, tmp_path):
    """``run unidepth_v2`` on the CPU (the tiny model swapped in through
    ``build_pipeline``): the npz holds every output but the viz equal to the
    pipeline's; ``_fov.json`` is the intrinsics' field of view."""
    from monocular_depth_estimation_trt_tpu_torch.utils import imageio

    sd = geometric_from_jax(_tiny("unidepth")["params"])
    build = treg.build_pipeline

    def tiny_build(name, **kw):
        assert name == "unidepth_v2"
        return build(name, params=sd, input_size=HW[0], attn_impl="xla",
                     model_kw=dict(cfg=_port_cfg()), **kw)

    monkeypatch.setattr(treg, "build_pipeline", tiny_build)
    frame = np.random.default_rng(2).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    png = str(tmp_path / "frame.png")
    imageio.write_image(png, frame)
    out = tmp_path / "out"
    assert tcli.main(["--device", "cpu", "run", "unidepth_v2", "--encoder", "tiny", "--image",
                      png, "--out", str(out), "--precision", "fp32"]) == 0
    stem = "frame_unidepth_v2_tiny_70x70_metric_fp32"
    got = np.load(out / f"{stem}.npz")
    want = tiny_build("unidepth_v2", encoder="tiny", precision="fp32", device="cpu")(frame)
    assert sorted(got.files) == ["confidence", "depth", "intrinsics", "pts_3d"]
    for key in got.files:
        np.testing.assert_array_equal(got[key], want[key])
    K = want["intrinsics"]
    with open(out / f"{stem}_fov.json") as fh:
        assert json.load(fh) == {
            "fov_x": round(math.degrees(2 * math.atan(0.5 * 64 / K[0, 0])), 2),
            "fov_y": round(math.degrees(2 * math.atan(0.5 * 48 / K[1, 1])), 2)}
