"""The port's int8 (w8a8) serving path as a whole against the JAX package, on
the CPU at tiny sizes: a DA-V2 model with the JAX ``q8`` collection carried
over, each side's own calibration of one model, the ``build_pipeline``
int8 path of DA-V2, VGGT and Depth Pro, the calibration images and the
small-encoder guard.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monocular_depth_estimation_trt_tpu.models.depth_anything_v2 as jda
import monocular_depth_estimation_trt_tpu.models.vit as jvit
from monocular_depth_estimation_trt_tpu import registry as jreg
from monocular_depth_estimation_trt_tpu.models import depth_pro as jdp
from monocular_depth_estimation_trt_tpu.models import vggt as jvggt
from monocular_depth_estimation_trt_tpu.ops import quant as jquant
from monocular_depth_estimation_trt_tpu_torch import registry as treg
from monocular_depth_estimation_trt_tpu_torch.models import depth_pro as tdp
from monocular_depth_estimation_trt_tpu_torch.models import vggt as tvggt
from monocular_depth_estimation_trt_tpu_torch.models import vit as tvit
from monocular_depth_estimation_trt_tpu_torch.models.depth_anything_v2 import DepthAnythingV2
from monocular_depth_estimation_trt_tpu_torch.ops import quant as tquant
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import quant_matmul as qm
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import (
    depth_pro_from_jax,
    q8_from_jax,
    state_dict_from_jax,
    vggt_from_jax,
)

from torch_port_params import lift_depth_pro_outputs, random_params, rel_err

torch.set_num_threads(1)

DEPTH_REL_TOL = 2e-3  # fp32 on both sides, the same int8 artifacts (readings 1.7e-6 to 2.2e-4)
# Each side's own fp32 calibration: the absmax statistics agree to about
# 1e-6, so a weight whose smoothed value sits that close to a rounding tie
# may quantize one step apart. Readings at 3 weight seeds: 0 to 1 of the
# 196,608 weights; the depth of the two 3.7e-6 to 3.5e-4 apart.
KERNEL_Q_TIE_SHARE = 1e-4
OWN_CALIB_REL_TOL = 2e-3
# int8 serving computes in bf16 on both sides, and XLA and PyTorch round the
# bf16 graph at other places: max rel readings 9.3e-3 to 3.6e-2 at 3 weight
# seeds (the bar is about twice the largest), Pearson r above 0.9994.
PIPELINE_BF16_REL_TOL = 7.5e-2
PEARSON_MIN = 0.98  # the JAX package's own bar (tests/test_quant.py)

TINY = dict(vit=dict(dim=64, depth=4, num_heads=2, pretrain_img_size=70),
            head=dict(features=16, out_channels=(8, 16, 32, 32)), taps=(0, 1, 2, 3))
SIZE = 70


def _jax_tiny_da(monkeypatch, quant="none"):
    monkeypatch.setitem(jvit.VIT_CONFIGS, "tiny", jvit.ViTConfig(**TINY["vit"]))
    monkeypatch.setitem(jda.HEAD_CONFIGS, "tiny", TINY["head"])
    monkeypatch.setitem(jda.INTERMEDIATE_LAYER_IDX, "tiny", TINY["taps"])
    return jda.DepthAnythingV2(encoder="tiny", dtype=jnp.float32, attn_impl="xla", quant=quant)


def _port_kw():
    return dict(vit_config=tvit.ViTConfig(**TINY["vit"]), head_features=TINY["head"]["features"],
                head_out_channels=TINY["head"]["out_channels"], out_indices=TINY["taps"])


def _images(n, hw, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(n)]


def _pearson(a, b):
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


@pytest.fixture
def da(monkeypatch):
    """The tiny DA-V2 (head_dim 32, plain attention on both sides), its
    params, the JAX q8 calibrated on two inputs, the JAX int8 depth, and the
    port's fp32 model on those params."""
    jm = _jax_tiny_da(monkeypatch)
    rng = np.random.default_rng(7)
    xs = [rng.uniform(-2, 2, (1, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2)]
    params = random_params(jm, jnp.asarray(xs[0]), seed=5)
    serve = _jax_tiny_da(monkeypatch, "serve")
    q8 = jquant.quantize_vit_pipeline(_jax_tiny_da(monkeypatch, "calib"), serve, params,
                                      tuple(jnp.asarray(x) for x in xs))
    depth = np.asarray(jax.jit(lambda v, y: serve.apply(v, y))({"params": params, "q8": q8},
                                                               jnp.asarray(xs[0])))
    tm = DepthAnythingV2(encoder="tiny", attn_impl="xla", **_port_kw())
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return dict(params=params, q8=q8, xs=xs, depth=depth, model=tm.eval())


def test_da_with_the_jax_q8_matches_jax(da):
    model = da["model"]
    q8 = q8_from_jax(da["q8"], "depth_anything_v2")
    assert sorted(q8) == sorted(model.int8_targets())
    assert len(q8) == 4 * TINY["vit"]["depth"]
    tquant.install_q8(model, q8)
    before = qm.w8a8_matmul.launches
    with torch.no_grad():
        ours = model(torch.from_numpy(da["xs"][0])).numpy()
    assert qm.w8a8_matmul.launches == before  # CPU: the plain version
    assert rel_err(ours, da["depth"]) < DEPTH_REL_TOL


def test_da_calibrated_by_each_side_agrees_up_to_rounding_ties(da):
    model = da["model"]
    targets = model.int8_targets()
    tquant.quantize_model_bundle(model, tquant.full_precision(model, targets),
                                 [torch.from_numpy(x) for x in da["xs"]])
    ref = q8_from_jax(da["q8"], "depth_anything_v2")
    apart, total = 0, 0
    for path in targets:
        layer = model.get_submodule(path)
        assert isinstance(layer, tquant.QuantLinear) and layer.bias.dtype == torch.float32
        diff = (layer.weight_q.int() - ref[path]["weight_q"].int()).abs()
        assert int(diff.max()) <= 1, path
        apart += int((diff > 0).sum())
        total += diff.numel()
        np.testing.assert_allclose(layer.qmul.numpy(), ref[path]["qmul"].numpy(), rtol=1e-5)
    assert apart <= KERNEL_Q_TIE_SHARE * total, (apart, total)
    with torch.no_grad():
        ours = model(torch.from_numpy(da["xs"][0])).numpy()
    assert rel_err(ours, da["depth"]) < OWN_CALIB_REL_TOL


def test_da_int8_pipelines_agree(monkeypatch):
    """build_pipeline(precision="int8", calib_images=...) on both sides, the
    tiny encoder patched into the JAX presets: the same artifact name, every
    encoder Dense quantized, the bf16 graphs' depth within a bar of each
    other, and the port's int8 depth tracking its fp32 path."""
    jm = _jax_tiny_da(monkeypatch)
    params = random_params(jm, jnp.zeros((1, SIZE, SIZE, 3)), seed=9)
    calib = _images(2, (80, 80), seed=1)
    kw = dict(encoder="tiny", input_size=SIZE, calib_images=calib)
    jpipe = jreg.build_pipeline("depth_anything_v2", precision="int8", params=params,
                                attn_impl="xla", **kw)
    sd = state_dict_from_jax(params)
    tpipe = treg.build_pipeline("depth_anything_v2", precision="int8", params=sd, device="cpu",
                                attn_impl="xla", model_kw=_port_kw(), **kw)
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name() == "depth_anything_v2_tiny_70x70_int8"
    swapped = [n for n, m in tpipe.model.named_modules() if isinstance(m, tquant.QuantLinear)]
    assert sorted(swapped) == sorted(q8_from_jax(jpipe.params["q8"], "depth_anything_v2"))
    fp32 = treg.build_pipeline("depth_anything_v2", precision="fp32", params=sd, device="cpu",
                               encoder="tiny", input_size=SIZE, model_kw=_port_kw())
    frame = _images(1, (64, 80), seed=2)[0]
    ref, ours = jpipe(frame)["depth"], tpipe(frame)["depth"]
    assert ours.shape == (64, 80) and np.isfinite(ours).all()
    assert rel_err(ours, ref) < PIPELINE_BF16_REL_TOL
    assert _pearson(ours, fp32(frame)["depth"]) > PEARSON_MIN


def _q8_paths(struct, family):
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), struct)
    return sorted(q8_from_jax(zeros, family))


def test_vggt_int8_quantizes_the_jax_set_and_tracks_fp32():
    vit = dict(dim=128, depth=1, num_heads=2, pretrain_img_size=SIZE)
    common = dict(dim=128, depth=2, num_heads=2, head_layers=(0, 1, 0, 1), encoder="vits",
                  head_features=16, head_out_channels=(8, 16, 32, 32))
    jcfg = jvggt.VGGTConfig(vit_config=jvit.ViTConfig(**vit), **common)
    jm = jvggt.VGGT(cfg=jcfg, dtype=jnp.float32, attn_impl="xla", with_camera=True)
    x = jnp.zeros((1, 1, SIZE, SIZE, 3))
    params = random_params(jm, x, seed=13)
    serve = jvggt.VGGT(cfg=jcfg, dtype=jnp.float32, attn_impl="xla", with_camera=True,
                       quant="serve")
    q8_struct = jax.eval_shape(serve.init, jax.random.PRNGKey(0), x)["q8"]
    assert set(q8_struct) == {"aggregator"}

    kw = dict(input_size=SIZE, params=vggt_from_jax(params), device="cpu",
              vggt_cfg=tvggt.VGGTConfig(vit_config=tvit.ViTConfig(**vit), **common))
    q = treg.build_pipeline("vggt", precision="int8", calib_images=_images(2, (70, 70), 3), **kw)
    f = treg.build_pipeline("vggt", precision="fp32", **kw)
    assert q.spec.artifact_name() == "vggt_70x70_metric_int8"
    swapped = sorted(n for n, m in q.model.named_modules() if isinstance(m, tquant.QuantLinear))
    assert swapped == _q8_paths(q8_struct, "vggt") == sorted(f.model.int8_targets())
    views = _images(2, (48, 64), seed=4)
    ours, ref = q.multi_view(np.stack(views)), f.multi_view(np.stack(views))
    for key in ("depth", "pose_enc"):
        assert np.isfinite(ours[key]).all()
        assert _pearson(ours[key], ref[key]) > PEARSON_MIN, key


def test_depth_pro_int8_quantizes_the_jax_set_and_tracks_fp32():
    """The small Depth Pro of tests/test_torch_depth_pro.py (512 input, 128
    windows, ViT dim 32, 3 blocks)."""
    geo = dict(img_size=512, window=128, stride0=96, stride1=64)
    head = dict(decoder_features=16, dims_encoder=(8, 16, 32, 32))
    vit = dict(dim=32, depth=3, num_heads=2, patch_size=16, pretrain_img_size=128)
    jcfg = jdp.DepthProConfig(**geo, hook_block_ids=(0, 1), vit_config=jvit.ViTConfig(**vit))
    x = jnp.zeros((1, 512, 512, 3))
    params = random_params(jdp.DepthPro(**head, dtype=jnp.float32, cfg=jcfg), x, seed=17)
    lift_depth_pro_outputs(params)
    serve = jdp.DepthPro(**head, dtype=jnp.float32, cfg=jcfg, quant="serve")
    q8_struct = jax.eval_shape(serve.init, jax.random.PRNGKey(0), x)["q8"]

    tcfg = tdp.DepthProConfig(**geo, hook_block_ids=(0, 1), vit_config=tvit.ViTConfig(**vit))
    kw = dict(params=depth_pro_from_jax(params), device="cpu", model_kw=dict(cfg=tcfg, **head))
    q = treg.build_pipeline("depth_pro", precision="int8",
                            calib_images=_images(2, (512, 512), 5), **kw)
    f = treg.build_pipeline("depth_pro", precision="fp32", **kw)
    assert q.spec.artifact_name() == "depth_pro_512x512_int8"
    swapped = sorted(n for n, m in q.model.named_modules() if isinstance(m, tquant.QuantLinear))
    assert swapped == _q8_paths(q8_struct, "depth_pro") == sorted(f.model.int8_targets())
    frame = _images(1, (240, 320), seed=6)[0]
    ours, ref = q(frame), f(frame)
    assert np.isfinite(ours["depth"]).all() and np.isfinite(ours["f_px"])
    assert _pearson(1.0 / ours["depth"], 1.0 / ref["depth"]) > PEARSON_MIN


@pytest.mark.parametrize("hw", [SIZE, (64, 90)])
def test_calibration_images_match_jax(hw):
    """The synthetic textures (and the example photo, decoded by cv2 here)
    within 1 LSB of the JAX package's frames."""
    ref, ours = jreg._calibration_images(hw), treg._calibration_images(hw)
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        assert a.shape == b.shape and a.dtype == np.uint8
        assert int(np.abs(a.astype(int) - b.astype(int)).max()) <= 1


def test_small_encoder_guard(monkeypatch, capsys):
    """On the H100 vits int8 is slower than vits bf16 at batch 1 (PERF.md):
    int8 builds bf16 there unless MDET_FORCE_INT8=1, as in the JAX package."""
    monkeypatch.delenv("MDET_FORCE_INT8", raising=False)
    assert treg.INT8_MEMORY_BOUND_ENCODERS == jreg.INT8_MEMORY_BOUND_ENCODERS
    assert treg.INT8_FAMILIES == jreg.INT8_FAMILIES & set(treg.list_models())
    for enc, want in (("vits", "bf16"), ("small", "bf16"), ("vitl", "int8"), ("vitb", "int8")):
        assert treg.resolve_int8_precision("depth_anything_v2", enc, "int8") == want
        assert jreg.resolve_int8_precision("depth_anything_v2", enc, "int8") == want
    assert treg.resolve_int8_precision("depth_anything_v2", "vits", "bf16") == "bf16"
    assert "auto-routing int8 -> bf16" in capsys.readouterr().out
    monkeypatch.setenv("MDET_FORCE_INT8", "1")
    assert treg.resolve_int8_precision("depth_anything_v2", "vits", "int8") == "int8"
