"""The port's accuracy tools on the CPU, against the JAX package where it
has the same command: ``eval`` and ``quantcheck`` JSON against the JAX
CLI's, ``convert`` (the key manifests, the strict load's audit, the params
cache and its precedence), ``distill --promote`` / ``--qat`` and ``run
--colorbar``; and the port's copy of the key manifests against the JAX
package's files and every registry family's layout.

Tiny DA-V2 models (dim 64, 2 blocks) stand in for the real ones, swapped in
the way ``tests/test_cli_distill.py`` swaps them. Every test that writes the
params cache points ``MDET_CACHE_DIR`` at its own directory: the test cache
is shared by a worker's tests."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monocular_depth_estimation_trt_tpu.models.depth_anything_v2 as jda
import monocular_depth_estimation_trt_tpu.models.vit as jvit
from monocular_depth_estimation_trt_tpu import cli as jcli
from monocular_depth_estimation_trt_tpu import registry as jreg
from monocular_depth_estimation_trt_tpu.weights import manifest as jmanifest
from monocular_depth_estimation_trt_tpu_torch import cli
from monocular_depth_estimation_trt_tpu_torch import registry as treg
from monocular_depth_estimation_trt_tpu_torch.config import ModelSpec
from monocular_depth_estimation_trt_tpu_torch.models import depth_anything_v2 as tda
from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig
from monocular_depth_estimation_trt_tpu_torch.training import load_train_state, metrics
from monocular_depth_estimation_trt_tpu_torch.training.trainer import adamw, create_train_state
from monocular_depth_estimation_trt_tpu_torch.utils import imageio
from monocular_depth_estimation_trt_tpu_torch.weights import manifest, store
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import state_dict_from_jax

from torch_port_params import random_params

torch.set_num_threads(1)

# both CLIs round to 5 decimals (a last digit may round either way), after
# fp32 sums taken in another order (the affine fit's normal equations)
JSON_ABS_TOL, JSON_REL_TOL = 2e-5, 5e-5
TINY_KW = dict(vit_config=ViTConfig(dim=64, depth=2, num_heads=4, pretrain_img_size=56),
               head_features=16, head_out_channels=(8, 16, 32, 32), out_indices=(0, 1, 0, 1))
VITS_NAME = "depth_anything_v2_vits_518x518_bf16"


def _json_line(capsys):
    out = capsys.readouterr().out
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


def _same_json(ours, ref):
    assert list(ours) == list(ref)
    for k, v in ref.items():
        if isinstance(v, float):
            assert abs(ours[k] - v) <= JSON_ABS_TOL + JSON_REL_TOL * abs(v), (k, ours[k], v)
        else:
            assert ours[k] == v, k


def _eval_both(capsys, argv):
    rc_j = jcli.main(["eval", *argv])
    ref = _json_line(capsys)
    rc_t = cli.main(["eval", *argv])
    ours = _json_line(capsys)
    assert rc_j == rc_t == 0
    _same_json(ours, ref)
    return ours


# ---------------------------------------------------------------------------
# eval
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("align", ["none", "affine", "median"])
def test_eval_npz_dirs_match_the_jax_cli(tmp_path, capsys, align):
    rng = np.random.default_rng(1)
    pd, gd = tmp_path / "pred", tmp_path / "gt"
    pd.mkdir(), gd.mkdir()
    for i in range(3):
        gt = (np.abs(rng.standard_normal((12, 16))) + 0.5).astype(np.float32)
        np.savez(pd / f"im{i}.npz", depth=(2.0 * gt + 1.0 + 0.2 * rng.standard_normal(
            gt.shape)).astype(np.float32))
        np.savez(gd / f"im{i}.npz", depth=gt)
    np.savez(gd / "unpaired.npz", depth=np.ones((12, 16), np.float32))
    out = _eval_both(capsys, ["--pred", str(pd), "--gt", str(gd), "--align", align])
    assert out["n_images"] == 3 and out["align"] == align


def test_eval_npy_files_with_caps_match_the_jax_cli(tmp_path, capsys):
    rng = np.random.default_rng(2)
    gt = (np.abs(rng.standard_normal((20, 24))) * 30 + 0.5).astype(np.float32)
    gt[:3] = 0.0
    np.save(tmp_path / "a.npy", (gt * 1.1 + 0.3).astype(np.float32))
    np.save(tmp_path / "b.npy", gt)
    _eval_both(capsys, ["--pred", str(tmp_path / "a.npy"), "--gt", str(tmp_path / "b.npy"),
                        "--min-depth", "1.0", "--max-depth", "40", "--align", "median"])


@pytest.mark.parametrize("with_cv2", [True, False])
def test_eval_16bit_png_ground_truth_matches_the_jax_cli(tmp_path, capsys, monkeypatch,
                                                         with_cv2):
    """KITTI-style ground truth: uint16 PNG (meters * 256, holes 0), scored at
    its own resolution against a half-resolution npz, within the caps; the
    port reads it with cv2 or, without cv2, with its own PNG decoder."""
    import cv2

    yy, xx = np.mgrid[0:24, 0:32].astype(np.float32)
    gt = 0.5 + 2.0 * yy / 24 + 1.5 * xx / 32
    np.savez(tmp_path / "im0.npz", depth=gt[::2, ::2].copy())
    gt[:4] = 0.0
    gt[-2:] = 100.0
    cv2.imwrite(str(tmp_path / "im0.png"), (gt * 256.0).astype(np.uint16))
    cv2.imwrite(str(tmp_path / "k.png"), (gt * 1000.0).astype(np.uint16))
    if not with_cv2:
        monkeypatch.setattr(imageio, "_cv2", lambda: None)
    pred = str(tmp_path / "im0.npz")
    for argv in (["--gt", str(tmp_path / "im0.png"), "--min-depth", "0.001",
                  "--max-depth", "80"],
                 ["--gt", str(tmp_path / "im0.png")],
                 ["--gt", str(tmp_path / "k.png"), "--gt-scale", "1000", "--align", "affine"]):
        _eval_both(capsys, ["--pred", pred, *argv])


def test_eval_flow_matches_the_jax_cli(tmp_path, capsys):
    rng = np.random.default_rng(3)
    gt = (3 * rng.standard_normal((10, 12, 2))).astype(np.float32)
    np.save(tmp_path / "p.npy", (gt + rng.standard_normal(gt.shape)).astype(np.float32))
    np.save(tmp_path / "g.npy", gt)
    out = _eval_both(capsys, ["--pred", str(tmp_path / "p.npy"), "--gt",
                              str(tmp_path / "g.npy"), "--flow"])
    assert list(out) == ["epe", "acc_1px", "acc_3px", "acc_5px", "n_images", "align"]
    assert out["align"] is None


def test_eval_without_matching_stems_fails_as_the_jax_cli(tmp_path, capsys):
    for d in ("p", "g"):
        (tmp_path / d).mkdir()
    for name, d in (("a", "p"), ("b", "p"), ("c", "g"), ("d", "g")):
        np.save(tmp_path / d / f"{name}.npy", np.ones((4, 4), np.float32))
    argv = ["eval", "--pred", str(tmp_path / "p"), "--gt", str(tmp_path / "g")]
    assert jcli.main(argv) == cli.main(argv) == 1


# ---------------------------------------------------------------------------
# quantcheck
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_params():
    cfg = jvit.ViTConfig(dim=64, depth=2, num_heads=4, pretrain_img_size=56)
    model = jda.DepthAnythingV2(encoder="tiny", vit_config=cfg, head_features=16,
                                head_out_channels=(8, 16, 32, 32), out_indices=(0, 1, 0, 1),
                                dtype=jnp.float32, attn_impl="xla")
    return random_params(model, jnp.zeros((1, 70, 70, 3)), seed=9)


def _png_dir(tmp_path, n=2, hw=(64, 64), name="imgs", seed=4):
    d = tmp_path / name
    d.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        coarse = rng.integers(0, 256, (hw[0] // 8, hw[1] // 8, 3))
        img = np.repeat(np.repeat(coarse, 8, 0), 8, 1).astype(np.uint8)
        imageio.write_image(str(d / f"i{i}.png"), img)
    return str(d)


def test_quantcheck_matches_the_jax_cli(monkeypatch, tmp_path, capsys, tiny_params):
    """The same tiny weights at bf16 and int8 (calibrated on the default set)
    on both sides, 2 images at 70x70: the JSON's keys in the JAX order, and
    each value within what separates the two stacks' bf16 outputs alone.
    The bf16 roundings of the two stacks differ (fp32: rel 1e-6; bf16: rel
    1.4e-2, the size of the int8 error itself on this model), and the
    log-space metrics are dominated by the 1.6% of pixels at the 1e-3
    clamp. So the bar of an error metric (abs_rel, ..., silog) is the sum of
    its values between the port's and JAX's bf16 depth and between their
    int8 depth (the triangle inequality), of a delta_k the sum of 1 - its
    values there, and of corr 1e-3. The exit code follows the same gate."""
    monkeypatch.setenv("MDET_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setitem(jvit.VIT_CONFIGS, "tiny", jvit.ViTConfig(
        dim=64, depth=2, num_heads=4, pretrain_img_size=56))
    monkeypatch.setitem(jda.HEAD_CONFIGS, "tiny", dict(features=16,
                                                       out_channels=(8, 16, 32, 32)))
    monkeypatch.setitem(jda.INTERMEDIATE_LAYER_IDX, "tiny", (0, 1, 0, 1))
    sd = state_dict_from_jax(tiny_params)
    real_j, real_t = jreg.build_pipeline, treg.build_pipeline
    built = {}

    def jbuild(name, precision="bf16", **kw):
        built["jax", precision] = real_j(
            "depth_anything_v2", encoder="tiny", input_size=70, attn_impl="xla",
            precision=precision, params=tiny_params)
        return built["jax", precision]

    def tbuild(name, precision="bf16", **kw):
        built["port", precision] = real_t(
            "depth_anything_v2", encoder="tiny", input_size=70, attn_impl="xla",
            precision=precision, params=sd, model_kw=TINY_KW, device=kw["device"])
        return built["port", precision]

    monkeypatch.setattr(jreg, "build_pipeline", jbuild)
    monkeypatch.setattr(treg, "build_pipeline", tbuild)
    imgs = _png_dir(tmp_path)
    argv = ["quantcheck", "depth_anything_v2", "--encoder", "vits", "--images", imgs,
            "--min-delta1", "0.5"]
    rc_j = jcli.main(argv)
    ref = _json_line(capsys)
    rc_t = cli.main(["--device", "cpu", *argv])
    ours = _json_line(capsys)
    assert list(ours) == list(ref) == ["metric", "images", "corr", "abs_rel", "sq_rel", "rmse",
                                       "rmse_log", "silog", "delta1", "delta2", "delta3"]
    assert ours["metric"] == ref["metric"] == "depth_anything_v2_tiny_70x70_int8_vs_bf16"
    assert ours["images"] == ref["images"] == 2

    bar = {}
    for prec in ("bf16", "int8"):
        for i in range(2):
            frame = imageio.read_image(os.path.join(imgs, f"i{i}.png"))
            m = metrics.depth_metrics(
                torch.from_numpy(built["port", prec](frame)["depth"])[None],
                torch.from_numpy(np.array(built["jax", prec](frame)["depth"]))[None])
            for k, v in m.items():
                v = 1.0 - float(v) if k.startswith("delta") else float(v)
                bar[k] = bar.get(k, 0.0) + v / 2
    assert abs(ours["corr"] - ref["corr"]) <= 1e-3
    for k in bar:
        assert abs(ours[k] - ref[k]) <= bar[k], (k, ours[k], ref[k], bar[k])
    assert rc_t == rc_j == (0 if ref["delta1"] > 0.5 else 3)
    argv[-1] = "1.01"  # an impossible gate
    assert cli.main(["--device", "cpu", *argv]) == 3


# ---------------------------------------------------------------------------
# convert, the params cache and its precedence
# ---------------------------------------------------------------------------


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("MDET_CACHE_DIR", str(tmp_path / "cache"))
    return tmp_path / "cache"


@pytest.fixture
def tiny_da(monkeypatch):
    """Swap the port's DepthAnythingV2 for the tiny config wherever it is
    looked up at call time (the registry and ``distill``)."""
    real = tda.DepthAnythingV2

    def tiny(encoder="vits", **kw):
        return real(encoder="tiny", **{**kw, **TINY_KW})

    monkeypatch.setattr(tda, "DepthAnythingV2", tiny)
    return tiny


def _tiny_state_dict(tiny, seed):
    model = tiny(attn_impl="xla")
    store.init_random_(model, seed)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _full_vits_checkpoint(path, rename=None):
    """The full-size vits layout, each tensor a zero-stride view of one
    element: the shapes of 24.8 M parameters in a file of a few kB."""
    with torch.device("meta"):
        keys = {k: tuple(v.shape) for k, v in tda.DepthAnythingV2("vits").state_dict().items()}
    sd = {k: torch.full((), 0.01).expand(shape) for k, shape in keys.items()}
    if rename:
        sd[rename[1]] = sd.pop(rename[0])
    torch.save(sd, path)
    return str(path)


def test_convert_verify_manifest_on_a_full_size_vits_layout(cache, tmp_path):
    ckpt = _full_vits_checkpoint(tmp_path / "vits.pth")
    assert os.path.getsize(ckpt) < 1 << 20
    assert cli.main(["convert", "depth_anything_v2", "--encoder", "vits", "--checkpoint", ckpt,
                     "--verify-manifest"]) == 0
    cached = store.load_params(VITS_NAME)
    assert len(cached) == 238 and all(v.dtype == torch.float32 for v in cached.values())


@pytest.mark.parametrize("case,want", [("renamed", 2), ("missing", 3)])
def test_convert_exit_codes_match_the_jax_cli(cache, tmp_path, case, want):
    """One renamed key: the manifest differs (2); no such file (3)."""
    ckpt = str(tmp_path / "absent.pth")
    if case == "renamed":
        ckpt = _full_vits_checkpoint(tmp_path / "renamed.pth", rename=(
            "pretrained.blocks.3.attn.qkv.weight", "pretrained.blocks.3.attn.qkv2.weight"))
    argv = ["convert", "depth_anything_v2", "--encoder", "vits", "--checkpoint", ckpt]
    assert cli.main([*argv, "--verify-manifest"]) == want
    # the JAX CLI reads a missing file for the manifest before it checks it
    assert jcli.main(argv if case == "missing" else [*argv, "--verify-manifest"]) == want
    assert cli.main(argv) == (3 if case == "missing" else 1)
    assert not os.path.exists(store.params_path(VITS_NAME))


def test_convert_strict_load_mismatch_exits_1_and_report_writes_nothing(cache, tmp_path,
                                                                        tiny_da, capsys):
    sd = _tiny_state_dict(tiny_da, 3)
    sd["pretrained.extra_head.weight"] = torch.zeros(2)
    del sd["depth_head.scratch.output_conv2.2.bias"]
    torch.save(sd, tmp_path / "bad.pth")
    argv = ["convert", "depth_anything_v2", "--encoder", "vits", "--checkpoint",
            str(tmp_path / "bad.pth")]
    assert cli.main(argv) == 1
    capsys.readouterr()
    assert cli.main([*argv, "--report"]) == 0
    out = capsys.readouterr().out
    assert f"consumed {len(sd) - 1}/{len(sd)} checkpoint tensors; 1 missing, 1 extra" in out
    assert "MISSING depth_head.scratch.output_conv2.2.bias" in out
    assert "UNCONSUMED pretrained.extra_head.weight" in out
    assert not os.path.exists(os.path.join(str(cache), "params"))


def test_convert_installs_the_weights_that_run_then_serves(cache, tmp_path, tiny_da):
    """convert writes the params cache; ``run`` without ``--checkpoint`` or
    ``--allow-random-weights`` serves those weights, bit for bit as a
    pipeline given the state dict."""
    sd = _tiny_state_dict(tiny_da, 4)
    torch.save(sd, tmp_path / "tiny.pth")
    png = os.path.join(_png_dir(tmp_path, n=1, hw=(40, 48)), "i0.png")
    with store.allow_random_weights(False):
        with pytest.raises(store.MissingCheckpointError, match="none cached"):
            treg.build_pipeline("depth_anything_v2", encoder="vits", device="cpu")
        assert cli.main(["convert", "depth_anything_v2", "--encoder", "vits", "--checkpoint",
                         str(tmp_path / "tiny.pth")]) == 0
        assert sorted(store.load_params(VITS_NAME)) == sorted(sd)
        assert cli.main(["--device", "cpu", "run", "depth_anything_v2", "--encoder", "vits",
                         "--image", png, "--out", str(tmp_path / "out")]) == 0
        served = np.load(tmp_path / "out" / f"i0_{VITS_NAME}.npz")["depth"]
        ref = treg.build_pipeline("depth_anything_v2", encoder="vits", device="cpu",
                                  params=sd)(imageio.read_image(png))["depth"]
    np.testing.assert_array_equal(served, ref)


def test_an_explicit_checkpoint_wins_over_the_params_cache(cache, tmp_path, tiny_da):
    """The deliberate departure (ROADMAP section 3), first half: with a
    cache entry present, ``checkpoint=`` serves the checkpoint's weights."""
    cached, named = _tiny_state_dict(tiny_da, 5), _tiny_state_dict(tiny_da, 6)
    store.save_params(VITS_NAME, cached)
    torch.save(named, tmp_path / "named.pth")
    frame = imageio.read_image(os.path.join(_png_dir(tmp_path, n=1), "i0.png"))
    got = treg.build_pipeline("depth_anything_v2", encoder="vits", device="cpu",
                              checkpoint=str(tmp_path / "named.pth"))(frame)["depth"]
    want = treg.build_pipeline("depth_anything_v2", encoder="vits", device="cpu",
                               params=named)(frame)["depth"]
    from_cache = treg.build_pipeline("depth_anything_v2", encoder="vits",
                                     device="cpu")(frame)["depth"]
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, from_cache)


def test_a_checkpoint_load_never_writes_the_params_cache(cache, tmp_path, tiny_da):
    """Second half: only ``convert`` and ``distill --promote`` write it; a
    build from a checkpoint leaves it as it was, and the int8 bundle then
    names the checkpoint as its source, the cache file where the weights
    came from there."""
    torch.save(_tiny_state_dict(tiny_da, 7), tmp_path / "w.pth")
    treg.build_pipeline("depth_anything_v2", encoder="vits", device="cpu",
                        checkpoint=str(tmp_path / "w.pth"))
    assert not os.path.exists(store.params_path(VITS_NAME))
    model = tiny_da(attn_impl="xla")
    key = treg._int8_bundle_key(model, str(tmp_path / "w.pth"), VITS_NAME, torch.bfloat16)
    assert set(key["source"]) == {"checkpoint", "size", "mtime_ns"}
    store.save_params(VITS_NAME, model.state_dict())
    key = treg._int8_bundle_key(model, None, VITS_NAME, torch.bfloat16)
    assert key["source"]["params_cache"] == os.path.realpath(store.params_path(VITS_NAME))
    jax_dir = os.path.join(str(cache), "params", VITS_NAME)  # the JAX package's orbax tree
    assert store.params_path(VITS_NAME) != jax_dir and not os.path.exists(jax_dir)


# ---------------------------------------------------------------------------
# distill
# ---------------------------------------------------------------------------


def test_distill_promote_then_run_serves_the_promoted_weights(cache, tmp_path, tiny_da):
    before = _tiny_state_dict(tiny_da, 8)
    store.save_params(VITS_NAME, before)
    imgs = _png_dir(tmp_path, n=4, hw=(48, 64))
    out = str(tmp_path / "out")
    assert cli.main(["--device", "cpu", "--allow-random-weights", "distill", "--images-dir",
                     imgs, "--size", "56", "--batch", "2", "--steps", "3", "--lr", "1e-3",
                     "--out", out, "--promote"]) == 0
    bak = store.params_path(VITS_NAME) + ".pre-distill-bak"
    backed_up = torch.load(bak, weights_only=True)
    assert all(torch.equal(backed_up[k], v) for k, v in before.items())
    promoted = store.load_params(VITS_NAME)
    assert sorted(promoted) == sorted(before)
    assert any(not torch.equal(promoted[k], before[k]) for k in before)

    # the train state resumes at step 3, holding the promoted weights
    like = create_train_state(before, adamw(1e-3))
    state = load_train_state(os.path.join(out, "distill_depth_anything_v2_vits.pt"), like)
    assert state.step == 3
    assert all(torch.equal(state.params[k].detach(), promoted[k]) for k in promoted)

    png = os.path.join(imgs, "i0.png")
    with store.allow_random_weights(False):
        assert cli.main(["--device", "cpu", "run", "depth_anything_v2", "--encoder", "vits",
                         "--image", png, "--out", out]) == 0
    served = np.load(os.path.join(out, f"i0_{VITS_NAME}.npz"))["depth"]
    ref = treg.build_pipeline("depth_anything_v2", encoder="vits", device="cpu",
                              params=promoted)(imageio.read_image(png))["depth"]
    np.testing.assert_array_equal(served, ref)


def test_distill_qat_keeps_the_plain_state_dict(cache, tmp_path, tiny_da, monkeypatch):
    """Also: the student is asked for full fp32 on its device (TF32 off on a
    card), as a registry build at precision="fp32" is."""
    full_fp32 = []
    monkeypatch.setattr(treg, "_full_fp32", lambda dtype, dev: full_fp32.append((dtype, dev)))
    imgs = _png_dir(tmp_path, n=2, hw=(48, 64))
    out = str(tmp_path / "out")
    assert cli.main(["--device", "cpu", "--allow-random-weights", "distill", "--images-dir",
                     imgs, "--size", "56", "--batch", "2", "--steps", "2", "--out", out,
                     "--qat"]) == 0
    assert (torch.float32, torch.device("cpu")) in full_fp32
    saved = torch.load(os.path.join(out, "distill_depth_anything_v2_vits.pt"),
                       weights_only=True)
    assert saved["step"] == 2
    assert sorted(saved["params"]) == sorted(tiny_da(attn_impl="xla").state_dict())
    assert not os.path.exists(store.params_path(VITS_NAME))  # no --promote


@pytest.mark.parametrize("student", cli.DISTILL_STUDENTS)
def test_distill_promotes_under_the_students_serving_artifact(monkeypatch, student):
    """``distill`` names the params-cache entry it promotes by ModelSpec's
    defaults at the student's name, without building the student's serving
    pipeline: the name that pipeline (the one ``run`` builds) reads."""
    served = _meta_pipeline(monkeypatch, student).spec.artifact_name()
    assert ModelSpec(model=student, encoder="vits").artifact_name() == served


@pytest.mark.parametrize("argv", [
    ["distill", "--images-dir", "IMGS", "--batch", "1"],
    ["quantcheck", "depth_anything_v2", "--images", "IMGS"],
])
def test_training_commands_raise_without_a_card_unless_told_cpu(tmp_path, argv):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    imgs = _png_dir(tmp_path, n=1)
    argv = [imgs if a == "IMGS" else a for a in argv]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--allow-random-weights", *argv])


# ---------------------------------------------------------------------------
# run --colorbar
# ---------------------------------------------------------------------------


def _toy(monkeypatch):
    from monocular_depth_estimation_trt_tpu.config import ModelSpec as JModelSpec
    from monocular_depth_estimation_trt_tpu.pipelines import DepthPipeline as JDepthPipeline
    from monocular_depth_estimation_trt_tpu_torch.config import ModelSpec
    from monocular_depth_estimation_trt_tpu_torch.pipelines import DepthPipeline

    spec = dict(model="toy_bar", input_hw=(16, 16), metric=True)
    jpipe = JDepthPipeline(JModelSpec(**spec), lambda params, img, hw: {
        "depth": img.astype(jnp.float32)[..., 0] / 25.0 + 0.5}, {}, viz="none")
    tpipe = DepthPipeline(ModelSpec(**spec), lambda img, hw: {
        "depth": img.float()[..., 0] / 25.0 + 0.5}, device="cpu", viz="none")
    monkeypatch.setattr(jreg, "build_pipeline", lambda name, **kw: jpipe)
    monkeypatch.setattr(treg, "build_pipeline", lambda name, **kw: tpipe)


def test_colorbar_writes_the_jax_clis_files(monkeypatch, tmp_path):
    pytest.importorskip("matplotlib")
    _toy(monkeypatch)
    png = os.path.join(_png_dir(tmp_path, n=1, hw=(40, 48)), "i0.png")
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jcli.main(["run", "toy", "--image", png, "--colorbar", "--out", jdir]) == 0
    assert cli.main(["--device", "cpu", "run", "toy", "--image", png, "--colorbar",
                     "--out", tdir]) == 0
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    (bar,) = [f for f in os.listdir(tdir) if f.endswith("_depth_bar.jpg")]
    assert imageio.read_image(os.path.join(tdir, bar)).shape[0] > 100


def test_colorbar_without_matplotlib_exits_1_naming_it(monkeypatch, tmp_path, capsys):
    import sys

    _toy(monkeypatch)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    png = os.path.join(_png_dir(tmp_path, n=1, hw=(40, 48)), "i0.png")
    assert cli.main(["--device", "cpu", "run", "toy", "--image", png, "--colorbar",
                     "--out", str(tmp_path / "o")]) == 1
    assert "--colorbar needs matplotlib" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the key manifests
# ---------------------------------------------------------------------------

JAX_MANIFESTS = os.path.join(os.path.dirname(jmanifest.__file__), "manifests")


def test_the_port_keeps_every_manifest():
    assert sorted(os.listdir(manifest.manifest_dir())) == sorted(os.listdir(JAX_MANIFESTS))


@pytest.mark.parametrize("fname", sorted(os.listdir(JAX_MANIFESTS)))
def test_manifest_file_equals_the_jax_packages_byte_for_byte(fname):
    with open(os.path.join(manifest.manifest_dir(), fname), "rb") as a, \
            open(os.path.join(JAX_MANIFESTS, fname), "rb") as b:
        assert a.read() == b.read()


def test_manifest_keys_and_reports_match_the_jax_module():
    for name in treg.list_models():
        for enc in ("", "vits", "vitb", "vitl"):
            assert manifest.manifest_key(name, enc) == jmanifest.manifest_key(name, enc)
    want = jmanifest.load_manifest("raft")
    assert manifest.load_manifest("raft") == want and manifest.load_manifest("nope") is None
    sd = {("module." + k): np.zeros(v) for k, v in want["keys"].items()}
    sd.pop("module." + sorted(want["keys"])[0])
    sd["module.fnet.num_batches_tracked"] = np.zeros(())
    sd["extra.weight"] = np.zeros(3)
    first = sorted(want["keys"])[1]
    sd["module." + first] = np.zeros(7)
    ours, ref = manifest.verify_state_dict(sd, want), jmanifest.verify_state_dict(sd, want)
    assert ours == ref and not ours["ok"]
    assert manifest.format_report(ours, max_items=2) == jmanifest.format_report(ref, max_items=2)
    assert manifest.AUDIT_IGNORE.pattern == jmanifest._AUDIT_IGNORE.pattern


def _meta_pipeline(monkeypatch, name):
    """``build_pipeline(name)`` on the meta device, full size, no memory."""
    def meta_model(make):
        with torch.device("meta"):
            return make()

    monkeypatch.setattr(treg, "_new_model", meta_model)
    monkeypatch.setattr(store, "init_random_", lambda model, seed=0: None)
    with store.allow_random_weights(True), torch.device("meta"):
        return treg.build_pipeline(name, device="meta")


FAMILIES = sorted(n for n in treg.list_models() if n not in ("megasam", "vipe", "wildgs_slam"))


@pytest.mark.parametrize("name", FAMILIES)
def test_every_registry_family_passes_its_manifest(monkeypatch, name):
    """Each family's model as the registry builds it, on the meta device:
    its state dict passes ``verify_state_dict`` against the family's
    manifest. Prior Depth Anything's refiner and VGGT against their two
    manifests; Align3R's DA-V2 prior against DA-V2 vits's; the depth-only
    VGGTs (StreamVGGT's, Prior Depth Anything's) hold VGGT's keys but the
    camera head."""
    pipe = _meta_pipeline(monkeypatch, name)
    enc = getattr(pipe.spec, "encoder", "")
    checks = [(pipe.model, manifest.manifest_key(name, enc))]
    if name == "prior_depth_anything":
        checks = [(pipe.model.refiner, "prior_depth_anything_vits"), (pipe.model.vggt, "vggt")]
    if name == "align3r":
        checks.append((pipe.prior, "depth_anything_v2_vits"))
    for module, key in checks:
        rep = manifest.verify_state_dict(module.state_dict(), manifest.load_manifest(key))
        if key == "vggt" and name in ("streamvggt", "prior_depth_anything"):
            assert rep["missing"] and all(k.startswith("camera_head.") for k in rep["missing"])
            assert not rep["extra"] and not rep["shape_mismatch"]
        else:
            assert rep["ok"], (key, rep["missing"][:3], rep["extra"][:3])
