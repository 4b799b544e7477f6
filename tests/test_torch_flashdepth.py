"""The port's FlashDepth (``models/flashdepth.py``), its ``flashdepth``
pipeline and its streaming session (``apps/streaming.py::FlashDepthSession``)
against the JAX package on the CPU, fp32, one set of seeded weights
(``weights/from_jax.py::flashdepth_from_jax``): one Mamba step, a clip, the
session's steps, ``reset`` and single images.

The tiny configuration is ``tests/test_parity_flashdepth.py``'s (ViT dim 64
/ 2 heads / 4 blocks at 70², DPT features 16, so the Mamba block has
d_model 16, d_inner 32, d_state 16). The JAX factory takes no model
overrides: its presets get a ``tiny`` encoder for the test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monocular_depth_estimation_trt_tpu.models.depth_anything_v2 as jda
import monocular_depth_estimation_trt_tpu.models.vit as jvit
from monocular_depth_estimation_trt_tpu import registry as jreg
from monocular_depth_estimation_trt_tpu.models import flashdepth as jfd
from monocular_depth_estimation_trt_tpu_torch.models import flashdepth as tfd
from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig as TViTConfig
from monocular_depth_estimation_trt_tpu_torch.registry import build_pipeline
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import (
    flashdepth_from_jax,
    mamba_from_jax,
    state_dict_from_jax,
)

from torch_port_params import random_params, rel_err

torch.set_num_threads(1)

REL_TOL = 2e-3  # fp32 on both sides: summation order and exp/erf only
EXACT = 1e-5  # the session against the port's own clip
SIZE = 70
VIT = dict(dim=64, depth=4, num_heads=2, pretrain_img_size=SIZE)
HEAD = dict(features=16, out_channels=(8, 16, 32, 32))
TAPS = (0, 1, 2, 3)


def _lift_mamba(params):
    """A_log and D at their JAX initial values (random ones would put A
    near -1 and D near 0)."""
    m = params["depth_head"]["mamba"]
    d_inner, d_state = np.shape(m["A_log"])
    m["A_log"] = np.log(np.broadcast_to(np.arange(1, d_state + 1, dtype=np.float32),
                                        (d_inner, d_state))).copy()
    m["D"] = np.ones(d_inner, np.float32)


def tiny_models():
    jm = jfd.FlashDepth(vit_config=jvit.ViTConfig(**VIT), head_features=HEAD["features"],
                        head_out_channels=HEAD["out_channels"], out_indices=TAPS,
                        dtype=jnp.float32, attn_impl="xla")
    params = random_params(jm, jnp.zeros((1, SIZE, SIZE, 3)),
                           jfd.flashdepth_init_state(jm, 1, (5, 5)), seed=8)
    _lift_mamba(params)
    tm = tfd.FlashDepth(vit_config=TViTConfig(**VIT), head_features=HEAD["features"],
                        head_out_channels=HEAD["out_channels"], out_indices=TAPS)
    tm.load_state_dict(flashdepth_from_jax(params), strict=True)
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def tiny():
    return tiny_models()


def test_mamba_step_matches_jax():
    block = jfd.MambaBlock(16)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    state = {"conv": rng.standard_normal((2, 5, 3, 32)).astype(np.float32),
             "ssm": rng.standard_normal((2, 5, 32, 16)).astype(np.float32)}
    params = random_params(block, jnp.asarray(x), state, seed=2)
    out, new = jax.jit(block.apply)({"params": params}, jnp.asarray(x), state)
    ours = tfd.MambaBlock(16)
    ours.load_state_dict(mamba_from_jax(params), strict=True)
    with torch.no_grad():
        t_out, t_new = ours(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in state.items()})
    assert rel_err(t_out.numpy(), out) < REL_TOL
    for k in ("conv", "ssm"):
        assert t_new[k].dtype == torch.float32
        assert rel_err(t_new[k].numpy(), new[k]) < REL_TOL, k


def test_mamba_block_stays_fp32_under_a_cast():
    block = tfd.MambaBlock(16).to(torch.bfloat16)
    assert {p.dtype for p in block.parameters()} == {torch.float32}
    assert block.D.detach().eq(1).all() and float(block.A_log.detach()[0, 1]) == pytest.approx(np.log(2.0))


def test_clip_matches_flashdepth_video(tiny):
    jm, params, tm = tiny
    clip = np.random.default_rng(0).standard_normal((1, 3, SIZE, SIZE, 3)).astype(np.float32)
    ref, ref_state = jfd.flashdepth_video(jm, params, jnp.asarray(clip))
    with torch.no_grad():
        ours, state = tfd.flashdepth_video(tm, torch.from_numpy(clip))
    assert ours.shape == ref.shape == (1, 3, SIZE, SIZE)
    assert rel_err(ours.numpy(), ref) < REL_TOL
    for k in ("conv", "ssm"):
        assert rel_err(state[k].numpy(), ref_state[k]) < REL_TOL, k
    assert float(ours.min()) >= 0.0


def test_state_matters(tiny):
    """The same frame twice: the second depth differs (the SSM's state)."""
    _, _, tm = tiny
    frame = np.random.default_rng(1).standard_normal((1, 1, SIZE, SIZE, 3)).astype(np.float32)
    with torch.no_grad():
        d, _ = tfd.flashdepth_video(tm, torch.from_numpy(np.concatenate([frame, frame], 1)))
    assert rel_err(d[:, 1].numpy(), d[:, 0].numpy()) > 1e-4


def flashdepth_pipelines(params, mp):
    """The two packages' pipelines at 70² on the tiny ``params``; ``mp``, a
    ``MonkeyPatch``, gives the JAX presets a tiny encoder (which its
    session reads at every call)."""
    mp.setitem(jvit.VIT_CONFIGS, "tiny", jvit.ViTConfig(**VIT))
    mp.setitem(jda.HEAD_CONFIGS, "tiny", HEAD)
    mp.setitem(jda.INTERMEDIATE_LAYER_IDX, "tiny", TAPS)
    jpipe = jreg.build_pipeline("flashdepth", encoder="tiny", input_size=SIZE,
                                precision="fp32", attn_impl="xla", params=params)
    return jpipe, build_pipeline(
        "flashdepth", encoder="tiny", input_size=SIZE, precision="fp32", device="cpu",
        params=state_dict_from_jax(params),
        model_kw=dict(vit_config=TViTConfig(**VIT), head_features=HEAD["features"],
                      head_out_channels=HEAD["out_channels"], out_indices=TAPS))


@pytest.fixture(scope="module")
def pipes(tiny):
    with pytest.MonkeyPatch.context() as mp:
        yield flashdepth_pipelines(tiny[1], mp)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(5).integers(0, 256, (3, 48, 64, 3), dtype=np.uint8)


def test_session_steps_match_jax_and_the_clip(pipes, frames):
    """Three steps of each package's session; the port's against its own
    clip through ``flashdepth_video`` (preprocess, steps, upsample)."""
    jpipe, tpipe = pipes
    jsess, sess = jpipe.stream(), tpipe.stream()
    steps = [sess(f, viz=(i == 2)) for i, f in enumerate(frames)]
    for i, f in enumerate(frames):
        ref = jsess(f, viz=(i == 2))
        assert sorted(steps[i]) == sorted(ref)
        assert steps[i]["depth"].shape == (48, 64)
        assert rel_err(steps[i]["depth"], ref["depth"]) < REL_TOL, i
    assert steps[2]["viz"].shape == (48, 64, 3)
    assert np.mean(np.any(steps[2]["viz"] != np.asarray(ref["viz"]), axis=-1)) < 0.01

    from monocular_depth_estimation_trt_tpu_torch.ops.postprocess import upsample_depth
    from monocular_depth_estimation_trt_tpu_torch.ops.preprocess import normalize, to_float_rgb
    from monocular_depth_estimation_trt_tpu_torch.ops.resize import resize
    from monocular_depth_estimation_trt_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD

    x = normalize(resize(to_float_rgb(torch.from_numpy(frames)), (SIZE, SIZE), method="cubic"),
                  IMAGENET_MEAN, IMAGENET_STD)
    with torch.no_grad():
        clip, _ = tfd.flashdepth_video(tpipe.model, x[None])
    want = torch.clamp(upsample_depth(clip[0], (48, 64), clamp=None), min=0).numpy()
    for i in range(3):
        assert rel_err(steps[i]["depth"], want[i]) < EXACT, i


def test_reset_starts_a_new_sequence(pipes, frames):
    _, tpipe = pipes
    sess = tpipe.stream()
    first = sess(frames[0])["depth"]
    second = sess(frames[0])["depth"]
    assert rel_err(second, first) > 1e-4
    sess.reset()
    assert not any(t.any() for t in sess.state.values())
    assert np.array_equal(sess(frames[0])["depth"], first)


def test_single_image_serving_matches_jax(pipes, frames):
    """Each image its own sequence: the pipeline's call equals a fresh
    session's first step, and the JAX pipeline."""
    jpipe, tpipe = pipes
    ref, ours = jpipe(frames[1], viz=True), tpipe(frames[1], viz=True)
    assert sorted(ours) == sorted(ref) == ["depth", "viz"]
    assert rel_err(ours["depth"], ref["depth"]) < REL_TOL
    assert np.array_equal(tpipe(frames[1])["depth"], ours["depth"])
    assert np.array_equal(tpipe.stream()(frames[1])["depth"], ours["depth"])
