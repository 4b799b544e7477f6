"""The port's Video Depth Anything (``models/video_depth_anything.py``) and
its ``video_depth_anything`` pipeline against the JAX package on the CPU,
fp32, one set of seeded weights (``weights/from_jax.py::vda_from_jax``):
the temporal block, a window, the K1 route's plain version at head_dim 64,
the host stitching helpers, the windowed ``video_depth``, single images and
the whole-video MP4 writer.

The tiny configuration is ``tests/test_parity_vda.py``'s (ViT dim 64 / 2
heads / 4 blocks at 70², DPT features 16, 2 temporal heads); the JAX side
runs its plain attention.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu import registry as jreg
from monocular_depth_estimation_trt_tpu.models import video_depth_anything as jvda
from monocular_depth_estimation_trt_tpu.models.vit import ViTConfig as JViTConfig
from monocular_depth_estimation_trt_tpu_torch.models import video_depth_anything as tvda
from monocular_depth_estimation_trt_tpu_torch.models import vit as tvit
from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig as TViTConfig
from monocular_depth_estimation_trt_tpu_torch.registry import build_pipeline
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import (
    state_dict_from_jax,
    temporal_block_from_jax,
    vda_from_jax,
)

from torch_port_params import random_params, rel_err

torch.set_num_threads(1)

REL_TOL = 2e-3  # fp32 on both sides: summation order and exp/erf only
SIZE = 70
HEAD = dict(head_features=16, head_out_channels=(8, 16, 32, 32), out_indices=(0, 1, 2, 3),
            num_heads=2)


def _models(dim, heads, seed, attn_impl="auto"):
    vit = dict(dim=dim, depth=4, num_heads=heads, pretrain_img_size=SIZE)
    jm = jvda.VideoDepthAnything(vit_config=JViTConfig(**vit), dtype=jnp.float32,
                                 attn_impl="xla", **HEAD)
    params = random_params(jm, jnp.zeros((1, 2, SIZE, SIZE, 3)), seed=seed)
    tm = tvda.VideoDepthAnything(vit_config=TViTConfig(**vit), attn_impl=attn_impl, **HEAD)
    tm.load_state_dict(vda_from_jax(params), strict=True)
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def tiny():
    return _models(64, 2, seed=3)


def _clip(t, seed, hw=(SIZE, SIZE)):
    return np.random.default_rng(seed).standard_normal((1, t, *hw, 3)).astype(np.float32)


def test_temporal_block_matches_jax():
    block = jvda.TemporalAttentionBlock(16, num_heads=2, dtype=jnp.float32)
    x = np.random.default_rng(1).standard_normal((2, 5, 3, 4, 16)).astype(np.float32)
    params = random_params(block, jnp.asarray(x), seed=2)
    ref = jax.jit(block.apply)({"params": params}, jnp.asarray(x))
    ours = tvda.TemporalAttentionBlock(16, num_heads=2)
    ours.load_state_dict(temporal_block_from_jax(params), strict=True)
    with torch.no_grad():  # the port's block takes (B, T, C, H, W)
        out = ours(torch.from_numpy(x).permute(0, 1, 4, 2, 3)).permute(0, 1, 3, 4, 2)
    assert rel_err(out.numpy(), ref) < REL_TOL
    assert rel_err(out.numpy(), x) > 1e-2  # the block moves its input


def test_window_matches_jax_and_mixes_frames(tiny):
    jm, params, tm = tiny
    apply = jax.jit(jm.apply)
    clip = _clip(4, seed=0)
    ref = apply({"params": params}, jnp.asarray(clip))
    with torch.no_grad():
        ours = tm(torch.from_numpy(clip))
    assert ours.shape == ref.shape == (1, 4, SIZE, SIZE)
    assert rel_err(ours.numpy(), ref) < REL_TOL
    assert float(ours.min()) >= 0.0
    # other frames move frame 0: the temporal blocks mix the window
    with torch.no_grad():
        swapped = tm(torch.from_numpy(clip[:, [0, 2, 1, 3]]))
    assert rel_err(swapped[:, 0].numpy(), ours[:, 0].numpy()) > 1e-4


def test_head_dim_64_window_takes_k1_and_matches_jax(monkeypatch):
    """ViT dim 128 with 2 heads: the encoder's attention goes to K1's
    wrapper (its plain version on the CPU), T = 3 frames folded into its
    batch."""
    jm, params, tm = _models(128, 2, seed=4)
    calls = []
    k1 = tvit.flash_attention_packed

    def counted(qkv, heads, *a, **k):
        calls.append(tuple(qkv.shape))
        return k1(qkv, heads, *a, **k)

    monkeypatch.setattr(tvit, "flash_attention_packed", counted)
    clip = _clip(3, seed=5)
    ref = jax.jit(jm.apply)({"params": params}, jnp.asarray(clip))
    with torch.no_grad():
        ours = tm(torch.from_numpy(clip))
    assert calls == [(3, 26, 3 * 128)] * 4
    assert rel_err(ours.numpy(), ref) < REL_TOL


def test_stitching_helpers_equal_jax():
    rng = np.random.default_rng(6)
    x = rng.uniform(0.1, 5.0, (3, 8, 8)).astype(np.float32)
    y = (2.5 * x - 0.7 + 0.01 * rng.standard_normal(x.shape)).astype(np.float32)
    assert tvda.align_scale_shift(x, y) == pytest.approx(jvda.align_scale_shift(x, y),
                                                         rel=1e-6)
    assert tvda.align_scale_shift(np.ones(4), np.arange(4.0)) == \
        pytest.approx(jvda.align_scale_shift(np.ones(4), np.arange(4.0)))
    prev, new = (rng.uniform(0.5, 4.0, (t, 6, 6)).astype(np.float32) for t in (3, 7))
    for overlap in (1, 3):
        np.testing.assert_allclose(tvda.stitch_window(prev[-overlap:], new, overlap),
                                   np.asarray(jvda.stitch_window(prev[-overlap:], new, overlap)),
                                   rtol=1e-6, atol=1e-6)
    for n, window, overlap in ((100, 32, 10), (80, 32, 10), (20, 32, 10), (32, 32, 10),
                               (9, 4, 2), (33, 32, 10)):
        assert tvda.window_starts(n, window, overlap) == jvda.window_starts(n, window, overlap)
    assert tvda.window_starts(80, 32, 10) == [0, 22, 44, 48]
    assert (tvda.WINDOW, tvda.OVERLAP) == (jvda.WINDOW, jvda.OVERLAP)


def vda_pipelines(params):
    """The two packages' pipelines on the tiny ``params``, input 28, window
    4, overlap 2."""
    vit = dict(dim=64, depth=4, num_heads=2, pretrain_img_size=SIZE)
    kw = dict(input_size=28, window=4, overlap=2, precision="fp32")
    jpipe = jreg.build_pipeline("video_depth_anything", params=params, attn_impl="xla",
                                model_kw=dict(vit_config=JViTConfig(**vit), **HEAD), **kw)
    tpipe = build_pipeline("video_depth_anything", params=state_dict_from_jax(params),
                           device="cpu", model_kw=dict(vit_config=TViTConfig(**vit), **HEAD),
                           **kw)
    return jpipe, tpipe


@pytest.fixture(scope="module")
def pipes(tiny):
    return vda_pipelines(tiny[1])


def _video(t, seed, hw=(32, 48)):
    return np.random.default_rng(seed).integers(0, 256, (t, *hw, 3), dtype=np.uint8)


@pytest.mark.parametrize("frames", [3, 9])
def test_video_depth_matches_jax(pipes, frames):
    """3 frames: one window padded with the last frame; 9 frames: windows
    at 0, 2, 4 and 5, stitched."""
    jpipe, tpipe = pipes
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name()
    video = _video(frames, seed=frames)
    ref, ours = jpipe.video_depth(video), tpipe.video_depth(video)
    assert ours.shape == ref.shape == (frames, 28, 28) and ours.dtype == np.float32
    assert rel_err(ours, ref) < REL_TOL
    assert float(ours.std()) > 0.0


def test_single_image_serving_matches_jax(pipes):
    jpipe, tpipe = pipes
    frame = _video(1, seed=11)[0]
    ref, ours = jpipe(frame, viz=True), tpipe(frame, viz=True)
    assert sorted(ours) == sorted(ref) == ["depth", "viz"]
    assert ours["depth"].shape == (32, 48) and float(ours["depth"].min()) >= 0.0
    assert rel_err(ours["depth"], ref["depth"]) < REL_TOL
    assert np.mean(np.any(ours["viz"] != np.asarray(ref["viz"]), axis=-1)) < 0.01


def test_write_depth_video_matches_jax(pipes, tmp_path):
    """One global normalization over the video, inferno, the source's size
    and frame count; the decoded frames of the two packages' files within 2
    uint8 steps."""
    cv2 = pytest.importorskip("cv2")
    from monocular_depth_estimation_trt_tpu.apps import streaming as jstreaming
    from monocular_depth_estimation_trt_tpu_torch.apps import streaming

    jpipe, tpipe = pipes
    src = str(tmp_path / "src.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 10, (48, 32))
    for f in _video(6, seed=2):
        w.write(f[..., ::-1])
    w.release()
    outs = [str(tmp_path / "ours.mp4"), str(tmp_path / "ref.mp4")]
    streaming.write_depth_video(tpipe, src, outs[0])
    jstreaming.write_depth_video(jpipe, src, outs[1])
    decoded = []
    for path in outs:
        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(f.astype(np.int16))
        decoded.append(np.stack(frames))
    assert decoded[0].shape == decoded[1].shape == (6, 32, 48, 3)
    assert int(np.abs(decoded[0] - decoded[1]).max()) <= 2
    assert os.path.getsize(outs[0]) > 0
