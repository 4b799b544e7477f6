"""The port's CoTracker3 (``models/cotracker3.py``), its online pipeline
(``registry.py::CoTrackerPipeline``), ``apps/tracking.py`` and the ``track``
command against the JAX package on the CPU: one set of seeded weights
(``weights/from_jax.py::cotracker3_from_jax``), fp32, a tiny config
(dim 16, d_model 32, 2 levels of radius 2), window 4, 32x48 frames and a
3x3 grid."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu import cli as jcli
from monocular_depth_estimation_trt_tpu import registry as jreg
from monocular_depth_estimation_trt_tpu.models import cotracker3 as jct
from monocular_depth_estimation_trt_tpu.weights.convert import convert_cotracker3
from monocular_depth_estimation_trt_tpu_torch import cli
from monocular_depth_estimation_trt_tpu_torch import config as tconfig
from monocular_depth_estimation_trt_tpu_torch import registry as treg
from monocular_depth_estimation_trt_tpu_torch.apps.tracking import visualize_tracks
from monocular_depth_estimation_trt_tpu_torch.models.cotracker3 import CoTracker3
from monocular_depth_estimation_trt_tpu_torch.weights import from_jax, store

from torch_mirror_cotracker import TorchCoTracker3
from torch_port_params import random_params, rel_err

torch.set_num_threads(1)

REL_TOL = 2e-3  # fp32 on both sides, of max |tracks| (the ROADMAP bar)
TINY = dict(dim=16, d_model=32, iters=2, blocks=1, levels=2, radius=2, num_heads=4)
HW = (32, 48)
WINDOW = 4
GRID = 3
FIXTURE = os.path.join(os.path.dirname(__file__), "..", "data", "example_video.mp4")


def _video(t, seed=0, hw=HW):
    return np.random.default_rng(seed).integers(0, 256, (t, *hw, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def params():
    frames = jnp.zeros((1, WINDOW, *HW, 3))
    return random_params(jct.CoTracker3(dtype=jnp.float32, **TINY), frames,
                         jnp.zeros((1, GRID * GRID, 2)), seed=13)


@pytest.fixture(scope="module")
def pipes(params):
    """(the JAX pipeline, the port's) on one set of weights."""
    kw = dict(window=WINDOW, grid_size=GRID, input_hw=HW, precision="fp32", model_kw=TINY)
    return (jreg.build_pipeline("cotracker3", params=params, **kw),
            treg.build_pipeline("cotracker3", params=from_jax.cotracker3_from_jax(params),
                                device="cpu", **kw))


def test_model_first_window_and_continuation_match_jax(params):
    """The model alone: a first window from the queries, then a
    continuation seeded with tracks, visibility log-odds and track features
    (the JAX function under ``jax.jit``)."""
    model = CoTracker3(**TINY)
    model.load_state_dict(from_jax.cotracker3_from_jax(params), strict=True)
    jmodel = jct.CoTracker3(dtype=jnp.float32, **TINY)
    apply = jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a))
    rng = np.random.default_rng(4)
    frames = rng.uniform(0, 1, (1, WINDOW, *HW, 3)).astype(np.float32)
    queries = rng.uniform(4, 28, (1, 5, 2)).astype(np.float32)
    seeds = (queries[:, None].repeat(WINDOW, 1) + rng.normal(0, 2, (1, WINDOW, 5, 2)),
             rng.normal(0, 1, (1, WINDOW, 5)), rng.normal(0, 1, (1, 5, TINY["dim"])))
    seeds = tuple(s.astype(np.float32) for s in seeds)
    for args in ((frames, queries), (frames, queries, *seeds)):
        ref = apply(params, *(jnp.asarray(a) for a in args))
        with torch.no_grad():
            ours = model(*(torch.from_numpy(a) for a in args))
        assert ours["tracks"].shape == (1, WINDOW, 5, 2)
        assert ours["visibility"].shape == (1, WINDOW, 5, 1)
        assert rel_err(ours["tracks"], ref["tracks"]) < REL_TOL
        assert np.abs(ours["visibility"].numpy() - np.asarray(ref["visibility"])).max() < REL_TOL
        assert rel_err(ours["track_feat"], ref["track_feat"]) < REL_TOL


def test_state_dict_keys_are_the_manifest_and_the_mirror_round_trips():
    """The full-size module holds the 72 keys of the manifest; the torch
    mirror's weights go through the JAX converter and back unchanged."""
    import json

    path = os.path.join(os.path.dirname(__file__), "..", "monocular_depth_estimation_trt_tpu",
                        "weights", "manifests", "cotracker3.json")
    with open(path) as f:
        manifest = json.load(f)["keys"]
    with torch.device("meta"):
        full = CoTracker3()
    assert {k: list(v.shape) for k, v in full.state_dict().items()} == manifest
    assert len(manifest) == 72
    torch.manual_seed(5)
    mirror = TorchCoTracker3(**TINY)
    back = from_jax.cotracker3_from_jax(convert_cotracker3(mirror.state_dict(),
                                                           blocks=TINY["blocks"]))
    ref = mirror.state_dict()
    assert sorted(back) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(back[k].numpy(), ref[k].numpy(), err_msg=k)
    CoTracker3(**TINY).load_state_dict(back, strict=True)


def test_online_windows_match_jax(pipes):
    """The upstream online API on both sides: a first window, then two
    continuations (the seed shifted by ``step`` on the device), the last
    chunk short (padded by repeating its last frame)."""
    jpipe, tpipe = pipes
    assert tpipe.step == jpipe.step == WINDOW // 2
    video = _video(9, seed=1)
    assert tpipe(None, is_first_step=True, grid_size=GRID) is None
    jpipe(None, is_first_step=True, grid_size=GRID)
    for start in (0, 2, 4, 6):
        chunk = video[start: start + WINDOW]
        (tr, vi), (jtr, jvi) = tpipe(chunk), jpipe(chunk)
        assert tr.shape == jtr.shape == (1, len(chunk), GRID * GRID, 2)
        assert vi.shape == (1, len(chunk), GRID * GRID, 1)
        assert rel_err(tr, jtr) < REL_TOL, start
        assert np.abs(vi - jvi).max() < REL_TOL, start
    assert set(tpipe._engines) == {"first", "cont"}
    assert all(t.device.type == "cpu" for t in tpipe._state)


def test_track_video_matches_jax_over_a_partial_last_window(pipes):
    jpipe, tpipe = pipes
    video = _video(7, seed=2, hw=(40, 56))  # resized to 32x48; 7 frames: no whole steps
    (tr, vi), (jtr, jvi) = tpipe.track_video(video), jpipe.track_video(video)
    assert tr.shape == (1, 7, GRID * GRID, 2) and vi.shape == (1, 7, GRID * GRID, 1)
    assert rel_err(tr, jtr) < REL_TOL
    assert np.abs(vi - jvi).max() < REL_TOL


def test_grid_size_mismatch_raises_as_jax(pipes):
    for pipe in pipes:
        with pytest.raises(ValueError, match="grid_size"):
            pipe(None, is_first_step=True, grid_size=GRID + 1)


def test_factory_builds_with_the_jax_artifact_name(monkeypatch):
    monkeypatch.setattr(store, "resolve_weights", lambda *a, **k: None)
    jpipe = jreg.build_pipeline("cotracker3", params={})
    tpipe = treg.build_pipeline("cotracker3", device="meta")
    assert tpipe.spec == tconfig.ModelSpec(**jpipe.spec.to_dict())
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name() == \
        "cotracker3_384x512_win16_grid10_bf16"
    assert treg.get_fidelity("cotracker3") == jreg.get_fidelity("cotracker3")
    # every layer in bf16 but the fp32 heads, as the JAX module's dtypes
    dtypes = {n: p.dtype for n, p in tpipe.model.named_parameters()}
    assert {n.split(".")[0] for n, d in dtypes.items() if d == torch.float32} == \
        {"head_coord", "head_vis"}
    assert dtypes["blocks.0.time_qkv.weight"] == torch.bfloat16


def test_visualize_tracks_writes_an_mp4(tmp_path, pipes):
    pytest.importorskip("cv2")
    video = _video(6, seed=3)
    tracks, vis = pipes[1].track_video(video)
    out = visualize_tracks(video, tracks, vis, str(tmp_path / "tracked.mp4"))
    assert os.path.getsize(out) > 500


def _decoded(path):
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f.astype(np.int16))
    cap.release()
    return np.stack(frames)


def test_track_command_matches_the_jax_cli(pipes, monkeypatch, tmp_path):
    """``track`` on the 512x288 fixture, 6 frames, with the tiny pipelines
    on both sides: the same file name, frame count and size, the decoded
    frames within 2 uint8 steps but at mp4v-spread rounding ties (as the
    ``video`` command's test, ``tests/test_torch_cli.py``)."""
    pytest.importorskip("cv2")
    jpipe, tpipe = pipes
    monkeypatch.setattr(jreg, "build_pipeline", lambda name, **kw: jpipe)
    monkeypatch.setattr(treg, "build_pipeline", lambda name, **kw: tpipe)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    argv = ["track", "cotracker3", "--video", FIXTURE, "--grid", str(GRID), "--max-frames", "6"]
    assert jcli.main([*argv, "--out", jdir]) == 0
    assert cli.main(["--device", "cpu", *argv, "--out", tdir]) == 0
    name = f"example_video_{tpipe.spec.artifact_name()}.mp4"
    assert os.listdir(jdir) == os.listdir(tdir) == [name]
    ref, ours = _decoded(os.path.join(jdir, name)), _decoded(os.path.join(tdir, name))
    assert ours.shape == ref.shape == (6, 288, 512, 3)
    diff = np.abs(ours - ref)
    assert float(np.mean(diff > 2)) < 1e-2 and float(diff.mean()) < 0.05
