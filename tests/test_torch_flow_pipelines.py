"""The port's flow pipelines (``pipelines.py::FlowPipeline``,
``registry.py::TripletFlowPipeline`` and ``MEMFOFSession``), their registry
entries and the ``flow`` command against the JAX package on the CPU: the
same seeded weights (``weights/from_jax.py``) and the same uint8 frames,
fp32, at 64x96 (WAFT 56x84 on a dim-128 ViT) and 2 refinement steps
(NeuFlow the JAX factory's 8 + 8)."""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu import registry as jreg
from monocular_depth_estimation_trt_tpu.models import vit as jvit
from monocular_depth_estimation_trt_tpu.models.flow import meflow as jmeflow
from monocular_depth_estimation_trt_tpu.models.flow import memfof as jmemfof
from monocular_depth_estimation_trt_tpu.models.flow import neuflow as jneuflow
from monocular_depth_estimation_trt_tpu.models.flow import raft as jraft
from monocular_depth_estimation_trt_tpu.models.flow import waft as jwaft
from monocular_depth_estimation_trt_tpu_torch import cli
from monocular_depth_estimation_trt_tpu_torch import config as tconfig
from monocular_depth_estimation_trt_tpu_torch import registry as treg
from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig as TViTConfig
from monocular_depth_estimation_trt_tpu_torch.pipelines import FlowPipeline
from monocular_depth_estimation_trt_tpu_torch.utils import imageio
from monocular_depth_estimation_trt_tpu_torch.weights import from_jax, store

from torch_port_params import random_params, rel_err

torch.set_num_threads(1)

REL_TOL = 2e-3  # fp32 on both sides, of max |flow|
ITERS = 2
HW = (64, 96)
WAFT_HW = (56, 84)
WAFT_VIT = dict(dim=128, depth=2, num_heads=2, pretrain_img_size=70)
FRAME_HW = (60, 90)  # resized on the device to the model's input


def _jax_params(name):
    """Seeded JAX params for the JAX factory's model of ``name``."""
    x = jnp.zeros((1, *(WAFT_HW if name == "waft" else HW), 3))
    module = {"raft": lambda: jraft.RAFT(iters=ITERS),
              "neuflow": jneuflow.NeuFlow,
              "meflow": lambda: jmeflow.MeFlow(iters=ITERS),
              "memfof": lambda: jmemfof.MEMFOF(iters=ITERS),
              "waft": lambda: jwaft.WAFT(iters=ITERS, encoder="tiny")}[name]()
    args = (jnp.zeros((1, 3, *HW, 3)),) if name == "memfof" else (x, x)
    return random_params(module, *args, seed=len(name))


@pytest.fixture(scope="module")
def pipes():
    """name -> (the JAX pipeline, the port's) on one set of weights."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jvit.VIT_CONFIGS, "tiny", jvit.ViTConfig(**WAFT_VIT))
        for name in ("raft", "neuflow", "meflow", "memfof", "waft"):
            params = _jax_params(name)
            kw = {"precision": "fp32"}
            if name != "neuflow":
                kw["iters"] = ITERS
            if name == "waft":
                kw.update(encoder="tiny", input_hw=WAFT_HW)
            else:
                kw["input_hw"] = HW
            port_kw = {"model_kw": {"vit_config": TViTConfig(**WAFT_VIT)}} if name == "waft" else {}
            out[name] = (jreg.build_pipeline(name, params=params, **kw),
                         treg.build_pipeline(name, params=from_jax.state_dict_from_jax(params),
                                             device="cpu", **kw, **port_kw))
        yield out


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(11).integers(0, 256, (4, *FRAME_HW, 3), dtype=np.uint8)


@pytest.mark.parametrize("name", ["raft", "neuflow", "meflow", "waft"])
def test_flow_pipeline_matches_jax(pipes, frames, name):
    jpipe, tpipe = pipes[name]
    assert isinstance(tpipe, FlowPipeline) and tpipe.device == torch.device("cpu")
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name()
    ref = jpipe(frames[0], frames[1], viz=True)
    ours = tpipe(frames[0], frames[1], viz=True)
    assert sorted(ours) == sorted(ref)
    hw = WAFT_HW if name == "waft" else HW
    assert ours["flow"].shape == ref["flow"].shape == (*hw, 2)
    assert ours["viz"].shape == (*hw, 3) and ours["viz"].dtype == np.uint8
    for k in ("flow", "flow_low"):
        if k in ref:
            assert rel_err(ours[k], ref[k]) < REL_TOL, k
    # the color wheel on the two packages' flows: within a level but where
    # the hue sits on a wheel entry's edge
    off = np.abs(ours["viz"].astype(int) - np.asarray(ref["viz"]).astype(int)).max(-1)
    assert np.mean(off > 1) < 0.01
    dev = tpipe(frames[0], frames[1], device_out=True)
    assert isinstance(dev["flow"], torch.Tensor)
    np.testing.assert_array_equal(dev["flow"].numpy(), ours["flow"])


def test_triplet_pipeline_and_session_match_jax(pipes, frames):
    """MEMFOF: a triplet through each package's pipeline, then each one's
    video session over four frames: nothing for two frames, then the whole
    triplet, then the cached step (only the newest frame encoded)."""
    jpipe, tpipe = pipes["memfof"]
    ref = jpipe(*frames[:3])
    ours = tpipe(*frames[:3])
    assert ours["flow"].shape == ref["flow"].shape == (2, *HW, 2)
    assert rel_err(ours["flow"], ref["flow"]) < REL_TOL
    assert [tuple(c.shape) for c in ours["fmap_cache"]] == [(1, 256, 4, 6)] * 3
    jsess, sess = jpipe.stream(), tpipe.stream()
    for i, f in enumerate(frames):
        got, want = sess.step(f), jsess.step(f)
        if i < 2:
            assert got is None and want is None
            continue
        assert got.shape == (2, *HW, 2)
        assert rel_err(got, np.asarray(want)) < REL_TOL, i
    assert "cached" in tpipe._engines  # the fourth frame took the cached step
    # the cached step against the whole triplet on the same resized frames
    whole = tpipe(*sess._frames)["flow"]
    assert rel_err(got, whole) < 1e-5


@pytest.mark.parametrize("name,kw", [("raft", {}), ("raft", {"iters": 12, "precision": "bf16"}),
                                     ("neuflow", {}), ("meflow", {}), ("meflow", {"use_scan": True}),
                                     ("memfof", {}), ("waft", {})])
def test_flow_factories_build_with_the_jax_artifact_names(monkeypatch, name, kw):
    """Both registries at full size without weights: the JAX side keeps the
    given (empty) params, the port builds on the meta device."""
    monkeypatch.setattr(store, "resolve_weights", lambda *a, **k: None)
    jpipe = jreg.build_pipeline(name, params={}, **kw)
    tpipe = treg.build_pipeline(name, device="meta", **kw)
    assert tpipe.spec == tconfig.ModelSpec(**jpipe.spec.to_dict())
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name()
    assert treg.get_fidelity(name) == jreg.get_fidelity(name) == "converter-verified"
    assert hasattr(tpipe, "stream") == (name == "memfof")
    dtype = next(tpipe.model.parameters()).dtype
    assert dtype == (torch.float32 if (name == "raft" and not kw) else torch.bfloat16)


def _write_frames(directory, frames):
    os.makedirs(directory, exist_ok=True)
    for i, f in enumerate(frames):
        imageio.write_image(os.path.join(directory, f"frame_{i:05d}.png"), f)


def _mp4_frames(path):
    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    size = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    cap.release()
    return n, size


@pytest.mark.parametrize("name,source,want", [("raft", "frames", 3), ("memfof", "frames", 2),
                                              ("raft", "video", 2)])
def test_flow_command_writes_the_mp4(pipes, frames, monkeypatch, tmp_path, name, source, want):
    """``flow`` on the CPU: four frames -> 3 pairs (RAFT) or 2 triplets
    (MEMFOF), or 3 frames of a video -> 2 pairs; a 512x288 MP4 of that many
    frames, the pipeline built with ``--iters``."""
    built = {}

    def build(model, **kw):
        built.update(model=model, **kw)
        return pipes[model][1]

    monkeypatch.setattr(treg, "build_pipeline", build)
    out = str(tmp_path / "out")
    argv = ["--device", "cpu", "flow", name, "--out", out, "--iters", "2"]
    if source == "frames":
        _write_frames(str(tmp_path / "frames"), frames)
        argv += ["--frames", str(tmp_path / "frames")]
    else:
        fixture = os.path.join(os.path.dirname(__file__), "..", "data", "example_video.mp4")
        argv += ["--video", fixture, "--max-frames", "3"]
    assert cli.main(argv) == 0
    assert built == {"model": name, "device": "cpu", "iters": 2}
    assert _mp4_frames(os.path.join(out, f"{name}_flow.mp4")) == (want, (512, 288))
    if source == "video":
        assert len(os.listdir(os.path.join(out, "_frames"))) == 3


def test_flow_command_names_the_codec_without_cv2(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(imageio, "_cv2", lambda: None)
    assert cli.main(["--device", "cpu", "flow", "raft", "--out", str(tmp_path)]) == 1
    assert "needs the cv2 (OpenCV) codec" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["raft", "memfof"])
def test_bench_times_a_flow_pipeline_at_its_input_size(pipes, monkeypatch, capsys, name):
    """``bench raft`` / ``bench memfof`` go to the pipeline's ``benchmark``
    at the model's input size (which times on a card only)."""
    pipe = pipes[name][1]
    seen = []

    class Report:
        def print(self):
            print("benchmarked")

    monkeypatch.setattr(pipe, "benchmark", lambda in_hw, cfg: seen.append(
        (in_hw, cfg.warmup, cfg.iterations)) or Report())
    monkeypatch.setattr(treg, "build_pipeline", lambda model, **kw: pipe)
    assert cli.main(["--device", "cpu", "bench", name, "--warmup", "1", "--iterations", "2"]) == 0
    assert seen == [(HW, 1, 2)]
    assert "benchmarked" in capsys.readouterr().out
