"""The port's streaming apps (``apps/streaming.py``): the JAX package's
``tests/test_streaming.py`` cases on the port (worker queues, the video
loop and its one-in-flight pipelining, the VGGT windowed session),
``extract_frames_from_video`` on the committed fixture against the JAX
function, and the no-cv2 path, which names the missing codec."""

import os
import time

import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu_torch.apps.streaming import (
    FrameWorker,
    VGGTStreamingSession,
    extract_frames_from_video,
    run_video,
    write_depth_video,
)
from monocular_depth_estimation_trt_tpu_torch.utils import imageio

cv2 = pytest.importorskip("cv2")

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
                       "example_video.mp4")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _mp4(path, rng, frames):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    for _ in range(frames):
        writer.write(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8))
    writer.release()
    return str(path)


def _frame_count(path):
    cap = cv2.VideoCapture(path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


def _out(rgb):
    return {"depth": rgb[..., 0].astype(np.float32), "viz": np.stack([rgb[..., 0]] * 3, -1)}


def test_frame_worker_backpressure():
    processed = []

    def process(frame):
        time.sleep(0.01)
        processed.append(frame.sum())
        return frame * 2

    w = FrameWorker(process).start()
    try:
        for i in range(20):
            w.submit(np.full((4, 4), i, np.uint8))
            time.sleep(0.002)
        deadline = time.time() + 2
        while w.latest() is None and time.time() < deadline:
            time.sleep(0.01)
        assert w.latest() is not None
        # bounded queues drop frames rather than queueing without bound
        assert len(processed) < 20
    finally:
        w.stop()


def test_frame_worker_error_recovery():
    """A failed frame passes through (reference Depth_Pro/onnx2trt_webcam.py:113-115)."""
    calls = {"n": 0}

    def process(frame):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("boom")
        return frame

    w = FrameWorker(process).start()
    try:
        w.submit(np.ones((2, 2), np.uint8))
        deadline = time.time() + 2
        while w.latest() is None and time.time() < deadline:
            time.sleep(0.01)
        assert w.latest() is not None
    finally:
        w.stop()


def test_run_video_roundtrip(tmp_path, rng):
    vp = _mp4(tmp_path / "in.mp4", rng, 4)

    class FakePipe:
        def __call__(self, rgb, viz=False):
            return _out(rgb)

    out = run_video(FakePipe(), vp, str(tmp_path / "out.mp4"), max_frames=3)
    assert _frame_count(out) == 3


def test_run_video_pipelined_one_in_flight(tmp_path, rng):
    """A runner that takes device_out is pipelined, every frame still lands
    in the MP4 and the last one is flushed after the loop."""
    vp = _mp4(tmp_path / "in.mp4", rng, 4)
    calls = []

    class DevOutPipe:
        def __call__(self, rgb, viz=False, device_out=False):
            assert device_out, "run_video should ask for device outputs"
            calls.append(rgb.shape)
            return {k: torch.from_numpy(v) for k, v in _out(rgb).items()}

    out = run_video(DevOutPipe(), vp, str(tmp_path / "out.mp4"), max_frames=4)
    assert _frame_count(out) == 4
    assert len(calls) == 4


def test_video_sync_env_forces_synchronous_path(tmp_path, rng, monkeypatch):
    vp = _mp4(tmp_path / "in.mp4", rng, 3)
    seen = []

    class Pipe:
        def __call__(self, rgb, viz=False, device_out=False):
            seen.append(device_out)
            return _out(rgb)

    monkeypatch.setenv("MDET_VIDEO_SYNC", "1")
    out = run_video(Pipe(), vp, str(tmp_path / "out.mp4"), max_frames=3)
    assert _frame_count(out) == 3
    assert seen == [False, False, False]


def test_run_video_serves_a_stream_when_the_pipeline_has_one(tmp_path, rng):
    """A pipeline with ``stream()`` (FlashDepth, StreamVGGT) serves the
    video as one fresh stream of that session."""
    vp = _mp4(tmp_path / "in.mp4", rng, 3)
    sessions = []

    class Session:
        def __init__(self):
            self.steps = 0

        def __call__(self, rgb, viz=False):
            self.steps += 1
            return _out(rgb)

    class Pipe:
        def stream(self):
            sessions.append(Session())
            return sessions[-1]

    out = run_video(Pipe(), vp, str(tmp_path / "out.mp4"))
    assert _frame_count(out) == 3
    assert [s.steps for s in sessions] == [3]


def test_vggt_streaming_session(rng):
    """The KV-cache session on tiny VGGT weights: one more step than the
    window (the ring evicts), finite outputs, the step counter."""
    from monocular_depth_estimation_trt_tpu_torch.models.vggt import VGGT, VGGTConfig
    from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig
    from monocular_depth_estimation_trt_tpu_torch.weights.store import init_random_

    cfg = VGGTConfig(dim=64, depth=2, num_heads=4, head_layers=(0, 1, 0, 1), encoder="vits",
                     causal=True, vit_config=ViTConfig(dim=48, depth=2, num_heads=2,
                                                       pretrain_img_size=70))
    joint = VGGT(cfg, attn_impl="flash", with_camera=False)
    init_random_(joint, 0)
    sess = VGGTStreamingSession(joint.eval(), window=3, input_size=70)
    for _ in range(4):
        out = sess.step(rng.integers(0, 255, (70, 70, 3), dtype=np.uint8))
    assert out["depth"].shape == (70, 70)
    assert torch.isfinite(out["depth"]).all()
    assert int(sess.steps) == 4


def test_extract_frames_matches_jax(tmp_path):
    """The committed fixture (16 frames, 512x288) as numbered PNGs, the
    JAX function's files byte for byte; ``max_frames`` keeps the first."""
    from monocular_depth_estimation_trt_tpu.apps.streaming import (
        extract_frames_from_video as jextract,
    )

    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    assert extract_frames_from_video(FIXTURE, ours) == jextract(FIXTURE, ref) == 16
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(ref)) and names[0] == "frame_00000.png"
    for name in names:
        a, b = (imageio.read_image(os.path.join(d, name)) for d in (ours, ref))
        assert a.shape == (288, 512, 3) and np.array_equal(a, b), name
    assert extract_frames_from_video(FIXTURE, str(tmp_path / "e"), max_frames=4) == 4
    assert sorted(os.listdir(tmp_path / "e")) == names[:4]
    for name in names[:4]:
        assert np.array_equal(imageio.read_image(str(tmp_path / "e" / name)),
                              imageio.read_image(os.path.join(ours, name))), name


def test_video_without_cv2_names_the_codec(monkeypatch, tmp_path):
    monkeypatch.setattr(imageio, "_cv2", lambda: None)
    for call in (lambda: run_video(None, FIXTURE, str(tmp_path / "o.mp4")),
                 lambda: write_depth_video(None, FIXTURE, str(tmp_path / "o.mp4")),
                 lambda: extract_frames_from_video(FIXTURE, str(tmp_path / "f")),
                 lambda: imageio.VideoWriter(str(tmp_path / "o.mp4"), 10, (64, 48))):
        with pytest.raises(imageio.CodecUnavailable, match="mp4v.*cv2"):
            call()
