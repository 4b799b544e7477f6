"""The port's runtime tools on the CPU: ``runtime/profiler.py`` (the trace
and ``StageTimer``), the native host-IO binding ``runtime/native.py`` (the
cases of ``tests/test_native.py``, skipped as that file skips them where the
library does not build; its output against the JAX binding's on the same
files) and the on-disk int8 serving bundle of ``registry.py``."""

import json
import os
import time

import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu_torch import registry as treg
from monocular_depth_estimation_trt_tpu_torch.ops import quant as tquant
from monocular_depth_estimation_trt_tpu_torch.runtime import native, profiler
from monocular_depth_estimation_trt_tpu_torch.utils import imageio
from monocular_depth_estimation_trt_tpu_torch.weights import store

from test_torch_int8_slice import SIZE, _port_kw

needs_native = pytest.mark.skipif(not native.native_available(),
                                  reason="native toolchain/OpenCV unavailable")


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with profiler.trace(str(tmp_path / "t")) as path:
        for _ in range(3):
            x = torch.mm(x, x).tanh()
    assert os.path.dirname(path) == str(tmp_path / "t")
    events = json.load(open(path))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_stage_timer_accumulates_sections():
    timer = profiler.StageTimer()
    for _ in range(3):
        with timer.section("decode"):
            time.sleep(0.002)
    with timer.section("model", sync={"depth": torch.zeros(2)}):
        pass
    rep = timer.report()
    assert rep["decode"]["count"] == 3 and rep["model"]["count"] == 1
    assert rep["decode"]["avg_ms"] >= 2.0
    assert rep["decode"]["total_s"] >= 0.006


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(10):
        img = rng.integers(0, 255, (120, 160, 3), dtype=np.uint8)
        img[:10, :10] = i * 20  # the frame index, for the order
        p = str(d / f"f_{i:03d}.png")
        cv2.imwrite(p, img)
        paths.append(p)
    return paths


@needs_native
def test_decode_resize_matches_cv2_and_the_jax_binding(image_dir):
    import cv2

    from monocular_depth_estimation_trt_tpu.runtime import native as jnative

    out = native.decode_resize(image_dir[0], (60, 80))
    ref = cv2.resize(cv2.cvtColor(cv2.imread(image_dir[0]), cv2.COLOR_BGR2RGB), (80, 60),
                     interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, jnative.decode_resize(image_dir[0], (60, 80)))


@needs_native
@pytest.mark.parametrize("hw,threads", [((120, 160), 4), ((64, 96), 2)])
def test_pump_delivers_in_order(image_dir, hw, threads):
    with native.FramePump.from_images(image_dir, hw, threads=threads) as pump:
        seen = []
        for idx, frame in pump:
            assert frame.shape == (*hw, 3)
            if hw == (120, 160):  # no resize: the marker survives
                assert frame[0, 0, 0] == idx * 20
            seen.append(idx)
        assert seen == list(range(10)) and pump.decoded == 10


@needs_native
def test_pump_small_ring_does_not_deadlock(tmp_path):
    import cv2

    rng = np.random.default_rng(3)
    paths = []
    for i in range(40):
        p = str(tmp_path / f"s_{i:03d}.png")
        cv2.imwrite(p, rng.integers(0, 255, (64, 64, 3), dtype=np.uint8))
        paths.append(p)
    with native.FramePump.from_images(paths, (64, 64), ring=2, threads=6) as pump:
        seen = []
        for idx, _ in pump:
            time.sleep(0.002)  # a slow consumer widens the race window
            seen.append(idx)
    assert seen == list(range(40))


@needs_native
def test_encode_jpg_and_the_video_pump(tmp_path):
    import cv2

    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 255, (50, 60, 3), dtype=np.uint8)
    p = str(tmp_path / "out.jpg")
    assert native.encode_jpg(p, rgb)
    back = cv2.imread(p)
    assert back is not None and back.shape == (50, 60, 3)
    vp = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(vp, cv2.VideoWriter_fourcc(*"mp4v"), 10, (96, 64))
    for _ in range(6):
        writer.write(rng.integers(0, 255, (64, 96, 3), dtype=np.uint8))
    writer.release()
    with native.FramePump.from_video(vp, (64, 96)) as pump:
        assert [idx for idx, _ in pump] == list(range(6))


@needs_native
def test_offline_batching_decodes_through_the_pump(image_dir, tmp_path):
    """``apps/offline.py`` takes the native ring where it is available and
    says so; its frames are the Python path's (cv2 decode and resize)."""
    from monocular_depth_estimation_trt_tpu_torch.apps.offline import process_images_batched
    from monocular_depth_estimation_trt_tpu_torch.config import ModelSpec
    from monocular_depth_estimation_trt_tpu_torch.pipelines import DepthPipeline

    pipe = DepthPipeline(ModelSpec(model="toy", input_hw=(60, 80)),
                         lambda img, hw: {"depth": img.float().mean(-1)}, device="cpu")
    got = {}
    stats = process_images_batched(pipe, image_dir[:5], batch=2,
                                   on_result=lambda i, host: got.update({i: host["depth"]}))
    assert stats["decode"] == "native" and stats["frames"] == 5
    want = imageio.resize(imageio.read_image(image_dir[2]), (60, 80)).astype(np.float32)
    np.testing.assert_array_equal(got[2][0], want.mean(-1))


def _tiny_int8(**kw):
    return treg.build_pipeline("depth_anything_v2", encoder="tiny", input_size=SIZE,
                               precision="int8", device="cpu", attn_impl="xla",
                               model_kw=_port_kw(), **kw)


def test_int8_bundle_is_cached_and_loaded_without_calibrating(monkeypatch, tmp_path):
    """The first int8 build of seeded weights on the default calibration set
    calibrates and caches the bundle under the bf16 artifact's name; the
    second loads it, never calibrates, and serves the same outputs. Explicit
    weights or calibration images are never cached."""
    monkeypatch.setenv("MDET_CACHE_DIR", str(tmp_path))
    calls = []
    calibrate = tquant.calibrate
    monkeypatch.setattr(tquant, "calibrate",
                        lambda *a, **k: calls.append(1) or calibrate(*a, **k))
    with store.allow_random_weights():
        first = _tiny_int8()
        path = treg.int8_bundle_path(first.spec)
        assert calls == [1] and os.path.exists(path)
        assert os.path.basename(path) == "depth_anything_v2_tiny_70x70_bf16_int8bundle_v2.pt"
        second = _tiny_int8()
    assert calls == [1]
    frame = np.random.default_rng(2).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    np.testing.assert_array_equal(second(frame)["depth"], first(frame)["depth"])
    quantized = [sorted(n for n, m in p.model.named_modules() if isinstance(m, tquant.QuantLinear))
                 for p in (first, second)]
    assert quantized[0] == quantized[1] and len(quantized[0]) == 16
    mtime = os.stat(path).st_mtime_ns
    with store.allow_random_weights():
        weights = treg.build_pipeline("depth_anything_v2", encoder="tiny", input_size=SIZE,
                                      precision="fp32", device="cpu", attn_impl="xla",
                                      model_kw=_port_kw()).model.state_dict()
        _tiny_int8(params=weights)
        _tiny_int8(calib_images=[frame])
    assert calls == [1, 1, 1] and os.stat(path).st_mtime_ns == mtime
