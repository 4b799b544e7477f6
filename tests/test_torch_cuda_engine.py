"""The port's captured engines on a card (marker ``cuda``; each test skips
where ``torch.cuda.is_available()`` is false: a CUDA graph has no CPU mode).

Small pipelines (head_dim 64, two blocks) through ``runtime/engine.py``:
the replay against the eager forward on the same input, bit for bit;
output buffers poisoned with NaN before a replay; results that outlive the
next replay; the kernel launches of the captured forward; one graph per
batch bucket; replays from another thread; the HTTP server's batched
answers against ``batch_call``. Imports neither JAX nor the JAX package::

    python -m pytest tests/test_torch_cuda_engine.py -m cuda --noconftest -q
"""

import io
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu_torch.apps.server import DepthServer, make_handler
from monocular_depth_estimation_trt_tpu_torch.models.vggt import VGGTConfig
from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig
from monocular_depth_estimation_trt_tpu_torch.registry import build_pipeline
from monocular_depth_estimation_trt_tpu_torch.runtime.engine import WARMUP_CALLS, Engine
from monocular_depth_estimation_trt_tpu_torch.utils.imageio import encode_png
from monocular_depth_estimation_trt_tpu_torch.weights.store import allow_random_weights

pytestmark = pytest.mark.cuda

SMALL_DA = dict(encoder="small", input_size=70, model_kw=dict(
    vit_config=ViTConfig(dim=128, depth=2, num_heads=2, pretrain_img_size=70),
    head_features=16, head_out_channels=(8, 16, 32, 32), out_indices=(0, 1, 0, 1)))
SMALL_VGGT = VGGTConfig(dim=128, depth=2, num_heads=2, head_layers=(0, 1, 0, 1),
                        vit_config=ViTConfig(dim=128, depth=2, num_heads=2, pretrain_img_size=70),
                        head_features=16, head_out_channels=(8, 16, 32, 32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a captured graph has no CPU mode")
    return torch.device("cuda")


def _frames(n, hw, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


def _check_engine(engine, eager, arg, other, launches):
    """Poisoned outputs, replay == eager bit for bit, a result that survives
    the next call, the captured launches."""
    engine.compile()
    with torch.inference_mode():
        for t in engine.static_outputs().values():
            if t.is_floating_point():
                t.fill_(float("nan"))
    out = engine(torch.from_numpy(arg))
    with torch.inference_mode():
        ref = eager(torch.from_numpy(arg).cuda())
    assert sorted(out) == sorted(ref)
    for k in out:
        # every NaN overwritten; finite wherever the eager forward is (a
        # random-weight VGGT fov at the relu's 0 gives an inf focal_px)
        assert not torch.isnan(out[k].float()).any(), k
        assert torch.equal(torch.isfinite(out[k]), torch.isfinite(ref[k])), k
        assert torch.equal(out[k], ref[k]), k
    kept = {k: v.clone() for k, v in out.items()}
    second = engine(torch.from_numpy(other))
    for k in out:
        assert torch.equal(out[k], kept[k]), k
    assert not torch.equal(second["depth"], out["depth"])
    got = {k: v for k, v in engine.captured_launches.items() if v}
    assert got == launches


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_depth_engine_replays_the_eager_forward(cuda, precision):
    with allow_random_weights(True):
        pipe = build_pipeline("depth_anything_v2", precision=precision, **SMALL_DA)
    a, b = _frames(2, (48, 64))
    _check_engine(pipe.engine_for((48, 64), True), lambda x: pipe._run(x, (48, 64), True),
                  a, b, {"flash_attention_packed": 2})


def test_vggt_views_engine_replays_the_eager_forward(cuda):
    with allow_random_weights(True):
        pipe = build_pipeline("vggt", input_size=70, vggt_cfg=SMALL_VGGT)
    a, b = _frames(3, (70, 70)), _frames(3, (70, 70), seed=1)
    _check_engine(pipe.views_engine(3), pipe._views_forward, a, b,
                  {"flash_attention_packed": 2, "flash_attention": 4})
    a1, b1 = _frames(2, (48, 64), seed=2)
    _check_engine(pipe.engine_for((48, 64)), lambda x: pipe._run(x, (48, 64), False), a1, b1,
                  {"flash_attention_packed": 2, "flash_attention": 4})


def test_int8_engine_replays_the_eager_forward(cuda, monkeypatch):
    monkeypatch.setenv("MDET_FORCE_INT8", "1")
    calib = list(_frames(2, (70, 70), seed=5))
    with allow_random_weights(True):
        pipe = build_pipeline("depth_anything_v2", precision="int8", calib_images=calib,
                              **SMALL_DA)
    a, b = _frames(2, (70, 70), seed=6)
    _check_engine(pipe.engine_for((70, 70)), lambda x: pipe._run(x, (70, 70), False), a, b,
                  {"flash_attention_packed": 2, "w8a8_matmul": 8})


def test_one_graph_per_batch_bucket(cuda):
    with allow_random_weights(True):
        pipe = build_pipeline("depth_anything_v2", **SMALL_DA)
    engines = []
    for bucket in (1, 2, 4):
        frames = _frames(bucket, (70, 70), seed=bucket)
        out = pipe.batch_call(frames, viz=True)
        eng = pipe.batch_engine_for((70, 70), bucket, True)
        assert out["depth"].shape == (bucket, 70, 70) and out["viz"].shape == (bucket, 70, 70, 3)
        with torch.inference_mode():
            ref = pipe._run(torch.from_numpy(frames).cuda(), (70, 70), True)
        assert np.array_equal(out["depth"], ref["depth"].cpu().numpy())
        assert eng.captured_launches["flash_attention_packed"] == 2
        engines.append(eng)
    assert len({id(e) for e in engines}) == 3 and len({e.name for e in engines}) == 3
    assert all(e._graph is not None for e in engines)


def test_replays_from_another_thread_use_its_stream(cuda):
    """The server's worker replays graphs captured by the main thread (and
    captures its own): the results are the main thread's."""
    with allow_random_weights(True):
        pipe = build_pipeline("depth_anything_v2", **SMALL_DA)
    a, b = _frames(2, (70, 70), seed=7)
    want_a = pipe(a)["depth"]
    got = {}

    def worker():
        got["a"] = pipe(a)["depth"]
        got["b"] = pipe(b, viz=True)["depth"]  # captured on this thread

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert np.array_equal(got["a"], want_a)
    assert np.array_equal(got["b"], pipe(b)["depth"])


def test_engine_of_a_plain_function(cuda):
    eng = Engine(lambda x: {"y": x.float() * 2 + 1}, (torch.empty(4, 5, device="meta"),),
                 name="toy_cuda_engine", device="cuda")
    x = torch.arange(20.0).reshape(4, 5)
    out = eng(x)["y"]
    assert out.is_cuda and torch.equal(out.cpu(), x * 2 + 1)
    assert eng.captured_launches == {k: 0 for k in eng.captured_launches}
    assert WARMUP_CALLS >= 1


def test_server_batches_answer_as_batch_call(cuda):
    """Four jobs queued before the worker starts form one bucket of 4 on the
    card: each answer is its frame's row of ``batch_call`` on that bucket;
    a request over HTTP answers as the single-frame call."""
    with allow_random_weights(True):
        pipe = build_pipeline("depth_anything_v2", **SMALL_DA)
    ds = DepthServer(pipe, max_batch=4, batch_window_ms=50.0)
    ds.warmup()
    frames = _frames(4, (70, 70), seed=9)
    jobs = [ds.submit(f, viz=False) for f in frames]
    ds.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(ds))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        for j in jobs:
            assert j.done.wait(60) and j.error is None
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/v1/depth",
                                     data=encode_png(frames[0]), method="POST")
        single = np.load(io.BytesIO(urllib.request.urlopen(req, timeout=60).read()))
    finally:
        httpd.shutdown()
        httpd.server_close()
        ds.stop()
    assert ds.stats()["batches"] == 1
    ref = pipe.batch_call(frames)["depth"]
    for i, j in enumerate(jobs):
        assert np.array_equal(j.result["depth"], ref[i])
    assert np.array_equal(single["depth"], pipe(frames[0])["depth"])
