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
from monocular_depth_estimation_trt_tpu_torch.models.vggt import VGGTConfig, build_stage_pipeline
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


def test_vggt_stage_pipeline_engines_equal_the_joint_model(cuda):
    """``build_stage_pipeline`` on the card: each stage a captured engine of
    its own, the tokens passed from one to the next on the device; depth,
    depth_conf and pose_enc equal to the joint model's eager forward bit for
    bit, at the capture's call and at a replay; the aggregator's engine
    holds the kernels (K1 in the DINOv2 patch embed, K2 in the frame and
    global blocks), the heads none."""
    with allow_random_weights(True):
        pipe = build_pipeline("vggt", input_size=70, vggt_cfg=SMALL_VGGT)
    stages = build_stage_pipeline(pipe.model)
    rng = np.random.default_rng(4)
    for _ in range(2):
        views = torch.from_numpy(rng.standard_normal((1, 3, 70, 70, 3)).astype(np.float32))
        out = stages({"views": views.cuda()})
        with torch.inference_mode():
            joint = pipe.model(views.cuda())
        for k in ("depth", "depth_conf", "pose_enc"):
            assert out[k].is_cuda and torch.equal(out[k], joint[k]), k
    launches = {name: {k: v for k, v in eng.captured_launches.items() if v}
                for (name, _), eng in stages._engines.items()}
    assert launches == {"aggregator": {"flash_attention_packed": 2, "flash_attention": 4},
                        "depth_head": {}, "camera_head": {}}


def test_int8_engine_replays_the_eager_forward(cuda, monkeypatch):
    monkeypatch.setenv("MDET_FORCE_INT8", "1")
    calib = list(_frames(2, (70, 70), seed=5))
    with allow_random_weights(True):
        pipe = build_pipeline("depth_anything_v2", precision="int8", calib_images=calib,
                              **SMALL_DA)
    a, b = _frames(2, (70, 70), seed=6)
    _check_engine(pipe.engine_for((70, 70)), lambda x: pipe._run(x, (70, 70), False), a, b,
                  {"flash_attention_packed": 2, "w8a8_matmul": 8})


SMALL_HEAD = dict(vit_config=ViTConfig(dim=128, depth=2, num_heads=2, pretrain_img_size=70),
                  head_features=16, head_out_channels=(8, 16, 32, 32), out_indices=(0, 1, 0, 1))


def test_vda_window_engine_replays_the_eager_forward(cuda):
    """A 4-frame window (K1 at batch 4), and the single-image engine."""
    with allow_random_weights(True):
        pipe = build_pipeline("video_depth_anything", input_size=70, window=4, overlap=2,
                              model_kw=dict(num_heads=2, **SMALL_HEAD))
    a, b = _frames(4, (48, 64)), _frames(4, (48, 64), seed=1)
    _check_engine(pipe.window_engine((48, 64)), pipe._window_forward, a, b,
                  {"flash_attention_packed": 2})
    a1, b1 = _frames(2, (48, 64), seed=2)
    _check_engine(pipe.engine_for((48, 64)), lambda x: pipe._run(x, (48, 64), False), a1, b1,
                  {"flash_attention_packed": 2})


def test_flashdepth_session_replays_the_eager_step(cuda):
    """Four steps of the captured session against the eager step on a copy
    of the state before each; reset() zeroes the state in place."""
    with allow_random_weights(True):
        pipe = build_pipeline("flashdepth", input_size=70, model_kw=SMALL_HEAD)
    frames = _frames(4, (48, 64), seed=3)
    sess = pipe.stream()
    eng = sess.engine_for((48, 64))
    assert not any(t.any() for t in sess.state.values())  # the build put the state back
    assert {k: v for k, v in eng.captured_launches.items() if v} == {"flash_attention_packed": 2}
    outs = []
    for f in frames:
        before = {k: t.clone() for k, t in sess.state.items()}
        with torch.inference_mode():
            ref, new = pipe._forward_state(torch.from_numpy(f).cuda(), (48, 64), before)
        outs.append(sess.step(f))
        assert torch.equal(outs[-1]["depth"], ref["depth"])
        for k in new:
            assert torch.equal(sess.state[k], new[k]), k
    assert not torch.equal(outs[0]["depth"], outs[1]["depth"])
    sess.reset()
    assert not any(t.any() for t in sess.state.values())
    assert torch.equal(sess.step(frames[0])["depth"], outs[0]["depth"])


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


def test_ba_solve_engine_replays_the_eager_solve(cuda):
    """The SLAM recipes' LM solve (``slam/recipes.py``) captured at K=4
    keyframes on a 96x128 flow grid: the replay equals the eager solve bit
    for bit, outputs poisoned with NaN before it, and a result outlives the
    next call."""
    from monocular_depth_estimation_trt_tpu_torch.slam.ba import init_state
    from monocular_depth_estimation_trt_tpu_torch.slam.recipes import MegaSaMPipeline, ba_solve_fn

    pipe = MegaSaMPipeline(device="cuda")
    prob = pipe._synthetic_problem((96, 128), k=4)
    k, (e, p) = 4, prob.weight.shape
    args = [*prob, *init_state(k), torch.tensor(115.2)]
    eng = pipe.solve_engine((96, 128), k, e, p)
    eng.compile()
    with torch.inference_mode():
        for t in eng.static_outputs().values():
            t.fill_(float("nan"))
    out = eng(*args)
    with torch.inference_mode():  # the solve leaves inference mode for jacfwd itself
        ref = ba_solve_fn((96, 128), pipe.ba_cfg)(*(a.cuda() for a in args))
    for name in ref:
        assert torch.equal(out[name], ref[name]), name
    kept = {n: v.clone() for n, v in out.items()}
    other = [a.clone() for a in args]
    other[3] = other[3] + 1.0  # another flow
    second = eng(*other)
    assert all(torch.equal(out[n], kept[n]) for n in out)
    assert not torch.equal(second["poses"], out["poses"])
    assert eng.captured_launches == {n: 0 for n in eng.captured_launches}


def test_mapping_step_engine_replays_the_eager_step(cuda):
    """WildGS-SLAM's mapping step (render, backward, Adam) captured at a
    64x64 map of 1024 slots: the replay's new state equals the eager
    step's bit for bit."""
    from monocular_depth_estimation_trt_tpu_torch.slam.gaussians import init_from_depth
    from monocular_depth_estimation_trt_tpu_torch.slam.recipes import (
        WildGSSLAMPipeline,
        flatten_mapping_state,
        unflatten_mapping_state,
    )

    pipe = WildGSSLAMPipeline(device="cuda", map_hw=(64, 64), max_gaussians=1024, k_per_tile=16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    depth = 2.0 + torch.rand((64, 64), generator=gen, device="cuda")
    rgb = torch.rand((64, 64, 3), generator=gen, device="cuda")
    pose, focal = torch.eye(4, device="cuda"), torch.tensor(60.0, device="cuda")
    with torch.no_grad():
        gmap = init_from_depth(rgb, depth, pose, focal, stride=2, max_gaussians=1024)
    net, (init_opt, step) = pipe._mapper()
    unc = {n: v.detach().clone() for n, v in net.named_parameters()}
    state = flatten_mapping_state(gmap, unc, init_opt(gmap, unc))
    names = list(unc)
    eng = pipe.mapping_engine(step, state, names, (64, 64))
    out = eng(*state, rgb, depth, pose, focal)
    with torch.inference_mode():  # the step leaves inference mode for its gradients itself
        g2, u2, o2, loss, _ = step(*unflatten_mapping_state(state, names), rgb, depth, pose, focal)
    ref = [*flatten_mapping_state(g2, u2, o2), loss]
    assert len(out) == len(ref)
    for i, (a, b) in enumerate(zip(out, ref)):
        assert torch.equal(a, b), i
    assert not torch.equal(out[0], state[0])  # the step moved the means
