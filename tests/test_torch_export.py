"""The port's serialized engine artifacts (``runtime/export.py``, the
``export`` command and ``--engine`` on every serving surface) on the CPU:
the cases of the JAX package's ``tests/test_export.py`` on toy pipelines of
the port, a JAX artifact refused, and ``doctor --no-devices``.

On the CPU a loaded module runs its exported graph under an ``Engine``
without a CUDA graph; the outputs must equal the in-process pipeline's bit
for bit. ``bench`` measures only on a card (``runtime/benchmark.py``), so
its timing loop is replaced here by one that calls the step a few times."""

import dataclasses
import json
import os
import zipfile

import numpy as np
import pytest
import torch
import torch.nn as nn

from monocular_depth_estimation_trt_tpu_torch import cli, pipelines
from monocular_depth_estimation_trt_tpu_torch import registry as treg
from monocular_depth_estimation_trt_tpu_torch.config import BenchmarkConfig, ModelSpec
from monocular_depth_estimation_trt_tpu_torch.pipelines import (
    DepthPipeline,
    FlowPipeline,
    VGGTPipeline,
)
from monocular_depth_estimation_trt_tpu_torch.runtime import benchmark as tbenchmark
from monocular_depth_estimation_trt_tpu_torch.runtime.export import (
    export_pipeline,
    load_engine,
    read_meta,
)
from monocular_depth_estimation_trt_tpu_torch.utils import imageio

CPU = ["--device", "cpu"]


class _Toy(nn.Module):
    def __init__(self, **values):
        super().__init__()
        for name, value in values.items():
            setattr(self, name, nn.Parameter(torch.as_tensor(value, dtype=torch.float32)))


def _toy_pipeline(viz="relative", model="toy_export"):
    toy = _Toy(w=[2.0, 2.0, 2.0], b=0.5)

    def forward(img_u8, out_hw):
        return {"depth": img_u8.float() / 255.0 @ toy.w + toy.b}

    return DepthPipeline(ModelSpec(model=model, input_hw=(16, 16)), forward, device="cpu",
                         model=toy, viz=viz)


def _toy_flow_pipeline():
    toy = _Toy(s=0.1)

    def forward(img1, img2):
        return {"flow": ((img2.float() - img1.float()) * toy.s)[..., :2]}

    return FlowPipeline(ModelSpec(model="toy_flow", input_hw=(16, 16)), forward, device="cpu",
                        model=toy)


def _toy_views_pipeline():
    """VGGT-shaped: (S, H, W, 3) -> depth, depth_conf, pose_enc."""
    toy = _Toy(g=2.0)

    def views_forward(views_u8):
        depth = views_u8.float().mean(-1) * toy.g
        pose = torch.tensor([0, 0, 0, 0, 0, 0, 1, 0.8, 0.8]).expand(views_u8.shape[0], 9)
        return {"depth": depth, "depth_conf": torch.ones_like(depth) * 2.0, "pose_enc": pose}

    def forward(img_u8, out_hw):
        return {"depth": img_u8.float().mean(-1) * toy.g}

    return VGGTPipeline(ModelSpec(model="toy_views", input_hw=(16, 16)), forward, views_forward,
                        device="cpu", model=toy, viz="none")


class _ToyStream(DepthPipeline):
    """A running mean as the causal state: the StreamVGGT stream's contract."""

    def stream_export_bundle(self, window=2, in_hw=(16, 16)):
        def step(frame_u8, state):
            acc = state[0] + frame_u8.float().mean(-1) * self.model.g
            n = state[1] + 1.0
            depth = acc / n
            viz = depth.clamp(0, 255)[..., None].expand(*depth.shape, 3).to(torch.uint8)
            return {"depth": depth, "viz": viz}, [acc, n]

        return step, [torch.zeros(in_hw), torch.zeros(())], {}


def _toy_stream_pipeline():
    toy = _Toy(g=1.0)

    def forward(img_u8, out_hw):
        return {"depth": img_u8.float().mean(-1) * toy.g}

    return _ToyStream(ModelSpec(model="toy_stream", input_hw=(16, 16)), forward, device="cpu",
                      model=toy, viz="none")


def _img(shape=(16, 16, 3), seed=7):
    return np.random.default_rng(seed).integers(0, 255, shape, dtype=np.uint8)


def _png(path, img):
    imageio.write_image(str(path), img)
    return str(path)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """One export of each kind, shared by the cases that only read them."""
    d = tmp_path_factory.mktemp("artifacts")
    pipe = _toy_pipeline()
    flow = _toy_flow_pipeline()
    views = _toy_views_pipeline()
    stream = _toy_stream_pipeline()
    paths = {
        "raw": export_pipeline(pipe, (16, 16), path=str(d / "raw.mdeteng")),
        "viz": export_pipeline(pipe, (16, 16), with_viz=True, path=str(d / "viz.mdeteng")),
        "bundle": export_pipeline(pipe, (16, 16), with_viz="both", batches=(1, 2, 4),
                                  path=str(d / "bundle.mdeteng")),
        "flow_viz": export_pipeline(flow, (16, 16), with_viz=True, path=str(d / "f.mdeteng")),
        "flow_both": export_pipeline(flow, (16, 16), with_viz="both",
                                     path=str(d / "fb.mdeteng")),
        "views": export_pipeline(views, (16, 16), views=(2,), path=str(d / "mv.mdeteng")),
        "stream": export_pipeline(stream, (16, 16), stream_window=2,
                                  path=str(d / "st.mdeteng")),
    }
    return {"paths": paths, "pipe": pipe, "flow": flow, "views": views, "stream": stream}


def test_roundtrip_matches_pipeline(artifacts):
    eng = load_engine(artifacts["paths"]["raw"])
    img = _img()
    got, want = eng(img), artifacts["pipe"](img)
    assert set(got) == set(want) == {"depth"}
    np.testing.assert_array_equal(got["depth"], want["depth"])


def test_viz_epilogue_is_fused_into_artifact(artifacts):
    path = artifacts["paths"]["viz"]
    out = load_engine(path)(_img(), viz=True)
    want = artifacts["pipe"](_img(), viz=True)
    assert out["viz"].dtype == np.uint8
    np.testing.assert_array_equal(out["viz"], want["viz"])
    assert "b1_viz" in read_meta(path)["modules"]


def test_weights_are_snapshotted(tmp_path):
    """Plan-file semantics: changing the live weights after the export does
    not change the artifact's outputs."""
    pipe = _toy_pipeline()
    path = export_pipeline(pipe, (16, 16), path=str(tmp_path / "s.mdeteng"))
    img = _img()
    before = load_engine(path)(img)["depth"]
    with torch.no_grad():
        pipe.model.w.zero_()
    np.testing.assert_array_equal(before, load_engine(path)(img)["depth"])
    assert not np.allclose(before, pipe(img)["depth"])


def test_weights_stored_once_across_modules(artifacts):
    path = artifacts["paths"]["bundle"]
    meta = read_meta(path)
    assert sorted(meta["modules"]) == ["b1", "b1_viz", "b2", "b2_viz", "b4", "b4_viz"]
    with zipfile.ZipFile(path) as z:
        names = z.namelist()
        infos = {i.filename: i for i in z.infolist()}
    assert sum(n.startswith("params/") for n in names) == 2  # w and b, once
    assert sum(n.startswith("modules/") for n in names) == 6
    assert all(infos[n].compress_type == zipfile.ZIP_STORED for n in names
               if n.startswith("params/"))


def test_weights_shared_by_two_modules_are_stored_once(tmp_path):
    """A module that holds another's tensors (StreamVGGT's streaming model
    on the joint model's) adds no weight entry."""
    pipe = _toy_stream_pipeline()
    shared = _Toy()
    shared.g = nn.Parameter(pipe.model.g.detach())  # the same storage, another tensor
    pipe.export_modules = lambda: {"model": pipe.model, "other": shared}
    path = export_pipeline(pipe, (16, 16), path=str(tmp_path / "sh.mdeteng"))
    assert len(read_meta(path)["param_manifest"]) == 1


def test_serve_bundle_batch_call_buckets_and_pads(artifacts):
    eng = load_engine(artifacts["paths"]["bundle"])
    assert eng.batches == [1, 2, 4]
    frames = np.stack([_img(seed=s) for s in range(3)])  # 3 -> bucket 4
    got = eng.batch_call(frames)
    assert got["depth"].shape == (3, 16, 16)
    padded = np.concatenate([frames, frames[-1:]])
    np.testing.assert_array_equal(got["depth"], artifacts["pipe"].batch_call(padded)["depth"][:3])
    assert eng.batch_call(frames, viz=True)["viz"].shape == (3, 16, 16, 3)


def test_missing_bucket_raises_with_hint(artifacts):
    eng = load_engine(artifacts["paths"]["raw"])
    with pytest.raises(ValueError, match="serve-bundle"):
        eng.batch_call(np.stack([_img(), _img()]))
    with pytest.raises(ValueError, match="serve-bundle"):
        eng.batch_engine_for((16, 16), 2)


def test_viz_falls_back_to_raw_module(artifacts):
    out = load_engine(artifacts["paths"]["raw"])(_img(), viz=True)
    assert "depth" in out and "viz" not in out


def test_raw_falls_back_to_viz_module(artifacts):
    eng = load_engine(artifacts["paths"]["viz"])
    out = eng(_img(), viz=False)
    assert "depth" in out and "viz" in out
    assert eng.engine_for((16, 16), False).name.endswith("_b1_viz")


def test_export_rejects_empty_batches(tmp_path):
    with pytest.raises(ValueError, match="non-empty"):
        export_pipeline(_toy_pipeline(), (16, 16), batches=(), path=str(tmp_path / "e.mdeteng"))


def test_meta_describes_signature(artifacts):
    path = artifacts["paths"]["raw"]
    meta = read_meta(path)
    assert (meta["format"], meta["runtime"], meta["device"]) == ("MDETENG", "torch", "cpu")
    assert meta["torch_version"] == torch.__version__
    assert meta["model"] == "toy_export" and meta["in_hw"] == [16, 16]
    assert meta["inputs"] == [{"shape": [16, 16, 3], "dtype": "uint8"}]
    assert meta["n_image_args"] == 1 and meta["output_names"] == ["depth"]
    assert meta["modules"]["b1"]["outputs"] == [{"shape": [16, 16], "dtype": "float32"}]
    eng = load_engine(path)
    assert eng.in_shapes == [(16, 16, 3)]
    assert "toy_export" in eng.describe()
    assert eng.spec.artifact_name().startswith("toy_export")


def test_load_rejects_non_engine_zip(tmp_path):
    p = str(tmp_path / "junk.mdeteng")
    with zipfile.ZipFile(p, "w") as z:
        z.writestr("meta.json", "{}")
    with pytest.raises(ValueError, match="not an MDETENG artifact"):
        load_engine(p)


def test_load_refuses_a_jax_artifact(tmp_path):
    """The JAX package writes the same container under the same default
    path; the port refuses it with a message that says so."""
    import jax.numpy as jnp

    from monocular_depth_estimation_trt_tpu.config import ModelSpec as JModelSpec
    from monocular_depth_estimation_trt_tpu.pipelines import DepthPipeline as JDepthPipeline
    from monocular_depth_estimation_trt_tpu.runtime.export import (
        export_pipeline as jexport_pipeline,
    )

    def forward(params, img_u8, out_hw):
        return {"depth": img_u8.astype(jnp.float32).mean(-1) * params["g"]}

    jpipe = JDepthPipeline(JModelSpec(model="toy_jax", input_hw=(16, 16)), forward,
                           {"g": jnp.asarray(2.0, jnp.float32)})
    path = jexport_pipeline(jpipe, (16, 16), path=str(tmp_path / "jax.mdeteng"),
                            platforms=("cpu",))
    with pytest.raises(ValueError, match="exported by the JAX package"):
        load_engine(path)
    assert cli.main([*CPU, "run", "--engine", path, "--image", _png(tmp_path / "i.png", _img()),
                     "--out", str(tmp_path / "o")]) == 2


def test_flow_pipeline_exports_two_image_artifact(artifacts, tmp_path):
    eng = load_engine(artifacts["paths"]["flow_both"])
    assert eng.meta["n_image_args"] == 2
    f1, f2 = _img(seed=1), _img(seed=2)
    np.testing.assert_array_equal(eng(f1, f2)["flow"], artifacts["flow"](f1, f2)["flow"])
    assert "viz" in eng(f1, f2, viz=True)
    with pytest.raises(TypeError, match="2 image"):
        eng(f1)
    with pytest.raises(ValueError, match="single-image only"):
        eng.batch_call(np.stack([f1, f2]))
    with pytest.raises(ValueError, match="single-image only"):
        export_pipeline(artifacts["flow"], (16, 16), batches=(1, 2),
                        path=str(tmp_path / "fb.mdeteng"))


def test_views_module_exports_and_roundtrips(artifacts):
    path = artifacts["paths"]["views"]
    eng = load_engine(path)
    assert "views_s2" in read_meta(path)["modules"]
    views = np.stack([_img(seed=s) for s in range(2)])
    got, want = eng.multi_view(views), artifacts["views"].multi_view(views)
    for key in ("depth", "depth_conf", "pose_enc"):
        np.testing.assert_array_equal(got[key], want[key])
    with pytest.raises(ValueError, match=r"available: \[2\]"):
        eng.multi_view(np.stack([_img()] * 3))
    assert eng(_img())["depth"].shape == (16, 16)  # b1, not views_s2
    with pytest.raises(ValueError, match="multi-view"):
        export_pipeline(_toy_pipeline(), (16, 16), views=(2,))


def test_views_export_honors_requested_size(tmp_path):
    pipe = _toy_views_pipeline()
    path = export_pipeline(pipe, (8, 8), views=(2,), path=str(tmp_path / "mv8.mdeteng"))
    assert read_meta(path)["modules"]["views_s2"]["outputs"][0]["shape"] == [2, 8, 8]
    out = load_engine(path).multi_view(np.stack([_img((8, 8, 3), seed=s) for s in range(2)]))
    assert out["depth"].shape == (2, 8, 8)


def test_stream_module_exports_causal_state(artifacts):
    """The loaded runner carries its state between frames on the device:
    one frame twice gives the pure step's outputs, step by step."""
    path = artifacts["paths"]["stream"]
    meta = read_meta(path)
    assert meta["modules"]["stream"]["stream"] is True
    assert meta["modules"]["stream"]["window"] == 2
    runner = load_engine(path).stream()
    f = _img()
    step, state, _ = artifacts["stream"].stream_export_bundle(2, (16, 16))
    for _ in range(2):
        with torch.no_grad():
            want, state = step(torch.from_numpy(f), state)
        got = runner(f, viz=True)
        np.testing.assert_array_equal(got["depth"], want["depth"].numpy())
        assert "viz" in got
    assert load_engine(path)(_img())["depth"].shape == (16, 16)  # b1, not the stream


def test_stream_zero_state_ships_as_manifest_only(artifacts):
    path = artifacts["paths"]["stream"]
    with zipfile.ZipFile(path) as z:
        assert not any(n.startswith("state/") for n in z.namelist())
    meta = read_meta(path)
    assert all(m.get("zero") for m in meta["state_manifest"])
    assert meta["modules"]["stream"]["outputs"]


def test_stream_window_mismatch_and_rejections(artifacts, tmp_path):
    eng = load_engine(artifacts["paths"]["stream"])
    with pytest.raises(ValueError, match="stream-window 2"):
        eng.stream(window=4)
    assert callable(eng.stream(window=2))
    with pytest.raises(ValueError, match="stream-window"):
        export_pipeline(_toy_stream_pipeline(), (16, 16), stream_window=-1,
                        path=str(tmp_path / "n.mdeteng"))
    with pytest.raises(ValueError, match="streaming step"):
        export_pipeline(_toy_pipeline(), (16, 16), stream_window=2,
                        path=str(tmp_path / "sx.mdeteng"))


def test_stream_fallback_for_plain_artifacts(artifacts):
    from monocular_depth_estimation_trt_tpu_torch.runtime.transfer import supports_device_out

    runner = load_engine(artifacts["paths"]["viz"]).stream()
    out = runner(_img(), viz=True)
    assert "depth" in out and "viz" in out
    assert supports_device_out(runner)
    assert isinstance(runner(_img(), viz=True, device_out=True)["viz"], torch.Tensor)


def test_cli_export_then_run_engine(tmp_path, monkeypatch):
    """`export` writes the artifact; `run --engine` serves it (a frame of
    another size resized to the fixed input) and writes the usual files,
    the npz depth equal to the pipeline's on the fitted frame."""
    pipe = _toy_pipeline()
    monkeypatch.setattr(treg, "build_pipeline", lambda name, **kw: pipe)
    path = str(tmp_path / "cli.mdeteng")
    assert cli.main([*CPU, "export", "toy_export", "--size", "16", "--viz", "--out", path]) == 0
    assert read_meta(path)["device"] == "cpu"
    img = _img((20, 24, 3))
    out_dir = tmp_path / "out"
    assert cli.main([*CPU, "run", "--engine", path, "--image", _png(tmp_path / "img.png", img),
                     "--out", str(out_dir)]) == 0
    files = os.listdir(out_dir)
    (npz,) = [f for f in files if f.endswith(".npz")]
    depth = np.load(out_dir / npz)["depth"]
    np.testing.assert_array_equal(depth, pipe(imageio.resize(img, (16, 16)))["depth"])
    assert any(f.endswith((".jpg", ".png")) for f in files)


def test_cli_export_takes_the_bundle_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(treg, "build_pipeline", lambda name, **kw: _toy_pipeline())
    path = str(tmp_path / "sb.mdeteng")
    assert cli.main([*CPU, "export", "toy", "--size", "16", "--serve-bundle", "2",
                     "--out", path]) == 0
    assert sorted(read_meta(path)["modules"]) == ["b1", "b1_viz", "b2", "b2_viz"]
    path = str(tmp_path / "b.mdeteng")
    assert cli.main([*CPU, "export", "toy", "--size", "16", "--batches", "1,3",
                     "--out", path]) == 0
    assert sorted(read_meta(path)["modules"]) == ["b1", "b3"]


def test_cli_run_without_model_or_engine_errors():
    assert cli.main([*CPU, "run"]) == 2


def test_cli_doctor_no_devices(capsys):
    assert cli.main(["doctor", "--no-devices"]) == 0
    text = capsys.readouterr().out
    for label in ("torch", "nvcc", "kernel library", "built engines", "exported artifacts",
                  "cached weights", "native host IO", "devices"):
        assert label in text, label


@pytest.fixture
def cpu_benchmark(monkeypatch):
    """The timing loop on the CPU: the step a few times, a report."""
    calls = []

    def bench(step, *, device, config=None, name="model"):
        for _ in range(2):
            step()
        calls.append(name)
        return tbenchmark.BenchmarkReport(name=name, iterations=2, total_seconds=1e-3,
                                          times=[5e-4, 5e-4])

    monkeypatch.setattr(pipelines, "benchmark", bench)
    monkeypatch.setattr(tbenchmark, "benchmark", bench)
    return calls


def test_cli_bench_engine_and_trace(artifacts, tmp_path, cpu_benchmark):
    raw, views = artifacts["paths"]["raw"], artifacts["paths"]["views"]
    trace_dir = tmp_path / "trace"
    assert cli.main([*CPU, "bench", "--engine", raw, "--warmup", "1", "--iterations", "2",
                     "--trace", str(trace_dir)]) == 0
    (trace,) = os.listdir(trace_dir)
    assert json.load(open(trace_dir / trace))["traceEvents"]
    assert cli.main([*CPU, "bench", "--engine", views, "--views", "2"]) == 0
    assert cpu_benchmark == ["toy_export_16x16_bf16", "toy_views_16x16_bf16_in16x16_s2"]
    rep = load_engine(views).benchmark_views(2, BenchmarkConfig(warmup=1, iterations=2))
    assert rep.frames_per_iteration == 2
    with pytest.raises(ValueError, match="re-export with --views"):
        load_engine(views).benchmark_views(4)
    # what the artifact fixed cannot be asked again
    assert cli.main([*CPU, "bench", "--engine", raw, "--precision", "int8"]) == 2
    assert cli.main([*CPU, "bench", "--engine", raw, "--size", "32"]) == 2
    with pytest.raises(ValueError, match="single-image"):
        load_engine(artifacts["paths"]["flow_viz"]).benchmark()


def test_cli_batch_from_artifact(tmp_path):
    pipe = _toy_pipeline()
    path = export_pipeline(pipe, (16, 16), batches=(2,), path=str(tmp_path / "b2.mdeteng"))
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    frames = [_img(seed=s) for s in range(3)]
    for s, f in enumerate(frames):
        _png(img_dir / f"f{s}.png", f)
    out_dir = tmp_path / "bout"
    assert cli.main([*CPU, "batch", "--engine", path, "--images-dir", str(img_dir),
                     "--batch", "2", "--out", str(out_dir), "--save"]) == 0
    npz = sorted(f for f in os.listdir(out_dir) if f.endswith(".npz"))
    assert len(npz) == 3
    np.testing.assert_array_equal(np.load(out_dir / npz[0])["depth"], pipe(frames[0])["depth"])


def test_cli_views_from_artifact(artifacts, tmp_path):
    path = artifacts["paths"]["views"]
    paths = [_png(tmp_path / f"v{s}.png", _img(seed=s)) for s in range(3)]
    out_dir = tmp_path / "vout"
    assert cli.main([*CPU, "views", "--engine", path, "--resize", "16",
                     "--images", *paths[:2], "--out", str(out_dir)]) == 0
    files = os.listdir(out_dir)
    assert any(f.endswith("_s2.npz") for f in files)
    assert any(f.endswith("_s2.ply") for f in files)
    # three views, only S=2 exported: a clean error
    assert cli.main([*CPU, "views", "--engine", path, "--resize", "16", "--images", *paths,
                     "--out", str(out_dir)]) == 2


def test_cli_pair_from_artifact(tmp_path):
    toy = _Toy(o=1.0)

    def forward(img1, img2):
        d = img1.float().mean(-1) + toy.o
        pts = torch.stack([d, d, d], -1)
        return {"depth": d, "pts1": pts, "pts2": pts, "rotation": torch.eye(3),
                "translation": torch.zeros(3)}

    pipe = FlowPipeline(ModelSpec(model="toy_pair", input_hw=(16, 16)), forward, device="cpu",
                        model=toy)
    path = export_pipeline(pipe, (16, 16), path=str(tmp_path / "pair.mdeteng"))
    p1, p2 = (_png(tmp_path / f"{n}.png", _img(seed=s)) for n, s in (("a", 1), ("b", 2)))
    out_dir = tmp_path / "pout"
    assert cli.main([*CPU, "pair", "--engine", path, "--image1", p1, "--image2", p2,
                     "--out", str(out_dir)]) == 0
    files = os.listdir(out_dir)
    assert any(f.endswith((".jpg", ".png")) for f in files)
    assert any(f.endswith(".ply") for f in files)
    assert any(f.endswith("_pose.json") for f in files)


def test_cli_webcam_and_flow_engine_checks(artifacts, tmp_path):
    """A raw artifact is refused by webcam, a one-image artifact by flow, a
    flow artifact without viz by flow, a stream-only viz by webcam: before
    any model runs."""
    raw = artifacts["paths"]["raw"]
    assert cli.main([*CPU, "webcam", "--engine", raw]) == 2
    assert cli.main([*CPU, "flow", "--engine", raw, "--frames", str(tmp_path)]) == 2
    flow_raw = export_pipeline(_toy_flow_pipeline(), (16, 16), path=str(tmp_path / "fr.mdeteng"))
    assert cli.main([*CPU, "flow", "--engine", flow_raw, "--frames", str(tmp_path)]) == 2
    assert cli.main([*CPU, "webcam", "--engine", artifacts["paths"]["stream"]]) == 2
    assert cli.main([*CPU, "video", "--engine", raw, "--video", "x.mp4",
                     "--out", str(tmp_path)]) == 2


def _write_video(path, n, hw=(48, 64)):
    cv2 = pytest.importorskip("cv2")
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10, (hw[1], hw[0]))
    for s in range(n):
        writer.write(cv2.cvtColor(_img((*hw, 3), seed=s), cv2.COLOR_RGB2BGR))
    writer.release()
    return str(path)


def _frame_count(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


@pytest.mark.parametrize("kind,frames", [("viz", 4), ("stream", 3)])
def test_cli_video_from_artifact(artifacts, tmp_path, kind, frames):
    """`video --engine`: per frame from a viz module, or the causal stream
    from a stream module, frames resized to the fixed input."""
    video = _write_video(tmp_path / "in.mp4", frames)
    out_dir = tmp_path / "vout"
    assert cli.main([*CPU, "video", "--engine", artifacts["paths"][kind], "--video", video,
                     "--out", str(out_dir)]) == 0
    (mp4,) = [f for f in os.listdir(out_dir) if f.endswith(".mp4")]
    assert _frame_count(out_dir / mp4) == frames


def test_cli_flow_from_artifact(artifacts, tmp_path):
    pytest.importorskip("cv2")
    frames = tmp_path / "frames"
    frames.mkdir()
    for s in range(3):
        _png(frames / f"f{s}.png", _img(seed=s))
    out_dir = tmp_path / "fout"
    assert cli.main([*CPU, "flow", "--engine", artifacts["paths"]["flow_viz"], "--frames",
                     str(frames), "--out", str(out_dir)]) == 0
    assert _frame_count(out_dir / "toy_flow_flow.mp4") == 2


def test_http_server_from_artifact(artifacts):
    """The server drives a LoadedEngine by the pipeline convention: single
    frames and dynamic batches, each answer equal to the pipeline's."""
    from monocular_depth_estimation_trt_tpu_torch.apps.server import DepthServer

    eng = load_engine(artifacts["paths"]["bundle"])
    ds = DepthServer(eng, max_batch=2).start()
    try:
        ds.warmup()
        frames = [_img(seed=s) for s in range(3)]
        jobs = [ds.submit(f, viz=(s == 0)) for s, f in enumerate(frames)]
        for job in jobs:
            assert job.done.wait(30) and job.error is None
        for job, f in zip(jobs, frames):
            np.testing.assert_array_equal(job.result["depth"], artifacts["pipe"](f)["depth"])
        assert "viz" in jobs[0].result
        assert ds.health()["model"].startswith("toy_export")
    finally:
        ds.stop()


def test_cli_serve_multi_engine_branch(artifacts, tmp_path, monkeypatch):
    """`serve --engine a --engine b`: every artifact loaded, keyed by family,
    --max-batch clamped to the largest exported bucket, one dict to serve()."""
    from monocular_depth_estimation_trt_tpu_torch.apps import server

    pb = _toy_pipeline(model="toy_export_b")
    path_b = export_pipeline(pb, (16, 16), with_viz="both", batches=(1, 2),
                             path=str(tmp_path / "b.mdeteng"))
    captured = {}

    def fake_serve(pipeline, **kw):
        captured["pipeline"] = pipeline
        captured.update(kw)

    monkeypatch.setattr(server, "serve", fake_serve)
    path_a = artifacts["paths"]["bundle"]
    assert cli.main([*CPU, "serve", "--engine", path_a, "--engine", path_b,
                     "--max-batch", "8", "--port", "0"]) == 0
    pipes = captured["pipeline"]
    assert list(pipes) == ["toy_export", "toy_export_b"]
    assert captured["max_batch"] == 4
    assert server.DepthServer(pipes, max_batch=4).max_batch_by == {"toy_export": 4,
                                                                   "toy_export_b": 2}
    assert cli.main([*CPU, "serve", "--engine", path_a, "--engine", path_a, "--port", "0"]) == 2
    spec = dataclasses.replace(pipes["toy_export"].spec)
    assert spec.model == "toy_export"
