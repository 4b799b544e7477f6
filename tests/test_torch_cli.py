"""The port's command line (``cli.py``, ``python -m
monocular_depth_estimation_trt_tpu_torch``) against the JAX package's CLI on
the CPU: the same seeded PNG through ``run`` and ``views`` on both sides,
with one set of weights (``weights/from_jax.py``) and ``build_pipeline``
replaced on both sides as ``tests/test_cli_run.py`` does; and the modules
behind its artifacts (``ops/camera.py``'s unprojections, ``apps/ply.py``,
``apps/pointcloud.py``) against their JAX counterparts."""

import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu import cli as jcli
from monocular_depth_estimation_trt_tpu import registry as jreg
from monocular_depth_estimation_trt_tpu.apps import ply as jply
from monocular_depth_estimation_trt_tpu.apps import pointcloud as jpointcloud
from monocular_depth_estimation_trt_tpu.config import ModelSpec as JModelSpec
from monocular_depth_estimation_trt_tpu.ops import camera as jcamera
from monocular_depth_estimation_trt_tpu.pipelines import DepthPipeline as JDepthPipeline
from monocular_depth_estimation_trt_tpu_torch import cli
from monocular_depth_estimation_trt_tpu_torch import registry as treg
from monocular_depth_estimation_trt_tpu_torch.apps import ply as tply
from monocular_depth_estimation_trt_tpu_torch.apps import pointcloud as tpointcloud
from monocular_depth_estimation_trt_tpu_torch.config import ModelSpec
from monocular_depth_estimation_trt_tpu_torch.ops import camera as tcamera
from monocular_depth_estimation_trt_tpu_torch.pipelines import DepthPipeline
from monocular_depth_estimation_trt_tpu_torch.utils import imageio

from torch_port_params import rel_err

REL_TOL = 2e-3  # fp32 on both sides


def _png(tmp_path, name="frame.png", hw=(48, 64), seed=3):
    path = str(tmp_path / name)
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (hw[0] // 8 + 1, hw[1] // 8 + 1, 3))
    img = np.repeat(np.repeat(coarse, 8, axis=0), 8, axis=1)[: hw[0], : hw[1]]
    imageio.write_image(path, np.ascontiguousarray(img.astype(np.uint8)))
    return path


def _run_both(monkeypatch, tmp_path, jpipe, tpipe, argv):
    monkeypatch.setattr(jreg, "build_pipeline", lambda name, **kw: jpipe)
    monkeypatch.setattr(treg, "build_pipeline", lambda name, **kw: tpipe)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    rc_j = jcli.main([argv[0], "toy", *argv[1:], "--out", jdir])
    rc_t = cli.main(["--device", "cpu", argv[0], "toy", *argv[1:], "--out", tdir])
    return (rc_j, jdir), (rc_t, tdir)


def _only(directory, suffix):
    (name,) = [f for f in os.listdir(directory) if f.endswith(suffix)]
    return os.path.join(directory, name)


def test_run_matches_the_jax_cli(monkeypatch, tmp_path):
    """Tiny DA-V2 (dim 64, depth 4, 2 heads, fp32, plain attention on both
    sides): npz depth, viz and point cloud."""
    from test_torch_da_v2_slice import TINY, _pipelines

    jpipe, tpipe = _pipelines(monkeypatch, TINY)
    png = _png(tmp_path)
    (rc_j, jdir), (rc_t, tdir) = _run_both(monkeypatch, tmp_path, jpipe, tpipe,
                                           ["run", "--image", png, "--pointcloud"])
    assert rc_j == rc_t == 0
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    ref, ours = (np.load(_only(d, ".npz"))["depth"] for d in (jdir, tdir))
    assert ours.shape == ref.shape == (48, 64)
    assert rel_err(ours, ref) < REL_TOL
    (ref_pts, ref_col), (pts, col) = (jply.read_ply(_only(d, ".ply")) for d in (jdir, tdir))
    assert pts.shape == ref_pts.shape == (48 * 64, 3)
    np.testing.assert_array_equal(col, ref_col)
    assert rel_err(pts, ref_pts) < REL_TOL


def _toy_pipelines(extra):
    spec = dict(model="toy_cli", input_hw=(16, 16))

    def jforward(params, img_u8, out_hw):
        out = {"depth": img_u8.astype(jnp.float32)[..., 0] / 255.0 + 1.0}
        out.update({k: jnp.asarray(v) for k, v in extra.items()})
        return out

    def tforward(img_u8, out_hw):
        out = {"depth": img_u8.float()[..., 0] / 255.0 + 1.0}
        out.update({k: torch.tensor(v) for k, v in extra.items()})
        return out

    return (JDepthPipeline(JModelSpec(**spec), jforward, {}, viz="none"),
            DepthPipeline(ModelSpec(**spec), tforward, device="cpu", viz="none"))


@pytest.mark.parametrize("extra", [{"f_px": 30.0}, {"focal": 0.8}, {}])
def test_fov_json_matches_the_jax_cli(monkeypatch, tmp_path, extra):
    jpipe, tpipe = _toy_pipelines(extra)
    png = _png(tmp_path, hw=(20, 24))
    (rc_j, jdir), (rc_t, tdir) = _run_both(monkeypatch, tmp_path, jpipe, tpipe,
                                           ["run", "--image", png, "--pointcloud"])
    assert rc_j == rc_t == 0
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    fovs = [f for f in os.listdir(tdir) if f.endswith("_fov.json")]
    assert len(fovs) == (1 if extra else 0)
    for f in fovs:
        assert json.load(open(os.path.join(tdir, f))) == json.load(open(os.path.join(jdir, f)))
    if "f_px" in extra:  # the point cloud unprojects with the predicted focal
        (ref_pts, _), (pts, _) = (jply.read_ply(_only(d, ".ply")) for d in (jdir, tdir))
        assert rel_err(pts, ref_pts) < 1e-6


def test_compare_exit_codes_match_the_jax_cli(monkeypatch, tmp_path):
    jpipe, tpipe = _toy_pipelines({})
    png = _png(tmp_path, hw=(20, 24))
    _run_both(monkeypatch, tmp_path, jpipe, tpipe, ["run", "--image", png])
    ref = _only(str(tmp_path / "jax"), ".npz")
    depth = np.load(ref)["depth"]
    drifted, cut = str(tmp_path / "drifted.npz"), str(tmp_path / "cut.npz")
    np.savez_compressed(drifted, depth=depth + 1.0)
    np.savez_compressed(cut, depth=depth[:-2])
    for target, want in ((ref, 0), (drifted, 1), (cut, 1)):
        (rc_j, _), (rc_t, _) = _run_both(monkeypatch, tmp_path, jpipe, tpipe,
                                         ["run", "--image", png, "--compare", target])
        assert rc_j == rc_t == want, target


def test_views_matches_the_jax_cli(monkeypatch, tmp_path):
    """Tiny VGGT (head_dim 64, 70² input): the S-stack npz and the merged
    world-point cloud."""
    from test_torch_vggt_slice import _pipelines

    jpipe, tpipe = _pipelines(with_camera=True)
    pngs = [_png(tmp_path, f"v{i}.png", hw=(60, 80), seed=i) for i in range(2)]
    (rc_j, jdir), (rc_t, tdir) = _run_both(monkeypatch, tmp_path, jpipe, tpipe,
                                           ["views", "--images", *pngs, "--resize", "70"])
    assert rc_j == rc_t == 0
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    ref, ours = (np.load(_only(d, "_s2.npz")) for d in (jdir, tdir))
    for key in ("depth", "depth_conf", "pose_enc"):
        assert ours[key].shape == ref[key].shape
        assert rel_err(ours[key], ref[key]) < REL_TOL, key
    (ref_pts, ref_col), (pts, col) = (jply.read_ply(_only(d, "_s2.ply")) for d in (jdir, tdir))
    assert pts.shape == ref_pts.shape and pts.shape[0] > 0
    np.testing.assert_array_equal(col, ref_col)
    assert rel_err(pts, ref_pts) < REL_TOL


def test_parser_has_the_ported_commands_and_rejects_the_rest():
    p = cli.build_parser()
    for cmd in (["run", "x"], ["batch", "x", "--images-dir", "d"], ["views", "--images", "a"],
                ["bench", "x"], ["build", "x"], ["serve", "x"], ["models"], ["engines"],
                ["batch", "x", "--video", "v.mp4"], ["video", "x", "--video", "v.mp4"],
                ["webcam", "x", "--camera", "1"], ["flow", "raft"], ["track", "--video", "v.mp4"],
                ["slam", "megasam", "--video", "v.mp4"], ["export", "x"], ["doctor"],
                ["run", "x", "--engine", "e.mdeteng"], ["bench", "x", "--trace", "t"],
                ["flow", "raft", "--engine", "e"], ["serve", "--engine", "a", "--engine", "b"],
                ["convert", "x", "--checkpoint", "c", "--verify-manifest", "--report"],
                ["eval", "--pred", "p", "--gt", "g", "--align", "median", "--flow"],
                ["quantcheck", "x", "--images", "d", "--min-delta1", "0.9"],
                ["distill", "--images-dir", "d", "--qat", "--promote"],
                ["bench", "x", "--device-mesh", "1x1"], ["serve", "x", "--device-mesh", "1x8"]):
        assert p.parse_args(cmd).fn.__name__ == f"cmd_{cmd[0]}"
    assert p.parse_args(["run", "x", "--colorbar"]).colorbar
    assert p.parse_args(["run", "x"]).device == "cuda"
    assert p.parse_args(["--device", "cpu", "run", "x"]).device == "cpu"
    a = p.parse_args(["run", "x", "--precision", "int8", "--calib-dir", "c", "--compare", "r",
                      "--compare-tol", "0.5", "--allow-random-weights"])
    assert (a.precision, a.calib_dir, a.compare, a.compare_tol) == ("int8", "c", "r", 0.5)
    assert p.parse_args(["serve", "x", "--device-mesh", "1x8"]).device_mesh == "1x8"
    for bad in (["--device", "tpu", "run", "x"], ["track", "x"],
                ["slam", "megasam", "--engine", "e"], ["convert", "x"], ["eval", "x"],
                ["quantcheck"], ["distill", "x"]):
        with pytest.raises(SystemExit):
            p.parse_args(bad)


@pytest.mark.parametrize("argv", [
    ["run", "depth_anything_v2", "--allow-random-weights"],
    ["views", "vggt", "--allow-random-weights", "--images"],
    ["serve", "depth_anything_v2", "--allow-random-weights"],
    ["build", "depth_pro"],
    ["flow", "raft", "--allow-random-weights"],
])
def test_commands_raise_without_a_card_unless_told_cpu(tmp_path, argv):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    png = _png(tmp_path)
    argv = [*argv, png] if argv[-1] == "--images" else argv
    if argv[0] == "run":
        argv = [*argv, "--image", png]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


def test_run_without_cv2_writes_a_png_viz(monkeypatch, tmp_path):
    monkeypatch.setattr(imageio, "_cv2", lambda: None)
    spec = ModelSpec(model="toy_viz", input_hw=(16, 16))
    pipe = DepthPipeline(spec, lambda img, hw: {"depth": img.float()[..., 0] + 1.0},
                         device="cpu", viz="relative")
    monkeypatch.setattr(treg, "build_pipeline", lambda name, **kw: pipe)
    png = _png(tmp_path, hw=(20, 24))
    assert cli.main(["--device", "cpu", "run", "toy", "--image", png,
                     "--out", str(tmp_path / "o")]) == 0
    files = os.listdir(tmp_path / "o")
    assert not [f for f in files if f.endswith(".jpg")]
    viz = imageio.read_image(_only(str(tmp_path / "o"), ".png"))
    assert viz.shape == (20, 24, 3)


def test_batch_command_writes_what_single_calls_give(monkeypatch, tmp_path, capsys):
    from test_torch_da_v2_slice import TINY, _pipelines

    _, tpipe = _pipelines(monkeypatch, TINY)
    monkeypatch.setattr(treg, "build_pipeline", lambda name, **kw: tpipe)
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    paths = [_png(frames_dir, f"f{i}.png", hw=(70, 70), seed=i) for i in range(3)]
    rc = cli.main(["--device", "cpu", "batch", "toy", "--images-dir", str(frames_dir),
                   "--batch", "2", "--save", "--out", str(tmp_path / "o")])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["frames"] == 3 and line["batch"] == 2 and line["unit"] == "fps"
    name = tpipe.spec.artifact_name()
    for p in paths:
        stem = os.path.splitext(os.path.basename(p))[0]
        got = np.load(tmp_path / "o" / f"{stem}_{name}.npz")["depth"]
        assert rel_err(got, tpipe(imageio.read_image(p))["depth"]) < REL_TOL


FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
                       "example_video.mp4")


def _decoded(path):
    cv2 = pytest.importorskip("cv2")
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f.astype(np.int16))
    cap.release()
    return np.stack(frames)


def test_video_matches_the_jax_cli(monkeypatch, tmp_path):
    """``video`` with the tiny Video Depth Anything on both sides (the
    whole-video protocol: 6 frames, window 4, overlap 2): the same file
    name, frame count and size, the decoded frames within 2 uint8 steps.
    The two depths normalize to uint8 maps 1 step apart at about 0.02 % of
    the pixels (rounding ties); the mp4v codec spreads such a pixel over its
    block (and an 18x upscale before it): 0.12 % of the decoded values read
    more than 2 steps apart, so the bar is 1 % of them, with the mean
    difference far below a step (``tests/test_torch_vda.py`` holds the
    writer at 2 steps everywhere on a clip without ties)."""
    pytest.importorskip("cv2")
    from test_torch_vda import SIZE, _models, vda_pipelines

    jpipe, tpipe = vda_pipelines(_models(64, 2, seed=3)[1])
    (rc_j, jdir), (rc_t, tdir) = _run_both(monkeypatch, tmp_path, jpipe, tpipe,
                                           ["video", "--video", FIXTURE, "--max-frames", "6"])
    assert rc_j == rc_t == 0
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir)) == \
        [f"example_video_{tpipe.spec.artifact_name()}.mp4"]
    ref, ours = (_decoded(_only(d, ".mp4")) for d in (jdir, tdir))
    assert ours.shape == ref.shape == (6, 288, 512, 3)
    diff = np.abs(ours - ref)
    assert float(np.mean(diff > 2)) < 1e-2 and float(diff.mean()) < 0.05


def test_video_streams_flashdepth_as_the_jax_cli(monkeypatch, tmp_path):
    """``video`` with the tiny FlashDepth: one stream over the video, frame
    by frame, the frame rate overlaid (its digits differ from run to run):
    the frame count and size of the JAX command's file, and the frames
    close to its below the overlay."""
    pytest.importorskip("cv2")
    from test_torch_flashdepth import flashdepth_pipelines, tiny_models

    jpipe, tpipe = flashdepth_pipelines(tiny_models()[1], monkeypatch)
    (rc_j, jdir), (rc_t, tdir) = _run_both(monkeypatch, tmp_path, jpipe, tpipe,
                                           ["video", "--video", FIXTURE, "--max-frames", "4"])
    assert rc_j == rc_t == 0
    ref, ours = (_decoded(_only(d, ".mp4")) for d in (jdir, tdir))
    assert ours.shape == ref.shape == (4, 288, 512, 3)
    assert float(np.abs(ours[:, 64:] - ref[:, 64:]).mean()) < 1.0


def test_batch_video_writes_what_single_calls_give(monkeypatch, tmp_path, capsys):
    """``batch --video``: the fixture's first 3 frames extracted as PNGs and
    served in batches of 2; ``--images-dir`` and ``--video`` together (or
    neither) is a usage error."""
    pytest.importorskip("cv2")
    from test_torch_da_v2_slice import TINY, _pipelines

    _, tpipe = _pipelines(monkeypatch, TINY)
    monkeypatch.setattr(treg, "build_pipeline", lambda name, **kw: tpipe)
    out = tmp_path / "o"
    rc = cli.main(["--device", "cpu", "batch", "toy", "--video", FIXTURE, "--max-frames", "3",
                   "--batch", "2", "--save", "--out", str(out)])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["frames"] == 3 and line["batch"] == 2
    frames = sorted(os.listdir(out / "_frames"))
    assert frames == [f"frame_{i:05d}.png" for i in range(3)]
    name = tpipe.spec.artifact_name()
    for f in frames:
        got = np.load(out / f"{f[:-4]}_{name}.npz")["depth"]
        frame = imageio.resize(imageio.read_image(str(out / "_frames" / f)), (70, 70))
        assert rel_err(got, tpipe(frame)["depth"]) < REL_TOL
    for bad in ([], ["--images-dir", str(tmp_path), "--video", FIXTURE]):
        assert cli.main(["--device", "cpu", "batch", "toy", *bad]) == 2


def test_webcam_on_a_fake_capture(monkeypatch):
    """``webcam`` with camera 0: frames of a fake capture through the
    pipeline on its worker thread, shown with the rates overlaid; the
    capture ends once three results were shown (or after 1000 frames)."""
    cv2 = pytest.importorskip("cv2")
    shown, opened = [], []

    class FakeCapture:
        def __init__(self, source):
            opened.append(source)
            self.read_frames = 0

        def isOpened(self):
            return True

        def read(self):
            time.sleep(0.005)  # a camera's pace
            self.read_frames += 1
            if len(shown) >= 3 or self.read_frames > 1000:
                return False, None
            return True, np.full((24, 32, 3), self.read_frames % 256, np.uint8)

        def release(self):
            pass

    spec = ModelSpec(model="toy_cam", input_hw=(16, 16))
    pipe = DepthPipeline(spec, lambda img, hw: {"depth": img.float()[..., 0] + 1.0},
                         device="cpu", viz="relative")
    monkeypatch.setattr(treg, "build_pipeline", lambda name, **kw: pipe)
    monkeypatch.setattr(cv2, "VideoCapture", FakeCapture)
    monkeypatch.setattr(cv2, "imshow", lambda title, view: shown.append(view.shape))
    monkeypatch.setattr(cv2, "waitKey", lambda ms: -1)
    monkeypatch.setattr(cv2, "destroyAllWindows", lambda: None)
    assert cli.main(["--device", "cpu", "webcam", "toy", "--camera", "0"]) == 0
    assert opened == [0]
    assert len(shown) == 3 and set(shown) == {(24, 32, 3)}


@pytest.mark.parametrize("argv", [
    ["video", "toy", "--video", FIXTURE],
    ["batch", "toy", "--video", FIXTURE],
    ["webcam", "toy"],
])
def test_video_commands_without_cv2_name_the_codec(monkeypatch, capsys, tmp_path, argv):
    """Without cv2 each video command exits non-zero before it builds a
    pipeline, and names the missing codec."""
    monkeypatch.setattr(imageio, "_cv2", lambda: None)
    monkeypatch.setattr(treg, "build_pipeline", lambda name, **kw: pytest.fail("built"))
    assert cli.main(["--device", "cpu", *argv, "--out", str(tmp_path)]
                    if argv[0] != "webcam" else ["--device", "cpu", *argv]) == 1
    assert "video (MP4/mp4v) needs the cv2 (OpenCV) codec" in capsys.readouterr().out


def test_build_command_records_the_engine(monkeypatch):
    from monocular_depth_estimation_trt_tpu_torch.runtime.engine import EngineRegistry

    _, tpipe = _toy_pipelines({})
    monkeypatch.setattr(treg, "build_pipeline", lambda name, **kw: tpipe)
    assert cli.main(["--device", "cpu", "build", "toy", "--size", "24", "--viz"]) == 0
    name = tpipe.engine_for((24, 24), True).name
    assert name == "toy_cli_16x16_bf16_in24x24_viz"
    assert EngineRegistry().load(name)["inputs"] == [{"shape": [24, 24, 3], "dtype": "uint8"}]


# ---------------------------------------------------------------------------
# the modules behind the artifacts
# ---------------------------------------------------------------------------


def test_unprojections_match_jax(rng):
    depth = (rng.random((12, 17)) * 10 + 0.5).astype(np.float32)
    K = np.array([[30.0, 0, 8.3], [0, 28.0, 6.1], [0, 0, 1]], np.float32)
    quat = rng.standard_normal(4).astype(np.float32)
    E = np.asarray(jcamera.extrinsics_from_quat_trans(jnp.asarray(quat),
                                                      jnp.asarray([0.3, -0.2, 1.0])))
    td = torch.from_numpy(depth)
    pairs = [
        (tcamera.unproject_depth(td, 25.0), jcamera.unproject_depth(jnp.asarray(depth), 25.0)),
        (tcamera.unproject_depth(td, 25.0, 3.0, 4.0),
         jcamera.unproject_depth(jnp.asarray(depth), 25.0, 3.0, 4.0)),
        (tcamera.unproject_intrinsics(td, torch.from_numpy(K)),
         jcamera.unproject_intrinsics(jnp.asarray(depth), jnp.asarray(K))),
        (tcamera.unproject_to_world(td, torch.from_numpy(K), torch.from_numpy(E)),
         jcamera.unproject_to_world(jnp.asarray(depth), jnp.asarray(K), jnp.asarray(E))),
    ]
    for ours, ref in pairs:
        assert ours.shape == ref.shape == (12, 17, 3)
        assert rel_err(ours.numpy(), np.asarray(ref)) < 1e-6


@pytest.mark.parametrize("stride,intrinsics,z_limit", [(1, None, None), (2, None, 5.0),
                                                       (3, True, None)])
def test_pointcloud_matches_jax(rng, stride, intrinsics, z_limit):
    depth = (rng.random((20, 30)) * 10 + 0.5).astype(np.float32)
    img = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    K = np.array([[40.0, 0, 15.0], [0, 40.0, 10.0], [0, 0, 1]], np.float32) if intrinsics else None
    kw = dict(focal=33.0, intrinsics=K, z_limit=z_limit, stride=stride)
    (pts, col), (ref_pts, ref_col) = (tpointcloud.depth_to_pointcloud(depth, img, **kw),
                                      jpointcloud.depth_to_pointcloud(depth, img, **kw))
    assert pts.shape == ref_pts.shape
    np.testing.assert_array_equal(col, ref_col)
    assert rel_err(pts, ref_pts) < 1e-6


def test_ply_and_glb_writers_write_the_jax_bytes(tmp_path, rng):
    pts = rng.standard_normal((50, 3)).astype(np.float32)
    cols = {"u8": rng.integers(0, 256, (50, 3), dtype=np.uint8),
            "float": rng.random((50, 3)).astype(np.float32), "none": None}
    mask = rng.random(50) > 0.2
    faces = jply.image_mesh_faces(5, 10, mask)
    np.testing.assert_array_equal(tply.image_mesh_faces(5, 10, mask), faces)
    for label, col in cols.items():
        writers = [("ply", lambda m, p: m.write_ply(p, pts, col)),
                   ("ply_ascii", lambda m, p: m.write_ply(p, pts, col, binary=False)),
                   ("mesh_ply", lambda m, p: m.write_ply_mesh(p, pts, faces, col)),
                   ("mesh_glb", lambda m, p: m.write_glb_mesh(p, pts, faces, col)),
                   ("glb", lambda m, p: m.write_glb_pointcloud(p, pts, col))]
        for kind, write in writers:
            a, b = str(tmp_path / f"t_{label}_{kind}"), str(tmp_path / f"j_{label}_{kind}")
            write(tply, a)
            write(jply, b)
            assert open(a, "rb").read() == open(b, "rb").read(), (label, kind)
    got, ref = tply.read_ply(str(tmp_path / "t_u8_ply")), jply.read_ply(str(tmp_path / "j_u8_ply"))
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
