"""The port's SLAM recipes (``slam/recipes.py``: MegaSaM, ViPE, WildGS-SLAM),
their registry entries and the ``slam`` command against the JAX package on
the CPU, on ``tests/test_slam_recipes.py``'s analytic world (imported from
there): dense flow generated by the solver's own projection model from a
known trajectory and depth surface, injected through the frontend's
callables on both sides. Each recipe picks the JAX recipe's keyframes,
lands within the stated bars of its poses and focal, and recovers the world
to the JAX file's own bars.

Bars, about twice the readings of the first CPU run (torch 2.13, jax 0.9;
in brackets), as max |port - JAX| / max |JAX|: poses 1e-5 [2.6e-6], focal
5e-6 [2.6e-6], aligned keyframe disparity 1e-5 [2.1e-6], consistent video
depth 1e-5 [6.6e-6], ViPE's metric scale 1e-6 [4.5e-7], the ``slam``
command's npz values 4e-5 [1.9e-5], WildGS-SLAM's seeded map and its render
2e-6 [1.1e-6]. After mapping steps the two maps part: the JAX map loses the
gaussians of every keyframe after the first (ROADMAP, section 3), so
WildGS-SLAM's mapped result is held to the JAX file's bars alone."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu import cli as jcli
from monocular_depth_estimation_trt_tpu import registry as jreg
from monocular_depth_estimation_trt_tpu.slam import mapping as jmap
from monocular_depth_estimation_trt_tpu.slam import recipes as jrec
from monocular_depth_estimation_trt_tpu.slam.ba import BAConfig as JBAConfig
from monocular_depth_estimation_trt_tpu.slam.frontend import FrontendConfig as JFrontendConfig
from monocular_depth_estimation_trt_tpu_torch import cli
from monocular_depth_estimation_trt_tpu_torch import registry as treg
from monocular_depth_estimation_trt_tpu_torch.slam import recipes as trec
from monocular_depth_estimation_trt_tpu_torch.slam.ba import BAConfig
from monocular_depth_estimation_trt_tpu_torch.slam.frontend import FrontendConfig, _bilinear
from monocular_depth_estimation_trt_tpu_torch.slam.lie import rotation_geodesic_deg
from monocular_depth_estimation_trt_tpu_torch.weights import from_jax

from test_slam_recipes import SyntheticWorld
from torch_port_params import rel_err

torch.set_num_threads(1)

POSE_TOL = 1e-5
FOCAL_TOL = 5e-6
DISP_TOL = 1e-5
CVD_TOL = 1e-5
METRIC_TOL = 1e-6
RENDER_TOL = 2e-6
CLI_TOL = 4e-5
FRONTEND = dict(grid_stride=8, kf_min_flow=2.5, kf_max_interval=4, kf_stride=1,
                sigma_consistency=50.0)


def _pair(cls_name, world, ba, **kw):
    """(the JAX recipe, the port's) on the same injected callables."""
    jcls, tcls = getattr(jrec, cls_name), getattr(trec, cls_name)
    jkw = {k: v for k, v in kw.items() if k != "uncertainty_init"}
    return (jcls(flow_fn=world.flow_fn, frontend_cfg=JFrontendConfig(**FRONTEND),
                 ba_cfg=JBAConfig(**ba), **jkw),
            tcls(flow_fn=world.flow_fn, frontend_cfg=FrontendConfig(**FRONTEND),
                 ba_cfg=BAConfig(**ba), device="cpu", **kw))


def _same_result(ours, ref):
    assert ours.keyframe_indices == ref.keyframe_indices
    assert rel_err(ours.poses, ref.poses) < POSE_TOL
    assert rel_err(ours.focal, ref.focal) < FOCAL_TOL
    for a, b in zip(ours.keyframe_disparity, ref.keyframe_disparity):
        assert rel_err(a, b) < DISP_TOL


@pytest.fixture(scope="module")
def megasam():
    """MegaSaM on a 10% wrong focal prior and per-frame affine-corrupted
    mono disparity (``test_megasam_recovers_trajectory``)."""
    world = SyntheticWorld()
    affine = [(1.0 + 0.2 * np.sin(i), 0.01 * i) for i in range(world.n)]
    pipes = _pair("MegaSaMPipeline", world,
                  dict(iters=30, optimize_focal=True, focal_prior=1e-4),
                  depth_fn=world.depth_fn_factory(affine))
    frames = [world.frame(i) for i in range(world.n)]
    return world, pipes, [p.run(frames, focal=world.focal * 1.1) for p in pipes]


def test_megasam_matches_jax_and_recovers_the_trajectory(megasam):
    world, _, (ref, ours) = megasam
    _same_result(ours, ref)
    # the JAX file's bars
    assert ours.rms_px < 0.3
    assert abs(ours.focal - world.focal) / world.focal < 0.05
    gt = world.poses[ours.keyframe_indices]
    rot_err = rotation_geodesic_deg(torch.from_numpy(ours.poses[:, :3, :3]),
                                    torch.from_numpy(gt[:, :3, :3].astype(np.float32)))
    assert float(rot_err.max()) < 0.5
    t, t_gt = ours.poses[:, :3, 3], gt[:, :3, 3]
    s = float(np.sum(t * t_gt) / np.maximum(np.sum(t * t), 1e-12))
    assert np.linalg.norm(s * t - t_gt) / np.linalg.norm(t_gt) < 0.05
    g = None
    for n, k_idx in enumerate(ours.keyframe_indices):
        ratio = ours.keyframe_disparity[n] * world.depth_grid(k_idx, world.depth_hw)
        g = np.median(ratio) if g is None else g
        assert np.std(ratio) / np.mean(ratio) < 0.02
        assert abs(np.median(ratio) - g) / g < 0.05


def test_megasam_consistent_video_depth_matches_jax():
    """``test_megasam_consistent_video_depth``'s run (exact mono disparity,
    the focal known): every frame's aligned disparity on both sides."""
    world = SyntheticWorld()
    pipes = _pair("MegaSaMPipeline", world, dict(iters=20, optimize_focal=False),
                  depth_fn=world.depth_fn_factory())
    frames = [world.frame(i) for i in range(world.n)]
    ref, ours = (p.run(frames, focal=world.focal) for p in pipes)
    _same_result(ours, ref)
    ref_cvd, cvd = (p.consistent_video_depth(frames, r) for p, r in zip(pipes, (ref, ours)))
    assert len(cvd) == len(ref_cvd) == world.n
    g = np.median(ours.keyframe_disparity[0]
                  * world.depth_grid(ours.keyframe_indices[0], world.depth_hw))
    for i, (a, b) in enumerate(zip(cvd, ref_cvd)):
        assert rel_err(a, b) < CVD_TOL, i
        ratio = a * world.depth_grid(i, world.depth_hw)
        assert abs(np.median(ratio) - g) / g < 0.1, i


def test_vipe_matches_jax_and_promotes_to_meters():
    world = SyntheticWorld()

    def metric_fn(img):
        return world.depth_grid(int(np.asarray(img)[0, 0, 0]), world.depth_hw)

    pipes = _pair("ViPEPipeline", world, dict(iters=25, optimize_focal=True),
                  depth_fn=world.depth_fn_factory(), metric_depth_fn=metric_fn,
                  calib_fn=lambda img: world.focal)
    frames = [world.frame(i) for i in range(world.n)]
    ref, ours = (p.run(frames) for p in pipes)  # no focal given: the calib channel
    _same_result(ours, ref)
    assert rel_err(ours.extras["metric_scale"], ref.extras["metric_scale"]) < METRIC_TOL
    assert ours.rms_px < 0.3
    for n, k_idx in enumerate(ours.keyframe_indices):
        depth = 1.0 / np.maximum(ours.keyframe_disparity[n], 1e-6)
        gt = world.depth_grid(k_idx, world.depth_hw)
        assert np.median(np.abs(depth - gt) / gt) < 0.05, n
    gt_t = world.poses[ours.keyframe_indices][:, :3, 3]
    assert np.linalg.norm(ours.poses[:, :3, 3] - gt_t) / np.linalg.norm(gt_t) < 0.1


def _wildgs(mapping_iters):
    """WildGS-SLAM at ``test_wildgs_slam_maps_the_scene``'s size, the
    uncertainty net's JAX init (``PRNGKey(0)``) carried to the port."""
    world = SyntheticWorld(n_frames=6)
    unc = jmap.UncertaintyNet(width=16).init(jax.random.PRNGKey(0),
                                             jnp.zeros((16, 32, 3)))["params"]
    pipes = _pair("WildGSSLAMPipeline", world, dict(iters=15, optimize_focal=False),
                  depth_fn=world.depth_fn_factory(), map_hw=(16, 32), max_gaussians=2048,
                  mapping_iters=mapping_iters, k_per_tile=16,
                  uncertainty_init=from_jax.uncertainty_net_from_jax(unc))
    frames = [world.frame(i) for i in range(world.n)]
    return world, pipes, [p.run(frames, focal=world.focal) for p in pipes]


@pytest.fixture(scope="module")
def wildgs():
    return _wildgs(6)


def test_wildgs_slam_seeds_and_renders_the_map_as_jax():
    """Without mapping steps: the keyframes' seeds inserted into the map and
    rendered at each keyframe, on both sides."""
    _, _, (ref, ours) = _wildgs(0)
    _same_result(ours, ref)
    for r, r_ref in zip(ours.extras["rendered_depth"], ref.extras["rendered_depth"]):
        assert rel_err(r, r_ref) < RENDER_TOL
    for name in ("means", "log_scales", "colors_logit", "valid"):
        assert rel_err(getattr(ours.extras["gaussians"], name),
                       getattr(ref.extras["gaussians"], name)) < RENDER_TOL, name


def test_wildgs_slam_maps_the_scene_and_keeps_inserted_gaussians(wildgs):
    """The JAX file's run (6 mapping steps a keyframe): the port recovers the
    world to that file's bars, and every gaussian of its map is finite. The
    JAX map is not: the gradient of ``jnp.linalg.norm`` at a free slot's
    zero quaternion is NaN, the free-slot mask multiplies it by 0 (still
    NaN), so Adam's moments of every free slot are NaN, and a gaussian that
    a later keyframe inserts there turns NaN at its first step (ROADMAP,
    section 3). The port's ``vector_norm`` has gradient 0 at 0."""
    world, _, (ref, ours) = wildgs
    _same_result(ours, ref)
    rendered = ours.extras["rendered_depth"]
    assert len(rendered) == len(ours.keyframe_indices)
    for n, r in enumerate(rendered):
        assert r.shape == (16, 32) and np.all(np.isfinite(r))
        anchor = 1.0 / np.maximum(ours.keyframe_disparity[n], 1e-4)
        ah = _bilinear(anchor, *np.meshgrid(
            (np.arange(32) + 0.5) * anchor.shape[1] / 32 - 0.5,
            (np.arange(16) + 0.5) * anchor.shape[0] / 16 - 0.5))
        covered = r > 1e-3
        assert covered.mean() > 0.5
        assert np.median(np.abs(r[covered] - ah[covered]) / ah[covered]) < 0.25, n
    gmap, jmap_ = ours.extras["gaussians"], ref.extras["gaussians"]
    valid = gmap.valid > 0.5
    assert int(valid.sum()) == int((np.asarray(jmap_.valid) > 0.5).sum()) == 32 * 3
    assert all(np.isfinite(getattr(gmap, f)).all() for f in gmap._fields)
    jnan = np.isnan(np.asarray(jmap_.means)[valid]).any(-1)
    assert not jnan[:32].any() and jnan[32:].all()  # the first keyframe's seeds only


def test_recipes_refuse_a_single_image_call():
    for name in ("MegaSaMPipeline", "ViPEPipeline", "WildGSSLAMPipeline"):
        with pytest.raises(RuntimeError, match="slam"):
            getattr(trec, name)(device="cpu")(np.zeros((32, 32, 3), np.uint8))


@pytest.mark.parametrize("name", ["megasam", "vipe", "wildgs_slam"])
def test_registry_builds_the_recipes_with_the_jax_names(name):
    pipe = treg.build_pipeline(name, device="cpu")
    ref = jreg.build_pipeline(name)
    assert type(pipe).__name__ == type(ref).__name__
    assert pipe.spec.artifact_name() == ref.spec.artifact_name() == f"{name}_288x512_fp32"
    assert treg.get_fidelity(name) == jreg.get_fidelity(name) == "approximated"


def _frames_dir(tmp_path, world):
    from monocular_depth_estimation_trt_tpu_torch.utils import imageio

    d = tmp_path / "frames"
    d.mkdir()
    for i in range(world.n):
        imageio.write_image(str(d / f"f{i:03d}.png"), world.frame(i))
    return str(d)


def test_slam_command_writes_the_jax_cli_files(tmp_path, monkeypatch):
    """``slam megasam --cvd`` over a frame directory on both sides, the
    recipes built on the analytic world: the same files, npz keys, and
    values within the recipe bars."""
    world = SyntheticWorld()
    pipes = _pair("MegaSaMPipeline", world, dict(iters=15, optimize_focal=False),
                  depth_fn=world.depth_fn_factory())
    monkeypatch.setattr(jreg, "build_pipeline", lambda name, **kw: pipes[0])
    monkeypatch.setattr(treg, "build_pipeline", lambda name, **kw: pipes[1])
    argv = ["slam", "megasam", "--frames", _frames_dir(tmp_path, world), "--focal",
            str(world.focal), "--cvd"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jcli.main([*argv, "--out", jdir]) == 0
    assert cli.main(["--device", "cpu", *argv, "--out", tdir]) == 0
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == \
        ["frames_megasam_288x512_fp32.npz", "frames_megasam_288x512_fp32_cvd.npz"]
    for f in os.listdir(jdir):
        ref, ours = np.load(os.path.join(jdir, f)), np.load(os.path.join(tdir, f))
        assert sorted(ours.files) == sorted(ref.files)
        for k in ref.files:
            assert ours[k].shape == ref[k].shape and ours[k].dtype == ref[k].dtype, k
            assert rel_err(ours[k], ref[k]) < CLI_TOL, k
    assert float(np.load(os.path.join(tdir, "frames_megasam_288x512_fp32.npz"))["rms_px"]) < 1.0


@pytest.mark.parametrize("name,key", [("vipe", "metric_scale"), ("wildgs_slam", "rendered_depth")])
def test_slam_command_writes_each_recipe_key(tmp_path, monkeypatch, wildgs, name, key):
    """The recipe-specific npz keys of the JAX CLI: ViPE's metric scale and
    WildGS-SLAM's rendered depth (each side's pipeline answers with its
    recipe's result)."""
    world, pipes, results = wildgs
    if name == "vipe":
        results = [r._replace(extras={**r.extras, "metric_scale": 2.0}) for r in results]
    for mod, pipe, res in zip((jreg, treg), pipes, results):
        monkeypatch.setattr(pipe, "run", lambda frames, focal=None, res=res: res)
        monkeypatch.setattr(mod, "build_pipeline", lambda n, pipe=pipe, **kw: pipe)
    argv = ["slam", name, "--frames", _frames_dir(tmp_path, world)]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jcli.main([*argv, "--out", jdir]) == 0
    assert cli.main(["--device", "cpu", *argv, "--out", tdir]) == 0
    (f,) = os.listdir(jdir)
    assert os.listdir(tdir) == [f]
    ref, ours = np.load(os.path.join(jdir, f)), np.load(os.path.join(tdir, f))
    assert sorted(ours.files) == sorted(ref.files) and key in ours.files
    if key == "metric_scale":
        assert float(ours[key]) == float(ref[key]) == 2.0
    else:  # each side's own map (the JAX one lost its later keyframes' gaussians)
        assert ours[key].shape == ref[key].shape and np.isfinite(ours[key]).all()
