"""The port's SLAM core (``slam/lie.py``, ``slam/ba.py``, ``slam/gaussians.py``,
``slam/mapping.py``) against the JAX package on the CPU, fp32: the Lie
closed forms and their forward-mode derivatives at a zero delta, the BA
residuals, Jacobian and one LM step on ``tests/test_slam_ba.py``'s analytic
problem, the full solve on that file's four problems (each recovering the
truth to that file's bars), the Gaussian-splat render and its gradients,
the map seeding and insertion, and one mapping step against the optax
step; the uncertainty net's convolution against ``F.conv2d``, and the solve
and the mapping step under inference mode. The JAX side runs under
``jax.jit``.

Bars (max |port - JAX| / max |JAX|), about twice the readings of the first
CPU run (torch 2.13, jax 0.9; in brackets): residuals 3e-6 [1.4e-6],
Jacobian 1e-6 [3.0e-7], one LM step's normal equations 2e-7 [8.8e-8] and
its step per field (``STEP_TOL``: poses 1.2e-5, log-scales 1.7e-4, shifts
3.2e-4, log focal 4.5e-3, cost 2.5e-4, rms 1.3e-4), the full solves' poses
1e-6 [2.8e-7], render 1e-6 [5.5e-7], its gradients 4e-6 [1.9e-6], two
mapping steps 2e-5 [9.0e-6]; the Lie closed forms 1e-5 [1.2e-7]."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monocular_depth_estimation_trt_tpu.slam import ba as jba
from monocular_depth_estimation_trt_tpu.slam import gaussians as jgs
from monocular_depth_estimation_trt_tpu.slam import lie as jlie
from monocular_depth_estimation_trt_tpu.slam import mapping as jmap
from monocular_depth_estimation_trt_tpu_torch.slam import ba as tba
from monocular_depth_estimation_trt_tpu_torch.slam import gaussians as tgs
from monocular_depth_estimation_trt_tpu_torch.slam import lie as tlie
from monocular_depth_estimation_trt_tpu_torch.slam import mapping as tmap
from monocular_depth_estimation_trt_tpu_torch.weights import from_jax

from test_slam_ba import _synthetic_problem
from torch_port_params import rel_err

torch.set_num_threads(1)

LIE_TOL = 1e-5
RESID_TOL = 3e-6
JAC_TOL = 1e-6
NORMAL_TOL = 2e-7
STEP_TOL = {"poses": 3e-5, "log_scale": 4e-4, "shift": 7e-4, "log_focal": 1e-2, "cost": 5e-4,
            "rms_px": 3e-4}
SOLVE_POSE_TOL = 1e-6
RENDER_TOL = 1e-6
GRAD_TOL = 4e-6
MAP_STEP_TOL = 2e-5


def t(x, dtype=None):
    a = np.array(x)
    return torch.from_numpy(a if dtype is None else a.astype(dtype))


def tprob(prob):
    return tba.BAProblem(*(t(x) for x in prob))._replace(edges=t(prob.edges, np.int64))


def tstate(state):
    return tba.BAState(*(t(x, np.float32) for x in state))


# -- lie -------------------------------------------------------------------

@pytest.fixture(scope="module")
def tangents():
    """Rows of (rho, phi): random, and theta = 0, 1e-5 and near pi/2."""
    xi = np.random.default_rng(0).normal(0, 0.5, (12, 6)).astype(np.float32)
    xi[0, 3:] = 0.0
    xi[1] = 0.0
    xi[2, 3:] = [1e-5, 0.0, 0.0]
    xi[3, 3:] = [0.0, 1.5, 0.3]
    return xi


@pytest.mark.parametrize("name", ["so3_exp", "se3_exp", "hat"])
def test_lie_exponentials_match_jax(tangents, name):
    arg = tangents[:, 3:] if name in ("so3_exp", "hat") else tangents
    ours = getattr(tlie, name)(t(arg)).numpy()
    ref = np.asarray(jax.jit(getattr(jlie, name))(jnp.asarray(arg)))
    assert np.isfinite(ours).all()
    assert rel_err(ours, ref) < LIE_TOL


def test_lie_inverse_apply_retract_log_match_jax(tangents):
    T = np.asarray(jax.jit(jlie.se3_exp)(jnp.asarray(tangents)))
    pts = np.random.default_rng(1).normal(0, 2, (12, 7, 3)).astype(np.float32)
    cases = {"se3_inv": ((T,), ()), "se3_apply": ((T, pts), ()),
             "se3_retract": ((tangents[::-1].copy(), T), ()),
             "so3_log": ((T[:, :3, :3],), ()),
             "rotation_geodesic_deg": ((T[:, :3, :3], T[::-1, :3, :3].copy()), ())}
    for name, (args, _) in cases.items():
        ours = getattr(tlie, name)(*(t(a) for a in args)).numpy()
        ref = np.asarray(jax.jit(getattr(jlie, name))(*(jnp.asarray(a) for a in args)))
        assert rel_err(ours, ref) < LIE_TOL, name


@pytest.mark.parametrize("name", ["so3_exp", "se3_exp"])
def test_forward_mode_at_a_zero_delta_takes_the_series_branch(name):
    """``jacfwd`` at theta = 0: the large-angle branch is 0/0 there, and
    ``where`` selects the series branch's tangent, so no NaN leaks; the
    Jacobian is JAX's."""
    n = 3 if name == "so3_exp" else 6
    # on a batch of one: torch's jvp under vmap gives a 0-d intermediate
    # (theta^2 of one unbatched vector) combined with a Python float a
    # float64 tangent, which the matmul after it refuses; BA's deltas are
    # (K, 6) batches
    ours = torch.func.jacfwd(lambda x: getattr(tlie, name)(x[None])[0])(torch.zeros(n)).numpy()
    ref = np.asarray(jax.jit(jax.jacfwd(getattr(jlie, name)))(jnp.zeros(n)))
    assert np.isfinite(ours).all()
    assert rel_err(ours, ref) < LIE_TOL
    # the generators: d exp(w)/dw_k at 0 is hat(e_k) (rotation part)
    gens = np.asarray(tlie.hat(torch.eye(3)).numpy()).transpose(1, 2, 0)
    rot = ours if name == "so3_exp" else ours[:3, :3, 3:]
    np.testing.assert_allclose(rot, gens, atol=1e-7)


# -- bundle adjustment -----------------------------------------------------

@pytest.fixture(scope="module")
def ba_case():
    """test_slam_ba's analytic problem, keyframes 1.. perturbed, the
    per-frame affine and the focal off their truth (so every block of the
    Jacobian moves)."""
    prob, state_gt, focal, hw = _synthetic_problem()
    k = state_gt.poses.shape[0]
    rng = np.random.default_rng(7)
    noise = np.zeros((k, 6), np.float32)
    noise[1:] = rng.normal(0, 0.03, (k - 1, 6))
    state = state_gt._replace(
        poses=jlie.se3_retract(jnp.asarray(noise), state_gt.poses),
        log_scale=jnp.asarray(rng.normal(0, 0.05, k), jnp.float32),
        shift=jnp.asarray(rng.normal(0, 0.01, k), jnp.float32),
        log_focal=jnp.float32(0.04))
    return prob, state, focal, hw


def test_residuals_and_jacobian_match_jax(ba_case):
    prob, state, focal, hw = ba_case
    k = state.poses.shape[0]
    cfg = jba.BAConfig(optimize_focal=True)
    center = jnp.asarray([hw[1] / 2.0, hw[0] / 2.0], jnp.float32)

    def jres(delta):
        return jba._residuals(jba._apply_delta(state, delta, cfg), prob, jnp.float32(focal),
                              center, cfg).reshape(-1)

    tp, ts = tprob(prob), tstate(state)
    tcfg = tba.BAConfig(optimize_focal=True)

    def tres(delta):
        return tba._residuals(tba._apply_delta(ts, delta, tcfg), tp, torch.tensor(focal),
                              (hw[1] / 2.0, hw[0] / 2.0), tcfg).reshape(-1)

    zero = np.zeros(8 * k + 1, np.float32)
    r_ref, J_ref = jax.jit(lambda d: (jres(d), jax.jacfwd(jres)(d)))(jnp.asarray(zero))
    r = tres(t(zero))
    J = torch.func.jacfwd(tres)(t(zero))
    assert J.shape == (prob.flow.size, 8 * k + 1)
    assert rel_err(r, r_ref) < RESID_TOL
    assert rel_err(J, J_ref) < JAC_TOL
    assert np.abs(np.asarray(r_ref)).max() > 1.0  # the perturbation moves every residual


def _jax_normal_equations(prob, state, focal, hw, cfg):
    """JAX's H and g of one LM iteration, as ``slam/ba.py::run_ba`` forms
    them (its ``lm_step`` keeps them local)."""
    k = state.poses.shape[0]
    center = jnp.asarray([hw[1] / 2.0, hw[0] / 2.0], jnp.float32)

    def resid_flat(delta):
        return jba._residuals(jba._apply_delta(state, delta, cfg), prob, jnp.float32(focal),
                              center, cfg).reshape(-1)

    zero = jnp.zeros((8 * k + 1,), jnp.float32)
    r0 = resid_flat(zero)
    rn = jnp.sqrt(jnp.sum(r0.reshape(-1, 2) ** 2, axis=-1) + 1e-12)
    w_rob = jnp.where(rn <= cfg.huber_px, 1.0, cfg.huber_px / rn)
    w = (jnp.maximum(prob.weight, 0.0).reshape(-1) * w_rob)[:, None].repeat(2, 1).reshape(-1)
    J = jax.jacfwd(resid_flat)(zero)
    return J.T @ (J * w[:, None]) + jnp.diag(jba._prior_diag(k, cfg)), (J * w[:, None]).T @ r0


@pytest.mark.parametrize("optimize_focal", [False, True])
def test_one_lm_step_matches_jax(ba_case, optimize_focal):
    """One LM iteration: its normal equations (H, g) against JAX's, then the
    step after the fp32 LU solve. The system's condition number is about
    1.6e7 (the gauge prior of 1e8): each framework's fp32 step is about 1e-4
    from the float64 solution of the same system, and the 1e-6 differences
    in (H, g) move the step by up to a few 1e-3 (the focal), so the step's
    bars are per field, about twice the readings."""
    prob, state, focal, hw = ba_case
    jcfg = jba.BAConfig(iters=1, optimize_focal=optimize_focal)
    tcfg = tba.BAConfig(iters=1, optimize_focal=optimize_focal)
    k = state.poses.shape[0]
    H_ref, g_ref = jax.jit(_jax_normal_equations, static_argnums=(2, 3, 4))(
        prob, state, focal, hw, jcfg)
    with torch.no_grad():
        H, g = tba.normal_equations(tstate(state), tprob(prob), torch.tensor(focal),
                                    (hw[1] / 2.0, hw[0] / 2.0), tcfg, tba._prior_diag(k, tcfg, "cpu"))
    assert rel_err(H, H_ref) < NORMAL_TOL and rel_err(g, g_ref) < NORMAL_TOL
    ref_state, ref_info = jax.jit(jba.run_ba, static_argnums=(3, 4))(prob, state, focal, hw, jcfg)
    with torch.no_grad():
        ours, info = tba.run_ba(tprob(prob), tstate(state), focal, hw, tcfg)
    for name in tba.BAState._fields:
        assert rel_err(getattr(ours, name), getattr(ref_state, name)) < STEP_TOL[name], name
    assert rel_err(info["cost"], ref_info["cost"]) < STEP_TOL["cost"]
    assert rel_err(info["rms_px"], ref_info["rms_px"]) < STEP_TOL["rms_px"]
    assert not np.allclose(ours.poses.numpy(), np.asarray(state.poses))  # the step moved


def _perturbed_poses(seed=7, sigma=0.03, problem_seed=3):
    prob, state_gt, focal, hw = _synthetic_problem(seed=problem_seed)
    k = state_gt.poses.shape[0]
    rng = np.random.default_rng(seed)
    noise = np.zeros((k, 6), np.float32)
    noise[1:] = rng.normal(0, sigma, (k - 1, 6))
    init = jba.init_state(k)._replace(poses=jlie.se3_retract(jnp.asarray(noise), state_gt.poses))
    return prob, state_gt, init, focal, hw, jba.BAConfig(iters=20)


def _affine():
    prob, state_gt, focal, hw = _synthetic_problem(seed=11)
    k = state_gt.poses.shape[0]
    s_true = np.array([1.0, 1.3, 0.8, 1.1], np.float32)[:k]
    q_true = np.array([0.0, 0.02, -0.015, 0.01], np.float32)[:k]
    prob = prob._replace(idepth=(prob.idepth - q_true[:, None]) / s_true[:, None])
    init = jba.init_state(k)._replace(poses=state_gt.poses)
    return prob, state_gt._replace(log_scale=jnp.log(s_true), shift=jnp.asarray(q_true)), init, \
        focal, hw, jba.BAConfig(iters=25)


def _focal():
    prob, state_gt, focal, hw = _synthetic_problem(seed=5)
    init = jba.init_state(state_gt.poses.shape[0])._replace(poses=state_gt.poses)
    return prob, state_gt, init, focal * 1.15, hw, jba.BAConfig(iters=30, optimize_focal=True,
                                                                focal_prior=1e-4)


def _moving():
    prob, state_gt, focal, hw = _synthetic_problem(seed=13)
    k = state_gt.poses.shape[0]
    e, p = prob.flow.shape[:2]
    rng = np.random.default_rng(17)
    moving = rng.random(p) < 0.2
    bad = np.asarray(prob.flow).copy()
    bad[:, moving] += rng.normal(0, 6.0, (e, int(moving.sum()), 2))
    weight = np.ones((e, p), np.float32)
    weight[:, moving] = 0.0
    prob = prob._replace(flow=jnp.asarray(bad), weight=jnp.asarray(weight))
    noise = np.zeros((k, 6), np.float32)
    noise[1:] = rng.normal(0, 0.02, (k - 1, 6))
    init = jba.init_state(k)._replace(poses=jlie.se3_retract(jnp.asarray(noise), state_gt.poses))
    return prob, state_gt, init, focal, hw, jba.BAConfig(iters=20)


@pytest.mark.parametrize("case", ["perturbed_poses", "disparity_affine", "focal", "moving"])
def test_run_ba_recovers_the_truth_as_jax(case):
    """``tests/test_slam_ba.py``'s four problems, each with that file's
    solver configuration and bars, solved by both packages."""
    prob, gt, init, focal, hw, jcfg = {"perturbed_poses": _perturbed_poses, "disparity_affine":
                                       _affine, "focal": _focal, "moving": _moving}[case]()
    ref, ref_info = jax.jit(jba.run_ba, static_argnums=(3, 4))(prob, init, focal, hw, jcfg)
    with torch.no_grad():
        ours, info = tba.run_ba(tprob(prob), tstate(init), focal, hw, tba.BAConfig(*jcfg))
    assert rel_err(ours.poses, ref.poses) < SOLVE_POSE_TOL
    rot_err = tlie.rotation_geodesic_deg(ours.poses[:, :3, :3], t(gt.poses[:, :3, :3])).numpy()
    t_err = np.linalg.norm(ours.poses[:, :3, 3].numpy() - np.asarray(gt.poses[:, :3, 3]), axis=-1)
    rms = float(info["rms_px"])
    if case == "perturbed_poses":
        costs = info["cost"].numpy()
        assert rms < 0.05 and rot_err.max() < 0.1 and t_err.max() < 5e-3
        assert costs[-1] < costs[0] * 1e-3
    elif case == "disparity_affine":
        assert rms < 0.05
        np.testing.assert_allclose(np.exp(ours.log_scale.numpy()), np.exp(gt.log_scale),
                                   atol=0.02)
        np.testing.assert_allclose(ours.shift.numpy(), gt.shift, atol=0.01)
    elif case == "focal":
        f_rec = float(focal * np.exp(ours.log_focal.numpy()))
        assert abs(f_rec - focal / 1.15) / (focal / 1.15) < 0.03 and rms < 0.25
    else:
        assert rot_err.max() < 0.15


def test_flow_weights_and_disparity_alignment_match_jax():
    rng = np.random.default_rng(23)
    fwd, bwd = (rng.normal(0, 3, (50, 2)).astype(np.float32) for _ in range(2))
    assert rel_err(tba.flow_consistency_weights(t(fwd), t(bwd), 2.0),
                   jba.flow_consistency_weights(jnp.asarray(fwd), jnp.asarray(bwd), 2.0)) < 1e-6
    disp = rng.uniform(0.2, 1.0, (3, 200)).astype(np.float32)
    target = rng.uniform(0.5, 3.0, (3, 200)).astype(np.float32)
    w = rng.uniform(0, 1, (3, 200)).astype(np.float32)
    for ours, ref in zip(tba.align_disparity(t(disp), t(target), t(w)),
                         jba.align_disparity(jnp.asarray(disp), jnp.asarray(target),
                                             jnp.asarray(w))):
        assert rel_err(ours, ref) < 1e-5


# -- Gaussian splatting ----------------------------------------------------

_jax_init = jax.jit(jgs.init_from_depth, static_argnames=("stride", "max_gaussians"))


def _scene(seed=3, h=48, w=64, g=1024):
    """A seeded map from a smooth depth frame (stride 4) in a larger
    capacity, scales (anisotropic, so that the rotations matter), colors,
    opacities and rotations perturbed, seen from a moved camera."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    depth = (2.0 + 0.4 * np.sin(xx / w * 3.0) * np.cos(yy / h * 2.0)).astype(np.float32)
    img = rng.uniform(0.2, 0.8, (h, w, 3)).astype(np.float32)
    gmap = _jax_init(jnp.asarray(img), jnp.asarray(depth), jnp.eye(4), 60.0, stride=4,
                     max_gaussians=g)
    gmap = gmap._replace(
        log_scales=gmap.log_scales + jnp.asarray(rng.normal(0, 0.3, (g, 3)), jnp.float32),
        colors_logit=gmap.colors_logit + jnp.asarray(rng.normal(0, 0.5, (g, 3)), jnp.float32),
        opacity_logit=gmap.opacity_logit + jnp.asarray(rng.normal(0, 0.3, g), jnp.float32),
        quats=gmap.quats + jnp.asarray(rng.normal(0, 0.1, (g, 4)), jnp.float32))
    pose = np.asarray(jax.jit(jlie.se3_exp)(jnp.asarray([0.05, -0.03, 0.1, 0.02, -0.03, 0.01])))
    return gmap, pose, img, depth


def tmap_of(gmap):
    return tgs.GaussianMap(*(t(x, np.float32) for x in gmap))


def test_render_matches_jax():
    gmap, pose, _, _ = _scene()
    ref = jgs.render(gmap, jnp.asarray(pose), 60.0, (48, 64), k_per_tile=16)
    ours = tgs.render(tmap_of(gmap), t(pose), 60.0, (48, 64), k_per_tile=16)
    for name in ("color", "depth", "alpha"):
        assert rel_err(getattr(ours, name), getattr(ref, name)) < RENDER_TOL, name
    assert float(ours.alpha.mean()) > 0.3  # the map covers most of the frame


def test_render_gradients_match_jax():
    """d loss / d (means, log_scales, quats, colors, opacities, pose matrix)
    through the render, against ``jax.grad``."""
    gmap, pose, img, depth = _scene()
    fields = ("means", "log_scales", "quats", "colors_logit", "opacity_logit")

    def jloss(params, c2w):
        out = jgs.render(gmap._replace(**dict(zip(fields, params))), c2w, 60.0, (48, 64),
                         k_per_tile=16)
        return jnp.mean(jnp.abs(out.color - img)) + jnp.mean((out.depth - depth) ** 2)

    ref_g, ref_pose = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        tuple(getattr(gmap, f) for f in fields), jnp.asarray(pose))
    tm = tmap_of(gmap)

    def tloss(params, c2w):
        out = tgs.render(tm._replace(**dict(zip(fields, params))), c2w, 60.0, (48, 64),
                         k_per_tile=16)
        return torch.mean(torch.abs(out.color - t(img))) + torch.mean((out.depth - t(depth)) ** 2)

    ours_g, ours_pose = torch.func.grad(tloss, argnums=(0, 1))(
        tuple(getattr(tm, f) for f in fields), t(pose))
    for name, a, b in zip(fields, ours_g, ref_g):
        assert float(np.abs(np.asarray(b)).max()) > 0, name
        assert rel_err(a, b) < GRAD_TOL, name
    assert rel_err(ours_pose, ref_pose) < GRAD_TOL


def test_top_k_ties_at_the_kth_place():
    """Finite ties in the per-tile score across the K-th place: the
    gaussians of a tie are exact copies here (same mean, scale, color and
    opacity), so whichever of them the selection keeps, the render is the
    same, and it is JAX's. A tie of gaussians that differ would render
    differently where ``torch.topk`` keeps another index than ``lax.top_k``
    (the lower one); the map's seeding and densification make no such
    copies of one position."""
    g = 64
    means = np.zeros((g, 3), np.float32)
    means[:, 2] = np.repeat(np.arange(1.0, 5.0, 0.25, dtype=np.float32), 4)  # groups of 4 tie
    base = jgs.GaussianMap(
        means=jnp.asarray(means), log_scales=jnp.full((g, 3), -1.5, jnp.float32),
        quats=jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 1.0]), (g, 1)),
        colors_logit=jnp.asarray(np.repeat(np.linspace(-2, 2, g // 4), 4)[:, None]
                                 .repeat(3, 1).astype(np.float32)),
        opacity_logit=jnp.full((g,), 0.0, jnp.float32), valid=jnp.ones((g,), jnp.float32))
    for k in (6, 10):  # the K-th place inside a group of 4 ties
        ref = jgs.render(base, jnp.eye(4), 40.0, (32, 32), k_per_tile=k)
        ours = tgs.render(tmap_of(base), torch.eye(4), 40.0, (32, 32), k_per_tile=k)
        assert rel_err(ours.color, ref.color) < RENDER_TOL
        assert rel_err(ours.depth, ref.depth) < RENDER_TOL


def test_init_from_depth_and_insert_match_jax():
    gmap, _, img, depth = _scene(g=200)
    ours = tgs.init_from_depth(t(img), t(depth), torch.eye(4), 60.0, stride=4, max_gaussians=200)
    ref = _jax_init(jnp.asarray(img), jnp.asarray(depth), jnp.eye(4), 60.0, stride=4,
                    max_gaussians=200)
    for name in tgs.GaussianMap._fields:
        assert rel_err(getattr(ours, name), getattr(ref, name)) < 1e-6, name
    assert int(ours.valid.sum()) == 12 * 16
    new = _jax_init(jnp.asarray(img), jnp.asarray(depth) + 1.0, jnp.eye(4), 60.0, stride=8,
                    max_gaussians=96)
    new = new._replace(valid=new.valid.at[::3].set(0.0))
    ref = jax.jit(jgs.insert_gaussians)(gmap, new)
    merged = tgs.insert_gaussians(tmap_of(gmap), tmap_of(new))
    for name in tgs.GaussianMap._fields:
        np.testing.assert_array_equal(getattr(merged, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    # 192 valid + 32 incoming in 200 slots: the excess dropped
    assert int(merged.valid.sum()) == 200


# -- mapping ---------------------------------------------------------------

@pytest.fixture(scope="module")
def mappers():
    """Each package's mapping step (uncertainty net width 8, lr 2e-2, K 16),
    the JAX net's init carried to the port; one JAX compile for the
    module's maps of 512 slots."""
    net = jmap.UncertaintyNet(width=8)
    unc = jax.jit(net.init)(jax.random.PRNGKey(0), jnp.zeros((48, 64, 3)))["params"]
    init_opt, jstep = jmap.make_mapping_step(net, jmap.MappingConfig(lr=2e-2, k_per_tile=16))
    tnet = tmap.UncertaintyNet(width=8)
    tnet.load_state_dict(from_jax.uncertainty_net_from_jax(unc), strict=True)
    tinit, tstep = tmap.make_mapping_step(tnet, tmap.MappingConfig(lr=2e-2, k_per_tile=16))
    tunc = {k: v.detach().clone() for k, v in tnet.named_parameters()}
    return (unc, init_opt, jstep), (tunc, tinit, tstep)


def test_one_mapping_step_matches_optax(mappers):
    """One step of each package's mapper from the same map, uncertainty
    weights and Adam state: the loss, the updated map and net, and the Adam
    moments; then a second step (bias correction at count 2)."""
    gmap, pose, img, depth = _scene(g=512)
    (unc, init_opt, jstep), (tunc, tinit, tstep) = mappers
    jstate = (gmap, unc, init_opt(gmap, unc))
    tstate_ = (tmap_of(gmap), tunc, tinit(tmap_of(gmap), tunc))
    args = (img, depth, pose)
    with torch.no_grad():
        for _ in range(2):
            *jstate, jloss, jout = jstep(*jstate, *(jnp.asarray(a) for a in args),
                                         jnp.float32(60.0))
            *tstate_, loss, out = tstep(*tstate_, *(t(a) for a in args), torch.tensor(60.0))
            assert rel_err(loss, jloss) < MAP_STEP_TOL
            assert rel_err(out.depth, jout.depth) < MAP_STEP_TOL
            for name in tgs.GaussianMap._fields:
                assert rel_err(getattr(tstate_[0], name), getattr(jstate[0], name)) \
                    < MAP_STEP_TOL, name
            ref_unc = from_jax.uncertainty_net_from_jax(jstate[1])
            for name, v in tstate_[1].items():
                assert rel_err(v, ref_unc[name]) < MAP_STEP_TOL, name
            # optax's multi_transform: each group's Adam state, its moments
            # over the (map, net) pair with the other group masked out
            jg, ju = (jstate[2].inner_states[grp].inner_state[0] for grp in ("gauss", "unc"))
            for ours_m, ref_m in ((tstate_[2].gauss.mu, jg.mu[0]), (tstate_[2].gauss.nu, jg.nu[0])):
                for name, a, b in zip(tgs.GaussianMap._fields, ours_m, ref_m):
                    if name != "valid":
                        assert rel_err(a, b) < MAP_STEP_TOL, name
            for ours_m, ref_m in ((tstate_[2].unc.mu, ju.mu[1]), (tstate_[2].unc.nu, ju.nu[1])):
                ref_m = from_jax.uncertainty_net_from_jax(ref_m)
                for name, a in zip(tstate_[1], ours_m):
                    assert rel_err(a, ref_m[name]) < MAP_STEP_TOL, name
            assert int(tstate_[2].gauss.count) == int(jg.count) == int(tstate_[2].unc.count)


def test_free_slots_keep_finite_adam_moments(mappers):
    """A map seeded into a larger capacity (free slots: zero quaternions):
    one mapping step of each package. The port's moments of the free slots
    stay 0 and its map finite; JAX's are NaN (``jnp.linalg.norm``'s gradient
    at a zero vector, times the free-slot mask's 0), which turns a gaussian
    that WildGS-SLAM later inserts into such a slot into NaN (ROADMAP,
    section 3)."""
    _, pose, img, depth = _scene(g=512)
    gmap = _jax_init(jnp.asarray(img), jnp.asarray(depth), jnp.eye(4), 60.0, stride=4,
                     max_gaussians=512)  # 192 seeds, 320 free slots
    (unc, init_opt, jstep), (tunc, tinit, tstep) = mappers
    jout = jstep(gmap, unc, init_opt(gmap, unc), jnp.asarray(img), jnp.asarray(depth),
                 jnp.asarray(pose), jnp.float32(60.0))
    with torch.no_grad():
        tout = tstep(tmap_of(gmap), tunc, tinit(tmap_of(gmap), tunc), t(img), t(depth), t(pose),
                     torch.tensor(60.0))
    free = np.asarray(gmap.valid) < 0.5
    assert free.sum() == 320
    jmu = jout[2].inner_states["gauss"].inner_state[0].mu[0]
    assert np.isnan(np.asarray(jmu.quats)[free]).all()  # the JAX fault
    assert all(np.isfinite(m.numpy()).all() for m in tout[2].gauss.mu)
    assert float(tout[2].gauss.mu[2][free].abs().max()) == 0.0
    assert all(np.isfinite(x.numpy()).all() for x in tout[0])
    # the seeded slots step as JAX's
    for name, a, b in zip(tgs.GaussianMap._fields, tout[0], jout[0]):
        assert rel_err(a.numpy()[~free], np.asarray(b)[~free]) < MAP_STEP_TOL, name


@pytest.mark.parametrize("kernel", [3, 1])
def test_conv_nhwc_matches_conv2d(kernel):
    """The uncertainty net's convolution as one matmul over shifted windows
    against ``F.conv2d`` on the same NCHW data: the output and the input's
    and weights' gradients (max rel < 1e-5)."""
    gen = torch.Generator().manual_seed(kernel)
    conv = torch.nn.Conv2d(5, 7, kernel, padding=kernel // 2)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    x = torch.randn((1, 12, 16, 5), generator=gen, requires_grad=True)
    cot = torch.randn((1, 12, 16, 7), generator=gen)
    ours = tmap.conv_nhwc(x, conv)
    grads = torch.autograd.grad((ours * cot).sum(), (x, conv.weight, conv.bias))
    ref = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias,
                                     padding=kernel // 2).permute(0, 2, 3, 1)
    ref_grads = torch.autograd.grad((ref * cot).sum(), (x, conv.weight, conv.bias))
    assert rel_err(ours.detach(), ref.detach()) < 1e-5
    for name, a, b in zip(("x", "weight", "bias"), grads, ref_grads):
        assert rel_err(a, b) < 1e-5, name


def test_solve_and_mapping_step_leave_inference_mode(ba_case, mappers):
    """The solve and the mapping step take their derivatives outside
    inference mode themselves (an Engine runs and captures its function
    inside it): called under ``torch.inference_mode()`` they return what
    they return under ``torch.no_grad()``, bit for bit, as ordinary
    tensors."""
    prob, state, focal, hw = ba_case
    cfg = tba.BAConfig(iters=3, optimize_focal=True)
    runs = []
    for mode in (torch.no_grad, torch.inference_mode):
        with mode():
            runs.append(tba.run_ba(tprob(prob), tstate(state), focal, hw, cfg))
    (s0, i0), (s1, i1) = runs
    for a, b in [*zip(s0, s1), (i0["cost"], i1["cost"]), (i0["rms_px"], i1["rms_px"])]:
        assert torch.equal(a, b) and not b.is_inference()
    gmap, pose, img, depth = _scene(g=512)
    _, (tunc, tinit, tstep) = mappers
    outs = []
    for mode in (torch.no_grad, torch.inference_mode):
        with mode():
            g = tmap_of(gmap)
            outs.append(tstep(g, tunc, tinit(g, tunc), t(img), t(depth), t(pose),
                              torch.tensor(60.0)))
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a, b) and not b.is_inference()
    assert torch.equal(outs[0][3], outs[1][3])
