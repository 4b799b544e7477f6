"""The port's training subsystem (``training/``) and QAT (``ops/quant.py``)
against the JAX package on the CPU: the losses and their gradients, the
metrics, the schedule, AdamW against optax, gradient accumulation, remat,
save and resume, the QAT forward and its straight-through gradients on a
tiny DA-V2, and a whole distillation run. Inputs come from numpy seeds; the
JAX side runs jitted. Each test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import monocular_depth_estimation_trt_tpu.models.depth_anything_v2 as jda
from monocular_depth_estimation_trt_tpu.config import IMAGENET_MEAN, IMAGENET_STD
from monocular_depth_estimation_trt_tpu.models.vit import ViTConfig as JViTConfig
from monocular_depth_estimation_trt_tpu.ops import postprocess as jpost
from monocular_depth_estimation_trt_tpu.ops import preprocess as jpre
from monocular_depth_estimation_trt_tpu.training.distill import distill as jax_distill
from monocular_depth_estimation_trt_tpu.training import losses as jlosses
from monocular_depth_estimation_trt_tpu.training import metrics as jmetrics
from monocular_depth_estimation_trt_tpu_torch.models.depth_anything_v2 import DepthAnythingV2
from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import flash_attention as fa
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import quant_matmul as qm
from monocular_depth_estimation_trt_tpu_torch.ops.quant import QATLinear, install_qat
from monocular_depth_estimation_trt_tpu_torch.training import losses, metrics, trainer
from monocular_depth_estimation_trt_tpu_torch.training.distill import depth_student, distill
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import state_dict_from_jax

from torch_port_params import random_params, rel_err

torch.set_num_threads(1)

LOSS_REL_TOL = 1e-5  # values and gradients, fp32 on both sides
METRIC_REL_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _depth_pair(seed, b=2, h=12, w=16):
    """A relu'd prediction and a teacher clamped at 1e-3 with flat regions:
    the residual's finite differences hold exact zeros (the |x| kink)."""
    rng = np.random.default_rng(seed)
    coarse = rng.standard_normal((b, h // 4, w // 4)).astype(np.float32)
    pred = np.maximum(np.repeat(np.repeat(coarse, 4, 1), 4, 2), 0.0)
    pred[:, :, : w // 2] += 0.1 * rng.standard_normal((b, h, w // 2)).astype(np.float32)
    target = np.maximum(np.repeat(np.repeat(
        rng.standard_normal((b, h // 4, w // 4)).astype(np.float32), 4, 1), 4, 2), 1e-3)
    mask = (rng.random((b, h, w)) > 0.25).astype(np.float32)
    return pred.astype(np.float32), target.astype(np.float32), mask


LOSSES = {
    "ssi": (jlosses.ssi_loss, losses.ssi_loss, {}),
    "ssi_unaligned": (jlosses.ssi_loss, losses.ssi_loss, {"alignment": "none"}),
    "gradient_matching": (jlosses.gradient_matching_loss, losses.gradient_matching_loss, {}),
    "gradient_matching_unaligned": (jlosses.gradient_matching_loss,
                                    losses.gradient_matching_loss,
                                    {"align": False, "scales": 2}),
    "silog": (jlosses.silog_loss, losses.silog_loss, {}),
    "distillation": (jlosses.distillation_loss, losses.distillation_loss, {}),
}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_and_gradient_match_jax(name, masked):
    jfn, tfn, kw = LOSSES[name]
    pred, target, mask = _depth_pair(3)
    m = mask if masked else None
    want, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jfn(p, jnp.asarray(target), None if m is None else jnp.asarray(m), **kw)))(
        jnp.asarray(pred))
    p = _t(pred).requires_grad_(True)
    got = tfn(p, _t(target), None if m is None else _t(m), **kw)
    (grad,) = torch.autograd.grad(got, p)
    assert got.dtype == torch.float32
    assert rel_err(got.detach(), want) < LOSS_REL_TOL
    assert rel_err(grad, jgrad) < LOSS_REL_TOL
    if name.startswith("gradient_matching"):
        # the case the |x| convention decides: exact zeros among the
        # residual's differences, where torch.abs has gradient 0 and JAX 1
        r = pred - target
        assert np.sum(r[:, :, 1:] == r[:, :, :-1]) > 20


def test_losses_take_bf16_and_compute_in_fp32():
    pred, target, _ = _depth_pair(5)
    for fn in (losses.ssi_loss, losses.silog_loss, losses.distillation_loss):
        a = fn(_t(pred).bfloat16(), _t(target).bfloat16())
        b = fn(_t(pred).bfloat16().float(), _t(target).bfloat16().float())
        assert a.dtype == torch.float32 and torch.equal(a, b)


@pytest.mark.parametrize("masked", [False, True])
def test_align_scale_shift_matches_jax(masked):
    pred, target, mask = _depth_pair(7)
    pred[1] = 0.5  # a constant prediction: the shift-only fallback
    m = mask if masked else None
    js, jt = jlosses.align_scale_shift(jnp.asarray(pred), jnp.asarray(target),
                                       None if m is None else jnp.asarray(m))
    s, t = losses.align_scale_shift(_t(pred), _t(target), None if m is None else _t(m))
    assert float(s[1]) == 1.0
    assert rel_err(s, js) < LOSS_REL_TOL and rel_err(t, jt) < LOSS_REL_TOL


def _metric_case(seed, kind):
    rng = np.random.default_rng(seed)
    gt = (np.abs(rng.standard_normal((2, 10, 14))) + 0.2).astype(np.float32)
    pred = (1.7 * gt + 0.3 + 0.1 * rng.standard_normal(gt.shape)).astype(np.float32)
    mask = None
    if kind == "masked":
        mask = (rng.random(gt.shape) > 0.3).astype(np.float32)
    elif kind == "nonpositive_gt":
        gt[:, :3] = 0.0
        gt[:, -1, :4] = -1.0
    elif kind == "constant_pred":
        pred[0] = 2.0
    return pred, gt, mask


@pytest.mark.parametrize("kind", ["plain", "masked", "nonpositive_gt", "constant_pred"])
@pytest.mark.parametrize("align", ["none", "affine", "median"])
def test_depth_metrics_match_jax(align, kind):
    pred, gt, mask = _metric_case(11, kind)
    want = jax.jit(lambda p, g, m: jmetrics.depth_metrics(p, g, m, align=align))(
        jnp.asarray(pred), jnp.asarray(gt), None if mask is None else jnp.asarray(mask))
    got = metrics.depth_metrics(_t(pred), _t(gt), None if mask is None else _t(mask),
                                align=align)
    assert sorted(got) == sorted(want)  # jit returns the dict sorted
    for k in want:
        assert rel_err(got[k], want[k]) < METRIC_REL_TOL, k


def test_median_scale_takes_the_upper_median_as_jax_does():
    """An even count: the JAX protocol reads index n // 2 of the sorted
    values (the upper median), where ``torch.median`` gives the lower."""
    pred = np.array([[[1.0, 2.0, 3.0, 4.0]]], np.float32)
    gt = np.array([[[2.0, 4.0, 6.0, 80.0]]], np.float32)
    w = torch.ones(1, 1, 4)
    s = metrics._median_scale(_t(pred), _t(gt), w)
    assert float(s) == pytest.approx(6.0 / 3.0)
    js = jmetrics._median_scale(jnp.asarray(pred), jnp.asarray(gt), jnp.ones((1, 1, 4)))
    assert float(s) == float(js[0])


@pytest.mark.parametrize("masked", [False, True])
def test_flow_metrics_match_jax(masked):
    rng = np.random.default_rng(13)
    gt = (4 * rng.standard_normal((2, 9, 11, 2))).astype(np.float32)
    pred = (gt + 2 * rng.standard_normal(gt.shape)).astype(np.float32)
    mask = (rng.random((2, 9, 11)) > 0.4).astype(np.float32) if masked else None
    want = jmetrics.flow_metrics(jnp.asarray(pred), jnp.asarray(gt),
                                 None if mask is None else jnp.asarray(mask))
    got = metrics.flow_metrics(_t(pred), _t(gt), None if mask is None else _t(mask))
    assert list(got) == list(want)
    for k in want:
        assert rel_err(got[k], want[k]) < METRIC_REL_TOL, k


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warmup,decay", [(10, 30), (1, 4), (10, 11)])
def test_schedule_equals_optax_at_every_step(warmup, decay):
    """Within float32 rounding (rel 1e-6) at every step of the run, and the
    checked points: 0 at step 0, the peak at the warmup's end, 0 at the
    end."""
    ours = trainer.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, decay)
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, decay)
    for step in range(decay + 2):
        want = float(ref(step))
        assert abs(ours(step) - want) <= 1e-6 * 3e-4, step
    assert ours(0) == 0.0 and ours(warmup) == pytest.approx(3e-4, rel=1e-6)
    assert ours(decay) == pytest.approx(0.0, abs=1e-12)
    if (warmup, decay) == (10, 30):
        assert ours(1) == pytest.approx(3e-5, rel=1e-6)


def _mlp_params(seed):
    rng = np.random.default_rng(seed)
    return {"fc1.weight": rng.standard_normal((16, 8)).astype(np.float32) / 3,
            "fc1.bias": 0.1 * rng.standard_normal(16).astype(np.float32),
            "fc2.weight": rng.standard_normal((1, 16)).astype(np.float32) / 4,
            "fc2.bias": np.zeros(1, np.float32)}


def test_adamw_equals_optax_on_the_same_grads():
    """Three steps of AdamW under a warmup-cosine schedule on the same
    parameters and gradients as optax.adamw: rel < 1e-6 on the tensors of
    random initial values. fc2.bias starts at 0, so that its value is the
    updates alone: rel < 3e-5 there, as optax computes the bias corrections
    1 - b^t in float32 (at t = 2, 1 - 0.999^2 is 2e-5 off, the update half
    of that through the square root) and torch in float64."""
    params = _mlp_params(1)
    rng = np.random.default_rng(2)
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 5)
    tx = optax.adamw(sched, weight_decay=1e-4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    state = trainer.create_train_state(
        {k: _t(v) for k, v in params.items()},
        trainer.adamw(trainer.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 5),
                      weight_decay=1e-4))
    @jax.jit  # one program, not one compile an operation
    def jstep(g, opt_state, jp):
        updates, opt_state = tx.update(g, opt_state, jp)
        return optax.apply_updates(jp, updates), opt_state

    for g in grads:
        jp, opt_state = jstep({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        for k, p in state.params.items():
            p.grad = _t(g[k])
        state.optimizer.step()
        state.scheduler.step()
    for k in params:
        bar = 3e-5 if k == "fc2.bias" else 1e-6
        assert rel_err(state.params[k].detach(), jp[k]) < bar, k
        assert not np.array_equal(jp[k], params[k])  # the steps moved every tensor


def _mlp_loss(params, batch):
    x, y = batch
    h = torch.relu(x @ params["fc1.weight"].T + params["fc1.bias"])
    out = (h @ params["fc2.weight"].T + params["fc2.bias"])[:, 0]
    return torch.mean((out - y) ** 2)


def _mlp_batch(seed, n=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    return _t(x), _t(np.sin(x.sum(-1)).astype(np.float32))


def _run(steps, *, accum_steps=1, remat=False, state=None):
    if state is None:
        state = trainer.create_train_state({k: _t(v) for k, v in _mlp_params(4).items()},
                                           trainer.adamw(1e-2))
    step = trainer.make_train_step(_mlp_loss, accum_steps=accum_steps, remat=remat)
    history = []
    for i in range(steps):
        state, m = step(state, _mlp_batch(100 + state.step))
        history.append((float(m["loss"]), float(m["grad_norm"])))
    return state, history


def test_grad_accumulation_matches_full_batch():
    """The mean of two microbatches' losses and gradients equals the full
    batch's (a mean loss): rel < 1e-6 after three steps."""
    full, h_full = _run(3)
    acc, h_acc = _run(3, accum_steps=2)
    np.testing.assert_allclose(h_acc, h_full, rtol=1e-6)
    for k in full.params:
        assert rel_err(acc.params[k].detach(), full.params[k].detach()) < 1e-6, k
    with pytest.raises(ValueError, match="divisible"):
        _run(1, accum_steps=3)


def test_remat_equals_plain():
    plain, h_plain = _run(3)
    remat, h_remat = _run(3, remat=True)
    assert h_remat == h_plain
    for k in plain.params:
        assert torch.equal(remat.params[k], plain.params[k]), k


def test_grad_norm_is_the_global_norm():
    state = trainer.create_train_state({k: _t(v) for k, v in _mlp_params(4).items()},
                                       trainer.adamw(0.0))
    batch = _mlp_batch(9)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in state.params.items()}
    grads = torch.autograd.grad(_mlp_loss(p, batch), list(p.values()))
    want = optax.global_norm([jnp.asarray(g.numpy()) for g in grads])
    _, m = trainer.make_train_step(_mlp_loss)(state, batch)
    assert rel_err(m["grad_norm"], want) < 1e-6


def test_save_resume_equals_an_uninterrupted_run(tmp_path):
    """Two steps, save, a fresh state loads it, two more steps: bit for bit
    the four-step run (parameters, moments, schedule position, history)."""
    straight, h_straight = _run(4)
    first, h_first = _run(2)
    path = trainer.save_train_state(str(tmp_path / "state.pt"), first)
    fresh = trainer.create_train_state({k: _t(v) for k, v in _mlp_params(4).items()},
                                       trainer.adamw(1e-2))
    resumed = trainer.load_train_state(path, fresh)
    assert resumed.step == 2
    resumed, h_rest = _run(2, state=resumed)
    assert h_first + h_rest == h_straight
    for k in straight.params:
        assert torch.equal(resumed.params[k], straight.params[k]), k
    a, b = straight.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    for i in a:
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a[i][key], b[i][key])


# ---------------------------------------------------------------------------
# The kernels have no backward; QAT
# ---------------------------------------------------------------------------


def _kernel_calls():
    rng = np.random.default_rng(0)
    q, k, v = (_t(rng.standard_normal((1, 2, 16, 64)).astype(np.float32)) for _ in range(3))
    x = _t(rng.standard_normal((4, 32)).astype(np.float32))
    wq = torch.randint(-127, 128, (8, 32), dtype=torch.int8)
    return {
        "K1": (lambda t: fa.flash_attention_packed(t, 2), _t(
            rng.standard_normal((1, 16, 3 * 128)).astype(np.float32))),
        "K2": (lambda t: fa.flash_attention(t, k, v), q),
        "K3": (lambda t: fa.flash_attention_batched(t, k, v), q),
        "K4": (lambda t: qm.w8a8_matmul(t, wq, torch.ones(32), torch.full((8,), 0.01), None,
                                        torch.float32), x),
    }


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4"])
def test_backward_through_a_kernel_raises(kernel):
    """The mdet:: operators have no autograd formula: a backward through one
    raises instead of silently detaching, so that training takes the plain
    attention route."""
    fn, x = _kernel_calls()[kernel]
    y = fn(x.clone().requires_grad_(True))
    with pytest.raises(RuntimeError, match="no autograd formula"):
        y.sum().backward()


TINY_KW = dict(vit_config=ViTConfig(dim=64, depth=2, num_heads=4, pretrain_img_size=56),
               head_features=16, head_out_channels=(8, 16, 32, 32), out_indices=(0, 1, 0, 1))
SIZE = 56


@pytest.fixture(scope="module")
def tiny_jax():
    """The tiny DA-V2 of ``tests/test_cli_distill.py`` (dim 64, 2 blocks, 4
    heads, head features 16) in fp32 on the plain attention route, plain
    and QAT, with seeded params."""
    cfg = JViTConfig(dim=64, depth=2, num_heads=4, pretrain_img_size=56)
    kw = dict(encoder="tiny", vit_config=cfg, head_features=16,
              head_out_channels=(8, 16, 32, 32), out_indices=(0, 1, 0, 1),
              dtype=jnp.float32, attn_impl="xla")
    plain, qat = jda.DepthAnythingV2(**kw), jda.DepthAnythingV2(quant="qat", **kw)
    params = random_params(plain, jnp.zeros((1, SIZE, SIZE, 3)), seed=21)
    return plain, qat, params


def _tiny_port(params, qat=False):
    model = DepthAnythingV2(encoder="tiny", attn_impl="xla", **TINY_KW)
    model.load_state_dict(state_dict_from_jax(params))
    return install_qat(model, model.int8_targets()) if qat else model


def _images(seed, n=1):
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (n, SIZE // 8, SIZE // 8, 3))
    return np.repeat(np.repeat(coarse, 8, 1), 8, 2).astype(np.uint8)


def _normalized(imgs_u8):
    x = imgs_u8.astype(np.float32) / 255.0
    return ((x - np.array(IMAGENET_MEAN, np.float32)) / np.array(IMAGENET_STD, np.float32))


def test_qat_forward_matches_jax(tiny_jax):
    """rel < 1e-5 on the depth; QAT differs from the plain forward by the
    quantization grid only."""
    plain, qat, params = tiny_jax
    x = _normalized(_images(1, 2))
    want = jax.jit(lambda p, x: qat.apply({"params": p}, x))(params, jnp.asarray(x))
    model = _tiny_port(params, qat=True)
    assert sum(isinstance(m, QATLinear) for m in model.modules()) == 2 * 4
    with torch.no_grad():
        got = model(_t(x))
        fp = _tiny_port(params)(_t(x))
    assert rel_err(got, want) < 1e-5
    assert 0.0 < rel_err(got, fp) < 0.1


def test_qat_ste_gradients_match_jax(tiny_jax):
    """Gradients of sum(depth^2) through the fake quantization, every
    parameter: rel < 1e-4 of each tensor's largest gradient."""
    _, qat, params = tiny_jax
    x = _normalized(_images(2, 2))
    jgrads = jax.jit(jax.grad(lambda p: jnp.sum(qat.apply({"params": p}, jnp.asarray(x)) ** 2)))(
        params)
    want = state_dict_from_jax(jgrads)
    model = _tiny_port(params, qat=True)
    (model(_t(x)) ** 2).sum().backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        if not want[k].any():  # JAX's converter pads a tensor the graph never reads
            continue
        assert rel_err(g, want[k]) < 1e-4, k


def test_qat_state_dict_is_the_plain_models(tiny_jax):
    _, _, params = tiny_jax
    plain, qat = _tiny_port(params), _tiny_port(params, qat=True)
    a, b = plain.state_dict(), qat.state_dict()
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    lin = DepthAnythingV2(encoder="tiny", attn_impl="xla", **TINY_KW)
    with pytest.raises(TypeError, match="not an nn.Linear"):
        install_qat(lin, ["pretrained.blocks.0.norm1"])


# ---------------------------------------------------------------------------
# Distillation against JAX
# ---------------------------------------------------------------------------


def _teacher(imgs):
    """A deterministic 'teacher': disparity from the red channel, clamped at
    1e-3 as a serving teacher's depth is (flat regions: exact zeros)."""
    return np.maximum(np.asarray(imgs)[..., 0].astype(np.float32) / 255.0 - 0.3, 1e-3)


def test_distill_matches_jax(tiny_jax):
    """Four steps (warmup 2, lr 1e-3, batch 2, two batch positions) on the
    same frames, labels and initial weights, fp32 on the CPU: the loss
    history at rel < 1e-4. The final parameters, in units of lr (a step
    moves an element by about lr: the median element moved 0.95 lr): the
    99.9th percentile of |port - JAX| within 0.02 lr (0.008 measured), every
    element within 0.5 lr (0.35 measured, in 20 of 210,649 elements of the
    DPT head's first convolutions). Adam divides by sqrt(v_hat), so an
    element whose gradients are near 0 turns fp32 differences of the
    gradient into a sizeable part of a step; a step gone the other way
    would show as about 2 lr."""
    plain, _, params = tiny_jax
    frames, lr, steps = _images(5, 4), 1e-3, 4

    def japply(p, imgs):
        x = jpre.normalize(jpre.to_float_rgb(imgs), IMAGENET_MEAN, IMAGENET_STD)
        return jpost.upsample_depth(plain.apply({"params": p}, x), (SIZE, SIZE), clamp=None)

    jstate, jhist = jax_distill(_teacher, japply, params, [frames[:2], frames[2:]],
                                     steps=steps, learning_rate=lr, warmup=2, log_every=0)

    port = _tiny_port(params)
    init = {k: v.clone() for k, v in port.state_dict().items()}
    state, hist = distill(_teacher, depth_student(port, SIZE), dict(port.named_parameters()),
                          [frames[:2], frames[2:]], steps=steps, learning_rate=lr, warmup=2,
                          log_every=0)
    assert state.step == steps and len(hist) == steps
    np.testing.assert_allclose(hist, jhist, rtol=1e-4)
    want = state_dict_from_jax(jstate.params)
    assert sorted(want) == sorted(state.params)
    diff = torch.cat([(p.detach() - want[k]).abs().flatten()
                      for k, p in state.params.items()]) / lr
    assert float(diff.max()) <= 0.5
    assert float(torch.quantile(diff, 0.999)) <= 0.02
    moved = torch.cat([(p.detach() - init[k]).abs().flatten()
                       for k, p in state.params.items()]) / lr
    assert float(moved.median()) > 0.5
