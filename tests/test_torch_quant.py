"""The port's int8 (w8a8) pieces against the JAX package's ``ops/quant.py``
and ``ops/pallas/quant_matmul.py`` on the CPU, at tiny sizes, with inputs
made from numpy seeds: weight quantization, the SmoothQuant rule,
calibration statistics, K4's plain version and ``QuantLinear``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu.models import vit as jvit
from monocular_depth_estimation_trt_tpu.ops import quant as jquant
from monocular_depth_estimation_trt_tpu.ops.pallas.quant_matmul import w8a8_matmul as jax_w8a8
from monocular_depth_estimation_trt_tpu_torch.models import vit as tvit
from monocular_depth_estimation_trt_tpu_torch.ops import quant as tquant
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import quant_matmul as qm
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import dinovit_from_jax

from torch_port_params import random_params

torch.set_num_threads(1)

SCALE_RTOL = 1e-6  # fp32 scales: the same operations, at most an ulp apart
STATS_RTOL = 1e-5  # fp32 activations through two blocks, summation order apart


def _xla_serve(x, kernel_q, qmul, out_scale, bias):
    """The JAX serve mode's unfused path (QuantDense with MDET_W8A8_IMPL=xla)."""
    xq = jnp.clip(jnp.round(x.astype(jnp.float32) * qmul), -127, 127).astype(jnp.int8)
    y = jax.lax.dot_general(xq, kernel_q, (((xq.ndim - 1,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32).astype(jnp.float32) * out_scale
    return y if bias is None else y + bias


def _operands(m, k, n, seed=0, lead=()):
    """numpy operands: x (..., M, K), kernel_q (K, N) int8 in the JAX layout,
    qmul (K,), out_scale and bias (N,)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, m, k)).astype(np.float32)
    kq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    qmul = rng.uniform(0.5, 30.0, k).astype(np.float32)
    scale = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    return x, kq, qmul, scale, bias


def _port(x, kq, qmul, scale, bias, dtype=torch.float32):
    t = torch.from_numpy
    return qm.w8a8_matmul(t(x).to(dtype), t(np.ascontiguousarray(kq.T)), t(qmul), t(scale),
                          None if bias is None else t(bias))


def _bf16_step(v):
    """bf16 spacing at each |v| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)


def test_quantize_weight_matches_jax(rng):
    k = (rng.standard_normal((48, 24)) * rng.uniform(0.01, 3.0, 24)).astype(np.float32)
    k[:, 5] = 0.0  # an all-zero output channel takes the 1e-8 floor
    jq, js = jquant.quantize_weight(jnp.asarray(k))
    tq, ts = tquant.quantize_weight(torch.from_numpy(np.ascontiguousarray(k.T)))
    assert tq.dtype == torch.int8 and tq.shape == (24, 48)
    np.testing.assert_array_equal(tq.numpy().T, np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=SCALE_RTOL)


def test_build_q8_matches_jax_from_the_same_stats(rng):
    """Two layers from the same absmax statistics: one with a channel that
    never fired (absmax 0: s = 1) and a weight row of zeros (s = 1), and a
    layer that never fired at all (a = 1)."""
    k_in, n = 64, 96
    kernels = [rng.standard_normal((k_in, n)).astype(np.float32) / 8 for _ in range(2)]
    kernels[0][7] = 0.0
    stats = [np.abs(rng.standard_normal(k_in)).astype(np.float32) * 5, np.zeros(k_in, np.float32)]
    stats[0][3] = 0.0
    stats[0][:2] *= 40.0  # outlier channels
    params = {f"d{i}": {"kernel": jnp.asarray(kern), "bias": jnp.zeros(n)}
              for i, kern in enumerate(kernels)}
    q8_struct = {f"d{i}": {"qmul": 0, "kernel_q": 0, "out_scale": 0} for i in range(2)}
    jq8 = jquant.build_q8(q8_struct, params, {f"d{i}": {"absmax_ch": jnp.asarray(s)}
                                              for i, s in enumerate(stats)})
    for i in range(2):
        ours = tquant.build_q8(torch.from_numpy(np.ascontiguousarray(kernels[i].T)),
                               torch.from_numpy(stats[i]))
        ref = jq8[f"d{i}"]
        np.testing.assert_array_equal(ours["weight_q"].numpy().T, np.asarray(ref["kernel_q"]))
        np.testing.assert_allclose(ours["qmul"].numpy(), np.asarray(ref["qmul"]),
                                   rtol=SCALE_RTOL)
        np.testing.assert_allclose(ours["out_scale"].numpy(), np.asarray(ref["out_scale"]),
                                   rtol=SCALE_RTOL)
    assert torch.all(tquant.build_q8(torch.ones(4, 8), torch.zeros(8))["qmul"] == 1.0)


def test_calibration_stats_of_a_tiny_dinovit_match_jax(rng):
    """fp32 DinoViT (dim 128, 2 heads, 2 blocks), two calibration batches:
    the per-layer input absmax of every Dense layer, max-reduced."""
    cfg = dict(dim=128, depth=2, num_heads=2, pretrain_img_size=42)
    jm = jvit.DinoViT(jvit.ViTConfig(**cfg), out_indices=(1,), dtype=jnp.float32,
                      attn_impl="xla", quant="calib")
    xs = [rng.standard_normal((b, 42, 42, 3)).astype(np.float32) for b in (1, 2)]
    params = random_params(jm, jnp.asarray(xs[0]), seed=3)
    jstats = jquant.calibrate(jm, {"params": params}, *(jnp.asarray(x) for x in xs))

    tm = tvit.DinoViT(tvit.ViTConfig(**cfg), out_indices=(1,), attn_impl="xla")
    tm.load_state_dict(dinovit_from_jax(params, ""), strict=True)
    targets = tquant.linear_paths(tm, "blocks")
    assert len(targets) == 8
    ours = tquant.calibrate(tm.eval(), targets, [torch.from_numpy(x) for x in xs])
    for path in targets:
        _, i, *rest = path.split(".")
        node = jstats[f"blocks_{i}"]
        for key in rest:
            node = node[key]
        want = node["absmax_ch"]
        want = np.asarray(want[0] if isinstance(want, tuple) else want)
        np.testing.assert_allclose(ours[path].numpy(), want, rtol=STATS_RTOL)


@pytest.mark.parametrize("m,k,n", [(40, 64, 128), (130, 96, 256), (8, 32, 128)])
def test_plain_version_matches_the_jax_pallas_kernel(m, k, n):
    """The shapes of tests/test_quant_matmul.py, against the Pallas kernel
    in interpret mode, fp32 out."""
    x, kq, qmul, scale, bias = _operands(m, k, n)
    want = jax_w8a8(jnp.asarray(x), jnp.asarray(kq), jnp.asarray(qmul), jnp.asarray(scale),
                    jnp.asarray(bias), out_dtype=jnp.float32)
    before = qm.w8a8_matmul.launches
    ours = _port(x, kq, qmul, scale, bias)
    assert qm.w8a8_matmul.launches == before  # a CPU tensor: the plain version
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# csrc/w8a8_matmul.cu's fp32 form: 128 x 128 output tiles, K steps of 64
TILE_M, TILE_N32, K_STEP32 = 128, 128, 64
ROUNDER = np.float32(12582912.0)  # 1.5 * 2^23


def _kernel_quantize(x, qmul, rounding="even"):
    """The fp32 kernel's quantize in numpy float32: x * qmul with one
    rounding, the clamp, then the add of 1.5 * 2^23, whose own rounding at a
    spacing of 1 rounds half to even, and the low byte of the sum.
    ``rounding="away"`` is a cut model that rounds half away from zero."""
    v = np.clip(x.astype(np.float32) * qmul.astype(np.float32), np.float32(-127),
                np.float32(127))
    if rounding == "away":
        return (np.sign(v) * np.floor(np.abs(v) + np.float32(0.5))).astype(np.int8)
    bits = (v + ROUNDER).astype(np.float32).view(np.uint32)
    return (bits & 0xFF).astype(np.uint8).view(np.int8)


def _kernel_model(x, kq, qmul, scale, bias, rounding="even", k_tail=True):
    """The fp32 kernel's arithmetic and tile walk: each 128 x 128 output
    tile sums K steps of 64 over x and weight tiles zero-filled past
    M, N and K (as TMA fills them; qmul reads zero past K), int32 exact, then
    rescales float32(acc) * out_scale, then + bias, two float32 roundings,
    and writes only the rows and columns inside (M, N). ``k_tail=False`` is
    a cut model that drops the last K step where it is partial."""
    m, k = x.shape
    n = kq.shape[1]
    steps = -(-k // K_STEP32) if k_tail else k // K_STEP32
    kp = -(-k // K_STEP32) * K_STEP32
    xp = np.zeros((-(-m // TILE_M) * TILE_M, kp), np.float32)
    xp[:m, :k] = x
    wp = np.zeros((kp, -(-n // TILE_N32) * TILE_N32), np.int32)
    wp[:k, :n] = kq
    qp = np.zeros(kp, np.float32)
    qp[:k] = qmul
    out = np.full((m, n), np.nan, np.float32)
    for m0 in range(0, m, TILE_M):
        for n0 in range(0, n, TILE_N32):
            acc = np.zeros((TILE_M, TILE_N32), np.int32)
            for ks in range(steps):
                cols = slice(ks * K_STEP32, (ks + 1) * K_STEP32)
                xq = _kernel_quantize(xp[m0:m0 + TILE_M, cols], qp[cols], rounding)
                acc += xq.astype(np.int32) @ wp[cols, n0:n0 + TILE_N32]
            rows, width = min(TILE_M, m - m0), min(TILE_N32, n - n0)
            y = acc[:rows, :width].astype(np.float32) * scale[n0:n0 + width]
            if bias is not None:
                y = y + bias[n0:n0 + width]
            out[m0:m0 + rows, n0:n0 + width] = y
    return out


def _tie_operands(m, k, n, seed):
    """fp32 operands on which the quantize meets exact ties (x * qmul = j +
    0.5, qmul a power of two), values that clip at +-127, and ordinary
    values."""
    x, kq, _, scale, bias = _operands(m, k, n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    qmul = (2.0 ** rng.integers(-2, 4, k)).astype(np.float32)
    j = rng.integers(-140, 140, (m, k)).astype(np.float32)
    kind = rng.integers(0, 3, (m, k))
    x = np.where(kind == 0, (j + np.float32(0.5)) / qmul, x * 60 / qmul).astype(np.float32)
    x[0, :] = 200.0 / qmul  # a row that clips at +127
    return x, kq, qmul, scale, bias


@pytest.mark.parametrize("k", [40, 96])
@pytest.mark.parametrize("model,holds", [
    ("kernel", True), ("round_half_away", False), ("drop_k_tail", False)])
def test_fp32_kernel_model_matches_the_jax_pallas_kernel(model, holds, k):
    """The fp32 kernel's arithmetic and tile walk (ragged M = 130 and N =
    136) against the Pallas kernel in interpret mode with fp32 x and fp32
    out, on exact ties and clipped values. Bit for bit on the int32 sums
    (out_scale 1 and bias 0 make the output float32(acc), exactly); the cut
    models (half away from zero, the K tail dropped) must miss that bar.
    With the scales and the bias, the model equals the plain version bit for
    bit and the JAX kernel within its existing 1e-6: on the CPU the JAX
    kernel fuses the rescale and the bias into one FMA, where the kernel and
    the plain version round twice."""
    x, kq, qmul, scale, bias = _tie_operands(130, k, 136, seed=k)
    assert np.any(np.abs(np.modf(x * qmul)[0]) == 0.5) and np.any(np.abs(x * qmul) > 127)
    rounding = "away" if model == "round_half_away" else "even"

    def jax_out(s, b):
        return np.asarray(jax_w8a8(jnp.asarray(x), jnp.asarray(kq), jnp.asarray(qmul),
                                   jnp.asarray(s), jnp.asarray(b), out_dtype=jnp.float32))

    one, zero = np.ones(136, np.float32), np.zeros(136, np.float32)
    sums = _kernel_model(x, kq, qmul, one, zero, rounding, k_tail=model != "drop_k_tail")
    assert np.array_equal(sums, jax_out(one, zero)) == holds
    if holds:
        got = _kernel_model(x, kq, qmul, scale, bias)
        np.testing.assert_array_equal(got, _port(x, kq, qmul, scale, bias).numpy())
        np.testing.assert_allclose(got, jax_out(scale, bias), rtol=1e-6, atol=1e-6)


def test_fp32_kernel_quantize_is_rint_then_clip():
    """The add of 1.5 * 2^23 gives the integer of rint followed by the clamp
    at every tie from -130.5 to 130.5 and at values between."""
    v = np.arange(-130.5, 131.0, 0.25, dtype=np.float32)
    one = np.ones_like(v)
    want = np.clip(np.rint(v), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(_kernel_quantize(v, one), want)
    assert not np.array_equal(_kernel_quantize(v, one, "away"), want)


@pytest.mark.parametrize("m,k,n,lead,with_bias", [
    (1, 40, 136, (), True), (7, 40, 136, (2, 3), True), (24, 64, 128, (), False)])
def test_plain_version_matches_the_jax_serve_path(m, k, n, lead, with_bias):
    """Shapes the Pallas kernel does not take (M = 1, K = 40, N = 136),
    leading dims and no bias, against the unfused XLA serve path: fp32 out
    within 1e-6, bf16 out within one bf16 step."""
    x, kq, qmul, scale, bias = _operands(m, k, n, seed=2, lead=lead)
    bias = bias if with_bias else None
    want = np.asarray(_xla_serve(jnp.asarray(x), jnp.asarray(kq), jnp.asarray(qmul),
                                 jnp.asarray(scale), None if bias is None else jnp.asarray(bias)))
    ours = _port(x, kq, qmul, scale, bias)
    assert ours.shape == (*lead, m, n) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), want, rtol=1e-6, atol=1e-6)
    t = torch.from_numpy
    bf = qm.w8a8_matmul(t(x), t(np.ascontiguousarray(kq.T)), t(qmul), t(scale),
                        None if bias is None else t(bias), out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert np.all(np.abs(bf.float().numpy() - want) <= _bf16_step(want))


def test_w8a8_matmul_refuses_an_empty_k():
    """K = 0 has no product to take: the wrapper raises on every device
    rather than return the bias alone."""
    x = torch.zeros((4, 0))
    wq = torch.zeros((8, 0), dtype=torch.int8)
    with pytest.raises(ValueError, match="K >= 1"):
        qm.w8a8_matmul(x, wq, torch.zeros(0), torch.ones(8), torch.zeros(8))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_quant_linear_matches_jax_quant_dense(monkeypatch, impl):
    """QuantDense serve mode (both of its routes) and QuantLinear on one
    layer's calibrated artifacts."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 40, 64)).astype(np.float32)
    calib = jquant.QuantDense(128, dtype=jnp.float32, mode="calib")
    params = calib.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = {"kernel": params["kernel"], "bias": jnp.asarray(rng.standard_normal(128) * 0.1)}
    stats = jquant.calibrate(calib, {"params": params}, jnp.asarray(x))
    serve = jquant.QuantDense(128, dtype=jnp.float32, mode="serve")
    q8 = jquant.build_q8(jax.eval_shape(serve.init, jax.random.PRNGKey(0), jnp.asarray(x))["q8"],
                         params, stats)
    monkeypatch.setenv("MDET_W8A8_IMPL", impl)
    want = np.asarray(serve.apply({"params": {"bias": params["bias"]}, "q8": q8}, jnp.asarray(x)))

    layer = tquant.QuantLinear(
        torch.from_numpy(np.ascontiguousarray(np.asarray(q8["kernel_q"]).T)),
        torch.from_numpy(np.array(q8["qmul"])), torch.from_numpy(np.array(q8["out_scale"])),
        torch.from_numpy(np.array(params["bias"], np.float32)), out_dtype=torch.float32)
    ours = layer(torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), want, rtol=1e-5, atol=1e-5)


def test_casting_keeps_quant_linear_scales_fp32():
    layer = tquant.QuantLinear(torch.ones(4, 8, dtype=torch.int8), torch.full((8,), 0.5),
                               torch.full((4,), 0.25), torch.zeros(4), out_dtype=torch.float32)
    model = torch.nn.Sequential(torch.nn.Linear(8, 8), layer).to(torch.bfloat16)
    assert model[0].weight.dtype == layer.out_dtype == torch.bfloat16
    assert layer.weight_q.dtype == torch.int8
    assert layer.qmul.dtype == layer.out_scale.dtype == layer.bias.dtype == torch.float32
    assert float(layer.qmul[0]) == 0.5
    assert model(torch.ones(2, 8, dtype=torch.bfloat16)).dtype == torch.bfloat16
    model.to("meta")  # a move still moves them, fp32
    assert layer.qmul.device.type == "meta" and layer.qmul.dtype == torch.float32
    assert layer.out_dtype == torch.bfloat16
    layer.float()
    assert layer.out_scale.dtype == torch.float32 and layer.out_dtype == torch.float32


def test_model_bundle_quantizes_the_full_precision_weights_and_swaps():
    """quantize_model_bundle on a bf16 model: the int8 weights come from the
    fp32 weights held before the cast, the bias stays fp32, the bf16 weight
    goes with the swapped layer."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.GELU(), torch.nn.Linear(64, 16))
    masters = tquant.full_precision(model, ["0", "2"])
    fp32 = {k: v.clone() for k, v in model.state_dict().items()}
    model = model.to(torch.bfloat16)
    x = torch.randn(3, 5, 32)
    stats = tquant.calibrate(model, ["0", "2"], [x.bfloat16()])
    tquant.quantize_model_bundle(model, masters, [x.bfloat16()])
    for i, path in ((0, "0"), (2, "2")):
        layer = model[i]
        assert isinstance(layer, tquant.QuantLinear) and layer.out_dtype == torch.bfloat16
        want = tquant.build_q8(fp32[f"{path}.weight"], stats[path])
        assert torch.equal(layer.weight_q, want["weight_q"])
        assert torch.equal(layer.bias, fp32[f"{path}.bias"])
    assert not any(p.numel() for p in model.parameters())
    y = model(x.bfloat16())
    assert y.dtype == torch.bfloat16 and y.shape == (3, 5, 16)
