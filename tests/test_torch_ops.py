"""Main-path ops of the torch port against the JAX package's functions, fp32,
random inputs: resize, preprocess, postprocess, colormap."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monocular_depth_estimation_trt_tpu.ops import colormap as jcm
from monocular_depth_estimation_trt_tpu.ops import postprocess as jpost
from monocular_depth_estimation_trt_tpu.ops import preprocess as jpre
from monocular_depth_estimation_trt_tpu_torch.ops import colormap as tcm
from monocular_depth_estimation_trt_tpu_torch.ops import postprocess as tpost
from monocular_depth_estimation_trt_tpu_torch.ops import preprocess as tpre
from monocular_depth_estimation_trt_tpu_torch.ops import resize as trs

# the JAX ops package re-exports a function named ``resize`` over the module
jrs = importlib.import_module("monocular_depth_estimation_trt_tpu.ops.resize")


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err = np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6)
    assert err < tol, f"rel err {err:.2e}"


@pytest.mark.parametrize(
    "args",
    [
        (37, 74, "cubic", False, False),
        (37, 5, "cubic", False, False),
        (518, 480, "linear", False, False),
        (37, 518, "linear", True, False),
        (1, 7, "linear", True, False),
        (7, 1, "linear", True, False),
        (100, 30, "cubic", False, True),
        (100, 30, "linear", False, True),
        (10, 7, "nearest", False, False),
        (12, 12, "linear", False, False),
        (12, 12, "linear", True, False),
    ],
)
def test_resample_matrix_bit_equal(args):
    ours = trs.resample_matrix(*args)
    ref = jrs.resample_matrix(*args)
    assert ours.dtype == ref.dtype == np.float32
    assert np.array_equal(ours, ref)


@pytest.mark.parametrize("method,align", [("linear", False), ("cubic", False),
                                          ("linear", True)])
@pytest.mark.parametrize("out_hw", [(37, 45), (9, 13)])
def test_resize_matches_jax(rng, method, align, out_hw):
    x = rng.standard_normal((2, 20, 30, 3)).astype(np.float32)
    ref = jrs.resize(jnp.asarray(x), out_hw, method=method, align_corners=align)
    ours = trs.resize(torch.from_numpy(x), out_hw, method=method, align_corners=align)
    _close(ours.numpy(), ref)


def test_resize_hw_and_identity(rng):
    x = rng.standard_normal((3, 17, 11)).astype(np.float32)
    _close(trs.resize_hw(torch.from_numpy(x), (40, 9)).numpy(),
           jrs.resize_hw(jnp.asarray(x), (40, 9)))
    t = torch.from_numpy(x[..., None])
    assert trs.resize(t, (17, 11), method="linear") is t


@pytest.mark.parametrize("hw,target", [((480, 640), 518), ((640, 480), 518),
                                       ((100, 333), 70), ((518, 518), 518)])
def test_lower_bound_sizing_matches_jax(hw, target):
    assert trs.lower_bound_size(*hw, target) == jrs.lower_bound_size(*hw, target)
    for x in (13.0, 500.4, 517.9, 7.0):
        for kw in ({}, {"min_val": 14}, {"max_val": 490}):
            assert (trs.constrain_to_multiple_of(x, **kw)
                    == jrs.constrain_to_multiple_of(x, **kw))


def test_to_float_rgb_and_normalize(rng):
    img = rng.integers(0, 256, (2, 9, 7, 3), dtype=np.uint8)
    for bgr in (False, True):
        _close(tpre.to_float_rgb(torch.from_numpy(img), bgr=bgr).numpy(),
               jpre.to_float_rgb(jnp.asarray(img), bgr=bgr), 1e-7)
    x = rng.random((9, 7, 3)).astype(np.float32)
    _close(tpre.normalize(torch.from_numpy(x)).numpy(),
           jpre.normalize(jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("hw", [(60, 80), (45, 28)])
def test_preprocess_lower_bound_matches_jax(rng, hw):
    img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    ref = jpre.preprocess_lower_bound(jnp.asarray(img), target=42)
    ours = tpre.preprocess_lower_bound(torch.from_numpy(img), target=42)
    assert ours.shape == ref.shape and ours.shape[0] == 1
    _close(ours.numpy(), ref)


@pytest.mark.parametrize("clamp", [(1e-3, 1e3), None])
def test_upsample_depth_matches_jax(rng, clamp):
    d = (rng.standard_normal((2, 37, 37)) * 3).astype(np.float32)
    ref = jpost.upsample_depth(jnp.asarray(d), (48, 64), clamp=clamp)
    ours = tpost.upsample_depth(torch.from_numpy(d), (48, 64), clamp=clamp)
    _close(ours.numpy(), ref)


@pytest.mark.parametrize("fn", ["normalize_depth_for_viz", "inverse_depth_normalize"])
def test_viz_normalizations_per_frame(rng, fn):
    d = (rng.random((3, 20, 24)) * 50 + 0.01).astype(np.float32)
    d[1] *= 7.0  # frames with different ranges
    jfn, tfn = getattr(jpost, fn), getattr(tpost, fn)
    ours = tfn(torch.from_numpy(d)).numpy()
    # the JAX batch program vmaps the per-frame epilogue
    _close(ours, jax.vmap(jfn)(jnp.asarray(d)), 1e-6)
    _close(ours[1], jfn(jnp.asarray(d[1])), 1e-6)


def test_quantile_normalize_and_crop_pad(rng):
    v = rng.standard_normal((30, 40)).astype(np.float32)
    _close(tpost.quantile_normalize(torch.from_numpy(v)).numpy(),
           jpost.quantile_normalize(jnp.asarray(v)), 1e-5)
    for pad in ((1, 2, 3, 4), (0, 0, 5, 0), (2, 0, 0, 1)):
        assert np.array_equal(tpost.crop_pad(torch.from_numpy(v), pad).numpy(),
                              np.asarray(jpost.crop_pad(jnp.asarray(v), pad)))


def test_turbo_lut_equals_matplotlib_table():
    pytest.importorskip("matplotlib")
    assert np.array_equal(tcm.turbo_lut(), jcm.turbo_lut())


def test_turbo_colormap_matches_jax(rng):
    x = rng.uniform(-0.1, 1.1, (33, 40)).astype(np.float32)
    x[0, :4] = [0.0, 1.0, 1.0 / 255.0, 254.999 / 255.0]  # quantization edges
    jax_rgb = np.asarray(jnp.asarray(tcm.turbo_lut())[
        np.clip(x * 255.0, 0, 255).astype(np.uint8).astype(np.int32)] * 255.0
    ).astype(np.uint8)
    ours = tcm.turbo_colormap(torch.from_numpy(x)).numpy()
    assert ours.dtype == np.uint8 and ours.shape == (33, 40, 3)
    assert np.array_equal(ours, jax_rgb)
    ours_f = tcm.turbo_colormap(torch.from_numpy(x), as_uint8=False).numpy()
    if np.array_equal(tcm.turbo_lut(), jcm.turbo_lut()):
        assert np.array_equal(ours, np.asarray(jcm.turbo_colormap(jnp.asarray(x))))
        _close(ours_f, jcm.turbo_colormap(jnp.asarray(x), as_uint8=False), 1e-7)
