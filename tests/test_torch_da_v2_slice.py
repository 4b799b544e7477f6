"""The torch port's Depth Anything V2 pipeline end to end against the JAX
package's pipeline, on the CPU, fp32: uint8 frame in, depth and turbo viz
out, through ``build_pipeline`` on both sides with one set of weights.

The models are cut to a tiny width. The JAX registry has no width hook, so
a "tiny" encoder entry is put into its preset tables for the test; the port
takes the same overrides through ``model_kw``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monocular_depth_estimation_trt_tpu.models.depth_anything_v2 as jda
import monocular_depth_estimation_trt_tpu.models.vit as jvit
from monocular_depth_estimation_trt_tpu.registry import build_pipeline as jax_build
from monocular_depth_estimation_trt_tpu_torch.ops.colormap import turbo_lut
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import flash_attention as fa
from monocular_depth_estimation_trt_tpu_torch.registry import build_pipeline
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import state_dict_from_jax

from torch_port_params import random_params, rel_err

torch.set_num_threads(1)

DEPTH_REL_TOL = 2e-3  # fp32 on both sides
VIZ_MAX_FRACTION = 0.005  # pixels whose colormap index may differ, by one step

# head_dim 32: the plain attention route on both sides
TINY = dict(vit=dict(dim=64, depth=4, num_heads=2, pretrain_img_size=70),
            head=dict(features=16, out_channels=(8, 16, 32, 32)), taps=(0, 1, 2, 3))
# head_dim 64, 2 heads: the JAX packed Pallas kernel and the port's K1 route
KERNEL = dict(vit=dict(dim=128, depth=2, num_heads=2, pretrain_img_size=70),
              head=dict(features=16, out_channels=(8, 16, 32, 32)), taps=(0, 1, 0, 1))


def _pipelines(monkeypatch, tiny, *, metric=False, input_size=70,
               resize_mode="square", jax_attn="xla", port_attn="xla"):
    cfg = jvit.ViTConfig(**tiny["vit"])
    monkeypatch.setitem(jvit.VIT_CONFIGS, "tiny", cfg)
    monkeypatch.setitem(jda.HEAD_CONFIGS, "tiny", tiny["head"])
    monkeypatch.setitem(jda.INTERMEDIATE_LAYER_IDX, "tiny", tiny["taps"])
    model = jda.DepthAnythingV2(encoder="tiny", metric=metric, dtype=jnp.float32,
                                attn_impl=jax_attn)
    params = random_params(model, jnp.zeros((1, input_size, input_size, 3)), seed=5)
    kw = dict(encoder="tiny", metric=metric, input_size=input_size, precision="fp32",
              resize_mode=resize_mode, params=params)
    jpipe = jax_build("depth_anything_v2", attn_impl=jax_attn, **kw)
    from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig

    kw["params"] = state_dict_from_jax(params)
    tpipe = build_pipeline(
        "depth_anything_v2", attn_impl=port_attn, device="cpu",
        model_kw=dict(vit_config=ViTConfig(**tiny["vit"]), head_features=tiny["head"]["features"],
                      head_out_channels=tiny["head"]["out_channels"], out_indices=tiny["taps"]),
        **kw)
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name()
    return jpipe, tpipe


def _lut_index(viz):
    """uint8 turbo colors -> colormap indices (the LUT's colors are distinct)."""
    lut = (turbo_lut() * 255.0).astype(np.uint8)
    codes = {tuple(c): i for i, c in enumerate(lut)}
    assert len(codes) == 256
    flat = viz.reshape(-1, 3)
    return np.array([codes[tuple(c)] for c in flat]).reshape(viz.shape[:-1])


def _check_viz(ours, ref):
    """Quantization boundaries may fall either way: at most one colormap
    step, on at most VIZ_MAX_FRACTION of the pixels."""
    assert ours.shape == ref.shape and ours.dtype == ref.dtype == np.uint8
    a, b = _lut_index(ours), _lut_index(np.asarray(ref))
    assert np.max(np.abs(a - b)) <= 1
    assert np.mean(a != b) <= VIZ_MAX_FRACTION
    return a


def _frame(rng, hw):
    """Smooth-ish synthetic uint8 frame: a coarse random grid, upsampled."""
    coarse = rng.integers(0, 256, (hw[0] // 8 + 1, hw[1] // 8 + 1, 3))
    img = np.repeat(np.repeat(coarse, 8, axis=0), 8, axis=1)[: hw[0], : hw[1]]
    return np.ascontiguousarray(img.astype(np.uint8))


@pytest.mark.parametrize(
    "hw,metric,resize_mode",
    [((48, 64), False, "square"), ((90, 70), True, "square"),
     ((48, 64), True, "lower_bound"), ((90, 70), False, "lower_bound")],
)
def test_pipeline_matches_jax(monkeypatch, rng, hw, metric, resize_mode):
    """Relative and metric heads, two frame shapes, square and lower-bound
    resizing (lower-bound gives a non-square grid: the pos-embed table is
    interpolated)."""
    jpipe, tpipe = _pipelines(monkeypatch, TINY, metric=metric, resize_mode=resize_mode)
    frame = _frame(rng, hw)
    ref = jpipe(frame, viz=True)
    ours = tpipe(frame, viz=True)
    assert ours["depth"].shape == hw and ours["depth"].dtype == np.float32
    assert rel_err(ours["depth"], ref["depth"]) < DEPTH_REL_TOL
    assert ours["depth"].min() >= 1e-3 and ours["depth"].max() <= 1e3
    _check_viz(ours["viz"], ref["viz"])


def test_batch_call_normalizes_each_frame(monkeypatch, rng):
    jpipe, tpipe = _pipelines(monkeypatch, TINY)
    a = _frame(rng, (48, 64))
    b = (a // 4 + 100).astype(np.uint8)  # another frame with another depth range
    frames = np.stack([a, b])
    ref = jpipe.batch_call(frames, viz=True)
    ours = tpipe.batch_call(frames, viz=True)
    assert ours["depth"].shape == (2, 48, 64) and ours["viz"].shape == (2, 48, 64, 3)
    assert rel_err(ours["depth"], ref["depth"]) < DEPTH_REL_TOL
    idx = _check_viz(ours["viz"], ref["viz"])
    for i, frame in enumerate(frames):
        # each frame spans the whole colormap: min-max over that frame alone
        assert idx[i].min() == 0 and idx[i].max() == 255
        single = tpipe(frame, viz=True)
        assert rel_err(ours["depth"][i], single["depth"]) < 1e-5
        _check_viz(ours["viz"][i], single["viz"])


def test_kernel_route_matches_jax_packed_kernel(monkeypatch, rng):
    """The default attention route at head_dim 64: 448^2 gives 32^2 + 1 =
    1025 tokens, inside the JAX packed kernel's gate, so every JAX block runs
    the Pallas kernel (interpret mode) and every port block goes through
    K1's wrapper (its plain version on the CPU, no launch counted)."""
    jpipe, tpipe = _pipelines(monkeypatch, KERNEL, input_size=448,
                              jax_attn="packed", port_attn="auto")
    frame = _frame(rng, (60, 80))
    ref = jpipe(frame)
    before = fa.flash_attention_packed.launches
    ours = tpipe(frame)
    assert fa.flash_attention_packed.launches == before
    assert rel_err(ours["depth"], ref["depth"]) < DEPTH_REL_TOL


def test_default_route_reaches_k1_wrapper(monkeypatch, rng):
    """Without ``attn_impl`` the port sends every block's attention to the
    K1 wrapper (ViT-S included), never to plain attention."""
    _, tpipe = _pipelines(monkeypatch, KERNEL, port_attn="auto")
    calls = []
    real = fa.flash_attention_packed

    def spy(qkv, num_heads, scale=None):
        calls.append(tuple(qkv.shape))
        return real(qkv, num_heads, scale)

    import monocular_depth_estimation_trt_tpu_torch.models.vit as tvit

    monkeypatch.setattr(tvit, "flash_attention_packed", spy)
    monkeypatch.setattr(tvit, "attention_reference", None)  # must not be reached
    tpipe(_frame(rng, (48, 64)))
    assert calls == [(1, 26, 3 * 128)] * KERNEL["vit"]["depth"]
