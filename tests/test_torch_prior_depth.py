"""The torch port's Prior Depth Anything against the JAX package's, on the
CPU, fp32, one set of seeded weights on both sides (``torch_port_params``
and ``weights/from_jax.py``):

* ``scale_shift_align`` (against JAX, and recovering a known affine map);
* ``PriorDARefiner`` (the frozen MDE, the weighted alignment and blend, the
  6-channel conditioned stack) at ``tests/test_parity_prior.py``'s tiny
  config (dim 64, depth 4, 2 heads, DPT 16 / (8, 16, 32, 32)), the JAX side
  under ``jax.jit`` with its plain attention;
* the full-size key sets: the refiner against
  ``weights/manifests/prior_depth_anything_vits.json``, the depth-only VGGT
  against ``vggt.json`` without its camera head; ``state_dict_from_jax`` on
  the refiner's tree and on the pipeline's ``{"vggt", "refiner"}``; the
  JAX artifact names;
* the ``prior_depth_anything`` pipeline against the JAX pipeline with a
  tiny VGGT (``tests/test_torch_vggt_slice.py``'s head_dim-64 config, so
  that the port takes K1's and K2's wrappers, their plain versions on the
  CPU) at a frame that is not square (the pad-square crop).

Readings on a CPU: rel errors below 1e-4 (bar 2e-3).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu import registry as jreg
from monocular_depth_estimation_trt_tpu.models import prior_depth as jpd
from monocular_depth_estimation_trt_tpu.models import vggt as jvggt
from monocular_depth_estimation_trt_tpu.models import vit as jvit
from monocular_depth_estimation_trt_tpu_torch import registry as treg
from monocular_depth_estimation_trt_tpu_torch.models import prior_depth as tpd
from monocular_depth_estimation_trt_tpu_torch.models import vggt as tvggt
from monocular_depth_estimation_trt_tpu_torch.models import vit as tvit
from monocular_depth_estimation_trt_tpu_torch.weights import store
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import (
    prior_depth_anything_from_jax,
    prior_refiner_from_jax,
    state_dict_from_jax,
    vggt_from_jax,
)

from test_torch_geometric import MANIFESTS
from torch_port_params import random_params, rel_err

torch.set_num_threads(1)

REL_TOL = 2e-3  # fp32 on both sides
VIT = dict(dim=64, depth=4, num_heads=2, pretrain_img_size=70)
HEAD = dict(head_features=16, head_out_channels=(8, 16, 32, 32), out_indices=(0, 1, 2, 3))
SIDE = 70
# the VGGT of tests/test_torch_vggt_slice.py: head_dim 64 in the patch
# embed and the aggregator
VGGT_VIT = dict(dim=128, depth=1, num_heads=2, pretrain_img_size=SIDE)
VGGT = dict(dim=128, depth=2, num_heads=2, head_layers=(0, 1, 0, 1), encoder="vits",
            head_features=16, head_out_channels=(8, 16, 32, 32))


def _jax_kw():
    return dict(vit_config=jvit.ViTConfig(**VIT), **HEAD)


def _port_kw():
    return dict(vit_config=tvit.ViTConfig(**VIT), **HEAD)


def _inputs(seed=3, hw=(SIDE, SIDE)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, *hw, 3)).astype(np.float32),
            rng.uniform(0.5, 5.0, (1, *hw)).astype(np.float32),
            rng.uniform(0.0, 2.0, (1, *hw)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _refiner():
    jm = jpd.PriorDARefiner(dtype=jnp.float32, attn_impl="xla", **_jax_kw())
    args = tuple(jnp.asarray(a) for a in _inputs())
    params = random_params(jm, *args, seed=11)
    out = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(params, *args)
    return params, np.asarray(out)


# --- the alignment and the refiner --------------------------------------------


def test_scale_shift_align_matches_jax_and_recovers_an_affine_map():
    rng = np.random.default_rng(0)
    pred = rng.uniform(0.1, 2.0, (2, 10, 12)).astype(np.float32)
    w = rng.uniform(0.5, 1.0, pred.shape).astype(np.float32)
    s, t = tpd.scale_shift_align(*(torch.from_numpy(a) for a in (pred, 3.5 * pred + 0.7, w)))
    np.testing.assert_allclose(s.numpy(), [3.5, 3.5], rtol=1e-4)
    np.testing.assert_allclose(t.numpy(), [0.7, 0.7], rtol=1e-3)
    prior = rng.uniform(0.5, 5.0, pred.shape).astype(np.float32)
    ref = jpd.scale_shift_align(*(jnp.asarray(a) for a in (pred, prior, w)))
    ours = tpd.scale_shift_align(*(torch.from_numpy(a) for a in (pred, prior, w)))
    for a, b in zip(ours, ref):
        assert a.shape == (2,) and rel_err(a.numpy(), np.asarray(b)) < REL_TOL
    # a constant prediction: the determinant is 0, as in the JAX function
    flat = np.ones_like(pred)
    ref = jpd.scale_shift_align(*(jnp.asarray(a) for a in (flat, prior, w)))
    ours = tpd.scale_shift_align(*(torch.from_numpy(a) for a in (flat, prior, w)))
    for a, b in zip(ours, ref):
        assert rel_err(a.numpy(), np.asarray(b)) < REL_TOL


def test_refiner_matches_jax():
    params, ref = _refiner()
    model = tpd.PriorDARefiner("tiny", "xla", **_port_kw())
    model.load_state_dict(prior_refiner_from_jax(params), strict=True)
    assert model.cond.patch_embed.proj.weight.shape == (64, 6, 14, 14)
    assert sorted(state_dict_from_jax(params)) == sorted(model.state_dict())
    with torch.no_grad():
        ours = model.eval()(*(torch.from_numpy(a) for a in _inputs()))
    assert ours.shape == ref.shape == (1, SIDE, SIDE) and ours.dtype == torch.float32
    assert rel_err(ours.numpy(), ref) < REL_TOL
    assert (ours > 0).all()


def test_full_size_keys_equal_the_manifests():
    with open(os.path.join(MANIFESTS, "prior_depth_anything_vits.json")) as f:
        refiner = json.load(f)["keys"]
    with open(os.path.join(MANIFESTS, "vggt.json")) as f:
        vggt = {k: v for k, v in json.load(f)["keys"].items()
                if not k.startswith("camera_head.")}
    with torch.device("meta"):
        model = tpd.PriorDepthAnything(tvggt.VGGT(with_camera=False), tpd.PriorDARefiner())
    for sub, manifest in ((model.refiner, refiner), (model.vggt, vggt)):
        assert {k: list(v.shape) for k, v in sub.state_dict().items()} == manifest


def test_full_size_builds_with_the_jax_artifact_names(monkeypatch):
    """On the meta device, no weights; int8 raises on both sides."""
    from monocular_depth_estimation_trt_tpu.weights import store as jstore

    names = []
    monkeypatch.setattr(jstore, "get_or_convert_params",
                        lambda name, *a, **k: names.append(name) or {})
    monkeypatch.setattr(store, "resolve_weights", lambda model, name, **k: names.append(name))
    jpipe = jreg.build_pipeline("prior_depth_anything")
    with torch.device("meta"):  # VGGT's 1.2 B parameters, not made on the CPU
        tpipe = treg.build_pipeline("prior_depth_anything", device="meta")
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name() \
        == "prior_depth_anything_vits_518x518_metric_bf16"
    assert tpipe.viz == jpipe.viz == "metric"
    # the weights' names: the depth-only VGGT's and the refiner's, in both
    assert names[:2] == names[2:] == ["vggt_518x518_metric_bf16_depthonly",
                                      "prior_depth_anything_vits_518x518_metric_bf16_refiner"]
    assert not hasattr(tpipe.model.vggt, "camera_head")
    with pytest.raises(ValueError, match="int8"):
        treg.build_pipeline("prior_depth_anything", device="meta", precision="int8")


# --- the pipeline --------------------------------------------------------------


@pytest.fixture(scope="module")
def pipes():
    jcfg = jvggt.VGGTConfig(vit_config=jvit.ViTConfig(**VGGT_VIT), **VGGT)
    jv = jvggt.VGGT(cfg=jcfg, dtype=jnp.float32, attn_impl="xla", with_camera=False)
    params = {"vggt": random_params(jv, jnp.zeros((1, 1, SIDE, SIDE, 3)), seed=13),
              "refiner": _refiner()[0]}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvggt, "VGGTConfig", lambda: jcfg)
        mp.setattr(jpd, "PriorDARefiner", functools.partial(jpd.PriorDARefiner, **_jax_kw()))
        kw = dict(encoder="tiny", input_size=SIDE, precision="fp32", attn_impl="xla")
        jpipe = jreg.build_pipeline("prior_depth_anything", params=params, **kw)
    ported = state_dict_from_jax(params)
    assert ported.keys() == {"vggt", "refiner"}
    assert sorted(ported["vggt"]) == sorted(vggt_from_jax(params["vggt"]))
    tpipe = treg.build_pipeline(
        "prior_depth_anything", params=prior_depth_anything_from_jax(params), device="cpu",
        vggt_cfg=tvggt.VGGTConfig(vit_config=tvit.ViTConfig(**VGGT_VIT), **VGGT),
        model_kw=_port_kw(), encoder="tiny", input_size=SIDE, precision="fp32")
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name()
    return jpipe, tpipe


@pytest.mark.parametrize("hw", [(48, 64), (64, 40)])
def test_prior_depth_pipeline_matches_jax(pipes, hw):
    """VGGT's depth and confidence refined in one forward; the pad-square
    crop for frames of either orientation."""
    jpipe, tpipe = pipes
    frame = np.random.default_rng(hw[1]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    ref, ours = jpipe(frame, viz=True), tpipe(frame, viz=True)
    assert sorted(ours) == sorted(ref) == ["confidence", "depth", "depth_vggt", "viz"]
    for key in ("depth", "depth_vggt", "confidence"):
        assert ours[key].shape == hw and ours[key].dtype == np.float32, key
        assert rel_err(ours[key], ref[key]) < REL_TOL, key
    assert ours["depth"].min() >= 1e-3 and ours["depth"].max() <= 1e3
    assert ours["viz"].shape == (*hw, 3)
