"""The port's five optical-flow models (``models/flow/``) against the JAX
package's on the CPU, fp32, one set of seeded weights carried across by
``weights/from_jax.py``: RAFT, NeuFlow, MeFlow, MEMFOF (and its feature
cache) and WAFT, at 64x96 (WAFT 56x84) and 2 refinement steps. WAFT's
backbone is a ViT of dim 128 with 2 heads (head_dim 64), so that its
attention takes K1's route (the kernel's plain version on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu.models import vit as jvit
from monocular_depth_estimation_trt_tpu.models.flow import meflow as jmeflow
from monocular_depth_estimation_trt_tpu.models.flow import memfof as jmemfof
from monocular_depth_estimation_trt_tpu.models.flow import neuflow as jneuflow
from monocular_depth_estimation_trt_tpu.models.flow import raft as jraft
from monocular_depth_estimation_trt_tpu.models.flow import waft as jwaft
from monocular_depth_estimation_trt_tpu_torch.models import vit as tvit
from monocular_depth_estimation_trt_tpu_torch.models.flow import meflow as tmeflow
from monocular_depth_estimation_trt_tpu_torch.models.flow import memfof as tmemfof
from monocular_depth_estimation_trt_tpu_torch.models.flow import neuflow as tneuflow
from monocular_depth_estimation_trt_tpu_torch.models.flow import raft as traft
from monocular_depth_estimation_trt_tpu_torch.models.flow import waft as twaft
from monocular_depth_estimation_trt_tpu_torch.weights import from_jax

from torch_port_params import random_params, rel_err

torch.set_num_threads(1)

REL_TOL = 2e-3  # fp32 on both sides, of max |flow|
ITERS = 2
HW = (64, 96)
WAFT_HW = (56, 84)
WAFT_VIT = dict(dim=128, depth=2, num_heads=2, pretrain_img_size=70)


def _frames(shape, seed):
    return np.random.default_rng(seed).integers(0, 255, shape).astype(np.float32)


FAMILIES = {
    # name: (JAX model, port model, from_jax, inputs)
    "raft": (lambda: jraft.RAFT(iters=ITERS), lambda: traft.RAFT(iters=ITERS),
             from_jax.raft_from_jax, lambda: (_frames((1, *HW, 3), 0), _frames((1, *HW, 3), 1))),
    "neuflow": (lambda: jneuflow.NeuFlow(refine_iters_16=ITERS, refine_iters_8=ITERS),
                lambda: tneuflow.NeuFlow(refine_iters_16=ITERS, refine_iters_8=ITERS),
                from_jax.neuflow_from_jax,
                lambda: (_frames((1, *HW, 3), 2), _frames((1, *HW, 3), 3))),
    "meflow": (lambda: jmeflow.MeFlow(iters=ITERS), lambda: tmeflow.MeFlow(iters=ITERS),
               from_jax.meflow_from_jax,
               lambda: (_frames((1, *HW, 3), 4), _frames((1, *HW, 3), 5))),
    "memfof": (lambda: jmemfof.MEMFOF(iters=ITERS), lambda: tmemfof.MEMFOF(iters=ITERS),
               from_jax.memfof_from_jax, lambda: (_frames((1, 3, *HW, 3), 6),)),
    "waft": (lambda: jwaft.WAFT(iters=ITERS, vit_config=jvit.ViTConfig(**WAFT_VIT),
                                attn_impl="xla"),
             lambda: twaft.WAFT(iters=ITERS, vit_config=tvit.ViTConfig(**WAFT_VIT)),
             from_jax.waft_from_jax,
             lambda: (_frames((1, *WAFT_HW, 3), 7), _frames((1, *WAFT_HW, 3), 8))),
}


@pytest.fixture(scope="module")
def models():
    """name -> (JAX model, JAX params, the port's model on those weights)."""
    out = {}
    for i, (name, (jmake, tmake, convert, inputs)) in enumerate(FAMILIES.items()):
        jm = jmake()
        params = random_params(jm, *(jnp.asarray(x) for x in inputs()), seed=20 + i)
        tm = tmake()
        tm.load_state_dict(convert(params), strict=True)
        out[name] = (jm, params, tm.eval())
    return out


def _both(models, name, *args, **kw):
    jm, params, tm = models[name]
    ref = jax.jit(jm.apply)({"params": params}, *(jnp.asarray(a) for a in args), **kw)
    with torch.no_grad():
        ours = tm(*(torch.from_numpy(a) for a in args))
    return ours, ref


@pytest.mark.parametrize("name", ["raft", "meflow", "waft"])
def test_pair_models_match_jax_on_flow_and_flow_low(models, name):
    inputs = FAMILIES[name][3]()
    (low, up), (jlow, jup) = _both(models, name, *inputs)
    h, w = inputs[0].shape[1:3]
    stride = 7 if name == "waft" else 8
    assert tuple(up.shape) == jup.shape == (1, h, w, 2)
    assert tuple(low.shape) == jlow.shape == (1, h // stride, w // stride, 2)
    assert up.dtype == low.dtype == torch.float32
    assert rel_err(up.numpy(), jup) < REL_TOL
    assert rel_err(low.numpy(), jlow) < REL_TOL
    assert float(up.abs().max()) > 1e-3  # random weights move the flow


def test_neuflow_matches_jax(models):
    flow, ref = _both(models, "neuflow", *FAMILIES["neuflow"][3]())
    assert tuple(flow.shape) == ref.shape == (1, *HW, 2)
    assert rel_err(flow.numpy(), ref) < REL_TOL


def test_memfof_matches_jax_and_its_cache(models):
    """The triplet's bidirectional flow and uncertainty against JAX; the
    returned feature maps (against JAX's) fed back as the cache give the
    same flow, all three or the first two (the video step)."""
    (frames,) = FAMILIES["memfof"][3]()
    ours, ref = _both(models, "memfof", frames)
    assert tuple(ours["flow"].shape) == ref["flow"].shape == (1, 2, *HW, 2)
    assert tuple(ours["info"].shape) == ref["info"].shape == (1, 2, *HW, 4)
    assert rel_err(ours["flow"].numpy(), ref["flow"]) < REL_TOL
    assert rel_err(ours["info"].numpy(), ref["info"]) < REL_TOL
    cache = ours["fmap_cache"]
    assert [tuple(c.shape) for c in cache] == [(1, 256, HW[0] // 16, HW[1] // 16)] * 3
    for c, jc in zip(cache, ref["fmap_cache"]):
        assert rel_err(c.permute(0, 2, 3, 1).numpy(), jc) < REL_TOL
    _, _, tm = models["memfof"]
    with torch.no_grad():
        again = tm(torch.from_numpy(frames), fmap_cache=cache)
        step = tm(torch.from_numpy(frames), fmap_cache=(cache[0], cache[1], None))
    torch.testing.assert_close(again["flow"], ours["flow"], rtol=0, atol=0)
    torch.testing.assert_close(step["flow"], ours["flow"], rtol=1e-5, atol=1e-5)


def test_waft_attention_takes_k1_and_equals_the_plain_route(models, monkeypatch):
    """At head_dim 64 WAFT's ViT attention goes through K1's wrapper (on
    the CPU its plain version): one call a block over both frames at once
    (batch 2); the plain route (``attn_impl="xla"``) gives the same flow."""
    _, _, tm = models["waft"]
    calls = []
    packed = tvit.flash_attention_packed

    def counted(qkv, heads):
        calls.append((tuple(qkv.shape), heads))
        return packed(qkv, heads)

    monkeypatch.setattr(tvit, "flash_attention_packed", counted)
    a, b = (torch.from_numpy(x) for x in FAMILIES["waft"][3]())
    n = (WAFT_HW[0] // 14) * (WAFT_HW[1] // 14) + 1
    with torch.no_grad():
        _, up = tm(a, b)
        assert calls == [((2, n, 3 * 128), 2)] * WAFT_VIT["depth"]
        for blk in tm.pretrained.blocks:
            blk.attn.attn_impl = "xla"
        try:
            _, plain = tm(a, b)
        finally:
            for blk in tm.pretrained.blocks:
                blk.attn.attn_impl = "auto"
    assert len(calls) == WAFT_VIT["depth"]
    assert rel_err(up.numpy(), plain.numpy()) < 1e-5


def test_meflow_use_scan_is_the_same_model():
    """``use_scan`` is an artifact key: the same modules, the same loop."""
    with torch.device("meta"):
        a, b = tmeflow.MeFlow(use_scan=False), tmeflow.MeFlow(use_scan=True)
    assert {k: v.shape for k, v in a.state_dict().items()} == \
        {k: v.shape for k, v in b.state_dict().items()}
