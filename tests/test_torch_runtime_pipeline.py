"""The port's ``runtime/pipeline.py`` (``Stage``, ``DevicePipeline``,
``fused``) and ``models/vggt.py::build_stage_pipeline``, the reference's
three-engine VGGT chain, against the joint model and the JAX package's
stage pipeline on the CPU, fp32 (the tiny VGGT of ``tests/test_torch_vggt.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu.models import vggt as jvggt
from monocular_depth_estimation_trt_tpu.models.vit import ViTConfig as JViTConfig
from monocular_depth_estimation_trt_tpu_torch.models import vggt as tvggt
from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig as TViTConfig
from monocular_depth_estimation_trt_tpu_torch.runtime.pipeline import DevicePipeline, Stage
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import vggt_from_jax

from torch_port_params import random_params, rel_err

torch.set_num_threads(1)

REL_TOL = 2e-3
SIZE = 70
VIT = dict(dim=48, depth=2, num_heads=2, pretrain_img_size=SIZE)
COMMON = dict(dim=64, depth=2, num_heads=4, head_layers=(0, 1, 0, 1), encoder="vits",
              head_features=16, head_out_channels=(8, 16, 32, 32))


def _chain():
    return DevicePipeline([
        Stage("agg", lambda x: x + 1.0, ["images"], ["tokens"]),
        Stage("depth", lambda t: (t * 2.0, t * 3.0), ["tokens"], ["depth", "conf"]),
        Stage("camera", lambda t: t - 1.0, ["tokens"], ["pose"]),
    ])


def test_device_pipeline_chaining():
    """The aggregator -> heads pattern, staged and fused."""
    pipe = _chain()
    out = pipe({"images": torch.ones(2, 2)})
    assert torch.equal(out["depth"], torch.full((2, 2), 4.0))
    assert torch.equal(out["conf"], torch.full((2, 2), 6.0))
    assert torch.equal(out["pose"], torch.ones(2, 2))
    fused = pipe.fused(["depth", "pose"])({"images": torch.ones(2, 2)})
    assert sorted(fused) == ["depth", "pose"] and torch.equal(fused["depth"], out["depth"])
    bad = DevicePipeline([Stage("agg", lambda x: (x, x), ["images"], ["tokens"])])
    with pytest.raises(ValueError, match="returned 2 outputs, declared 1"):
        bad({"images": torch.ones(1)})


def test_device_pipeline_builds_one_engine_per_stage_and_signature():
    """Each stage its own engine per input signature: a repeated signature
    reuses it, a new one builds one more per stage; release frees them."""
    pipe = _chain()
    for _ in range(2):
        pipe({"images": torch.ones(2, 2)})
    assert sorted(name for name, _ in pipe._engines) == ["agg", "camera", "depth"]
    out = pipe({"images": torch.zeros(3, 5)})
    assert len(pipe._engines) == 6 and torch.equal(out["pose"], torch.full((3, 5), 0.0))
    pipe.release_engines()
    assert not pipe._engines


def test_vggt_stage_pipeline_equals_the_joint_model_and_jax():
    jcfg = jvggt.VGGTConfig(vit_config=JViTConfig(**VIT), **COMMON)
    jm = jvggt.VGGT(cfg=jcfg, dtype=jnp.float32, attn_impl="xla", with_camera=True)
    views = np.random.default_rng(3).standard_normal((1, 2, SIZE, SIZE, 3)).astype(np.float32)
    params = random_params(jm, jnp.asarray(views), seed=17)
    tm = tvggt.VGGT(tvggt.VGGTConfig(vit_config=TViTConfig(**VIT), **COMMON), attn_impl="flash")
    tm.load_state_dict(vggt_from_jax(params), strict=True)
    tm.eval()
    x = torch.from_numpy(views)
    pipe = tvggt.build_stage_pipeline(tm)
    out = pipe({"views": x})
    assert out["tokens"].shape == (4, 1, 2, 1 + 4 + 25, 128)
    with torch.no_grad():
        joint = tm(x)
    ref = jvggt.build_stage_pipeline(params, jcfg, dtype=jnp.float32, attn_impl="xla")(
        {"views": jnp.asarray(views)})
    for k in ("depth", "depth_conf", "pose_enc"):
        assert torch.equal(out[k], joint[k]), k
        assert rel_err(out[k].numpy(), np.asarray(jax.device_get(ref[k]))) < REL_TOL, k
    assert sorted(name for name, _ in pipe._engines) == ["aggregator", "camera_head", "depth_head"]
    fused = pipe.fused(["depth", "pose_enc"])
    with torch.no_grad():
        one = fused({"views": x})
    assert torch.equal(one["depth"], joint["depth"])
