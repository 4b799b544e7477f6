"""The torch port's ``depth_pro`` pipeline end to end against the JAX
package's ``registry.depth_pro`` on the CPU, fp32, with one set of weights:
uint8 frames in; metric depth, the focal estimate and viz out.

The geometry is the real one (1536 input, 384 windows, 25 + 9 + 1 views of
577 tokens); the model is narrow (ViT dim 128, 8 heads, 3 blocks, hooks 0
and 1, decoder width 16), so that the port's patch encoder takes K3's route
(35 x 8 heads of 577 tokens), its plain version here. The JAX registry
builds its model by name, so the test swaps the narrow ``DepthPro`` in
there; the JAX side runs its plain attention.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu import registry as jreg
from monocular_depth_estimation_trt_tpu.models import depth_pro as jdp
from monocular_depth_estimation_trt_tpu.models.vit import ViTConfig as JViTConfig
from monocular_depth_estimation_trt_tpu_torch.models import depth_pro as tdp
from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig as TViTConfig
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import flash_attention as fa
from monocular_depth_estimation_trt_tpu_torch.registry import build_pipeline
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import depth_pro_from_jax

from torch_port_params import lift_depth_pro_outputs, random_params, rel_err

torch.set_num_threads(1)

REL_TOL = 2e-3  # fp32 on both sides
VIT = dict(dim=128, depth=3, num_heads=8, patch_size=16, pretrain_img_size=384)
HEAD = dict(decoder_features=16, dims_encoder=(8, 16, 32, 32))


@pytest.fixture(scope="module")
def pipes():
    jcfg = jdp.DepthProConfig(vit_config=JViTConfig(**VIT), hook_block_ids=(0, 1))
    narrow = functools.partial(jdp.DepthPro, cfg=jcfg, **HEAD)
    params = random_params(narrow(dtype=jnp.float32, attn_impl="xla"),
                           jnp.zeros((1, 1536, 1536, 3)), seed=23)
    lift_depth_pro_outputs(params)
    with pytest.MonkeyPatch.context() as mp:  # the JAX registry builds DepthPro by name
        mp.setattr(jdp, "DepthPro", narrow)
        jpipe = jreg.build_pipeline("depth_pro", precision="fp32", attn_impl="xla",
                                    params=params)
    tcfg = tdp.DepthProConfig(vit_config=TViTConfig(**VIT), hook_block_ids=(0, 1))
    tpipe = build_pipeline("depth_pro", precision="fp32", device="cpu",
                           params=depth_pro_from_jax(params), model_kw=dict(cfg=tcfg, **HEAD))
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name() == "depth_pro_1536x1536_fp32"
    assert tpipe.viz == jpipe.viz == "metric"
    return jpipe, tpipe


@pytest.mark.parametrize("hw", [(480, 640), (1536, 1536)])
def test_depth_pro_pipeline_matches_jax(pipes, monkeypatch, hw):
    jpipe, tpipe = pipes
    frame = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    ref = jpipe(frame, viz=True)
    shapes = []
    plain = fa.flash_attention_batched

    def spy(q, k, v, scale=None):
        shapes.append(tuple(q.shape))
        return plain(q, k, v, scale)

    monkeypatch.setattr("monocular_depth_estimation_trt_tpu_torch.models.vit."
                        "flash_attention_batched", spy)
    launches = fa.flash_attention_batched.launches
    ours = tpipe(frame, viz=True)
    assert shapes == [(35, 8, 577, 16)] * 3  # the patch encoder, one call per block
    assert fa.flash_attention_batched.launches == launches  # CPU: the plain version
    assert sorted(ours) == sorted(ref) == ["depth", "f_px", "viz"]
    d = ours["depth"]
    assert d.shape == hw and d.dtype == np.float32
    assert d.min() >= 1e-4 and d.max() <= 1e4
    assert np.mean(d == 1e4) < 0.01  # nearly every pixel counts
    # the inverse depth, which the model predicts: a clipped pixel's 1e4
    # would set the scale of a relative error of the depth itself
    assert rel_err(1.0 / d, 1.0 / ref["depth"]) < REL_TOL
    assert ours["f_px"].shape == () and ours["f_px"].dtype == np.float32
    np.testing.assert_allclose(ours["f_px"], ref["f_px"], rtol=REL_TOL)
    assert ours["viz"].shape == (*hw, 3) and ours["viz"].dtype == np.uint8
    # colormap quantization may fall either way at a few pixels
    assert np.mean(np.any(ours["viz"] != np.asarray(ref["viz"]), axis=-1)) < 0.01


def test_depth_pro_takes_the_callers_focal_and_one_frame_at_a_time(pipes):
    _, tpipe = pipes
    frame = np.random.default_rng(3).integers(0, 256, (240, 320, 3), dtype=np.uint8)
    out = tpipe(frame)
    fixed = build_pipeline("depth_pro", precision="fp32", device="cpu", f_px=2.0 * out["f_px"],
                           params=tpipe.model.state_dict(),
                           model_kw=dict(cfg=tpipe.model.cfg, **HEAD))(frame)
    assert float(fixed["f_px"]) == pytest.approx(2.0 * float(out["f_px"]), rel=1e-6)
    # depth = f / (W * cid): twice the focal, twice the depth
    assert rel_err(fixed["depth"], 2.0 * out["depth"]) < 1e-5
    with pytest.raises(ValueError, match="one"):
        tpipe.batch_call(np.stack([frame, frame]))
