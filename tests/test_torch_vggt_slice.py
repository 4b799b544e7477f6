"""The torch port's ``vggt`` pipeline end to end against the JAX package's
``registry._build_vggt`` on the CPU, fp32, with one set of weights: uint8
frames in; depth, confidence, camera and viz out.

The model is cut to head_dim 64 (ViT and aggregator dim 128, 2 heads) at a
70² input, so that the port takes its default route: K1's plain version in
the patch embed, K2's in the aggregator. The JAX side runs its plain
attention, as it does on any backend other than a TPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu import registry as jreg
from monocular_depth_estimation_trt_tpu.models import vggt as jvggt
from monocular_depth_estimation_trt_tpu.models.vit import ViTConfig as JViTConfig
from monocular_depth_estimation_trt_tpu_torch.models import vggt as tvggt
from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig as TViTConfig
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import flash_attention as fa
from monocular_depth_estimation_trt_tpu_torch.registry import build_pipeline
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import vggt_from_jax

from torch_port_params import random_params, rel_err

torch.set_num_threads(1)

REL_TOL = 2e-3  # fp32 on both sides
SIZE = 70
VIT = dict(dim=128, depth=1, num_heads=2, pretrain_img_size=SIZE)
COMMON = dict(dim=128, depth=2, num_heads=2, head_layers=(0, 1, 0, 1), encoder="vits",
              head_features=16, head_out_channels=(8, 16, 32, 32))
CAMERA_KEYS = ("pose_enc", "extrinsic", "focal_px")


def _pipelines(with_camera):
    jcfg = jvggt.VGGTConfig(vit_config=JViTConfig(**VIT), **COMMON)
    model = jvggt.VGGT(cfg=jcfg, dtype=jnp.float32, attn_impl="xla", with_camera=with_camera)
    params = random_params(model, jnp.zeros((1, 1, SIZE, SIZE, 3)), seed=13)
    jpipe = jreg._build_vggt("vggt", SIZE, "fp32", "xla", params, vggt_cfg=jcfg,
                             with_camera=with_camera)
    tpipe = build_pipeline(
        "vggt", input_size=SIZE, precision="fp32", params=vggt_from_jax(params),
        depth_only=not with_camera, device="cpu",
        vggt_cfg=tvggt.VGGTConfig(vit_config=TViTConfig(**VIT), **COMMON))
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name()
    assert tpipe.viz == jpipe.viz == "metric"
    return jpipe, tpipe


@pytest.fixture(scope="module")
def pipes():
    return _pipelines(with_camera=True)


def _check_depth(ours, ref):
    for key in ("depth", "depth_conf"):
        assert ours[key].shape == np.shape(ref[key]) and ours[key].dtype == np.float32
        assert rel_err(ours[key], ref[key]) < REL_TOL, key


@pytest.mark.parametrize("hw", [(48, 64), (64, 40)])
def test_single_frame_with_camera_matches_jax(pipes, rng, hw):
    """Non-square frames: pad to square, crop the padding back out."""
    jpipe, tpipe = pipes
    frame = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    ref = jpipe(frame, viz=True)
    counts = (fa.flash_attention.launches, fa.flash_attention_packed.launches)
    ours = tpipe(frame, viz=True)
    assert (fa.flash_attention.launches, fa.flash_attention_packed.launches) == counts
    assert sorted(ours) == sorted(ref)
    assert sorted(ours) == sorted(("depth", "depth_conf", "viz") + CAMERA_KEYS)
    _check_depth(ours, ref)
    assert ours["depth"].shape == hw
    assert ours["depth"].min() >= 1e-3 and ours["depth"].max() <= 1e3
    assert ours["pose_enc"].shape == (9,) and ours["extrinsic"].shape == (3, 4)
    assert ours["focal_px"].shape == ()
    assert rel_err(ours["pose_enc"], ref["pose_enc"]) < REL_TOL
    np.testing.assert_allclose(ours["extrinsic"], ref["extrinsic"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(ours["focal_px"], ref["focal_px"], rtol=1e-3)
    assert ours["viz"].shape == (*hw, 3) and ours["viz"].dtype == np.uint8
    # colormap quantization may fall either way at a few pixels
    assert np.mean(np.any(ours["viz"] != np.asarray(ref["viz"]), axis=-1)) < 0.01


def test_multi_view_matches_jax(pipes, rng):
    jpipe, tpipe = pipes
    views = rng.integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    ref = jpipe.multi_view(views)
    ours = tpipe.multi_view(views)
    assert sorted(ours) == sorted(ref) == ["depth", "depth_conf", "pose_enc"]
    _check_depth(ours, ref)
    assert ours["depth"].shape == (2, SIZE, SIZE) and ours["pose_enc"].shape == (2, 9)
    assert rel_err(ours["pose_enc"], ref["pose_enc"]) < REL_TOL
    # the views attend to each other: view 0 alone gives another answer
    alone = tpipe.multi_view(views[:1])
    assert rel_err(alone["depth"][0], ours["depth"][0]) > 1e-4


def test_depth_only_variant_matches_jax(rng):
    jpipe, tpipe = _pipelines(with_camera=False)
    assert tpipe.spec.artifact_name() == "vggt_depth_70x70_metric_fp32"
    assert not hasattr(tpipe.model, "camera_head")
    frame = rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    ref, ours = jpipe(frame), tpipe(frame)
    assert sorted(ours) == sorted(ref) == ["depth", "depth_conf"]
    _check_depth(ours, ref)
