"""The port's MapAnything (``models/map_anything.py``: the dense and scale
heads and ``compose``) and its ``map_anything`` pipeline against the JAX
package's on the CPU, fp32, with one set of seeded weights: the composed
output set of one frame (S = 1, ``__call__``) and of two views
(``reconstruct``), and the model's key set against the upstream manifest.

The aggregator is ``tests/test_torch_vggt.py``'s tiny one (ViT dim 48 / 2
heads, aggregator dim 64 / 4 heads, 5x5 patches at 70²); the JAX side runs
its plain attention."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu import registry as jreg
from monocular_depth_estimation_trt_tpu.models import map_anything as jma
from monocular_depth_estimation_trt_tpu.models import vggt as jvggt
from monocular_depth_estimation_trt_tpu.models.vit import ViTConfig as JViTConfig
from monocular_depth_estimation_trt_tpu_torch.models import vggt as tvggt
from monocular_depth_estimation_trt_tpu_torch.models.map_anything import MapAnything
from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig as TViTConfig
from monocular_depth_estimation_trt_tpu_torch.registry import build_pipeline
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import (
    map_anything_from_jax,
    state_dict_from_jax,
)

from torch_port_params import random_params, rel_err

torch.set_num_threads(1)

REL_TOL = 2e-3  # fp32 on both sides
SIZE = 70
VIT = dict(dim=48, depth=2, num_heads=2, pretrain_img_size=SIZE)
COMMON = dict(dim=64, depth=2, num_heads=4, head_layers=(0, 1, 0, 1), encoder="vits",
              head_features=16, head_out_channels=(8, 16, 32, 32))
BOOLEAN = ("mask", "non_ambiguous_mask")
MANIFEST = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "monocular_depth_estimation_trt_tpu", "weights", "manifests",
                        "map_anything.json")


@pytest.fixture(scope="module")
def pipes():
    jcfg = jvggt.VGGTConfig(vit_config=JViTConfig(**VIT), **COMMON)
    model = jma.MapAnything(cfg=jcfg, dtype=jnp.float32, attn_impl="xla")
    params = random_params(model, jnp.zeros((1, 1, SIZE, SIZE, 3)), seed=31)
    jpipe = jreg.build_pipeline("map_anything", input_size=SIZE, precision="fp32",
                                attn_impl="xla", params=params, vggt_cfg=jcfg)
    sd = map_anything_from_jax(params)
    assert set(sd) == set(state_dict_from_jax(params))
    tpipe = build_pipeline("map_anything", input_size=SIZE, precision="fp32", device="cpu",
                           params=sd,
                           vggt_cfg=tvggt.VGGTConfig(vit_config=TViTConfig(**VIT), **COMMON))
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name()
    return jpipe, tpipe


def _check(ours, ref):
    assert sorted(ours) == sorted(ref)
    for k, want in ref.items():
        want = np.asarray(want)
        assert ours[k].shape == want.shape and ours[k].dtype == want.dtype, k
        if k in BOOLEAN or k == "viz":  # thresholds, colormap steps: either way at a pixel
            assert np.mean(ours[k] != want) < 0.01, k
        else:
            assert rel_err(ours[k], want) < REL_TOL, k


def test_single_frame_output_set_matches_jax(pipes):
    """S = 1: the composed set at the square input and the depth cropped out
    of the pad-square view and resampled to the frame."""
    jpipe, tpipe = pipes
    frame = np.random.default_rng(7).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    ours = tpipe(frame, viz=True)
    _check(ours, jpipe(frame, viz=True))
    assert ours["depth"].shape == (48, 64) and ours["pts3d"].shape == (1, SIZE, SIZE, 3)
    assert ours["camera_poses"][0, 3].tolist() == [0.0, 0.0, 0.0, 1.0]
    # the world points are the camera points moved by the scaled pose
    R, t = ours["camera_poses"][0, :3, :3], ours["camera_poses"][0, :3, 3]
    np.testing.assert_allclose(ours["pts3d"][0], ours["pts3d_cam"][0] @ R.T + t, atol=1e-4)


def test_reconstruct_two_views_matches_jax(pipes):
    jpipe, tpipe = pipes
    frames = np.random.default_rng(8).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    ours = tpipe.reconstruct(frames)
    _check(ours, jpipe.reconstruct(frames))
    assert ours["pts3d"].shape == (1, 2, SIZE, SIZE, 3)
    assert ours["metric_scaling_factor"].shape == (1,)
    # the views attend to each other: view 0 alone gives another answer
    alone = tpipe.reconstruct(frames[:1])
    assert rel_err(alone["pts3d_cam"][0, 0], ours["pts3d_cam"][0, 0]) > 1e-4


def test_keys_equal_the_manifest():
    with open(MANIFEST) as f:
        want = json.load(f)["keys"]
    with torch.device("meta"):
        got = {k: list(v.shape) for k, v in MapAnything().state_dict().items()}
    assert got == want
