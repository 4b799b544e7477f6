"""Depth Pro's artifact (kernel K3's first program in a file) on the CPU:
the 512 geometry (every ratio of the 1536 preset), ViT dim 512 with 8 heads
of 64, 3 blocks (hooks 0 and 1), fp32, one set of seeded weights on both sides.

Its CPU program holds ``mdet.flash_attention_batched`` once a patch-encoder
block (35 windows x 8 heads: K3's route) and ``mdet.flash_attention_packed``
once an image-encoder block (head_dim 64: K1's), as does its CUDA program;
the loaded artifact equals the in-process pipeline bit for bit and the JAX
pipeline's steps on the same weights within REL_TOL."""

import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu.config import HALF_MEAN, HALF_STD
from monocular_depth_estimation_trt_tpu.models import depth_pro as jdp
from monocular_depth_estimation_trt_tpu.models import vit as jvit
from monocular_depth_estimation_trt_tpu.ops.camera import fov_to_focal
from monocular_depth_estimation_trt_tpu.ops.preprocess import normalize, to_float_rgb
from monocular_depth_estimation_trt_tpu.ops.resize import resize, resize_hw
from monocular_depth_estimation_trt_tpu_torch import registry as treg
from monocular_depth_estimation_trt_tpu_torch.models import depth_pro as tdp
from monocular_depth_estimation_trt_tpu_torch.models import vit as tvit
from monocular_depth_estimation_trt_tpu_torch.runtime.export import (
    export_pipeline,
    load_engine,
    read_meta,
)
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import depth_pro_from_jax

from torch_port_params import lift_depth_pro_outputs, random_params, rel_err

torch.set_num_threads(1)

REL_TOL = 2e-3  # fp32 on both sides
SIZE = 512
GEO = dict(img_size=SIZE, window=128, stride0=96, stride1=64)
HEAD = dict(decoder_features=16, dims_encoder=(8, 16, 32, 32))
VIT = dict(dim=512, depth=3, num_heads=8, patch_size=16, pretrain_img_size=128)


def _jax_pipeline(model, params):
    """The JAX registry's Depth Pro steps (``registry.depth_pro``) at this
    geometry: normalize, resize to the model's input, the model, the focal
    from the FoV and the metric depth at the frame's size."""

    @jax.jit
    def run(frame):
        x = resize(normalize(to_float_rgb(frame), HALF_MEAN, HALF_STD)[None], (SIZE, SIZE),
                   method="linear")
        cid, fov_deg = model.apply({"params": params}, x)
        width = frame.shape[1]
        focal = fov_to_focal(fov_deg[0], width)
        inverse = resize_hw(cid[0] * (width / focal), frame.shape[:2], "linear",
                            align_corners=False)
        return {"depth": 1.0 / jnp.clip(inverse, 1e-4, 1e4), "f_px": focal}

    return run


@pytest.fixture(scope="module")
def depth_pro(tmp_path_factory):
    jcfg = jdp.DepthProConfig(**GEO, hook_block_ids=(0, 1), vit_config=jvit.ViTConfig(**VIT))
    model = jdp.DepthPro(**HEAD, dtype=jnp.float32, attn_impl="xla", cfg=jcfg)
    params = random_params(model, jnp.zeros((1, SIZE, SIZE, 3)), seed=29)
    lift_depth_pro_outputs(params)
    tcfg = tdp.DepthProConfig(**GEO, hook_block_ids=(0, 1), vit_config=tvit.ViTConfig(**VIT))
    tpipe = treg.build_pipeline("depth_pro", precision="fp32", device="cpu",
                                params=depth_pro_from_jax(params),
                                model_kw=dict(cfg=tcfg, **HEAD))
    path = export_pipeline(tpipe, (SIZE, SIZE), with_viz=True,
                           path=str(tmp_path_factory.mktemp("dp") / "depth_pro.mdeteng"))
    return _jax_pipeline(model, params), tpipe, path


@pytest.mark.parametrize("platform", ["cpu", "cuda"])
def test_graph_holds_k3_a_patch_block_and_k1_an_image_block(depth_pro, platform):
    _, _, path = depth_pro
    assert read_meta(path)["platforms"] == ["cpu", "cuda"]
    with zipfile.ZipFile(path) as z:
        ep = torch.export.load(z.open(f"modules/{platform}/b1_viz.bin"))
    counts = {}
    for node in ep.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("mdet."):
            counts[str(node.target)] = counts.get(str(node.target), 0) + 1
            assert node.args[0].meta["val"].device.type == platform
    assert counts == {"mdet.flash_attention_batched.default": VIT["depth"],
                      "mdet.flash_attention_packed.default": VIT["depth"]}


def test_loaded_artifact_is_the_pipeline_and_tracks_jax(depth_pro):
    jrun, tpipe, path = depth_pro
    frame = np.random.default_rng(3).integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    eng = load_engine(path, "cpu")
    got, here = eng(frame, viz=True), tpipe(frame, viz=True)
    for key in ("depth", "f_px", "viz"):
        np.testing.assert_array_equal(got[key], here[key], err_msg=key)
    ref = jrun(jnp.asarray(frame))
    for key in ("depth", "f_px"):
        assert np.shape(got[key]) == np.shape(ref[key]), key
        assert rel_err(got[key], np.asarray(ref[key])) < REL_TOL, key
