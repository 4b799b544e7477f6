"""VGGT's and StreamVGGT's artifacts against the JAX package's on the CPU,
fp32, one set of weights on both sides: the ``views_s2`` module and the
stream module (window 2, three steps), each loaded on both sides and
compared within REL_TOL, and equal to the port's in-process pipeline bit for
bit (the helpers of ``test_torch_export_parity.py``)."""

import jax.numpy as jnp
import numpy as np
import torch

from monocular_depth_estimation_trt_tpu import registry as jreg
from monocular_depth_estimation_trt_tpu.models import vggt as jvggt
from monocular_depth_estimation_trt_tpu.models import vit as jvit
from monocular_depth_estimation_trt_tpu_torch import registry as treg
from monocular_depth_estimation_trt_tpu_torch.models import vggt as tvggt
from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig as TViTConfig
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import vggt_from_jax

from test_torch_export_parity import SIZE, _both, _check, _frames, _ops
from torch_port_params import random_params

torch.set_num_threads(1)


VGGT_VIT = dict(dim=128, depth=1, num_heads=2, pretrain_img_size=SIZE)
VGGT_COMMON = dict(dim=128, depth=2, num_heads=2, head_layers=(0, 1, 0, 1), encoder="vits",
                   head_features=16, head_out_channels=(8, 16, 32, 32))


def _vggt(name, with_camera, seed):
    jcfg = jvggt.VGGTConfig(vit_config=jvit.ViTConfig(**VGGT_VIT), **VGGT_COMMON)
    tcfg = tvggt.VGGTConfig(vit_config=TViTConfig(**VGGT_VIT), **VGGT_COMMON)
    model = jvggt.VGGT(cfg=jcfg, dtype=jnp.float32, attn_impl="xla", with_camera=with_camera)
    params = random_params(model, jnp.zeros((1, 1, SIZE, SIZE, 3)), seed=seed)
    jpipe = jreg._build_vggt(name, SIZE, "fp32", "xla", params, vggt_cfg=jcfg,
                             with_camera=with_camera)
    kw = {} if name == "streamvggt" else {"depth_only": not with_camera}
    tpipe = treg.build_pipeline(name, input_size=SIZE, precision="fp32", device="cpu",
                                params=vggt_from_jax(params), vggt_cfg=tcfg, **kw)
    return jpipe, tpipe


def test_vggt_views_module(tmp_path):
    jpipe, tpipe = _vggt("vggt", with_camera=True, seed=13)
    jeng, tpath, teng = _both(tmp_path, "vggt", jpipe, tpipe, (SIZE, SIZE), views=(2,))
    assert _ops(tpath, "views_s2") == {"mdet.flash_attention_packed.default": 1,
                                       "mdet.flash_attention.default": 4}
    views = np.stack(_frames(2, (SIZE, SIZE), seed=6))
    _check(teng.multi_view(views), jeng.multi_view(views), tpipe.multi_view(views),
           keys=("depth", "depth_conf", "pose_enc"))


def test_streamvggt_stream_three_steps(tmp_path):
    """Window 2, three steps (the ring wraps): the loaded stream against the
    JAX artifact's and the port's in-process session, whose step writes its
    cache in place where the exported step makes new tensors."""
    jpipe, tpipe = _vggt("streamvggt", with_camera=False, seed=21)
    jeng, tpath, teng = _both(tmp_path, "stream", jpipe, tpipe, (48, 64), stream_window=2)
    assert _ops(tpath, "stream") == {"mdet.flash_attention_packed.default": 1,
                                     "mdet.flash_attention.default": 2}
    jrun, trun, here = jeng.stream(), teng.stream(), tpipe.stream(window=2)
    for frame in _frames(3, (48, 64), seed=5):
        _check(trun(frame), jrun(frame), here(frame), keys=("depth", "viz"))
