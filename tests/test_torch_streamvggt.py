"""The port's view-causal VGGT, point head, masked camera head and KV-cache
stream (``models/vggt.py``, ``models/streamvggt.py``,
``apps/streaming.py``) and the ``streamvggt``, ``stream3r`` and
``litevggt`` pipelines against the JAX package on the CPU, fp32, with one
set of seeded weights (``weights/from_jax.py``).

The tiny configuration is ``tests/test_torch_vggt.py``'s (ViT dim 48 / 2
heads, aggregator dim 64 / 4 heads, a 5x5 patch grid at 70²). The JAX side
runs its plain attention, as on any backend but a TPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu import registry as jreg
from monocular_depth_estimation_trt_tpu.models import vggt as jvggt
from monocular_depth_estimation_trt_tpu.models.vit import ViTConfig as JViTConfig
from monocular_depth_estimation_trt_tpu_torch.apps.streaming import VGGTStreamingSession
from monocular_depth_estimation_trt_tpu_torch.models import vggt as tvggt
from monocular_depth_estimation_trt_tpu_torch.models.streamvggt import StreamingVGGT
from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig as TViTConfig
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import flash_attention as fa
from monocular_depth_estimation_trt_tpu_torch.ops.preprocess import preprocess_pad_square
from monocular_depth_estimation_trt_tpu_torch.registry import build_pipeline
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import vggt_from_jax

from torch_port_params import random_params, rel_err

torch.set_num_threads(1)

REL_TOL = 2e-3  # fp32 on both sides: summation order and exp/erf only
EXACT = 1e-5  # the stream against the port's own causal joint model
# each side's own int8 pipeline computes in bf16 and calibrates on its own
# (tests/test_torch_int8_slice.py's PIPELINE_BF16_REL_TOL)
INT8_BF16_REL_TOL = 7.5e-2
SIZE = 70  # a 5x5 patch grid, 30 tokens per view
VIT = dict(dim=48, depth=2, num_heads=2, pretrain_img_size=SIZE)
COMMON = dict(dim=64, depth=2, num_heads=4, head_layers=(0, 1, 0, 1), encoder="vits",
              head_features=16, head_out_channels=(8, 16, 32, 32))
OUTPUTS = ("depth", "depth_conf", "world_points", "world_points_conf", "pose_enc")
MANIFESTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "monocular_depth_estimation_trt_tpu", "weights", "manifests")


def configs(causal):
    return (jvggt.VGGTConfig(vit_config=JViTConfig(**VIT), causal=causal, **COMMON),
            tvggt.VGGTConfig(vit_config=TViTConfig(**VIT), causal=causal, **COMMON))


@pytest.fixture(scope="module")
def pair():
    """(JAX causal VGGT with camera and point head, its params, the port's on
    those weights)."""
    jcfg, tcfg = configs(causal=True)
    jm = jvggt.VGGT(cfg=jcfg, dtype=jnp.float32, attn_impl="xla", with_camera=True,
                    with_point_head=True)
    params = random_params(jm, jnp.zeros((1, 1, SIZE, SIZE, 3)), seed=21)
    tm = tvggt.VGGT(tcfg, attn_impl="flash", with_camera=True, with_point_head=True)
    tm.load_state_dict(vggt_from_jax(params), strict=True)
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(5)
    return rng.integers(0, 256, (3, 48, 64, 3), dtype=np.uint8)


def _views(frames):
    return preprocess_pad_square(torch.from_numpy(frames), SIZE)[None]  # (1, S, 70, 70, 3)


@pytest.fixture(scope="module")
def jax_joint(pair, frames):
    """The JAX causal model on the three views, one jitted run: its outputs
    and its aggregator's and point head's."""
    jm, params, _ = pair
    keep = (jvggt.Aggregator, jvggt.VGGTPointHead)
    fn = jax.jit(lambda p, v: jm.apply({"params": p}, v, mutable=["intermediates"],
                                       capture_intermediates=lambda m, _: isinstance(m, keep)))
    out, state = fn(params, jnp.asarray(_views(frames).numpy()))
    return out, {k: v["__call__"][0] for k, v in state["intermediates"].items()}


def test_causal_joint_vggt_matches_jax(pair, frames, jax_joint):
    _, _, tm = pair
    ref, _ = jax_joint
    x = _views(frames)
    before = fa.flash_attention.launches
    with torch.no_grad():
        ours = tm(x)
    assert fa.flash_attention.launches == before  # CPU: the plain version
    assert sorted(ours) == sorted(ref) == sorted(OUTPUTS)
    for k in OUTPUTS:
        assert ours[k].shape == ref[k].shape, k
        assert rel_err(ours[k].numpy(), ref[k]) < REL_TOL, k
    # view 0 sees itself only: its dense outputs are the S=1 model's
    with torch.no_grad():
        alone = tm(x[:, :1])
    assert rel_err(alone["depth"][:, 0].numpy(), ours["depth"][:, 0].numpy()) < EXACT
    assert rel_err(alone["depth"][:, 0].numpy(), ours["depth"][:, 1].numpy()) > 1e-3


def test_point_head_matches_jax(pair, jax_joint):
    """On the JAX aggregator's tokens."""
    _, _, tm = pair
    _, inter = jax_joint
    agg, hw = inter["aggregator"]
    assert tuple(int(v) for v in hw) == (5, 5)
    with torch.no_grad():
        pts, conf = tm.point_head([torch.from_numpy(np.array(t)) for t in agg], (5, 5), 5)
    rp, rc = inter["point_head"]
    assert pts.shape == (1, 3, SIZE, SIZE, 3) and conf.shape == (1, 3, SIZE, SIZE)
    assert rel_err(pts.numpy(), rp) < REL_TOL and rel_err(conf.numpy(), rc) < REL_TOL
    assert float(conf.min()) >= 1.0


def test_camera_head_with_a_key_mask_matches_jax(pair):
    _, params, tm = pair
    tokens = np.random.default_rng(6).standard_normal((1, 3, 128)).astype(np.float32)
    head = jvggt.CameraHead(128, num_heads=4, dtype=jnp.float32)
    fn = jax.jit(lambda p, t, m: head.apply({"params": p}, t, key_mask=m))
    for mask in ((True, True, False), (True, False, False)):
        ref = fn(params["camera_head"], jnp.asarray(tokens), jnp.asarray(mask))
        with torch.no_grad():
            ours = tm.camera_head(torch.from_numpy(tokens), key_mask=torch.tensor(mask))
            unmasked = tm.camera_head(torch.from_numpy(tokens))
        assert rel_err(ours.numpy(), ref) < REL_TOL, mask
        assert rel_err(unmasked.numpy(), ours.numpy()) > 1e-3, mask


@pytest.fixture(scope="module")
def stream3r_pipes(pair):
    _, params, _ = pair
    jcfg, tcfg = configs(causal=True)
    jpipe = jreg.build_pipeline("stream3r", input_size=SIZE, precision="fp32",
                                attn_impl="xla", params=params, vggt_cfg=jcfg)
    tpipe = build_pipeline("stream3r", input_size=SIZE, precision="fp32", device="cpu",
                           params=vggt_from_jax(params), vggt_cfg=tcfg)
    return jpipe, tpipe


def test_stream_steps_match_jax_and_the_causal_joint_model(pair, frames, stream3r_pipes):
    """Three steps at window 2, so that the ring wraps (STream3R's session:
    camera and point head): each step against the JAX session's step; the
    first two against the port's causal joint model on those views (the
    camera on the prefix, as its trunk is bidirectional)."""
    _, _, tm = pair
    jpipe, tpipe = stream3r_pipes
    jsess, sess = jpipe.stream_session(window=2), tpipe.stream_session(window=2)
    assert isinstance(sess, VGGTStreamingSession)
    with torch.no_grad():
        joint = {s: tm(_views(frames[:s])) for s in (1, 2)}
    for s in range(3):
        ref = jsess.step(frames[s])
        ours = sess.step(frames[s])
        assert sorted(ours) == sorted(ref) == sorted(OUTPUTS)
        for k in OUTPUTS:
            assert ours[k].shape == ref[k].shape, k
            assert rel_err(ours[k].numpy(), ref[k]) < REL_TOL, (s, k)
            if s < 2:
                want = joint[2 if k != "pose_enc" else s + 1][k][0, s]
                assert rel_err(ours[k].numpy(), want.numpy()) < EXACT, (s, k)
    assert int(sess.steps) == 3
    # the third step sees views 1 and 2 only: not the joint model's view 2
    with torch.no_grad():
        full = tm(_views(frames))
    assert rel_err(ours["depth"].numpy(), full["depth"][0, 2].numpy()) > 1e-4
    sess.reset()
    assert int(sess.steps) == 0
    again = sess.step(frames[0])
    fresh = sess.model.init_cache(1, (5, 5), torch.float32, "cpu")
    assert torch.equal(again["depth"], sess.pure_step(torch.from_numpy(frames[0]), fresh)[0]
                       ["depth"])


def test_stream3r_pipeline_matches_jax(frames, stream3r_pipes):
    jpipe, tpipe = stream3r_pipes
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name()
    ref, ours = jpipe(frames[0], viz=True), tpipe(frames[0], viz=True)
    assert sorted(ours) == sorted(ref)
    for k in ("depth", "world_points", "world_points_conf", "pose_enc"):
        assert ours[k].shape == np.shape(ref[k]), k
        assert rel_err(ours[k], ref[k]) < REL_TOL, k


@pytest.fixture(scope="module")
def depth_only_params(pair):
    return {k: pair[1][k] for k in ("aggregator", "depth_head")}


def test_streamvggt_pipeline_and_stream_match_jax(depth_only_params, frames):
    jcfg, tcfg = configs(causal=False)
    jpipe = jreg._build_vggt("streamvggt", SIZE, "fp32", "xla", depth_only_params,
                             vggt_cfg=jcfg, with_camera=False)
    tpipe = build_pipeline("streamvggt", input_size=SIZE, precision="fp32", device="cpu",
                           params=vggt_from_jax(depth_only_params), vggt_cfg=tcfg)
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name()
    ref, ours = jpipe(frames[0]), tpipe(frames[0])
    assert sorted(ours) == sorted(ref) == ["depth", "depth_conf"]
    for k in ours:
        assert rel_err(ours[k], ref[k]) < REL_TOL, k
    jrun, trun = jpipe.stream(window=2), tpipe.stream(window=2)
    for frame in frames:
        ref, ours = jrun(frame), trun(frame)
        assert sorted(ours) == sorted(ref) == ["depth", "viz"]
        assert ours["depth"].shape == frame.shape[:2] and ours["viz"].shape == frame.shape
        assert rel_err(ours["depth"], ref["depth"]) < REL_TOL
        assert np.mean(np.any(ours["viz"] != ref["viz"], axis=-1)) < 0.01


def test_litevggt_matches_jax_and_drops_only_token_merge_keys(pair, frames, tmp_path):
    params = {k: pair[1][k] for k in ("aggregator", "depth_head", "camera_head")}
    jcfg, tcfg = configs(causal=False)
    # the JAX factory takes no config: its builder, as it calls it
    jpipe = jreg._build_vggt("litevggt", SIZE, "fp32", "xla", params, vggt_cfg=jcfg,
                             with_camera=True)
    sd = vggt_from_jax(params)
    tpipe = build_pipeline("litevggt", input_size=SIZE, precision="fp32", device="cpu",
                           params=sd, vggt_cfg=tcfg)
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name()
    ref, ours = jpipe(frames[1]), tpipe(frames[1])
    assert sorted(ours) == sorted(ref)
    for k in ("depth", "depth_conf", "pose_enc"):
        assert rel_err(ours[k], ref[k]) < REL_TOL, k
    extra = {"te_dict.0.weight": torch.zeros(2), "aggregator.token_merge.scale": torch.ones(1)}
    ckpt = str(tmp_path / "lite.pth")
    torch.save({**sd, **extra}, ckpt)
    loaded = build_pipeline("litevggt", input_size=SIZE, precision="fp32", device="cpu",
                            checkpoint=ckpt, vggt_cfg=tcfg)
    assert np.array_equal(loaded(frames[1])["depth"], ours["depth"])
    torch.save({**sd, **extra, "aggregator.other.weight": torch.zeros(1)}, ckpt)
    with pytest.raises(RuntimeError, match="aggregator.other.weight"):
        build_pipeline("litevggt", input_size=SIZE, device="cpu", checkpoint=ckpt,
                       vggt_cfg=tcfg)


@pytest.mark.parametrize("manifest,build", [
    ("vggt", lambda: tvggt.VGGT()),
    ("vggt", lambda: StreamingVGGT(with_camera=True)),
    ("stream3r", lambda: tvggt.VGGT(tvggt.VGGTConfig(causal=True), with_point_head=True)),
])
def test_vggt_family_keys_equal_the_manifests(manifest, build):
    """streamvggt and litevggt load VGGT's checkpoint, stream3r adds the
    point head; the streaming model holds the joint model's keys."""
    with open(os.path.join(MANIFESTS, f"{manifest}.json")) as f:
        want = json.load(f)["keys"]
    with torch.device("meta"):
        got = {k: list(v.shape) for k, v in build().state_dict().items()}
    assert got == want


def test_int8_stream_matches_jax(depth_only_params, frames):
    """The int8 stream (ROADMAP fault 4): the JAX int8 streamvggt pipeline's
    ``{"params", "q8"}`` bundle, calibrated on two frames, served by the JAX
    session and by the port's session on a joint model holding that q8
    (``install_q8``), both in fp32, three steps at window 2; then the
    port's own int8 pipeline streams on the joint model's ``QuantLinear``
    layers, against the JAX int8 runner (both bf16)."""
    from monocular_depth_estimation_trt_tpu.apps.streaming import (
        VGGTStreamingSession as JSession,
    )
    from monocular_depth_estimation_trt_tpu_torch.ops.quant import QuantLinear, install_q8
    from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import q8_from_jax

    jcfg, tcfg = configs(causal=False)
    calib = [np.random.default_rng(s).integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
             for s in (31, 32)]
    jpipe = jreg._build_vggt("streamvggt", SIZE, "int8", "xla", depth_only_params,
                             vggt_cfg=jcfg, with_camera=False, calib_images=calib)
    bundle = jpipe.params
    assert sorted(bundle) == ["params", "q8"]
    jsess = JSession(bundle, cfg=jcfg, window=2, input_size=SIZE, dtype=jnp.float32,
                     attn_impl="xla")
    tm = tvggt.VGGT(tcfg, attn_impl="flash", with_camera=False)
    tm.load_state_dict(vggt_from_jax(depth_only_params), strict=True)
    targets = sorted(tm.int8_targets())
    install_q8(tm.eval(), q8_from_jax(bundle["q8"], "streamvggt"))
    sess = VGGTStreamingSession(tm, window=2, input_size=SIZE)
    quant = [n for n, m in sess.model.named_modules() if isinstance(m, QuantLinear)]
    assert sorted(quant) == targets
    for s in range(3):
        ref, ours = jsess.step(frames[s]), sess.step(frames[s])
        for k in ("depth", "depth_conf"):
            assert rel_err(ours[k].numpy(), ref[k]) < REL_TOL, (s, k)

    tpipe = build_pipeline("streamvggt", input_size=SIZE, precision="int8", device="cpu",
                           params=vggt_from_jax(depth_only_params), vggt_cfg=tcfg,
                           calib_images=calib)
    trun, jrun = tpipe.stream(window=2), jpipe.stream(window=2)
    joint = {n: m for n, m in tpipe.model.named_modules() if isinstance(m, QuantLinear)}
    streaming = dict(trun.session.model.named_modules())
    assert sorted(joint) == sorted(quant) and all(streaming[n] is m for n, m in joint.items())
    for frame in frames:
        ref, ours = jrun(frame), trun(frame)
        assert np.isfinite(ours["depth"]).all()
        assert rel_err(ours["depth"], ref["depth"]) < INT8_BF16_REL_TOL
