"""The torch port's VGGT modules and camera/preprocess ops against the JAX
package's, fp32, on the CPU.

One set of seeded weights drives both sides: a Flax params tree filled by
numpy (``torch_port_params.random_params``), and ``weights/from_jax.py``
for the port. Two configurations:

* ``tiny``: ``tests/test_parity_vggt.py``'s (ViT dim 48 / 2 heads,
  aggregator dim 64 / 4 heads, so ``input_proj`` exists); the port runs
  ``attn_impl="flash"``, so every attention takes K2's plain version (head
  dims 24 and 16);
* ``k64``: head_dim 64 everywhere (ViT and aggregator dim 128, 2 heads);
  the port's default route, K1 in the patch embed and K2 in the aggregator.

The JAX side runs its plain attention (``attn_impl="xla"``), which is what
it runs on any backend other than a TPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu.models import vggt as jvggt
from monocular_depth_estimation_trt_tpu.models.vit import ViTConfig as JViTConfig
from monocular_depth_estimation_trt_tpu.ops import camera as jcamera
from monocular_depth_estimation_trt_tpu.ops import preprocess as jpre
from monocular_depth_estimation_trt_tpu_torch.models import vggt as tvggt
from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig as TViTConfig
from monocular_depth_estimation_trt_tpu_torch.ops import camera as tcamera
from monocular_depth_estimation_trt_tpu_torch.ops import preprocess as tpre
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import flash_attention as fa
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import vggt_from_jax

from torch_port_params import random_params, rel_err

torch.set_num_threads(1)

REL_TOL = 2e-3  # fp32 on both sides: summation order and exp/erf only
HW = (70, 70)  # a 5x5 patch grid, 30 tokens per view
HEAD = dict(head_features=16, head_out_channels=(8, 16, 32, 32))
CONFIGS = {
    "tiny": dict(vit=dict(dim=48, depth=2, num_heads=2, pretrain_img_size=70),
                 agg=dict(dim=64, depth=2, num_heads=4), attn="flash"),
    "k64": dict(vit=dict(dim=128, depth=1, num_heads=2, pretrain_img_size=70),
                agg=dict(dim=128, depth=2, num_heads=2), attn="auto"),
}


def vggt_configs(name):
    c = CONFIGS[name]
    common = dict(head_layers=(0, 1, 0, 1), encoder="vits", **c["agg"], **HEAD)
    return (jvggt.VGGTConfig(vit_config=JViTConfig(**c["vit"]), **common),
            tvggt.VGGTConfig(vit_config=TViTConfig(**c["vit"]), **common), c["attn"])


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(config name, JAX VGGT, its params, the port's VGGT on those weights)."""
    jcfg, tcfg, attn = vggt_configs(request.param)
    jm = jvggt.VGGT(cfg=jcfg, dtype=jnp.float32, attn_impl="xla")
    params = random_params(jm, jnp.zeros((1, 1, *HW, 3)), seed=11)
    tm = tvggt.VGGT(tcfg, attn_impl=attn)
    tm.load_state_dict(vggt_from_jax(params), strict=True)
    return request.param, jm, params, tm.eval()


@pytest.fixture(scope="module")
def jax_run(pair):
    """s -> (views, JAX outputs, the outputs of its aggregator, depth head
    and camera head), one jitted run per S, shared by the module tests."""
    _, jm, params, _ = pair
    keep = (jvggt.Aggregator, jvggt.VGGTDepthHead, jvggt.CameraHead)
    fn = jax.jit(lambda p, v: jm.apply({"params": p}, v, mutable=["intermediates"],
                                       capture_intermediates=lambda m, _: isinstance(m, keep)))
    runs = {}

    def run(s):
        if s not in runs:
            x = np.random.default_rng(100 + s).standard_normal((1, s, *HW, 3))
            x = x.astype(np.float32) * 0.4
            out, state = fn(params, jnp.asarray(x))
            inter = {k: v["__call__"][0] for k, v in state["intermediates"].items()}
            runs[s] = (x, out, inter)
        return runs[s]

    return run


@pytest.mark.parametrize("grid,head_dim", [((5, 7), 16), ((4, 4), 64)])
def test_rope_tables_and_rotation_match_jax(rng, grid, head_dim):
    jcos, jsin = jvggt.rope_2d_freqs(*grid, head_dim)
    cos, sin = tvggt.rope_2d_freqs(*grid, head_dim)
    assert cos.shape == (grid[0] * grid[1], head_dim // 2) and cos.dtype == torch.float32
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    q = rng.standard_normal((2, 3, grid[0] * grid[1], head_dim)).astype(np.float32)
    ref = jvggt.apply_rope(jnp.asarray(q), jcos, jsin)
    ours = tvggt.apply_rope(torch.from_numpy(q), cos, sin)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("views", [1, 2])
def test_rope_attention_matches_jax(pair, rng, views):
    name, _, params, tm = pair
    attn = tm.aggregator.global_blocks[0].attn
    jm = jvggt.RopeAttention(attn.dim, attn.num_heads, attn.num_special, (5, 5),
                             dtype=jnp.float32)
    x = rng.standard_normal((1, views * (attn.num_special + 25), attn.dim)).astype(np.float32)
    ref = jm.apply({"params": params["aggregator"]["global_0"]["attn"]}, jnp.asarray(x), views)
    before = fa.flash_attention.launches
    with torch.no_grad():
        ours = attn(torch.from_numpy(x), (5, 5), views)
    assert fa.flash_attention.launches == before  # CPU: the plain version
    assert rel_err(ours.numpy(), ref) < REL_TOL


@pytest.mark.parametrize("views", [1, 2])
def test_rope_attention_at_head_dim_128_matches_jax(rng, views):
    """RopeAttention(256, 2): head_dim 128 (the width of VGGT's camera
    heads and of DINOv3 vit7b16), which used to raise in the port's K2
    wrapper; on the CPU it runs K2's plain version."""
    jm = jvggt.RopeAttention(256, 2, 5, (5, 5), dtype=jnp.float32)
    x = rng.standard_normal((1, views * 30, 256)).astype(np.float32)
    params = random_params(jm, jnp.asarray(x), views, seed=12)
    tm = tvggt.RopeAttention(256, 2, 5)
    tm.load_state_dict({f"{name}.{p}": torch.from_numpy(
        np.array(params[name]["kernel"].T if p == "weight" else params[name]["bias"]))
        for name in ("qkv", "proj") for p in ("weight", "bias")}, strict=True)
    ref = jax.jit(lambda p, v: jm.apply({"params": p}, v, views))(params, jnp.asarray(x))
    before = fa.flash_attention.launches
    with torch.no_grad():
        ours = tm(torch.from_numpy(x), (5, 5), views)
    assert fa.flash_attention.launches == before  # CPU: the plain version
    assert rel_err(ours.numpy(), ref) < 1e-5


def test_view_causal_config_is_refused():
    with pytest.raises(NotImplementedError, match="streamvggt"):
        tvggt.Aggregator(tvggt.VGGTConfig(causal=True))


def test_aggregator_matches_jax(pair, jax_run):
    name, _, _, tm = pair
    x, _, inter = jax_run(2)
    ref, ref_hw = inter["aggregator"]
    with torch.no_grad():
        ours, hw = tm.aggregator(torch.from_numpy(x))
    assert hw == tuple(ref_hw) == (5, 5)
    assert hasattr(tm.aggregator, "input_proj") == (name == "tiny")
    assert len(ours) == len(ref) == 4
    for o, r in zip(ours, ref):
        assert o.shape == r.shape == (1, 2, 30, 2 * tm.cfg.dim)
        assert rel_err(o.numpy(), r) < REL_TOL


def test_camera_head_matches_jax(pair, jax_run):
    """On the JAX aggregator's last tokens."""
    _, _, _, tm = pair
    _, out, inter = jax_run(2)
    tokens = torch.from_numpy(np.array(inter["aggregator"][0][-1]))
    with torch.no_grad():
        ours = tm.camera_head(tokens)
    assert ours.shape == (1, 2, 9) and ours.dtype == torch.float32
    assert rel_err(ours.numpy(), inter["camera_head"]) < REL_TOL
    assert float(ours[..., 7:].min()) >= 0.0  # fov through relu


def test_depth_head_matches_jax(pair, jax_run):
    """On the JAX aggregator's tokens."""
    _, _, _, tm = pair
    _, _, inter = jax_run(2)
    agg = [torch.from_numpy(np.array(t)) for t in inter["aggregator"][0]]
    with torch.no_grad():
        d, c = tm.depth_head(agg, (5, 5), 5)
    ref_d, ref_c = inter["depth_head"]
    assert d.shape == c.shape == (1, 2, 70, 70)
    assert rel_err(d.numpy(), ref_d) < REL_TOL
    assert rel_err(c.numpy(), ref_c) < REL_TOL
    assert float(c.min()) >= 1.0


@pytest.mark.parametrize("s", [1, 2])
def test_vggt_matches_jax(pair, jax_run, s):
    _, _, _, tm = pair
    x, ref, _ = jax_run(s)
    counts = (fa.flash_attention.launches, fa.flash_attention_packed.launches)
    with torch.no_grad():
        ours = tm(torch.from_numpy(x))
    assert (fa.flash_attention.launches, fa.flash_attention_packed.launches) == counts
    assert sorted(ours) == sorted(ref) == ["depth", "depth_conf", "pose_enc"]
    for key in ours:
        assert ours[key].shape == ref[key].shape, key
        assert rel_err(ours[key].numpy(), ref[key]) < REL_TOL, key


@pytest.mark.parametrize("shape,out_size", [((40, 60, 3), 70), ((60, 44, 3), 98),
                                            ((2, 30, 50, 3), 70), ((56, 56, 3), 70)])
def test_preprocess_pad_square_matches_jax(rng, shape, out_size):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    ref = jpre.preprocess_pad_square(jnp.asarray(img), out_size)
    ours = tpre.preprocess_pad_square(torch.from_numpy(img), out_size)
    assert ours.shape == ref.shape and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
    assert tpre.pad_square_size(*shape[-3:-1]) == jpre.pad_square_size(*shape[-3:-1])


def test_pad_square_pads_white():
    img = np.zeros((10, 30, 3), dtype=np.uint8)
    x = tpre.preprocess_pad_square(torch.from_numpy(img), 30, mean=(0.0,) * 3,
                                   std=(1.0,) * 3)
    assert x.shape == (1, 30, 30, 3)
    assert torch.all(x[0, :10] == 1.0) and torch.all(x[0, 10:20] == 0.0)
    assert torch.all(x[0, 20:] == 1.0)


def test_camera_ops_match_jax(rng):
    quat = rng.standard_normal((5, 4)).astype(np.float32)
    quat[0] = 0.0  # the degenerate quaternion: identity rotation
    trans = rng.standard_normal((5, 3)).astype(np.float32)
    ref = jcamera.extrinsics_from_quat_trans(jnp.asarray(quat), jnp.asarray(trans))
    ours = tcamera.extrinsics_from_quat_trans(torch.from_numpy(quat), torch.from_numpy(trans))
    assert ours.shape == (5, 3, 4)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(ours[0, :, :3].numpy(), np.eye(3), atol=0)
    fov = rng.uniform(20.0, 120.0, 7).astype(np.float32)
    np.testing.assert_allclose(tcamera.fov_to_focal(torch.from_numpy(fov), 518).numpy(),
                               np.asarray(jcamera.fov_to_focal(jnp.asarray(fov), 518)),
                               rtol=1e-6)
    assert float(tcamera.fov_to_focal(90.0, 518)) == pytest.approx(259.0, rel=1e-6)
