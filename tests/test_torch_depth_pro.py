"""Kernel K3's plain version, the attention route that reaches it, and the
torch port's Depth Pro modules against the JAX package's, on the CPU.

* K3 (``flash_attention_batched``) against the JAX batch-gridded kernel
  (``flash_attention(blk_b=4)``) in Pallas interpret mode. On the CPU the
  wrapper runs its plain version; the CUDA kernel itself is compared with
  that plain version by ``tests/test_torch_cuda_kernels.py`` and
  ``chip_smoke.py`` on a card.
* ``Attention("auto")`` sends many short heads (B*H >= 256, N <= 1024) to
  K3 and the rest to K1, or to K2 at a head_dim other than 64.
* ``split_overlapping``, ``merge_overlapping``, ``ProjectUpsample``,
  ``MultiresConvDecoder``, ``FOVNetwork`` and the whole ``DepthPro`` at
  ``tests/test_parity_depth_pro.py``'s ratio-preserving tiny geometry, fp32,
  one set of seeded weights on both sides (``torch_port_params`` and
  ``weights/from_jax.py``). The JAX side runs its plain attention, as it
  does on any backend other than a TPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu.models import depth_pro as jdp
from monocular_depth_estimation_trt_tpu.models import vit as jvit
from monocular_depth_estimation_trt_tpu.ops.pallas.flash_attention import (
    attention_reference as jax_attention_reference,
    flash_attention as jax_flash_attention,
)
from monocular_depth_estimation_trt_tpu_torch.models import depth_pro as tdp
from monocular_depth_estimation_trt_tpu_torch.models import vit as tvit
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import flash_attention as fa
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import depth_pro_from_jax

from torch_port_params import lift_depth_pro_outputs, random_params, rel_err

torch.set_num_threads(1)

REL_TOL = 2e-3  # fp32 on both sides: summation order and exp/erf only
DTYPES = {
    "float32": (jnp.float32, torch.float32, 1e-5),
    "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2),  # bf16 output mantissa
}

# tests/test_parity_depth_pro.py's geometry: every ratio of the 1536 preset
GEO = dict(img_size=512, window=128, stride0=96, stride1=64)
HEAD = dict(decoder_features=16, dims_encoder=(8, 16, 32, 32))
VITS = {
    "tiny": dict(dim=32, depth=3, num_heads=2),  # the parity test's ViT
    # 35 windows x 8 heads = 280 >= 256 problems of N = 65: K3's route
    "k3": dict(dim=128, depth=3, num_heads=8),
}


# --- K3: the plain version against the JAX batch-gridded kernel ----------


@pytest.mark.parametrize("n", [1, 65, 130, 577])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_k3_matches_jax_batched_kernel(rng, n, d, dtype):
    """The JAX entry pads N to 128 with masked keys and d to 64 with zeros
    and runs whole-N attention for 4 heads per program; the port's plain
    version pads nothing."""
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = (rng.standard_normal((2, 4, n, d)).astype(np.float32) for _ in range(3))
    ref = jax_flash_attention(*(jnp.asarray(t, jdt) for t in (q, k, v)), blk_b=4,
                              interpret=True)
    out = fa.flash_attention_batched(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)))
    assert out.shape == (2, 4, n, d) and out.dtype == tdt
    err = np.max(np.abs(out.float().numpy() - np.asarray(ref, np.float32)))
    assert err < tol, f"max abs err {err:.2e}"


@pytest.mark.parametrize("shapes,dtypes,exc,match", [
    ([(1, 2, 1025, 64)] * 3, [torch.float32] * 3, ValueError, "1024"),
    ([(1, 2, 10, 0)] * 3, [torch.float32] * 3, ValueError, "head_dim"),
    ([(1, 2, 10, 64), (1, 2, 11, 64), (1, 2, 10, 64)], [torch.float32] * 3, ValueError,
     "shape"),
    ([(1, 2, 10)] * 3, [torch.float32] * 3, ValueError, "shape"),
    ([(1, 2, 10, 64)] * 3, [torch.float32, torch.bfloat16, torch.float32], TypeError,
     "float"),
    ([(1, 2, 10, 64)] * 3, [torch.float16] * 3, TypeError, "float"),
])
def test_k3_wrapper_rejects_unsupported_inputs(shapes, dtypes, exc, match):
    with pytest.raises(exc, match=match):
        fa.flash_attention_batched(*(torch.zeros(s, dtype=t) for s, t in zip(shapes, dtypes)))


def test_k3_wrapper_rejects_other_devices_and_a_cpu_tensor_never_counts(rng):
    q = torch.zeros((1, 2, 10, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        fa.flash_attention_batched(q, q, q)
    before = fa.flash_attention_batched.launches
    q = torch.from_numpy(rng.standard_normal((2, 3, 70, 64)).astype(np.float32))
    fa.flash_attention_batched(q, q, q)
    fa.flash_attention_batched(*(q.to(torch.bfloat16),) * 3)
    assert fa.flash_attention_batched.launches == before


def test_plain_k3_takes_strided_views_and_a_scale(rng):
    """q, k, v as views of one qkv tensor (the ViT layout), any scale."""
    b, n, h = 3, 90, 4
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3, h, 64)).astype(np.float32))
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    out = fa.flash_attention_batched(q, k, v, scale=0.3)
    ref = fa.attention_reference(q.contiguous(), k.contiguous(), v.contiguous(), 0.3)
    assert np.max(np.abs(out.numpy() - ref.numpy())) < 1e-5


# --- the route of Attention("auto") -------------------------------------


def _spy(monkeypatch, name, make_out):
    """Replace the kernel wrapper ``name`` seen by models/vit.py with one
    that records its operand shapes and returns zeros (no attention is
    computed: the point is the route)."""
    calls = []

    def spy(*args, **kw):
        calls.append(tuple(args[0].shape))
        return make_out(*args)

    monkeypatch.setattr(tvit, name, spy)
    return calls


@pytest.mark.parametrize("b,heads,dim,n,route", [
    (128, 2, 128, 65, "k3"),  # B*H = 256, head_dim 64
    (128, 2, 128, 1024, "k3"),  # at the bound of K3's regime
    (35, 8, 128, 577, "k3"),  # head_dim 16: K3 pads it
    (127, 2, 128, 65, "k1"),  # B*H = 254
    (128, 2, 128, 1025, "k1"),  # longer than K3 takes
    (1, 16, 1024, 577, "k1"),  # Depth Pro's image encoder
    (1, 8, 128, 65, "k2"),  # head_dim 16 below the regime: K1 takes 64 only
])
def test_auto_route_sends_many_short_heads_to_k3(monkeypatch, b, heads, dim, n, route):
    calls = {
        "k1": _spy(monkeypatch, "flash_attention_packed",
                   lambda qkv, h: torch.zeros(qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3)),
        "k2": _spy(monkeypatch, "flash_attention", lambda q, k, v: torch.zeros(q.shape)),
        "k3": _spy(monkeypatch, "flash_attention_batched", lambda q, k, v: torch.zeros(q.shape)),
    }
    attn = tvit.Attention(dim, heads, attn_impl="auto")
    with torch.no_grad():
        out = attn(torch.zeros(b, n, dim))
    assert out.shape == (b, n, dim)
    head_dim = dim // heads
    want = {"k1": [(b, n, 3 * dim)], "k2": [(b, heads, n, head_dim)],
            "k3": [(b, heads, n, head_dim)]}
    assert {key: got for key, got in calls.items() if got} == {route: want[route]}


def test_auto_route_takes_any_head_dim_as_jax_does(rng):
    """A non-rope attention of head_dim 16 below K3's regime used to reach
    K1, which takes head_dim 64 only, and raise; it now goes to K2 (zero
    padding d) and matches the JAX package's attention."""
    x = rng.standard_normal((1, 65, 128)).astype(np.float32)
    jm = jvit.Attention(128, 8, dtype=jnp.float32, attn_impl="auto")
    params = random_params(jm, jnp.asarray(x), seed=5)
    tm = tvit.Attention(128, 8, attn_impl="auto")
    tm.load_state_dict({f"{name}.{p}": torch.from_numpy(
        np.array(params[name]["kernel"].T if p == "weight" else params[name]["bias"]))
        for name in ("qkv", "proj") for p in ("weight", "bias")}, strict=True)
    with torch.no_grad():
        ours = tm(torch.from_numpy(x))
    assert rel_err(ours.numpy(), jm.apply({"params": params}, jnp.asarray(x))) < 1e-5


@pytest.mark.parametrize("impl,b,route", [("auto", 1, "flash_attention"),
                                          ("auto", 200, "flash_attention_batched"),
                                          ("flash", 1, "flash_attention")])
def test_head_dim_128_attention_matches_jax(rng, monkeypatch, impl, b, route):
    """Attention(256, 2): head_dim 128, which used to raise in the port.
    "auto" sends B = 1 to K2 and B = 200 (400 heads of 16 tokens) to K3;
    "flash" takes K2 on both sides (the JAX kernel in interpret mode, d
    padded to 128); on the CPU each wrapper runs its plain version."""
    routes = []
    for name in ("flash_attention", "flash_attention_batched", "flash_attention_packed"):
        real = getattr(tvit, name)
        monkeypatch.setattr(tvit, name, lambda *a, _f=real, _n=name: routes.append(_n) or _f(*a))
    x = rng.standard_normal((b, 16, 256)).astype(np.float32)
    jm = jvit.Attention(256, 2, dtype=jnp.float32, attn_impl=impl)
    params = random_params(jm, jnp.asarray(x[:1]), seed=6)
    tm = tvit.Attention(256, 2, attn_impl=impl)
    tm.load_state_dict({f"{name}.{p}": torch.from_numpy(
        np.array(params[name]["kernel"].T if p == "weight" else params[name]["bias"]))
        for name in ("qkv", "proj") for p in ("weight", "bias")}, strict=True)
    counts = (fa.flash_attention.launches, fa.flash_attention_batched.launches)
    with torch.no_grad():
        ours = tm(torch.from_numpy(x))
    assert (fa.flash_attention.launches, fa.flash_attention_batched.launches) == counts
    assert routes == [route]
    ref = jax.jit(lambda p, v: jm.apply({"params": p}, v))(params, jnp.asarray(x))
    assert rel_err(ours.numpy(), ref) < 1e-5


def test_jax_attention_reference_is_the_plain_route_of_k3(rng):
    """The JAX package's plain attention, which its Depth Pro runs off the
    TPU, and K3's plain version agree in fp32 at Depth Pro's shape."""
    q, k, v = (rng.standard_normal((5, 16, 577, 64)).astype(np.float32) for _ in range(3))
    ref = jax_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = fa.flash_attention_batched(*(torch.from_numpy(t) for t in (q, k, v)))
    assert np.max(np.abs(out.numpy() - np.asarray(ref))) < 1e-5


# --- Depth Pro modules --------------------------------------------------


def _configs(vit):
    jcfg = jdp.DepthProConfig(**GEO, hook_block_ids=(0, 1), vit_config=jvit.ViTConfig(
        **VITS[vit], patch_size=16, pretrain_img_size=GEO["window"]))
    tcfg = tdp.DepthProConfig(**GEO, hook_block_ids=(0, 1), vit_config=tvit.ViTConfig(
        **VITS[vit], patch_size=16, pretrain_img_size=GEO["window"]))
    return jcfg, tcfg


@pytest.fixture(scope="module", params=sorted(VITS))
def pair(request):
    """(ViT name, JAX DepthPro, its params, the port's DepthPro on them,
    an input image, the JAX outputs)."""
    jcfg, tcfg = _configs(request.param)
    jm = jdp.DepthPro(**HEAD, dtype=jnp.float32, attn_impl="xla", cfg=jcfg)
    x = np.random.default_rng(31).standard_normal((1, 512, 512, 3)).astype(np.float32) * 0.5
    params = random_params(jm, jnp.asarray(x), seed=17)
    lift_depth_pro_outputs(params)
    tm = tdp.DepthPro(tcfg, **HEAD)
    tm.load_state_dict(depth_pro_from_jax(params), strict=True)
    ref = jax.jit(lambda p, y: jm.apply({"params": p}, y))(params, jnp.asarray(x))
    return request.param, jm, params, tm.eval(), x, ref


@pytest.mark.parametrize("size,patch,stride", [(512, 128, 96), (256, 128, 64), (384, 128, 64)])
def test_split_and_merge_overlapping_match_jax(rng, size, patch, stride):
    x = rng.standard_normal((1, size, size, 3)).astype(np.float32)
    ref = jdp.split_overlapping(jnp.asarray(x), patch, stride)
    ours = tdp.split_overlapping(torch.from_numpy(x), patch, stride)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    k = (size - patch) // stride + 1
    assert ours.shape == (k * k, patch, patch, 3)
    feats = rng.standard_normal((k * k, 8, 8, 5)).astype(np.float32)
    stride_f = 8 * stride // patch
    merged = tdp.merge_overlapping(torch.from_numpy(feats), k, stride_f)
    np.testing.assert_array_equal(
        merged.numpy(), np.asarray(jdp.merge_overlapping(jnp.asarray(feats), k, stride_f)))
    p = (8 - stride_f) // 2
    assert merged.shape == (1, k * stride_f + 2 * p, k * stride_f + 2 * p, 5)
    with pytest.raises(ValueError):
        tdp.merge_overlapping(torch.from_numpy(feats[1:]), k, stride_f)


@pytest.mark.parametrize("name,dim_out,ups", [("upsample_latent0", 8, 3), ("upsample0", 16, 1)])
def test_project_upsample_matches_jax(pair, rng, name, dim_out, ups):
    _, _, params, tm, _, _ = pair
    dim = tm.cfg.vit.dim
    x = rng.standard_normal((1, 6, 5, dim)).astype(np.float32)
    ref = jdp.ProjectUpsample(dim_out, ups, jnp.float32).apply({"params": params[name]},
                                                               jnp.asarray(x))
    with torch.no_grad():
        ours = getattr(tm, name)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert ours.shape == (1, dim_out, 6 * 2 ** ups, 5 * 2 ** ups)
    assert rel_err(ours.permute(0, 2, 3, 1).numpy(), ref) < REL_TOL


def test_multires_decoder_matches_jax(pair, rng):
    _, _, params, tm, _, _ = pair
    dims, sides = (8, 8, 16, 32, 32), (64, 32, 16, 8, 4)
    levels = [rng.standard_normal((1, s, s, d)).astype(np.float32) for s, d in zip(sides, dims)]
    ref = jdp.MultiresConvDecoder(16, jnp.float32).apply(
        {"params": params["decoder"]}, [jnp.asarray(t) for t in levels])
    with torch.no_grad():
        ours = tm.decoder([torch.from_numpy(t).permute(0, 3, 1, 2) for t in levels])
    assert ours.shape == (1, 16, 64, 64)
    assert sorted(tm.decoder.convs) == ["0", "1", "3", "4"]  # widths other than 16
    assert rel_err(ours.permute(0, 2, 3, 1).numpy(), ref) < REL_TOL


def test_fov_network_matches_jax(pair, rng):
    _, _, params, tm, _, _ = pair
    dec = rng.standard_normal((1, 64, 64, 16)).astype(np.float32)
    cls = rng.standard_normal((1, tm.cfg.vit.dim)).astype(np.float32)
    ref = jdp.FOVNetwork(16, jnp.float32).apply({"params": params["fov"]}, jnp.asarray(dec),
                                                jnp.asarray(cls), (8, 8))
    with torch.no_grad():
        ours = tm.fov(torch.from_numpy(dec).permute(0, 3, 1, 2), torch.from_numpy(cls), (8, 8))
    assert ours.shape == (1,) and ours.dtype == torch.float32
    assert rel_err(ours.numpy(), ref) < REL_TOL


def test_depth_pro_matches_jax(pair, monkeypatch):
    """The whole model: pyramid, one batched patch-encoder pass with raw
    taps, seam-cropped merges, the image encoder, fusion, head and FoV. The
    "k3" ViT's patch encoder (35 x 8 heads of 65 tokens) takes K3's route."""
    name, _, _, tm, x, (ref_cid, ref_fov) = pair
    shapes = []
    plain = fa.flash_attention_batched

    def spy(q, k, v, scale=None):
        shapes.append(tuple(q.shape))
        return plain(q, k, v, scale)

    monkeypatch.setattr(tvit, "flash_attention_batched", spy)
    with torch.no_grad():
        cid, fov = tm(torch.from_numpy(x))
    assert shapes == ([(35, 8, 65, 16)] * 3 if name == "k3" else [])
    assert cid.shape == (1, 512, 512) and cid.dtype == torch.float32
    assert fov.shape == (1,) and fov.dtype == torch.float32
    assert rel_err(cid.numpy(), ref_cid) < REL_TOL
    assert rel_err(fov.numpy(), ref_fov) < REL_TOL
    with pytest.raises(ValueError):
        tm(torch.zeros(1, 256, 256, 3))
