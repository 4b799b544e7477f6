"""The port's CUDA kernels on a card (marker ``cuda``; each test skips where
``torch.cuda.is_available()`` is false, the kernels having no CPU mode).

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only the port's dependencies. ``tests/conftest.py`` imports JAX,
so there it runs without it::

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -q
"""

import math

import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu_torch.models.depth_pro import DepthProConfig
from monocular_depth_estimation_trt_tpu_torch.models.vggt import VGGTConfig
from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import flash_attention as fa
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import quant_matmul as qm
from monocular_depth_estimation_trt_tpu_torch.ops.quant import QuantLinear
from monocular_depth_estimation_trt_tpu_torch.registry import build_pipeline
from monocular_depth_estimation_trt_tpu_torch.runtime.engine import WARMUP_CALLS
from monocular_depth_estimation_trt_tpu_torch.weights.store import allow_random_weights

pytestmark = pytest.mark.cuda

D = fa.HEAD_DIM
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}  # bf16 output mantissa; fp32 order
K2_BF16_ULPS = 4  # K2 and K3 in bf16 against their plain version (chip_smoke.py)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(b, n, h, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((b, n, 3 * h * D), generator=gen).to(device, dtype)


@pytest.mark.parametrize("b,n,h,dtype", [
    (1, 1370, 6, torch.bfloat16), (2, 65, 3, torch.bfloat16), (1, 1, 6, torch.bfloat16),
    (1, 64, 16, torch.bfloat16), (2, 130, 3, torch.float32), (1, 1370, 6, torch.float32),
    # Video Depth Anything's 32-frame window folded into the batch (vits, vitl)
    (32, 1370, 6, torch.bfloat16), (32, 1370, 16, torch.bfloat16),
])
def test_k1_matches_its_plain_version(cuda, b, n, h, dtype):
    """K2's bar (``_check_bhnd``) on the (B, H, N, 64) views of the packed
    qkv tensor: K1 runs K2's online mode over them."""
    x = _qkv(b, n, h, dtype, cuda)
    before = fa.flash_attention_packed.launches
    out = fa.flash_attention_packed(x, h)
    torch.cuda.synchronize()
    assert fa.flash_attention_packed.launches == before + 1
    assert out.shape == (b, n, h * D) and out.dtype == dtype and out.is_cuda
    ref = fa.flash_attention_packed_reference(x, h)
    assert (out.float() - ref.float()).abs().max().item() < TOL[dtype]
    q, k, v = x.view(b, n, 3, h, D).permute(2, 0, 3, 1, 4)
    _check_bhnd(out.view(b, n, h, D).transpose(1, 2), q, k, v)


def test_k1_takes_a_scale_and_refuses_what_it_cannot_read(cuda):
    x = _qkv(1, 100, 2, torch.bfloat16, cuda)
    out = fa.flash_attention_packed(x, 2, scale=0.3)
    ref = fa.flash_attention_packed_reference(x, 2, 0.3)
    assert (out.float() - ref.float()).abs().max().item() < TOL[torch.bfloat16]
    wide = _qkv(1, 100, 2, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_packed(wide[:, ::2], 2)
    flat = torch.zeros(1 + 100 * 3 * 2 * D, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_packed(flat[1:].view(1, 100, 3 * 2 * D), 2)
    with pytest.raises(TypeError):
        fa.flash_attention_packed(x.half(), 2)


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_pipeline_on_the_card_goes_through_k1(cuda, precision):
    """A small DA-V2 (head_dim 64, 2 blocks) on the card: one K1 launch per
    block per frame in the engine's captured forward (the warm-up calls
    launch it too; replays go through no wrapper), and the depth of the card
    against the CPU fp32 path at the same weights."""
    kw = dict(encoder="small", input_size=70, model_kw=dict(
        vit_config=ViTConfig(dim=128, depth=2, num_heads=2, pretrain_img_size=70),
        head_features=16, head_out_channels=(8, 16, 32, 32), out_indices=(0, 1, 0, 1)))
    with allow_random_weights(True):
        card = build_pipeline("depth_anything_v2", precision=precision, **kw)
        cpu = build_pipeline("depth_anything_v2", precision="fp32", device="cpu", **kw)
    frame = np.random.default_rng(0).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    before = fa.flash_attention_packed.launches
    out = card(frame, viz=True)
    assert fa.flash_attention_packed.launches == before + 2 * (WARMUP_CALLS + 1)
    assert card.engine_for((48, 64), True).captured_launches["flash_attention_packed"] == 2
    card(frame, viz=True)  # a replay: no wrapper call
    assert fa.flash_attention_packed.launches == before + 2 * (WARMUP_CALLS + 1)
    ref = cpu(frame)["depth"]
    rel = np.abs(out["depth"] - ref).max() / np.abs(ref).max()
    assert rel < (5e-2 if precision == "bf16" else 1e-3)
    assert out["viz"].shape == (48, 64, 3) and out["viz"].dtype == np.uint8


def _bhnd(b, h, n, d, dtype, device, seed=0, strided=False):
    """q, k, v: three (B, H, N, d) tensors, or views of one (B, N, 3, H, d)
    qkv tensor (the layout the model paths hand over)."""
    gen = torch.Generator().manual_seed(seed)
    if strided:
        qkv = torch.randn((b, n, 3, h, d), generator=gen).to(device, dtype)
        return [qkv[:, :, i].transpose(1, 2) for i in range(3)]
    return [torch.randn((b, h, n, d), generator=gen).to(device, dtype) for _ in range(3)]


def _check_bhnd(out, q, k, v):
    """K2 or K3 against the plain version. In bf16 the two differ in when P
    is divided by the row sum (K2) or only in the rounding of P (K3), so
    they round a few bf16 steps apart at most: the bar is K2_BF16_ULPS steps
    at the largest output (a typical output at N = 5496 is about 0.022, so
    2e-2 alone could not see a skipped key tile); the plain version with one
    64-key tile left out must fail it; and the kernel is no further from
    fp32 attention than the plain bf16 route. Returns the error in steps."""
    b, h, n, d = q.shape
    assert out.shape == (b, h, n, d) and out.dtype == q.dtype and out.is_cuda
    ref = fa.flash_attention_reference(q, k, v).float()
    err = (out.float() - ref).abs().max().item()
    if q.dtype == torch.float32:
        assert err < TOL[q.dtype]
        return None
    step = 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)  # bf16 ulp
    bar = min(TOL[q.dtype], K2_BF16_ULPS * step)
    assert err <= bar, (err, step)
    if n >= 128:
        keep = torch.cat([torch.arange(64), torch.arange(128, n)]).to(q.device)
        skipped = fa.flash_attention_reference(q, k[:, :, keep], v[:, :, keep]).float()
        assert (skipped - ref).abs().max().item() > bar
    exact = fa.flash_attention_reference(q.float(), k.float(), v.float())
    plain = fa.attention_reference(q, k, v).float()
    assert (out.float() - exact).abs().max() <= (plain - exact).abs().max()
    return err / step


@pytest.mark.parametrize("b,h,n,d,dtype,strided", [
    (4, 16, 1374, 64, torch.bfloat16, False), (1, 16, 5496, 64, torch.bfloat16, False),
    (1, 2, 1, 64, torch.bfloat16, False), (2, 3, 63, 64, torch.bfloat16, False),
    (2, 3, 65, 64, torch.bfloat16, False), (2, 3, 130, 16, torch.bfloat16, False),
    (2, 3, 127, 64, torch.bfloat16, False), (2, 3, 128, 64, torch.bfloat16, False),
    (2, 3, 129, 64, torch.bfloat16, False), (2, 3, 255, 64, torch.bfloat16, False),
    (2, 3, 257, 64, torch.bfloat16, False), (2, 16, 577, 64, torch.bfloat16, True),
    (1, 16, 5496, 64, torch.bfloat16, True),
    (1, 4, 300, 64, torch.float32, False), (2, 3, 65, 16, torch.float32, False),
])
def test_k2_matches_its_plain_version(cuda, b, h, n, d, dtype, strided):
    """VGGT's frame and global shapes and the ends of the 64-row query
    tiles and 128-key tiles of the ring (N = 1, 127, 128, 129, 255, 257),
    contiguous and as views of one qkv tensor."""
    q, k, v = _bhnd(b, h, n, d, dtype, cuda, strided=strided)
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    _check_bhnd(out, q, k, v)


@pytest.mark.parametrize("b,h,n,d,dtype", [
    (35, 16, 577, 64, torch.bfloat16), (35, 16, 65, 64, torch.bfloat16),
    (2, 3, 1024, 64, torch.bfloat16), (35, 8, 1, 64, torch.bfloat16),
    (35, 8, 127, 64, torch.bfloat16), (35, 8, 128, 64, torch.bfloat16),
    (35, 8, 129, 64, torch.bfloat16), (35, 8, 255, 64, torch.bfloat16),
    (35, 8, 257, 64, torch.bfloat16),
    (35, 8, 65, 16, torch.float32), (35, 16, 577, 64, torch.float32),
])
def test_k3_matches_its_plain_version(cuda, b, h, n, d, dtype):
    """Depth Pro's patch-encoder shape (35 windows x 16 heads of 577 tokens)
    as views of one qkv tensor, and edges (the ends of the 64-row query
    tiles and 128-key tiles, N = 1024), with K2's bar: K3 divides P by the
    row sum before its cast, as its plain version does."""
    q, k, v = _bhnd(b, h, n, d, dtype, cuda, seed=2, strided=True)
    before = fa.flash_attention_batched.launches
    out = fa.flash_attention_batched(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention_batched.launches == before + 1
    _check_bhnd(out, q, k, v)


@pytest.mark.parametrize("d", [64, 16, 128])
@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_batched"])
def test_k2_and_k3_read_rotated_q_k_beside_a_strided_v(cuda, name, d):
    """A grid of 35 x 16 heads of 577 tokens with VGGT's operand layout:
    q and k non-contiguous views of one rotated (B, N, 2, H, d) buffer, v a
    strided view of the (B, N, 3, H, d) qkv output; d = 16 is zero-padded
    to 64 by the wrapper, d = 128 runs the two-region tiles."""
    gen = torch.Generator().manual_seed(5)
    qk = torch.randn((35, 577, 2, 16, d), generator=gen).to(cuda, torch.bfloat16)
    qkv = torch.randn((35, 577, 3, 16, d), generator=gen).to(cuda, torch.bfloat16)
    q, k = qk[:, :, 0].transpose(1, 2), qk[:, :, 1].transpose(1, 2)
    v = qkv[:, :, 2].transpose(1, 2)
    assert not q.is_contiguous() and not v.is_contiguous()
    out = getattr(fa, name)(q, k, v)
    torch.cuda.synchronize()
    _check_bhnd(out, q, k, v)


def test_k3_refuses_more_than_1024_tokens(cuda):
    q = torch.zeros((1, 2, 1025, D), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="1024"):
        fa.flash_attention_batched(q, q, q)


def test_k2_reads_strided_views_and_refuses_what_it_cannot_read(cuda):
    gen = torch.Generator().manual_seed(1)
    qkv = torch.randn((2, 100, 3, 4, D), generator=gen).to(cuda, torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # the VGGT layout
    out = fa.flash_attention(q, k, v, scale=0.3)
    ref = fa.flash_attention_reference(q, k, v, 0.3)
    assert (out.float() - ref.float()).abs().max().item() < TOL[torch.bfloat16]
    # the output is a (B, N, H, d) buffer: the reshape to the proj input is free
    assert out.transpose(1, 2).is_contiguous()
    d_strided = torch.zeros((2, 4, D, 100), device=cuda, dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError, match="stride"):
        fa.flash_attention(d_strided, k, v)
    flat = torch.zeros(1 + 2 * 4 * 100 * D, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(flat[1:].view(2, 4, 100, D), k, v)


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_batched"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [80, 96, 128])
@pytest.mark.parametrize("n", [1, 129, 577])
def test_k2_and_k3_at_head_dims_above_64(cuda, name, dtype, d, n):
    """d in (64, 128] runs the head-width-128 kernels (64 < d < 128
    zero-padded), with K2's bar and the dropped-tile check."""
    q, k, v = _bhnd(2, 3, n, d, dtype, cuda, seed=d)
    kernel = getattr(fa, name)
    before = kernel.launches
    out = kernel(q, k, v)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _check_bhnd(out, q, k, v)


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_batched"])
def test_head_dim_128_reads_each_64_column_half_of_v(cuda, name):
    """V's two 64-column halves are distinct functions of one another (a
    kernel that read one half twice, or swapped them, would be off by O(1)):
    the check of the descriptor's leading offset between V's two atoms."""
    gen = torch.Generator().manual_seed(7)
    q, k, lo = (torch.randn((4, 8, 300, 64), generator=gen) for _ in range(3))
    q, k = (torch.cat([t, torch.randn(t.shape, generator=gen)], -1) for t in (q, k))
    v = torch.cat([lo, 1.0 - 2.0 * lo.flip(-1)], -1)
    q, k, v = (t.to(cuda, torch.bfloat16) for t in (q, k, v))
    out = getattr(fa, name)(q, k, v)
    torch.cuda.synchronize()
    _check_bhnd(out, q, k, v)


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_batched"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [192, 256, 320])
@pytest.mark.parametrize("n,strided", [(1, False), (129, True), (577, False)])
def test_k2_and_k3_compute_heads_wider_than_128_on_a_card(cuda, name, dtype, d, n, strided):
    """d > 128 is zero-padded to a multiple of 128 and runs the wide loop
    (csrc/attention_wide.cuh), with K2's bar and the dropped-tile check."""
    q, k, v = _bhnd(2, 3, n, d, dtype, cuda, seed=d, strided=strided)
    kernel = getattr(fa, name)
    before = kernel.launches
    out = kernel(q, k, v)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _check_bhnd(out, q, k, v)


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_vggt_pipeline_on_the_card_goes_through_k1_and_k2(cuda, precision):
    """A small VGGT (head_dim 64: 2 ViT blocks, 2 alternating blocks) on the
    card: per captured forward, whatever S, one K1 launch per ViT block and
    two K2 launches per alternating block; the outputs against the CPU fp32
    path."""
    cfg = VGGTConfig(dim=128, depth=2, num_heads=2, head_layers=(0, 1, 0, 1),
                     vit_config=ViTConfig(dim=128, depth=2, num_heads=2, pretrain_img_size=70),
                     head_features=16, head_out_channels=(8, 16, 32, 32))
    with allow_random_weights(True):
        card = build_pipeline("vggt", precision=precision, input_size=70, vggt_cfg=cfg)
        cpu = build_pipeline("vggt", precision="fp32", input_size=70, vggt_cfg=cfg,
                             device="cpu")
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    views = rng.integers(0, 256, (3, 70, 70, 3), dtype=np.uint8)
    tol = 5e-2 if precision == "bf16" else 1e-3
    for run, arg, ref, engine in (
            (card, frame, cpu(frame), lambda: card.engine_for((48, 64))),
            (card.multi_view, views, cpu.multi_view(views), lambda: card.views_engine(3))):
        counts = (fa.flash_attention_packed.launches, fa.flash_attention.launches)
        out = run(arg)
        assert (fa.flash_attention_packed.launches - counts[0],
                fa.flash_attention.launches - counts[1]) == (2 * (WARMUP_CALLS + 1),
                                                             4 * (WARMUP_CALLS + 1))
        captured = engine().captured_launches
        assert (captured["flash_attention_packed"], captured["flash_attention"]) == (2, 4)
        for key in ("depth", "depth_conf", "pose_enc"):
            assert out[key].shape == ref[key].shape and np.isfinite(out[key]).all()
            rel = np.abs(out[key] - ref[key]).max() / np.abs(ref[key]).max()
            assert rel < tol, (key, rel)


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_depth_pro_pipeline_on_the_card_goes_through_k3_and_k1(cuda, precision):
    """A narrow Depth Pro at the real 1536 geometry (ViT dim 512, 8 heads, 2
    blocks) on the card: per captured frame, one K3 launch per patch-encoder
    block (35 windows x 8 heads of 577 tokens) and one K1 launch per
    image-encoder block; the inverse depth and focal against the CPU fp32
    path at the same weights."""
    kw = dict(model_kw=dict(
        cfg=DepthProConfig(vit_config=ViTConfig(dim=512, depth=2, num_heads=8, patch_size=16,
                                                pretrain_img_size=384),
                           hook_block_ids=(0, 1)),
        decoder_features=32, dims_encoder=(16, 32, 64, 64)))
    with allow_random_weights(True):
        card = build_pipeline("depth_pro", precision=precision, **kw)
        cpu = build_pipeline("depth_pro", precision="fp32", device="cpu", **kw)
    for pipe in (card, cpu):  # random output layers: depth off the clip, fov near 60 degrees
        with torch.no_grad():
            pipe.model.head_conv2.bias.fill_(1.0)
            pipe.model.fov.head.bias.fill_(60.0)
    frame = np.random.default_rng(0).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    counts = (fa.flash_attention_batched.launches, fa.flash_attention_packed.launches,
              fa.flash_attention.launches)
    out = card(frame, viz=True)
    n = WARMUP_CALLS + 1
    assert (fa.flash_attention_batched.launches - counts[0],
            fa.flash_attention_packed.launches - counts[1],
            fa.flash_attention.launches - counts[2]) == (2 * n, 2 * n, 0)
    captured = card.engine_for((480, 640), True).captured_launches
    assert (captured["flash_attention_batched"], captured["flash_attention_packed"]) == (2, 2)
    ref = cpu(frame)
    tol = 5e-2 if precision == "bf16" else 1e-3
    d, d_ref = out["depth"], ref["depth"]
    assert d.shape == (480, 640) and np.isfinite(d).all()
    rel = np.abs(1 / d - 1 / d_ref).max() / np.abs(1 / d_ref).max()
    assert rel < tol, rel
    assert abs(float(out["f_px"]) / float(ref["f_px"]) - 1) < tol
    assert out["viz"].shape == (480, 640, 3) and out["viz"].dtype == np.uint8


def _w8a8(m, k, n, dtype, device, lead=(), seed=0):
    """K4 operands: activations whose quantized values span the int8 range
    (some clip), random int8 weights, scales of a calibrated layer."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((*lead, m, k)).astype(np.float32)).to(device, dtype)
    wq = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8)).to(device)
    qmul = torch.from_numpy(rng.uniform(10.0, 60.0, k).astype(np.float32)).to(device)
    scale = torch.from_numpy(rng.uniform(1e-5, 1e-3, n).astype(np.float32)).to(device)
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(device)
    return x, wq, qmul, scale, bias


@pytest.mark.parametrize("m,k,n,dtype", [
    (1370, 1024, 3072, torch.bfloat16), (1370, 4096, 1024, torch.bfloat16),
    (20195, 1024, 4096, torch.bfloat16), (5496, 4096, 1024, torch.bfloat16),
    (1, 1024, 1024, torch.bfloat16), (1, 40, 136, torch.bfloat16), (17, 32, 8, torch.bfloat16),
    (130, 96, 1000, torch.bfloat16), (300, 1040, 520, torch.bfloat16),
    (1370, 1040, 3000, torch.bfloat16), (1370, 64, 3066, torch.bfloat16),
    (1370, 1024, 1024, torch.float32), (5, 40, 8, torch.float32), (130, 96, 136, torch.float32),
])
def test_k4_equals_its_plain_version(cuda, m, k, n, dtype):
    """Bit for bit: an exact int32 product and the same fp32 roundings; in
    bf16 (the persistent kernel) every output tile written exactly: where
    the wrapper allocates nothing else, the output lands in the block the
    allocator held NaN in just before. The bf16 shapes take both tile
    widths, ragged N on each (3000 and 3066 on 256-column tiles, 3066 with
    rows no multiple of 16 bytes) and K tails (1040, 64)."""
    x, wq, qmul, scale, bias = _w8a8(m, k, n, dtype, cuda)
    ref = qm.w8a8_matmul_reference(x, wq, qmul, scale, bias)
    poisoned = torch.full((m, n), float("nan"), dtype=dtype, device=cuda).data_ptr()
    before = qm.w8a8_matmul.launches
    out = qm.w8a8_matmul(x, wq, qmul, scale, bias)
    torch.cuda.synchronize()
    assert qm.w8a8_matmul.launches == before + 1
    assert out.shape == (m, n) and out.dtype == dtype and out.is_cuda
    assert torch.equal(out, ref)
    assert dtype != torch.bfloat16 or k % 16 or out.data_ptr() == poisoned


def test_k4_equals_its_plain_version_at_the_edge_shapes(cuda):
    """M in (1, 17, 130), K in (32, 40, 96) (40 is zero-padded to 48 in
    bf16), N in (8, 136, 1000), bf16 and fp32: 54 shapes, bit for bit."""
    bad = []
    for dtype in (torch.bfloat16, torch.float32):
        for m in (1, 17, 130):
            for k in (32, 40, 96):
                for n in (8, 136, 1000):
                    ops = _w8a8(m, k, n, dtype, cuda, seed=m + k + n)
                    if not torch.equal(qm.w8a8_matmul(*ops), qm.w8a8_matmul_reference(*ops)):
                        bad.append((m, k, n, dtype))
    assert not bad


def test_k4_takes_leading_dims_and_no_bias_and_refuses_what_it_cannot_write(cuda):
    x, wq, qmul, scale, _ = _w8a8(10, 64, 128, torch.bfloat16, cuda, lead=(2, 3))
    out = qm.w8a8_matmul(x, wq, qmul, scale)
    assert out.shape == (2, 3, 10, 128)
    assert torch.equal(out, qm.w8a8_matmul_reference(x, wq, qmul, scale))
    strided = x.transpose(1, 2)  # copied to rows of K by the wrapper
    assert torch.equal(qm.w8a8_matmul(strided, wq, qmul, scale),
                       qm.w8a8_matmul_reference(strided, wq, qmul, scale))
    with pytest.raises(TypeError, match="type of x"):
        qm.w8a8_matmul(x, wq, qmul, scale, out_dtype=torch.float32)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        qm.w8a8_matmul(x.half(), wq, qmul, scale)
    with pytest.raises(ValueError, match="K >= 1"):
        qm.w8a8_matmul(x[..., :0], wq[:, :0], qmul[:0], scale)


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_int8_pipeline_on_the_card_goes_through_k4(cuda, precision, monkeypatch):
    """A small DA-V2 int8 (head_dim 64, 2 blocks, forced past the small-encoder
    guard) on the card: four K4 launches and one K1 launch per block per
    captured frame; the depth tracks the CPU fp32 path at the same weights.
    ``precision`` is the reference's; the int8 graph computes in bf16."""
    monkeypatch.setenv("MDET_FORCE_INT8", "1")
    kw = dict(encoder="small", input_size=70, model_kw=dict(
        vit_config=ViTConfig(dim=128, depth=2, num_heads=2, pretrain_img_size=70),
        head_features=16, head_out_channels=(8, 16, 32, 32), out_indices=(0, 1, 0, 1)))
    calib = [np.random.default_rng(i).integers(0, 256, (70, 70, 3), dtype=np.uint8)
             for i in range(2)]
    with allow_random_weights(True):
        card = build_pipeline("depth_anything_v2", precision="int8", calib_images=calib, **kw)
        ref = build_pipeline("depth_anything_v2", precision=precision, device="cpu", **kw)
    assert sum(isinstance(m, QuantLinear) for m in card.model.modules()) == 8
    frame = np.random.default_rng(0).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    before = (qm.w8a8_matmul.launches, fa.flash_attention_packed.launches)
    out = card(frame, viz=True)
    assert (qm.w8a8_matmul.launches - before[0],
            fa.flash_attention_packed.launches - before[1]) == (8 * (WARMUP_CALLS + 1),
                                                                2 * (WARMUP_CALLS + 1))
    captured = card.engine_for((48, 64), True).captured_launches
    assert (captured["w8a8_matmul"], captured["flash_attention_packed"]) == (8, 2)
    want = ref(frame)["depth"].ravel()
    assert np.isfinite(out["depth"]).all()
    assert np.corrcoef(out["depth"].ravel(), want)[0, 1] > 0.98
    assert out["viz"].shape == (48, 64, 3) and out["viz"].dtype == np.uint8
