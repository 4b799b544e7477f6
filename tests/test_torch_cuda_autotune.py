"""The tile tuner (role K5) on a card (marker ``cuda``; each test skips where
``torch.cuda.is_available()`` is false): every candidate tile of K1 to K4
against its kernel's plain version at the shapes the tuner is run at, the
tuner's measurement and its persisted winners, and a one-device mesh that
leaves the served path as it was.

Imports neither JAX nor the JAX package; on the card's machine::

    python -m pytest tests/test_torch_cuda_autotune.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu_torch.ops.cuda import autotune
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import flash_attention as fa
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import quant_matmul as qm

pytestmark = pytest.mark.cuda

# the tuned shapes: K1 (B, N, H), K2/K3 (B, H, N, d), K4 (M, K, N)
K1_SHAPES = [(1, 1370, 6), (1, 3349, 16)]
K2_SHAPES = [(1, 16, 5496, 64), (1, 32, 4101, 128)]
K3_SHAPES = [(35, 16, 577, 64), (16, 16, 577, 128)]
K4_SHAPES = [(1370, 4096, 1024), (20195, 1024, 4096)]


@pytest.fixture
def cuda(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    monkeypatch.setenv("MDET_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("MDET_AUTOTUNE", raising=False)
    autotune.reset()  # the tiles another test's settings resolved
    yield torch.device("cuda")
    autotune.reset()


def _randn(shape, seed, device):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(device, torch.bfloat16)


def _within_bar(out, ref):
    err = (out.float() - ref.float()).abs().max().item()
    return err <= autotune.attention_bar(ref.float()), err


@pytest.mark.parametrize("b,n,h", K1_SHAPES)
def test_every_k1_tile_holds_the_bar(cuda, b, n, h):
    qkv = _randn((b, n, 3 * h * fa.HEAD_DIM), 0, cuda)
    ref = fa.flash_attention_packed_reference(qkv, h)
    for tile in autotune.candidates("flash_attention_packed", torch.bfloat16, fa.HEAD_DIM):
        with autotune.use_tile(tile):
            out = fa.flash_attention_packed(qkv, h)
        torch.cuda.synchronize()
        ok, err = _within_bar(out, ref)
        assert ok, (tile, err)


@pytest.mark.parametrize("name,shape", [("flash_attention", s) for s in K2_SHAPES]
                         + [("flash_attention_batched", s) for s in K3_SHAPES])
def test_every_k2_and_k3_tile_holds_the_bar(cuda, name, shape):
    q, k, v = (_randn(shape, seed, cuda) for seed in (1, 2, 3))
    ref = fa.flash_attention_reference(q, k, v)
    wrapper = getattr(fa, name)
    tiles = autotune.candidates(name, torch.bfloat16, shape[-1])
    assert len(tiles) >= 2
    for tile in tiles:
        with autotune.use_tile(tile):
            out = wrapper(q, k, v)
        torch.cuda.synchronize()
        ok, err = _within_bar(out, ref)
        assert ok, (tile, err)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", K4_SHAPES)
def test_every_k4_width_equals_the_plain_version(cuda, m, k, n, dtype):
    """Every tile width of each type: 128 and 256 in bf16, 128 in fp32."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((m, k), generator=gen).to(cuda, dtype)
    wq = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8).to(cuda)
    qmul = (torch.rand(k, generator=gen) * 40 + 20).to(cuda)
    scale = (torch.rand(n, generator=gen) * 1e-4).to(cuda)
    bias = torch.randn(n, generator=gen).to(cuda)
    ref = qm.w8a8_matmul_reference(x, wq, qmul, scale, bias)
    for width in autotune.candidates("w8a8_matmul", dtype, k):
        with autotune.use_tile(width):
            out = qm.w8a8_matmul(x, wq, qmul, scale, bias)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), width


def test_an_unknown_tile_raises(cuda):
    qkv = _randn((1, 64, 3 * 2 * fa.HEAD_DIM), 0, cuda)
    with autotune.use_tile(7), pytest.raises(RuntimeError, match="tile 7"):
        fa.flash_attention_packed(qkv, 2)


def test_the_tuner_measures_once_persists_and_is_captured(cuda, monkeypatch):
    """MDET_AUTOTUNE=1: the first eager launch of a shape measures every
    candidate and persists the winner; a second launch and a captured graph
    read it with no measurement."""
    monkeypatch.setenv("MDET_AUTOTUNE", "1")
    monkeypatch.setenv("MDET_AUTOTUNE_CHAIN", "4")
    qkv = _randn((1, 1370, 3 * 6 * fa.HEAD_DIM), 0, cuda)
    before, reports = autotune.measurements, len(autotune.reports)
    out = fa.flash_attention_packed(qkv, 6)
    torch.cuda.synchronize()
    assert autotune.measurements == before + 2
    report = autotune.reports[reports]
    assert report["default"] == 0 and all(r["ok"] for r in report["candidates"])
    with open(autotune.cache_path()) as f:
        import json

        entries = json.load(f)
    key = autotune.key("flash_attention_packed", torch.bfloat16, (1, 1370, 6, 64),
                       torch.cuda.get_device_name(0))
    assert entries == {key: autotune.tile_name("flash_attention_packed", 64, report["winner"])}
    ok, _ = _within_bar(out, fa.flash_attention_packed_reference(qkv, 6))
    assert ok
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.cuda.graph(graph):
        captured = fa.flash_attention_packed(qkv, 6)
    graph.replay()
    torch.cuda.synchronize()
    assert autotune.measurements == before + 2
    with autotune.use_tile(report["winner"]):
        eager = fa.flash_attention_packed(qkv, 6)
    assert torch.equal(captured, eager)


def test_without_the_switch_every_kernel_takes_its_default(cuda):
    assert not autotune.autotune_enabled()
    before = autotune.measurements
    qkv = _randn((1, 1370, 3 * 6 * fa.HEAD_DIM), 0, cuda)
    out = fa.flash_attention_packed(qkv, 6)
    with autotune.use_tile(0):
        default = fa.flash_attention_packed(qkv, 6)
    assert torch.equal(out, default)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((1370, 1024), generator=gen).to(cuda, torch.bfloat16)
    wq = torch.randint(-127, 128, (1024, 1024), generator=gen, dtype=torch.int8).to(cuda)
    qmul, scale = torch.ones(1024, device=cuda), torch.full((1024,), 1e-3, device=cuda)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    width = autotune.waves_width(1370, 1024, sms)
    with autotune.use_tile(width):
        want = qm.w8a8_matmul(x, wq, qmul, scale)
    assert torch.equal(qm.w8a8_matmul(x, wq, qmul, scale), want)
    assert autotune.measurements == before


def test_a_one_device_mesh_serves_the_plain_path_bit_for_bit(cuda):
    """DA-V2 vits with random weights: apply_mesh of the one-device mesh
    changes no tensor, no launch and no output."""
    from monocular_depth_estimation_trt_tpu_torch.parallel import single_device_mesh
    from monocular_depth_estimation_trt_tpu_torch.registry import build_pipeline
    from monocular_depth_estimation_trt_tpu_torch.weights.store import allow_random_weights

    frame = np.random.default_rng(0).integers(0, 256, (518, 518, 3), dtype=np.uint8)
    with allow_random_weights():
        pipe = build_pipeline("depth_anything_v2", encoder="vits")
        meshed = build_pipeline("depth_anything_v2", encoder="vits")
    plain = pipe(frame)["depth"]
    meshed.apply_mesh(single_device_mesh("cuda"))
    before = fa.flash_attention_packed.launches
    out = meshed(frame)["depth"]
    assert fa.flash_attention_packed.launches - before == 12 * 3  # warm-up x2 + capture
    assert np.array_equal(out, plain)
