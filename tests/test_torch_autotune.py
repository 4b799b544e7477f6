"""The tile tuner, role K5 (``ops/cuda/autotune.py``; the counterpart of the
JAX package's ``tests/test_autotune.py``), on the CPU: the candidates, the
defaults (the tiles every launch took before the tuner), the resolution
order, the persisted entries and the measurement's rules, with the card's
calls replaced where a test needs them. The measurement itself runs on the
card (``tests/test_torch_cuda_autotune.py``, ``chip_smoke.py``).
"""

import json
import os

import numpy as np
import pytest
import torch

import monocular_depth_estimation_trt_tpu.ops.pallas.autotune as jat
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import autotune as at
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import flash_attention as fa
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import quant_matmul as qm
from monocular_depth_estimation_trt_tpu_torch.runtime import kernel_timing

BF16 = torch.bfloat16


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("MDET_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("MDET_AUTOTUNE", raising=False)
    monkeypatch.setattr(at, "_CACHE", None)
    monkeypatch.setattr(at, "_MEMO", {})
    return tmp_path


def _fresh_process():
    """What a new process holds of the cache: nothing read, nothing resolved."""
    at.reset()


def test_candidates_are_the_instantiations_of_each_width():
    assert at.candidates("flash_attention_packed", BF16, 64) == (0, 1)
    for name in ("flash_attention", "flash_attention_batched"):
        assert at.candidates(name, BF16, 64) == (0, 1)
        assert at.candidates(name, BF16, 128) == (0, 1)
        assert at.candidates(name, BF16, 256) == (0,)  # the wide loop
        assert at.candidates(name, torch.float32, 64) == (0,)
    assert at.candidates("w8a8_matmul", BF16, 1024) == (128, 256)
    # the fp32 K4 runs the same GEMM at 128 columns alone: at 256 ptxas
    # serializes its wgmma chain (csrc/w8a8_matmul.cu)
    assert at.candidates("w8a8_matmul", torch.float32, 1024) == (128,)
    assert all(len(at.ATTENTION_TILES[d]) == len(at.candidates("flash_attention", BF16, d))
               for d in (64, 128))
    assert at.ATTENTION_TILES == {64: ("128k3s2c", "64k4s2c"), 128: ("64k2s2c", "128k3s1c")}
    # the fp32 K1 and K2: the split TF32 loop's one instantiation a head width
    assert at.ATTENTION_FP32_TILES == {64: ("64k3s1c",), 128: ("32k2s1c",)}
    assert at.candidates("flash_attention", torch.float32, 128) == (0,)
    assert at.candidates("flash_attention_packed", torch.float32, 64) == (0,)
    # the fp32 K3 runs the same split TF32 loop, one tile a head width
    assert at.FP32_TILED == ("flash_attention_packed", "flash_attention",
                             "flash_attention_batched")
    assert at.candidates("flash_attention_batched", torch.float32, 128) == (0,)


@pytest.mark.parametrize("m,n,want", [(1370, 1024, 128), (1370, 3072, 256), (1370, 4096, 256),
                                      (20195, 4096, 256), (20195, 1024, 256), (5496, 1024, 256)])
def test_k4_default_is_the_waves_rule(m, n, want):
    """On the H100's 132 SMs: 128 wide at M = 1370, N = 1024, 256 elsewhere
    on the paths (the rule csrc/w8a8_matmul.cu applied before the tuner)."""
    assert at.waves_width(m, n, 132) == want
    assert at.default_tile("w8a8_matmul", BF16, (m, n, 1024), torch.device("cuda", 0),
                           sms=132) == want


def test_attention_default_is_tile_0():
    for name in ("flash_attention_packed", "flash_attention", "flash_attention_batched"):
        assert at.default_tile(name, BF16, (1, 1370, 6, 64), torch.device("cpu")) == 0
    assert at.default_tile("w8a8_matmul", torch.float32, (8, 8, 8), torch.device("cpu")) == 128


def _never(*_):
    raise AssertionError("no launch expected")


def test_resolution_order_explicit_then_persisted_then_default(cache):
    shape, dev = (1, 1370, 6, 64), torch.device("cpu")
    args = ("flash_attention_packed", BF16, shape, dev, 64, _never, _never)
    assert at.tile_for(*args) == 0  # no entry, no switch: the default
    with open(at.cache_path(), "w") as f:
        json.dump({at.key("flash_attention_packed", BF16, shape, "cpu"): "64k4s2c"}, f)
    _fresh_process()
    assert at.tile_for(*args) == 1  # a persisted entry, honoured by a fresh load
    with at.use_tile(0):
        assert at.tile_for(*args) == 0  # an explicit tile wins
    assert at.tile_for(*args) == 1


@pytest.mark.parametrize("value", [1, "64k4s1c", "128k3s1c", None, [1], True])
def test_an_entry_that_names_no_candidate_counts_as_absent(cache, value):
    """An index (the meaning of which a later build may change), a name
    this build lacks or one of another head width: the default, and no
    measurement without MDET_AUTOTUNE=1."""
    shape, dev = (1, 1370, 6, 64), torch.device("cpu")
    with open(at.cache_path(), "w") as f:
        json.dump({at.key("flash_attention_packed", BF16, shape, "cpu"): value}, f)
    assert at.persisted_tile("flash_attention_packed", BF16, shape, "cpu", 64) is None
    assert at.tile_for("flash_attention_packed", BF16, shape, dev, 64, _never, _never) == 0


def test_a_stale_entry_is_measured_again_under_the_switch(cache, monkeypatch):
    card = _FakeCard(monkeypatch, {0: 2.0, 1: 1.0})
    launch, reference = _attention_case({0: 0.0, 1: 0.0}, card)
    k = at.key("flash_attention", BF16, (1, 2, 128, 64), "Fake H100")
    with open(at.cache_path(), "w") as f:
        json.dump({k: 1}, f)
    before = at.measurements
    assert at.tile_for("flash_attention", BF16, (1, 2, 128, 64), torch.device("cuda", 0), 64,
                       launch, reference) == 1
    assert at.measurements == before + 2
    with open(at.cache_path()) as f:
        assert json.load(f) == {k: "64k4s2c"}


def test_a_resolved_tile_is_memoized_until_the_cache_is_written_or_reset(
        cache, monkeypatch, tmp_path_factory):
    """A shape's later launches compute no path and read no file, whatever
    the settings say meanwhile; a write of the file drops the memo, and
    reset() reads the settings and the file again."""
    shape, dev = (1, 1370, 6, 64), torch.device("cpu")
    args = ("flash_attention_packed", BF16, shape, dev, 64, _never, _never)
    assert at.tile_for(*args) == 0
    cache_path = at.cache_path
    monkeypatch.setattr(at, "cache_path", _never)
    assert at.tile_for(*args) == 0  # no path computed, no file read
    monkeypatch.setattr(at, "cache_path", cache_path)
    other = tmp_path_factory.mktemp("other")
    monkeypatch.setenv("MDET_CACHE_DIR", str(other))
    with open(os.path.join(str(other), at.TUNING_FILE), "w") as f:
        json.dump({at.key("flash_attention_packed", BF16, shape, "cpu"): "64k4s2c"}, f)
    assert at.tile_for(*args) == 0
    at.reset()
    assert at.tile_for(*args) == 1
    at._persist(at.key("flash_attention", BF16, (1, 2, 3, 64), "cpu"), "64k4s2c")
    assert at._MEMO == {}


def test_keys_name_kernel_type_shape_and_card():
    assert at.key("w8a8_matmul", BF16, (1370, 1024, 4096), "NVIDIA H100 80GB HBM3") == (
        "w8a8_matmul|bfloat16|1370x1024x4096|NVIDIA H100 80GB HBM3")


def test_no_measurement_off_cuda(cache, monkeypatch):
    monkeypatch.setenv("MDET_AUTOTUNE", "1")
    before = at.measurements
    assert at.tile_for("flash_attention", BF16, (1, 16, 577, 64), torch.device("cpu"), 64,
                       _never, _never) == 0
    assert at.measurements == before and not os.path.exists(at.cache_path())


class _FakeCard:
    """The card's calls the measurement makes, on the CPU: a card name,
    a no-op synchronize, no capture, and a timing per tile."""

    def __init__(self, monkeypatch, times):
        monkeypatch.setenv("MDET_AUTOTUNE", "1")
        monkeypatch.setattr(at, "_card", lambda index: "Fake H100")
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
        self.timed = []

        def device_ms(fn, iters=20, repeats=3):
            fn()
            self.timed.append(self.current)
            return times[self.current]

        monkeypatch.setattr(kernel_timing, "device_ms", device_ms)


def _attention_case(tile_outputs, card):
    gen = torch.Generator().manual_seed(0)
    ref = torch.randn(1, 128, 2, 128, generator=gen)

    def launch(tile):
        card.current = tile
        return ref + tile_outputs[tile]

    return launch, lambda: ref


def test_the_fastest_candidate_within_the_bar_wins_and_persists(cache, monkeypatch):
    """Tile 1 holds the bar (4 bf16 steps) and beats the default: it wins
    and is persisted by its name."""
    card = _FakeCard(monkeypatch, {0: 3.0, 1: 2.0})
    launch, reference = _attention_case({0: 0.0, 1: 1e-3}, card)
    dev = torch.device("cuda", 0)
    before = at.measurements
    assert at.tile_for("flash_attention", BF16, (1, 2, 128, 128), dev, 128, launch,
                       reference) == 1
    assert at.measurements == before + 2 and card.timed == [0, 1]
    report = at.reports[-1]
    assert [(r["ok"], r["name"]) for r in report["candidates"]] == [(True, "64k2s2c"),
                                                                      (True, "128k3s1c")]
    assert report["default"] == 0 and report["winner"] == 1 and report["card"] == "Fake H100"
    with open(at.cache_path()) as f:
        assert json.load(f) == {
            at.key("flash_attention", BF16, (1, 2, 128, 128), "Fake H100"): "128k3s1c"}
    # a fresh process's load reads the winner and measures nothing
    _fresh_process()
    assert at.tile_for("flash_attention", BF16, (1, 2, 128, 128), dev, 128, _never,
                       _never) == 1
    assert at.measurements == before + 2


def test_a_fast_candidate_that_misses_the_bar_never_wins(cache, monkeypatch):
    """Tile 1 is fastest but misses the bar: it is not timed, and the
    default wins."""
    card = _FakeCard(monkeypatch, {0: 3.0, 1: 1.0})
    launch, reference = _attention_case({0: 0.0, 1: 0.5}, card)
    assert at.tile_for("flash_attention", BF16, (1, 2, 128, 128), torch.device("cuda", 0), 128,
                       launch, reference) == 0
    assert card.timed == [0]
    assert [r["ok"] for r in at.reports[-1]["candidates"]] == [True, False]


def test_a_default_that_misses_its_bar_raises_and_persists_nothing(cache, monkeypatch):
    card = _FakeCard(monkeypatch, {0: 1.0, 1: 2.0})
    launch, reference = _attention_case({0: 0.5, 1: 0.0}, card)
    with pytest.raises(RuntimeError, match="default tile 0 misses its bar"):
        at.tile_for("flash_attention_batched", BF16, (1, 2, 128, 64), torch.device("cuda", 0),
                    64, launch, reference)
    assert not os.path.exists(at.cache_path())


def test_k4_candidates_must_equal_the_plain_version_bit_for_bit(cache, monkeypatch):
    card = _FakeCard(monkeypatch, {128: 2.0, 256: 1.0})
    monkeypatch.setattr(at, "_sm_count", lambda index: 132)
    ref = torch.arange(12.0).reshape(3, 4)

    def launch(width):
        card.current = width
        return ref + (width == 256) * 2.0 ** -20  # one ulp off: not bit-equal

    assert at.tile_for("w8a8_matmul", BF16, (1370, 1024, 1024), torch.device("cuda", 0), 1024,
                       launch, lambda: ref) == 128
    assert [r["ok"] for r in at.reports[-1]["candidates"]] == [True, False]


def test_no_measurement_during_capture(cache, monkeypatch):
    _FakeCard(monkeypatch, {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert at.tile_for("flash_attention_packed", BF16, (1, 9, 2, 64), torch.device("cuda", 0),
                       64, _never, _never) == 0


def test_the_jax_tuning_file_is_never_read_or_written(cache, monkeypatch):
    """Both packages' cache directories default to ~/.cache/mdet_tpu; the
    JAX tuner's attention_tuning.json holds TPU blocks under other keys."""
    monkeypatch.setattr(jat, "_CACHE", None)
    jax_file = os.path.join(str(cache), "attention_tuning.json")
    with open(jax_file, "w") as f:
        json.dump({"bh16_n1408_d64": 352,
                   "flash_attention_packed|bfloat16|1x1370x6x64|cpu": 1}, f)
    stamp = os.stat(jax_file).st_mtime_ns
    assert at.cache_path() != jax_file and os.path.basename(at.cache_path()) == "cuda_tuning.json"
    assert at.tile_for("flash_attention_packed", BF16, (1, 1370, 6, 64), torch.device("cpu"),
                       64, _never, _never) == 0
    card = _FakeCard(monkeypatch, {0: 2.0, 1: 1.0})
    launch, reference = _attention_case({0: 0.0, 1: 0.0}, card)
    at.tile_for("flash_attention_packed", BF16, (1, 128, 2, 64), torch.device("cuda", 0), 64,
                launch, reference)
    assert os.stat(jax_file).st_mtime_ns == stamp
    assert jat.best_block(16, 1408, 64, np.float32) == 352  # the JAX tuner reads its own


def test_the_operators_resolve_no_tile_on_the_cpu(cache, monkeypatch):
    """On a CPU tensor each operator runs its plain version: no tile is
    resolved (the CUDA registrations resolve it) and nothing is written."""
    monkeypatch.setenv("MDET_AUTOTUNE", "1")
    monkeypatch.setattr(at, "tile_for", _never)
    qkv = torch.randn(1, 96, 3 * 2 * 64, generator=torch.Generator().manual_seed(0))
    # (the CPU's sgemm may round the last bit by the operands' alignment)
    torch.testing.assert_close(fa.flash_attention_packed(qkv, 2),
                               fa.flash_attention_packed_reference(qkv, 2), rtol=1e-6, atol=1e-6)
    x, wq = torch.randn(5, 32), torch.randint(-127, 128, (8, 32), dtype=torch.int8)
    qmul, scale = torch.ones(32), torch.full((8,), 1e-2)
    assert torch.equal(qm.w8a8_matmul(x, wq, qmul, scale),
                       qm.w8a8_matmul_reference(x, wq, qmul, scale))
    assert not os.path.exists(at.cache_path())
