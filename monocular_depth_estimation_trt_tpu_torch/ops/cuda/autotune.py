"""Per-shape tile tuner of the kernels K1 to K4, role K5 (counterpart of the
JAX package's ``ops/pallas/autotune.py``).

The JAX tuner times every legal q-block of a padded attention shape on a
TPU and persists the winner. Here each kernel's CUDA operator asks
:func:`tile_for` for its tile at every launch, and the tile is resolved in
this order:

1. an explicit tile (:func:`use_tile`), else
2. the persisted entry of the shape: ``cuda_tuning.json`` under
   ``config.cache_dir()``, whose keys name the kernel, the operand type, the
   shape the kernel computes (after the wrapper's padding) and the card, and
   whose values name the tile (an attention instantiation by its keys,
   stages and CTAs an SM, e.g. ``128k3s2c``; K4's tile width). An entry that
   names no candidate of its kernel (written for another build of the
   kernels) counts as absent. Else
3. the default: the tile every launch took before the tuner existed, tile
   0 of ``csrc/attention_sm90.cuh`` for K1 to K3 (128 keys x 3 stages at
   d = 64, 64 keys x 2 stages at d = 128) and K4's waves rule
   (:func:`waves_width`).

With ``MDET_AUTOTUNE=1``, a CUDA launch of a shape that has no entry, made
outside CUDA-graph capture, first measures every candidate on the call's
own operands. Each candidate's output is held against the kernel's plain
version to the kernel's bar (K1 to K3: 4 bf16 steps at the largest output,
at most 2e-2; K4: bit equality) and timed with CUDA events over a chain of
``MDET_AUTOTUNE_CHAIN`` (16) back-to-back calls queued behind a spin kernel
(``runtime/kernel_timing.py::device_ms``: the card's time per call, which a
captured graph replays; back-to-back calls alone would read the host's pace
where a call costs the host more than its kernel). The fastest candidate that
holds its bar is persisted; one that fails never wins, and a default that
fails raises. So an ``Engine``'s eager warm-up calls tune a new shape, and
its captured graph carries the winner. Nothing is measured off CUDA. The
JAX package's ``attention_tuning.json`` (TPU blocks under other keys) in
the same directory is never read or written.

A launch pays one dict lookup for its tile. A shape's tile is resolved at
its first launch in a process (the settings read then, the file loaded once
per cache path, as the JAX tuner loads its file once) and memoized per
kernel, type, shape and device; a measurement's write drops the memo, and
:func:`reset` forgets the memo and the loaded file, as a new process starts.

The candidates: the bf16 attention mainloop's instantiations at head width
64 and 128 (:data:`ATTENTION_TILES`, in the order of the C entries' tile
index) and K4's two output tile widths in bf16 (:data:`W8A8_WIDTHS`). The
fp32 kernels and K2/K3's wide heads (d > 128, on each mainloop's wide
form) have one tile each: for the fp32 K1, K2 and K3 the split TF32
mainloop's one instantiation a head width (:data:`ATTENTION_FP32_TILES`),
their default under the fp32 keys; for the fp32 K4 the GEMM's 128-column
tile (:data:`W8A8_FP32_WIDTH`).
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

TUNING_FILE = "cuda_tuning.json"
AUTOTUNE_ENV = "MDET_AUTOTUNE"
CHAIN_ENV = "MDET_AUTOTUNE_CHAIN"

# csrc/attention_sm90.cuh::dispatch_tile, by head width, in the order of the C
# entries' tile index (0 is the default): keys per K/V tile, stages of the
# ring, CTAs an SM
ATTENTION_TILES = {
    64: ("128k3s2c", "64k4s2c"),
    128: ("64k2s2c", "128k3s1c"),
}
# csrc/attention_sm90_f32.cuh::Head64 / Head128: the fp32 K1, K2 and K3's one
# instantiation a head width (keys per K/V tile, stages, CTAs an SM)
ATTENTION_FP32_TILES = {64: ("64k3s1c",), 128: ("32k2s1c",)}
FP32_TILED = ("flash_attention_packed", "flash_attention", "flash_attention_batched")
W8A8_WIDTHS = (128, 256)  # K4's bf16 output tile widths
# the fp32 K4's one width: at 256 columns ptxas serializes the GEMM's wgmma
# chain within the 168 registers a thread its 384-thread CTA gets
W8A8_FP32_WIDTH = 128
W8A8_ROWS = 128  # K4's output rows per tile
# The waves rule: a 256-wide tile takes WIDE_256_COST / 4 of a 128-wide one's
# time (1.2 to 1.45 measured on the H100 at the paths' shapes, PERF.md)
WIDE_256_COST = 5
BF16_STEPS = 4  # K1 to K3's bar in bf16 steps at the largest output
BF16_TOL = 2e-2  # and at most this (the JAX package's packed-kernel bar)

class _Explicit(threading.local):
    tile: Optional[int] = None  # this thread's use_tile, None outside one


_LOCK = threading.Lock()
_LOCAL = _Explicit()
_CACHE: Optional[Tuple[str, Dict[str, object]]] = None  # (path, entries)
_MEMO: Dict[tuple, int] = {}  # (kernel, dtype, shape, device) -> the resolved tile

measurements = 0  # candidates this process has timed
reports = []  # one record per shape this process has tuned


def cache_path() -> str:
    from monocular_depth_estimation_trt_tpu_torch.config import cache_dir

    return os.path.join(cache_dir(), TUNING_FILE)


def _entries() -> Dict[str, object]:
    """The persisted entries (read once per cache path)."""
    global _CACHE
    path = cache_path()
    if _CACHE is None or _CACHE[0] != path:
        entries = {}
        if os.path.exists(path):
            with open(path) as f:
                entries = json.load(f)
        _CACHE = (path, entries)
    return _CACHE[1]


def reset() -> None:
    """Forget the resolved tiles and the loaded file: each shape's next
    launch reads the settings and the file again."""
    global _CACHE
    with _LOCK:
        _CACHE = None
        _MEMO.clear()


def _persist(key: str, value) -> None:
    entries = _entries()
    entries[key] = value
    _MEMO.clear()
    path = cache_path()
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(entries, f, indent=1, sort_keys=True)
    os.replace(tmp, path)  # atomic: a concurrent reader sees all or nothing


def waves_width(m: int, n: int, sms: int) -> int:
    """K4's default tile width: 256 columns halve the quantize work and the
    x traffic per operation, 128 give twice the tiles where 256 would leave
    SMs idle; the one with the smaller waves x time per tile wins. At
    M = 1370, N = 1024 it picks 128 on 132 SMs, elsewhere on the paths 256."""
    rows = -(-m // W8A8_ROWS)
    waves128 = -(-(rows * -(-n // 128)) // sms)
    waves256 = -(-(rows * -(-n // 256)) // sms)
    return 256 if waves256 * WIDE_256_COST < waves128 * 4 else 128


def candidates(kernel: str, dtype: torch.dtype, width: int) -> Tuple[int, ...]:
    """The tiles ``kernel`` may run in ``dtype`` at head width ``width`` (K1
    to K3; ignored for K4)."""
    if kernel == "w8a8_matmul":
        return W8A8_WIDTHS if dtype == torch.bfloat16 else (W8A8_FP32_WIDTH,)
    if dtype != torch.bfloat16:
        tiles = ATTENTION_FP32_TILES if kernel in FP32_TILED else {}
        return tuple(range(len(tiles.get(width, ("one loop",)))))
    return tuple(range(len(ATTENTION_TILES.get(width, ("wide form",)))))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _card(index: int) -> str:
    return torch.cuda.get_device_name(index)


def _device_name(device: torch.device) -> str:
    if device.type != "cuda":
        return device.type
    return _card(device.index if device.index is not None else torch.cuda.current_device())


def default_tile(kernel: str, dtype: torch.dtype, shape: Sequence[int],
                 device: torch.device, sms: Optional[int] = None) -> int:
    """The tile every launch took before the tuner: 0 for K1 to K3, the
    waves rule for K4 in bf16 (``shape`` = (M, N, K); ``sms`` defaults to
    the card's), its one width in fp32."""
    if kernel != "w8a8_matmul":
        return 0
    if dtype != torch.bfloat16:
        return W8A8_FP32_WIDTH
    if sms is None:
        sms = _sm_count(device.index if device.index is not None else torch.cuda.current_device())
    return waves_width(shape[0], shape[1], sms)


def key(kernel: str, dtype: torch.dtype, shape: Sequence[int], card: str) -> str:
    return f"{kernel}|{str(dtype).replace('torch.', '')}|{'x'.join(map(str, shape))}|{card}"


def tile_name(kernel: str, width: int, tile: int):
    """The persisted value of a bf16 tile: the attention instantiation's
    name at head width ``width``, K4's tile width."""
    return tile if kernel == "w8a8_matmul" else ATTENTION_TILES[width][tile]


def persisted_tile(kernel: str, dtype: torch.dtype, shape: Sequence[int], card: str,
                   width: int) -> Optional[int]:
    """The tile the cache file holds for a shape: None where it holds none,
    or a value that names no candidate (written for other kernels)."""
    cands = candidates(kernel, dtype, width)
    if len(cands) < 2:
        return None
    value = _entries().get(key(kernel, dtype, shape, card))
    names = {tile_name(kernel, width, t): t for t in cands}
    if isinstance(value, bool) or not isinstance(value, (str, int)):
        return None
    return names.get(value)


@contextlib.contextmanager
def use_tile(tile: int):
    """Launches of this thread take ``tile`` (a candidate of their kernel)
    inside the block, whatever the cache says."""
    previous = _LOCAL.tile
    _LOCAL.tile = tile
    try:
        yield
    finally:
        _LOCAL.tile = previous


def autotune_enabled() -> bool:
    return os.environ.get(AUTOTUNE_ENV, "0") == "1"


def attention_bar(ref: torch.Tensor) -> float:
    """K1 to K3's bar against the plain version: 4 bf16 steps at the largest
    output, at most 2e-2."""
    top = ref.abs().max().item()
    step = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    return min(BF16_TOL, BF16_STEPS * step)


def tile_for(kernel: str, dtype: torch.dtype, shape: Sequence[int], device: torch.device,
             width: int, launch: Callable[[int], torch.Tensor],
             reference: Callable[[], torch.Tensor]) -> int:
    """The tile of one launch: explicit, persisted, measured (``MDET_AUTOTUNE=1``
    on CUDA outside capture) or default. ``launch(tile)`` runs the kernel at
    a tile and returns its output, ``reference()`` the plain version's; the
    measurement calls them, and the caller launches the tile returned."""
    explicit = _LOCAL.tile
    if explicit is not None:
        return explicit
    memo = (kernel, dtype, shape, device)
    tile = _MEMO.get(memo)
    if tile is not None:
        return tile
    with _LOCK:
        card = _device_name(device)
        cands = candidates(kernel, dtype, width)
        tile = persisted_tile(kernel, dtype, shape, card, width)
        if tile is None:
            tile = default_tile(kernel, dtype, shape, device)
            if len(cands) > 1 and device.type == "cuda" and autotune_enabled():
                if torch.cuda.is_current_stream_capturing():
                    return tile  # not memoized: a later eager launch measures
                tile = _measure(kernel, dtype, shape, card, width, cands, tile, launch,
                                reference)
                _persist(key(kernel, dtype, shape, card), tile_name(kernel, width, tile))
        _MEMO[memo] = tile
        return tile


def _measure(kernel, dtype, shape, card, width, cands, default, launch, reference) -> int:
    """Each candidate against the plain version, then timed; the fastest
    that holds the bar wins."""
    global measurements
    from monocular_depth_estimation_trt_tpu_torch.runtime.kernel_timing import device_ms

    chain = max(1, int(os.environ.get(CHAIN_ENV, "16")))
    ref = reference()
    exact = kernel == "w8a8_matmul"
    bar = 0.0 if exact else attention_bar(ref.float())
    rows = []
    for tile in cands:
        out = launch(tile)
        torch.cuda.synchronize()
        if exact:
            ok = bool(torch.equal(out, ref))
            err = (out.float() - ref.float()).abs().max().item()
        else:
            err = (out.float() - ref.float()).abs().max().item()
            ok = err <= bar
        ms = device_ms(lambda: launch(tile), iters=chain, repeats=3) if ok else None
        measurements += 1
        rows.append({"tile": tile, "name": tile_name(kernel, width, tile), "max_abs_err": err,
                     "ok": ok, "ms": ms})
    by_tile = {r["tile"]: r for r in rows}
    if not by_tile[default]["ok"]:
        raise RuntimeError(f"{kernel} {tuple(shape)}: the default tile {default} misses its bar "
                           f"{bar} against the plain version: {by_tile[default]}")
    winner = min((r for r in rows if r["ok"]), key=lambda r: r["ms"])["tile"]
    reports.append({"kernel": kernel, "dtype": str(dtype).replace("torch.", ""),
                    "shape": list(shape), "card": card, "bar": bar, "chain": chain,
                    "default": default, "winner": winner, "candidates": rows})
    return winner
