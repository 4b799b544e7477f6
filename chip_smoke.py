#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printed as one JSON line; any failure exits non-zero:

1. device: card name and power limit, torch/CUDA versions, ``nvcc --version``;
2. build: compiles ``monocular_depth_estimation_trt_tpu_torch/csrc/*.cu``
   with nvcc into the package's ``_build/`` directory and loads it, with
   ptxas's registers and spills per kernel; then ``sass``: the HGMMA (bf16
   wgmma; IGMMA for K4's int8) and UTMALDG (TMA load) instructions of each
   kernel in ``cuobjdump -sass`` (the bf16 K1, K2 (both head widths), K3
   (both) and K4 (both tile widths) must have both);
3. kernel checks: each kernel's wrapper (K1 packed-qkv attention, K2
   (B, H, N, d) attention and K3 exact-softmax attention of many short
   heads, all three on the TMA + wgmma mainloop of
   ``csrc/attention_sm90.cuh`` in bf16, K2 and K3 at head widths 64 and 128,
   and above 128 on the simple loop of ``csrc/attention_wide.cuh``;
   K4 the fused w8a8 matmul, a TMA + wgmma int8 GEMM in bf16) against its
   plain PyTorch version on the card, at the main paths' shapes and edge
   shapes (for the attention kernels the ends of the 64-row query tiles and
   128-key tiles: N = 1, 63, 65, 127, 128, 129, 255, 257, 577, and head
   widths 16, 80, 96, 128, 192, 256, 320; K4 bit for bit), with timings of the kernel and
   one library call (for K4 the chain quantize, ``torch._int_mm``, rescale,
   and the bf16 ``torch.matmul`` of the same shape) as device time
   (``kernel_ms``, ``library_ms``: CUDA events around calls queued behind a
   spin kernel, so that the host's time per call is hidden), the kernel and
   the plain version also from CUDA events around back-to-back calls
   (``kernel_event_ms``, ``plain_ms``), the card's bound, and the host time
   of one wrapper call (the attention kernels encode four TMA tensor maps a
   call, K4 two), all three from
   ``monocular_depth_estimation_trt_tpu_torch/runtime/kernel_timing.py``;
4. main path: ``build_pipeline("depth_anything_v2", encoder="vits")`` on the
   card with seeded random weights: two frames, a batch of two with the viz
   epilogue, the metric variant, each through a captured engine
   (``runtime/engine.py``: WARMUP_CALLS eager calls, then one captured
   call; the wrappers count both, a replay goes through none); the launch
   counts of every kernel are read over exactly this run, and each
   engine's captured forward holds 12 K1 launches; then the bf16 depth
   against the same pipeline with plain attention and against the fp32
   path, and the fp32 pipeline on the card against the CPU;
5. VGGT path: ``build_pipeline("vggt")`` at full size (ViT-L patch embed, 24
   alternating blocks): one 480x640 frame with the viz epilogue, 4 views,
   then 8 views, with the counts set to 0 just before and read just after
   (24 K1 + 48 K2 per captured forward); then its bf16 outputs against
   plain attention and the fp32 path for two weight seeds and three frames,
   and the fp32 path on the card against the CPU;
6. Depth Pro path: ``build_pipeline("depth_pro")`` at full size (two
   ViT-L/16@384 encoders, 1536 input): a 480x640 frame with the viz
   epilogue and a 1536x1536 frame, with the counts set to 0 just before and
   read just after (24 K3 + 24 K1 per captured forward); then its bf16
   outputs against plain attention and the fp32 path for two weight seeds
   and two frames, and the fp32 path on the card against the CPU with the
   ViT depth cut to 6 blocks (hooks at blocks 2 and 5);
7. metric_families_path: ``depth_anything_v3`` (vitl 518²),
   ``metric3d_v2`` (vitl on the 616x1064 canvas, ``iters=4``), ``moge2``
   (vits 291x518, 1800 tokens) and ``metric_anything`` (vitl 518², 3600
   tokens) at full width on the card, each with its own counts set to 0 just
   before and read just after (per captured forward 24, 24, 12 and 24 K1, no
   K2/K3/K4), two frames each (a 480x640 frame with the viz epilogue, then
   one at the model's input size), outputs finite where they must be (the
   MoGe pair: inf off its mask); then the bf16 kernel route against plain
   attention and the fp32 path for two weight seeds and the two frames (the
   MoGe pair on its model's outputs), and the fp32 path on the card against
   the CPU, the ViT-L families cut to 4 blocks; then single_image_families_path:
   ``unidepth_v2`` and ``unik3d`` (vitb 518², 4 registers), ``sidepth`` (two
   vits stacks, 518²), ``geocalib`` (vits 322² and its 10-step camera fit)
   and ``prior_depth_anything`` (VGGT S=1 depth-only and the vits refiner) in
   the same way (per captured forward 12, 12, 24, 12 K1, and 48 K1 + 48 K2;
   GeoCalib's fields compared, its roll, pitch and focal recorded; the fp32
   comparison with every ViT, and Prior Depth Anything's VGGT, cut to 4
   blocks); then ``geocalib_fit``: GeoCalib's camera fit on the fields of
   a known camera (exact, and noisy under uneven weights), eager and
   through an engine, against the camera and the CPU's fit;
8. int8 paths: ``build_pipeline(name, precision="int8", calib_images=...)``
   for DA-V2 vitl, depth_pro, vggt, metric3d_v2 and unidepth_v2 at full
   size, each with its own counts set to 0 just before and read just after
   (per captured forward: 96 K4 + 24 K1; 192 K4 + 24 K3 + 24 K1; 288 K4 + 24
   K1 + 48 K2; 96 K4 + 24 K1; 48 K4 + 12 K1), two frames each (the first
   with the viz epilogue) and 4 views for vggt; then the int8 outputs
   against the bf16 and fp32 routes for two weight seeds and two frames;
   and unik3d int8's counted run alone (48 K4 + 12 K1 a forward);
9. engine: an engine each for vits, vitl, int8 vitl, vggt S=1 and S=4,
   depth_pro 1536², int8 unidepth_v2 and the nine single-image families at
   their input sizes,
   against the eager forward it captures: the same kernel
   launches per forward, output buffers filled with NaN before the first
   replay, the replay's outputs finite and equal to the eager forward's bit
   for bit (else within ENGINE_REL_TOL, recorded), a result that survives
   the next call; build seconds per engine;
10. cli: ``python -m monocular_depth_estimation_trt_tpu_torch run
   depth_anything_v2 --encoder vits --pointcloud --benchmark`` on a seeded
   480x640 PNG in a process of its own (npz depth equal to this process's
   pipeline bit for bit; viz and ``.ply`` written), ``views vggt`` on 4
   PNGs, ``run depth_pro`` on this process's weights (``_fov.json`` against
   its f_px), ``run moge2 --mesh --mesh-format glb``, ``run unidepth_v2``
   (``_fov.json`` from its intrinsics) and ``run geocalib`` (the
   calibration lines) on this process's weights (every npz output equal to
   the pipeline's bit for bit);
11. server: ``DepthServer`` over vits on port 0 with max_batch 4: 8
   concurrent PNG requests, 2 of another size, a bad body (400), an unknown
   model (404), ``format=jpg`` (501 without a JPEG codec); each npz answer
   equal to ``batch_call`` on the same padded bucket, or to the
   single-frame call, bit for bit; ``/v1/stats``;
12. speed: ``DepthPipeline.benchmark`` (through the engine, "graph") and
   the same step through the eager forward ("eager") in turns eager,
   graph, graph, eager for vits, vitl, int8 vitl, vggt S=1 and S=4
   (``benchmark_views``), depth_pro 1536² and the nine single-image
   families at their input sizes; int8 depth_pro, vggt, metric3d_v2 and
   unidepth_v2 through their engines; vits int8 (forced) against vits bf16
   in alternating turns;
13. profile: device time by kernel, device busy time and idle share of a
   graph replay of each path (and of the eager forward of vits, vggt S=4,
   depth_pro, metric3d_v2, moge2, geocalib, unidepth_v2 and unik3d, with
   the device time of the last two's decoder attention), from
   ``torch.profiler``.

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import subprocess
import sys
import time

from monocular_depth_estimation_trt_tpu_torch.runtime.engine import WARMUP_CALLS
from monocular_depth_estimation_trt_tpu_torch.runtime.kernel_timing import (
    device_ms, event_ms, host_us)

REPO = os.path.dirname(os.path.abspath(__file__))

BF16_TOL = 2e-2  # bf16 output mantissa (the JAX package's packed-kernel bar)
FP32_TOL = 1e-4  # fp32: summation order only
# K2 in bf16 against its plain version, in bf16 steps (ulps) at the largest
# output: the two differ in when P is divided by the row sum, which moves
# the fp32 value before the last cast by far less than a step, so they
# round at most a step apart. 2e-2 would be the size of a typical output at
# VGGT's global shapes (std about sqrt(e/N): 0.022 at N = 5496), where a
# kernel that skipped a key tile would still pass.
K2_BF16_ULPS = 4
# Whole-path bf16 depth, kernel route vs plain attention route, as
# max|a - b| / max|b|: both run every op in bf16 (3.9e-3 relative per
# rounding) and the plain route also rounds the scores to bf16 before the
# softmax, so the two drift apart by a few bf16 steps over 12 blocks.
PATH_BF16_REL_TOL = 5e-2
# Whole-path fp32 depth, card vs CPU: summation order only, TF32 off.
PATH_FP32_REL_TOL = 1e-3
# VGGT, bf16 kernel route against the plain route, as max rel, at every
# (weight seed, frame) of the comparison: about twice the largest of six
# readings (2 seeds x 3 frames; PERF.md), far below the O(1) differences of
# a wrong route. VGGT's 48 bf16 blocks drift further than DA-V2's 12: the
# plain route alone reads up to 7.5e-2 from fp32 on depth. Confidence
# (1 + exp of a logit) turns the logit's absolute bf16 error into a
# relative one, and pose_enc has 9 values a view.
PATH_BF16_VGGT_REL_TOL = {"depth": 1e-1, "depth_conf": 7.5e-2, "pose_enc": 1.5e-1}
PARITY_WEIGHT_SEEDS = (0, 1)
# ... and, averaged over the readings, the kernel route's distance from fp32
# is at most this multiple of the plain route's: it adds no error beyond the
# bf16 rounding that the plain route already has (readings 0.88 to 1.06; one
# reading alone swings 0.3 to 2x on pose's 9 values).
PATH_BF16_ROUTE_RATIO = 1.5

# The fp32 card-vs-CPU comparison runs the full 1536 geometry and widths
# with the ViT depth cut to 6 blocks, hooked at blocks 2 and 5 (12 blocks and
# hooks 5 and 11 until the metric families' phases needed the card time).
DEPTH_PRO_CPU_VIT_DEPTH = 6
DEPTH_PRO_CPU_HOOKS = (2, 5)

# int8 serving against its fp32 path, at 2 weight seeds x 2 frames per
# family: Pearson r above the JAX package's bar (tests/test_quant.py) at
# every reading, and max |int8 - fp32| / max |fp32| below these bars, about
# twice the largest of the four readings per output (PERF.md): DA-V2 depth
# 3.3e-2; Depth Pro inverse depth 3.2e-2, f_px 1.8e-3; VGGT depth 6.0e-2,
# confidence 3.8e-2, pose 9.2e-2; Metric3D V2 depth 4.1e-2, confidence
# 1.5e-2. The bf16 route alone reads up to 2.7e-2, 2.0e-2, 1.8e-3, 4.5e-2,
# 3.3e-2, 3.9e-2, 3.0e-2 and 1.1e-2 from fp32 there. UniDepth V2 (its first
# card run): depth 2.8e-3, points 1.2e-2, confidence 1.8e-3, intrinsics 1.0e-2,
# the bf16 route alone up to 3.5e-3, 1.3e-2, 2.4e-3 and 1.6e-2.
INT8_PEARSON_MIN = 0.98
INT8_REL_TOL = {
    "depth_anything_v2": {"depth": 7.5e-2},
    "depth_pro": {"inverse_depth": 7.5e-2, "f_px": 5e-3},
    "vggt": {"depth": 1.2e-1, "depth_conf": 7.5e-2, "pose_enc": 2e-1},
    "metric3d_v2": {"depth": 1e-1, "confidence": 3e-2},
    "unidepth_v2": {"depth": 7.5e-3, "pts_3d": 3e-2, "confidence": 4e-3, "intrinsics": 3e-2},
}

# replay against eager where a library call picks another algorithm under
# capture (max |graph - eager| / max |eager|); equal bit for bit otherwise
ENGINE_REL_TOL = 1e-3
VGGT_BENCH = dict(warmup=3, iterations=20, latency_iterations=10)
DEPTH_PRO_BENCH = dict(warmup=3, iterations=20, latency_iterations=10)
FAMILY_BENCH = dict(warmup=3, iterations=50, latency_iterations=20)

# the TMA + wgmma kernels (bf16 x) and their instantiations in the library
# (K2 and K3 at head widths 64 and 128, K4 at tile widths 128 and 256),
# with the wgmma's SASS name: HGMMA for bf16 operands, IGMMA for int8
SM90_KERNELS = {"attn_packed_kernel_sm90": (1, "HGMMA"), "attn_bhnd_kernel_sm90": (2, "HGMMA"),
                "attn_batched_kernel_sm90": (2, "HGMMA"), "w8a8_kernel_sm90": (2, "IGMMA")}

PEAK_BF16_OPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate
PEAK_FP32_OPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


T0 = time.perf_counter()


def emit(record) -> None:
    if "phase" in record:  # the script's clock at each phase record
        record = {**record, "elapsed_s": round(time.perf_counter() - T0, 1)}
    print(json.dumps(record), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def run_cmd(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        fail(f"{' '.join(cmd)} exited {proc.returncode}: {proc.stderr.strip()}")
    return proc.stdout.strip()


def sass_counts(lib_path: str):
    """HGMMA (bf16 wgmma), IGMMA (int8 wgmma), UTMALDG (TMA load) and UTMASTG
    (TMA store) instructions per kernel of the built library, from
    ``cuobjdump -sass``; None if the toolkit has no cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    counts, func = {}, None
    for line in run_cmd([tool, "-sass", lib_path]).splitlines():
        if "Function :" in line:
            func = line.split("Function :", 1)[1].strip()
            counts[func] = {"HGMMA": 0, "IGMMA": 0, "UTMALDG": 0, "UTMASTG": 0}
        elif func is not None:
            for op in counts[func]:
                counts[func][op] += op in line
    return counts


def attention_bound(b: int, n: int, h: int, d: int, itemsize: int, peak_ops: float):
    ops = 4.0 * b * h * n * n * d
    nbytes = float(b * n * 4 * h * d * itemsize)  # qkv read once, out written once
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 numbers (8 significant bits) at magnitude ``x`` > 0."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def rel(a, b) -> float:
    """max |a - b| / max |b| (host arrays)."""
    import numpy as np

    return float(np.abs(a - b).max() / np.abs(b).max())


def mean_rel(a, b) -> float:
    import numpy as np

    return float(np.abs(a - b).mean() / np.abs(b).mean())


def check_flash_attention_packed(fa, dev):
    """K1 against its plain version at the main path's and edge shapes. In
    bf16 the bar is K2's: K2_BF16_ULPS steps at the largest output (at most
    BF16_TOL); the plain version with one 64-key tile left out must fail
    it; the kernel must sit no further from fp32 attention than the plain
    bf16 route."""
    import torch
    import torch.nn.functional as F

    shapes = [  # (label, B, N, H, dtype)
        ("vits_518", 1, 1370, 6, torch.bfloat16),
        ("vits_518_batch2", 2, 1370, 6, torch.bfloat16),
        ("vits_518_batch4", 4, 1370, 6, torch.bfloat16),
        ("vitl_518", 1, 1370, 16, torch.bfloat16),
        ("depth_pro_image", 1, 577, 16, torch.bfloat16),
        # the metric and point-map families: Metric3D V2 (44x76 patches, cls
        # and 4 registers), Metric Anything (60x60 + cls), MoGe-2 vits (32x57)
        ("metric3d_616x1064", 1, 3349, 16, torch.bfloat16),
        ("metric_anything_518", 1, 3601, 16, torch.bfloat16),
        ("moge2_vits_291x518", 1, 1825, 6, torch.bfloat16),
        # UniDepth V2 / UniK3D vitb (37x37 patches, cls and 4 registers) and
        # GeoCalib vits at 322^2 (23x23 + cls)
        ("unidepth_vitb_518", 1, 1374, 12, torch.bfloat16),
        ("geocalib_vits_322", 1, 530, 6, torch.bfloat16),
        ("n1", 1, 1, 6, torch.bfloat16),
        ("n63", 1, 63, 6, torch.bfloat16),
        ("n64", 1, 64, 6, torch.bfloat16),
        ("n65", 1, 65, 6, torch.bfloat16),
        ("n1024", 1, 1024, 6, torch.bfloat16),
        ("h3_n1370", 1, 1370, 3, torch.bfloat16),
        ("vits_518_fp32", 1, 1370, 6, torch.float32),
        ("h3_n65_fp32", 2, 65, 3, torch.float32),
    ]
    gen = torch.Generator().manual_seed(0)
    records = []
    for label, b, n, h, dtype in shapes:
        d = fa.HEAD_DIM
        qkv = torch.randn((b, n, 3 * h * d), generator=gen).to(dev, dtype)
        bf16 = dtype == torch.bfloat16
        out = fa.flash_attention_packed(qkv, h)
        torch.cuda.synchronize()
        ref = fa.flash_attention_packed_reference(qkv, h).float()
        err = (out.float() - ref).abs().max().item()
        step = bf16_ulp(ref.abs().max().item())
        tol = min(BF16_TOL, K2_BF16_ULPS * step) if bf16 else FP32_TOL
        check(out.shape == (b, n, h * d), f"K1 {label}: shape {tuple(out.shape)}")
        check(err <= tol, f"K1 {label}: max_abs_err {err} > {tol}")
        q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
        dropped_tile_err = None
        if n >= 2 * 64:  # the bar's power: one key tile left out must fail it
            t0 = (n // 64 // 2) * 64
            keep = torch.cat([torch.arange(t0), torch.arange(t0 + 64, n)]).to(dev)
            skipped = fa.flash_attention_reference(q, k[:, :, keep], v[:, :, keep])
            skipped = skipped.transpose(1, 2).reshape(b, n, h * d).float()
            dropped_tile_err = (skipped - ref).abs().max().item()
            check(dropped_tile_err > tol, f"K1 {label}: a dropped key tile moves the output "
                                          f"{dropped_tile_err} <= the bar {tol}")
            del skipped
        # both bf16 routes against fp32 attention of the same inputs
        exact = fa.flash_attention_packed_reference(qkv.float(), h)
        plain_route = fa.attention_reference(q, k, v).transpose(1, 2).reshape(b, n, h * d)
        kernel_vs_fp32 = (out.float() - exact).abs().max().item()
        plain_vs_fp32 = (plain_route.float() - exact).abs().max().item()
        if bf16:
            check(kernel_vs_fp32 <= plain_vs_fp32,
                  f"K1 {label}: kernel vs fp32 {kernel_vs_fp32} > plain bf16 attention vs "
                  f"fp32 {plain_vs_fp32}")
        peak = PEAK_BF16_OPS if dtype == torch.bfloat16 else PEAK_FP32_OPS
        bound_ms, bound_by = attention_bound(b, n, h, d, qkv.element_size(), peak)
        rec = {
            "shape": label, "B": b, "N": n, "H": h, "d": d,
            "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err, "tolerance": tol,
            "err_bf16_steps": err / step if bf16 else None,
            "dropped_key_tile_err": dropped_tile_err,
            "kernel_vs_fp32_err": kernel_vs_fp32,
            "plain_attention_vs_fp32_err": plain_vs_fp32,
            "kernel_ms": device_ms(lambda: fa.flash_attention_packed(qkv, h)),
            "kernel_event_ms": event_ms(lambda: fa.flash_attention_packed(qkv, h)),
            "host_us_per_call": host_us(lambda: fa.flash_attention_packed(qkv, h)),
            "plain_ms": event_ms(lambda: fa.flash_attention_packed_reference(qkv, h),
                                 iters=10, warmup=2),
            "library_ms": device_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        emit({"phase": "kernel_check", "kernel": "flash_attention_packed", **rec})
        records.append(rec)
    return records


def check_flash_attention(fa, dev):
    """K2 against its plain version at VGGT's shapes and edge shapes. The
    frame shape is (B*S, 16, 1374, 64) at S=4; global attention is
    (1, 16, S*1374, 64). "strided" reads q, k, v as views of one qkv
    tensor, as the VGGT path does."""
    import torch

    return check_bhnd_kernel(fa, dev, "flash_attention", seed=1, shapes=[
        # (label, B, H, N, d, dtype, strided)
        ("frame_s4", 4, 16, 1374, 64, torch.bfloat16, False),
        ("global_s4", 1, 16, 5496, 64, torch.bfloat16, False),
        ("global_s8", 1, 16, 10992, 64, torch.bfloat16, False),
        ("n1", 1, 16, 1, 64, torch.bfloat16, False),
        ("n63", 2, 16, 63, 64, torch.bfloat16, False),
        ("n65", 2, 16, 65, 64, torch.bfloat16, False),
        ("n127", 2, 16, 127, 64, torch.bfloat16, False),
        ("n128", 2, 16, 128, 64, torch.bfloat16, False),
        ("n129", 2, 16, 129, 64, torch.bfloat16, False),
        ("n255", 2, 16, 255, 64, torch.bfloat16, False),
        ("n257", 2, 16, 257, 64, torch.bfloat16, False),
        ("n577_strided", 4, 16, 577, 64, torch.bfloat16, True),
        ("d16_padded", 1, 16, 1374, 16, torch.bfloat16, False),
        ("global_s4_strided", 1, 16, 5496, 64, torch.bfloat16, True),
        ("frame_s1_fp32", 1, 16, 1374, 64, torch.float32, False),
        ("n65_fp32", 2, 3, 65, 64, torch.float32, False),
        # head_dim 128 (DINOv3 vit7b16's 32 heads at 1029 tokens), and 80, 96 padded to it
        ("d128_vit7b", 1, 32, 1029, 128, torch.bfloat16, False),
        ("d128_n129", 2, 16, 129, 128, torch.bfloat16, False),
        ("d128_n577_strided", 4, 16, 577, 128, torch.bfloat16, True),
        ("d80_padded", 2, 16, 257, 80, torch.bfloat16, False),
        ("d96_padded", 2, 16, 255, 96, torch.bfloat16, True),
        ("d128_vit7b_fp32", 1, 32, 1029, 128, torch.float32, False),
        ("d96_fp32", 2, 3, 65, 96, torch.float32, False),
        # heads wider than 128, zero-padded to a multiple of 128: the wide loop
        ("d192_wide", 1, 16, 1029, 192, torch.bfloat16, False),
        ("d256_wide", 1, 16, 1029, 256, torch.bfloat16, False),
        ("d320_wide_strided", 2, 8, 577, 320, torch.bfloat16, True),
        ("d192_wide_fp32", 1, 4, 257, 192, torch.float32, False),
        ("d320_wide_fp32", 1, 4, 129, 320, torch.float32, False),
    ])


def check_flash_attention_batched(fa, dev):
    """K3 against its plain version at Depth Pro's patch-encoder shape (35
    windows x 16 heads of 577 tokens, q, k, v as views of the qkv output,
    as the path reads them) and edge shapes: the bound N = 1024, N = 833,
    the ends of the 64-row query tiles and 128-key tiles (N = 1, 63, 65,
    127, 128, 129, 255, 257), a padded d = 16, a head count that is no power
    of two, and fp32. K1 is timed at the main shape too, on the same qkv:
    the route between the two is open."""
    import torch

    return check_bhnd_kernel(fa, dev, "flash_attention_batched", seed=3, k1_at="depth_pro_patch",
                             shapes=[
        ("depth_pro_patch", 35, 16, 577, 64, torch.bfloat16, True),
        ("n1024", 16, 16, 1024, 64, torch.bfloat16, False),
        ("n833", 4, 16, 833, 64, torch.bfloat16, False),
        ("n1", 35, 8, 1, 64, torch.bfloat16, False),
        ("n63", 35, 8, 63, 64, torch.bfloat16, False),
        ("n65", 35, 8, 65, 64, torch.bfloat16, False),
        ("n127", 35, 8, 127, 64, torch.bfloat16, False),
        ("n128", 35, 8, 128, 64, torch.bfloat16, False),
        ("n129", 35, 8, 129, 64, torch.bfloat16, False),
        ("n255", 35, 8, 255, 64, torch.bfloat16, False),
        ("n257", 35, 8, 257, 64, torch.bfloat16, False),
        ("d16_padded", 35, 16, 577, 16, torch.bfloat16, True),
        ("bh259", 7, 37, 577, 64, torch.bfloat16, False),
        ("depth_pro_patch_fp32", 35, 16, 577, 64, torch.float32, True),
        ("n1024_fp32", 2, 8, 1024, 64, torch.float32, False),
        # head_dim 128, and 80, 96 padded to it
        ("d128", 16, 16, 577, 128, torch.bfloat16, False),
        ("d128_n1024", 4, 8, 1024, 128, torch.bfloat16, True),
        ("d128_n1", 35, 8, 1, 128, torch.bfloat16, False),
        ("d80_padded", 35, 8, 129, 80, torch.bfloat16, True),
        ("d96_padded", 35, 8, 257, 96, torch.bfloat16, False),
        ("d128_fp32", 16, 16, 577, 128, torch.float32, False),
        ("d128_n1024_fp32", 2, 8, 1024, 128, torch.float32, False),
        # heads wider than 128, zero-padded to a multiple of 128: the wide loop
        ("d192_wide", 16, 16, 577, 192, torch.bfloat16, True),
        ("d256_wide", 8, 16, 577, 256, torch.bfloat16, False),
        ("d320_wide", 8, 8, 257, 320, torch.bfloat16, False),
        ("d256_wide_fp32", 4, 8, 577, 256, torch.float32, False),
    ])


def check_bhnd_kernel(fa, dev, name, shapes, seed, k1_at=None):
    """K2 or K3 (``name``) against its plain version (both divide P by the
    row sum before its cast: the TPU's numerics) at ``shapes``. In bf16 the
    bar is K2_BF16_ULPS steps at the largest output (at most BF16_TOL); the
    plain version with one 64-key tile left out must fail it; the kernel
    must sit no further from fp32 attention than the plain bf16 route."""
    import torch
    import torch.nn.functional as F

    kernel = getattr(fa, name)
    gen = torch.Generator().manual_seed(seed)
    records = []
    for label, b, h, n, d, dtype, strided in shapes:
        if strided:
            qkv = torch.randn((b, n, 3, h, d), generator=gen).to(dev, dtype)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        else:
            q, k, v = (torch.randn((b, h, n, d), generator=gen).to(dev, dtype)
                       for _ in range(3))
        bf16 = dtype == torch.bfloat16
        out = kernel(q, k, v)
        torch.cuda.synchronize()
        ref = fa.flash_attention_reference(q, k, v).float()
        diff = (out.float() - ref).abs()
        err, mean_err = diff.max().item(), diff.mean().item()
        ref_max, ref_rms = ref.abs().max().item(), ref.square().mean().sqrt().item()
        step = bf16_ulp(ref_max)
        tol = min(BF16_TOL, K2_BF16_ULPS * step) if bf16 else FP32_TOL
        check(out.shape == (b, h, n, d), f"{name} {label}: shape {tuple(out.shape)}")
        check(err <= tol, f"{name} {label}: max_abs_err {err} > {tol}")
        # the bar's power: the plain version with one key tile left out (what
        # a kernel that skipped a tile computes) must fail it
        dropped_tile_err = None
        if n >= 2 * 64:
            t0 = (n // 64 // 2) * 64
            keep = torch.cat([torch.arange(t0), torch.arange(t0 + 64, n)]).to(dev)
            skipped = fa.flash_attention_reference(q, k[:, :, keep], v[:, :, keep])
            dropped_tile_err = (skipped.float() - ref).abs().max().item()
            check(dropped_tile_err > tol,
                  f"{name} {label}: a dropped key tile moves the output {dropped_tile_err} "
                  f"<= the bar {tol}")
            del skipped
        del ref, diff
        # the kernel and the plain bf16 route against fp32 attention
        exact = fa.flash_attention_reference(q.float(), k.float(), v.float())
        kernel_vs_fp32 = (out.float() - exact).abs().max().item()
        plain_route = fa.attention_reference(q, k, v)
        plain_vs_fp32 = (plain_route.float() - exact).abs().max().item()
        del exact, plain_route
        if bf16:
            check(kernel_vs_fp32 <= plain_vs_fp32,
                  f"{name} {label}: kernel vs fp32 {kernel_vs_fp32} > plain bf16 attention "
                  f"vs fp32 {plain_vs_fp32}")
        peak = PEAK_BF16_OPS if dtype == torch.bfloat16 else PEAK_FP32_OPS
        bound_ms, bound_by = attention_bound(b, n, h, d, q.element_size(), peak)
        long = n > 4096
        rec = {
            "shape": label, "B": b, "H": h, "N": n, "d": d, "strided": strided,
            "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err, "tolerance": tol, "mean_abs_err": mean_err,
            "err_bf16_steps": err / step if bf16 else None,
            "plain_max_abs": ref_max, "plain_rms": ref_rms,
            "dropped_key_tile_err": dropped_tile_err,
            "kernel_vs_fp32_err": kernel_vs_fp32,
            "plain_attention_vs_fp32_err": plain_vs_fp32,
            "kernel_ms": device_ms(lambda: kernel(q, k, v), iters=5 if long else 20),
            "kernel_event_ms": event_ms(lambda: kernel(q, k, v), iters=10 if long else 50),
            "host_us_per_call": host_us(lambda: kernel(q, k, v)),
            "plain_ms": event_ms(lambda: fa.flash_attention_reference(q, k, v),
                                 iters=3 if long else 10, warmup=1 if long else 2),
            "library_ms": device_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                                    iters=5 if long else 20),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        if label == k1_at:  # K1 on the same problem, read from the packed qkv
            packed = qkv.reshape(b, n, 3 * h * d)
            rec["k1_same_shape_ms"] = device_ms(lambda: fa.flash_attention_packed(packed, h))
            del packed
        emit({"phase": "kernel_check", "kernel": name, **rec})
        records.append(rec)
        del q, k, v, out
        if strided:
            del qkv
        torch.cuda.empty_cache()
    return records


def profile_breakdown(step, name: str, iters: int = 5, top: int = 12, ranges=()):
    """Device time by kernel over ``iters`` calls of ``step`` (one forward of
    device-resident input), from ``torch.profiler``'s CUDA events; the busy
    time is the union of the kernels' intervals, the wall time the host clock
    around the loop (which the profiler itself slows). Times are per call.
    ``ranges``: names of ``record_function`` ranges (see ``annotated``) whose
    kernels' device time is added up (an eager step only: a graph replay's
    kernels belong to no range)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.name not in ranges)
    rec = {"phase": "profile", "model": name, "calls": iters, "wall_ms_per_call": wall_ms}
    for r in ranges:  # the kernels launched inside the range, its children's too
        calls = [e for e in prof.events() if e.name == r and e.device_type == DeviceType.CPU]
        rec[r] = {"calls_per_call": len(calls) / iters,
                  "device_ms_per_call": sum(e.device_time_total for e in calls) / 1e3 / iters}
    if not spans:
        return {**rec, "device_time": "not measured (no CUDA events in the trace)"}
    busy_us, end = 0.0, float("-inf")
    by_name = {}
    for s, e, kname in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        tot, cnt = by_name.get(kname, (0.0, 0))
        by_name[kname] = (tot + (e - s), cnt + 1)
    busy_ms = busy_us / 1e3 / iters
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])

    def kernel_ms(entry: str) -> float:
        return sum(v[0] for k, v in by_name.items() if entry in k) / 1e3 / iters

    return {**rec,
            "device_busy_ms_per_call": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "device_ops_per_call": len(spans) / iters,
            "k1_ms_per_call": kernel_ms("attn_packed_kernel"),
            "k2_ms_per_call": kernel_ms("attn_bhnd_kernel"),
            "k3_ms_per_call": kernel_ms("attn_batched_kernel"),
            "k4_ms_per_call": kernel_ms("w8a8_kernel"),
            "top": [{"name": k[:90], "ms_per_call": v[0] / 1e3 / iters,
                     "per_call": v[1] / iters} for k, v in ranked[:top]]}


@contextlib.contextmanager
def annotated(module, fn_name: str):
    """``module.<fn_name>`` called inside a ``torch.profiler.record_function``
    range of its own name while the context lasts."""
    import torch

    fn = getattr(module, fn_name)

    def in_range(*args, **kw):
        with torch.profiler.record_function(fn_name):
            return fn(*args, **kw)

    setattr(module, fn_name, in_range)
    try:
        yield
    finally:
        setattr(module, fn_name, fn)


def run_vggt_path(build_pipeline, wrappers, rng):
    """The VGGT path with its own counts: set to 0 just before, read just
    after. Returns the pipeline and the counts."""
    import numpy as np
    import torch

    pipe = build_pipeline("vggt")
    check(pipe.device.type == "cuda", f"vggt default device is {pipe.device}")
    frame = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    views4 = rng.integers(0, 256, (4, 518, 518, 3), dtype=np.uint8)
    views8 = rng.integers(0, 256, (8, 518, 518, 3), dtype=np.uint8)

    set_counts_to_zero(wrappers)
    per_forward = {}
    outs = {}
    for key, run, arg, engine_of in (
            ("frame_480x640", lambda a: pipe(a, viz=True), frame,
             lambda: pipe.engine_for((480, 640), True)),
            ("views_s4", pipe.multi_view, views4, lambda: pipe.views_engine(4)),
            ("views_s8", pipe.multi_view, views8, lambda: pipe.views_engine(8))):
        outs[key], per = run_counted(lambda: run(arg), engine_of, wrappers, f"vggt {key}")
        per_forward[key] = per[1:3]
    torch.cuda.synchronize()
    launches = launch_record(wrappers)

    for key, got in per_forward.items():
        check(got == [24, 48], f"vggt {key}: K1, K2 launches {got}, want [24, 48]")
    n = 3 * (WARMUP_CALLS + 1)  # three engines, each warmed up and captured
    check(launches == {"flash_attention_batched": 0, "flash_attention_packed": 24 * n,
                       "flash_attention": 48 * n, "w8a8_matmul": 0},
          f"launches on the vggt path {launches}")
    one = outs["frame_480x640"]
    want = {"depth": (480, 640), "depth_conf": (480, 640), "pose_enc": (9,),
            "extrinsic": (3, 4), "focal_px": (), "viz": (480, 640, 3)}
    check({k: v.shape for k, v in one.items()} == want,
          f"vggt frame outputs {({k: v.shape for k, v in one.items()})}")
    for key in ("depth", "depth_conf", "pose_enc", "extrinsic"):
        check(bool(np.isfinite(one[key]).all()), f"vggt {key} not finite")
    # fov goes through a relu: a random-weight fov of 0 gives an infinite focal
    fov_h, focal = float(one["pose_enc"][7]), float(one["focal_px"])
    check(focal > 0 and (np.isfinite(focal) or fov_h == 0.0),
          f"vggt focal_px {focal} for fov_h {fov_h}")
    d = one["depth"]
    check(d.dtype == np.float32 and d.min() >= 1e-3 and d.max() <= 1e3,
          f"vggt depth outside clamp {d.min()} {d.max()}")
    check(d.max() > d.min(), "vggt depth is constant")
    check(one["depth_conf"].min() >= 1.0, "vggt confidence below 1")
    check(one["viz"].dtype == np.uint8, "vggt viz dtype")
    for key, s in (("views_s4", 4), ("views_s8", 8)):
        o = outs[key]
        check(o["depth"].shape == (s, 518, 518) and o["depth_conf"].shape == (s, 518, 518)
              and o["pose_enc"].shape == (s, 9), f"vggt {key} shapes")
        check(all(bool(np.isfinite(v).all()) for v in o.values()), f"vggt {key} not finite")
        check(o["depth"].max() > o["depth"].min(), f"vggt {key} depth is constant")
    emit({"phase": "vggt_path", "model": pipe.spec.artifact_name(),
          "forwards": list(per_forward), "launches_per_forward_k1_k2": per_forward,
          "launches": launches, "counted": f"{WARMUP_CALLS} warm-up + 1 captured per engine",
          "depth_range_480x640": [float(d.min()), float(d.max())],
          "pose_enc_480x640": [float(x) for x in one["pose_enc"]],
          "focal_px_480x640": float(one["focal_px"])})
    return pipe, launches


def parity_frames(rng):
    """The frames of the VGGT route comparison: noise at 518x518 and at
    480x640 (the crop path), and a smooth scene-like 518x518 frame."""
    import numpy as np

    y, x = np.mgrid[0:518, 0:518] / 517.0
    smooth = np.stack([x, y, 0.5 + 0.5 * np.sin(6.0 * (x + y))], axis=-1)
    smooth[(x - 0.6) ** 2 + (y - 0.4) ** 2 < 0.04] = (0.9, 0.2, 0.1)
    return {"noise_518x518": rng.integers(0, 256, (518, 518, 3), dtype=np.uint8),
            "noise_480x640": rng.integers(0, 256, (480, 640, 3), dtype=np.uint8),
            "smooth_518x518": (smooth * 255).round().astype(np.uint8)}


def vggt_parity(build_pipeline, pipe, frames):
    """For each weight seed and frame (S=1), on weights rounded to bf16 and
    shared by every route: the bf16 kernel route against plain attention
    and against the fp32 card path, on depth, confidence and pose; and, for
    seed 0 and the first frame, the fp32 card path against the fp32 CPU
    path. Every reading is emitted before any is checked."""
    import torch
    from monocular_depth_estimation_trt_tpu_torch.models.vggt import VGGT
    from monocular_depth_estimation_trt_tpu_torch.weights.store import init_random_

    keys = ("depth", "depth_conf", "pose_enc")

    def run(p, frame):
        out = p(frame)
        return {k: out[k] for k in keys}

    readings, cpu_rec = [], None
    for seed in PARITY_WEIGHT_SEEDS:
        kernel_pipe = pipe
        if seed != 0:  # the path's pipeline holds seed 0
            model = VGGT()
            init_random_(model, seed)
            kernel_pipe = build_pipeline("vggt", params=model.state_dict())
            del model
        sd = {k: v.float().cpu() for k, v in kernel_pipe.model.state_dict().items()}
        plain_pipe = build_pipeline("vggt", attn_impl="xla", params=sd)
        card32_pipe = build_pipeline("vggt", precision="fp32", params=sd)
        for name, frame in frames.items():
            kernel, plain = run(kernel_pipe, frame), run(plain_pipe, frame)
            card32 = run(card32_pipe, frame)
            rec = {"phase": "vggt_parity", "weights_seed": seed, "frame": name}
            for k in keys:
                rec[k] = {
                    "bf16_kernel_vs_plain_attention_rel": rel(kernel[k], plain[k]),
                    "bf16_kernel_vs_plain_attention_mean_rel": mean_rel(kernel[k], plain[k]),
                    "bf16_kernel_route_vs_fp32_rel": rel(kernel[k], card32[k]),
                    "bf16_kernel_route_vs_fp32_mean_rel": mean_rel(kernel[k], card32[k]),
                    "bf16_plain_route_vs_fp32_rel": rel(plain[k], card32[k]),
                    "bf16_plain_route_vs_fp32_mean_rel": mean_rel(plain[k], card32[k]),
                }
            emit(rec)
            readings.append(rec)
            if cpu_rec is None:
                t0 = time.perf_counter()
                cpu32 = run(build_pipeline("vggt", precision="fp32", params=sd,
                                           device="cpu"), frame)
                cpu_rec = {"phase": "vggt_parity_cpu", "weights_seed": seed, "frame": name,
                           "cpu_fp32_seconds": time.perf_counter() - t0,
                           "model_depth": "full (24 ViT + 24 alternating blocks)",
                           **{k: {"fp32_card_vs_cpu_rel": rel(card32[k], cpu32[k])}
                              for k in keys}}
                emit(cpu_rec)
        drop_engines(plain_pipe, card32_pipe, kernel_pipe)
        del kernel_pipe, plain_pipe, card32_pipe, sd

    def worst(k, metric):
        return max(r[k][metric] for r in readings)

    def average(k, metric):
        return sum(r[k][metric] for r in readings) / len(readings)

    ratio = {k: average(k, "bf16_kernel_route_vs_fp32_rel")
             / average(k, "bf16_plain_route_vs_fp32_rel") for k in keys}
    emit({"phase": "vggt_parity_summary", "readings": len(readings),
          **{k: {"max_bf16_kernel_vs_plain_attention_rel":
                 worst(k, "bf16_kernel_vs_plain_attention_rel"),
                 "max_bf16_kernel_route_vs_fp32_rel": worst(k, "bf16_kernel_route_vs_fp32_rel"),
                 "max_bf16_plain_route_vs_fp32_rel": worst(k, "bf16_plain_route_vs_fp32_rel"),
                 "bf16_kernel_vs_plain_attention_tolerance": PATH_BF16_VGGT_REL_TOL[k],
                 "kernel_over_plain_route_vs_fp32": ratio[k]}
             for k in keys},
          "bf16_route_ratio_tolerance": PATH_BF16_ROUTE_RATIO,
          "fp32_tolerance": PATH_FP32_REL_TOL})
    for r in readings:
        at = f"seed {r['weights_seed']} {r['frame']}"
        for k in keys:
            got = r[k]["bf16_kernel_vs_plain_attention_rel"]
            check(got < PATH_BF16_VGGT_REL_TOL[k],
                  f"vggt bf16 {k} kernel vs plain attention {got} ({at})")
    for k in keys:
        check(ratio[k] <= PATH_BF16_ROUTE_RATIO,
              f"vggt bf16 {k}: kernel route {ratio[k]} x as far from fp32 as the plain "
              f"route, over {len(readings)} readings")
    for k in keys:
        got = cpu_rec[k]["fp32_card_vs_cpu_rel"]
        check(got < PATH_FP32_REL_TOL, f"vggt fp32 {k} card vs cpu {got}")


def lift_depth_pro_outputs(model) -> None:
    """Seeded random weights leave Depth Pro's two output layers at zero
    bias: the canonical inverse depth sits at 0 at about half the pixels
    (relu) and the field of view has a random sign, which puts every pixel
    at the depth clip. Output biases of 1 and 60 degrees give a depth map and
    a focal that every check can read; nothing else of the weights moves."""
    import torch

    with torch.no_grad():
        model.head_conv2.bias.fill_(1.0)
        model.fov.head.bias.fill_(60.0)


def depth_pro_pipeline(build_pipeline, **kw):
    pipe = build_pipeline("depth_pro", **kw)
    lift_depth_pro_outputs(pipe.model)
    return pipe


# the kernels' wrappers by name, in the order of counts(): K3, K1, K2, K4
KERNELS = ("flash_attention_batched", "flash_attention_packed", "flash_attention", "w8a8_matmul")


def wrappers_of(fa, qm):
    return {"flash_attention_batched": fa.flash_attention_batched,
            "flash_attention_packed": fa.flash_attention_packed,
            "flash_attention": fa.flash_attention, "w8a8_matmul": qm.w8a8_matmul}


def counts(wrappers):
    """The launch counts of K3, K1, K2 and K4, in that order."""
    return [wrappers[name].launches for name in KERNELS]


def set_counts_to_zero(wrappers) -> None:
    for name in KERNELS:
        wrappers[name].launches = 0


def launch_record(wrappers):
    return {name: wrappers[name].launches for name in KERNELS}


def drop_engines(*pipes) -> None:
    """Release the pipelines' captured graphs and their memory pools (an
    engine's function refers back to its pipeline, so a dropped pipeline
    would keep its graphs until the cycle collector ran)."""
    import gc

    import torch

    for p in pipes:
        p.release_engines()
    gc.collect()
    torch.cuda.empty_cache()


def engine_launches(engine):
    """The launches [K3, K1, K2, K4] of an engine's captured forward."""
    return [engine.captured_launches[name] for name in KERNELS]


def run_counted(call, engine_of, wrappers, label):
    """``call()`` through an engine that it builds: the wrappers count the
    engine's WARMUP_CALLS eager calls and its captured one, and nothing else
    (a replay goes through no wrapper). Returns the output and the launches
    [K3, K1, K2, K4] of one forward."""
    before = counts(wrappers)
    out = call()
    got = [a - b for a, b in zip(counts(wrappers), before)]
    per = engine_launches(engine_of())
    check(got == [(WARMUP_CALLS + 1) * n for n in per],
          f"{label}: launches {got} for a new engine whose forward launches {per}")
    return out, per


def run_depth_pro_path(build_pipeline, wrappers, rng):
    """The Depth Pro path with its own counts: set to 0 just before, read
    just after. Returns the pipeline, the counts and the frames."""
    import numpy as np
    import torch

    pipe = depth_pro_pipeline(build_pipeline)
    check(pipe.device.type == "cuda", f"depth_pro default device is {pipe.device}")
    frames = {"frame_480x640": rng.integers(0, 256, (480, 640, 3), dtype=np.uint8),
              "frame_1536x1536": rng.integers(0, 256, (1536, 1536, 3), dtype=np.uint8)}

    set_counts_to_zero(wrappers)
    per_forward, outs = {}, {}
    for key, frame in frames.items():
        viz = key == "frame_480x640"
        outs[key], per_forward[key] = run_counted(
            lambda: pipe(frame, viz=viz), lambda: pipe.engine_for(frame.shape[:2], viz),
            wrappers, f"depth_pro {key}")
    torch.cuda.synchronize()
    launches = launch_record(wrappers)

    for key, got in per_forward.items():
        check(got == [24, 24, 0, 0],
              f"depth_pro {key}: K3, K1, K2, K4 launches {got}, want [24, 24, 0, 0]")
    n = 2 * (WARMUP_CALLS + 1)
    check(launches == {"flash_attention_batched": 24 * n, "flash_attention_packed": 24 * n,
                       "flash_attention": 0, "w8a8_matmul": 0},
          f"launches on the depth_pro path {launches}")
    rec = {"phase": "depth_pro_path", "model": pipe.spec.artifact_name(),
           "forwards": list(per_forward), "launches_per_forward_k3_k1_k2_k4": per_forward,
           "launches": launches}
    for key, frame in frames.items():
        out, hw = outs[key], frame.shape[:2]
        d, f_px = out["depth"], float(out["f_px"])
        check(d.shape == hw and d.dtype == np.float32, f"depth_pro {key}: depth {d.shape} {d.dtype}")
        check(bool(np.isfinite(d).all()), f"depth_pro {key}: depth not finite")
        check(d.min() >= 1e-4 and d.max() <= 1e4,
              f"depth_pro {key}: depth outside the clip {d.min()} {d.max()}")
        check(d.max() > d.min(), f"depth_pro {key}: depth is constant")
        # the focal follows a random-weight fov: checked where it is finite
        check(not np.isfinite(f_px) or f_px > 0, f"depth_pro {key}: f_px {f_px}")
        rec[key] = {"depth_range": [float(d.min()), float(d.max())],
                    "depth_share_at_clip": float(np.mean(d == 1e4)), "f_px": f_px}
    check(outs["frame_480x640"]["viz"].shape == (480, 640, 3)
          and outs["frame_480x640"]["viz"].dtype == np.uint8, "depth_pro viz")
    emit(rec)
    return pipe, launches, frames


def depth_pro_parity(build_pipeline, pipe, frames):
    """For each weight seed and frame, on weights rounded to bf16 and shared
    by every route: the bf16 kernel route (K3 + K1) against plain attention
    and against the fp32 card path, on the inverse depth (the model's
    output: a pixel at the depth clip would set the scale of a relative
    error of the depth itself) and f_px. The kernel route is held to
    PATH_BF16_REL_TOL of the plain route at every reading, and, averaged
    over the readings, to PATH_BF16_ROUTE_RATIO times the plain route's
    distance from fp32. Then the
    fp32 path on the card against the CPU at the full 1536 geometry and
    widths, the ViT depth cut to DEPTH_PRO_CPU_VIT_DEPTH blocks. Every
    reading is emitted before any is checked."""
    import numpy as np
    import torch
    from monocular_depth_estimation_trt_tpu_torch.models.depth_pro import (
        DepthPro,
        DepthProConfig,
    )
    from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig
    from monocular_depth_estimation_trt_tpu_torch.weights.store import init_random_

    keys = ("inverse_depth", "f_px")

    def run(p, frame):
        out = p(frame)
        return {"inverse_depth": 1.0 / out["depth"], "f_px": np.asarray(out["f_px"])}

    readings = []
    for seed in PARITY_WEIGHT_SEEDS:
        kernel_pipe = pipe
        if seed != 0:  # the path's pipeline holds seed 0
            model = DepthPro()
            init_random_(model, seed)
            lift_depth_pro_outputs(model)
            kernel_pipe = build_pipeline("depth_pro", params=model.state_dict())
            del model
        sd = {k: v.float().cpu() for k, v in kernel_pipe.model.state_dict().items()}
        plain_pipe = build_pipeline("depth_pro", attn_impl="xla", params=sd)
        card32_pipe = build_pipeline("depth_pro", precision="fp32", params=sd)
        for name, frame in frames.items():
            kernel, plain = run(kernel_pipe, frame), run(plain_pipe, frame)
            card32 = run(card32_pipe, frame)
            rec = {"phase": "depth_pro_parity", "weights_seed": seed, "frame": name,
                   "f_px": {"kernel": float(kernel["f_px"]), "plain": float(plain["f_px"]),
                            "fp32": float(card32["f_px"])}}
            for k in keys:
                rec[k] = {
                    "bf16_kernel_vs_plain_attention_rel": rel(kernel[k], plain[k]),
                    "bf16_kernel_vs_plain_attention_mean_rel": mean_rel(kernel[k], plain[k]),
                    "bf16_kernel_route_vs_fp32_rel": rel(kernel[k], card32[k]),
                    "bf16_plain_route_vs_fp32_rel": rel(plain[k], card32[k]),
                }
            emit(rec)
            readings.append(rec)
        drop_engines(plain_pipe, card32_pipe, kernel_pipe)
        del kernel_pipe, plain_pipe, card32_pipe, sd

    # fp32, card against CPU: full geometry and widths, DEPTH_PRO_CPU_VIT_DEPTH ViT blocks
    vit = ViTConfig(dim=1024, depth=DEPTH_PRO_CPU_VIT_DEPTH, num_heads=16, patch_size=16,
                    pretrain_img_size=384)
    model_kw = dict(cfg=DepthProConfig(vit_config=vit, hook_block_ids=DEPTH_PRO_CPU_HOOKS))
    card32 = depth_pro_pipeline(build_pipeline, precision="fp32", model_kw=model_kw)
    frame = frames["frame_480x640"]
    got_card = run(card32, frame)
    sd = {k: v.cpu() for k, v in card32.model.state_dict().items()}
    drop_engines(card32)
    del card32
    t0 = time.perf_counter()
    got_cpu = run(build_pipeline("depth_pro", precision="fp32", device="cpu", params=sd,
                                 model_kw=model_kw), frame)
    cpu_rec = {"phase": "depth_pro_parity_cpu", "frame": "frame_480x640",
               "cpu_fp32_seconds": time.perf_counter() - t0,
               "model_depth": f"full widths and 1536 geometry; {DEPTH_PRO_CPU_VIT_DEPTH} of 24 "
                              f"ViT blocks in each encoder (hooks at {DEPTH_PRO_CPU_HOOKS})",
               **{k: {"fp32_card_vs_cpu_rel": rel(got_card[k], got_cpu[k])} for k in keys}}
    emit(cpu_rec)

    def worst(k, metric):
        return max(r[k][metric] for r in readings)

    def average(k, metric):
        return sum(r[k][metric] for r in readings) / len(readings)

    ratio = {k: average(k, "bf16_kernel_route_vs_fp32_rel")
             / average(k, "bf16_plain_route_vs_fp32_rel") for k in keys}
    emit({"phase": "depth_pro_parity_summary", "readings": len(readings),
          **{k: {"max_bf16_kernel_vs_plain_attention_rel":
                 worst(k, "bf16_kernel_vs_plain_attention_rel"),
                 "max_bf16_kernel_route_vs_fp32_rel": worst(k, "bf16_kernel_route_vs_fp32_rel"),
                 "max_bf16_plain_route_vs_fp32_rel": worst(k, "bf16_plain_route_vs_fp32_rel"),
                 "bf16_kernel_vs_plain_attention_tolerance": PATH_BF16_REL_TOL,
                 "kernel_over_plain_route_vs_fp32": ratio[k]}
             for k in keys},
          "bf16_route_ratio_tolerance": PATH_BF16_ROUTE_RATIO,
          "fp32_tolerance": PATH_FP32_REL_TOL})
    for r in readings:
        at = f"seed {r['weights_seed']} {r['frame']}"
        check(all(np.isfinite(v) for v in r["f_px"].values()), f"depth_pro f_px ({at})")
        for k in keys:
            got = r[k]["bf16_kernel_vs_plain_attention_rel"]
            check(got < PATH_BF16_REL_TOL,
                  f"depth_pro bf16 {k} kernel vs plain attention {got} ({at})")
    for k in keys:
        check(ratio[k] <= PATH_BF16_ROUTE_RATIO,
              f"depth_pro bf16 {k}: kernel route {ratio[k]} x as far from fp32 as the plain "
              f"route, over {len(readings)} readings")
        got = cpu_rec[k]["fp32_card_vs_cpu_rel"]
        check(got < PATH_FP32_REL_TOL, f"depth_pro fp32 {k} card vs cpu {got}")


# The single-image families at full width, in two groups (the phases'
# names): the frames of each one's counted run (the first with the viz
# epilogue), the per-forward launches [K3, K1, K2, K4] of its bf16 path, the
# outputs that the route comparisons read and the scalars they record.
# Metric and point-map families: DA3 vitl at 518^2 and Metric Anything vitl at
# 3600 tokens (60x60) run 24 K1 at 16 heads, Metric3D V2 vitl 24 K1 at N = 3349
# (a 616x1064 canvas, 4 registers), MoGe-2 vits 12 K1 at 6 heads (32x57
# tokens). The last single-image families: UniDepth V2 and UniK3D vitb at
# 518^2 run 12 K1 at N = 1374 (4 registers), 12 heads (their decoder's
# attention is plain matmuls, as in the JAX package); SIDepth two vits stacks,
# 24 K1; GeoCalib vits at 322^2, 12 K1 at N = 530, and its 10-step camera fit;
# Prior Depth Anything VGGT S=1 depth-only (24 K1 + 48 K2) and the refiner's
# two vits stacks (24 K1).
METRIC, SINGLE = "metric_families", "single_image_families"
# How each compared output of a family is held in the bf16 route
# comparisons (family_parity): ``bar`` for the kernel route against the
# plain route at every (weight seed, frame), on ``gate``: "rel" (max |a - b|
# / max |b|) or "mean_rel" (mean |a - b| / mean |b|); ``in_ratio``: the
# kernel route's distance from fp32, averaged over the readings, held to
# PATH_BF16_ROUTE_RATIO times the plain route's (not for outputs of a few
# values a reading, whose ratio swings with one value). The fp32 card-vs-CPU
# comparison holds every output on max rel below PATH_FP32_REL_TOL.
Held = collections.namedtuple("Held", "bar gate in_ratio", defaults=("rel", True))
# The MoGe pair is compared on its model's outputs (affine-invariant points,
# normal, mask probability, metric scale): with random weights its focal
# solve is ill-conditioned (a focal near 1e-4), so the focal and the shifted
# depth built from them are recorded, not held. A unit vector (the MoGe
# normal, GeoCalib's up field) divides by a norm that random weights leave
# near 0 at some pixels, where bf16 rounding turns the direction: held on
# its mean rel; so are UniK3D's points, unit rays of such a field times the
# distance (max rel 0.25 to 0.56 from fp32 on either bf16 route, mean rel
# 0.006 to 0.009, in the first card runs). Each bar sits about twice above
# the largest of the first card run's 4 readings per family (PERF.md §6):
# DA3 depth 2.9e-2 (DA-V2's bar kept), sky 1.4e-2; Metric3D depth 2.2e-2,
# confidence 1.2e-2; MoGe-2 / Metric Anything points 6.3e-3 and 7.1e-3,
# normal 1.1e-2 (mean), mask 3.2e-3 and 3.3e-3, metric scale 1.6e-2 and
# 3.9e-3; UniDepth V2 points 1.3e-2, confidence 1.5e-3, intrinsics 1.2e-2;
# UniK3D points 7.7e-3 (mean), confidence 1.6e-3, intrinsics 9.9e-3;
# SIDepth depth 3.4e-2, SSI 4.1e-2; GeoCalib up field 6.3e-3 (mean),
# latitude 7.8e-2, confidences 1.8e-2 and 1.3e-2, where the plain route
# reads as far from fp32 (up to 7.4e-2 on the latitude); Prior Depth
# Anything refined depth 3.5e-2, VGGT depth 5.6e-2, confidence 5.6e-2 (after
# VGGT's 48 bf16 blocks). A key tile left out of K1 moves an attention
# output by O(1).
FAMILIES = {
    "depth_anything_v3": dict(group=METRIC, hw=((480, 640), (518, 518)),
                              per_forward=[0, 24, 0, 0],
                              held={"depth": Held(5e-2), "sky": Held(3e-2)}),
    "metric3d_v2": dict(group=METRIC, hw=((480, 640), (616, 1064)), per_forward=[0, 24, 0, 0],
                        held={"depth": Held(5e-2), "confidence": Held(2.5e-2)}),
    "moge2": dict(group=METRIC, hw=((480, 640), (291, 518)), per_forward=[0, 12, 0, 0],
                  held={"points": Held(1.5e-2), "normal": Held(2.5e-2, "mean_rel"),
                        "mask": Held(7.5e-3), "metric_scale": Held(3e-2, in_ratio=False)},
                  recorded=("focal",)),
    "metric_anything": dict(group=METRIC, hw=((480, 640), (518, 518)),
                            per_forward=[0, 24, 0, 0],
                            held={"points": Held(1.5e-2), "mask": Held(7.5e-3),
                                  "metric_scale": Held(3e-2, in_ratio=False)},
                            recorded=("focal",)),
    "unidepth_v2": dict(group=SINGLE, hw=((480, 640), (518, 518)), per_forward=[0, 12, 0, 0],
                        held={"pts_3d": Held(3e-2), "confidence": Held(3e-3),
                              "intrinsics": Held(2.5e-2, in_ratio=False)}),
    "unik3d": dict(group=SINGLE, hw=((480, 640), (518, 518)), per_forward=[0, 12, 0, 0],
                   held={"pts_3d": Held(1.5e-2, "mean_rel"), "confidence": Held(3e-3),
                         "intrinsics": Held(2.5e-2, in_ratio=False)}),
    "sidepth": dict(group=SINGLE, hw=((480, 640), (518, 518)), per_forward=[0, 24, 0, 0],
                    held={"depth": Held(7e-2), "ssi": Held(8e-2)}),
    "geocalib": dict(group=SINGLE, hw=((480, 640), (322, 322)), per_forward=[0, 12, 0, 0],
                     held={"up_field": Held(1.5e-2, "mean_rel"), "latitude_field": Held(1.5e-1),
                           "up_confidence": Held(4e-2), "latitude_confidence": Held(3e-2)},
                     recorded=("roll", "pitch", "focal")),
    "prior_depth_anything": dict(group=SINGLE, hw=((480, 640), (518, 518)),
                                 per_forward=[0, 48, 48, 0],
                                 held={"depth": Held(7.5e-2), "depth_vggt": Held(1.2e-1),
                                       "confidence": Held(1.2e-1)}),
}
GEOCALIB_FIELDS = tuple(FAMILIES["geocalib"]["held"])
POINTMAP = ("moge2", "metric_anything")
GEOMETRIC = ("unidepth_v2", "unik3d")
# Seeded random weights leave the MoGe pair's mask logit about 0, where the
# mask can hold no pixel and the focal solve reads 0/0: an output bias of
# the mask branch keeps most pixels in the mask (as lift_depth_pro_outputs
# does for Depth Pro); nothing else of the weights moves.
MOGE_MASK_BIAS = 1.0
# GeoCalib's fp32 up field, card against CPU, is held on max rel over the
# pixels where the field's norm before normalization is at least this share
# of its median: below it the unit vector turns with the last bits of its
# two components (max rel 1.4e-3 to 3.2e-3 over all pixels in card runs; 5.8e-5
# over the rest, 0.7 % of the pixels left out, in one). The share left out is
# recorded.
UP_NORM_NEAR_0 = 0.1
# The fp32 card-vs-CPU comparison cuts each family's ViTs to 4 blocks (taps 0
# to 3) at full width and resolution, Prior Depth Anything's VGGT to 4
# alternating blocks on a 4-block patch embed; MoGe-2 vits runs whole.
FAMILY_CPU_VIT_DEPTH = 4


def lift_moge_mask(model) -> None:
    import torch

    with torch.no_grad():
        model.head.mask_out[2].bias.fill_(MOGE_MASK_BIAS)


def family_cut_kw(name, depth=None):
    """Keyword arguments of a family's pipeline: none at full depth; else its
    ViTs (ViT-L, ViT-B or ViT-S at full width) cut to ``depth`` blocks with
    taps spread over them, and Prior Depth Anything's VGGT cut likewise."""
    if depth is None:
        return {}
    import dataclasses

    from monocular_depth_estimation_trt_tpu_torch.models.geometric import GeometricConfig
    from monocular_depth_estimation_trt_tpu_torch.models.metric3d_v2 import Metric3DConfig
    from monocular_depth_estimation_trt_tpu_torch.models.moge2 import MoGeConfig
    from monocular_depth_estimation_trt_tpu_torch.models.vggt import VGGTConfig
    from monocular_depth_estimation_trt_tpu_torch.models.vit import VIT_CONFIGS

    encoder = {"unidepth_v2": "vitb", "unik3d": "vitb", "sidepth": "vits", "geocalib": "vits",
               "prior_depth_anything": "vits"}.get(name, "vitl")
    vit = dataclasses.replace(VIT_CONFIGS[encoder], depth=depth)
    taps = tuple(range(depth // 4 - 1, depth, depth // 4))
    if name in ("depth_anything_v3", "sidepth", "geocalib"):
        return dict(model_kw=dict(vit_config=vit, out_indices=taps))
    if name == "prior_depth_anything":
        return dict(model_kw=dict(vit_config=vit, out_indices=taps),
                    vggt_cfg=VGGTConfig(depth=depth, head_layers=taps,
                                        vit_config=dataclasses.replace(VIT_CONFIGS["vitl"],
                                                                       depth=depth)))
    if name in GEOMETRIC:
        return dict(model_kw=dict(cfg=GeometricConfig(vit_config=vit, out_indices=taps)))
    if name == "metric3d_v2":
        return dict(model_kw=dict(cfg=Metric3DConfig(vit_config=vit, out_indices=taps)))
    return dict(model_kw=dict(cfg=MoGeConfig(vit_config=vit, out_indices=taps)))


def family_pipeline(build_pipeline, name, **kw):
    pipe = build_pipeline(name, **kw)
    if name in POINTMAP:
        lift_moge_mask(pipe.model)
    return pipe


def family_model(name, seed):
    """A family's full-size model on seeded random weights (fp32, CPU)."""
    from monocular_depth_estimation_trt_tpu_torch.models.depth_anything_v3 import (
        DepthAnythingV3,
    )
    from monocular_depth_estimation_trt_tpu_torch.models.geocalib import GeoCalib
    from monocular_depth_estimation_trt_tpu_torch.models.geometric import GeometricDepthModel
    from monocular_depth_estimation_trt_tpu_torch.models.metric3d_v2 import Metric3DV2
    from monocular_depth_estimation_trt_tpu_torch.models.moge2 import MoGe2
    from monocular_depth_estimation_trt_tpu_torch.models.prior_depth import (
        PriorDARefiner,
        PriorDepthAnything,
    )
    from monocular_depth_estimation_trt_tpu_torch.models.sidepth import SIDepth
    from monocular_depth_estimation_trt_tpu_torch.models.vggt import VGGT
    from monocular_depth_estimation_trt_tpu_torch.weights.store import init_random_

    model = {"depth_anything_v3": DepthAnythingV3, "metric3d_v2": Metric3DV2,
             "moge2": MoGe2,
             "metric_anything": lambda: MoGe2("vitl", 3600, predict_normal=False),
             "unidepth_v2": GeometricDepthModel,
             "unik3d": lambda: GeometricDepthModel(mode="unik3d"),
             "sidepth": SIDepth, "geocalib": GeoCalib,
             "prior_depth_anything": lambda: PriorDepthAnything(VGGT(with_camera=False),
                                                                PriorDARefiner())}[name]()
    init_random_(model, seed)
    if name in POINTMAP:
        lift_moge_mask(model)
    return model


def family_params(name, model):
    """``params`` of a family's pipeline from its model's weights, as fp32
    CPU tensors (Prior Depth Anything: a state dict each for VGGT and the
    refiner)."""
    def sd(m):
        return {k: v.float().cpu() for k, v in m.state_dict().items()}

    if name == "prior_depth_anything":
        return {"vggt": sd(model.vggt), "refiner": sd(model.refiner)}
    return sd(model)


def check_family_outputs(name, key, out, hw):
    """The outputs of one forward: shapes, dtypes, and finite values where
    they must be (the MoGe pair: depth and points finite on the mask and inf
    off it, normal finite, focal and scale finite; GeoCalib: its fields, the
    up field of unit norm, and its fit recorded). Returns a summary."""
    import numpy as np

    at = f"{name} {key}"
    if name == "geocalib":
        side = FAMILIES[name]["hw"][1]
        for k in GEOCALIB_FIELDS:
            check(out[k].shape[:2] == side and bool(np.isfinite(out[k]).all()), f"{at}: {k}")
        norm_err = float(np.abs(np.linalg.norm(out["up_field"], axis=-1) - 1.0).max())
        check(norm_err < 1e-3, f"{at}: up field off unit norm by {norm_err}")
        for k in ("up_confidence", "latitude_confidence"):
            check(out[k].min() >= 0.0 and out[k].max() <= 1.0, f"{at}: {k} outside [0, 1]")
        check(np.abs(out["latitude_field"]).max() <= np.pi / 2, f"{at}: latitude")
        # the fit of random-weight fields may run off (PERF.md): recorded
        return {"up_field_norm_err": norm_err,
                **{k: finite_or_none(float(out[k])) for k in (
                    "roll", "pitch", "focal", "vfov", "hfov", "roll_uncertainty",
                    "pitch_uncertainty", "focal_uncertainty", "vfov_uncertainty")}}
    d = out["depth"]
    if name in POINTMAP:
        mask = out["mask"]
        check(mask.dtype == np.bool_ and d.shape == mask.shape, f"{at}: mask {mask.shape}")
        check(bool(np.isfinite(d[mask]).all()) and bool(np.isinf(d[~mask]).all()),
              f"{at}: depth not finite on the mask or not inf off it")
        pts = out["points"]
        check(pts.shape == (*d.shape, 3) and bool(np.isfinite(pts[mask]).all())
              and bool(np.isinf(pts[~mask]).all()), f"{at}: points")
        if "normal" in out:
            check(bool(np.isfinite(out["normal"]).all()) and not out["normal"][~mask].any(),
                  f"{at}: normal")
        focal, scale = float(out["focal"]), float(out["metric_scale"])
        check(np.isfinite(focal) and np.isfinite(scale) and scale > 0,
              f"{at}: focal {focal}, metric_scale {scale}")
        check(mask.mean() > 0.1, f"{at}: {mask.mean()} of the pixels in the mask")
        check(np.ptp(d[mask]) > 0, f"{at}: depth is constant")
        return {"depth_shape": list(d.shape), "mask_share": float(mask.mean()),
                "depth_range_on_mask": [float(d[mask].min()), float(d[mask].max())],
                "focal": focal, "metric_scale": scale}
    check(d.shape == hw and d.dtype == np.float32 and bool(np.isfinite(d).all()),
          f"{at}: depth {d.shape} {d.dtype}")
    rec = {"depth_shape": list(d.shape), "depth_range": [float(d.min()), float(d.max())]}
    check(d.max() > d.min(), f"{at}: depth is constant")
    if name in GEOMETRIC:
        pts, conf, K = out["pts_3d"], out["confidence"], out["intrinsics"]
        check(pts.shape == (*hw, 3) and bool(np.isfinite(pts).all()), f"{at}: pts_3d")
        check(np.array_equal(d, np.clip(pts[..., 2], 1e-3, 1e3)), f"{at}: depth is not z")
        check(conf.shape == hw and conf.min() >= 0.0 and conf.max() <= 1.0, f"{at}: confidence")
        check(K.shape == (3, 3) and bool(np.isfinite(K).all()) and K[0, 0] > 0 and K[1, 1] > 0,
              f"{at}: intrinsics {K.tolist()}")
        rec["intrinsics"] = K.tolist()
        return rec
    for k in FAMILIES[name]["held"]:
        check(out[k].shape == hw and bool(np.isfinite(out[k]).all()), f"{at}: {k}")
    if name == "metric3d_v2":
        check(d.min() >= 0.0 and d.max() <= 300.0, f"{at}: depth outside [0, 300]")
    if name in ("depth_anything_v3", "sidepth", "prior_depth_anything"):
        check(d.min() >= 1e-3 and d.max() <= 1e3, f"{at}: depth outside the clamp")
    if name == "depth_anything_v3":
        rec["sky_range"] = [float(out["sky"].min()), float(out["sky"].max())]
    if name == "sidepth":
        rec["ssi_range"] = [float(out["ssi"].min()), float(out["ssi"].max())]
    if name == "prior_depth_anything":
        check(out["confidence"].min() >= 1.0, f"{at}: VGGT confidence below 1")
        rec["depth_vggt_range"] = [float(out["depth_vggt"].min()),
                                   float(out["depth_vggt"].max())]
    return rec


def run_family_path(name, build_pipeline, wrappers, rng):
    """One family's path with its own counts: set to 0 just before, read
    just after; each frame through ``__call__`` and a new engine (the first
    with the viz epilogue). Returns the pipeline, the counts and the frames."""
    import numpy as np
    import torch

    fam = FAMILIES[name]
    t0 = time.perf_counter()
    pipe = family_pipeline(build_pipeline, name)
    build_s = time.perf_counter() - t0
    check(pipe.device.type == "cuda", f"{name} default device is {pipe.device}")
    frames = {f"frame_{h}x{w}": rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in fam["hw"]}

    set_counts_to_zero(wrappers)
    per_forward, outs = {}, {}
    for i, (key, frame) in enumerate(frames.items()):
        viz = i == 0
        outs[key], per_forward[key] = run_counted(
            lambda: pipe(frame, viz=viz), lambda: pipe.engine_for(frame.shape[:2], viz),
            wrappers, f"{name} {key}")
    torch.cuda.synchronize()
    launches = launch_record(wrappers)

    want = fam["per_forward"]
    for key, got in per_forward.items():
        check(got == want, f"{name} {key}: K3, K1, K2, K4 launches {got}, want {want}")
    forwards = len(frames) * (WARMUP_CALLS + 1)
    check(launches == {k: n * forwards for k, n in zip(KERNELS, want)},
          f"launches on the {name} path {launches}")
    rec = {"phase": f"{fam['group']}_path", "model": pipe.spec.artifact_name(),
           "build_seconds": build_s, "forwards": list(per_forward),
           "launches_per_forward_k3_k1_k2_k4": per_forward, "launches": launches,
           "counted": f"{WARMUP_CALLS} warm-up + 1 captured per engine"}
    for key, frame in frames.items():
        rec[key] = check_family_outputs(name, key, outs[key], frame.shape[:2])
    first = outs[next(iter(frames))]
    if pipe.viz != "none":
        check(first["viz"].dtype == np.uint8 and first["viz"].shape[:2] == first["depth"].shape,
              f"{name} viz")
    emit(rec)
    return pipe, launches, frames


def family_outputs(name, pipe, frame):
    """The compared outputs of one frame as host arrays: the pipeline's, or,
    for the MoGe pair, its model's on the pipeline's preprocessed input,
    with the family's recorded scalars beside them (the MoGe focal,
    GeoCalib's roll, pitch and focal)."""
    import numpy as np
    import torch

    from monocular_depth_estimation_trt_tpu_torch.registry import _imagenet_square

    out = pipe(frame)
    if name not in POINTMAP:
        got = {k: out[k] for k in FAMILIES[name]["held"]}
    else:
        x = torch.from_numpy(frame).to(pipe.device)
        with torch.inference_mode():
            raw = pipe.model(_imagenet_square(pipe.spec.input_hw)(x[None]))
        got = {k: v[0].float().cpu().numpy() for k, v in raw.items()}
    for k in FAMILIES[name].get("recorded", ()):
        got[k] = np.asarray(out[k])
    return got


def family_readings(name, a, b):
    """max rel and mean rel of ``a`` against ``b`` on the family's compared
    outputs."""
    return {k: {"rel": rel(a[k], b[k]), "mean_rel": mean_rel(a[k], b[k])}
            for k in FAMILIES[name]["held"]}


def geocalib_up_norm(pipe, frame):
    """The norm of GeoCalib's up field before it is made a unit vector, at
    the network's input size (host array)."""
    import torch

    from monocular_depth_estimation_trt_tpu_torch.models.sidepth import run_stack
    from monocular_depth_estimation_trt_tpu_torch.registry import _imagenet_square

    x = torch.from_numpy(frame).to(pipe.device)
    with torch.inference_mode():
        raw = run_stack(pipe.model.backbone, pipe.model.head,
                        _imagenet_square(pipe.spec.input_hw)(x[None]))
    return torch.linalg.vector_norm(raw[0, ..., 0:2].float(), dim=-1).cpu().numpy()


def family_parity(name, build_pipeline, pipe, frames):
    """For each weight seed and frame, on weights rounded to bf16 and shared
    by every route: the bf16 kernel route (K1) against plain attention and
    against the fp32 card path, each output held to its ``Held`` bar of the
    plain route at every reading and, averaged over the readings, to
    PATH_BF16_ROUTE_RATIO times the plain route's distance from fp32. Then
    the fp32 path on the card against the CPU (ViTs cut to
    FAMILY_CPU_VIT_DEPTH blocks), every output on max rel. Every reading is
    emitted before any is checked."""
    import numpy as np
    import torch

    fam = FAMILIES[name]
    held, group, recorded = fam["held"], fam["group"], fam.get("recorded", ())
    readings = []
    for seed in PARITY_WEIGHT_SEEDS:
        kernel_pipe = pipe
        if seed != 0:  # the path's pipeline holds seed 0
            model = family_model(name, seed)
            kernel_pipe = build_pipeline(name, params=family_params(name, model))
            del model
        sd = family_params(name, kernel_pipe.model)
        plain_pipe = build_pipeline(name, attn_impl="xla", params=sd)
        card32_pipe = build_pipeline(name, precision="fp32", params=sd)
        for frame_name, frame in frames.items():
            kernel, plain, card32 = (family_outputs(name, p, frame)
                                     for p in (kernel_pipe, plain_pipe, card32_pipe))
            rec = {"phase": f"{group}_parity", "model": name, "weights_seed": seed,
                   "frame": frame_name,
                   "bf16_kernel_vs_plain_attention": family_readings(name, kernel, plain),
                   "bf16_kernel_route_vs_fp32": family_readings(name, kernel, card32),
                   "bf16_plain_route_vs_fp32": family_readings(name, plain, card32)}
            for k in recorded:
                rec[k] = {route: finite_or_none(float(got[k])) for route, got in
                          (("kernel", kernel), ("plain", plain), ("fp32", card32))}
            emit(rec)
            readings.append(rec)
        drop_engines(plain_pipe, card32_pipe, kernel_pipe)
        del kernel_pipe, plain_pipe, card32_pipe, sd

    # fp32, card against CPU, on the first frame
    depth = None if name == "moge2" else FAMILY_CPU_VIT_DEPTH
    cut = family_cut_kw(name, depth)
    card32 = family_pipeline(build_pipeline, name, precision="fp32", **cut)
    frame_name, frame = next(iter(frames.items()))
    got_card = family_outputs(name, card32, frame)
    sd = family_params(name, card32.model)
    drop_engines(card32)
    del card32
    t0 = time.perf_counter()
    cpu32 = build_pipeline(name, precision="fp32", device="cpu", params=sd, **cut)
    got_cpu = family_outputs(name, cpu32, frame)
    cpu_rec = {"phase": f"{group}_parity_cpu", "model": name, "frame": frame_name,
               "cpu_fp32_seconds": time.perf_counter() - t0,
               "model_depth": "full" if depth is None else
               f"full widths and resolution; {depth} blocks of each ViT"
               + (" and of VGGT's aggregator" if name == "prior_depth_anything" else ""),
               "fp32_card_vs_cpu": family_readings(name, got_card, got_cpu)}
    fp32_rel = {k: cpu_rec["fp32_card_vs_cpu"][k]["rel"] for k in held}
    if name == "geocalib":  # the up field where its norm is not near 0
        norm = geocalib_up_norm(cpu32, frame)
        kept = norm >= UP_NORM_NEAR_0 * np.median(norm)
        fp32_rel["up_field"] = rel(got_card["up_field"][kept], got_cpu["up_field"][kept])
        cpu_rec["fp32_card_vs_cpu"]["up_field"].update(
            rel_where_norm_not_near_0=fp32_rel["up_field"],
            share_near_0=float(1.0 - kept.mean()))
    for k in recorded:
        cpu_rec[k] = {"card": finite_or_none(float(got_card[k])),
                      "cpu": finite_or_none(float(got_cpu[k]))}
    emit(cpu_rec)
    del cpu32
    torch.cuda.empty_cache()

    def worst(route, k):
        return max(r[route][k][held[k].gate] for r in readings)

    def average(route, k):
        return sum(r[route][k][held[k].gate] for r in readings) / len(readings)

    ratio = {k: average("bf16_kernel_route_vs_fp32", k)
             / max(average("bf16_plain_route_vs_fp32", k), 1e-12) for k in held}
    summary = {"phase": f"{group}_parity_summary", "model": name,
               "readings": len(readings),
               **{k: {"held_on": h.gate,
                      "max_bf16_kernel_vs_plain_attention": worst("bf16_kernel_vs_plain_attention",
                                                                  k),
                      "max_bf16_kernel_route_vs_fp32": worst("bf16_kernel_route_vs_fp32", k),
                      "max_bf16_plain_route_vs_fp32": worst("bf16_plain_route_vs_fp32", k),
                      "bf16_kernel_vs_plain_attention_tolerance": h.bar,
                      "kernel_over_plain_route_vs_fp32": ratio[k],
                      "ratio_held": h.in_ratio} for k, h in held.items()},
               "bf16_route_ratio_tolerance": PATH_BF16_ROUTE_RATIO,
               "fp32_tolerance": PATH_FP32_REL_TOL}
    emit(summary)
    for r in readings:
        at = f"seed {r['weights_seed']} {r['frame']}"
        for k, h in held.items():
            got = r["bf16_kernel_vs_plain_attention"][k][h.gate]
            check(got < h.bar, f"{name} bf16 {k} kernel vs plain attention {got} ({at})")
    for k, h in held.items():
        check(not h.in_ratio or ratio[k] <= PATH_BF16_ROUTE_RATIO,
              f"{name} bf16 {k}: kernel route {ratio[k]} x as far from fp32 as the plain "
              f"route, over {len(readings)} readings")
        check(fp32_rel[k] < PATH_FP32_REL_TOL, f"{name} fp32 {k} card vs cpu {fp32_rel[k]}")


# GeoCalib's fit on the fields of a known camera at the network's 322^2:
# roll and pitch (radians) and the focal (pixels; a vertical FoV of 60 degrees)
GEOCALIB_CAMERA = {"roll": 0.12, "pitch": -0.25, "focal": 280.0}


def check_geocalib_fit(dev):
    """GeoCalib's 10-step Gauss-Newton fit (``models/geocalib.py::
    fit_camera``) on the card, eager and through an engine, on the fields
    that ``perspective_fields`` gives for GEOCALIB_CAMERA: as they are
    ("exact", unit weights), and with seeded noise on both fields under
    uneven weights ("noisy"). Every estimate is finite; the engine's replay,
    its output buffers filled with NaN first, equals the eager fit bit for
    bit; the eager fit agrees with the CPU's within PATH_FP32_REL_TOL (rel
    per estimate); the exact fit recovers the camera (roll and pitch within
    1e-3 rad, the focal within 1e-3 rel, as the JAX package's test)."""
    import torch

    from monocular_depth_estimation_trt_tpu_torch.models.geocalib import (
        fit_camera,
        perspective_fields,
    )
    from monocular_depth_estimation_trt_tpu_torch.runtime.engine import Engine

    hw = FAMILIES["geocalib"]["hw"][1]
    cam = {k: torch.tensor(v) for k, v in GEOCALIB_CAMERA.items()}
    up, lat = perspective_fields(cam["roll"], cam["pitch"], cam["focal"], hw)
    gen = torch.Generator().manual_seed(9)
    noisy_up = up + 0.05 * torch.randn(up.shape, generator=gen)
    noisy_up = noisy_up / torch.linalg.vector_norm(noisy_up, dim=-1, keepdim=True)
    cases = {"exact": (up, lat, torch.ones(hw), torch.ones(hw)),
             "noisy": (noisy_up, lat + 0.02 * torch.randn(hw, generator=gen),
                       0.2 + 0.8 * torch.rand(hw, generator=gen),
                       0.2 + 0.8 * torch.rand(hw, generator=gen))}

    def fit(*fields):
        return fit_camera(*fields, hw, iters=10)

    for case, fields in cases.items():
        cpu = fit(*fields)
        on_card = [f.to(dev) for f in fields]
        with torch.inference_mode():
            eager = fit(*on_card)
        engine = Engine(fit, on_card, name=f"geocalib_fit_{case}_{hw[0]}x{hw[1]}").compile()
        with torch.inference_mode():
            for t in engine.static_outputs().values():
                t.fill_(float("nan"))
        replay = engine(*fields)
        torch.cuda.synchronize()
        rec = {"phase": "geocalib_fit", "case": case, "hw": list(hw), "iters": 10,
               "camera": GEOCALIB_CAMERA,
               "card": {k: float(v) for k, v in eager.items()},
               "cpu": {k: float(v) for k, v in cpu.items()},
               "replay_equal_to_eager": all(torch.equal(replay[k], eager[k]) for k in eager),
               "card_vs_cpu_rel": {k: abs(float(eager[k]) - float(cpu[k]))
                                   / max(abs(float(cpu[k])), 1e-12) for k in eager},
               "card_vs_camera": {k: abs(float(eager[k]) - v)
                                  / (v if k == "focal" else 1.0)
                                  for k, v in GEOCALIB_CAMERA.items()},
               "tolerance": PATH_FP32_REL_TOL}
        emit(rec)
        engine.release()
        check(all(math.isfinite(v) for v in rec["card"].values())
              and bool(all(torch.isfinite(v).all() for v in replay.values())),
              f"geocalib fit {case}: not finite {rec['card']}")
        check(rec["replay_equal_to_eager"], f"geocalib fit {case}: replay differs from eager")
        held = GEOCALIB_CAMERA if case == "exact" else eager
        for k in held:
            got = rec["card_vs_cpu_rel"][k]
            check(got < PATH_FP32_REL_TOL, f"geocalib fit {case}: {k} card vs cpu rel {got}")
        if case == "exact":
            got = rec["card_vs_camera"]
            check(all(v < 1e-3 for v in got.values()),
                  f"geocalib fit: off the camera by {got} (radians; focal rel)")


def w8a8_operands(m, k, n, dtype, dev, gen):
    """K4's operands at one shape: activations whose quantized values span
    the int8 range (a few clip at +-127), random int8 weights, scales of a
    calibrated layer."""
    import torch

    x = torch.randn((m, k), generator=gen).to(dev, dtype)
    wq = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8).to(dev)
    qmul = (10.0 + 50.0 * torch.rand(k, generator=gen)).to(dev)
    scale = (1e-5 + 1e-3 * torch.rand(n, generator=gen)).to(dev)
    bias = torch.randn(n, generator=gen).to(dev)
    return x, wq, qmul, scale, bias


def w8a8_bound(m, k, n, itemsize):
    ops = 2.0 * m * k * n
    nbytes = float(m * k * itemsize + n * k + 4 * (k + 2 * n) + m * n * itemsize)
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def w8a8_library(x, wq, qmul, scale, bias):
    """The same function through PyTorch calls: quantize, torch._int_mm
    (cuBLASLt int8), rescale. A yardstick only; the port never calls it."""
    import torch

    xq = torch.clamp(torch.round(x.float() * qmul), -127, 127).to(torch.int8)
    return (torch._int_mm(xq, wq.t()).float() * scale + bias).to(x.dtype)


def check_w8a8_matmul(qm, dev):
    """K4 against its plain version, bit for bit (torch.equal), at the int8
    paths' shapes (DA-V2 ViT-L's four layers at M = 1370; Depth Pro's patch
    encoder at M = 35 x 577 = 20,195; VGGT S=4 at M = 4 x 1374 = 5,496) in
    bf16 and fp32, and at edge shapes M in (1, 17, 130), K in (32, 40, 96),
    N in (8, 136, 1000); timings of the kernel, the plain version and the
    library chain (quantize, torch._int_mm, rescale) at the main shapes."""
    import torch

    gen = torch.Generator().manual_seed(4)
    main = [  # (label, M, K, N, dtype)
        ("vitl_qkv", 1370, 1024, 3072, torch.bfloat16),
        ("vitl_proj", 1370, 1024, 1024, torch.bfloat16),
        ("vitl_fc1", 1370, 1024, 4096, torch.bfloat16),
        ("vitl_fc2", 1370, 4096, 1024, torch.bfloat16),
        ("depth_pro_fc1", 20195, 1024, 4096, torch.bfloat16),
        ("depth_pro_fc2", 20195, 4096, 1024, torch.bfloat16),
        ("vggt_s4_fc1", 5496, 1024, 4096, torch.bfloat16),
        # Metric3D V2's ViT-L at 616x1064 (M = 3349 tokens)
        ("metric3d_qkv", 3349, 1024, 3072, torch.bfloat16),
        ("metric3d_proj", 3349, 1024, 1024, torch.bfloat16),
        ("metric3d_fc1", 3349, 1024, 4096, torch.bfloat16),
        ("metric3d_fc2", 3349, 4096, 1024, torch.bfloat16),
        # UniDepth V2's ViT-B pixel encoder at 518^2 (M = 1374 tokens)
        ("vitb_qkv", 1374, 768, 2304, torch.bfloat16),
        ("vitb_proj", 1374, 768, 768, torch.bfloat16),
        ("vitb_fc1", 1374, 768, 3072, torch.bfloat16),
        ("vitb_fc2", 1374, 3072, 768, torch.bfloat16),
        ("vitl_qkv_fp32", 1370, 1024, 3072, torch.float32),
        ("depth_pro_fc1_fp32", 20195, 1024, 4096, torch.float32),
    ]
    records = []
    for label, m, k, n, dtype in main:
        x, wq, qmul, scale, bias = w8a8_operands(m, k, n, dtype, dev, gen)
        out = qm.w8a8_matmul(x, wq, qmul, scale, bias)
        torch.cuda.synchronize()
        ref = qm.w8a8_matmul_reference(x, wq, qmul, scale, bias)
        check(out.shape == (m, n) and out.dtype == dtype, f"K4 {label}: {out.shape} {out.dtype}")
        equal = torch.equal(out, ref)
        err = (out.float() - ref.float()).abs().max().item()
        lib = w8a8_library(x, wq, qmul, scale, bias)
        clipped = (torch.round(x.float() * qmul).abs() > 127).float().mean().item()
        bound_ms, bound_by = w8a8_bound(m, k, n, x.element_size())
        w = wq.to(dtype)  # the yardstick int8 serving has to beat: the matmul it replaces
        rec = {"shape": label, "M": m, "K": k, "N": n, "dtype": str(dtype).replace("torch.", ""),
               "equal": equal, "max_abs_err": err, "tolerance": "torch.equal",
               "library_equal": torch.equal(lib, ref), "share_clipped": clipped,
               "kernel_ms": device_ms(lambda: qm.w8a8_matmul(x, wq, qmul, scale, bias)),
               "kernel_event_ms": event_ms(lambda: qm.w8a8_matmul(x, wq, qmul, scale, bias)),
               "host_us_per_call": host_us(lambda: qm.w8a8_matmul(x, wq, qmul, scale, bias)),
               "plain_ms": event_ms(lambda: qm.w8a8_matmul_reference(x, wq, qmul, scale, bias),
                                    iters=5, warmup=1),
               "library_ms": device_ms(lambda: w8a8_library(x, wq, qmul, scale, bias)),
               "matmul_ms": device_ms(lambda: torch.matmul(x, w.t())),
               "bound_ms": bound_ms, "bound_by": bound_by}
        rec["kernel_tops"] = 2.0 * m * k * n / rec["kernel_ms"] / 1e9
        emit({"phase": "kernel_check", "kernel": "w8a8_matmul", **rec})
        records.append(rec)
        check(equal, f"K4 {label}: differs from its plain version by {err}")
        del x, wq, qmul, scale, bias, out, ref, lib, w
        torch.cuda.empty_cache()
    edges = []
    for dtype in (torch.bfloat16, torch.float32):
        for m in (1, 17, 130):
            for k in (32, 40, 96):
                for n in (8, 136, 1000):
                    ops = w8a8_operands(m, k, n, dtype, dev, gen)
                    out = qm.w8a8_matmul(*ops)
                    ref = qm.w8a8_matmul_reference(*ops)
                    edges.append({"M": m, "K": k, "N": n, "dtype": str(dtype)[6:],
                                  "equal": torch.equal(out, ref)})
    torch.cuda.synchronize()
    emit({"phase": "kernel_check", "kernel": "w8a8_matmul", "edge_shapes": len(edges),
          "all_equal": all(e["equal"] for e in edges)})
    bad = [e for e in edges if not e["equal"]]
    check(not bad, f"K4 differs from its plain version at {bad}")
    return records


def pearson(a, b) -> float:
    import numpy as np

    return float(np.corrcoef(np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64))[0, 1])


def int8_family(name, build_pipeline, calib):
    """What the int8 phases need of one family: the model class, a function
    that builds its pipeline at a precision on a state dict, one forward's
    outputs as host arrays, the per-forward launches [K3, K1, K2, K4] of its
    int8 path, and the outputs that Pearson r is read on."""
    import numpy as np

    from monocular_depth_estimation_trt_tpu_torch.models.depth_anything_v2 import (
        DepthAnythingV2,
    )
    from monocular_depth_estimation_trt_tpu_torch.models.depth_pro import DepthPro
    from monocular_depth_estimation_trt_tpu_torch.models.vggt import VGGT

    if name == "depth_anything_v2":
        return dict(
            make=lambda: DepthAnythingV2(encoder="vitl"),
            build=lambda precision, sd: build_pipeline(
                "depth_anything_v2", encoder="vitl", precision=precision, params=sd,
                calib_images=calib),
            run=lambda p, frame: {"depth": p(frame)["depth"]},
            per_forward=[0, 24, 0, 96], pearson_keys=("depth",))
    if name == "metric3d_v2":
        from monocular_depth_estimation_trt_tpu_torch.models.metric3d_v2 import Metric3DV2

        return dict(
            make=Metric3DV2,
            build=lambda precision, sd: build_pipeline(
                "metric3d_v2", precision=precision, params=sd, calib_images=calib),
            run=lambda p, frame: {k: v for k, v in p(frame).items() if k != "viz"},
            per_forward=[0, 24, 0, 96], pearson_keys=("depth",))
    if name in GEOMETRIC:
        from monocular_depth_estimation_trt_tpu_torch.models.geometric import (
            GeometricDepthModel,
        )

        mode = "unik3d" if name == "unik3d" else "unidepth"
        return dict(
            make=lambda: GeometricDepthModel(mode=mode),
            build=lambda precision, sd: build_pipeline(
                name, precision=precision, params=sd, calib_images=calib),
            run=lambda p, frame: {k: v for k, v in p(frame).items() if k != "viz"},
            per_forward=[0, 12, 0, 48], pearson_keys=("depth", "pts_3d", "confidence"))
    if name == "depth_pro":
        def build(precision, sd):
            return depth_pro_pipeline(build_pipeline, precision=precision, params=sd,
                                      calib_images=calib)

        def run(p, frame):
            out = p(frame)
            return {"inverse_depth": 1.0 / out["depth"], "f_px": np.asarray(out["f_px"])}

        return dict(make=DepthPro, build=build, run=run, per_forward=[24, 24, 0, 192],
                    pearson_keys=("inverse_depth",))

    def run_vggt(p, frame):
        out = p(frame)
        return {k: out[k] for k in ("depth", "depth_conf", "pose_enc")}

    return dict(make=VGGT,
                build=lambda precision, sd: build_pipeline("vggt", precision=precision,
                                                           params=sd, calib_images=calib),
                run=run_vggt, per_forward=[0, 24, 48, 288],
                pearson_keys=("depth", "depth_conf", "pose_enc"))


def run_int8_path(name, fam, wrappers, frames, views4=None):
    """One family's int8 path on seed-0 weights, with the counts set to 0
    just before and read just after: each frame through ``__call__`` (the
    first with the viz epilogue), then 4 views where the family has them.
    Returns the pipeline and the counts."""
    import numpy as np
    import torch

    from monocular_depth_estimation_trt_tpu_torch.ops.quant import QuantLinear
    from monocular_depth_estimation_trt_tpu_torch.weights.store import init_random_

    model = fam["make"]()
    init_random_(model, 0)
    t0 = time.perf_counter()
    pipe = fam["build"]("int8", model.state_dict())
    build_s = time.perf_counter() - t0
    del model
    check(pipe.device.type == "cuda" and pipe.spec.precision == "int8",
          f"{name} int8 on {pipe.device}, {pipe.spec.precision}")
    swapped = sum(isinstance(m, QuantLinear) for m in pipe.model.modules())
    torch.cuda.synchronize()

    set_counts_to_zero(wrappers)
    per_forward, outs = {}, {}
    for i, (key, frame) in enumerate(frames.items()):
        outs[key], per_forward[key] = run_counted(
            lambda: pipe(frame, viz=i == 0), lambda: pipe.engine_for(frame.shape[:2], i == 0),
            wrappers, f"{name} int8 {key}")
    if views4 is not None:
        outs["views_s4"], per_forward["views_s4"] = run_counted(
            lambda: pipe.multi_view(views4), lambda: pipe.views_engine(4), wrappers,
            f"{name} int8 views_s4")
    torch.cuda.synchronize()
    launches = launch_record(wrappers)

    want = fam["per_forward"]
    for key, got in per_forward.items():
        check(got == want, f"{name} int8 {key}: K3, K1, K2, K4 launches {got}, want {want}")
    forwards = len(per_forward) * (WARMUP_CALLS + 1)
    check(launches == {k: n * forwards for k, n in zip(KERNELS, want)},
          f"launches on the {name} int8 path {launches}")
    check(swapped == want[3], f"{name} int8: {swapped} QuantLinear layers, want {want[3]}")
    rec = {"phase": "int8_path", "model": pipe.spec.artifact_name(), "build_seconds": build_s,
           "quantized_layers": swapped, "forwards": list(per_forward),
           "launches_per_forward_k3_k1_k2_k4": per_forward, "launches": launches}
    for key, out in outs.items():
        d = out["depth"]
        check(bool(np.isfinite(d).all()), f"{name} int8 {key}: depth not finite")
        check(d.max() > d.min(), f"{name} int8 {key}: depth is constant")
        if key in frames:
            check(d.shape == frames[key].shape[:2], f"{name} int8 {key}: depth {d.shape}")
        rec[key] = {"depth_shape": list(d.shape), "depth_range": [float(d.min()), float(d.max())]}
    first = outs[next(iter(frames))]
    check(first["viz"].dtype == np.uint8 and first["viz"].shape[:2] == first["depth"].shape,
          f"{name} int8 viz")
    emit(rec)
    return pipe, launches


def int8_parity(name, fam, path_pipe, frames):
    """For each weight seed and frame, the int8 route against the bf16 and
    fp32 routes on the same fp32 weights: Pearson r against fp32 (held above
    INT8_PEARSON_MIN at every reading) and max rel against both (against
    fp32 held below INT8_REL_TOL). Every reading is emitted before any is
    checked."""
    import numpy as np
    import torch

    from monocular_depth_estimation_trt_tpu_torch.weights.store import init_random_

    readings = []
    for seed in PARITY_WEIGHT_SEEDS:
        model = fam["make"]()
        init_random_(model, seed)
        sd = model.state_dict()
        del model
        int8 = path_pipe if seed == 0 else fam["build"]("int8", sd)
        bf16, fp32 = fam["build"]("bf16", sd), fam["build"]("fp32", sd)
        for frame_name, frame in frames.items():
            q, b, f = (fam["run"](p, frame) for p in (int8, bf16, fp32))
            rec = {"phase": "int8_parity", "model": name, "weights_seed": seed,
                   "frame": frame_name}
            for k in q:
                rec[k] = {"int8_vs_fp32_rel": rel(q[k], f[k]),
                          "int8_vs_fp32_mean_rel": mean_rel(q[k], f[k]),
                          "int8_vs_bf16_rel": rel(q[k], b[k]),
                          "bf16_vs_fp32_rel": rel(b[k], f[k]),
                          "bf16_vs_fp32_mean_rel": mean_rel(b[k], f[k])}
                if k in fam["pearson_keys"]:
                    rec[k]["int8_vs_fp32_pearson"] = pearson(q[k], f[k])
                    rec[k]["bf16_vs_fp32_pearson"] = pearson(b[k], f[k])
            emit(rec)
            readings.append(rec)
        drop_engines(bf16, fp32, *(() if int8 is path_pipe else (int8,)))
        del int8, bf16, fp32, sd
    keys = [k for k in readings[0] if isinstance(readings[0][k], dict)]
    emit({"phase": "int8_parity_summary", "model": name, "readings": len(readings),
          **{k: {"max_int8_vs_fp32_rel": max(r[k]["int8_vs_fp32_rel"] for r in readings),
                 "max_bf16_vs_fp32_rel": max(r[k]["bf16_vs_fp32_rel"] for r in readings),
                 "min_int8_vs_fp32_pearson": min(
                     (r[k].get("int8_vs_fp32_pearson", 1.0) for r in readings)),
                 "int8_vs_fp32_rel_tolerance": INT8_REL_TOL[name][k]}
             for k in keys},
          "pearson_tolerance": INT8_PEARSON_MIN})
    for r in readings:
        at = f"seed {r['weights_seed']} {r['frame']}"
        for k in keys:
            check(bool(np.isfinite(r[k]["int8_vs_fp32_rel"])), f"{name} int8 {k} ({at})")
            got = r[k].get("int8_vs_fp32_pearson")
            check(got is None or got > INT8_PEARSON_MIN,
                  f"{name} int8 {k}: Pearson r {got} against fp32 ({at})")
            got = r[k]["int8_vs_fp32_rel"]
            check(got < INT8_REL_TOL[name][k], f"{name} int8 {k} vs fp32 rel {got} ({at})")


ROUTE_TURNS = ("eager", "graph", "graph", "eager")


def p_eager(pipe, in_hw):
    """The pipeline's eager forward of one frame (or batch) of size ``in_hw``
    without the viz epilogue: what its engine captures."""
    return lambda x: pipe._eager(x, in_hw, False)


def timed_route(pipe, route, in_hw, views, config):
    """The benchmark of one path: ``DepthPipeline.benchmark`` /
    ``VGGTPipeline.benchmark_views`` through the engine ("graph"), or the
    same step through the eager forward ("eager"): pinned uint8 H2D,
    forward, depth D2H into pinned memory (S views: device-resident uint8
    views, forward only)."""
    import numpy as np
    import torch

    from monocular_depth_estimation_trt_tpu_torch.runtime.benchmark import benchmark

    if route == "graph":
        return pipe.benchmark_views(views, config) if views else pipe.benchmark(in_hw, config)
    rng = np.random.default_rng(0)
    if views:
        arg = torch.from_numpy(
            rng.integers(0, 255, (views, *pipe.spec.input_hw, 3), dtype=np.uint8)).to(pipe.device)

        def step():
            with torch.inference_mode():
                pipe._views_forward(arg)
    else:
        frame = rng.integers(0, 255, size=(*in_hw, 3), dtype=np.uint8)
        host_in = torch.from_numpy(frame).pin_memory()
        # what DepthPipeline.benchmark fetches: the depth, else every output
        out = pipe._run(host_in.to(pipe.device), tuple(in_hw), False)
        host_out = {k: torch.empty(out[k].shape, dtype=out[k].dtype).pin_memory()
                    for k in (["depth"] if "depth" in out else sorted(out))}

        def step():
            dev = host_in.to(pipe.device, non_blocking=True)
            res = pipe._run(dev, tuple(in_hw), False)
            for k, buf in host_out.items():
                buf.copy_(res[k], non_blocking=True)
    rep = benchmark(step, device=pipe.device, config=config, name=pipe.spec.artifact_name())
    rep.frames_per_iteration = views or 1
    return rep


def speed_record(rep, pipe, label, route, turn, views, in_hw, card, power_limit):
    per = "_per_forward" if views else ""
    return {"phase": "speed", "path": label, "model": pipe.spec.artifact_name(),
            "route": route, "turn": turn, "views": views or None,
            "fps_per_frame" if views else "fps": rep.fps, f"mean_ms{per}": rep.avg_ms,
            f"p50_ms{per}": rep.percentile_ms(50), f"p99_ms{per}": rep.percentile_ms(99),
            "iterations": rep.iterations,
            "includes": (f"forward of {views} device-resident uint8 views" if views
                         else f"H2D uint8 {in_hw[0]}x{in_hw[1]} + forward + D2H "
                              + ("every output" if pipe.spec.model == "geocalib" else "depth")),
            "card": card, "power_limit": power_limit}


def finite_or_none(x: float):
    return x if math.isfinite(x) else None


def check_engine(label, pipe, engine, eager, arg, other, want, wrappers):
    """One engine against the eager forward it captures: the eager forward's
    launches [K3, K1, K2, K4] equal the captured forward's and ``want``; the
    capture's output buffers are filled with NaN before the first replay,
    whose outputs are finite and equal the eager forward's bit for bit (or,
    where a library call picks another algorithm under capture, within
    ENGINE_REL_TOL, recorded); a result survives the next call on another
    input."""
    import numpy as np
    import torch

    dev_arg = torch.from_numpy(arg).to(pipe.device)
    before = counts(wrappers)
    with torch.inference_mode():
        ref = eager(dev_arg)
    torch.cuda.synchronize()
    eager_launches = [a - b for a, b in zip(counts(wrappers), before)]
    engine.compile()
    with torch.inference_mode():
        for t in engine.static_outputs().values():
            if t.is_floating_point():
                t.fill_(float("nan"))
    out = engine(torch.from_numpy(arg))
    kept = {k: v.clone() for k, v in out.items()}
    second = engine(torch.from_numpy(other))
    torch.cuda.synchronize()
    rec = {"phase": "engine", "path": label, "engine": engine.name,
           "build_seconds": engine.build_seconds,
           "launches_per_forward_k3_k1_k2_k4": {"eager": eager_launches,
                                                "captured": engine_launches(engine)},
           "outputs": {}}
    for k in out:
        a, b = out[k].float(), ref[k].float()
        equal = bool(torch.equal(out[k], ref[k]))
        rec["outputs"][k] = {
            "equal_to_eager": equal, "finite": bool(torch.isfinite(a).all()),
            "eager_finite": bool(torch.isfinite(b).all()), "nan": bool(torch.isnan(a).any()),
            "max_rel": finite_or_none(
                ((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()),
            "survives_next_call": bool(torch.equal(out[k], kept[k])),
            "next_call_differs": not torch.equal(second[k], out[k]) if second[k].numel() > 1
            else None}
    emit(rec)
    check(eager_launches == engine_launches(engine) == want,
          f"engine {label}: launches eager {eager_launches}, captured "
          f"{engine_launches(engine)}, want {want}")
    for k, r in rec["outputs"].items():
        # the replay overwrote every NaN, and is finite wherever eager is
        # (VGGT's random-weight fov can sit at the relu's 0: focal_px inf)
        check(not r["nan"] and (r["finite"] or (r["equal_to_eager"] and not r["eager_finite"])),
              f"engine {label} {k}: not finite after the NaN-filled capture")
        check(r["equal_to_eager"] or (r["max_rel"] or math.inf) <= ENGINE_REL_TOL,
              f"engine {label} {k}: replay vs eager max rel {r['max_rel']}")
        check(r["survives_next_call"], f"engine {label} {k}: overwritten by the next call")
    main_key = "depth" if "depth" in out else max(out, key=lambda k: out[k].numel())
    check(rec["outputs"][main_key]["next_call_differs"],
          f"engine {label}: another input gave the same {main_key}")


class LaunchRecorder:
    """A pipeline seen through the server: records the frames of every
    launch (``__call__`` and ``batch_call``), then delegates."""

    def __init__(self, pipe):
        self.pipe, self.spec, self.device = pipe, pipe.spec, pipe.device
        self.launches = []

    def __call__(self, frame, viz=False, device_out=False):
        import numpy as np

        self.launches.append((np.array(frame)[None], viz, False))
        return self.pipe(frame, viz=viz, device_out=device_out)

    def batch_call(self, frames, viz=False, device_out=False):
        import numpy as np

        self.launches.append((np.array(frames), viz, True))
        return self.pipe.batch_call(frames, viz=viz, device_out=device_out)


def post(url, body, timeout=120):
    """(status, body) of a POST."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"),
                                    timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def server_phase(pipe, rng):
    """``DepthServer`` over the vits pipeline on port 0 with max_batch 4: 8
    concurrent PNG requests at the served size, then 2 of another size
    (resized with the area rule), a bad body (400), an unknown model (404),
    ``format=jpg`` (501 without a JPEG codec). Each npz answer must equal
    its frame's row of ``batch_call`` on the same padded bucket, or the
    single-frame call, bit for bit."""
    import io
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np

    from monocular_depth_estimation_trt_tpu_torch.apps.server import DepthServer, make_handler
    from monocular_depth_estimation_trt_tpu_torch.utils import imageio

    recorder = LaunchRecorder(pipe)
    ds = DepthServer(recorder, max_batch=4, batch_window_ms=50.0)
    warm_s = ds.warmup()
    recorder.launches.clear()
    ds.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(ds))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    hw = tuple(pipe.spec.input_hw)
    frames = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(8)]
    frames += [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(2)]
    answers = {}

    def fire(i):
        answers[i] = post(f"{base}/v1/depth", imageio.encode_png(frames[i]))

    try:
        t0 = time.perf_counter()
        for group in (range(8), range(8, 10)):
            threads = [threading.Thread(target=fire, args=(i,)) for i in group]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        serve_s = time.perf_counter() - t0
        bad = post(f"{base}/v1/depth", b"not an image")
        unknown = post(f"{base}/v1/models/nope/depth", imageio.encode_png(frames[0]))
        jpg = post(f"{base}/v1/depth?format=jpg", imageio.encode_png(frames[0]))
        stats = json.load(urllib.request.urlopen(f"{base}/v1/stats", timeout=30))
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()
        ds.stop()

    has_jpeg = imageio.jpeg_available()
    rec = {"phase": "server", "model": pipe.spec.artifact_name(), "max_batch": 4,
           "warmup_seconds": warm_s, "requests_seconds": serve_s, "stats": stats,
           "launches": [(int(f.shape[0]), batched) for f, _, batched in recorder.launches],
           "bad_body": bad[0], "unknown_model": unknown[0], "jpg": jpg[0],
           "answers": {}}
    for i, frame in enumerate(frames):
        status, body = answers[i]
        check(status == 200, f"server request {i}: HTTP {status} {body[:200]!r}")
        depth = np.load(io.BytesIO(body))["depth"]
        served = imageio.resize(frame, hw, "area")
        where = [(f, j, batched) for f, _, batched in recorder.launches
                 for j in range(f.shape[0]) if np.array_equal(f[j], served)]
        check(len(where) >= 1, f"server request {i}: its frame is in no launch")
        f, j, batched = where[0]
        want = pipe.batch_call(f)["depth"][j] if batched else pipe(f[0])["depth"]
        equal = bool(np.array_equal(depth, want))
        rec["answers"][i] = {"bucket": int(f.shape[0]), "row": j, "equal": equal,
                             "size": list(frame.shape[:2])}
        check(equal, f"server request {i}: answer differs from the direct call "
                     f"(bucket {f.shape[0]}, row {j})")
    emit(rec)
    check(bad[0] == 400, f"server: a bad body answered {bad[0]}")
    check(unknown[0] == 404, f"server: an unknown model answered {unknown[0]}")
    check(jpg[0] == (200 if has_jpeg else 501), f"server: format=jpg answered {jpg[0]}")
    # the jpg request is served (and counted) only where a JPEG codec imports
    check(stats["requests"] == 10 + has_jpeg and stats["errors"] == 0, f"server stats {stats}")
    check(any(batched and f.shape[0] > 1 for f, _, batched in recorder.launches),
          "server: no request was batched")


def cli_phase(pipe, vggt, depth_pro, moge, unidepth, geocalib, rng):
    """``python -m monocular_depth_estimation_trt_tpu_torch`` in processes of
    its own, as a user starts it: ``run`` of DA-V2 vits on a seeded 480x640
    PNG with ``--pointcloud --benchmark`` (its npz depth equal to this
    process's pipeline on the same frame, bit for bit; the viz and the
    ``.ply`` written), ``views vggt`` on 4 PNGs, ``run depth_pro`` on
    weights saved from this process's (``_fov.json`` against its f_px),
    ``run moge2 --mesh --mesh-format glb`` on this process's MoGe-2 weights
    (every npz output equal to its pipeline's bit for bit, the ``.glb`` mesh
    written), ``run unidepth_v2`` (the npz's points, confidence and
    intrinsics equal to the pipeline's, ``_fov.json`` from the intrinsics)
    and ``run geocalib`` (the Roll / Pitch / vFoV / Focal lines and the npz
    of every output, equal to the pipeline's) on this process's weights."""
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch

    from monocular_depth_estimation_trt_tpu_torch.apps.ply import read_ply
    from monocular_depth_estimation_trt_tpu_torch.utils import imageio

    tmp = tempfile.mkdtemp(prefix="mdet_cli_")
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}

    def cli(*argv):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "monocular_depth_estimation_trt_tpu_torch",
                               *argv], cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=600)
        check(proc.returncode == 0, f"cli {' '.join(argv[:2])} exited {proc.returncode}: "
                                    f"{proc.stdout[-1500:]}{proc.stderr[-2500:]}")
        return proc.stdout, time.perf_counter() - t0

    def only(directory, suffix):
        found = [f for f in os.listdir(directory) if f.endswith(suffix)]
        check(len(found) == 1, f"cli: want one *{suffix} in {sorted(os.listdir(directory))}")
        return os.path.join(directory, found[0])

    try:
        frame = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
        png = os.path.join(tmp, "frame.png")
        imageio.write_image(png, frame)
        check(np.array_equal(imageio.read_image(png), frame), "cli: the PNG round trip")
        out_run = os.path.join(tmp, "run")
        stdout, run_s = cli("run", "depth_anything_v2", "--encoder", "vits", "--image", png,
                            "--out", out_run, "--pointcloud", "--allow-random-weights",
                            "--benchmark")
        depth = np.load(only(out_run, ".npz"))["depth"]
        in_process = pipe(frame, viz=True)["depth"]
        viz = [f for f in os.listdir(out_run) if f.endswith((".jpg", ".png"))]
        pts, cols = read_ply(only(out_run, ".ply"))
        fps = [ln for ln in stdout.splitlines() if "Average FPS" in ln]
        rec = {"phase": "cli", "command": "run depth_anything_v2 --encoder vits --pointcloud "
                                          "--benchmark", "seconds": run_s,
               "files": sorted(os.listdir(out_run)),
               "depth_equal_in_process": bool(np.array_equal(depth, in_process)),
               "ply_points": int(pts.shape[0]), "benchmark_line": fps[-1] if fps else None}
        emit(rec)
        check(rec["depth_equal_in_process"], "cli run: npz depth differs from the pipeline's")
        check(len(viz) == 1 and pts.shape == (480 * 640, 3) and cols is not None,
              f"cli run: viz {viz}, ply {pts.shape}")
        check(bool(fps), "cli run --benchmark printed no FPS line")

        views = rng.integers(0, 256, (4, 518, 518, 3), dtype=np.uint8)
        pngs = []
        for i, v in enumerate(views):
            pngs.append(os.path.join(tmp, f"view{i}.png"))
            imageio.write_image(pngs[-1], v)
        out_views = os.path.join(tmp, "views")
        _, views_s = cli("views", "vggt", "--images", *pngs, "--out", out_views,
                         "--allow-random-weights")
        got = np.load(only(out_views, "_s4.npz"))
        want = vggt.multi_view(views)
        vpts, _ = read_ply(only(out_views, "_s4.ply"))
        rec = {"phase": "cli", "command": "views vggt (4 views)", "seconds": views_s,
               "files": sorted(os.listdir(out_views)),
               "shapes": {k: list(got[k].shape) for k in got.files},
               "depth_equal_in_process": bool(np.array_equal(got["depth"], want["depth"])),
               "ply_points": int(vpts.shape[0])}
        emit(rec)
        check(got["depth"].shape == (4, 518, 518) and got["pose_enc"].shape == (4, 9)
              and all(bool(np.isfinite(got[k]).all()) for k in got.files),
              f"cli views: {rec['shapes']}")
        check(vpts.shape[0] > 0, "cli views: an empty point cloud")

        ckpt = os.path.join(tmp, "depth_pro_lifted.pth")
        torch.save({k: v.detach().cpu() for k, v in depth_pro.model.state_dict().items()}, ckpt)
        out_dp = os.path.join(tmp, "depth_pro")
        _, dp_s = cli("run", "depth_pro", "--image", png, "--out", out_dp, "--checkpoint", ckpt)
        fov = json.load(open(only(out_dp, "_fov.json")))
        ours = depth_pro(frame)
        f_px = float(ours["f_px"])
        want_fov = {"fov_x": round(math.degrees(2 * math.atan(0.5 * 640 / f_px)), 2),
                    "fov_y": round(math.degrees(2 * math.atan(0.5 * 480 / f_px)), 2)}
        dp_depth = np.load(only(out_dp, ".npz"))["depth"]
        rec = {"phase": "cli", "command": "run depth_pro (this process's weights)",
               "seconds": dp_s, "files": sorted(os.listdir(out_dp)), "fov_json": fov,
               "in_process_f_px": f_px, "in_process_fov": want_fov,
               "depth_equal_in_process": bool(np.array_equal(dp_depth, ours["depth"]))}
        emit(rec)
        check(f_px > 0 and fov == want_fov, f"cli depth_pro: fov {fov}, want {want_fov}")
        check(dp_depth.shape == (480, 640) and bool(np.isfinite(dp_depth).all()),
              "cli depth_pro: depth")

        ckpt = os.path.join(tmp, "moge2_lifted.pth")
        torch.save({k: v.detach().cpu() for k, v in moge.model.state_dict().items()}, ckpt)
        out_moge = os.path.join(tmp, "moge2")
        _, moge_s = cli("run", "moge2", "--image", png, "--out", out_moge, "--checkpoint", ckpt,
                        "--mesh", "--mesh-format", "glb")
        got = np.load(only(out_moge, ".npz"))
        ours = moge(frame)
        with open(only(out_moge, ".glb"), "rb") as f:
            magic = f.read(4)
        rec = {"phase": "cli", "command": "run moge2 --mesh --mesh-format glb (this process's "
                                          "weights)", "seconds": moge_s,
               "files": sorted(os.listdir(out_moge)),
               "shapes": {k: list(got[k].shape) for k in got.files},
               "equal_in_process": {k: bool(np.array_equal(got[k], ours[k]))
                                    for k in got.files},
               "glb_bytes": os.path.getsize(only(out_moge, ".glb"))}
        emit(rec)
        check(sorted(got.files) == sorted(ours) == ["depth", "focal", "mask", "metric_scale",
                                                    "normal", "points"],
              f"cli moge2: npz {got.files}, pipeline {sorted(ours)}")
        check(all(rec["equal_in_process"].values()), "cli moge2: npz differs from the pipeline's")
        check(magic == b"glTF", f"cli moge2: the mesh starts {magic!r}")

        for name, p in (("unidepth_v2", unidepth), ("geocalib", geocalib)):
            ckpt = os.path.join(tmp, f"{name}.pth")
            torch.save({k: v.detach().cpu() for k, v in p.model.state_dict().items()}, ckpt)
            out_dir = os.path.join(tmp, name)
            stdout, seconds = cli("run", name, "--image", png, "--out", out_dir,
                                  "--checkpoint", ckpt)
            got = np.load(only(out_dir, ".npz"))
            ours = {k: v for k, v in p(frame).items() if k != "viz"}
            rec = {"phase": "cli", "command": f"run {name} (this process's weights)",
                   "seconds": seconds, "files": sorted(os.listdir(out_dir)),
                   "shapes": {k: list(got[k].shape) for k in got.files},
                   "equal_in_process": {k: bool(np.array_equal(got[k], ours[k], equal_nan=True))
                                        for k in got.files}}
            if name == "unidepth_v2":
                K = ours["intrinsics"]
                want_fov = {"fov_x": round(math.degrees(2 * math.atan(0.5 * 640 / K[0, 0])), 2),
                            "fov_y": round(math.degrees(2 * math.atan(0.5 * 480 / K[1, 1])), 2)}
                rec["fov_json"] = json.load(open(only(out_dir, "_fov.json")))
                rec["in_process_fov"] = want_fov
            else:
                rec["lines"] = [ln for ln in stdout.splitlines()
                                if ln.startswith(("[MDET] Roll", "[MDET] Pitch", "[MDET] vFoV",
                                                  "[MDET] Focal"))]
            emit(rec)
            check(sorted(got.files) == sorted(ours), f"cli {name}: npz {got.files}, pipeline "
                                                     f"{sorted(ours)}")
            check(all(rec["equal_in_process"].values()),
                  f"cli {name}: npz differs from the pipeline's")
            if name == "unidepth_v2":
                check(rec["fov_json"] == rec["in_process_fov"],
                      f"cli unidepth_v2: fov {rec['fov_json']}, want {rec['in_process_fov']}")
            else:
                check(len(rec["lines"]) == 4, f"cli geocalib: calibration lines {rec['lines']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def parse_smi(line: str):
    name, _, limit = line.partition(",")
    return name.strip(), limit.strip()


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, REPO)
    from monocular_depth_estimation_trt_tpu_torch.ops.cuda import _build
    from monocular_depth_estimation_trt_tpu_torch.ops.cuda import flash_attention as fa
    from monocular_depth_estimation_trt_tpu_torch.ops.cuda import quant_matmul as qm
    from monocular_depth_estimation_trt_tpu_torch.registry import build_pipeline
    from monocular_depth_estimation_trt_tpu_torch.config import BenchmarkConfig
    from monocular_depth_estimation_trt_tpu_torch.weights.store import (
        set_allow_random_weights,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    wrappers = wrappers_of(fa, qm)

    # 1. device
    smi = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0]
    card, power_limit = parse_smi(smi)
    nvcc_version = run_cmd([_build._nvcc(), "--version"]).splitlines()[-1]
    kind = torch.cuda.get_device_name(0)
    from monocular_depth_estimation_trt_tpu_torch.utils.imageio import jpeg_available

    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc_version,
          "python": sys.version.split()[0], "cv2_importable": jpeg_available()})

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info()
    ptxas = [ln.strip() for ln in info.log.splitlines()
             if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": info.built, "library": os.path.relpath(info.path, REPO),
          "ptxas": ptxas})
    # every bf16 kernel runs on wgmma and TMA (K2 and K3 in two head widths);
    # the fp32 kernels (fp32 FMAs, and K4's fp32 wmma loop) on neither
    sass = sass_counts(info.path)
    if sass is None:
        emit({"phase": "sass", "counts": "not measured (no cuobjdump in the toolkit)"})
    else:
        emit({"phase": "sass", "counts": sass})
        for entry, (count, mma) in SM90_KERNELS.items():
            found = [c for f, c in sass.items() if entry in f]
            check(len(found) == count and all(c[mma] > 0 and c["UTMALDG"] > 0 for c in found),
                  f"{entry}: want {count} instantiations with {mma} and UTMALDG, SASS {found}")
        fp32 = {f: c for f, c in sass.items() if "_sm90" not in f}
        check(fp32 and all(c["HGMMA"] + c["IGMMA"] + c["UTMALDG"] == 0 for c in fp32.values()),
              f"fp32 kernels' SASS {fp32}")

    # 3. kernel checks (their launches are not the main paths')
    k1 = check_flash_attention_packed(fa, dev)
    k2 = check_flash_attention(fa, dev)
    k3 = check_flash_attention_batched(fa, dev)
    k4 = check_w8a8_matmul(qm, dev)

    # 4. main path: every count set to 0 just before, read just after
    set_allow_random_weights(True)
    rng = np.random.default_rng(0)
    frame_a = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    frame_b = rng.integers(0, 256, (518, 518, 3), dtype=np.uint8)
    frame_c = rng.integers(0, 256, (518, 518, 3), dtype=np.uint8)
    pipe = build_pipeline("depth_anything_v2", encoder="vits")
    metric = build_pipeline("depth_anything_v2", encoder="vits", metric=True)
    check(pipe.device.type == "cuda", f"default device is {pipe.device}")

    set_counts_to_zero(wrappers)
    per_frame = []
    outs = {}
    for key, frame in (("a", frame_a), ("b", frame_b)):
        outs[key], per = run_counted(lambda: pipe(frame, viz=True),
                                     lambda: pipe.engine_for(frame.shape[:2], True), wrappers,
                                     f"vits frame {key}")
        per_frame.append(per[1])
    batch, per = run_counted(lambda: pipe.batch_call(np.stack([frame_b, frame_c]), viz=True),
                             lambda: pipe.batch_engine_for((518, 518), 2, True), wrappers,
                             "vits batch of 2")
    batch_launches = per[1]
    out_metric, _ = run_counted(lambda: metric(frame_a, viz=True),
                                lambda: metric.engine_for((480, 640), True), wrappers,
                                "vits metric")
    replayed = pipe(frame_a, viz=True)  # a replay: no wrapper call
    torch.cuda.synchronize()
    launches = launch_record(wrappers)

    check(per_frame == [12, 12], f"K1 launches per vits frame {per_frame}, want 12")
    check(batch_launches == 12, f"K1 launches for a batch of 2: {batch_launches}")
    check(launches == {"flash_attention_batched": 0,
                       "flash_attention_packed": 4 * 12 * (WARMUP_CALLS + 1),
                       "flash_attention": 0, "w8a8_matmul": 0},
          f"launches on the main path {launches}")
    check(np.array_equal(replayed["depth"], outs["a"]["depth"]), "vits replay differs")
    for key, frame in (("a", frame_a), ("b", frame_b)):
        d, viz = outs[key]["depth"], outs[key]["viz"]
        check(d.shape == frame.shape[:2] and d.dtype == np.float32,
              f"depth {d.shape} {d.dtype}")
        check(bool(np.isfinite(d).all()), "depth not finite")
        check(d.min() >= 1e-3 and d.max() <= 1e3, f"depth outside clamp {d.min()} {d.max()}")
        check(d.max() > d.min(), "depth is constant")
        check(viz.shape == frame.shape and viz.dtype == np.uint8, f"viz {viz.shape}")
    check(batch["depth"].shape == (2, 518, 518) and batch["viz"].shape == (2, 518, 518, 3),
          "batch shapes")
    batch_rel = float(np.abs(batch["depth"][0] - outs["b"]["depth"]).max()
                      / np.abs(outs["b"]["depth"]).max())
    check(batch_rel < PATH_BF16_REL_TOL, f"batch frame 0 vs single frame rel {batch_rel}")
    # per-frame viz normalization: each frame spans the full colormap range
    for i in range(2):
        lo = batch["viz"][i].reshape(-1, 3)
        check(len(np.unique(lo, axis=0)) > 16, f"batch viz {i} collapsed")
    dm = out_metric["depth"]
    check(bool(np.isfinite(dm).all()) and dm.min() >= 1e-3 and dm.max() <= 20.0,
          f"metric depth range {dm.min()} {dm.max()}")
    emit({"phase": "main_path", "model": pipe.spec.artifact_name(),
          "frames": ["480x640", "518x518"], "launches_per_frame": per_frame,
          "batch2_launches": batch_launches, "launches": launches,
          "counted": f"{WARMUP_CALLS} warm-up + 1 captured per engine, 4 engines",
          "depth_range_480x640": [float(outs["a"]["depth"].min()),
                                  float(outs["a"]["depth"].max())],
          "metric_depth_range": [float(dm.min()), float(dm.max())],
          "batch_vs_single_rel": batch_rel})

    # whole-path comparisons (outside the counted run)
    plain = build_pipeline("depth_anything_v2", encoder="vits", attn_impl="xla")
    ref = plain(frame_b)["depth"]
    rel_bf16 = rel(outs["b"]["depth"], ref)
    check(rel_bf16 < PATH_BF16_REL_TOL,
          f"bf16 depth kernel vs plain attention rel {rel_bf16} >= {PATH_BF16_REL_TOL}")
    card32 = build_pipeline("depth_anything_v2", encoder="vits", precision="fp32")
    cpu32 = build_pipeline("depth_anything_v2", encoder="vits", precision="fp32",
                           device="cpu")
    d_card, d_cpu = card32(frame_b)["depth"], cpu32(frame_b)["depth"]
    rel_fp32 = rel(d_card, d_cpu)
    check(rel_fp32 < PATH_FP32_REL_TOL,
          f"fp32 depth card vs cpu rel {rel_fp32} >= {PATH_FP32_REL_TOL}")
    # both bf16 routes against the fp32 path on the same weights
    kernel_vs_fp32, plain_vs_fp32 = rel(outs["b"]["depth"], d_card), rel(ref, d_card)
    check(kernel_vs_fp32 < PATH_BF16_REL_TOL,
          f"bf16 kernel route vs fp32 rel {kernel_vs_fp32} >= {PATH_BF16_REL_TOL}")
    emit({"phase": "whole_path_parity",
          "bf16_kernel_vs_plain_attention_rel": rel_bf16,
          "bf16_kernel_route_vs_fp32_rel": kernel_vs_fp32,
          "bf16_plain_route_vs_fp32_rel": plain_vs_fp32,
          "bf16_kernel_route_vs_fp32_mean_rel": mean_rel(outs["b"]["depth"], d_card),
          "bf16_plain_route_vs_fp32_mean_rel": mean_rel(ref, d_card),
          "bf16_tolerance": PATH_BF16_REL_TOL,
          "fp32_card_vs_cpu_rel": rel_fp32, "fp32_tolerance": PATH_FP32_REL_TOL})
    drop_engines(pipe, plain, card32, cpu32, metric)
    del plain, card32, cpu32, metric

    # 5. the VGGT path (its own counted run), then its route comparisons
    vggt, vggt_launches = run_vggt_path(build_pipeline, wrappers, rng)
    vggt_parity(build_pipeline, vggt, parity_frames(rng))
    drop_engines(vggt)

    # 6. the Depth Pro path (its own counted run), then its route comparisons
    depth_pro, depth_pro_launches, depth_pro_frames = run_depth_pro_path(build_pipeline, wrappers,
                                                                         rng)
    depth_pro_parity(build_pipeline, depth_pro, depth_pro_frames)
    drop_engines(depth_pro)

    # 7. the single-image metric and point-map families, then the last
    # single-image families (each its own counted run), then their route
    # comparisons. The last families draw their frames from a generator of
    # their own, so that every earlier phase reads the frames it read before
    families, family_launches, family_frames = {}, {}, {}
    for group, frame_rng in ((METRIC, rng), (SINGLE, np.random.default_rng(9))):
        for name in (n for n, fam in FAMILIES.items() if fam["group"] == group):
            families[name], family_launches[name], family_frames[name] = run_family_path(
                name, build_pipeline, wrappers, frame_rng)
            family_parity(name, build_pipeline, families[name], family_frames[name])
            drop_engines(families[name])
    check_geocalib_fit(dev)

    # 8. the int8 paths (each its own counted run), then int8 against the bf16
    # and fp32 routes; calibration on three seeded frames (noise and a
    # smooth scene-like frame)
    calib = list(parity_frames(np.random.default_rng(7)).values())
    int8_frames = {
        "depth_anything_v2": {"frame_480x640": rng.integers(0, 256, (480, 640, 3), dtype=np.uint8),
                              "frame_518x518": rng.integers(0, 256, (518, 518, 3), dtype=np.uint8)},
        "depth_pro": depth_pro_frames,
        "vggt": {"frame_480x640": rng.integers(0, 256, (480, 640, 3), dtype=np.uint8),
                 "frame_518x518": rng.integers(0, 256, (518, 518, 3), dtype=np.uint8)},
        "metric3d_v2": family_frames["metric3d_v2"],
        "unidepth_v2": family_frames["unidepth_v2"],
    }
    views4_u8 = rng.integers(0, 256, (4, 518, 518, 3), dtype=np.uint8)
    int8_pipes, int8_launches = {}, {}
    for name, frames in int8_frames.items():
        fam = int8_family(name, build_pipeline, calib)
        int8_pipes[name], int8_launches[name] = run_int8_path(
            name, fam, wrappers, frames, views4_u8 if name == "vggt" else None)
        int8_parity(name, fam, int8_pipes[name], frames)
        drop_engines(int8_pipes[name])
    # UniK3D's int8 build, the same pixel encoder as UniDepth V2's: its
    # counted run only
    unik3d8, int8_launches["unik3d"] = run_int8_path(
        "unik3d", int8_family("unik3d", build_pipeline, calib), wrappers,
        family_frames["unik3d"])
    drop_engines(unik3d8)
    del unik3d8

    # 9. engines: each captured graph against the eager forward it captures
    vitl = build_pipeline("depth_anything_v2", encoder="vitl")
    frame_dp = depth_pro_frames["frame_1536x1536"]
    other_dp = rng.integers(0, 256, (1536, 1536, 3), dtype=np.uint8)
    views4_other = rng.integers(0, 256, (4, 518, 518, 3), dtype=np.uint8)
    int8_vitl = int8_pipes["depth_anything_v2"]
    for label, p, engine, eager, arg, other, want in (
            ("vits", pipe, pipe.engine_for((518, 518)), p_eager(pipe, (518, 518)), frame_b,
             frame_c, [0, 12, 0, 0]),
            ("vitl", vitl, vitl.engine_for((518, 518)), p_eager(vitl, (518, 518)), frame_b,
             frame_c, [0, 24, 0, 0]),
            ("vitl_int8", int8_vitl, int8_vitl.engine_for((518, 518)),
             p_eager(int8_vitl, (518, 518)), frame_b, frame_c, [0, 24, 0, 96]),
            ("vggt_s1", vggt, vggt.engine_for((518, 518)), p_eager(vggt, (518, 518)), frame_b,
             frame_c, [0, 24, 48, 0]),
            ("vggt_s4", vggt, vggt.views_engine(4), vggt._views_forward, views4_u8,
             views4_other, [0, 24, 48, 0]),
            ("depth_pro_1536", depth_pro, depth_pro.engine_for((1536, 1536)),
             p_eager(depth_pro, (1536, 1536)), frame_dp, other_dp, [24, 24, 0, 0]),
            ("unidepth_v2_int8", int8_pipes["unidepth_v2"],
             int8_pipes["unidepth_v2"].engine_for((518, 518)),
             p_eager(int8_pipes["unidepth_v2"], (518, 518)), frame_b, frame_c, [0, 12, 0, 48])):
        check_engine(label, p, engine, eager, arg, other, want, wrappers)
        drop_engines(p)
    for name, fam in FAMILIES.items():
        p, hw = families[name], fam["hw"][1]
        arg, other = (rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(2))
        check_engine(name, p, p.engine_for(hw), p_eager(p, hw), arg, other,
                     fam["per_forward"], wrappers)
        drop_engines(p)

    # 10. the command line, as a user starts it, in processes of its own
    cli_phase(pipe, vggt, depth_pro, families["moge2"], families["unidepth_v2"],
              families["geocalib"], rng)
    drop_engines(pipe, vggt, depth_pro, families["moge2"], families["unidepth_v2"],
                 families["geocalib"])

    # 11. the HTTP server in this process, batching up to 4
    server_phase(pipe, rng)
    drop_engines(pipe)

    # 12. speed (the counts are read above; benchmark launches are not
    # counted): each path eager and through its engine, in turns eager,
    # graph, graph, eager
    cfg = BenchmarkConfig(warmup=10, iterations=100, latency_iterations=50)
    vcfg = BenchmarkConfig(**VGGT_BENCH)
    dcfg = BenchmarkConfig(**DEPTH_PRO_BENCH)
    fcfg = BenchmarkConfig(**FAMILY_BENCH)
    for label, p, in_hw, views, c in (
            ("vits", pipe, (518, 518), 0, cfg), ("vitl", vitl, (518, 518), 0, cfg),
            ("vitl_int8", int8_vitl, (518, 518), 0, cfg),
            ("vggt_s1", vggt, (518, 518), 0, vcfg), ("vggt_s4", vggt, None, 4, vcfg),
            ("depth_pro_1536", depth_pro, (1536, 1536), 0, dcfg),
            *((name, families[name], tuple(families[name].spec.input_hw), 0, fcfg)
              for name in FAMILIES)):
        for turn, route in enumerate(ROUTE_TURNS):
            rep = timed_route(p, route, in_hw, views, c)
            emit(speed_record(rep, p, label, route, turn, views, in_hw, card, power_limit))
        drop_engines(p)
    # the other int8 paths through their engines; vits int8 (forced past the
    # small-encoder guard) against vits bf16 in alternating turns: the
    # evidence for the guard's default
    for label, p, in_hw, views, c in (("depth_pro_1536_int8", int8_pipes["depth_pro"],
                                        (1536, 1536), 0, dcfg),
                                       ("vggt_s1_int8", int8_pipes["vggt"], (518, 518), 0, vcfg),
                                       ("vggt_s4_int8", int8_pipes["vggt"], None, 4, vcfg),
                                       ("metric3d_v2_int8", int8_pipes["metric3d_v2"],
                                        (616, 1064), 0, fcfg),
                                       ("unidepth_v2_int8", int8_pipes["unidepth_v2"],
                                        (518, 518), 0, fcfg)):
        for repeat in range(2):
            rep = timed_route(p, "graph", in_hw, views, c)
            emit(speed_record(rep, p, label, "graph", repeat, views, in_hw, card, power_limit))
        drop_engines(p)
    os.environ["MDET_FORCE_INT8"] = "1"
    vits8 = build_pipeline("depth_anything_v2", encoder="vits", precision="int8",
                           calib_images=calib)
    del os.environ["MDET_FORCE_INT8"]
    check(vits8.spec.precision == "int8", f"forced vits int8 built {vits8.spec.precision}")
    for turn, p in enumerate((pipe, vits8, vits8, pipe)):
        emit({**speed_record(p.benchmark((518, 518), cfg), p, "vits_ab", "graph", turn, 0,
                             (518, 518), card, power_limit), "ab_turn": turn})

    # 13. where the device time goes, after the speed phase so that the
    # profiler cannot slow it (launches not counted): graph replays, and the
    # eager forward of some paths beside them; in the UniDepth pair's, the
    # device time of its decoder's attention (plain matmuls, fp32 softmax)
    from monocular_depth_estimation_trt_tpu_torch.models import geometric

    dev_frame = torch.from_numpy(frame_b).to(dev)
    views4 = torch.from_numpy(views4_u8).to(dev)
    dev_dp = torch.from_numpy(frame_dp).to(dev)
    family_args = {name: torch.from_numpy(rng.integers(
        0, 256, (*p.spec.input_hw, 3), dtype=np.uint8)).to(dev) for name, p in families.items()}
    for p, arg, in_hw, suffix, iters, with_eager in (
            (pipe, dev_frame, (518, 518), "", 5, True),
            (vitl, dev_frame, (518, 518), "", 5, False),
            (int8_vitl, dev_frame, (518, 518), "", 5, False),
            (vits8, dev_frame, (518, 518), "", 5, False),
            (vggt, dev_frame, (518, 518), "_s1", 3, False),
            (vggt, views4, None, "_s4", 3, True),
            (int8_pipes["vggt"], dev_frame, (518, 518), "_s1", 3, False),
            (int8_pipes["vggt"], views4, None, "_s4", 3, False),
            (depth_pro, dev_dp, (1536, 1536), "", 3, True),
            (int8_pipes["depth_pro"], dev_dp, (1536, 1536), "", 3, False),
            *((families[name], family_args[name], tuple(families[name].spec.input_hw), "", 5,
               name in ("metric3d_v2", "moge2", "geocalib", *GEOMETRIC)) for name in FAMILIES),
            (int8_pipes["metric3d_v2"], family_args["metric3d_v2"], (616, 1064), "", 5,
             False),
            (int8_pipes["unidepth_v2"], family_args["unidepth_v2"], (518, 518), "", 5,
             False)):
        eng = p.engine_for(in_hw) if in_hw else p.views_engine(4)
        emit({**profile_breakdown(lambda: eng(arg), p.spec.artifact_name() + suffix, iters),
              "route": "graph"})
        if with_eager:
            eager = p_eager(p, in_hw) if in_hw else p._views_forward
            ranges = ("decoder_attention",) if p.spec.model in GEOMETRIC else ()

            def eager_step():
                with torch.inference_mode():
                    eager(arg)

            with annotated(geometric, "decoder_attention"):
                emit({**profile_breakdown(eager_step, p.spec.artifact_name() + suffix, iters,
                                          ranges=ranges), "route": "eager"})
        drop_engines(p)

    # kernels line: the main shape's numbers, every shape in "shapes"; the
    # launches of each path's counted run
    def kernel_entry(name, source, replaces, function, records, main_shape,
                     library_call="torch.nn.functional.scaled_dot_product_attention",
                     head_dim_128=None):
        keys = ("shape", "B", "H", "N", "d", "dtype", "max_abs_err", "err_bf16_steps",
                "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "host_us_per_call")
        main = next(r for r in records if r["shape"] == main_shape)
        extra = {}
        if "matmul_ms" in main:
            extra.update(matmul_ms=main["matmul_ms"],
                         matmul_call="torch.matmul of bf16 x and the weight cast to bf16")
        if head_dim_128:  # the d = 128 instantiation, on no ported path yet
            d128 = next(r for r in records if r["shape"] == head_dim_128)
            extra["head_dim_128"] = {k: d128[k] for k in keys}
            # the wide loop (d > 128, csrc/attention_wide.cuh), on no ported path
            extra["wide_heads"] = [{k: r[k] for k in keys} for r in records
                                   if "_wide" in r["shape"]]
        by_path = {"depth_anything_v2": launches[name], "vggt": vggt_launches[name],
                   "depth_pro": depth_pro_launches[name],
                   **{k: v[name] for k, v in family_launches.items()},
                   **{f"{k}_int8": v[name] for k, v in int8_launches.items()}}
        pallas_file = replaces.partition(":")[0]
        return {
            "name": name,
            "route": "cuda",
            "source": f"monocular_depth_estimation_trt_tpu_torch/csrc/{source}",
            "replaces": f"monocular_depth_estimation_trt_tpu/ops/pallas/{replaces}",
            "replaces_function": f"ops/pallas/{pallas_file}::{function}",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in records),
            "ms": main["kernel_ms"],
            "kernel_ms": main["kernel_ms"],
            "host_us_per_call": main["host_us_per_call"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "library_call": library_call,
            "at_shape": main["shape"],
            **extra,
            "shapes": records,
        }

    kernels = [
        kernel_entry("flash_attention_packed", "flash_attention_packed.cu",
                     "flash_attention.py:272", "_attn_kernel_packed", k1, "vits_518"),
        kernel_entry("flash_attention", "flash_attention.cu", "flash_attention.py:38",
                     "_attn_kernel", k2, "global_s4", head_dim_128="d128_vit7b"),
        kernel_entry("flash_attention_batched", "flash_attention_batched.cu",
                     "flash_attention.py:68", "_attn_kernel_batched", k3, "depth_pro_patch",
                     head_dim_128="d128"),
        kernel_entry("w8a8_matmul", "w8a8_matmul.cu", "quant_matmul.py:43", "_w8a8_kernel", k4,
                     "vitl_qkv", library_call="quantize + torch._int_mm + rescale"),
    ]

    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
