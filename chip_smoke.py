#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printed as one JSON line; any failure exits non-zero:

1. device: card name and power limit, torch/CUDA versions, ``nvcc --version``;
2. build: compiles ``monocular_depth_estimation_trt_tpu_torch/csrc/*.cu``
   with nvcc into the package's ``_build/`` directory and loads it;
3. kernel checks: each kernel's wrapper against its plain PyTorch version on
   the card, at the main path's shapes and edge shapes, with timings of the
   kernel, the plain version and one library call, and the card's bound;
4. main path: ``build_pipeline("depth_anything_v2", encoder="vits")`` on the
   card with seeded random weights: two frames, a batch of two with the viz
   epilogue, the metric variant; the launch counts of every kernel are read
   over exactly this run; then the bf16 depth against the same pipeline with
   plain attention and against the fp32 path, and the fp32 pipeline on the
   card against the CPU;
5. speed: ``DepthPipeline.benchmark((518, 518))`` for vits and vitl;
6. profile: device time by kernel, device busy time and idle share of a
   vits frame, from ``torch.profiler``.

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

BF16_TOL = 2e-2  # bf16 output mantissa (the JAX package's packed-kernel bar)
FP32_TOL = 1e-4  # fp32: summation order only
# Whole-path bf16 depth, kernel route vs plain attention route, as
# max|a - b| / max|b|: both run every op in bf16 (3.9e-3 relative per
# rounding) and the plain route also rounds the scores to bf16 before the
# softmax, so the two drift apart by a few bf16 steps over 12 blocks.
PATH_BF16_REL_TOL = 5e-2
# Whole-path fp32 depth, card vs CPU: summation order only, TF32 off.
PATH_FP32_REL_TOL = 1e-3

SPEED_REPEATS = 3

PEAK_BF16_OPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_OPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def emit(record) -> None:
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


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(b: int, n: int, h: int, d: int, itemsize: int, peak_ops: float):
    ops = 4.0 * b * h * n * n * d
    nbytes = float(b * n * 4 * h * d * itemsize)  # qkv read once, out written once
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_flash_attention_packed(fa, dev):
    """K1 against its plain version at the main path's and edge shapes."""
    import torch
    import torch.nn.functional as F

    shapes = [  # (label, B, N, H, dtype)
        ("vits_518", 1, 1370, 6, torch.bfloat16),
        ("vits_518_batch2", 2, 1370, 6, torch.bfloat16),
        ("vits_518_batch4", 4, 1370, 6, torch.bfloat16),
        ("vitl_518", 1, 1370, 16, torch.bfloat16),
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
        out = fa.flash_attention_packed(qkv, h)
        torch.cuda.synchronize()
        ref = fa.flash_attention_packed_reference(qkv, h)
        err = (out.float() - ref.float()).abs().max().item()
        tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
        check(out.shape == (b, n, h * d), f"K1 {label}: shape {tuple(out.shape)}")
        check(err <= tol, f"K1 {label}: max_abs_err {err} > {tol}")
        q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
        # both bf16 routes against fp32 attention of the same inputs
        exact = fa.flash_attention_packed_reference(qkv.float(), h)
        plain_route = fa.attention_reference(q, k, v).transpose(1, 2).reshape(b, n, h * d)
        peak = PEAK_BF16_OPS if dtype == torch.bfloat16 else PEAK_FP32_OPS
        bound_ms, bound_by = attention_bound(b, n, h, d, qkv.element_size(), peak)
        rec = {
            "shape": label, "B": b, "N": n, "H": h, "d": d,
            "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err, "tolerance": tol,
            "kernel_vs_fp32_err": (out.float() - exact).abs().max().item(),
            "plain_attention_vs_fp32_err": (plain_route.float() - exact).abs().max().item(),
            "kernel_ms": time_ms(lambda: fa.flash_attention_packed(qkv, h)),
            "plain_ms": time_ms(lambda: fa.flash_attention_packed_reference(qkv, h),
                                iters=10, warmup=2),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        emit({"phase": "kernel_check", "kernel": "flash_attention_packed", **rec})
        records.append(rec)
    return records


def profile_breakdown(pipe, frame, frames: int = 5, top: int = 12):
    """Device time by kernel over ``frames`` forwards of a device-resident
    frame, from ``torch.profiler``'s CUDA events; the busy time is the union
    of the kernels' intervals, the wall time the host clock around the
    loop (which the profiler itself slows)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = pipe.engine_for(frame.shape[:2])
    dev = torch.from_numpy(frame).to(pipe.device)
    eng(dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            eng(dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    rec = {"phase": "profile", "model": pipe.spec.artifact_name(), "frames": frames,
           "wall_ms_per_frame": wall_ms}
    if not spans:
        return {**rec, "device_time": "not measured (no CUDA events in the trace)"}
    busy_us, end = 0.0, float("-inf")
    by_name = {}
    for s, e, name in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + (e - s), cnt + 1)
    busy_ms = busy_us / 1e3 / frames
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    k1 = [v for k, v in by_name.items() if "attn_packed_kernel" in k]
    return {**rec,
            "device_busy_ms_per_frame": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "device_ops_per_frame": len(spans) / frames,
            "k1_ms_per_frame": sum(v[0] for v in k1) / 1e3 / frames,
            "top": [{"name": k[:90], "ms_per_frame": v[0] / 1e3 / frames,
                     "per_frame": v[1] / frames} for k, v in ranked[:top]]}


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
    from monocular_depth_estimation_trt_tpu_torch.registry import build_pipeline
    from monocular_depth_estimation_trt_tpu_torch.config import BenchmarkConfig
    from monocular_depth_estimation_trt_tpu_torch.weights.store import (
        set_allow_random_weights,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. device
    smi = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0]
    card, power_limit = parse_smi(smi)
    nvcc_version = run_cmd([_build._nvcc(), "--version"]).splitlines()[-1]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc_version,
          "python": sys.version.split()[0]})

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info()
    ptxas = [ln.strip() for ln in info.log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": info.built, "library": os.path.relpath(info.path, REPO),
          "ptxas": ptxas})

    # 3. kernel checks (their launches are not the main path's)
    k1 = check_flash_attention_packed(fa, dev)

    # 4. main path: every count set to 0 just before, read just after
    set_allow_random_weights(True)
    rng = np.random.default_rng(0)
    frame_a = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    frame_b = rng.integers(0, 256, (518, 518, 3), dtype=np.uint8)
    frame_c = rng.integers(0, 256, (518, 518, 3), dtype=np.uint8)
    pipe = build_pipeline("depth_anything_v2", encoder="vits")
    metric = build_pipeline("depth_anything_v2", encoder="vits", metric=True)
    check(pipe.device.type == "cuda", f"default device is {pipe.device}")

    fa.flash_attention_packed.launches = 0
    per_frame = []
    outs = {}
    for key, frame in (("a", frame_a), ("b", frame_b)):
        before = fa.flash_attention_packed.launches
        outs[key] = pipe(frame, viz=True)
        per_frame.append(fa.flash_attention_packed.launches - before)
    before = fa.flash_attention_packed.launches
    batch = pipe.batch_call(np.stack([frame_b, frame_c]), viz=True)
    batch_launches = fa.flash_attention_packed.launches - before
    out_metric = metric(frame_a, viz=True)
    torch.cuda.synchronize()
    launches = {"flash_attention_packed": fa.flash_attention_packed.launches}

    check(per_frame == [12, 12], f"K1 launches per vits frame {per_frame}, want 12")
    check(batch_launches == 12, f"K1 launches for a batch of 2: {batch_launches}")
    check(launches["flash_attention_packed"] == 48,
          f"K1 launches on the main path {launches}")
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
          "depth_range_480x640": [float(outs["a"]["depth"].min()),
                                  float(outs["a"]["depth"].max())],
          "metric_depth_range": [float(dm.min()), float(dm.max())],
          "batch_vs_single_rel": batch_rel})

    # whole-path comparisons (outside the counted run)
    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    def mean_rel(a, b):
        return float(np.abs(a - b).mean() / np.abs(b).mean())

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
    del plain, card32, cpu32, metric

    # kernels line: the main-path shape's numbers, every shape in "shapes"
    main = k1[0]
    kernels = [{
        "name": "flash_attention_packed",
        "route": "cuda",
        "source": "monocular_depth_estimation_trt_tpu_torch/csrc/flash_attention_packed.cu",
        "replaces": "monocular_depth_estimation_trt_tpu/ops/pallas/flash_attention.py:272",
        "replaces_function": "ops/pallas/flash_attention.py::_attn_kernel_packed",
        "launches": launches["flash_attention_packed"],
        "max_abs_err": max(r["max_abs_err"] for r in k1),
        "ms": main["kernel_ms"],
        "kernel_ms": main["kernel_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library_call": "torch.nn.functional.scaled_dot_product_attention",
        "at_shape": main["shape"],
        "shapes": k1,
    }]

    # 5. speed (the counts are read above; benchmark launches are not counted)
    cfg = BenchmarkConfig(warmup=10, iterations=100, latency_iterations=50)
    for encoder in ("vits", "vitl"):
        p = pipe if encoder == "vits" else build_pipeline(
            "depth_anything_v2", encoder=encoder)
        if encoder == "vitl":
            before = fa.flash_attention_packed.launches
            out = p(frame_b)["depth"]
            got = fa.flash_attention_packed.launches - before
            check(got == 24, f"K1 launches per vitl frame {got}, want 24")
            check(bool(np.isfinite(out).all()), "vitl depth not finite")
        for repeat in range(SPEED_REPEATS):  # the spread within one call
            rep = p.benchmark((518, 518), cfg)
            emit({"phase": "speed", "model": p.spec.artifact_name(), "repeat": repeat,
                  "fps": rep.fps, "mean_ms": rep.avg_ms,
                  "p50_ms": rep.percentile_ms(50), "p99_ms": rep.percentile_ms(99),
                  "iterations": rep.iterations,
                  "includes": "H2D uint8 + forward + D2H depth",
                  "card": card, "power_limit": power_limit})
        del p

    # 6. where the time of a vits frame goes on the card, after the speed
    # phase so that the profiler cannot slow it (launches not counted)
    emit(profile_breakdown(pipe, frame_b))

    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
