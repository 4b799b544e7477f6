#!/usr/bin/env python3
"""A/B of the PyTorch port's kernels between checkouts, on one card.

    python3 scripts/torch_kernel_ab.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout of this repository. For each one in
the order given, a fresh process puts that root first on ``sys.path``,
builds its kernels from its own ``csrc/`` and times, on random inputs from
a fixed seed:

- bf16: K1 (packed-qkv attention) at the DA-V2, VGGT and Depth Pro shapes,
  beside ``scaled_dot_product_attention`` at ViT-S and ViT-L
  (``*_sdpa_ms``); K2 ((B, H, N, d) attention) at VGGT's frame and global
  shapes and K3 (many short heads) at Depth Pro's patch shape, and both at
  head_dim 128 where the checkout takes it; K2 and K3 at head widths above
  128 (192, 256, 320: three shapes each, from a generator of their own)
  beside ``scaled_dot_product_attention`` on the same q, k, v; K4 (the w8a8
  matmul) at the int8 paths' seven layer shapes, beside the bf16 ``torch.matmul`` of the
  same (M, K, N) (``*_matmul_ms``, the yardstick int8 serving has to beat);
- fp32 (``precision="fp32"``, TF32 off): K1 at ViT-S and ViT-L, K2 at
  VGGT's frame (S=1) and global (S=4) shapes and at DINOv3 vit7b16's
  head_dim-128 shapes, each beside fp32 ``scaled_dot_product_attention``
  on the same q, k, v (``*_sdpa_ms``); K3 at Depth Pro's patch shape, at
  N = 1024 and at head_dim 128, each beside fp32 SDPA, and K4 at ViT-L's
  qkv and fc2 and Depth Pro's fc1 and fc2, each beside the fp32 library
  chain (quantize, ``torch._int_mm``, rescale: ``*_chain_ms``); K2 and K3
  at the six wide shapes above (``*_wide_fp32``, from a
  generator of their own) beside fp32 SDPA; and
  the fp32 route end to end through its engine
  (``DepthPipeline.benchmark``, seeded random weights): DA-V2 vitl at 518²
  (``vitl_fp32_graph_*``) and Depth Pro at 1536² (``depth_pro_fp32_graph_*``;
  24 fp32 K3 and 24 fp32 K1 a forward).

Every timed call's output also gets a digest (``*_digest``: the first 16
hex digits of the SHA-256 of its bytes), and a last line names the timings
whose digest differs between the checkouts: a kernel that a change leaves
alone gives the same bits on the same inputs.

It prints one JSON line per checkout, beside the card's name and power
limit: the median of ``REPEATS`` CUDA-event timings of ``ITERS``
back-to-back launches each, in ms per launch (``*_ms``), which follows the
host where a call's host time exceeds its kernel's; the device time per
call (``*_dev_ms``: the median of ``REPEATS`` CUDA-event timings of
``ITERS`` calls queued behind a spin kernel twice as long as the host took
to issue them, so that the card runs them back to back); and each
wrapper's host time per call (``*_host_us``: the median over
``HOST_CALLS`` calls at a small shape, where the card keeps up with the
host). The three come from the port's ``runtime/kernel_timing.py`` of the
checkout that holds this script, loaded by path, so that every checkout
is timed the same way, an older one without that module too. Imports
nothing of JAX.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import os
import subprocess
import sys

REPEATS = 7
ITERS = 50
HOST_CALLS = 200
HOST_SHAPE = (1, 16, 128)  # (B, H, N): a kernel shorter than its host call
K1_SHAPES = {"vits_518": (1, 1370, 6), "vits_518_batch4": (4, 1370, 6),
             "vitl_518": (1, 1370, 16), "vggt_s4": (4, 1374, 16),
             "depth_pro_image": (1, 577, 16), "depth_pro_patch": (35, 577, 16)}  # (B, N, H)
K1_SDPA = ("vits_518", "vitl_518")
K2_SHAPES = {"frame_s4": (4, 16, 1374, 64), "global_s4": (1, 16, 5496, 64),
             "d128_vit7b": (1, 32, 1029, 128), "d128": (16, 16, 577, 128)}  # (B, H, N, d)
K3_SHAPES = {"depth_pro_patch": (35, 16, 577, 64), "n1024": (16, 16, 1024, 64),
             "d128": (16, 16, 577, 128)}
# heads wider than 128 (B, H, N, d, strided), timed WIDE_ITERS calls a timing
K2_WIDE_SHAPES = {"d192_wide": (1, 16, 1029, 192, False), "d256_wide": (1, 16, 1029, 256, False),
                  "d320_wide_strided": (2, 8, 577, 320, True)}
K3_WIDE_SHAPES = {"d192_wide": (16, 16, 577, 192, True), "d256_wide": (8, 16, 577, 256, False),
                  "d320_wide": (8, 8, 257, 320, False)}
WIDE_ITERS = 10
K4_SHAPES = {"vitl_qkv": (1370, 1024, 3072), "vitl_proj": (1370, 1024, 1024),
             "vitl_fc1": (1370, 1024, 4096), "vitl_fc2": (1370, 4096, 1024),
             "depth_pro_fc1": (20195, 1024, 4096), "depth_pro_fc2": (20195, 4096, 1024),
             "vggt_s4_fc1": (5496, 1024, 4096)}  # (M, K, N)
K4_HOST_SHAPE = (64, 256, 256)
K1_FP32_SHAPES = {"vits_518": (1, 1370, 6), "vitl_518": (1, 1370, 16)}  # (B, N, H)
# (B, H, N, d, strided: q, k, v as views of one qkv tensor, as the rope path reads them)
K2_FP32_SHAPES = {"frame_s1": (1, 16, 1374, 64, False), "global_s4": (1, 16, 5496, 64, False),
                  "d128_vit7b": (1, 32, 1029, 128, False),
                  "dinov3_vit7b16_1024": (1, 32, 4101, 128, True)}
K3_FP32_SHAPES = {"depth_pro_patch": (35, 16, 577, 64), "n1024": (2, 8, 1024, 64),
                  "d128": (16, 16, 577, 128)}  # (B, H, N, d)
K4_FP32_SHAPES = {"vitl_qkv": (1370, 1024, 3072), "vitl_fc2": (1370, 4096, 1024),
                  "depth_pro_fc1": (20195, 1024, 4096),
                  "depth_pro_fc2": (20195, 4096, 1024)}  # (M, K, N)
LONG_N = 4096  # fp32 shapes above this take LONG_ITERS calls a timing
LONG_ITERS = 5
E2E_BENCH = dict(warmup=5, iterations=30, latency_iterations=15)
DEPTH_PRO_BENCH = dict(warmup=3, iterations=10, latency_iterations=5)
TIMING = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "monocular_depth_estimation_trt_tpu_torch", "runtime", "kernel_timing.py")


def _yardstick():
    """This checkout's ``kernel_timing`` module, without importing its
    package (the package under test comes from the root being timed)."""
    spec = importlib.util.spec_from_file_location("mdet_kernel_timing", TIMING)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def k4_chain(x, wq, qmul, scale, bias):
    """K4's function through PyTorch calls: quantize, ``torch._int_mm``,
    rescale (the yardstick of ``chip_smoke.py::w8a8_library``)."""
    import torch

    xq = torch.clamp(torch.round(x.float() * qmul), -127, 127).to(torch.int8)
    return (torch._int_mm(xq, wq.t()).float() * scale + bias).to(x.dtype)


def child(root: str) -> dict:
    import torch
    import torch.nn.functional as F

    timing = _yardstick()
    sys.path.insert(0, root)
    from monocular_depth_estimation_trt_tpu_torch.ops.cuda import flash_attention as fa
    from monocular_depth_estimation_trt_tpu_torch.ops.cuda import quant_matmul as qm

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    d = fa.HEAD_DIM

    def timed(key, fn, iters=ITERS) -> None:
        out = fn().contiguous()
        torch.cuda.synchronize()
        rec[f"{key}_digest"] = hashlib.sha256(
            out.view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]
        rec[f"{key}_ms"] = timing.event_ms(fn, iters=iters, repeats=REPEATS)
        rec[f"{key}_dev_ms"] = timing.device_ms(fn, iters=iters, repeats=REPEATS)

    def host_us(fn) -> float:
        return timing.host_us(fn, calls=HOST_CALLS)

    rec = {"root": root, "package": os.path.dirname(fa.__file__)}
    for label, (b, n, h) in K1_SHAPES.items():
        qkv = torch.randn((b, n, 3 * h * d), generator=gen).to(dev, torch.bfloat16)
        timed(f"k1_{label}", lambda: fa.flash_attention_packed(qkv, h))
        if label in K1_SDPA:
            q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
            timed(f"k1_{label}_sdpa", lambda: F.scaled_dot_product_attention(q, k, v))
    # a tree with WIDE_HEAD_DIM or WIDE_STEP takes every head width; older trees name their
    # widest
    widest = (math.inf if hasattr(fa, "WIDE_HEAD_DIM") or hasattr(fa, "WIDE_STEP")
              else getattr(fa, "BHND_MAX_HEAD_DIM", d))
    for key, name, shapes in (("k2", "flash_attention", K2_SHAPES),
                              ("k3", "flash_attention_batched", K3_SHAPES)):
        for label, (b, h, n, hd) in shapes.items():
            if hd > widest:
                continue
            q, k, v = (torch.randn((b, h, n, hd), generator=gen).to(dev, torch.bfloat16)
                       for _ in range(3))
            timed(f"{key}_{label}", lambda: getattr(fa, name)(q, k, v))
    for label, (m, kk, n) in K4_SHAPES.items():
        x = torch.randn((m, kk), generator=gen).to(dev, torch.bfloat16)
        wq = torch.randint(-127, 128, (n, kk), generator=gen, dtype=torch.int8).to(dev)
        qmul = (10.0 + 50.0 * torch.rand(kk, generator=gen)).to(dev)
        scale = (1e-5 + 1e-3 * torch.rand(n, generator=gen)).to(dev)
        bias = torch.randn(n, generator=gen).to(dev)
        timed(f"k4_{label}", lambda: qm.w8a8_matmul(x, wq, qmul, scale, bias))
        w = wq.to(torch.bfloat16)
        timed(f"k4_{label}_matmul", lambda: torch.matmul(x, w.t()))
        del x, wq, w
    # the wide heads, from a generator of their own (the rows above keep their inputs)
    gen_wide = torch.Generator().manual_seed(2)
    for key, name, shapes in (("k2", "flash_attention", K2_WIDE_SHAPES),
                              ("k3", "flash_attention_batched", K3_WIDE_SHAPES)):
        for label, (b, h, n, hd, strided) in shapes.items():
            if strided:
                qkv = torch.randn((b, n, 3, h, hd), generator=gen_wide).to(dev, torch.bfloat16)
                q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            else:
                q, k, v = (torch.randn((b, h, n, hd), generator=gen_wide).to(dev, torch.bfloat16)
                           for _ in range(3))
            timed(f"{key}_{label}", lambda: getattr(fa, name)(q, k, v), WIDE_ITERS)
            timed(f"{key}_{label}_sdpa", lambda: F.scaled_dot_product_attention(q, k, v),
                  WIDE_ITERS)
            del q, k, v
    # fp32, from a generator of its own (the bf16 inputs above stay as they were)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen32 = torch.Generator().manual_seed(1)
    for label, (b, n, h) in K1_FP32_SHAPES.items():
        qkv = torch.randn((b, n, 3 * h * d), generator=gen32).to(dev)
        q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
        timed(f"k1_{label}_fp32", lambda: fa.flash_attention_packed(qkv, h))
        timed(f"k1_{label}_fp32_sdpa", lambda: F.scaled_dot_product_attention(q, k, v))
    for label, (b, h, n, hd, strided) in K2_FP32_SHAPES.items():
        if strided:
            qkv = torch.randn((b, n, 3, h, hd), generator=gen32).to(dev)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        else:
            q, k, v = (torch.randn((b, h, n, hd), generator=gen32).to(dev) for _ in range(3))
        iters = LONG_ITERS if n > LONG_N else ITERS
        timed(f"k2_{label}_fp32", lambda: fa.flash_attention(q, k, v), iters)
        timed(f"k2_{label}_fp32_sdpa", lambda: F.scaled_dot_product_attention(q, k, v), iters)
        del q, k, v
    for label, shape in K3_FP32_SHAPES.items():
        q, k, v = (torch.randn(shape, generator=gen32).to(dev) for _ in range(3))
        timed(f"k3_{label}_fp32", lambda: fa.flash_attention_batched(q, k, v))
        timed(f"k3_{label}_fp32_sdpa", lambda: F.scaled_dot_product_attention(q, k, v))
        del q, k, v
    for label, (m, kk, n) in K4_FP32_SHAPES.items():
        x = torch.randn((m, kk), generator=gen32).to(dev)
        wq = torch.randint(-127, 128, (n, kk), generator=gen32, dtype=torch.int8).to(dev)
        qmul = (10.0 + 50.0 * torch.rand(kk, generator=gen32)).to(dev)
        scale = (1e-5 + 1e-3 * torch.rand(n, generator=gen32)).to(dev)
        bias = torch.randn(n, generator=gen32).to(dev)
        timed(f"k4_{label}_fp32", lambda: qm.w8a8_matmul(x, wq, qmul, scale, bias))
        timed(f"k4_{label}_fp32_chain", lambda: k4_chain(x, wq, qmul, scale, bias))
        del x, wq
    # the fp32 wide heads, from a generator of their own
    gen_wide32 = torch.Generator().manual_seed(4)
    for key, name, shapes in (("k2", "flash_attention", K2_WIDE_SHAPES),
                              ("k3", "flash_attention_batched", K3_WIDE_SHAPES)):
        for label, (b, h, n, hd, strided) in shapes.items():
            if strided:
                qkv = torch.randn((b, n, 3, h, hd), generator=gen_wide32).to(dev)
                q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            else:
                q, k, v = (torch.randn((b, h, n, hd), generator=gen_wide32).to(dev)
                           for _ in range(3))
            timed(f"{key}_{label}_fp32", lambda: getattr(fa, name)(q, k, v), WIDE_ITERS)
            timed(f"{key}_{label}_fp32_sdpa", lambda: F.scaled_dot_product_attention(q, k, v),
                  WIDE_ITERS)
            del q, k, v
    b, h, n = HOST_SHAPE
    qkv = torch.randn((b, n, 3 * h * d), generator=gen).to(dev, torch.bfloat16)
    rec["k1_host_us"] = host_us(lambda: fa.flash_attention_packed(qkv, h))
    q, k, v = (qkv.view(b, n, 3, h, d)[:, :, i].transpose(1, 2) for i in range(3))
    for key, name in (("k2", "flash_attention"), ("k3", "flash_attention_batched")):
        rec[f"{key}_host_us"] = host_us(lambda: getattr(fa, name)(q, k, v))
    m, kk, n = K4_HOST_SHAPE
    x = torch.randn((m, kk), generator=gen).to(dev, torch.bfloat16)
    wq = torch.randint(-127, 128, (n, kk), generator=gen, dtype=torch.int8).to(dev)
    qmul, scale, bias = (torch.rand(size, generator=gen).to(dev) for size in (kk, n, n))
    rec["k4_host_us"] = host_us(lambda: qm.w8a8_matmul(x, wq, qmul, scale, bias))
    from monocular_depth_estimation_trt_tpu_torch.config import BenchmarkConfig
    from monocular_depth_estimation_trt_tpu_torch.registry import build_pipeline
    from monocular_depth_estimation_trt_tpu_torch.weights.store import set_allow_random_weights

    set_allow_random_weights(True)
    torch.manual_seed(0)
    pipe = build_pipeline("depth_anything_v2", encoder="vitl", precision="fp32")
    bench = pipe.benchmark((518, 518), BenchmarkConfig(**E2E_BENCH))
    rec["vitl_fp32_graph_p50_ms"] = bench.percentile_ms(50)
    rec["vitl_fp32_graph_mean_ms"] = bench.avg_ms
    pipe.release_engines()
    del pipe
    torch.manual_seed(0)
    pipe = build_pipeline("depth_pro", precision="fp32")
    bench = pipe.benchmark((1536, 1536), BenchmarkConfig(**DEPTH_PRO_BENCH))
    rec["depth_pro_fp32_graph_p50_ms"] = bench.percentile_ms(50)
    rec["depth_pro_fp32_graph_mean_ms"] = bench.avg_ms
    pipe.release_engines()
    del pipe
    from monocular_depth_estimation_trt_tpu_torch.ops.cuda import _build

    rec["ptxas"] = [ln.strip() for ln in _build.build_info().log.splitlines()
                    if "Compiling entry" in ln or "registers" in ln]
    return rec


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        print(json.dumps(child(os.path.abspath(sys.argv[2]))), flush=True)
        return
    roots = sys.argv[1:]
    if not roots:
        sys.exit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    digests = {}
    for i, root in enumerate(roots):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"{root}: exited {proc.returncode}\n{proc.stderr}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": i + 1, "card": smi, **rec}), flush=True)
        for key, value in rec.items():
            if key.endswith("_digest"):
                digests.setdefault(key[:-len("_digest")], {})[i] = value
    both = {k: set(v.values()) for k, v in digests.items() if len(v) == len(roots)}
    print(json.dumps({"digests_differ": sorted(k for k, v in both.items() if len(v) > 1),
                      "digests_equal": sorted(k for k, v in both.items() if len(v) == 1),
                      "timed_in_some_runs_only": sorted(set(digests) - set(both))}),
          flush=True)


if __name__ == "__main__":
    main()
