#!/usr/bin/env python3
"""A/B of the PyTorch port's attention kernels between checkouts, on one card.

    python3 scripts/torch_kernel_ab.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout of this repository. For each one in
the order given, a fresh process puts that root first on ``sys.path``,
builds its kernels from its own ``csrc/`` and times K1 (packed-qkv
attention) at the DA-V2 shapes and Depth Pro's patch shape and, where the
checkout has them, K2 ((B, H, N, d) attention) at VGGT's frame and global
shapes and K3 (whole-row attention) at Depth Pro's patch shape, all bf16 on
random inputs from a fixed seed. It prints one JSON line per checkout: the median
of ``REPEATS`` CUDA-event timings of ``ITERS`` back-to-back launches each,
in ms per launch, beside the card's name and power limit; and each wrapper's
host time per call (``*_host_us``: the median over ``HOST_CALLS`` calls at a
small shape, where the card keeps up with the host). Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPEATS = 7
ITERS = 50
HOST_CALLS = 200
HOST_SHAPE = (1, 16, 128)  # (B, H, N): a kernel shorter than its host call
K1_SHAPES = {"vits_518": (1, 1370, 6), "vits_518_batch4": (4, 1370, 6),
             "vitl_518": (1, 1370, 16), "depth_pro_patch": (35, 577, 16)}  # (B, N, H)
K2_SHAPES = {"frame_s4": (4, 16, 1374), "global_s4": (1, 16, 5496)}  # (B, H, N)
K3_SHAPES = {"depth_pro_patch": (35, 16, 577), "n1024": (16, 16, 1024)}  # (B, H, N)


def child(root: str) -> dict:
    import statistics
    import time

    import torch

    sys.path.insert(0, root)
    from monocular_depth_estimation_trt_tpu_torch.ops.cuda import flash_attention as fa

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    d = fa.HEAD_DIM

    def time_ms(fn) -> float:
        for _ in range(5):
            fn()
        times = []
        for _ in range(REPEATS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(ITERS):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / ITERS)
        return statistics.median(times)

    def host_us(fn) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(HOST_CALLS):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return statistics.median(times) * 1e6

    rec = {"root": root, "package": os.path.dirname(fa.__file__)}
    for label, (b, n, h) in K1_SHAPES.items():
        qkv = torch.randn((b, n, 3 * h * d), generator=gen).to(dev, torch.bfloat16)
        rec[f"k1_{label}_ms"] = time_ms(lambda: fa.flash_attention_packed(qkv, h))
    if hasattr(fa, "flash_attention"):
        for label, (b, h, n) in K2_SHAPES.items():
            q, k, v = (torch.randn((b, h, n, d), generator=gen).to(dev, torch.bfloat16)
                       for _ in range(3))
            rec[f"k2_{label}_ms"] = time_ms(lambda: fa.flash_attention(q, k, v))
    if hasattr(fa, "flash_attention_batched"):
        for label, (b, h, n) in K3_SHAPES.items():
            q, k, v = (torch.randn((b, h, n, d), generator=gen).to(dev, torch.bfloat16)
                       for _ in range(3))
            rec[f"k3_{label}_ms"] = time_ms(lambda: fa.flash_attention_batched(q, k, v))
    b, h, n = HOST_SHAPE
    qkv = torch.randn((b, n, 3 * h * d), generator=gen).to(dev, torch.bfloat16)
    rec["k1_host_us"] = host_us(lambda: fa.flash_attention_packed(qkv, h))
    q, k, v = (qkv.view(b, n, 3, h, d)[:, :, i].transpose(1, 2) for i in range(3))
    for key, name in (("k2", "flash_attention"), ("k3", "flash_attention_batched")):
        if hasattr(fa, name):
            rec[f"{key}_host_us"] = host_us(lambda: getattr(fa, name)(q, k, v))
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
    for i, root in enumerate(roots):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"{root}: exited {proc.returncode}\n{proc.stderr}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": i + 1, "card": smi, **rec}), flush=True)


if __name__ == "__main__":
    main()
