#!/usr/bin/env python3
"""Eager latency of the PyTorch port between checkouts, on one card.

    python3 scripts/torch_eager_ab.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout of this repository. For each one in
the order given, a fresh process puts that root first on ``sys.path``,
builds its kernels from its own ``csrc/`` and times, on random inputs and
weights from a fixed seed:

* DA-V2 vits at 518x518 through its eager forward (``DepthPipeline._run``:
  no CUDA graph, what an engine's warm-up calls and the eager profiles run):
  a pinned uint8 frame's H2D, the forward and the depth's D2H, each call
  synchronised; the p50 and p90 in ms over ``ITERS`` calls after ``WARMUP``
  (host clock);
* each kernel wrapper's host time per call (``*_host_us``, the median over
  ``HOST_CALLS`` calls at a small shape, where the card keeps up with the
  host), from the ``runtime/kernel_timing.py`` of the checkout that holds
  this script, loaded by path.

It prints one JSON line per checkout, beside the card's name and power
limit. Neither ``MDET_AUTOTUNE`` nor ``--device-mesh`` is set: every kernel
takes its default tile. Imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

WARMUP = 10
ITERS = 200
HOST_CALLS = 200
HW = (518, 518)
TIMING = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "monocular_depth_estimation_trt_tpu_torch", "runtime", "kernel_timing.py")


def _yardstick():
    spec = importlib.util.spec_from_file_location("mdet_kernel_timing", TIMING)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def child(root: str) -> dict:
    import numpy as np
    import torch

    timing = _yardstick()
    sys.path.insert(0, root)
    from monocular_depth_estimation_trt_tpu_torch.ops.cuda import flash_attention as fa
    from monocular_depth_estimation_trt_tpu_torch.ops.cuda import quant_matmul as qm
    from monocular_depth_estimation_trt_tpu_torch.registry import build_pipeline
    from monocular_depth_estimation_trt_tpu_torch.weights.store import set_allow_random_weights

    dev = torch.device("cuda", 0)
    rec = {"root": root, "package": os.path.dirname(fa.__file__)}
    set_allow_random_weights(True)
    torch.manual_seed(0)
    pipe = build_pipeline("depth_anything_v2", encoder="vits")
    frame = np.random.default_rng(0).integers(0, 255, (*HW, 3), dtype=np.uint8)
    host_in = torch.from_numpy(frame).pin_memory()
    out = pipe._run(host_in.to(dev), HW, False)["depth"]
    host_out = torch.empty(out.shape, dtype=out.dtype).pin_memory()
    before = fa.flash_attention_packed.launches
    times = []
    for i in range(WARMUP + ITERS):
        t0 = time.perf_counter()
        x = host_in.to(dev, non_blocking=True)
        host_out.copy_(pipe._run(x, HW, False)["depth"], non_blocking=True)
        torch.cuda.synchronize()
        if i >= WARMUP:
            times.append((time.perf_counter() - t0) * 1e3)
    rec["vits_518_eager_p50_ms"] = float(np.percentile(times, 50))
    rec["vits_518_eager_p90_ms"] = float(np.percentile(times, 90))
    rec["k1_launches_per_call"] = (fa.flash_attention_packed.launches - before) / (WARMUP + ITERS)

    gen = torch.Generator().manual_seed(0)
    d = fa.HEAD_DIM
    b, h, n = 1, 16, 128
    qkv = torch.randn((b, n, 3 * h * d), generator=gen).to(dev, torch.bfloat16)
    rec["k1_host_us"] = timing.host_us(lambda: fa.flash_attention_packed(qkv, h), HOST_CALLS)
    q, k, v = (qkv.view(b, n, 3, h, d)[:, :, i].transpose(1, 2) for i in range(3))
    for key, name in (("k2", "flash_attention"), ("k3", "flash_attention_batched")):
        rec[f"{key}_host_us"] = timing.host_us(lambda: getattr(fa, name)(q, k, v), HOST_CALLS)
    m, kk, nn = 64, 256, 256
    x = torch.randn((m, kk), generator=gen).to(dev, torch.bfloat16)
    wq = torch.randint(-127, 128, (nn, kk), generator=gen, dtype=torch.int8).to(dev)
    qmul, scale, bias = (torch.rand(size, generator=gen).to(dev) for size in (kk, nn, nn))
    rec["k4_host_us"] = timing.host_us(lambda: qm.w8a8_matmul(x, wq, qmul, scale, bias),
                                       HOST_CALLS)
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
            sys.exit(f"{root}: exited {proc.returncode}\n{proc.stderr[-4000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": i + 1, "card": smi, **rec}), flush=True)


if __name__ == "__main__":
    main()
