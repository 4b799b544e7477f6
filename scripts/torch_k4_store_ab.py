#!/usr/bin/env python3
"""K4's fp32 epilogue with and without its TMA stores, on one card.

    python3 scripts/torch_k4_store_ab.py [ROOT]

ROOT (default: this checkout) is the root of a checkout of this
repository. The script copies its port package into a temporary directory
and changes one line of the copy's ``csrc/w8a8_matmul.cu``: the launch's
``tma_out`` becomes 0, so that the same kernel stages each 64 x 32 fp32
slice in shared memory as before and every thread then stores its
elements with plain stores, the path the kernel takes where N % 4 != 0.
Then, in turns (TMA, plain, plain, TMA), a fresh process builds one of
the two and times the fp32 K4 at ViT-L's qkv and fc2 and Depth Pro's fc1
and fc2 (``K4_FP32_SHAPES`` of ``scripts/torch_kernel_ab.py``), each at
its default tile width, with ``runtime/kernel_timing.py::device_ms`` of
this checkout, after holding the output equal to the plain version bit
for bit. It prints one JSON line per turn beside the card's name and
power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile

PACKAGE = "monocular_depth_estimation_trt_tpu_torch"
SHAPES = {"vitl_qkv": (1370, 1024, 3072), "vitl_fc2": (1370, 4096, 1024),
          "depth_pro_fc1": (20195, 1024, 4096), "depth_pro_fc2": (20195, 4096, 1024)}
TMA_LINE = "const int tma_out = n % 4 == 0;"
REPEATS = 7
ITERS = 20
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(root: str, store: str) -> dict:
    import torch

    spec = importlib.util.spec_from_file_location(
        "mdet_kernel_timing", os.path.join(HERE, PACKAGE, "runtime", "kernel_timing.py"))
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    sys.path.insert(0, root)
    from monocular_depth_estimation_trt_tpu_torch.ops.cuda import quant_matmul as qm

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(1)
    rec = {"store": store, "package": os.path.dirname(qm.__file__)}
    for label, (m, k, n) in SHAPES.items():
        x = torch.randn((m, k), generator=gen).to(dev)
        wq = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8).to(dev)
        qmul = (10.0 + 50.0 * torch.rand(k, generator=gen)).to(dev)
        scale = (1e-5 + 1e-3 * torch.rand(n, generator=gen)).to(dev)
        bias = torch.randn(n, generator=gen).to(dev)
        out = qm.w8a8_matmul(x, wq, qmul, scale, bias)
        rec[f"{label}_equal"] = bool(torch.equal(out, qm.w8a8_matmul_reference(
            x, wq, qmul, scale, bias)))
        rec[f"{label}_ms"] = timing.device_ms(lambda: qm.w8a8_matmul(x, wq, qmul, scale, bias),
                                              iters=ITERS, repeats=REPEATS)
        del x, wq, out
        torch.cuda.empty_cache()
    return rec


def plain_store_copy(root: str, into: str) -> str:
    """A copy of ``root``'s package whose fp32 K4 stores without TMA."""
    shutil.copytree(os.path.join(root, PACKAGE), os.path.join(into, PACKAGE),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = os.path.join(into, PACKAGE, "csrc", "w8a8_matmul.cu")
    with open(src) as f:
        text = f.read()
    if text.count(TMA_LINE) != 1:
        sys.exit(f"{src}: expected one line {TMA_LINE!r}")
    with open(src, "w") as f:
        f.write(text.replace(TMA_LINE, "const int tma_out = 0;"))
    return into


def main() -> None:
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        print(json.dumps(child(os.path.abspath(sys.argv[2]), sys.argv[3])), flush=True)
        return
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        roots = {"tma": root, "plain": plain_store_copy(root, tmp)}
        for i, store in enumerate(("tma", "plain", "plain", "tma")):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                                   roots[store], store], capture_output=True, text=True)
            if proc.returncode != 0:
                sys.exit(f"{store}: exited {proc.returncode}\n{proc.stderr}")
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({"turn": i + 1, "card": smi, **rec}), flush=True)


if __name__ == "__main__":
    main()
