#!/usr/bin/env python3
"""K4's fp32 GEMM at 128 against 256 output columns a tile, on one card.

    python3 scripts/torch_k4_width_ab.py [ROOT]

ROOT (default: this checkout) is the root of a checkout of this
repository, whose fp32 K4 takes 128-column tiles alone. The script copies
its port package into a temporary directory and lets the copy's
``csrc/w8a8_matmul.cu`` instantiate and launch the fp32 kernel at 256
columns too (two edits of ``launch_sm90``), builds it in a fresh process,
prints ptxas's report of each fp32 instantiation (``chip_smoke.py``'s
parser: registers, spills, and warning C7512, a serialized wgmma chain),
and times the fp32 K4 at the four shapes of ``scripts/torch_k4_store_ab.py``
at each width in turns (128, 256, 256, 128) with this checkout's
``runtime/kernel_timing.py::device_ms``, after holding each output equal
to the plain version bit for bit. One JSON line per shape and turn,
beside the card's name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "scripts"))

from torch_k4_store_ab import ITERS, PACKAGE, REPEATS, SHAPES  # noqa: E402

# the two lines of launch_sm90 that keep fp32 at 128 columns, and their edits
EDITS = {"if ((tile_n != 128 && (tile_n != 256 || kF32)) ||":
         "if ((tile_n != 128 && tile_n != 256) ||",
         "if constexpr (!kF32) {\n    if (tile_n == 256) {":
         "{\n    if (tile_n == 256) {"}
WIDTHS = (128, 256, 256, 128)


def child(root: str) -> None:
    import torch

    spec = importlib.util.spec_from_file_location(
        "mdet_kernel_timing", os.path.join(HERE, PACKAGE, "runtime", "kernel_timing.py"))
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)
    import chip_smoke
    from monocular_depth_estimation_trt_tpu_torch.ops.cuda import _build, autotune
    from monocular_depth_estimation_trt_tpu_torch.ops.cuda import quant_matmul as qm

    _build.library()
    report = chip_smoke.ptxas_report(_build.build_info().log)
    print(json.dumps({"ptxas": {k: v for k, v in report.items() if "w8a8_kernel_f32" in k}}),
          flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(1)
    for label, (m, k, n) in SHAPES.items():
        x = torch.randn((m, k), generator=gen).to(dev)
        wq = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8).to(dev)
        qmul = (10.0 + 50.0 * torch.rand(k, generator=gen)).to(dev)
        scale = (1e-5 + 1e-3 * torch.rand(n, generator=gen)).to(dev)
        bias = torch.randn(n, generator=gen).to(dev)
        ref = qm.w8a8_matmul_reference(x, wq, qmul, scale, bias)
        for turn, width in enumerate(WIDTHS):
            with autotune.use_tile(width):
                out = qm.w8a8_matmul(x, wq, qmul, scale, bias)
                ms = timing.device_ms(lambda: qm.w8a8_matmul(x, wq, qmul, scale, bias),
                                      iters=ITERS, repeats=REPEATS)
            print(json.dumps({"shape": label, "turn": turn + 1, "width": width,
                              "equal": bool(torch.equal(out, ref)), "ms": ms}), flush=True)
        del x, wq, out, ref
        torch.cuda.empty_cache()


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(os.path.abspath(sys.argv[2]))
        return
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    print(json.dumps({"card": smi}), flush=True)
    import shutil

    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(os.path.join(root, PACKAGE), os.path.join(tmp, PACKAGE),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        src = os.path.join(tmp, PACKAGE, "csrc", "w8a8_matmul.cu")
        with open(src) as f:
            text = f.read()
        for old, new in EDITS.items():
            if text.count(old) != 1:
                sys.exit(f"{src}: expected one {old!r}")
            text = text.replace(old, new)
        with open(src, "w") as f:
            f.write(text)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tmp])
        sys.exit(proc.returncode)


if __name__ == "__main__":
    main()
