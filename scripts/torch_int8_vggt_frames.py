#!/usr/bin/env python3
"""int8 VGGT against its fp32 path on many seeded frames, on one card.

    python3 scripts/torch_int8_vggt_frames.py [FRAME_SEEDS]

``chip_smoke.py`` holds int8 VGGT (S = 1) to max |int8 - fp32| / max |fp32|
bars set at about twice its first readings, on two frames. This script reads
the same comparison, built the same way (``chip_smoke.int8_family``: the
calibration frames of ``chip_smoke.py``, seeded random weights, the bf16 and
fp32 pipelines on the same weights), on more frames: a 480x640 and a
518x518 noise frame from each of FRAME_SEEDS seeds (default 6) and the
smooth scene-like frame, at weight seeds 0 and 1. The fp32 path on the card
is the witness (``chip_smoke.py`` holds it to the CPU within 1e-3). For
depth, confidence and pose it prints one JSON line per reading: max rel,
mean rel, Pearson r and the 99.9th percentile of |a - b| / max |b|, int8
and bf16 each against fp32; then a summary against ``chip_smoke.py``'s bars,
the card's name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("depth", "depth_conf", "pose_enc")


def emit(rec) -> None:
    print(json.dumps(rec), flush=True)


def main() -> None:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from monocular_depth_estimation_trt_tpu_torch.registry import build_pipeline
    from monocular_depth_estimation_trt_tpu_torch.weights.store import (
        init_random_,
        set_allow_random_weights,
    )

    if not torch.cuda.is_available():
        sys.exit("needs one CUDA card")
    seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py: fp32 is fp32
    torch.backends.cudnn.allow_tf32 = False
    set_allow_random_weights(True)
    calib = list(cs.parity_frames(np.random.default_rng(7)).values())
    fam = cs.int8_family("vggt", build_pipeline, calib)
    frames = {"smooth_518x518": cs.parity_frames(np.random.default_rng(0))["smooth_518x518"]}
    for s in range(seeds):
        rng = np.random.default_rng(100 + s)
        frames[f"noise_480x640_seed{100 + s}"] = rng.integers(0, 256, (480, 640, 3), np.uint8)
        frames[f"noise_518x518_seed{100 + s}"] = rng.integers(0, 256, (518, 518, 3), np.uint8)

    def tail(a, b) -> float:
        return float(np.quantile(np.abs(a - b), 0.999) / np.abs(b).max())

    readings = []
    for wseed in cs.PARITY_WEIGHT_SEEDS:
        model = fam["make"]()
        init_random_(model, wseed)
        sd = model.state_dict()
        del model
        pipes = {p: fam["build"](p, sd) for p in ("int8", "bf16", "fp32")}
        for name, frame in frames.items():
            q, b, f = (fam["run"](pipes[p], frame) for p in ("int8", "bf16", "fp32"))
            rec = {"weights_seed": wseed, "frame": name}
            for k in KEYS:
                rec[k] = {f"{route}_vs_fp32_{m}": fn(x[k], f[k])
                          for route, x in (("int8", q), ("bf16", b))
                          for m, fn in (("rel", cs.rel), ("mean_rel", cs.mean_rel),
                                        ("pearson", cs.pearson), ("p999", tail))}
            emit(rec)
            readings.append(rec)
        cs.drop_engines(*pipes.values())
        del pipes, sd
        torch.cuda.empty_cache()

    bars = cs.INT8_REL_TOL["vggt"]
    summary = {"phase": "summary", "readings": len(readings)}
    for k in KEYS:
        q = np.array([r[k]["int8_vs_fp32_rel"] for r in readings])
        b = np.array([r[k]["bf16_vs_fp32_rel"] for r in readings])
        summary[k] = {"bar": bars[k], "int8_over_bar": int((q >= bars[k]).sum()),
                      "int8_rel_max": float(q.max()), "int8_rel_median": float(np.median(q)),
                      "bf16_rel_max": float(b.max()), "bf16_rel_median": float(np.median(b)),
                      "int8_over_bf16_median": float(np.median(q / b)),
                      "int8_mean_rel_max": max(r[k]["int8_vs_fp32_mean_rel"] for r in readings),
                      "int8_pearson_min": min(r[k]["int8_vs_fp32_pearson"] for r in readings),
                      "int8_p999_max": max(r[k]["int8_vs_fp32_p999"] for r in readings)}
    emit(summary)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
