#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printed as one JSON line; any failure exits non-zero:

1. device: card name and power limit, torch/CUDA versions, ``nvcc --version``;
2. build: compiles ``monocular_depth_estimation_trt_tpu_torch/csrc/*.cu``
   with nvcc into the package's ``_build/`` directory and loads it, with
   ptxas's registers and spills per kernel (the wide and fp32 kernels,
   ``*_wide_kernel_sm90`` and ``*_f32_sm90``, must spill nothing and keep
   their wgmma unserialized: no warning C7512); then ``sass``: the HGMMA (bf16
   and TF32 wgmma; IGMMA for K4's int8), UTMALDG (TMA load) and UTMASTG (TMA
   store) instructions of each kernel in ``cuobjdump -sass`` (the bf16 K1, K2
   (both head widths and the wide form), K3 (the same) and K4 (both tile
   widths), and the fp32 K1, K2 and K3 (split TF32, both head widths; K2 and
   K3 also the wide form) and K4 (its one tile width, with TMA stores), must
   have both, and the library must hold no other kernel);
3. kernel checks: each kernel's wrapper (K1 packed-qkv attention, K2
   (B, H, N, d) attention and K3 exact-softmax attention of many short
   heads, all three on the TMA + wgmma mainloop of
   ``csrc/attention_sm90.cuh`` in bf16, K1, K2 and K3 in fp32 on the split
   TF32 mainloop of ``csrc/attention_sm90_f32.cuh``, K2 and K3 at head widths
   64 and 128, and above 128 on each mainloop's wide form (up to d = 1536,
   where Q is streamed beside K);
   K4 the fused w8a8 matmul, a TMA + wgmma int8 GEMM in bf16 and fp32) against its
   plain PyTorch version on the card, at the main paths' shapes and edge
   shapes (for the attention kernels the ends of the 64-row query tiles and
   128-key tiles: N = 1, 63, 65, 127, 128, 129, 255, 257, 577, and head
   widths 16, 80, 96, 128, 192, 256, 320, 1024, 1536; K4 bit for bit), with timings of the
   kernel and
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
   plain attention and the fp32 path for one weight seed and three frames,
   and the fp32 path on the card against the CPU (2 of 24 ViT and 2 of 24
   alternating blocks);
6. Depth Pro path: ``build_pipeline("depth_pro")`` at full size (two
   ViT-L/16@384 encoders, 1536 input): a 480x640 frame with the viz
   epilogue and a 1536x1536 frame, with the counts set to 0 just before and
   read just after (24 K3 + 24 K1 per captured forward); then its bf16
   outputs against plain attention and the fp32 path for one weight seed
   and two frames (the fp32 pipeline's first forward a counted run,
   ``fp32_path``: 24 fp32 K3 + 24 fp32 K1 a forward, then its 1536² graph
   p50 and device time by kernel), and the fp32 path on the card against
   the CPU with the ViT depth cut to 2 blocks (hooks at blocks 0 and 1);
7. metric_families_path: ``depth_anything_v3`` (vitl 518²),
   ``metric3d_v2`` (vitl on the 616x1064 canvas, ``iters=4``), ``moge2``
   (vits 291x518, 1800 tokens) and ``metric_anything`` (vitl 518², 3600
   tokens) at full width on the card, each with its own counts set to 0 just
   before and read just after (per captured forward 24, 24, 12 and 24 K1, no
   K2/K3/K4), two frames each (a 480x640 frame with the viz epilogue, then
   one at the model's input size), outputs finite where they must be (the
   MoGe pair: inf off its mask); then the bf16 kernel route against plain
   attention and the fp32 path for one weight seed and the two frames (the
   MoGe pair on its model's outputs), and the fp32 path on the card against
   the CPU, the ViT-L families cut to 2 blocks; then single_image_families_path:
   ``unidepth_v2`` and ``unik3d`` (vitb 518², 4 registers), ``sidepth`` (two
   vits stacks, 518²), ``geocalib`` (vits 322² and its 10-step camera fit)
   and ``prior_depth_anything`` (VGGT S=1 depth-only and the vits refiner) in
   the same way (per captured forward 12, 12, 24, 12 K1, and 48 K1 + 48 K2;
   GeoCalib's fields compared, its roll, pitch and focal recorded; the fp32
   comparison with every ViT, and Prior Depth Anything's VGGT, cut to 2
   blocks); then ``geocalib_fit``: GeoCalib's camera fit on the fields of
   a known camera (exact, and noisy under uneven weights), eager and
   through an engine, against the camera and the CPU's fit; then
   multi_view_families_path: ``map_anything``, ``stream3r`` (view-causal,
   point head) and ``litevggt`` at 518² (VGGT's aggregator: 24 K1 + 48 K2
   per forward), ``align3r`` on pairs of frames at 512² (24 K1 at
   (4, 1025, 16) and its DA-V2 prior's 12 at (2, 1297, 6)), ``dinov3``
   vitl16 and vit7b16 at 1024² (24 K2 at (1, 16, 4101, 64); 40 at
   (1, 32, 4101, 128), head_dim 128; vit7b16's weights made on the card),
   their route comparisons on the kernel route's own model (vit7b16 one
   weight seed) and fp32 card against CPU (ViTs and VGGT's aggregator cut
   to 2 blocks, vit7b16 to 1,
   Align3R's encoder and decoders to 4); ``procrustes``:
   Align3R's pose fit on a known motion of 512² points (and a mirrored one),
   eager and through an engine, against the motion and the CPU;
   ``map_anything_reconstruct``: 4 views through one engine; ``stream``:
   STream3R's KV-cache session, window 4, 8 steps of one captured graph
   (the ring wraps; step times at steps 1-4 and 5-8; each step against the
   eager step; steps 1-4 against the causal joint model in bf16) and
   StreamVGGT's ``stream`` runner, 24 K1 + 24 K2 a step, and the step's
   profile (graph; eager with the device time of its masked cached
   attention); then each multi-view family's engine against its eager
   forward, its speed in turns eager, graph, and its profile
   (Align3R's eager forward with the device time of its plain decoder
   attention); then the video paths (``video``): Video Depth Anything vits
   and vitl at 518², a 32-frame window each (K1 at (32, 1370, 6 or 16); 12
   or 24 K1 a window) and, for vits, an 80-frame 288x512 clip through
   ``video_depth`` (windows at 0, 22, 44, 48, stitched on the host; the
   stitching re-done from the windows' replays), each window engine against
   its eager forward; FlashDepth vits at 518², 16 steps of its session's one
   captured graph (12 K1 a step) against the eager steps from a fresh state
   and against ``flashdepth_video``, a single frame from a zero state, the
   reset; the int8 StreamVGGT stream, window 4, 8 steps at 480x640 (288 K4
   + 24 K1 + 24 K2 a step) against the eager steps; each with its own counts
   set to 0 just before and read just after; the bf16 kernel route against
   the plain and fp32 routes at one weight seed (``video_parity``) and fp32
   card against CPU with the ViT cut to 2 blocks; then their speed (the VDA
   windows in frames/s, FlashDepth's frame in turns) and profile (the VDA
   windows' eager rows with the device time of the temporal blocks and of
   their attention, the FlashDepth and int8 stream steps' graphs), all
   released before the int8 phases; then the optical-flow paths
   (``flow``): ``raft`` (fp32, TF32 off from its build on), ``neuflow``,
   ``meflow``, ``memfof`` and ``waft`` at their full default sizes
   (288x512; WAFT vits 280x504, K1 at (2, 721, 6): 12 a pair), each with
   its own counts set to 0 just before and read just after, on a 480x640
   pair (MEMFOF a triplet) with the color wheel: shapes, finite values, a
   replay against its eager forward; MEMFOF's video session over 8 frames
   (the triplet's engine, then the cached step's, the two older feature
   maps in), each step against the eager step on an eager cache; fp32 card
   against CPU (2 refinement steps at 144x256, NeuFlow 8 + 8, WAFT
   140x252); WAFT's bf16 kernel route against its plain and fp32 routes at
   one weight seed; RAFT's correlation lookup alone at its shape in the
   separable and the gather form; then each model's speed in turns and its
   profile (graph, and eager with the device time of its lookup, warp or
   plain attention), all released before the int8 phases; then
   ``tracking``: CoTracker3 (``cotracker3`` defaults: window 16, grid 10,
   384x512, bf16) over a first window and a continuation with its counts
   set to 0 just before and read just after (no kernel on its path), both
   engines against their eager forwards, the bf16 route against the fp32
   route, fp32 card against CPU (the model on 8 frames), each window
   engine's p50 with its H2D and D2H and the whole call's, ``track_video``
   over an 80-frame 480x640 clip, the first window's profile; then
   ``slam``: MegaSaM's bundle adjustment on the analytic world of
   ``tests/test_slam_recipes.py`` (its flows injected) on the card against
   that test's bars and against the CPU, the solve engine's and the mapping
   step's engine's replays against eager bit for bit (the mapping step at
   144x256 with 32,768 slots, card against CPU), then ``megasam``,
   ``wildgs_slam`` and ``vipe`` on a 24-frame 480x640 seeded clip over the
   flow phase's RAFT and the DA-V2 vits, UniDepth V2 and GeoCalib pipelines
   of the earlier phases, each with its own counts (36 K1 a depth network's
   new 480x640 engine), the solve's p50 on the served path at the clip's K
   and a mapping step's p50, and their replays' profiles;
8. int8 paths: ``build_pipeline(name, precision="int8", calib_images=...)``
   for DA-V2 vitl, depth_pro, vggt, metric3d_v2 and unidepth_v2 at full
   size, each with its own counts set to 0 just before and read just after
   (per captured forward: 96 K4 + 24 K1; 192 K4 + 24 K3 + 24 K1; 288 K4 + 24
   K1 + 48 K2; 96 K4 + 24 K1; 48 K4 + 12 K1), two frames each (the first
   with the viz epilogue) and 4 views for vggt; then the int8 outputs
   against the bf16 and fp32 routes for one weight seed and two frames
   (VGGT's confidence on its 99.9th percentile and its route ratio); and
   the counted runs alone of unik3d int8 (48 K4 + 12 K1 a forward) and
   map_anything int8 (288 K4 + 24 K1 + 48 K2);
9. engine: an engine each for vits, vitl, int8 vitl, vggt S=1 and S=4,
   depth_pro 1536², int8 unidepth_v2 and the nine single-image families at
   their input sizes (the multi-view families' engines, speed and profile
   run right after their own phases, so that their models are released
   before the int8 phases),
   against the eager forward it captures: the same kernel
   launches per forward, output buffers filled with NaN before the first
   replay, the replay's outputs finite and equal to the eager forward's bit
   for bit (else within ENGINE_REL_TOL, recorded), a result that survives
   the next call; build seconds per engine;
10. cli: the commands in one process of their own, started before the
   int8 phases and read after the engines, each timed: ``run
   depth_anything_v2 --encoder vits --pointcloud --benchmark`` on a seeded
   480x640 PNG (npz depth equal to this process's
   pipeline bit for bit; viz and ``.ply`` written), ``views vggt`` on 4
   PNGs, ``run depth_pro`` on this process's weights (``_fov.json`` against
   its f_px), ``run moge2 --mesh --mesh-format glb``, ``run unidepth_v2``
   (``_fov.json`` from its intrinsics) and ``run geocalib`` (the
   calibration lines) on this process's weights (every npz output equal to
   the pipeline's bit for bit); ``video video_depth_anything``, ``video
   flashdepth`` and ``batch depth_anything_v2 --video`` on
   ``data/example_video.mp4`` (the MP4s' frame count and size, each
   extracted frame's depth; without cv2, each exits non-zero naming the
   codec); ``flow raft`` on 3 seeded 288x512 PNGs (an MP4 of 2 frames at
   512x288); ``track cotracker3`` (an MP4 of the fixture's 16 frames at
   512x288) and ``slam megasam --cvd`` (the JAX CLI's npz keys and 16 frames
   of disparity) on the fixture; meanwhile ``python -m
   monocular_depth_estimation_trt_tpu_torch models`` lists the registry;
11. server: ``DepthServer`` over vits on port 0 with max_batch 4: 8
   concurrent PNG requests, 2 of another size, a bad body (400), an unknown
   model (404), ``format=jpg`` (501 without a JPEG codec); each npz answer
   equal to ``batch_call`` on the same padded bucket, or to the
   single-frame call, bit for bit; ``/v1/stats``;
12. speed: ``DepthPipeline.benchmark`` (through the engine, "graph") and
   the same step through the eager forward ("eager") in turns eager,
   graph for vits, vitl, int8 vitl, vggt S=1 and S=4
   (``benchmark_views``), depth_pro 1536² and the nine single-image
   families at their input sizes; int8 depth_pro, vggt, metric3d_v2 and
   unidepth_v2 through their engines; vits int8 (forced) against vits bf16
   in alternating turns; DA-V2 vitl with ``precision="fp32"`` through its
   engine (a counted run first: 24 fp32 K1 a forward; VGGT's fp32 route,
   counted in its parity phase, launches 24 K1 and 48 K2 a forward);
13. profile: device time by kernel, device busy time and idle share of a
   graph replay of each path (3 calls each; 5 for the 518² and single-image
   paths until the training phase needed the card time) (and of the eager forward of vits, vggt S=4,
   depth_pro, metric3d_v2, moge2, geocalib, unidepth_v2 and unik3d, with
   the device time of the last two's decoder attention), from
   ``torch.profiler``;
14. export: serialized artifacts (``runtime/export.py``) of pipelines built
   above: DA-V2 vits 518² as a serve bundle (b1, b2, both viz modes) before
   the int8 phases, then vitl int8 b1, VGGT's 4-view module and StreamVGGT's
   stream (window 4, 480x640, 8 steps), these two at full widths with 2
   blocks (``EXPORT_VGGT_DEPTH``); each exported, loaded and its first call
   counted with the counts set to 0 just before (per forward 12 K1; 24 K1 +
   96 K4; 2 K1 + 4 K2; 2 K1 + 2 K2), every loaded replay equal to the
   in-process engine bit for bit (else within 1e-3, recorded with the first
   op that differs), the loaded and in-process vits p50 in turns; then, in a
   process where the model zoo cannot be imported, at work from the int8
   phases on, ``run --engine`` (its npz depth
   against the in-process engine), ``bench --engine``, ``bench --engine
   --trace`` (the trace names K1's kernel), ``doctor`` and ``serve --engine``
   (four answers against in-process calls); the record says which host IO
   (the native library or Python's) this machine takes;
15. training: the ``distill`` command's student (DA-V2 vits, fp32, plain
   attention, 266², batch 4) taught by the vitl bf16 teacher's captured
   engine (its labelling run counted: 24 K1 a forward); 3 steps on the card
   against the same 3 steps on the CPU, each from the card's state (losses
   and gradient norms at rel 1e-4, the parameters to the bar of
   ``tests/test_torch_training.py``), one QAT step the same way (its
   gradient norm and its parameters at the bars of activation rounding,
   ``QAT_GRAD_NORM_REL_TOL``); the step's p50 over 20 steps after 3 warm-up
   steps, images/s, the teacher's labelling time per batch, the step's
   device busy time and idle share with its top kernels; then ``distill
   --steps 20 --promote`` (a temporary params cache; its student in full
   fp32, TF32 off, by its own log line) and ``run`` serving the
   promoted weights (its npz depth equal to this process's pipeline on them,
   bit for bit), ``convert --verify-manifest`` of a seeded vits ``.pth``
   (exit 0, and 2 with a key renamed), ``quantcheck`` of DA-V2 vitl (its
   JSON equal to the metrics of this process's bf16 and int8 pipelines, the
   int8 run counted: 96 K4 + 24 K1 a forward; its exit code by the report's
   delta1), ``eval`` of the untrained student's depth against the
   teacher's, two npz files (its JSON equal to this process's metrics) and
   ``run --colorbar`` (the figure, or exit 1 naming
   matplotlib), in one process of their own that starts before the export
   phase's last artifacts and runs while this one exports them and holds
   the card against the CPU.

16. mesh (after the VGGT path): the one-device mesh of ``--device-mesh 1x1``
   (``cli._apply_device_mesh``) applied to the DA-V2 vits and VGGT pipelines
   built above, in a counted run: the main path's 518² frame with its viz (12
   K1) and the VGGT path's 4 views (24 K1 + 48 K2 a forward), each bit-equal
   to those paths' outputs; ``run
   --device-mesh 2x1`` in a process of its own exits non-zero with "needs 2
   devices; 1 available"; 2 ``distill`` steps of the vits student through
   ``shard_train_state`` and ``shard_batch_tree`` on the 1x1 mesh against 2
   plain steps (the JAX sharded-training bars). ``run --device-mesh 1x1``,
   ``views --device-mesh 1x1`` and ``bench --device-mesh 1x1`` join the
   cli phase's process, their npz files bit-equal to the plain commands';
17. autotune: the tile tuner (role K5, ``ops/cuda/autotune.py``) in a
   process of its own with ``MDET_AUTOTUNE=1`` and a temporary
   ``MDET_CACHE_DIR``: K1 at (1, 1370, 6) and (1, 3349, 16), K2 at (1, 16,
   5496, 64) and (1, 32, 4101, 128), K3 at Depth Pro's patch shape (35, 16,
   577, 64), K4 at ViT-L fc2 (M = 1370) and Depth Pro fc1 (M = 20,195): each
   candidate's time, its error against the plain version and its bar, the
   default's and the winner's times beside the bound; then a second process
   on the same cache, run during the Depth Pro path, resolves every winner
   with no measurement.

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
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
# The route comparisons' weight seeds (0 and 1 until the script outgrew its
# time limit: the second seed's models cost about 160 s on an H100 host; its
# readings had never decided a check, PERF.md §6)
PARITY_WEIGHT_SEEDS = (0,)
# ... and, averaged over the readings, the kernel route's distance from fp32
# is at most this multiple of the plain route's: it adds no error beyond the
# bf16 rounding that the plain route already has (readings 0.88 to 1.06; one
# reading alone swings 0.3 to 2x on pose's 9 values).
PATH_BF16_ROUTE_RATIO = 1.5

# The fp32 card-vs-CPU comparison runs the full 1536 geometry and widths
# with the ViT depth cut to 2 blocks, hooked at blocks 0 and 1 (12 blocks and
# hooks 5 and 11 until the metric families' phases needed the card time, 6
# and hooks 2 and 5 until the multi-view families', 4 and hooks 1 and 3
# until the video paths').
DEPTH_PRO_CPU_VIT_DEPTH = 2
DEPTH_PRO_CPU_HOOKS = (0, 1)
# VGGT's fp32 card-vs-CPU comparison: 2 of 24 ViT blocks and 2 of 24
# alternating blocks at full widths and 518^2 (the whole model until the
# multi-view families' phases needed the card time, 4 + 4 until the video
# paths')
VGGT_CPU_DEPTH = 2

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
    "vggt": {"depth": 1.2e-1, "pose_enc": 2e-1},
    "metric3d_v2": {"depth": 1e-1, "confidence": 3e-2},
    "unidepth_v2": {"depth": 7.5e-3, "pts_3d": 3e-2, "confidence": 4e-3, "intrinsics": 3e-2},
}

# VGGT's confidence (1 + exp of a logit) is not held on max rel: over 268k
# values its max swings with one pixel, and scripts/torch_int8_vggt_frames.py
# read it over the old 7.5e-2 bar at 2 of 26 frames (8.6e-2, 8.0e-2) where the
# int8 error followed the bf16 route's pixel for pixel. It is held, as the
# route comparisons are, on the int8 route's distance from fp32 averaged over
# the readings, at most INT8_ROUTE_RATIO times the bf16 route's (the 26
# readings: 1.21), and at every reading on the 99.9th percentile of
# |int8 - fp32| / max |fp32|, about twice the 26 readings' largest (2.9e-2).
# Its max rel is recorded.
INT8_ROUTE_RATIO = 1.5
INT8_P999_TOL = {"vggt": {"depth_conf": 6e-2}}

# replay against eager where a library call picks another algorithm under
# capture (max |graph - eager| / max |eager|); equal bit for bit otherwise
ENGINE_REL_TOL = 1e-3
# 10 timed and 6 synchronised iterations (20 and 10 until the export phase
# needed the card time, 14 and 8 until the training phase's)
VGGT_BENCH = dict(warmup=3, iterations=10, latency_iterations=6)
DEPTH_PRO_BENCH = dict(warmup=3, iterations=10, latency_iterations=6)
# 12 timed and 5 synchronised iterations (50 and 20 until the video paths'
# phases needed the card time, 30 and 10 until the export phase's, 20 and 6
# until the training phase's)
FAMILY_BENCH = dict(warmup=3, iterations=12, latency_iterations=5)

# every kernel of the library, each a TMA + wgmma kernel, and its
# instantiations (the tile candidates of csrc/attention_sm90.cuh: K1 two at
# head width 64, K2 and K3 two at 64 and two at 128, and one of its wide form
# (d > 128) each; K4 at tile widths 128 and 256 with bf16 x, at 128 with fp32 x;
# the fp32 K1, K2 and K3 of csrc/attention_sm90_f32.cuh, one tile a head
# width, and one of its wide form (d > 128) each), with the wgmma's SASS
# name: HGMMA for bf16 and TF32 operands, IGMMA for int8
SM90_KERNELS = {"attn_packed_kernel_sm90": (2, "HGMMA"), "attn_bhnd_kernel_sm90": (4, "HGMMA"),
                "attn_batched_kernel_sm90": (4, "HGMMA"), "w8a8_kernel_sm90": (2, "IGMMA"),
                "w8a8_kernel_f32_sm90": (1, "IGMMA"),
                "attn_bhnd_wide_kernel_sm90": (1, "HGMMA"),
                "attn_batched_wide_kernel_sm90": (1, "HGMMA"),
                "attn_packed_kernel_f32_sm90": (1, "HGMMA"),
                "attn_bhnd_kernel_f32_sm90": (2, "HGMMA"),
                "attn_batched_kernel_f32_sm90": (2, "HGMMA"),
                "attn_bhnd_wide_kernel_f32_sm90": (1, "HGMMA"),
                "attn_batched_wide_kernel_f32_sm90": (1, "HGMMA")}
# the kernels that write their output with TMA stores (UTMASTG in the SASS)
TMA_STORE_KERNELS = ("w8a8_kernel_f32_sm90",)

PEAK_BF16_OPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate
PEAK_FP32_OPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_TF32_OPS = 495e12  # H100 SXM dense TF32 tensor-core rate
# fp32-accurate products on the TF32 tensor cores take three TF32 products
# each (split TF32: lo.hi + hi.lo + hi.hi; csrc/attention_sm90_f32.cuh)
TF32_SPLIT_PRODUCTS = 3
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
    """HGMMA (bf16 and TF32 wgmma), IGMMA (int8 wgmma), UTMALDG (TMA load) and
    UTMASTG (TMA store) instructions per kernel of the built library, from
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


def sass_faults(counts):
    """What the SASS counts lack: each SM90_KERNELS entry with its number of
    instantiations, each with its wgmma and TMA loads (and TMA stores where
    TMA_STORE_KERNELS names it), and no kernel outside SM90_KERNELS."""
    faults = []
    for entry, (count, mma) in SM90_KERNELS.items():
        ops = (mma, "UTMALDG", *(("UTMASTG",) if entry in TMA_STORE_KERNELS else ()))
        found = [c for f, c in counts.items() if entry in f]
        if len(found) != count or not all(c[op] > 0 for c in found for op in ops):
            faults.append(f"{entry}: want {count} instantiations with {', '.join(ops)}, "
                          f"SASS {found}")
    faults += [f"{f}: a kernel outside SM90_KERNELS" for f in counts
               if not any(entry in f for entry in SM90_KERNELS)]
    return faults


# kernels whose design rests on ptxas keeping every value in registers and
# the wgmma chain asynchronous: the bf16 wide form (one CTA an SM, about 240
# registers a consumer thread), the fp32 split-TF32 mainloop, its wide
# form included, and the fp32 K4
PTXAS_CLEAN = ("_wide_kernel_sm90", "_f32_sm90")


def ptxas_report(log: str):
    """Per kernel entry of an ``nvcc -Xptxas -v`` log: its registers, spill
    stores and loads (bytes), and whether ptxas serialized its wgmma (warning
    C7512, which names the function)."""
    report, entry = {}, None

    def of(name):  # the warning may come before or after its entry's lines
        return report.setdefault(name, {"registers": None, "spill_stores": None,
                                        "spill_loads": None, "serialized": False})

    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            of(entry)
        elif "(C7512)" in line:
            of(line.rsplit("'", 2)[-2])["serialized"] = True
        elif entry is not None and "spill stores" in line:
            for part in line.split(","):
                words = part.split()
                if part.strip().endswith("spill stores"):
                    report[entry]["spill_stores"] = int(words[0])
                elif part.strip().endswith("spill loads"):
                    report[entry]["spill_loads"] = int(words[0])
        elif entry is not None and "Used" in line and "registers" in line:
            words = line.split()
            report[entry]["registers"] = int(words[words.index("Used") + 1])
    return report


def ptxas_faults(report):
    """The PTXAS_CLEAN kernels that spill, serialize their wgmma, or whose
    spill line is missing; every PTXAS_CLEAN pattern must match an entry."""
    faults = [f"no kernel matching {pat} in the ptxas log" for pat in PTXAS_CLEAN
              if not any(pat in name for name in report)]
    for name, r in report.items():
        if any(pat in name for pat in PTXAS_CLEAN) and (
                r["serialized"] or r["spill_stores"] != 0 or r["spill_loads"] != 0):
            faults.append(f"{name}: {r}")
    return faults


def attention_bound(b: int, n: int, h: int, d: int, itemsize: int, peak_ops: float):
    ops = 4.0 * b * h * n * n * d
    nbytes = float(b * n * 4 * h * d * itemsize)  # qkv read once, out written once
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_bounds(b: int, n: int, h: int, d: int, dtype):
    """The bound of an attention row: bf16 on the bf16 tensor cores; fp32 the
    lesser of its two ways to fp32 accuracy, ops / 67 TFLOP/s on the fp32
    pipes and 3 ops / 495 TFLOP/s on the TF32 tensor cores (split TF32), each
    against the bytes. Returns (bound_ms, bound_by, fields of the record)."""
    import torch

    if dtype == torch.bfloat16:
        ms, by = attention_bound(b, n, h, d, 2, PEAK_BF16_OPS)
        return ms, by, {"bound_of": "bf16 tensor cores"}
    fma = attention_bound(b, n, h, d, 4, PEAK_FP32_OPS)
    tf32 = attention_bound(b, n, h, d, 4, PEAK_TF32_OPS / TF32_SPLIT_PRODUCTS)
    fields = {"bound_fp32_fma_ms": fma[0], "bound_split_tf32_ms": tf32[0]}
    if tf32[0] <= fma[0]:
        return (*tf32, {**fields, "bound_of": "3 x ops on the TF32 tensor cores (split TF32)"})
    return (*fma, {**fields, "bound_of": "ops on the fp32 pipes"})


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 numbers (8 significant bits) at magnitude ``x`` > 0."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def rel(a, b) -> float:
    """max |a - b| / max |b| (host arrays)."""
    import numpy as np

    return float(np.abs(a - b).max() / np.abs(b).max())


def p999_rel(a, b) -> float:
    """The 99.9th percentile of |a - b| / max |b| (host arrays)."""
    import numpy as np

    return float(np.percentile(np.abs(a - b), 99.9) / np.abs(b).max())


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
        # Align3R: the ViT-L/16 encoder over both pair orders' four 512^2 images
        # (32x32 + cls) and the DA-V2 vits prior of both frames at 504^2 (36x36 + cls)
        ("align3r_encoder_512", 4, 1025, 16, torch.bfloat16),
        ("align3r_prior_504", 2, 1297, 6, torch.bfloat16),
        # Video Depth Anything: a 32-frame 518^2 window folded into the batch
        ("vda_vits_window32", 32, 1370, 6, torch.bfloat16),
        ("vda_vitl_window32", 32, 1370, 16, torch.bfloat16),
        # WAFT: the ViT-S over both frames of a 280x504 pair (20x36 + cls)
        ("waft_vits_280x504_pair", 2, 721, 6, torch.bfloat16),
        ("n1", 1, 1, 6, torch.bfloat16),
        ("n63", 1, 63, 6, torch.bfloat16),
        ("n64", 1, 64, 6, torch.bfloat16),
        ("n65", 1, 65, 6, torch.bfloat16),
        ("n1024", 1, 1024, 6, torch.bfloat16),
        ("h3_n1370", 1, 1370, 3, torch.bfloat16),
        ("vits_518_fp32", 1, 1370, 6, torch.float32),
        ("vitl_518_fp32", 1, 1370, 16, torch.float32),
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
        bound_ms, bound_by, bound_fields = attention_bounds(b, n, h, d, dtype)
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
            "bound_ms": bound_ms, "bound_by": bound_by, **bound_fields,
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
        ("global_s4_fp32", 1, 16, 5496, 64, torch.float32, False),
        ("n65_fp32", 2, 3, 65, 64, torch.float32, False),
        # DINOv3 at 1024^2 (64x64 + cls + 4 registers): vitl16, and vit7b16's 32
        # heads of head_dim 128, as the rope attention reads them (strided views)
        ("dinov3_vitl16_1024", 1, 16, 4101, 64, torch.bfloat16, True),
        ("dinov3_vit7b16_1024", 1, 32, 4101, 128, torch.bfloat16, True),
        # head_dim 128 at 1029 tokens, and 80, 96 padded to it
        ("d128_vit7b", 1, 32, 1029, 128, torch.bfloat16, False),
        ("d128_n129", 2, 16, 129, 128, torch.bfloat16, False),
        ("d128_n577_strided", 4, 16, 577, 128, torch.bfloat16, True),
        ("d80_padded", 2, 16, 257, 80, torch.bfloat16, False),
        ("d96_padded", 2, 16, 255, 96, torch.bfloat16, True),
        ("d128_vit7b_fp32", 1, 32, 1029, 128, torch.float32, False),
        ("dinov3_vit7b16_1024_fp32", 1, 32, 4101, 128, torch.float32, True),
        ("d96_fp32", 2, 3, 65, 96, torch.float32, False),
        # heads wider than 128, zero-padded to a multiple of 64: in bf16 the
        # mainloop's wide form (Q streamed beside K past d = 1280), in fp32 the
        # split TF32 mainloop's (Q streamed past d = 192)
        ("d192_wide", 1, 16, 1029, 192, torch.bfloat16, False),
        ("d256_wide", 1, 16, 1029, 256, torch.bfloat16, False),
        ("d320_wide_strided", 2, 8, 577, 320, torch.bfloat16, True),
        ("d1024_wide", 1, 2, 129, 1024, torch.bfloat16, False),
        ("d1536_wide_qstream", 1, 2, 129, 1536, torch.bfloat16, False),
        ("d192_wide_fp32", 1, 4, 257, 192, torch.float32, False),
        ("d320_wide_fp32", 1, 4, 129, 320, torch.float32, False),
        ("d1024_wide_fp32", 1, 2, 129, 1024, torch.float32, False),
        ("d1536_wide_qstream_fp32", 1, 2, 129, 1536, torch.float32, False),
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
        # heads wider than 128, as K2's
        ("d192_wide", 16, 16, 577, 192, torch.bfloat16, True),
        ("d256_wide", 8, 16, 577, 256, torch.bfloat16, False),
        ("d320_wide", 8, 8, 257, 320, torch.bfloat16, False),
        ("d1024_wide", 4, 2, 129, 1024, torch.bfloat16, False),
        ("d1536_wide_qstream", 4, 2, 129, 1536, torch.bfloat16, False),
        ("d256_wide_fp32", 4, 8, 577, 256, torch.float32, False),
        ("d1024_wide_fp32", 4, 2, 129, 1024, torch.float32, False),
        ("d1536_wide_qstream_fp32", 4, 2, 129, 1536, torch.float32, False),
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
        bound_ms, bound_by, bound_fields = attention_bounds(b, n, h, d, dtype)
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
            "bound_ms": bound_ms, "bound_by": bound_by, **bound_fields,
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
    return pipe, launches, (views4, outs["views_s4"])


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


def vggt_parity(build_pipeline, pipe, frames, wrappers):
    """For each weight seed and frame (S=1), on weights rounded to bf16 and
    shared by every route: the bf16 kernel route against plain attention
    and against the fp32 card path, on depth, confidence and pose; and, for
    seed 0 and the first frame, the fp32 card path against the fp32 CPU
    path. Every reading is emitted before any is checked. The fp32 card
    path's first forward (its engine's build) is a counted run of the fp32
    K1 and K2 (24 + 48 a forward): its launch record is returned."""
    import torch
    from monocular_depth_estimation_trt_tpu_torch.models.vggt import VGGT

    keys = ("depth", "depth_conf", "pose_enc")

    def run(p, frame):
        out = p(frame)
        return {k: out[k] for k in keys}

    readings, cpu_rec, fp32_launches = [], None, None
    for seed in PARITY_WEIGHT_SEEDS:
        kernel_pipe = pipe
        if seed != 0:  # the path's pipeline holds seed 0
            model = seeded(VGGT, seed)
            kernel_pipe = build_pipeline("vggt", params=model.state_dict())
            del model
        sd = {k: v.float().cpu() for k, v in kernel_pipe.model.state_dict().items()}
        plain_pipe = build_pipeline("vggt", attn_impl="xla", params=sd)
        card32_pipe = build_pipeline("vggt", precision="fp32", params=sd)
        for name, frame in frames.items():
            kernel, plain = run(kernel_pipe, frame), run(plain_pipe, frame)
            if fp32_launches is None:  # the fp32 path's own counts
                set_counts_to_zero(wrappers)
                card32, per = run_counted(lambda: run(card32_pipe, frame),
                                          lambda: card32_pipe.engine_for(frame.shape[:2]),
                                          wrappers, f"vggt fp32 {name}")
                torch.cuda.synchronize()
                fp32_launches = launch_record(wrappers)
                check(per == [0, 24, 48, 0],
                      f"vggt fp32: K3, K1, K2, K4 launches {per}, want [0, 24, 48, 0]")
                emit({"phase": "fp32_path", "model": card32_pipe.spec.artifact_name(),
                      "frame": name, "launches_per_forward": per, "launches": fp32_launches,
                      "counted": f"{WARMUP_CALLS} warm-up + 1 captured"})
            else:
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
            if cpu_rec is None:  # on a cut model: full widths, VGGT_CPU_DEPTH blocks
                cut = family_cut_kw("litevggt", VGGT_CPU_DEPTH)
                cut32_pipe = build_pipeline("vggt", precision="fp32", **cut)
                cut_card = run(cut32_pipe, frame)
                cut_sd = {k: v.cpu() for k, v in cut32_pipe.model.state_dict().items()}
                drop_engines(cut32_pipe)
                del cut32_pipe
                t0 = time.perf_counter()
                cpu32 = run(build_pipeline("vggt", precision="fp32", params=cut_sd,
                                           device="cpu", **cut), frame)
                cpu_rec = {"phase": "vggt_parity_cpu", "weights_seed": seed, "frame": name,
                           "cpu_fp32_seconds": time.perf_counter() - t0,
                           "model_depth": f"full widths; {VGGT_CPU_DEPTH} of 24 ViT blocks and "
                                          f"{VGGT_CPU_DEPTH} of 24 alternating blocks",
                           **{k: {"fp32_card_vs_cpu_rel": rel(cut_card[k], cpu32[k])}
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
    return fp32_launches


def seeded(make, seed):
    """``make()`` with seeded random weights (fp32, CPU): built on the meta
    device and filled by ``init_random_``, which writes every parameter, so
    that no default init is computed to be overwritten."""
    import torch

    from monocular_depth_estimation_trt_tpu_torch.weights.store import init_random_

    with torch.device("meta"):
        model = make()
    model = model.to_empty(device="cpu")
    init_random_(model, seed)
    return model


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


def depth_pro_parity(build_pipeline, pipe, frames, wrappers, config, card, power_limit):
    """For each weight seed and frame, on weights rounded to bf16 and shared
    by every route: the bf16 kernel route (K3 + K1) against plain attention
    and against the fp32 card path, on the inverse depth (the model's
    output: a pixel at the depth clip would set the scale of a relative
    error of the depth itself) and f_px. The kernel route is held to
    PATH_BF16_REL_TOL of the plain route at every reading, and, averaged
    over the readings, to PATH_BF16_ROUTE_RATIO times the plain route's
    distance from fp32. The fp32 pipeline's first forward is the fp32
    path's counted run (``fp32_path``: 24 fp32 K3 + 24 fp32 K1 a forward);
    its 1536² engine is then timed (``config``) and profiled. Then the
    fp32 path on the card against the CPU at the full 1536 geometry and
    widths, the ViT depth cut to DEPTH_PRO_CPU_VIT_DEPTH blocks. Every
    reading is emitted before any is checked. Returns the fp32 counted
    run's launch record."""
    import numpy as np
    import torch
    from monocular_depth_estimation_trt_tpu_torch.models.depth_pro import (
        DepthPro,
        DepthProConfig,
    )
    from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig

    keys = ("inverse_depth", "f_px")

    def run(p, frame):
        out = p(frame)
        return {"inverse_depth": 1.0 / out["depth"], "f_px": np.asarray(out["f_px"])}

    readings, fp32_launches = [], None
    for seed in PARITY_WEIGHT_SEEDS:
        kernel_pipe = pipe
        if seed != 0:  # the path's pipeline holds seed 0
            model = seeded(DepthPro, seed)
            lift_depth_pro_outputs(model)
            kernel_pipe = build_pipeline("depth_pro", params=model.state_dict())
            del model
        sd = {k: v.float().cpu() for k, v in kernel_pipe.model.state_dict().items()}
        plain_pipe = build_pipeline("depth_pro", attn_impl="xla", params=sd)
        card32_pipe = build_pipeline("depth_pro", precision="fp32", params=sd)
        for name, frame in frames.items():
            kernel, plain = run(kernel_pipe, frame), run(plain_pipe, frame)
            if fp32_launches is None:  # the fp32 path's own counts
                set_counts_to_zero(wrappers)
                card32, per = run_counted(lambda: run(card32_pipe, frame),
                                          lambda: card32_pipe.engine_for(frame.shape[:2]),
                                          wrappers, f"depth_pro fp32 {name}")
                torch.cuda.synchronize()
                fp32_launches = launch_record(wrappers)
                check(per == [24, 24, 0, 0],
                      f"depth_pro fp32: K3, K1, K2, K4 launches {per}, want [24, 24, 0, 0]")
                emit({"phase": "fp32_path", "model": card32_pipe.spec.artifact_name(),
                      "frame": name, "launches_per_forward": per, "launches": fp32_launches,
                      "counted": f"{WARMUP_CALLS} warm-up + 1 captured"})
            else:
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
        if seed == PARITY_WEIGHT_SEEDS[0]:  # the fp32 path's speed at 1536^2, its engine built
            hw = (1536, 1536)
            rep = timed_route(card32_pipe, "graph", hw, 0, config)
            emit({**speed_record(rep, card32_pipe, "depth_pro_fp32", "graph", 0, 0, hw, card,
                                 power_limit), "launches_per_forward": per})
            eng = card32_pipe.engine_for(hw)
            arg = torch.from_numpy(frames["frame_1536x1536"]).to(card32_pipe.device)
            emit({**profile_breakdown(lambda: eng(arg), card32_pipe.spec.artifact_name(), 3),
                  "route": "graph"})
            del eng, arg
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
    return fp32_launches


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
# two vits stacks (24 K1). The multi-view and rope families: MapAnything,
# STream3R (causal, S=1: its global attention over one view stays on K2) and
# LiteVGGT at 518^2, each the VGGT aggregator (24 K1 + 48 K2); Align3R at 512^2
# on a pair (frame 1, frame 2), whose ViT-L/16 encoder runs both pair orders'
# four images at once (24 K1 at (4, 1025, 16)) beside the DA-V2 vits prior of
# both frames at 504^2 (12 K1 at (2, 1297, 6)), its decoders' attention plain;
# DINOv3 vitl16 and vit7b16 at 1024^2, every attention a rope attention on K2
# (24 at (1, 16, 4101, 64); 40 at (1, 32, 4101, 128), head_dim 128). vit7b16
# (8.2 B parameters) runs one weight seed. The plain and fp32 routes of these
# families run on the kernel route's own model (``on_card_routes``: its
# attention switched to "xla", its bf16 weights cast to fp32 and back), so
# that no pipeline is rebuilt per route and vit7b16's host never holds an
# fp32 copy.
# Bars: about twice the largest of the first card run's 4 readings (2 for
# vit7b16): MapAnything depth 1.3e-1, rays 1.1e-2 (mean), confidence 4.4e-2,
# scale 1.7e-2; STream3R depth 4.4e-2, points 5.7e-2, their confidence
# 2.9e-2, pose 3.4e-2; LiteVGGT holds VGGT's bars (its graph); DINOv3 vitl16
# 1.9e-2, vit7b16 1.6e-2. Align3R's bf16 routes read 0.17-0.37 max rel from
# fp32 on both routes alike (points are expm1 of DPT outputs up to 10 with
# random weights, which turns a bf16 step into 4 %), so its point maps, depth
# and first confidence are held on mean rel (readings 6.4e-2, 3.6e-2, 4.0e-2,
# 3.9e-2); its pose, a Procrustes fit of two random-weight point clouds, is
# ill-conditioned (rotation 0.03-0.40 from fp32 on either route) and is
# recorded; the fit itself is held on a known motion (check_procrustes).
METRIC, SINGLE = "metric_families", "single_image_families"
MULTI = "multi_view_families"
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
    "map_anything": dict(group=MULTI, hw=((480, 640), (518, 518)), per_forward=[0, 24, 48, 0],
                         on_card_routes=True, cpu_depth=2,
                         held={"depth": Held(2.5e-1), "ray_directions": Held(2.5e-2, "mean_rel"),
                               "conf": Held(9e-2),
                               "metric_scaling_factor": Held(3.5e-2, in_ratio=False)}),
    "stream3r": dict(group=MULTI, hw=((480, 640), (518, 518)), per_forward=[0, 24, 48, 0],
                     on_card_routes=True, cpu_depth=2,
                     held={"depth": Held(9e-2), "world_points": Held(1.2e-1),
                           "world_points_conf": Held(6e-2),
                           "pose_enc": Held(7e-2, in_ratio=False)}),
    "litevggt": dict(group=MULTI, hw=((480, 640), (518, 518)), per_forward=[0, 24, 48, 0],
                     on_card_routes=True, cpu_depth=2,
                     held={k: Held(v) for k, v in PATH_BF16_VGGT_REL_TOL.items()}),
    "align3r": dict(group=MULTI, hw=((480, 640), (512, 512)), per_forward=[0, 36, 0, 0],
                    pair=True, on_card_routes=True, cpu_depth=4,  # its decoder taps need 4
                    held={"depth": Held(1.5e-1, "mean_rel"), "pts1": Held(8e-2, "mean_rel"),
                          "pts2": Held(8e-2, "mean_rel"), "conf1": Held(8e-2, "mean_rel"),
                          "conf2": Held(1.5e-1)},
                    recorded=("rotation", "translation")),
    "dinov3": dict(group=MULTI, hw=((480, 640), (1024, 1024)), per_forward=[0, 0, 24, 0],
                   on_card_routes=True, cpu_depth=2, held={"depth": Held(4e-2)}),
    "dinov3_vit7b16": dict(group=MULTI, model="dinov3", kw=dict(encoder="vit7b16"),
                           hw=((480, 640), (1024, 1024)), per_forward=[0, 0, 40, 0],
                           held={"depth": Held(3.5e-2)}, seeds=(0,), on_card_routes=True,
                           cpu_depth=1, bench=dict(warmup=2, iterations=8,
                                                   latency_iterations=4)),
}
GEOCALIB_FIELDS = tuple(FAMILIES["geocalib"]["held"])
POINTMAP = ("moge2", "metric_anything")
GEOMETRIC = ("unidepth_v2", "unik3d")
SINGLE_FAMILIES = tuple(n for n, fam in FAMILIES.items() if fam["group"] != MULTI)
VGGT_FAMILY = ("map_anything", "stream3r", "litevggt")
DINOV3 = ("dinov3", "dinov3_vit7b16")
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
# The fp32 card-vs-CPU comparison cuts each family's ViTs to 2 blocks (taps 0,
# 1, 0, 1) at full width and resolution, Prior Depth Anything's VGGT to 2
# alternating blocks on a 2-block patch embed; MoGe-2 vits runs whole (4
# blocks until the video paths' phases needed the card time).
FAMILY_CPU_VIT_DEPTH = 2


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
    taps = tuple(range(depth // 4 - 1, depth, depth // 4)) if depth >= 4 else (0, depth - 1) * 2
    if name in DINOV3:
        from monocular_depth_estimation_trt_tpu_torch.models.dinov3 import DINOV3_CONFIGS

        tier = FAMILIES[name].get("kw", {}).get("encoder", "vitl16")
        return dict(model_kw=dict(vit_config=dataclasses.replace(DINOV3_CONFIGS[tier],
                                                                 depth=depth),
                                  out_indices=taps))
    if name == "align3r":
        from monocular_depth_estimation_trt_tpu_torch.models.align3r import ALIGN3R_ENCODER

        return dict(model_kw=dict(enc=dataclasses.replace(ALIGN3R_ENCODER, depth=depth),
                                  dec_depth=depth))
    if name in VGGT_FAMILY:
        return dict(vggt_cfg=VGGTConfig(depth=depth, head_layers=taps, causal=name == "stream3r",
                                        vit_config=vit))
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


def build_family(build_pipeline, name, **kw):
    """``build_pipeline`` of a family's registry entry, with its entry's own
    arguments (DINOv3 vit7b16's encoder)."""
    fam = FAMILIES[name]
    return build_pipeline(fam.get("model", name), **{**fam.get("kw", {}), **kw})


def family_pipeline(build_pipeline, name, **kw):
    pipe = build_family(build_pipeline, name, **kw)
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
    from monocular_depth_estimation_trt_tpu_torch.models.vggt import VGGT, VGGTConfig

    if name == "align3r":  # the pair model and its frozen prior, as the pipeline holds them
        import types

        from monocular_depth_estimation_trt_tpu_torch.models.align3r import Align3R
        from monocular_depth_estimation_trt_tpu_torch.models.depth_anything_v2 import (
            DepthAnythingV2,
        )

        return types.SimpleNamespace(model=seeded(Align3R, seed),
                                     prior=seeded(lambda: DepthAnythingV2("vits"), seed))
    from monocular_depth_estimation_trt_tpu_torch.models.dinov3 import DINOv3Depther
    from monocular_depth_estimation_trt_tpu_torch.models.map_anything import MapAnything

    model = {"map_anything": MapAnything,
             "stream3r": lambda: VGGT(VGGTConfig(causal=True), with_point_head=True),
             "litevggt": VGGT, "dinov3": DINOv3Depther,
             "depth_anything_v3": DepthAnythingV3, "metric3d_v2": Metric3DV2,
             "moge2": MoGe2,
             "metric_anything": lambda: MoGe2("vitl", 3600, predict_normal=False),
             "unidepth_v2": GeometricDepthModel,
             "unik3d": lambda: GeometricDepthModel(mode="unik3d"),
             "sidepth": SIDepth, "geocalib": GeoCalib,
             "prior_depth_anything": lambda: PriorDepthAnything(VGGT(with_camera=False),
                                                                PriorDARefiner())}[name]
    model = seeded(model, seed)
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
    if name == "align3r":  # a PairPipeline, or family_model's pair
        return {"align3r": sd(model.model), "prior": sd(model.prior)}
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
    if name in MULTI_OUTPUTS:
        return check_multi_view_outputs(name, at, out, hw)
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
    with the viz epilogue; a pair family takes two frames of each size and
    has no viz). Returns the pipeline, the counts and the frames."""
    import numpy as np
    import torch

    fam = FAMILIES[name]
    t0 = time.perf_counter()
    pipe = family_pipeline(build_pipeline, name)
    build_s = time.perf_counter() - t0
    check(pipe.device.type == "cuda", f"{name} default device is {pipe.device}")
    pair = fam.get("pair", False)
    frames = {f"frame_{h}x{w}": (tuple(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                                       for _ in range(2)) if pair else
                                 rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
              for h, w in fam["hw"]}

    set_counts_to_zero(wrappers)
    per_forward, outs = {}, {}
    for i, (key, frame) in enumerate(frames.items()):
        viz = i == 0
        if pair:
            call, engine = (lambda: pipe(*frame)), (lambda: pipe.engine_for(frame[0].shape[:2]))
        else:
            call, engine = (lambda: pipe(frame, viz=viz)), (
                lambda: pipe.engine_for(frame.shape[:2], viz))
        outs[key], per_forward[key] = run_counted(call, engine, wrappers, f"{name} {key}")
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
        rec[key] = check_family_outputs(name, key, outs[key],
                                        (frame[0] if pair else frame).shape[:2])
    first = outs[next(iter(frames))]
    if not pair and pipe.viz != "none":
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

    out = pipe(*frame) if FAMILIES[name].get("pair") else pipe(frame)
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
    for seed in fam.get("seeds", PARITY_WEIGHT_SEEDS):
        kernel_pipe = pipe
        if seed != 0:  # the path's pipeline holds seed 0
            model = family_model(name, seed)
            kernel_pipe = build_family(build_pipeline, name, params=family_params(name, model))
            del model
        if fam.get("on_card_routes"):
            routes = on_card_routes(name, kernel_pipe, frames)
        else:
            sd = family_params(name, kernel_pipe if fam.get("pair") else kernel_pipe.model)
            plain_pipe = build_family(build_pipeline, name, attn_impl="xla", params=sd)
            card32_pipe = build_family(build_pipeline, name, precision="fp32", params=sd)
            routes = {frame_name: [family_outputs(name, p, frame)
                                   for p in (kernel_pipe, plain_pipe, card32_pipe)]
                      for frame_name, frame in frames.items()}
            drop_engines(plain_pipe, card32_pipe, kernel_pipe)
            del plain_pipe, card32_pipe, sd
        for frame_name, (kernel, plain, card32) in routes.items():
            rec = {"phase": f"{group}_parity", "model": name, "weights_seed": seed,
                   "frame": frame_name,
                   "bf16_kernel_vs_plain_attention": family_readings(name, kernel, plain),
                   "bf16_kernel_route_vs_fp32": family_readings(name, kernel, card32),
                   "bf16_plain_route_vs_fp32": family_readings(name, plain, card32)}
            for k in recorded:
                rec[k] = {route: recorded_value(got[k]) for route, got in
                          (("kernel", kernel), ("plain", plain), ("fp32", card32))}
            emit(rec)
            readings.append(rec)
        del kernel_pipe

    # fp32, card against CPU, on the first frame
    depth = None if name == "moge2" else fam.get("cpu_depth", FAMILY_CPU_VIT_DEPTH)
    cut = family_cut_kw(name, depth)
    card32 = family_pipeline(build_pipeline, name, precision="fp32", **cut)
    frame_name, frame = next(iter(frames.items()))
    got_card = family_outputs(name, card32, frame)
    sd = family_params(name, card32 if fam.get("pair") else card32.model)
    drop_engines(card32)
    del card32
    t0 = time.perf_counter()
    cpu32 = build_family(build_pipeline, name, precision="fp32", device="cpu", params=sd, **cut)
    got_cpu = family_outputs(name, cpu32, frame)
    cpu_rec = {"phase": f"{group}_parity_cpu", "model": name, "frame": frame_name,
               "cpu_fp32_seconds": time.perf_counter() - t0,
               "model_depth": "full" if depth is None else
               f"full widths and resolution; {depth} blocks of each ViT"
               + (" and of VGGT's aggregator" if name in ("prior_depth_anything", *VGGT_FAMILY)
                  else "") + (" and of each decoder" if name == "align3r" else ""),
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
        cpu_rec[k] = {"card": recorded_value(got_card[k]), "cpu": recorded_value(got_cpu[k])}
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


MULTI_OUTPUTS = (*VGGT_FAMILY, "align3r")


def check_multi_view_outputs(name, at, out, hw):
    """The outputs of one forward of a multi-view family: shapes, finite
    values, confidences >= 1, unit rays, a proper rotation. Returns a
    summary."""
    import numpy as np

    d = out["depth"]
    side = FAMILIES[name]["hw"][1]
    want_depth = side if name == "align3r" else hw
    check(d.shape == want_depth and d.dtype == np.float32 and bool(np.isfinite(d).all()),
          f"{at}: depth {d.shape} {d.dtype}")
    check(d.min() >= 1e-3 and d.max() > d.min(), f"{at}: depth range {d.min()} {d.max()}")
    rec = {"depth_shape": list(d.shape), "depth_range": [float(d.min()), float(d.max())]}
    for k, v in out.items():
        # a random-weight fov at the relu's 0 makes focal_px infinite (vggt_path)
        if k in ("viz", "focal_px") or v.dtype == np.bool_:
            continue
        check(bool(np.isfinite(v).all()), f"{at}: {k} not finite")
    if "focal_px" in out:
        focal = float(out["focal_px"])
        check(focal > 0 and (np.isfinite(focal) or float(out["pose_enc"][7]) == 0.0),
              f"{at}: focal_px {focal} for fov_h {float(out['pose_enc'][7])}")
    if name == "align3r":
        for k in ("pts1", "pts2"):
            check(out[k].shape == (*side, 3), f"{at}: {k} {out[k].shape}")
        for k in ("conf1", "conf2"):
            check(out[k].shape == side and out[k].min() >= 1.0, f"{at}: {k}")
        R = out["rotation"].astype(np.float64)
        orth = float(np.abs(R @ R.T - np.eye(3)).max())
        check(orth < 1e-4 and abs(np.linalg.det(R) - 1.0) < 1e-4, f"{at}: rotation {R.tolist()}")
        rec.update(rotation_orthogonality_err=orth, translation=out["translation"].tolist())
        return rec
    if name == "map_anything":
        ray = out["ray_directions"]
        check(ray.shape == (1, *side, 3) and out["pts3d"].shape == (1, *side, 3),
              f"{at}: ray {ray.shape}")
        norm_err = float(np.abs(np.linalg.norm(ray, axis=-1) - 1.0).max())
        check(norm_err < 1e-3 and ray[..., 2].min() > 0, f"{at}: rays off unit norm {norm_err}")
        check(out["conf"].min() >= 1.0 and float(out["metric_scaling_factor"][0]) > 0,
              f"{at}: confidence or scale")
        rec.update(metric_scaling_factor=float(out["metric_scaling_factor"][0]),
                   mask_share=float(out["mask"].mean()))
        return rec
    if name == "stream3r":
        check(out["world_points"].shape == (*hw, 3) and out["world_points_conf"].min() >= 1.0,
              f"{at}: world points")
    else:
        check(out["depth_conf"].shape == hw and out["depth_conf"].min() >= 1.0,
              f"{at}: confidence")
    check(out["pose_enc"].shape == (9,), f"{at}: pose_enc")
    rec["pose_enc"] = out["pose_enc"].tolist()
    return rec


def set_attention_route(modules, impl) -> None:
    """Every attention of ``modules`` that has a route (the ViTs' and VGGT's
    RoPE attention) to ``impl`` ("xla": the plain route; "auto": the
    kernels)."""
    for module in modules:
        for m in module.modules():
            if hasattr(m, "attn_impl"):
                m.attn_impl = impl


def on_card_routes(name, pipe, frames):
    """The three routes on the kernel route's own model (no rebuild, and no
    host copy of DINOv3 vit7b16): the kernel route (the pipeline and its
    engines), then the plain route (its attention switched to "xla") and the
    fp32 route (its bf16 weights cast to fp32 in place, and back after: exact
    both ways), each an eager forward. Returns {frame: [kernel, plain,
    fp32]}."""
    import gc

    import torch

    fam = FAMILIES[name]
    models = [pipe.model] + ([pipe.prior] if fam.get("pair") else [])

    def eager_outputs(frame):
        frames_in = frame if fam.get("pair") else (frame,)
        dev = [torch.from_numpy(f).to(pipe.device) for f in frames_in]
        if fam.get("pair"):
            out = pipe._run(*dev)
        else:
            out = pipe._run(dev[0], frame.shape[:2], False)
        return {k: out[k].float().cpu().numpy()
                for k in (*fam["held"], *fam.get("recorded", ()))}

    routes = {k: [family_outputs(name, pipe, f)] for k, f in frames.items()}
    drop_engines(pipe)
    set_attention_route(models, "xla")
    for k, f in frames.items():
        routes[k].append(eager_outputs(f))
    set_attention_route(models, "auto")
    for m in models:
        m.float()
    for k, f in frames.items():
        routes[k].append(eager_outputs(f))
    for m in models:
        m.to(torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    return routes


# weighted_procrustes on the card, on a known rigid motion of as many points as
# Align3R's pose step fits (512^2), uneven weights: eager and through an engine
# (its Jacobi eigen-solve in the captured graph), against the motion and the CPU
PROCRUSTES_TOL = 1e-4


def check_procrustes(dev):
    import numpy as np
    import torch

    from monocular_depth_estimation_trt_tpu_torch.ops.procrustes import weighted_procrustes
    from monocular_depth_estimation_trt_tpu_torch.runtime.engine import Engine

    rng = np.random.default_rng(15)
    q = rng.standard_normal(4)
    w_, x, y, z = q / np.linalg.norm(q)
    rot = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w_ * z), 2 * (x * z + w_ * y)],
                    [2 * (x * y + w_ * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w_ * x)],
                    [2 * (x * z - w_ * y), 2 * (y * z + w_ * x), 1 - 2 * (x * x + y * y)]])
    trans = rng.standard_normal(3)
    src = rng.standard_normal((1, 512 * 512, 3)) * [2.0, 1.0, 0.5] + [0.0, 0.0, 4.0]
    cases = {"rigid": src @ rot.T + trans,
             "mirrored": (src @ rot.T + trans) * [1.0, 1.0, -1.0]}
    weights = rng.uniform(0.0, 2.0, (1, 512 * 512))
    rec = {"phase": "procrustes", "points": 512 * 512, "cases": {}}
    for case, dst in cases.items():
        args = [torch.from_numpy(a.astype(np.float32)) for a in (src, dst, weights)]
        cpu_r, cpu_t = weighted_procrustes(*args)
        eng = Engine(weighted_procrustes, [a.to(dev) for a in args], name=f"procrustes_{case}")
        eager_r, eager_t = weighted_procrustes(*(a.to(dev) for a in args))
        graph_r, graph_t = eng(*(a.to(dev) for a in args))
        got = {"eager_vs_cpu": max(rel(eager_r.cpu().numpy(), cpu_r.numpy()),
                                   rel(eager_t.cpu().numpy(), cpu_t.numpy())),
               "graph_equal_to_eager": bool(torch.equal(graph_r, eager_r)
                                            and torch.equal(graph_t, eager_t)),
               "det": float(np.linalg.det(graph_r.cpu().double().numpy()[0]))}
        if case == "rigid":
            got["vs_motion"] = max(rel(graph_r.cpu().numpy()[0], rot),
                                   rel(graph_t.cpu().numpy()[0], trans))
        rec["cases"][case] = got
        eng.release()
    emit(rec)
    for case, got in rec["cases"].items():
        check(got["eager_vs_cpu"] < PROCRUSTES_TOL and got["graph_equal_to_eager"]
              and abs(got["det"] - 1.0) < PROCRUSTES_TOL, f"procrustes {case}: {got}")
    check(rec["cases"]["rigid"]["vs_motion"] < PROCRUSTES_TOL,
          f"procrustes: off the known motion {rec['cases']['rigid']}")


# The KV-cache stream (STream3R's session: camera and point head) at full
# size: a window of 4 views, 8 steps, so that the ring wraps. Steps 1 to 4
# against the causal joint model on those 4 views, both bf16: the two differ
# in how the masked global attention reduces (over the 4-view cache, padded
# with masked slots, against the joint sequence) and in K2's frame attention
# at batch 1 against batch 4, which 24 blocks of bf16 carry to the outputs.
STREAM_WINDOW, STREAM_STEPS = 4, 8
# First card run: depth 4.7e-2, confidence 2.9e-2, points 4.7e-2, their
# confidence 1.7e-2 at most over steps 1-4; the pose at step 4 (over the same
# 4 camera tokens) 0.0. Bars about twice those.
STREAM_JOINT_REL_TOL = {"depth": 1e-1, "depth_conf": 6e-2, "world_points": 1e-1,
                        "world_points_conf": 4e-2, "pose_enc": 1e-2}


def run_stream_phase(stream3r, streamvggt, wrappers, rng):
    """STream3R's session and StreamVGGT's ``stream`` runner on the card, with
    the counts set to 0 just before and read just after: one engine per
    session (2 warm-up steps and the captured one, the state put back), then
    every step a replay (no launch counted). Step times (host clock around
    each step, synchronised) at steps 1-4 and 5-8; every step's outputs
    against the eager step on a fresh cache (bit for bit, else within
    ENGINE_REL_TOL, recorded); steps 1-4 against the causal joint model.
    Returns the counts and the session."""
    import numpy as np
    import torch

    from monocular_depth_estimation_trt_tpu_torch.ops.preprocess import preprocess_pad_square

    hw = (480, 640)
    frames = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(STREAM_STEPS)]
    sess = stream3r.stream_session(STREAM_WINDOW)
    runner = streamvggt.stream(STREAM_WINDOW)

    set_counts_to_zero(wrappers)
    _, per = run_counted(lambda: sess.engine_for(hw), lambda: sess.engine_for(hw), wrappers,
                         "stream3r step engine")
    check(int(sess.steps) == 0, f"stream3r: {int(sess.steps)} steps after the engine build")
    times, outs = [], []
    for f in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(sess.step(f))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    after_steps = counts(wrappers)
    vggt_outs, vggt_per = [], None
    for i, f in enumerate(frames[:STREAM_WINDOW + 1]):
        if i == 0:
            out, vggt_per = run_counted(lambda: runner(f), lambda: runner.session.engine_for(hw),
                                        wrappers, "streamvggt stream step")
        else:
            out = runner(f)
        vggt_outs.append(out)
    torch.cuda.synchronize()
    launches = launch_record(wrappers)
    check(per == vggt_per == [0, 24, 24, 0],
          f"stream step launches [K3, K1, K2, K4]: stream3r {per}, streamvggt {vggt_per}")
    check(after_steps == [(WARMUP_CALLS + 1) * n for n in per],
          f"stream3r: launches after {STREAM_STEPS} steps {after_steps}: a step went through "
          "a wrapper")
    check(launches == {k: 2 * (WARMUP_CALLS + 1) * n for k, n in zip(KERNELS, per)},
          f"launches on the stream phase {launches}")
    check(int(sess.steps) == STREAM_STEPS, f"stream3r: {int(sess.steps)} steps")

    # the eager steps on a fresh cache, and the causal joint model
    dev = stream3r.device
    cache = sess.model.init_cache(1, (37, 37), next(sess.model.parameters()).dtype, dev)
    replay = {"equal": [], "max_rel": []}
    with torch.inference_mode():
        for f, got in zip(frames, outs):
            ref, _ = sess.pure_step(torch.from_numpy(f).to(dev), cache)
            for k in got:
                replay["equal"].append(bool(torch.equal(got[k], ref[k])))
                a, b = got[k].float(), ref[k].float()
                replay["max_rel"].append(float((a - b).abs().max() / b.abs().max()))
        views = preprocess_pad_square(torch.from_numpy(np.stack(frames[:STREAM_WINDOW])).to(dev),
                                      stream3r.spec.input_hw[0])[None]
        joint = stream3r.model(views)
    vs_joint = {k: [rel(outs[s_][k].float().cpu().numpy(), joint[k][0, s_].float().cpu().numpy())
                    for s_ in (range(STREAM_WINDOW) if k != "pose_enc" else [STREAM_WINDOW - 1])]
                for k in STREAM_JOINT_REL_TOL}
    finite = all(bool(torch.isfinite(v).all()) for o in outs for v in o.values())
    rec = {"phase": "stream", "model": stream3r.spec.artifact_name(), "window": STREAM_WINDOW,
           "steps": STREAM_STEPS, "frame": list(hw),
           "launches_per_step_k3_k1_k2_k4": {"stream3r": per, "streamvggt": vggt_per},
           "launches": launches, "counted": f"{WARMUP_CALLS} warm-up + 1 captured step per "
                                            "session; steps after it are replays",
           "step_ms": times, "step_p50_ms_steps_1_to_4": float(np.median(times[:4])),
           "step_p50_ms_steps_5_to_8": float(np.median(times[4:])),
           "replay_equal_to_eager": all(replay["equal"]),
           "replay_vs_eager_max_rel": max(replay["max_rel"]),
           "bf16_stream_vs_causal_joint_rel": vs_joint,
           "stream_vs_causal_joint_tolerance": STREAM_JOINT_REL_TOL,
           "streamvggt_depth_shapes": [list(o["depth"].shape) for o in vggt_outs],
           "card": torch.cuda.get_device_name(0)}
    emit(rec)
    check(finite, "stream3r: a step's outputs not finite")
    check(all(o["viz"].shape == (*hw, 3) and bool(np.isfinite(o["depth"]).all())
              for o in vggt_outs), "streamvggt stream: outputs")
    check(rec["replay_equal_to_eager"] or rec["replay_vs_eager_max_rel"] <= ENGINE_REL_TOL,
          f"stream: replay vs eager max rel {rec['replay_vs_eager_max_rel']}")
    for k, readings in vs_joint.items():
        check(max(readings) < STREAM_JOINT_REL_TOL[k],
              f"stream3r {k}: steps vs the causal joint model {readings}")
    return launches, sess, frames[0]


def run_reconstruct(pipe, wrappers, rng):
    """MapAnything's joint pass over 4 views (``reconstruct``) with its own
    counts; then its engine against the eager forward. Returns the counts."""
    import numpy as np

    views, other = (rng.integers(0, 256, (4, 518, 518, 3), dtype=np.uint8) for _ in range(2))
    set_counts_to_zero(wrappers)
    out, per = run_counted(lambda: pipe.reconstruct(views),
                           lambda: pipe.reconstruct_engine(4, (518, 518)), wrappers,
                           "map_anything reconstruct s4")
    launches = launch_record(wrappers)
    check(per == [0, 24, 48, 0], f"map_anything reconstruct S=4 launches {per}")
    check(out["pts3d"].shape == (1, 4, 518, 518, 3) and out["camera_poses"].shape == (1, 4, 4, 4),
          f"reconstruct shapes {out['pts3d'].shape}")
    check(all(bool(np.isfinite(v).all()) for v in out.values() if v.dtype != np.bool_),
          "reconstruct outputs not finite")
    emit({"phase": "map_anything_reconstruct", "views": 4, "launches_per_forward_k3_k1_k2_k4": per,
          "launches": launches, "metric_scaling_factor": float(out["metric_scaling_factor"][0]),
          "depth_z_range": [float(out["depth_z"].min()), float(out["depth_z"].max())]})
    check_engine("map_anything_reconstruct_s4", pipe, pipe.reconstruct_engine(4, (518, 518)),
                 pipe._views_forward, views, other, per, wrappers)
    return launches


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
    bf16, at ViT-L's qkv and fc2 and Depth Pro's fc1 and fc2 in fp32, and
    at edge shapes M in (1, 17, 130), K in (32, 40, 96),
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
        ("vitl_fc2_fp32", 1370, 4096, 1024, torch.float32),
        ("depth_pro_fc1_fp32", 20195, 1024, 4096, torch.float32),
        ("depth_pro_fc2_fp32", 20195, 4096, 1024, torch.float32),
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
    if name == "map_anything":
        from monocular_depth_estimation_trt_tpu_torch.models.map_anything import MapAnything

        return dict(
            make=MapAnything,
            build=lambda precision, sd: build_pipeline(
                "map_anything", precision=precision, params=sd, calib_images=calib),
            run=lambda p, frame: {k: p(frame)[k] for k in ("depth", "conf")},
            per_forward=[0, 24, 48, 288], pearson_keys=("depth",))
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
    Returns the pipeline and the counts; the seed-0 state dict stays in
    ``fam`` for ``int8_parity`` (the load copies it)."""
    import numpy as np
    import torch

    from monocular_depth_estimation_trt_tpu_torch.ops.quant import QuantLinear

    fam["weights_seed_0"] = seeded(fam["make"], 0).state_dict()
    t0 = time.perf_counter()
    pipe = fam["build"]("int8", fam["weights_seed_0"])
    build_s = time.perf_counter() - t0
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


    readings = []
    for seed in PARITY_WEIGHT_SEEDS:
        # seed 0: the path's own weights, made once
        sd = fam.pop("weights_seed_0") if seed == 0 else seeded(fam["make"], seed).state_dict()
        int8 = path_pipe if seed == 0 else fam["build"]("int8", sd)
        bf16, fp32 = fam["build"]("bf16", sd), fam["build"]("fp32", sd)
        for frame_name, frame in frames.items():
            q, b, f = (fam["run"](p, frame) for p in (int8, bf16, fp32))
            rec = {"phase": "int8_parity", "model": name, "weights_seed": seed,
                   "frame": frame_name}
            for k in q:
                rec[k] = {"int8_vs_fp32_rel": rel(q[k], f[k]),
                          "int8_vs_fp32_p999": p999_rel(q[k], f[k]),
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
    p999_held = INT8_P999_TOL.get(name, {})
    ratio = {k: sum(r[k]["int8_vs_fp32_rel"] for r in readings)
             / sum(r[k]["bf16_vs_fp32_rel"] for r in readings) for k in keys}
    emit({"phase": "int8_parity_summary", "model": name, "readings": len(readings),
          **{k: {"max_int8_vs_fp32_rel": max(r[k]["int8_vs_fp32_rel"] for r in readings),
                 "max_bf16_vs_fp32_rel": max(r[k]["bf16_vs_fp32_rel"] for r in readings),
                 "min_int8_vs_fp32_pearson": min(
                     (r[k].get("int8_vs_fp32_pearson", 1.0) for r in readings)),
                 "max_int8_vs_fp32_p999": max(r[k]["int8_vs_fp32_p999"] for r in readings),
                 "int8_over_bf16_route_vs_fp32": ratio[k],
                 **({"int8_vs_fp32_p999_tolerance": p999_held[k],
                     "int8_over_bf16_route_tolerance": INT8_ROUTE_RATIO} if k in p999_held
                    else {"int8_vs_fp32_rel_tolerance": INT8_REL_TOL[name][k]})}
             for k in keys},
          "pearson_tolerance": INT8_PEARSON_MIN})
    for r in readings:
        at = f"seed {r['weights_seed']} {r['frame']}"
        for k in keys:
            check(bool(np.isfinite(r[k]["int8_vs_fp32_rel"])), f"{name} int8 {k} ({at})")
            got = r[k].get("int8_vs_fp32_pearson")
            check(got is None or got > INT8_PEARSON_MIN,
                  f"{name} int8 {k}: Pearson r {got} against fp32 ({at})")
            if k in p999_held:
                got = r[k]["int8_vs_fp32_p999"]
                check(got < p999_held[k], f"{name} int8 {k} vs fp32 99.9th percentile {got} ({at})")
            else:
                got = r[k]["int8_vs_fp32_rel"]
                check(got < INT8_REL_TOL[name][k], f"{name} int8 {k} vs fp32 rel {got} ({at})")
    for k in p999_held:
        check(ratio[k] <= INT8_ROUTE_RATIO,
              f"{name} int8 {k}: {ratio[k]} x the bf16 route's distance from fp32, over "
              f"{len(readings)} readings")


# the speed readings' turns (eager, graph, graph, eager until the script
# outgrew its time limit)
ROUTE_TURNS = ("eager", "graph")
# calls of each eager forward that torch.profiler reads (2 or 3 until the
# script outgrew its time limit: the profiler's own host time grows with
# the eager forward's events)
EAGER_PROFILE_CALLS = 1


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

    from monocular_depth_estimation_trt_tpu_torch.pipelines import PairPipeline
    from monocular_depth_estimation_trt_tpu_torch.runtime.benchmark import benchmark

    if route == "graph":
        return pipe.benchmark_views(views, config) if views else pipe.benchmark(in_hw, config)
    rng = np.random.default_rng(0)
    if isinstance(pipe, PairPipeline):  # two pinned frames in, the depth out
        frames = [torch.from_numpy(rng.integers(0, 255, (*in_hw, 3), dtype=np.uint8)).pin_memory()
                  for _ in range(2)]
        depth = pipe._run(*(f.to(pipe.device) for f in frames))["depth"]
        host_out = torch.empty(depth.shape, dtype=depth.dtype).pin_memory()

        def step():
            dev = [f.to(pipe.device, non_blocking=True) for f in frames]
            host_out.copy_(pipe._run(*dev)["depth"], non_blocking=True)
    elif views:
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
                         else f"H2D uint8 {in_hw[0]}x{in_hw[1]}"
                              + (" x 2 (a pair)" if pipe.spec.model == "align3r" else "")
                              + " + forward + D2H "
                              + ("every output" if pipe.spec.model == "geocalib" else "depth")),
            "card": card, "power_limit": power_limit}


def fp32_vitl_speed(build_pipeline, vitl, wrappers, frame, config, card, power_limit):
    """DA-V2 vitl at 518^2 with precision="fp32" (TF32 off), on the bf16
    ``vitl`` pipeline's weights (no second random build): one forward
    through a new engine with the counts set to 0 just before and read just
    after (24 fp32 K1 a forward), then the captured graph's speed and its
    device time by kernel. Returns the launch record."""
    import torch

    sd = {k: v.float().cpu() for k, v in vitl.model.state_dict().items()}
    pipe = build_pipeline("depth_anything_v2", encoder="vitl", precision="fp32", params=sd)
    del sd
    check(pipe.spec.precision == "fp32", f"vitl fp32 built {pipe.spec.precision}")
    set_counts_to_zero(wrappers)
    _, per = run_counted(lambda: pipe(frame), lambda: pipe.engine_for(frame.shape[:2]), wrappers,
                         "vitl fp32")
    torch.cuda.synchronize()
    launches = launch_record(wrappers)
    check(per == [0, 24, 0, 0], f"vitl fp32: K3, K1, K2, K4 launches {per}, want [0, 24, 0, 0]")
    emit({"phase": "fp32_path", "model": pipe.spec.artifact_name(), "frame": "518x518",
          "launches_per_forward": per, "launches": launches,
          "counted": f"{WARMUP_CALLS} warm-up + 1 captured"})
    rep = timed_route(pipe, "graph", (518, 518), 0, config)
    emit({**speed_record(rep, pipe, "vitl_fp32", "graph", 0, 0, (518, 518), card, power_limit),
          "launches_per_forward": per})
    eng, arg = pipe.engine_for((518, 518)), torch.from_numpy(frame).to(pipe.device)
    emit({**profile_breakdown(lambda: eng(arg), pipe.spec.artifact_name(), 3), "route": "graph"})
    drop_engines(pipe)
    return launches


def finite_or_none(x: float):
    return x if math.isfinite(x) else None


def recorded_value(a):
    """A recorded output for JSON: a scalar (None if not finite) or a list."""
    import numpy as np

    a = np.asarray(a)
    return finite_or_none(float(a)) if a.size == 1 else a.tolist()


def check_engine(label, pipe, engine, eager, arg, other, want, wrappers):
    """One engine against the eager forward it captures: the eager forward's
    launches [K3, K1, K2, K4] equal the captured forward's and ``want``; the
    capture's output buffers are filled with NaN before the first replay,
    whose outputs are finite and equal the eager forward's bit for bit (or,
    where a library call picks another algorithm under capture, within
    ENGINE_REL_TOL, recorded); a result survives the next call on another
    input (``arg``, ``other``: a frame, or a tuple of frames)."""
    import numpy as np
    import torch

    args, others = (a if isinstance(a, tuple) else (a,) for a in (arg, other))
    before = counts(wrappers)
    with torch.inference_mode():
        ref = eager(*(torch.from_numpy(a).to(pipe.device) for a in args))
    torch.cuda.synchronize()
    eager_launches = [a - b for a, b in zip(counts(wrappers), before)]
    engine.compile()
    with torch.inference_mode():
        for t in engine.static_outputs().values():
            if t.is_floating_point():
                t.fill_(float("nan"))
    out = engine(*(torch.from_numpy(a) for a in args))
    kept = {k: v.clone() for k, v in out.items()}
    second = engine(*(torch.from_numpy(a) for a in others))
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


def cli_group_start(commands, env):
    """Start one process of its own that runs each argv of ``commands``
    through the command line's ``main``, in order (the commands of one
    process share its start-up: importing torch and loading the kernels'
    library); its ``subprocess.Popen``, for ``cli_group_result``."""
    # each command's pipeline and graphs are freed before the next command
    code = ("import gc\nimport time\nimport torch\n"
            "print('@@ cuda', torch.cuda.is_available(), torch.cuda.device_count(), flush=True)\n"
            "from monocular_depth_estimation_trt_tpu_torch.cli import main\n"
            f"for argv in {[list(c) for c in commands]!r}:\n"
            "    print('@@ command', flush=True)\n"
            "    t0 = time.perf_counter()\n"
            "    rc = main(argv)\n"
            "    print('@@ exit', rc, time.perf_counter() - t0, flush=True)\n"
            "    gc.collect()\n"
            "    torch.cuda.empty_cache()\n")
    # files, not pipes: nothing reads the output until the commands end, and
    # a full pipe would stall them
    logs = tuple(tempfile.TemporaryFile("w+") for _ in range(2))
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                            stdout=logs[0], stderr=logs[1], text=True)
    proc.logs = logs
    return proc


def cli_group_result(proc, commands):
    """Wait for a process of ``cli_group_start`` (killed after 900 s).
    Returns each command's stdout and its seconds (the process's clock
    around its ``main``) by its argv tuple, and the exit codes; what the
    process printed before its first command (``@@ cuda <available>
    <count>``) is left in ``proc.preamble``."""
    try:
        proc.wait(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    for log in proc.logs:
        log.seek(0)
    stdout, stderr = (log.read() for log in proc.logs)
    proc.preamble, *parts = stdout.split("@@ command\n")
    check(proc.returncode == 0 and len(parts) == len(commands),
          f"cli {[c[:2] for c in commands]} exited {proc.returncode}: {stdout[-1500:]}"
          f"{stderr[-2500:]}")
    ends = [p.rsplit("@@ exit ", 1)[1].split() for p in parts]
    return ({tuple(c): (p, float(e[1])) for c, p, e in zip(commands, parts, ends)},
            [int(e[0]) for e in ends])


CLI_SEED = 10  # the cli phase's frames: a generator of their own


def stop_process(proc) -> None:
    """Kill ``proc`` where it still runs (registered with ``atexit`` for a
    process that outlives the phase that started it, when a check fails in
    between)."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def cli_phase(pipe, vggt, depth_pro, moge, unidepth, geocalib, align3r):
    """A generator in two parts. The first ``next`` writes the inputs and
    starts the processes; the int8 phases run while they work (correctness
    only, no timing: the commands' bit-for-bit checks hold under any load).
    The second reads and checks what they wrote.

    The command line's commands, in one process of their own
    (``cli_group_start``; each record's seconds are its command's): ``run`` of
    DA-V2 vits on a seeded 480x640 PNG with ``--pointcloud --benchmark``
    (its npz depth equal to this
    process's pipeline on the same frame, bit for bit; the viz and the
    ``.ply`` written), ``views vggt`` on 4 PNGs, ``run depth_pro`` on
    weights saved from this process's (``_fov.json`` against its f_px),
    ``run moge2 --mesh --mesh-format glb`` on this process's MoGe-2 weights
    (every npz output equal to its pipeline's bit for bit, the ``.glb`` mesh
    written), ``run unidepth_v2`` (the npz's points, confidence and
    intrinsics equal to the pipeline's, ``_fov.json`` from the intrinsics)
    and ``run geocalib`` (the Roll / Pitch / vFoV / Focal lines and the npz
    of every output, equal to the pipeline's) on this process's weights;
    ``pair align3r`` on two seeded PNGs (the PLY's points and colors and the
    pose JSON equal to this process's Align3R on the same seeded random
    weights); then ``video_commands``. Meanwhile ``python -m
    monocular_depth_estimation_trt_tpu_torch models``, as a user starts the
    package, lists the registry with the video families."""
    import math
    import shutil

    import numpy as np
    import torch

    from monocular_depth_estimation_trt_tpu_torch.apps.ply import read_ply
    from monocular_depth_estimation_trt_tpu_torch.utils import imageio

    import atexit

    tmp = tempfile.mkdtemp(prefix="mdet_cli_")
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    rng = np.random.default_rng(CLI_SEED)

    outputs = {}

    def cli(*argv):
        """A command's stdout and its seconds."""
        return outputs[argv]

    def only(directory, suffix):
        found = [f for f in os.listdir(directory) if f.endswith(suffix)]
        check(len(found) == 1, f"cli: want one *{suffix} in {sorted(os.listdir(directory))}")
        return os.path.join(directory, found[0])

    try:
        frame = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
        png = os.path.join(tmp, "frame.png")
        imageio.write_image(png, frame)
        check(np.array_equal(imageio.read_image(png), frame), "cli: the PNG round trip")
        views = rng.integers(0, 256, (4, 518, 518, 3), dtype=np.uint8)
        pngs = []
        for i, v in enumerate(views):
            pngs.append(os.path.join(tmp, f"view{i}.png"))
            imageio.write_image(pngs[-1], v)
        # pair: two PNGs on seeded random weights, as this process's Align3R
        pair_rng = np.random.default_rng(13)
        pair_pngs = []
        for i in range(2):
            pair_pngs.append(os.path.join(tmp, f"pair{i}.png"))
            imageio.write_image(pair_pngs[-1], pair_rng.integers(0, 256, (480, 640, 3), np.uint8))
        ckpts = {}
        for name, p in (("depth_pro", depth_pro), ("moge2", moge), ("unidepth_v2", unidepth),
                        ("geocalib", geocalib)):
            ckpts[name] = os.path.join(tmp, f"{name}.pth")
            torch.save({k: v.detach().cpu() for k, v in p.model.state_dict().items()},
                       ckpts[name])
        out_run, out_views = os.path.join(tmp, "run"), os.path.join(tmp, "views")
        out_pair, out_dp = os.path.join(tmp, "pair"), os.path.join(tmp, "depth_pro")
        out_moge = os.path.join(tmp, "moge2")
        run_cmd_argv = ("run", "depth_anything_v2", "--encoder", "vits", "--image", png,
                        "--out", out_run, "--pointcloud", "--allow-random-weights", "--benchmark")
        views_argv = ("views", "vggt", "--images", *pngs, "--out", out_views,
                      "--allow-random-weights")
        pair_argv = ("pair", "align3r", "--image1", pair_pngs[0], "--image2", pair_pngs[1],
                     "--out", out_pair, "--allow-random-weights")
        dp_argv = ("run", "depth_pro", "--image", png, "--out", out_dp, "--checkpoint",
                   ckpts["depth_pro"])
        moge_argv = ("run", "moge2", "--image", png, "--out", out_moge, "--checkpoint",
                     ckpts["moge2"], "--mesh", "--mesh-format", "glb")
        family_argv = {name: ("run", name, "--image", png, "--out", os.path.join(tmp, name),
                              "--checkpoint", ckpts[name]) for name in ("unidepth_v2", "geocalib")}
        commands = [run_cmd_argv, views_argv, pair_argv, dp_argv, moge_argv,
                    *family_argv.values()]
        meshes = mesh_commands(tmp, png, pngs)
        videos = video_commands(tmp)
        flows = flow_commands(tmp)
        track_slam = track_slam_commands(tmp)
        listing = subprocess.Popen([sys.executable, "-m", "monocular_depth_estimation_trt_tpu_torch",
                                    "models"], cwd=REPO, env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
        group_argvs = commands + videos + flows + track_slam + meshes
        group = cli_group_start(group_argvs, env)
        for proc in (listing, group):
            atexit.register(stop_process, proc)
        yield
        try:
            outputs, rcs = cli_group_result(group, group_argvs)
        finally:
            listed, listing_err = listing.communicate(timeout=120)
        names = [ln.split()[0] for ln in listed.splitlines() if ln.strip()]
        emit({"phase": "cli", "command": "python -m monocular_depth_estimation_trt_tpu_torch "
                                         "models", "exit_code": listing.returncode,
              "models": len(names)})
        check(listing.returncode == 0
              and {"video_depth_anything", "flashdepth", *FLOW_MODELS, "cotracker3", "megasam",
                   "vipe", "wildgs_slam"} <= set(names),
              f"python -m ... models exited {listing.returncode}: {listed[-800:]}"
              f"{listing_err[-1500:]}")
        check(rcs[:len(commands)] == [0] * len(commands),
              f"cli {[c[:2] for c in commands]}: exit codes {rcs}")

        stdout, run_s = cli(*run_cmd_argv)
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

        _, views_s = cli(*views_argv)
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

        _, dp_s = cli(*dp_argv)
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

        _, moge_s = cli(*moge_argv)
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
            out_dir = os.path.join(tmp, name)
            stdout, took = cli(*family_argv[name])
            got = np.load(only(out_dir, ".npz"))
            ours = {k: v for k, v in p(frame).items() if k != "viz"}
            rec = {"phase": "cli", "command": f"run {name} (this process's weights)",
                   "seconds": took, "files": sorted(os.listdir(out_dir)),
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

        _, pair_s = cli(*pair_argv)
        frames = [imageio.read_image(p) for p in pair_pngs]
        ours = align3r(*frames)
        pts, cols = read_ply(only(out_pair, ".ply"))
        pose = json.load(open(only(out_pair, "_pose.json")))
        side = ours["depth"].shape[0]
        rec = {"phase": "cli", "command": "pair align3r (seeded random weights)",
               "seconds": pair_s, "files": sorted(os.listdir(out_pair)),
               "ply_points": int(pts.shape[0]),
               "points_equal_in_process": bool(np.array_equal(pts, np.concatenate(
                   [ours["pts1"].reshape(-1, 3), ours["pts2"].reshape(-1, 3)]))),
               "colors_equal": bool(np.array_equal(cols, np.concatenate(
                   [imageio.resize(f, (side, side)).reshape(-1, 3) for f in frames]))),
               "pose_equal_in_process": pose == {"rotation": ours["rotation"].tolist(),
                                                 "translation": ours["translation"].tolist()},
               "pose": pose}
        emit(rec)
        check(rec["points_equal_in_process"] and rec["colors_equal"]
              and rec["pose_equal_in_process"], "cli pair: PLY or pose differs from the "
                                                "pipeline's")
        check(any(f.endswith((".jpg", ".png")) for f in rec["files"]), "cli pair: no depth image")
        check_video_commands(tmp, [outputs[c] for c in videos],
                             rcs[len(commands):len(commands) + len(videos)])
        flow_at = len(commands) + len(videos)
        check_flow_command(tmp, outputs[flows[0]], rcs[flow_at])
        check_track_slam_commands(tmp, [outputs[c] for c in track_slam],
                                  rcs[flow_at + 1:flow_at + 1 + len(track_slam)])
        check_mesh_commands(tmp, [outputs[c] for c in meshes], rcs[-len(meshes):])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


VIDEO_FIXTURE = ("data/example_video.mp4", 16, 288, 512)  # path, frames, height, width


def video_commands(tmp):
    """``video video_depth_anything``, ``video flashdepth`` and ``batch
    depth_anything_v2 --video`` on the repository's 16-frame 512x288 MP4, on
    seeded random weights: their argvs, for ``cli_group_start``."""
    fixture = os.path.join(REPO, VIDEO_FIXTURE[0])
    out_video, out_batch = os.path.join(tmp, "video"), os.path.join(tmp, "batch")
    return [("video", "video_depth_anything", "--video", fixture, "--out", out_video,
             "--allow-random-weights"),
            ("video", "flashdepth", "--video", fixture, "--out", out_video,
             "--allow-random-weights"),
            ("batch", "depth_anything_v2", "--video", fixture, "--out", out_batch, "--batch", "4",
             "--save", "--allow-random-weights")]


def check_video_commands(tmp, outputs, rcs):
    """The video commands' results: where cv2 imports, each MP4 written with
    the source's frame count and size, and ``batch`` the depth of every
    extracted frame; where it does not, each command exited non-zero naming
    the missing codec. ``outputs``: each command's stdout and seconds."""
    import numpy as np

    from monocular_depth_estimation_trt_tpu_torch.utils import imageio

    _, n, h, w = VIDEO_FIXTURE
    out_video, out_batch = os.path.join(tmp, "video"), os.path.join(tmp, "batch")
    rec = {"phase": "cli", "command": "video video_depth_anything, video flashdepth, batch "
                                      "depth_anything_v2 --video (one process)",
           "seconds": [sec for _, sec in outputs], "exit_codes": rcs,
           "cv2_importable": imageio.jpeg_available()}
    if not imageio.jpeg_available():
        named = "".join(out for out, _ in outputs).count("video (MP4/mp4v) needs the cv2 (OpenCV) codec")
        emit({**rec, "codec_named": named})
        check(rcs == [1, 1, 1] and named == 3, f"cli video commands without cv2: {rcs}, the "
                                               f"codec named {named} times")
        return
    cv2 = imageio.video_cv2("the written MP4s")
    mp4s = {}
    for f in sorted(os.listdir(out_video)):
        cap = cv2.VideoCapture(os.path.join(out_video, f))
        frames = 0
        while cap.read()[0]:
            frames += 1
        mp4s[f] = {"frames": frames, "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                   "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))}
        cap.release()
    depths = [np.load(os.path.join(out_batch, f))["depth"]
              for f in sorted(os.listdir(out_batch)) if f.endswith(".npz")]
    rec.update(mp4s=mp4s, batch_frames=len(os.listdir(os.path.join(out_batch, "_frames"))),
               batch_depths=len(depths), batch_depth_shape=list(depths[0].shape) if depths else None)
    emit(rec)
    check(rcs == [0, 0, 0], f"cli video commands: exit codes {rcs}")
    check(sorted(mp4s) == sorted(f"example_video_{m}.mp4" for m in (
        "video_depth_anything_vits_518x518_bf16", "flashdepth_vits_518x518_bf16"))
          and all(v == {"frames": n, "width": w, "height": h} for v in mp4s.values()),
          f"cli video: {mp4s}")
    check(rec["batch_frames"] == len(depths) == n
          and all(d.shape == (518, 518) and bool(np.isfinite(d).all()) for d in depths),
          f"cli batch --video: {rec['batch_frames']} frames, {len(depths)} depths")


FLOW_CLI_FRAMES = 3  # 288x512 PNGs: 2 pairs


def flow_commands(tmp):
    """``flow raft`` on FLOW_CLI_FRAMES seeded 288x512 PNGs, on seeded random
    weights: its argv, for ``cli_group_start``."""
    import numpy as np

    from monocular_depth_estimation_trt_tpu_torch.utils import imageio

    frames_dir = os.path.join(tmp, "flow_frames")
    os.makedirs(frames_dir)
    gen = np.random.default_rng(19)
    for i in range(FLOW_CLI_FRAMES):
        imageio.write_image(os.path.join(frames_dir, f"frame_{i:05d}.png"),
                            gen.integers(0, 256, (288, 512, 3), dtype=np.uint8))
    return [("flow", "raft", "--frames", frames_dir, "--out", os.path.join(tmp, "flow"),
             "--allow-random-weights")]


def check_flow_command(tmp, output, rc):
    """``flow raft``: where cv2 imports, ``raft_flow.mp4`` of one frame a
    pair at 512x288; where it does not, exit 1 naming the codec."""
    from monocular_depth_estimation_trt_tpu_torch.utils import imageio

    stdout, seconds = output
    rec = {"phase": "cli", "command": f"flow raft ({FLOW_CLI_FRAMES} frames)", "seconds": seconds,
           "exit_code": rc, "cv2_importable": imageio.jpeg_available()}
    if not imageio.jpeg_available():
        named = "needs the cv2 (OpenCV) codec" in stdout
        emit({**rec, "codec_named": named})
        check(rc == 1 and named, f"cli flow without cv2: exit {rc}, codec named {named}")
        return
    cv2 = imageio.video_cv2("the flow MP4")
    cap = cv2.VideoCapture(os.path.join(tmp, "flow", "raft_flow.mp4"))
    frames = 0
    while cap.read()[0]:
        frames += 1
    rec.update(mp4_frames=frames, width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
               height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    cap.release()
    emit(rec)
    check(rc == 0 and (frames, rec["width"], rec["height"]) == (FLOW_CLI_FRAMES - 1, 512, 288),
          f"cli flow raft: {rec}")


def multi_view_serving(families, wrappers, card, power_limit, dev):
    """The multi-view families' engines against their eager forwards, their
    speed in turns eager, graph, and their profile (graph, and
    Align3R's eager forward with the device time of its plain decoder
    attention), right after their route comparisons, so that their models
    (DINOv3 vit7b16's 16 GB among them) are released before the int8 phases;
    Align3R's pipeline stays for the command line."""
    import gc

    import numpy as np
    import torch

    from monocular_depth_estimation_trt_tpu_torch.config import BenchmarkConfig
    from monocular_depth_estimation_trt_tpu_torch.models import align3r as align3r_mod

    engine_rng, profile_rng = np.random.default_rng(12), np.random.default_rng(14)
    for name in [n for n, fam in FAMILIES.items() if fam["group"] == MULTI]:
        fam, p = FAMILIES[name], families[name]
        hw, pair = fam["hw"][1], fam.get("pair", False)

        def frames(gen):
            got = tuple(gen.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(2))
            return got if pair else got[0]

        arg, other = frames(engine_rng), frames(engine_rng)
        check_engine(name, p, p.engine_for(hw), p._forward if pair else p_eager(p, hw), arg,
                     other, fam["per_forward"], wrappers)
        drop_engines(p)
        config = BenchmarkConfig(**fam.get("bench", FAMILY_BENCH))
        for turn, route in enumerate(ROUTE_TURNS):
            rep = timed_route(p, route, hw, 0, config)
            emit(speed_record(rep, p, name, route, turn, 0, hw, card, power_limit))
        drop_engines(p)
        arg = frames(profile_rng)
        args = tuple(torch.from_numpy(a).to(dev) for a in (arg if pair else (arg,)))
        eng = p.engine_for(hw)
        emit({**profile_breakdown(lambda: eng(*args), p.spec.artifact_name(),
                                  3 if name in DINOV3 else 5), "route": "graph"})
        if pair:
            def eager_step():
                with torch.inference_mode():
                    p._forward(*args)

            with annotated(align3r_mod, "decoder_attention"):
                emit({**profile_breakdown(eager_step, p.spec.artifact_name(),
                                          EAGER_PROFILE_CALLS, ranges=("decoder_attention",)),
                      "route": "eager"})
        drop_engines(p)
        if not pair:
            del families[name]
        del p, eng
        gc.collect()
        torch.cuda.empty_cache()


def profile_stream_step(sess, frame, dev):
    """One stream step: its graph replay, and the eager step with the device
    time of its masked cached attention (the 24 global blocks')."""
    import torch

    from monocular_depth_estimation_trt_tpu_torch.models import streamvggt as stream_mod

    host = torch.from_numpy(frame)
    eng = sess.engine_for(tuple(frame.shape[:2]))
    emit({**profile_breakdown(lambda: eng(host), sess.name + "_step", 5), "route": "graph"})
    cache = sess.model.init_cache(1, (37, 37), next(sess.model.parameters()).dtype, dev)
    on_card = host.to(dev)

    def eager_step():
        with torch.inference_mode():
            sess.pure_step(on_card, cache)

    with annotated(stream_mod, "masked_attention"):
        emit({**profile_breakdown(eager_step, sess.name + "_step", EAGER_PROFILE_CALLS,
                                  ranges=("masked_attention",)), "route": "eager"})
    sess.release_engines()


# ---------------------------------------------------------------------------
# the video path: Video Depth Anything, FlashDepth, the int8 stream step
# ---------------------------------------------------------------------------

VDA_WINDOW = 32
VDA_CLIP = (80, 288, 512)  # frames, height, width: windows at 0, 22, 44, 48
VDA_ROUTE_FRAMES = 8  # the route comparisons' window (the model takes any T)
VIDEO_CPU_DEPTH, VIDEO_CPU_TAPS, VIDEO_CPU_FRAMES = 2, (0, 0, 1, 1), 4
FLASHDEPTH_STEPS = 16
# the first frame stepped again after FLASHDEPTH_STEPS frames against its
# step from a zero state, max rel: replays are deterministic (the step after
# reset() equals the first bit for bit), so this is the carried state's
# effect; a state that did not carry reads 0
STATE_MOVED_MIN_REL = 1e-2
INT8_STREAM_STEPS = 8
# the stitched clip against the host stitching re-done here from the
# windows' replays (float64 least squares against video_depth's float32)
STITCH_REL_TOL = 1e-5
VIDEO_BENCH = dict(warmup=2, iterations=8, latency_iterations=4)


@contextlib.contextmanager
def temporal_ranges():
    """The VDA temporal blocks (``forward``) and their attention inside a
    ``record_function`` range each, ``temporal_block`` and
    ``temporal_attention``, while the context lasts."""
    import torch

    from monocular_depth_estimation_trt_tpu_torch.models.video_depth_anything import (
        TemporalAttentionBlock as block,
    )

    fns = {"forward": block.forward, "attention": block.attention}

    def wrap(fn, name):
        def in_range(*args, **kw):
            with torch.profiler.record_function(name):
                return fn(*args, **kw)
        return in_range

    block.forward = wrap(fns["forward"], "temporal_block")
    block.attention = wrap(fns["attention"], "temporal_attention")
    try:
        yield ("temporal_block", "temporal_attention")
    finally:
        block.forward, block.attention = fns["forward"], fns["attention"]


def restitch(windows, starts, window, overlap, n_frames):
    """``video_depth``'s protocol re-done from the windows' depths: each
    window after the first aligned to the stitched frames before it by a
    least-squares scale and shift (``np.linalg.lstsq``) on their overlap,
    then cross-faded there. Returns the clip and the (scale, shift) of each
    window."""
    import numpy as np

    out = np.zeros((n_frames, *windows[0].shape[1:]), np.float64)
    fits, prev_end = [], 0
    for s, d in zip(starts, windows):
        d = d.astype(np.float64)
        if prev_end == 0:
            out[:window] = d
            fits.append((1.0, 0.0))
        else:
            ov = prev_end - s
            x = d[:ov].ravel()
            (a, b), *_ = np.linalg.lstsq(np.stack([x, np.ones_like(x)], 1),
                                         out[s:prev_end].ravel(), rcond=None)
            aligned = a * d + b
            w = np.linspace(0.0, 1.0, ov + 2)[1:-1, None, None]
            out[s:prev_end] = out[s:prev_end] * (1.0 - w) + aligned[:ov] * w
            out[prev_end:s + window] = aligned[ov:]
            fits.append((float(a), float(b)))
        prev_end = s + window
    return out, fits


def run_vda_path(build_pipeline, wrappers, rng, encoder):
    """Video Depth Anything at full width, 518²: a 32-frame window through
    ``video_depth`` (one engine, K1 at (32, 1370, heads)) and, for vits, an
    80-frame 288x512 clip (4 windows, stitched on the host), with the counts
    set to 0 just before and read just after; the window engine against its
    eager forward. Returns the pipeline and the counts."""
    import numpy as np
    import torch

    from monocular_depth_estimation_trt_tpu_torch.models.video_depth_anything import (
        window_starts,
    )

    want = [0, 12 if encoder == "vits" else 24, 0, 0]
    pipe = build_pipeline("video_depth_anything", encoder=encoder)
    video = rng.integers(0, 256, (VDA_WINDOW, 518, 518, 3), dtype=np.uint8)
    clip = rng.integers(0, 256, VDA_CLIP + (3,), dtype=np.uint8) if encoder == "vits" else None
    torch.cuda.synchronize()
    set_counts_to_zero(wrappers)
    t0 = time.perf_counter()
    depth, per = run_counted(lambda: pipe.video_depth(video),
                             lambda: pipe.window_engine((518, 518)), wrappers,
                             f"vda {encoder} window")
    window_s = time.perf_counter() - t0
    rec = {"phase": "video", "path": f"vda_{encoder}_window", "model": pipe.spec.artifact_name(),
           "frames": list(video.shape[:3]), "launches_per_window_k3_k1_k2_k4": per,
           "window_seconds_with_build": window_s}
    if clip is not None:
        t0 = time.perf_counter()
        stitched, clip_per = run_counted(lambda: pipe.video_depth(clip),
                                         lambda: pipe.window_engine(VDA_CLIP[1:]), wrappers,
                                         "vda vits clip")
        rec["clip_seconds_with_build"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = launch_record(wrappers)
    engines = 2 if clip is not None else 1
    check(per == want, f"vda {encoder} window: launches {per}, want {want}")
    check(launches == {k: engines * (WARMUP_CALLS + 1) * n for k, n in zip(KERNELS, want)},
          f"launches on the vda {encoder} path {launches}")
    check(depth.shape == (VDA_WINDOW, 518, 518) and bool(np.isfinite(depth).all())
          and depth.min() >= 0 and depth.max() > depth.min(),
          f"vda {encoder} window depth {depth.shape} {depth.min()} {depth.max()}")
    rec.update(launches=launches, depth_range=[float(depth.min()), float(depth.max())])
    if clip is not None:
        check(clip_per == want, f"vda clip: launches {clip_per}")
        starts = window_starts(VDA_CLIP[0], VDA_WINDOW, pipe.overlap)
        check(starts == [0, 22, 44, 48], f"vda clip: windows at {starts}")
        eng = pipe.window_engine(VDA_CLIP[1:])
        windows = [eng(torch.from_numpy(clip[s:s + VDA_WINDOW]))["depth"].cpu().numpy()
                   for s in starts]
        again, fits = restitch(windows, starts, VDA_WINDOW, pipe.overlap, VDA_CLIP[0])
        stitch_rel = rel(stitched, again)
        rec.update(clip=list(VDA_CLIP), window_starts=starts, scale_shift=fits,
                   stitched_vs_restitched_rel=stitch_rel, stitch_tolerance=STITCH_REL_TOL,
                   clip_depth_shape=list(stitched.shape))
        check(stitched.shape == (VDA_CLIP[0], 518, 518) and bool(np.isfinite(stitched).all()),
              f"vda clip: stitched {stitched.shape}")
        check(np.array_equal(stitched[:22], windows[0][:22]), "vda clip: window 0 moved")
        check(stitch_rel < STITCH_REL_TOL, f"vda clip: stitched vs re-stitched rel {stitch_rel}")
    emit(rec)
    other = rng.integers(0, 256, (VDA_WINDOW, 518, 518, 3), dtype=np.uint8)
    check_engine(f"vda_{encoder}_window32", pipe, pipe.window_engine((518, 518)),
                 pipe._window_forward, video, other, want, wrappers)
    return pipe, launches


def video_route_readings(name, pipe, frames):
    """The bf16 kernel route, the plain route and the fp32 route on the
    kernel route's own model (eager forwards): VDA on a window of
    VDA_ROUTE_FRAMES frames, FlashDepth on one frame from a zero state.
    Returns the three depths."""
    import torch

    def depth():
        x = torch.from_numpy(frames).to(pipe.device)
        with torch.inference_mode():
            if name == "video_depth_anything":
                return pipe._window_forward(x)["depth"].float().cpu().numpy()
            return pipe._run(x, frames.shape[:2], False)["depth"].float().cpu().numpy()

    out = [depth()]
    set_attention_route([pipe.model], "xla")
    out.append(depth())
    set_attention_route([pipe.model], "auto")
    pipe.model.float()
    out.append(depth())
    pipe.model.to(torch.bfloat16)
    return out


def video_parity(build_pipeline, rng):
    """For each video family: the bf16 kernel route against the plain route
    and the fp32 route at PARITY_WEIGHT_SEEDS (max rel < PATH_BF16_REL_TOL at
    every reading; averaged over them, the kernel route's distance from
    fp32 at most PATH_BF16_ROUTE_RATIO times the plain route's), then fp32
    on the card against the CPU on the same weights, the ViT cut to 2 blocks
    (VDA on a 4-frame window, FlashDepth over 2 steps)."""
    import numpy as np
    import torch

    from monocular_depth_estimation_trt_tpu_torch.models.flashdepth import FlashDepth
    from monocular_depth_estimation_trt_tpu_torch.models.video_depth_anything import (
        VideoDepthAnything,
    )
    from monocular_depth_estimation_trt_tpu_torch.models.vit import VIT_CONFIGS

    makes = {"video_depth_anything": VideoDepthAnything, "flashdepth": FlashDepth}
    for name, make in makes.items():
        if name == "video_depth_anything":
            frames = rng.integers(0, 256, (VDA_ROUTE_FRAMES, 518, 518, 3), dtype=np.uint8)
        else:
            frames = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
        readings = []
        for seed in PARITY_WEIGHT_SEEDS:
            sd = seeded(make, seed).state_dict()
            pipe = build_pipeline(name, params=sd)
            kernel, plain, fp32 = video_route_readings(name, pipe, frames)
            readings.append({"seed": seed, "kernel_vs_plain": rel(kernel, plain),
                             "kernel_vs_fp32": rel(kernel, fp32),
                             "plain_vs_fp32": rel(plain, fp32),
                             "kernel_vs_fp32_mean_rel": mean_rel(kernel, fp32),
                             "plain_vs_fp32_mean_rel": mean_rel(plain, fp32)})
            drop_engines(pipe)
            del pipe, sd
        ratio = (np.mean([r["kernel_vs_fp32_mean_rel"] for r in readings])
                 / np.mean([r["plain_vs_fp32_mean_rel"] for r in readings]))
        # fp32, card against CPU: 2 ViT blocks, full widths and 518²
        cfg = dataclasses.replace(VIT_CONFIGS["vits"], depth=VIDEO_CPU_DEPTH)
        kw = dict(vit_config=cfg, out_indices=VIDEO_CPU_TAPS)
        sd = seeded(lambda: make("vits", **kw), 0).state_dict()
        card, cpu = (build_pipeline(name, precision="fp32", params=sd, model_kw=kw, device=d)
                     for d in ("cuda", "cpu"))
        got = []
        if name == "video_depth_anything":
            x = rng.integers(0, 256, (VIDEO_CPU_FRAMES, 518, 518, 3), dtype=np.uint8)
            for p in (card, cpu):
                with torch.inference_mode():
                    got.append(p._window_forward(torch.from_numpy(x).to(p.device))["depth"]
                               .cpu().numpy())
        else:
            x = rng.integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
            for p in (card, cpu):
                state = p._init_state(p.device)
                steps = []
                with torch.inference_mode():
                    for f in x:
                        out, state = p._forward_state(torch.from_numpy(f).to(p.device),
                                                      f.shape[:2], state)
                        steps.append(out["depth"].cpu().numpy())
                got.append(np.stack(steps))
        cpu_rel = rel(got[0], got[1])
        drop_engines(card, cpu)
        emit({"phase": "video_parity", "model": name, "readings": readings,
              "kernel_over_plain_distance_from_fp32": float(ratio),
              "bf16_tolerance": PATH_BF16_REL_TOL, "route_ratio_bar": PATH_BF16_ROUTE_RATIO,
              "fp32_card_vs_cpu_rel": cpu_rel, "fp32_cpu_cut": f"{VIDEO_CPU_DEPTH} ViT blocks",
              "fp32_tolerance": PATH_FP32_REL_TOL})
        for r in readings:
            check(r["kernel_vs_plain"] < PATH_BF16_REL_TOL and
                  r["kernel_vs_fp32"] < PATH_BF16_REL_TOL, f"{name} routes {r}")
        check(ratio <= PATH_BF16_ROUTE_RATIO, f"{name}: kernel route {ratio}x the plain "
                                              "route's distance from fp32")
        check(cpu_rel < PATH_FP32_REL_TOL, f"{name} fp32 card vs cpu rel {cpu_rel}")


def run_flashdepth_path(build_pipeline, wrappers, rng):
    """FlashDepth vits at 518², with the counts set to 0 just before and read
    just after: its session's engine (2 warm-up steps and the captured one,
    the state put back), then FLASHDEPTH_STEPS steps, each a replay of that
    graph, and a single frame through the pipeline (a zero state inside its
    graph). Every step against the eager step from a fresh state carried
    along (bit for bit, else within ENGINE_REL_TOL, recorded), the clip
    against ``flashdepth_video``, and the state's reset. Returns the
    pipeline, the counts and the session."""
    import numpy as np
    import torch

    from monocular_depth_estimation_trt_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
    from monocular_depth_estimation_trt_tpu_torch.models.flashdepth import flashdepth_video
    from monocular_depth_estimation_trt_tpu_torch.ops.postprocess import upsample_depth
    from monocular_depth_estimation_trt_tpu_torch.ops.preprocess import normalize, to_float_rgb
    from monocular_depth_estimation_trt_tpu_torch.ops.resize import resize

    hw = (518, 518)
    want = [0, 12, 0, 0]
    pipe = build_pipeline("flashdepth")
    frames = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(FLASHDEPTH_STEPS)]
    sess = pipe.stream()
    torch.cuda.synchronize()
    set_counts_to_zero(wrappers)
    _, per = run_counted(lambda: sess.engine_for(hw), lambda: sess.engine_for(hw), wrappers,
                         "flashdepth step engine")
    state_zero = not any(bool(t.any()) for t in sess.state.values())
    times, outs = [], []
    for f in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(sess.step(f))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    after_steps = counts(wrappers)
    single, single_per = run_counted(lambda: pipe(frames[0]), lambda: pipe.engine_for(hw),
                                     wrappers, "flashdepth frame")
    torch.cuda.synchronize()
    launches = launch_record(wrappers)
    check(per == single_per == want, f"flashdepth launches: step {per}, frame {single_per}")
    check(after_steps == [(WARMUP_CALLS + 1) * n for n in per],
          f"flashdepth: launches after {FLASHDEPTH_STEPS} steps {after_steps}")
    check(launches == {k: 2 * (WARMUP_CALLS + 1) * n for k, n in zip(KERNELS, want)},
          f"launches on the flashdepth path {launches}")
    check(state_zero, "flashdepth: the state moved during the engine build")

    dev = pipe.device
    state = pipe._init_state(dev)
    replay = {"equal": [], "max_rel": []}
    with torch.inference_mode():
        for f, got in zip(frames, outs):
            ref, state = pipe._forward_state(torch.from_numpy(f).to(dev), hw, state)
            replay["equal"].append(bool(torch.equal(got["depth"], ref["depth"])))
            a, b = got["depth"].float(), ref["depth"].float()
            replay["max_rel"].append(float((a - b).abs().max() / b.abs().max()))
        x = torch.stack([normalize(resize(to_float_rgb(torch.from_numpy(f).to(dev)), hw,
                                          method="cubic"), IMAGENET_MEAN, IMAGENET_STD)
                         for f in frames])
        clip, _ = flashdepth_video(pipe.model, x[None])
        clip = torch.clamp(upsample_depth(clip[0], hw, clamp=None), min=0.0)
    steps = torch.stack([o["depth"] for o in outs])
    clip_rel = float((steps - clip).abs().max() / clip.abs().max())
    first_vs_single = float(np.abs(outs[0]["depth"].cpu().numpy() - single["depth"]).max())
    carried = sess.step(frames[0])
    carried_vs_fresh = rel(carried["depth"].cpu().numpy(), outs[0]["depth"].cpu().numpy())
    sess.reset()
    after_reset = sess.step(frames[0])
    rec = {"phase": "video", "path": "flashdepth_vits_stream", "model": pipe.spec.artifact_name(),
           "steps": FLASHDEPTH_STEPS, "frame": list(hw),
           "launches_per_step_k3_k1_k2_k4": per, "launches_per_frame_k3_k1_k2_k4": single_per,
           "launches": launches, "step_ms": times,
           "step_p50_ms": float(np.median(times)),
           "replay_equal_to_eager": all(replay["equal"]),
           "replay_vs_eager_max_rel": max(replay["max_rel"]),
           "steps_vs_flashdepth_video_rel": clip_rel,
           "first_step_vs_single_frame_max_abs": first_vs_single,
           "first_frame_carried_vs_fresh_rel": carried_vs_fresh,
           "reset_step_equal_to_first": bool(torch.equal(after_reset["depth"], outs[0]["depth"])),
           "card": torch.cuda.get_device_name(0)}
    emit(rec)
    check(all(bool(torch.isfinite(o["depth"]).all()) and float(o["depth"].min()) >= 0
              for o in outs), "flashdepth: a step's depth not finite or negative")
    check(rec["replay_equal_to_eager"] or rec["replay_vs_eager_max_rel"] <= ENGINE_REL_TOL,
          f"flashdepth: replay vs eager max rel {rec['replay_vs_eager_max_rel']}")
    check(clip_rel <= ENGINE_REL_TOL, f"flashdepth: steps vs flashdepth_video rel {clip_rel}")
    check(first_vs_single == 0.0, "flashdepth: a single frame is not a fresh sequence's step")
    check(carried_vs_fresh > STATE_MOVED_MIN_REL,
          f"flashdepth: the carried state moved the first frame's depth by {carried_vs_fresh}")
    check(rec["reset_step_equal_to_first"], "flashdepth: reset did not start a new sequence")
    sess.reset()
    return pipe, launches, sess


def run_int8_stream(build_pipeline, wrappers, rng, calib):
    """The int8 StreamVGGT stream (window 4, 480x640 frames): the session on
    the int8 joint model's QuantLinear layers, with the counts set to 0 just
    before and read just after: its engine build, then INT8_STREAM_STEPS
    steps of that graph; each step against the eager step on a fresh cache.
    Returns the counts, the session and a frame."""
    import numpy as np
    import torch

    from monocular_depth_estimation_trt_tpu_torch.ops.quant import QuantLinear

    hw = (480, 640)
    want = [0, 24, 24, 288]
    pipe = build_pipeline("streamvggt", precision="int8", calib_images=calib)
    sess = pipe.stream(STREAM_WINDOW).session
    shared = [n for n, m in sess.model.named_modules() if isinstance(m, QuantLinear)
              and m is pipe.model.get_submodule(n)]
    frames = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(INT8_STREAM_STEPS)]
    torch.cuda.synchronize()
    set_counts_to_zero(wrappers)
    _, per = run_counted(lambda: sess.engine_for(hw), lambda: sess.engine_for(hw), wrappers,
                         "int8 stream step engine")
    times, outs = [], []
    for f in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(sess.step(f))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = launch_record(wrappers)
    check(per == want, f"int8 stream step launches {per}, want {want}")
    check(len(shared) == want[3], f"int8 stream: {len(shared)} QuantLinear layers shared")
    check(launches == {k: (WARMUP_CALLS + 1) * n for k, n in zip(KERNELS, want)},
          f"launches on the int8 stream {launches}")
    check(int(sess.steps) == INT8_STREAM_STEPS, f"int8 stream: {int(sess.steps)} steps")
    dev = pipe.device
    cache = sess.model.init_cache(1, (37, 37), next(sess.model.parameters()).dtype, dev)
    replay = {"equal": [], "max_rel": []}
    with torch.inference_mode():
        for f, got in zip(frames, outs):
            ref, _ = sess.pure_step(torch.from_numpy(f).to(dev), cache, hw)
            for k in got:
                replay["equal"].append(bool(torch.equal(got[k], ref[k])))
                a, b = got[k].float(), ref[k].float()
                replay["max_rel"].append(float((a - b).abs().max() / b.abs().max()))
    rec = {"phase": "video", "path": "streamvggt_int8_stream", "model": pipe.spec.artifact_name(),
           "window": STREAM_WINDOW, "steps": INT8_STREAM_STEPS, "frame": list(hw),
           "launches_per_step_k3_k1_k2_k4": per, "launches": launches,
           "quantized_layers_shared": len(shared), "step_ms": times,
           "step_p50_ms_steps_1_to_4": float(np.median(times[:4])),
           "step_p50_ms_steps_5_to_8": float(np.median(times[4:])),
           "replay_equal_to_eager": all(replay["equal"]),
           "replay_vs_eager_max_rel": max(replay["max_rel"]),
           "card": torch.cuda.get_device_name(0)}
    emit(rec)
    check(all(bool(torch.isfinite(o["depth"]).all()) and tuple(o["depth"].shape) == hw
              for o in outs), "int8 stream: depth")
    check(rec["replay_equal_to_eager"] or rec["replay_vs_eager_max_rel"] <= ENGINE_REL_TOL,
          f"int8 stream: replay vs eager max rel {rec['replay_vs_eager_max_rel']}")
    return launches, sess, frames[0]


def video_serving(vda, flashdepth, fd_sess, stream_sess, stream_frame, card, power_limit, dev):
    """The video paths' speed and profile right after their checks, so that
    their graphs are released before the int8 phases: each VDA window
    engine (``VDAPipeline.benchmark``: frames/s; vits in turns eager, graph,
    vitl graph once), FlashDepth's single frame in turns
    (its stream step's p50 is the video record's), then the profile of each
    VDA window (graph, and eager with the device time of the temporal blocks
    and of their attention), of the FlashDepth step and of the int8 stream
    step (graph)."""
    import numpy as np
    import torch

    from monocular_depth_estimation_trt_tpu_torch.config import BenchmarkConfig
    from monocular_depth_estimation_trt_tpu_torch.runtime.benchmark import benchmark

    cfg = BenchmarkConfig(**VIDEO_BENCH)
    gen = np.random.default_rng(15)
    for label, p in vda.items():
        window = torch.from_numpy(
            gen.integers(0, 256, (VDA_WINDOW, 518, 518, 3), dtype=np.uint8)).to(dev)

        def eager_step():
            with torch.inference_mode():
                p._window_forward(window)

        for turn, route in enumerate(ROUTE_TURNS if label == "vits" else ("graph",)):
            if route == "graph":
                rep = p.benchmark((518, 518), cfg)
            else:
                rep = benchmark(eager_step, device=dev, config=cfg, name=p.spec.artifact_name())
                rep.frames_per_iteration = VDA_WINDOW
            emit({**speed_record(rep, p, f"vda_{label}_window32", route, turn, 0, (518, 518),
                                 card, power_limit),
                  "frames_per_iteration": VDA_WINDOW,
                  "includes": f"a window of {VDA_WINDOW} device-resident uint8 518x518 frames "
                              "+ forward" + (" + D2H depth" if route == "graph" else "")})
        eng = p.window_engine((518, 518))
        emit({**profile_breakdown(lambda: eng(window), p.spec.artifact_name() + "_win32", 3),
              "route": "graph"})
        with temporal_ranges() as ranges:
            emit({**profile_breakdown(eager_step, p.spec.artifact_name() + "_win32",
                                      EAGER_PROFILE_CALLS, ranges=ranges), "route": "eager"})
        drop_engines(p)
    fcfg = BenchmarkConfig(**FAMILY_BENCH)
    for turn, route in enumerate(ROUTE_TURNS):
        rep = timed_route(flashdepth, route, (518, 518), 0, fcfg)
        emit(speed_record(rep, flashdepth, "flashdepth", route, turn, 0, (518, 518), card,
                          power_limit))
    frame = torch.from_numpy(gen.integers(0, 256, (518, 518, 3), dtype=np.uint8))
    eng = fd_sess.engine_for((518, 518))
    emit({**profile_breakdown(lambda: eng(frame), fd_sess.name + "_step", 5), "route": "graph"})
    drop_engines(flashdepth)
    fd_sess.release_engines()
    host = torch.from_numpy(stream_frame)
    eng = stream_sess.engine_for(tuple(stream_frame.shape[:2]))
    emit({**profile_breakdown(lambda: eng(host), stream_sess.name + "_step", 3),
          "route": "graph"})
    stream_sess.release_engines()


def video_phase(build_pipeline, wrappers, calib, card, power_limit, dev):
    """Every video path's counted run and checks, then its speed and profile
    (``video_serving``), everything released at the end. Returns the counts
    of each counted run."""
    import gc

    import numpy as np
    import torch

    t0 = time.perf_counter()
    rng = np.random.default_rng(16)
    vda, launches = {}, {}
    for encoder in ("vits", "vitl"):
        vda[encoder], launches[f"vda_{encoder}"] = run_vda_path(build_pipeline, wrappers, rng,
                                                                encoder)
        drop_engines(vda[encoder])
    flashdepth, launches["flashdepth"], fd_sess = run_flashdepth_path(build_pipeline, wrappers,
                                                                      rng)
    launches["streamvggt_int8_stream"], stream_sess, stream_frame = run_int8_stream(
        build_pipeline, wrappers, rng, calib)
    video_parity(build_pipeline, rng)
    emit({"phase": "video_summary", "seconds": time.perf_counter() - t0, "launches": launches})
    video_serving(vda, flashdepth, fd_sess, stream_sess, stream_frame, card, power_limit, dev)
    del vda, flashdepth, fd_sess, stream_sess
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# optical flow: RAFT, NeuFlow, MeFlow, MEMFOF, WAFT
# ---------------------------------------------------------------------------

FLOW_MODELS = ("raft", "neuflow", "meflow", "memfof", "waft")
FLOW_FRAME_HW = (480, 640)  # camera frames, resized on the card to each model's input
# per model: (flow size, flow_low size or None), K3/K1/K2/K4 launches a forward
FLOW_SHAPES = {"raft": ((288, 512), (36, 64)), "neuflow": ((288, 512), None),
               "meflow": ((288, 512), (36, 64)), "memfof": ((288, 512), None),
               "waft": ((280, 504), (40, 72))}
FLOW_LAUNCHES = {name: [0, 12 if name == "waft" else 0, 0, 0] for name in FLOW_MODELS}
MEMFOF_STEPS = 8
# fp32 card against CPU: 2 refinement steps (NeuFlow its 8 + 8) at a quarter
# of the input's pixels, full widths
FLOW_CPU_HW = {"waft": (140, 252)}
FLOW_CPU_ITERS = 2
# WAFT's bf16 kernel route (K1) against its plain route (``attn_impl="xla"``),
# max |a - b| / max |b| of the flow at 2 weight seeds: about twice the larger
# of the first chip run's two readings (6.1e-3, 5.1e-3; each route 0.5-1.3e-2
# from fp32 after 8 recurrent bf16 steps)
WAFT_BF16_REL_TOL = 1.5e-2
# the lookup at RAFT's shape: 36x64 pixels, a 4-level pyramid of 36x64
# slabs, radius 4, 20 lookups a forward
RAFT_LOOKUP = dict(hw=(36, 64), channels=256, levels=4, radius=4, per_forward=20)


@contextlib.contextmanager
def flow_ranges(name):
    """The plain parts of a flow model each inside a ``record_function``
    range while the context lasts: the correlation lookups (RAFT, NeuFlow,
    MEMFOF: ``corr_lookup_separable``; MeFlow: ``meflow_corr``), WAFT's warp
    (``bilinear_sample_nhwc``), and the plain attentions (NeuFlow's
    ``CrossAttention.attend``, MeFlow's ``Window1DAttention.forward``,
    MEMFOF's ``GMAAttention.forward``). Yields the range names."""
    import torch

    from monocular_depth_estimation_trt_tpu_torch.models.flow import meflow, memfof, neuflow
    from monocular_depth_estimation_trt_tpu_torch.models.flow import raft, waft

    targets = {
        "raft": [(raft, "corr_lookup_separable")],
        "neuflow": [(neuflow, "corr_lookup_separable"), (neuflow.CrossAttention, "attend")],
        "meflow": [(meflow, "meflow_corr"), (meflow.Window1DAttention, "forward")],
        "memfof": [(memfof, "corr_lookup_separable"), (memfof.GMAAttention, "forward")],
        "waft": [(waft, "bilinear_sample_nhwc")],
    }[name]

    def wrap(fn, label):
        def in_range(*args, **kw):
            with torch.profiler.record_function(label):
                return fn(*args, **kw)
        return in_range

    saved = [(owner, attr, getattr(owner, attr)) for owner, attr in targets]
    labels = []
    for owner, attr, fn in saved:
        label = attr if not isinstance(owner, type) else f"{owner.__name__}.{attr}"
        setattr(owner, attr, wrap(fn, label))
        labels.append(label)
    try:
        yield tuple(labels)
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def flow_frames(name, rng, hw):
    import numpy as np

    return [rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
            for _ in range(3 if name == "memfof" else 2)]


def flow_eager(pipe, name, frames):
    """The pipeline's eager forward of host frames (no viz): what its engine
    for their size captures."""
    import torch

    dev = [torch.from_numpy(f).to(pipe.device) for f in frames]
    if name == "memfof":
        return pipe._run(torch.stack(dev))
    return pipe._run(*dev)


def flow_outputs_equal(got, ref):
    """Replay against eager: per output tensor (MEMFOF's cache maps
    included), equal bit for bit, and the max rel."""
    import torch

    flat = lambda out: [(k, v) for k, v in out.items() if isinstance(v, torch.Tensor)] + [
        (f"fmap_cache_{i}", v) for i, v in enumerate(out.get("fmap_cache", ()))]
    res = {}
    for (k, a), (_, b) in zip(flat(got), flat(ref)):
        a, b = a.to(b.device), b
        res[k] = {"equal": bool(torch.equal(a, b)),
                  "max_rel": finite_or_none(float((a.float() - b.float()).abs().max()
                                                  / b.float().abs().max().clamp_min(1e-12)))}
    return res


def run_flow_path(name, build_pipeline, wrappers, rng):
    """One flow model at full size on the card with its own counts, set to 0
    just before and read just after: a pair (MEMFOF a triplet) of 480x640
    frames through a new engine, with the color wheel (MEMFOF: its flow and
    cache); shapes and finiteness; then a replay of another input against
    its eager forward. Returns the pipeline and the counts."""
    import numpy as np
    import torch

    pipe = build_pipeline(name)
    check(pipe.device.type == "cuda", f"{name}: default device {pipe.device}")
    if name == "raft":  # fp32: full fp32 convolutions and matmuls from the build on
        check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
              "raft fp32: TF32 is on")
    want = FLOW_LAUNCHES[name]
    hw = FLOW_FRAME_HW
    frames = flow_frames(name, rng, hw)
    torch.cuda.synchronize()
    set_counts_to_zero(wrappers)
    if name == "memfof":
        out, per = run_counted(lambda: pipe(*frames), lambda: pipe.engine_for(hw), wrappers,
                               "memfof triplet")
    else:
        out, per = run_counted(lambda: pipe(*frames, viz=True), lambda: pipe.engine_for(hw, True),
                               wrappers, f"{name} pair")
    torch.cuda.synchronize()
    launches = launch_record(wrappers)
    (fh, fw), low = FLOW_SHAPES[name]
    flow = np.asarray(out["flow"])
    rec = {"phase": "flow", "path": name, "model": pipe.spec.artifact_name(),
           "frames": [len(frames), *hw], "launches_per_forward_k3_k1_k2_k4": per,
           "launches": launches, "flow_shape": list(flow.shape),
           "flow_abs_max": float(np.abs(flow).max()), "flow_finite": bool(np.isfinite(flow).all()),
           "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn": torch.backends.cudnn.allow_tf32},
           "dtype": str(next(pipe.model.parameters()).dtype).replace("torch.", "")}
    if low:
        rec["flow_low_shape"] = list(out["flow_low"].shape)
    if "viz" in out:
        rec.update(viz_shape=list(out["viz"].shape), viz_dtype=str(out["viz"].dtype),
                   viz_colors=int(len(np.unique(out["viz"].reshape(-1, 3), axis=0))))
    other = flow_frames(name, rng, hw)
    engine = pipe.engine_for(hw) if name == "memfof" else pipe.engine_for(hw, False)
    replay = engine(*(torch.from_numpy(f) for f in (
        [np.stack(other)] if name == "memfof" else other)))
    rec["replay_vs_eager"] = flow_outputs_equal(replay, flow_eager(pipe, name, other))
    emit(rec)
    check(per == want, f"{name}: launches a forward {per}, want {want}")
    check(launches == {k: (WARMUP_CALLS + 1) * n for k, n in zip(KERNELS, want)},
          f"launches on the {name} path {launches}")
    want_flow = (2, fh, fw, 2) if name == "memfof" else (fh, fw, 2)
    check(flow.shape == want_flow and rec["flow_finite"] and rec["flow_abs_max"] > 0,
          f"{name}: flow {flow.shape} finite {rec['flow_finite']} max {rec['flow_abs_max']}")
    if low:
        check(tuple(out["flow_low"].shape) == (*low, 2) and bool(np.isfinite(out["flow_low"]).all()),
              f"{name}: flow_low {out['flow_low'].shape}")
    if "viz" in out:
        check(out["viz"].shape == (fh, fw, 3) and out["viz"].dtype == np.uint8
              and rec["viz_colors"] > 16, f"{name}: viz {out['viz'].shape} {out['viz'].dtype}")
    if name == "memfof":
        check([tuple(c.shape) for c in out["fmap_cache"]] == [(1, 256, fh // 16, fw // 16)] * 3,
              "memfof: fmap_cache shapes")
    for k, r in rec["replay_vs_eager"].items():
        check(r["equal"] or (r["max_rel"] or math.inf) <= ENGINE_REL_TOL,
              f"{name} {k}: replay vs eager {r}")
    return pipe, launches


def run_memfof_stream(pipe, wrappers, rng):
    """MEMFOF's video session over MEMFOF_STEPS 480x640 frames, with the
    counts set to 0 just before and read just after: the triplet's engine
    at the first full window, then the cached step's engine (the two older
    feature maps in) at every later frame; each step against the eager step
    on an eager cache carried along. Returns the counts."""
    import numpy as np
    import torch

    frames = [rng.integers(0, 256, (*FLOW_FRAME_HW, 3), dtype=np.uint8)
              for _ in range(MEMFOF_STEPS)]
    sess = pipe.stream()
    torch.cuda.synchronize()
    set_counts_to_zero(wrappers)
    times, outs = [], []
    for f in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(sess.step(f))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = launch_record(wrappers)
    prepared = [sess._prepare(f) for f in frames]
    cache, equal, max_rel = None, [], []
    with torch.inference_mode():
        for i in range(2, MEMFOF_STEPS):
            trip = prepared[i - 2:i + 1]
            ref = (pipe._forward(torch.stack(trip)) if cache is None
                   else pipe._cached_forward(*trip, cache[1], cache[2]))
            cache = ref["fmap_cache"]
            want = ref["flow"].float().cpu().numpy()
            equal.append(bool(np.array_equal(outs[i], want)))
            max_rel.append(rel(outs[i], want))
    rec = {"phase": "flow", "path": "memfof_stream", "model": pipe.spec.artifact_name(),
           "frames": MEMFOF_STEPS, "frame": list(FLOW_FRAME_HW), "launches": launches,
           "outputs": [None if o is None else list(o.shape) for o in outs],
           "step_ms": times, "cached_step_p50_ms": float(np.median(times[3:])),
           "steps_equal_to_eager": equal, "steps_vs_eager_max_rel": max_rel,
           "cached_engine": pipe.cached_engine().name}
    emit(rec)
    check(outs[0] is None and outs[1] is None
          and all(o is not None and o.shape == (2, 288, 512, 2) and bool(np.isfinite(o).all())
                  for o in outs[2:]), f"memfof stream outputs {rec['outputs']}")
    check(all(e or r <= ENGINE_REL_TOL for e, r in zip(equal, max_rel)),
          f"memfof stream: steps vs eager {max_rel}")
    check(launches == {k: 0 for k in KERNELS}, f"memfof stream launches {launches}")
    return launches


def flow_cpu_parity(build_pipeline, rng):
    """Each flow model in fp32 on the card against the CPU on the same
    random weights (the CPU pipeline's), 2 refinement steps (NeuFlow its 8 +
    8), at 144x256 (WAFT 140x252), full widths: max rel of the flow (and
    flow_low) below PATH_FP32_REL_TOL, TF32 off."""
    import numpy as np

    readings = {}
    for name in FLOW_MODELS:
        kw = dict(precision="fp32", input_hw=FLOW_CPU_HW.get(name, (144, 256)))
        if name != "neuflow":
            kw["iters"] = FLOW_CPU_ITERS
        cpu = build_pipeline(name, device="cpu", **kw)
        card = build_pipeline(name, params=cpu.model.state_dict(), **kw)
        frames = flow_frames(name, rng, (240, 320))
        outs = [flow_eager(p, name, frames) for p in (card, cpu)]
        readings[name] = {k: rel(outs[0][k].cpu().numpy(), outs[1][k].numpy())
                          for k in ("flow", "flow_low") if k in outs[1]}
        drop_engines(card, cpu)
    emit({"phase": "flow_parity", "fp32_card_vs_cpu_rel": readings,
          "cut": f"{FLOW_CPU_ITERS} refinement steps (NeuFlow 8 + 8) at 144x256 (WAFT 140x252)",
          "fp32_tolerance": PATH_FP32_REL_TOL})
    for name, r in readings.items():
        check(all(v < PATH_FP32_REL_TOL for v in r.values()), f"{name} fp32 card vs cpu {r}")


def waft_routes(build_pipeline, rng):
    """WAFT's bf16 kernel route (K1 at (2, 721, 6)) against its plain route
    and the fp32 route on the kernel route's own model, at PARITY_WEIGHT_SEEDS on
    one 480x640 pair: max rel of the flow below WAFT_BF16_REL_TOL, and,
    averaged over the seeds, the kernel route's distance from fp32 at most
    PATH_BF16_ROUTE_RATIO times the plain route's."""
    import numpy as np
    import torch

    from monocular_depth_estimation_trt_tpu_torch.models.flow.waft import WAFT

    frames = flow_frames("waft", rng, FLOW_FRAME_HW)
    readings = []
    for seed in PARITY_WEIGHT_SEEDS:
        pipe = build_pipeline("waft", params=seeded(WAFT, seed).state_dict())
        kernel = flow_eager(pipe, "waft", frames)["flow"].float().cpu().numpy()
        set_attention_route([pipe.model], "xla")
        plain = flow_eager(pipe, "waft", frames)["flow"].float().cpu().numpy()
        set_attention_route([pipe.model], "auto")
        pipe.model.float()
        fp32 = flow_eager(pipe, "waft", frames)["flow"].float().cpu().numpy()
        readings.append({"seed": seed, "kernel_vs_plain": rel(kernel, plain),
                         "kernel_vs_fp32": rel(kernel, fp32), "plain_vs_fp32": rel(plain, fp32),
                         "kernel_vs_fp32_mean_rel": mean_rel(kernel, fp32),
                         "plain_vs_fp32_mean_rel": mean_rel(plain, fp32),
                         "flow_abs_max": float(np.abs(fp32).max())})
        drop_engines(pipe)
        del pipe
    ratio = (np.mean([r["kernel_vs_fp32_mean_rel"] for r in readings])
             / np.mean([r["plain_vs_fp32_mean_rel"] for r in readings]))
    emit({"phase": "flow_parity", "model": "waft", "routes": readings,
          "kernel_over_plain_distance_from_fp32": float(ratio),
          "bf16_tolerance": WAFT_BF16_REL_TOL, "route_ratio_bar": PATH_BF16_ROUTE_RATIO})
    for r in readings:
        check(r["kernel_vs_plain"] < WAFT_BF16_REL_TOL, f"waft routes {r}")
    check(ratio <= PATH_BF16_ROUTE_RATIO,
          f"waft: kernel route {ratio}x the plain route's distance from fp32")
    torch.cuda.empty_cache()


def flow_lookup_alone(dev):
    """RAFT's correlation lookup timed alone at its shape, the separable
    form (what RAFT runs) and the gather form, on the same pyramid and
    coordinates (the two agree); device ms per lookup."""
    import torch

    from monocular_depth_estimation_trt_tpu_torch.models.flow.raft import coords_grid
    from monocular_depth_estimation_trt_tpu_torch.ops import flow_sampler as fs

    c = RAFT_LOOKUP
    gen = torch.Generator(device=dev).manual_seed(0)
    f1, f2 = (torch.randn((1, *c["hw"], c["channels"]), generator=gen, device=dev)
              for _ in range(2))
    pyr = fs.build_corr_pyramid(f1, f2, c["levels"])
    coords = coords_grid(1, *c["hw"], device=dev) + 4.0 * torch.randn(
        (1, *c["hw"], 2), generator=gen, device=dev)
    with torch.inference_mode():
        sep = fs.corr_lookup_separable(pyr, coords, c["radius"])
        gat = fs.corr_lookup(pyr, coords, c["radius"])
    agree = float((sep - gat).abs().max() / gat.abs().max())
    rec = {"phase": "flow_lookup", "shape": c, "separable_vs_gather_rel": agree,
           "separable_ms": device_ms(lambda: fs.corr_lookup_separable(pyr, coords, c["radius"])),
           "gather_ms": device_ms(lambda: fs.corr_lookup(pyr, coords, c["radius"])),
           "pyramid_ms": device_ms(lambda: fs.build_corr_pyramid(f1, f2, c["levels"]))}
    check(agree < FP32_TOL, f"raft lookup: separable vs gather {agree}")
    return rec


def flow_timed_route(pipe, name, route, config):
    """A flow model's step at its input size: ``benchmark`` through the
    engine ("graph"), or the same step through the eager forward ("eager"):
    pinned uint8 frames H2D, forward, the flow D2H into pinned memory."""
    import numpy as np
    import torch

    from monocular_depth_estimation_trt_tpu_torch.runtime.benchmark import benchmark

    if route == "graph":
        return pipe.benchmark(None, config)
    frames = [torch.from_numpy(f).pin_memory()
              for f in flow_frames(name, np.random.default_rng(0), pipe.spec.input_hw)]
    flow = flow_eager(pipe, name, [f.numpy() for f in frames])["flow"]
    host_out = torch.empty(flow.shape, dtype=flow.dtype).pin_memory()

    def step():
        dev = [f.to(pipe.device, non_blocking=True) for f in frames]
        out = pipe._run(torch.stack(dev)) if name == "memfof" else pipe._run(*dev)
        host_out.copy_(out["flow"], non_blocking=True)

    return benchmark(step, device=pipe.device, config=config, name=pipe.spec.artifact_name())


def flow_serving(name, pipe, card, power_limit, dev, lookup=None):
    """A flow model's speed in turns eager, graph, then its
    profile: the graph replay, and the eager forward with the device time of
    its plain parts (``flow_ranges``). RAFT's record adds the lookup's share
    of the replay's device time, from its time alone in each form."""
    import numpy as np
    import torch

    from monocular_depth_estimation_trt_tpu_torch.config import BenchmarkConfig

    config = BenchmarkConfig(**FAMILY_BENCH)
    hw = tuple(pipe.spec.input_hw)
    n = 3 if name == "memfof" else 2
    for turn, route in enumerate(ROUTE_TURNS):
        rep = flow_timed_route(pipe, name, route, config)
        emit({"phase": "speed", "path": name, "model": pipe.spec.artifact_name(), "route": route,
              "turn": turn, "fps": rep.fps, "mean_ms": rep.avg_ms,
              "p50_ms": rep.percentile_ms(50), "p99_ms": rep.percentile_ms(99),
              "iterations": rep.iterations,
              "includes": f"H2D uint8 {hw[0]}x{hw[1]} x {n} + forward + D2H flow",
              "card": card, "power_limit": power_limit})
    drop_engines(pipe)
    frames = [torch.from_numpy(f).to(dev)
              for f in flow_frames(name, np.random.default_rng(17), hw)]
    args = (torch.stack(frames),) if name == "memfof" else tuple(frames)
    eng = pipe.engine_for(hw) if name == "memfof" else pipe.engine_for(hw, False)
    graph = profile_breakdown(lambda: eng(*args), pipe.spec.artifact_name(), 5)
    if lookup is not None and "device_busy_ms_per_call" in graph:
        busy = graph["device_busy_ms_per_call"]
        for form in ("separable", "gather"):
            lookup[f"{form}_share_of_raft_replay"] = (
                RAFT_LOOKUP["per_forward"] * lookup[f"{form}_ms"] / busy)
        lookup["raft_replay_busy_ms"] = busy
        emit(lookup)
    emit({**graph, "route": "graph"})

    def eager_step():
        with torch.inference_mode():
            pipe._forward(*args)

    with flow_ranges(name) as ranges:
        emit({**profile_breakdown(eager_step, pipe.spec.artifact_name(), EAGER_PROFILE_CALLS,
                                  ranges=ranges), "route": "eager"})
    drop_engines(pipe)


def flow_phase(build_pipeline, wrappers, card, power_limit, dev):
    """Every flow model's counted run and checks (MEMFOF's video session
    too), fp32 card against CPU, WAFT's routes, RAFT's lookup alone, then
    each model's speed and profile; every engine released at the end.
    Returns the counts of each counted run and the RAFT pipeline (the SLAM
    phase's flow network)."""
    import gc

    import numpy as np
    import torch

    t0 = time.perf_counter()
    rng = np.random.default_rng(18)
    pipes, launches = {}, {}
    for name in FLOW_MODELS:
        pipes[name], launches[name] = run_flow_path(name, build_pipeline, wrappers, rng)
        drop_engines(pipes[name])
    launches["memfof_stream"] = run_memfof_stream(pipes["memfof"], wrappers, rng)
    drop_engines(pipes["memfof"])
    flow_cpu_parity(build_pipeline, rng)
    waft_routes(build_pipeline, rng)
    lookup = flow_lookup_alone(dev)
    emit({"phase": "flow_summary", "seconds": time.perf_counter() - t0, "launches": launches})
    for name in FLOW_MODELS:
        flow_serving(name, pipes[name], card, power_limit, dev,
                     lookup if name == "raft" else None)
    raft = pipes["raft"]  # the SLAM phase's flow network
    del pipes
    gc.collect()
    torch.cuda.empty_cache()
    return launches, raft


# ---------------------------------------------------------------------------
# point tracking (CoTracker3) and the SLAM recipes
# ---------------------------------------------------------------------------

# CoTracker3's bf16 route against the card's fp32 route on the same weights
# at PARITY_WEIGHT_SEEDS, a first window and a continuation each
# (``tracking_routes``), about twice the larger of the readings (seed 0 /
# seed 1, first and continuation windows; PERF.md): the tracks' max
# |a - b| / max |b| (2.7e-3, 1.8e-2 / 3.6e-3, 9.7e-3) and the visibility's
# mean |a - b| (3.7e-3, 8.1e-3 / 1.3e-2, 3.3e-3). The visibility's max
# |a - b| (6.2e-2, 0.37 / 7.2e-2, 0.22) has its bar too, but it is the
# mean that discriminates: a few of the 1,600 probabilities of a random
# model sit on the sigmoid's steep part, where bf16 moves them by tenths
TRACK_BF16_REL_TOL = 4e-2
TRACK_BF16_VIS_MEAN_TOL = 2.5e-2
TRACK_BF16_VIS_TOL = 7.5e-1
TRACK_CLIP = (80, 480, 640)  # frames, height, width: track_video's clip
TRACK_CPU_FRAMES = 8  # fp32 card vs CPU: the model on 8 of a window's frames
TRACK_STEPS = 20  # timed window steps (each synchronised, host clock)
SLAM_CLIP = (24, 480, 640)
# the analytic world's frontend and solver (tests/test_slam_recipes.py)
SLAM_WORLD_FRONTEND = dict(grid_stride=8, kf_min_flow=2.5, kf_max_interval=4, kf_stride=1,
                           sigma_consistency=50.0)
SLAM_BENCH = dict(warmup=2, iterations=10, latency_iterations=10)


def timed_p50(step, n):
    """p50 (ms) of ``n`` calls of ``step``, each synchronised, host clock."""
    import numpy as np
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def tracking_routes(build_pipeline, frames, q):
    """CoTracker3's bf16 route against its fp32 route on the same weights,
    at PARITY_WEIGHT_SEEDS: a first window on ``frames[0]`` and a
    continuation on ``frames[1]`` from the fp32 first window's seed (both
    routes take the same seed). One reading per seed and window: the
    tracks' max rel and the visibility's max abs difference."""
    import torch

    from monocular_depth_estimation_trt_tpu_torch.models.cotracker3 import CoTracker3

    readings = []
    for wseed in PARITY_WEIGHT_SEEDS:
        params = seeded(CoTracker3, wseed).state_dict()
        bf16 = build_pipeline("cotracker3", params=params)
        fp32 = build_pipeline("cotracker3", precision="fp32", params=params)
        with torch.inference_mode():
            fp32._keep(fp32._forward(frames[0], q))
            for key, fr, args in (("first", frames[0], ()), ("cont", frames[1], fp32._seed())):
                a, b = bf16._forward(fr, q, *args), fp32._forward(fr, q, *args)
                tr_a, tr_b = a["tracks"].cpu().numpy(), b["tracks"].cpu().numpy()
                dv = (a["visibility"] - b["visibility"]).abs()
                readings.append({
                    "seed": wseed, "window": key, "tracks_rel": rel(tr_a, tr_b),
                    "tracks_mean_rel": mean_rel(tr_a, tr_b),
                    "visibility_abs": float(dv.max()), "visibility_mean_abs": float(dv.mean())})
        del bf16, fp32
    return readings


def tracking_phase(build_pipeline, wrappers, card, power_limit, dev):
    """CoTracker3 at full width (``cotracker3`` defaults: window 16, grid 10,
    384x512, bf16) with its counts set to 0 just before and read just after
    a first window and a continuation; both engines' replays against their
    eager forwards; the bf16 route against the card's fp32 route at 2
    weight seeds (``tracking_routes``); fp32 card against CPU; each window
    engine's p50 with its H2D and D2H, and the whole ``pipe(chunk)`` call's;
    ``track_video`` over an 80-frame 480x640 clip; the first window's
    profile. Returns the counts."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    rng = np.random.default_rng(21)
    pipe = build_pipeline("cotracker3")
    check(pipe.device.type == "cuda", f"cotracker3: default device {pipe.device}")
    win, hw, n = pipe.window, tuple(pipe.spec.input_hw), pipe.num_queries
    chunks = [rng.integers(0, 256, (win, *hw, 3), dtype=np.uint8) for _ in range(3)]
    torch.cuda.synchronize()
    set_counts_to_zero(wrappers)
    pipe(None, is_first_step=True, grid_size=pipe.grid_size)
    first, cont = pipe(chunks[0]), pipe(chunks[1])
    torch.cuda.synchronize()
    launches = launch_record(wrappers)
    outs_ok = all(tr.shape == (1, win, n, 2) and vi.shape == (1, win, n, 1)
                  and bool(np.isfinite(tr).all()) and bool(((vi >= 0) & (vi <= 1)).all())
                  for tr, vi in (first, cont))

    # each engine's replay against its eager forward, on a third window
    fr = torch.from_numpy(pipe._prep(chunks[2])[None])
    q = pipe._queries
    seed = pipe._seed()
    replay = {}
    for key, args in (("first", ()), ("cont", seed)):
        out = pipe.engine(key == "first")(fr, q, *args)
        with torch.inference_mode():
            ref = pipe._forward(fr.to(dev), q.to(dev), *args)
        replay[key] = {k: bool(torch.equal(out[k], ref[k])) for k in out}

    # the bf16 route against the fp32 route, at PARITY_WEIGHT_SEEDS
    routes = tracking_routes(build_pipeline, [torch.from_numpy(pipe._prep(c)[None]).to(dev)
                                              for c in chunks[:2]], q.to(dev))
    # fp32 card against CPU: the model alone on TRACK_CPU_FRAMES frames
    fp32 = build_pipeline("cotracker3", precision="fp32")
    cpu = build_pipeline("cotracker3", precision="fp32", device="cpu")
    small = fr[:, :TRACK_CPU_FRAMES]
    with torch.inference_mode():
        a = fp32.model(small.to(dev), q.to(dev))
        b = cpu.model(small, q)
    card_vs_cpu = {"tracks_rel": rel(a["tracks"].cpu().numpy(), b["tracks"].numpy()),
                   "visibility_abs": float((a["visibility"].cpu() - b["visibility"]).abs().max())}
    del cpu

    # speed: each window engine with pinned fp32 frames in and its outputs
    # fetched into pinned buffers; then the whole call (host prep included)
    fr_pinned = fr.pin_memory()
    host = {k: torch.empty((1, win, n, c), dtype=torch.float32).pin_memory()
            for k, c in (("tracks", 2), ("visibility", 1))}
    speed = {}
    for key, args in (("first", ()), ("cont", seed)):
        eng = pipe.engine(key == "first")

        def step(eng=eng, args=args):
            res = eng(fr_pinned, q, *args)
            for k, buf in host.items():
                buf.copy_(res[k], non_blocking=True)

        step()
        speed[f"{key}_window_p50_ms"] = timed_p50(step, TRACK_STEPS)
    speed["frames_per_s"] = pipe.step / (speed["cont_window_p50_ms"] / 1e3)
    speed["call_p50_ms"] = timed_p50(lambda: pipe(chunks[2]), 5)

    # track_video over a clip of camera frames (resized on the host)
    clip = rng.integers(0, 256, (TRACK_CLIP[0], *TRACK_CLIP[1:], 3), dtype=np.uint8)
    t0 = time.perf_counter()
    tracks, vis = pipe.track_video(clip)
    torch.cuda.synchronize()
    video_s = time.perf_counter() - t0
    rec = {"phase": "tracking", "model": pipe.spec.artifact_name(), "launches": launches,
           "windows": [list(first[0].shape), list(cont[0].shape)], "outputs_ok": outs_ok,
           "replay_vs_eager": replay, "bf16_vs_fp32": routes,
           "bf16_tolerance": {"tracks_rel": TRACK_BF16_REL_TOL,
                              "visibility_mean_abs": TRACK_BF16_VIS_MEAN_TOL,
                              "visibility_abs": TRACK_BF16_VIS_TOL},
           "fp32_card_vs_cpu": card_vs_cpu, "cpu_cut": f"the model on {TRACK_CPU_FRAMES} frames",
           **speed, "includes": "H2D fp32 16x384x512 + window + tracks/visibility D2H",
           "track_video": {"frames": list(TRACK_CLIP), "tracks": list(tracks.shape),
                           "visibility": list(vis.shape), "seconds": video_s,
                           "finite": bool(np.isfinite(tracks).all())},
           "card": card, "power_limit": power_limit}
    emit(rec)
    check(outs_ok, "cotracker3: window outputs' shapes or values")
    check(launches == {k: 0 for k in KERNELS}, f"cotracker3 launches {launches}")
    for key, r in replay.items():
        check(all(r.values()), f"cotracker3 {key} engine: replay differs from eager {r}")
    for r in routes:
        check(r["tracks_rel"] < TRACK_BF16_REL_TOL
              and r["visibility_mean_abs"] < TRACK_BF16_VIS_MEAN_TOL
              and r["visibility_abs"] < TRACK_BF16_VIS_TOL, f"cotracker3 bf16 vs fp32 {r}")
    check(card_vs_cpu["tracks_rel"] < PATH_FP32_REL_TOL
          and card_vs_cpu["visibility_abs"] < PATH_FP32_REL_TOL,
          f"cotracker3 fp32 card vs cpu {card_vs_cpu}")
    check(tracks.shape == (1, TRACK_CLIP[0], n, 2) and vis.shape == (1, TRACK_CLIP[0], n, 1)
          and rec["track_video"]["finite"], f"cotracker3 track_video {rec['track_video']}")
    eng = pipe.engine(True)
    fr_dev = fr.to(dev)
    emit({**profile_breakdown(lambda: eng(fr_dev, q), pipe.spec.artifact_name() + "_first", 3),
          "route": "graph"})
    drop_engines(pipe, fp32)
    emit({"phase": "tracking_summary", "seconds": time.perf_counter() - t_phase})
    return {"cotracker3": launches}


class SyntheticWorld:
    """``tests/test_slam_recipes.py``'s analytic world (copied: the script
    imports nothing of the JAX package): a smooth surface seen by a moving
    camera; each frame carries its index in a 12x12 corner block, and the
    injected flow is the solver's own projection model between two frames'
    poses."""

    def __init__(self, n_frames=10, flow_hw=(48, 64), depth_hw=(96, 128), focal=80.0, seed=0):
        import numpy as np
        import torch

        from monocular_depth_estimation_trt_tpu_torch.slam.lie import se3_exp

        self.n, self.flow_hw, self.depth_hw, self.focal = n_frames, flow_hw, depth_hw, focal
        rng = np.random.default_rng(seed)
        xis = np.zeros((n_frames, 6), np.float32)
        for i in range(1, n_frames):
            xis[i] = xis[i - 1] + np.concatenate([
                [0.05, 0.015, 0.07] + rng.normal(0, 0.01, 3),
                rng.normal(0, 0.008, 3)]).astype(np.float32)
        self.poses = se3_exp(torch.from_numpy(xis)).numpy()  # (N, 4, 4) c2w

    def z_of(self, un, vn, i):
        import numpy as np

        return 3.0 + 0.8 * np.sin(un * 3.1) * np.cos(vn * 2.3) + 0.1 * np.sin(i + un * 5.0)

    def frame(self, i):
        import numpy as np

        img = np.full((*self.flow_hw, 3), 40 + 13 * i, np.uint8)
        img[:12, :12] = i * 25
        return img

    def _ident(self, img):
        import numpy as np

        return int(round(float(np.median(np.asarray(img)[:12, :12, 0].astype(np.float32))) / 25.0))

    def depth_grid(self, i, hw):
        import numpy as np

        uu, vv = np.meshgrid(np.arange(hw[1], dtype=np.float32), np.arange(hw[0], dtype=np.float32))
        return self.z_of(uu / hw[1], vv / hw[0], i).astype(np.float32)

    def flow_fn(self, f1, f2):
        import numpy as np

        i, j = self._ident(f1), self._ident(f2)
        h, w = self.flow_hw
        f, cx, cy = self.focal, w / 2.0, h / 2.0
        uu, vv = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
        z = self.depth_grid(i, self.flow_hw)
        pts = np.stack([(uu - cx) / f * z, (vv - cy) / f * z, z], -1)
        T = np.linalg.inv(self.poses[j]) @ self.poses[i]
        pj = pts @ T[:3, :3].T + T[:3, 3]
        zj = np.maximum(pj[..., 2], 1e-3)
        return np.stack([f * pj[..., 0] / zj + cx - uu, f * pj[..., 1] / zj + cy - vv],
                        -1).astype(np.float32)

    def depth_fn_factory(self, affine=None):
        def fn(img):
            i = self._ident(img)
            disp = 1.0 / self.depth_grid(i, self.depth_hw)
            if affine is not None:
                disp = affine[i][0] * disp + affine[i][1]
            return disp.astype("float32")

        return fn


def slam_world(dev):
    """MegaSaM on the analytic world (``test_megasam_recovers_trajectory``:
    per-frame affine-corrupted disparity, a 10 % wrong focal prior, 30 LM
    iterations with focal refinement) on the card and on the CPU: the card's
    solve recovers the trajectory to the JAX test's bars and its poses
    match the CPU's (rel < PATH_FP32_REL_TOL); then the solve engine's
    replay against the eager solve, bit for bit."""
    import numpy as np
    import torch

    from monocular_depth_estimation_trt_tpu_torch.slam.ba import BAConfig, init_state
    from monocular_depth_estimation_trt_tpu_torch.slam.frontend import FrontendConfig
    from monocular_depth_estimation_trt_tpu_torch.slam.lie import rotation_geodesic_deg
    from monocular_depth_estimation_trt_tpu_torch.slam.recipes import (
        MegaSaMPipeline,
        ba_solve_fn,
    )

    world = SyntheticWorld()
    affine = [(1.0 + 0.2 * np.sin(i), 0.01 * i) for i in range(world.n)]
    frames = [world.frame(i) for i in range(world.n)]
    results = {}
    for device in ("cuda", "cpu"):
        pipe = MegaSaMPipeline(flow_fn=world.flow_fn, depth_fn=world.depth_fn_factory(affine),
                               frontend_cfg=FrontendConfig(**SLAM_WORLD_FRONTEND),
                               ba_cfg=BAConfig(iters=30, optimize_focal=True, focal_prior=1e-4),
                               device=device)
        results[device] = (pipe, pipe.run(frames, focal=world.focal * 1.1))
    card_pipe, res = results["cuda"]
    gt = world.poses[res.keyframe_indices]
    rot_err = float(rotation_geodesic_deg(torch.from_numpy(res.poses[:, :3, :3]),
                                          torch.from_numpy(gt[:, :3, :3])).max())
    t, t_gt = res.poses[:, :3, 3], gt[:, :3, 3]
    s = float(np.sum(t * t_gt) / max(np.sum(t * t), 1e-12))
    t_err = float(np.linalg.norm(s * t - t_gt) / np.linalg.norm(t_gt))
    cpu_res = results["cpu"][1]
    # the solve engine against the eager solve on the world's problem
    fe = card_pipe._frontend()
    prob, aux = fe.build_problem(frames, res.keyframe_indices)
    k, (e, p) = len(res.keyframe_indices), prob.weight.shape
    args = [*prob, *init_state(k), torch.tensor(world.focal * 1.1)]
    eng = card_pipe.solve_engine(aux["flow_hw"], k, e, p)
    out = eng(*args)
    with torch.no_grad():
        ref = ba_solve_fn(aux["flow_hw"], card_pipe.ba_cfg)(*(a.to(dev) for a in args))
    replay = {n: bool(torch.equal(out[n], ref[n])) for n in out}
    rec = {"phase": "slam", "path": "analytic_world", "keyframes": res.keyframe_indices,
           "K_E_P": [k, e, p], "rms_px": res.rms_px,
           "focal_rel_err": abs(res.focal - world.focal) / world.focal,
           "rotation_err_deg": rot_err, "translation_rel_err_to_scale": t_err,
           "card_vs_cpu_poses_rel": rel(res.poses, cpu_res.poses),
           "same_keyframes_as_cpu": res.keyframe_indices == cpu_res.keyframe_indices,
           "solve_replay_vs_eager": replay, "solve_engine_build_s": eng.build_seconds,
           "bars": "rms < 0.3 px, focal 5 %, rotation 0.5 deg, translation 5 % "
                   "(tests/test_slam_recipes.py)"}
    emit(rec)
    check(res.rms_px < 0.3 and rec["focal_rel_err"] < 0.05 and rot_err < 0.5 and t_err < 0.05,
          f"slam analytic world: {rec}")
    check(rec["same_keyframes_as_cpu"] and rec["card_vs_cpu_poses_rel"] < PATH_FP32_REL_TOL,
          f"slam analytic world card vs cpu {rec['card_vs_cpu_poses_rel']}")
    check(all(replay.values()), f"slam solve engine: replay differs from eager {replay}")
    card_pipe.release_engines()


def slam_mapping_engine(dev):
    """WildGS-SLAM's mapping step at its full size (144x256, 32,768 slots
    from a stride-2 seeding): the engine's replay against the eager step
    bit for bit, and one step on the card against the CPU (loss and map,
    rel < PATH_FP32_REL_TOL)."""
    import torch

    from monocular_depth_estimation_trt_tpu_torch.slam.gaussians import init_from_depth
    from monocular_depth_estimation_trt_tpu_torch.slam.recipes import (
        WildGSSLAMPipeline,
        flatten_mapping_state,
        unflatten_mapping_state,
    )

    outs = {}
    for device in ("cuda", "cpu"):
        pipe = WildGSSLAMPipeline(device=device)
        gen = torch.Generator().manual_seed(0)
        depth = (2.0 + torch.rand((144, 256), generator=gen)).to(device)
        rgb = torch.rand((144, 256, 3), generator=gen).to(device)
        pose = torch.eye(4, device=device)
        focal = torch.tensor(230.4).to(device)
        with torch.no_grad():
            gmap = init_from_depth(rgb, depth, pose, focal, stride=2,
                                   max_gaussians=pipe.max_gaussians)
        net, (init_opt, step) = pipe._mapper()
        unc = {n: v.detach().clone() for n, v in net.named_parameters()}
        state = flatten_mapping_state(gmap, unc, init_opt(gmap, unc))
        names = list(unc)
        with torch.no_grad():
            g2, u2, o2, loss, _ = step(*unflatten_mapping_state(state, names), rgb, depth, pose,
                                       focal)
        outs[device] = [t.cpu() for t in (*flatten_mapping_state(g2, u2, o2), loss)]
        if device == "cuda":
            eng = pipe.mapping_engine(step, state, names, pipe.map_hw)
            replay = [t.cpu() for t in eng(*state, rgb, depth, pose, focal)]
            equal = all(torch.equal(a, b) for a, b in zip(replay, outs["cuda"]))
            build_s = eng.build_seconds
            pipe.release_engines()
    card, cpu = outs["cuda"], outs["cpu"]
    rec = {"phase": "slam", "path": "mapping_step_engine", "map_hw": [144, 256],
           "slots": card[0].shape[0], "replay_equals_eager": equal, "engine_build_s": build_s,
           "card_vs_cpu_loss_rel": rel(card[-1].numpy(), cpu[-1].numpy()),
           "card_vs_cpu_means_rel": rel(card[0].numpy(), cpu[0].numpy()),
           "loss": float(card[-1])}
    emit(rec)
    check(equal, "slam mapping step engine: replay differs from eager")
    check(rec["card_vs_cpu_loss_rel"] < PATH_FP32_REL_TOL
          and rec["card_vs_cpu_means_rel"] < PATH_FP32_REL_TOL,
          f"slam mapping step card vs cpu {rec}")


def slam_phase(build_pipeline, wrappers, card, power_limit, dev, raft, vits, unidepth, geocalib):
    """The SLAM recipes on the card: the analytic world (``slam_world``), the
    mapping step's engine (``slam_mapping_engine``), then ``megasam`` and
    ``wildgs_slam`` on a 24-frame 480x640 seeded clip with the default
    networks (the RAFT and DA-V2 vits pipelines built by earlier phases,
    through the recipes' injectable callables) and ``vipe`` (also UniDepth
    V2 vitb and GeoCalib), each with its counts set to 0 just before and
    read just after (each depth network's engines released before, so that
    its new 480x640 engine is counted); the solve's p50 on the served path
    at the clip's K and E, a mapping step's p50, and their replays'
    profiles. Returns the counts."""
    import numpy as np
    import torch

    from monocular_depth_estimation_trt_tpu_torch.config import BenchmarkConfig
    from monocular_depth_estimation_trt_tpu_torch.slam.ba import init_state
    from monocular_depth_estimation_trt_tpu_torch.slam.frontend import (
        make_pipeline_depth_fn,
        make_pipeline_flow_fn,
    )

    t_phase = time.perf_counter()
    slam_world(dev)
    slam_mapping_engine(dev)
    rng = np.random.default_rng(23)
    clip = [rng.integers(0, 256, SLAM_CLIP[1:] + (3,), dtype=np.uint8)
            for _ in range(SLAM_CLIP[0])]
    flow_fn, depth_fn = make_pipeline_flow_fn(raft), make_pipeline_depth_fn(vits)
    bench = BenchmarkConfig(**SLAM_BENCH)
    launches = {}
    for name, kw in (("megasam", {}), ("wildgs_slam", {}),
                     ("vipe", {"metric_depth_fn": make_pipeline_depth_fn(unidepth),
                               "calib_fn": lambda f: float(geocalib(f)["focal"])})):
        drop_engines(raft, vits, unidepth, geocalib)
        recipe = build_pipeline(name, flow_fn=flow_fn, depth_fn=depth_fn, **kw)
        torch.cuda.synchronize()
        set_counts_to_zero(wrappers)
        t0 = time.perf_counter()
        res = recipe.run(clip)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches[name] = launch_record(wrappers)
        k = len(res.keyframe_indices)
        disp = np.stack(res.keyframe_disparity)
        rec = {"phase": "slam", "path": name, "frames": list(SLAM_CLIP), "seconds": run_s,
               "keyframes": res.keyframe_indices, "rms_px": res.rms_px, "focal_px": res.focal,
               "poses_shape": list(res.poses.shape), "disparity_shape": list(disp.shape),
               "finite": bool(np.isfinite(res.poses).all() and np.isfinite(disp).all()),
               "launches": launches[name],
               "engines": sorted(e.name for e in recipe._engines.values())}
        if "metric_scale" in res.extras:
            rec["metric_scale"] = res.extras["metric_scale"]
        if "rendered_depth" in res.extras:
            rd = np.stack(res.extras["rendered_depth"])
            rec.update(rendered_depth_shape=list(rd.shape),
                       rendered_finite=bool(np.isfinite(rd).all()),
                       gaussians=int(res.extras["gaussians"].valid.sum()))
        if name != "vipe":
            # the served solve at the clip's K (E and P follow from K and the
            # flow size), then its replay's profile
            rep = recipe.benchmark_solve((288, 512), bench, k=k)
            rec["solve_p50_ms"] = rep.percentile_ms(50)
            rec["solve_mean_ms"] = rep.avg_ms
            prob = recipe._synthetic_problem((288, 512), k)
            e, p = prob.weight.shape
            rec["solve_K_E_P_D_M"] = [k, e, p, 8 * k + 1, e * p * 2]
            eng = recipe.solve_engine((288, 512), k, e, p)
            args = [t.to(dev) for t in (*prob, *init_state(k), torch.tensor(460.8))]
            # one solve (16,460 kernels; 3 until the export phase needed the card time)
            emit({**profile_breakdown(lambda: eng(*args), f"{name}_solve_k{k}", 1),
                  "route": "graph"})
        if name == "wildgs_slam":
            rep = recipe.benchmark((144, 256), bench)
            rec["mapping_step_p50_ms"] = rep.percentile_ms(50)
            rec["mapping_step_mean_ms"] = rep.avg_ms
            rec["mapping_steps"] = recipe.mapping_iters * k
            map_eng = next(e for key, e in recipe._engines.items() if key[0] == "map"
                           and key[1] == (144, 256) and key[2] == recipe.max_gaussians)
            emit({**profile_breakdown(lambda: map_eng(*map_eng._static_in), "wildgs_mapping_step",
                                      3), "route": "graph"})
        rec.update(card=card, power_limit=power_limit)
        emit(rec)
        check(rec["finite"] and res.poses.shape == (k, 4, 4) and disp.shape == (k, 480, 640),
              f"slam {name}: {rec}")
        want_k1 = 36 * (3 if name == "vipe" else 1)
        check(launches[name] == {**{kk: 0 for kk in KERNELS},
                                 "flash_attention_packed": want_k1},
              f"slam {name}: launches {launches[name]}, want {want_k1} K1")
        if name == "wildgs_slam":
            check(rec["rendered_finite"] and rec["rendered_depth_shape"] == [k, 144, 256],
                  f"slam wildgs_slam rendered depth {rec}")
        recipe.release_engines()
    drop_engines(raft, vits, unidepth, geocalib)
    emit({"phase": "slam_summary", "seconds": time.perf_counter() - t_phase,
          "launches": launches})
    return launches


TRACK_SLAM_CLI = ("data/example_video.mp4", 16, 288, 512)  # the fixture: frames, height, width


def track_slam_commands(tmp):
    """``track cotracker3`` and ``slam megasam --cvd`` on the repository's
    16-frame 512x288 MP4, on seeded random weights: their argvs, for
    ``cli_group_start``."""
    fixture = os.path.join(REPO, TRACK_SLAM_CLI[0])
    return [("track", "cotracker3", "--video", fixture, "--out", os.path.join(tmp, "track"),
             "--allow-random-weights"),
            ("slam", "megasam", "--video", fixture, "--out", os.path.join(tmp, "slam"), "--cvd",
             "--allow-random-weights")]


def check_track_slam_commands(tmp, outputs, rcs):
    """``track``: an MP4 of the source's frames and size; ``slam --cvd``: the
    JAX CLI's npz keys and the per-frame disparity. Without cv2 each exits 1
    naming the codec."""
    import numpy as np

    from monocular_depth_estimation_trt_tpu_torch.utils import imageio

    _, n, h, w = TRACK_SLAM_CLI
    rec = {"phase": "cli", "command": "track cotracker3, slam megasam --cvd (the video fixture)",
           "seconds": [sec for _, sec in outputs], "exit_codes": rcs,
           "cv2_importable": imageio.jpeg_available()}
    if not imageio.jpeg_available():
        named = "".join(out for out, _ in outputs).count("needs the cv2 (OpenCV) codec")
        emit({**rec, "codec_named": named})
        check(rcs == [1, 1] and named == 2, f"cli track/slam without cv2: {rcs}, named {named}")
        return
    cv2 = imageio.video_cv2("the tracks MP4")
    (mp4,) = os.listdir(os.path.join(tmp, "track"))
    cap = cv2.VideoCapture(os.path.join(tmp, "track", mp4))
    frames = 0
    while cap.read()[0]:
        frames += 1
    size = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    cap.release()
    slam_dir = os.path.join(tmp, "slam")
    npzs = sorted(os.listdir(slam_dir))
    main_npz = np.load(os.path.join(slam_dir, npzs[0]))
    cvd = np.load(os.path.join(slam_dir, npzs[1]))["disparity"]
    rec.update(track_mp4=mp4, track_frames=frames, track_size=list(size), slam_files=npzs,
               slam_keys=sorted(main_npz.files), keyframes=main_npz["keyframes"].tolist(),
               cvd_shape=list(cvd.shape), cvd_finite=bool(np.isfinite(cvd).all()))
    emit(rec)
    check(rcs == [0, 0], f"cli track/slam: exit codes {rcs}")
    check(mp4 == "example_video_cotracker3_384x512_win16_grid10_bf16.mp4" and frames == n
          and size == (w, h), f"cli track: {rec}")
    check(npzs == ["example_video_megasam_288x512_fp32.npz",
                   "example_video_megasam_288x512_fp32_cvd.npz"]
          and rec["slam_keys"] == sorted(["poses", "keyframes", "focal_px", "rms_px",
                                          "keyframe_disparity"])
          and cvd.shape == (n, h, w) and rec["cvd_finite"], f"cli slam: {rec}")


# VGGT's and StreamVGGT's artifacts: full widths, their ViT and aggregator
# cut to this many blocks (the whole models, whose export and load took
# about 50 s, until the script outgrew its time limit)
EXPORT_VGGT_DEPTH = 2
# the loaded artifacts' modules: launches [K3, K1, K2, K4] of one forward
# (VGGT's: one K1 per ViT block, one K2 per frame and per global block;
# StreamVGGT's step: its global attention over the cache is plain)
EXPORT_PER_FORWARD = {"vits_b1": [0, 12, 0, 0], "vitl_int8_b1": [0, 24, 0, 96],
                      "vits_nocard_b1_viz": [0, 12, 0, 0],
                      "vggt_views_s4": [0, EXPORT_VGGT_DEPTH, 2 * EXPORT_VGGT_DEPTH, 0],
                      "streamvggt_stream": [0, EXPORT_VGGT_DEPTH, EXPORT_VGGT_DEPTH, 0],
                      # one K3 a patch-encoder block, one K1 an image-encoder block
                      "depth_pro_b1": [24, 24, 0, 0]}
EXPORT_STREAM_STEPS = 8
EXPORT_BENCH = dict(warmup=5, iterations=30, latency_iterations=20)
# Depth Pro's artifact, for the card alone: the whole model, bf16, from the
# pipeline of the Depth Pro path (its export, load and first call take about
# 18 s of this phase on an H100 host; a fresh model cut to 2 blocks an
# encoder would save little, as its build and capture cost time too)
EXPORT_DEPTH_PRO_HW = (1536, 1536)


def nocard_commands(tmp, png):
    """The artifact built where no card is visible, and served on the CPU:
    DA-V2 vits 518² with its viz (the pipeline built on the CPU) exported
    for ``cpu,cuda``, for ``cpu`` alone and for ``cuda`` alone; then the
    two-platform file's CPU program on the frame (``run --engine --device
    cpu``) and the CPU pipeline on the same weights (``run
    depth_anything_v2``). Returns (the argvs, the paths by name)."""
    paths = {name: os.path.join(tmp, f"nocard_{name}.mdeteng")
             for name in ("cpu_cuda", "cpu", "cuda")}
    paths.update(run=os.path.join(tmp, "nocard_run"), pipeline=os.path.join(tmp, "nocard_pipe"))
    export = ["--device", "cpu", "--allow-random-weights", "export", "depth_anything_v2",
              "--encoder", "vits", "--size", "518", "--viz"]
    commands = [(*export, "--platforms", name.replace("_", ","), "--out", paths[name])
                for name in ("cpu_cuda", "cpu", "cuda")]
    commands += [("--device", "cpu", "run", "--engine", paths["cpu_cuda"], "--image", png,
                  "--out", paths["run"]),
                 ("--device", "cpu", "--allow-random-weights", "run", "depth_anything_v2",
                  "--encoder", "vits", "--image", png, "--out", paths["pipeline"])]
    return commands, paths


def npz_depth(out_dir):
    import numpy as np

    files = [f for f in os.listdir(out_dir) if f.endswith(".npz")]
    check(len(files) == 1, f"{out_dir}: npz files {sorted(os.listdir(out_dir))}")
    return np.load(os.path.join(out_dir, files[0]))["depth"]


def cli_in_process(argv):
    """The command line's ``main`` in this process: (exit code, stdout)."""
    import io

    from monocular_depth_estimation_trt_tpu_torch.cli import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(list(argv))
    return rc, out.getvalue()
# Python run first in the processes that serve the vits artifact: there the
# port's model zoo cannot be imported
NO_MODEL_ZOO = (
    "import importlib.abc\nimport sys\n"
    "class NoModelZoo(importlib.abc.MetaPathFinder):\n"
    "    def find_spec(self, name, path, target=None):\n"
    "        if name.startswith(('monocular_depth_estimation_trt_tpu_torch.models',\n"
    "                            'monocular_depth_estimation_trt_tpu_torch.registry')):\n"
    "            raise ImportError('the model zoo is not importable here: ' + name)\n"
    "sys.meta_path.insert(0, NoModelZoo())\n")


def op_trail(fn, args):
    """The aten ops that ``fn(*args)`` dispatches, in order, each with its
    output's shape and sum (run eagerly, outside any graph)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Trail(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor) and out.is_floating_point():
                self.ops.append((str(func), tuple(out.shape), out.double().sum().item()))
            return out

    with torch.inference_mode(), Trail() as trail:
        fn(*args)
    return trail.ops


def first_differing_op(here_fn, loaded_fn, args):
    """Where an artifact's eager forward first departs from the in-process
    eager forward on the same inputs: the index, and each side's op, shape
    and output sum there (None if the two trails agree, when only the
    captured graph differs)."""
    here, loaded = op_trail(here_fn, args), op_trail(loaded_fn, args)
    for i, (a, b) in enumerate(zip(here, loaded)):
        if a != b:
            return {"index": i, "in_process": a, "loaded": b}
    if len(here) != len(loaded):
        return {"index": min(len(here), len(loaded)), "in_process_ops": len(here),
                "loaded_ops": len(loaded)}
    return None


def replay_vs_in_process(label, got, want, attribute=None):
    """Each output of a loaded artifact against the in-process engine's:
    equal bit for bit, or within ENGINE_REL_TOL (max |a - b| / max |b|)
    and recorded with the first op that differs (``attribute()``)."""
    import numpy as np
    import torch

    rec = {}
    for k in want:
        a, b = (torch.as_tensor(np.asarray(t)) for t in (got[k], want[k]))
        equal = a.shape == b.shape and bool(torch.equal(a, b))
        entry = {"equal": equal}
        if not equal:
            af, bf = a.double(), b.double()
            entry["max_rel"] = finite_or_none(
                ((af - bf).abs().max() / bf.abs().max().clamp_min(1e-12)).item())
        rec[k] = entry
    if not all(r["equal"] for r in rec.values()) and attribute is not None:
        rec["first_differing_op"] = attribute()
    for k, r in rec.items():
        if k != "first_differing_op":
            check(r["equal"] or (r["max_rel"] or math.inf) <= ENGINE_REL_TOL,
                  f"export {label} {k}: loaded vs in-process {rec}")
    return rec


def artifact_process_start(path, commands, env):
    """Start one process of its own where the model zoo cannot be imported:
    ``commands`` (argvs of the command line, each with its stdout and
    seconds, as ``cli_group_start`` runs them), then ``serve --engine path``
    on a free local port with max batch 2, which the process serves until
    ``artifact_process`` sends SIGTERM (it drains and exits). Returns what
    ``artifact_process`` reads."""
    import atexit
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    serve_argv = ["serve", "--engine", path, "--host", "127.0.0.1", "--port", str(port),
                  "--max-batch", "2"]
    code = (NO_MODEL_ZOO + "import time\n"
            "from monocular_depth_estimation_trt_tpu_torch.cli import main\n"
            f"for argv in {[list(c) for c in commands]!r}:\n"
            "    print('@@ command', flush=True)\n"
            "    t0 = time.perf_counter()\n"
            "    rc = main(argv)\n"
            "    print('@@ exit', rc, time.perf_counter() - t0, flush=True)\n"
            "print('@@ serve', flush=True)\n"
            f"sys.exit(main({serve_argv!r}))\n")
    t0 = time.perf_counter()
    server = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    atexit.register(stop_process, server)
    return server, port, t0


def artifact_process(started, commands, pipe, rng):
    """The process of ``artifact_process_start`` once its commands have
    run: four sequential requests to its server at the served size (each a
    batch of one, the b1 module), the last through
    ``/v1/models/<name>/depth``, each answer against the in-process engine;
    then SIGTERM. Returns the serve record, the commands' outputs by argv
    and their exit codes."""
    import io
    import signal
    import urllib.request

    import numpy as np

    from monocular_depth_estimation_trt_tpu_torch.utils import imageio

    server, port, t0 = started
    base = f"http://127.0.0.1:{port}"
    answers = []
    try:
        while True:
            check(server.poll() is None, "the artifact's process exited before serving")
            check(time.perf_counter() - t0 < 600, "serve --engine not up in 600 s")
            try:
                urllib.request.urlopen(f"{base}/v1/health", timeout=5).read()
                break
            except OSError:
                time.sleep(1.0)
        # from the start to the first answer asked for (the process is up
        # well before: it starts during the int8 phases)
        up_s = time.perf_counter() - t0
        hw = tuple(pipe.spec.input_hw)
        for i, url in enumerate([f"{base}/v1/depth"] * 3
                                + [f"{base}/v1/models/{pipe.spec.model}/depth"]):
            sent = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
            status, body = post(url, imageio.encode_png(sent))
            check(status == 200, f"serve --engine request {i}: HTTP {status} {body[:200]!r}")
            answers.append(replay_vs_in_process(
                f"serve --engine request {i}", {"depth": np.load(io.BytesIO(body))["depth"]},
                {"depth": pipe(sent)["depth"]}))
    finally:
        server.send_signal(signal.SIGTERM)
        try:
            out, err = server.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            server.kill()
            out, err = server.communicate()
    check(server.returncode == 0, f"serve --engine exited {server.returncode}: {err[-2000:]}")
    parts = out.split("@@ serve\n")[0].split("@@ command\n")[1:]
    check(len(parts) == len(commands), f"the artifact's commands: {out[-1500:]}{err[-1500:]}")
    ends = [p.rsplit("@@ exit ", 1)[1].split() for p in parts]
    outputs = {tuple(c): (p, float(e[1])) for c, p, e in zip(commands, parts, ends)}
    return ({"healthy_when_asked_after_seconds": up_s, "answers": answers,
             "exit_code": server.returncode},
            outputs, [int(e[0]) for e in ends])


def export_phase(pipe, build_pipeline, wrappers, card, power_limit):
    """Serialized artifacts (``runtime/export.py``) of pipelines that earlier
    phases built: DA-V2 vits 518² bf16 as a serve bundle (b1, b2, both viz
    modes), DA-V2 vitl int8 b1 (sent in); and of VGGT's 4-view module and
    StreamVGGT's stream (window 4, 480x640, 8 steps), both at full widths
    with EXPORT_VGGT_DEPTH blocks (seeded random weights). Each is exported,
    loaded, and its first call counted (the counts set to 0 just before:
    WARMUP_CALLS + 1 forwards of EXPORT_PER_FORWARD); every loaded replay
    against the in-process engine's output (``replay_vs_in_process``); the
    loaded and in-process vits p50 in turns. From the vits artifact's turns
    on, the vits artifact in a process of its own where the model zoo
    cannot be imported: ``run --engine`` (its npz
    depth against the in-process engine), ``bench --engine``, ``bench
    --engine --trace`` (the trace names K1's kernel) and ``serve --engine``
    (answers to sequential requests against in-process calls). These are
    exported for the card alone. Beside them, DA-V2 vits 518² with its viz
    exported in a process that sees no card (``CUDA_VISIBLE_DEVICES=""``,
    ``nocard_commands``) for ``cpu,cuda``, ``cpu`` and ``cuda``: its cuda
    program loaded here and counted, its replay and p50 against the
    in-process engine, its cpu program's depth against the CPU pipeline's;
    ``run --engine`` of the cpu-only file on the card exits 2 naming
    ``--platforms``, and the cpu,cuda file serves ``--device cuda``; and
    the whole Depth Pro 1536² bf16 (K3; sent in) exported, loaded, counted
    and released with its file. A generator in two parts: the first
    ``next`` exports the vits artifact, reads its turns and starts its
    process and the card-less one, which work through the int8 phases
    (correctness only: the bench lines share the card); ``send((vitl_int8,
    depth_pro))`` runs the rest and yields the counted launches of each
    module."""
    import atexit
    import gc
    import shutil

    import numpy as np
    import torch

    from monocular_depth_estimation_trt_tpu_torch.config import BenchmarkConfig
    from monocular_depth_estimation_trt_tpu_torch.runtime import native
    from monocular_depth_estimation_trt_tpu_torch.runtime.export import (
        export_pipeline,
        load_engine,
        read_meta,
    )
    from monocular_depth_estimation_trt_tpu_torch.utils import imageio

    t_phase = time.perf_counter()
    rng = np.random.default_rng(14)
    tmp = tempfile.mkdtemp(prefix="mdet_export_")
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    launches, artifacts = {}, {}

    def made(label, source, **kw):
        t0 = time.perf_counter()
        path = export_pipeline(source, path=os.path.join(tmp, f"{label}.mdeteng"), **kw)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng = load_engine(path)
        rec = {"export_seconds": export_s, "artifact_mb": os.path.getsize(path) / 1e6,
               "load_seconds": time.perf_counter() - t0, "modules": sorted(eng.meta["modules"]),
               "weights": len(eng.meta["param_manifest"])}
        artifacts[label] = rec
        return path, eng, rec

    def counted(label, eng, key, call):
        """``call()`` builds the module's engine: its launches, counted."""
        set_counts_to_zero(wrappers)
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        got, per = counts(wrappers), engine_launches(eng._engine(key))
        launches[label] = launch_record(wrappers)
        want = EXPORT_PER_FORWARD[label]
        check(per == want and got == [(WARMUP_CALLS + 1) * n for n in want],
              f"export {label}: launches {got} for a new engine whose forward launches {per}, "
              f"want {want} a forward")
        return out, {"first_call_seconds": first, "launches_per_forward": per}

    try:
        # DA-V2 vits, the serve bundle
        frame = rng.integers(0, 256, (518, 518, 3), dtype=np.uint8)
        frames2 = rng.integers(0, 256, (2, 518, 518, 3), dtype=np.uint8)
        path_vits, vits, rec = made("vits", pipe, in_hw=(518, 518), with_viz="both",
                                    batches=(1, 2), platforms=("cuda",))
        out, counted_rec = counted("vits_b1", vits, "b1", lambda: vits(frame))
        rec.update(counted_rec)
        dev_frame = torch.from_numpy(frame).to(pipe.device)
        rec["vs_in_process"] = {
            "b1": replay_vs_in_process("vits b1", out, pipe(frame), lambda: first_differing_op(
                p_eager(pipe, (518, 518)), lambda x: vits._programs["b1"](vits._weights, x),
                (dev_frame,))),
            "b1_viz": replay_vs_in_process("vits b1_viz", vits(frame, viz=True),
                                           pipe(frame, viz=True)),
            "b2": replay_vs_in_process("vits b2", vits.batch_call(frames2),
                                       pipe.batch_call(frames2))}
        cfg = BenchmarkConfig(**EXPORT_BENCH)
        p50 = {"in_process": [], "loaded": []}
        for route, p in (("in_process", pipe), ("loaded", vits), ("loaded", vits),
                         ("in_process", pipe)):
            p50[route].append(p.benchmark((518, 518), cfg).percentile_ms(50))
        rec["p50_ms_in_turns"] = p50
        vits.release_engines()
        del vits

        # the vits artifact in a process where the model zoo cannot be
        # imported, at work from the int8 phases on (its bench lines share
        # the card with them)
        png = os.path.join(tmp, "frame.png")
        imageio.write_image(png, frame)
        # the artifact built with no card visible: its process works on the
        # host's cores from here on, through the int8 phases
        nocard_argvs, nocard = nocard_commands(tmp, png)
        nocard_proc = cli_group_start(nocard_argvs, {**env, "CUDA_VISIBLE_DEVICES": "",
                                                     "OMP_NUM_THREADS": "4"})
        atexit.register(stop_process, nocard_proc)
        out_run, trace_dir = os.path.join(tmp, "run"), os.path.join(tmp, "trace")
        run_argv = ("run", "--engine", path_vits, "--image", png, "--out", out_run)
        bench_argv = ("bench", "--engine", path_vits, "--warmup", "5", "--iterations", "30")
        trace_argv = ("bench", "--engine", path_vits, "--warmup", "2", "--iterations", "5",
                      "--trace", trace_dir)
        doctor_argv = ("doctor",)
        artifact_argvs = [run_argv, bench_argv, trace_argv, doctor_argv]
        started = artifact_process_start(path_vits, artifact_argvs, env)
        first_part_s = time.perf_counter() - t_phase
        vitl_int8, depth_pro = yield
        t_phase = time.perf_counter()

        # the artifact built with no card: its process's records, then its
        # cuda program loaded here, counted, against the in-process engine
        outputs, rcs = cli_group_result(nocard_proc, nocard_argvs)
        check(rcs == [0] * len(nocard_argvs), f"export: the card-less commands exited {rcs}")
        check(nocard_proc.preamble.split() == ["@@", "cuda", "False", "0"],
              f"export: the card-less process saw {nocard_proc.preamble!r}")
        metas = {name: read_meta(nocard[name]) for name in ("cpu_cuda", "cpu", "cuda")}
        t0 = time.perf_counter()
        eng = load_engine(nocard["cpu_cuda"], "cuda")
        rec = {"process_saw": nocard_proc.preamble.strip(),
               "platforms": {name: m["platforms"] for name, m in metas.items()},
               "export_seconds_by_platform": {
                   name: m["export_seconds_by_platform"] for name, m in metas.items()},
               "export_command_seconds": {name: outputs[argv][1] for name, argv in
                                          zip(("cpu_cuda", "cpu", "cuda"), nocard_argvs)},
               "artifact_mb": {name: os.path.getsize(nocard[name]) / 1e6 for name in metas},
               "load_seconds": time.perf_counter() - t0,
               "modules": sorted(eng.meta["modules"])}
        artifacts["vits_nocard"] = rec
        out, counted_rec = counted("vits_nocard_b1_viz", eng, "b1_viz",
                                   lambda: eng(frame, viz=True))
        dev_frame = torch.from_numpy(frame).to(pipe.device)
        rec.update(counted_rec, vs_in_process={"b1_viz": replay_vs_in_process(
            "vits (exported with no card) b1_viz", out, pipe(frame, viz=True),
            lambda: first_differing_op(
                lambda x: pipe._eager(x, (518, 518), True),
                lambda x: eng._programs["b1_viz"](eng._weights, x), (dev_frame,)))})
        p50 = {"in_process": [], "loaded": []}
        cfg = BenchmarkConfig(**EXPORT_BENCH)
        for route, p in (("in_process", pipe), ("loaded", eng), ("loaded", eng),
                         ("in_process", pipe)):
            p50[route].append(p.benchmark((518, 518), cfg).percentile_ms(50))
        rec["p50_ms_in_turns"] = p50
        eng.release_engines()
        del eng
        # the CPU program against the CPU pipeline, both in the card-less process
        cpu_run, cpu_pipe = npz_depth(nocard["run"]), npz_depth(nocard["pipeline"])
        check(np.array_equal(cpu_run, cpu_pipe),
              "export: the card-less artifact's cpu program differs from the CPU pipeline "
              f"(max |a - b| {np.abs(cpu_run.astype(np.float64) - cpu_pipe).max()})")
        # --device picks the program: a cpu-only file under the default
        # --device cuda exits 2 naming --platforms; the cpu,cuda file serves
        # the card's program (the card pipeline's depth)
        rc, refused = cli_in_process(("run", "--engine", nocard["cpu"], "--image", png,
                                      "--out", os.path.join(tmp, "refused")))
        check(rc == 2 and "--platforms including cuda" in refused,
              f"export: run --engine of a cpu-only artifact on the card exited {rc}: {refused}")
        card_run = os.path.join(tmp, "nocard_card_run")
        rc, text = cli_in_process(("--device", "cuda", "run", "--engine", nocard["cpu_cuda"],
                                   "--image", png, "--out", card_run))
        check(rc == 0 and "device=cuda" in text, f"export: run --engine --device cuda: {text}")
        rec["device_flag"] = {
            "cpu_only_on_the_card": {"exit_code": 2, "hint": [
                ln for ln in refused.splitlines() if "--platforms" in ln][:1]},
            "cpu_program_vs_cpu_pipeline_equal": True,
            "cuda_program_vs_card_pipeline": replay_vs_in_process(
                "run --engine --device cuda", {"depth": npz_depth(card_run)},
                {"depth": pipe(frame, viz=True)["depth"]})}
        gc.collect()

        # DA-V2 vitl int8, b1
        _, eng, rec = made("vitl_int8", vitl_int8, in_hw=(518, 518), platforms=("cuda",))
        out, counted_rec = counted("vitl_int8_b1", eng, "b1", lambda: eng(frame))
        rec.update(counted_rec, vs_in_process={"b1": replay_vs_in_process(
            "vitl int8 b1", out, vitl_int8(frame))})
        eng.release_engines()
        del eng

        # VGGT, the 4-view module alone
        cut = family_cut_kw("litevggt", EXPORT_VGGT_DEPTH)  # VGGT's graph
        vggt = build_pipeline("vggt", **cut)
        views4 = rng.integers(0, 256, (4, 518, 518, 3), dtype=np.uint8)
        _, eng, rec = made("vggt", vggt, in_hw=(518, 518), batches=(), views=(4,),
                           platforms=("cuda",))
        out, counted_rec = counted("vggt_views_s4", eng, "views_s4",
                                   lambda: eng.multi_view(views4))
        rec.update(counted_rec, vs_in_process={"views_s4": replay_vs_in_process(
            "vggt views_s4", out, vggt.multi_view(views4))})
        eng.release_engines()
        drop_engines(vggt)
        del eng, vggt

        # StreamVGGT, the stream alone: 8 steps, the ring wraps after 4
        streamvggt = build_pipeline("streamvggt", **cut)
        clip = rng.integers(0, 256, (EXPORT_STREAM_STEPS, 480, 640, 3), dtype=np.uint8)
        _, eng, rec = made("streamvggt", streamvggt, in_hw=(480, 640), batches=(),
                           stream_window=4, platforms=("cuda",))
        runner, here = eng.stream(), streamvggt.stream(window=4)
        out, counted_rec = counted("streamvggt_stream", eng, "stream", lambda: runner(clip[0]))
        steps = [replay_vs_in_process("streamvggt step 0", out, here(clip[0]))]
        for i in range(1, EXPORT_STREAM_STEPS):
            steps.append(replay_vs_in_process(f"streamvggt step {i}", runner(clip[i]),
                                              here(clip[i])))
        rec.update(counted_rec, vs_in_process={"steps": steps})
        eng.release_engines()
        here.session.release_engines()
        drop_engines(pipe, vitl_int8, streamvggt)
        del eng, runner, here, streamvggt

        # Depth Pro, for the card alone (K3's first artifact): exported,
        # loaded, its first call counted, its replay against the in-process
        # engine; both engines and the file released at once
        dp_frame = rng.integers(0, 256, (*EXPORT_DEPTH_PRO_HW, 3), dtype=np.uint8)
        path_dp, eng, rec = made("depth_pro", depth_pro, in_hw=EXPORT_DEPTH_PRO_HW,
                                 platforms=("cuda",))
        out, counted_rec = counted("depth_pro_b1", eng, "b1", lambda: eng(dp_frame))
        eng.release_engines()  # one 1536² graph pool at a time
        want = depth_pro(dp_frame)
        drop_engines(depth_pro)
        dev_frame = torch.from_numpy(dp_frame).to(depth_pro.device)
        rec.update(counted_rec, platforms=eng.meta["platforms"],
                   vs_in_process={"b1": replay_vs_in_process(
                       "depth_pro b1", out, want, lambda: first_differing_op(
                           p_eager(depth_pro, EXPORT_DEPTH_PRO_HW),
                           lambda x: eng._programs["b1"](eng._weights, x), (dev_frame,)))})
        os.remove(path_dp)
        del eng, depth_pro, dev_frame

        serve, outputs, rcs = artifact_process(started, artifact_argvs, pipe, rng)
        check(rcs == [0, 0, 0, 0], f"export: the vits artifact's commands exited {rcs}")
        doctor = [ln for ln in outputs[doctor_argv][0].splitlines() if " : " in ln]
        npz = [f for f in os.listdir(out_run) if f.endswith(".npz")]
        check(len(npz) == 1, f"export: run --engine wrote {sorted(os.listdir(out_run))}")
        run_depth = np.load(os.path.join(out_run, npz[0]))["depth"]
        traces = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
        check(len(traces) == 1, f"export: bench --trace wrote {traces}")
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        k1_events = [e for e in events if "attn_packed_kernel" in str(e.get("name", ""))]
        check(k1_events, "export: the bench --trace file names no K1 kernel")
        processes = {
            "run_vs_in_process": replay_vs_in_process("run --engine", {"depth": run_depth},
                                                      {"depth": pipe(frame, viz=True)["depth"]}),
            "seconds": {argv[0] + (" --trace" if "--trace" in argv else ""): outputs[argv][1]
                        for argv in (run_argv, bench_argv, trace_argv)},
            "bench_lines": [ln for ln in outputs[bench_argv][0].splitlines()
                            if "FPS" in ln or "latency" in ln or "inference time" in ln],
            "trace_k1_kernel_events": len(k1_events),
            "trace_k1_kernel": k1_events[0]["name"],
            "serve": serve,
            "doctor": doctor,
        }
        # which host IO the offline batching and JPEG writes take here
        native_io = "native" if native.native_available() else "python"
        drop_engines(pipe)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "export", "card": card, "power_limit": power_limit,
          "artifacts": artifacts, "processes": processes, "launches": launches,
          "native_host_io": native_io, "first_part_seconds": first_part_s,
          "seconds": time.perf_counter() - t_phase})
    yield {f"export_{label}": counted_launches for label, counted_launches in launches.items()}


TRAIN_SIZE, TRAIN_BATCH, TRAIN_LR = 266, 4, 3e-4  # the distill command's defaults
TRAIN_FRAMES = 8  # seeded 480x640 PNGs: two batch positions
TRAIN_STEPS = 3  # card against CPU, each from the card's state; warmup 1: rates 0, lr, lr / 2
TRAIN_TIMED = (3, 20)  # warm-up and timed steps of the speed reading
TRAIN_REL_TOL = 1e-4  # losses and gradient norms, fp32 card against CPU
# the parameters after the steps, |card - CPU| in units of lr: the 99.9th
# percentile and the largest (tests/test_torch_training.py's bar for the
# port against JAX: Adam turns fp32 differences of a near-zero gradient into
# a part of a step)
TRAIN_PARAM_P999, TRAIN_PARAM_MAX = 0.02, 0.5
# The QAT step: fake quantization rounds each of some 70 M activations, and
# card and CPU activations differ by fp32 rounding, so a few roundings fall
# the other way: the loss moves little (rel 4.5e-7 on an H100, PERF.md §6),
# the gradient more (its norm 6.6e-3), and Adam's first step moves an
# element by +-lr whatever its gradient's size, so an element whose gradient
# changes sign lands 2 lr away (99.9th percentile 1.86 lr, 1.9 % of the
# elements more than half a step apart). Held: the loss at TRAIN_REL_TOL,
# the gradient norm and that share at about 2.5 times their readings.
QAT_GRAD_NORM_REL_TOL, QAT_SPLIT_SHARE = 2e-2, 5e-2
QUANTCHECK_IMAGES = 2
VITS_ARTIFACT = "depth_anything_v2_vits_518x518_bf16"


def student_on_host(seed: int = 0):
    """The ``distill`` command's student before it moves: a fresh fp32 DA-V2
    vits on the plain attention route, seeded random weights made on the
    host."""
    import torch

    from monocular_depth_estimation_trt_tpu_torch.models.depth_anything_v2 import (
        DepthAnythingV2,
    )
    from monocular_depth_estimation_trt_tpu_torch.weights.store import init_random_

    with torch.device("meta"):
        model = DepthAnythingV2("vits", attn_impl="xla")
    model = model.to_empty(device="cpu")
    init_random_(model, seed)
    return model


def synced_steps(model, card_batches, cpu_batches, steps, tx, dev, qat=False):
    """``steps`` distillation steps of copies of ``model`` (QAT layers
    installed where asked) on the card and on the CPU over the batches in
    turn, the CPU's parameters, moments and schedule position set to the
    card's before each step, so that each step starts from the same state on
    both: per step the two losses and gradient norms and the parameters'
    difference after it (``param_readings``)."""
    import copy

    import torch

    from monocular_depth_estimation_trt_tpu_torch.ops.quant import install_qat
    from monocular_depth_estimation_trt_tpu_torch.training import (
        create_train_state,
        make_distill_step,
    )
    from monocular_depth_estimation_trt_tpu_torch.training.distill import depth_student

    sides = []
    for batches, where in ((card_batches, dev), (cpu_batches, torch.device("cpu"))):
        m = copy.deepcopy(model).to(where)
        if qat:
            install_qat(m, m.int8_targets())
        sides.append((make_distill_step(depth_student(m, TRAIN_SIZE)),
                      create_train_state(dict(m.named_parameters()), tx()), batches))
    (card_step, card, card_b), (cpu_step, cpu, cpu_b) = sides
    readings = []
    for i in range(steps):
        with torch.no_grad():
            for k, p in cpu.params.items():
                p.copy_(card.params[k])
        # a copy: on one device the load would share the card's moments
        cpu.optimizer.load_state_dict(copy.deepcopy(card.optimizer.state_dict()))
        cpu.scheduler.load_state_dict(card.scheduler.state_dict())
        card, mc = card_step(card, card_b[i % len(card_b)])
        cpu, mp = cpu_step(cpu, cpu_b[i % len(cpu_b)])
        got = {k: (float(mc[k]), float(mp[k])) for k in ("loss", "grad_norm")}
        readings.append({**{f"{k}_card_cpu": v for k, v in got.items()},
                         **{f"{k}_rel": abs(v[0] - v[1]) / abs(v[1]) for k, v in got.items()},
                         **param_readings(card, cpu, TRAIN_LR)})
    return readings


def param_readings(card_state, cpu_state, lr):
    """|card - CPU| of every parameter in units of ``lr``: the 99.9th
    percentile and the largest."""
    import numpy as np

    diff = np.concatenate([(p.detach().cpu() - cpu_state.params[k].detach()).abs().flatten()
                           .numpy() for k, p in card_state.params.items()]) / lr
    return {"params_p999_lr": float(np.quantile(diff, 0.999)),
            "params_max_lr": float(diff.max()),
            "params_frac_over_half_lr": float(np.mean(diff > 0.5))}


def training_commands(tmp, images, png, pth, renamed, pred_npz, gt_npz):
    """The accuracy and training commands, in one process (``cli_group_start``):
    ``distill --promote``, ``run`` on the promoted weights, ``convert`` of a
    good and a renamed ``.pth``, ``quantcheck``, ``eval``, ``run
    --colorbar``."""
    return [("--allow-random-weights", "distill", "--images-dir", images, "--steps", "20",
             "--promote", "--out", os.path.join(tmp, "distill")),
            ("run", "depth_anything_v2", "--encoder", "vits", "--image", png, "--out",
             os.path.join(tmp, "run")),
            ("convert", "depth_anything_v2", "--encoder", "vits", "--checkpoint", pth,
             "--verify-manifest"),
            ("convert", "depth_anything_v2", "--encoder", "vits", "--checkpoint", renamed,
             "--verify-manifest"),
            ("--allow-random-weights", "quantcheck", "depth_anything_v2", "--encoder", "vitl",
             "--images", images, "--max-images", str(QUANTCHECK_IMAGES)),
            ("eval", "--pred", pred_npz, "--gt", gt_npz, "--align", "affine"),
            ("--allow-random-weights", "run", "depth_anything_v2", "--encoder", "vits",
             "--metric", "--image", png, "--out", os.path.join(tmp, "bar"), "--colorbar")]


def quantcheck_report(bf16, int8, images):
    """``quantcheck``'s report computed in this process."""
    import numpy as np
    import torch

    from monocular_depth_estimation_trt_tpu_torch.training.metrics import depth_metrics
    from monocular_depth_estimation_trt_tpu_torch.utils.imageio import read_image

    sums, corr = {}, []
    for path in images:
        img = read_image(path)
        df = np.asarray(bf16(img)["depth"], np.float32)
        dq = np.asarray(int8(img)["depth"], np.float32)
        m = depth_metrics(torch.from_numpy(dq)[None], torch.from_numpy(df)[None])
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        corr.append(float(np.corrcoef(dq.ravel(), df.ravel())[0, 1]))
    n = len(images)
    return {"metric": f"{int8.spec.artifact_name()}_vs_bf16", "images": n,
            "corr": round(float(np.mean(corr)), 5),
            **{k: round(v / n, 5) for k, v in sums.items()}}


def training_phase(teacher, build_pipeline, wrappers, card, power_limit, dev):
    """Phase 15 (see the module docstring). ``teacher``: the default vitl bf16
    pipeline, seed-0 random weights, as ``distill`` builds its teacher. A
    generator in two parts: the first ``next`` labels the frames, writes the
    commands' inputs and starts their process (during the export phase); the
    second runs the rest and yields the launches of its counted runs."""
    import atexit
    import copy
    import json as json_
    import shutil

    import numpy as np
    import torch

    from monocular_depth_estimation_trt_tpu_torch.training import (
        create_train_state,
        depth_metrics,
        make_distill_step,
    )
    from monocular_depth_estimation_trt_tpu_torch.training.distill import depth_student
    from monocular_depth_estimation_trt_tpu_torch.training.trainer import (
        adamw,
        warmup_cosine_decay_schedule,
    )
    from monocular_depth_estimation_trt_tpu_torch.utils import imageio
    from monocular_depth_estimation_trt_tpu_torch.utils.files import list_images

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mdet_train_")
    rng = np.random.default_rng(15)
    size, b = TRAIN_SIZE, TRAIN_BATCH
    try:
        images = os.path.join(tmp, "frames")
        os.makedirs(images)
        for i in range(TRAIN_FRAMES):
            coarse = rng.integers(0, 256, (480 // 16, 640 // 16, 3), dtype=np.uint8)
            imageio.write_image(os.path.join(images, f"f{i}.png"),
                                np.repeat(np.repeat(coarse, 16, 0), 16, 1))
        paths = list_images(images)
        # as the command loads them: read, resized to the training size
        frames = np.stack([imageio.resize(imageio.read_image(p), (size, size)) for p in paths])
        chunks = [frames[i:i + b] for i in range(0, len(frames), b)]

        # the teacher's labelling run, counted: a new (266, 266) batch-4 engine
        set_counts_to_zero(wrappers)
        first, per = run_counted(lambda: teacher.batch_call(chunks[0], device_out=True),
                                 lambda: teacher.batch_engine_for((size, size), b, False),
                                 wrappers, "teacher labels")
        launches = launch_record(wrappers)
        check(per == [0, 24, 0, 0], f"teacher launches per forward {per}, want 24 K1")
        labels = [first["depth"]] + [teacher.batch_call(c, device_out=True)["depth"]
                                     for c in chunks[1:]]
        check(all(bool(torch.isfinite(lb).all()) and lb.shape == (b, size, size)
                  for lb in labels), "teacher labels")
        card_batches = [(torch.from_numpy(c).to(dev), lb.clone()) for c, lb in zip(chunks, labels)]
        cpu_batches = [(torch.from_numpy(c), lb.cpu()) for c, lb in zip(chunks, labels)]

        # eval's inputs: the untrained student's depth against the teacher's
        host = student_on_host()
        card_model = copy.deepcopy(host).to(dev)
        with torch.no_grad():
            eval_pred = depth_student(card_model, size)(
                dict(card_model.named_parameters()), card_batches[0][0])[0].cpu().numpy()
        eval_gt = labels[0][0].cpu().numpy()

        # the commands start in a process of their own, on a temporary
        # cache, while this process exports artifacts and then runs the
        # card-vs-CPU steps (mostly the host's time); the speed readings
        # wait until they have ended
        cache = os.path.join(tmp, "cache")
        env = {**os.environ, "MDET_CACHE_DIR": cache,
               "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
        seeded = {k: v.detach() for k, v in student_on_host(3).state_dict().items()}
        pth, renamed = os.path.join(tmp, "vits.pth"), os.path.join(tmp, "renamed.pth")
        torch.save(seeded, pth)
        torch.save({("pretrained.blocks.3.attn.qkv2.weight"
                     if k == "pretrained.blocks.3.attn.qkv.weight" else k): v
                    for k, v in seeded.items()}, renamed)
        pred_npz, gt_npz = os.path.join(tmp, "pred.npz"), os.path.join(tmp, "gt.npz")
        np.savez(pred_npz, depth=eval_pred)
        np.savez(gt_npz, depth=eval_gt)
        commands = training_commands(tmp, images, paths[0], pth, renamed, pred_npz, gt_npz)
        proc = cli_group_start(commands, env)
        atexit.register(stop_process, proc)
        start_s = time.perf_counter() - t0
        try:
            yield
            t0 = time.perf_counter()
            # 3 steps on the card against the same 3 on the CPU, each from
            # the card's state; one QAT step
            parity = {}
            for label, steps, tx, qat in (
                    ("fp32", TRAIN_STEPS, lambda: adamw(warmup_cosine_decay_schedule(
                        0.0, TRAIN_LR, 1, TRAIN_STEPS)), False),
                    ("qat", 1, lambda: adamw(TRAIN_LR), True)):
                parity[label] = synced_steps(host, card_batches, cpu_batches, steps, tx, dev,
                                             qat)
                for i, r in enumerate(parity[label]):
                    if qat:
                        held = (r["grad_norm_rel"] < QAT_GRAD_NORM_REL_TOL
                                and r["params_frac_over_half_lr"] <= QAT_SPLIT_SHARE)
                    else:
                        held = (r["grad_norm_rel"] < TRAIN_REL_TOL
                                and r["params_p999_lr"] <= TRAIN_PARAM_P999
                                and r["params_max_lr"] <= TRAIN_PARAM_MAX)
                    check(r["loss_rel"] < TRAIN_REL_TOL and held,
                          f"training {label} step {i}: card vs CPU {r}")
            outputs, rcs = cli_group_result(proc, commands)
        finally:
            if proc.poll() is None:  # a failed check: stop the commands' process
                proc.kill()
                proc.wait()
        out = [outputs[tuple(c)][0] for c in commands]
        seconds = [outputs[tuple(c)][1] for c in commands]
        check(rcs[:4] == [0, 0, 0, 2] and rcs[4] in (0, 3) and rcs[5] == 0
              and rcs[6] in (0, 1), f"training commands' exit codes {rcs}")

        # speed: the card's step, the teacher's labelling of a batch
        step = make_distill_step(depth_student(card_model, size))
        state = create_train_state(dict(card_model.named_parameters()), adamw(TRAIN_LR))
        warm, timed = TRAIN_TIMED
        for i in range(warm):
            step(state, card_batches[i % 2])
        step_ms = timed_p50(lambda: step(state, card_batches[0]), timed)
        teacher_ms = timed_p50(lambda: teacher.batch_call(chunks[0], device_out=True), 10)
        prof = profile_breakdown(lambda: step(state, card_batches[0]),
                                 f"distill_student_vits_{size}_b{b}_fp32", iters=3)
        emit({**prof, "route": "eager (training step)"})
        del state, step, card_model, host

        # run serves the promoted weights
        promoted = torch.load(os.path.join(tmp, "distill", "distill_depth_anything_v2_vits.pt"),
                              map_location="cpu", weights_only=True)["params"]
        served = np.load(os.path.join(tmp, "run", f"f0_{VITS_ARTIFACT}.npz"))["depth"]
        in_process = build_pipeline("depth_anything_v2", encoder="vits", params=promoted)
        want = in_process(imageio.read_image(paths[0]))["depth"]
        check(np.array_equal(served, want), "run: the promoted weights' depth differs")
        drop_engines(in_process)
        del in_process
        cached = torch.load(os.path.join(cache, "params", f"{VITS_ARTIFACT}.pt"),
                            map_location="cpu", weights_only=True)
        check(sorted(cached) == sorted(seeded)
              and all(torch.equal(cached[k], seeded[k]) for k in seeded),
              "convert: the params cache does not hold the checkpoint's tensors")
        distill_losses = [ln for ln in out[0].splitlines() if "distill step" in ln]
        # the command's student runs in full fp32, as this process's steps do
        student_line = [ln for ln in out[0].splitlines() if " as fp32 on cuda" in ln]
        check(len(student_line) == 1
              and student_line[0].endswith("TF32 matmul=False cudnn=False"),
              f"distill: the student is not in full fp32 on the card: {student_line}")

        # quantcheck against this process's pipelines, on the subprocess's
        # int8 bundle (the same temporary cache); the int8 run counted
        report = json_.loads([ln for ln in out[4].splitlines() if ln.startswith("{")][-1])
        prev_cache = os.environ.get("MDET_CACHE_DIR")
        os.environ["MDET_CACHE_DIR"] = cache
        try:
            int8 = build_pipeline("depth_anything_v2", encoder="vitl", precision="int8")
        finally:
            if prev_cache is None:
                os.environ.pop("MDET_CACHE_DIR")
            else:
                os.environ["MDET_CACHE_DIR"] = prev_cache
        first_img = imageio.read_image(paths[0])
        set_counts_to_zero(wrappers)
        _, per8 = run_counted(lambda: int8(first_img), lambda: int8.engine_for(
            first_img.shape[:2], False), wrappers, "quantcheck int8")
        int8_launches = launch_record(wrappers)
        check(per8 == [0, 24, 0, 96], f"quantcheck int8 launches per forward {per8}")
        mine = quantcheck_report(teacher, int8, paths[:QUANTCHECK_IMAGES])
        check(report == mine, f"quantcheck: {report} vs this process's {mine}")
        check(rcs[4] == (0 if report["delta1"] > 0.95 else 3),
              f"quantcheck exit {rcs[4]} for delta1 {report['delta1']}")
        drop_engines(int8)
        del int8

        # eval against this process's metrics
        got = json_.loads([ln for ln in out[5].splitlines() if ln.startswith("{")][-1])
        m = depth_metrics(torch.from_numpy(eval_pred)[None], torch.from_numpy(eval_gt)[None],
                          align="affine")
        want_eval = {**{k: round(float(v), 5) for k, v in m.items()}, "n_images": 1,
                     "align": "affine"}
        check(got == want_eval, f"eval: {got} vs this process's {want_eval}")

        bar_files = sorted(os.listdir(os.path.join(tmp, "bar"))) if os.path.isdir(
            os.path.join(tmp, "bar")) else []
        colorbar = ("written" if rcs[6] == 0 and any(f.endswith("_depth_bar.jpg")
                                                     for f in bar_files)
                    else "exit 1 naming matplotlib" if rcs[6] == 1
                    and "--colorbar needs matplotlib" in out[6] else None)
        check(colorbar is not None, f"run --colorbar: exit {rcs[6]}, files {bar_files}")
        emit({"phase": "training", "card": card, "power_limit_w": power_limit,
              "student": f"depth_anything_v2 vits fp32 {size}x{size} batch {b}, plain attention",
              "teacher": teacher.spec.artifact_name(), "teacher_launches": launches,
              "teacher_launches_per_forward": per, "parity": parity,
              "step_p50_ms": step_ms, "images_per_s": b / (step_ms / 1e3),
              "teacher_label_ms_per_batch": teacher_ms,
              "device_idle_share": prof.get("device_idle_share"),
              "commands": [" ".join(c[:3]) for c in commands], "exit_codes": rcs,
              "seconds": seconds, "distill_student": student_line[0].split("] ")[-1],
              "distill_log": distill_losses[-2:],
              "quantcheck": report, "quantcheck_int8_launches_per_forward": per8,
              "eval": got, "colorbar": colorbar,
              "start_seconds": start_s, "phase_seconds": time.perf_counter() - t0})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    yield {"training_teacher": launches, "quantcheck_int8": int8_launches}


MESH_SEED = 16  # the mesh phase's frames: a generator of their own
PACKAGE = "monocular_depth_estimation_trt_tpu_torch"


def mesh_phase(pipe, vggt, wrappers, dev, vits_run, vggt_run):
    """``--device-mesh 1x1`` on the one card: every placement collapses to the
    plain tensor, so the served path keeps its kernels, launches and bits.
    The DA-V2 vits and VGGT pipelines (their engines dropped) take the mesh
    as the command line gives it, and run the main path's 518² frame (with
    its viz) and the VGGT path's 4 views, with the counts set to 0 just
    before and read just after, against those paths' outputs (``vits_run``,
    ``vggt_run``: (input, output)); ``run --device-mesh 2x1`` must exit
    naming the devices; 2 distillation steps through ``shard_train_state``
    on the mesh against 2 plain steps. Returns the launches of the counted
    run."""
    import atexit

    import numpy as np
    import torch

    from monocular_depth_estimation_trt_tpu_torch import cli
    from monocular_depth_estimation_trt_tpu_torch.parallel import (
        single_device_mesh,
        vit_tp_rules,
    )
    from monocular_depth_estimation_trt_tpu_torch.training import (
        create_train_state,
        make_distill_step,
        shard_batch_tree,
        shard_train_state,
    )
    from monocular_depth_estimation_trt_tpu_torch.training.distill import depth_student
    from monocular_depth_estimation_trt_tpu_torch.training.trainer import adamw

    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    too_large = subprocess.Popen([sys.executable, "-m", PACKAGE, "run", "depth_anything_v2",
                                  "--encoder", "vits", "--device-mesh", "2x1",
                                  "--allow-random-weights"], cwd=REPO, env=env,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    atexit.register(stop_process, too_large)
    rng = np.random.default_rng(MESH_SEED)
    (frame, vits_plain), (views4, vggt_plain) = vits_run, vggt_run
    for p in (pipe, vggt):
        cli._apply_device_mesh(p, "1x1")
    from torch.distributed.tensor import DTensor

    plain_tensors = not any(isinstance(t, DTensor) for p in (pipe, vggt)
                            for t in (*p.model.parameters(), *p.model.buffers()))

    set_counts_to_zero(wrappers)
    vits_out, vits_per = run_counted(lambda: pipe(frame, viz=True),
                                     lambda: pipe.engine_for((518, 518), True), wrappers,
                                     "vits on the 1x1 mesh")
    vggt_out, vggt_per = run_counted(lambda: vggt.multi_view(views4),
                                     lambda: vggt.views_engine(4), wrappers,
                                     "vggt S=4 on the 1x1 mesh")
    torch.cuda.synchronize()
    launches = launch_record(wrappers)
    drop_engines(pipe, vggt)
    check(plain_tensors, "the 1x1 mesh placed a tensor as a DTensor")
    check(vits_per == [0, 12, 0, 0], f"vits on the 1x1 mesh: launches {vits_per} a frame")
    check(vggt_per == [0, 24, 48, 0], f"vggt on the 1x1 mesh: launches {vggt_per} a forward")
    check(sorted(vits_out) == sorted(vits_plain)
          and all(np.array_equal(vits_out[k], vits_plain[k]) for k in vits_plain),
          "vits on the 1x1 mesh differs")
    check(sorted(vggt_out) == sorted(vggt_plain)
          and all(np.array_equal(vggt_out[k], vggt_plain[k]) for k in vggt_plain),
          "vggt on the 1x1 mesh differs")

    # the trainer's sharding on the mesh: 2 distillation steps, plain and sharded
    mesh = single_device_mesh("cuda")
    student = student_on_host(0).to(dev)
    imgs = torch.from_numpy(rng.integers(0, 256, (TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3),
                                         dtype=np.uint8)).to(dev)
    labels = torch.from_numpy(rng.random((TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE),
                                         dtype=np.float32) + 0.5).to(dev)
    step = make_distill_step(depth_student(student, TRAIN_SIZE))
    plain_state = create_train_state(dict(student.named_parameters()), adamw(TRAIN_LR))
    sharded = shard_train_state(mesh, vit_tp_rules(),
                                create_train_state(dict(student.named_parameters()),
                                                   adamw(TRAIN_LR)))
    losses = []
    for _ in range(2):
        plain_state, mp = step(plain_state, (imgs, labels))
        sharded, ms = step(sharded, shard_batch_tree(mesh, (imgs, labels)))
        losses.append((float(mp["loss"]), float(ms["loss"])))
    with torch.no_grad():
        worst = max(float(((a - b).abs() - 5e-2 * b.abs()).max())
                    for a, b in zip(sharded.params.values(), plain_state.params.values()))
        bit_equal = all(torch.equal(a, b) for a, b in zip(sharded.params.values(),
                                                           plain_state.params.values()))
    del student, plain_state, sharded
    torch.cuda.empty_cache()
    check(all(abs(a - b) <= 1e-4 * abs(a) for a, b in losses),
          f"distill on the 1x1 mesh: losses {losses}")
    check(worst <= 5e-4, f"distill on the 1x1 mesh: parameters {worst} past rtol 5e-2")

    out, err = too_large.communicate(timeout=300)
    message = "--device-mesh 2x1 needs 2 devices; 1 available"
    emit({"phase": "mesh", "launches": launches,
          "launches_per_forward": {"vits_518": vits_per, "vggt_s4": vggt_per},
          "outputs_bit_equal": True, "plain_tensors": plain_tensors,
          "distill_losses_plain_sharded": losses, "distill_params_bit_equal": bit_equal,
          "distill_params_past_rtol": worst,
          "run_2x1": {"exit_code": too_large.returncode,
                      "message": [ln for ln in (out + err).splitlines() if "device-mesh" in ln]},
          "elapsed_s": time.perf_counter() - t0})
    check(too_large.returncode != 0 and message in out + err,
          f"run --device-mesh 2x1 exited {too_large.returncode}: {out[-500:]}{err[-800:]}")
    return launches


def mesh_commands(tmp, png, pngs):
    """The mesh's commands for the cli phase's process: ``run`` (vits, the
    cli phase's frame), ``views vggt`` (its 4 views) and ``bench`` (vits,
    518²), each with ``--device-mesh 1x1``."""
    return [("run", "depth_anything_v2", "--encoder", "vits", "--image", png, "--out",
             os.path.join(tmp, "run_mesh"), "--allow-random-weights", "--device-mesh", "1x1"),
            ("views", "vggt", "--images", *pngs, "--out", os.path.join(tmp, "views_mesh"),
             "--allow-random-weights", "--device-mesh", "1x1"),
            ("bench", "depth_anything_v2", "--encoder", "vits", "--warmup", "3",
             "--iterations", "10", "--device-mesh", "1x1")]


def check_mesh_commands(tmp, outputs, rcs):
    """Each ``--device-mesh 1x1`` command's npz equal, file for file and
    array for array, to the plain command's; ``bench`` printed its report."""
    import numpy as np

    rec = {"phase": "cli", "command": "run / views / bench --device-mesh 1x1",
           "exit_codes": rcs, "seconds": [o[1] for o in outputs]}
    for plain, meshed in (("run", "run_mesh"), ("views", "views_mesh")):
        a, b = (sorted(f for f in os.listdir(os.path.join(tmp, d)) if f.endswith(".npz"))
                for d in (plain, meshed))
        check(a == b and len(a) == 1, f"cli {meshed}: npz files {b}, plain {a}")
        x, y = (np.load(os.path.join(tmp, d, a[0])) for d in (plain, meshed))
        rec[f"{meshed}_bit_equal"] = sorted(x.files) == sorted(y.files) and all(
            np.array_equal(x[k], y[k]) for k in x.files)
    fps = [ln for ln in outputs[2][0].splitlines() if "FPS" in ln]
    rec["bench_line"] = fps[-1] if fps else None
    emit(rec)
    check(rcs == [0, 0, 0], f"cli --device-mesh 1x1: exit codes {rcs}")
    check(rec["run_mesh_bit_equal"] and rec["views_mesh_bit_equal"],
          "cli --device-mesh 1x1: npz differs from the plain command's")
    check(bool(fps), "cli bench --device-mesh 1x1 printed no FPS line")


# K5's shapes: kernel, label, shape as the wrapper takes it, the bound's arguments
AUTOTUNE_SHAPES = (
    ("flash_attention_packed", "vits_518", (1, 1370, 6)),
    ("flash_attention_packed", "metric3d_616x1064", (1, 3349, 16)),
    ("flash_attention", "vggt_global_s4", (1, 16, 5496, 64)),
    ("flash_attention", "dinov3_vit7b16_1024", (1, 32, 4101, 128)),
    ("flash_attention_batched", "depth_pro_patch", (35, 16, 577, 64)),
    ("w8a8_matmul", "vitl_fc2", (1370, 4096, 1024)),
    ("w8a8_matmul", "depth_pro_fc1", (20195, 1024, 4096)),
)


def autotune_child() -> None:
    """The autotune phase's process (``MDET_AUTOTUNE`` and ``MDET_CACHE_DIR``
    set by the parent): its start-up (imports, the kernels' library, the CUDA
    context), then, once a line arrives on its standard input, one call of
    each kernel at each shape of AUTOTUNE_SHAPES; prints one line with the
    tuner's reports, its count of measurements and the tile each shape
    resolved to."""
    import torch

    sys.path.insert(0, REPO)
    from monocular_depth_estimation_trt_tpu_torch.ops.cuda import _build, autotune
    from monocular_depth_estimation_trt_tpu_torch.ops.cuda import flash_attention as fa
    from monocular_depth_estimation_trt_tpu_torch.ops.cuda import quant_matmul as qm

    _build.library()
    torch.cuda.init()
    sys.stdin.readline()  # the parent's card is idle from here
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(5)
    bf16 = torch.bfloat16
    tiles = {}
    for kernel, label, shape in AUTOTUNE_SHAPES:
        if kernel == "flash_attention_packed":
            b, n, h = shape
            qkv = torch.randn((b, n, 3 * h * 64), generator=gen, device=dev, dtype=bf16)
            fa.flash_attention_packed(qkv, h)
            key, width = (b, n, h, 64), 64
        elif kernel == "w8a8_matmul":
            m, k, n = shape
            x, wq, qmul, scale, bias = w8a8_operands(m, k, n, bf16, dev,
                                                     torch.Generator().manual_seed(4))
            qm.w8a8_matmul(x, wq, qmul, scale, bias)
            key, width = (m, n, k), k
        else:
            q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=bf16)
                       for _ in range(3))
            getattr(fa, kernel)(q, k, v)
            key, width = shape, shape[-1]
        torch.cuda.synchronize()
        tiles[label] = autotune.persisted_tile(kernel, bf16, key, torch.cuda.get_device_name(0),
                                               width)
    print("@@autotune " + json.dumps({"reports": autotune.reports,
                                      "measurements": autotune.measurements, "tiles": tiles,
                                      "cache": sorted(os.listdir(os.path.dirname(
                                          autotune.cache_path())))}), flush=True)


def _autotune_run(proc):
    """Let an ``autotune_child`` process measure; its record (waited for)."""
    out, err = proc.communicate("go\n", timeout=600)
    lines = [ln for ln in out.splitlines() if ln.startswith("@@autotune ")]
    check(proc.returncode == 0 and len(lines) == 1,
          f"autotune process exited {proc.returncode}: {out[-800:]}{err[-2500:]}")
    return json.loads(lines[0].split(" ", 1)[1])


def autotune_phase(card, power_limit):
    """A generator in three parts. The first ``next`` starts the tile tuner's
    process on a temporary cache, which starts up while the mesh phase runs;
    the second lets it measure (the card otherwise idle), records it, and
    starts a second process on that cache; the third checks that it
    resolved every winner with no measurement (it times nothing, so other
    phases run meanwhile)."""
    import atexit
    import shutil

    cache = tempfile.mkdtemp(prefix="mdet_tune_")
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "MDET_CACHE_DIR": cache, "MDET_AUTOTUNE": "1"}

    def start():
        proc = subprocess.Popen([sys.executable, "-c",
                                 "import chip_smoke\nchip_smoke.autotune_child()\n"],
                                cwd=REPO, env=env, stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        atexit.register(stop_process, proc)
        return proc

    try:
        tuner = start()
        yield
        t0 = time.perf_counter()
        first = _autotune_run(tuner)
        tuned_s = time.perf_counter() - t0
        check(len(first["reports"]) == len(AUTOTUNE_SHAPES),
              f"autotune: {len(first['reports'])} reports for {len(AUTOTUNE_SHAPES)} shapes")
        for (kernel, label, shape), report in zip(AUTOTUNE_SHAPES, first["reports"]):
            check(report["kernel"] == kernel, f"autotune: report {report['kernel']} for {kernel}")
            if kernel == "w8a8_matmul":
                m, k, n = shape
                bound_ms, bound_by = w8a8_bound(m, k, n, 2)
            elif kernel == "flash_attention_packed":
                b, n, h = shape
                bound_ms, bound_by = attention_bound(b, n, h, 64, 2, PEAK_BF16_OPS)
            else:
                b, h, n, d = shape
                bound_ms, bound_by = attention_bound(b, n, h, d, 2, PEAK_BF16_OPS)
            by_tile = {r["tile"]: r for r in report["candidates"]}
            emit({"phase": "autotune", "kernel": kernel, "shape": label, "dims": list(shape),
                  "card": card, "power_limit": power_limit, "chain": report["chain"],
                  "bar": report["bar"], "candidates": report["candidates"],
                  "default_tile": report["default"],
                  "default_ms": by_tile[report["default"]]["ms"],
                  "winner_tile": report["winner"], "winner_ms": by_tile[report["winner"]]["ms"],
                  "bound_ms": bound_ms, "bound_by": bound_by})
            check(all(r["ok"] for r in report["candidates"]),
                  f"autotune {kernel} {label}: a candidate misses its bar {report['candidates']}")
            check(first["tiles"][label] == report["winner"],
                  f"autotune {kernel} {label}: winner {report['winner']}, persisted "
                  f"{first['tiles'][label]}")
        check(first["cache"] == ["cuda_tuning.json"], f"autotune: the cache holds {first['cache']}")
        reader = start()
        reader.stdin.write("go\n")  # it times nothing: no need to wait for an idle card
        reader.stdin.flush()
        yield
        second = _autotune_run(reader)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    emit({"phase": "autotune_summary", "measurements": first["measurements"],
          "winners": first["tiles"], "fresh_process_measurements": second["measurements"],
          "fresh_process_tiles": second["tiles"], "tuning_process_s": tuned_s})
    check(second["measurements"] == 0 and not second["reports"],
          f"autotune: the fresh process measured {second['measurements']} candidates")
    check(second["tiles"] == first["tiles"],
          f"autotune: a fresh process read {second['tiles']}, the tuner persisted "
          f"{first['tiles']}")


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
             if "Compiling entry" in ln or "registers" in ln or "spill" in ln
             or "C7512" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": info.built, "library": os.path.relpath(info.path, REPO),
          "ptxas": ptxas})
    # the wide and fp32 mainloops neither spill nor serialize their wgmma
    # (a library built earlier left no log to read)
    if info.built:
        faults = ptxas_faults(ptxas_report(info.log))
        check(not faults, f"ptxas: {faults}")
    # every kernel runs on wgmma and TMA, in either type (K2 and K3 in two head
    # widths and the wide form; K4 in bf16 and fp32, the fp32 form with TMA
    # stores), and the library holds no kernel outside SM90_KERNELS
    sass = sass_counts(info.path)
    if sass is None:
        emit({"phase": "sass", "counts": "not measured (no cuobjdump in the toolkit)"})
    else:
        emit({"phase": "sass", "counts": sass})
        check(not sass_faults(sass), f"sass: {sass_faults(sass)}")

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
    vggt, vggt_launches, vggt_views4 = run_vggt_path(build_pipeline, wrappers, rng)
    # the fp32 route's counted runs (the fp32 K1 and K2), each path's own
    fp32_launches = {"vggt_fp32": vggt_parity(build_pipeline, vggt, parity_frames(rng), wrappers)}
    drop_engines(vggt)

    # 16. the one-device mesh on the vits and VGGT pipelines (its own counted
    # run, against the main path's and the VGGT path's outputs), then 17. the
    # tile tuner in a process of its own, started before 16; the second
    # process, which reads the winners back, runs during the Depth Pro path
    autotune = autotune_phase(card, power_limit)
    next(autotune)  # the tuner's process starts up meanwhile
    mesh_launches = mesh_phase(pipe, vggt, wrappers, dev, (frame_b, outs["b"]), vggt_views4)
    next(autotune)

    # 6. the Depth Pro path (its own counted run), then its route comparisons
    depth_pro, depth_pro_launches, depth_pro_frames = run_depth_pro_path(build_pipeline, wrappers,
                                                                         rng)
    fp32_launches["depth_pro_fp32"] = depth_pro_parity(
        build_pipeline, depth_pro, depth_pro_frames, wrappers,
        BenchmarkConfig(**DEPTH_PRO_BENCH), card, power_limit)
    drop_engines(depth_pro)
    next(autotune, None)

    # 7. the single-image metric and point-map families, then the last
    # single-image families (each its own counted run), then their route
    # comparisons. The last families draw their frames from a generator of
    # their own, so that every earlier phase reads the frames it read before
    families, family_launches, family_frames = {}, {}, {}
    for group, frame_rng in ((METRIC, rng), (SINGLE, np.random.default_rng(9)),
                             (MULTI, np.random.default_rng(10))):
        for name in (n for n, fam in FAMILIES.items() if fam["group"] == group):
            families[name], family_launches[name], family_frames[name] = run_family_path(
                name, build_pipeline, wrappers, frame_rng)
            family_parity(name, build_pipeline, families[name], family_frames[name])
            drop_engines(families[name])
        if group == SINGLE:
            check_geocalib_fit(dev)
    check_procrustes(dev)
    # the multi-view passes: MapAnything's joint reconstruction of 4 views,
    # then the KV-cache stream (STream3R's session, StreamVGGT's runner)
    multi_rng = np.random.default_rng(11)
    extra_launches = {"map_anything_reconstruct_s4": run_reconstruct(
        families["map_anything"], wrappers, multi_rng), "mesh_1x1": mesh_launches}
    drop_engines(families["map_anything"])
    streamvggt = build_pipeline("streamvggt")
    extra_launches["stream"], stream_sess, stream_frame = run_stream_phase(
        families["stream3r"], streamvggt, wrappers, multi_rng)
    drop_engines(families["stream3r"], streamvggt)
    del streamvggt
    profile_stream_step(stream_sess, stream_frame, dev)
    del stream_sess
    multi_view_serving(families, wrappers, card, power_limit, dev)

    # the video paths (each its own counted run), their comparisons, speed and
    # profile; released before the int8 phases
    calib = list(parity_frames(np.random.default_rng(7)).values())
    extra_launches.update(video_phase(build_pipeline, wrappers, calib, card, power_limit, dev))
    # the optical-flow paths (each its own counted run), their comparisons,
    # speed and profile; released before the int8 phases
    flow_launches, raft = flow_phase(build_pipeline, wrappers, card, power_limit, dev)
    extra_launches.update(flow_launches)
    # point tracking, then the SLAM recipes on the RAFT, DA-V2 vits, UniDepth V2
    # and GeoCalib pipelines built above (each its own counted run)
    extra_launches.update(tracking_phase(build_pipeline, wrappers, card, power_limit, dev))
    extra_launches.update(slam_phase(build_pipeline, wrappers, card, power_limit, dev, raft, pipe,
                                     families["unidepth_v2"], families["geocalib"]))
    del raft

    # 14 and 10 start here: the vits artifact's exports, turns and process,
    # then the command line's processes, which work during 8 and 9
    export = export_phase(pipe, build_pipeline, wrappers, card, power_limit)
    next(export)
    cli = cli_phase(pipe, vggt, depth_pro, families["moge2"], families["unidepth_v2"],
                    families["geocalib"], families["align3r"])
    next(cli)

    # 8. the int8 paths (each its own counted run), then int8 against the bf16
    # and fp32 routes; calibration on three seeded frames (noise and a
    # smooth scene-like frame)
    # (DA-V2 and VGGT on frames of their own generator, which no other phase moves)
    int8_rng = np.random.default_rng(8)
    int8_frames = {
        "depth_anything_v2": {
            "frame_480x640": int8_rng.integers(0, 256, (480, 640, 3), dtype=np.uint8),
            "frame_518x518": int8_rng.integers(0, 256, (518, 518, 3), dtype=np.uint8)},
        "depth_pro": depth_pro_frames,
        "vggt": {"frame_480x640": int8_rng.integers(0, 256, (480, 640, 3), dtype=np.uint8),
                 "frame_518x518": int8_rng.integers(0, 256, (518, 518, 3), dtype=np.uint8)},
        "metric3d_v2": family_frames["metric3d_v2"],
        "unidepth_v2": family_frames["unidepth_v2"],
    }
    # the shared generator advances by the draws it made for those frames
    # before they had a generator of their own, so that every later phase
    # reads the frames it read before
    for hw in ((480, 640), (518, 518)) * 2:
        rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
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
    # MapAnything's int8 build, VGGT's aggregator quantized: its counted run only
    map8, int8_launches["map_anything"] = run_int8_path(
        "map_anything", int8_family("map_anything", build_pipeline, calib), wrappers,
        family_frames["map_anything"])
    drop_engines(map8)
    del map8

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
    for name in SINGLE_FAMILIES:  # the multi-view families' ran in multi_view_serving
        fam, p = FAMILIES[name], families[name]
        hw = fam["hw"][1]
        arg, other = (rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(2))
        check_engine(name, p, p.engine_for(hw), p_eager(p, hw), arg, other,
                     fam["per_forward"], wrappers)
        drop_engines(p)

    # 10. the command line, as a user starts it, in processes of its own
    # (started before 8); the shared generator advances by the frames the
    # phase drew from it before they had a generator of their own, so that
    # every later phase reads the frames it read before
    rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    rng.integers(0, 256, (4, 518, 518, 3), dtype=np.uint8)
    next(cli, None)
    drop_engines(pipe, vggt, depth_pro, families["moge2"], families["unidepth_v2"],
                 families["geocalib"], families["align3r"])

    # 11. the HTTP server in this process, batching up to 4
    server_phase(pipe, rng)
    drop_engines(pipe)

    # 12. speed (the counts are read above; benchmark launches are not
    # counted): each path eager and through its engine, in turns eager,
    # graph
    # 30 timed and 15 synchronised iterations (100 and 50 until the export
    # phase needed the card time, 60 and 30 until the training phase's)
    cfg = BenchmarkConfig(warmup=5, iterations=30, latency_iterations=15)
    vcfg = BenchmarkConfig(**VGGT_BENCH)
    dcfg = BenchmarkConfig(**DEPTH_PRO_BENCH)
    fcfg = BenchmarkConfig(**FAMILY_BENCH)
    for label, p, in_hw, views, c in (
            ("vits", pipe, (518, 518), 0, cfg), ("vitl", vitl, (518, 518), 0, cfg),
            ("vitl_int8", int8_vitl, (518, 518), 0, cfg),
            ("vggt_s1", vggt, (518, 518), 0, vcfg), ("vggt_s4", vggt, None, 4, vcfg),
            ("depth_pro_1536", depth_pro, (1536, 1536), 0, dcfg),
            *((name, families[name], tuple(families[name].spec.input_hw), 0, fcfg)
              for name in SINGLE_FAMILIES)):
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
        # once (twice until the script outgrew its time limit)
        rep = timed_route(p, "graph", in_hw, views, c)
        emit(speed_record(rep, p, label, "graph", 0, views, in_hw, card, power_limit))
        drop_engines(p)
    # the fp32 route (--precision fp32) of DA-V2 vitl: its counted run on the
    # fp32 K1, then its captured graph's p50 beside the bf16 rows above
    fp32_launches["depth_anything_v2_vitl_fp32"] = fp32_vitl_speed(
        build_pipeline, vitl, wrappers, frame_b, cfg, card, power_limit)
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
        0, 256, (*families[name].spec.input_hw, 3), dtype=np.uint8)).to(dev)
        for name in SINGLE_FAMILIES}
    for p, arg, in_hw, suffix, iters, with_eager in (
            (pipe, dev_frame, (518, 518), "", 3, True),
            (vitl, dev_frame, (518, 518), "", 3, False),
            (int8_vitl, dev_frame, (518, 518), "", 3, False),
            (vits8, dev_frame, (518, 518), "", 3, False),
            (vggt, dev_frame, (518, 518), "_s1", 3, False),
            (vggt, views4, None, "_s4", 3, True),
            (int8_pipes["vggt"], dev_frame, (518, 518), "_s1", 3, False),
            (int8_pipes["vggt"], views4, None, "_s4", 3, False),
            (depth_pro, dev_dp, (1536, 1536), "", 3, True),
            (int8_pipes["depth_pro"], dev_dp, (1536, 1536), "", 3, False),
            *((families[name], family_args[name], tuple(families[name].spec.input_hw), "", 3,
               name in ("metric3d_v2", "moge2", "geocalib", *GEOMETRIC))
              for name in SINGLE_FAMILIES),
            (int8_pipes["metric3d_v2"], family_args["metric3d_v2"], (616, 1064), "", 3,
             False),
            (int8_pipes["unidepth_v2"], family_args["unidepth_v2"], (518, 518), "", 3,
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
                emit({**profile_breakdown(eager_step, p.spec.artifact_name() + suffix,
                                          EAGER_PROFILE_CALLS, ranges=ranges),
                      "route": "eager"})
        drop_engines(p)

    # 14. serialized artifacts of pipelines built above (and of VGGT and
    # StreamVGGT at cut depth), loaded and served (the vits artifact's
    # process started before 8); 15 starts its commands' process first, so
    # that they run while the artifacts are exported
    drop_engines(vggt, depth_pro, vits8, *(p for p in int8_pipes.values() if p is not int8_vitl),
                 *families.values())
    training = training_phase(vitl, build_pipeline, wrappers, card, power_limit, dev)
    next(training)
    extra_launches.update(export.send((int8_vitl, depth_pro)))

    # 15. training and the accuracy commands, with the vitl pipeline built
    # above as the teacher (each counted run its own)
    drop_engines(pipe, int8_vitl)
    extra_launches.update(next(training))

    # kernels line: the main shape's numbers, every shape in "shapes"; the
    # launches of each path's counted run
    def kernel_entry(name, source, replaces, function, records, main_shape,
                     library_call="torch.nn.functional.scaled_dot_product_attention",
                     head_dim_128=None, wrapper=None, paths=None):
        keys = ("shape", "B", "H", "N", "d", "dtype", "max_abs_err", "err_bf16_steps",
                "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "host_us_per_call")
        main = next(r for r in records if r["shape"] == main_shape)
        extra = {}
        if "matmul_ms" in main:
            extra.update(matmul_ms=main["matmul_ms"],
                         matmul_call="torch.matmul of bf16 x and the weight cast to bf16")
        if head_dim_128:  # the d = 128 instantiation (K2: DINOv3 vit7b16's path)
            d128 = next(r for r in records if r["shape"] == head_dim_128)
            extra["head_dim_128"] = {k: d128[k] for k in keys}
            # the heads wider than 128, on no ported path: each type on its
            # mainloop's wide form
            wide = [{**{k: r[k] for k in keys},
                     "source": "monocular_depth_estimation_trt_tpu_torch/csrc/"
                               + ("attention_sm90.cuh" if r["dtype"] == "bfloat16"
                                  else "attention_sm90_f32.cuh")}
                    for r in records if "_wide" in r["shape"]]
            if wide:
                extra["wide_heads"] = wide
        if paths is None:
            by_path = {"depth_anything_v2": launches[name], "vggt": vggt_launches[name],
                       "depth_pro": depth_pro_launches[name],
                       **{k: v[name] for k, v in family_launches.items()},
                       **{k: v[name] for k, v in extra_launches.items()},
                       **{f"{k}_int8": v[name] for k, v in int8_launches.items()}}
        else:  # a wrapper's fp32 form: the fp32 paths' counted runs
            by_path = {k: v[wrapper] for k, v in paths.items()}
        pallas_file = replaces.partition(":")[0]
        return {
            "name": name,
            "wrapper": wrapper or name,
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
            **{k: main[k] for k in main if k.startswith("bound_") and k != "bound_ms"
               and k != "bound_by"},
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
                     "_attn_kernel", k2, "global_s4", head_dim_128="dinov3_vit7b16_1024"),
        kernel_entry("flash_attention_batched", "flash_attention_batched.cu",
                     "flash_attention.py:68", "_attn_kernel_batched", k3, "depth_pro_patch",
                     head_dim_128="d128"),
        kernel_entry("w8a8_matmul", "w8a8_matmul.cu", "quant_matmul.py:43", "_w8a8_kernel", k4,
                     "vitl_qkv", library_call="quantize + torch._int_mm + rescale"),
        # the fp32 forms of K1 and K2 (precision="fp32"): the split TF32 mainloop
        kernel_entry("flash_attention_packed_fp32", "attention_sm90_f32.cuh",
                     "flash_attention.py:272", "_attn_kernel_packed",
                     [r for r in k1 if r["dtype"] == "float32"], "vits_518_fp32",
                     wrapper="flash_attention_packed", paths=fp32_launches),
        kernel_entry("flash_attention_fp32", "attention_sm90_f32.cuh", "flash_attention.py:38",
                     "_attn_kernel", [r for r in k2 if r["dtype"] == "float32"
                                      and "_wide" not in r["shape"]],
                     "global_s4_fp32", head_dim_128="dinov3_vit7b16_1024_fp32",
                     wrapper="flash_attention", paths=fp32_launches),
        # the fp32 K3 (Depth Pro's fp32 path) on the same split TF32 mainloop
        kernel_entry("flash_attention_batched_fp32", "attention_sm90_f32.cuh",
                     "flash_attention.py:68", "_attn_kernel_batched",
                     [r for r in k3 if r["dtype"] == "float32" and "_wide" not in r["shape"]],
                     "depth_pro_patch_fp32", head_dim_128="d128_fp32",
                     wrapper="flash_attention_batched", paths=fp32_launches),
    ]
    for entry in kernels:
        check(entry["launches"] > 0, f"{entry['name']}: no launch on its paths' counted runs")

    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
