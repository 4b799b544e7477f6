"""Command-line interface (counterpart of the JAX package's ``cli.py``).

Replaces the reference's "edit constants at the top of the script" workflow
(``Depth_Anything_V2/onnx2trt.py:153-159``) with one typed CLI::

    python -m monocular_depth_estimation_trt_tpu_torch run depth_anything_v2 \
        --encoder vits --image frame.png --out results/ --pointcloud

    python -m monocular_depth_estimation_trt_tpu_torch run moge2 --image frame.png \
        --mesh --mesh-format glb

    python -m monocular_depth_estimation_trt_tpu_torch serve depth_anything_v2 --max-batch 4
    python -m monocular_depth_estimation_trt_tpu_torch bench depth_anything_v2 --encoder vits
    python -m monocular_depth_estimation_trt_tpu_torch models

Every command runs on the card (``--device cuda``, the default) unless
``--device cpu`` asks for the port's plain PyTorch path on the CPU; without
a card the default raises. Artifacts mirror the reference's outputs and the
JAX CLI's file names: the turbo-colormapped viz (``.jpg``; ``.png`` where
no JPEG codec is importable, see ``utils/imageio.py``), a compressed
``.npz`` of the depth and the model's other outputs (the JAX CLI's holds the
depth alone), the ``_fov.json`` camera estimate, an optional ``.ply``/``.glb``
point cloud or, for a point-map model, mesh, and the ``[MDET] max/min``
parity line
(``onnx2trt.py:218-245``).

Not ported yet, so argparse rejects them: ``--engine`` (serialized
artifacts), ``--device-mesh`` (multi-device sharding), ``--trace`` (the
profiler), ``--colorbar`` (a matplotlib figure), ``batch --video`` and the
``flow``/``video``/``track``/``pair``/``webcam``/``export``/``slam``/
``convert``/``distill``/``eval``/``quantcheck``/``doctor`` commands.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from monocular_depth_estimation_trt_tpu_torch.utils.logging import log

DEVICES = ("cuda", "cpu")


def _fov_from_outputs(out, depth_hw):
    """(fov_x_deg, fov_y_deg) from whichever camera estimate the model
    emits, or None. Conventions: MoGe ``focal`` is in normalized view-plane
    units; Depth Pro ``f_px`` and UniDepth ``intrinsics`` are in pixels of
    the original image."""
    import math

    h, w = int(depth_hw[0]), int(depth_hw[1])
    if "focal" in out:  # MoGe normalized focal
        f = float(np.asarray(out["focal"]))
        if f <= 0:
            return None
        diag = math.hypot(h, w)
        return (math.degrees(2 * math.atan((w / diag) / f)),
                math.degrees(2 * math.atan((h / diag) / f)))
    if "f_px" in out:
        f = float(np.asarray(out["f_px"]))
        if f <= 0:
            return None
        return (math.degrees(2 * math.atan(0.5 * w / f)),
                math.degrees(2 * math.atan(0.5 * h / f)))
    if "intrinsics" in out:
        K = np.asarray(out["intrinsics"])
        if K.shape != (3, 3) or K[0, 0] <= 0 or K[1, 1] <= 0:
            return None
        return (math.degrees(2 * math.atan(0.5 * w / K[0, 0])),
                math.degrees(2 * math.atan(0.5 * h / K[1, 1])))
    return None


def _calib_images_from(args):
    """--calib-dir: up to 8 domain images for int8 activation-scale
    calibration (default: registry._calibration_images). None when the flag
    is absent."""
    d = getattr(args, "calib_dir", "")
    if not d:
        return None
    from monocular_depth_estimation_trt_tpu_torch.utils.files import list_images
    from monocular_depth_estimation_trt_tpu_torch.utils.imageio import read_image

    paths = list_images(d)[:8]
    if not paths:
        raise SystemExit(f"[MDET] --calib-dir {d}: no images found")
    log(f"int8 calibration on {len(paths)} images from {d}")
    return [read_image(p) for p in paths]


def _pipeline_kw(args, *keys) -> dict:
    """build_pipeline keyword arguments from the flags a command has."""
    kw = {"device": args.device}
    for key in keys:
        value = getattr(args, key, "")
        if value:
            kw[key] = value
    if getattr(args, "metric", False):
        kw["metric"] = True
        if getattr(args, "dataset", ""):
            kw["dataset"] = args.dataset
    ci = _calib_images_from(args)
    if ci is not None:
        kw["calib_images"] = ci
    return kw


def _build(args, *keys):
    from monocular_depth_estimation_trt_tpu_torch import registry

    return registry.build_pipeline(args.model, **_pipeline_kw(args, *keys))


def cmd_run(args) -> int:
    from monocular_depth_estimation_trt_tpu_torch.utils.imageio import read_image, resize

    img = read_image(args.image)
    if args.resize:
        img = resize(img, (args.resize, args.resize))
    log(f"original shape : {img.shape}")
    if not args.model:
        log("run: give a model name", tag="ERROR")
        return 2
    pipe = _build(args, "encoder", "checkpoint", "precision")
    out = pipe(img, viz=True)
    return _write_run_outputs(args, img, out, pipe.spec.artifact_name(), pipe=pipe)


def _write_run_outputs(args, img, out, name, pipe) -> int:
    """Artifact-writing tail of ``run``: viz, npz, fov json, point cloud,
    compare, benchmark."""
    from monocular_depth_estimation_trt_tpu_torch.utils.imageio import write_image

    os.makedirs(args.out, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.image))[0]

    if "depth" not in out:
        # calibration-style pipelines (GeoCalib): scalar estimates + fields
        # (reference later/GeoCalib/infer.py:35-39 print format)
        deg = 180.0 / np.pi
        if "roll" in out:
            log(f"Roll:  {float(out['roll']) * deg:.1f}° "
                f"(± {float(out.get('roll_uncertainty', 0)) * deg:.1f})°")
            log(f"Pitch: {float(out['pitch']) * deg:.1f}° "
                f"(± {float(out.get('pitch_uncertainty', 0)) * deg:.1f})°")
            log(f"vFoV:  {float(out['vfov']) * deg:.1f}° "
                f"(± {float(out.get('vfov_uncertainty', 0)) * deg:.1f})°")
            log(f"Focal: {float(out['focal']):.1f} px "
                f"(± {float(out.get('focal_uncertainty', 0)):.1f} px)")
        npz = os.path.join(args.out, f"{stem}_{name}.npz")
        np.savez_compressed(npz, **{k: np.asarray(v) for k, v in out.items()})
        log(f"wrote {npz}")
        if args.benchmark:
            pipe.benchmark((img.shape[0], img.shape[1])).print()
        return 0

    depth = out["depth"]
    log(f"max : {depth.max():0.5f} , min : {depth.min():0.5f}")
    if "viz" in out:
        written = write_image(os.path.join(args.out, f"{stem}_{name}.jpg"), out["viz"])
        log(f"wrote {written}")
    npz = os.path.join(args.out, f"{stem}_{name}.npz")
    # the depth and every other output of the pipeline but the viz (sky,
    # confidence, the MoGe pair's points, mask, normal, scale and focal)
    np.savez_compressed(npz, depth=depth, **{k: np.asarray(v) for k, v in out.items()
                                             if k not in ("depth", "viz")})
    log(f"wrote {npz}")

    fov = _fov_from_outputs(out, depth.shape)
    if fov is not None:
        # dedicated fov artifact (reference MoGe_2/onnx2trt.py:211-213)
        fov_path = os.path.join(args.out, f"{stem}_{name}_fov.json")
        with open(fov_path, "w") as f:
            json.dump({"fov_x": round(fov[0], 2), "fov_y": round(fov[1], 2)}, f)
        log(f"wrote {fov_path} (fov_x {fov[0]:.2f}°, fov_y {fov[1]:.2f}°)")

    if args.pointcloud or args.mesh:
        from monocular_depth_estimation_trt_tpu_torch.apps.pointcloud import (
            depth_to_pointcloud_file,
            points_to_mesh_file,
        )

        ext = "glb" if args.mesh_format == "glb" else "ply"
        ply = os.path.join(args.out, f"{stem}_{name}.{ext}")
        if args.mesh and "points" in out:
            points_to_mesh_file(out["points"], img, ply, mask=out.get("mask"))
        else:
            # the model's own camera estimate where it predicts one (Depth
            # Pro f_px, reference Depth_Pro/onnx2trt_pointcloud.py:216-230)
            focal, intrinsics = args.focal, out.get("intrinsics")
            if "f_px" in out:
                focal = float(out["f_px"])
                log(f"using predicted focal length: {focal:.2f} px")
            depth_to_pointcloud_file(depth, img, ply, focal=focal, intrinsics=intrinsics)
        log(f"wrote {ply}")

    if args.compare:
        # regression check against a stored depth npz (the reference's
        # max/min eyeball protocol as a gate)
        ref = np.load(args.compare)["depth"]
        if ref.shape != depth.shape:
            log(f"compare: shape mismatch ours {depth.shape} vs ref {ref.shape}", tag="ERROR")
            return 1
        err = float(np.max(np.abs(np.asarray(depth) - ref)))
        rel = err / max(float(np.max(np.abs(ref))), 1e-6)
        log(f"compare vs {args.compare}: max-abs-err {err:.6f} (rel {rel:.2e})")
        if rel > args.compare_tol:
            log(f"compare FAILED (tol {args.compare_tol:g})", tag="ERROR")
            return 1

    if args.benchmark:
        pipe.benchmark((img.shape[0], img.shape[1])).print()
    return 0


def cmd_batch(args) -> int:
    """Batched offline serving over an image directory (``apps/offline.py``):
    decode threads keep frames ahead of a (B, H, W, 3) engine."""
    from monocular_depth_estimation_trt_tpu_torch.apps.offline import process_images_batched
    from monocular_depth_estimation_trt_tpu_torch.utils.files import list_images

    paths = list_images(args.images_dir)
    if args.max_frames:
        paths = paths[: args.max_frames]
    if not paths:
        log("batch: no images found", tag="ERROR")
        return 1
    if not args.model:
        log("batch: give a model name", tag="ERROR")
        return 2
    pipe = _build(args, "encoder", "checkpoint", "precision")
    os.makedirs(args.out, exist_ok=True)
    name = pipe.spec.artifact_name()

    on_result = None
    if args.save:
        from monocular_depth_estimation_trt_tpu_torch.utils import imageio

        def on_result(start_idx, host):
            depths = np.asarray(host["depth"])
            for j in range(depths.shape[0]):
                i = start_idx + j
                if i >= len(paths):  # tail-batch padding
                    break
                stem = os.path.splitext(os.path.basename(paths[i]))[0]
                d = depths[j]
                np.savez_compressed(os.path.join(args.out, f"{stem}_{name}.npz"), depth=d)
                norm = ((d - d.min()) / max(float(d.max() - d.min()), 1e-6)
                        * 255).astype(np.uint8)
                jpg = os.path.join(args.out, f"{stem}_{name}.jpg")
                cv2 = imageio._cv2()
                if cv2 is not None:  # the JAX CLI's inferno viz
                    imageio.write_image(jpg, cv2.cvtColor(
                        cv2.applyColorMap(norm, cv2.COLORMAP_INFERNO), cv2.COLOR_BGR2RGB))
                else:
                    imageio.write_gray(jpg, norm)

    stats = process_images_batched(pipe, paths, batch=args.batch, on_result=on_result,
                                   decode_threads=args.decode_threads)
    print(json.dumps({"metric": f"{name}_batched_fps", "value": stats["fps"], "unit": "fps",
                      "batch": stats["batch"], "frames": stats["frames"]}))
    return 0


def cmd_bench(args) -> int:
    from monocular_depth_estimation_trt_tpu_torch.config import BenchmarkConfig

    if not args.model:
        log("bench: give a model name", tag="ERROR")
        return 2
    pipe = _build(args, "encoder", "precision")
    cfg = BenchmarkConfig(warmup=args.warmup, iterations=args.iterations)
    if args.views and args.views > 1:
        if not hasattr(pipe, "benchmark_views"):
            log(f"{args.model} has no multi-view protocol", tag="ERROR")
            return 2
        report = pipe.benchmark_views(args.views, cfg)
    else:
        in_hw = (args.size, args.size) if args.size else tuple(pipe.spec.input_hw)
        report = pipe.benchmark(in_hw, cfg)
    report.print()
    return 0


def cmd_build(args) -> int:
    """Build (warm up and capture) an engine for a model config: the
    reference's explicit engine-build step."""
    pipe = _build(args, "encoder", "precision")
    eng = pipe.engine_for((args.size, args.size), args.viz)
    eng.compile()
    log(f"engine ready: {eng.name} (build {eng.build_seconds:.2f}s)")
    return 0


def cmd_views(args) -> int:
    """Multi-view 3D reconstruction: N images through one S-view VGGT
    engine -> per-view depth npz + merged world-space point cloud."""
    from monocular_depth_estimation_trt_tpu_torch.apps.vggt_3d import export_multi_view_points
    from monocular_depth_estimation_trt_tpu_torch.utils.imageio import read_image, resize

    size = args.resize or 518
    imgs = [resize(read_image(p), (size, size)) for p in args.images]
    if not args.model:
        log("views: give a model name", tag="ERROR")
        return 2
    pipe = _build(args, "precision")
    if not hasattr(pipe, "multi_view"):
        log(f"{args.model} has no multi-view protocol", tag="ERROR")
        return 2
    out = pipe.multi_view(np.stack(imgs))

    os.makedirs(args.out, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.images[0]))[0]
    name = pipe.spec.artifact_name()
    npz = os.path.join(args.out, f"{stem}_{name}_s{len(imgs)}.npz")
    np.savez_compressed(npz, depth=out["depth"], depth_conf=out["depth_conf"],
                        pose_enc=out.get("pose_enc"))
    log(f"wrote {npz}")
    if "pose_enc" in out:
        ply = os.path.join(args.out, f"{stem}_{name}_s{len(imgs)}.ply")
        export_multi_view_points(out, imgs, ply, input_size=pipe.spec.input_hw[0])
    return 0


def cmd_serve(args) -> int:
    """HTTP model serving (``apps/server.py``): engines behind one
    device-worker thread and a bounded queue."""
    from monocular_depth_estimation_trt_tpu_torch.apps.server import serve

    if not args.model:
        log("serve: give a model name", tag="ERROR")
        return 2
    pipe = _build(args, "encoder", "checkpoint", "precision")
    hw = (args.size, args.size) if args.size else None
    serve(pipe, host=args.host, port=args.port, input_hw=hw, max_queue=args.max_queue,
          max_batch=args.max_batch, batch_window_ms=args.batch_window_ms)
    return 0


def cmd_models(_args) -> int:
    from monocular_depth_estimation_trt_tpu_torch.registry import (
        INT8_FAMILIES,
        get_fidelity,
        list_models,
    )

    for name in list_models():
        tags = [get_fidelity(name)]
        if name in INT8_FAMILIES:
            tags.append("int8")
        print(f"{name}  [{', '.join(tags)}]")
    return 0


def cmd_engines(_args) -> int:
    from monocular_depth_estimation_trt_tpu_torch.runtime.engine import EngineRegistry

    reg = EngineRegistry()
    for name in reg.list():
        entry = reg.load(name) or {}
        bt = entry.get("build_seconds")
        print(f"{name}  build={bt:.2f}s" if bt else name)
    return 0


def _add_precision_args(p, calib: bool = True) -> None:
    """Shared --precision/--calib-dir flags."""
    p.add_argument("--precision", default="", choices=["", "bf16", "fp16", "fp32", "int8"],
                   help="compute precision; int8 = statically calibrated w8a8 serving "
                   "(kernel K4)")
    if calib:
        p.add_argument("--calib-dir", default="", dest="calib_dir",
                       help="directory of domain images for int8 activation-scale calibration")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mdet", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--allow-random-weights", action="store_true",
                   help="permit deterministic random weights when no checkpoint is "
                   "available (outputs are not meaningful)")
    p.add_argument("--device", default=os.environ.get("MDET_DEVICE", "cuda"), choices=DEVICES,
                   help="cuda (default; env MDET_DEVICE) runs on the card and raises without "
                   "one; cpu runs the plain PyTorch path")
    sub = p.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="single-image inference")
    run.add_argument("model", nargs="?", default="")
    run.add_argument("--encoder", default="")
    run.add_argument("--image", default="data/example.jpg")
    run.add_argument("--out", default="results")
    run.add_argument("--resize", type=int, default=0,
                     help="pre-resize the raw image to a square (reference onnx2trt.py:146)")
    run.add_argument("--metric", action="store_true")
    run.add_argument("--dataset", default="hypersim")
    run.add_argument("--checkpoint", default="")
    _add_precision_args(run)
    run.add_argument("--pointcloud", action="store_true")
    run.add_argument("--focal", type=float, default=470.4,
                     help="focal for unprojection (reference onnx2trt_pointcloud.py)")
    run.add_argument("--mesh-format", default="ply", choices=["ply", "glb"],
                     help="point-cloud container")
    run.add_argument("--mesh", action="store_true",
                     help="write a triangulated image-grid mesh of the model's point map "
                     "(moge2, metric_anything) instead of points; implies --pointcloud")
    run.add_argument("--benchmark", action="store_true")
    run.add_argument("--compare", default="",
                     help="compare the depth against a stored .npz and fail on drift")
    run.add_argument("--compare-tol", type=float, default=1e-2,
                     help="max relative error allowed with --compare")
    run.set_defaults(fn=cmd_run)

    batch = sub.add_parser("batch", help="batched offline serving over an image dir")
    batch.add_argument("model", nargs="?", default="")
    batch.add_argument("--encoder", default="")
    batch.add_argument("--images-dir", required=True)
    batch.add_argument("--batch", type=int, default=8)
    batch.add_argument("--out", default="results")
    batch.add_argument("--max-frames", type=int, default=0)
    batch.add_argument("--checkpoint", default="")
    _add_precision_args(batch)
    batch.add_argument("--save", action="store_true",
                       help="write per-image npz + viz (default: throughput mode, outputs "
                       "discarded)")
    batch.add_argument("--decode-threads", type=int, default=4)
    batch.set_defaults(fn=cmd_batch)

    bench = sub.add_parser("bench", help="benchmark a model config")
    bench.add_argument("model", nargs="?", default="")
    bench.add_argument("--encoder", default="")
    _add_precision_args(bench)
    bench.add_argument("--size", type=int, default=0,
                       help="square input size (default: the model's)")
    bench.add_argument("--warmup", type=int, default=10)
    bench.add_argument("--iterations", type=int, default=100)
    bench.add_argument("--views", type=int, default=0,
                       help="multi-view S axis (VGGT): benchmark the S-view engine, per-frame "
                       "FPS")
    bench.set_defaults(fn=cmd_bench)

    views = sub.add_parser("views", help="multi-view 3D reconstruction (S-view VGGT engine)")
    views.add_argument("model", nargs="?", default="vggt")
    views.add_argument("--images", nargs="+", required=True)
    views.add_argument("--out", default="results")
    views.add_argument("--resize", type=int, default=0,
                       help="square side for every view (default 518)")
    _add_precision_args(views)
    views.set_defaults(fn=cmd_views)

    build = sub.add_parser("build", help="build (warm up and capture) an engine")
    build.add_argument("model")
    build.add_argument("--encoder", default="")
    build.add_argument("--size", type=int, default=518)
    build.add_argument("--metric", action="store_true")
    build.add_argument("--viz", action="store_true")
    _add_precision_args(build, calib=False)
    build.set_defaults(fn=cmd_build)

    serve = sub.add_parser("serve", help="HTTP depth serving (POST images to /v1/depth)")
    serve.add_argument("model", nargs="?", default="")
    serve.add_argument("--encoder", default="")
    serve.add_argument("--checkpoint", default="")
    _add_precision_args(serve)
    serve.add_argument("--host", default="0.0.0.0")
    serve.add_argument("--port", type=int, default=8000)
    serve.add_argument("--size", type=int, default=0,
                       help="served square input size (default: model spec)")
    serve.add_argument("--max-queue", type=int, default=32, dest="max_queue")
    serve.add_argument("--max-batch", type=int, default=1, dest="max_batch",
                       help="dynamic batching: serve up to N queued requests per launch "
                       "(power-of-two buckets)")
    serve.add_argument("--batch-window-ms", type=float, default=2.0, dest="batch_window_ms",
                       help="how long to wait for straggler requests once one is in hand "
                       "(only with --max-batch > 1)")
    serve.set_defaults(fn=cmd_serve)

    sub.add_parser("models", help="list registered models").set_defaults(fn=cmd_models)
    sub.add_parser("engines", help="list built engines").set_defaults(fn=cmd_engines)
    for sp in (run, batch, views, serve):
        # SUPPRESS: the subparser's default must not clobber the main
        # parser's flag when it is given before the subcommand
        sp.add_argument("--allow-random-weights", action="store_true",
                        dest="allow_random_weights", default=argparse.SUPPRESS,
                        help="permit random weights when no checkpoint exists")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.device not in DEVICES:
        # argparse never validates defaults: a bad MDET_DEVICE lands here
        log(f"invalid MDET_DEVICE/--device {args.device!r}; want cuda|cpu", tag="ERROR")
        return 2
    if getattr(args, "allow_random_weights", False) or args.cmd in ("bench", "build"):
        # bench and build measure speed and layout, not numerics: random
        # weights are fine there (and loudly warned). Everything else errors
        # on a missing checkpoint unless --allow-random-weights.
        from monocular_depth_estimation_trt_tpu_torch.weights.store import (
            set_allow_random_weights,
        )

        set_allow_random_weights(True)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
