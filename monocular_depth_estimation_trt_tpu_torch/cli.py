"""Command-line interface (counterpart of the JAX package's ``cli.py``).

Replaces the reference's "edit constants at the top of the script" workflow
(``Depth_Anything_V2/onnx2trt.py:153-159``) with one typed CLI::

    python -m monocular_depth_estimation_trt_tpu_torch run depth_anything_v2 \
        --encoder vits --image frame.png --out results/ --pointcloud

    python -m monocular_depth_estimation_trt_tpu_torch run moge2 --image frame.png \
        --mesh --mesh-format glb

    python -m monocular_depth_estimation_trt_tpu_torch pair align3r --image1 a.png --image2 b.png

    python -m monocular_depth_estimation_trt_tpu_torch video video_depth_anything --video in.mp4
    python -m monocular_depth_estimation_trt_tpu_torch video flashdepth --video in.mp4
    python -m monocular_depth_estimation_trt_tpu_torch batch depth_anything_v2 --video in.mp4
    python -m monocular_depth_estimation_trt_tpu_torch webcam depth_anything_v2 --camera 0
    python -m monocular_depth_estimation_trt_tpu_torch flow raft --frames frames/ --out results/
    python -m monocular_depth_estimation_trt_tpu_torch flow memfof --video in.mp4
    python -m monocular_depth_estimation_trt_tpu_torch track cotracker3 --video in.mp4 --grid 10
    python -m monocular_depth_estimation_trt_tpu_torch slam megasam --video in.mp4 --cvd

    python -m monocular_depth_estimation_trt_tpu_torch serve depth_anything_v2 --max-batch 4
    python -m monocular_depth_estimation_trt_tpu_torch bench depth_anything_v2 --encoder vits
    python -m monocular_depth_estimation_trt_tpu_torch models

    python -m monocular_depth_estimation_trt_tpu_torch export depth_anything_v2 --serve-bundle 4
    python -m monocular_depth_estimation_trt_tpu_torch serve --engine a.mdeteng --engine b.mdeteng
    python -m monocular_depth_estimation_trt_tpu_torch bench --engine a.mdeteng --trace traces/
    python -m monocular_depth_estimation_trt_tpu_torch doctor

    python -m monocular_depth_estimation_trt_tpu_torch convert depth_anything_v2 --encoder vits \
        --checkpoint depth_anything_v2_vits.pth --verify-manifest
    python -m monocular_depth_estimation_trt_tpu_torch distill --images-dir frames/ --promote
    python -m monocular_depth_estimation_trt_tpu_torch eval --pred results/ --gt gt/ --align affine
    python -m monocular_depth_estimation_trt_tpu_torch quantcheck depth_anything_v2 --encoder vitl

Every command runs on the card (``--device cuda``, the default) unless
``--device cpu`` asks for the port's plain PyTorch path on the CPU; without
a card the default raises. Artifacts mirror the reference's outputs and the
JAX CLI's file names: the turbo-colormapped viz (``.jpg``; ``.png`` where
no JPEG codec is importable, see ``utils/imageio.py``), a compressed
``.npz`` of the depth and the model's other outputs (the JAX CLI's holds the
depth alone), the ``_fov.json`` camera estimate, an optional ``.ply``/``.glb``
point cloud or, for a point-map model, mesh, and the ``[MDET] max/min``
parity line
(``onnx2trt.py:218-245``). ``pair`` writes Align3R's depth image, a PLY of
both views' points in view 1's frame with their colors, and the relative
pose as JSON. ``video`` writes a colorized depth MP4 beside the source's
name: the whole-video protocol with one normalization for a windowed model
(``video_depth_anything``), else frame by frame with the frame rate
overlaid, through the model's stream where it has one (``flashdepth``,
``streamvggt``); ``batch --video`` serves a video's frames as a directory
of PNGs; ``webcam`` shows a camera's depth live. Video needs cv2: without it
these commands exit non-zero naming the missing codec
(``utils/imageio.py``). ``flow`` writes the color-wheel MP4 of an optical-flow
model over a directory of frames or a video's frames (``raft``, ``neuflow``,
``meflow``, ``waft`` on consecutive pairs, ``memfof`` on triplets).
``track`` writes CoTracker3's grid tracks drawn on the video
(``<stem>_<artifact>.mp4``, tracks rescaled to the source size); ``slam``
runs a SLAM recipe (``megasam``, ``vipe``, ``wildgs_slam``) over a video or
a directory of frames and writes the poses, keyframes, refined focal, BA
residual and aligned keyframe disparity (and the recipe's metric scale or
rendered depth) as ``<stem>_<artifact>.npz``, with ``--cvd`` also each
frame's consistent disparity (``_cvd.npz``).

``export`` writes a serialized engine artifact (``.mdeteng``,
``runtime/export.py``): the fused programs of each platform that
``--platforms`` names (default ``cpu,cuda``) with the weights stored once;
``--device`` is where the pipeline is built, so a host with no card
exports the CUDA programs under ``--device cpu``. ``--engine FILE`` serves
one on ``run``, ``batch``, ``bench``, ``views``, ``pair``, ``video``,
``flow``, ``webcam`` and ``serve`` (repeated on ``serve``: several models
behind one worker) with no model code, on ``--device``: its program for
that device is loaded, and an artifact without one exits 2. ``bench
--trace DIR`` writes a ``torch.profiler`` Chrome trace of the timed loop;
``doctor`` reports the installation.

``convert`` checks an upstream checkpoint (``--verify-manifest`` against
the family's key manifest, ``--report`` for the load's audit) and installs
it in the params cache that ``run`` and the other commands read without a
``--checkpoint``; ``distill`` trains a DA-V2-family student against a frozen
teacher (``--qat`` for int8 serving, ``--promote`` into the params cache);
``eval`` scores predictions against ground truth and ``quantcheck`` an int8
pipeline against its bf16 twin, each in one JSON line. ``run --colorbar``
also writes the colorbar-in-meters figure (matplotlib; without it the
command exits 1 naming it).

``--device-mesh DxM`` on ``run``, ``bench``, ``views`` and ``serve`` shards
the model over a data x model mesh (``parallel/``): ``1x1`` is the one
device and changes nothing; a larger mesh needs one process per device,
``torchrun --nproc-per-node D*M -m monocular_depth_estimation_trt_tpu_torch
... --device-mesh DxM``, in which every rank computes and rank 0 alone
writes files and prints results (``serve``: rank 0 answers HTTP, the other
ranks follow its calls).
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


def _device_mesh_shape(mesh_str: str):
    try:
        shape = tuple(int(s) for s in mesh_str.lower().split("x"))
    except ValueError:
        raise SystemExit(f"[MDET] bad --device-mesh {mesh_str!r}; want DxM")
    if len(shape) != 2 or min(shape) < 1:
        raise SystemExit(f"[MDET] bad --device-mesh {mesh_str!r}; want DxM")
    return shape


def _join_device_mesh(args) -> None:
    """Before a build: check ``--device-mesh`` and, for more than one
    device, join the process group the launcher describes (one process per
    device), so that this rank's pipeline is built on its own card."""
    mesh_str = getattr(args, "device_mesh", "")
    if not mesh_str:
        return
    from monocular_depth_estimation_trt_tpu_torch.parallel.mesh import init_process_group

    d, m = _device_mesh_shape(mesh_str)
    if d * m > 1:
        available = init_process_group(args.device)
        if d * m > available:
            raise SystemExit(f"[MDET] --device-mesh {mesh_str} needs {d * m} devices; "
                             f"{available} available")
        if d * m < available:
            raise SystemExit(f"[MDET] --device-mesh {mesh_str} needs {d * m} devices; the "
                             f"process group holds {available}: start {d * m} processes")


def _apply_device_mesh(pipe, mesh_str: str):
    """Shard a pipeline over ``--device-mesh DxM`` (data x model axes).

    ``1x1`` (or an absent flag) is the one-device case: every placement
    collapses to the plain tensor and the same program runs unchanged (see
    parallel/sharding.py). More devices take the process group that
    :func:`_join_device_mesh` joined."""
    if not mesh_str:
        return pipe
    from monocular_depth_estimation_trt_tpu_torch.parallel.mesh import (
        get_mesh,
        single_device_mesh,
        world_size,
    )

    shape = _device_mesh_shape(mesh_str)
    need = shape[0] * shape[1]
    if need == 1:
        return pipe.apply_mesh(single_device_mesh(pipe.device.type))
    if need != world_size():
        raise SystemExit(f"[MDET] --device-mesh {mesh_str} needs {need} devices; "
                         f"{world_size()} available")
    return pipe.apply_mesh(get_mesh(shape, ("data", "model"), device_type=pipe.device.type))


def _is_rank0() -> bool:
    from monocular_depth_estimation_trt_tpu_torch.parallel.mesh import rank

    return rank() == 0


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


def _load_artifact(path, *, surface, device, need_viz=False, allow_stream_viz=False,
                   need_images=(1,), need_views=None):
    """Check an ``.mdeteng`` against what a surface needs from its meta
    alone (a zip header read: a wrong artifact is refused before its weights
    go to the device), then load its program for ``device`` (``--device``).
    None, after an error line, when the artifact cannot serve the surface:
    it lacks that platform (the line names ``--platforms``), or the device
    is a card and there is none.

    ``need_viz`` counts the per-call viz modules (the surfaces that call
    ``pipe(frame, viz=True)``); ``allow_stream_viz`` also takes a stream
    module (``video``, which goes through ``.stream()``)."""
    from monocular_depth_estimation_trt_tpu_torch.runtime.export import (
        check_meta,
        load_engine,
        read_meta,
    )

    meta = read_meta(path)
    try:
        check_meta(path, meta, device)
    except (ValueError, RuntimeError) as e:
        log(str(e), tag="ERROR")
        return None
    n = int(meta.get("n_image_args", 1))
    if n not in need_images:
        log(f"{surface} needs a {'/'.join(map(str, need_images))}-image artifact; {path} "
            f"takes {n} image(s) per call", tag="ERROR")
        return None
    mods = list(meta["modules"].values())
    call_viz = any(m["viz"] and not m.get("stream") for m in mods)
    stream_viz = any(m.get("stream") for m in mods)
    if need_viz and not (call_viz or (allow_stream_viz and stream_viz)):
        log(f"{surface} needs a viz module; re-export with --viz or --serve-bundle",
            tag="ERROR")
        return None
    if need_views is not None:
        avail = sorted(m["views"] for m in mods if m.get("views"))
        if need_views not in avail:
            log(f"{surface}: no views module for S={need_views} (available: {avail}); "
                "re-export with --views", tag="ERROR")
            return None
    eng = load_engine(path, device)
    log(f"{surface} from artifact: {eng.describe()}")
    return eng


def cmd_run(args) -> int:
    from monocular_depth_estimation_trt_tpu_torch.utils.imageio import read_image, resize

    img = read_image(args.image)
    if args.resize:
        img = resize(img, (args.resize, args.resize))
    log(f"original shape : {img.shape}")
    if args.engine:
        # the deserialize-and-run consumer of a plan file (reference
        # common_runtime.py): no model code, no checkpoint
        eng = _load_artifact(args.engine, device=args.device, surface="run")
        if eng is None:
            return 2
        # fitted here, so that the point cloud takes its colors from the
        # frame the depth was computed on
        img = eng.fit(img)
        return _write_run_outputs(args, img, eng(img, viz=True), eng.meta["artifact"], pipe=eng)
    if not args.model:
        log("run: give a model name (or --engine artifact)", tag="ERROR")
        return 2
    pipe = _apply_device_mesh(_build(args, "encoder", "checkpoint", "precision"),
                              args.device_mesh)
    out = pipe(img, viz=True)
    if not _is_rank0():  # every rank computes, rank 0 writes
        if args.benchmark:
            pipe.benchmark((img.shape[0], img.shape[1]))
        return 0
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

    if args.colorbar:
        from monocular_depth_estimation_trt_tpu_torch.apps.pointcloud import (
            save_metric_colorbar_figure,
        )

        bar = os.path.join(args.out, f"{stem}_{name}_depth_bar.jpg")
        try:
            save_metric_colorbar_figure(depth, bar)
        except ImportError as e:
            log(f"--colorbar needs matplotlib, which is not importable here ({e})", tag="ERROR")
            return 1
        log(f"wrote {bar}")

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
    """Batched offline serving over an image directory or a video's frames
    (``apps/offline.py``): decode threads keep frames ahead of a (B, H, W, 3)
    engine."""
    from monocular_depth_estimation_trt_tpu_torch.apps.offline import process_images_batched
    from monocular_depth_estimation_trt_tpu_torch.utils.files import list_images

    if bool(args.images_dir) == bool(args.video):
        log("batch: give exactly one of --images-dir / --video", tag="ERROR")
        return 2
    if args.video:
        from monocular_depth_estimation_trt_tpu_torch.apps.streaming import (
            extract_frames_from_video,
        )

        frames_dir = os.path.join(args.out, "_frames")
        extract_frames_from_video(args.video, frames_dir, max_frames=args.max_frames or None)
        paths = list_images(frames_dir)
    else:
        paths = list_images(args.images_dir)
        if args.max_frames:
            paths = paths[: args.max_frames]
    if not paths:
        log("batch: no images found", tag="ERROR")
        return 1
    if args.engine:
        pipe = _load_artifact(args.engine, device=args.device, surface="batch")
        if pipe is None:
            return 2
    elif not args.model:
        log("batch: give a model name (or --engine artifact)", tag="ERROR")
        return 2
    else:
        pipe = _build(args, "encoder", "checkpoint", "precision")
    os.makedirs(args.out, exist_ok=True)
    name = pipe.spec.artifact_name()

    on_result = None
    if args.save:
        def on_result(start_idx, host):
            depths = np.asarray(host["depth"])
            for j in range(depths.shape[0]):
                i = start_idx + j
                if i >= len(paths):  # tail-batch padding
                    break
                stem = os.path.splitext(os.path.basename(paths[i]))[0]
                d = depths[j]
                np.savez_compressed(os.path.join(args.out, f"{stem}_{name}.npz"), depth=d)
                _write_inferno(os.path.join(args.out, f"{stem}_{name}.jpg"), d)

    stats = process_images_batched(pipe, paths, batch=args.batch, on_result=on_result,
                                   decode_threads=args.decode_threads)
    print(json.dumps({"metric": f"{name}_batched_fps", "value": stats["fps"], "unit": "fps",
                      "batch": stats["batch"], "frames": stats["frames"],
                      "decode": stats["decode"]}))
    return 0


def _write_inferno(path: str, depth) -> str:
    """The JAX CLI's depth image: min-max normalized, cv2's inferno colormap
    where cv2 imports, else gray (``utils/imageio.py`` writes ``.png`` where
    no JPEG codec imports). Returns the path written."""
    from monocular_depth_estimation_trt_tpu_torch.utils import imageio

    from monocular_depth_estimation_trt_tpu_torch.runtime import native

    d = np.asarray(depth)
    norm = ((d - d.min()) / max(float(d.max() - d.min()), 1e-6) * 255).astype(np.uint8)
    cv2 = imageio._cv2()
    if cv2 is None:
        return imageio.write_gray(path, norm)
    rgb = cv2.cvtColor(cv2.applyColorMap(norm, cv2.COLORMAP_INFERNO), cv2.COLOR_BGR2RGB)
    # the native encoder where the library is available (the JAX CLI's
    # batch writer); cv2 covers a failed native encode too
    if path.endswith(".jpg") and native.native_available() and native.encode_jpg(path, rgb):
        return path
    return imageio.write_image(path, rgb)


def cmd_pair(args) -> int:
    """Two-image 3D reconstruction (Align3R): the depth image, a colored
    point-cloud PLY of both views' points and the relative pose as JSON
    (reference ``later/Align3R/README.md``: "two 2d images -> depth, point
    cloud, Camera pose")."""
    from monocular_depth_estimation_trt_tpu_torch.apps.ply import write_ply
    from monocular_depth_estimation_trt_tpu_torch.utils.imageio import read_image, resize

    img1, img2 = read_image(args.image1), read_image(args.image2)
    if args.engine:
        pipe = _load_artifact(args.engine, device=args.device, surface="pair", need_images=(2,))
        if pipe is None:
            return 2
        img1, img2 = pipe.fit(img1), pipe.fit(img2)
    else:
        pipe = _build(args)
    out = pipe(img1, img2)

    os.makedirs(args.out, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.image1))[0]
    name = pipe.spec.artifact_name()
    depth = np.asarray(out["depth"])
    log(f"max : {depth.max():.5f} , min : {depth.min():.5f}")
    log(f"wrote {_write_inferno(os.path.join(args.out, f'{stem}_{name}.jpg'), depth)}")

    side = depth.shape[0]  # the points are at the model's square input size
    colors = np.concatenate([resize(img, (side, side)).reshape(-1, 3) for img in (img1, img2)])
    pts = np.concatenate([np.asarray(out["pts1"]).reshape(-1, 3),
                          np.asarray(out["pts2"]).reshape(-1, 3)])
    ply = os.path.join(args.out, f"{stem}_{name}.ply")
    write_ply(ply, pts, colors)
    log(f"wrote {ply}")

    pose = os.path.join(args.out, f"{stem}_{name}_pose.json")
    with open(pose, "w") as f:
        json.dump({"rotation": np.asarray(out["rotation"]).tolist(),
                   "translation": np.asarray(out["translation"]).tolist()}, f, indent=2)
    log(f"wrote {pose}")
    return 0


def cmd_video(args) -> int:
    """Depth over a video file -> colorized MP4 (reference
    ``Depth_Pro/onnx2trt_video.py``; the windowed protocol of Video Depth
    Anything's ``run.py`` for a model with ``video_depth``)."""
    from monocular_depth_estimation_trt_tpu_torch.apps.streaming import (
        run_video,
        write_depth_video,
    )
    from monocular_depth_estimation_trt_tpu_torch.utils.imageio import open_video

    if args.engine:
        pipe = _load_artifact(args.engine, device=args.device, surface="video", need_viz=True,
                              allow_stream_viz=True)
        if pipe is None:
            return 2
        open_video(args.video).release()
    elif not args.model:
        log("video: give a model name (or --engine artifact)", tag="ERROR")
        return 2
    else:
        open_video(args.video).release()  # the codec and the file, before the build
        pipe = _build(args, "encoder", "checkpoint", "precision")
    os.makedirs(args.out, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.video))[0]
    out_path = os.path.join(args.out, f"{stem}_{pipe.spec.artifact_name()}.mp4")
    if hasattr(pipe, "video_depth"):
        write_depth_video(pipe, args.video, out_path, max_frames=args.max_frames or None)
    else:
        run_video(pipe, args.video, out_path, max_frames=args.max_frames or None)
    return 0


def cmd_webcam(args) -> int:
    """Live depth viewer (reference ``Depth_Pro/onnx2trt_webcam.py``; takes an
    IP-camera URL)."""
    from monocular_depth_estimation_trt_tpu_torch.apps.streaming import run_webcam
    from monocular_depth_estimation_trt_tpu_torch.utils.imageio import video_cv2

    if args.engine:
        pipe = _load_artifact(args.engine, device=args.device, surface="webcam", need_viz=True)
        if pipe is None:
            return 2
        video_cv2(f"camera {args.camera!r}")
    elif not args.model:
        log("webcam: give a model name (or --engine artifact)", tag="ERROR")
        return 2
    else:
        video_cv2(f"camera {args.camera!r}")  # the codec, before the build
        pipe = _build(args, "encoder", "checkpoint", "precision")
    run_webcam(pipe, int(args.camera) if args.camera.isdigit() else args.camera)
    return 0


FLOW_MODELS = ("raft", "neuflow", "meflow", "memfof", "waft")


def cmd_flow(args) -> int:
    """Optical flow over consecutive frames of a directory or a video ->
    ``<model>_flow.mp4`` (reference RAFT / NeuFlow / MeFlow ``onnx2trt.py``
    video loops): pairs, or MEMFOF's triplets."""
    import inspect

    from monocular_depth_estimation_trt_tpu_torch import registry
    from monocular_depth_estimation_trt_tpu_torch.apps.streaming import (
        extract_frames_from_video,
        run_flow_frames,
        run_flow_triplets,
    )
    from monocular_depth_estimation_trt_tpu_torch.utils.imageio import video_cv2

    if args.engine:
        pipe = _load_artifact(args.engine, device=args.device, surface="flow", need_viz=True,
                              need_images=(2, 3))
        if pipe is None:
            return 2
        video_cv2("the flow MP4")
        model_name = pipe.spec.model
        triplets = int(pipe.meta["n_image_args"]) == 3
    elif not args.model:
        log("flow: give a model name (or --engine artifact)", tag="ERROR")
        return 2
    else:
        video_cv2("the flow MP4")  # the codec, before the build
        kw = {"device": args.device}
        if args.iters:
            if "iters" in inspect.signature(registry._REGISTRY[args.model]).parameters:
                kw["iters"] = args.iters
            else:
                log(f"flow: {args.model} has no iterations to set; --iters ignored",
                    tag="WARN")
        pipe = registry.build_pipeline(args.model, **kw)
        model_name = args.model
        triplets = args.model == "memfof"
    frames_dir = args.frames
    if args.video:
        frames_dir = os.path.join(args.out, "_frames")
        extract_frames_from_video(args.video, frames_dir, max_frames=args.max_frames or None)
    os.makedirs(args.out, exist_ok=True)
    out_path = os.path.join(args.out, f"{model_name}_flow.mp4")
    if triplets:
        run_flow_triplets(pipe, frames_dir, out_path, max_triplets=args.max_frames or None)
    else:
        run_flow_frames(pipe, frames_dir, out_path, max_pairs=args.max_frames or None)
    return 0


def cmd_track(args) -> int:
    """Online point tracking over a video -> tracked-points MP4 (reference
    ``later/CoTracker3/infer.py``)."""
    from monocular_depth_estimation_trt_tpu_torch import registry
    from monocular_depth_estimation_trt_tpu_torch.apps.tracking import visualize_tracks
    from monocular_depth_estimation_trt_tpu_torch.utils.imageio import read_video

    video, _ = read_video(args.video, max_frames=args.max_frames or None)
    pipe = registry.build_pipeline(args.model, grid_size=args.grid, device=args.device)
    tracks, vis = pipe.track_video(video)
    # tracks are at the model's input size; rescale to the source video
    ih, iw = pipe.spec.input_hw
    tracks = tracks * np.asarray([video.shape[2] / iw, video.shape[1] / ih], np.float32)
    os.makedirs(args.out, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.video))[0]
    visualize_tracks(video, tracks, vis,
                     os.path.join(args.out, f"{stem}_{pipe.spec.artifact_name()}.mp4"))
    return 0


def _load_clip(args) -> list:
    """Frames for the SLAM recipes: ``--video`` (with ``--stride`` /
    ``--max-frames``) or a ``--frames`` directory of images."""
    from monocular_depth_estimation_trt_tpu_torch.utils.imageio import (
        iter_video,
        open_video,
        read_image,
    )

    stride = max(args.stride, 1)
    frames = []
    if args.video:
        for n, rgb in enumerate(iter_video(open_video(args.video))):
            if n % stride == 0:
                frames.append(rgb)
                if args.max_frames and len(frames) >= args.max_frames:
                    break
    else:
        for nm in sorted(os.listdir(args.frames))[::stride]:
            if os.path.splitext(nm)[1].lower() in (".jpg", ".jpeg", ".png"):
                frames.append(read_image(os.path.join(args.frames, nm)))
                if args.max_frames and len(frames) >= args.max_frames:
                    break
    if len(frames) < 2:
        raise ValueError(f"[MDET] need >=2 frames, got {len(frames)}")
    return frames


def cmd_slam(args) -> int:
    """Video SLAM recipes: the reference's three README-only staging dirs
    (``later/MegaSaM/README.md``, ``later/VIPE/README.md``,
    ``later/WildGS-SLAM/README.md``) as compositions of the port's own
    engines. Writes poses + refined focal + aligned keyframe disparity (and,
    with ``--cvd``, per-frame consistent video depth)."""
    from monocular_depth_estimation_trt_tpu_torch import registry

    frames = _load_clip(args)
    pipe = registry.build_pipeline(args.model, device=args.device)
    if not hasattr(pipe, "run"):
        log(f"{args.model} is not a SLAM recipe", tag="ERROR")
        return 2
    res = pipe.run(frames, focal=args.focal or None)

    os.makedirs(args.out, exist_ok=True)
    src = args.video or args.frames
    stem = os.path.splitext(os.path.basename(os.path.normpath(src)))[0]
    name = pipe.spec.artifact_name()
    payload = {
        "poses": res.poses,
        "keyframes": np.asarray(res.keyframe_indices, np.int32),
        "focal_px": np.float32(res.focal),
        "rms_px": np.float32(res.rms_px),
        "keyframe_disparity": np.stack(res.keyframe_disparity),
    }
    if "metric_scale" in res.extras:
        payload["metric_scale"] = np.float32(res.extras["metric_scale"])
    if "rendered_depth" in res.extras:
        payload["rendered_depth"] = np.stack(res.extras["rendered_depth"])
    npz = os.path.join(args.out, f"{stem}_{name}.npz")
    np.savez_compressed(npz, **payload)
    log(f"wrote {npz} (K={len(res.keyframe_indices)}, rms {res.rms_px:.2f} px, "
        f"focal {res.focal:.1f} px)")
    if args.cvd:
        cvd = pipe.consistent_video_depth(frames, res)
        cvd_npz = os.path.join(args.out, f"{stem}_{name}_cvd.npz")
        np.savez_compressed(cvd_npz, disparity=np.stack(cvd))
        log(f"wrote {cvd_npz} ({len(cvd)} frames)")
    return 0


def _maybe_trace(args):
    """``--trace DIR``: a ``torch.profiler`` trace of the timed loop (the
    TensorRT DETAILED profiling role, ``Depth_Anything_V2/onnx2trt.py:40``),
    else a context that does nothing."""
    import contextlib

    if not getattr(args, "trace", ""):
        return contextlib.nullcontext()
    from monocular_depth_estimation_trt_tpu_torch.runtime import profiler

    return profiler.trace(args.trace)


def cmd_bench(args) -> int:
    from monocular_depth_estimation_trt_tpu_torch.config import BenchmarkConfig

    cfg = BenchmarkConfig(warmup=args.warmup, iterations=args.iterations)
    if args.engine:
        from monocular_depth_estimation_trt_tpu_torch.runtime.export import read_meta

        meta = read_meta(args.engine)
        if args.precision or args.encoder or args.device_mesh:
            log("bench --engine: --device-mesh/--precision/--encoder are baked into the "
                "artifact at export time", tag="ERROR")
            return 2
        if args.size and (args.size, args.size) != tuple(meta["in_hw"]):
            log(f"bench --engine: the artifact is fixed at {tuple(meta['in_hw'])}; --size "
                f"{args.size} cannot apply (re-export at that size)", tag="ERROR")
            return 2
        pipe = _load_artifact(args.engine, device=args.device, surface="bench")
        if pipe is None:
            return 2
        with _maybe_trace(args):
            if args.views and args.views > 1:
                report = pipe.benchmark_views(args.views, cfg)
            else:
                report = pipe.benchmark(config=cfg)
        report.print()
        return 0
    if not args.model:
        log("bench: give a model name (or --engine artifact)", tag="ERROR")
        return 2
    pipe = _apply_device_mesh(_build(args, "encoder", "precision"), args.device_mesh)
    if args.views and args.views > 1 and not hasattr(pipe, "benchmark_views"):
        log(f"{args.model} has no multi-view protocol", tag="ERROR")
        return 2
    with _maybe_trace(args):
        if args.views and args.views > 1:
            report = pipe.benchmark_views(args.views, cfg)
        else:
            in_hw = (args.size, args.size) if args.size else tuple(pipe.spec.input_hw)
            report = pipe.benchmark(in_hw, cfg)
    if _is_rank0():
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
    if args.engine:
        pipe = _load_artifact(args.engine, device=args.device, surface="views",
                              need_views=len(imgs))
        if pipe is None:
            return 2
    elif not args.model:
        log("views: give a model name (or --engine artifact)", tag="ERROR")
        return 2
    else:
        pipe = _apply_device_mesh(_build(args, "precision"), args.device_mesh)
        if not hasattr(pipe, "multi_view"):
            log(f"{args.model} has no multi-view protocol", tag="ERROR")
            return 2
    out = pipe.multi_view(np.stack(imgs))
    if not _is_rank0():
        return 0

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
    from monocular_depth_estimation_trt_tpu_torch.apps import server

    if args.engine:
        # the deployment box needs the .mdeteng files alone (export with
        # --serve-bundle for the batch buckets and both viz modes); several
        # --engine flags serve several models behind one device worker
        # (POST /v1/models/<name>/depth)
        if args.device_mesh:
            log("serve --engine: shardings are baked into the artifact at export time; "
                "--device-mesh ignored", tag="WARN")
        loaded = []
        for path in args.engine:
            eng = _load_artifact(path, device=args.device, surface="serve")
            if eng is None:
                return 2
            loaded.append(eng)
        families = [e.spec.model for e in loaded]
        pipes = {}
        for eng, family in zip(loaded, families):
            # by family where it is unique, else by the full artifact name
            key = family if families.count(family) == 1 else eng.spec.artifact_name()
            if key in pipes:
                log(f"serve: duplicate model {key!r} (the same artifact twice?)", tag="ERROR")
                return 2
            pipes[key] = eng
        max_batch = args.max_batch
        largest = max(max(e.batches) for e in loaded)
        if max_batch > largest:
            log(f"--max-batch {max_batch} exceeds every artifact's largest exported bucket "
                f"({largest}); clamping", tag="WARN")
            max_batch = largest
        # a model whose artifact has smaller buckets is capped on its own by
        # the server (DepthServer.max_batch_by)
        server.serve(pipes, host=args.host, port=args.port, max_queue=args.max_queue,
                     max_batch=max_batch, batch_window_ms=args.batch_window_ms)
        return 0
    if not args.model:
        log("serve: give a model name (or --engine artifact)", tag="ERROR")
        return 2
    pipe = _apply_device_mesh(_build(args, "encoder", "checkpoint", "precision"),
                              args.device_mesh)
    hw = (args.size, args.size) if args.size else None
    server.serve(pipe, host=args.host, port=args.port, input_hw=hw, max_queue=args.max_queue,
                 max_batch=args.max_batch, batch_window_ms=args.batch_window_ms)
    return 0


def cmd_export(args) -> int:
    """Write a serialized engine artifact (``.mdeteng``,
    ``runtime/export.py``): the fused programs of each of ``--platforms``
    and the weights, the port's counterpart of the reference writing its
    TensorRT plan (``Depth_Anything_V2/onnx2trt.py:60-68``). The pipeline
    is built on ``--device``; the programs need no card. Serve it with
    ``--engine``."""
    from monocular_depth_estimation_trt_tpu_torch.runtime.export import (
        export_pipeline,
        parse_platforms,
    )

    try:
        platforms = parse_platforms(args.platforms)
    except ValueError as e:
        log(f"export --platforms: {e}", tag="ERROR")
        return 2
    pipe = _build(args, "encoder", "checkpoint", "precision")
    if args.serve_bundle:
        # what `serve --engine` needs: power-of-two buckets up to N, each in
        # both viz modes
        batches, b = [], 1
        while b <= args.serve_bundle:
            batches.append(b)
            b *= 2
        with_viz = "both"
    else:
        batches = [int(x) for x in args.batches.split(",") if x.strip()]
        with_viz = args.viz
    views = [int(x) for x in args.views.split(",") if x.strip()]
    path = export_pipeline(pipe, (args.size, args.size), with_viz=with_viz, batches=batches,
                           views=views, stream_window=args.stream_window,
                           path=args.out or None, platforms=platforms)
    print(path)
    return 0


def cmd_doctor(args) -> int:
    """What this installation will use: torch and CUDA, nvcc and the kernel
    library, the engine registry, exported artifacts, cached int8 bundles,
    native host IO and, last (``--no-devices`` skips it), the card."""
    import glob
    import subprocess

    import torch

    from monocular_depth_estimation_trt_tpu_torch.config import cache_dir
    from monocular_depth_estimation_trt_tpu_torch.ops.cuda import _build
    from monocular_depth_estimation_trt_tpu_torch.runtime import native
    from monocular_depth_estimation_trt_tpu_torch.runtime.engine import EngineRegistry
    from monocular_depth_estimation_trt_tpu_torch.runtime.export import (
        artifact_platforms,
        exported_dir,
        read_meta,
    )

    print(f"torch              : {torch.__version__} (CUDA {torch.version.cuda})")
    try:
        nvcc = _build._nvcc()
        version = subprocess.run([nvcc, "--version"], capture_output=True,
                                 text=True).stdout.strip().splitlines()
        print(f"nvcc               : {nvcc} ({version[-1] if version else '?'})")
    except _build.KernelBuildError:
        print("nvcc               : not found (kernels cannot build; CPU tensors run the "
              "plain versions)")
    lib = _build.library_path()
    state = "built" if os.path.exists(lib) else "not built yet (builds at the first launch)"
    print(f"kernel library     : {os.path.relpath(lib)} {state}")
    print(f"mdet cache dir     : {cache_dir()}")
    print(f"built engines      : {len(EngineRegistry().list())} registry entries")
    port, other = {}, []
    for path in sorted(glob.glob(os.path.join(exported_dir(), "*.mdeteng"))):
        try:
            meta = read_meta(path)
        except (OSError, KeyError, ValueError):
            other.append(path)
            continue
        if meta.get("runtime") == "torch":
            port[path] = artifact_platforms(meta)
        else:
            other.append(path)
    print(f"exported artifacts : {len(port)} of the port"
          + (f" (and {len(other)} it cannot serve)" if other else ""))
    for path, platforms in port.items():
        print(f"  {os.path.basename(path)}: platforms {','.join(platforms)}")
    bundles = glob.glob(os.path.join(cache_dir(), "params", "*_int8bundle_v2.pt"))
    mirror = os.environ.get("MDET_HF_CACHE") or os.path.join(cache_dir(), "hf")
    checkpoints = [f for f in glob.glob(os.path.join(mirror, "**", "*"), recursive=True)
                   if os.path.isfile(f)]
    print(f"cached weights     : {len(checkpoints)} checkpoint files in {mirror}, "
          f"{len(bundles)} int8 bundles")
    print("native host IO     : " + ("native (native/libmdet_hostio.so)"
                                     if native.native_available()
                                     else "python IO (the native library did not build "
                                          "or load)"))
    if args.no_devices:
        print("devices            : skipped (--no-devices)")
        return 0
    if not torch.cuda.is_available():
        print("devices            : no CUDA device")
        return 0
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip().splitlines()
    except OSError:
        smi = []
    print(f"devices            : {torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}"
          + (f" ({smi[0]})" if smi else ""))
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

    from monocular_depth_estimation_trt_tpu_torch.runtime.export import exported_dir

    reg = EngineRegistry()
    for name in reg.list():
        entry = reg.load(name) or {}
        bt = entry.get("build_seconds")
        print(f"{name}  build={bt:.2f}s" if bt else name)
    d = exported_dir()
    arts = sorted(f for f in os.listdir(d) if f.endswith(".mdeteng"))
    if arts:
        print("-- serialized artifacts (export) --")
        for f in arts:
            print(f"{f}  {os.path.getsize(os.path.join(d, f)) / 1e6:.2f} MB")
    return 0


def cmd_convert(args) -> int:
    """Check an upstream checkpoint and install it in the params cache.

    Computes on the CPU whatever ``--device`` says: a strict load is host
    work (the JAX package forces its CPU platform here too). Exit 0 on
    success, with the fp32 state dict written to the params cache under the
    artifact's name (``weights/store.py``); 1 when the strict load finds
    missing, extra or misshapen tensors; 2 when ``--verify-manifest`` finds
    the layout differs from the family's manifest, or there is no manifest;
    3 when the checkpoint cannot be found. ``--report`` prints the load's
    audit (consumed, missing, extra) and writes nothing."""
    import torch

    from monocular_depth_estimation_trt_tpu_torch import registry
    from monocular_depth_estimation_trt_tpu_torch.weights.store import (
        MissingCheckpointError,
        StateDictMismatchError,
        checkpoint_loads,
        resolve_checkpoint,
        save_params,
    )

    kw = {"encoder": args.encoder} if args.encoder else {}
    try:
        path = resolve_checkpoint(args.checkpoint)
        log(f"checkpoint resolves to {path}")
        if args.verify_manifest:
            from monocular_depth_estimation_trt_tpu_torch.weights.manifest import (
                format_report,
                load_manifest,
                manifest_key,
                verify_state_dict,
            )

            key = manifest_key(args.model, args.encoder)
            manifest = load_manifest(key) or load_manifest(manifest_key(args.model))
            if manifest is None:
                log(f"no manifest for {key!r} (weights/manifests/)", tag="ERROR")
                return 2
            rep = verify_state_dict(torch.load(path, map_location="cpu", weights_only=True),
                                    manifest)
            log("\n" + format_report(rep))
            if not rep["ok"]:
                return 2
        with checkpoint_loads(report_only=args.report) as loads:
            registry.build_pipeline(args.model, checkpoint=args.checkpoint, device="cpu", **kw)
    except StateDictMismatchError as e:
        log(str(e), tag="ERROR")
        return 1
    except MissingCheckpointError as e:
        log(str(e), tag="ERROR")
        return 3
    for entry in loads:
        a = entry["audit"]
        log(f"load audit ({entry['name']}): consumed {a['consumed']}/{a['total']} checkpoint "
            f"tensors; {len(a['missing'])} missing, {len(a['extra'])} extra, "
            f"{len(a['shape_mismatch'])} of another shape")
        for k in a["missing"]:
            log(f"  MISSING {k}", tag="WARN")
        for k in a["extra"]:
            log(f"  UNCONSUMED {k}", tag="WARN")
        for k, v in a["shape_mismatch"].items():
            log(f"  SHAPE {k}: checkpoint {v['checkpoint']} vs model {v['model']}", tag="WARN")
        if not args.report:
            save_params(entry["name"], entry["state_dict"])
    log("conversion OK")
    return 0


# the relative-depth DA-V2-family graphs, whose serving spec is ModelSpec's
# defaults at their name: the students distill can train
DISTILL_STUDENTS = ("depth_anything_v2", "distill_any_depth", "depth_anything_ac", "bridge")


def cmd_distill(args) -> int:
    """Teacher-to-student depth distillation on an image directory.

    A frozen bf16 teacher pipeline (its captured engine, kernel K1 on the
    card) labels each batch once; a DA-V2-family student trains in fp32
    against the labels with the SSI + gradient-matching objective
    (``training/``), through the plain attention route, as the kernels have
    no backward. The student starts from the weights its serving pipeline
    would load (the params cache, else seeded random weights where
    allowed), as fp32 weights. The train state is written to
    ``<out>/distill_<student>_<encoder>.pt``; ``--promote`` also installs
    the weights in the params cache under the student's artifact name (an
    entry there is moved aside to ``.pre-distill-bak``), so that ``run``
    serves them."""
    import shutil

    import torch

    from monocular_depth_estimation_trt_tpu_torch import registry
    from monocular_depth_estimation_trt_tpu_torch.config import ModelSpec
    from monocular_depth_estimation_trt_tpu_torch.models import depth_anything_v2 as da
    from monocular_depth_estimation_trt_tpu_torch.ops.quant import install_qat
    from monocular_depth_estimation_trt_tpu_torch.training import distill, save_train_state
    from monocular_depth_estimation_trt_tpu_torch.training.distill import depth_student
    from monocular_depth_estimation_trt_tpu_torch.utils.files import list_images
    from monocular_depth_estimation_trt_tpu_torch.utils.imageio import read_image, resize
    from monocular_depth_estimation_trt_tpu_torch.weights.store import (
        params_path,
        resolve_weights,
        save_params,
    )

    if args.steps < 1:
        log("--steps must be >= 1", tag="ERROR")
        return 1
    size = args.size - args.size % 14  # ViT patch grid
    paths = list_images(args.images_dir)
    if len(paths) < args.batch:
        log(f"need at least --batch={args.batch} images in {args.images_dir}; found "
            f"{len(paths)}", tag="ERROR")
        return 1
    if len(paths) > args.max_images:
        # frames and teacher labels stay resident for the run: cap them
        log(f"capping at --max-images={args.max_images} of {len(paths)} images (raise the "
            "flag to use more)", tag="WARN")
        paths = paths[: args.max_images]
    tail = len(paths) % args.batch
    if tail:
        log(f"dropping {tail} tail image(s) that don't fill a --batch={args.batch} chunk "
            "(static shapes, one engine)")
    frames = np.stack([resize(read_image(p), (size, size)) for p in paths])
    log(f"distilling from {len(frames) - tail} images @ {size}x{size}")

    device = registry.resolve_device(args.device)
    teacher = registry.build_pipeline(
        args.teacher, device=device,
        **({"encoder": args.teacher_encoder} if args.teacher_encoder else {}))

    def teacher_fn(imgs_u8):
        return teacher.batch_call(imgs_u8, device_out=True)["depth"]

    # the student: the weights its bf16 serving pipeline would load (named by
    # that pipeline's spec; seeded random weights are the CPU generator's),
    # filled into a fresh fp32 model on the host, then moved to the device
    # in full fp32 (TF32 off for the process, as a precision="fp32" build)
    name = ModelSpec(model=args.student, encoder=args.student_encoder).artifact_name()
    model = registry._new_model(
        lambda: da.DepthAnythingV2(encoder=args.student_encoder, attn_impl="xla"))
    resolve_weights(model, name)
    registry._full_fp32(torch.float32, device)
    model = model.to(device)
    log(f"student {name} as fp32 on {device}: TF32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    if args.qat:
        # fake-quant (STE) forward so that the weights serve well at int8;
        # the parameter names stay, so promotion and calibration work as-is
        install_qat(model, model.int8_targets())

    def batches():
        for i in range(0, len(frames) - tail, args.batch):
            yield frames[i: i + args.batch]

    state, history = distill(teacher_fn, depth_student(model, size),
                             dict(model.named_parameters()), batches(), steps=args.steps,
                             learning_rate=args.lr, accum_steps=args.accum_steps)
    log(f"distillation done: loss {history[0]:.4f} -> {history[-1]:.4f}")

    os.makedirs(args.out, exist_ok=True)
    save_train_state(os.path.join(os.path.abspath(args.out),
                                  f"distill_{args.student}_{args.student_encoder}.pt"), state)
    if args.promote:
        existing = params_path(name)
        if os.path.exists(existing):
            # never clobber the installed weights irreversibly
            bak = existing + ".pre-distill-bak"
            shutil.move(existing, bak)
            log(f"previous params cached at {bak} (move it back to undo the promotion)")
        save_params(name, state.params)
        log(f"promoted distilled params into the params cache as {name!r}; `run "
            f"{args.student} --encoder {args.student_encoder}` now serves them")
    return 0


def cmd_quantcheck(args) -> int:
    """The int8 accuracy gate: the same configuration at bf16 and at int8
    (one set of weights) on the given images, and one JSON line of the
    int8-vs-bf16 metric suite (delta1, AbsRel, ..., corr). Exit 3 when
    delta1 does not exceed ``--min-delta1``."""
    import torch

    from monocular_depth_estimation_trt_tpu_torch import registry
    from monocular_depth_estimation_trt_tpu_torch.training.metrics import depth_metrics
    from monocular_depth_estimation_trt_tpu_torch.utils.files import list_images
    from monocular_depth_estimation_trt_tpu_torch.utils.imageio import read_image

    if args.images:
        paths = list_images(args.images)[: args.max_images]
    else:
        paths = [os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "data", "example.jpg")]
    if not paths:
        log(f"quantcheck: no images under {args.images}", tag="ERROR")
        return 1

    kw = _pipeline_kw(args, "encoder", "checkpoint")
    calib = {"calib_images": kw.pop("calib_images")} if "calib_images" in kw else {}
    pipe_f = registry.build_pipeline(args.model, precision="bf16", **kw)
    pipe_q = registry.build_pipeline(args.model, precision="int8", **kw, **calib)

    sums, corr = {}, []
    for p in paths:
        img = read_image(p)
        df = np.asarray(pipe_f(img)["depth"], np.float32)
        dq = np.asarray(pipe_q(img)["depth"], np.float32)
        m = depth_metrics(torch.from_numpy(dq)[None], torch.from_numpy(df)[None], align="none")
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        corr.append(float(np.corrcoef(dq.ravel(), df.ravel())[0, 1]))
    n = len(paths)
    report = {
        "metric": f"{pipe_q.spec.artifact_name()}_vs_bf16",
        "images": n,
        "corr": round(float(np.mean(corr)), 5),
        **{k: round(v / n, 5) for k, v in sums.items()},
    }
    print(json.dumps(report))
    return 0 if report.get("delta1", 0.0) > args.min_delta1 else 3


_EVAL_EXTS = (".npz", ".npy", ".png", ".pgm", ".tif", ".tiff")


def _load_eval_array(path: str, key: str, scale: float = 0.0) -> np.ndarray:
    """A prediction or ground-truth array: ``.npy``, ``key`` of an ``.npz``
    (else its first array), or a depth image (16-bit PNG without cv2) divided
    by ``scale``; a uint16 image defaults to 256 (KITTI's meters * 256).
    ``.npy``/``.npz`` are metric already: ``scale`` is for images only."""
    from monocular_depth_estimation_trt_tpu_torch.utils.imageio import read_unchanged

    if path.endswith(".npy"):
        arr, scale = np.load(path), 0.0
    elif path.endswith(".npz"):
        z = np.load(path)
        arr, scale = (z[key] if key in z else z[list(z.files)[0]]), 0.0
    else:
        arr = read_unchanged(path)
        if arr.ndim == 3:
            arr = arr[..., 0]
        if arr.dtype == np.uint16 and scale == 0.0:
            scale = 256.0
    arr = np.squeeze(np.asarray(arr)).astype(np.float32)
    return arr / scale if scale else arr


def _load_eval_set(path: str, key: str, scale: float = 0.0) -> dict:
    if os.path.isdir(path):
        files = sorted(f for f in os.listdir(path) if f.lower().endswith(_EVAL_EXTS))
        return {os.path.splitext(f)[0]: _load_eval_array(os.path.join(path, f), key, scale)
                for f in files}
    return {os.path.splitext(os.path.basename(path))[0]: _load_eval_array(path, key, scale)}


def cmd_eval(args) -> int:
    """Score predictions against ground truth with the standard metric
    suites (``training/metrics.py``): AbsRel, RMSE, SiLog and the delta
    thresholds for depth (optionally affine- or median-aligned), EPE and
    n-px accuracies for flow (``--flow``); one JSON line. Computes on the
    CPU whatever ``--device`` says: host arithmetic on host arrays (the JAX
    package forces its CPU platform here too)."""
    import torch

    from monocular_depth_estimation_trt_tpu_torch.training.metrics import (
        depth_metrics,
        flow_metrics,
    )

    preds = _load_eval_set(args.pred, args.key)
    gts = _load_eval_set(args.gt, args.key, scale=args.gt_scale)
    if len(preds) == 1 and len(gts) == 1:
        pairs = [(next(iter(preds.values())), next(iter(gts.values())))]
    else:
        common = sorted(set(preds) & set(gts))
        if not common:
            log("no matching prediction/ground-truth stems", tag="ERROR")
            return 1
        pairs = [(preds[k], gts[k]) for k in common]

    sums: dict = {}
    for pred, gt in pairs:
        if not args.flow and pred.shape != gt.shape and pred.ndim == 2:
            # score at the ground truth's resolution (the benchmark
            # protocol), nearest-neighbour: no depth invented at edges
            yi = np.minimum((np.arange(gt.shape[0]) + 0.5) * pred.shape[0] // gt.shape[0],
                            pred.shape[0] - 1).astype(np.int64)
            xi = np.minimum((np.arange(gt.shape[1]) + 0.5) * pred.shape[1] // gt.shape[1],
                            pred.shape[1] - 1).astype(np.int64)
            pred = pred[yi][:, xi]
        if pred.ndim == 2:
            pred, gt = pred[None], gt[None]
        pred_t, gt_t = torch.from_numpy(np.ascontiguousarray(pred)), torch.from_numpy(
            np.ascontiguousarray(gt))
        if args.flow:
            m = flow_metrics(pred_t, gt_t)
        else:
            # the Eigen protocol's valid range: gt > 0 always (depth_metrics),
            # the caps bound the scored range (KITTI: 80 m)
            mask = None
            if args.min_depth > 0 or args.max_depth > 0:
                valid = np.isfinite(gt) & (gt > args.min_depth)
                if args.max_depth > 0:
                    valid &= gt <= args.max_depth
                mask = torch.from_numpy(valid.astype(np.float32))
            m = depth_metrics(pred_t, gt_t, mask, align=args.align)
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + float(v)
    out = {k: round(v / len(pairs), 5) for k, v in sums.items()}
    out["n_images"] = len(pairs)
    out["align"] = args.align if not args.flow else None
    print(json.dumps(out))
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
    run.add_argument("--colorbar", action="store_true",
                     help="also save the colorbar-in-meters figure (metric models; needs "
                     "matplotlib)")
    run.add_argument("--benchmark", action="store_true")
    run.add_argument("--compare", default="",
                     help="compare the depth against a stored .npz and fail on drift")
    run.add_argument("--compare-tol", type=float, default=1e-2,
                     help="max relative error allowed with --compare")
    run.set_defaults(fn=cmd_run)

    batch = sub.add_parser("batch", help="batched offline serving over an image dir or video")
    batch.add_argument("model", nargs="?", default="")
    batch.add_argument("--encoder", default="")
    batch.add_argument("--images-dir", default="")
    batch.add_argument("--video", default="")
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
    bench.add_argument("--trace", default="",
                       help="also write a torch.profiler Chrome trace of the timed loop into "
                       "this directory")
    bench.set_defaults(fn=cmd_bench)

    views = sub.add_parser("views", help="multi-view 3D reconstruction (S-view VGGT engine)")
    views.add_argument("model", nargs="?", default="vggt")
    views.add_argument("--images", nargs="+", required=True)
    views.add_argument("--out", default="results")
    views.add_argument("--resize", type=int, default=0,
                       help="square side for every view (default 518)")
    _add_precision_args(views)
    views.set_defaults(fn=cmd_views)

    pair = sub.add_parser("pair", help="two-image depth, point cloud and relative pose "
                          "(Align3R)")
    pair.add_argument("model", nargs="?", default="align3r")
    pair.add_argument("--image1", required=True)
    pair.add_argument("--image2", required=True)
    pair.add_argument("--out", default="results")
    pair.set_defaults(fn=cmd_pair)

    video = sub.add_parser("video", help="depth over a video file")
    video.add_argument("model", nargs="?", default="")
    video.add_argument("--encoder", default="")
    video.add_argument("--video", required=True)
    video.add_argument("--out", default="results")
    video.add_argument("--max-frames", type=int, default=0)
    video.add_argument("--checkpoint", default="")
    _add_precision_args(video)
    video.set_defaults(fn=cmd_video)

    flow = sub.add_parser("flow", help="optical flow over a frame directory or a video")
    flow.add_argument("model", nargs="?", default="", choices=[*FLOW_MODELS, ""])
    flow.add_argument("--frames", default="video_frames", help="directory of frames")
    flow.add_argument("--video", default="", help="a video whose frames to use instead")
    flow.add_argument("--out", default="results")
    flow.add_argument("--iters", type=int, default=0,
                      help="refinement steps (default: the model's)")
    flow.add_argument("--max-frames", type=int, default=0,
                      help="at most this many pairs (triplets), and video frames")
    flow.set_defaults(fn=cmd_flow)

    track = sub.add_parser("track", help="online point tracking over a video")
    track.add_argument("model", nargs="?", default="cotracker3")
    track.add_argument("--video", required=True)
    track.add_argument("--grid", type=int, default=10,
                       help="grid_size (reference later/CoTracker3/infer.py:23)")
    track.add_argument("--out", default="results")
    track.add_argument("--max-frames", type=int, default=0)
    track.set_defaults(fn=cmd_track)

    slam = sub.add_parser("slam", help="video SLAM recipes (megasam / vipe / wildgs_slam)")
    slam.add_argument("model", nargs="?", default="megasam")
    slam.add_argument("--video", default="")
    slam.add_argument("--frames", default="", help="directory of frames (alternative to --video)")
    slam.add_argument("--out", default="results")
    slam.add_argument("--focal", type=float, default=0.0,
                      help="known focal in flow-resolution px (default: recipe-specific prior / "
                      "GeoCalib)")
    slam.add_argument("--stride", type=int, default=1)
    slam.add_argument("--max-frames", type=int, default=0)
    slam.add_argument("--cvd", action="store_true",
                      help="also write per-frame consistent video depth")
    slam.set_defaults(fn=cmd_slam)

    webcam = sub.add_parser("webcam", help="live depth viewer (webcam or IP camera)")
    webcam.add_argument("model", nargs="?", default="")
    webcam.add_argument("--encoder", default="")
    webcam.add_argument("--camera", default="0", help="device index or IP camera URL")
    webcam.add_argument("--checkpoint", default="")
    _add_precision_args(webcam)
    webcam.set_defaults(fn=cmd_webcam)

    build = sub.add_parser("build", help="build (warm up and capture) an engine")
    build.add_argument("model")
    build.add_argument("--encoder", default="")
    build.add_argument("--size", type=int, default=518)
    build.add_argument("--metric", action="store_true")
    build.add_argument("--viz", action="store_true")
    _add_precision_args(build, calib=False)
    build.set_defaults(fn=cmd_build)

    exp = sub.add_parser("export", help="write a serialized engine artifact (.mdeteng): the "
                         "fused programs, the weights stored once")
    exp.add_argument("model")
    exp.add_argument("--encoder", default="")
    exp.add_argument("--size", type=int, default=518, help="square input size")
    exp.add_argument("--metric", action="store_true")
    exp.add_argument("--dataset", default="hypersim")
    exp.add_argument("--checkpoint", default="")
    exp.add_argument("--viz", action="store_true",
                     help="fuse the colormap epilogue into the artifact")
    exp.add_argument("--batches", default="1",
                     help="comma-separated batch sizes to export modules for")
    exp.add_argument("--views", default="",
                     help="comma-separated S values: S-view joint modules (VGGT family)")
    exp.add_argument("--stream-window", type=int, default=0, dest="stream_window",
                     metavar="W", help="a causal KV-cache step module with a W-view window "
                     "(streamvggt): `video --engine` then serves the stream")
    exp.add_argument("--serve-bundle", type=int, default=0, dest="serve_bundle", metavar="N",
                     help="power-of-two batch buckets up to N, both viz modes (what `serve "
                     "--engine` needs)")
    exp.add_argument("--out", default="",
                     help="output path (default: <cache>/exported/<name>.mdeteng)")
    exp.add_argument("--platforms", default="cpu,cuda",
                     help="comma-separated device types to trace a program for (cpu, cuda); "
                     "a host with no card traces cuda too (run it with --device cpu)")
    _add_precision_args(exp)
    exp.set_defaults(fn=cmd_export)

    serve = sub.add_parser("serve", help="HTTP depth serving (POST images to /v1/depth)")
    serve.add_argument("model", nargs="?", default="")
    serve.add_argument("--encoder", default="")
    serve.add_argument("--checkpoint", default="")
    serve.add_argument("--engine", action="append", default=[],
                       help="serve a serialized artifact (`export --serve-bundle N`); repeat "
                       "to serve several models behind one server "
                       "(POST /v1/models/<name>/depth)")
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

    convert = sub.add_parser("convert", help="check an upstream checkpoint and install it in "
                             "the params cache (on the CPU)")
    convert.add_argument("model")
    convert.add_argument("--checkpoint", required=True)
    convert.add_argument("--encoder", default="")
    convert.add_argument("--report", action="store_true",
                         help="print the strict load's audit (consumed, missing, extra) and "
                         "write nothing")
    convert.add_argument("--verify-manifest", action="store_true", dest="verify_manifest",
                         help="diff the checkpoint's tensor names and shapes against the "
                         "family's key manifest (weights/manifests/) first; exit 2 on a "
                         "mismatch")
    convert.set_defaults(fn=cmd_convert)

    dist = sub.add_parser("distill", help="teacher-to-student depth distillation on an image "
                          "directory")
    dist.add_argument("--teacher", default="depth_anything_v2")
    dist.add_argument("--teacher-encoder", default="vitl")
    dist.add_argument("--student", default="depth_anything_v2", choices=DISTILL_STUDENTS,
                      help="student registry name: a relative-depth DA-V2-family graph")
    dist.add_argument("--student-encoder", default="vits")
    dist.add_argument("--images-dir", required=True)
    dist.add_argument("--size", type=int, default=266,
                      help="training resolution (rounded down to /14)")
    dist.add_argument("--batch", type=int, default=4)
    dist.add_argument("--steps", type=int, default=200)
    dist.add_argument("--lr", type=float, default=3e-4)
    dist.add_argument("--accum-steps", type=int, default=1)
    dist.add_argument("--max-images", type=int, default=2048,
                      help="cap on images held in memory (frames and teacher labels stay "
                      "resident for the run)")
    dist.add_argument("--out", default="results/distill")
    dist.add_argument("--qat", action="store_true",
                      help="quantization-aware training: fake-quant (STE) student forward, so "
                      "that the result serves well at --precision int8")
    dist.add_argument("--promote", action="store_true",
                      help="install the distilled weights in the params cache under the "
                      "student's artifact name")
    dist.set_defaults(fn=cmd_distill)

    ev = sub.add_parser("eval", help="depth/flow metrics between prediction and ground-truth "
                        "npz/npy/image files or directories (on the CPU)")
    ev.add_argument("--pred", required=True)
    ev.add_argument("--gt", required=True)
    ev.add_argument("--key", default="depth", help="array key inside npz files")
    ev.add_argument("--align", default="none", choices=["none", "affine", "median"],
                    help="per-image alignment before scoring (relative-depth protocols)")
    ev.add_argument("--flow", action="store_true",
                    help="score (H, W, 2) flow fields with EPE/n-px instead")
    ev.add_argument("--gt-scale", type=float, default=0.0,
                    help="divide image-file ground truth by this (default 256 for uint16: "
                    "KITTI's meters * 256)")
    ev.add_argument("--min-depth", type=float, default=0.0,
                    help="ignore ground truth below this depth (Eigen protocol)")
    ev.add_argument("--max-depth", type=float, default=0.0,
                    help="ignore ground truth beyond this depth (e.g. 80 for KITTI)")
    ev.set_defaults(fn=cmd_eval)

    qc = sub.add_parser("quantcheck", help="int8-vs-bf16 accuracy report for one "
                        "configuration (one JSON line; exit 3 if delta1 falls below "
                        "--min-delta1)")
    qc.add_argument("model")
    qc.add_argument("--encoder", default="")
    qc.add_argument("--checkpoint", default="")
    qc.add_argument("--images", default="", help="image directory (default: the bundled "
                    "example)")
    qc.add_argument("--max-images", type=int, default=8)
    qc.add_argument("--min-delta1", type=float, default=0.95, dest="min_delta1")
    qc.add_argument("--calib-dir", default="", dest="calib_dir",
                    help="directory of domain images for int8 calibration")
    qc.set_defaults(fn=cmd_quantcheck)

    sub.add_parser("models", help="list registered models").set_defaults(fn=cmd_models)
    sub.add_parser("engines", help="list built engines").set_defaults(fn=cmd_engines)
    doctor = sub.add_parser("doctor", help="report what this installation will use")
    doctor.add_argument("--no-devices", action="store_true", dest="no_devices",
                        help="skip the card query")
    doctor.set_defaults(fn=cmd_doctor)
    for sp in (run, bench, views, serve):
        sp.add_argument("--device-mesh", default="", dest="device_mesh",
                        help="shard the model over a DxM (data x model) device mesh, e.g. "
                        "1x4; 1x1 or absent = one device. More than one device: start one "
                        "process per device (torchrun --nproc-per-node D*M)")
    for sp in (run, batch, bench, views, pair, video, flow, webcam):
        sp.add_argument("--engine", default="",
                        help="serve from a serialized artifact (`export`): no model code or "
                        "checkpoint")
    for sp in (run, batch, views, pair, serve, video, webcam, flow, track, slam, exp, dist, qc):
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
    from monocular_depth_estimation_trt_tpu_torch.utils.imageio import CodecUnavailable

    if not getattr(args, "engine", ""):
        _join_device_mesh(args)
    try:
        return args.fn(args)
    except CodecUnavailable as e:  # JPEG or video without cv2: name the codec
        log(str(e), tag="ERROR")
        return 1


if __name__ == "__main__":
    sys.exit(main())
