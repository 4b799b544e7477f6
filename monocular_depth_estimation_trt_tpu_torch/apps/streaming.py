"""Streaming apps: video files, live webcam and stateful per-frame sessions
(counterpart of the JAX package's ``apps/streaming.py``).

The host side follows the reference's latency-oriented serving path
(``Depth_Pro/onnx2trt_webcam.py:36-44,117-180``): a capture loop feeding a
bounded ``deque(maxlen=2)`` frame queue (drop-oldest backpressure), a model
worker thread calling the pipeline, and a ``deque(maxlen=1)`` result queue
for display (:class:`FrameWorker`, :func:`run_webcam`). :func:`run_video`
writes a colorized depth MP4 with the frame rate overlaid, one frame in
flight on the card; :func:`write_depth_video` serves the windowed video
models (Video Depth Anything) with one normalization over the whole video;
:func:`run_flow_frames` and :func:`run_flow_triplets` write the flow
models' color-wheel MP4s from a directory of frames.
Video files go through ``utils/imageio.py`` (cv2; without it,
``CodecUnavailable`` names the missing codec).

A stateful session keeps its state in static device buffers that its
captured step (``runtime/engine.py``) updates in place, so that one CUDA
graph per frame size serves every step and nothing is read back on the host
between steps: :class:`VGGTStreamingSession`, the KV-cache causal stream on
VGGT weights (``models/streamvggt.py``; one view per step through the
aggregator, global attention over the cached keys and values of the views
before it), and :class:`FlashDepthSession`, FlashDepth's Mamba state
(``models/flashdepth.py``). A session's engine build runs the step (warm-up
and capture), so the state is saved before and put back after;
``reset()`` zeroes it in place.
"""

from __future__ import annotations

import collections
import functools
import os
import threading
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from monocular_depth_estimation_trt_tpu_torch.models.streamvggt import StreamingVGGT
from monocular_depth_estimation_trt_tpu_torch.models.vggt import VGGT
from monocular_depth_estimation_trt_tpu_torch.ops.preprocess import preprocess_pad_square
from monocular_depth_estimation_trt_tpu_torch.pipelines import DepthPipeline
from monocular_depth_estimation_trt_tpu_torch.runtime.engine import Engine
from monocular_depth_estimation_trt_tpu_torch.runtime.transfer import (
    supports_device_out,
    tree_get_chunked,
)
from monocular_depth_estimation_trt_tpu_torch.utils import imageio
from monocular_depth_estimation_trt_tpu_torch.utils.logging import log


class FrameWorker:
    """Producer/consumer pair around ``process(frame) -> result``."""

    def __init__(self, process: Callable[[np.ndarray], np.ndarray]):
        self.process = process
        self.frame_queue = collections.deque(maxlen=2)
        self.result_queue = collections.deque(maxlen=1)
        self.lock = threading.Lock()
        self.running = False
        self.model_fps = 0.0
        self._thread: Optional[threading.Thread] = None

    def submit(self, frame: np.ndarray) -> None:
        with self.lock:
            self.frame_queue.append(frame)

    def latest(self):
        with self.lock:
            return self.result_queue[-1] if self.result_queue else None

    def _loop(self) -> None:
        while self.running:
            frame = None
            with self.lock:
                if self.frame_queue:
                    frame = self.frame_queue.popleft()
            if frame is None:
                time.sleep(0.001)
                continue
            t0 = time.perf_counter()
            try:
                result = self.process(frame)
            except Exception as e:  # graceful frame skip, reference :113-115
                log(f"frame processing failed: {e!r}", tag="WARN")
                result = frame
            self.model_fps = 1.0 / max(time.perf_counter() - t0, 1e-9)
            with self.lock:
                self.result_queue.append(result)

    def start(self) -> "FrameWorker":
        self.running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.running = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)


def _put_fps(cv2, bgr: np.ndarray, text: str, scale: float = 1.0) -> None:
    cv2.putText(bgr, text, (20, 40), cv2.FONT_HERSHEY_SIMPLEX, scale, (255, 255, 255), 2)


def run_video(pipeline, video_path: str, out_path: str, *,
              max_frames: Optional[int] = None) -> str:
    """MP4 -> colorized depth MP4 with the frame rate overlaid (reference
    ``Depth_Pro/onnx2trt_video.py:41-85``). A pipeline with ``stream()``
    (FlashDepth, StreamVGGT) serves the video as one fresh stream. A runner
    that takes ``device_out`` is pipelined: frame N is queued on the card
    before frame N-1 is fetched, colorized and written
    (``MDET_VIDEO_SYNC=1`` forces the synchronous path)."""
    cap = imageio.open_video(video_path)
    cv2 = imageio.video_cv2(video_path)
    fps = imageio.video_fps(cap)
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    writer = imageio.VideoWriter(out_path, fps, (w, h))
    runner = pipeline.stream() if hasattr(pipeline, "stream") else pipeline
    pipelined = supports_device_out(runner) and not os.environ.get("MDET_VIDEO_SYNC")
    last_emit = None  # the overlay's rate is the emitted-frame period

    def emit(out, dt_fallback):
        nonlocal last_emit
        now = time.perf_counter()
        dt = (now - last_emit) if last_emit is not None else dt_fallback
        last_emit = now
        viz = cv2.cvtColor(np.asarray(out["viz"]), cv2.COLOR_RGB2BGR)
        if viz.shape[:2] != (h, w):
            viz = cv2.resize(viz, (w, h))
        _put_fps(cv2, viz, f"FPS: {1.0 / max(dt, 1e-9):.1f}")
        writer.write_bgr(viz)

    n = 0
    pending = None  # (dispatch time, device outputs): one frame in flight
    for rgb in imageio.iter_video(cap, max_frames):
        t0 = time.perf_counter()
        if pipelined:
            out_dev = runner(rgb, viz=True, device_out=True)
            if pending is not None:
                emit(tree_get_chunked(pending[1]), time.perf_counter() - pending[0])
            pending = (t0, out_dev)
        else:
            emit(runner(rgb, viz=True), time.perf_counter() - t0)
        n += 1
    if pending is not None:
        emit(tree_get_chunked(pending[1]), time.perf_counter() - pending[0])
    writer.release()
    log(f"wrote {n} frames -> {out_path}")
    return out_path


FLOW_VIDEO_FPS = 15.0  # the flow MP4s' rate (reference RAFT/onnx2trt.py:150-196)


def _frame_paths(frames_dir: str, need: int):
    from monocular_depth_estimation_trt_tpu_torch.utils.files import list_images

    paths = list_images(frames_dir)
    if len(paths) < need:
        raise FileNotFoundError(f"[MDET] need >={need} frames in {frames_dir}")
    return paths


def run_flow_frames(flow_pipeline, frames_dir: str, out_path: str, *,
                    size_wh: Tuple[int, int] = (512, 288),
                    max_pairs: Optional[int] = None) -> str:
    """Optical flow of consecutive frames of an image directory -> a
    color-wheel MP4 at ``size_wh`` (reference ``RAFT/onnx2trt.py:150-196``).
    A pipeline that takes ``device_out`` is pipelined: pair N is queued on
    the card before pair N-1 is fetched and written."""
    paths = _frame_paths(frames_dir, 2)
    cv2 = imageio.video_cv2(out_path)
    writer = imageio.VideoWriter(out_path, FLOW_VIDEO_FPS, size_wh)
    pipelined = supports_device_out(flow_pipeline)

    def emit(out):
        writer.write_bgr(cv2.cvtColor(np.asarray(out["viz"]), cv2.COLOR_RGB2BGR))

    prev = imageio.read_image(paths[0])
    n = 0
    pending = None
    for p in paths[1:]:
        if max_pairs and n >= max_pairs:
            break
        cur = imageio.read_image(p)
        if pipelined:
            out_dev = flow_pipeline(prev, cur, viz=True, device_out=True)
            if pending is not None:
                emit(tree_get_chunked(pending))
            pending = out_dev
        else:
            emit(flow_pipeline(prev, cur, viz=True))
        prev = cur
        n += 1
    if pending is not None:
        emit(tree_get_chunked(pending))
    writer.release()
    log(f"wrote {n} flow frames -> {out_path}")
    return out_path


def run_flow_triplets(triplet_pipeline, frames_dir: str, out_path: str, *,
                      size_wh: Tuple[int, int] = (512, 288),
                      max_triplets: Optional[int] = None) -> str:
    """MEMFOF's three-frame bidirectional flow over an image directory: the
    center -> next flow of each triplet, colored on the device, -> an MP4 at
    ``size_wh`` (the JAX package's protocol: every triplet through the
    pipeline)."""
    from monocular_depth_estimation_trt_tpu_torch.ops.flow_viz import flow_to_color

    paths = _frame_paths(frames_dir, 3)
    cv2 = imageio.video_cv2(out_path)
    writer = imageio.VideoWriter(out_path, FLOW_VIDEO_FPS, size_wh)
    n = 0
    for i in range(1, len(paths) - 1):
        if max_triplets and n >= max_triplets:
            break
        out = triplet_pipeline(*(imageio.read_image(p) for p in paths[i - 1:i + 2]),
                               device_out=True)
        viz = flow_to_color(out["flow"][1]).cpu().numpy()  # center -> next
        writer.write_bgr(cv2.cvtColor(viz, cv2.COLOR_RGB2BGR))
        n += 1
    writer.release()
    log(f"wrote {n} flow frames -> {out_path}")
    return out_path


def extract_frames_from_video(video_path: str, out_dir: str, *,
                              max_frames: Optional[int] = None) -> int:
    """MP4 -> numbered PNG frames (reference ``gen_video2imgs.py:4-35``)."""
    cap = imageio.open_video(video_path)
    os.makedirs(out_dir, exist_ok=True)
    saved = 0
    for rgb in imageio.iter_video(cap, max_frames):
        imageio.write_image(os.path.join(out_dir, f"frame_{saved:05d}.png"), rgb)
        saved += 1
    log(f"extracted {saved} frames -> {out_dir}")
    return saved


def run_webcam(pipeline, camera=0) -> None:
    """Live webcam or IP-camera viewer (reference
    ``Depth_Pro/onnx2trt_webcam.py``; camera URLs at :195): capture here,
    the pipeline on a :class:`FrameWorker`."""
    cap = imageio.open_video(camera)
    cv2 = imageio.video_cv2(str(camera))

    def process(frame_bgr):
        out = pipeline(cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB), viz=True)
        return cv2.cvtColor(np.asarray(out["viz"]), cv2.COLOR_RGB2BGR)

    worker = FrameWorker(process).start()
    frames, t_start = 0, time.perf_counter()
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            worker.submit(frame)
            result = worker.latest()
            frames += 1
            if result is not None:
                view = result.copy()
                cam_fps = frames / max(time.perf_counter() - t_start, 1e-9)
                _put_fps(cv2, view, f"cam {cam_fps:.1f} fps / model {worker.model_fps:.1f} fps",
                         0.8)
                cv2.imshow("mdet", view)
                if cv2.waitKey(1) & 0xFF == ord("q"):
                    break
    finally:
        worker.stop()
        cap.release()
        cv2.destroyAllWindows()


def depth_video_u8(depth: np.ndarray, metric: bool) -> np.ndarray:
    """(T, H, W) depth -> uint8 with ONE min-max normalization over the
    whole video (inverse depth for a metric model, near bright as in the
    upstream disparity-style viz)."""
    if metric:
        depth = 1.0 / np.maximum(depth, 1e-4)
    lo, hi = float(depth.min()), float(depth.max())
    return ((depth - lo) / max(hi - lo, 1e-6) * 255.0).astype(np.uint8)


def write_depth_video(pipeline, video_path: str, out_path: str, *,
                      max_frames: Optional[int] = None) -> str:
    """Whole-video depth for the windowed models (Video Depth Anything's
    ``run.py`` protocol): read every frame, ``pipeline.video_depth`` (one
    engine per window, stitched on the host), colorize with one global
    normalization (:func:`depth_video_u8`) and cv2's inferno, and write the
    MP4 at the source size and rate."""
    video, fps = imageio.read_video(video_path, max_frames)
    cv2 = imageio.video_cv2(video_path)
    h, w = video.shape[1:3]
    t0 = time.perf_counter()
    depth = pipeline.video_depth(video)  # (T, ih, iw)
    dt = time.perf_counter() - t0
    log(f"video depth: {len(video)} frames in {dt:.2f}s ({len(video) / max(dt, 1e-9):.1f} FPS)")
    writer = imageio.VideoWriter(out_path, fps, (w, h))
    for d in depth_video_u8(depth, bool(getattr(pipeline.spec, "metric", False))):
        writer.write_bgr(cv2.applyColorMap(d, cv2.COLORMAP_INFERNO))
    writer.release()
    log(f"wrote {out_path}")
    return out_path


# ---------------------------------------------------------------------------
# stateful sessions: static device state, one captured step per frame size
# ---------------------------------------------------------------------------


class _StatefulSession:
    """The state (device tensors, updated in place by each step) and the
    step's engines, one per key."""

    def __init__(self, state: Iterable[torch.Tensor], *, device: torch.device, name: str):
        self._state = list(state)
        self.device = torch.device(device)
        self.name = name
        self._engines: Dict = {}

    def reset(self) -> None:
        """Zero the state (in place, so the captured graphs stay valid)."""
        with torch.no_grad():
            for t in self._state:
                t.zero_()

    def _engine(self, key, fn: Callable, in_hw: Tuple[int, int], suffix: str = "") -> Engine:
        """The step's engine for frames of size ``in_hw``, built now: its
        warm-up and capture run the step, so the state is saved before and
        put back after."""
        if key not in self._engines:
            h, w = in_hw
            eng = Engine(fn, (torch.empty((h, w, 3), dtype=torch.uint8, device="meta"),),
                         name=f"{self.name}_in{h}x{w}{suffix}", device=self.device)
            saved = [t.clone() for t in self._state]
            eng.compile()
            with torch.no_grad():
                for t, s in zip(self._state, saved):
                    t.copy_(s)
            self._engines[key] = eng
        return self._engines[key]

    def release_engines(self) -> None:
        for eng in self._engines.values():
            eng.release()
        self._engines.clear()


def _cache_tensors(cache: Dict):
    yield from (t for kv in cache["kv"] for t in kv)
    yield cache["cam"]
    yield cache["t"]


class VGGTStreamingSession(_StatefulSession):
    """A stream of frames through a VGGT-family model, one causal step each.

    ``model``: the joint ``VGGT`` (on its device, cast; int8 included), whose
    parameters and quantized layers the session shares; ``window``: the
    ring's capacity in views (a sliding window past it); ``epilogue``:
    fn(step outputs of one view, frame (H, W)) -> dict, run inside the same
    captured step (the pipeline's crop, upsample and viz). Frames of one
    size share an engine; the state carries across sizes."""

    def __init__(self, model: VGGT, *, window: int = 4, input_size: int = 518,
                 epilogue: Optional[Callable] = None, name: str = "vggt_stream"):
        param = next(model.parameters())
        self.dtype = param.dtype
        self.window = window
        self.input_size = input_size
        self.model = StreamingVGGT.sharing(model, window)
        grid = (input_size // model.cfg.patch_size,) * 2
        with torch.inference_mode(False):  # reset() writes to it outside inference mode
            self._cache = self.model.init_cache(1, grid, self.dtype, param.device)
        super().__init__(_cache_tensors(self._cache), device=param.device,
                         name=f"{name}_w{window}")
        self._epilogue = epilogue

    @property
    def steps(self) -> torch.Tensor:
        """The number of steps since the last reset (a device tensor)."""
        return self._cache["t"]

    def pure_step(self, frame_u8: torch.Tensor, cache: Dict,
                  in_hw: Optional[Tuple[int, int]] = None) -> Tuple[Dict, Dict]:
        """One causal step on an explicit ``cache`` (updated in place and
        returned): the function that the session's engines capture.
        ``frame_u8``: (H, W, 3) uint8 on the session's device."""
        x = preprocess_pad_square(frame_u8[None], self.input_size)
        out = {k: v[0] for k, v in self.model.step(x, cache).items()}
        if self._epilogue is not None:
            out = self._epilogue(out, tuple(in_hw or frame_u8.shape[:2]))
        return out, cache

    def _forward(self, frame_u8: torch.Tensor, in_hw: Tuple[int, int]) -> Dict:
        return self.pure_step(frame_u8, self._cache, in_hw)[0]

    def engine_for(self, in_hw: Tuple[int, int]) -> Engine:
        in_hw = tuple(in_hw)
        return self._engine(in_hw, functools.partial(self._forward, in_hw=in_hw), in_hw)

    def step(self, frame_u8) -> Dict[str, torch.Tensor]:
        """frame_u8: (H, W, 3) RGB uint8 (numpy or tensor) -> this view's
        outputs as device tensors: depth and depth_conf at the model's input
        size (or what the epilogue makes of them), world_points and
        world_points_conf with the point head, pose_enc with the camera."""
        frame_u8 = DepthPipeline._as_tensor(frame_u8)
        return self.engine_for(frame_u8.shape[:2])(frame_u8)


class FlashDepthSession(_StatefulSession):
    """FlashDepth over a stream of frames: the Mamba state (``conv``,
    ``ssm``; fp32) rides on the card between steps, one captured graph per
    (frame size, viz) serving every step.

    ``forward_state``: fn(frame_u8 (H, W, 3) on the device, out_hw, state)
    -> (outputs, new state); ``init_state``: fn(device) -> a zero state;
    ``viz``: fn(outputs) -> outputs with ``viz``."""

    def __init__(self, forward_state: Callable, init_state: Callable, viz: Callable, *,
                 device: torch.device, name: str):
        with torch.inference_mode(False):  # reset() writes to it outside inference mode
            self.state = init_state(device)
        super().__init__(self.state.values(), device=device, name=name)
        self._forward_state = forward_state
        self._viz = viz

    def _forward(self, frame_u8: torch.Tensor, in_hw: Tuple[int, int], viz: bool) -> Dict:
        out, new = self._forward_state(frame_u8, in_hw, self.state)
        for k, t in self.state.items():
            t.copy_(new[k])
        return self._viz(out) if viz else out

    def engine_for(self, in_hw: Tuple[int, int], viz: bool = False) -> Engine:
        in_hw = tuple(in_hw)
        return self._engine((in_hw, viz), functools.partial(self._forward, in_hw=in_hw, viz=viz),
                            in_hw, "_viz" if viz else "")

    def step(self, frame_u8, *, viz: bool = False) -> Dict[str, torch.Tensor]:
        """frame_u8: (H, W, 3) RGB uint8 -> this frame's depth (and viz) at
        the frame's size as device tensors, after the frames before it."""
        frame_u8 = DepthPipeline._as_tensor(frame_u8)
        return self.engine_for(frame_u8.shape[:2], viz)(frame_u8)

    def __call__(self, image_u8, *, viz: bool = False) -> Dict[str, np.ndarray]:
        """The JAX session's call: host numpy outputs."""
        return tree_get_chunked(self.step(image_u8, viz=viz))
