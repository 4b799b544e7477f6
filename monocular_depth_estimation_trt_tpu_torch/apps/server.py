"""HTTP model serving (counterpart of the JAX package's ``apps/server.py``).

The reference's closest surfaces are the webcam/IP-cam viewers
(``Depth_Pro/onnx2trt_webcam.py:191-197``); this module turns any
registered pipeline into a network service, stdlib only:

  * one engine per launch shape, captured once at startup for a fixed input
    size (a CUDA graph per shape on the card): requests are resized on the
    host (``cv2.INTER_AREA``, or ``utils/imageio.py``'s area resample where
    cv2 is missing) so that every launch replays a captured graph;
  * one device-worker thread owns the card. HTTP handler threads only
    decode, enqueue and wait; a bounded queue turns overload into fast 503s;
  * optional dynamic batching (``--max-batch N``): the worker drains up to
    N queued requests (waiting ``--batch-window-ms`` for stragglers) and
    serves them as one launch padded with the last frame to a power-of-two
    bucket, so that at most log2(N)+1 graphs are captured per viz mode;
  * a two-stage worker: it launches group N, queues its device-to-host
    copies behind the launch, then waits for group N-1's copies, so that
    the host's fetch overlaps the card's work;
  * responses are ``.npz`` bytes (every array output of the pipeline, the
    payload the CLI writes) or a turbo-colorized JPEG (501 where no JPEG
    codec is importable).

Endpoints:
  GET  /v1/health          -> {"model", "input_hw", "uptime_s", ...}
  GET  /v1/stats           -> {"requests", "errors", "avg_ms", "p50_ms", ...}
  GET  /v1/models          -> served model names + input sizes
  POST /v1/depth           -> npz of all array outputs (depth, fov, ...)
  POST /v1/depth?format=jpg -> colorized depth JPEG
  POST /v1/models/<name>/depth -> same, explicit model (multi-model serving)

Multi-device serving (a pipeline sharded over a mesh of more than one
rank, ``serve --device-mesh DxM`` under ``torchrun``): rank 0 runs the HTTP
server and its one device-worker thread; each call the worker makes is
broadcast (:func:`lockstep`) to the other ranks, which make the same call
in lock-step (:func:`follow`), so that every rank enters the sharded
layers' collectives together. A one-device mesh changes nothing.

Multi-model serving (``DepthServer({name: pipeline, ...})``): one server
process hosts several pipelines behind one device-worker thread; requests
for different models are grouped per model before each launch, and every
model keeps its own input size. ``POST /v1/depth`` serves the first
(default) model; ``/v1/models/<name>/depth`` (or ``?model=<name>``)
addresses the rest.
"""

from __future__ import annotations

import io
import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from monocular_depth_estimation_trt_tpu_torch.utils.logging import log


def _ceil_pow2(n: int) -> int:
    """Smallest power of two >= n — THE launch-bucket rounding; the warm-key
    tracking in _run and the padding in _dispatch_group must agree on it."""
    return 1 << max(n - 1, 0).bit_length()


class _Job:
    __slots__ = ("frame", "viz", "model", "done", "result", "error")

    def __init__(self, frame: np.ndarray, viz: bool, model: str):
        self.frame = frame
        self.viz = viz
        self.model = model
        self.done = threading.Event()
        self.result: Optional[Dict[str, Any]] = None
        self.error: Optional[str] = None


class DepthServer:
    """Wraps one or several pipelines in a single-device-worker request queue.

    ``pipeline`` is any registry pipeline (``pipe(frame, viz=...) -> dict``)
    OR an ordered ``{name: pipeline}`` dict for multi-model serving (the
    first entry is the default model ``POST /v1/depth`` serves).
    ``input_hw`` fixes the served resolution of the default model (requests
    are resized to it); every model defaults to its own spec's input size.
    """

    def __init__(self, pipeline, input_hw: Optional[Tuple[int, int]] = None,
                 max_queue: int = 32, timeout_s: float = 30.0,
                 max_batch: int = 1, batch_window_ms: float = 2.0,
                 chip_side: bool = False):
        # ``chip_side``: measurement mode. The batching/queue/worker logic
        # runs unchanged, but each group launches on a device-resident
        # synthetic frame batch (uploaded once at warmup) and resolves with
        # a 1-element probe readback instead of the bulk fetch, isolating
        # the batcher and the card from the host's transfers. Clients get
        # ``{"probe": ...}`` results, not depth maps.
        self._chip_side = bool(chip_side)
        self._synth_dev: Dict[Tuple[str, int], Any] = {}
        if isinstance(pipeline, dict):
            if not pipeline:
                raise ValueError("need at least one pipeline to serve")
            self.pipes: Dict[str, Any] = {
                str(k): v for k, v in pipeline.items()
            }
        else:
            self.pipes = {
                getattr(pipeline.spec, "model", "") or "default": pipeline
            }
        self.default_model = next(iter(self.pipes))
        self.pipe = self.pipes[self.default_model]  # default / back-compat
        self.hw_by: Dict[str, Tuple[int, int]] = {}
        for name, p in self.pipes.items():
            hw = (input_hw if (p is self.pipe and input_hw)
                  else tuple(p.spec.input_hw))
            self.hw_by[name] = (int(hw[0]), int(hw[1]))
        self.input_hw = self.hw_by[self.default_model]
        self.timeout_s = timeout_s
        # dynamic batching: the worker drains up to max_batch queued jobs
        # (waiting batch_window_ms for stragglers) and serves them as ONE
        # padded power-of-two-bucket device launch; max_batch=1 is
        # per-request serving. Normalized down to a power of two: buckets are
        # powers of two, so e.g. max_batch=6 would otherwise pad 5-job
        # batches up to 8, past the operator's cap and onto an engine that
        # warmup never captured.
        mb = max(int(max_batch), 1)
        self.max_batch = 1 << (mb.bit_length() - 1)
        if self.max_batch != mb:
            log(f"server: --max-batch {mb} rounded down to "
                f"{self.max_batch} (power-of-two buckets)")
        # per-model batch cap: a pipeline that carries ``batches`` (the
        # buckets it can serve) is clamped to its largest one, without
        # dragging every co-served model down with it
        self.max_batch_by: Dict[str, int] = {}
        for name, p in self.pipes.items():
            cap = self.max_batch
            if cap > 1 and not hasattr(p, "batch_call"):
                log(f"server: model {name!r} has no batch_call; "
                    f"capped at batch 1")
                cap = 1
            buckets = getattr(p, "batches", None)
            if buckets:
                top = max(int(b) for b in buckets)
                top = 1 << (top.bit_length() - 1)  # guard non-pow2 exports
                if top < cap:
                    log(f"server: model {name!r} capped at batch {top} "
                        f"(artifact's largest exported bucket)")
                    cap = top
            self.max_batch_by[name] = cap
        # pipelined serving: the worker dispatches group N (device_out=True,
        # its device-to-host copies queued behind it), then waits for group
        # N-1's copies while N runs on the card. Duck-typed pipelines
        # without a device_out kwarg degrade to synchronous per-group
        # serving.
        from monocular_depth_estimation_trt_tpu_torch.runtime.transfer import (
            supports_device_out,
        )

        # MDET_SERVE_SYNC=1 forces the synchronous worker (an A/B knob for
        # the overlap)
        force_sync = bool(os.environ.get("MDET_SERVE_SYNC"))
        self._dev_out: Dict[str, bool] = {}
        for name, p in self.pipes.items():
            ok = not force_sync and supports_device_out(p)
            if ok and hasattr(p, "batch_call"):
                ok = supports_device_out(p.batch_call)
            self._dev_out[name] = ok
        # (model, bucket, viz) launch shapes already captured: a dispatch
        # that would capture (seconds on first touch) must not hold a prior
        # group's finished results hostage; the worker resolves the
        # in-flight group before any cold-shape dispatch
        self._warm: set = set()
        self.batch_window_s = max(float(batch_window_ms), 0.0) / 1e3
        self.jobs: "queue.Queue[_Job]" = queue.Queue(maxsize=max_queue)
        self.started = time.time()
        self.requests = 0
        self.errors = 0
        self.requests_by_model = {name: 0 for name in self.pipes}
        self.batches = 0
        self.batched_jobs = 0
        # request service latency (dispatch -> results on host), rolling.
        # In pipelined mode this includes the bounded overlap hold (~1 ms
        # idle peek or the next group's host-side launch), not pure device
        # time — it is what a client actually experiences past the queue.
        self.lat_ms: list = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)

    # -- device worker ----------------------------------------------------
    def warmup(self) -> float:
        """Capture and run every served engine once (both viz modes, every
        power-of-two bucket) so that no request waits for an engine build.
        Returns seconds spent."""
        t0 = time.time()
        for name, pipe in self.pipes.items():
            h, w = self.hw_by[name]
            # both single-frame engines: npz responses serve viz=False, jpg
            # responses viz=True
            pipe(np.zeros((h, w, 3), np.uint8), viz=True)
            pipe(np.zeros((h, w, 3), np.uint8), viz=False)
            self._warm.update({(name, 1, True), (name, 1, False)})
            cap = self.max_batch_by[name]
            # every power-of-two bucket in both viz modes (a batch serves
            # viz=True iff any job wants jpg): log2(cap)+1 graphs per mode
            b = 2
            while b <= cap:
                frames = np.zeros((b, h, w, 3), np.uint8)
                pipe.batch_call(frames, viz=False)
                pipe.batch_call(frames, viz=True)
                self._warm.update({(name, b, True), (name, b, False)})
                b *= 2
            if self._chip_side:
                # one device-resident synthetic frame batch per bucket:
                # groups launch on these instead of stacked request frames
                from monocular_depth_estimation_trt_tpu_torch.runtime.transfer import (
                    device_put_chunked,
                )

                rng = np.random.default_rng(0)
                b = 1
                while b <= cap:
                    self._synth_dev[(name, b)] = device_put_chunked(
                        rng.integers(0, 255, (b, h, w, 3), dtype=np.uint8),
                        device=getattr(pipe, "device", None))
                    b *= 2
            log(f"server warmup: engine ready "
                f"({pipe.spec.artifact_name()} @ {h}x{w}"
                + (f", max_batch={cap}" if cap > 1 else "") + ")")
        dt = time.time() - t0
        log(f"server warmup: {len(self.pipes)} engine(s) in {dt:.1f}s")
        return dt

    def _collect(self, first: _Job) -> list:
        """Drain up to max_batch jobs, waiting batch_window_s for
        stragglers once at least one job is in hand."""
        batch = [first]
        deadline = time.time() + self.batch_window_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.time()
            try:
                batch.append(
                    self.jobs.get(timeout=remaining)
                    if remaining > 0 else self.jobs.get_nowait()
                )
            except queue.Empty:
                break
        return batch

    def _dispatch_group(self, name: str, jobs: list):
        """Launch one group (single frame or padded power-of-two batch) on
        the device and return the in-flight record for ``_resolve_group``.
        Batch sizes bucket to powers of two so at most log2(max_batch)+1
        graphs are ever captured per viz mode.
        Returns None if the launch itself failed (jobs already resolved)."""
        from monocular_depth_estimation_trt_tpu_torch.runtime.transfer import (
            tree_fetch_async,
        )

        pipe = self.pipes[name]
        dev_out = self._dev_out[name]
        t0 = time.time()
        try:
            if self._chip_side:
                # measurement mode: launch on the pre-uploaded device batch
                # (no per-request H2D; see __init__)
                bucket = _ceil_pow2(len(jobs))
                dev = self._synth_dev[(name, bucket)]
                viz = any(j.viz for j in jobs)
                if bucket == 1:
                    out = pipe(dev[0], viz=viz, device_out=True)
                else:
                    out = pipe.batch_call(dev, viz=viz, device_out=True)
            elif len(jobs) == 1:
                out = (pipe(jobs[0].frame, viz=jobs[0].viz, device_out=True)
                       if dev_out else pipe(jobs[0].frame, viz=jobs[0].viz))
            else:
                frames = np.stack([j.frame for j in jobs])
                bucket = _ceil_pow2(len(jobs))
                if bucket > len(jobs):  # pad w/ last frame (rows discarded)
                    pad = np.repeat(frames[-1:], bucket - len(jobs), axis=0)
                    frames = np.concatenate([frames, pad], axis=0)
                viz = any(j.viz for j in jobs)
                out = (pipe.batch_call(frames, viz=viz, device_out=True)
                       if dev_out else pipe.batch_call(frames, viz=viz))
            if dev_out or self._chip_side:
                # the device-to-host copies go in right behind the launch;
                # _resolve_group waits for them alone, not for later groups
                out = tree_fetch_async(out)
        except Exception as e:  # surface as 500, keep serving
            self._finish_group(name, jobs, t0, error=f"{type(e).__name__}: {e}")
            return None
        return (name, jobs, out, t0)

    def _resolve_group(self, pending) -> None:
        """Wait for a dispatched group's outputs on the host and resolve its
        jobs. Runs after the next group is launched, so that the wait
        overlaps the card's work (the point of the two-stage worker)."""
        name, jobs, out, t0 = pending
        try:
            if self._dev_out[name] or self._chip_side:
                out = out.result()
            if self._chip_side:
                # a 1-element probe of the fetched result (the launch's
                # sync) instead of the whole payload
                leaf = next(v for v in out.values() if isinstance(v, np.ndarray))
                probe = np.asarray(leaf).reshape(-1)[:1]
                for job in jobs:
                    job.result = {"probe": probe}
            elif len(jobs) == 1:
                jobs[0].result = out
            else:
                for i, job in enumerate(jobs):
                    job.result = {k: np.asarray(v)[i] for k, v in out.items()}
        except Exception as e:  # surface as 500, keep serving
            self._finish_group(name, jobs, t0, error=f"{type(e).__name__}: {e}")
            return
        self._finish_group(name, jobs, t0)

    def _finish_group(self, name: str, jobs: list, t0: float,
                      error: Optional[str] = None) -> None:
        if error is not None:
            for j in jobs:
                j.error = error
        dt = (time.time() - t0) * 1e3
        with self._lock:
            if error is not None:
                self.errors += len(jobs)
            self.requests += len(jobs)
            self.requests_by_model[name] += len(jobs)
            if len(jobs) > 1:
                self.batches += 1
                self.batched_jobs += len(jobs)
            self.lat_ms.append(dt)
            if len(self.lat_ms) > 1000:
                self.lat_ms = self.lat_ms[-1000:]
        for j in jobs:
            j.done.set()

    def _run(self) -> None:
        inflight = None  # at most ONE dispatched-but-unfetched group
        while not self._stop.is_set():
            try:
                # with a group in flight, only peek for immediate work
                # before fetching its results (keeps idle latency ~1 ms)
                job = self.jobs.get(timeout=0.001 if inflight else 0.2)
            except queue.Empty:
                if inflight is not None:
                    self._resolve_group(inflight)
                    inflight = None
                continue
            jobs = (self._collect(job) if self.max_batch > 1 else [job])
            # group per model: the card still sees one launch at a time,
            # but a mixed drain must not stack frames of different models
            # (or input sizes) into one batch
            groups: Dict[str, list] = {}
            for j in jobs:
                groups.setdefault(j.model, []).append(j)
            for name, group in groups.items():
                # honor the model's own cap: chunk, never exceed its largest
                # bucket
                cap = self.max_batch_by[name]
                for i in range(0, len(group), cap):
                    chunk = group[i:i + cap]
                    key = (name, _ceil_pow2(len(chunk)),
                           any(j.viz for j in chunk))
                    # resolve first when the coming dispatch would block:
                    # sync pipes compute inline, and a cold launch shape
                    # captures its graph; either would hold the previous
                    # group's finished results
                    if inflight is not None and (
                            not self._dev_out[name] or key not in self._warm):
                        self._resolve_group(inflight)
                        inflight = None
                    pending = self._dispatch_group(name, chunk)
                    if pending is not None:
                        # only a successful dispatch proves the shape is
                        # captured; a failed one must stay cold so the next
                        # attempt still resolves prior work first
                        self._warm.add(key)
                    if inflight is not None:
                        self._resolve_group(inflight)
                        inflight = None
                    if pending is None:
                        continue
                    if self._dev_out[name]:
                        inflight = pending
                    else:  # host results already in hand — nothing to overlap
                        self._resolve_group(pending)
        if inflight is not None:
            self._resolve_group(inflight)

    def start(self) -> "DepthServer":
        self._worker.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._worker.is_alive():
            self._worker.join(timeout=2.0)

    # -- request path -----------------------------------------------------
    def submit(self, frame: np.ndarray, viz: bool,
               model: Optional[str] = None) -> _Job:
        from monocular_depth_estimation_trt_tpu_torch.utils.imageio import resize

        # '' (e.g. a "/v1/models//depth" URL) is an unknown model, not a
        # request for the default — only absent selectors fall through.
        name = self.default_model if model is None else model
        if name not in self.pipes:
            raise KeyError(name)  # -> 404 upstream
        h, w = self.hw_by[name]
        if frame.shape[:2] != (h, w):
            frame = resize(frame, (h, w), "area")
        job = _Job(frame, viz, name)
        self.jobs.put_nowait(job)  # queue.Full -> 503 upstream
        return job

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            lat = list(self.lat_ms)
            n, e = self.requests, self.errors
            nb, bj = self.batches, self.batched_jobs
            by_model = dict(self.requests_by_model)
        out = {"requests": n, "errors": e, "queue_depth": self.jobs.qsize()}
        if len(self.pipes) > 1:
            out["requests_by_model"] = by_model
        if self.max_batch > 1:
            out["max_batch"] = self.max_batch
            out["batches"] = nb
            out["avg_batch"] = round(bj / nb, 2) if nb else None
        if lat:
            out["avg_ms"] = round(float(np.mean(lat)), 2)
            out["p50_ms"] = round(float(np.percentile(lat, 50)), 2)
            out["p99_ms"] = round(float(np.percentile(lat, 99)), 2)
        return out

    def metrics_text(self) -> str:
        """Prometheus text exposition of the serving counters (GET
        /metrics) — the same numbers as /v1/stats, scrape-ready."""
        s = self.stats()
        lines = [
            "# TYPE mdet_requests_total counter",
            f"mdet_requests_total {s['requests']}",
            "# TYPE mdet_errors_total counter",
            f"mdet_errors_total {s['errors']}",
            "# TYPE mdet_queue_depth gauge",
            f"mdet_queue_depth {s['queue_depth']}",
        ]
        for k, name in (("avg_ms", "mdet_latency_avg_ms"),
                        ("p50_ms", "mdet_latency_p50_ms"),
                        ("p99_ms", "mdet_latency_p99_ms")):
            if k in s:
                lines += [f"# TYPE {name} gauge", f"{name} {s[k]}"]
        if self.max_batch > 1:
            lines += ["# TYPE mdet_batches_total counter",
                      f"mdet_batches_total {s['batches']}"]
            if s.get("avg_batch"):
                lines += ["# TYPE mdet_avg_batch gauge",
                          f"mdet_avg_batch {s['avg_batch']}"]
        return "\n".join(lines) + "\n"

    def health(self) -> Dict[str, Any]:
        out = {
            "status": "ok",
            "model": self.pipe.spec.artifact_name(),
            "input_hw": list(self.input_hw),
            "uptime_s": round(time.time() - self.started, 1),
        }
        if len(self.pipes) > 1:
            out["models"] = list(self.pipes)
        return out

    def models(self) -> Dict[str, Any]:
        """GET /v1/models payload: what this server hosts and how to
        address each entry (`POST /v1/models/<name>/depth`)."""
        return {
            "default": self.default_model,
            "models": {
                name: {
                    "artifact": p.spec.artifact_name(),
                    "input_hw": list(self.hw_by[name]),
                    **({"max_batch": self.max_batch_by[name]}
                       if self.max_batch > 1 else {}),
                }
                for name, p in self.pipes.items()
            },
        }


def _npz_bytes(out: Dict[str, Any]) -> bytes:
    buf = io.BytesIO()
    arrays = {
        k: np.asarray(v)
        for k, v in out.items()
        if isinstance(v, (np.ndarray,)) or hasattr(v, "__array__")
    }
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def make_handler(server: DepthServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through [MDET] logging
            log(f"http {self.address_string()} {fmt % args}")

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj: Dict[str, Any]) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def _drain_body(self) -> None:
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                length = 0
            while length > 0:
                chunk = self.rfile.read(min(length, 1 << 20))
                if not chunk:
                    break
                length -= len(chunk)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/v1/health":
                return self._json(200, server.health())
            if path == "/v1/stats":
                return self._json(200, server.stats())
            if path == "/v1/models":
                return self._json(200, server.models())
            if path == "/metrics":  # Prometheus scrape endpoint
                return self._send(200, server.metrics_text().encode(),
                                  "text/plain; version=0.0.4")
            return self._json(404, {"error": f"unknown path {path}"})

        def do_POST(self):
            from monocular_depth_estimation_trt_tpu_torch.utils.imageio import (
                CodecUnavailable,
                decode_image,
                encode_image,
                jpeg_available,
            )

            url = urlparse(self.path)
            # keep_blank_values: `?model=` must mean "unknown model ''"
            # (-> 404 + listing), not silently fall through to the default
            qs = parse_qs(url.query, keep_blank_values=True)
            model = None
            if (url.path.startswith("/v1/models/")
                    and url.path.endswith("/depth")):
                model = url.path[len("/v1/models/"):-len("/depth")]
            elif url.path == "/v1/depth":
                model = qs.get("model", [None])[0]
            else:
                # drain the request body first: with HTTP/1.1 keep-alive an
                # unread body would be parsed as the start of the NEXT
                # request on this connection
                self._drain_body()
                return self._json(404, {"error": f"unknown path {url.path}"})
            fmt = qs.get("format", ["npz"])[0]
            if fmt == "jpg" and not jpeg_available():
                self._drain_body()
                return self._json(501, {"error": "format=jpg needs the cv2 (OpenCV) "
                                        "JPEG codec, which is not importable here; "
                                        "use format=npz"})
            try:
                length = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(length)
                frame = decode_image(raw)
                if frame is None:
                    return self._json(400, {"error": "undecodable image"})
            except CodecUnavailable as e:
                return self._json(501, {"error": str(e)})
            except Exception as e:
                return self._json(400, {"error": str(e)})

            try:
                job = server.submit(frame, viz=(fmt == "jpg"), model=model)
            except KeyError:
                return self._json(404, {
                    "error": f"unknown model {model!r}",
                    "models": list(server.pipes),
                })
            except queue.Full:
                return self._json(503, {"error": "queue full", **server.stats()})
            if not job.done.wait(server.timeout_s):
                return self._json(504, {"error": "inference timeout"})
            if job.error:
                return self._json(500, {"error": job.error})

            out = job.result
            if fmt == "jpg":
                viz = out.get("viz")
                if viz is None:
                    return self._json(400, {
                        "error": "pipeline has no viz output; use format=npz"
                    })
                try:
                    body = encode_image(np.asarray(viz), ".jpg")
                except CodecUnavailable as e:
                    return self._json(501, {"error": str(e)})
                return self._send(200, body, "image/jpeg")
            return self._send(200, _npz_bytes(out), "application/octet-stream")

    return Handler


# -- lock-step serving over a process group ---------------------------------

_STOP = "stop"


def _broadcast(msg=None):
    """Rank 0's ``msg`` on every rank."""
    import torch.distributed as dist

    box = [msg]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class _Lockstep:
    """A pipeline on rank 0 whose every call is first broadcast to the
    other ranks (:func:`follow`)."""

    def __init__(self, name: str, pipe):
        self._name = name
        self._pipe = pipe

    def __getattr__(self, attr):
        return getattr(self._pipe, attr)

    def __call__(self, frame, *, viz: bool = False, device_out: bool = False):
        _broadcast(("__call__", self._name, np.asarray(frame), viz))
        return self._pipe(frame, viz=viz, device_out=device_out)

    def batch_call(self, frames, *, viz: bool = False, device_out: bool = False):
        _broadcast(("batch_call", self._name, np.asarray(frames), viz))
        return self._pipe.batch_call(frames, viz=viz, device_out=device_out)


def lockstep(pipeline):
    """Rank 0's side of lock-step serving: ``pipeline`` (one, or a
    ``{name: pipeline}`` dict) with every call broadcast first. Release the
    other ranks with :func:`release_followers` when done."""
    if isinstance(pipeline, dict):
        return {name: _Lockstep(name, p) for name, p in pipeline.items()}
    return _Lockstep("", pipeline)


def follow(pipeline) -> int:
    """The other ranks' side: make each call rank 0 broadcasts, until it
    releases them. Returns the number of calls made."""
    from monocular_depth_estimation_trt_tpu_torch.parallel.mesh import rank

    pipes = pipeline if isinstance(pipeline, dict) else {"": pipeline}
    calls = 0
    while True:
        msg = _broadcast()
        if msg == _STOP:
            return calls
        kind, name, frames, viz = msg
        try:
            getattr(pipes[name], kind)(frames, viz=viz)
        except Exception as e:  # rank 0 answers it with a 500 and serves on: follow on
            log(f"serve: rank {rank()} call failed as rank 0's will: {type(e).__name__}: {e}",
                tag="WARN")
        calls += 1


def release_followers() -> None:
    _broadcast(_STOP)


def serve(pipeline, host: str = "0.0.0.0", port: int = 8000,
          input_hw: Optional[Tuple[int, int]] = None,
          max_queue: int = 32, warmup: bool = True,
          max_batch: int = 1, batch_window_ms: float = 2.0) -> None:
    """Blocking entry point for ``mdet serve`` (``python -m
    monocular_depth_estimation_trt_tpu_torch serve``). ``pipeline`` may be one
    pipeline or an ordered ``{name: pipeline}`` dict (multi-model). Under a
    process group of more than one rank, rank 0 serves and the other ranks
    follow its calls (:func:`lockstep`)."""
    from monocular_depth_estimation_trt_tpu_torch.parallel.mesh import rank, world_size

    multi = world_size() > 1
    if multi and rank() != 0:
        log(f"serve: rank {rank()} follows rank 0's calls")
        follow(pipeline)
        return
    if multi:
        pipeline = lockstep(pipeline)
    try:
        _serve_http(pipeline, host, port, input_hw, max_queue, warmup, max_batch,
                    batch_window_ms)
    finally:
        if multi:
            release_followers()


def _serve_http(pipeline, host, port, input_hw, max_queue, warmup, max_batch,
                batch_window_ms) -> None:
    ds = DepthServer(pipeline, input_hw=input_hw, max_queue=max_queue,
                     max_batch=max_batch, batch_window_ms=batch_window_ms)
    if warmup:
        ds.warmup()
    ds.start()
    httpd = ThreadingHTTPServer((host, port), make_handler(ds))
    if len(ds.pipes) > 1:
        log(f"serving {len(ds.pipes)} models on http://{host}:{port} — "
            f"default {ds.default_model!r} at POST /v1/depth, all at "
            f"POST /v1/models/<name>/depth: {', '.join(ds.pipes)}")
    else:
        log(f"serving {ds.pipe.spec.artifact_name()} on http://{host}:{port} "
            f"(POST /v1/depth)")
    # SIGTERM (docker stop / kubernetes) drains like Ctrl-C: stop accepting,
    # resolve the in-flight group, join the worker — not a mid-launch kill
    import signal

    def _term(signum, frame):
        raise KeyboardInterrupt

    try:
        prev = signal.signal(signal.SIGTERM, _term)
    except ValueError:  # not the main thread (embedded/test use)
        prev = None
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        log("serve: shutting down (drain + worker join)")
    finally:
        httpd.server_close()
        ds.stop()
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
