"""Offline batch processing: decode threads + batched engines (counterpart
of the JAX package's ``apps/offline.py``).

The composition the reference cannot express (its batch dim is pinned to 1
and decode is single-threaded Python): a pool of decode threads reads and
resizes frames ahead of the device (``utils/imageio.py``: cv2 where it
imports, else the PNG / ``.npy`` codec), batches go to a (B, H, W, 3)
engine while the previous batch computes, and results come back through
pinned host memory. Where the native host-IO library builds
(``runtime/native.py``), its C++ decode ring (``FramePump``) reads the
frames instead of the Python threads, as in the JAX package; the stats say
which path ran (``decode``: ``native`` or ``python``).
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional

import numpy as np
import torch

from monocular_depth_estimation_trt_tpu_torch.runtime.transfer import tree_fetch_async
from monocular_depth_estimation_trt_tpu_torch.utils.logging import log


def process_images_batched(
    pipeline,
    paths: List[str],
    *,
    batch: int = 8,
    decode_hw: Optional[tuple] = None,
    on_result: Optional[Callable[[int, dict], None]] = None,
    decode_threads: int = 4,
) -> dict:
    """Run a DepthPipeline over many images with one batched engine.

    Returns throughput stats. ``on_result(start_index, outputs)`` receives
    each batch's host outputs if given (otherwise outputs are discarded after
    the fetch: benchmark mode). The tail batch is padded with its last
    frame; the padded rows are passed on too, as in the JAX package."""
    from monocular_depth_estimation_trt_tpu_torch.runtime import native
    from monocular_depth_estimation_trt_tpu_torch.utils.imageio import read_image, resize

    decode_hw = tuple(decode_hw or (pipeline.spec.height, pipeline.spec.width))

    def decode(path):
        return resize(read_image(path), decode_hw)

    eng = pipeline.batch_engine_for(decode_hw, batch)
    eng.compile()
    use_native = native.native_available()

    t0 = time.perf_counter()
    n_frames = 0
    pending = []  # (start_idx, fetch in flight)
    buf: List[np.ndarray] = []
    start_idx = 0

    def drain(sidx, fetch):
        host = fetch.result()
        if on_result is not None:
            on_result(sidx, host)

    def flush():
        nonlocal buf
        if not buf:
            return
        while len(buf) < batch:  # pad the tail batch
            buf.append(buf[-1])
        out = eng(torch.from_numpy(np.stack(buf)))
        pending.append((start_idx, tree_fetch_async(out)))
        if len(pending) > 2:  # bounded in-flight batches
            drain(*pending.pop(0))
        buf = []

    def decoded(pool):
        """Frames in order, with at most a ring of decodes ahead (the JAX
        package's ring of ``batch * 2 + 2`` buffers): the native pump's
        where the library is available, else the pool's."""
        if use_native:
            with native.FramePump.from_images(paths, decode_hw, ring=batch * 2 + 2,
                                              threads=max(int(decode_threads), 1)) as pump:
                for _, frame in pump:
                    yield np.copy(frame)  # the ring slot is reused after this step
            return
        ahead, todo = deque(), iter(paths)
        for path in itertools.islice(todo, batch * 2 + 2):
            ahead.append(pool.submit(decode, path))
        while ahead:
            frame = ahead.popleft().result()
            nxt = next(todo, None)
            if nxt is not None:
                ahead.append(pool.submit(decode, nxt))
            yield frame

    with ThreadPoolExecutor(max_workers=max(int(decode_threads), 1)) as pool:
        for idx, frame in enumerate(decoded(pool)):
            if not buf:
                start_idx = idx
            buf.append(frame)
            n_frames += 1
            if len(buf) == batch:
                flush()
        flush()
    for item in pending:
        drain(*item)

    dt = time.perf_counter() - t0
    stats = {"frames": n_frames, "seconds": round(dt, 3),
             "fps": round(n_frames / dt, 2) if dt > 0 else 0.0, "batch": batch,
             "decode": "native" if use_native else "python"}
    log(f"offline: {n_frames} frames in {dt:.2f}s -> {stats['fps']} FPS (batch {batch})")
    return stats
