"""Point-track visualization (counterpart of the JAX package's
``apps/tracking.py``; the reference's ``cotracker.utils.visualizer`` role,
``later/CoTracker3/infer.py:31-32``): tracked points with short motion
trails drawn onto the video, written as an MP4 (cv2, mp4v)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from monocular_depth_estimation_trt_tpu_torch.utils.logging import log


def _track_color(i: int, n: int):
    """Stable per-track BGR color from the turbo table."""
    from monocular_depth_estimation_trt_tpu_torch.ops.colormap import turbo_lut

    c = turbo_lut()[int(i / max(n - 1, 1) * 255)] * 255.0
    return int(c[2]), int(c[1]), int(c[0])


def visualize_tracks(video: np.ndarray, tracks: np.ndarray, visibility: Optional[np.ndarray],
                     out_path: str, *, fps: float = 20.0, trail: int = 8) -> str:
    """video (T, H, W, 3) uint8 RGB; tracks (1, T, N, 2) pixel (x, y);
    visibility (1, T, N, 1) in [0, 1] or None. Writes ``out_path`` MP4;
    without cv2, raises ``utils.imageio.CodecUnavailable`` naming it."""
    from monocular_depth_estimation_trt_tpu_torch.utils.imageio import video_cv2

    cv2 = video_cv2("the tracks MP4")
    t_total, h, w = video.shape[:3]
    tr = tracks[0]
    vis = None if visibility is None else visibility[0, ..., 0] > 0.5
    n = tr.shape[1]
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for t in range(min(t_total, tr.shape[0])):
        frame = cv2.cvtColor(video[t], cv2.COLOR_RGB2BGR).copy()
        for i in range(n):
            color = _track_color(i, n)
            for s in range(max(0, t - trail), t):
                p0 = tuple(np.round(tr[s, i]).astype(int))
                p1 = tuple(np.round(tr[s + 1, i]).astype(int))
                cv2.line(frame, p0, p1, color, 1, cv2.LINE_AA)
            if vis is None or vis[t, i]:
                cv2.circle(frame, tuple(np.round(tr[t, i]).astype(int)), 3, color, -1,
                           cv2.LINE_AA)
        writer.write(frame)
    writer.release()
    log(f"wrote {out_path}")
    return out_path
