"""SLAM frontend: keyframing, pair graph, and BA-problem assembly
(counterpart of the JAX package's ``slam/frontend.py``).

Host-side orchestration around the port's flow and depth engines: pick
keyframes by accumulated flow magnitude, connect them in a radius graph,
run dense flow along both directions of every edge, turn forward/backward
consistency into per-correspondence weights, and sample everything onto
the static BA grid, in numpy.

This is the shared tracking substrate of the three SLAM recipes
(``later/MegaSaM/README.md``, ``later/VIPE/README.md``,
``later/WildGS-SLAM/README.md``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from monocular_depth_estimation_trt_tpu_torch.slam.ba import BAProblem, flow_consistency_weights


@dataclass(frozen=True)
class FrontendConfig:
    grid_stride: int = 16  # BA grid stride in flow-resolution pixels
    kf_min_flow: float = 8.0  # mean |flow| (px) that spawns a keyframe
    kf_max_interval: int = 12  # force a keyframe after this many frames
    kf_stride: int = 2  # candidate spacing when scanning for keyframes
    max_keyframes: int = 16
    edge_radius: int = 2  # connect keyframes (i, i+1 .. i+radius)
    sigma_consistency: float = 1.5
    depth_is_disparity: bool = True  # DA-family nets emit disparity


def scale_coords(p: np.ndarray, src: float, dst: float) -> np.ndarray:
    """Map pixel-center coords from a src-length axis to a dst-length axis:
    ``(p + 0.5) * (dst / src) - 0.5`` (plain ``p * dst / src`` is biased by
    up to half a source pixel at the borders)."""
    return (p + 0.5) * (dst / src) - 0.5


def _bilinear(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Sample (H, W[, C]) at float coords (clamped); host-side numpy."""
    h, w = img.shape[:2]
    x = np.clip(x, 0.0, w - 1.0)
    y = np.clip(y, 0.0, h - 1.0)
    x0 = np.clip(np.floor(x).astype(np.int64), 0, w - 2)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, h - 2)
    fx = (x - x0).reshape(x.shape + (1,) * (img.ndim - 2))
    fy = (y - y0).reshape(y.shape + (1,) * (img.ndim - 2))
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
            + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)


class Frontend:
    """Wraps a flow function and a mono-depth function into BA inputs.

    ``flow_fn(frame1_u8, frame2_u8) -> (H', W', 2)`` and ``depth_fn(frame_u8)
    -> (H, W)`` may be the port's pipelines (:func:`make_pipeline_flow_fn`,
    :func:`make_pipeline_depth_fn`) or injected callables (tests use
    synthetic ones)."""

    def __init__(self, flow_fn, depth_fn, cfg: FrontendConfig = FrontendConfig()):
        self.flow_fn = flow_fn
        self.depth_fn = depth_fn
        self.cfg = cfg

    def select_keyframes(self, frames: Sequence[np.ndarray]) -> List[int]:
        """Greedy scan: a frame becomes a keyframe when the mean flow from
        the previous keyframe reaches ``kf_min_flow`` px (or after
        ``kf_max_interval`` frames)."""
        cfg = self.cfg
        kf, last, i = [0], 0, cfg.kf_stride
        while i < len(frames) and len(kf) < cfg.max_keyframes:
            flow = np.asarray(self.flow_fn(frames[last], frames[i]))
            mean_mag = float(np.mean(np.linalg.norm(flow, axis=-1)))
            if mean_mag >= cfg.kf_min_flow or (i - last) >= cfg.kf_max_interval:
                kf.append(i)
                last = i
            i += cfg.kf_stride
        return kf

    def build_edges(self, num_kf: int) -> np.ndarray:
        """Radius graph over keyframes, both directions per pair; (0, 2) for
        a single keyframe."""
        edges = []
        for i in range(num_kf):
            for r in range(1, self.cfg.edge_radius + 1):
                if i + r < num_kf:
                    edges += [(i, i + r), (i + r, i)]
        return np.asarray(edges, np.int64).reshape(-1, 2)

    def build_problem(self, frames: Sequence[np.ndarray], kf_idx: Sequence[int]
                      ) -> Tuple[BAProblem, dict]:
        """Run flow over every edge and mono depth on every keyframe, and
        sample both onto the BA grid. Returns the problem (CPU tensors) and an
        aux dict (flow resolution, grid shape, each keyframe's full-size
        disparity for the CVD stage)."""
        cfg = self.cfg
        kf_frames = [np.asarray(frames[i]) for i in kf_idx]
        k = len(kf_frames)
        edges = self.build_edges(k)

        # one probe to learn the flow resolution
        fh, fw = np.asarray(self.flow_fn(kf_frames[0], kf_frames[0])).shape[:2]
        st = cfg.grid_stride
        us = np.arange(st // 2, fw, st, dtype=np.float32)
        vs = np.arange(st // 2, fh, st, dtype=np.float32)
        uu, vv = np.meshgrid(us, vs)
        pu, pv = uu.ravel(), vv.ravel()
        p = pu.shape[0]

        flows = {}  # forward flow per ordered edge
        for i, j in map(tuple, edges):
            if (i, j) not in flows:
                flows[(i, j)] = np.asarray(self.flow_fn(kf_frames[i], kf_frames[j]))

        e = edges.shape[0]
        flow_grid = np.zeros((e, p, 2), np.float32)
        weight = np.zeros((e, p), np.float32)
        for n, (i, j) in enumerate(map(tuple, edges)):
            fg = _bilinear(flows[(i, j)], pu, pv)  # (P, 2)
            # backward flow at the forward-displaced location
            bg = _bilinear(flows[(j, i)], pu + fg[:, 0], pv + fg[:, 1])
            flow_grid[n] = fg
            weight[n] = flow_consistency_weights(torch.from_numpy(np.asarray(fg, np.float32)),
                                                 torch.from_numpy(np.asarray(bg, np.float32)),
                                                 cfg.sigma_consistency).numpy()
            # discard correspondences leaving the frame
            tu, tv = pu + fg[:, 0], pv + fg[:, 1]
            weight[n] *= ((tu >= 0) & (tu <= fw - 1) & (tv >= 0) & (tv <= fh - 1))

        # mono disparity per keyframe, sampled at the grid (scaled to the
        # depth map's own resolution), median-normalized per frame (BA's
        # affine channel owns the global alignment)
        idepth = np.zeros((k, p), np.float32)
        full_disp = []
        for n, f in enumerate(kf_frames):
            d = np.asarray(self.depth_fn(f))
            dh, dw = d.shape[:2]
            disp = d if cfg.depth_is_disparity else 1.0 / np.maximum(d, 1e-6)
            disp = disp / (float(np.median(disp)) or 1.0)
            full_disp.append(disp)
            idepth[n] = _bilinear(disp, scale_coords(pu, fw, dw), scale_coords(pv, fh, dh))

        prob = BAProblem(points_uv=torch.from_numpy(np.stack([pu, pv], -1)),
                         idepth=torch.from_numpy(idepth), edges=torch.from_numpy(edges),
                         flow=torch.from_numpy(flow_grid), weight=torch.from_numpy(weight))
        aux = {"flow_hw": (fh, fw), "grid_hw": (len(vs), len(us)), "full_disparity": full_disp}
        return prob, aux


def make_pipeline_flow_fn(flow_pipe) -> Any:
    """Adapt a :class:`~monocular_depth_estimation_trt_tpu_torch.pipelines.FlowPipeline`
    to the frontend contract: the flow at the model's input size."""

    def fn(f1: np.ndarray, f2: np.ndarray) -> np.ndarray:
        return np.asarray(flow_pipe(f1, f2)["flow"])

    return fn


def make_pipeline_depth_fn(depth_pipe) -> Any:
    """Adapt a depth pipeline: the depth at the frame's size."""

    def fn(f: np.ndarray) -> np.ndarray:
        return np.asarray(depth_pipe(f)["depth"])

    return fn
