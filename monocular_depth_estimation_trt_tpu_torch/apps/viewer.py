"""Live 3D point-cloud viewing (counterpart of the JAX package's
``apps/viewer.py``; reference ``onnx2trt_pointcloud_vis.py`` / ``vis_ply.py``).

The reference streams point clouds to a browser with viser
(``Depth_Anything_V2/onnx2trt_pointcloud_vis.py:7-17,68-93``) and views
``.ply`` files with open3d (``vis_ply.py:9-17``). Neither library is a
dependency: each is used where it imports, and without it :func:`view_ply`
prints the cloud's statistics and :func:`stream_pointclouds` writes numbered
``.ply`` files (``apps/ply.py``) that any external viewer opens.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np

from monocular_depth_estimation_trt_tpu_torch.apps.ply import read_ply, write_ply
from monocular_depth_estimation_trt_tpu_torch.utils.logging import log


def have_viser() -> bool:
    try:
        import viser  # noqa: F401

        return True
    except ImportError:
        return False


def have_open3d() -> bool:
    try:
        import open3d  # noqa: F401

        return True
    except ImportError:
        return False


def view_ply(path: str) -> None:
    """Open a ``.ply`` in an open3d window (reference ``vis_ply.py:9-17``);
    without open3d, log the cloud's point count and bounds."""
    if have_open3d():
        import open3d as o3d

        o3d.visualization.draw_geometries([o3d.io.read_point_cloud(path)])
        return
    pts, _ = read_ply(path)
    log(f"open3d not installed; {path}: {len(pts)} points, "
        f"bounds {pts.min(axis=0)} .. {pts.max(axis=0)}")


def stream_pointclouds(clouds: Iterable, *, port: int = 8080, out_dir: Optional[str] = None,
                       point_size: float = 0.002) -> None:
    """Stream (points, colors) pairs to a viser server (reference
    ``onnx2trt_pointcloud_vis.py:68-93``); without viser, write them as
    ``cloud_00000.ply``, ... into ``out_dir`` (default
    ``results/pointcloud_stream``)."""
    if have_viser():
        import time

        import viser

        server = viser.ViserServer(port=port)
        log(f"viser server on :{port}")
        for pts, col in clouds:
            server.scene.add_point_cloud(
                "/depth", points=np.asarray(pts, np.float32),
                colors=np.asarray(col) if col is not None else None, point_size=point_size)
            time.sleep(1 / 30)
        return
    out_dir = out_dir or "results/pointcloud_stream"
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for i, (pts, col) in enumerate(clouds):
        write_ply(os.path.join(out_dir, f"cloud_{i:05d}.ply"), pts, col)
        n += 1
    log(f"viser not installed; wrote {n} .ply frames -> {out_dir}")
