"""Point-cloud / mesh writers, numpy and struct only (the JAX package's
``apps/ply.py``, byte for byte the same files).

The reference writes ``.ply`` via open3d (``Depth_Anything_V2/
onnx2trt_pointcloud.py:80-84``) and meshes via trimesh
(``MoGe_2/onnx2trt.py:269-317``); neither library is required here — PLY and
GLB are simple containers and we emit them directly.
"""

from __future__ import annotations

import json
import struct
from typing import Optional

import numpy as np


def write_ply(
    path: str,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    *,
    binary: bool = True,
) -> str:
    """points (N, 3) float; colors (N, 3) uint8 or float in [0,1]."""
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = pts.shape[0]
    has_color = colors is not None
    if has_color:
        col = np.asarray(colors).reshape(-1, 3)
        if col.dtype != np.uint8:
            col = np.clip(col * 255.0, 0, 255).astype(np.uint8)

    header = ["ply"]
    header.append(
        "format binary_little_endian 1.0" if binary else "format ascii 1.0"
    )
    header += [f"element vertex {n}", "property float x", "property float y",
               "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            if has_color:
                rec = np.zeros(
                    n,
                    dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)],
                )
                rec["xyz"] = pts
                rec["rgb"] = col
                f.write(rec.tobytes())
            else:
                f.write(pts.astype("<f4").tobytes())
        else:
            for i in range(n):
                line = f"{pts[i,0]} {pts[i,1]} {pts[i,2]}"
                if has_color:
                    line += f" {col[i,0]} {col[i,1]} {col[i,2]}"
                f.write((line + "\n").encode("ascii"))
    return path


def read_ply(path: str):
    """Minimal PLY reader (for tests / the viewer)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii").splitlines()
    n = 0
    binary = False
    props = []
    for line in header:
        if line.startswith("format binary"):
            binary = True
        elif line.startswith("element vertex"):
            n = int(line.split()[-1])
        elif line.startswith("property"):
            props.append(line.split()[-1])
    has_color = "red" in props
    body = data[header_end:]
    if binary:
        dtype = [("xyz", np.float32, 3)]
        if has_color:
            dtype.append(("rgb", np.uint8, 3))
        rec = np.frombuffer(body, dtype=dtype, count=n)
        pts = rec["xyz"].copy()
        col = rec["rgb"].copy() if has_color else None
    else:
        rows = [r.split() for r in body.decode("ascii").splitlines()[:n]]
        arr = np.asarray(rows, dtype=np.float64)
        pts = arr[:, :3].astype(np.float32)
        col = arr[:, 3:6].astype(np.uint8) if has_color else None
    return pts, col


def image_mesh_faces(h: int, w: int, mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Image-grid triangulation with masked-face removal.

    The reference builds the MoGe-2 mesh with ``utils3d.image_mesh`` +
    invalid-vertex face removal (``MoGe_2/onnx2trt.py:269-317``): each pixel
    quad becomes two triangles; a face survives only if all three vertices
    are valid. Returns (F, 3) int32 indices into the row-major (h*w) grid."""
    ii, jj = np.meshgrid(np.arange(h - 1), np.arange(w - 1), indexing="ij")
    tl = (ii * w + jj).ravel()
    tr = tl + 1
    bl = tl + w
    br = bl + 1
    # two triangles per quad, counter-clockwise
    f1 = np.stack([tl, bl, tr], axis=-1)
    f2 = np.stack([tr, bl, br], axis=-1)
    faces = np.concatenate([f1, f2], axis=0).astype(np.int32)
    if mask is not None:
        valid = np.asarray(mask).reshape(-1).astype(bool)
        keep = valid[faces].all(axis=1)
        faces = faces[keep]
    return faces


def write_ply_mesh(
    path: str,
    points: np.ndarray,
    faces: np.ndarray,
    colors: Optional[np.ndarray] = None,
) -> str:
    """Faces-bearing binary PLY (the reference's trimesh export role)."""
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    faces = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
    n, nf = pts.shape[0], faces.shape[0]
    has_color = colors is not None
    if has_color:
        col = np.asarray(colors).reshape(-1, 3)
        if col.dtype != np.uint8:
            col = np.clip(col * 255.0, 0, 255).astype(np.uint8)

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}", "property float x", "property float y",
              "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += [f"element face {nf}", "property list uchar int vertex_indices",
               "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if has_color:
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            rec["xyz"] = pts
            rec["rgb"] = col
            f.write(rec.tobytes())
        else:
            f.write(pts.astype("<f4").tobytes())
        frec = np.zeros(nf, dtype=[("n", np.uint8), ("idx", "<i4", 3)])
        frec["n"] = 3
        frec["idx"] = faces
        f.write(frec.tobytes())
    return path


def write_glb_mesh(
    path: str,
    points: np.ndarray,
    faces: np.ndarray,
    colors: Optional[np.ndarray] = None,
) -> str:
    """GLB with a TRIANGLES primitive + index buffer (MoGe-2 mesh ``.glb``
    parity, reference ``MoGe_2/onnx2trt.py:269-317``)."""
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    faces = np.asarray(faces, dtype=np.uint32).reshape(-1)
    n = pts.shape[0]
    finite = np.isfinite(pts)
    safe = np.where(finite, pts, 0.0)
    bufs = [safe.tobytes()]
    views = [{"buffer": 0, "byteOffset": 0, "byteLength": len(bufs[0])}]
    accessors = [
        {
            "bufferView": 0,
            "componentType": 5126,
            "count": n,
            "type": "VEC3",
            "min": [float(x) for x in safe.min(axis=0)],
            "max": [float(x) for x in safe.max(axis=0)],
        }
    ]
    attrs = {"POSITION": 0}
    if colors is not None:
        col = np.asarray(colors, dtype=np.float32).reshape(-1, 3)
        if col.max() > 1.0:
            col = col / 255.0
        b = col.tobytes()
        views.append({"buffer": 0, "byteOffset": sum(len(x) for x in bufs),
                      "byteLength": len(b)})
        accessors.append(
            {"bufferView": len(views) - 1, "componentType": 5126, "count": n,
             "type": "VEC3"}
        )
        attrs["COLOR_0"] = len(accessors) - 1
        bufs.append(b)
    ib = faces.astype("<u4").tobytes()
    views.append({"buffer": 0, "byteOffset": sum(len(x) for x in bufs),
                  "byteLength": len(ib)})
    accessors.append(
        {"bufferView": len(views) - 1, "componentType": 5125,
         "count": int(faces.size), "type": "SCALAR"}
    )
    bufs.append(ib)
    idx_accessor = len(accessors) - 1

    bin_chunk = b"".join(bufs)
    pad = (-len(bin_chunk)) % 4
    bin_chunk += b"\x00" * pad

    gltf = {
        "asset": {"version": "2.0", "generator": "mdet_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": attrs, "mode": 4,
                                    "indices": idx_accessor}]}],
        "buffers": [{"byteLength": len(bin_chunk)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    js = json.dumps(gltf).encode("utf-8")
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(bin_chunk)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(js), 0x4E4F534A))
        f.write(js)
        f.write(struct.pack("<II", len(bin_chunk), 0x004E4942))
        f.write(bin_chunk)
    return path


def write_glb_pointcloud(
    path: str, points: np.ndarray, colors: Optional[np.ndarray] = None
) -> str:
    """Minimal valid GLB with a POINTS primitive (MoGe-2 ``.glb`` parity,
    reference ``MoGe_2/onnx2trt.py:269-317``)."""
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = pts.shape[0]
    bufs = [pts.tobytes()]
    accessors = [
        {
            "bufferView": 0,
            "componentType": 5126,
            "count": n,
            "type": "VEC3",
            "min": [float(x) for x in pts.min(axis=0)],
            "max": [float(x) for x in pts.max(axis=0)],
        }
    ]
    views = [{"buffer": 0, "byteOffset": 0, "byteLength": len(bufs[0])}]
    attrs = {"POSITION": 0}
    if colors is not None:
        col = np.asarray(colors, dtype=np.float32).reshape(-1, 3)
        if col.max() > 1.0:
            col = col / 255.0
        b = col.tobytes()
        views.append(
            {"buffer": 0, "byteOffset": len(bufs[0]), "byteLength": len(b)}
        )
        accessors.append(
            {"bufferView": 1, "componentType": 5126, "count": n, "type": "VEC3"}
        )
        attrs["COLOR_0"] = 1
        bufs.append(b)

    bin_chunk = b"".join(bufs)
    pad = (-len(bin_chunk)) % 4
    bin_chunk += b"\x00" * pad

    gltf = {
        "asset": {"version": "2.0", "generator": "mdet_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": attrs, "mode": 0}]}],
        "buffers": [{"byteLength": len(bin_chunk)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    js = json.dumps(gltf).encode("utf-8")
    js += b" " * ((-len(js)) % 4)

    total = 12 + 8 + len(js) + 8 + len(bin_chunk)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(js), 0x4E4F534A))
        f.write(js)
        f.write(struct.pack("<II", len(bin_chunk), 0x004E4942))
        f.write(bin_chunk)
    return path
