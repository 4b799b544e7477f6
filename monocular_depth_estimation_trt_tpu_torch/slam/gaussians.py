"""Differentiable 3D Gaussian splatting, tile-based and static-shape
(counterpart of the JAX package's ``slam/gaussians.py``).

The reference's WildGS-SLAM recipe builds the CUDA rasterizer
``thirdparty/diff-gaussian-rasterization-w-pose`` (``later/WildGS-SLAM/
README.md``), whose per-pixel gaussian lists come from a device-side sort
of dynamic length. Both packages use a static-shape formulation instead:

  * EWA projection of every gaussian (batched 2x2/3x3 algebra).
  * Per 16x16 tile, a **fixed top-K** of contributing gaussians, chosen by
    ``torch.topk`` on a front-most score among those whose 3-sigma
    footprint touches the tile, then put in exact depth order by a stable
    ``argsort``.
  * Alpha compositing over the K slots as an exclusive ``cumprod``: a
    (tiles, pixels, K) contraction, not a loop.

Differentiable in the gaussian parameters and the camera pose (the
selection indices are piecewise constant: gradients flow through the
gathered values, as is standard for splatting), so the same renderer
serves mapping and pose refinement. A map holds a static capacity G with a
validity mask; densification writes into free slots.

Ties in the top-K score: ``lax.top_k`` keeps the lower index, ``torch.topk``
promises no order among equal scores. The masked slots (score ``-inf``)
carry zero opacity, so only finite ties at the K-th place could change a
render (``tests/test_torch_slam.py`` builds one).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from monocular_depth_estimation_trt_tpu_torch.slam.lie import se3_apply, se3_inv


class GaussianMap(NamedTuple):
    """Optimizable splat parameters (leading axis = static capacity G)."""

    means: torch.Tensor  # (G, 3) world
    log_scales: torch.Tensor  # (G, 3)
    quats: torch.Tensor  # (G, 4) xyzw, unnormalized
    colors_logit: torch.Tensor  # (G, 3) sigmoid -> [0, 1]
    opacity_logit: torch.Tensor  # (G,) sigmoid -> (0, 1)
    valid: torch.Tensor  # (G,) float {0, 1} slot-occupancy mask


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyzw (unnormalized) -> (..., 3, 3)."""
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-8)
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], -2)


class RenderOut(NamedTuple):
    color: torch.Tensor  # (H, W, 3)
    depth: torch.Tensor  # (H, W) alpha-weighted mean splat depth
    alpha: torch.Tensor  # (H, W) accumulated opacity


def _tile_centers(th: int, tw: int, tile: int, device) -> torch.Tensor:
    ty = (torch.arange(th, dtype=torch.float32, device=device) + 0.5) * tile
    tx = (torch.arange(tw, dtype=torch.float32, device=device) + 0.5) * tile
    tcy, tcx = torch.meshgrid(ty, tx, indexing="ij")
    return torch.stack([tcx.reshape(-1), tcy.reshape(-1)], -1)  # (T, 2) (u, v)


def render(gmap: GaussianMap, c2w: torch.Tensor, focal, hw: Tuple[int, int], *,
           tile: int = 16, k_per_tile: int = 32, near: float = 0.05) -> RenderOut:
    """Render the map from a camera-to-world pose under a centered pinhole.
    ``focal``: a float or a 0-d tensor. ``hw`` must be a multiple of ``tile``
    in both dims (pad upstream)."""
    h, w = hw
    assert h % tile == 0 and w % tile == 0
    th, tw = h // tile, w // tile
    dev = gmap.means.device
    f = torch.as_tensor(focal, dtype=torch.float32).to(dev)
    cx, cy = w / 2.0, h / 2.0

    w2c = se3_inv(c2w)
    xc = se3_apply(w2c, gmap.means)  # (G, 3)
    z = xc[:, 2]
    in_front = z > near
    zs = torch.clamp(z, min=near)
    u = f * xc[:, 0] / zs + cx
    v = f * xc[:, 1] / zs + cy

    # 3D covariance in world -> camera -> EWA 2D
    rs = quat_to_rot(gmap.quats) * torch.exp(gmap.log_scales)[:, None, :]
    cov3 = rs @ rs.transpose(-1, -2)  # R S S^T R^T
    rot_cw = w2c[:3, :3]
    cov_cam = rot_cw @ cov3 @ rot_cw.T
    invz = 1.0 / zs
    # J = d(u,v)/d(x,y,z): rows [f/z, 0, -f x/z^2], [0, f/z, -f y/z^2]
    j00 = f * invz
    zero = torch.zeros_like(j00)
    J = torch.stack([torch.stack([j00, zero, -f * xc[:, 0] * invz * invz], -1),
                     torch.stack([zero, j00, -f * xc[:, 1] * invz * invz], -1)], -2)
    cov2 = J @ cov_cam @ J.transpose(-1, -2)  # (G, 2, 2)
    cov2 = cov2 + 0.3 * torch.eye(2, dtype=cov2.dtype, device=dev)
    det = torch.clamp(cov2[:, 0, 0] * cov2[:, 1, 1] - cov2[:, 0, 1] * cov2[:, 1, 0], min=1e-8)
    inv2 = torch.stack([torch.stack([cov2[:, 1, 1], -cov2[:, 0, 1]], -1),
                        torch.stack([-cov2[:, 1, 0], cov2[:, 0, 0]], -1)], -2) / det[:, None, None]
    # 3-sigma screen radius from the larger eigenvalue
    mid = 0.5 * (cov2[:, 0, 0] + cov2[:, 1, 1])
    radius = 3.0 * torch.sqrt(mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.0)))

    # tile selection: distance from the tile rect to the projected center
    tc = _tile_centers(th, tw, tile, dev)
    half = tile / 2.0
    du = torch.clamp(torch.abs(tc[:, None, 0] - u[None, :]) - half, min=0.0)
    dv = torch.clamp(torch.abs(tc[:, None, 1] - v[None, :]) - half, min=0.0)
    dist2 = du * du + dv * dv
    r2 = radius[None, :] ** 2
    usable = (dist2 <= r2) & in_front[None, :] & (gmap.valid[None, :] > 0.5)
    # relevance: front-most, with a scale-free tile-proximity tie-break, so
    # that near-equal depths (flat surfaces) keep the gaussians that cover
    # this tile
    score = -zs[None, :] * (1.0 + 0.1 * dist2 / torch.clamp(r2, min=1e-8))
    score = torch.where(usable, score, float("-inf"))
    k = min(k_per_tile, score.shape[1])
    top_score, idx = torch.topk(score, k, dim=-1)  # (T, K)
    slot_ok = torch.isfinite(top_score)

    # gather each tile's splats, then restore exact depth order for
    # compositing (the tie-break perturbs the top-K order)
    order = torch.argsort(torch.where(slot_ok, zs[idx], float("inf")), dim=-1, stable=True)
    idx = torch.gather(idx, -1, order)
    slot_ok = torch.gather(slot_ok, -1, order)
    g_z = zs[idx]
    g_uv = torch.stack([u, v], -1)[idx]  # (T, K, 2)
    g_inv = inv2[idx]  # (T, K, 2, 2)
    g_col = torch.sigmoid(gmap.colors_logit)[idx]  # (T, K, 3)
    g_op = torch.sigmoid(gmap.opacity_logit)[idx] * slot_ok

    # per-tile pixel coordinates (P = tile*tile)
    ar = torch.arange(tile, dtype=torch.float32, device=dev) + 0.5
    py, px = torch.meshgrid(ar, ar, indexing="ij")
    pix = (tc - half)[:, None, :] + torch.stack([px.reshape(-1), py.reshape(-1)], -1)[None]

    d = pix[:, :, None, :] - g_uv[:, None, :, :]  # (T, P, K, 2)
    dx, dy = d[..., 0], d[..., 1]
    gi = g_inv[:, None]
    quad = (dx * (gi[..., 0, 0] * dx + gi[..., 0, 1] * dy)
            + dy * (gi[..., 1, 0] * dx + gi[..., 1, 1] * dy))
    alpha = g_op[:, None, :] * torch.exp(-0.5 * torch.clamp(quad, min=0.0))
    alpha = torch.clamp(alpha, 0.0, 0.995)  # (T, P, K) depth-sorted along K
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans_excl = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    wgt = alpha * trans_excl  # (T, P, K)

    color_t = wgt @ g_col  # (T, P, 3)
    depth_t = (wgt @ g_z[..., None])[..., 0]
    alpha_t = torch.sum(wgt, dim=-1)

    def untile(x):
        return x.reshape(th, tw, tile, tile, *x.shape[2:]).transpose(1, 2).reshape(
            h, w, *x.shape[2:])

    alpha_i = untile(alpha_t)
    return RenderOut(color=untile(color_t), depth=untile(depth_t) / torch.clamp(alpha_i, min=1e-6),
                     alpha=alpha_i)


def init_from_depth(image_rgb: torch.Tensor, depth: torch.Tensor, c2w: torch.Tensor, focal, *,
                    stride: int = 4, max_gaussians: int = 16384,
                    opacity: float = 0.7) -> GaussianMap:
    """Seed a map by backprojecting a depth frame on a stride grid
    (WildGS-SLAM-style keyframe densification), into static capacity.

    image_rgb: (H, W, 3) float in [0, 1]; depth: (H, W)."""
    h, w = depth.shape
    dev = depth.device
    f = torch.as_tensor(focal, dtype=torch.float32).to(dev)
    ys = torch.arange(stride // 2, h, stride, device=dev)
    xs = torch.arange(stride // 2, w, stride, device=dev)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    yy, xx = yy.reshape(-1), xx.reshape(-1)
    z = depth[yy, xx]
    u, v = xx.float(), yy.float()
    xc = torch.stack([(u - w / 2.0) * z / f, (v - h / 2.0) * z / f, z], -1)  # (N, 3) camera
    means = se3_apply(c2w, xc)
    n = means.shape[0]
    # isotropic init: world size of one stride cell at that depth
    sigma = torch.log(torch.clamp(z * stride / f, min=1e-4) * 0.7)
    cols = torch.clamp(image_rgb[yy, xx], 1e-3, 1 - 1e-3)
    g = max_gaussians

    def fit(x, fill=0.0):
        x = x[:g]
        pad = torch.full((g - x.shape[0], *x.shape[1:]), fill, dtype=x.dtype, device=dev)
        return torch.cat([x, pad])

    quat = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    quat[:, 3] = 1.0
    return GaussianMap(
        means=fit(means),
        log_scales=fit(sigma[:, None].expand(n, 3)),
        quats=fit(quat),
        colors_logit=fit(torch.log(cols / (1 - cols))),
        opacity_logit=fit(torch.full((n,), float(torch.logit(torch.tensor(opacity))),
                                     dtype=torch.float32, device=dev), fill=-10.0),
        valid=fit(torch.ones((n,), dtype=torch.float32, device=dev)),
    )


def insert_gaussians(gmap: GaussianMap, new: GaussianMap) -> GaussianMap:
    """Append ``new``'s valid gaussians into ``gmap``'s free slots (static
    shapes: a masked scatter, no reallocation). Overflow beyond capacity is
    dropped front-first."""
    free = gmap.valid < 0.5  # (G,)
    free_rank = torch.cumsum(free.long(), 0) - 1  # position among free slots
    new_valid = new.valid > 0.5
    new_rank = torch.cumsum(new_valid.long(), 0) - 1
    take = new_valid & (new_rank < free.sum())
    g = gmap.valid.shape[0]
    gn = new.valid.shape[0]
    # incoming index by rank: a dense table of incoming ranks (the sentinel
    # g collects the gaussians not taken)
    order = torch.where(take, new_rank, g).clamp(max=g)
    table = torch.zeros((g + 1,), dtype=torch.long, device=gmap.valid.device)
    table.scatter_(0, order, torch.arange(gn, device=gmap.valid.device))
    src = table[torch.clamp(free_rank, 0, g - 1)]  # (G,) incoming index per free slot
    fill = free & (free_rank < take.sum())

    def merge(a, b):
        return torch.where(fill.reshape((-1,) + (1,) * (a.ndim - 1)), b[src], a)

    merged = GaussianMap(*(merge(a, b) for a, b in zip(gmap, new)))
    return merged._replace(valid=torch.where(fill, 1.0, gmap.valid).to(gmap.valid.dtype))
