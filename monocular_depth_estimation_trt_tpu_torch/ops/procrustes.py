"""Weighted Procrustes (Kabsch) rigid alignment (counterpart of the JAX
package's ``ops/procrustes.py``): the pose step of two-view reconstruction.

The JAX package takes the 3x3 SVD of the cross-covariance. On the card
``torch.linalg.svd`` goes through cuSOLVER, which reads a status on the host
and so cannot sit inside a captured CUDA graph. Here the same rotation comes
from Horn's quaternion form: the best proper rotation (det +1, which is what
the JAX reflection fix selects) is the unit quaternion of the largest
eigenvalue of a symmetric 4x4 matrix built from the cross-covariance, found
by a fixed number of cyclic Jacobi sweeps in float64. Every operation is a
plain tensor kernel with no host read, and a rank-2 (coplanar) set, whose
SVD leaves the third singular vectors free, still has one answer.
"""

from __future__ import annotations

from typing import Tuple

import torch

JACOBI_SWEEPS = 8  # cyclic sweeps: quadratic convergence, float64 exact at 4x4


def _horn_matrix(h: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) cross-covariance S = sum w src dst^T -> Horn's symmetric
    (..., 4, 4) matrix, whose top eigenvector is the rotation's quaternion
    (w, x, y, z)."""
    sxx, sxy, sxz = h[..., 0, 0], h[..., 0, 1], h[..., 0, 2]
    syx, syy, syz = h[..., 1, 0], h[..., 1, 1], h[..., 1, 2]
    szx, szy, szz = h[..., 2, 0], h[..., 2, 1], h[..., 2, 2]
    rows = [
        [sxx + syy + szz, syz - szy, szx - sxz, sxy - syx],
        [syz - szy, sxx - syy - szz, sxy + syx, szx + sxz],
        [szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy],
        [sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def symmetric_eigh_jacobi(a: torch.Tensor, sweeps: int = JACOBI_SWEEPS
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues (..., n) and eigenvectors (columns of (..., n, n)) of
    symmetric ``a`` by ``sweeps`` cyclic Jacobi sweeps: each rotation zeroes
    one off-diagonal pair, its angle from ``atan2`` (0 for a pair already 0).
    A fixed count of tensor operations, for small n."""
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    vecs = eye.expand_as(a).clone()
    for _ in range(sweeps):
        for p, q in ((p, q) for p in range(n) for q in range(p + 1, n)):
            theta = 0.5 * torch.atan2(2.0 * a[..., p, q], a[..., q, q] - a[..., p, p])
            c, s = torch.cos(theta)[..., None, None], torch.sin(theta)[..., None, None]
            rot = eye + (c - 1.0) * (eye[:, p:p + 1] * eye[p] + eye[:, q:q + 1] * eye[q]) \
                + s * (eye[:, p:p + 1] * eye[q] - eye[:, q:q + 1] * eye[p])
            a = rot.transpose(-1, -2) @ a @ rot
            vecs = vecs @ rot
    return torch.diagonal(a, dim1=-2, dim2=-1), vecs


def _quat_to_rotation(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) as (w, x, y, z) -> rotation (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def weighted_procrustes(src: torch.Tensor, dst: torch.Tensor,
                        w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """R, t minimizing sum_i w_i ||R @ src_i + t - dst_i||^2.

    src/dst: (..., N, 3); w: (..., N), clipped at 0. Returns R (..., 3, 3)
    with det(R) = +1 and t (..., 3), fp32; the sums and the eigen-solve in
    float64."""
    src, dst = src.double(), dst.double()
    w = torch.clamp(w.double(), min=0.0)
    wn = w / (w.sum(dim=-1, keepdim=True) + 1e-8)
    mu_s = torch.einsum("...n,...ni->...i", wn, src)
    mu_d = torch.einsum("...n,...ni->...i", wn, dst)
    cs, cd = src - mu_s[..., None, :], dst - mu_d[..., None, :]
    h = torch.einsum("...ni,...nj->...ij", wn[..., None] * cs, cd)
    vals, vecs = symmetric_eigh_jacobi(_horn_matrix(h))
    top = torch.argmax(vals, dim=-1)
    q = torch.gather(vecs, -1, top[..., None, None].expand(*vecs.shape[:-1], 1))[..., 0]
    rot = _quat_to_rotation(q / torch.linalg.vector_norm(q, dim=-1, keepdim=True))
    t = mu_d - torch.einsum("...ij,...j->...i", rot, mu_s)
    return rot.float(), t.float()


def se3_apply(R: torch.Tensor, t: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (R, t) to points (..., N, 3)."""
    return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]
