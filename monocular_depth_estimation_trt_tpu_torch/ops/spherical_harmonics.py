"""Real spherical harmonics on unit vectors (counterpart of the JAX package's
``ops/spherical_harmonics.py``).

UniDepth V2 / UniK3D embed camera ray directions with a degree-8 real SH
basis before conditioning their depth decoders (upstream ``rsh_cart_8``).
The basis is evaluated with the associated-Legendre recurrence in Cartesian
form, as the JAX function does: orthonormal real SH, no Condon-Shortley
phase, components ordered l = 0..lmax, m = -l..l, (lmax + 1)^2 of them.
"""

from __future__ import annotations

import math

import torch


def num_sh_components(lmax: int) -> int:
    return (lmax + 1) ** 2


def _k_norm(l: int, m: int) -> float:
    return math.sqrt((2 * l + 1) / (4 * math.pi) * math.factorial(l - m) / math.factorial(l + m))


def real_spherical_harmonics(xyz: torch.Tensor, lmax: int = 8) -> torch.Tensor:
    """The real SH basis on (..., 3) unit vectors -> (..., (lmax+1)^2), in
    fp32 (or the input's wider type). With C_m = r_xy^m cos(m phi) and S_m =
    r_xy^m sin(m phi) from the recurrences C_m = x C_{m-1} - y S_{m-1},
    S_m = x S_{m-1} + y C_{m-1}, each term stays polynomial in x, y, z."""
    dtype = torch.promote_types(xyz.dtype, torch.float32)
    x, y, z = (xyz[..., i].to(dtype) for i in range(3))
    c_m, s_m = torch.ones_like(x), torch.zeros_like(x)
    pmm = torch.ones_like(x)  # P_m^m with the r_xy^m factor removed
    sh = {}
    for m in range(lmax + 1):
        if m > 0:
            pmm = pmm * (2 * m - 1)
            c_m, s_m = x * c_m - y * s_m, x * s_m + y * c_m
        p_prev = pmm
        p_curr = (2 * m + 1) * z * pmm if m < lmax else None
        for l in range(m, lmax + 1):
            if l == m:
                p = p_prev
            elif l == m + 1:
                p = p_curr
            else:
                # (l-m) P_l^m = (2l-1) z P_{l-1}^m - (l+m-1) P_{l-2}^m
                p = ((2 * l - 1) * z * p_curr - (l + m - 1) * p_prev) / (l - m)
                p_prev, p_curr = p_curr, p
            k = _k_norm(l, m)
            if m == 0:
                sh[(l, 0)] = k * p
            else:
                s2 = math.sqrt(2.0) * k
                sh[(l, m)] = s2 * p * c_m
                sh[(l, -m)] = s2 * p * s_m
    return torch.stack([sh[(l, m)] for l in range(lmax + 1) for m in range(-l, l + 1)], dim=-1)
