"""Sampling warps and discrete distributions (counterpart of
``bre_tpu/core/sampling.py``; pbrt sampling.{h,cpp})."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .math import PI, PI_OVER_2, PI_OVER_4


def uniform_sample_sphere(u: torch.Tensor) -> torch.Tensor:
    """u: (...,2) -> unit directions (...,3). sampling.cpp:226-232."""
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def concentric_sample_disk(u: torch.Tensor) -> torch.Tensor:
    """Shirley-Chiu concentric disk warp (sampling.cpp:234-250)."""
    u_off = 2.0 * u - 1.0
    ux, uy = u_off[..., 0], u_off[..., 1]
    zero = (ux == 0.0) & (uy == 0.0)
    use_x = ux.abs() > uy.abs()
    r = torch.where(use_x, ux, uy)
    one = torch.ones_like(ux)
    theta = torch.where(
        use_x,
        PI_OVER_4 * (uy / torch.where(ux == 0.0, one, ux)),
        PI_OVER_2 - PI_OVER_4 * (ux / torch.where(uy == 0.0, one, uy)),
    )
    d = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)], -1)
    return torch.where(zero[..., None], torch.zeros_like(d), d)


def cosine_sample_hemisphere(u: torch.Tensor) -> torch.Tensor:
    """Malley's method (sampling.h:151-155)."""
    d = concentric_sample_disk(u)
    z = torch.sqrt(torch.clamp_min(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, 0.0))
    return torch.cat([d, z[..., None]], -1)


def cosine_hemisphere_pdf(cos_theta: torch.Tensor) -> torch.Tensor:
    return cos_theta * (1.0 / PI)


def uniform_sample_triangle(u: torch.Tensor) -> torch.Tensor:
    """Barycentric warp (sampling.cpp UniformSampleTriangle)."""
    su0 = torch.sqrt(u[..., 0])
    return torch.stack([1.0 - su0, u[..., 1] * su0], -1)


class Distribution1D(NamedTuple):
    """Piecewise-constant 1D distribution (pbrt sampling.h:55-131).

    func: (n,) nonnegative weights; cdf: (n+1,) normalized CDF;
    func_int: scalar integral (mean of func).
    """

    func: torch.Tensor
    cdf: torch.Tensor
    func_int: torch.Tensor

    @property
    def count(self) -> int:
        return self.func.shape[-1]


def make_distribution_1d(func: torch.Tensor) -> Distribution1D:
    func = func.to(torch.float32)
    n = func.shape[-1]
    zero = torch.zeros(func.shape[:-1] + (1,), dtype=torch.float32,
                       device=func.device)
    cdf = torch.cat([zero, torch.cumsum(func, -1) / n], -1)
    func_int = cdf[..., -1]
    # degenerate all-zero distribution -> uniform (sampling.h:69-77)
    uniform = torch.arange(n + 1, dtype=torch.float32, device=func.device) / n
    cdf = torch.where(func_int[..., None] > 0.0,
                      cdf / torch.clamp_min(func_int[..., None], 1e-30),
                      uniform)
    return Distribution1D(func, cdf, func_int)


def sample_discrete(dist: Distribution1D,
                    u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """SampleDiscrete (sampling.h:95-109): returns (index int64, pdf)."""
    if dist.count == 0:  # empty distribution (a light-less scene)
        return (torch.zeros(u.shape, dtype=torch.int64, device=u.device),
                torch.zeros_like(u))
    # FindInterval: largest i with cdf[i] <= u
    idx = torch.clamp(torch.searchsorted(dist.cdf, u, right=True) - 1,
                      0, dist.count - 1)
    pdf = torch.where(
        dist.func_int > 0.0,
        dist.func[idx] / torch.clamp_min(dist.func_int * dist.count, 1e-30),
        torch.full_like(u, 1.0 / dist.count),
    )
    return idx, pdf
