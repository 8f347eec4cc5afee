"""Homogeneous participating media: HG phase, distance sampling,
transmittance (counterpart of ``bre_tpu/media.py``; pbrt medium.{h,cpp},
media/homogeneous.cpp:44-77).  Grid media are ROADMAP Queue 1
"heterogeneous media"; ``scene.check_slice`` rejects them."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .core.math import INV_4PI, PI, coordinate_system, dot, spherical_direction_basis
from .core.rng import PCG32State
from .core.samplers import stream_1d
from .scene.scene import Media

_MAX_F = 3.0e38


def phase_hg(cos_theta: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """PhaseHG (medium.h:95-99)."""
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4PI * (1.0 - g * g) / (denom * torch.sqrt(torch.clamp_min(denom, 1e-12)))


def hg_p(wo: torch.Tensor, wi: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """HenyeyGreenstein::p (medium.cpp:215-218)."""
    return phase_hg(dot(wo, wi), g)


def hg_sample_p(wo: torch.Tensor, g: torch.Tensor,
                u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """HenyeyGreenstein::Sample_p (medium.cpp:194-213): (wi, pdf), with the
    branchless g~0 isotropic fallback."""
    iso = g.abs() < 1e-3
    g_safe = torch.where(iso, torch.ones_like(g), g)
    sqr = (1.0 - g * g) / (1.0 - g + 2.0 * g * u[..., 0])
    cos_theta = torch.where(iso, 1.0 - 2.0 * u[..., 0],
                            (1.0 + g * g - sqr * sqr) / (2.0 * g_safe))
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    phi = 2.0 * PI * u[..., 1]
    v1, v2 = coordinate_system(wo)
    wi = spherical_direction_basis(sin_theta, cos_theta, phi, v1, v2, -wo)
    return wi, phase_hg(-cos_theta, g)


def _lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a table of a few rows (one per medium) and many
    ids, as one select per row.  The values are the same; the gradient is
    one reduction per row, where indexing's backward on a card adds up the
    cotangents of equal ids one after another, which took most of a
    fwd+bwd iteration (PERF.md, profile_step.py)."""
    out = table[0].expand(idx.shape + table.shape[1:])
    for m in range(1, table.shape[0]):
        sel = (idx == m).reshape(idx.shape + (1,) * (table.dim() - 1))
        out = torch.where(sel, table[m], out)
    return out


def gather_medium(media: Media, med_idx: torch.Tensor):
    """Per-ray (sigma_a, sigma_s, g, in_medium) from int64 medium ids; zeros
    in vacuum (-1)."""
    in_medium = med_idx >= 0
    M = media.mtype.shape[0]
    if M == 0:
        z = torch.zeros(med_idx.shape + (3,), dtype=torch.float32,
                        device=med_idx.device)
        return z, z, z[..., 0], in_medium
    safe = torch.clamp(med_idx, 0, M - 1)
    zero = torch.zeros((), dtype=torch.float32, device=med_idx.device)
    sigma_a = torch.where(in_medium[..., None], _lookup(media.sigma_a, safe),
                          zero)
    sigma_s = torch.where(in_medium[..., None], _lookup(media.sigma_s, safe),
                          zero)
    g = torch.where(in_medium, _lookup(media.g, safe), zero)
    return sigma_a, sigma_s, g, in_medium


class MediumSample(NamedTuple):
    sampled: torch.Tensor  # (R,) bool — scatter event before t_max
    t: torch.Tensor  # (R,) ray parameter of the interaction
    weight: torch.Tensor  # (R,3) path throughput factor


def sample_homogeneous(sigma_a, sigma_s, d, t_max, u_channel,
                       u_dist) -> MediumSample:
    """HomogeneousMedium::Sample (homogeneous.cpp:50-77), vectorized;
    t_max in units of |d|."""
    sigma_t = sigma_a + sigma_s
    d_len = torch.sqrt(torch.clamp_min((d * d).sum(-1), 1e-30))
    channel = torch.clamp_max((u_channel * 3).to(torch.int64), 2)
    sig_c = torch.gather(sigma_t, -1, channel[..., None])[..., 0]
    pos = sig_c > 1e-12
    sig_safe = torch.where(pos, sig_c, torch.ones_like(sig_c))
    dist = -torch.log(torch.clamp_min(1.0 - u_dist, 1e-38)) / sig_safe
    t = torch.where(pos, torch.minimum(dist / d_len, t_max), t_max)
    sampled = (t < t_max) & pos
    tr = torch.exp(-sigma_t * torch.clamp_max((t * d_len)[..., None], _MAX_F))
    density = torch.where(sampled[..., None], sigma_t * tr, tr)
    pdf = density.mean(-1)
    pdf = torch.where(pdf == 0.0, torch.ones_like(pdf), pdf)
    w_scatter = tr * sigma_s / pdf[..., None]
    w_pass = tr / pdf[..., None]
    weight = torch.where(sampled[..., None], w_scatter, w_pass)
    return MediumSample(sampled, t, weight)


def sample_medium(media: Media, med_idx, d, t_max,
                  rng: PCG32State) -> Tuple[PCG32State, MediumSample]:
    """Medium::Sample over the media table, homogeneous branch: two draws
    per lane (channel, distance); vacuum lanes pass through unweighted."""
    sigma_a, sigma_s, _, in_medium = gather_medium(media, med_idx)
    rng, u1 = stream_1d(rng)
    rng, u2 = stream_1d(rng)
    hs = sample_homogeneous(sigma_a, sigma_s, d, t_max, u1, u2)
    sampled = hs.sampled & in_medium
    t = torch.where(in_medium, hs.t, t_max)
    weight = torch.where(in_medium[..., None], hs.weight,
                         torch.ones_like(hs.weight))
    return rng, MediumSample(sampled, t, weight)


def tr_homogeneous(sigma_a, sigma_s, d, t_max) -> torch.Tensor:
    """HomogeneousMedium::Tr = exp(-sigma_t * min(tMax*|d|, inf))
    (homogeneous.cpp:44-48)."""
    sigma_t = sigma_a + sigma_s
    d_len = torch.sqrt(torch.clamp_min((d * d).sum(-1), 1e-30))
    return torch.exp(-sigma_t * torch.clamp_max(t_max * d_len, _MAX_F)[..., None])
