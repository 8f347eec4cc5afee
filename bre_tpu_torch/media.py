"""Participating media: HG phase, homogeneous and grid-density distance
sampling, transmittance (counterpart of ``bre_tpu/media.py``; pbrt
medium.{h,cpp}, media/homogeneous.cpp:44-77, media/grid.cpp:46-120).

Grid media track in two forms, both with the whole batch stepping together
and two draws per lane per trip.  The early-exit form (what the photon-beam
path takes) stops when no lane is live (a host loop on ``live.any()``, one
sync per trip) or ``max_steps`` trips have passed, so every lane's PCG32
stream advances exactly as the reference's ``lax.while_loop`` moves it; it
runs on detached values and re-attaches the sampled distance's gradient in
closed form.  The fixed-trip form (``early_exit=False``, what volpath
takes, and ``tr_grid``'s ratio tracking) is the reference's ``lax.scan``
of ``max_steps`` trips: the same loop, whose streams are then moved on by
the draws of the trips it skipped (``pcg32_advance``), so they end
``2 * max_steps`` draws on, as there.  While a profiler records, each
trip is a ``bre.track.trip`` span (``utils.stats.profile_phase``)."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .core import transform as tfm
from .core.math import (INV_4PI, PI, coordinate_system, dot, length,
                        ordered_index_sum, spherical_direction_basis)
from .core.rng import PCG32State, pcg32_advance, pcg32_next_f32
from .core.samplers import stream_1d, stream_rng, stream_with_rng
from .scene.scene import MEDIUM_GRID, Media
from .utils.stats import profile_phase

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
    """Per-ray (sigma_a, sigma_s, g, is_grid, in_medium) from int64 medium
    ids; zeros in vacuum (-1)."""
    in_medium = med_idx >= 0
    M = media.mtype.shape[0]
    if M == 0:
        z = torch.zeros(med_idx.shape + (3,), dtype=torch.float32,
                        device=med_idx.device)
        return z, z, z[..., 0], torch.zeros_like(in_medium), in_medium
    safe = torch.clamp(med_idx, 0, M - 1)
    zero = torch.zeros((), dtype=torch.float32, device=med_idx.device)
    sigma_a = torch.where(in_medium[..., None], _lookup(media.sigma_a, safe),
                          zero)
    sigma_s = torch.where(in_medium[..., None], _lookup(media.sigma_s, safe),
                          zero)
    g = torch.where(in_medium, _lookup(media.g, safe), zero)
    is_grid = in_medium & (media.mtype[safe] == MEDIUM_GRID)
    return sigma_a, sigma_s, g, is_grid, in_medium


class _RowGather(torch.autograd.Function):
    """``tab[ids]`` whose backward sums the cotangents of each row in a
    fixed order, without atomics (``core.math.ordered_index_sum``).
    Indexing's own backward (``index_put_`` with accumulate) is
    deterministic too, but on a card it adds each run of equal ids one
    entry after another, and the points that fall outside the grid clamp
    onto a few border rows: runs of millions of entries.  In a config-3
    step that scatter took 56% of the device time (PERF.md, PR 3)."""

    @staticmethod
    def forward(ctx, tab, ids):
        ctx.save_for_backward(ids)
        ctx.n_rows = tab.shape[0]
        return tab[ids]

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1)
        return ordered_index_sum(flat, grad.reshape(flat.shape[0], -1),
                                 ctx.n_rows), None


def grid_density(density: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Trilinear density at medium-space p in [0,1]^3, 0 outside
    (grid.cpp:46-60); density (nz, ny, nx) z-major, p (..., 3) xyz.

    The reference's form, kept for its values: one row lookup into an
    8-corner table of rolled copies of the flat grid, and the per-axis
    weight redistribution onto the clamped base cell (equivalent to eight
    masked corner reads).  The eight products are summed in corner order;
    the lookup's gradient is a sorted segment sum (``_RowGather``)."""
    nz, ny, nx = density.shape
    flat = density.reshape(-1)
    offs = (0, 1, nx, nx + 1, nx * ny, nx * ny + 1, nx * ny + nx,
            nx * ny + nx + 1)
    tab = torch.stack([torch.roll(flat, -o) for o in offs], -1)  # (n, 8)

    res = torch.tensor([nx, ny, nz], dtype=torch.float32, device=p.device)
    ps = p * res - 0.5
    pi0 = torch.floor(ps)
    d = ps - pi0
    pi = pi0.to(torch.int64)
    x, y, z = pi[..., 0], pi[..., 1], pi[..., 2]
    base = ((torch.clamp(z, 0, nz - 2) * ny + torch.clamp(y, 0, ny - 2)) * nx
            + torch.clamp(x, 0, nx - 2))
    vals = _RowGather.apply(tab, base)  # (..., 8)
    zero = torch.zeros((), dtype=torch.float32, device=p.device)

    def axis_w(c, dc, nc):
        """(w_corner0, w_corner1) for one axis with the base clamped to
        [0, nc-2]: D[c] (weight 1-dc) and D[c+1] (weight dc) land on the
        table corner that holds that cell."""
        in0 = (c >= 0) & (c <= nc - 1)
        in1 = (c + 1 >= 0) & (c + 1 <= nc - 1)
        lo, hi = c < 0, c > nc - 2
        w0 = (torch.where(in0 & ~hi, 1.0 - dc, zero)
              + torch.where(in1 & lo, dc, zero))
        w1 = (torch.where(in0 & hi, 1.0 - dc, zero)
              + torch.where(in1 & ~lo, dc, zero))
        return w0, w1

    wx0, wx1 = axis_w(x, d[..., 0], nx)
    wy0, wy1 = axis_w(y, d[..., 1], ny)
    wz0, wz1 = axis_w(z, d[..., 2], nz)
    w = (wx0 * wy0 * wz0, wx1 * wy0 * wz0, wx0 * wy1 * wz0, wx1 * wy1 * wz0,
         wx0 * wy0 * wz1, wx1 * wy0 * wz1, wx0 * wy1 * wz1, wx1 * wy1 * wz1)
    acc = vals[..., 0] * w[0]
    for k in range(1, 8):
        acc = acc + vals[..., k] * w[k]
    return acc


def _grid_ray_setup(media: Media, o, d, t_max):
    """World ray -> medium-space unit ray and the [t0, t1] overlap with
    [0,1]^3 (grid.cpp:66-71, Bounds3::IntersectP): returns (om, dm, dlen,
    t0, t1, hit_box), t in medium units."""
    om = tfm.apply_point(media.world_to_medium, o)
    dm = tfm.apply_vector(media.world_to_medium, d)
    dlen = torch.sqrt(torch.clamp_min(
        dm[..., 0] * dm[..., 0] + dm[..., 1] * dm[..., 1]
        + dm[..., 2] * dm[..., 2], 1e-30))
    dm = dm / dlen[..., None]
    t_max_m = t_max * dlen
    tiny = torch.where(dm < 0, torch.full_like(dm, -1e-12),
                       torch.full_like(dm, 1e-12))
    inv_d = 1.0 / torch.where(dm.abs() < 1e-12, tiny, dm)
    t_lo = (0.0 - om) * inv_d
    t_hi = (1.0 - om) * inv_d
    near = torch.minimum(t_lo, t_hi)
    far = torch.maximum(t_lo, t_hi)
    t0 = torch.clamp_min(near.amax(-1), 0.0)
    t1 = torch.minimum(far.amin(-1), t_max_m)
    return om, dm, dlen, t0, t1, t0 <= t1


class MediumSample(NamedTuple):
    sampled: torch.Tensor  # (R,) bool — scatter event before t_max
    t: torch.Tensor  # (R,) ray parameter of the interaction
    weight: torch.Tensor  # (R,3) path throughput factor


def sample_homogeneous(sigma_a, sigma_s, d, t_max, u_channel,
                       u_dist) -> MediumSample:
    """HomogeneousMedium::Sample (homogeneous.cpp:50-77), vectorized;
    t_max in units of |d|."""
    sigma_t = sigma_a + sigma_s
    d_len = length(d)
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


def sample_grid(media: Media, sigma_a, sigma_s, o, d, t_max,
                rng: PCG32State, max_steps: int = 256,
                early_exit: bool = True):
    """GridDensityMedium::Sample delta tracking (grid.cpp:62-87).  Returns
    (rng, MediumSample, n_overflow), n_overflow counting lanes still live
    after ``max_steps`` trips.

    Every trip draws two uniforms for every lane, live or not, until no
    lane of the batch is live.  In the early-exit form (the default,
    media.py:290-334) a lane's stream then ends 2 x (batch trips) draws
    on, as in the reference, so the photon walks stay slot for slot.  The
    loop runs on detached values and records each lane's S = sum of
    -log(1-u1) up to acceptance; the gradient re-attaches outside it as
    t_hit = t0 + S * inv_max_density / sigma_med (acceptance is a discrete
    event; the density reads feed only it).  ``early_exit`` False is the
    reference's fixed-trip scan (media.py:235-289): the streams are moved
    on by the skipped trips' draws, ``2 * max_steps`` in all, and the hit
    distance is the t accumulated trip by trip, detached (volpath, its
    caller, is not differentiated)."""
    sigma_t = (sigma_a + sigma_s)[..., 0]  # spectrally uniform (grid.h)
    om, dm, dlen, t0, t1, hit_box = _grid_ray_setup(media, o, d, t_max)
    # per-medium-unit extinction: t advances in medium units (tr_grid note)
    sigma_med = torch.clamp_min(sigma_t / torch.clamp_min(dlen, 1e-30), 1e-30)
    # amax splits the gradient evenly over ties, as jnp.max does
    inv_max_density = 1.0 / torch.clamp_min(media.density.amax(), 1e-30)

    om_l, dm_l, t1_l = om.detach(), dm.detach(), t1.detach()
    sigma_med_l, inv_max_l = sigma_med.detach(), inv_max_density.detach()
    dens_l = media.density.detach()
    live = hit_box & (sigma_t > 0.0)
    sampled = torch.zeros_like(live)
    t = t0.detach()
    S = torch.zeros_like(t)
    S_hit = torch.zeros_like(t)
    t_loop_hit = torch.zeros_like(t)
    zero = torch.zeros((), dtype=torch.float32, device=t.device)
    trips = 0
    while trips < max_steps and bool(live.any()):  # one host sync per trip
        with profile_phase("bre.track.trip"):
            rng, u1 = pcg32_next_f32(rng)
            rng, u2 = pcg32_next_f32(rng)
            term = -torch.log(1.0 - u1)
            S = S + torch.where(live, term, zero)
            t = t + term * inv_max_l / sigma_med_l
            exited = t >= t1_l
            dens = grid_density(dens_l, om_l + t[..., None] * dm_l)
            accept = (dens * inv_max_l > u2) & live & ~exited
            sampled = sampled | accept
            S_hit = torch.where(accept, S, S_hit)
            t_loop_hit = torch.where(accept, t, t_loop_hit)
            live = live & ~exited & ~accept
        trips += 1
    if early_exit:
        t_hit = t0 + S_hit * inv_max_density / sigma_med
    else:
        rng = pcg32_advance(rng, 2 * (max_steps - trips))
        t_hit = t_loop_hit
    t_hit = torch.where(sampled, t_hit, zero)
    weight = torch.where(
        sampled[..., None],
        sigma_s / torch.clamp_min(sigma_t, 1e-30)[..., None],
        torch.ones_like(sigma_s))
    t_world = t_hit / torch.clamp_min(dlen, 1e-30)
    ms = MediumSample(sampled, torch.where(sampled, t_world, t_max), weight)
    return rng, ms, live.sum()


def sample_medium(media: Media, med_idx, o, d, t_max, rng: PCG32State,
                  max_steps: int = 256, early_exit: bool = True, u12=None):
    """Medium::Sample over the media table: two draws per lane (channel,
    distance) for the homogeneous sample, then, when the scene has a grid
    medium, the batch-wide grid tracking on the raw streams
    (``stream_rng``) for every lane, in the form ``early_exit`` picks (the
    reference's default is the fixed-trip form; its photon-beam render
    asks for the early-exit one, the port's default).  ``u12`` (R,2), where
    given, replaces the two draws (media.py:348-371: a primary-sample
    caller's columns); the grid tracking still draws from the streams.
    Vacuum lanes pass through unweighted.  Returns (rng, MediumSample,
    n_overflow)."""
    sigma_a, sigma_s, _, is_grid, in_medium = gather_medium(media, med_idx)
    if u12 is None:
        rng, u1 = stream_1d(rng)
        rng, u2 = stream_1d(rng)
    else:
        u1, u2 = u12[..., 0], u12[..., 1]
    hs = sample_homogeneous(sigma_a, sigma_s, d, t_max, u1, u2)
    if media.density.numel() > 1:  # the scene has a grid medium
        raw, gs, n_overflow = sample_grid(media, sigma_a, sigma_s, o, d,
                                          t_max, stream_rng(rng), max_steps,
                                          early_exit=early_exit)
        rng = stream_with_rng(rng, raw)
        sampled = torch.where(is_grid, gs.sampled, hs.sampled) & in_medium
        t = torch.where(is_grid, gs.t, hs.t)
        weight = torch.where(is_grid[..., None], gs.weight, hs.weight)
    else:
        sampled, t, weight = hs.sampled & in_medium, hs.t, hs.weight
        n_overflow = torch.zeros((), dtype=torch.int64, device=t.device)
    t = torch.where(in_medium, t, t_max)
    weight = torch.where(in_medium[..., None], weight,
                         torch.ones_like(weight))
    return rng, MediumSample(sampled, t, weight), n_overflow


def tr_homogeneous(sigma_a, sigma_s, d, t_max) -> torch.Tensor:
    """HomogeneousMedium::Tr = exp(-sigma_t * min(tMax*|d|, inf))
    (homogeneous.cpp:44-48)."""
    sigma_t = sigma_a + sigma_s
    d_len = length(d)
    return torch.exp(-sigma_t * torch.clamp_max(t_max * d_len, _MAX_F)[..., None])


def tr_grid(media: Media, sigma_a, sigma_s, o, d, t_max, rng: PCG32State,
            max_steps: int = 512):
    """GridDensityMedium::Tr, ratio tracking with Russian roulette
    (grid.cpp:89-120; media.py:403-443): per trip one draw for the
    tentative step and one for the roulette, on every lane.  The running
    product stays differentiable in the density grid; the roulette is a
    detached decision.  The loop stops computing once no lane is live and
    moves the streams on by the skipped trips' draws (``2 * max_steps`` in
    all, as the reference's scan).  Returns (rng, Tr (R,), n_overflow)."""
    sigma_t = (sigma_a + sigma_s)[..., 0]
    om, dm, dlen, t0, t1, hit_box = _grid_ray_setup(media, o, d, t_max)
    # t advances in medium units (dm is normalized) and sigma is per world
    # unit, so the rate per medium unit is sigma_t / dlen
    sigma_med = torch.clamp_min(sigma_t / torch.clamp_min(dlen, 1e-30), 1e-30)
    inv_max_density = 1.0 / torch.clamp_min(media.density.amax(), 1e-30)
    rr_threshold = 0.1
    live = hit_box & (sigma_t > 0.0)
    t = t0
    tr = torch.ones_like(t0)
    zero = torch.zeros((), dtype=torch.float32, device=t0.device)
    trips = 0
    while trips < max_steps and bool(live.any()):  # one host sync per trip
        with profile_phase("bre.track.trip"):
            rng, u1 = pcg32_next_f32(rng)
            t = t - torch.log(1.0 - u1) * inv_max_density / sigma_med
            exited = t >= t1
            dens = grid_density(media.density, om + t[..., None] * dm)
            factor = 1.0 - torch.clamp_min(dens * inv_max_density, 0.0)
            tr = torch.where(live & ~exited, tr * factor, tr)
            rng, u2 = pcg32_next_f32(rng)
            do_rr = live & ~exited & (tr < rr_threshold)
            q = torch.clamp_min(1.0 - tr, 0.05)
            killed = do_rr & (u2 < q).detach()
            tr = torch.where(killed, zero,
                             torch.where(do_rr, tr / (1.0 - q), tr))
            live = live & ~exited & ~killed
        trips += 1
    rng = pcg32_advance(rng, 2 * (max_steps - trips))
    return rng, tr, live.sum()


def transmittance(media: Media, med_idx, o, d, t_max, rng: PCG32State,
                  max_steps: int = 512):
    """Medium::Tr over the media table (media.py:446-468): homogeneous
    analytic, grid lanes by ``tr_grid`` (which draws on every lane when the
    scene has a grid medium), 1 in vacuum.  Returns (rng, Tr (R,3),
    n_overflow)."""
    sigma_a, sigma_s, _, is_grid, in_medium = gather_medium(media, med_idx)
    tr = tr_homogeneous(sigma_a, sigma_s, d, t_max)
    if media.density.numel() > 1:
        rng, tr_g, n_overflow = tr_grid(media, sigma_a, sigma_s, o, d, t_max,
                                        rng, max_steps)
        tr = torch.where(is_grid[..., None], tr_g[..., None], tr)
    else:
        n_overflow = torch.zeros((), dtype=torch.int64, device=tr.device)
    return rng, torch.where(in_medium[..., None], tr, torch.ones_like(tr)), \
        n_overflow
