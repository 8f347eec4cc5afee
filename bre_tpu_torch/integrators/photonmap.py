"""Two-pass photon mapping with classified photon maps (counterpart of
``bre_tpu/integrators/photonmap.py``; pbrt photonmap.{h,cpp}, compiled but
unregistered in the reference).

ShootPhotons (photonmap.cpp:616-908) deposits photons classified direct
(a depth-0 surface), caustic (after specular bounces only), indirect and
volume (a medium interaction).  The render estimates, as the reference
package does (the reference's own Li only counts volume photons):
surface radiance = NEE + the caustic and indirect density estimates
(pi r^2); volume radiance = a ray march through each medium segment
gathering the volume map ((4/3) pi r^3) weighted by the camera
transmittance.

The per-class kd-trees are one array sorted by the key (class, cell)
(a stable sort); a fixed-radius gather reads the 27 cells around a point
with ``searchsorted``.  The port gathers an (N, K) block of slots at once
and every march step of a segment together, where the reference loops
over slots and steps, so sums are added in another order (the counts are
the same).  Plain torch on the card: the reference runs no Pallas kernel
here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from ..core.math import absdot, dot, offset_ray_origin
from ..core.rng import pcg32_init, pcg32_next_f32
from ..core.sampling import sample_discrete
from ..core.spectrum import luminance
from ..lights import (area_light_emitted, escaped_radiance,
                      light_power_distribution, sample_le)
from ..materials import MODE_IMPORTANCE, MODE_RADIANCE, eval_bsdf, sample_bsdf
from ..media import gather_medium, hg_p, hg_sample_p, sample_medium
from ..scene.camera import Camera, generate_rays, pixel_centers
from ..scene.intersect import intersect
from ..scene.scene import Scene, check_slice, world_span
from .common import (NO_KEY, cell_range, default_tr_crossings,
                     sample_one_light, segment_transmittance_det, slot_blocks)

P_DIRECT = 0
P_INDIRECT = 1
P_CAUSTIC = 2
P_VOLUME = 3
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class PhotonMapConfig:
    """The reference's PhotonMapConfig, field for field (photonmap.py:53-71;
    CreatePhotonMapIntegrator, photonmap.cpp:1003+): one shooting budget,
    classified per deposit."""

    nphotons: int = 50_000
    maxdepth: int = 5
    maxdist: float = 0.2  # surface gather radius
    volume_maxdist: float = 0.2
    march_steps: int = 32  # volume ray-march steps per camera segment
    spp: int = 4
    max_photons_per_cell: int = 64
    finalgather: bool = False  # the reference's final gather is commented out
    # shadow-ray boundary crossings; None = resolve from the scene
    tr_crossings: Optional[int] = None


class PhotonMaps(NamedTuple):
    """The photons sorted by (class, cell) and their cell grid."""

    p: torch.Tensor  # (N,3)
    wi: torch.Tensor  # (N,3)
    power: torch.Tensor  # (N,3)
    pclass: torch.Tensor  # (N,) int64 P_*
    valid: torch.Tensor  # (N,)
    keys: torch.Tensor  # (N,) int64 sorted keys
    gmin: torch.Tensor  # (3,) grid origin
    cell: torch.Tensor  # () float32 cell size


def _cell_coords(p, gmin, cell):
    return torch.clamp(torch.floor((p - gmin) / cell).to(torch.int64), 0, 255)


def _key(pclass, c):
    return (pclass << 24) | (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]


def shoot_photons(scene: Scene, cfg: PhotonMapConfig, seed: int = 0
                  ) -> PhotonMaps:
    """ShootPhotons (photonmap.cpp:616-908; photonmap.py:93-208): photon i
    draws from ``RNG(i + seed * P + 1)``; each deposit is direct (a depth-0
    surface), caustic (a specular-only prefix), indirect, or volume (a
    medium interaction).  Returns the maps on the scene's device, powers
    divided by the photon count."""
    P = cfg.nphotons
    dev = scene.device
    distr = light_power_distribution(scene)
    rng = pcg32_init((torch.arange(P, dtype=torch.int64, device=dev)
                      + seed * P + 1) & _U32)
    rng, u_light = pcg32_next_f32(rng)
    light_num, light_pdf = sample_discrete(distr, u_light)
    rng, a0 = pcg32_next_f32(rng)
    rng, a1 = pcg32_next_f32(rng)
    rng, b0 = pcg32_next_f32(rng)
    rng, b1 = pcg32_next_f32(rng)
    rng, _ = pcg32_next_f32(rng)
    le = sample_le(scene, light_num, torch.stack([a0, a1], -1),
                   torch.stack([b0, b1], -1))
    denom = light_pdf * le.pdf_pos * le.pdf_dir
    beta = (absdot(le.n_light, le.d) / torch.clamp_min(denom, 1e-30))[:, None] * le.Le
    alive = (denom > 0.0) & (le.Le.sum(-1) > 0.0)
    span = world_span(scene)

    o, d, medium = le.o, le.d, le.medium
    specular_only = torch.ones((P,), dtype=torch.bool, device=dev)
    depth = torch.zeros((P,), dtype=torch.int64, device=dev)
    records = []
    for _ in range(cfg.maxdepth + 2):
        h = intersect(scene, o, d)
        t_lim = torch.clamp_max(torch.where(h.valid, h.t, span), span)
        h_p = o + t_lim[:, None] * d
        rng, ms, _ = sample_medium(scene.media, medium, o, d, t_lim, rng,
                                   early_exit=False)
        scattered = ms.sampled & alive & h.valid
        beta = torch.where((alive & h.valid)[:, None], beta * ms.weight, beta)
        surf = alive & h.valid & ~scattered
        is_boundary = surf & (h.material < 0)
        deposit_surf = surf & ~is_boundary
        pclass = torch.where(scattered, P_VOLUME, torch.where(
            depth == 0, P_DIRECT, torch.where(specular_only, P_CAUSTIC,
                                              P_INDIRECT)))
        p_med = o + ms.t[:, None] * d
        records.append((torch.where(scattered[:, None], p_med, h_p), -d, beta,
                        pclass, scattered | deposit_surf))

        rng, p0 = pcg32_next_f32(rng)
        rng, p1 = pcg32_next_f32(rng)
        _, _, g_here, _, _ = gather_medium(scene.media, medium)
        wi_phase, _ = hg_sample_p(-d, g_here, torch.stack([p0, p1], -1))
        rng, s0 = pcg32_next_f32(rng)
        rng, s1 = pcg32_next_f32(rng)
        bs = sample_bsdf(scene.materials, h.material, h.ns, -d,
                         torch.stack([s0, s1], -1), mode=MODE_IMPORTANCE)
        pdf_ok = bs.pdf > 1e-12
        one = torch.ones_like(bs.pdf)
        # CorrectShadingNormal for importance transport (bdpt.h:68-86)
        csn_num = absdot(-d, h.ns) * absdot(bs.wi, h.n)
        csn_den = torch.clamp_min(absdot(-d, h.n) * absdot(bs.wi, h.ns), 1e-12)
        csn = torch.where(pdf_ok, csn_num / csn_den, one)
        beta_surf = (beta * torch.where(pdf_ok[:, None], bs.f, 0.0)
                     * torch.where(pdf_ok, csn * absdot(bs.wi, h.ns)
                                   / torch.where(pdf_ok, bs.pdf, one),
                                   0.0)[:, None])
        entering = dot(d, h.n) < 0.0
        med_b = torch.where(entering, h.medium_inside, h.medium_outside)
        sc3, bd3 = scattered[:, None], is_boundary[:, None]
        new_o = torch.where(sc3, p_med, offset_ray_origin(
            h_p, h.n, torch.where(bd3, d, bs.wi)))
        new_d = torch.where(sc3, wi_phase, torch.where(bd3, d, bs.wi))
        new_beta = torch.where((deposit_surf & bs.valid)[:, None], beta_surf,
                               beta)
        medium = torch.where(scattered, medium, torch.where(
            is_boundary, med_b, torch.where(dot(bs.wi, h.n) > 0.0,
                                            h.medium_outside,
                                            h.medium_inside)))
        # Russian roulette (photonmap.cpp:~800)
        rng, u_rr = pcg32_next_f32(rng)
        lum_old = luminance(beta)
        ok_l = lum_old > 1e-20
        q = torch.clamp_min(1.0 - torch.where(ok_l, luminance(new_beta), 0.0)
                            / torch.where(ok_l, lum_old, one), 0.0)
        killed = deposit_surf & (u_rr < q)
        keep = deposit_surf & ~killed & (q < 1.0 - 1e-6)
        new_beta = torch.where(keep[:, None],
                               new_beta / torch.where(keep, 1.0 - q, one)[:, None],
                               new_beta)
        specular_only = specular_only & (scattered | is_boundary | bs.specular)
        depth = depth + (scattered | deposit_surf).to(torch.int64)
        alive = alive & (scattered | is_boundary
                         | (deposit_surf & bs.valid & ~killed))
        alive = alive & (new_beta.sum(-1) > 0.0) & (depth < cfg.maxdepth)
        beta, o, d = new_beta, new_o, new_d

    p_all, wi_all, pw, pc, pv = (torch.cat(list(f), 0) for f in zip(*records))
    cell = torch.tensor(max(cfg.maxdist, cfg.volume_maxdist),
                        dtype=torch.float32, device=dev)
    inf = torch.full_like(p_all, float("inf"))
    gmin = torch.where(pv[:, None], p_all, inf).amin(0)
    gmin = torch.where(torch.isfinite(gmin), gmin, 0.0)
    keys = torch.where(pv, _key(pc, _cell_coords(p_all, gmin, cell)), NO_KEY)
    keys, order = torch.sort(keys, stable=True)
    return PhotonMaps(p=p_all[order], wi=wi_all[order], power=pw[order] / P,
                      pclass=pc[order], valid=pv[order], keys=keys,
                      gmin=gmin, cell=cell)


def _range_gather(maps: PhotonMaps, pclass: int, x, radius, fn, K: int,
                  active=None):
    """Sum fn over the photons of ``pclass`` within ``radius`` of each x
    (photonmap.py:211-240): the 27 cells around x (clamped to the grid, as
    the reference does), K slots each.  ``fn(rows, wi (n,k,3), power
    (n,k,3))`` -> (n,k,3), rows indexing x.  Only points where ``active``
    holds are gathered (the others get 0).  Returns (acc (N,3), count (N,))."""
    Np, dev = x.shape[0], x.device
    N = maps.p.shape[0]
    base = _cell_coords(x - radius[:, None], maps.gmin, maps.cell)
    acc = torch.zeros((Np, 3), dtype=torch.float32, device=dev)
    count = torch.zeros((Np,), dtype=torch.int64, device=dev)
    r2 = radius * radius
    live = (torch.ones((Np,), dtype=torch.bool, device=dev) if active is None
            else active)
    for ox in range(3):
        for oy in range(3):
            for oz in range(3):
                c = torch.clamp(base + torch.tensor([ox, oy, oz], device=dev),
                                0, 255)
                lo, n_in = cell_range(maps.keys, _key(pclass, c))
                for rr, j, ok in slot_blocks(lo, n_in, live, K, N):
                    diff = x[rr][:, None, :] - maps.p[j]
                    ok = (ok & maps.valid[j]
                          & (dot(diff, diff) <= r2[rr][:, None]))
                    f = fn(rr, maps.wi[j], maps.power[j])
                    acc[rr] += torch.where(ok[..., None], f, 0.0).sum(1)
                    count[rr] += ok.sum(1)
    return acc, count


def _one_pass(scene: Scene, camera: Camera, width: int, height: int,
              maps: PhotonMaps, sample_idx: int, cfg: PhotonMapConfig):
    """One sample per pixel (photonmap.py:258-356): pixel i draws from
    ``RNG(sample * R + i + 0x9A90)``.  Returns L (R,3)."""
    R = width * height
    dev = scene.device
    f32 = dict(dtype=torch.float32, device=dev)
    zero = torch.zeros((), **f32)
    S = cfg.march_steps
    vmax = cfg.volume_maxdist
    K = cfg.max_photons_per_cell
    pix = torch.arange(R, dtype=torch.int64, device=dev)
    rng = pcg32_init((sample_idx * R + pix + 0x9A90) & _U32)
    rng, jx = pcg32_next_f32(rng)
    rng, jy = pcg32_next_f32(rng)
    o, d = generate_rays(camera, pixel_centers(width, height, dev)
                         + torch.stack([jx, jy], -1) - 0.5)
    beta = torch.ones((R, 3), **f32)
    medium = scene.camera_medium.expand(R).clone()
    alive = torch.ones((R,), dtype=torch.bool, device=dev)
    first = torch.ones_like(alive)
    specular = torch.zeros_like(alive)
    L = torch.zeros((R, 3), **f32)
    span = world_span(scene)
    steps = torch.arange(S, **f32) + 0.5

    for _ in range(cfg.maxdepth + 2):
        h = intersect(scene, o, d)
        miss = alive & ~h.valid
        L = L + torch.where(miss[:, None], beta * escaped_radiance(scene, d),
                            zero)
        t_seg = torch.clamp_max(h.t, span)
        h_p = o + t_seg[:, None] * d

        # volume: march the segment through the volume map, every step
        # gathered at once (photonmap.py:281-305)
        sigma_a_m, sigma_s_m, g_m, _, in_med = gather_medium(scene.media,
                                                             medium)
        seg_live = alive & h.valid & in_med
        dt = t_seg / S
        sigma_t = (sigma_a_m + sigma_s_m)[:, 0]
        t_k = steps[None, :] * dt[:, None]  # (R, S)
        xs = (o[:, None, :] + t_k[..., None] * d[:, None, :]).reshape(-1, 3)
        ray = torch.arange(R, device=dev).repeat_interleave(S)

        def f_vol(rows, wi_j, pw_j):
            r = ray[rows]
            return hg_p(-d[r][:, None, :], wi_j, g_m[r][:, None])[..., None] * pw_j

        Sv, _ = _range_gather(maps, P_VOLUME, xs,
                              torch.full((R * S,), vmax, **f32), f_vol, K,
                              active=seg_live.repeat_interleave(S))
        Sv = Sv.reshape(R, S, 3) / ((4.0 / 3.0) * math.pi * vmax ** 3)
        tr = torch.exp(-sigma_t[:, None] * t_k)[..., None]
        march = (beta[:, None, :] * tr * Sv * dt[:, None, None]).sum(1)
        L = L + torch.where(seg_live[:, None], march, zero)

        beta = beta * segment_transmittance_det(scene, medium, o, d, t_seg)
        surf = alive & h.valid
        is_boundary = surf & (h.material < 0)
        real = surf & ~is_boundary
        see_le = surf & (first | specular)
        L = L + torch.where(see_le[:, None], beta * area_light_emitted(
            scene, h.area_light, h.n, -d), zero)
        rng, nee = sample_one_light(scene, rng, h_p, h.ns, -d, h.material,
                                    medium, torch.ones_like(alive),
                                    tr_crossings=cfg.tr_crossings or 0)
        L = L + torch.where(real[:, None], beta * nee, zero)

        # surface: caustic + indirect density estimates (pi r^2)
        def f_surf(rows, wi_j, pw_j):
            n, k = wi_j.shape[:2]
            rep = lambda x: x[rows].repeat_interleave(k, 0)  # noqa: E731
            f, _ = eval_bsdf(scene.materials, rep(h.material), rep(h.ns),
                             rep(-d), wi_j.reshape(n * k, 3))
            return f.reshape(n, k, 3) * pw_j

        rad = torch.full((R,), cfg.maxdist, **f32)
        est = torch.zeros((R, 3), **f32)
        for cls in (P_CAUSTIC, P_INDIRECT):
            e, _ = _range_gather(maps, cls, h_p, rad, f_surf, K, active=real)
            est = est + e
        est = est / (math.pi * cfg.maxdist ** 2)
        L = L + torch.where(real[:, None], beta * est, zero)

        # specular continuation only: diffuse indirect comes from the map
        rng, s0 = pcg32_next_f32(rng)
        rng, s1 = pcg32_next_f32(rng)
        bs = sample_bsdf(scene.materials, h.material, h.ns, -d,
                         torch.stack([s0, s1], -1), mode=MODE_RADIANCE)
        cont = real & bs.valid & bs.specular
        pdf_ok = cont & (bs.pdf > 1e-12)
        beta = torch.where(pdf_ok[:, None], beta * bs.f * (
            absdot(bs.wi, h.ns) / torch.where(pdf_ok, bs.pdf,
                                               torch.ones_like(bs.pdf)))[:, None],
            beta)
        entering = dot(d, h.n) < 0.0
        med_b = torch.where(entering, h.medium_inside, h.medium_outside)
        o = torch.where(surf[:, None], offset_ray_origin(
            h_p, h.n, torch.where(is_boundary[:, None], d, bs.wi)), o)
        new_d = torch.where(cont[:, None], bs.wi, d)
        medium = torch.where(is_boundary, med_b, torch.where(
            cont & (dot(bs.wi, h.n) > 0.0), h.medium_outside,
            torch.where(cont, h.medium_inside, medium)))
        specular = torch.where(cont, bs.specular, specular & is_boundary)
        first = first & is_boundary
        alive = alive & (is_boundary | cont)
        d = new_d
    return L


def render_photonmap(scene: Scene, camera: Camera, width: int, height: int,
                     cfg: PhotonMapConfig = PhotonMapConfig()):
    """The two-pass render (photonmap.py:243-372) on the scene's device:
    shoot the maps, then ``spp`` passes added in sample order.  Returns
    (image (H, W, 3), stats with the valid photons of each class)."""
    check_slice(scene)
    if cfg.tr_crossings is None:
        cfg = dataclasses.replace(cfg, tr_crossings=default_tr_crossings(scene))
    R = width * height
    maps = shoot_photons(scene, cfg)
    acc = torch.zeros((R, 3), dtype=torch.float32, device=scene.device)
    for s in range(cfg.spp):
        acc = acc + _one_pass(scene, camera, width, height, maps, s, cfg)
    img = (acc / cfg.spp).reshape(height, width, 3)
    counts = {name: int(((maps.pclass == c) & maps.valid).sum())
              for name, c in (("direct", P_DIRECT), ("indirect", P_INDIRECT),
                              ("caustic", P_CAUSTIC), ("volume", P_VOLUME))}
    return img, dict(photon_counts=counts)
