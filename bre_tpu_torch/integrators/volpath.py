"""The volumetric path tracer, the photon-beam estimator's oracle
(counterpart of ``bre_tpu/integrators/volpath.py``; pbrt
volpath.cpp:55-160).

Per bounce: intersect; Medium::Sample; at a medium interaction, next-event
estimation with the phase function and a phase-sampled continuation; at a
surface, next-event estimation with the BSDF and a BSDF-sampled
continuation; Russian roulette past the third bounce.  The camera paths
walk ``maxdepth + 2`` steps in lockstep on per-pixel, per-sample streams
(the reference's ``lax.scan`` over steps is a Python loop here); where the
reference runs one pass per sample, several samples' passes walk together
as one batch, since a walk launches a few hundred small kernels per step
whatever its width.  Grid media take the fixed-trip delta tracking
(``sample_medium(early_exit=False)``), as the reference's volpath does.

Ported: ``indirect`` "full" and "specular", ``samplealllights``,
``nee_mis``, ``maxsampleluminance``, ``tr_crossings``, the light-pick
strategies "uniform", "power" and "spatial" (``lights.
spatial_light_distribution``), every sampler of ``core/samplers``
(random, stratified, 02sequence, sobol, maxmindist, halton), and
``texture_filter``: ray differentials at the first hits and EWA image-map
lookups where the scene has an image atlas.  Subsurface and kdsubsurface
materials take the reference's BSSRDF branch on transmission events
(``_bssrdf_exit``, ``_bssrdf_nee``): an exit point by a probe segment with
a fixed chain of ``_BSSRDF_CHAIN_K`` re-intersections, next-event
estimation there with the adapter BSDF, and a cosine-sampled
continuation.  The branch and its draws run where the material table
holds those tags, as the reference's static guard decides.  The camera
rays take the lens samples (thin lens, realistic camera), and a realistic
camera's vignetted rays weigh 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

import math

from ..bssrdf import (bssrdf_sample_sr, bssrdf_sr, pdf_sp, sw_factor)
from ..core.math import (absdot, coordinate_system, dot, face_forward,
                         length, offset_ray_origin)
from ..core.sampling import cosine_sample_hemisphere
from ..core.rng import pcg32_init
from ..core.samplers import (make_sample_stream, make_stream_spec, stream_1d,
                             stream_camera_sample)
from ..core.spectrum import luminance
from ..lights import (area_light_emitted, escaped_radiance,
                      power_light_distribution, sample_li,
                      spatial_light_distribution)
from ..materials import MODE_RADIANCE, sample_bsdf
from ..media import gather_medium, hg_sample_p, sample_medium
from ..scene.camera import (Camera, generate_ray_differentials,
                            generate_rays_weighted, pixel_centers)
from ..scene.intersect import (compute_uv_differentials, intersect,
                               intersect_p)
from ..scene.scene import (MAT_KDSUBSURFACE, MAT_SUBSURFACE, Scene,
                           check_slice)
from .common import (default_tr_crossings, sample_all_lights,
                     sample_one_light, segment_transmittance_det)

_U32 = 0xFFFFFFFF
# lanes per batch of sample passes: at most this many camera paths (whole
# samples of the film) walk together
SAMPLE_LANES = 1 << 18


@dataclasses.dataclass(frozen=True)
class VolPathConfig:
    """The reference's VolPathConfig, field for field (volpath.py:38-81)."""

    maxdepth: int = 5
    spp: int = 16
    rrthreshold: float = 1.0  # volpath.cpp rrThreshold
    # "full": path/volpath; "specular": whitted/directlighting semantics
    # (specular continuations only, direct lighting at every hit)
    indirect: str = "full"
    # the sampler behind every dimension (core/samplers.KINDS)
    sampler: str = "random"
    # ray differentials + EWA image-map filtering at the first hits
    texture_filter: bool = False
    # Film "maxsampleluminance": per-sample luminance clamp (film.h:121)
    maxsampleluminance: float = float("inf")
    # NEE light pick: "uniform", "power" or "spatial" (lightdistrib.cpp)
    lightsamplestrategy: str = "uniform"
    # NEE against every light (UniformSampleAllLights)
    samplealllights: bool = False
    # EstimateDirect's two-sample MIS instead of light sampling only
    nee_mis: bool = False
    # shadow-ray boundary crossings; None = resolve from the scene
    tr_crossings: Optional[int] = None


def _check_config(cfg: VolPathConfig) -> None:
    if cfg.indirect not in ("full", "specular"):
        raise ValueError(f"unknown indirect mode {cfg.indirect!r}")
    if cfg.lightsamplestrategy not in ("uniform", "power", "spatial"):
        raise ValueError(
            f"unknown lightsamplestrategy {cfg.lightsamplestrategy!r}")


# the probe segment's intersection chain (bssrdf.cpp:296-313 keeps an
# unbounded list; four hits cover a convex object's front and back and two
# more), volpath.py:83
_BSSRDF_CHAIN_K = 4


def has_bssrdf(scene: Scene) -> bool:
    """Whether the material table holds a subsurface material: the BSSRDF
    branch and its draws run then (materials.py:72-82)."""
    kinds = scene.materials.kinds
    return bool(kinds[MAT_SUBSURFACE]) or bool(kinds[MAT_KDSUBSURFACE])


def _bssrdf_exit(scene: Scene, rng, active, po_p, ns, mi):
    """The BSSRDF's exit point (SeparableBSSRDF::Sample_Sp, bssrdf.cpp:
    247-325; volpath.py:84-174): a projection axis and a channel, a
    profile radius, then the probe segment re-intersected ``_BSSRDF_CHAIN_K``
    times, keeping hits on the same material; one of them picked.
    Returns (rng, dict(ok, p, n, medium, weight = Sp / pdf))."""
    R = po_p.shape[0]
    mats = scene.materials
    tables = mats.bss_tables
    sig_a = mats.bss_sigma_a[mi]
    sig_s = mats.bss_sigma_s[mi]
    sigma_t = sig_a + sig_s
    rho = torch.where(sigma_t > 0, sig_s / torch.where(
        sigma_t == 0, torch.ones_like(sigma_t), sigma_t),
        torch.zeros_like(sigma_t))
    tidx = mats.bss_table[mi]
    ss, ts = coordinate_system(ns)
    rng, u1 = stream_1d(rng)
    rng, u2a = stream_1d(rng)
    rng, u2b = stream_1d(rng)

    # the projection axis, .5/.25/.25 toward the normal (bssrdf.cpp:251-270)
    c_n = (u1 < 0.5)[:, None]
    c_s = ((u1 >= 0.5) & (u1 < 0.75))[:, None]
    vx = torch.where(c_n, ss, torch.where(c_s, ts, ns))
    vy = torch.where(c_n, ts, torch.where(c_s, ns, ss))
    vz = torch.where(c_n, ns, torch.where(c_s, ss, ts))
    u1 = torch.where(c_n[:, 0], u1 * 2.0, torch.where(
        c_s[:, 0], (u1 - 0.5) * 4.0, (u1 - 0.75) * 4.0))
    # the channel (bssrdf.cpp:272-274)
    ch = torch.clamp((u1 * 3.0).to(torch.int64), 0, 2)
    u1 = u1 * 3.0 - ch.to(torch.float32)
    st_ch = torch.gather(sigma_t, 1, ch[:, None])[:, 0]
    rho_ch = torch.gather(rho, 1, ch[:, None])[:, 0]
    r = bssrdf_sample_sr(tables, tidx, st_ch, rho_ch, u2a)
    r_max = bssrdf_sample_sr(tables, tidx, st_ch, rho_ch,
                             torch.full_like(u2a, 0.999))
    ok = active & (r >= 0.0) & (r < r_max) & (r_max > 0.0)
    phi = 2.0 * math.pi * u2b
    half_l = torch.sqrt(torch.clamp_min(r_max * r_max - r * r, 0.0))
    cur_o = (po_p + r[:, None] * (vx * torch.cos(phi)[:, None]
                                  + vy * torch.sin(phi)[:, None])
             - half_l[:, None] * vz)

    # the intersection chain (bssrdf.cpp:290-313), K fixed steps
    remaining = 2.0 * half_l
    chain_alive = ok
    ps, nns, meds, match = [], [], [], []
    for _ in range(_BSSRDF_CHAIN_K):
        h = intersect(scene, cur_o, vz, t_max=torch.clamp_min(remaining, 0.0))
        hit_ok = chain_alive & h.valid & (h.t < remaining)
        hp = cur_o + h.t[:, None] * vz
        ps.append(hp)
        nns.append(h.n)
        meds.append(h.medium_outside)
        match.append(hit_ok & (h.material == mi))
        cur_o = torch.where(hit_ok[:, None], offset_ray_origin(hp, h.n, vz),
                            cur_o)
        remaining = torch.where(hit_ok, remaining - h.t, remaining)
        chain_alive = hit_ok
    match = torch.stack(match, 0).to(torch.int64)  # (K, R)
    n_found = match.sum(0)
    selected = torch.minimum(
        torch.clamp_min((u1 * n_found.to(torch.float32)).to(torch.int64), 0),
        torch.clamp_min(n_found - 1, 0))
    rank = torch.cumsum(match, 0) - match
    sel = (match > 0) & (rank == selected[None, :])  # (K, R) one-hot
    selw = sel.to(torch.float32)[:, :, None]
    pi_p = (selw * torch.stack(ps, 0)).sum(0)
    pi_n = (selw * torch.stack(nns, 0)).sum(0)
    pi_med = torch.where(sel, torch.stack(meds, 0),
                         torch.zeros_like(match)).sum(0)
    ok = ok & (n_found > 0)
    # the pdf of this combination of strategies over nFound (:316-324)
    pdf = pdf_sp(tables, tidx, sigma_t, rho, po_p - pi_p, pi_n, ss, ts, ns)
    pdf = pdf / torch.clamp_min(n_found.to(torch.float32), 1.0)
    sp = bssrdf_sr(tables, tidx, sigma_t, rho, length(po_p - pi_p))
    ok = ok & (pdf > 1e-12) & (sp.sum(-1) > 0.0)
    weight = torch.where(ok[:, None], sp / torch.where(
        ok, pdf, torch.ones_like(pdf))[:, None], torch.zeros_like(sp))
    return rng, dict(ok=ok, p=pi_p, n=pi_n, medium=pi_med, weight=weight)


def _bssrdf_nee(scene: Scene, rng, p, n, eta, med_idx):
    """Next-event estimation at the BSSRDF's exit point with the
    SeparableBSSRDFAdapter BSDF, f = Sw(wi) eta^2 (bssrdf.h:162-180;
    volpath.py:177-202): one light picked uniformly."""
    R = p.shape[0]
    n_lights = scene.n_lights
    if n_lights == 0:
        return rng, torch.zeros((R, 3), dtype=torch.float32, device=p.device)
    rng, u_pick = stream_1d(rng)
    light_idx = torch.clamp_max((u_pick * n_lights).to(torch.int64),
                                n_lights - 1)
    rng, ua = stream_1d(rng)
    rng, ub = stream_1d(rng)
    ls = sample_li(scene, light_idx, p, torch.stack([ua, ub], -1))
    cos_i = dot(ls.wi, n)
    f = (sw_factor(eta, cos_i) * eta * eta * torch.clamp_min(cos_i, 0.0)
         )[:, None]
    o_shadow = offset_ray_origin(p, n, ls.wi)
    t_shadow = ls.dist * (1.0 - 1e-3)
    occluded = intersect_p(scene, o_shadow, ls.wi, t_shadow)
    tr = segment_transmittance_det(scene, med_idx, o_shadow, ls.wi, t_shadow)
    ok = ~occluded & (ls.pdf > 1e-12) & (cos_i > 0.0)
    contrib = f * ls.Li * tr / torch.where(ok, ls.pdf,
                                           torch.ones_like(ls.pdf))[:, None]
    return rng, torch.where(ok[:, None], contrib,
                            torch.zeros_like(contrib)) * float(n_lights)


def light_distribution(scene: Scene, strategy: str):
    """The NEE light-pick table of a strategy (volpath.py:450-470): None
    for "uniform" (and for a scene without lights)."""
    if scene.n_lights == 0 or strategy == "uniform":
        return None
    if strategy == "spatial":
        return spatial_light_distribution(scene)
    return power_light_distribution(scene)


def _li_batch(scene: Scene, o, d, rng, cfg: VolPathConfig,
              light_distrib=None, diffs=None):
    """Radiance along a batch of camera rays (volpath.py:205-428).
    ``diffs``: the camera rays' differentials (rx_o, rx_d, ry_o, ry_d),
    for EWA texture footprints at the first hits.  Returns (rng, L (R,3))."""
    R = o.shape[0]
    dev = o.device
    k_tr = cfg.tr_crossings or 0
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def nee(rng, p, n, wo, mat_idx, med_idx, is_surface, **kw):
        if cfg.samplealllights:
            return sample_all_lights(scene, rng, p, n, wo, mat_idx, med_idx,
                                     is_surface, tr_crossings=k_tr,
                                     mis=cfg.nee_mis, **kw)
        return sample_one_light(scene, rng, p, n, wo, mat_idx, med_idx,
                                is_surface, tr_crossings=k_tr,
                                mis=cfg.nee_mis, light_distrib=light_distrib,
                                **kw)

    beta = torch.ones((R, 3), dtype=torch.float32, device=dev)
    medium = scene.camera_medium.expand(R).clone()
    alive = torch.ones((R,), dtype=torch.bool, device=dev)
    specular = torch.zeros((R,), dtype=torch.bool, device=dev)
    first = torch.ones((R,), dtype=torch.bool, device=dev)
    L = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    bounces = torch.zeros((R,), dtype=torch.int64, device=dev)
    no_mat = torch.full((R,), -1, dtype=torch.int64, device=dev)
    all_surf = torch.ones((R,), dtype=torch.bool, device=dev)
    bssrdf = has_bssrdf(scene)

    for _ in range(cfg.maxdepth + 2):
        h = intersect(scene, o, d)
        t_lim = torch.where(h.valid, h.t, torch.full_like(h.t, 1e6))
        # a finite hit point for the 1e30 miss sentinel
        h_p = o + torch.clamp_max(h.t, 1e6)[:, None] * d

        rng, ms, _ = sample_medium(scene.media, medium, o, d, t_lim, rng,
                                   early_exit=False)
        scattered = ms.sampled & alive
        beta = torch.where(alive[:, None], beta * ms.weight, beta)

        # medium interaction (volpath.cpp:88-107)
        p_med = o + ms.t[:, None] * d
        rng, nee_med = nee(rng, p_med, torch.zeros_like(d), -d, no_mat,
                           medium, ~all_surf)
        L = L + torch.where(scattered[:, None], beta * nee_med, zero)
        rng, p0 = stream_1d(rng)
        rng, p1 = stream_1d(rng)
        _, _, g_here, _, _ = gather_medium(scene.media, medium)
        wi_phase, _ = hg_sample_p(-d, g_here, torch.stack([p0, p1], -1))

        # escaped (volpath.cpp:112-120)
        miss = alive & ~scattered & ~h.valid
        see_inf = miss & (first | specular)
        L = L + torch.where(see_inf[:, None],
                            beta * escaped_radiance(scene, d), zero)

        # surface interaction (volpath.cpp:109-149); Le before the
        # null-BSDF check (volpath.cpp:112-120)
        surf = alive & ~scattered & h.valid
        is_boundary = surf & (h.material < 0)
        entering = dot(d, h.n) < 0.0
        medium_after_boundary = torch.where(entering, h.medium_inside,
                                            h.medium_outside)
        see_le = surf & (first | specular)
        Le = area_light_emitted(scene, h.area_light, h.n, -d)
        L = L + torch.where(see_le[:, None], beta * Le, zero)
        # texture footprints at first camera hits, zero past them, as
        # pbrt differentiates camera rays only (volpath.py:283-294)
        duv_dx = duv_dy = None
        if diffs is not None:
            duv_dx, duv_dy = compute_uv_differentials(scene, h, o, d, *diffs)
            fm = (first & surf)[:, None]
            duv_dx = torch.where(fm, duv_dx, torch.zeros_like(duv_dx))
            duv_dy = torch.where(fm, duv_dy, torch.zeros_like(duv_dy))
        tex = dict(uv=h.uv, duv_dx=duv_dx, duv_dy=duv_dy)
        rng, nee_surf = nee(rng, h_p, h.ns, -d, h.material, medium, all_surf,
                            tangent=h.tangent, **tex)
        L = L + torch.where((surf & ~is_boundary)[:, None], beta * nee_surf,
                            zero)

        rng, s0 = stream_1d(rng)
        rng, s1 = stream_1d(rng)
        bs = sample_bsdf(scene.materials, h.material, h.ns, -d,
                         torch.stack([s0, s1], -1), mode=MODE_RADIANCE,
                         textures=scene.textures, p=h_p, tangent=h.tangent,
                         **tex)
        cont_surf = surf & ~is_boundary & bs.valid
        if cfg.indirect == "specular":
            cont_surf = cont_surf & bs.specular
        pdf_ok = cont_surf & (bs.pdf > 1e-12)
        one = torch.ones_like(bs.pdf)
        beta_surf = (
            beta * torch.where(pdf_ok[:, None], bs.f, zero)
            * torch.where(pdf_ok, absdot(bs.wi, h.ns)
                          / torch.where(pdf_ok, bs.pdf, one), zero)[:, None])

        # the continuation
        sc3, bd3 = scattered[:, None], is_boundary[:, None]
        new_o = torch.where(sc3, p_med, offset_ray_origin(
            h_p, h.n, torch.where(bd3, d, bs.wi)))
        new_d = torch.where(sc3, wi_phase, torch.where(bd3, d, bs.wi))
        new_beta = torch.where(cont_surf[:, None], beta_surf, beta)
        new_medium = torch.where(scattered, medium, torch.where(
            is_boundary, medium_after_boundary, torch.where(
                cont_surf & (dot(bs.wi, h.n) > 0.0), h.medium_outside,
                torch.where(cont_surf, h.medium_inside, medium))))

        # the BSSRDF: subsurface transport on transmission events
        # (path.cpp:153-170; volpath.py:351-395)
        sss_ok = sss_failed = None
        if bssrdf:
            mats = scene.materials
            mi_s = torch.clamp(h.material, 0, mats.mtype.shape[0] - 1)
            mt_s = mats.mtype[mi_s]
            transmitted = dot(bs.wi, h.n) * dot(-d, h.n) < 0.0
            is_sss = (cont_surf & ((mt_s == MAT_SUBSURFACE)
                                   | (mt_s == MAT_KDSUBSURFACE))
                      & transmitted)
            eta_s = mats.eta[mi_s]
            rng, probe = _bssrdf_exit(scene, rng, is_sss, h_p,
                                      face_forward(h.n, -d), mi_s)
            sss_ok = is_sss & probe["ok"]
            sss_failed = is_sss & ~probe["ok"]
            beta_sss = new_beta * probe["weight"]
            rng, nee_sss = _bssrdf_nee(scene, rng, probe["p"], probe["n"],
                                       eta_s, probe["medium"])
            ok3 = sss_ok[:, None]
            L = L + torch.where(ok3, beta_sss * nee_sss, zero)
            # the continuation: the adapter cosine-sampled, f cos / pdf =
            # pi Sw
            rng, q0 = stream_1d(rng)
            rng, q1 = stream_1d(rng)
            wl = cosine_sample_hemisphere(torch.stack([q0, q1], -1))
            bx, by = coordinate_system(probe["n"])
            wi_sss = (wl[:, 0:1] * bx + wl[:, 1:2] * by
                      + wl[:, 2:3] * probe["n"])
            sw = sw_factor(eta_s, torch.clamp_min(wl[:, 2], 0.0))
            beta_sss = beta_sss * (math.pi * sw * eta_s * eta_s)[:, None]
            new_o = torch.where(ok3, offset_ray_origin(
                probe["p"], probe["n"], wi_sss), new_o)
            new_d = torch.where(ok3, wi_sss, new_d)
            new_beta = torch.where(ok3, beta_sss, new_beta)
            new_medium = torch.where(sss_ok, probe["medium"], new_medium)
        bounces = bounces + (scattered | cont_surf).to(torch.int64)
        new_alive = alive & (scattered | is_boundary | cont_surf)
        if sss_failed is not None:
            new_alive = new_alive & ~sss_failed
        new_alive = new_alive & (luminance(new_beta) > 0.0)
        new_alive = new_alive & (bounces < cfg.maxdepth)
        specular = torch.where(cont_surf, bs.specular, specular & is_boundary)
        if sss_ok is not None:
            specular = specular & ~sss_ok  # the exit lobe is diffuse
        first = first & is_boundary

        # Russian roulette past three bounces (volpath.cpp:150-158)
        rng, u_rr = stream_1d(rng)
        y = luminance(new_beta)
        do_rr = new_alive & (y < cfg.rrthreshold) & (bounces > 3)
        q = torch.clamp_min(1.0 - y, 0.05)
        killed = do_rr & (u_rr < q)
        keep = do_rr & ~killed & (q < 1.0 - 1e-6)
        new_beta = torch.where(
            keep[:, None],
            new_beta / torch.where(keep, 1.0 - q, torch.ones_like(q))[:, None],
            new_beta)
        o, d, beta, medium = new_o, new_d, new_beta, new_medium
        alive = new_alive & ~killed
    return rng, L


def render_volpath(scene: Scene, camera: Camera, width: int, height: int,
                   cfg: VolPathConfig = VolPathConfig()) -> torch.Tensor:
    """Render ``cfg.spp`` jittered samples per pixel (volpath.py:431-506):
    sample s of pixel i draws from ``RNG(s * R + i + 0x9E37)``, film
    jitter, time and lens first (GetCameraSample).  The reference runs one
    pass of R lanes per sample; here up to ``SAMPLE_LANES`` lanes (several
    samples' passes) walk together, which changes no lane's arithmetic, and
    the samples are added to the film in sample order, as there.  Returns
    the (H, W, 3) image on the scene's device."""
    _check_config(cfg)
    check_slice(scene)
    if cfg.tr_crossings is None:
        cfg = dataclasses.replace(cfg, tr_crossings=default_tr_crossings(scene))
    dev = scene.device
    R = width * height
    pix = pixel_centers(width, height, dev)
    spec = make_stream_spec(cfg.sampler, width, height, cfg.spp)
    light_distrib = light_distribution(scene, cfg.lightsamplestrategy)
    # EWA texture filtering needs ray differentials and an image atlas
    use_diffs = bool(cfg.texture_filter) and scene.textures.atlas.shape[0] > 1
    pix_idx = torch.arange(R, dtype=torch.int64, device=dev)
    per_batch = max(1, min(cfg.spp, SAMPLE_LANES // R))
    acc = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    for s0 in range(0, cfg.spp, per_batch):
        n = min(per_batch, cfg.spp - s0)
        samp = torch.arange(s0, s0 + n, dtype=torch.int64, device=dev)
        lane_pix = pix_idx.repeat(n)
        lane_samp = samp.repeat_interleave(R)
        raw = pcg32_init((lane_samp * R + lane_pix + 0x9E37) & _U32)
        rng = make_sample_stream(spec, lane_pix, lane_pix % width,
                                 lane_pix // width, lane_samp, raw)
        rng, j2, _time, u_lens = stream_camera_sample(rng)
        p_raster = pix.repeat(n, 1) + j2 - 0.5
        diffs = None
        if use_diffs:
            o, d, w_cam, *diffs = generate_ray_differentials(camera, p_raster,
                                                             u_lens)
        else:
            o, d, w_cam = generate_rays_weighted(camera, p_raster, u_lens)
        _, L = _li_batch(scene, o, d, rng, cfg, light_distrib, diffs)
        if cfg.maxsampleluminance != float("inf"):
            # Film::AddSample's per-sample clamp (film.h:~125)
            y = 0.212671 * L[:, 0] + 0.715160 * L[:, 1] + 0.072169 * L[:, 2]
            f = torch.where(y > cfg.maxsampleluminance,
                            cfg.maxsampleluminance / torch.clamp_min(y, 1e-30),
                            torch.ones_like(y))
            L = L * f[:, None]
        Lw = (L * w_cam[:, None]).reshape(n, R, 3)
        for k in range(n):
            acc = acc + Lw[k]
    return (acc / cfg.spp).reshape(height, width, 3)
