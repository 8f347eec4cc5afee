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
lookups where the scene has an image atlas.  Scenes the slice does not
render raise (``check_slice``: subsurface materials among them, so the
reference's BSSRDF branch is never needed).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.math import absdot, dot, offset_ray_origin
from ..core.rng import pcg32_init
from ..core.samplers import (make_sample_stream, make_stream_spec, stream_1d,
                             stream_camera_sample)
from ..core.spectrum import luminance
from ..lights import (area_light_emitted, escaped_radiance,
                      power_light_distribution, spatial_light_distribution)
from ..materials import MODE_RADIANCE, sample_bsdf
from ..media import gather_medium, hg_sample_p, sample_medium
from ..scene.camera import (Camera, generate_ray_differentials,
                            generate_rays_weighted, pixel_centers)
from ..scene.intersect import compute_uv_differentials, intersect
from ..scene.scene import Scene, check_slice
from .common import default_tr_crossings, sample_all_lights, sample_one_light

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
        bounces = bounces + (scattered | cont_surf).to(torch.int64)
        new_alive = alive & (scattered | is_boundary | cont_surf)
        new_alive = new_alive & (luminance(new_beta) > 0.0)
        new_alive = new_alive & (bounces < cfg.maxdepth)
        specular = torch.where(cont_surf, bs.specular, specular & is_boundary)
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
