"""Volumetric SPPM: stochastic progressive photon mapping with medium
visible points (counterpart of ``bre_tpu/integrators/vsppm.py``; the fork's
vsppm.{h,cpp}, registered ``"vsppm"``, api.cpp:1459-1460).

Per iteration (vsppm.cpp:187-657):
  A. camera pass: a visible point per pixel, at the first diffuse surface
     or sampled medium scatter (specular surfaces continue), and Ld;
  B. a grid over the photon interactions, cell = the largest radius;
  C. photon pass: every photon interaction within a visible point's
     radius, of the point's kind, adds beta * f(wo, wi) (surface) or
     beta * phase(wo, wi) (medium);
  D. the SPPM update, gamma = 2/3; E. the image Ld/(i+1) + tau/(Np k(r)).

The reference's lock-free grid becomes the reference package's gather:
photon interactions sorted by cell key (a stable sort: the per-cell cap K
keeps photons by their position in the cell), each visible point reads the
27 cells its radius ball can overlap with ``searchsorted``.  Where the
reference walks the K slots of a cell in a loop, the port gathers an
(R, K) block at once and sums over K, so Phi is added in another order
(the counts are the same).  Plain torch on the card: the reference runs no
Pallas kernel here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from ..core.math import absdot, dot, offset_ray_origin
from ..core.rng import pcg32_init, pcg32_next_f32
from ..core.samplers import halton_next_1d, halton_next_2d, halton_stream_init
from ..core.sampling import sample_discrete
from ..core.spectrum import luminance
from ..lights import (area_light_emitted, escaped_radiance,
                      light_power_distribution, sample_le)
from ..materials import MODE_IMPORTANCE, MODE_RADIANCE, eval_bsdf, sample_bsdf
from ..media import gather_medium, hg_p, hg_sample_p, sample_medium
from ..scene.camera import Camera, generate_rays, pixel_centers
from ..scene.intersect import intersect
from ..scene.scene import MAT_MATTE, Scene, check_slice, world_span
from .common import (NO_KEY, cell_range, default_tr_crossings,
                     sample_one_light, segment_transmittance_det, slot_blocks)

VP_NONE = -1
VP_SURFACE = 0
VP_MEDIUM = 1
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class VSPPMConfig:
    """The reference's VSPPMConfig, field for field (vsppm.py:62-87;
    CreateVolSPPMIntegrator, vsppm.cpp:661-678).

    ``kernel="compat"`` reproduces the C++ reference with its three quirks:
    medium visible points take the surface pi r^2 kernel; depth-0 medium
    interactions splat into medium visible points (single scatter counted
    twice); photons die at their first medium interaction (its Russian
    roulette reads ``bnew``, never assigned there, vsppm.cpp:466-500,
    562-564).  ``"physical"`` takes the (4/3) pi r^3 sigma_s volume kernel,
    splats medium interactions past depth 0 only, and continues photons
    through medium scatters."""

    iterations: int = 64
    maxdepth: int = 5
    photonsperiteration: int = -1  # -1: one per pixel
    imagewritefrequency: int = 1 << 31
    radius: float = 1.0  # initial search radius
    rendersurfaces: bool = True
    rendermedia: bool = True
    max_photons_per_cell: int = 64  # gather cap per cell (overflow counted)
    # shadow-ray boundary crossings; None = resolve from the scene
    tr_crossings: Optional[int] = None
    kernel: str = "physical"  # "physical" | "compat"


class VisiblePoints(NamedTuple):
    p: torch.Tensor  # (R,3)
    wo: torch.Tensor  # (R,3)
    beta: torch.Tensor  # (R,3)
    kind: torch.Tensor  # (R,) int64 VP_*
    material: torch.Tensor  # (R,) surface VP material id
    n: torch.Tensor  # (R,3) surface VP shading normal
    g: torch.Tensor  # (R,) medium VP HG g
    sigma_s: torch.Tensor  # (R,3) medium VP scattering coefficient


class PhotonInteractions(NamedTuple):
    p: torch.Tensor  # (I,3)
    wi: torch.Tensor  # (I,3) = -photon direction
    beta: torch.Tensor  # (I,3)
    kind: torch.Tensor  # (I,) VP_SURFACE / VP_MEDIUM
    depth: torch.Tensor  # (I,) photon path depth at the interaction
    valid: torch.Tensor  # (I,)


def _camera_pass(scene: Scene, camera: Camera, width: int, height: int,
                 iter_idx: int, cfg: VSPPMConfig):
    """Phase A (vsppm.cpp:220-357; vsppm.py:101-251): pixel i draws from
    ``RNG(iter * R + i + 0xA11CE)``.  Returns (Ld_add (R,3), VisiblePoints)."""
    R = width * height
    dev = scene.device
    f32 = dict(dtype=torch.float32, device=dev)
    zero = torch.zeros((), **f32)
    k_tr = cfg.tr_crossings or 0
    pix = torch.arange(R, dtype=torch.int64, device=dev)
    rng = pcg32_init((iter_idx * R + pix + 0xA11CE) & _U32)
    rng, jx = pcg32_next_f32(rng)
    rng, jy = pcg32_next_f32(rng)
    o, d = generate_rays(camera, pixel_centers(width, height, dev)
                         + torch.stack([jx, jy], -1) - 0.5)

    beta = torch.ones((R, 3), **f32)
    medium = scene.camera_medium.expand(R).clone()
    alive = torch.ones((R,), dtype=torch.bool, device=dev)
    specular = torch.zeros_like(alive)
    first = torch.ones_like(alive)
    no = torch.zeros_like(alive)
    Ld = torch.zeros((R, 3), **f32)
    vp_p, vp_wo, vp_beta = (torch.zeros((R, 3), **f32) for _ in range(3))
    vp_kind = torch.full((R,), VP_NONE, dtype=torch.int64, device=dev)
    vp_mat = torch.full((R,), -1, dtype=torch.int64, device=dev)
    vp_n = torch.zeros((R, 3), **f32)
    vp_g = torch.zeros((R,), **f32)
    vp_ss = torch.zeros((R, 3), **f32)
    depth = torch.zeros((R,), dtype=torch.int64, device=dev)
    n_mat = scene.materials.mtype.shape[0]

    for _ in range(cfg.maxdepth + 2):
        h = intersect(scene, o, d)
        t_lim = torch.where(h.valid, h.t, torch.full_like(h.t, 1e6))
        h_p = o + torch.clamp_max(h.t, 1e6)[:, None] * d

        # escaped (vsppm.cpp:259-265)
        miss = alive & ~h.valid
        Ld = Ld + torch.where(miss[:, None], beta * escaped_radiance(scene, d),
                              zero)

        # medium sampling (vsppm.cpp:267-272); rendermedia=False: Tr only
        rng, ms, _ = sample_medium(scene.media, medium, o, d, t_lim, rng,
                                   early_exit=False)
        live_hit = (alive & h.valid)[:, None]
        if cfg.rendermedia:
            scattered = ms.sampled & alive & h.valid
            beta = torch.where(live_hit, beta * ms.weight, beta)
        else:
            tr = segment_transmittance_det(scene, medium, o, d, t_lim)
            beta = torch.where(live_hit, beta * tr, beta)
            scattered = no

        # medium visible point (vsppm.cpp:278-293)
        p_med = o + ms.t[:, None] * d
        rng, nee_med = sample_one_light(
            scene, rng, p_med, torch.zeros_like(d), -d, torch.full_like(vp_mat, -1),
            medium, no, tr_crossings=k_tr)
        Ld = Ld + torch.where(scattered[:, None], beta * nee_med, zero)
        _, sigma_s_here, g_here, _, _ = gather_medium(scene.media, medium)

        # surface interaction (vsppm.cpp:295-352)
        surf = alive & h.valid & ~scattered
        is_boundary = surf & (h.material < 0)
        entering = dot(d, h.n) < 0.0
        med_after_boundary = torch.where(entering, h.medium_inside,
                                         h.medium_outside)
        see_le = surf & (first | specular)
        Le = area_light_emitted(scene, h.area_light, h.n, -d)
        Ld = Ld + torch.where(see_le[:, None], beta * Le, zero)
        rng, nee_surf = sample_one_light(
            scene, rng, h_p, h.ns, -d, h.material, medium, ~no,
            tr_crossings=k_tr)
        Ld = Ld + torch.where((surf & ~is_boundary)[:, None], beta * nee_surf,
                              zero)

        real = surf & ~is_boundary
        if n_mat:
            mat_safe = torch.clamp(h.material, 0, n_mat - 1)
            is_diffuse = real & (scene.materials.mtype[mat_safe] == MAT_MATTE)
        else:
            is_diffuse = no
        at_last = depth >= cfg.maxdepth - 1
        make_surf_vp = (is_diffuse | (real & at_last)) & cfg.rendersurfaces

        # the first visible point wins; its lane dies after
        record = (scattered | make_surf_vp) & (vp_kind == VP_NONE)
        rec3, med3 = record[:, None], scattered[:, None]
        vp_kind = torch.where(record, torch.where(scattered, VP_MEDIUM,
                                                  VP_SURFACE), vp_kind)
        vp_p = torch.where(rec3, torch.where(med3, p_med, h_p), vp_p)
        vp_wo = torch.where(rec3, -d, vp_wo)
        vp_beta = torch.where(rec3, beta, vp_beta)
        vp_mat = torch.where(record, h.material, vp_mat)
        vp_n = torch.where(rec3, h.ns, vp_n)
        vp_g = torch.where(record, g_here, vp_g)
        vp_ss = torch.where(rec3, sigma_s_here, vp_ss)

        # specular continuation (vsppm.cpp:334-351)
        rng, s0 = pcg32_next_f32(rng)
        rng, s1 = pcg32_next_f32(rng)
        bs = sample_bsdf(scene.materials, h.material, h.ns, -d,
                         torch.stack([s0, s1], -1), mode=MODE_RADIANCE)
        cont = real & ~record & bs.valid & ~at_last
        pdf_ok = cont & (bs.pdf > 1e-12)
        one = torch.ones_like(bs.pdf)
        new_beta = torch.where(
            pdf_ok[:, None],
            beta * bs.f * (absdot(bs.wi, h.ns)
                           / torch.where(pdf_ok, bs.pdf, one))[:, None],
            beta)
        # Russian roulette (vsppm.cpp:345-350)
        rng, u_rr = pcg32_next_f32(rng)
        y = luminance(new_beta)
        do_rr = cont & (y < 0.25)
        cp = torch.clamp_max(y, 1.0)
        killed = do_rr & (u_rr > cp)
        keep = do_rr & ~killed & (cp > 1e-6)
        new_beta = torch.where(keep[:, None],
                               new_beta / torch.where(keep, cp, one)[:, None],
                               new_beta)

        o = torch.where(surf[:, None], offset_ray_origin(
            h_p, h.n, torch.where(is_boundary[:, None], d, bs.wi)), o)
        new_d = torch.where(cont[:, None], bs.wi, d)
        medium = torch.where(is_boundary, med_after_boundary, torch.where(
            cont & (dot(bs.wi, h.n) > 0.0), h.medium_outside,
            torch.where(cont, h.medium_inside, medium)))
        alive = alive & (is_boundary | (cont & ~killed))
        specular = torch.where(cont, bs.specular, specular & is_boundary)
        first = first & is_boundary
        depth = depth + cont.to(torch.int64)
        d, beta = new_d, new_beta

    return Ld, VisiblePoints(vp_p, vp_wo, vp_beta, vp_kind, vp_mat, vp_n,
                             vp_g, vp_ss)


def _photon_pass(scene: Scene, light_distr, iter_idx: int, photons: int,
                 cfg: VSPPMConfig) -> PhotonInteractions:
    """Phase C's walk (vsppm.cpp:424-566; vsppm.py:263-382): photon i of
    iteration n is AwesomeHaltonSampler(n * P + i) for emission, light pick,
    phase, BSDF and roulette; the medium tracking draws from its PCG32
    stream as it stood after the emission draws.  Returns every step's
    interaction record, concatenated."""
    P = photons
    dev = scene.device
    idx = (iter_idx * P + torch.arange(P, dtype=torch.int64, device=dev)) & _U32
    hs = halton_stream_init(idx)
    hs, u_light = halton_next_1d(hs)
    light_num, light_pdf = sample_discrete(light_distr, u_light)
    hs, u0 = halton_next_2d(hs)
    hs, u1 = halton_next_2d(hs)
    hs, _ut = halton_next_1d(hs)
    le = sample_le(scene, light_num, u0, u1)
    denom = light_pdf * le.pdf_pos * le.pdf_dir
    beta = (absdot(le.n_light, le.d) / torch.clamp_min(denom, 1e-30))[:, None] * le.Le
    alive = (denom > 0.0) & (le.Le.sum(-1) > 0.0)
    span = world_span(scene)

    rng = hs.rng
    o, d, medium = le.o, le.d, le.medium
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
        real = surf & ~is_boundary
        p_med = o + ms.t[:, None] * d

        # medium interactions always; surface ones at depth > 0 on a real
        # material (vsppm.cpp:506)
        records.append(PhotonInteractions(
            p=torch.where(scattered[:, None], p_med, h_p), wi=-d, beta=beta,
            kind=torch.where(scattered, VP_MEDIUM, VP_SURFACE), depth=depth,
            valid=scattered | (real & (depth > 0))))

        hs, u_ph = halton_next_2d(hs)
        _, _, g_here, _, _ = gather_medium(scene.media, medium)
        wi_phase, _ = hg_sample_p(-d, g_here, u_ph)
        hs, u_bs = halton_next_2d(hs)
        bs = sample_bsdf(scene.materials, h.material, h.ns, -d, u_bs,
                         mode=MODE_IMPORTANCE)
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
        med_boundary = torch.where(entering, h.medium_inside, h.medium_outside)
        sc3, bd3 = scattered[:, None], is_boundary[:, None]
        new_o = torch.where(sc3, p_med, offset_ray_origin(
            h_p, h.n, torch.where(bd3, d, bs.wi)))
        new_d = torch.where(sc3, wi_phase, torch.where(bd3, d, bs.wi))
        new_beta = torch.where(sc3, beta, torch.where(bd3, beta, beta_surf))
        new_medium = torch.where(scattered, medium, torch.where(
            is_boundary, med_boundary, torch.where(
                dot(bs.wi, h.n) > 0.0, h.medium_outside, h.medium_inside)))
        cont_surf = real & bs.valid
        # Russian roulette against the old beta (vsppm.cpp:558-563)
        hs, u_rr = halton_next_1d(hs)
        lum_old = luminance(beta)
        lum_ok = lum_old > 1e-20
        q = torch.clamp_min(
            1.0 - torch.where(lum_ok, luminance(new_beta), 0.0)
            / torch.where(lum_ok, lum_old, one), 0.0)
        killed = cont_surf & (u_rr < q)
        keep = cont_surf & ~killed & (q < 1.0 - 1e-6)
        new_beta = torch.where(keep[:, None],
                               new_beta / torch.where(keep, 1.0 - q, one)[:, None],
                               new_beta)
        depth = depth + (scattered | real).to(torch.int64)
        # compat: the reference's roulette kills every photon at its first
        # medium interaction (VSPPMConfig)
        cont_med = scattered if cfg.kernel == "physical" else torch.zeros_like(scattered)
        alive = alive & (cont_med | is_boundary | (cont_surf & ~killed))
        alive = alive & (new_beta.sum(-1) > 0.0) & (depth < cfg.maxdepth)
        o, d, beta, medium = new_o, new_d, new_beta, new_medium

    return PhotonInteractions(*(torch.cat(list(f), 0) for f in zip(*records)))


def _cell_key(c: torch.Tensor) -> torch.Tensor:
    return (c[..., 0] << 20) | (c[..., 1] << 10) | c[..., 2]


def _splat_gather(vps: VisiblePoints, radii: torch.Tensor,
                  photons: PhotonInteractions, materials, cfg: VSPPMConfig):
    """Phases B and C joined in gather form (vsppm.py:385-463): per visible
    point, the sum of its kind's photon contributions within its radius.
    Each of the 27 cells its ball can overlap (offsets outside the grid
    skipped, not clamped) is read as an (R, K) block of slots, masked to
    the cell's count.  Returns (Phi (R,3), M (R,) int64, overflow, the
    slots past K summed over cells)."""
    R, dev = vps.p.shape[0], vps.p.device
    I = photons.p.shape[0]
    K = cfg.max_photons_per_cell
    has_vp = vps.kind != VP_NONE
    max_r = torch.clamp_min(torch.where(has_vp, radii, 0.0).max(), 1e-6)
    inf = torch.full_like(photons.p, float("inf"))
    gmin = torch.where(photons.valid[:, None], photons.p, inf).amin(0)
    gmin = torch.where(torch.isfinite(gmin), gmin, 0.0)
    cell = max_r

    c_ph = torch.clamp(torch.floor((photons.p - gmin) / cell).to(torch.int64),
                       0, 1023)
    pkey = torch.where(photons.valid, _cell_key(c_ph), NO_KEY)
    pkey_s, order = torch.sort(pkey, stable=True)
    pp, pwi, pbeta = photons.p[order], photons.wi[order], photons.beta[order]
    pkind, pvalid = photons.kind[order], photons.valid[order]
    if cfg.kernel == "physical":
        # depth-0 medium interactions are single scatter, already in Ld
        pvalid = pvalid & ((pkind != VP_MEDIUM) | (photons.depth[order] > 0))

    base = torch.floor((vps.p - gmin - radii[:, None]) / cell).to(torch.int64)
    r2 = radii * radii
    Phi = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    M = torch.zeros((R,), dtype=torch.int64, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    for ox in range(3):
        for oy in range(3):
            for oz in range(3):
                cu = base + torch.tensor([ox, oy, oz], device=dev)
                in_grid = ((cu >= 0) & (cu <= 1023)).all(-1)
                lo, count = cell_range(pkey_s,
                                       _cell_key(torch.clamp(cu, 0, 1023)))
                count = torch.where(in_grid, count, 0)
                overflow = overflow + torch.clamp_min(count - K, 0).sum()
                for rr, j, ok in slot_blocks(lo, count, has_vp, K, I):
                    phi, m = _gather_block(vps, rr, j, ok, r2[rr], pp, pwi,
                                           pbeta, pkind, pvalid, materials)
                    Phi[rr] += phi
                    M[rr] += m
    return Phi, M, overflow


def _gather_block(vps, rr, j, ok, r2, pp, pwi, pbeta, pkind, pvalid,
                  materials):
    """The contributions of the slots ``j`` (n, k) of one cell, ``ok``
    inside its run, to visible points ``rr``: (Phi (n,3) summed over the
    slots, M (n,))."""
    n, k_max = j.shape
    kind = vps.kind[rr][:, None]
    diff = vps.p[rr][:, None, :] - pp[j]
    use = (ok & pvalid[j] & (pkind[j] == kind)
           & (dot(diff, diff) <= r2[:, None]))
    wi = pwi[j].reshape(n * k_max, 3)
    rep = lambda x: x[rr].repeat_interleave(k_max, 0)  # noqa: E731
    wo = rep(vps.wo)
    f_s, _ = eval_bsdf(materials, rep(vps.material), rep(vps.n), wo, wi)
    f_m = hg_p(wo, wi, rep(vps.g))[:, None].expand(-1, 3)
    f = torch.where((kind == VP_MEDIUM).repeat_interleave(k_max, 0), f_m, f_s)
    contrib = torch.where(use[..., None], pbeta[j] * f.reshape(n, k_max, 3),
                          0.0)
    return contrib.sum(1), use.sum(1)


def render_vsppm(scene: Scene, camera: Camera, width: int, height: int,
                 cfg: VSPPMConfig = VSPPMConfig(),
                 write_callback: Optional[Callable] = None):
    """The progressive render (vsppm.cpp:187-657; vsppm.py:466-552) on the
    scene's device.  ``write_callback(iter, image)`` receives the (H, W, 3)
    image on the host after every ``imagewritefrequency`` iterations and
    after the last.  Returns (image (H, W, 3), stats): photon_paths,
    splat_overflow, medium_interactions (photon-pass interactions),
    vp_medium and vp_surface (the reference's counters,
    vsppm.cpp:49-56)."""
    if cfg.kernel not in ("physical", "compat"):
        raise ValueError(f"unknown vsppm kernel {cfg.kernel!r}")
    check_slice(scene)
    if cfg.tr_crossings is None:
        cfg = dataclasses.replace(cfg, tr_crossings=default_tr_crossings(scene))
    R = width * height
    dev = scene.device
    photons = cfg.photonsperiteration if cfg.photonsperiteration > 0 else R
    light_distr = light_power_distribution(scene)
    physical = cfg.kernel == "physical"

    radii = torch.full((R,), cfg.radius, dtype=torch.float32, device=dev)
    N = torch.zeros((R,), dtype=torch.float32, device=dev)
    tau_s = torch.zeros((R, 3), dtype=torch.float32, device=dev)  # pi r^2
    tau_m = torch.zeros_like(tau_s)  # physical: (4/3) pi r^3 sigma_s
    Ld = torch.zeros_like(tau_s)
    stats = dict(photon_paths=0, splat_overflow=0)

    def final_image(n_iter):
        Np = n_iter * photons
        r = torch.clamp_min(radii, 1e-12)[:, None]
        L = Ld / n_iter + tau_s / (Np * math.pi * r * r)
        if physical:
            return L + tau_m / (Np * (4.0 / 3.0) * math.pi * r * r * r)
        return L + tau_m / (Np * math.pi * r * r)

    for it in range(cfg.iterations):
        Ld_add, vps = _camera_pass(scene, camera, width, height, it, cfg)
        pi_ = _photon_pass(scene, light_distr, it, photons, cfg)
        Phi, M, ovf = _splat_gather(vps, radii, pi_, scene.materials, cfg)
        Ld = Ld + Ld_add
        # SPPM update (vsppm.cpp:572-600), gamma = 2/3
        has = (M > 0) & (vps.kind != VP_NONE)
        Mf = M.to(torch.float32)
        N_new = N + (2.0 / 3.0) * Mf
        R_new = radii * torch.sqrt(N_new / torch.clamp_min(N + Mf, 1e-6))
        ratio2 = (R_new * R_new / torch.clamp_min(radii * radii, 1e-12))[:, None]
        ratio3 = ratio2 * (R_new / torch.clamp_min(radii, 1e-12))[:, None]
        is_med = vps.kind == VP_MEDIUM
        add_s = torch.where((has & ~is_med)[:, None], vps.beta * Phi, 0.0)
        if physical:
            # the visible point's sigma_s folds into the volume estimate
            phi_m = vps.beta * Phi / torch.clamp_min(vps.sigma_s, 1e-12)
        else:
            phi_m = vps.beta * Phi
        add_m = torch.where((has & is_med)[:, None], phi_m, 0.0)
        has3 = has[:, None]
        tau_s = torch.where(has3, (tau_s + add_s) * ratio2, tau_s)
        tau_m = torch.where(has3, (tau_m + add_m) * (ratio3 if physical
                                                     else ratio2), tau_m)
        N = torch.where(has, N_new, N)
        radii = torch.where(has, R_new, radii)
        stats["photon_paths"] += photons
        stats["splat_overflow"] += int(ovf)
        counts = (int((pi_.valid & (pi_.kind == VP_MEDIUM)).sum()),
                  int(is_med.sum()), int((vps.kind == VP_SURFACE).sum()))
        for name, c in zip(("medium_interactions", "vp_medium", "vp_surface"),
                           counts):
            stats[name] = stats.get(name, 0) + c
        if write_callback is not None and (
                (it + 1) == cfg.iterations
                or (it + 1) % cfg.imagewritefrequency == 0):
            write_callback(it, final_image(it + 1).reshape(height, width, 3).cpu())

    return final_image(cfg.iterations).reshape(height, width, 3), stats
