"""Photon-beam tracing: light emission -> scattering walk -> beam segments
(counterpart of ``bre_tpu/integrators/photon_trace.py:47-386``; pbrt
photonbeam.cpp:258-437).

The whole photon batch walks a fixed number of steps (``max_depth + 2``) in
lockstep, each step writing one fixed-capacity beam slot per photon, so
``beams.capacity == photons * (max_depth + 2)``, step-major.  The reference's
``lax.scan`` is a Python loop here.  Per-photon PCG32 streams are seeded
``iter * photons + idx + 1`` (uint32 arithmetic), bit-identical to the
reference, and every draw happens in the reference's order.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core.math import absdot, dot, offset_ray_origin
from ..core.rng import pcg32_init, pcg32_next_f32
from ..core.sampling import Distribution1D, sample_discrete
from ..core.spectrum import luminance
from ..lights import sample_le
from ..materials import MODE_IMPORTANCE, sample_bsdf
from ..media import gather_medium, hg_sample_p, sample_medium, tr_homogeneous
from ..scene.intersect import intersect
from ..scene.scene import Scene, check_slice, world_span

_U32 = 0xFFFFFFFF


class Beams(NamedTuple):
    """Fixed-capacity SoA photon-beam array (PhotonBeam,
    photonbeambvh.h:28-45, plus the start power)."""

    start: torch.Tensor  # (B, 3)
    end: torch.Tensor  # (B, 3)
    power_start: torch.Tensor  # (B, 3)
    power_end: torch.Tensor  # (B, 3) power at the segment end (after Tr)
    radius: torch.Tensor  # (B,)
    medium: torch.Tensor  # (B,) int64
    valid: torch.Tensor  # (B,) bool

    @property
    def capacity(self) -> int:
        return self.radius.shape[0]


def _segment_tr(scene: Scene, med_idx, d, t_end):
    """Deterministic segment transmittance for beam power bookkeeping:
    exact exp(-sigma_t L) in homogeneous media (homogeneous.cpp:44-48), 1 in
    vacuum."""
    sigma_a, sigma_s, _, in_medium = gather_medium(scene.media, med_idx)
    tr = tr_homogeneous(sigma_a, sigma_s, d, t_end)
    return torch.where(in_medium[..., None], tr, torch.ones_like(tr))


def trace_photon_beams(scene: Scene, light_distr: Distribution1D, iter_idx: int,
                       photons_per_iter: int, max_depth: int, beam_radius,
                       detach_sampling: bool = False,
                       long_beams: bool = True) -> Tuple[Beams, dict]:
    """Trace ``photons_per_iter`` photon paths for iteration ``iter_idx``."""
    idx = torch.arange(photons_per_iter, dtype=torch.int64, device=scene.device)
    halton_index = (int(iter_idx) * photons_per_iter + idx) & _U32
    return trace_photon_beams_by_index(
        scene, light_distr, halton_index, max_depth, beam_radius,
        detach_sampling=detach_sampling, long_beams=long_beams)


def trace_photon_beams_by_index(scene: Scene, light_distr: Distribution1D,
                                halton_index: torch.Tensor, max_depth: int,
                                beam_radius, detach_sampling: bool = False,
                                long_beams: bool = True) -> Tuple[Beams, dict]:
    """Trace one photon per global stream id ``halton_index`` (uint32
    values in int64).

    ``long_beams``: beams span to the surface hit with analytic decay (what
    the normalized BRE gather needs); False stores scatter-truncated
    segments.  ``detach_sampling``: the sampled distances and continuation
    geometry are detached, at the same points as the reference's
    stop_gradient (no-op for this forward-only slice)."""
    check_slice(scene)
    P = halton_index.shape[0]
    dev = scene.device
    n_steps = max_depth + 2
    rng = pcg32_init((halton_index.to(torch.int64) + 1) & _U32)

    # light selection + emission (photonbeam.cpp:393-414)
    rng, u_light = pcg32_next_f32(rng)
    light_num, light_pdf = sample_discrete(light_distr, u_light)
    rng, a0 = pcg32_next_f32(rng)
    rng, a1 = pcg32_next_f32(rng)
    rng, b0 = pcg32_next_f32(rng)
    rng, b1 = pcg32_next_f32(rng)
    rng, _u_time = pcg32_next_f32(rng)  # uLightTime (consumed, unused)
    le = sample_le(scene, light_num, torch.stack([a0, a1], -1),
                   torch.stack([b0, b1], -1))
    denom = light_pdf * le.pdf_pos * le.pdf_dir
    beta0 = (absdot(le.n_light, le.d) / torch.clamp_min(denom, 1e-30))[:, None] * le.Le
    alive = (denom > 0.0) & (le.Le.sum(-1) > 0.0)

    span = world_span(scene)
    o, d = le.o, le.d
    beta = torch.where(alive[:, None], beta0, torch.zeros_like(beta0))
    medium = le.medium
    depth = torch.zeros((P,), dtype=torch.int64, device=dev)
    steps = []
    n_scatter = n_surface = 0
    for _ in range(n_steps):
        h = intersect(scene, o, d)
        t_lim = torch.minimum(torch.where(h.valid, h.t, span), span)
        # finite hit point even for the miss sentinel
        h_p = o + t_lim[:, None] * d

        rng, ms = sample_medium(scene.media, medium, d, t_lim, rng)
        if detach_sampling:
            ms = ms._replace(t=ms.t.detach())
        scattered = ms.sampled & alive
        t_end = torch.where(scattered, ms.t, t_lim)
        end = o + t_end[:, None] * d

        t_beam = t_lim if long_beams else t_end
        end_beam = h_p if long_beams else end
        tr_seg = _segment_tr(scene, medium, d, t_beam)
        steps.append((o, end_beam, beta, beta * tr_seg, medium,
                      alive & (medium >= 0)))

        # branch A: medium scatter (phase-function continuation)
        rng, p0 = pcg32_next_f32(rng)
        rng, p1 = pcg32_next_f32(rng)
        _, _, g_here, _ = gather_medium(scene.media, medium)
        wi_phase, _ = hg_sample_p(-d, g_here, torch.stack([p0, p1], -1))
        beta_scatter = beta * ms.weight

        # branch B: surface interaction
        surf = alive & ~scattered & h.valid
        is_boundary = surf & (h.material < 0)
        entering = dot(d, h.n) < 0.0
        new_medium_if_boundary = torch.where(entering, h.medium_inside,
                                             h.medium_outside)
        rng, s0 = pcg32_next_f32(rng)
        rng, s1 = pcg32_next_f32(rng)
        bs = sample_bsdf(scene.materials, h.material, h.ns, -d,
                         torch.stack([s0, s1], -1), mode=MODE_IMPORTANCE,
                         tangent=h.tangent)
        pdf_ok = bs.pdf > 1e-12
        one = torch.ones_like(bs.pdf)
        # CorrectShadingNormal (bdpt.h:68-86): 1 when ns == ng
        csn_num = absdot(-d, h.ns) * absdot(bs.wi, h.n)
        csn_den = torch.clamp_min(absdot(-d, h.n) * absdot(bs.wi, h.ns), 1e-12)
        csn = torch.where(pdf_ok, csn_num / csn_den, one)
        beta_surface = (
            beta * ms.weight
            * torch.where(pdf_ok[:, None], bs.f, torch.zeros_like(bs.f))
            * torch.where(pdf_ok, csn * absdot(bs.wi, h.ns)
                          / torch.where(pdf_ok, bs.pdf, one),
                          torch.zeros_like(one))[:, None]
        )
        leaving = dot(bs.wi, h.n) > 0.0
        new_medium_if_surface = torch.where(leaving, h.medium_outside,
                                            h.medium_inside)

        # select the continuation
        sc3 = scattered[:, None]
        bd3 = is_boundary[:, None]
        new_o = torch.where(sc3, end, offset_ray_origin(
            h_p, h.n, torch.where(bd3, d, bs.wi)))
        new_d = torch.where(sc3, wi_phase, torch.where(bd3, d, bs.wi))
        new_beta = torch.where(sc3, beta_scatter,
                               torch.where(bd3, beta * ms.weight, beta_surface))
        new_medium = torch.where(scattered, medium, torch.where(
            is_boundary, new_medium_if_boundary, new_medium_if_surface))
        new_alive = alive & (scattered | is_boundary
                             | (surf & bs.valid & (h.material >= 0)))
        new_alive = new_alive & (new_beta.sum(-1) > 0.0)

        # Russian roulette on surface bounces (photonbeam.cpp:320-323)
        rng, u_rr = pcg32_next_f32(rng)
        lum_old = luminance(beta)
        lum_ok = lum_old > 1e-20
        q = torch.clamp_min(
            1.0 - torch.where(lum_ok, luminance(new_beta), torch.zeros_like(lum_old))
            / torch.where(lum_ok, lum_old, torch.ones_like(lum_old)), 0.0)
        do_rr = surf & ~is_boundary
        killed = do_rr & (u_rr < q)
        keep = do_rr & ~killed & (q < 1.0 - 1e-6)
        new_beta = torch.where(
            keep[:, None],
            new_beta / torch.where(keep, 1.0 - q, torch.ones_like(q))[:, None],
            new_beta)
        new_alive = new_alive & ~killed

        # depth: medium scatter and BSDF bounce consume depth; boundary
        # pass-through does not (photonbeam.cpp:300-303)
        new_depth = depth + (scattered | (surf & ~is_boundary)).to(torch.int64)
        new_alive = new_alive & (new_depth < max_depth)
        if detach_sampling:
            new_o, new_d = new_o.detach(), new_d.detach()
        n_scatter = n_scatter + scattered.sum()
        n_surface = n_surface + surf.sum()
        o, d, beta, medium, alive, depth = (new_o, new_d, new_beta, new_medium,
                                            new_alive, new_depth)

    B = P * n_steps
    cat = lambda k: torch.cat([s[k] for s in steps], 0)  # noqa: E731
    beams = Beams(
        start=cat(0), end=cat(1), power_start=cat(2), power_end=cat(3),
        radius=torch.full((B,), float(beam_radius), dtype=torch.float32,
                          device=dev),
        medium=cat(4), valid=cat(5))
    stats = dict(n_medium_scatter=n_scatter, n_surface=n_surface,
                 n_beams=beams.valid.sum(), photon_paths=P)
    return beams, stats
