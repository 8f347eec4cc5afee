"""Photon-beam tracing: light emission -> scattering walk -> beam segments
(counterpart of ``bre_tpu/integrators/photon_trace.py``; pbrt
photonbeam.cpp:258-437).  ``trace_photon_beams`` is the linear walk of the
normalized estimate; ``trace_photon_beams_compat`` the reference renderer's
splitting walk, for ``kernel="compat"``.

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
from ..core.rng import PCG32State, pcg32_init, pcg32_next_f32
from ..core.sampling import Distribution1D, sample_discrete
from ..core.spectrum import luminance
from ..lights import sample_le
from ..materials import MODE_IMPORTANCE, sample_bsdf
from ..media import (_grid_ray_setup, gather_medium, grid_density,
                     hg_sample_p, sample_grid, sample_medium, tr_homogeneous)
from ..scene.intersect import intersect
from ..scene.scene import Scene, check_slice, world_span
from ..utils.stats import traced

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


def _segment_tr(scene: Scene, med_idx, o, d, t_end):
    """Deterministic segment transmittance for beam power bookkeeping:
    exact exp(-sigma_t L) in homogeneous media (homogeneous.cpp:44-48); in
    a grid medium a fixed 16-point midpoint quadrature of the trilinear
    density over the segment's overlap with the grid, deterministic and
    differentiable in the density; 1 in vacuum."""
    media = scene.media
    sigma_a, sigma_s, _, is_grid, in_medium = gather_medium(media, med_idx)
    tr = tr_homogeneous(sigma_a, sigma_s, d, t_end)
    if media.density.numel() > 1:
        om, dm, dlen, t0, t1, _ = _grid_ray_setup(media, o, d, t_end)
        n_q = 16
        sigma_t = (sigma_a + sigma_s)[..., 0]
        # t0, t1 in medium units; sigma is per world unit: divide by dlen
        dt = torch.clamp_min(t1 - t0, 0.0) / n_q
        q = torch.arange(n_q, dtype=torch.float32, device=o.device) + 0.5
        ts = t0[..., None] + q * dt[..., None]
        dens = grid_density(media.density,
                            om[..., None, :] + ts[..., None] * dm[..., None, :])
        tau = sigma_t * dens.sum(-1) * dt / torch.clamp_min(dlen, 1e-30)
        tr_g = torch.exp(-tau)[..., None].expand(tr.shape)
        tr = torch.where(is_grid[..., None], tr_g, tr)
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


@traced("bre.walk")
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
    stop_gradient: the detached estimator, whose gradient keeps only the
    explicit medium-parameter dependence of weights and transmittances."""
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
    n_scatter = n_surface = n_grid_overflow = 0
    for _ in range(n_steps):
        h = intersect(scene, o, d)
        t_lim = torch.minimum(torch.where(h.valid, h.t, span), span)
        # finite hit point even for the miss sentinel
        h_p = o + t_lim[:, None] * d

        rng, ms, n_ovf = sample_medium(scene.media, medium, o, d, t_lim, rng)
        if detach_sampling:
            ms = ms._replace(t=ms.t.detach())
        scattered = ms.sampled & alive
        t_end = torch.where(scattered, ms.t, t_lim)
        end = o + t_end[:, None] * d

        t_beam = t_lim if long_beams else t_end
        end_beam = h_p if long_beams else end
        tr_seg = _segment_tr(scene, medium, o, d, t_beam)
        steps.append((o, end_beam, beta, beta * tr_seg, medium,
                      alive & (medium >= 0)))

        # branch A: medium scatter (phase-function continuation)
        rng, p0 = pcg32_next_f32(rng)
        rng, p1 = pcg32_next_f32(rng)
        _, _, g_here, _, _ = gather_medium(scene.media, medium)
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
        n_grid_overflow = n_grid_overflow + n_ovf
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
                 n_beams=beams.valid.sum(), photon_paths=P,
                 n_grid_overflow=n_grid_overflow)
    return beams, stats


# ---------------------------------------------------------------------------
# The reference renderer's splitting walk (kernel="compat")
# ---------------------------------------------------------------------------

def _masked_f32(rng: PCG32State, mask):
    """One UniformFloat draw, consumed only on the lanes of ``mask``: the
    other lanes keep their state (photon_trace.py:393-400), the vectorized
    form of pbrt's conditional sampler calls."""
    rng2, u = pcg32_next_f32(rng)
    return PCG32State(torch.where(mask, rng2.state, rng.state),
                      torch.where(mask, rng2.inc, rng.inc)), u


def _stack_top(st: torch.Tensor, top: torch.Tensor) -> torch.Tensor:
    """Each lane's entry ``top`` of its stack st (P, S, ...), 0 where top
    is -1.  Float entries come out as the reference's one-hot sum gives
    them: + 0.0 turns a -0.0 into +0.0."""
    idx = torch.clamp_min(top, 0).reshape((-1, 1) + (1,) * (st.dim() - 2))
    picked = st.gather(1, idx.expand((-1, 1) + st.shape[2:]))[:, 0]
    if picked.is_floating_point():
        picked = picked + 0.0
    return picked


def trace_photon_beams_compat(scene: Scene, light_distr: Distribution1D,
                              halton_index: torch.Tensor, max_depth: int,
                              beam_radius, per_photon_stats: bool = False
                              ) -> Tuple[Beams, dict]:
    """The reference renderer's photon walk, TracePhotonBeamRecursive
    (photonbeam.cpp:258-325), quirks included, for seed-matched image
    comparison (photon_trace.py:403-727):

    - splitting: a sampled medium interaction continues into the
      phase-scattered branch AND, later, the surface continuation
      (:274-304), a deterministic-split estimator;
    - each beam spans the whole segment o -> surface hit with end power
      ``Tr(whole segment) * beta`` (:288-294), vacuum segments included;
    - the scatter branch restarts at the sampled point with
      ``beta * Tr(whole segment)`` (:287), no sigma_s or pdf factor;
    - null-material boundary hops keep beta unattenuated and use no depth
      (:300-303);
    - Russian roulette at real bounces: ``q = max(0, 1 - y(beta_new) /
      y(beta))``, continuing with ``beta_new / (1 - q)`` (:320-323);
    - the streams are ``RNG(halton_index + 1)``: six unconditional
      emission draws, each Get2D pair taken as (second, first) (g++
      evaluates ``Point2f(Get1D(), Get1D())`` right to left), then the
      conditional draws in the reference's depth-first order (medium
      sample 2, phase 2, BSDF 2, roulette 1), as masked PCG32 steps;
    - on grid lanes, early-exit delta tracking on an auxiliary stream
      ``RNG(halton_index ^ 0x9E3779B9)`` and the quadrature ``_segment_tr``
      as the whole-segment Tr (statistically matched: the reference burns
      a data-dependent number of dimensions there).

    The recursion is a per-lane stack of suspended surface continuations
    (capacity ``max_depth``), processed depth first: each of the
    ``n_steps = 4 * (max_depth + 1)`` steps either advances the
    current branch one segment or pops the latest continuation.  Beams are
    step-major, ``photons * n_steps`` slots.  ``halton_index``: (P,) uint32
    values in int64.  Returns (beams, stats); ``stats["n_overflow_steps"]``
    counts lanes still live when the steps ran out (none is dropped
    silently); ``per_photon_stats`` adds per-lane counts of scatters,
    surface events and beams (``lane_medium``, ``lane_surface``,
    ``lane_beam``) and each lane's final PCG32 states, main and auxiliary
    (``lane_rng``, ``lane_rng_grid``), for seed-matching diagnostics."""
    check_slice(scene)
    halton_index = halton_index.to(torch.int64) & _U32
    P = halton_index.shape[0]
    dev = scene.device
    S = max(max_depth, 1)  # continuation stack capacity
    has_grid = scene.media.density.numel() > 1
    n_steps = 4 * (max_depth + 1)
    rng = pcg32_init((halton_index + 1) & _U32)

    # emission: six unconditional draws (photonbeam.cpp:394-407)
    rng, u_light = pcg32_next_f32(rng)
    light_num, light_pdf = sample_discrete(light_distr, u_light)
    rng, a0 = pcg32_next_f32(rng)
    rng, a1 = pcg32_next_f32(rng)
    rng, b0 = pcg32_next_f32(rng)
    rng, b1 = pcg32_next_f32(rng)
    rng, _u_time = pcg32_next_f32(rng)
    le = sample_le(scene, light_num, torch.stack([a1, a0], -1),
                   torch.stack([b1, b0], -1))
    denom = light_pdf * le.pdf_pos * le.pdf_dir
    beta0 = (absdot(le.n_light, le.d) / torch.clamp_min(denom, 1e-30))[:, None] * le.Le
    alive = (denom > 0.0) & (le.Le.sum(-1) > 0.0)

    f3 = dict(dtype=torch.float32, device=dev)
    zeros3 = torch.zeros((P, 3), **f3)
    zero = torch.zeros((), **f3)
    rng_grid = pcg32_init((halton_index ^ 0x9E3779B9) & _U32)
    o, d, medium = le.o, le.d, le.medium
    beta = torch.where(alive[:, None], beta0, zero)
    depth = torch.zeros((P,), dtype=torch.int64, device=dev)
    sp = torch.zeros((P,), dtype=torch.int64, device=dev)
    st_o = torch.zeros((P, S, 3), **f3)
    st_d = torch.zeros((P, S, 3), **f3)
    st_beta = torch.zeros((P, S, 3), **f3)
    st_medium = torch.zeros((P, S), dtype=torch.int64, device=dev)
    st_depth = torch.zeros((P, S), dtype=torch.int64, device=dev)
    slots = torch.arange(S, device=dev)

    steps = []
    stats = dict(n_medium_scatter=0, n_surface=0)
    lanes = dict(lane_medium=0, lane_surface=0, lane_beam=0)
    for _ in range(n_steps):
        is_pop = ~alive & (sp > 0)
        top = sp - 1
        pop3 = is_pop[:, None]
        o = torch.where(pop3, _stack_top(st_o, top), o)
        d = torch.where(pop3, _stack_top(st_d, top), d)
        beta = torch.where(pop3, _stack_top(st_beta, top), beta)
        medium = torch.where(is_pop, _stack_top(st_medium, top), medium)
        depth = torch.where(is_pop, _stack_top(st_depth, top), depth)
        sp = torch.where(is_pop, sp - 1, sp)

        active = alive | is_pop
        h = intersect(scene, o, d)
        sigma_a, sigma_s, g_here, is_grid_l, in_med = gather_medium(
            scene.media, medium)
        sigma_t = sigma_a + sigma_s
        t_hit = torch.where(h.valid, h.t, zero)
        h_p = o + t_hit[:, None] * d
        if has_grid:
            tr_full = _segment_tr(scene, medium, o, d, t_hit)
        else:
            # HomogeneousMedium::Tr (0 dims)
            tr_full = torch.where(in_med[:, None],
                                  torch.exp(-sigma_t * t_hit[:, None]),
                                  torch.ones_like(sigma_t))

        # advancing lanes: Medium::Sample (2 dims, homogeneous.cpp:55-57)
        adv = alive & active
        do_sample = adv & h.valid & in_med
        rng, u_ch = _masked_f32(rng, do_sample)
        rng, u_t = _masked_f32(rng, do_sample)
        channel = torch.clamp_max((u_ch * 3).to(torch.int64), 2)
        sig_c = sigma_t.gather(1, channel[:, None])[:, 0]
        pos = sig_c > 1e-12
        dist = -torch.log(torch.clamp_min(1.0 - u_t, 1e-38)) / torch.where(
            pos, sig_c, torch.ones_like(sig_c))
        black = beta.sum(-1) <= 0.0  # Spectrum::IsBlack (photonbeam.cpp:271)
        scattered = do_sample & pos & (dist < t_hit) & ~black
        if has_grid:
            # GridDensityMedium::Sample (grid.cpp:62-87) on the auxiliary
            # stream
            rng_grid, gs, _ = sample_grid(scene.media, sigma_a, sigma_s, o, d,
                                          t_hit, rng_grid, early_exit=True)
            g_lane = is_grid_l & do_sample
            scattered = torch.where(g_lane, do_sample & gs.sampled & ~black,
                                    scattered)
            dist = torch.where(g_lane, gs.t, dist)

        # the segment's beam (photonbeam.cpp:288-294); a scattered segment
        # stores the same beam when its continuation resumes, so storing it
        # now is equivalent (Tr draws nothing)
        emit_beam = adv & h.valid & ~black
        steps.append((o, h_p, beta * tr_full, medium, emit_beam))

        # scatter branch: phase dims, push the surface continuation
        rng, p0 = _masked_f32(rng, scattered)
        rng, p1 = _masked_f32(rng, scattered)
        wi_phase, _ = hg_sample_p(-d, g_here, torch.stack([p1, p0], -1))
        push_sl = (slots == sp[:, None]) & scattered[:, None]  # (P, S)
        push3 = push_sl[..., None]
        st_o = torch.where(push3, o[:, None], st_o)
        st_d = torch.where(push3, d[:, None], st_d)
        st_beta = torch.where(push3, beta[:, None], st_beta)
        st_medium = torch.where(push_sl, medium[:, None], st_medium)
        st_depth = torch.where(push_sl, depth[:, None], st_depth)
        new_sp = torch.where(scattered, sp + 1, sp)

        # surface continuation: advancing lanes that did not scatter now,
        # popped lanes resume it (photonbeam.cpp:289-324)
        surf_proc = active & h.valid & ~black & ~scattered
        is_null = h.material < 0
        hop = surf_proc & is_null
        entering = dot(d, h.n) < 0.0
        medium_after_hop = torch.where(entering, h.medium_inside,
                                       h.medium_outside)
        real = surf_proc & ~is_null
        rng, s0 = _masked_f32(rng, real)
        rng, s1 = _masked_f32(rng, real)
        bs = sample_bsdf(scene.materials, h.material, h.ns, -d,
                         torch.stack([s1, s0], -1), mode=MODE_IMPORTANCE,
                         tangent=h.tangent)
        # `if (fr.IsBlack() || pdf == 0.f) break;` (:314): the roulette
        # dimension is drawn exactly when this passes
        fr_ok = real & (bs.pdf > 0.0) & (bs.f.sum(-1) > 0.0)
        beta_new = (tr_full * beta * bs.f
                    * (absdot(bs.wi, h.ns) / torch.where(
                        fr_ok, bs.pdf, torch.ones_like(bs.pdf)))[:, None])
        rng, u_rr = _masked_f32(rng, fr_ok)
        y_old = luminance(beta)
        y_ok = y_old > 0.0
        q = torch.clamp_min(1.0 - luminance(beta_new) / torch.where(
            y_ok, y_old, torch.ones_like(y_old)), 0.0)
        q = torch.where(y_ok, q, zero)
        bounce = fr_ok & ~(u_rr < q)
        beta_bounce = beta_new / torch.clamp_min(1.0 - q, 1e-30)[:, None]
        leaving = dot(bs.wi, h.n) > 0.0
        medium_after_bounce = torch.where(leaving, h.medium_outside,
                                          h.medium_inside)

        # the next current branch
        sc3, hop3 = scattered[:, None], hop[:, None]
        o = torch.where(sc3, o + dist[:, None] * d, torch.where(
            hop3, offset_ray_origin(h_p, h.n, d),
            offset_ray_origin(h_p, h.n, bs.wi)))
        d = torch.where(sc3, wi_phase, torch.where(hop3, d, bs.wi))
        beta = torch.where(sc3, beta * tr_full,
                           torch.where(hop3, beta, beta_bounce))
        medium = torch.where(scattered, medium, torch.where(
            hop, medium_after_hop, medium_after_bounce))
        depth = depth + (scattered | bounce).to(torch.int64)
        alive = (scattered | hop | bounce) & (hop | (depth < max_depth))
        sp = new_sp

        stats["n_medium_scatter"] = stats["n_medium_scatter"] + scattered.sum()
        stats["n_surface"] = stats["n_surface"] + surf_proc.sum()
        if per_photon_stats:
            lanes["lane_medium"] = lanes["lane_medium"] + scattered.to(torch.int64)
            lanes["lane_surface"] = lanes["lane_surface"] + surf_proc.to(torch.int64)
            lanes["lane_beam"] = lanes["lane_beam"] + emit_beam.to(torch.int64)

    B = P * n_steps
    cat = lambda k: torch.cat([s[k] for s in steps], 0)  # noqa: E731
    beams = Beams(
        start=cat(0), end=cat(1),
        power_start=torch.zeros((B, 3), **f3),  # betaStart zero (:265)
        power_end=cat(2),
        radius=torch.full((B,), float(beam_radius), **f3),
        medium=cat(3), valid=cat(4))
    stats.update(n_beams=beams.valid.sum(), photon_paths=P,
                 n_overflow_steps=(alive | (sp > 0)).sum())
    if per_photon_stats:
        stats.update(lanes, lane_rng=rng, lane_rng_grid=rng_grid)
    return beams, stats
