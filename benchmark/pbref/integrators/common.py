"""Shared integrator pieces: next-event estimation and segment transmittance
(counterpart of ``bre_tpu/integrators/common.py``; pbrt
integrator.cpp:54-215, scene.cpp:63-92)."""

from __future__ import annotations

import torch

from ..core.math import absdot, dot, offset_ray_origin
from ..core.rng import PCG32State
from ..core.samplers import stream_1d
from ..lights import (area_light_emitted, infinite_Le_pdf, light_shape_area,
                      sample_li, sample_light_spatial)
from ..materials import MODE_RADIANCE, eval_bsdf, sample_bsdf
from ..media import gather_medium, hg_p, hg_sample_p
from ..scene.intersect import intersect, intersect_p
from ..scene.scene import LIGHT_DIFFUSE_AREA, LIGHT_INFINITE, Scene
from .photon_trace import _segment_tr


# lanes (points x K slots) that a cell gather reads at once
GATHER_LANES = 1 << 22
# the sort key of an invalid photon: after every cell's run
NO_KEY = 0x7FFFFFFF


def cell_range(sorted_keys: torch.Tensor, key: torch.Tensor):
    """The run of each point's cell ``key`` in ``sorted_keys`` (the
    reference's ``searchsorted`` left and right): (lo, count)."""
    lo = torch.searchsorted(sorted_keys, key)
    return lo, torch.searchsorted(sorted_keys, key, right=True) - lo


def slot_blocks(lo: torch.Tensor, count: torch.Tensor, live: torch.Tensor,
                K: int, n: int):
    """The first K slots of each live point's cell run, where the reference
    loops over them, as blocks of at most GATHER_LANES lanes.  Yields (rows
    (b,) into the points, j (b, k) into the sorted photons, clamped to
    [0, n), ok (b, k): the slot lies inside the run)."""
    rows = torch.nonzero(live & (count > 0))[:, 0]
    if rows.numel() == 0:
        return
    k_max = min(K, int(count[rows].max()))
    k = torch.arange(k_max, device=lo.device)
    step = max(1, GATHER_LANES // k_max)
    for r0 in range(0, rows.numel(), step):
        rr = rows[r0:r0 + step]
        yield (rr, torch.clamp(lo[rr][:, None] + k, 0, n - 1),
               k < count[rr][:, None])


def segment_transmittance_det(scene: Scene, med_idx, o, d, t_end):
    """Deterministic per-segment transmittance (homogeneous analytic, grid
    by 16-point quadrature), shared with photon tracing."""
    return _segment_tr(scene, med_idx, o, d, t_end)


def default_tr_crossings(scene: Scene) -> int:
    """Bound on medium-boundary crossings of a shadow segment: 0 without
    media or without null-material boundary surfaces, else 2 per medium
    (enter + exit), capped at 4."""
    if scene.n_media == 0:
        return 0
    has_boundary = False
    if scene.n_triangles > 0:
        has_boundary |= bool((scene.triangles.material < 0).any())
    if scene.n_spheres > 0:
        has_boundary |= bool((scene.spheres.material < 0).any())
    if not has_boundary:
        return 0
    return min(2 * scene.n_media, 4)


def segment_transmittance_walk(scene: Scene, med_idx, o, d, t_end,
                               max_crossings: int = 0):
    """Transmittance along a shadow segment across up to ``max_crossings``
    null-material medium boundaries (the deterministic Scene::IntersectTr
    walk, scene.cpp:63-92).  Occlusion by real surfaces is the caller's."""
    if max_crossings <= 0:
        return segment_transmittance_det(scene, med_idx, o, d, t_end)
    R = o.shape[0]
    tr = torch.ones((R, 3), dtype=torch.float32, device=o.device)
    o_cur, med, remaining = o, med_idx, t_end
    for _ in range(max_crossings + 1):
        h = intersect(scene, o_cur, d, t_max=remaining)
        t_hit = torch.where(h.valid, torch.minimum(h.t, remaining), remaining)
        tr = tr * segment_transmittance_det(scene, med, o_cur, d, t_hit)
        crossing = h.valid & (h.material < 0) & (h.t < remaining)
        entering = dot(d, h.n) < 0.0
        med_next = torch.where(entering, h.medium_inside, h.medium_outside)
        med = torch.where(crossing, med_next, med)
        p_hit = o_cur + h.t[:, None] * d
        o_cur = torch.where(crossing[:, None], offset_ray_origin(p_hit, h.n, d),
                            o_cur)
        remaining = torch.where(crossing, remaining - t_hit,
                                torch.zeros_like(remaining))
    return tr


def sample_one_light(scene: Scene, rng: PCG32State, p, n, wo, mat_idx,
                     med_idx, is_surface, tangent=None, uv=None, duv_dx=None,
                     duv_dy=None, tr_crossings: int = 0, mis: bool = False,
                     light_distrib=None):
    """UniformSampleOneLight (integrator.cpp:54-83): pick one light,
    uniformly or from ``light_distrib`` (a ``lights.SpatialLightDistribution``:
    the "spatial" and "power" strategies), divide by its pick probability;
    EstimateDirect's light-sampling term with media transmittance, and
    with ``mis`` its scatter-sampled term too (two more draws).  ``rng`` is
    a bare PCG32 state or a sampler stream.  The BSDF reads the scene's
    kd textures at ``uv`` (at ``p[:, :2]`` where the caller passes none,
    as the reference's camera passes do), EWA-filtered with ``duv_dx``
    and ``duv_dy``.  Returns (rng, L (R,3))."""
    R = p.shape[0]
    n_lights = scene.n_lights
    if n_lights == 0:
        return rng, torch.zeros((R, 3), dtype=torch.float32, device=p.device)
    rng, u_pick = stream_1d(rng)
    if light_distrib is not None:
        light_idx, pick_pmf = sample_light_spatial(light_distrib, p, u_pick)
        inv_pick = (1.0 / torch.clamp_min(pick_pmf, 1e-12))[:, None]
    else:
        light_idx = torch.clamp_max((u_pick * n_lights).to(torch.int64),
                                    n_lights - 1)
        inv_pick = float(n_lights)
    rng, ua = stream_1d(rng)
    rng, ub = stream_1d(rng)
    u_scatter = None
    if mis:
        rng, sa = stream_1d(rng)
        rng, sb = stream_1d(rng)
        u_scatter = torch.stack([sa, sb], -1)
    contrib = _nee_one(scene, light_idx, p, n, wo, mat_idx, med_idx,
                       is_surface, torch.stack([ua, ub], -1), tangent=tangent,
                       uv=uv, duv_dx=duv_dx, duv_dy=duv_dy,
                       tr_crossings=tr_crossings, mis=mis,
                       u_scatter=u_scatter)
    return rng, contrib * inv_pick


def sample_all_lights(scene: Scene, rng: PCG32State, p, n, wo, mat_idx,
                      med_idx, is_surface, tangent=None, uv=None,
                      duv_dx=None, duv_dy=None, tr_crossings: int = 0,
                      mis: bool = False):
    """UniformSampleAllLights (integrator.cpp:54-83, strategy "all";
    common.py:261-294): EstimateDirect against every light, one sample
    each, summed in light order.  Returns (rng, L (R,3))."""
    R = p.shape[0]
    total = torch.zeros((R, 3), dtype=torch.float32, device=p.device)
    for li in range(scene.n_lights):
        rng, ua = stream_1d(rng)
        rng, ub = stream_1d(rng)
        u_scatter = None
        if mis:
            rng, sa = stream_1d(rng)
            rng, sb = stream_1d(rng)
            u_scatter = torch.stack([sa, sb], -1)
        total = total + _nee_one(
            scene, torch.full((R,), li, dtype=torch.int64, device=p.device),
            p, n, wo, mat_idx, med_idx, is_surface, torch.stack([ua, ub], -1),
            tangent=tangent, uv=uv, duv_dx=duv_dx, duv_dy=duv_dy,
            tr_crossings=tr_crossings, mis=mis, u_scatter=u_scatter)
    return rng, total


def _power_heuristic(fp, gp):
    """PowerHeuristic(1, fp, 1, gp) (sampling.cpp:66-70, beta = 2)."""
    f2 = fp * fp
    return torch.where(fp > 0, f2 / torch.clamp_min(f2 + gp * gp, 1e-30),
                       torch.zeros_like(fp))


def _nee_one(scene, light_idx, p, n, wo, mat_idx, med_idx, is_surface, u2,
             tangent=None, uv=None, duv_dx=None, duv_dy=None,
             tr_crossings: int = 0, mis: bool = False, u_scatter=None):
    """EstimateDirect for one light per lane (integrator.cpp:85-215,
    without the pick-probability factor; common.py:154-258).  The
    light-sampling term; with ``mis`` it is weighted by the power heuristic
    against the BSDF or phase pdf for the non-delta lights (area and
    infinite lights; the delta ones keep weight 1, integrator.cpp:100), and
    the scatter-sampled term is added: a direction from the BSDF
    (non-specular) or the phase function, traced to the light's shape for
    an area light, or escaping the scene for an infinite light, which adds
    its ``infinite_Le_pdf``.  ``u_scatter`` (R,2): the scatter-direction
    sample, needed with ``mis``."""
    ls = sample_li(scene, light_idx, p, u2)
    tex = dict(textures=scene.textures, p=p, uv=uv, duv_dx=duv_dx,
               duv_dy=duv_dy)
    f_surf, pdf_surf = eval_bsdf(scene.materials, mat_idx, n, wo, ls.wi,
                                 tangent=tangent, **tex)
    f_surf = f_surf * absdot(ls.wi, n)[:, None]
    _, _, g_here, _, _ = gather_medium(scene.media, med_idx)
    phase_l = hg_p(wo, ls.wi, g_here)
    f_med = phase_l[:, None].expand(-1, 3)
    f = torch.where(is_surface[:, None], f_surf, f_med)

    o_shadow = torch.where(is_surface[:, None],
                           offset_ray_origin(p, n, ls.wi), p)
    t_shadow = ls.dist * (1.0 - 1e-3)
    occluded = intersect_p(scene, o_shadow, ls.wi, t_shadow)
    tr = segment_transmittance_walk(scene, med_idx, o_shadow, ls.wi,
                                    t_shadow, tr_crossings)
    ok = ~occluded & (ls.pdf > 1e-12)
    contrib = f * ls.Li * tr / torch.where(ok, ls.pdf,
                                           torch.ones_like(ls.pdf))[:, None]
    contrib = torch.where(ok[:, None], contrib, torch.zeros_like(contrib))
    if not mis:
        return contrib

    one = torch.ones_like(ls.pdf)
    li = torch.clamp(light_idx, 0, max(scene.n_lights - 1, 0))
    ltype = scene.lights.ltype[li]
    area_l = ltype == LIGHT_DIFFUSE_AREA
    inf_l = ltype == LIGHT_INFINITE
    non_delta = area_l | inf_l
    # the light half's MIS weight: 1 for delta lights (integrator.cpp:100)
    pdf_scatter_at_wl = torch.where(is_surface, pdf_surf, phase_l)
    w_l = torch.where(non_delta, _power_heuristic(ls.pdf, pdf_scatter_at_wl),
                      one)
    contrib = contrib * w_l[:, None]

    # scatter-sampled half: the BSDF on surfaces, the phase function in media
    bs = sample_bsdf(scene.materials, mat_idx, n, wo, u_scatter,
                     mode=MODE_RADIANCE, tangent=tangent, **tex)
    wi_ph, pdf_ph = hg_sample_p(wo, g_here, u_scatter)
    surf3 = is_surface[:, None]
    ws = torch.where(surf3, bs.wi, wi_ph)
    f_ws = torch.where(surf3, bs.f * absdot(bs.wi, n)[:, None],
                       hg_p(wo, wi_ph, g_here)[:, None].expand(-1, 3))
    pdf_ws = torch.where(is_surface, bs.pdf, pdf_ph)
    live = non_delta & (pdf_ws > 1e-12) & torch.where(
        is_surface, bs.valid & ~bs.specular, torch.ones_like(is_surface))
    o2 = torch.where(surf3, offset_ray_origin(p, n, ws), p)
    h2 = intersect(scene, o2, ws)
    # an area light: the ray must hit this light's shape (Shape::Pdf(ref,
    # wi), shape.cpp:66-87: pdf_sa = dist^2 / (|cos| area))
    hit_light = h2.valid & (h2.area_light == li) & area_l
    Le_area = area_light_emitted(scene, h2.area_light, h2.n, -ws)
    cos2 = dot(h2.n, ws).abs()
    area = light_shape_area(scene, li)
    pdf_area_sa = (h2.t * h2.t) / torch.clamp_min(cos2 * area, 1e-12)
    Le2 = torch.where(hit_light[:, None], Le_area, torch.zeros_like(Le_area))
    pdf_l2 = torch.where(hit_light, pdf_area_sa, torch.zeros_like(one))
    add = hit_light
    if bool(scene.lights.kinds[LIGHT_INFINITE]):
        # an infinite light: the ray must escape (never a hit_light lane)
        Le_inf, pdf_inf = infinite_Le_pdf(scene, li, ws)
        escaped = ~h2.valid & inf_l
        Le2 = torch.where(escaped[:, None], Le_inf, Le2)
        pdf_l2 = torch.where(escaped, pdf_inf, pdf_l2)
        add = add | escaped
    t2 = torch.where(h2.valid, h2.t, torch.full_like(h2.t, 1e6)) * (1.0 - 1e-3)
    tr2 = segment_transmittance_walk(scene, med_idx, o2, ws, t2, tr_crossings)
    w_s = _power_heuristic(pdf_ws, pdf_l2)
    contrib2 = f_ws * Le2 * tr2 * (w_s / torch.clamp_min(pdf_ws, 1e-12))[:, None]
    add = (add & live)[:, None]
    return contrib + torch.where(add, contrib2, torch.zeros_like(contrib2))
