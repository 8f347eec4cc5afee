"""Shared integrator pieces: next-event estimation and segment transmittance
(counterpart of ``bre_tpu/integrators/common.py:30-206``; pbrt
integrator.cpp:54-160, scene.cpp:63-92)."""

from __future__ import annotations

import torch

from ..core.math import absdot, dot, offset_ray_origin
from ..core.rng import PCG32State
from ..core.samplers import stream_1d
from ..lights import sample_li
from ..materials import eval_bsdf
from ..media import gather_medium, hg_p
from ..scene.intersect import intersect, intersect_p
from ..scene.scene import Scene
from .photon_trace import _segment_tr


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
                     med_idx, is_surface, tangent=None, tr_crossings: int = 0):
    """UniformSampleOneLight (integrator.cpp:54-83): pick one light
    uniformly, divide by its pick probability; the light-sampling term of
    EstimateDirect with media transmittance.  Returns (rng, L (R,3))."""
    R = p.shape[0]
    n_lights = scene.n_lights
    if n_lights == 0:
        return rng, torch.zeros((R, 3), dtype=torch.float32, device=p.device)
    rng, u_pick = stream_1d(rng)
    light_idx = torch.clamp_max((u_pick * n_lights).to(torch.int64),
                                n_lights - 1)
    rng, ua = stream_1d(rng)
    rng, ub = stream_1d(rng)
    contrib = _nee_one(scene, light_idx, p, n, wo, mat_idx, med_idx,
                       is_surface, torch.stack([ua, ub], -1),
                       tr_crossings=tr_crossings)
    return rng, contrib * float(n_lights)


def _nee_one(scene, light_idx, p, n, wo, mat_idx, med_idx, is_surface, u2,
             tr_crossings: int = 0):
    """EstimateDirect's light-sampling term for one light per lane
    (integrator.cpp:85-160, without the pick-probability factor)."""
    ls = sample_li(scene, light_idx, p, u2)
    f_surf, _ = eval_bsdf(scene.materials, mat_idx, n, wo, ls.wi)
    f_surf = f_surf * absdot(ls.wi, n)[:, None]
    _, _, g_here, _, _ = gather_medium(scene.media, med_idx)
    f_med = hg_p(wo, ls.wi, g_here)[:, None].expand(-1, 3)
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
    return torch.where(ok[:, None], contrib, torch.zeros_like(contrib))
