"""Vectorized ray-scene intersection, dense path (counterpart of
``bre_tpu/scene/intersect.py:63-117, 301-356, 485-537``).

A batch of rays tests every primitive as one (R, N) masked min — the
reference's single-chunk sweep.  Scenes above ``MAX_DENSE_PRIMS`` primitives
(the chunked sweep, the tri-BVH) are rejected by ``scene.check_slice``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.math import cross, dot, normalize
from .scene import SHAPE_SPHERE, SHAPE_TRIANGLE, Scene

BIG = 1e30
T_MIN = 1e-4
_EPS = 1e-7


class Hit(NamedTuple):
    """SoA hit record (geometry subset of pbrt's SurfaceInteraction)."""

    valid: torch.Tensor  # (R,) bool
    t: torch.Tensor  # (R,) hit distance in units of |d|
    p: torch.Tensor  # (R, 3)
    n: torch.Tensor  # (R, 3) outward geometric normal (unit)
    material: torch.Tensor  # (R,) int64
    medium_inside: torch.Tensor
    medium_outside: torch.Tensor
    area_light: torch.Tensor
    prim_kind: torch.Tensor  # (R,) int64 SHAPE_* or -1
    prim_index: torch.Tensor  # (R,) int64
    tangent: torch.Tensor  # (R, 3) BSDF-frame ss axis
    ns: torch.Tensor  # (R, 3) shading normal


def ray_sphere(o, d, center, radius, t_min, t_max):
    """(R,3),(R,3) x (N,3),(N,) -> (R,N) nearest t in (t_min, t_max) or BIG
    (stable quadratic, reference sphere.cpp:117-170)."""
    oc = o[:, None, :] - center[None, :, :]
    a = dot(d, d)[:, None]
    b = 2.0 * dot(oc, d[:, None, :])
    c = dot(oc, oc) - (radius * radius)[None, :]
    disc = b * b - 4.0 * a * c
    ok = (disc > 0.0) & (radius > 0.0)[None, :]
    one = torch.ones_like(disc)
    sqrt_d = torch.sqrt(torch.where(ok, disc, one))
    sign_b = torch.where(b >= 0.0, one, -one)
    q = -0.5 * (b + sign_b * sqrt_d)
    t0 = q / a
    t1 = c / torch.where(q == 0.0, one, q)
    t1 = torch.where(q == 0.0, t0, t1)
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    tmn = t_min[:, None]
    tmx = t_max[:, None]
    use_lo = (lo > tmn) & (lo < tmx)
    use_hi = (hi > tmn) & (hi < tmx)
    big = torch.full_like(disc, BIG)
    t = torch.where(use_lo, lo, torch.where(use_hi, hi, big))
    return torch.where(ok, t, big)


def ray_triangle(o, d, p0, p1, p2, t_min, t_max):
    """Moller-Trumbore: (R,N) t or BIG (reference intersect.py:97-117)."""
    e1 = (p1 - p0)[None, :, :]
    e2 = (p2 - p0)[None, :, :]
    dv = d[:, None, :]
    pv = cross(dv.expand(-1, e2.shape[1], -1), e2.expand(dv.shape[0], -1, -1))
    det = dot(e1, pv)
    ok = det.abs() > _EPS
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tv = o[:, None, :] - p0[None, :, :]
    u = dot(tv, pv) * inv_det
    qv = cross(tv, e1.expand_as(tv))
    v = dot(dv, qv) * inv_det
    t = dot(e2, qv) * inv_det
    inside = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    in_range = (t > t_min[:, None]) & (t < t_max[:, None])
    return torch.where(ok & inside & in_range, t, torch.full_like(t, BIG))


def _nearest(ts):
    return ts.amin(1), ts.argmin(1)


def intersect(scene: Scene, o: torch.Tensor, d: torch.Tensor,
              t_max: Optional[torch.Tensor] = None) -> Hit:
    """Nearest-hit query for a ray batch (Scene::Intersect, scene.cpp:37-44)."""
    R = o.shape[0]
    dev = o.device
    if t_max is None:
        t_max = torch.full((R,), BIG, dtype=torch.float32, device=dev)
    t_min = torch.full((R,), T_MIN, dtype=torch.float32, device=dev)
    best_t = torch.full((R,), BIG, dtype=torch.float32, device=dev)
    best_kind = torch.full((R,), -1, dtype=torch.int64, device=dev)
    best_idx = torch.zeros((R,), dtype=torch.int64, device=dev)
    sph, tri = scene.spheres, scene.triangles
    Ns, Nt = scene.n_spheres, scene.n_triangles

    if Ns > 0:
        tbest, i = _nearest(ray_sphere(o, d, sph.center, sph.radius,
                                       t_min, t_max))
        better = tbest < best_t
        best_t = torch.where(better, tbest, best_t)
        best_kind = torch.where(better, SHAPE_SPHERE, best_kind)
        best_idx = torch.where(better, torch.clamp_max(i, Ns - 1), best_idx)
    if Nt > 0:
        tbest, i = _nearest(ray_triangle(o, d, tri.p0, tri.p1, tri.p2,
                                         t_min, t_max))
        better = tbest < best_t
        best_t = torch.where(better, tbest, best_t)
        best_kind = torch.where(better, SHAPE_TRIANGLE, best_kind)
        best_idx = torch.where(better, torch.clamp_max(i, Nt - 1), best_idx)

    valid = best_t < BIG
    p = o + best_t[:, None] * d
    is_s = best_kind == SHAPE_SPHERE
    is_t = best_kind == SHAPE_TRIANGLE

    def gather(sph_arr, tri_arr):
        out = torch.full_like(best_idx, -1)
        if Ns > 0:
            out = torch.where(is_s, sph_arr[best_idx.clamp_max(Ns - 1)], out)
        if Nt > 0:
            out = torch.where(is_t, tri_arr[best_idx.clamp_max(Nt - 1)], out)
        return out

    material = gather(sph.material, tri.material)
    medium_inside = gather(sph.medium_inside, tri.medium_inside)
    medium_outside = gather(sph.medium_outside, tri.medium_outside)
    area_light = gather(sph.area_light, tri.area_light)

    n = torch.zeros_like(p)
    tangent = torch.zeros_like(p)
    ns = None
    if Nt > 0:
        ii = best_idx.clamp_max(Nt - 1)
        q0 = tri.p0[ii]
        e1 = tri.p1[ii] - q0
        e2 = tri.p2[ii] - q0
        n = torch.where(is_t[:, None], normalize(cross(e1, e2)), n)
        tangent = torch.where(is_t[:, None], tri.tangent[ii], tangent)
        # shading normal from per-vertex normals where the mesh has them,
        # with the geometric normal face-forwarded into its hemisphere
        # (Triangle::Intersect, reference intersect.py:446-466)
        rel = p - q0
        d11 = dot(e1, e1)
        d12 = dot(e1, e2)
        d22 = dot(e2, e2)
        dr1 = dot(rel, e1)
        dr2 = dot(rel, e2)
        det = torch.clamp_min(d11 * d22 - d12 * d12, 1e-20)
        b1 = (d22 * dr1 - d12 * dr2) / det
        b2 = (d11 * dr2 - d12 * dr1) / det
        vn0, vn1, vn2 = tri.n0[ii], tri.n1[ii], tri.n2[ii]
        has_vn = vn0.abs().sum(-1) > 0.0
        ns_t = normalize((1.0 - b1 - b2)[:, None] * vn0 + b1[:, None] * vn1
                         + b2[:, None] * vn2)
        use_vn = is_t & has_vn
        flip_n = torch.where(dot(ns_t, n) < 0.0, -1.0, 1.0)
        n = torch.where(use_vn[:, None], n * flip_n[:, None], n)
        ns = torch.where(use_vn[:, None], ns_t, n)
    if Ns > 0:
        c = sph.center[best_idx.clamp_max(Ns - 1)]
        n_s = normalize(p - c)
        n = torch.where(is_s[:, None], n_s, n)
        # sphere dpdu (sphere.cpp:137): (-y, x, 0) about the center
        rel_s = p - c
        t_s = torch.stack([-rel_s[:, 1], rel_s[:, 0],
                           torch.zeros_like(rel_s[:, 0])], -1)
        t_len = torch.sqrt((t_s * t_s).sum(-1, keepdim=True))
        t_s = torch.where(t_len > 1e-9, t_s / torch.clamp_min(t_len, 1e-12),
                          torch.zeros_like(t_s))
        tangent = torch.where(is_s[:, None], t_s, tangent)
        if ns is not None:
            ns = torch.where(is_s[:, None], n_s, ns)
    if ns is None:
        ns = n

    return Hit(valid=valid, t=torch.where(valid, best_t, t_max), p=p, n=n,
               material=material, medium_inside=medium_inside,
               medium_outside=medium_outside, area_light=area_light,
               prim_kind=best_kind, prim_index=best_idx, tangent=tangent,
               ns=ns)


def intersect_p(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                t_max: torch.Tensor) -> torch.Tensor:
    """Any-hit shadow query; boundary-only surfaces (no material) never
    occlude (IntersectTr semantics, scene.cpp:63-92)."""
    R = o.shape[0]
    t_min = torch.full((R,), T_MIN, dtype=torch.float32, device=o.device)
    occluded = torch.zeros((R,), dtype=torch.bool, device=o.device)
    if scene.n_spheres > 0:
        sph = scene.spheres
        ts = ray_sphere(o, d, sph.center, sph.radius, t_min, t_max)
        occluded |= ((ts < BIG) & (sph.material >= 0)[None, :]).any(1)
    if scene.n_triangles > 0:
        tri = scene.triangles
        ts = ray_triangle(o, d, tri.p0, tri.p1, tri.p2, t_min, t_max)
        occluded |= ((ts < BIG) & (tri.material >= 0)[None, :]).any(1)
    return occluded
