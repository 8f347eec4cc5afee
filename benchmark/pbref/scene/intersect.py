"""Vectorized ray-scene intersection (counterpart of
``bre_tpu/scene/intersect.py``), with the hits' surface uvs and the
ray-differential uv footprints.

A batch of rays tests every primitive as one (R, N) masked min, the
reference's dense sweep.  Where R x N passes ``SWEEP_ELEMENTS`` the sweep
runs over chunks of primitives (``_nearest_over_chunks``), with a chunk
width chosen from R so that each chunk's (R, C) intermediates stay within
that budget: first-min ties inside a chunk as ``argmin`` gives them, a
strict ``<`` across chunks, so the winner is the single sweep's bit for bit.
The reference's chunk of 8,192 primitives is a TPU memory choice and is not
carried over.  The chunked sweep runs detached, and the winner's t is
recomputed differentiably from its index (the same arithmetic, so the same
bits), so its autograd graph holds O(R), not O(R x N), intermediates.

Triangles of a scene with a tri-BVH (``Scene.tri_bvh``, attached by the
builder at ``builder.BVH_MIN_TRIANGLES``) are found by a per-ray stack walk
of the LBVH (``_tri_bvh_traverse``, the reference's ``vmap``-ed
``while_loop``) run as a lockstep loop over the lanes, then recomputed
differentiably from the returned index as in the reference
(intersect.py:330-340).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import math

import torch

from ..core.math import cross, dot, normalize
from .scene import SHAPE_SPHERE, SHAPE_TRIANGLE, Scene

BIG = 1e30
T_MIN = 1e-4
_EPS = 1e-7
# R x C budget of one chunk of the sweep: (R, C, 3) float32 intermediates
# of 0.8 GB each at 2^26 elements
SWEEP_ELEMENTS = 1 << 26
# traversal trips between the host reads that tell when every lane is done
TRIPS_PER_READ = 8
MAX_STACK = 64


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
    uv: torch.Tensor  # (R, 2) surface uv (sphere (phi/2pi, theta/pi))
    tangent: torch.Tensor  # (R, 3) BSDF-frame ss axis
    ns: torch.Tensor  # (R, 3) shading normal


def _sphere_t(oc, d, a, rr, r_pos, tmn, tmx):
    """The stable-quadratic t of ``ray_sphere`` from oc = o - center, the
    ray direction, a = d.d and rr = radius^2, broadcast elementwise."""
    b = 2.0 * dot(oc, d)
    c = dot(oc, oc) - rr
    disc = b * b - 4.0 * a * c
    ok = (disc > 0.0) & r_pos
    one = torch.ones_like(disc)
    sqrt_d = torch.sqrt(torch.where(ok, disc, one))
    sign_b = torch.where(b >= 0.0, one, -one)
    q = -0.5 * (b + sign_b * sqrt_d)
    t0 = q / a
    t1 = c / torch.where(q == 0.0, one, q)
    t1 = torch.where(q == 0.0, t0, t1)
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    use_lo = (lo > tmn) & (lo < tmx)
    use_hi = (hi > tmn) & (hi < tmx)
    big = torch.full_like(disc, BIG)
    t = torch.where(use_lo, lo, torch.where(use_hi, hi, big))
    return torch.where(ok, t, big)


def ray_sphere(o, d, center, radius, t_min, t_max):
    """(R,3),(R,3) x (N,3),(N,) -> (R,N) nearest t in (t_min, t_max) or BIG
    (stable quadratic, reference sphere.cpp:117-170)."""
    return _sphere_t(o[:, None, :] - center[None, :, :], d[:, None, :],
                     dot(d, d)[:, None], (radius * radius)[None, :],
                     (radius > 0.0)[None, :], t_min[:, None], t_max[:, None])


def _ray_sphere_pairwise(o, d, center, radius, t_min, t_max):
    """Ray i against sphere i: (R,) t or BIG, ``ray_sphere``'s bits."""
    return _sphere_t(o - center, d, dot(d, d), radius * radius, radius > 0.0,
                     t_min, t_max)


def _triangle_t(dv, tv, e1, e2, tmn, tmx):
    """Moller-Trumbore's t from the direction, tv = o - p0 and the edges
    e1 = p1 - p0, e2 = p2 - p0, all broadcast to one shape (..., 3)."""
    pv = cross(dv, e2)
    det = dot(e1, pv)
    ok = det.abs() > _EPS
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
    u = dot(tv, pv) * inv_det
    qv = cross(tv, e1)
    v = dot(dv, qv) * inv_det
    t = dot(e2, qv) * inv_det
    inside = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    in_range = (t > tmn) & (t < tmx)
    return torch.where(ok & inside & in_range, t, torch.full_like(t, BIG))


def ray_triangle(o, d, p0, p1, p2, t_min, t_max):
    """Moller-Trumbore: (R,N) t or BIG (reference intersect.py:97-117)."""
    R, N = o.shape[0], p0.shape[0]
    e1 = (p1 - p0)[None, :, :]
    e2 = (p2 - p0)[None, :, :]
    tv = o[:, None, :] - p0[None, :, :]
    return _triangle_t(d[:, None, :].expand(-1, N, -1), tv,
                       e1.expand(R, -1, -1), e2.expand(R, -1, -1),
                       t_min[:, None], t_max[:, None])


def _ray_tri_pairwise(o, d, p0, p1, p2, t_min, t_max):
    """Ray i against triangle i: (R,) t or BIG, ``ray_triangle``'s bits
    (intersect.py:179-194)."""
    return _triangle_t(d, o - p0, p1 - p0, p2 - p0, t_min, t_max)


def _nearest(ts):
    return ts.amin(1), ts.argmin(1)


def _chunk_width(R: int) -> int:
    return max(1, SWEEP_ELEMENTS // max(R, 1))


def _nearest_over_chunks(prim_ts, N: int, R: int, dev):
    """Running (best_t, best_idx) of ``prim_ts(lo, hi) -> (R, hi - lo)``
    over chunks of ``_chunk_width(R)`` primitives (intersect.py:127-159):
    ``argmin``'s first minimum inside a chunk, a strict ``<`` across
    chunks, so the global first minimum, as one sweep gives it."""
    C = _chunk_width(R)
    best_t = torch.full((R,), BIG, dtype=torch.float32, device=dev)
    best_i = torch.zeros((R,), dtype=torch.int64, device=dev)
    for lo in range(0, N, C):
        tb, i = _nearest(prim_ts(lo, min(lo + C, N)))
        better = tb < best_t
        best_t = torch.where(better, tb, best_t)
        best_i = torch.where(better, i + lo, best_i)
    return best_t, best_i


def _sweep(ts_fn, pair_fn, N: int, R: int, dev):
    """Nearest t and index over N primitives: one (R, N) sweep where it
    fits ``SWEEP_ELEMENTS``, differentiable through its min as the
    reference's; else the detached chunked sweep, with the winner's t
    recomputed differentiably by ``pair_fn(i)`` (same bits)."""
    if N <= _chunk_width(R):
        return _nearest(ts_fn(0, N))
    with torch.no_grad():
        best_t, i = _nearest_over_chunks(ts_fn, N, R, dev)
    t = torch.where(best_t < BIG, pair_fn(i), torch.full_like(best_t, BIG))
    return t, i


class _TraversalStats:
    """Counts of the tri-BVH walk, for the measurements: calls, loop trips
    and host reads (host-side counters, free)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.calls = self.trips = self.host_reads = self.max_trips = 0

    def as_dict(self):
        return dict(calls=self.calls, trips=self.trips,
                    host_reads=self.host_reads, max_trips=self.max_trips)


TRAVERSAL_STATS = _TraversalStats()


def _use_tri_bvh(scene: Scene) -> bool:
    return scene.tri_bvh is not None and scene.tri_bvh.n_leaves > 1


def _slab(box, oo, inv, tmn):
    """(near, far) of boxes (..., 6) along their rays, the far end before
    the running best is folded in (the reference's ``box_hit``)."""
    lo = (box[..., :3] - oo) * inv
    hi = (box[..., 3:] - oo) * inv
    tn = torch.maximum(torch.minimum(lo, hi).amax(-1), tmn)
    return tn, torch.maximum(lo, hi).amin(-1)


def _trip(w: dict, tabs, any_hit: bool) -> None:
    """One trip of the lockstep walk, in place on the lanes' state ``w``
    (sp, stack, best_t, best_i; the rays o, d, inv_d, t_min, t_max):
    each live lane pops a node and handles its left child, then its right
    one."""
    kids, boxes, tri_tab, prim_ids, occludes = tabs
    o, d, t_min, t_max = w["o"], w["d"], w["t_min"], w["t_max"]
    act = w["sp"] > 0
    sp = w["sp"] - act.long()
    c = kids[w["stack"].gather(1, sp[:, None]).squeeze(1)]  # (A, 2)
    leaf = c < 0
    pid = prim_ids[torch.where(leaf, ~c, 0)]
    tt = tri_tab[pid]  # (A, 2, 9): p0, p1 - p0, p2 - p0
    t = _triangle_t(d[:, None].expand(-1, 2, -1), o[:, None] - tt[..., :3],
                    tt[..., 3:6], tt[..., 6:], t_min[:, None], t_max[:, None])
    if any_hit:
        t = torch.where(occludes[pid], t, torch.full_like(t, BIG))
    tn, tf = _slab(boxes[torch.where(leaf, 0, c)], o[:, None],
                   w["inv_d"][:, None], t_min[:, None])
    # the left child, then the right one against the best after it; an
    # internal child's push tests the best after its own turn (a leaf's
    # turn moves the best, an internal child's does not)
    hit_leaf = act[:, None] & leaf
    better = hit_leaf[:, 0] & (t[:, 0] < w["best_t"])
    best_t = torch.where(better, t[:, 0], w["best_t"])
    best_i = torch.where(better, pid[:, 0], w["best_i"])
    best_l = best_t
    better = hit_leaf[:, 1] & (t[:, 1] < best_t)
    best_t = torch.where(better, t[:, 1], best_t)
    best_i = torch.where(better, pid[:, 1], best_i)
    push = (act[:, None] & ~leaf & (tn <= torch.minimum(
        tf, torch.minimum(torch.stack([best_l, best_t], 1),
                          t_max[:, None]))))
    do_l = push[:, 0] & (sp < MAX_STACK)
    sp_r = sp + do_l.long()
    do_r = push[:, 1] & (sp_r < MAX_STACK)
    trash = torch.full_like(sp, MAX_STACK)
    w["stack"].scatter_(1, torch.stack([torch.where(do_l, sp, trash),
                                        torch.where(do_r, sp_r, trash)], 1),
                        c)
    sp = sp_r + do_r.long()
    if any_hit:
        sp = torch.where(best_t < BIG, torch.zeros_like(sp), sp)
    w["sp"].copy_(sp)
    w["best_t"].copy_(best_t)
    w["best_i"].copy_(best_i)


def _walk_state(scene: Scene, o, d, t_min, t_max):
    """The walk's tables (child pairs, node boxes, triangles as p0, p1 - p0,
    p2 - p0, leaf primitives, occluders) and its lanes' state at the root,
    all detached."""
    bvh, tri = scene.tri_bvh, scene.triangles
    o, d, t_min, t_max = (x.detach().contiguous()
                          for x in (o, d, t_min, t_max))
    R, dev = o.shape[0], o.device
    p0 = tri.p0.detach()
    tabs = (torch.stack([bvh.left_child, bvh.right_child], 1),
            torch.cat([bvh.node_min, bvh.node_max], 1),
            torch.cat([p0, tri.p1.detach() - p0, tri.p2.detach() - p0], 1),
            bvh.prim_ids, tri.material >= 0)
    big = torch.full((R,), BIG, dtype=torch.float32, device=dev)
    inv_d = 1.0 / torch.where(d.abs() < 1e-20, torch.full_like(d, 1e-20), d)
    tn0, tf0 = _slab(tabs[1][0], o, inv_d, t_min)
    w = dict(o=o, d=d, inv_d=inv_d, t_min=t_min, t_max=t_max,
             sp=(tn0 <= torch.minimum(tf0, torch.minimum(big, t_max))).long(),
             # one column past the stack takes the pushes that do not happen
             stack=torch.zeros((R, MAX_STACK + 1), dtype=torch.int64,
                               device=dev),
             best_t=big.clone(),
             best_i=torch.zeros((R,), dtype=torch.int64, device=dev))
    return tabs, w


def _tri_bvh_traverse(scene: Scene, o, d, t_min, t_max, any_hit: bool):
    """Per-ray LBVH walk over the triangles (intersect.py:197-295): the
    reference's ``while_loop`` with a 64-deep stack per ray, ``vmap``-ed so
    that lanes run in lockstep, here a loop whose trips (``_trip``) pop one
    node per live lane.  A popped node handles its left child, then its
    right one: a leaf's triangle replaces the best hit on a strictly smaller
    t; an internal child whose box (slab test against the running best) is
    met is pushed, left first, so the right child is popped first.  A push
    at a full stack is dropped.  With ``any_hit`` only surfaces with a
    material occlude and a lane stops at its first occluder.  Everything is
    detached: the caller recomputes the winner's t differentiably.

    A host read every ``TRIPS_PER_READ`` trips ends the loop when no lane
    is live.  On the CPU the lanes that are done are dropped there (1.6-7x
    faster than keeping them, the same bits: tests/torch_walk_cpu_timing.py);
    on a card, where a trip's ~90 small kernels cost their launches, the lanes
    stay and the trips between two reads are one CUDA graph, captured after
    the first reads' trips ran eagerly and replayed.  Returns (best_t (R,),
    best_idx (R,) int64); for ``any_hit`` only best_t < BIG means
    something."""
    tabs, w = _walk_state(scene, o, d, t_min, t_max)
    R, dev = o.shape[0], o.device
    out_t, out_i = w["best_t"].clone(), w["best_i"].clone()
    lanes = torch.arange(R, device=dev)
    st = TRAVERSAL_STATS
    st.calls += 1
    trips, graph = 0, None
    while True:
        st.host_reads += 1
        live = w["sp"] > 0
        if dev.type != "cuda":
            out_t[lanes], out_i[lanes] = w["best_t"], w["best_i"]
        if not bool(live.any()):
            break
        if dev.type != "cuda":
            keep = live.nonzero().squeeze(1)
            if keep.shape[0] < lanes.shape[0]:
                lanes = lanes[keep]
                w = {k: v[keep] for k, v in w.items()}
        if graph is not None:
            graph.replay()
        elif trips == 0 or dev.type != "cuda":
            for _ in range(TRIPS_PER_READ):
                _trip(w, tabs, any_hit)
        else:
            # captured on a side stream without torch.cuda.graph's
            # synchronize, gc and empty_cache, which every query would pay
            graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                graph.capture_begin()
                for _ in range(TRIPS_PER_READ):
                    _trip(w, tabs, any_hit)
                graph.capture_end()
            torch.cuda.current_stream(dev).wait_stream(side)
            graph.replay()
        trips += TRIPS_PER_READ
    st.trips += trips
    st.max_trips = max(st.max_trips, trips)
    if dev.type == "cuda":
        return w["best_t"], w["best_i"]
    return out_t, out_i


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
        tbest, i = _sweep(
            lambda lo, hi: ray_sphere(o, d, sph.center[lo:hi],
                                      sph.radius[lo:hi], t_min, t_max),
            lambda i: _ray_sphere_pairwise(o, d, sph.center[i], sph.radius[i],
                                           t_min, t_max), Ns, R, dev)
        better = tbest < best_t
        best_t = torch.where(better, tbest, best_t)
        best_kind = torch.where(better, SHAPE_SPHERE, best_kind)
        best_idx = torch.where(better, torch.clamp_max(i, Ns - 1), best_idx)
    if Nt > 0:
        def pair(i):
            return _ray_tri_pairwise(o, d, tri.p0[i], tri.p1[i], tri.p2[i],
                                     t_min, t_max)

        if _use_tri_bvh(scene):
            t_ng, i = _tri_bvh_traverse(scene, o, d, t_min, t_max,
                                        any_hit=False)
            tbest = torch.where(t_ng < BIG, pair(i), torch.full_like(t_ng,
                                                                     BIG))
        else:
            tbest, i = _sweep(
                lambda lo, hi: ray_triangle(o, d, tri.p0[lo:hi],
                                            tri.p1[lo:hi], tri.p2[lo:hi],
                                            t_min, t_max), pair, Nt, R, dev)
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
    uv = torch.zeros((R, 2), dtype=torch.float32, device=dev)
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
        # uv = b0 uv0 + b1 uv1 + b2 uv2 (triangle.cpp:171)
        uv_t = ((1.0 - b1 - b2)[:, None] * tri.uv0[ii]
                + b1[:, None] * tri.uv1[ii] + b2[:, None] * tri.uv2[ii])
        uv = torch.where(is_t[:, None], uv_t, uv)
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
        # sphere uv (sphere.cpp): phi / 2pi, theta / pi
        phi = torch.atan2(n_s[:, 1], n_s[:, 0])
        phi = torch.where(phi < 0, phi + 2.0 * math.pi, phi)
        theta = torch.acos(torch.clamp(n_s[:, 2], -1.0, 1.0))
        uv_s = torch.stack([phi / (2.0 * math.pi), theta / math.pi], -1)
        uv = torch.where(is_s[:, None], uv_s, uv)
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
               prim_kind=best_kind, prim_index=best_idx, uv=uv,
               tangent=tangent, ns=ns)


def intersect_p(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                t_max: torch.Tensor) -> torch.Tensor:
    """Any-hit shadow query; boundary-only surfaces (no material) never
    occlude (IntersectTr semantics, scene.cpp:63-92).  Chunked as
    ``intersect`` where R x N passes ``SWEEP_ELEMENTS``
    (intersect.py:495-538); the tri-BVH's walk stops at a lane's first
    occluder."""
    R = o.shape[0]
    t_min = torch.full((R,), T_MIN, dtype=torch.float32, device=o.device)
    occluded = torch.zeros((R,), dtype=torch.bool, device=o.device)
    C = _chunk_width(R)
    with torch.no_grad():
        if scene.n_spheres > 0:
            sph = scene.spheres
            for lo in range(0, scene.n_spheres, C):
                ts = ray_sphere(o, d, sph.center[lo:lo + C],
                                sph.radius[lo:lo + C], t_min, t_max)
                occluded |= ((ts < BIG)
                             & (sph.material[lo:lo + C] >= 0)[None, :]).any(1)
        if scene.n_triangles > 0:
            tri = scene.triangles
            if _use_tri_bvh(scene):
                t_any, _ = _tri_bvh_traverse(scene, o, d, t_min, t_max,
                                             any_hit=True)
                occluded |= t_any < BIG
            else:
                for lo in range(0, scene.n_triangles, C):
                    ts = ray_triangle(o, d, tri.p0[lo:lo + C],
                                      tri.p1[lo:lo + C], tri.p2[lo:lo + C],
                                      t_min, t_max)
                    occluded |= ((ts < BIG) & (tri.material[lo:lo + C]
                                               >= 0)[None, :]).any(1)
    return occluded


def hit_dpduv(scene: Scene, h: Hit):
    """dp/du and dp/dv at the hits (intersect.py:540-575; sphere.cpp,
    triangle.cpp): a sphere's (uv = phi/2pi, theta/pi) dpdu = 2pi (-l_y,
    l_x, 0), dpdv = pi (l_z cos phi, l_z sin phi, -r sin theta) with
    l = p - center; a triangle's p1 - p0 and p2 - p0.  (R,3) each."""
    R = h.p.shape[0]
    dpdu = torch.zeros((R, 3), dtype=torch.float32, device=h.p.device)
    dpdv = torch.zeros_like(dpdu)
    zero = dpdu[:, 0]
    if scene.n_spheres > 0:
        c = scene.spheres.center[h.prim_index.clamp_max(scene.n_spheres - 1)]
        rel = h.p - c
        du = 2.0 * math.pi * torch.stack([-rel[:, 1], rel[:, 0], zero], -1)
        zr = torch.sqrt(torch.clamp_min(rel[:, 0] ** 2 + rel[:, 1] ** 2, 1e-12))
        dv = math.pi * torch.stack([rel[:, 2] * (rel[:, 0] / zr),
                                    rel[:, 2] * (rel[:, 1] / zr), -zr], -1)
        is_s = (h.prim_kind == SHAPE_SPHERE)[:, None]
        dpdu = torch.where(is_s, du, dpdu)
        dpdv = torch.where(is_s, dv, dpdv)
    if scene.n_triangles > 0:
        tri = scene.triangles
        ii = h.prim_index.clamp_max(scene.n_triangles - 1)
        is_t = (h.prim_kind == SHAPE_TRIANGLE)[:, None]
        dpdu = torch.where(is_t, tri.p1[ii] - tri.p0[ii], dpdu)
        dpdv = torch.where(is_t, tri.p2[ii] - tri.p0[ii], dpdv)
    return dpdu, dpdv


def compute_uv_differentials(scene: Scene, h: Hit, o, d, rx_o, rx_d, ry_o,
                             ry_d):
    """SurfaceInteraction::ComputeDifferentials (intersect.py:578-617):
    the two offset rays meet the hit's tangent plane, and the least-squares
    2x2 system dp = dpdu du + dpdv dv gives (duv_dx, duv_dy) (R,2) each;
    zero where the hit is invalid or an offset ray runs parallel."""
    n = h.n
    pn = dot(h.p, n)

    def plane_hit(oo, dd):
        dn = dot(dd, n)
        ok = dn.abs() >= 1e-9
        tt = (pn - dot(oo, n)) / torch.where(ok, dn, torch.ones_like(dn))
        return oo + tt[:, None] * dd, ok

    px, okx = plane_hit(rx_o, rx_d)
    py, oky = plane_hit(ry_o, ry_d)
    dpdu, dpdv = hit_dpduv(scene, h)
    a11 = dot(dpdu, dpdu)
    a12 = dot(dpdu, dpdv)
    a22 = dot(dpdv, dpdv)
    det = a11 * a22 - a12 * a12
    ok = okx & oky & h.valid & (det > 1e-18)
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))

    def solve(dp):
        b1 = dot(dpdu, dp)
        b2 = dot(dpdv, dp)
        return torch.stack([(a22 * b1 - a12 * b2) * inv_det,
                            (a11 * b2 - a12 * b1) * inv_det], -1)

    okc = ok[:, None]
    zero = torch.zeros((ok.shape[0], 2), dtype=torch.float32, device=n.device)
    return (torch.where(okc, solve(px - h.p), zero),
            torch.where(okc, solve(py - h.p), zero))
