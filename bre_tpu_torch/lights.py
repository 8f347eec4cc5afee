"""Lights: emission sampling (Sample_Le) and its density (Pdf_Le), NEE
sampling (Sample_Li), power and the light-pick distributions — point lights
and diffuse area lights on triangles and spheres (counterpart of
``bre_tpu/lights.py``; pbrt lights/point.cpp, lights/diffuse.cpp,
shapes/sphere.cpp, integrator.cpp:217-226, lightdistrib.cpp).

As in the reference, every lane evaluates each light type's math and a
per-lane type mask picks the result.  Other light types are ROADMAP Queue 1
"breadth"; ``scene.check_slice`` rejects them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .core.math import (INV_4PI, PI, coordinate_system, cross, dot, length,
                        length_squared, normalize)
from .core.rng import pcg32_init, pcg32_next_f32
from .core.sampling import (Distribution1D, cosine_hemisphere_pdf,
                            cosine_sample_hemisphere, make_distribution_1d,
                            uniform_sample_sphere, uniform_sample_triangle)
from .core.spectrum import luminance
from .scene.scene import (LIGHT_DIFFUSE_AREA, LIGHT_POINT, SHAPE_SPHERE,
                          SHAPE_TRIANGLE, Scene)


def _shape_area(scene: Scene, kind, index) -> torch.Tensor:
    """The area of each entry's light shape (Shape::Area) in the arithmetic
    of ``light_power``, ``pdf_le`` and ``light_shape_area``
    (lights.py:130-138, 611-622, 666-673; 4 pi r^2 with r squared first);
    1 where there is no shape."""
    area = torch.ones(kind.shape, dtype=torch.float32, device=kind.device)
    if scene.n_spheres > 0:
        sidx = torch.clamp(index, 0, scene.n_spheres - 1)
        area = torch.where(kind == SHAPE_SPHERE,
                           4.0 * PI * scene.spheres.radius[sidx] ** 2, area)
    if scene.n_triangles > 0:
        tri = scene.triangles
        tidx = torch.clamp(index, 0, scene.n_triangles - 1)
        e1 = tri.p1[tidx] - tri.p0[tidx]
        e2 = tri.p2[tidx] - tri.p0[tidx]
        area = torch.where(kind == SHAPE_TRIANGLE,
                           0.5 * length(cross(e1, e2)), area)
    return area


def light_power(scene: Scene) -> torch.Tensor:
    """Power() per light (light.h:73), (Nl, 3): point 4*pi*I
    (point.cpp:59), diffuse area L*area*pi*(1 or 2) (diffuse.cpp:35-39)."""
    L = scene.lights
    area = _shape_area(scene, L.shape_kind, L.shape_index)
    sides = torch.where(L.two_sided > 0, 2.0, 1.0)
    p_point = 4.0 * PI * L.emit
    p_area = (sides * area * PI)[:, None] * L.emit
    return torch.where((L.ltype == LIGHT_POINT)[:, None], p_point, p_area)


def light_power_distribution(scene: Scene) -> Distribution1D:
    """ComputeLightPowerDistribution (integrator.cpp:217-226)."""
    return make_distribution_1d(luminance(light_power(scene)))


class SpatialLightDistribution(NamedTuple):
    """The voxel light-pick table (lightdistrib.{h,cpp}
    SpatialLightDistribution, volpath's default "spatial" strategy),
    computed for every voxel at once (lights.py:176-194)."""

    pmf: torch.Tensor  # (V, L) per-voxel light probabilities
    cdf: torch.Tensor  # (V, L) inclusive running sums of pmf
    res: int
    wmin: torch.Tensor  # (3,)
    inv_extent: torch.Tensor  # (3,)


def _running_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive sums over the last (light) axis, added in index order."""
    out = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., i])
    return torch.stack(out, -1)


def _pick_table(w: torch.Tensor, scene: Scene, res: int
                ) -> SpatialLightDistribution:
    """Rows of light weights (V, L) -> the normalized pick table; an
    all-zero row picks uniformly."""
    wsum = _running_sum(w)[..., -1:]
    w = torch.where(wsum > 0.0, w, torch.ones_like(w))
    pmf = w / _running_sum(w)[..., -1:]
    extent = torch.clamp_min(scene.world_max - scene.world_min, 1e-6)
    return SpatialLightDistribution(pmf, _running_sum(pmf), res,
                                    scene.world_min, 1.0 / extent)


def spatial_light_distribution(scene: Scene, res: int = 16,
                               samples_per_voxel: int = 32,
                               seed: int = 7) -> SpatialLightDistribution:
    """ComputeDistribution (lightdistrib.cpp:~160-220; lights.py:197-240):
    per voxel, the mean of each light's unoccluded |Li|/pdf over
    ``samples_per_voxel`` jittered points drawn from
    ``RNG(voxel * 9781 + seed)``; an all-dark voxel picks uniformly.  On
    the scene's device."""
    L, V, dev = scene.n_lights, res ** 3, scene.device
    if L == 0:
        one = torch.ones((V, 1), dtype=torch.float32, device=dev)
        return _pick_table(one, scene, res)
    S = samples_per_voxel
    ii = torch.arange(V, dtype=torch.int64, device=dev)
    ijk = torch.stack([ii % res, (ii // res) % res, ii // (res * res)], -1)
    rng = pcg32_init((ii.repeat_interleave(S) * 9781 + seed) & 0xFFFFFFFF)
    rng, u0 = pcg32_next_f32(rng)
    rng, u1 = pcg32_next_f32(rng)
    rng, u2 = pcg32_next_f32(rng)
    jitter = torch.stack([u0, u1, u2], -1)
    cell = ijk.to(torch.float32).repeat_interleave(S, 0)
    extent = torch.clamp_min(scene.world_max - scene.world_min, 1e-6)
    pts = scene.world_min + (cell + jitter) / res * extent
    rng, ua = pcg32_next_f32(rng)
    rng, ub = pcg32_next_f32(rng)
    u2d = torch.stack([ua, ub], -1)
    weights = []
    for li in range(L):
        ls = sample_li(scene, torch.full((V * S,), li, dtype=torch.int64,
                                         device=dev), pts, u2d)
        c = luminance(ls.Li) / torch.clamp_min(ls.pdf, 1e-12)
        c = torch.where(ls.pdf > 1e-12, c, torch.zeros_like(c))
        weights.append(c.reshape(V, S).mean(-1))
    return _pick_table(torch.stack(weights, -1), scene, res)


def power_light_distribution(scene: Scene) -> SpatialLightDistribution:
    """The "power" strategy as a one-voxel table holding the power pmf
    (volpath.py:458-470)."""
    return _pick_table(luminance(light_power(scene))[None, :], scene, 1)


def sample_light_spatial(sld: SpatialLightDistribution, p: torch.Tensor,
                         u: torch.Tensor):
    """A light per lane from the voxel table at p (lights.py:243-256): the
    count of inclusive sums <= u, capped at the last light.  Returns
    (light_idx (R,) int64, pmf (R,))."""
    res = sld.res
    q = (p - sld.wmin) * sld.inv_extent * res
    ijk = torch.clamp(q.to(torch.int64), 0, res - 1)
    vox = (ijk[:, 2] * res + ijk[:, 1]) * res + ijk[:, 0]
    row_cdf = sld.cdf[vox]
    idx = (u[:, None] >= row_cdf).sum(-1)
    idx = torch.clamp_max(idx, row_cdf.shape[1] - 1)
    pmf = torch.gather(sld.pmf[vox], 1, idx[:, None])[:, 0]
    return idx, pmf


class LeSample(NamedTuple):
    o: torch.Tensor  # (R,3) ray origin
    d: torch.Tensor  # (R,3) unit direction
    n_light: torch.Tensor  # (R,3)
    Le: torch.Tensor  # (R,3)
    pdf_pos: torch.Tensor  # (R,)
    pdf_dir: torch.Tensor  # (R,)
    medium: torch.Tensor  # (R,) int64 medium at the origin


def _sample_shape_point(scene: Scene, kind, index, u):
    """Uniform-area point + normal on an area light's shape (Sphere::Sample,
    sphere.cpp:232-240 area variant; Triangle::Sample, triangle.cpp:~313).
    Returns (p, n, pdf_area); lanes of no shape get (0, 0, 1)."""
    R = kind.shape[0]
    p = torch.zeros((R, 3), dtype=torch.float32, device=u.device)
    n = torch.zeros_like(p)
    pdf = torch.ones((R,), dtype=torch.float32, device=u.device)
    if scene.n_spheres > 0:
        sidx = torch.clamp(index, 0, scene.n_spheres - 1)
        r = scene.spheres.radius[sidx]
        dir_ = uniform_sample_sphere(u)
        m = kind == SHAPE_SPHERE
        p = torch.where(m[:, None],
                        scene.spheres.center[sidx] + r[:, None] * dir_, p)
        n = torch.where(m[:, None], dir_, n)
        pdf = torch.where(m, 1.0 / (4.0 * PI * r * r), pdf)
    if scene.n_triangles > 0:
        tri = scene.triangles
        tidx = torch.clamp(index, 0, scene.n_triangles - 1)
        p0, p1, p2 = tri.p0[tidx], tri.p1[tidx], tri.p2[tidx]
        b = uniform_sample_triangle(u)
        p_t = p0 + b[:, 0:1] * (p1 - p0) + b[:, 1:2] * (p2 - p0)
        nv = cross(p1 - p0, p2 - p0)
        a_tri = 0.5 * length(nv)
        m = kind == SHAPE_TRIANGLE
        p = torch.where(m[:, None], p_t, p)
        n = torch.where(m[:, None], normalize(nv), n)
        pdf = torch.where(m, 1.0 / torch.clamp_min(a_tri, 1e-30), pdf)
    return p, n, pdf


def sample_le(scene: Scene, light_idx: torch.Tensor, u1: torch.Tensor,
              u2: torch.Tensor) -> LeSample:
    """Batched Light::Sample_Le (light.h:68-71): light_idx (R,) int64 chosen
    lights, u1 and u2 (R,2) uniforms."""
    L = scene.lights
    R = light_idx.shape[0]
    dev = u1.device
    if scene.n_lights == 0:
        z3 = torch.zeros((R, 3), dtype=torch.float32, device=dev)
        z = torch.zeros((R,), dtype=torch.float32, device=dev)
        return LeSample(z3, z3, z3, z3, z, z,
                        torch.full((R,), -1, dtype=torch.int64, device=dev))
    li = torch.clamp(light_idx, 0, scene.n_lights - 1)
    ltype = L.ltype[li]

    # point light (point.cpp:61-71)
    d_point = uniform_sample_sphere(u1)
    o_point = L.position[li]
    pdf_dir_point = torch.full((R,), INV_4PI, dtype=torch.float32, device=dev)

    # diffuse area light (diffuse.cpp:89-125), one- and two-sided
    p_sh, n_sh, pdf_area = _sample_shape_point(scene, L.shape_kind[li],
                                               L.shape_index[li], u1)
    two = L.two_sided[li] > 0
    u2x = u2[:, 0]
    flip = two & (u2x >= 0.5)
    u2x_remap = torch.where(two, torch.where(u2x < 0.5, u2x * 2.0,
                                             (u2x - 0.5) * 2.0), u2x)
    w_local = cosine_sample_hemisphere(torch.stack([u2x_remap, u2[:, 1]], -1))
    w_local = torch.where(flip[:, None],
                          torch.cat([w_local[:, :2], -w_local[:, 2:]], -1),
                          w_local)
    pdf_dir_area = cosine_hemisphere_pdf(w_local[:, 2].abs())
    pdf_dir_area = torch.where(two, 0.5 * pdf_dir_area, pdf_dir_area)
    vx, vy = coordinate_system(n_sh)
    d_area = normalize(w_local[:, 0:1] * vx + w_local[:, 1:2] * vy
                       + w_local[:, 2:3] * n_sh)

    pt = ltype == LIGHT_POINT
    pt3 = pt[:, None]
    return LeSample(
        o=torch.where(pt3, o_point, p_sh),
        d=torch.where(pt3, d_point, d_area),
        n_light=torch.where(pt3, d_point, n_sh),
        Le=L.emit[li],
        pdf_pos=torch.where(pt, torch.ones_like(pdf_area), pdf_area),
        pdf_dir=torch.where(pt, pdf_dir_point, pdf_dir_area),
        medium=L.medium[li],
    )


class LiSample(NamedTuple):
    wi: torch.Tensor  # (R,3) unit direction to the light
    Li: torch.Tensor  # (R,3)
    pdf: torch.Tensor  # (R,) solid-angle pdf
    dist: torch.Tensor  # (R,) distance to the light sample
    p_light: torch.Tensor  # (R,3) the light sample's position
    n_light: torch.Tensor  # (R,3) its shape normal; -wi for point lights


def sample_li(scene: Scene, light_idx, p_ref, u) -> LiSample:
    """Batched Light::Sample_Li: point lights (point.cpp:42-52); area
    lights by uniform-area sampling converted to solid angle
    (Shape::Pdf(ref,wi), shape.cpp:66-87)."""
    L = scene.lights
    R = light_idx.shape[0]
    dev = p_ref.device
    if scene.n_lights == 0:
        z3 = torch.zeros((R, 3), dtype=torch.float32, device=dev)
        z = torch.zeros((R,), dtype=torch.float32, device=dev)
        return LiSample(z3, z3, z, z, z3, z3)
    li = torch.clamp(light_idx, 0, scene.n_lights - 1)
    ltype = L.ltype[li]
    emit = L.emit[li]

    to_l = L.position[li] - p_ref
    d2 = torch.clamp_min(length_squared(to_l), 1e-20)
    wi_point = to_l / torch.sqrt(d2)[:, None]
    Li_point = emit / d2[:, None]
    dist_point = torch.sqrt(d2)

    p_sh, n_sh, pdf_area = _sample_shape_point(scene, L.shape_kind[li],
                                               L.shape_index[li], u)
    to_s = p_sh - p_ref
    d2s = torch.clamp_min(length_squared(to_s), 1e-20)
    dist_s = torch.sqrt(d2s)
    wi_area = to_s / dist_s[:, None]
    cos_l = dot(n_sh, -wi_area)
    emits = (L.two_sided[li] > 0) | (cos_l > 0.0)
    Li_area = torch.where(emits[:, None], emit, torch.zeros_like(emit))
    pdf_sa = pdf_area * d2s / torch.clamp_min(cos_l.abs(), 1e-6)
    pdf_area_solid = torch.where(cos_l.abs() > 1e-6, pdf_sa,
                                 torch.zeros_like(pdf_sa))

    pt = ltype == LIGHT_POINT
    pt3 = pt[:, None]
    return LiSample(
        wi=torch.where(pt3, wi_point, wi_area),
        Li=torch.where(pt3, Li_point, Li_area),
        pdf=torch.where(pt, torch.ones_like(pdf_area_solid), pdf_area_solid),
        dist=torch.where(pt, dist_point, dist_s),
        p_light=torch.where(pt3, L.position[li], p_sh),
        n_light=torch.where(pt3, -wi_point, n_sh),
    )


def light_choice_pmf(scene: Scene) -> torch.Tensor:
    """Each light's pick probability under the power distribution
    (PowerLightDistribution, lightdistrib.cpp; lights.py:583-590);
    uniform when no light has power."""
    p = luminance(light_power(scene))
    total = p.sum()
    n = scene.n_lights
    return torch.where(total > 0.0, p / torch.clamp_min(total, 1e-30),
                       torch.full((n,), 1.0 / max(n, 1), dtype=torch.float32,
                                  device=p.device))


def pdf_le(scene: Scene, light_idx, n_light, w):
    """Batched Light::Pdf_Le (light.h:72; lights.py:593-653): (pdf_pos,
    pdf_dir) of emitting direction w from a light sample with shape normal
    n_light.  Point (point.cpp:73-78): position a delta (0), direction
    uniform on the sphere.  Diffuse area (diffuse.cpp:127-134): 1/area,
    cosine-weighted hemisphere, halved when two-sided, 0 behind a one-sided
    emitter."""
    L = scene.lights
    R = light_idx.shape[0]
    if scene.n_lights == 0:
        z = torch.zeros((R,), dtype=torch.float32, device=w.device)
        return z, z
    li = torch.clamp(light_idx, 0, scene.n_lights - 1)
    ltype = L.ltype[li]
    area = _shape_area(scene, L.shape_kind[li], L.shape_index[li])
    cos_l = dot(n_light, w)
    two = L.two_sided[li] > 0
    pdf_dir_area = torch.where(two, 0.5, 1.0) * cosine_hemisphere_pdf(
        cos_l.abs())
    pdf_dir_area = torch.where(two | (cos_l > 0.0), pdf_dir_area, 0.0)
    is_ar = ltype == LIGHT_DIFFUSE_AREA
    pdf_pos = torch.where(is_ar, 1.0 / torch.clamp_min(area, 1e-30), 0.0)
    pdf_dir = torch.where(ltype == LIGHT_POINT, INV_4PI,
                          torch.where(is_ar, pdf_dir_area, 0.0))
    return pdf_pos, pdf_dir


def light_shape_area(scene: Scene, light_idx) -> torch.Tensor:
    """Shape::Area of each lane's area light (sphere.cpp:241,
    triangle.cpp:~310; lights.py:656-674); 1 for lanes whose light has no
    shape."""
    L = scene.lights
    li = torch.clamp(light_idx, 0, max(scene.n_lights - 1, 0))
    return _shape_area(scene, L.shape_kind[li], L.shape_index[li])


def escaped_radiance(scene: Scene, d: torch.Tensor) -> torch.Tensor:
    """Sum of Light::Le over infinite lights for escaped rays: point and area
    lights emit nothing along escaped rays (light.h:75 default 0)."""
    return torch.zeros(d.shape[:-1] + (3,), dtype=torch.float32,
                       device=d.device)


def area_light_emitted(scene: Scene, area_light_idx, n, wo) -> torch.Tensor:
    """L emitted toward wo from a hit on an area light (DiffuseAreaLight::L,
    diffuse.cpp:50-56)."""
    if scene.n_lights == 0:
        return torch.zeros(area_light_idx.shape + (3,), dtype=torch.float32,
                           device=n.device)
    has = area_light_idx >= 0
    li = torch.clamp(area_light_idx, 0, scene.n_lights - 1)
    emit = scene.lights.emit[li]
    two = scene.lights.two_sided[li] > 0
    facing = dot(n, wo) > 0.0
    return torch.where((has & (two | facing))[:, None], emit,
                       torch.zeros_like(emit))
