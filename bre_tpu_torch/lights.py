"""Lights: emission sampling (Sample_Le), NEE sampling (Sample_Li), power —
point and triangle-area lights (counterpart of ``bre_tpu/lights.py``;
pbrt lights/point.cpp, lights/diffuse.cpp, integrator.cpp:217-226).

As in the reference, every lane evaluates each light type's math and a
per-lane type mask picks the result.  Other light types are ROADMAP Queue 1
"breadth"; ``scene.check_slice`` rejects them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .core.math import INV_4PI, PI, coordinate_system, cross, dot, length, length_squared, normalize
from .core.sampling import (Distribution1D, cosine_hemisphere_pdf,
                            cosine_sample_hemisphere, make_distribution_1d,
                            uniform_sample_sphere, uniform_sample_triangle)
from .core.spectrum import luminance
from .scene.scene import LIGHT_POINT, SHAPE_TRIANGLE, Scene


def light_power(scene: Scene) -> torch.Tensor:
    """Power() per light (light.h:73), (Nl, 3): point 4*pi*I
    (point.cpp:59), diffuse area L*area*pi*(1 or 2) (diffuse.cpp:35-39)."""
    L = scene.lights
    area = torch.ones(L.ltype.shape, dtype=torch.float32, device=scene.device)
    if scene.n_triangles > 0:
        tri = scene.triangles
        tidx = torch.clamp(L.shape_index, 0, scene.n_triangles - 1)
        e1 = tri.p1[tidx] - tri.p0[tidx]
        e2 = tri.p2[tidx] - tri.p0[tidx]
        area = torch.where(L.shape_kind == SHAPE_TRIANGLE,
                           0.5 * length(cross(e1, e2)), area)
    sides = torch.where(L.two_sided > 0, 2.0, 1.0)
    p_point = 4.0 * PI * L.emit
    p_area = (sides * area * PI)[:, None] * L.emit
    return torch.where((L.ltype == LIGHT_POINT)[:, None], p_point, p_area)


def light_power_distribution(scene: Scene) -> Distribution1D:
    """ComputeLightPowerDistribution (integrator.cpp:217-226)."""
    return make_distribution_1d(luminance(light_power(scene)))


class LeSample(NamedTuple):
    o: torch.Tensor  # (R,3) ray origin
    d: torch.Tensor  # (R,3) unit direction
    n_light: torch.Tensor  # (R,3)
    Le: torch.Tensor  # (R,3)
    pdf_pos: torch.Tensor  # (R,)
    pdf_dir: torch.Tensor  # (R,)
    medium: torch.Tensor  # (R,) int64 medium at the origin


def _sample_shape_point(scene: Scene, kind, index, u):
    """Uniform-area point + normal on a triangle light (Triangle::Sample,
    triangle.cpp:~313).  Returns (p, n, pdf_area); non-triangle lanes get
    (0, 0, 1)."""
    R = kind.shape[0]
    p = torch.zeros((R, 3), dtype=torch.float32, device=u.device)
    n = torch.zeros_like(p)
    pdf = torch.ones((R,), dtype=torch.float32, device=u.device)
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
    zflip = torch.tensor([1.0, 1.0, -1.0], dtype=torch.float32, device=dev)
    w_local = torch.where(flip[:, None], w_local * zflip, w_local)
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
        return LiSample(z3, z3, z, z)
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
    )


def light_shape_area(scene: Scene, light_idx) -> torch.Tensor:
    """Shape::Area of each lane's area light (triangle.cpp:~310;
    lights.py:656-674); 1 for lanes whose light has no triangle."""
    L = scene.lights
    li = torch.clamp(light_idx, 0, max(scene.n_lights - 1, 0))
    area = torch.ones(light_idx.shape, dtype=torch.float32,
                      device=light_idx.device)
    if scene.n_triangles > 0:
        tri = scene.triangles
        ti = torch.clamp(L.shape_index[li], 0, scene.n_triangles - 1)
        nv = cross(tri.p1[ti] - tri.p0[ti], tri.p2[ti] - tri.p0[ti])
        area = torch.where(L.shape_kind[li] == SHAPE_TRIANGLE,
                           0.5 * length(nv), area)
    return area


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
