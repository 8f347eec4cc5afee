"""Lights: emission sampling (Sample_Le) and its density (Pdf_Le), NEE
sampling (Sample_Li), power, the light-pick distributions and the radiance
of escaped rays, for every light type of the reference (counterpart of
``bre_tpu/lights.py``; pbrt lights/{point,spot,goniometric,projection,
diffuse,distant,infinite}.cpp, shapes/sphere.cpp, integrator.cpp:217-226,
lightdistrib.cpp).

As in the reference, a lane's result is picked from each light type's
branch by a per-lane type mask.  The branches of the types the table does
not hold are not computed: ``Lights.kinds``, a host bool per tag fixed when
the table is built, says which are held, which changes no lane's result.
The env map's importance sampling runs only when the table carries one
(``env_func`` is then larger than (1, 1), known from its shape).  None of
these functions reads the device from the host, so a CUDA graph can hold
them (MLT's chain step).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .core.math import (INV_2PI, INV_4PI, PI, coordinate_system, cross, dot,
                        length, length_squared, normalize)
from .core.rng import pcg32_init, pcg32_next_f32
from .core.sampling import (Distribution1D, concentric_sample_disk,
                            cosine_hemisphere_pdf, cosine_sample_hemisphere,
                            make_distribution_1d, uniform_sample_sphere,
                            uniform_sample_triangle)
from .core.spectrum import luminance
from .scene.scene import (LIGHT_DIFFUSE_AREA, LIGHT_DISTANT, LIGHT_GONIOMETRIC,
                          LIGHT_INFINITE, LIGHT_POINT, LIGHT_PROJECTION,
                          LIGHT_SPOT, SHAPE_SPHERE, SHAPE_TRIANGLE, Lights,
                          Scene)


def _held(L: Lights):
    """held(*tags): whether the table holds a light of any of the tags,
    read from ``Lights.kinds`` on the host."""
    kinds = L.kinds
    return lambda *tags: any(bool(kinds[t]) for t in tags)


def _has_env(L: Lights) -> bool:
    """Whether an infinite light carries an env map (lights.py:423, 509,
    687, 710): the shape of its sampling table, known on the host."""
    return L.env_func.shape[0] > 1


class _Select:
    """The per-lane pick of the reference's nested ``where`` over type
    masks, for one table and one batch of lanes: ``pick(branches)`` takes
    (tags, value) pairs outermost first, value None where no tag of the
    group is held; a lane of a held tag gets its group's value, bit for
    bit.  Masks test only the held tags (no lane has another) and are
    made once per group."""

    def __init__(self, L: Lights, ltype):
        self.kinds, self.ltype, self.masks = L.kinds, ltype, {}

    def mask(self, tags):
        if tags not in self.masks:
            held = [t for t in tags if bool(self.kinds[t])]
            m = self.ltype == held[0]
            for t in held[1:]:
                m = m | (self.ltype == t)
            self.masks[tags] = m
        return self.masks[tags]

    def pick(self, branches):
        out = None
        for tags, val in reversed(branches):
            if val is None:
                continue
            if out is None:
                out = val
                continue
            m = self.mask(tags)
            out = torch.where(m[:, None] if val.ndim == 2 else m, val, out)
        return out


def _spot_falloff(cos_theta, cos_falloff, cos_total):
    """SpotLight::Falloff (spot.cpp:75-84; lights.py:46-51): a smooth
    quartic between the cones."""
    t = (cos_theta - cos_total) / torch.clamp_min(cos_falloff - cos_total,
                                                  1e-6)
    t = torch.clamp(t, 0.0, 1.0)
    return torch.where(cos_theta < cos_total, 0.0,
                       torch.where(cos_theta > cos_falloff, 1.0, t ** 4))


def _light_map_bilerp(L: Lights, li, uv):
    """Bilinear lookup at level 0 of a light's image in the light atlas,
    rows clamped and columns wrapped (MIPMap::Lookup of goniometric.cpp,
    infinite.cpp, projection.cpp; lights.py:61-84); 1 where the light has
    no image."""
    off = L.img_off[li]
    w = torch.clamp_min(L.img_w[li], 1)
    h = torch.clamp_min(L.img_h[li], 1)
    s = uv[:, 0] * w.to(torch.float32) - 0.5
    t = uv[:, 1] * h.to(torch.float32) - 0.5
    s0 = torch.floor(s).to(torch.int64)
    t0 = torch.floor(t).to(torch.int64)
    ds = (s - s0.to(torch.float32))[:, None]
    dt = (t - t0.to(torch.float32))[:, None]
    row0 = torch.clamp_min(off, 0)

    def texel(si, tj):
        y = torch.minimum(torch.clamp_min(tj, 0), h - 1)
        return L.atlas[row0 + y, torch.remainder(si, w)]

    val = ((1 - ds) * (1 - dt) * texel(s0, t0)
           + (1 - ds) * dt * texel(s0, t0 + 1)
           + ds * (1 - dt) * texel(s0 + 1, t0)
           + ds * dt * texel(s0 + 1, t0 + 1))
    return torch.where((off >= 0)[:, None], val, 1.0)


def _to_light(L: Lights, li, w):
    """World direction -> light space by the rotation of world_to_light."""
    return torch.einsum("rij,rj->ri", L.world_to_light[li][:, :3, :3], w)


def _dir_to_equirect_uv(L: Lights, li, w_world):
    """World direction -> (u, v) on the light's equirectangular map and
    theta (infinite.cpp Le: SphericalPhi/Theta of WorldToLight(w);
    lights.py:87-95)."""
    wl = normalize(_to_light(L, li, w_world))
    theta = torch.arccos(torch.clamp(wl[:, 2], -1.0, 1.0))
    phi = torch.arctan2(wl[:, 1], wl[:, 0])
    phi = torch.where(phi < 0.0, phi + 2.0 * PI, phi)
    return torch.stack([phi * INV_2PI, theta * (1.0 / PI)], -1), theta


def _projection_scale(L: Lights, li, w_world):
    """The slide's value in a projection light's emission direction
    (projection.cpp Projection(): the perspective divide into the slide
    window, zero outside; lights.py:98-114)."""
    wl = _to_light(L, li, w_world)
    cos_f = L.cos_falloff_start[li]  # cos(fov/2): the half-extent
    tan_half = torch.sqrt(torch.clamp_min(1.0 - cos_f * cos_f, 1e-12)) \
        / torch.clamp_min(cos_f, 1e-6)
    z = wl[:, 2]
    ok = z > 1e-6
    zs = torch.where(ok, z, 1.0)
    th = torch.clamp_min(tan_half, 1e-6)
    sx = wl[:, 0] / zs / th
    sy = wl[:, 1] / zs / th
    inside = ok & (sx.abs() <= 1.0) & (sy.abs() <= 1.0)
    val = _light_map_bilerp(L, li, torch.stack([sx * 0.5 + 0.5,
                                                sy * 0.5 + 0.5], -1))
    return torch.where(inside[:, None], val, 0.0)


def _world_r2(scene: Scene):
    """The world radius squared, as light_power and pdf_le compute it
    (lights.py:125-126, 610-611)."""
    diag = scene.world_max - scene.world_min
    return 0.25 * (diag * diag).sum()


def _world_disk(scene: Scene):
    """(radius, center) of the world's bounding sphere (distant.cpp,
    infinite.cpp Preprocess)."""
    diag = scene.world_max - scene.world_min
    return (0.5 * torch.sqrt((diag * diag).sum()),
            0.5 * (scene.world_max + scene.world_min))


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
    """Power() per light (light.h:73; lights.py:117-168), (Nl, 3): point
    4 pi I (point.cpp:59), spot 2 pi I (1 - (cos_falloff + cos_total)/2),
    diffuse area L area pi (twice for two-sided; diffuse.cpp:35-39),
    distant L pi r^2 (distant.cpp:62-66), infinite L pi r^2 times the map's
    mean, goniometric 4 pi I times it, projection I times it over the
    frustum's cone."""
    L = scene.lights
    held = _held(L)
    if scene.n_lights == 0:
        return L.emit
    world_r2 = _world_r2(scene)
    p_area = p_dist = p_inf = p_spot = p_gonio = p_proj = None
    if held(LIGHT_DIFFUSE_AREA):
        area = _shape_area(scene, L.shape_kind, L.shape_index)
        sides = torch.where(L.two_sided > 0, 2.0, 1.0)
        p_area = (sides * area * PI)[:, None] * L.emit
    if held(LIGHT_SPOT):
        p_spot = (2.0 * PI * (1.0 - 0.5 * (L.cos_falloff_start
                                           + L.cos_total_width)))[:, None] \
            * L.emit
    if held(LIGHT_DISTANT):
        p_dist = (PI * world_r2) * L.emit
    if held(LIGHT_INFINITE):
        p_inf = (PI * world_r2) * L.emit * L.img_mean
    if held(LIGHT_GONIOMETRIC):
        p_gonio = 4.0 * PI * L.emit * L.img_mean
    if held(LIGHT_PROJECTION):
        p_proj = (2.0 * PI * (1.0 - L.cos_total_width))[:, None] * L.emit \
            * L.img_mean
    return _Select(L, L.ltype).pick([
        ((LIGHT_POINT,), 4.0 * PI * L.emit if held(LIGHT_POINT) else None),
        ((LIGHT_SPOT,), p_spot), ((LIGHT_DIFFUSE_AREA,), p_area),
        ((LIGHT_DISTANT,), p_dist), ((LIGHT_GONIOMETRIC,), p_gonio),
        ((LIGHT_PROJECTION,), p_proj), ((LIGHT_INFINITE,), p_inf)])


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
    """Batched Light::Sample_Le (light.h:68-71; lights.py:307-429):
    light_idx (R,) int64 chosen lights, u1 and u2 (R,2) uniforms.
    Goniometric and projection lights emit like point lights, uniformly
    over the sphere, with the map's value in the emitted direction."""
    L = scene.lights
    R = light_idx.shape[0]
    dev = u1.device
    if scene.n_lights == 0:
        z3 = torch.zeros((R, 3), dtype=torch.float32, device=dev)
        z = torch.zeros((R,), dtype=torch.float32, device=dev)
        return LeSample(z3, z3, z3, z3, z, z,
                        torch.full((R,), -1, dtype=torch.int64, device=dev))
    held = _held(L)
    li = torch.clamp(light_idx, 0, scene.n_lights - 1)
    ltype = L.ltype[li]
    emit = L.emit[li]
    one = torch.ones((R,), dtype=torch.float32, device=dev)
    PT = (LIGHT_POINT, LIGHT_GONIOMETRIC, LIGHT_PROJECTION)
    br = {}  # group -> (o, d, n_light, pdf_pos, pdf_dir)

    d_point = None
    if held(*PT):  # point.cpp:61-71
        d_point = uniform_sample_sphere(u1)
        br[PT] = (L.position[li], d_point, d_point, one,
                  torch.full((R,), INV_4PI, dtype=torch.float32, device=dev))
    spot_fall = None
    if held(LIGHT_SPOT):  # spot.cpp:86-100: a uniform cone about the axis
        cos_w = L.cos_total_width[li]
        axis = L.direction[li]
        ct = (1.0 - u1[:, 0]) + u1[:, 0] * cos_w
        st = torch.sqrt(torch.clamp_min(1.0 - ct * ct, 0.0))
        phi_s = 2.0 * PI * u1[:, 1]
        vx_s, vy_s = coordinate_system(axis)
        d_spot = normalize((st * torch.cos(phi_s))[:, None] * vx_s
                           + (st * torch.sin(phi_s))[:, None] * vy_s
                           + ct[:, None] * axis)
        pdf_dir_spot = 1.0 / torch.clamp_min(2.0 * PI * (1.0 - cos_w), 1e-9)
        spot_fall = _spot_falloff(ct, L.cos_falloff_start[li], cos_w)
        br[(LIGHT_SPOT,)] = (L.position[li], d_spot, d_spot, one,
                             pdf_dir_spot)
    if held(LIGHT_DIFFUSE_AREA):  # diffuse.cpp:89-125, one- and two-sided
        p_sh, n_sh, pdf_area = _sample_shape_point(
            scene, L.shape_kind[li], L.shape_index[li], u1)
        two = L.two_sided[li] > 0
        u2x = u2[:, 0]
        flip = two & (u2x >= 0.5)
        u2x_remap = torch.where(two, torch.where(u2x < 0.5, u2x * 2.0,
                                                 (u2x - 0.5) * 2.0), u2x)
        w_local = cosine_sample_hemisphere(torch.stack([u2x_remap, u2[:, 1]],
                                                       -1))
        w_local = torch.where(flip[:, None],
                              torch.cat([w_local[:, :2], -w_local[:, 2:]], -1),
                              w_local)
        pdf_dir_area = cosine_hemisphere_pdf(w_local[:, 2].abs())
        pdf_dir_area = torch.where(two, 0.5 * pdf_dir_area, pdf_dir_area)
        vx, vy = coordinate_system(n_sh)
        d_area = normalize(w_local[:, 0:1] * vx + w_local[:, 1:2] * vy
                           + w_local[:, 2:3] * n_sh)
        br[(LIGHT_DIFFUSE_AREA,)] = (p_sh, d_area, n_sh, pdf_area,
                                     pdf_dir_area)
    if held(LIGHT_DISTANT, LIGHT_INFINITE):
        world_r, center = _world_disk(scene)
        pdf_pos_disk = one / (PI * world_r * world_r)
    if held(LIGHT_DISTANT):  # distant.cpp:69-85
        w_dist = L.direction[li]
        v1, v2 = coordinate_system(-w_dist)
        cd = concentric_sample_disk(u1)
        p_disk = center + world_r * (cd[:, 0:1] * v1 + cd[:, 1:2] * v2)
        br[(LIGHT_DISTANT,)] = (p_disk + world_r * (-w_dist), w_dist, w_dist,
                                pdf_pos_disk, one)
    if held(LIGHT_INFINITE):  # infinite.cpp Sample_Le: a uniform direction
        d_inf = -uniform_sample_sphere(u2)
        v1i, v2i = coordinate_system(-d_inf)
        cdi = concentric_sample_disk(u1)
        p_di = center + world_r * (cdi[:, 0:1] * v1i + cdi[:, 1:2] * v2i)
        br[(LIGHT_INFINITE,)] = (p_di + world_r * (-d_inf), d_inf, d_inf,
                                 pdf_pos_disk, torch.full(
                                     (R,), INV_4PI, dtype=torch.float32,
                                     device=dev))
    order = (PT, (LIGHT_SPOT,), (LIGHT_DIFFUSE_AREA,), (LIGHT_DISTANT,),
             (LIGHT_INFINITE,))
    sel = _Select(L, ltype)
    o, d, n_l, pdf_pos, pdf_dir = (
        sel.pick([(g, br[g][k] if g in br else None) for g in order])
        for k in range(5))
    Le = emit
    if spot_fall is not None:
        Le = torch.where((ltype == LIGHT_SPOT)[:, None],
                         emit * spot_fall[:, None], Le)
    if held(LIGHT_GONIOMETRIC):
        uv_g, _ = _dir_to_equirect_uv(L, li, d_point)
        Le = torch.where((ltype == LIGHT_GONIOMETRIC)[:, None],
                         emit * _light_map_bilerp(L, li, uv_g), Le)
    if held(LIGHT_PROJECTION):
        Le = torch.where((ltype == LIGHT_PROJECTION)[:, None],
                         emit * _projection_scale(L, li, d_point), Le)
    if _has_env(L):  # the env map's radiance along the travel direction
        uv_e, _ = _dir_to_equirect_uv(L, li, -d)
        is_env = (li == L.env_light) & (ltype == LIGHT_INFINITE)
        Le = torch.where(is_env[:, None],
                         emit * _light_map_bilerp(L, li, uv_e), Le)
    return LeSample(o=o, d=d, n_light=n_l, Le=Le, pdf_pos=pdf_pos,
                    pdf_dir=pdf_dir, medium=L.medium[li])


class LiSample(NamedTuple):
    wi: torch.Tensor  # (R,3) unit direction to the light
    Li: torch.Tensor  # (R,3)
    pdf: torch.Tensor  # (R,) solid-angle pdf
    dist: torch.Tensor  # (R,) distance to the light sample
    p_light: torch.Tensor  # (R,3) the light sample's position
    n_light: torch.Tensor  # (R,3) its shape normal; -wi for point lights


def _env_pick(L: Lights, u):
    """The env map's row by its marginal CDF and column by the row's
    conditional CDF, each ``searchsorted(side="right") - 1`` batched over
    the lanes' rows (lights.py:513-520).  Returns (row, col, the lanes'
    conditional rows)."""
    He, We = L.env_func.shape
    marg = L.env_marg_cdf
    row = torch.clamp(torch.searchsorted(marg, u[:, 1].contiguous(),
                                         right=True) - 1, 0, He - 1)
    cond_r = L.env_cond_cdf[row]
    col = torch.clamp(torch.searchsorted(cond_r, u[:, 0:1].contiguous(),
                                         right=True)[:, 0] - 1, 0, We - 1)
    return row, col, cond_r


def _sample_env(L: Lights, li, u):
    """Importance-sample the env map's Distribution2D (infinite.cpp
    Sample_Li; lights.py:509-540) at the picks of ``_env_pick``.  Returns
    (wi, Li, pdf) of the lanes' samples; the pdf is the map's at the
    picked row and column."""
    He, We = L.env_func.shape
    marg = L.env_marg_cdf
    row, col, cond_r = _env_pick(L, u)
    dv = (u[:, 1] - marg[row]) / torch.clamp_min(marg[row + 1] - marg[row],
                                                 1e-30)
    c0 = torch.gather(cond_r, 1, col[:, None])[:, 0]
    c1 = torch.gather(cond_r, 1, col[:, None] + 1)[:, 0]
    duu = (u[:, 0] - c0) / torch.clamp_min(c1 - c0, 1e-30)
    v_map = (row.to(torch.float32) + dv) / He
    u_map = (col.to(torch.float32) + duu) / We
    theta = v_map * PI
    phi = u_map * 2.0 * PI
    sin_t = torch.sin(theta)
    wl = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                      torch.cos(theta)], -1)
    # light -> world: the transpose of the stored rotation
    wi = normalize(torch.einsum("rji,rj->ri",
                                L.world_to_light[li][:, :3, :3], wl))
    func_int = torch.clamp_min(L.env_func.mean(), 1e-30)
    pdf_map = L.env_func[row, col] / func_int
    pdf = pdf_map / torch.clamp_min(2.0 * PI * PI * sin_t, 1e-30)
    Li = L.emit[li] * _light_map_bilerp(L, li, torch.stack([u_map, v_map],
                                                           -1))
    return wi, Li, pdf


def sample_li(scene: Scene, light_idx, p_ref, u) -> LiSample:
    """Batched Light::Sample_Li (light.h:68-70; lights.py:444-580): the
    point-like lights (point.cpp:42-52, with the spot's falloff,
    spot.cpp:57-64, and the goniometric and projection maps' values),
    area lights by uniform-area sampling converted to solid angle
    (Shape::Pdf(ref,wi), shape.cpp:66-87), distant lights (distant.cpp:
    42-57), infinite lights uniformly over the sphere, or by the env map's
    Distribution2D for the one that carries it."""
    L = scene.lights
    R = light_idx.shape[0]
    dev = p_ref.device
    if scene.n_lights == 0:
        z3 = torch.zeros((R, 3), dtype=torch.float32, device=dev)
        z = torch.zeros((R,), dtype=torch.float32, device=dev)
        return LiSample(z3, z3, z, z, z3, z3)
    held = _held(L)
    li = torch.clamp(light_idx, 0, scene.n_lights - 1)
    ltype = L.ltype[li]
    emit = L.emit[li]
    one = torch.ones((R,), dtype=torch.float32, device=dev)
    PL = (LIGHT_POINT, LIGHT_SPOT, LIGHT_GONIOMETRIC, LIGHT_PROJECTION)
    br = {}  # group -> (wi, Li, pdf, dist, p_light, n_light)

    if held(*PL):
        pos = L.position[li]
        to_l = pos - p_ref
        d2 = torch.clamp_min(length_squared(to_l), 1e-20)
        wi_point = to_l / torch.sqrt(d2)[:, None]
        Li_point = emit / d2[:, None]
        br[PL] = (wi_point, Li_point, one, torch.sqrt(d2), pos, -wi_point)
    if held(LIGHT_DIFFUSE_AREA):
        p_sh, n_sh, pdf_area = _sample_shape_point(
            scene, L.shape_kind[li], L.shape_index[li], u)
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
        br[(LIGHT_DIFFUSE_AREA,)] = (wi_area, Li_area, pdf_area_solid, dist_s,
                                     p_sh, n_sh)
    if held(LIGHT_DISTANT, LIGHT_INFINITE):
        world_r, _ = _world_disk(scene)
        dist_far = torch.full((R,), 2.0, dtype=torch.float32,
                              device=dev) * world_r
    if held(LIGHT_DISTANT):
        wi_dist = -L.direction[li]
        br[(LIGHT_DISTANT,)] = (wi_dist, emit, one, dist_far,
                                p_ref + wi_dist * dist_far[:, None], -wi_dist)
    if held(LIGHT_INFINITE):
        wi_inf = uniform_sample_sphere(u)
        Li_inf = emit
        pdf_inf = torch.full((R,), INV_4PI, dtype=torch.float32, device=dev)
        if _has_env(L):
            wi_env, Li_env, pdf_env = _sample_env(L, li, u)
            is_env = li == L.env_light
            wi_inf = torch.where(is_env[:, None], wi_env, wi_inf)
            Li_inf = torch.where(is_env[:, None], Li_env, Li_inf)
            pdf_inf = torch.where(is_env, pdf_env, pdf_inf)
        br[(LIGHT_INFINITE,)] = (wi_inf, Li_inf, pdf_inf, dist_far,
                                 p_ref + wi_inf * dist_far[:, None], -wi_inf)
    order = (PL, (LIGHT_DIFFUSE_AREA,), (LIGHT_DISTANT,), (LIGHT_INFINITE,))
    sel = _Select(L, ltype)
    wi, Li, pdf, dist, p_light, n_light = (
        sel.pick([(g, br[g][k] if g in br else None) for g in order])
        for k in range(6))
    # the spot, goniometric and projection lights: the point geometry with
    # their direction-dependent factors
    if held(LIGHT_SPOT):
        cos_at = (-wi_point * L.direction[li]).sum(-1)
        fall = _spot_falloff(cos_at, L.cos_falloff_start[li],
                             L.cos_total_width[li])
        Li = torch.where((ltype == LIGHT_SPOT)[:, None],
                         Li_point * fall[:, None], Li)
    if held(LIGHT_GONIOMETRIC):
        uv_g, _ = _dir_to_equirect_uv(L, li, -wi_point)
        Li = torch.where((ltype == LIGHT_GONIOMETRIC)[:, None],
                         Li_point * _light_map_bilerp(L, li, uv_g), Li)
    if held(LIGHT_PROJECTION):
        Li = torch.where((ltype == LIGHT_PROJECTION)[:, None],
                         Li_point * _projection_scale(L, li, -wi_point), Li)
    return LiSample(wi=wi, Li=Li, pdf=pdf, dist=dist, p_light=p_light,
                    n_light=n_light)


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
    pdf_dir) of emitting direction w from a light sample with normal
    n_light.  Point, goniometric and projection (point.cpp:73-78): the
    position a delta (0), the direction uniform on the sphere.  Spot
    (spot.cpp:102-108): the uniform cone's density inside it, 0 outside.
    Diffuse area (diffuse.cpp:127-134): 1/area, the cosine-weighted
    hemisphere, halved when two-sided, 0 behind a one-sided emitter.
    Distant (distant.cpp:87-92): 1/(pi r^2), the direction a delta (0).
    Infinite: 1/(pi r^2), uniform on the sphere."""
    L = scene.lights
    R = light_idx.shape[0]
    if scene.n_lights == 0:
        z = torch.zeros((R,), dtype=torch.float32, device=w.device)
        return z, z
    held = _held(L)
    li = torch.clamp(light_idx, 0, scene.n_lights - 1)
    ltype = L.ltype[li]
    zero = torch.zeros((R,), dtype=torch.float32, device=w.device)
    PT = (LIGHT_POINT, LIGHT_GONIOMETRIC, LIGHT_PROJECTION)
    pos_area = dir_area = dir_spot = pos_disk = None
    if held(LIGHT_DIFFUSE_AREA):
        area = _shape_area(scene, L.shape_kind[li], L.shape_index[li])
        cos_l = dot(n_light, w)
        two = L.two_sided[li] > 0
        dir_area = torch.where(two, 0.5, 1.0) * cosine_hemisphere_pdf(
            cos_l.abs())
        dir_area = torch.where(two | (cos_l > 0.0), dir_area, 0.0)
        pos_area = 1.0 / torch.clamp_min(area, 1e-30)
    if held(LIGHT_SPOT):
        cos_w = L.cos_total_width[li]
        cos_ax = dot(L.direction[li], w)
        dir_spot = torch.where(
            cos_ax >= cos_w, 1.0 / torch.clamp_min(2.0 * PI * (1.0 - cos_w),
                                                   1e-9), 0.0)
    if held(LIGHT_DISTANT, LIGHT_INFINITE):
        pos_disk = (1.0 / (PI * _world_r2(scene))).expand(R)
    inv4pi = torch.full((R,), INV_4PI, dtype=torch.float32, device=w.device)
    sel = _Select(L, ltype)
    pdf_pos = sel.pick([
        ((LIGHT_DIFFUSE_AREA,), pos_area),
        (PT + (LIGHT_SPOT,), zero if held(*PT, LIGHT_SPOT) else None),
        ((LIGHT_DISTANT, LIGHT_INFINITE), pos_disk)])
    pdf_dir = sel.pick([
        (PT, inv4pi if held(*PT) else None), ((LIGHT_SPOT,), dir_spot),
        ((LIGHT_DIFFUSE_AREA,), dir_area),
        ((LIGHT_DISTANT,), zero if held(LIGHT_DISTANT) else None),
        ((LIGHT_INFINITE,), inv4pi if held(LIGHT_INFINITE) else None)])
    return pdf_pos, pdf_dir


def light_shape_area(scene: Scene, light_idx) -> torch.Tensor:
    """Shape::Area of each lane's area light (sphere.cpp:241,
    triangle.cpp:~310; lights.py:656-674); 1 for lanes whose light has no
    shape."""
    L = scene.lights
    li = torch.clamp(light_idx, 0, max(scene.n_lights - 1, 0))
    return _shape_area(scene, L.shape_kind[li], L.shape_index[li])


def infinite_Le_pdf(scene: Scene, light_idx, w):
    """(Le (R,3), pdf_dir (R,)) of an infinite light toward direction w
    (InfiniteAreaLight::{Le,Pdf_Li}, infinite.cpp; lights.py:677-700): L
    and the uniform sphere's density, or for the env map its value and its
    Distribution2D's density at the floor of w's equirect coordinates.
    Callers mask the lanes of other lights."""
    L = scene.lights
    li = torch.clamp(light_idx, 0, max(scene.n_lights - 1, 0))
    R = light_idx.shape[0]
    Le = L.emit[li]
    pdf = torch.full((R,), INV_4PI, dtype=torch.float32, device=w.device)
    if _has_env(L):
        uv, theta = _dir_to_equirect_uv(L, li, w)
        sin_t = torch.sin(theta)
        He, We = L.env_func.shape
        row = torch.clamp((uv[:, 1] * He).to(torch.int64), 0, He - 1)
        col = torch.clamp((uv[:, 0] * We).to(torch.int64), 0, We - 1)
        func_int = torch.clamp_min(L.env_func.mean(), 1e-30)
        pdf_env = (L.env_func[row, col] / func_int) / torch.clamp_min(
            2.0 * PI * PI * sin_t, 1e-30)
        is_env = li == L.env_light
        Le = torch.where(is_env[:, None], Le * _light_map_bilerp(L, li, uv),
                         Le)
        pdf = torch.where(is_env, pdf_env, pdf)
    return Le, pdf


def escaped_radiance(scene: Scene, d: torch.Tensor) -> torch.Tensor:
    """Sum of Light::Le over the infinite lights for escaped rays
    (light.h:75, 0 for the other types; infinite.cpp Le; lights.py:
    703-721): the constant L of each infinite light but the env map, plus
    the env map's value at d's equirect coordinates.  d: (R,3) -> (R,3)."""
    L = scene.lights
    out_shape = d.shape[:-1] + (3,)
    if scene.n_lights == 0 or not _held(L)(LIGHT_INFINITE):
        return torch.zeros(out_shape, dtype=torch.float32, device=d.device)
    mask = L.ltype == LIGHT_INFINITE
    if _has_env(L):
        mask = mask & (torch.arange(L.ltype.shape[0], device=d.device)
                       != L.env_light)
    total = (L.emit * mask.to(torch.float32)[:, None]).sum(0)
    out = total.expand(out_shape)
    if _has_env(L):
        # a 1-element index: a 0-d one would be read on the host
        env_li = torch.clamp_min(L.env_light, 0).reshape(1)
        li = env_li.expand(d.shape[0])
        uv, _ = _dir_to_equirect_uv(L, li, d)
        out = out + L.emit[env_li] * _light_map_bilerp(L, li, uv)
    return out


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
