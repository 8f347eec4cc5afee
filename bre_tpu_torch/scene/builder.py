"""Declarative scene builder (counterpart of ``bre_tpu/scene/builder.py``).

The slice's subset: homogeneous and grid-density media (one grid per
scene), the analytic surface materials (matte, mirror, glass, metal,
plastic, uber, substrate, translucent, mix), the texture table with its
MIPMap atlas, spheres, triangles (with per-vertex shading normals and uvs,
and pbrt's ``ss = normalize(dpdu)`` tangent from the uvs), quads, boxes,
and every light type: point, spot, goniometric, projection, distant and
infinite lights (constant or image-mapped, the light images packed in their
own MIPMap atlas, the env map's Distribution2D built here) and diffuse area
lights on triangles and spheres.  Parameter names and the numpy arithmetic
match the reference, so ``build()`` yields the same values as
``scene_from_jax(bre_tpu SceneBuilder.build())``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..materials import COPPER_ETA, COPPER_K
from ..textures import (TEX_BILERP, TEX_CHECKERBOARD, TEX_CONSTANT, TEX_DOTS,
                        TEX_FBM, TEX_IMAGE, TEX_MARBLE, TEX_MIX, TEX_SCALE,
                        TEX_UV, TEX_WINDY, TEX_WRINKLED, Textures,
                        build_pyramid, noise_permutation, pack_atlas)
from ..core import transform as tfm
from .scene import (LIGHT_DIFFUSE_AREA, LIGHT_DISTANT, LIGHT_GONIOMETRIC,
                    LIGHT_INFINITE, LIGHT_POINT, LIGHT_PROJECTION, LIGHT_SPOT,
                    MAT_GLASS, MAT_MATTE, MAT_METAL, MAT_MIRROR, MAT_MIX,
                    MAT_PLASTIC, MAT_SUBSTRATE, MAT_TRANSLUCENT, MAT_UBER,
                    MEDIUM_GRID, MEDIUM_HOMOGENEOUS, SHAPE_SPHERE,
                    SHAPE_TRIANGLE, Lights, Materials, Media, Scene, Spheres,
                    Triangles, light_kinds, material_kinds, resolve_device)

# luminance weights of the env map's sampling density (builder.py:1126)
_LUM = np.array([0.212671, 0.715160, 0.072169], np.float32)

# pbrt's default triangle uvs (triangle.cpp GetUVs)
_UV_DEFAULT = (np.array([0.0, 0.0], np.float32),
               np.array([1.0, 0.0], np.float32),
               np.array([1.0, 1.0], np.float32))


def _rgb(v) -> np.ndarray:
    a = np.asarray(v, np.float32)
    if a.shape == ():
        a = np.full(3, float(a), np.float32)
    return a


def _tex_graph_depth(tex_list) -> int:
    """Nesting depth of the texture graph (0 = flat); children precede
    their parents (``_add_tex`` checks it), so one forward pass does."""
    depth = [0] * len(tex_list)
    for i, t in enumerate(tex_list):
        for ch in (t["child0"], t["child1"]):
            if ch >= 0:
                depth[i] = max(depth[i], depth[ch] + 1)
    return max(depth, default=0)


class SceneBuilder:
    def __init__(self) -> None:
        self._sph: List[dict] = []
        self._tri: List[dict] = []
        self._mat: List[dict] = []
        self._light: List[dict] = []
        self._med: List[dict] = []
        self._grid_density: Optional[np.ndarray] = None
        self._grid_world_to_medium: Optional[np.ndarray] = None
        self._grid_medium_index = -1
        self._tex: List[dict] = []
        self._images: List[list] = []  # MIPMap pyramids of image textures
        self._light_images: List[list] = []  # pyramids of the light images
        self.camera_medium = -1

    # --- materials (reference src/materials/*.cpp) ---
    def _add_mat(self, mtype, kd, ks, eta=1.0, roughness=0.0,
                 metal_eta=(1.0, 1.0, 1.0), metal_k=(0.0, 0.0, 0.0),
                 kd_tex=-1, mix_m1=-1, mix_m2=-1,
                 mix_amount=(0.5, 0.5, 0.5)) -> int:
        self._mat.append(dict(
            mtype=mtype, kd=_rgb(kd), ks=_rgb(ks), eta=eta,
            roughness=roughness, metal_eta=_rgb(metal_eta),
            metal_k=_rgb(metal_k), kd_tex=kd_tex, mix_m1=mix_m1,
            mix_m2=mix_m2, mix_amount=_rgb(mix_amount)))
        return len(self._mat) - 1

    def matte(self, kd=(0.5, 0.5, 0.5), sigma=0.0, kd_tex=-1) -> int:
        """Lambertian whatever ``sigma`` is, as the reference's matte BSDF
        is (bre_tpu/materials.py:403, 544); ``sigma`` is stored."""
        return self._add_mat(MAT_MATTE, kd, (0, 0, 0), roughness=sigma,
                             kd_tex=kd_tex)

    def mirror(self, kr=(0.9, 0.9, 0.9)) -> int:
        return self._add_mat(MAT_MIRROR, kr, (0, 0, 0))

    def glass(self, kr=(1.0, 1.0, 1.0), kt=(1.0, 1.0, 1.0), eta=1.5) -> int:
        return self._add_mat(MAT_GLASS, kr, kt, eta=eta)

    def metal(self, eta=None, k=None, roughness=0.01,
              tint=(1.0, 1.0, 1.0)) -> int:
        """GGX conductor (metal.cpp), copper by default."""
        return self._add_mat(
            MAT_METAL, (0, 0, 0), tint, roughness=roughness,
            metal_eta=eta if eta is not None else COPPER_ETA,
            metal_k=k if k is not None else COPPER_K)

    def plastic(self, kd=(0.25, 0.25, 0.25), ks=(0.25, 0.25, 0.25),
                roughness=0.1, kd_tex=-1) -> int:
        return self._add_mat(MAT_PLASTIC, kd, ks, eta=1.5,
                             roughness=roughness, kd_tex=kd_tex)

    def uber(self, kd=(0.25,) * 3, ks=(0.25,) * 3, roughness=0.1, eta=1.5,
             kd_tex=-1) -> int:
        return self._add_mat(MAT_UBER, kd, ks, eta=eta, roughness=roughness,
                             kd_tex=kd_tex)

    def substrate(self, kd=(0.5,) * 3, ks=(0.5,) * 3, roughness=0.1) -> int:
        return self._add_mat(MAT_SUBSTRATE, kd, ks, roughness=roughness)

    def translucent(self, kd=(0.25,) * 3, kt=(0.25,) * 3) -> int:
        return self._add_mat(MAT_TRANSLUCENT, kd, kt)

    def mix(self, m1: int, m2: int, amount=(0.5, 0.5, 0.5)) -> int:
        """MixMaterial (mixmat.cpp): amount m1 + (1 - amount) m2, one level
        deep (``check_slice`` refuses a mix of mixes)."""
        return self._add_mat(MAT_MIX, (0, 0, 0), (0, 0, 0), mix_m1=m1,
                             mix_m2=m2, mix_amount=amount)

    # --- textures (reference src/textures/*; bre_tpu_torch/textures.py) ---
    def _add_tex(self, ttype, c0=(1, 1, 1), c1=(0, 0, 0), scale=1.0,
                 octaves=6, omega=0.5, img=-1, uv_scale=(1.0, 1.0),
                 uv_delta=(0.0, 0.0), tex1=-1, tex2=-1) -> int:
        # sub-textures come first, so the graph is acyclic
        for ch in (tex1, tex2):
            if ch >= len(self._tex):
                raise ValueError("sub-texture must be registered first")
        self._tex.append(dict(ttype=ttype, c0=_rgb(c0), c1=_rgb(c1),
                              scale=scale, octaves=octaves, omega=omega,
                              img=img,
                              uv_scale=np.asarray(uv_scale, np.float32),
                              uv_delta=np.asarray(uv_delta, np.float32),
                              child0=int(tex1), child1=int(tex2),
                              c2=np.zeros(3, np.float32),
                              c3=np.zeros(3, np.float32)))
        return len(self._tex) - 1

    def tex_imagemap(self, image, scale=(1, 1, 1), uscale=1.0, vscale=1.0,
                     udelta=0.0, vdelta=0.0) -> int:
        """Image map with a MIPMap pyramid (imagemap.cpp, mipmap.h);
        ``image``: (H, W, 3) or (H, W)."""
        self._images.append(build_pyramid(np.asarray(image, np.float32)))
        return self._add_tex(TEX_IMAGE, c0=scale, img=len(self._images) - 1,
                             uv_scale=(uscale, vscale),
                             uv_delta=(udelta, vdelta))

    def tex_constant(self, c) -> int:
        return self._add_tex(TEX_CONSTANT, c)

    def tex_checkerboard(self, c0=(1, 1, 1), c1=(0, 0, 0), scale=1.0,
                         tex1=-1, tex2=-1) -> int:
        return self._add_tex(TEX_CHECKERBOARD, c0, c1, scale, tex1=tex1,
                             tex2=tex2)

    def tex_uv(self) -> int:
        return self._add_tex(TEX_UV)

    def tex_fbm(self, c=(1, 1, 1), scale=1.0, octaves=6, omega=0.5) -> int:
        return self._add_tex(TEX_FBM, c, scale=scale, octaves=octaves,
                             omega=omega)

    def tex_wrinkled(self, c=(1, 1, 1), scale=1.0, octaves=6,
                     omega=0.5) -> int:
        return self._add_tex(TEX_WRINKLED, c, scale=scale, octaves=octaves,
                             omega=omega)

    def tex_marble(self, c0=(0.9, 0.9, 0.9), c1=(0.2, 0.2, 0.3), scale=1.0,
                   omega=0.5) -> int:
        return self._add_tex(TEX_MARBLE, c0, c1, scale, omega=omega)

    def tex_windy(self, c=(1, 1, 1), scale=1.0) -> int:
        return self._add_tex(TEX_WINDY, c, scale=scale)

    def tex_dots(self, c0=(1, 1, 1), c1=(0, 0, 0)) -> int:
        return self._add_tex(TEX_DOTS, c0, c1)

    def tex_bilerp(self, v00=(0, 0, 0), v01=(1, 1, 1), v10=(0, 0, 0),
                   v11=(1, 1, 1)) -> int:
        """Bilinear interpolation of four constant corners over uv
        (bilerp.cpp)."""
        i = self._add_tex(TEX_BILERP, v00, v11)
        self._tex[i]["c2"] = _rgb(v01)
        self._tex[i]["c3"] = _rgb(v10)
        return i

    def tex_scale(self, c0=(1, 1, 1), c1=(1, 1, 1), tex1=-1, tex2=-1) -> int:
        """tex1 * tex2 (scale.cpp); the constants where a slot is -1."""
        return self._add_tex(TEX_SCALE, c0, c1, tex1=tex1, tex2=tex2)

    def tex_mix(self, c0=(0, 0, 0), c1=(1, 1, 1), amount=0.5,
                tex1=-1, tex2=-1) -> int:
        """(1 - amount) tex1 + amount tex2 (mix.cpp)."""
        return self._add_tex(TEX_MIX, c0, c1, scale=amount, tex1=tex1,
                             tex2=tex2)

    # --- media (reference src/media/{homogeneous,grid}.cpp) ---
    def homogeneous_medium(self, sigma_a=(1, 1, 1), sigma_s=(1, 1, 1),
                           g=0.0) -> int:
        self._med.append(dict(mtype=MEDIUM_HOMOGENEOUS, sigma_a=_rgb(sigma_a),
                              sigma_s=_rgb(sigma_s), g=g))
        return len(self._med) - 1

    def grid_medium(self, density: np.ndarray, world_to_medium,
                    sigma_a=(1, 1, 1), sigma_s=(1, 1, 1), g=0.0) -> int:
        """density: (nz, ny, nx); world_to_medium maps world -> [0,1]^3."""
        if self._grid_density is not None:
            raise ValueError("only one grid-density medium supported per scene")
        self._med.append(dict(mtype=MEDIUM_GRID, sigma_a=_rgb(sigma_a),
                              sigma_s=_rgb(sigma_s), g=g))
        self._grid_density = np.asarray(density, np.float32)
        self._grid_world_to_medium = np.asarray(world_to_medium, np.float32)
        self._grid_medium_index = len(self._med) - 1
        return self._grid_medium_index

    # --- shapes (reference src/shapes/{sphere,triangle}.cpp) ---
    def sphere(self, center=(0, 0, 0), radius=1.0, material: int = -1,
               medium_inside: int = -1, medium_outside: int = -1,
               _area_light: int = -1) -> int:
        self._sph.append(dict(center=_rgb(center), radius=float(radius),
                              material=material, mi=medium_inside,
                              mo=medium_outside, al=_area_light))
        return len(self._sph) - 1

    def triangle(self, p0, p1, p2, material: int = -1, medium_inside: int = -1,
                 medium_outside: int = -1, _area_light: int = -1,
                 tangent=None, n0=None, n1=None, n2=None, uv0=None, uv1=None,
                 uv2=None) -> int:
        """One triangle.  ``n0/n1/n2``: optional per-vertex shading normals
        (None = faceted).  ``tangent`` defaults to pbrt's dpdu, solved from
        ``uv0/uv1/uv2`` when given (triangle.cpp:149-162) and
        ``p1 - p0`` for the default UVs; the UVs are stored, pbrt's
        defaults (0,0)/(1,0)/(1,1) where none are given."""
        if tangent is None:
            if uv0 is not None:
                a0, a1, a2 = (np.asarray(u, np.float32)
                              for u in (uv0, uv1, uv2))
                duv02, duv12 = a0 - a2, a1 - a2
                dp02 = _rgb(p0) - _rgb(p2)
                dp12 = _rgb(p1) - _rgb(p2)
                det = duv02[0] * duv12[1] - duv02[1] * duv12[0]
                e = (duv12[1] * dp02 - duv02[1] * dp12) / det \
                    if abs(det) > 1e-12 else _rgb(p1) - _rgb(p0)
            else:
                e = _rgb(p1) - _rgb(p0)
            ln = float(np.linalg.norm(e))
            tangent = e / ln if ln > 1e-12 else None
        z3 = np.zeros(3, np.float32)
        self._tri.append(dict(
            p0=_rgb(p0), p1=_rgb(p1), p2=_rgb(p2), material=material,
            mi=medium_inside, mo=medium_outside, al=_area_light,
            tangent=_rgb(tangent) if tangent is not None else z3,
            n0=_rgb(n0) if n0 is not None else z3,
            n1=_rgb(n1) if n1 is not None else z3,
            n2=_rgb(n2) if n2 is not None else z3,
            **({} if uv0 is None else dict(
                uv0=np.asarray(uv0, np.float32),
                uv1=np.asarray(uv1, np.float32),
                uv2=np.asarray(uv2, np.float32)))))
        return len(self._tri) - 1

    def quad(self, p0, p1, p2, p3, **kw) -> Sequence[int]:
        """Two triangles (p0,p1,p2) and (p0,p2,p3)."""
        return self.triangle(p0, p1, p2, **kw), self.triangle(p0, p2, p3, **kw)

    def box(self, lo, hi, **kw) -> None:
        """Axis-aligned box as 12 triangles with outward normals (the side
        opposite the geometric normal is ``medium_inside``)."""
        lx, ly, lz = (float(v) for v in lo)
        hx, hy, hz = (float(v) for v in hi)
        self.quad((lx, ly, lz), (lx, hy, lz), (hx, hy, lz), (hx, ly, lz), **kw)
        self.quad((lx, ly, hz), (hx, ly, hz), (hx, hy, hz), (lx, hy, hz), **kw)
        self.quad((lx, ly, lz), (hx, ly, lz), (hx, ly, hz), (lx, ly, hz), **kw)
        self.quad((lx, hy, lz), (lx, hy, hz), (hx, hy, hz), (hx, hy, lz), **kw)
        self.quad((lx, ly, lz), (lx, ly, hz), (lx, hy, hz), (lx, hy, lz), **kw)
        self.quad((hx, ly, lz), (hx, hy, lz), (hx, hy, hz), (hx, ly, hz), **kw)

    # --- lights (reference src/lights/*.cpp) ---
    def _add_light(self, **kw) -> int:
        base = dict(shape_kind=-1, shape_index=-1, two_sided=0, medium=-1,
                    cos_falloff_start=1.0, cos_total_width=1.0,
                    direction=np.zeros(3, np.float32), img=-1,
                    world_to_light=np.eye(4, dtype=np.float32))
        base.update(kw)
        self._light.append(base)
        return len(self._light) - 1

    def _add_light_image(self, image) -> int:
        self._light_images.append(build_pyramid(np.asarray(image, np.float32)))
        return len(self._light_images) - 1

    def goniometric_light(self, position=(0, 0, 0), intensity=(1, 1, 1),
                          image=None, world_to_light=None,
                          medium: int = -1) -> int:
        """Goniophotometric point light (goniometric.cpp): I scaled by an
        angular map indexed by the emitted direction's spherical
        coordinates in light space."""
        img = self._add_light_image(image) if image is not None else -1
        w2l = (np.asarray(world_to_light, np.float32)
               if world_to_light is not None else np.eye(4, dtype=np.float32))
        return self._add_light(ltype=LIGHT_GONIOMETRIC,
                               position=_rgb(position), emit=_rgb(intensity),
                               medium=medium, img=img, world_to_light=w2l)

    def projection_light(self, position=(0, 0, 0), intensity=(1, 1, 1),
                         image=None, fov=45.0, target=(0, 0, 1),
                         medium: int = -1) -> int:
        """Slide projector (projection.cpp): a point light emitting the
        image through a perspective frustum of ``fov`` degrees toward
        ``target``, nothing outside it.  ``cos_falloff_start`` holds
        cos(fov/2), ``cos_total_width`` the frustum's corner cone."""
        img = self._add_light_image(image) if image is not None else -1
        w = _rgb(target) - _rgb(position)
        w = w / max(np.linalg.norm(w), 1e-9)
        # light space: +z along the projection axis, a non-parallel up
        up = (0.0, 1.0, 0.0) if abs(float(w[1])) < 0.99 else (1.0, 0.0, 0.0)
        l2w = np.asarray(tfm.look_at(_rgb(position), _rgb(position) + w, up),
                         np.float32)
        w2l = np.linalg.inv(l2w).astype(np.float32)
        half_d = np.deg2rad(fov) * 0.5
        cos_total = float(np.cos(np.arctan(np.tan(half_d) * np.sqrt(2.0))))
        return self._add_light(ltype=LIGHT_PROJECTION, position=_rgb(position),
                               direction=w, emit=_rgb(intensity),
                               medium=medium, img=img, world_to_light=w2l,
                               cos_total_width=cos_total,
                               cos_falloff_start=float(np.cos(half_d)))

    def point_light(self, position=(0, 0, 0), intensity=(1, 1, 1),
                    medium: int = -1) -> int:
        return self._add_light(ltype=LIGHT_POINT, position=_rgb(position),
                               emit=_rgb(intensity), medium=medium)

    def spot_light(self, position=(0, 0, 0), target=(0, 0, 1),
                   intensity=(1, 1, 1), coneangle=30.0, conedeltaangle=5.0,
                   medium: int = -1) -> int:
        """Spot light (spot.cpp): full intensity inside coneangle -
        conedeltaangle degrees, a smooth falloff to coneangle."""
        w = _rgb(target) - _rgb(position)
        w = w / max(np.linalg.norm(w), 1e-9)
        return self._add_light(
            ltype=LIGHT_SPOT, position=_rgb(position), direction=w,
            emit=_rgb(intensity), medium=medium,
            cos_falloff_start=float(np.cos(np.deg2rad(coneangle
                                                      - conedeltaangle))),
            cos_total_width=float(np.cos(np.deg2rad(coneangle))))

    def distant_light(self, direction=(0, 0, -1), radiance=(1, 1, 1)) -> int:
        """Distant light (distant.cpp); ``direction`` is the way the light
        travels."""
        w = np.asarray(direction, np.float32)
        w = w / np.linalg.norm(w)
        return self._add_light(ltype=LIGHT_DISTANT,
                               position=np.zeros(3, np.float32), direction=w,
                               emit=_rgb(radiance))

    def infinite_light(self, radiance=(1, 1, 1), image=None,
                       world_to_light=None) -> int:
        """Environment light (infinite.cpp): constant L, or L times an
        equirectangular map, importance-sampled by the map's luminance
        Distribution2D.  The last image-mapped one is the scene's env map."""
        img = self._add_light_image(image) if image is not None else -1
        w2l = (np.asarray(world_to_light, np.float32)
               if world_to_light is not None else np.eye(4, dtype=np.float32))
        return self._add_light(ltype=LIGHT_INFINITE,
                               position=np.zeros(3, np.float32),
                               emit=_rgb(radiance), img=img,
                               world_to_light=w2l)

    def area_light_sphere(self, center, radius, radiance, material: int = -1,
                          two_sided=False, medium: int = -1,
                          medium_inside: int = -1) -> int:
        """Diffuse area light over a sphere (src/lights/diffuse.cpp);
        returns the light id."""
        light_id = len(self._light)
        sidx = self.sphere(center, radius, material=material,
                           _area_light=light_id, medium_inside=medium_inside,
                           medium_outside=medium)
        return self._add_light(
            ltype=LIGHT_DIFFUSE_AREA, position=_rgb(center),
            emit=_rgb(radiance), shape_kind=SHAPE_SPHERE, shape_index=sidx,
            two_sided=int(two_sided), medium=medium)

    def area_light_quad(self, p0, p1, p2, p3, radiance, material: int = -1,
                        two_sided=False, medium: int = -1) -> int:
        """Diffuse area light over two triangles; returns the first light id."""
        ids = []
        for tri in [(p0, p1, p2), (p0, p2, p3)]:
            light_id = len(self._light)
            tidx = self.triangle(*tri, material=material, _area_light=light_id,
                                 medium_inside=medium, medium_outside=medium)
            self._add_light(
                ltype=LIGHT_DIFFUSE_AREA,
                position=np.mean(np.stack([_rgb(p) for p in tri]), 0),
                emit=_rgb(radiance), shape_kind=SHAPE_TRIANGLE,
                shape_index=tidx, two_sided=int(two_sided), medium=medium)
            ids.append(light_id)
        return ids[0]

    def _build_lights(self, L, f, stack, col, i64) -> Lights:
        """The light table: the per-light image fields, the light atlas and
        the env map's Distribution2D over luminance * sin(theta), in the
        reference's numpy float32 expressions (builder.py:1108-1166)."""
        atlas, offs = pack_atlas(self._light_images)
        n_l = len(L)
        l_off = np.full(n_l, -1, np.int64)
        l_w, l_h = np.zeros(n_l, np.int64), np.zeros(n_l, np.int64)
        l_mean = np.ones((n_l, 3), np.float32)
        env_light = -1
        for i, li in enumerate(L):
            if li["img"] >= 0:
                py = self._light_images[li["img"]]
                l_off[i] = offs[li["img"]]
                l_h[i], l_w[i] = py[0].shape[:2]
                l_mean[i] = py[0].reshape(-1, 3).mean(0)
                if li["ltype"] == LIGHT_INFINITE:
                    env_light = i
        if env_light >= 0:
            env0 = self._light_images[L[env_light]["img"]][0]
            lum = env0 @ _LUM
            He, We = lum.shape
            sin_t = np.sin(np.pi * (np.arange(He) + 0.5) / He).astype(
                np.float32)
            func = np.maximum(lum * sin_t[:, None], 0.0).astype(np.float32)
            row_int = func.mean(axis=1)
            cond = np.concatenate(
                [np.zeros((He, 1), np.float32), np.cumsum(func, axis=1) / We],
                1)
            cond = cond / np.maximum(row_int[:, None], 1e-30)
            marg = np.concatenate(
                [np.zeros(1, np.float32), np.cumsum(row_int) / He])
            marg = marg / max(marg[-1], 1e-30)
            env = (func, marg.astype(np.float32), cond.astype(np.float32))
        else:
            env = (np.zeros((1, 1), np.float32), np.zeros(2, np.float32),
                   np.zeros((1, 2), np.float32))
        return Lights(
            ltype=col(L, "ltype"), position=stack(L, "position"),
            direction=stack(L, "direction"), emit=stack(L, "emit"),
            shape_kind=col(L, "shape_kind"), shape_index=col(L, "shape_index"),
            two_sided=col(L, "two_sided"), medium=col(L, "medium"),
            cos_falloff_start=col(L, "cos_falloff_start", torch.float32),
            cos_total_width=col(L, "cos_total_width", torch.float32),
            img_off=i64(l_off), img_w=i64(l_w), img_h=i64(l_h),
            img_mean=f(l_mean),
            world_to_light=(f(np.stack([li["world_to_light"] for li in L]))
                            if L else f(np.zeros((0, 4, 4), np.float32))),
            atlas=f(atlas), env_light=i64(env_light), env_func=f(env[0]),
            env_marg_cdf=f(env[1]), env_cond_cdf=f(env[2]),
            kinds=light_kinds([li["ltype"] for li in L]))

    # --- freeze ---
    def build(self, device="cuda") -> Scene:
        device = resolve_device(device)

        def f(a) -> torch.Tensor:
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        def stack(rows, key, width=3, default=None):
            if not rows:
                return f(np.zeros((0, width), np.float32))
            return f(np.stack([np.asarray(r.get(key, default), np.float32)
                               for r in rows]))

        def col(rows, key, dtype=torch.int64):
            vals = [r[key] for r in rows]
            np_dtype = np.float32 if dtype == torch.float32 else np.int64
            return torch.as_tensor(np.array(vals, np_dtype).reshape(-1),
                                   dtype=dtype, device=device)

        sph = self._sph
        spheres = Spheres(stack(sph, "center"),
                          col(sph, "radius", torch.float32),
                          *(col(sph, k) for k in ("material", "mi", "mo",
                                                  "al")))
        tri = self._tri
        triangles = Triangles(
            stack(tri, "p0"), stack(tri, "p1"), stack(tri, "p2"),
            col(tri, "material"), col(tri, "mi"), col(tri, "mo"),
            col(tri, "al"), stack(tri, "tangent"), stack(tri, "n0"),
            stack(tri, "n1"), stack(tri, "n2"),
            *(stack(tri, k, 2, _UV_DEFAULT[j])
              for j, k in enumerate(("uv0", "uv1", "uv2"))))
        mat = self._mat
        materials = Materials(
            col(mat, "mtype"), stack(mat, "kd"), stack(mat, "ks"),
            col(mat, "eta", torch.float32), col(mat, "roughness", torch.float32),
            stack(mat, "metal_eta"), stack(mat, "metal_k"), col(mat, "kd_tex"),
            col(mat, "mix_m1"), col(mat, "mix_m2"), stack(mat, "mix_amount"),
            material_kinds([r["mtype"] for r in mat]))
        atlas, img_offs = pack_atlas(self._images)
        tex = self._tex
        t_off = np.full(len(tex), -1, np.int64)
        t_w, t_h, t_nl = (np.zeros(len(tex), np.int64) for _ in range(3))
        for i, t in enumerate(tex):
            if t["img"] >= 0:
                py = self._images[t["img"]]
                t_off[i] = img_offs[t["img"]]
                t_h[i], t_w[i] = py[0].shape[:2]
                t_nl[i] = len(py)

        def i64(a):
            return torch.as_tensor(a, dtype=torch.int64, device=device)

        textures = Textures(
            ttype=col(tex, "ttype"), c0=stack(tex, "c0"), c1=stack(tex, "c1"),
            scale=col(tex, "scale", torch.float32), octaves=col(tex, "octaves"),
            omega=col(tex, "omega", torch.float32), img_off=i64(t_off),
            img_w=i64(t_w), img_h=i64(t_h), n_levels=i64(t_nl),
            uv_scale=stack(tex, "uv_scale", 2),
            uv_delta=stack(tex, "uv_delta", 2), atlas=f(atlas),
            child0=col(tex, "child0"), child1=col(tex, "child1"),
            c2=stack(tex, "c2"), c3=stack(tex, "c3"),
            perm=noise_permutation(device), depth=_tex_graph_depth(tex))
        L = self._light
        lights = self._build_lights(L, f, stack, col, i64)
        density = (self._grid_density if self._grid_density is not None
                   else np.zeros((1, 1, 1), np.float32))
        w2m = (self._grid_world_to_medium
               if self._grid_world_to_medium is not None
               else np.eye(4, dtype=np.float32))
        media = Media(col(self._med, "mtype"), stack(self._med, "sigma_a"),
                      stack(self._med, "sigma_s"),
                      col(self._med, "g", torch.float32), f(density), f(w2m),
                      torch.tensor(self._grid_medium_index, dtype=torch.int64,
                                   device=device))
        pts = []
        for sp in sph:
            pts.append(sp["center"] - sp["radius"])
            pts.append(sp["center"] + sp["radius"])
        for t in tri:
            pts.extend([t["p0"], t["p1"], t["p2"]])
        for li in L:  # distant, infinite, goniometric, projection: no
            if li["ltype"] in (LIGHT_POINT, LIGHT_SPOT):
                pts.append(li["position"])
        if pts:
            allp = np.stack(pts)
            wmin, wmax = allp.min(0), allp.max(0)
        else:
            wmin = np.full(3, -1.0, np.float32)
            wmax = np.full(3, 1.0, np.float32)
        return Scene(
            spheres=spheres, triangles=triangles, materials=materials,
            lights=lights, media=media, textures=textures,
            camera_medium=torch.tensor(self.camera_medium, dtype=torch.int64,
                                       device=device),
            world_min=f(wmin), world_max=f(wmax))
