"""Declarative scene builder (counterpart of ``bre_tpu/scene/builder.py``).

The slice's subset: homogeneous and grid-density media (one grid per
scene), matte materials, spheres, triangles (with per-vertex shading
normals, and pbrt's ``ss = normalize(dpdu)`` tangent from the UVs), quads,
boxes, point lights and diffuse area lights on triangles and spheres.
Parameter names and the numpy arithmetic match the reference, so
``build()`` yields the same values as ``scene_from_jax(bre_tpu
SceneBuilder.build())``.  What the slice cannot render (textured materials)
raises NotImplementedError.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .scene import (LIGHT_DIFFUSE_AREA, LIGHT_POINT, MAT_MATTE, MEDIUM_GRID,
                    MEDIUM_HOMOGENEOUS, SHAPE_SPHERE, SHAPE_TRIANGLE, Lights,
                    Materials, Media, Scene, Spheres, Triangles, resolve_device)


def _rgb(v) -> np.ndarray:
    a = np.asarray(v, np.float32)
    if a.shape == ():
        a = np.full(3, float(a), np.float32)
    return a


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
        self.camera_medium = -1

    # --- materials (reference src/materials/matte.cpp) ---
    def matte(self, kd=(0.5, 0.5, 0.5), sigma=0.0, kd_tex=-1) -> int:
        """Lambertian whatever ``sigma`` is, as the reference's matte BSDF
        is (bre_tpu/materials.py:403, 544)."""
        if kd_tex >= 0:
            raise NotImplementedError(
                "textured materials are not ported (ROADMAP Queue 1 item 5: "
                "breadth, materials and textures)")
        self._mat.append(dict(mtype=MAT_MATTE, kd=_rgb(kd), kd_tex=-1))
        return len(self._mat) - 1

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
        ``p1 - p0`` for the default UVs; the UVs themselves are not stored
        (only textures read them)."""
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
            n2=_rgb(n2) if n2 is not None else z3))
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

    # --- lights (reference src/lights/{point,diffuse}.cpp) ---
    def _add_light(self, **kw) -> int:
        base = dict(shape_kind=-1, shape_index=-1, two_sided=0, medium=-1)
        base.update(kw)
        self._light.append(base)
        return len(self._light) - 1

    def point_light(self, position=(0, 0, 0), intensity=(1, 1, 1),
                    medium: int = -1) -> int:
        return self._add_light(ltype=LIGHT_POINT, position=_rgb(position),
                               emit=_rgb(intensity), medium=medium)

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

    # --- freeze ---
    def build(self, device="cuda") -> Scene:
        device = resolve_device(device)

        def f(a) -> torch.Tensor:
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        def stack(rows, key):
            if not rows:
                return f(np.zeros((0, 3), np.float32))
            return f(np.stack([np.asarray(r[key], np.float32) for r in rows]))

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
            stack(tri, "n1"), stack(tri, "n2"))
        materials = Materials(col(self._mat, "mtype"), stack(self._mat, "kd"),
                              col(self._mat, "kd_tex"))
        L = self._light
        lights = Lights(col(L, "ltype"), stack(L, "position"), stack(L, "emit"),
                        col(L, "shape_kind"), col(L, "shape_index"),
                        col(L, "two_sided"), col(L, "medium"))
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
        for li in L:
            if li["ltype"] == LIGHT_POINT:
                pts.append(li["position"])
        if pts:
            allp = np.stack(pts)
            wmin, wmax = allp.min(0), allp.max(0)
        else:
            wmin = np.full(3, -1.0, np.float32)
            wmax = np.full(3, 1.0, np.float32)
        return Scene(
            spheres=spheres, triangles=triangles, materials=materials,
            lights=lights, media=media,
            camera_medium=torch.tensor(self.camera_medium, dtype=torch.int64,
                                       device=device),
            world_min=f(wmin), world_max=f(wmax))
