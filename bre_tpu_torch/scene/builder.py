"""Declarative scene builder (counterpart of ``bre_tpu/scene/builder.py``).

The slice's subset: homogeneous media, matte materials, triangles (with
pbrt's ``ss = normalize(dpdu)`` tangent), quads, boxes, point lights and
quad area lights.  Parameter names and the numpy arithmetic match the
reference, so ``build()`` yields the same values as
``scene_from_jax(bre_tpu SceneBuilder.build())``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .scene import (LIGHT_DIFFUSE_AREA, LIGHT_POINT, MAT_MATTE,
                    MEDIUM_HOMOGENEOUS, SHAPE_TRIANGLE, Lights, Materials,
                    Media, Scene, Spheres, Triangles)


def _rgb(v) -> np.ndarray:
    a = np.asarray(v, np.float32)
    if a.shape == ():
        a = np.full(3, float(a), np.float32)
    return a


class SceneBuilder:
    def __init__(self) -> None:
        self._tri: List[dict] = []
        self._mat: List[dict] = []
        self._light: List[dict] = []
        self._med: List[dict] = []
        self.camera_medium = -1

    # --- materials (reference src/materials/matte.cpp) ---
    def matte(self, kd=(0.5, 0.5, 0.5)) -> int:
        self._mat.append(dict(mtype=MAT_MATTE, kd=_rgb(kd), kd_tex=-1))
        return len(self._mat) - 1

    # --- media (reference src/media/homogeneous.cpp) ---
    def homogeneous_medium(self, sigma_a=(1, 1, 1), sigma_s=(1, 1, 1),
                           g=0.0) -> int:
        self._med.append(dict(mtype=MEDIUM_HOMOGENEOUS, sigma_a=_rgb(sigma_a),
                              sigma_s=_rgb(sigma_s), g=g))
        return len(self._med) - 1

    # --- shapes (reference src/shapes/triangle.cpp) ---
    def triangle(self, p0, p1, p2, material: int = -1, medium_inside: int = -1,
                 medium_outside: int = -1, _area_light: int = -1) -> int:
        """One triangle; its tangent is pbrt's dpdu for the default UVs,
        ``normalize(p1 - p0)`` (triangle.cpp GetUVs / dpdu solve)."""
        e = _rgb(p1) - _rgb(p0)
        ln = float(np.linalg.norm(e))
        tangent = _rgb(e / ln) if ln > 1e-12 else np.zeros(3, np.float32)
        self._tri.append(dict(p0=_rgb(p0), p1=_rgb(p1), p2=_rgb(p2),
                              material=material, mi=medium_inside,
                              mo=medium_outside, al=_area_light,
                              tangent=tangent))
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
    def build(self, device="cpu") -> Scene:
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

        no_sph = Spheres(f(np.zeros((0, 3))), col([], "r", torch.float32),
                         *(col([], "x") for _ in range(4)))
        tri = self._tri
        triangles = Triangles(
            stack(tri, "p0"), stack(tri, "p1"), stack(tri, "p2"),
            col(tri, "material"), col(tri, "mi"), col(tri, "mo"),
            col(tri, "al"), stack(tri, "tangent"),
            *(f(np.zeros((len(tri), 3), np.float32)) for _ in range(3)))
        materials = Materials(col(self._mat, "mtype"), stack(self._mat, "kd"),
                              col(self._mat, "kd_tex"))
        L = self._light
        lights = Lights(col(L, "ltype"), stack(L, "position"), stack(L, "emit"),
                        col(L, "shape_kind"), col(L, "shape_index"),
                        col(L, "two_sided"), col(L, "medium"))
        media = Media(col(self._med, "mtype"), stack(self._med, "sigma_a"),
                      stack(self._med, "sigma_s"),
                      col(self._med, "g", torch.float32))
        pts = []
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
            spheres=no_sph, triangles=triangles, materials=materials,
            lights=lights, media=media,
            camera_medium=torch.tensor(self.camera_medium, dtype=torch.int64,
                                       device=device),
            world_min=f(wmin), world_max=f(wmax))
