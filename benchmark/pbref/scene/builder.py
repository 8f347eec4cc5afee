"""Declarative scene builder (counterpart of ``bre_tpu/scene/builder.py``).

Homogeneous and grid-density media (one grid per scene), every material
of the reference (matte, mirror, glass, metal, plastic, uber, substrate,
translucent, mix, hair, subsurface and kdsubsurface with their
beam-diffusion tables, and the measured Fourier BSDF), the texture table with its
MIPMap atlas, spheres, triangles (with per-vertex shading normals and uvs,
and pbrt's ``ss = normalize(dpdu)`` tangent from the uvs), quads, boxes,
the shapes the reference tessellates into triangles (disk, cylinder, cone,
paraboloid, hyperboloid, heightfield, curves, Loop subdivision surfaces
and NURBS patches; the tri-BVH over the triangles at ``BVH_MIN_TRIANGLES``
and above), and every light type: point, spot, goniometric, projection,
distant and infinite lights (constant or image-mapped, the light images
packed in their own MIPMap atlas, the env map's Distribution2D built here)
and diffuse area lights on triangles and spheres.  Parameter names and the numpy arithmetic
match the reference, so ``build()`` yields the same values as
``scene_from_jax(bre_tpu SceneBuilder.build())``.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..accel.lbvh import build_lbvh
from ..bssrdf import bssrdf_tables
from ..fourier import stack_fourier_tables
from ..materials import COPPER_ETA, COPPER_K
from ..textures import (TEX_BILERP, TEX_CHECKERBOARD, TEX_CONSTANT, TEX_DOTS,
                        TEX_FBM, TEX_IMAGE, TEX_MARBLE, TEX_MIX, TEX_SCALE,
                        TEX_UV, TEX_WINDY, TEX_WRINKLED, Textures,
                        build_pyramid, noise_permutation, pack_atlas)
from ..core import transform as tfm
from .scene import (LIGHT_DIFFUSE_AREA, LIGHT_DISTANT, LIGHT_GONIOMETRIC,
                    LIGHT_INFINITE, LIGHT_POINT, LIGHT_PROJECTION, LIGHT_SPOT,
                    MAT_FOURIER, MAT_GLASS, MAT_HAIR, MAT_KDSUBSURFACE,
                    MAT_MATTE, MAT_METAL, MAT_MIRROR, MAT_MIX, MAT_PLASTIC,
                    MAT_SUBSTRATE, MAT_SUBSURFACE, MAT_TRANSLUCENT, MAT_UBER,
                    MEDIUM_GRID, MEDIUM_HOMOGENEOUS, SHAPE_SPHERE,
                    SHAPE_TRIANGLE, Lights, Materials, Media, Scene, Spheres,
                    Triangles, light_kinds, material_kinds, resolve_device)

# luminance weights of the env map's sampling density (builder.py:1126)
_LUM = np.array([0.212671, 0.715160, 0.072169], np.float32)

# Triangle count at which build() attaches an LBVH over the triangles
# (Scene.tri_bvh), which intersect() then traverses per ray instead of
# sweeping every triangle (builder.py:63, 1205-1219).  Tests lower it to
# take both paths.
BVH_MIN_TRIANGLES = 16384

# pbrt's default triangle uvs (triangle.cpp GetUVs)
_UV_DEFAULT = (np.array([0.0, 0.0], np.float32),
               np.array([1.0, 0.0], np.float32),
               np.array([1.0, 1.0], np.float32))


def _trimmed(*_a, **_k):
    """Subsurface, measured and fiber materials are not in the benchmark's
    scenes: their modules were left out of this copy."""
    raise NotImplementedError("left out of the benchmark's frozen copy")


compute_beam_diffusion_bssrdf = get_medium_scattering_properties = _trimmed
subsurface_from_diffuse = read_bsdf_file = _trimmed
sigma_a_from_concentration = _trimmed


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
        self._bss_tables: List[dict] = []  # beam-diffusion tables
        self._bss_keys: dict = {}  # (g, eta) -> row of _bss_tables
        self._fourier_tables: List = []  # fourier.FourierTable rows
        self.camera_medium = -1

    # --- materials (reference src/materials/*.cpp) ---
    def _add_mat(self, mtype, kd, ks, eta=1.0, roughness=0.0,
                 metal_eta=(1.0, 1.0, 1.0), metal_k=(0.0, 0.0, 0.0),
                 kd_tex=-1, mix_m1=-1, mix_m2=-1,
                 mix_amount=(0.5, 0.5, 0.5), beta_n=0.3, hair_alpha=2.0,
                 bss_sigma_a=(0, 0, 0), bss_sigma_s=(0, 0, 0), bss_table=-1,
                 fourier=-1) -> int:
        self._mat.append(dict(
            mtype=mtype, kd=_rgb(kd), ks=_rgb(ks), eta=eta,
            roughness=roughness, metal_eta=_rgb(metal_eta),
            metal_k=_rgb(metal_k), kd_tex=kd_tex, mix_m1=mix_m1,
            mix_m2=mix_m2, mix_amount=_rgb(mix_amount), beta_n=beta_n,
            hair_alpha=hair_alpha, bss_sigma_a=_rgb(bss_sigma_a),
            bss_sigma_s=_rgb(bss_sigma_s), bss_table=bss_table,
            fourier=fourier))
        return len(self._mat) - 1

    def _bss_table_for(self, g: float, eta: float) -> int:
        """One beam-diffusion table per unique (g, eta)
        (ComputeBeamDiffusionBSSRDF; builder.py:122-133)."""
        key = (round(float(g), 6), round(float(eta), 6))
        if key not in self._bss_keys:
            self._bss_keys[key] = len(self._bss_tables)
            self._bss_tables.append(compute_beam_diffusion_bssrdf(g, eta))
        return self._bss_keys[key]

    def subsurface(self, name=None, sigma_a=None, sigma_s=None, g=0.0,
                   eta=1.33, scale=1.0, kr=(1.0, 1.0, 1.0),
                   kt=(1.0, 1.0, 1.0)) -> int:
        """SubsurfaceMaterial (subsurface.cpp:46-137; builder.py:135-166):
        a smooth dielectric BSDF and a TabulatedBSSRDF.  ``name`` takes a
        measured medium's sigmas and forces g = 0; the defaults are
        Wholemilk's."""
        sa = np.asarray((0.0011, 0.0024, 0.014), np.float32)
        ss = np.asarray((2.55, 3.21, 3.77), np.float32)
        if name is not None:
            props = get_medium_scattering_properties(name)
            if props is None:
                warnings.warn(f'named scattering material "{name}" not '
                              "found; using defaults")
            else:
                ss, sa = props
                g = 0.0
        if sigma_a is not None:
            sa = _rgb(sigma_a)
        if sigma_s is not None:
            ss = _rgb(sigma_s)
        tab = self._bss_table_for(g, eta)
        return self._add_mat(MAT_SUBSURFACE, kd=kr, ks=kt, eta=eta,
                             bss_sigma_a=scale * sa, bss_sigma_s=scale * ss,
                             bss_table=tab)

    def kdsubsurface(self, kd=(0.5, 0.5, 0.5), mfp=(1.0, 1.0, 1.0), g=0.0,
                     eta=1.33, scale=1.0, kr=(1.0, 1.0, 1.0),
                     kt=(1.0, 1.0, 1.0)) -> int:
        """KdSubsurfaceMaterial (kdsubsurface.cpp:44-124; builder.py:
        168-182): the sigmas inverted from a diffuse color and a mean free
        path (SubsurfaceFromDiffuse)."""
        tab = self._bss_table_for(g, eta)
        sa, ss = subsurface_from_diffuse(self._bss_tables[tab], _rgb(kd),
                                         scale * _rgb(mfp))
        return self._add_mat(MAT_KDSUBSURFACE, kd=kr, ks=kt, eta=eta,
                             bss_sigma_a=sa, bss_sigma_s=ss, bss_table=tab)

    def hair(self, sigma_a=None, color=None, eumelanin=None, pheomelanin=0.0,
             beta_m=0.3, beta_n=0.3, alpha=2.0, eta=1.55) -> int:
        """HairMaterial (hair.cpp CreateHairMaterial; builder.py:184-208):
        sigma_a given, from a reflectance ``color`` (SigmaAFromReflectance)
        or from melanin concentrations; sigma_a is stored in kd and
        beta_m in roughness."""
        if sigma_a is None:
            if color is not None:
                c = np.clip(_rgb(color), 1e-4, 0.999)
                denom = (5.969 - 0.215 * beta_n + 2.532 * beta_n**2
                         - 10.73 * beta_n**3 + 5.574 * beta_n**4
                         + 0.245 * beta_n**5)
                sigma_a = (np.log(c) / denom) ** 2
            else:  # the reference's eumelanin 1.3 by default
                sigma_a = sigma_a_from_concentration(
                    1.3 if eumelanin is None else eumelanin,
                    pheomelanin if eumelanin is not None else 0.0)
        return self._add_mat(MAT_HAIR, kd=sigma_a, ks=(0, 0, 0), eta=eta,
                             roughness=beta_m, beta_n=beta_n,
                             hair_alpha=alpha)

    def fourier_material(self, bsdffile=None, table=None) -> int:
        """FourierMaterial (fourier.cpp:200-230; builder.py:964-978): a
        tabulated BSDF from a SCATFUN ``.bsdf`` file or an in-memory
        ``fourier.FourierTable``."""
        if table is None:
            if bsdffile is None:
                raise ValueError("fourier material needs bsdffile= or table=")
            table = read_bsdf_file(bsdffile)
        self._fourier_tables.append(table)
        return self._add_mat(MAT_FOURIER, kd=(0, 0, 0), ks=(0, 0, 0),
                             eta=table.eta,
                             fourier=len(self._fourier_tables) - 1)

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
        """MixMaterial (mixmat.cpp): amount m1 + (1 - amount) m2.  A mix may
        name a mix; the BSDFs read one level of sub-material, as the
        reference's do (materials.py:267-283, 492-505)."""
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

    def _revolve(self, profile, axis_o, axis_z, n_u: int, closed_bottom=None,
                 closed_top=None, **kw) -> None:
        """Tessellate a surface of revolution: profile = [(r_i, z_i), ...].

        The quadrics (disk, cylinder, cone, paraboloid, hyperboloid; pbrt's
        src/shapes/*.cpp) become triangles at build time, as in the
        reference (builder.py:446-490), so one intersection routine serves
        every shape.  A face whose ring edge has collapsed (``np.allclose``,
        the cone's apex ring) is dropped, as there.
        """
        o = np.asarray(axis_o, np.float32)
        z = np.asarray(axis_z, np.float32)
        z = z / max(np.linalg.norm(z), 1e-9)
        x = np.array([1.0, 0, 0], np.float32)
        if abs(float(np.dot(x, z))) > 0.9:
            x = np.array([0, 1.0, 0], np.float32)
        x = np.cross(z, x)
        x /= max(np.linalg.norm(x), 1e-9)
        y = np.cross(z, x)
        ang = np.linspace(0, 2 * np.pi, n_u, endpoint=False)
        rings = []
        for r, h in profile:
            ring = (o[None, :] + r * (np.cos(ang)[:, None] * x
                                      + np.sin(ang)[:, None] * y)
                    + h * z[None, :])
            rings.append(ring)
        for k in range(len(rings) - 1):
            a, bq = rings[k], rings[k + 1]
            for i in range(n_u):
                j = (i + 1) % n_u
                if not np.allclose(a[i], a[j]):
                    self.triangle(a[i], a[j], bq[j], **kw)
                if not np.allclose(bq[i], bq[j]):
                    self.triangle(a[i], bq[j], bq[i], **kw)
        if closed_bottom is not None:
            c = o + closed_bottom * z
            ring = rings[0]
            for i in range(n_u):
                self.triangle(c, ring[(i + 1) % n_u], ring[i], **kw)
        if closed_top is not None:
            c = o + closed_top * z
            ring = rings[-1]
            for i in range(n_u):
                self.triangle(c, ring[i], ring[(i + 1) % n_u], **kw)

    def disk(self, center=(0, 0, 0), normal=(0, 0, 1), radius=1.0,
             inner_radius=0.0, n_u: int = 32, **kw) -> None:
        """Disk (src/shapes/disk.cpp), tessellated (fan when solid)."""
        if inner_radius <= 0.0:
            o = np.asarray(center, np.float32)
            z = np.asarray(normal, np.float32)
            z = z / max(np.linalg.norm(z), 1e-9)
            x = np.array([1.0, 0, 0], np.float32)
            if abs(float(np.dot(x, z))) > 0.9:
                x = np.array([0, 1.0, 0], np.float32)
            x = np.cross(z, x)
            x /= max(np.linalg.norm(x), 1e-9)
            y = np.cross(z, x)
            ang = np.linspace(0, 2 * np.pi, n_u, endpoint=False)
            ring = o[None, :] + radius * (np.cos(ang)[:, None] * x
                                          + np.sin(ang)[:, None] * y)
            for i in range(n_u):
                self.triangle(o, ring[i], ring[(i + 1) % n_u], **kw)
        else:
            prof = [(inner_radius, 0.0), (radius, 0.0)]
            self._revolve(prof, center, normal, n_u, **kw)

    def cylinder(self, center=(0, 0, 0), axis=(0, 0, 1), radius=1.0,
                 zmin=-1.0, zmax=1.0, n_u: int = 32, **kw) -> None:
        """Cylinder (src/shapes/cylinder.cpp), tessellated (open ends)."""
        self._revolve([(radius, zmin), (radius, zmax)], center, axis, n_u, **kw)

    def cone(self, center=(0, 0, 0), axis=(0, 0, 1), radius=1.0, height=1.0,
             n_u: int = 32, **kw) -> None:
        """Cone (src/shapes/cone.cpp), tessellated."""
        self._revolve([(radius, 0.0), (1e-5, height)], center, axis, n_u, **kw)

    def paraboloid(self, center=(0, 0, 0), axis=(0, 0, 1), radius=1.0,
                   zmax=1.0, n_v: int = 8, n_u: int = 32, **kw) -> None:
        """Paraboloid z = zmax*(r/radius)^2 (src/shapes/paraboloid.cpp)."""
        prof = [(radius * np.sqrt(t), zmax * t) for t in np.linspace(1e-4, 1.0, n_v)]
        self._revolve(prof, center, axis, n_u, **kw)

    def hyperboloid(self, center=(0, 0, 0), axis=(0, 0, 1), r1=0.5, r2=1.0,
                    zmin=0.0, zmax=1.0, n_v: int = 8, n_u: int = 32, **kw) -> None:
        """Hyperboloid of revolution (src/shapes/hyperboloid.cpp)."""
        prof = [(r1 + (r2 - r1) * t * t, zmin + (zmax - zmin) * t)
                for t in np.linspace(0.0, 1.0, n_v)]
        self._revolve(prof, center, axis, n_u, **kw)

    def heightfield(self, z: "np.ndarray", origin=(0, 0, 0), size=(1.0, 1.0),
                    **kw) -> None:
        """Heightfield grid -> triangles (src/shapes/heightfield.cpp)."""
        z = np.asarray(z, np.float32)
        ny, nx = z.shape
        ox, oy, oz = (float(v) for v in origin)
        sx, sy = (float(v) for v in size)
        xs = np.linspace(0, sx, nx) + ox
        ys = np.linspace(0, sy, ny) + oy
        for j in range(ny - 1):
            for i in range(nx - 1):
                p00 = (xs[i], ys[j], oz + z[j, i])
                p10 = (xs[i + 1], ys[j], oz + z[j, i + 1])
                p01 = (xs[i], ys[j + 1], oz + z[j + 1, i])
                p11 = (xs[i + 1], ys[j + 1], oz + z[j + 1, i + 1])
                self.triangle(p00, p10, p11, **kw)
                self.triangle(p00, p11, p01, **kw)

    def curve(self, control_points, width0=0.01, width1=0.01,
              n_segments: int = 16, n_sides: int = 4, ctype: str = "cylinder",
              n0=None, n1=None, facing=None, **kw) -> None:
        """Cubic Bezier curve (src/shapes/curve.cpp) tessellated at build into
        the shared triangle SoA (one intersection kernel for all geometry;
        the reference intersects curves analytically per ray).

        ``ctype`` mirrors the reference's CurveType (curve.h:60-70):

        - ``"cylinder"`` — tube of ``n_sides`` facets, linearly
          interpolated width;
        - ``"ribbon"`` — oriented flat strip: the orientation normal is the
          sin-weighted interpolation of the endpoint normals ``n0``/``n1``
          (curve.cpp:301-309 ``sin((1-u)θ)/sinθ · n0 + sin(uθ)/sinθ · n1``),
          and the strip spans ``normalize(cross(n_u, dpdu)) * width``
          (curve.cpp:335-336 dpdv);
        - ``"flat"`` — a ribbon that faces the viewer: the reference orients
          it per-ray; the static tessellation faces the ``facing`` point
          (the camera position when driven by the parser) — exact for
          primary rays, approximate for secondary.
        """
        cp = np.asarray(control_points, np.float32).reshape(4, 3)
        if ctype in ("flat", "ribbon"):
            self._curve_strip(cp, width0, width1, n_segments, ctype,
                              n0, n1, facing, **kw)
            return
        ts = np.linspace(0.0, 1.0, n_segments + 1, dtype=np.float32)
        # Bezier evaluation + derivative
        def bez(t):
            u = 1.0 - t
            return (u**3)[:, None] * cp[0] + (3*u*u*t)[:, None] * cp[1] + \
                   (3*u*t*t)[:, None] * cp[2] + (t**3)[:, None] * cp[3]
        def bez_d(t):
            u = 1.0 - t
            return (3*u*u)[:, None] * (cp[1]-cp[0]) + (6*u*t)[:, None] * (cp[2]-cp[1]) + \
                   (3*t*t)[:, None] * (cp[3]-cp[2])
        p = bez(ts)
        d = bez_d(ts)
        widths = width0 + (width1 - width0) * ts
        # stable frame transport along the curve
        rings = []
        prev_n = None
        for i in range(n_segments + 1):
            tangent = d[i] / max(np.linalg.norm(d[i]), 1e-9)
            if prev_n is None:
                ref = np.array([0, 0, 1.0], np.float32)
                if abs(float(np.dot(ref, tangent))) > 0.9:
                    ref = np.array([1.0, 0, 0], np.float32)
                n = np.cross(tangent, ref)
            else:
                n = prev_n - tangent * float(np.dot(prev_n, tangent))
            n = n / max(np.linalg.norm(n), 1e-9)
            prev_n = n
            bn = np.cross(tangent, n)
            ang = np.linspace(0, 2*np.pi, n_sides, endpoint=False)
            r = 0.5 * widths[i]
            ring = p[i][None, :] + r * (np.cos(ang)[:, None] * n
                                        + np.sin(ang)[:, None] * bn)
            rings.append(ring)
        for k in range(n_segments):
            a, bq = rings[k], rings[k + 1]
            # fiber tangent for the hair BSDF frame (curve dpdu)
            seg_t = p[k + 1] - p[k]
            seg_t = seg_t / max(np.linalg.norm(seg_t), 1e-9)
            kw_t = dict(kw, tangent=seg_t) if "tangent" not in kw else kw
            for i in range(n_sides):
                j = (i + 1) % n_sides
                self.triangle(a[i], a[j], bq[j], **kw_t)
                self.triangle(a[i], bq[j], bq[i], **kw_t)

    def _curve_strip(self, cp, width0, width1, n_segments, ctype,
                     n0, n1, facing, **kw):
        """Flat / ribbon curve tessellation (see ``curve``): a two-triangle
        strip per segment, side direction from the interpolated orientation
        normal (ribbon, curve.cpp:301-309,335) or the facing point (flat)."""
        ts = np.linspace(0.0, 1.0, n_segments + 1, dtype=np.float32)
        u = 1.0 - ts
        p = ((u**3)[:, None] * cp[0] + (3*u*u*ts)[:, None] * cp[1]
             + (3*u*ts*ts)[:, None] * cp[2] + (ts**3)[:, None] * cp[3])
        d = ((3*u*u)[:, None] * (cp[1]-cp[0]) + (6*u*ts)[:, None] * (cp[2]-cp[1])
             + (3*ts*ts)[:, None] * (cp[3]-cp[2]))
        widths = width0 + (width1 - width0) * ts

        if ctype == "ribbon":
            if n0 is None or n1 is None:
                raise ValueError(
                    'ribbon curves need two normals ("N", curve.cpp:429)')
            na = np.asarray(n0, np.float32)
            nb = np.asarray(n1, np.float32)
            na /= max(np.linalg.norm(na), 1e-9)
            nb /= max(np.linalg.norm(nb), 1e-9)
            cosang = float(np.clip(np.dot(na, nb), 0.0, 1.0))
            ang = np.arccos(cosang)  # normalAngle (curve.cpp:85)
            inv_sin = 1.0 / max(np.sin(ang), 1e-6)
        else:
            face_pt = np.asarray(
                facing if facing is not None else (0.0, 0.0, 0.0), np.float32)

        verts = []
        for i in range(n_segments + 1):
            tangent = d[i] / max(np.linalg.norm(d[i]), 1e-9)
            if ctype == "ribbon":
                if ang < 1e-5:
                    n_u = na
                else:
                    n_u = (np.sin((1.0 - ts[i]) * ang) * inv_sin * na
                           + np.sin(ts[i] * ang) * inv_sin * nb)
                side = np.cross(n_u, tangent)
            else:  # flat: face the viewer
                view = face_pt - p[i]
                side = np.cross(view, tangent)
            side_n = np.linalg.norm(side)
            if side_n < 1e-9:  # degenerate: pick any perpendicular
                ref = np.array([0, 0, 1.0], np.float32)
                if abs(float(np.dot(ref, tangent))) > 0.9:
                    ref = np.array([1.0, 0, 0], np.float32)
                side = np.cross(ref, tangent)
                side_n = max(np.linalg.norm(side), 1e-9)
            side = side / side_n * (0.5 * widths[i])
            verts.append((p[i] - side, p[i] + side))
        for k in range(n_segments):
            (a0, a1), (b0, b1) = verts[k], verts[k + 1]
            seg_t = p[k + 1] - p[k]
            seg_t = seg_t / max(np.linalg.norm(seg_t), 1e-9)
            kw_t = dict(kw, tangent=seg_t) if "tangent" not in kw else kw
            self.triangle(a0, a1, b1, **kw_t)
            self.triangle(a0, b1, b0, **kw_t)

    def loopsubdiv(self, indices, P, nlevels: int = 2, **kw) -> None:
        """Loop subdivision surface (src/shapes/loopsubdiv.cpp) applied at
        build: ``nlevels`` rounds of 4-1 triangle split with Loop's vertex
        smoothing rules (beta weights for interior vertices, 1/8-3/4-1/8 for
        edge midpoints), then emitted as triangles.  A vertex's neighbours
        are summed in the iteration order of a Python ``set`` of their ids,
        as the reference sums them, so the float32 sums match bit for bit."""
        V = np.asarray(P, np.float32).reshape(-1, 3)
        F = np.asarray(indices, np.int64).reshape(-1, 3)
        for _ in range(nlevels):
            # edge midpoint indexing
            edges = {}
            new_faces = []
            mids = []

            def edge_key(a, b):
                return (min(a, b), max(a, b))

            # adjacency for vertex rule
            neighbors = [set() for _ in range(len(V))]
            for f in F:
                for a, b in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
                    neighbors[a].add(b)
                    neighbors[b].add(a)
            # opposite vertices per edge for the 1/8 weights
            opp = {}
            for f in F:
                for a, b, c in ((f[0], f[1], f[2]), (f[1], f[2], f[0]),
                                (f[2], f[0], f[1])):
                    opp.setdefault(edge_key(a, b), []).append(c)
            mid_pos = {}
            for (a, b), cs in opp.items():
                if len(cs) == 2:
                    mp = 0.375 * (V[a] + V[b]) + 0.125 * (V[cs[0]] + V[cs[1]])
                else:  # boundary edge
                    mp = 0.5 * (V[a] + V[b])
                mid_pos[(a, b)] = mp
            # smoothed original vertices (Loop beta rule)
            V_new = V.copy()
            for i in range(len(V)):
                n = len(neighbors[i])
                if n < 3:
                    continue
                beta = (0.625 - (0.375 + 0.25 * np.cos(2 * np.pi / n)) ** 2) / n
                V_new[i] = (1 - n * beta) * V[i] + beta * sum(
                    (V[j] for j in neighbors[i]), np.zeros(3, np.float32))
            # assign midpoint indices
            base = len(V_new)
            mid_idx = {}
            mid_list = []
            for k in mid_pos:
                mid_idx[k] = base + len(mid_list)
                mid_list.append(mid_pos[k])
            V = np.concatenate([V_new, np.asarray(mid_list, np.float32)
                                 if mid_list else np.zeros((0, 3), np.float32)])
            F2 = []
            for f in F:
                m01 = mid_idx[edge_key(f[0], f[1])]
                m12 = mid_idx[edge_key(f[1], f[2])]
                m20 = mid_idx[edge_key(f[2], f[0])]
                F2 += [(f[0], m01, m20), (f[1], m12, m01),
                       (f[2], m20, m12), (m01, m12, m20)]
            F = np.asarray(F2, np.int64)
        for f in F:
            self.triangle(V[f[0]], V[f[1]], V[f[2]], **kw)

    def nurbs(self, nu: int, nv: int, uorder: int, vorder: int,
              uknots, vknots, P, w=None, n_eval: int = 24, **kw) -> None:
        """NURBS patch (src/shapes/nurbs.cpp): Cox-de Boor basis evaluation on
        an ``n_eval`` x ``n_eval`` grid at build, emitted as triangles.
        ``P``: (nu*nv, 3) control points; ``w``: optional rational weights."""
        P = np.asarray(P, np.float32).reshape(nu * nv, 3)
        w = (np.asarray(w, np.float32).reshape(nu * nv)
             if w is not None else np.ones(nu * nv, np.float32))
        uk = np.asarray(uknots, np.float32)
        vk = np.asarray(vknots, np.float32)

        def basis(knots, order, n_cp, t):
            """Cox-de Boor: returns (n_cp,) basis values at parameter t."""
            k = order  # order = degree + 1 (pbrt convention)
            N = np.zeros((len(knots) - 1,), np.float32)
            # degree-0
            for i in range(len(knots) - 1):
                if knots[i] <= t < knots[i + 1]:
                    N[i] = 1.0
            if t >= knots[-1] - 1e-6:
                # clamp the end of the domain
                for i in range(len(knots) - 2, -1, -1):
                    if knots[i] < knots[i + 1]:
                        N[i] = 1.0
                        break
            for d in range(1, k):
                N_next = np.zeros_like(N)
                for i in range(len(N) - d):
                    left = 0.0
                    if knots[i + d] > knots[i]:
                        left = (t - knots[i]) / (knots[i + d] - knots[i]) * N[i]
                    right = 0.0
                    if knots[i + d + 1] > knots[i + 1]:
                        right = (knots[i + d + 1] - t) / (
                            knots[i + d + 1] - knots[i + 1]) * N[i + 1]
                    N_next[i] = left + right
                N = N_next
            return N[:n_cp]

        u0, u1 = float(uk[uorder - 1]), float(uk[nu])
        v0, v1 = float(vk[vorder - 1]), float(vk[nv])
        us = np.linspace(u0, u1, n_eval, dtype=np.float32)
        vs = np.linspace(v0, v1, n_eval, dtype=np.float32)
        grid = np.zeros((n_eval, n_eval, 3), np.float32)
        for iu, uu in enumerate(us):
            Bu = basis(uk, uorder, nu, uu)
            for iv, vv in enumerate(vs):
                Bv = basis(vk, vorder, nv, vv)
                wts = np.outer(Bu, Bv).reshape(-1) * w
                denom = max(float(wts.sum()), 1e-9)
                grid[iu, iv] = (wts[:, None] * P).sum(0) / denom
        for iu in range(n_eval - 1):
            for iv in range(n_eval - 1):
                a = grid[iu, iv]
                bq = grid[iu + 1, iv]
                c = grid[iu + 1, iv + 1]
                d_ = grid[iu, iv + 1]
                self.triangle(a, bq, c, **kw)
                self.triangle(a, c, d_, **kw)

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
            col(mat, "beta_n", torch.float32),
            col(mat, "hair_alpha", torch.float32), stack(mat, "bss_sigma_a"),
            stack(mat, "bss_sigma_s"), col(mat, "bss_table"),
            bssrdf_tables(self._bss_tables, device), col(mat, "fourier"),
            stack_fourier_tables(self._fourier_tables, device),
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
        tri_bvh = None
        if len(tri) >= BVH_MIN_TRIANGLES:
            bmin = torch.minimum(torch.minimum(triangles.p0, triangles.p1),
                                 triangles.p2)
            bmax = torch.maximum(torch.maximum(triangles.p0, triangles.p1),
                                 triangles.p2)
            tri_bvh = build_lbvh(bmin, bmax, torch.ones(
                len(tri), dtype=torch.bool, device=device))
        return Scene(
            spheres=spheres, triangles=triangles, materials=materials,
            lights=lights, media=media, textures=textures,
            camera_medium=torch.tensor(self.camera_medium, dtype=torch.int64,
                                       device=device),
            world_min=f(wmin), world_max=f(wmax), tri_bvh=tri_bvh)
