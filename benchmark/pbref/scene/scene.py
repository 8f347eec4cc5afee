"""The Scene: structure-of-arrays world description (counterpart of
``bre_tpu/scene/scene.py``).

NamedTuples of tensors with integer tags; -1 means "none" (no material,
vacuum, no area light).  Ids are int64 so they index directly; positions,
colors and parameters are float32.  Only the fields the ported slice reads
are carried: every material of the reference (matte, mirror, glass,
metal, plastic, uber, substrate, translucent, hair, subsurface,
kdsubsurface, the measured Fourier BSDF, and mixes, read one level deep)
with the BSSRDF and Fourier tables, the texture table, every light type of the reference (point, spot, goniometric and
projection lights, diffuse area lights on triangles and spheres, distant
lights, and infinite lights, constant or image-mapped, with the light-image
atlas and the one env map's sampling tables), homogeneous and grid-density
media (at most one grid, as the reference's builder allows), spheres and
triangles, and the tri-BVH the builder attaches to large meshes.

``scene_from_jax`` turns a ``bre_tpu`` Scene into this one, so tests can feed
both packages identical inputs; ``check_slice`` raises ``NotImplementedError``
for scenes outside the slice instead of rendering them wrongly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..accel.lbvh import LBVH
from ..bssrdf import BSSRDFTables
from ..fourier import FourierTables
from ..textures import Textures, textures_from_jax

# Material type tags (bre_tpu/scene/scene.py:26-39)
MAT_NONE = -1  # boundary-only surface (medium interface)
MAT_MATTE = 0  # matte.cpp (Lambertian)
MAT_MIRROR = 1  # mirror.cpp (perfect specular reflection)
MAT_GLASS = 2  # glass.cpp (FresnelSpecular reflection + transmission)
MAT_METAL = 3  # metal.cpp (GGX + conductor Fresnel)
MAT_PLASTIC = 4  # plastic.cpp (Lambert + GGX dielectric coat)
MAT_UBER = 5  # uber.cpp (as plastic)
MAT_SUBSTRATE = 6  # substrate.cpp (FresnelBlend)
MAT_TRANSLUCENT = 7  # translucent.cpp (two-sided Lambert)
MAT_MIX = 8  # mixmat.cpp (blend of two sub-materials)
MAT_HAIR = 9  # hair.cpp (Marschner / Chiang fiber BSDF)
MAT_SUBSURFACE = 10  # subsurface.cpp (dielectric + TabulatedBSSRDF)
MAT_KDSUBSURFACE = 11  # kdsubsurface.cpp (sigmas from a diffuse color)
MAT_FOURIER = 12  # fourier.cpp (measured FourierBSDF table)
N_MAT_TAGS = 13

# Light type tags (bre_tpu/scene/scene.py:42-48)
LIGHT_POINT = 0  # point.cpp
LIGHT_DIFFUSE_AREA = 1  # diffuse.cpp (over a triangle or a sphere)
LIGHT_DISTANT = 2  # distant.cpp
LIGHT_INFINITE = 3  # infinite.cpp (constant L or an equirectangular map)
LIGHT_SPOT = 4  # spot.cpp
LIGHT_GONIOMETRIC = 5  # goniometric.cpp (point light x angular map)
LIGHT_PROJECTION = 6  # projection.cpp (point light x projected slide)
N_LIGHT_TAGS = 7

# Medium type tags
MEDIUM_HOMOGENEOUS = 0
MEDIUM_GRID = 1

# Shape kind tags
SHAPE_SPHERE = 0
SHAPE_TRIANGLE = 1


class Spheres(NamedTuple):
    center: torch.Tensor  # (Ns, 3)
    radius: torch.Tensor  # (Ns,)
    material: torch.Tensor  # (Ns,) int64 material id or -1
    medium_inside: torch.Tensor  # (Ns,) int64 medium id or -1
    medium_outside: torch.Tensor  # (Ns,) int64
    area_light: torch.Tensor  # (Ns,) int64 light id or -1


class Triangles(NamedTuple):
    p0: torch.Tensor  # (Nt, 3)
    p1: torch.Tensor
    p2: torch.Tensor
    material: torch.Tensor  # (Nt,) int64
    medium_inside: torch.Tensor
    medium_outside: torch.Tensor
    area_light: torch.Tensor
    tangent: torch.Tensor  # (Nt, 3) pbrt dpdu: the BSDF frame's ss axis
    n0: torch.Tensor  # (Nt, 3) per-vertex shading normals (zeros = faceted)
    n1: torch.Tensor
    n2: torch.Tensor
    # per-vertex texture coordinates (pbrt's (0,0)/(1,0)/(1,1) where the
    # mesh has none), so a hit's uv is b0 uv0 + b1 uv1 + b2 uv2
    uv0: torch.Tensor  # (Nt, 2)
    uv1: torch.Tensor
    uv2: torch.Tensor


class Materials(NamedTuple):
    """Tagged material table (bre_tpu/scene/scene.py:97-120).  kd is matte
    kd / mirror kr / glass kr; ks is glass kt / plastic ks / metal tint."""

    mtype: torch.Tensor  # (Nm,) int64 tag
    kd: torch.Tensor  # (Nm, 3)
    ks: torch.Tensor  # (Nm, 3)
    eta: torch.Tensor  # (Nm,) index of refraction (glass, plastic coat)
    roughness: torch.Tensor  # (Nm,) GGX roughness; matte sigma
    metal_eta: torch.Tensor  # (Nm, 3) conductor eta
    metal_k: torch.Tensor  # (Nm, 3) conductor absorption
    kd_tex: torch.Tensor  # (Nm,) int64 texture index or -1
    mix_m1: torch.Tensor  # (Nm,) int64 first sub-material of a mix or -1
    mix_m2: torch.Tensor  # (Nm,) int64 second sub-material or -1
    mix_amount: torch.Tensor  # (Nm, 3) weight of m1
    beta_n: torch.Tensor  # (Nm,) hair azimuthal roughness (beta_m is in
    # roughness, sigma_a in kd)
    hair_alpha: torch.Tensor  # (Nm,) hair scale tilt, degrees
    # subsurface: world-space sigmas (after "scale", or inverted from Kd
    # and mfp for kdsubsurface) and the row of the profile table
    bss_sigma_a: torch.Tensor  # (Nm, 3)
    bss_sigma_s: torch.Tensor  # (Nm, 3)
    bss_table: torch.Tensor  # (Nm,) int64 row of bss_tables or -1
    bss_tables: "object"  # bssrdf.BSSRDFTables
    fourier: torch.Tensor  # (Nm,) int64 row of fourier_tables or -1
    fourier_tables: "object"  # fourier.FourierTables
    # (N_MAT_TAGS,) bool, on the host whatever the device: which tags the
    # table holds, decided when it is built (the reference reads mtype
    # with numpy on each call); the BSDFs skip the lobes of absent tags
    kinds: torch.Tensor


class Lights(NamedTuple):
    """Tagged light table (bre_tpu/scene/scene.py:129-160)."""

    ltype: torch.Tensor  # (Nl,) int64 tag
    position: torch.Tensor  # (Nl, 3) point/spot/goniometric/projection
    direction: torch.Tensor  # (Nl, 3) distant/spot/projection axis (travel)
    emit: torch.Tensor  # (Nl, 3) I of the point-like lights, else L
    shape_kind: torch.Tensor  # (Nl,) int64 SHAPE_* or -1
    shape_index: torch.Tensor  # (Nl,) int64
    two_sided: torch.Tensor  # (Nl,) int64 0/1
    medium: torch.Tensor  # (Nl,) int64 medium the light sits in
    cos_falloff_start: torch.Tensor  # (Nl,) spot inner cone; projection
    # cos(fov/2)
    cos_total_width: torch.Tensor  # (Nl,) spot outer cone; projection
    # frustum corner cone
    # the light images (infinite env maps, goniometric maps, projection
    # slides): MIPMap pyramids packed in one atlas, as the textures are
    img_off: torch.Tensor  # (Nl,) int64 level-0 row offset, -1 = no image
    img_w: torch.Tensor  # (Nl,) int64
    img_h: torch.Tensor  # (Nl,) int64
    img_mean: torch.Tensor  # (Nl, 3) the image's mean (1 without one)
    world_to_light: torch.Tensor  # (Nl, 4, 4) orientation of the map lookup
    atlas: torch.Tensor  # (Ha, Wa, 3) light-image atlas, (1, 1, 3) if unused
    # the env map's Distribution2D (infinite.cpp): one image-mapped
    # infinite light per scene, the last one built; (1, 1) func when none
    env_light: torch.Tensor  # () int64 light index or -1
    env_func: torch.Tensor  # (He, We) luminance * sin(theta)
    env_marg_cdf: torch.Tensor  # (He + 1,)
    env_cond_cdf: torch.Tensor  # (He, We + 1)
    # (N_LIGHT_TAGS,) bool, on the host whatever the device: which tags the
    # table holds, decided when it is built; the light queries skip the
    # branches of absent tags
    kinds: torch.Tensor


class Media(NamedTuple):
    """Tagged medium table; grid media scale their constant sigma_t by the
    shared ``density`` brick, reached through ``world_to_medium``
    (media/grid.cpp:46-120)."""

    mtype: torch.Tensor  # (M,) int64 MEDIUM_HOMOGENEOUS / MEDIUM_GRID
    sigma_a: torch.Tensor  # (M, 3)
    sigma_s: torch.Tensor  # (M, 3)
    g: torch.Tensor  # (M,)
    density: torch.Tensor  # (nz, ny, nx) grid density, (1,1,1) zeros if none
    world_to_medium: torch.Tensor  # (4, 4) world -> [0,1]^3 of the grid
    grid_medium: torch.Tensor  # () int64 index of the grid medium or -1


class Scene(NamedTuple):
    spheres: Spheres
    triangles: Triangles
    materials: Materials
    lights: Lights
    media: Media
    textures: Textures
    camera_medium: torch.Tensor  # () int64
    world_min: torch.Tensor  # (3,)
    world_max: torch.Tensor  # (3,)
    # accel.lbvh.LBVH over the triangles' boxes when the builder holds
    # builder.BVH_MIN_TRIANGLES or more, else None
    tri_bvh: "object" = None

    @property
    def device(self) -> torch.device:
        return self.world_min.device

    @property
    def n_spheres(self) -> int:
        return self.spheres.radius.shape[0]

    @property
    def n_triangles(self) -> int:
        return self.triangles.p0.shape[0]

    @property
    def n_lights(self) -> int:
        return self.lights.ltype.shape[0]

    @property
    def n_media(self) -> int:
        return self.media.mtype.shape[0]


def world_radius(scene: Scene) -> torch.Tensor:
    diag = scene.world_max - scene.world_min
    return 0.5 * torch.sqrt((diag * diag).sum())


def world_center(scene: Scene) -> torch.Tensor:
    return 0.5 * (scene.world_min + scene.world_max)


def world_span(scene: Scene) -> torch.Tensor:
    """2 * world diameter + 1: the finite stand-in for the 1e30 miss
    sentinel (photonbeam.py:241-242, photon_trace.py:191-192)."""
    diag = scene.world_max - scene.world_min
    return 2.0 * torch.sqrt((diag * diag).sum()) + 1.0


def check_slice(scene: Scene) -> None:
    """Raise NotImplementedError for scene content outside the ported slice;
    ValueError where a table's host-side ``kinds`` lacks a tag it holds."""
    m, L, mt = scene.materials, scene.lights, scene.media.mtype
    # one host read for the presence of every material and light tag and
    # for the refusals below
    flags = ([(m.mtype == tag).any() for tag in range(N_MAT_TAGS)]
             + [((m.mtype < MAT_MATTE) | (m.mtype >= N_MAT_TAGS)).any()]
             + [(L.ltype == tag).any() for tag in range(N_LIGHT_TAGS)]
             + [((L.ltype < 0) | (L.ltype >= N_LIGHT_TAGS)).any(),
                ((L.ltype == LIGHT_DIFFUSE_AREA)
                 & (L.shape_kind != SHAPE_TRIANGLE)
                 & (L.shape_kind != SHAPE_SPHERE)).any(),
                ((mt != MEDIUM_HOMOGENEOUS) & (mt != MEDIUM_GRID)).any(),
                (mt == MEDIUM_GRID).sum() > 1])
    held = torch.stack(flags).tolist()
    mat_held, held = held[:N_MAT_TAGS + 1], held[N_MAT_TAGS + 1:]
    light_held, held = held[:N_LIGHT_TAGS], held[N_LIGHT_TAGS:]
    bad_light, bad_area, bad_medium, two_grids = held
    if mat_held[-1]:
        raise NotImplementedError("unknown material type tag")
    for what, kinds, held_tags, remedy in (
            ("Materials", m.kinds, mat_held, "material_kinds(mtype)"),
            ("Lights", L.kinds, light_held, "light_kinds(ltype)")):
        missing = [t for t, h in enumerate(held_tags[:kinds.shape[0]])
                   if h and not bool(kinds[t])]
        if missing:
            raise ValueError(f"{what}.kinds lacks the tags {missing} that the "
                             f"table holds: rebuild it with {remedy}")
    if bad_light:
        raise NotImplementedError("unknown light type tag")
    if bad_area:
        raise NotImplementedError(
            "a diffuse area light on a shape other than a triangle or a "
            "sphere is not ported (ROADMAP Queue 1 item 5: breadth, shapes)")
    if bad_medium:
        raise NotImplementedError("unknown medium type tag")
    if two_grids:
        raise NotImplementedError(
            "more than one grid-density medium: the scene stores one density "
            "brick, as the reference's builder does")


def material_kinds(mtype) -> torch.Tensor:
    """``Materials.kinds`` of a table's tags (any int sequence or array)."""
    kinds = torch.zeros(N_MAT_TAGS, dtype=torch.bool)
    tags = np.asarray(mtype, np.int64).reshape(-1)
    kinds[tags[(tags >= 0) & (tags < N_MAT_TAGS)]] = True
    return kinds


def light_kinds(ltype) -> torch.Tensor:
    """``Lights.kinds`` of a table's tags (any int sequence or array)."""
    kinds = torch.zeros(N_LIGHT_TAGS, dtype=torch.bool)
    tags = np.asarray(ltype, np.int64).reshape(-1)
    kinds[tags[(tags >= 0) & (tags < N_LIGHT_TAGS)]] = True
    return kinds


def resolve_device(device) -> torch.device:
    """The device an entry point builds on.  Entry points default to
    "cuda"; asking for CUDA without a card raises instead of carrying on
    on the CPU, which runs only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} needs a CUDA card, and "
            "torch.cuda.is_available() is False; pass device=\"cpu\" to run "
            "on the CPU")
    return dev


def _t(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def scene_from_jax(scene_jax, device="cuda") -> Scene:
    """A ``bre_tpu`` Scene (its leaves read with ``np.asarray``) -> this
    package's Scene on ``device``, the grid medium's density brick (the
    parameter inverse rendering fits) and the tri-BVH included."""
    device = resolve_device(device)
    f = lambda x: _t(x, torch.float32, device)  # noqa: E731
    i = lambda x: _t(x, torch.int64, device)  # noqa: E731
    s, t = scene_jax.spheres, scene_jax.triangles
    m, L, md = scene_jax.materials, scene_jax.lights, scene_jax.media
    nt = np.asarray(t.p0).shape[0]
    bt, ft = m.bss_tables, m.fourier_tables

    def vn(x):  # per-vertex normals: (0,3) in scenes built without them
        a = np.asarray(x)
        return f(a if a.shape[0] == nt else np.zeros((nt, 3), np.float32))

    return Scene(
        spheres=Spheres(f(s.center), f(s.radius), i(s.material),
                        i(s.medium_inside), i(s.medium_outside),
                        i(s.area_light)),
        triangles=Triangles(f(t.p0), f(t.p1), f(t.p2), i(t.material),
                            i(t.medium_inside), i(t.medium_outside),
                            i(t.area_light), f(t.tangent), vn(t.n0), vn(t.n1),
                            vn(t.n2), f(t.uv0), f(t.uv1), f(t.uv2)),
        materials=Materials(
            i(m.mtype), f(m.kd), f(m.ks), f(m.eta), f(m.roughness),
            f(m.metal_eta), f(m.metal_k), i(m.kd_tex), i(m.mix_m1),
            i(m.mix_m2), f(m.mix_amount), f(m.beta_n), f(m.hair_alpha),
            f(m.bss_sigma_a), f(m.bss_sigma_s), i(m.bss_table),
            BSSRDFTables(f(bt.rho), f(bt.radius), f(bt.profile),
                         f(bt.rho_eff), f(bt.cdf)),
            i(m.fourier),
            FourierTables(f(ft.eta), f(ft.mu), f(ft.cdf), f(ft.a0),
                          i(ft.a_offset), i(ft.m), f(ft.a),
                          i(ft.n_channels), int(ft.m_max)),
            material_kinds(m.mtype)),
        lights=Lights(
            i(L.ltype), f(L.position), f(L.direction), f(L.emit),
            i(L.shape_kind), i(L.shape_index), i(L.two_sided), i(L.medium),
            f(L.cos_falloff_start), f(L.cos_total_width), i(L.img_off),
            i(L.img_w), i(L.img_h), f(L.img_mean),
            _t(np.asarray(L.world_to_light).reshape(-1, 4, 4), torch.float32,
               device), f(L.atlas), i(L.env_light), f(L.env_func),
            f(L.env_marg_cdf), f(L.env_cond_cdf), light_kinds(L.ltype)),
        media=Media(i(md.mtype), f(md.sigma_a), f(md.sigma_s), f(md.g),
                    f(md.density), f(md.world_to_medium), i(md.grid_medium)),
        textures=textures_from_jax(scene_jax.textures, device),
        camera_medium=i(scene_jax.camera_medium),
        world_min=f(scene_jax.world_min),
        world_max=f(scene_jax.world_max),
        tri_bvh=(None if scene_jax.tri_bvh is None else LBVH(
            *(_t(x, torch.int64 if i < 3 else torch.float32, device)
              for i, x in enumerate(scene_jax.tri_bvh)))),
    )
