"""The Scene: structure-of-arrays world description (counterpart of
``bre_tpu/scene/scene.py``).

NamedTuples of tensors with integer tags; -1 means "none" (no material,
vacuum, no area light).  Ids are int64 so they index directly; positions,
colors and parameters are float32.  Only the fields the ported slice reads
are carried: matte materials, point lights and triangle and sphere area
lights, homogeneous and grid-density media (at most one grid, as the
reference's builder allows), spheres and triangles swept densely.

``scene_from_jax`` turns a ``bre_tpu`` Scene into this one, so tests can feed
both packages identical inputs; ``check_slice`` raises ``NotImplementedError``
for scenes outside the slice instead of rendering them wrongly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Material type tags (bre_tpu/scene/scene.py)
MAT_MATTE = 0

# Light type tags
LIGHT_POINT = 0
LIGHT_DIFFUSE_AREA = 1

# Medium type tags
MEDIUM_HOMOGENEOUS = 0
MEDIUM_GRID = 1

# Shape kind tags
SHAPE_SPHERE = 0
SHAPE_TRIANGLE = 1

# Dense primitive sweep limit of the reference's single-chunk path
# (intersect._PRIM_CHUNK); the chunked sweep and the tri-BVH are not ported.
MAX_DENSE_PRIMS = 8192


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


class Materials(NamedTuple):
    mtype: torch.Tensor  # (Nm,) int64 tag
    kd: torch.Tensor  # (Nm, 3)
    kd_tex: torch.Tensor  # (Nm,) int64 texture index or -1


class Lights(NamedTuple):
    ltype: torch.Tensor  # (Nl,) int64 tag
    position: torch.Tensor  # (Nl, 3)
    emit: torch.Tensor  # (Nl, 3) point I / area L
    shape_kind: torch.Tensor  # (Nl,) int64 SHAPE_* or -1
    shape_index: torch.Tensor  # (Nl,) int64
    two_sided: torch.Tensor  # (Nl,) int64 0/1
    medium: torch.Tensor  # (Nl,) int64 medium the light sits in


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
    camera_medium: torch.Tensor  # () int64
    world_min: torch.Tensor  # (3,)
    world_max: torch.Tensor  # (3,)

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
    """Raise NotImplementedError for scene content outside the ported slice."""
    if scene.n_spheres + scene.n_triangles > MAX_DENSE_PRIMS:
        raise NotImplementedError(
            f"more than {MAX_DENSE_PRIMS} primitives needs the chunked sweep "
            "or the tri-BVH (ROADMAP Queue 1: breadth, accel/lbvh)")
    m = scene.materials
    if bool(((m.mtype != MAT_MATTE) | (m.kd_tex >= 0)).any()):
        raise NotImplementedError(
            "only untextured matte materials are ported (ROADMAP Queue 1: "
            "breadth, materials and textures)")
    L = scene.lights
    point = L.ltype == LIGHT_POINT
    area = (L.ltype == LIGHT_DIFFUSE_AREA) & (
        (L.shape_kind == SHAPE_TRIANGLE) | (L.shape_kind == SHAPE_SPHERE))
    if bool((~(point | area)).any()):
        raise NotImplementedError(
            "only point lights and triangle and sphere area lights are ported "
            "(ROADMAP Queue 1: breadth, lights)")
    mt = scene.media.mtype
    if bool(((mt != MEDIUM_HOMOGENEOUS) & (mt != MEDIUM_GRID)).any()):
        raise NotImplementedError("unknown medium type tag")
    if int((mt == MEDIUM_GRID).sum()) > 1:
        raise NotImplementedError(
            "more than one grid-density medium: the scene stores one density "
            "brick, as the reference's builder does")


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
    parameter inverse rendering fits) included.  The tri-BVH cannot be
    carried and raises NotImplementedError."""
    device = resolve_device(device)
    if scene_jax.tri_bvh is not None:
        raise NotImplementedError(
            "tri-BVH scenes are not ported (ROADMAP Queue 1: breadth, "
            "accel/lbvh)")
    f = lambda x: _t(x, torch.float32, device)  # noqa: E731
    i = lambda x: _t(x, torch.int64, device)  # noqa: E731
    s, t = scene_jax.spheres, scene_jax.triangles
    m, L, md = scene_jax.materials, scene_jax.lights, scene_jax.media
    nt = np.asarray(t.p0).shape[0]

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
                            vn(t.n2)),
        materials=Materials(i(m.mtype), f(m.kd), i(m.kd_tex)),
        lights=Lights(i(L.ltype), f(L.position), f(L.emit), i(L.shape_kind),
                      i(L.shape_index), i(L.two_sided), i(L.medium)),
        media=Media(i(md.mtype), f(md.sigma_a), f(md.sigma_s), f(md.g),
                    f(md.density), f(md.world_to_medium), i(md.grid_medium)),
        camera_medium=i(scene_jax.camera_medium),
        world_min=f(scene_jax.world_min),
        world_max=f(scene_jax.world_max),
    )
