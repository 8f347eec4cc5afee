"""The builder's tessellated shapes against bre_tpu's on the CPU.

Each shape method of ``SceneBuilder`` (disk and annulus, cylinder, cone,
paraboloid, hyperboloid, heightfield, the three curve types, Loop
subdivision, NURBS) with its parameters and frame varied builds the same
triangles as the reference's builder: ``np.array_equal`` on every triangle
field (vertices, ids, tangents, shading normals, uvs), since both run the
same numpy float32 expressions in the same order.  The tri-BVH is attached
at ``BVH_MIN_TRIANGLES`` and carried by ``scene_from_jax``; the shapes fog
box of ``chip_smoke.py`` phase 36 parses as the reference's scene."""

import numpy as np
import pytest
import torch

from bre_tpu.scene import builder as jbuilder
from bre_tpu.scene import parser as jparser
from bre_tpu_torch.scene import builder as tbuilder
from bre_tpu_torch.scene import parser as tparser
from bre_tpu_torch.scene.scene import scene_from_jax
from torch_parity import ICOSAHEDRON_F, ICOSAHEDRON_P, shapes_fog_pbrt, to_np

_RS = np.random.RandomState(15)
_CP = _RS.uniform(-1, 1, (4, 3)).astype(np.float32)

# (method, args, kwargs): two frames or parameter sets per shape
SHAPES = {
    "disk": ("disk", ((0.1, 0.2, 0.3), (0.2, 0.3, 1.0), 0.7), dict(n_u=20)),
    "disk x axis": ("disk", ((0, 0, 0), (1, 0, 0), 1.3), {}),
    "annulus": ("disk", ((0.1, -0.2, 0.3), (1, 1, 0), 0.7),
                dict(inner_radius=0.3)),
    "cylinder": ("cylinder", ((0, 0, 0), (0, 1, 0.2), 0.4, -0.3, 0.5), {}),
    "cylinder fine": ("cylinder", ((1, 2, 3), (0.3, -0.2, 1.0), 0.1, 0.0,
                                   2.0), dict(n_u=48)),
    "cone": ("cone", ((0.3, 0, 0), (0, 0, 1), 0.5, 1.2), {}),
    "cone tilted": ("cone", ((-1, 0.5, 2), (1, 0.95, 0.1), 0.25, 0.6),
                    dict(n_u=16)),
    "paraboloid": ("paraboloid", ((0, 0.3, 0), (1, 1, 0), 0.5, 0.8), {}),
    "paraboloid fine": ("paraboloid", ((0, 0, 0), (0, 0, -1), 1.5, 0.3),
                        dict(n_v=12, n_u=24)),
    "hyperboloid": ("hyperboloid", ((0, 0, 0.5), (0, 0, 1), 0.2, 0.6, -0.2,
                                    0.4), {}),
    "hyperboloid default": ("hyperboloid", (), {}),
    "heightfield": ("heightfield", (_RS.rand(9, 7).astype(np.float32) * 0.3,
                                    (-1, -1, 0), (2, 1.5)), {}),
    "heightfield 64": ("heightfield", (_RS.rand(64, 64).astype(np.float32),
                                       (0.5, 0, -2), (1.0, 3.0)), {}),
    "curve cylinder": ("curve", (_CP, 0.05, 0.02), {}),
    "curve cylinder sides": ("curve", (_CP * 3, 0.1, 0.1),
                             dict(n_segments=7, n_sides=6)),
    "curve flat": ("curve", (_CP, 0.05, 0.02),
                   dict(ctype="flat", facing=(0, 0, -5))),
    "curve flat no eye": ("curve", (_CP, 0.03, 0.08), dict(ctype="flat")),
    "curve ribbon": ("curve", (_CP, 0.05, 0.02),
                     dict(ctype="ribbon", n0=(0, 0, 1), n1=(0, 1, 1))),
    "curve ribbon parallel": ("curve", (_CP, 0.04, 0.04),
                              dict(ctype="ribbon", n0=(0, 0, 2),
                                   n1=(0, 0, 1))),
    "loopsubdiv closed": ("loopsubdiv", (
        [0, 1, 2, 0, 2, 3, 0, 3, 1, 1, 3, 2],
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]]), dict(nlevels=2)),
    "loopsubdiv boundary": ("loopsubdiv", (
        [0, 1, 2, 0, 2, 3, 2, 4, 3],
        [[0, 0, 0], [1, 0, 0], [1, 1, 0.1], [0, 1, 0.3], [0.5, 1.8, 0.4]]),
        dict(nlevels=3)),
    "loopsubdiv icosahedron": ("loopsubdiv", (ICOSAHEDRON_F, ICOSAHEDRON_P),
                               dict(nlevels=2)),
    "nurbs": ("nurbs", (3, 3, 3, 3, [0, 0, 0, 1, 1, 1], [0, 0, 0, 1, 1, 1],
                        _RS.rand(9, 3)), dict(n_eval=8)),
    "nurbs rational": ("nurbs", (4, 3, 3, 2, [0, 0, 0, 0.5, 1, 1, 1],
                                 [0, 0, 0.5, 1, 1], _RS.rand(12, 3)),
                       dict(w=_RS.rand(12) + 0.5)),
}


def _scene(mod, method, args, kw, **build):
    b = mod.SceneBuilder()
    m = b.matte((0.5, 0.4, 0.3))
    getattr(b, method)(*args, material=m, medium_inside=-1,
                       medium_outside=-1, **kw)
    return b.build(**build)


def _assert_triangles_equal(mine, ref):
    for name in mine.triangles._fields:
        a, b = getattr(mine.triangles, name), getattr(ref.triangles, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(to_np(a), to_np(b)), name


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_shape_builds_as_reference(case):
    method, args, kw = SHAPES[case]
    mine = _scene(tbuilder, method, args, kw, device="cpu")
    ref = scene_from_jax(_scene(jbuilder, method, args, kw), device="cpu")
    assert mine.n_triangles > 0
    _assert_triangles_equal(mine, ref)
    assert torch.equal(mine.world_min, ref.world_min)
    assert torch.equal(mine.world_max, ref.world_max)


def test_ribbon_without_normals_raises():
    for mod in (tbuilder, jbuilder):
        with pytest.raises(ValueError, match="two normals"):
            mod.SceneBuilder().curve(_CP, ctype="ribbon", n0=(0, 0, 1))


@pytest.mark.parametrize("center,n", [((0, 0, 0), 64), ((3, 3, 0), 32)])
def test_cone_apex_faces_dropped_as_reference(center, n):
    """The apex ring (r = 1e-5) drops its faces where ``np.allclose`` calls
    its points equal: relative to their coordinates, so off the origin's
    axis (32 triangles) and not on it (64), as in the reference."""
    args = (center, (0, 0, 1), 0.5, 1.0)
    mine = _scene(tbuilder, "cone", args, {}, device="cpu")
    ref = scene_from_jax(_scene(jbuilder, "cone", args, {}), device="cpu")
    assert mine.n_triangles == n
    _assert_triangles_equal(mine, ref)


@pytest.mark.parametrize("at", [-1, 0])
def test_tri_bvh_attached_at_threshold(at, monkeypatch):
    """A scene of BVH_MIN_TRIANGLES triangles carries the tri-BVH, one
    fewer does not, in both packages; scene_from_jax carries it bit for
    bit."""
    method, args, kw = SHAPES["heightfield"]  # 96 triangles
    for mod in (tbuilder, jbuilder):
        monkeypatch.setattr(mod, "BVH_MIN_TRIANGLES", 96 - at)
    mine = _scene(tbuilder, method, args, kw, device="cpu")
    ref_j = _scene(jbuilder, method, args, kw)
    ref = scene_from_jax(ref_j, device="cpu")
    assert (mine.tri_bvh is None) == (ref_j.tri_bvh is None) == (at == -1)
    if mine.tri_bvh is not None:
        for name in mine.tri_bvh._fields:
            a, b = getattr(mine.tri_bvh, name), getattr(ref.tri_bvh, name)
            assert a.dtype == b.dtype and torch.equal(a, b), name
        assert mine.tri_bvh.n_leaves == mine.n_triangles


@pytest.mark.parametrize("loop", [None, 2])
def test_shapes_fog_box_parses_as_reference(loop, monkeypatch):
    """chip_smoke.py phase 36's scenes, cut to a 16x16 heightfield (and the
    Loop icosahedron at level 2, with the tri-BVH forced on in both
    packages), parse into the same scene."""
    if loop is not None:
        for mod in (tbuilder, jbuilder):
            monkeypatch.setattr(mod, "BVH_MIN_TRIANGLES", 512)
    text = shapes_fog_pbrt(16, 1, 1000, loop_levels=loop, hf=16)
    mine = tparser.parse_string(text, device="cpu").build(device="cpu")
    ref = scene_from_jax(jparser.parse_string(text).build(), device="cpu")
    _assert_triangles_equal(mine, ref)
    assert (mine.tri_bvh is None) == (loop is None)
    if loop is not None:
        for name in mine.tri_bvh._fields:
            assert torch.equal(getattr(mine.tri_bvh, name),
                               getattr(ref.tri_bvh, name)), name
