"""bre_tpu_torch.render_photonbeam against bre_tpu's on a scene holding
every shape (tests/torch_parity.shapes_fog_pbrt: cornell_fog.pbrt's box and
fog with a disk, an annulus, a cylinder, a cone, a paraboloid, a
hyperboloid, a curve of each type, a rational NURBS patch, an 8 x 8
heightfield and a Loop icosahedron at level 1), parsed by each package,
with the tri-BVH forced on in both, at 16x16, 500 photons, 1
iteration.

Tolerances (tests/test_torch_render.py's, for the same reason: identical
PCG32 streams, so the two differ only where an ulp flips a photon or
camera decision): the image mean within 0.5%, 99% of the pixels within
rtol 1e-3 / atol 1e-6."""

import numpy as np
import pytest

from bre_tpu.integrators import photonbeam as jpb
from bre_tpu.scene import builder as jbuilder
from bre_tpu.scene import parser as jparser
from bre_tpu_torch.integrators import photonbeam as tpb
from bre_tpu_torch.scene import builder as tbuilder
from bre_tpu_torch.scene import parser as tparser
from torch_parity import shapes_fog_pbrt, to_np

W = 16


def test_every_shape_renders_as_reference(monkeypatch):
    for mod in (tbuilder, jbuilder):
        monkeypatch.setattr(mod, "BVH_MIN_TRIANGLES", 256)
    text = shapes_fog_pbrt(W, 1, 500, loop_levels=1, hf=8)
    ps_t = tparser.parse_string(text, device="cpu")
    ps_j = jparser.parse_string(text)
    ts, js = ps_t.build(device="cpu"), ps_j.build()
    assert ts.tri_bvh is not None and js.tri_bvh is not None
    assert ts.n_triangles > 2000
    over = dict(iterations=1, photonsperiteration=500, maxdepth=5,
                initialbeamradius=0.15)
    it, st = tpb.render_photonbeam(ts, ps_t.camera, W, W,
                                   tpb.PhotonBeamConfig(**over))
    ij, sj = jpb.render_photonbeam(js, ps_j.camera, W, W,
                                   jpb.PhotonBeamConfig(**over))
    it, ij = to_np(it), np.asarray(ij)
    assert np.isfinite(it).all() and ij.mean() > 0
    assert abs(it.mean() / ij.mean() - 1.0) < 5e-3
    close = np.isclose(it, ij, rtol=1e-3, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert st["final_radius"] == pytest.approx(sj["final_radius"])
