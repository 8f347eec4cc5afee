"""bre_tpu_torch.render_photonbeam against bre_tpu's through an
orthographic camera on cornell_fog.pbrt's box and fog with a hair curve in
it (torch_parity.HAIR_WORLD), parsed by each package at 16x16, 1
iteration of 500 photons.  In its own file because of the reference's
compile (about 60 s cold on one core, the hair lobe in both the photon
walk and the camera pass).

Tolerances (tests/test_torch_render.py's, for the same reason: identical
PCG32 streams, so the two differ only where an ulp flips a photon or
camera decision): the image mean within 0.5%, 99% of the pixels within
rtol 1e-3 / atol 1e-6."""

import numpy as np

from bre_tpu.integrators import photonbeam as jpb
from bre_tpu.scene import parser as jparser
from bre_tpu_torch.integrators import photonbeam as tpb
from bre_tpu_torch.scene import parser as tparser
from torch_parity import HAIR_WORLD, cornell_fog_text, to_np

W = 16


def test_orthographic_camera_and_hair_curve_render_as_reference():
    text = cornell_fog_text("orthographic", W, 1, 500, HAIR_WORLD)
    ps_t = tparser.parse_string(text, device="cpu")
    ps_j = jparser.parse_string(text)
    assert ps_t.camera.ctype == 1
    ts, js = ps_t.build(device="cpu"), ps_j.build()
    assert bool(ts.materials.kinds[9])  # the hair
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
