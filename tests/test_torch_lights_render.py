"""Whole renders of bre_tpu_torch against bre_tpu, on the CPU, with the
other lights: cornell_fog's box and fog lit by a spot light, a distant
light through the open front and an image-mapped infinite light
(``torch_parity.lit_fog_box``) at 16x16: ``render_photonbeam`` on the
default (non-packed) route and on the packed route (3,000 photons x 2
iterations, maxdepth 5, radius 0.15).  ``render_volpath`` on the same
scene is tests/test_torch_lights_volpath.py (each of bre_tpu's renders
here is one XLA compile, about 35 s on one core).

Tolerances (tests/test_torch_surface_render.py's pixel bound with the
tighter means of tests/test_torch_volpath.py): both packages run the same
PCG32 streams and the lights' queries agree to 1e-5
(tests/test_torch_lights.py); image means within rtol 1e-4, the 4x4
region means within rtol 1e-4, and 99% of the pixels within rtol 1e-3
(atol 1e-6).
"""

import numpy as np
import pytest

from bre_tpu.core import transform as jtfm
from bre_tpu.integrators import photonbeam as jpb
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu.scene.camera import make_perspective_camera as jcam
from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.integrators import photonbeam as tpb
from bre_tpu_torch.scene.builder import SceneBuilder as TBuilder
from bre_tpu_torch.scene.camera import make_perspective_camera as tcam
from torch_parity import lit_fog_box, pixels_close, region_means, to_np

W = 16
LOOK = ((0, 0, -2.2), (0, 0, 1), (0, 1, 0))
FOV = 50.0
PB = dict(iterations=2, maxdepth=5, photonsperiteration=3000,
          initialbeamradius=0.15, alpha=0.7)


def images_close(it, ij):
    it, ij = to_np(it), np.asarray(ij)
    assert it.shape == ij.shape == (W, W, 3)
    assert np.isfinite(it).all() and ij.mean() > 0
    np.testing.assert_allclose(it.mean(), ij.mean(), rtol=1e-4)
    np.testing.assert_allclose(region_means(it), region_means(ij), rtol=1e-4,
                               atol=1e-7)
    pixels_close(it, ij)


def cameras():
    return (tcam(ttfm.look_at(*LOOK), FOV, W, W, device="cpu"),
            jcam(jtfm.look_at(*LOOK), FOV, W, W))


@pytest.mark.parametrize("grad_geometry", [True, False],
                         ids=["default", "packed"])
def test_render_photonbeam_other_lights_match_jax(grad_geometry):
    cam_t, cam_j = cameras()
    ij, sj = jpb.render_photonbeam(
        lit_fog_box(JBuilder()), cam_j, W, W,
        jpb.PhotonBeamConfig(grad_geometry=grad_geometry, **PB))
    it, st = tpb.render_photonbeam(
        lit_fog_box(TBuilder(), device="cpu"), cam_t, W, W,
        tpb.PhotonBeamConfig(grad_geometry=grad_geometry, **PB))
    images_close(it, ij)
    assert int(st["n_beams"]) == int(sj["n_beams"])
