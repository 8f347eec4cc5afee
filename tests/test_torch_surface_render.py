"""render_photonbeam of bre_tpu_torch against bre_tpu on a surface scene:
the glass sphere in fog of tests/test_photonbeam_vs_volpath.py:316
(BASELINE config 4's shape) with a mirror floor, a metal and a plastic
sphere and a textured back wall (``torch_parity.surface_scene``), at 16x16
and 3,000 photons x 2 iterations, on both gather routes: the packed kernels'
route (grad_geometry=False) and the default one (grad_geometry=True).  The
camera pass's NEE reads the wall's kd texture at uv = p.xy, as the
reference's does; the walks scatter with the constant kd.

Tolerances (tests/test_torch_render.py's): the renders share bit-identical
PCG32 streams and differ only where a float-ulp difference flips a photon
or camera-path decision: image means within 0.5%, 99% of pixels within
rtol 1e-3 (atol 1e-6).
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
from torch_parity import SURFACE_FOV, SURFACE_LOOK, surface_scene

W = 16
CFG = dict(iterations=2, maxdepth=6, photonsperiteration=3000,
           initialbeamradius=0.12, alpha=0.7, gather="auto")


def images_close(it, ij):
    assert it.shape == ij.shape and np.isfinite(it).all() and ij.mean() > 0
    assert abs(it.mean() / ij.mean() - 1.0) < 5e-3
    close = np.isclose(it, ij, rtol=1e-3, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, close.mean()


@pytest.mark.parametrize("grad_geometry", [False, True],
                         ids=["packed", "default"])
def test_render_photonbeam_surfaces_match_jax(grad_geometry):
    ij, sj = jpb.render_photonbeam(
        surface_scene(JBuilder()), jcam(jtfm.look_at(*SURFACE_LOOK),
                                        SURFACE_FOV, W, W), W, W,
        jpb.PhotonBeamConfig(grad_geometry=grad_geometry, **CFG))
    it, st = tpb.render_photonbeam(
        surface_scene(TBuilder(), device="cpu"),
        tcam(ttfm.look_at(*SURFACE_LOOK), SURFACE_FOV, W, W, device="cpu"),
        W, W, tpb.PhotonBeamConfig(grad_geometry=grad_geometry, **CFG))
    images_close(it.numpy(), np.asarray(ij))
    assert abs(int(st["n_beams"]) - int(sj["n_beams"])) <= 3
    assert st["final_radius"] == pytest.approx(sj["final_radius"])
