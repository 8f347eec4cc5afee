"""render_vsppm of bre_tpu_torch against bre_tpu on the surface scene of
``torch_parity.surface_scene`` (a glass sphere in fog, a mirror floor, a
metal and a plastic sphere; the wall untextured: bre_tpu's Perlin graph
takes minutes to compile into its passes), with bre_tpu's three phases
jitted one by one as tests/test_torch_vsppm.py runs them, at its 8x8 and
2 iterations x 200 photons, maxdepth 2; the visible points record on the
matte wall only, the photons bounce off every surface (specular ones
included).

Tolerances: statistics exact; the image rtol 1e-4 / atol 1e-7 per pixel
(tests/test_torch_vsppm.py holds its matte scene to 1e-5: the glossy
lobes' GGX conditioning, up to 3.5e-3 per lane in
tests/test_torch_materials.py, reaches the photons' powers here).
"""

import numpy as np
import pytest

from bre_tpu.core import transform as jtfm
from bre_tpu.integrators import vsppm as jv
from bre_tpu.scene import camera as jcam
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.integrators import vsppm as tv
from bre_tpu_torch.scene import camera as tcam
from bre_tpu_torch.scene.builder import SceneBuilder as TBuilder
from test_torch_vsppm import W, phase_jitted_render
from torch_parity import SURFACE_FOV, SURFACE_LOOK, surface_scene, to_np

CFG = dict(iterations=2, maxdepth=2, photonsperiteration=200, radius=0.25)


@pytest.mark.parametrize("kernel", ["physical"])
def test_vsppm_surfaces_match_jax(kernel):
    cfg = dict(kernel=kernel, **CFG)
    js = surface_scene(JBuilder(), textured=False)
    jc = jcam.make_perspective_camera(jtfm.look_at(*SURFACE_LOOK),
                                      SURFACE_FOV, W, W)
    img_j, stats_j, _ = phase_jitted_render(js, jc, jv.VSPPMConfig(**cfg))
    img_t, stats_t = tv.render_vsppm(
        surface_scene(TBuilder(), textured=False, device="cpu"),
        tcam.make_perspective_camera(ttfm.look_at(*SURFACE_LOOK), SURFACE_FOV,
                                     W, W, device="cpu"),
        W, W, tv.VSPPMConfig(**cfg))
    assert stats_t == stats_j
    assert stats_t["medium_interactions"] > 0 and stats_t["vp_surface"] > 0
    assert np.isfinite(to_np(img_t)).all() and img_j.max() > 0
    np.testing.assert_allclose(to_np(img_t), img_j, rtol=1e-4, atol=1e-7)
