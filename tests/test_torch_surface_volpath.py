"""render_volpath of bre_tpu_torch against bre_tpu on surface scenes: the
glass, mirror, metal and plastic scene of ``torch_parity.surface_scene``
with its textured wall, and ``texture_filter=True`` on image-mapped
surfaces (ray differentials at the first hits and EWA lookups), the case
that raised before the surface-material slice.

Tolerances: both packages run the same PCG32 streams in the same order of
draws.  tests/test_torch_volpath.py holds its matte scenes to 1e-4; here
the glossy lobes carry the GGX conditioning into the pixels (near a narrow
lobe's peak D amplifies the inputs' last bits, up to 3.5e-3 per lane in
tests/test_torch_materials.py; measured here: pixels within 1.05e-3, image
means within 1.1e-4), so the image mean is held within 1e-3 and 99% of
pixels within rtol 1e-3 (atol 1e-6), tests/test_torch_render.py's pixel
bound.
"""

import numpy as np
import pytest

from bre_tpu.core import transform as jtfm
from bre_tpu.integrators import volpath as jvp
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu.scene.camera import make_perspective_camera as jcam
from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.integrators import volpath as tvp
from bre_tpu_torch.scene.camera import make_perspective_camera as tcam
from bre_tpu_torch.scene.scene import scene_from_jax
from torch_parity import (IMAGE_LOOK, SURFACE_FOV, SURFACE_LOOK, image_scene,
                          surface_scene)

W = 16


def _pair(js, look, fov, cfg):
    ij = jvp.render_volpath(js, jcam(jtfm.look_at(*look), fov, W, W), W, W,
                            jvp.VolPathConfig(**cfg))
    it = tvp.render_volpath(scene_from_jax(js, device="cpu"),
                            tcam(ttfm.look_at(*look), fov, W, W, device="cpu"),
                            W, W, tvp.VolPathConfig(**cfg))
    it, ij = it.numpy(), np.asarray(ij)
    assert it.shape == ij.shape == (W, W, 3)
    assert np.isfinite(it).all() and ij.mean() > 0
    assert abs(it.mean() / ij.mean() - 1.0) < 1e-3
    close = np.isclose(it, ij, rtol=1e-3, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, close.mean()
    return it


def test_volpath_surfaces_match_jax():
    _pair(surface_scene(JBuilder()), SURFACE_LOOK, SURFACE_FOV,
          dict(maxdepth=6, spp=2))


@pytest.mark.parametrize("texture_filter", [True])
def test_volpath_texture_filter_matches_jax(texture_filter):
    it = _pair(image_scene(JBuilder()), IMAGE_LOOK, 40.0, dict(maxdepth=3, spp=2, texture_filter=texture_filter))
    assert it.std() > 0
