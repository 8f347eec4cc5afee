"""``render_volpath`` of bre_tpu_torch against bre_tpu's, on the CPU, with
the other lights: the lit fog box of tests/test_torch_lights_render.py
(``torch_parity.lit_fog_box``: a spot, a distant and an image-mapped
infinite light) at 16x16, with the spatial light picks and MIS (2 spp,
maxdepth 5): the full EstimateDirect, whose scatter-sampled half adds the
env map's radiance and density where its ray escapes.

Tolerances: tests/test_torch_lights_render.py's (image means and the 4x4
region means within rtol 1e-4, 99% of the pixels within rtol 1e-3).
"""

from bre_tpu.integrators import volpath as jvp
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu_torch.integrators import volpath as tvp
from bre_tpu_torch.scene.builder import SceneBuilder as TBuilder
from test_torch_lights_render import W, cameras, images_close
from torch_parity import lit_fog_box


def test_render_volpath_other_lights_match_jax():
    cam_t, cam_j = cameras()
    cfg = dict(maxdepth=5, spp=2, lightsamplestrategy="spatial",
               nee_mis=True)
    ij = jvp.render_volpath(lit_fog_box(JBuilder()), cam_j, W, W,
                            jvp.VolPathConfig(**cfg))
    it = tvp.render_volpath(lit_fog_box(TBuilder(), device="cpu"), cam_t, W,
                            W, tvp.VolPathConfig(**cfg))
    images_close(it, ij)
