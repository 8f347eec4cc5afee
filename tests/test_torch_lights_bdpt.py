"""``render_bdpt`` of bre_tpu_torch against bre_tpu's, on the CPU, on a
matte sphere lit by a distant light and an env map
(``torch_parity.env_sphere``: the delta-direction branch, whose first
light vertex is not connectible, and the infinite-light densities of the
escaped camera rays at the film's corners), at 8x8, 2 spp, maxdepth 3.
One ``mlt._evaluate`` batch on the same scene is
tests/test_torch_lights_mlt.py (one compile of bre_tpu's render takes
most of this file's time on one core).

Tolerances: tests/test_torch_bdpt.py's whole render (image mean rtol
1e-5, 4x4 region means rtol 1e-4, 99% of pixels within rtol 1e-3, atol
1e-6).
"""

import numpy as np

from bre_tpu.core import transform as jtfm
from bre_tpu.integrators import bdpt as jb
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu.scene.camera import make_perspective_camera as jcam
from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.integrators import bdpt as tb
from bre_tpu_torch.scene.builder import SceneBuilder
from bre_tpu_torch.scene.camera import make_perspective_camera as tcam
from test_torch_bdpt import assert_renders_close
from torch_parity import ENV_SPHERE_LOOK, env_sphere, to_np

WH = 8


def setup_scenes():
    """The port's and bre_tpu's env_sphere and cameras at WH x WH."""
    return (env_sphere(SceneBuilder(), device="cpu"), env_sphere(JBuilder()),
            tcam(ttfm.look_at(*ENV_SPHERE_LOOK), 60.0, WH, WH, device="cpu"),
            jcam(jtfm.look_at(*ENV_SPHERE_LOOK), 60.0, WH, WH))


def test_render_bdpt_distant_and_env_map_match_jax():
    ts, js, cam_t, cam_j = setup_scenes()
    cfg = dict(maxdepth=3, spp=2)
    img_t = to_np(tb.render_bdpt(ts, cam_t, WH, WH, tb.BDPTConfig(**cfg)))
    img_j = np.asarray(jb.render_bdpt(js, cam_j, WH, WH,
                                      jb.BDPTConfig(**cfg)))
    assert_renders_close(img_t, img_j)
