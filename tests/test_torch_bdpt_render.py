"""A whole ``render_bdpt`` in bre_tpu_torch against bre_tpu's, on the CPU:
tests/test_bdpt.py's matte sphere lit from its center by a point light, at
8x8, 2 samples per pixel, maxdepth 3, with the whole-render tolerances
of tests/test_torch_bdpt.py (which renders the fog shell).
"""

import numpy as np

from bre_tpu.integrators import bdpt as jb
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu_torch.integrators import bdpt as tb
from bre_tpu_torch.scene.builder import SceneBuilder
from test_torch_bdpt import (WH, assert_renders_close, cameras,
                             sphere_point_light)
from torch_parity import to_np


def test_render_bdpt_point_light_matches_jax():
    cam_t, cam_j = cameras(WH)
    cfg = dict(maxdepth=3, spp=2)
    img_t = to_np(tb.render_bdpt(sphere_point_light(SceneBuilder(),
                                                    device="cpu"), cam_t,
                                 WH, WH, tb.BDPTConfig(**cfg)))
    img_j = np.asarray(jb.render_bdpt(sphere_point_light(JBuilder()), cam_j,
                                      WH, WH, jb.BDPTConfig(**cfg)))
    assert_renders_close(img_t, img_j)
