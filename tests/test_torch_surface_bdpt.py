"""render_bdpt of bre_tpu_torch against bre_tpu on the surface scene of
``torch_parity.surface_scene`` (a glass sphere in fog, a mirror floor, a
metal and a plastic sphere, a textured wall, two point lights) at 8x8,
2 samples per pixel, maxdepth 3: mirror and glass vertices are not
connectible (bdpt.h:246-252), the other materials are.

Tolerances: tests/test_torch_bdpt.py's whole-render ones (image mean rtol
1e-5, 4x4 region means rtol 1e-4, 99% of pixels within rtol 1e-3).
"""

import numpy as np
import torch

import jax.numpy as jnp
from bre_tpu.core import transform as jtfm
from bre_tpu.integrators import bdpt as jb
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu.scene.camera import make_perspective_camera as jcam
from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.integrators import bdpt as tb
from bre_tpu_torch.scene.builder import SceneBuilder as TBuilder
from bre_tpu_torch.scene.camera import make_perspective_camera as tcam
from test_torch_bdpt import WH, assert_renders_close
from torch_parity import SURFACE_FOV, SURFACE_LOOK, surface_scene, to_np


def test_surface_connectible_excludes_delta_lobes():
    ts = surface_scene(TBuilder(), device="cpu")
    idx = torch.arange(-1, ts.materials.mtype.shape[0])
    got = to_np(tb._surface_connectible(ts, idx))
    js = surface_scene(JBuilder())
    ref = np.asarray(jb._surface_connectible(js, jnp.asarray(idx.numpy())))
    np.testing.assert_array_equal(got, ref)
    assert got.any() and not got.all()


def test_render_bdpt_surfaces_match_jax():
    cfg = dict(maxdepth=3, spp=2)
    img_t = to_np(tb.render_bdpt(
        surface_scene(TBuilder(), device="cpu"),
        tcam(ttfm.look_at(*SURFACE_LOOK), SURFACE_FOV, WH, WH, device="cpu"),
        WH, WH, tb.BDPTConfig(**cfg)))
    img_j = np.asarray(jb.render_bdpt(
        surface_scene(JBuilder()),
        jcam(jtfm.look_at(*SURFACE_LOOK), SURFACE_FOV, WH, WH), WH, WH,
        jb.BDPTConfig(**cfg)))
    assert_renders_close(img_t, img_j)
