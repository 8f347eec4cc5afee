"""A whole ``render_mlt`` in bre_tpu_torch against bre_tpu's, on the CPU:
tests/test_mlt.py:27-40's matte sphere lit from its center by a point
light, at 8x8, maxdepth 2, 64 bootstrap samples, 16 chains and 2
mutations per pixel (8 chain steps).

Tolerances: the image mean within rtol 1e-4, the 4x4 region means within
1e-3 (a splat near a pixel edge may land in the neighbouring pixel of the
region), 99% of the pixels within rtol 1e-3, atol 1e-6.  The chains'
acceptance decisions compare luminances, and an accept that flipped
would move a chain and fail these bounds.
"""

import numpy as np
import pytest

from bre_tpu.integrators import mlt as jm
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu_torch.integrators import mlt as tm
from bre_tpu_torch.scene.builder import SceneBuilder
from test_torch_bdpt import cameras, sphere_point_light
from torch_parity import pixels_close, region_means, to_np

WH = 8


@pytest.fixture(scope="module")
def images():
    cfg = dict(maxdepth=2, bootstrapsamples=64, chains=16, mutationsperpixel=2)
    cam_t, cam_j = cameras(WH)
    img_t = to_np(tm.render_mlt(sphere_point_light(SceneBuilder(),
                                                   device="cpu"),
                                cam_t, WH, WH, tm.MLTConfig(**cfg)))
    img_j = np.asarray(jm.render_mlt(sphere_point_light(JBuilder()), cam_j, WH,
                                     WH, jm.MLTConfig(**cfg)))
    return img_t, img_j


def test_render_mlt_matches_jax(images):
    img_t, img_j = images
    assert np.isfinite(img_t).all() and img_j.mean() > 0
    np.testing.assert_allclose(img_t.mean(), img_j.mean(), rtol=1e-4)


def test_render_mlt_regions_match_jax(images):
    img_t, img_j = images
    np.testing.assert_allclose(region_means(img_t), region_means(img_j),
                               rtol=1e-3, atol=1e-7)


def test_render_mlt_pixels_match_jax(images):
    pixels_close(*images)
