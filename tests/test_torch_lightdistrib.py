"""The light-pick strategies and ambient occlusion in bre_tpu_torch against
bre_tpu, on the CPU: the spatial light distribution (pmf, cdf and picks),
the power strategy's table, one render_volpath with the halton sampler and
the spatial strategy (the CLI's volpath default) on the Cornell fog scene
with its area light and an extra point light, and render_ao.

Tolerances and their reasons:
- pmf and cdf: rtol 1e-5.  A voxel's weight is the mean of 32 |Li|/pdf
  samples, and XLA:CPU and torch add a 32-wide mean in different orders
  and contract the sample points' multiply-adds (ROADMAP Queue 3).
- Picks: equal wherever u lies more than 1e-5 from the voxel's cdf
  entries (a pick at a boundary may flip with the cdf's last bits).
- render_volpath: as tests/test_torch_volpath.py (the same streams and
  draw order): the mean within 1e-4 and 99% of pixels within rtol 1e-4
  (atol 1e-6).
- render_ao: the occlusion counts per pixel equal on 99% of pixels (a
  shadow ray grazing an edge may flip with the last ulp of its origin),
  the mean within 1e-3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bre_tpu import lights as jl
from bre_tpu.core import transform as jtfm
from bre_tpu.core.spectrum import luminance as jlum
from bre_tpu.integrators import extra as jextra
from bre_tpu.scene import camera as jcam
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu_torch import lights as tl
from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.integrators import extra as textra
from bre_tpu_torch.integrators import volpath as tvp
from bre_tpu_torch.scene import camera as tcam
from bre_tpu_torch.scene.scene import scene_from_jax
from test_lightdistrib import _two_room_scene
from test_torch_volpath import _render_pair
from torch_parity import cornell_fog, to_np


def _picks_match(sld_t, sld_j, rs, n=4000):
    lo = np.asarray(sld_j.wmin)
    hi = lo + 1.0 / np.asarray(sld_j.inv_extent)
    p = rs.uniform(lo - 0.1, hi + 0.1, (n, 3)).astype(np.float32)
    u = rs.rand(n).astype(np.float32)
    it, pt = tl.sample_light_spatial(sld_t, torch.from_numpy(p),
                                     torch.from_numpy(u))
    ij, pj = jl.sample_light_spatial(sld_j, jnp.asarray(p), jnp.asarray(u))
    it, ij = to_np(it), np.asarray(ij)
    # the voxel of each point, as both packages compute it
    res = sld_j.res
    q = (p - lo) * np.asarray(sld_j.inv_extent) * res
    ijk = np.clip(q.astype(np.int32), 0, res - 1)
    vox = (ijk[:, 2] * res + ijk[:, 1]) * res + ijk[:, 0]
    margin = np.abs(np.asarray(sld_j.cdf)[vox] - u[:, None]).min(-1)
    safe = margin > 1e-5
    assert safe.mean() > 0.99
    np.testing.assert_array_equal(it[safe], ij[safe])
    np.testing.assert_allclose(to_np(pt)[safe], np.asarray(pj)[safe],
                               rtol=1e-5)
    assert len(np.unique(ij)) > 1


@pytest.mark.parametrize("res,spv", [(8, 16), (16, 32)])
def test_spatial_distribution_matches_jax(res, spv):
    js = _two_room_scene()
    ts = scene_from_jax(js, device="cpu")
    sj = jl.spatial_light_distribution(js, res=res, samples_per_voxel=spv)
    st = tl.spatial_light_distribution(ts, res=res, samples_per_voxel=spv)
    assert st.res == sj.res and st.pmf.shape == sj.pmf.shape
    np.testing.assert_allclose(to_np(st.pmf), np.asarray(sj.pmf), rtol=1e-5)
    np.testing.assert_allclose(to_np(st.cdf), np.asarray(sj.cdf), rtol=1e-5)
    np.testing.assert_array_equal(to_np(st.wmin), np.asarray(sj.wmin))
    np.testing.assert_array_equal(to_np(st.inv_extent),
                                  np.asarray(sj.inv_extent))
    _picks_match(st, sj, np.random.RandomState(res))


def test_power_distribution_matches_jax():
    """The "power" strategy's one-voxel table (volpath.py:458-470)."""
    js = cornell_fog(JBuilder(), point_light=True)
    ts = scene_from_jax(js, device="cpu")
    w = jlum(jl.light_power(js))
    pmf = np.asarray(w / jnp.sum(w))
    st = tl.power_light_distribution(ts)
    assert st.res == 1
    np.testing.assert_allclose(to_np(st.pmf)[0], pmf, rtol=1e-6)
    np.testing.assert_allclose(to_np(st.cdf)[0], np.cumsum(pmf), rtol=1e-6)


def test_no_lights_distribution_is_uniform():
    b = JBuilder()
    b.quad((-1, -1, 2), (1, -1, 2), (1, 1, 2), (-1, 1, 2),
           material=b.matte((0.5,) * 3))
    ts = scene_from_jax(b.build(), device="cpu")
    st = tl.spatial_light_distribution(ts, res=4)
    assert st.pmf.shape == (64, 1) and bool((st.cdf == 1).all())
    assert tvp.light_distribution(ts, "spatial") is None


def test_volpath_halton_spatial_matches_jax():
    it, ij = _render_pair("cornell", "full", spp=2, sampler="halton",
                          lightsamplestrategy="spatial")
    assert np.isfinite(it).all() and ij.mean() > 0
    assert abs(it.mean() / ij.mean() - 1.0) < 1e-4
    close = np.isclose(it, ij, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, close.mean()


def test_render_ao_matches_jax():
    """A matte box on a matte floor before a back wall (ao.cpp reads the
    first hit whatever its material, so the scene has no null surfaces)."""
    b = JBuilder()
    m = b.matte((0.5,) * 3)
    b.quad((-3, -1, -1), (-3, -1, 4), (3, -1, 4), (3, -1, -1), material=m)
    b.quad((-3, -1, 2), (-3, 3, 2), (3, 3, 2), (3, -1, 2), material=m)
    b.box((-0.5, -1, 0.5), (0.5, 0, 1.5), material=m)
    js = b.build()
    ts = scene_from_jax(js, device="cpu")
    look = ((0.6, 1.2, -2.0), (0, -0.5, 1), (0, 1, 0))
    W = 10
    cj = jcam.make_perspective_camera(jtfm.look_at(*look), 40.0, W, W)
    ct = tcam.make_perspective_camera(ttfm.look_at(*look), 40.0, W, W,
                                      device="cpu")
    cfg = dict(nsamples=24, maxdistance=0.8)
    aj = np.asarray(jextra.render_ao(js, cj, W, W, jextra.AOConfig(**cfg)))
    at = to_np(textra.render_ao(ts, ct, W, W, textra.AOConfig(**cfg)))
    assert at.shape == aj.shape == (W, W, 3)
    assert 0.05 < aj.mean() < 0.95
    assert (at == aj).all(-1).mean() >= 0.99
    assert abs(at.mean() - aj.mean()) < 1e-3
