"""photonmap in bre_tpu_torch against bre_tpu, on the CPU: photon shooting
(bre_tpu eager, no jit) on the vsppm golden scene, which deposits direct,
caustic (a wall deposit after medium scatters only) and volume photons; the range gather on fixed inputs; and the
port's render against the port's volpath oracle on
tests/test_photonmap.py's fog cube, sizes and ratio bound (0.5-1.7).

Tolerances and their reasons:
- Photon classes, validity and sort keys: exact (the same PCG32 streams,
  decisions and stable sort).
- Positions within 5e-6 and directions within 1e-6 (absolute), powers
  rtol 1e-5: XLA:CPU contracts multiply-adds (ROADMAP Queue 3), and a
  photon's later deposits carry its earlier bounces' ulps (measured: 2.2e-6
  at the scene's extent of 3, 1.5e-7, 5.6e-7).
- The range gather: counts exact; sums rtol 1e-5, for the order of the K
  sum.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from bre_tpu.integrators import photonmap as jpm
from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.integrators import photonmap as tpm
from bre_tpu_torch.integrators.volpath import VolPathConfig, render_volpath
from bre_tpu_torch.scene import camera as tcam
from bre_tpu_torch.scene.scene import scene_from_jax
from test_photonbeam import fog_cube_scene
from test_torch_vsppm import golden_scenes
from torch_parity import to_np

CFG = dict(nphotons=2000, maxdepth=4)


@pytest.fixture(scope="module")
def maps():
    js, _, ts, _ = golden_scenes()
    mj = jpm.shoot_photons(js, jpm.PhotonMapConfig(**CFG), seed=3)
    mt = tpm.shoot_photons(ts, tpm.PhotonMapConfig(**CFG), seed=3)
    return mj, mt


def test_shoot_photons_matches_jax(maps):
    mj, mt = maps
    np.testing.assert_array_equal(to_np(mt.valid), np.asarray(mj.valid))
    np.testing.assert_array_equal(to_np(mt.pclass), np.asarray(mj.pclass))
    np.testing.assert_array_equal(to_np(mt.keys), np.asarray(mj.keys))
    v = np.asarray(mj.valid)
    for f, rtol, atol in (("p", 0, 5e-6), ("wi", 0, 1e-6),
                          ("power", 1e-5, 0)):
        np.testing.assert_allclose(to_np(getattr(mt, f))[v],
                                   np.asarray(getattr(mj, f))[v],
                                   rtol=rtol, atol=atol, err_msg=f)
    np.testing.assert_array_equal(to_np(mt.gmin), np.asarray(mj.gmin))
    assert float(mt.cell) == float(mj.cell)
    counts = {c: int(((np.asarray(mj.pclass) == c) & v).sum())
              for c in (tpm.P_DIRECT, tpm.P_CAUSTIC, tpm.P_VOLUME)}
    assert all(n > 0 for n in counts.values()), counts


@pytest.mark.parametrize("pclass", [tpm.P_CAUSTIC, tpm.P_VOLUME])
def test_range_gather_matches_jax(maps, pclass):
    """300 query points within 0.1 of the class's photons, with radii
    0.1-0.4, and a per-photon function of the direction and power."""
    mj, mt = maps
    rs = np.random.RandomState(5)
    mine = np.asarray(mj.p)[np.asarray(mj.valid)
                            & (np.asarray(mj.pclass) == pclass)]
    x = (mine[rs.randint(0, len(mine), 300)]
         + rs.uniform(-0.1, 0.1, (300, 3))).astype(np.float32)
    rad = (rs.rand(300) * 0.3 + 0.1).astype(np.float32)
    K = 16
    gj = jax.jit(lambda x, r: jpm._range_gather(
        mj, pclass, x, r, lambda wi, pw: pw * (wi[:, 0:1] + 2.0), K))
    acc_j, cnt_j = gj(jnp.asarray(x), jnp.asarray(rad))
    acc_t, cnt_t = tpm._range_gather(
        mt, pclass, torch.from_numpy(x), torch.from_numpy(rad),
        lambda rows, wi, pw: pw * (wi[..., 0:1] + 2.0), K)
    np.testing.assert_array_equal(to_np(cnt_t), np.asarray(cnt_j))
    assert int(np.asarray(cnt_j).sum()) > 100
    np.testing.assert_allclose(to_np(acc_t), np.asarray(acc_j), rtol=1e-5,
                               atol=1e-7)


def test_photonmap_volume_matches_volpath():
    """tests/test_photonmap.py::test_photonmap_volume_matches_volpath on the
    port alone: 12x12, 12,000 photons, volume radius 0.25, 24 march steps,
    2 spp, K = 192, against volpath at 96 spp."""
    js = fog_cube_scene(sigma_a=0.05, sigma_s=0.4, intensity=1.0).build()
    s = scene_from_jax(js, device="cpu")
    wh = 12
    cam = tcam.make_perspective_camera(
        ttfm.look_at((0, 0, -3.5), (0, 0, 0), (0, 1, 0)), 40.0, wh, wh,
        device="cpu")
    img, stats = tpm.render_photonmap(s, cam, wh, wh, tpm.PhotonMapConfig(
        nphotons=12_000, maxdepth=5, volume_maxdist=0.25, march_steps=24,
        spp=2, max_photons_per_cell=192))
    img = to_np(img)
    assert np.isfinite(img).all() and (img >= 0).all() and img.max() > 0
    truth = to_np(render_volpath(s, cam, wh, wh,
                                 VolPathConfig(maxdepth=5, spp=96)))
    ratio = img.mean() / truth.mean()
    assert 0.5 < ratio < 1.7, (img.mean(), truth.mean())
    c = stats["photon_counts"]
    assert c["volume"] > 0 and c["direct"] == 0 and c["caustic"] == 0


def test_photonmap_config_fields_match():
    fj = [(f.name, f.default) for f in dataclasses.fields(jpm.PhotonMapConfig)]
    ft = [(f.name, f.default) for f in dataclasses.fields(tpm.PhotonMapConfig)]
    assert ft == fj
