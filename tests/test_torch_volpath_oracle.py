"""The photon-beam estimator against the volpath oracle, both through
bre_tpu_torch: tests/test_photonbeam_vs_volpath.py's
test_bre_matches_volpath_fog_cube at its full shape (24x24, volpath
maxdepth 8 x 384 spp, BRE 24 iterations x 12,000 photons) on the CPU, with
its ``_check`` tolerances unchanged: the image mean within 10%, 3x3 region
means within 15% where the region carries signal, the 8x8-downsampled
images correlated above 0.95.  The grid-smoke version
(test_bre_matches_volpath_grid_smoke, slow in the reference's suite) runs
on the card in chip_smoke.py.

This file imports no JAX: chip_smoke.py takes its scenes and ``_check``.
"""

import numpy as np

from bre_tpu_torch.core import transform as tfm
from bre_tpu_torch.integrators.photonbeam import (PhotonBeamConfig,
                                                  render_photonbeam)
from bre_tpu_torch.integrators.volpath import VolPathConfig, render_volpath
from bre_tpu_torch.scene.builder import SceneBuilder
from bre_tpu_torch.scene.camera import make_perspective_camera


def _check(est, truth, mean_tol, region_tol, n_region=3):
    """tests/test_photonbeam_vs_volpath.py's _check, verbatim."""
    t = np.asarray(truth)
    e = np.asarray(est)
    ratio = e.mean() / t.mean()
    assert 1 - mean_tol < ratio < 1 + mean_tol, (
        f"mean ratio {ratio}: BRE {e.mean()} vs volpath {t.mean()}")
    wh = t.shape[0]
    blk = wh // n_region
    tr_ = t[: n_region * blk, : n_region * blk].reshape(
        n_region, blk, n_region, blk, 3).mean((1, 3, 4))
    er_ = e[: n_region * blk, : n_region * blk].reshape(
        n_region, blk, n_region, blk, 3).mean((1, 3, 4))
    sig = tr_ > 0.1 * t.mean()
    rr = er_[sig] / tr_[sig]
    assert (np.abs(rr - 1.0) < region_tol).all(), f"region ratios {rr}"
    k = wh // 8
    td = t[: 8 * k, : 8 * k].reshape(8, k, 8, k, 3).mean((1, 3, 4)).ravel()
    ed = e[: 8 * k, : 8 * k].reshape(8, k, 8, k, 3).mean((1, 3, 4)).ravel()
    corr = np.corrcoef(td, ed)[0, 1]
    assert corr > 0.95, f"spatial correlation {corr}"
    return dict(mean_ratio=float(ratio), region_ratios=rr.tolist(),
                corr=float(corr))


def fog_cube_scene(device, sigma_a=0.05, sigma_s=0.4, g=0.0, intensity=1.0):
    """tests/test_photonbeam.py's fog cube: a point light at the centre of
    a homogeneous [-1,1]^3 medium behind null boundaries."""
    b = SceneBuilder()
    fog = b.homogeneous_medium((sigma_a,) * 3, (sigma_s,) * 3, g)
    b.box((-1, -1, -1), (1, 1, 1), material=-1, medium_inside=fog,
          medium_outside=-1)
    b.point_light((0.0, 0.0, 0.0), (intensity,) * 3, medium=fog)
    return b.build(device=device)


def smoke_scene(device, g=0.4, n=24):
    """tests/test_photonbeam_vs_volpath.py's smoke_scene: a grid-density
    puff with anisotropic HG, lit from inside."""
    x, y, z = np.meshgrid(*(np.linspace(-1, 1, n),) * 3, indexing="ij")
    dens = np.exp(-2.0 * (x**2 + 2 * y**2 + z**2))
    dens *= 1.0 + 0.5 * np.sin(4 * x) * np.cos(3 * z)
    dens = np.clip(dens, 0.0, None).astype(np.float32)
    b = SceneBuilder()
    w2m = np.array(
        [[0.5, 0, 0, 0.5], [0, 0.5, 0, 0.5], [0, 0, 0.5, 0.5], [0, 0, 0, 1]],
        np.float32)
    smoke = b.grid_medium(dens, w2m, sigma_a=(0.05,) * 3, sigma_s=(0.9,) * 3,
                          g=g)
    b.box((-1, -1, -1), (1, 1, 1), material=-1, medium_inside=smoke,
          medium_outside=-1)
    b.point_light((0.0, 0.6, -0.4), (2.0, 2.0, 2.0), medium=smoke)
    return b.build(device=device)


# (scene, eye, fov, volpath config, BRE config, _check tolerances)
ORACLES = {
    "fog_cube": (fog_cube_scene, (0, 0, -3.5), 40.0,
                 VolPathConfig(maxdepth=8, spp=384),
                 PhotonBeamConfig(iterations=24, maxdepth=8,
                                  photonsperiteration=12000,
                                  initialbeamradius=0.05, alpha=0.5,
                                  kernel="bre", gather_chunk=4096),
                 dict(mean_tol=0.10, region_tol=0.15), 24),
    "grid_smoke": (smoke_scene, (0, 0, -3.2), 45.0,
                   VolPathConfig(maxdepth=8, spp=384),
                   PhotonBeamConfig(iterations=24, maxdepth=8,
                                    photonsperiteration=12000,
                                    initialbeamradius=0.05, alpha=0.5,
                                    kernel="bre", gather_chunk=4096),
                   dict(mean_tol=0.10, region_tol=0.20), 20),
}


def oracle_renders(name, device):
    """(volpath image, BRE image) of one oracle case on ``device``."""
    make, eye, fov, vcfg, bcfg, _, wh = ORACLES[name]
    scene = make(device)
    cam = make_perspective_camera(tfm.look_at(eye, (0, 0, 0), (0, 1, 0)), fov,
                                  wh, wh, device=device)
    truth = render_volpath(scene, cam, wh, wh, vcfg)
    est, _ = render_photonbeam(scene, cam, wh, wh, bcfg)
    return truth.cpu().numpy(), est.cpu().numpy()


def test_bre_matches_volpath_fog_cube():
    truth, est = oracle_renders("fog_cube", "cpu")
    _check(est, truth, **ORACLES["fog_cube"][5])
