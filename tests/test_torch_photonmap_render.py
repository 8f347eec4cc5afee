"""render_photonmap in bre_tpu_torch against bre_tpu's, on the CPU, on the
vsppm golden scene (a fog cube with a point light in it and a matte
wall): 8x8, 2,000 photons, maxdepth 2, 4 march steps, 2 spp, K = 16.
The scene deposits direct, caustic (on the wall after a medium scatter)
and volume photons, so one render runs the volume march, the surface
density estimates with the BSDF, next-event estimation and the walk
across the cube's boundary.  bre_tpu jits one pass whole (about 2 minutes
of XLA compile on one core, the BSDF inlined into every gather loop), so
this file holds that one render, in a module fixture its three tests
read.

Tolerances and their reasons:
- Photon counts of each class: exact (the same PCG32 streams and stable
  sort).
- The image: rtol 1e-5 (atol 1e-7).  The port sums a cell's K slots and a
  segment's march steps at once where the reference adds them one by one,
  and XLA:CPU contracts multiply-adds (ROADMAP Queue 3); measured 5.8e-7.
"""

import numpy as np
import pytest

from bre_tpu.integrators import photonmap as jpm
from bre_tpu_torch.integrators import photonmap as tpm
from test_torch_vsppm import W, golden_scenes
from torch_parity import to_np

CFG = dict(nphotons=2000, maxdepth=2, march_steps=4, spp=2,
           max_photons_per_cell=16)


@pytest.fixture(scope="module")
def renders():
    """Both packages' renders, and the photons the port's volume march and
    surface estimates found, by class."""
    js, jc, ts, tc = golden_scenes()
    gathered = {}
    gather = tpm._range_gather

    def counting_gather(maps, pclass, *args, **kw):
        acc, count = gather(maps, pclass, *args, **kw)
        gathered[pclass] = gathered.get(pclass, 0) + int(count.sum())
        return acc, count

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpm, "_range_gather", counting_gather)
        img_t, st_t = tpm.render_photonmap(ts, tc, W, W,
                                           tpm.PhotonMapConfig(**CFG))
    img_j, st_j = jpm.render_photonmap(js, jc, W, W, jpm.PhotonMapConfig(**CFG))
    return to_np(img_t), st_t, np.asarray(img_j), st_j, gathered


def test_photon_counts_match_jax(renders):
    _, st_t, _, st_j, _ = renders
    assert st_t == st_j
    c = st_t["photon_counts"]
    assert c["direct"] > 0 and c["caustic"] > 0 and c["volume"] > 0, c


def test_gathers_find_photons(renders):
    """The volume march and the caustic estimate both found photons."""
    gathered = renders[4]
    assert gathered[tpm.P_VOLUME] > 0 and gathered[tpm.P_CAUSTIC] > 0, gathered


def test_render_photonmap_matches_jax(renders):
    img_t, _, img_j, _, _ = renders
    assert img_t.shape == (W, W, 3) and np.isfinite(img_t).all()
    assert img_j.mean() > 0
    np.testing.assert_allclose(img_t, img_j, rtol=1e-5, atol=1e-7)
