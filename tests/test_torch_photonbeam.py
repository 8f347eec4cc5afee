"""bre_tpu_torch photon tracing and camera pass vs bre_tpu on the Cornell
fog scene (BASELINE config 2 at a small size).

Tolerances and their reasons:
- trace: both packages draw every sample from bit-identical PCG32 streams in
  the same order, so photon walks are identical slot for slot except where a
  float-ulp difference (XLA contracts multiply-adds and uses other
  exp/log/sin/cos than torch) flips a decision — a scatter, a roulette, a
  hit near an edge.  The reference records the same effect against pbrt
  (README "float-ULP flips").  At least 99% of photons must match in every
  slot's validity, medium and position (rtol 1e-4); on matching photons
  positions and powers agree to rtol 1e-4.
- camera pass: fed the SAME beams (the reference's, carried across), so the
  photon side cannot diverge; per-pixel rtol 1e-4 (measured ~4e-6)."""

import jax.numpy as jnp
import numpy as np
import torch

from bre_tpu.core import transform as jtfm
from bre_tpu.integrators import photonbeam as jpb
from bre_tpu.integrators.photon_trace import trace_photon_beams as jtrace
from bre_tpu.lights import light_power_distribution as jdistr
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu.scene.camera import make_perspective_camera as jcam
from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.integrators import photonbeam as tpb
from bre_tpu_torch.integrators.photon_trace import Beams, trace_photon_beams as ttrace
from bre_tpu_torch.lights import light_power_distribution as tdistr
from bre_tpu_torch.scene.camera import make_perspective_camera as tcam
from bre_tpu_torch.scene.scene import scene_from_jax
from torch_parity import cornell_fog, to_np

P, MAXDEPTH, RADIUS, ITER = 2000, 5, 0.12, 3


def _trace_both():
    js = cornell_fog(JBuilder())
    ts = scene_from_jax(js)
    bj, sj = jtrace(js, jdistr(js), ITER, P, MAXDEPTH, jnp.float32(RADIUS),
                    detach_sampling=True, long_beams=True, early_exit=True)
    bt, st = ttrace(ts, tdistr(ts), ITER, P, MAXDEPTH, RADIUS,
                    detach_sampling=True, long_beams=True)
    return js, ts, bj, bt, sj, st


def test_trace_photon_beams_matches():
    _, _, bj, bt, sj, st = _trace_both()
    S = MAXDEPTH + 2
    assert bt.capacity == bj.capacity == P * S
    per = lambda x: to_np(x).reshape((S, P) + to_np(x).shape[1:])  # noqa: E731
    vj, vt = per(bj.valid), per(bt.valid)
    same = (vj == vt).all(0) & (per(bj.medium) == per(bt.medium)).all(0)
    for k in ("start", "end"):
        close = np.isclose(per(getattr(bt, k)), per(getattr(bj, k)),
                           rtol=1e-4, atol=1e-5).all(-1)
        same &= (close | ~vj).all(0)
    assert same.mean() >= 0.99, same.mean()
    assert vj.sum() > P  # several beams per photon
    # on identical photons, geometry and powers agree to rtol 1e-4
    m = np.broadcast_to(same[None], vj.shape) & vj
    for k in ("start", "end", "power_start", "power_end"):
        np.testing.assert_allclose(per(getattr(bt, k))[m],
                                   per(getattr(bj, k))[m], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(to_np(bt.radius), to_np(bj.radius))
    assert abs(int(st["n_beams"]) - int(sj["n_beams"])) <= 0.01 * int(sj["n_beams"])


def test_camera_pass_same_beams_matches():
    """The camera side alone: JAX's beams carried across to the port."""
    W = H = 24
    js, ts, bj, _, _, _ = _trace_both()
    bt = Beams(*(torch.from_numpy(np.array(x)) for x in bj))
    bt = bt._replace(medium=bt.medium.to(torch.int64))
    args = ((0, 0, -2.2), (0, 0, 1), (0, 1, 0))
    cj = jcam(jtfm.look_at(*args), 50.0, W, H)
    ct = tcam(ttfm.look_at(*args), 50.0, W, H)
    kw = dict(gather="auto", grad_geometry=False, tr_crossings=2,
              maxdepth=MAXDEPTH)
    Lj, _ = jpb.camera_pass(js, cj, W, H, bj, jnp.float32(RADIUS), ITER,
                            jpb.PhotonBeamConfig(depth_scan=True,
                                                 grad_extras=False, **kw),
                            photons_per_iter=P)
    Lt, st = tpb.camera_pass(ts, ct, W, H, bt, RADIUS, ITER,
                             tpb.PhotonBeamConfig(**kw), photons_per_iter=P)
    Lj = to_np(Lj)
    assert Lt.shape == (W * H, 3) and st["camera_rays"] == W * H
    assert Lj.mean() > 0
    np.testing.assert_allclose(to_np(Lt), Lj, rtol=1e-4, atol=1e-7)
