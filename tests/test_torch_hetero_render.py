"""bre_tpu_torch on grid-density media end to end vs bre_tpu, on
examples/smoke_hetero.py's scene (BASELINE config 3) cut to 32x32 film and
a 16^3 grid: the photon walk slot for slot and a config-3-shaped
progressive render — identical inputs, scenes carried across by
``scene_from_jax``.  The gradient side is tests/test_torch_hetero_grad.py.

Tolerances and their reasons: both packages draw every sample from
bit-identical PCG32 streams and the grid tracking runs the same batch-wide
trips, so they differ only where a float-ulp difference (XLA contracts the
trilinear sum, torch does not) flips a tracking, scatter or roulette
decision, and in the order of float sums.  The walk must match slot for
slot on at least 99% of the beam slots (less would be a bug, not rounding);
measured 100%.  The image: mean within 1e-4 relative, pixels within 1e-3 of
the image's largest value (measured 2.4e-7 and 2e-5)."""

import jax.numpy as jnp
import numpy as np

from bre_tpu.core import transform as jtfm
from bre_tpu.integrators import photonbeam as jpb
from bre_tpu.integrators.photon_trace import trace_photon_beams as jtrace
from bre_tpu.lights import light_power_distribution as jdistr
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu.scene.camera import make_perspective_camera as jcam
from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.integrators import photonbeam as tpb
from bre_tpu_torch.integrators.photon_trace import trace_photon_beams as ttrace
from bre_tpu_torch.lights import light_power_distribution as tdistr
from bre_tpu_torch.scene.camera import make_perspective_camera as tcam
from bre_tpu_torch.scene.scene import scene_from_jax
from torch_parity import SMOKE_LOOK, smoke_density, smoke_hetero, to_np

WH, PHOTONS, MAXDEPTH, RADIUS = 32, 3000, 5, 0.15


def _scenes():
    js = smoke_hetero(JBuilder(), density=smoke_density(16))
    return js, scene_from_jax(js, device="cpu")


def test_photon_walk_matches_slot_for_slot():
    js, ts = _scenes()
    jb, js_stats = jtrace(js, jdistr(js), jnp.uint32(1), PHOTONS, MAXDEPTH,
                          jnp.float32(RADIUS), detach_sampling=True)
    tb, ts_stats = ttrace(ts, tdistr(ts), 1, PHOTONS, MAXDEPTH, RADIUS,
                          detach_sampling=True)
    vj, vt = to_np(jb.valid), to_np(tb.valid)
    match = vj == vt
    both = vj & vt
    for k in ("start", "end", "power_start", "power_end"):
        a, b = to_np(getattr(tb, k)), to_np(getattr(jb, k))
        match &= ~both | np.isclose(a, b, rtol=1e-4, atol=1e-6).all(-1)
    match &= ~both | (to_np(tb.medium) == to_np(jb.medium))
    assert vj.sum() > PHOTONS and (to_np(jb.medium)[vj] == 0).all()
    assert match.mean() >= 0.99, match.mean()
    assert int(ts_stats["n_beams"]) == int(js_stats["n_beams"])
    assert int(ts_stats["n_grid_overflow"]) == 0
    np.testing.assert_allclose(to_np(tb.power_start)[vt].sum(0),
                               to_np(jb.power_start)[vj].sum(0), rtol=1e-4)


def test_config3_shaped_render_matches_jax():
    js, ts = _scenes()
    kw = dict(iterations=2, maxdepth=MAXDEPTH, photonsperiteration=PHOTONS,
              initialbeamradius=RADIUS, gather="pallas", grad_geometry=False,
              grad_extras=False)
    jimg, jst = jpb.render_photonbeam(
        js, jcam(jtfm.look_at(*SMOKE_LOOK), 50.0, WH, WH), WH, WH,
        jpb.PhotonBeamConfig(gather_chunk=256, **kw))
    timg, tst = tpb.render_photonbeam(
        ts, tcam(ttfm.look_at(*SMOKE_LOOK), 50.0, WH, WH, device="cpu"),
        WH, WH, tpb.PhotonBeamConfig(**kw))
    jimg, timg = to_np(jimg), to_np(timg)
    assert timg.shape == (WH, WH, 3) and np.isfinite(timg).all()
    assert jimg.mean() > 0 and abs(timg.mean() / jimg.mean() - 1) < 1e-4
    assert np.abs(timg - jimg).max() <= 1e-3 * jimg.max()
    assert int(tst["n_beams"]) == int(jst["n_beams"])
