"""bre_tpu_torch forward+backward on grid-density media vs bre_tpu: the
gradient of one progressive iteration in the density brick and sigma_s
(examples/bench_hetero_bwd.py's iteration, at 16x16 film, 1,500 photons,
maxdepth 2 and a 16^3 grid) against jax.grad — identical inputs, the scene
carried across by ``scene_from_jax``.

Tolerances and their reasons: both packages draw every sample from
bit-identical PCG32 streams and run the same tracking trips, so they differ
only where a float-ulp difference flips a photon or camera-path decision
and in the order of float sums: the value within 5e-3 relative, gradients
within 2e-3 * max|ref|, test_torch_grad.py's criterion (measured 1.4e-5 at
32x32 and maxdepth 5).

The reference's d sigma_s is NaN in its first channel on this scene: the
grid branch of its ``sample_medium`` divides by max(sigma_t, 1e-30) on
vacuum lanes, and its one-hot media gather multiplies their NaN cotangent
by 0.  The port's select-based gather does not, so its first channel is
finite; only the reference's finite entries are compared (ROADMAP
Queue 3)."""

import jax
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
from bre_tpu_torch.integrators.photon_trace import trace_photon_beams as ttrace
from bre_tpu_torch.lights import light_power_distribution as tdistr
from bre_tpu_torch.scene.camera import make_perspective_camera as tcam
from bre_tpu_torch.scene.scene import scene_from_jax
from torch_parity import SMOKE_LOOK, smoke_density, smoke_hetero, to_np

WH, PHOTONS, MAXDEPTH, RADIUS = 16, 1500, 2, 0.15


def test_fwd_bwd_density_sigma_s_matches_jax():
    js = smoke_hetero(JBuilder(), density=smoke_density(16))
    ts = scene_from_jax(js, device="cpu")
    kw = dict(maxdepth=MAXDEPTH, photonsperiteration=PHOTONS,
              initialbeamradius=RADIUS, gather="pallas", grad_geometry=False,
              grad_extras=False)
    jc = jcam(jtfm.look_at(*SMOKE_LOOK), 50.0, WH, WH)
    jcfg, distr = jpb.PhotonBeamConfig(gather_chunk=256, **kw), jdistr(js)

    def it_j(density, sigma_s):
        sc = js._replace(media=js.media._replace(density=density,
                                                 sigma_s=sigma_s))
        beams, _ = jtrace(sc, distr, jnp.uint32(1), PHOTONS, MAXDEPTH,
                          jnp.float32(RADIUS), detach_sampling=True)
        Ld, _ = jpb.camera_pass(sc, jc, WH, WH, beams, jnp.float32(RADIUS),
                                jnp.uint32(1), jcfg, PHOTONS)
        return jnp.mean(Ld)

    lj, gj = jax.jit(jax.value_and_grad(it_j, (0, 1)))(js.media.density,
                                                       js.media.sigma_s)
    leaves = [ts.media.density.clone().requires_grad_(),
              ts.media.sigma_s.clone().requires_grad_()]
    sc = ts._replace(media=ts.media._replace(density=leaves[0],
                                             sigma_s=leaves[1]))
    beams, _ = ttrace(sc, tdistr(sc), 1, PHOTONS, MAXDEPTH, RADIUS,
                      detach_sampling=True)
    Ld, _ = tpb.camera_pass(
        sc, tcam(ttfm.look_at(*SMOKE_LOOK), 50.0, WH, WH, device="cpu"),
        WH, WH, beams, RADIUS, 1, tpb.PhotonBeamConfig(**kw), PHOTONS)
    lt = Ld.mean()
    gt = torch.autograd.grad(lt, leaves)
    assert float(lj) > 0 and abs(float(lt.detach()) / float(lj) - 1) < 5e-3
    for name, g_t, g_j in zip(("density", "sigma_s"), gt, gj):
        g_t, g_j = to_np(g_t), to_np(g_j)
        assert np.isfinite(g_t).all(), name
        ok = np.isfinite(g_j)
        assert ok.sum() >= g_j.size - 1 and np.abs(g_j[ok]).max() > 0, name
        err = np.abs(g_t[ok] - g_j[ok]).max()
        assert err <= 2e-3 * np.abs(g_j[ok]).max(), (name, err)
    # the density brick's gradient reaches most voxels of the puff
    assert (np.abs(to_np(gt[0])) > 0).mean() > 0.3
