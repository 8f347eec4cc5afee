"""bre_tpu_torch inverse rendering of a density grid vs bre_tpu: two
``optimize_medium`` steps fitting the density brick of
examples/inverse_smoke.py's scene (at 16x16 film, 600 photons, maxdepth 1
and a 16^3 grid) with its total-variation prior, against the reference's
loop body (the loss and gradient of its one-device train step, the TV
prior and ``optax.adam``, clamped at 0, as ``bre_tpu.integrators.inverse``
runs them), and the prior itself against jax.grad.  The reference's
``optimize_medium`` compiles its sharded step twice on this scene (its
parameters become committed arrays after the first update), which takes
minutes on the CPU; its loop body, compiled once and without the one-device
``shard_map``, is the same computation.

Tolerances and their reasons: the losses and the prior within 5e-3
relative and 1e-5 * max|ref| (same PCG32 streams; only float sums and
ulp-flipped decisions differ, test_torch_inverse.py).  Adam moves each
fitted voxel by about the learning rate in the direction of its gradient's
sign, so a voxel whose gradient is within rounding of zero may move the
other way: at least 99% of the voxels must end within 1e-4 of the
reference's (measured 100%), and every voxel within two steps' travel."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from bre_tpu.core import transform as jtfm
from bre_tpu.integrators import photonbeam as jpb
from bre_tpu.integrators import common as jcommon
from bre_tpu.integrators.photon_trace import trace_photon_beams as jtrace
from bre_tpu.lights import light_power_distribution as jdistr
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu.scene.camera import make_perspective_camera as jcam
from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.integrators import inverse as tinv
from bre_tpu_torch.integrators import photonbeam as tpb
from bre_tpu_torch.scene.camera import make_perspective_camera as tcam
from bre_tpu_torch.scene.scene import scene_from_jax
from torch_parity import SMOKE_LOOK, smoke_density, smoke_hetero, to_np

WH, PHOTONS, LR, TV = 16, 600, 3e-2, 2e-3
CFG = dict(maxdepth=1, photonsperiteration=PHOTONS, initialbeamradius=0.18,
           grad_geometry=False, grad_extras=False)


def test_tv_prior_matches_jax():
    d = smoke_density(16)
    tv_j = lambda dd: TV * sum(jnp.mean(jnp.diff(dd, axis=a) ** 2)  # noqa: E731
                               for a in range(3))
    vj, gj = jax.value_and_grad(tv_j)(jnp.asarray(d))
    vt, gt = tinv.tv_prior(torch.from_numpy(d), TV)
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-5)
    gj = to_np(gj)
    assert np.abs(to_np(gt) - gj).max() <= 1e-5 * np.abs(gj).max()


def test_optimize_medium_density_tv_matches_jax():
    true = smoke_density(16)
    start = np.full_like(true, float(true.mean()))
    js = smoke_hetero(JBuilder(), density=start, g=0.3)
    ts = scene_from_jax(js, device="cpu")
    jc = jcam(jtfm.look_at(*SMOKE_LOOK), 50.0, WH, WH)
    tc = tcam(ttfm.look_at(*SMOKE_LOOK), 50.0, WH, WH, device="cpu")
    target = np.random.RandomState(0).uniform(
        0.0, 0.05, (WH, WH, 3)).astype(np.float32)
    inv = dict(steps=2, learning_rate=LR, n_devices=1,
               optimize=("density",), tv_weight=TV)
    # the reference's loop body (inverse.py:97-125), step by step; its
    # one-device train step is the photon trace and the camera pass of
    # iteration ``it`` (parallel/mesh.py:86-131 with one device)
    jcfg = jpb.PhotonBeamConfig(gather_chunk=256, **CFG,
                                tr_crossings=jcommon.default_tr_crossings(js))
    distr, radius = jdistr(js), jnp.float32(CFG["initialbeamradius"])

    @jax.jit
    @jax.value_and_grad
    def jstep(density, it):
        sc = js._replace(media=js.media._replace(density=density))
        beams, _ = jtrace(sc, distr, it, PHOTONS, CFG["maxdepth"], radius,
                          detach_sampling=True)
        Ld, _ = jpb.camera_pass(sc, jc, WH, WH, beams, radius, it, jcfg,
                                PHOTONS)
        return jnp.mean((Ld - jnp.asarray(target).reshape(-1, 3)) ** 2)

    # committed to the device, as the updated parameters will be, so the
    # step compiles once
    pj = {"density": jax.device_put(js.media.density, jax.devices()[0])}
    opt = optax.adam(LR)
    opt_state = opt.init({"density": pj["density"]})
    tv = lambda dd: TV * sum(jnp.mean(jnp.diff(dd, axis=a) ** 2)  # noqa: E731
                             for a in range(3))
    lj = []
    for it in range(2):
        loss, grad = jstep(pj["density"], jnp.uint32(it))
        tv_v, tv_g = jax.value_and_grad(tv)(pj["density"])
        upd, opt_state = opt.update({"density": grad + tv_g}, opt_state)
        new = optax.apply_updates({"density": pj["density"]}, upd)
        pj = dict(pj, density=jnp.maximum(new["density"], 0.0))
        lj.append(float(loss + tv_v))
    pt, lt = tinv.optimize_medium(ts, tc, WH, WH, torch.from_numpy(target),
                                  tpb.PhotonBeamConfig(**CFG),
                                  tinv.InverseConfig(**inv))
    assert len(lt) == len(lj) == 2
    np.testing.assert_allclose(lt, lj, rtol=5e-3)
    d_t, d_j = to_np(pt["density"]), to_np(pj["density"])
    assert (d_t >= 0).all() and np.abs(d_j - start).max() > LR / 2
    close = np.abs(d_t - d_j) <= 1e-4
    assert close.mean() >= 0.99, close.mean()
    assert np.abs(d_t - d_j).max() <= 4 * LR
    # density only: sigma_a, sigma_s and g stay where they were
    for k in ("sigma_a", "sigma_s", "g"):
        assert torch.equal(pt[k], getattr(ts.media, k))
