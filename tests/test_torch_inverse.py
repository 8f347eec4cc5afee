"""bre_tpu_torch inverse rendering vs bre_tpu: the one-device train step
(``make_inverse_train_step``) against the reference's on a one-device mesh,
and three Adam steps of ``optimize_medium`` against the reference's optax
loop, on the fog cube at 16x16 with 256 photons per iteration.

Tolerances and their reasons: as in test_torch_grad.py, both packages draw
every sample from bit-identical PCG32 streams, so they differ only where a
float-ulp difference flips a photon or camera-path decision and in the
order of float sums: loss within 5e-3 relative, gradients within
2e-3 * max|ref| (measured: loss 7.6e-7 relative, gradients 2.0e-6 *
max|ref|).  Adam's first steps move each parameter by about lr in the
direction of its gradient's sign, so the optimizer trajectories agree as
long as the gradients do: losses within 5e-3 relative, final parameters
within 1e-4 absolute (lr 2e-2); measured: losses within 4.2e-6 relative,
parameters within 4.1e-7."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bre_tpu.core import transform as jtfm
from bre_tpu.integrators import inverse as jinv
from bre_tpu.integrators import photonbeam as jpb
from bre_tpu.parallel import mesh as jmesh
from bre_tpu.scene.camera import make_perspective_camera as jcam
from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.integrators import inverse as tinv
from bre_tpu_torch.integrators import photonbeam as tpb
from bre_tpu_torch.parallel import mesh as tmesh
from bre_tpu_torch.scene.camera import make_perspective_camera as tcam
from bre_tpu_torch.scene.scene import scene_from_jax
from test_photonbeam import fog_cube_scene
from torch_parity import to_np

WH, PHOTONS = 16, 256
LOOK = ((0, 0, -3.2), (0, 0, 0), (0, 1, 0))
CFG = dict(maxdepth=2, photonsperiteration=PHOTONS, initialbeamradius=0.4,
           grad_geometry=False)
PARAMS = ("sigma_a", "sigma_s", "g")


def _setup():
    js = fog_cube_scene(sigma_a=0.1, sigma_s=0.3, g=0.2, intensity=1.0).build()
    jc = jcam(jtfm.look_at(*LOOK), 45.0, WH, WH)
    tc = tcam(ttfm.look_at(*LOOK), 45.0, WH, WH, device="cpu")
    target = np.random.RandomState(0).uniform(
        0.0, 0.05, (WH, WH, 3)).astype(np.float32)
    return js, scene_from_jax(js, device="cpu"), jc, tc, target


def _close_rel(t, j, rtol):
    t, j = to_np(t), to_np(j)
    assert np.abs(j).max() > 0
    assert np.abs(t - j).max() <= rtol * np.abs(j).max(), (t, j)


def test_train_step_matches_jax():
    js, ts, jc, tc, target = _setup()
    jstep = jmesh.make_inverse_train_step(
        js, jc, WH, WH, jpb.PhotonBeamConfig(**CFG), jmesh.make_mesh(1))
    jparams = {k: getattr(js.media, k) for k in PARAMS + ("density",)}
    lj, gj = jstep(jparams, jnp.asarray(target), jnp.uint32(3),
                   jnp.float32(0.4))
    tstep = tmesh.make_inverse_train_step(ts, tc, WH, WH,
                                          tpb.PhotonBeamConfig(**CFG))
    lt, gt = tstep({k: getattr(ts.media, k) for k in PARAMS},
                   torch.from_numpy(target), 3, 0.4)
    assert float(lj) > 0 and abs(float(lt) / float(lj) - 1.0) < 5e-3
    for k in PARAMS:
        assert torch.isfinite(gt[k]).all()
        _close_rel(gt[k], gj[k], 2e-3)


def test_optimize_medium_matches_jax():
    js, ts, jc, tc, target = _setup()
    inv = dict(steps=3, learning_rate=2e-2, n_devices=1)
    pj, lj = jinv.optimize_medium(js, jc, WH, WH, jnp.asarray(target),
                                  jpb.PhotonBeamConfig(**CFG),
                                  jinv.InverseConfig(**inv))
    seen = []
    pt, lt = tinv.optimize_medium(
        ts, tc, WH, WH, torch.from_numpy(target), tpb.PhotonBeamConfig(**CFG),
        tinv.InverseConfig(**inv),
        callback=lambda it, loss, params: seen.append((it, loss)))
    assert [i for i, _ in seen] == [0, 1, 2] and len(lt) == len(lj) == 3
    np.testing.assert_allclose(lt, lj, rtol=5e-3)
    for k in PARAMS:
        np.testing.assert_allclose(to_np(pt[k]), to_np(pj[k]), atol=1e-4)
    # sigma_a and sigma_s moved, g (not optimized) did not
    assert float((pt["sigma_s"] - ts.media.sigma_s).abs().max()) > 1e-3
    assert torch.equal(pt["g"], ts.media.g)


def test_unported_options_raise():
    _, ts, _, tc, target = _setup()
    cfg = tpb.PhotonBeamConfig(**CFG)
    tgt = torch.from_numpy(target)
    # several ranks need a process group (tests/test_torch_mesh*.py run
    # them): without one, the mesh of n > 1 ranks is refused
    with pytest.raises(ValueError, match="initialize_distributed"):
        tmesh.make_inverse_train_step(ts, tc, WH, WH, cfg, tmesh.make_mesh(2))
    with pytest.raises(ValueError, match="initialize_distributed"):
        tinv.optimize_medium(ts, tc, WH, WH, tgt, cfg,
                             tinv.InverseConfig(steps=1, n_devices=4))
    # the non-packed gather route is ported: the geometry-attached step
    # and the plain chunk scan run (their values against the reference:
    # tests/test_torch_train_step.py, test_torch_default_route_breadth.py)
    step = tmesh.make_inverse_train_step(
        ts, tc, WH, WH, tpb.PhotonBeamConfig(**{**CFG, "grad_geometry": True}))
    params = {k: getattr(ts.media, k) for k in PARAMS}
    loss, grads = step(params, tgt, 0, 0.4)
    assert float(loss) > 0
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert float(grads["sigma_s"].abs().max()) > 0
    _, losses = tinv.optimize_medium(
        ts, tc, WH, WH, tgt, tpb.PhotonBeamConfig(**{**CFG, "gather": "brute"}),
        tinv.InverseConfig(steps=1))
    assert len(losses) == 1 and np.isfinite(losses).all()
    # density grids are ported: a scene without one carries a (1,1,1)
    # brick that nothing reads, and its gradient is zero, as jax.grad's
    loss, grads = tmesh.make_inverse_train_step(ts, tc, WH, WH, cfg)(
        {**params, "density": ts.media.density}, tgt, 0, 0.4)
    assert float(loss) > 0 and not grads["density"].any()
