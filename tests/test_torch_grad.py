"""bre_tpu_torch medium-parameter gradients vs bre_tpu: one forward+backward
iteration (trace_photon_beams with detached sampling + camera_pass through
the packed gather) differentiated with torch.autograd and with jax.grad on
the same scene, photon and camera streams.

Tolerances and their reasons: the two packages draw every sample from
bit-identical PCG32 streams, so loss and gradients differ only where a
float-ulp difference (XLA contracts multiply-adds and has its own exp, log,
sin and cos) flips a photon or camera-path decision, and in the order of
float sums.  One flipped path of the fog cube's 512 photons moves the loss
by about 1/500 of itself at most, so the loss must agree within 5e-3
relative and each gradient within 2e-3 * max|ref|; measured on this scene:
loss within 2.2e-7 relative, gradients within 1.1e-6 * max|ref| (no path
flipped)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bre_tpu.core import transform as jtfm
from bre_tpu.integrators import photonbeam as jpb
from bre_tpu.integrators.photon_trace import trace_photon_beams as jtrace
from bre_tpu.lights import light_power_distribution as jdistr
from bre_tpu.scene.camera import make_perspective_camera as jcam
from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.integrators import photonbeam as tpb
from bre_tpu_torch.integrators.photon_trace import trace_photon_beams as ttrace
from bre_tpu_torch.lights import light_power_distribution as tdistr
from bre_tpu_torch.scene.builder import SceneBuilder as TBuilder
from bre_tpu_torch.scene.camera import make_perspective_camera as tcam
from bre_tpu_torch.scene.scene import scene_from_jax
from test_photonbeam import fog_cube_scene
from torch_parity import cornell_fog, to_np

WH, PHOTONS, MAXDEPTH, RADIUS = 12, 512, 3, 0.35  # tests/test_gradients.py:84
LOOK = ((0, 0, -3.2), (0, 0, 0), (0, 1, 0))
PARAMS = ("sigma_a", "sigma_s", "g")


def _jax_loss(scene, cfg):
    cam = jcam(jtfm.look_at(*LOOK), 45.0, WH, WH)
    distr = jdistr(scene)

    @jax.jit
    def loss(params):
        sc = scene._replace(media=scene.media._replace(**params))
        beams, _ = jtrace(sc, distr, jnp.uint32(0), PHOTONS, MAXDEPTH,
                          jnp.float32(RADIUS), detach_sampling=True)
        Ld, _ = jpb.camera_pass(sc, cam, WH, WH, beams, jnp.float32(RADIUS),
                                jnp.uint32(0), cfg, PHOTONS)
        return jnp.mean(Ld)

    return loss


def torch_loss_and_grads(scene, cam, wh, cfg, photons, iter_idx=0,
                         params=PARAMS):
    """mean(Ld) of one iteration and its gradient with respect to the
    medium parameters ``params``."""
    leaves = {k: getattr(scene.media, k).detach().clone().requires_grad_()
              for k in params}
    sc = scene._replace(media=scene.media._replace(**leaves))
    radius = cfg.initialbeamradius
    beams, _ = ttrace(sc, tdistr(sc), iter_idx, photons, cfg.maxdepth, radius,
                      detach_sampling=True)
    Ld, _ = tpb.camera_pass(sc, cam, wh, wh, beams, radius, iter_idx, cfg,
                            photons)
    loss = Ld.mean()
    grads = torch.autograd.grad(loss, [leaves[k] for k in params])
    return float(loss.detach()), dict(zip(params, grads))


@pytest.mark.parametrize("grad_extras", [True, False])
def test_fog_cube_gradients_match_jax(grad_extras):
    """d mean(Ld) / d (sigma_a, sigma_s, g) on the fog cube of
    tests/test_gradients.py:84-125 (g = 0.3 so the phase function has a
    slope), against jax.grad of the same function; the sign check of
    test_gradients.py:124-125."""
    kw = dict(maxdepth=MAXDEPTH, photonsperiteration=PHOTONS,
              initialbeamradius=RADIUS, grad_geometry=False,
              grad_extras=grad_extras)
    js = fog_cube_scene(sigma_a=0.1, sigma_s=0.5, g=0.3, intensity=1.0).build()
    jloss = _jax_loss(js, jpb.PhotonBeamConfig(**kw))
    jparams = {k: getattr(js.media, k) for k in PARAMS}
    lj, gj = jax.value_and_grad(jloss)(jparams)

    ts = scene_from_jax(js, device="cpu")
    cfg = tpb.PhotonBeamConfig(**kw)
    cam = tcam(ttfm.look_at(*LOOK), 45.0, WH, WH, device="cpu")
    lt, gt = torch_loss_and_grads(ts, cam, WH, cfg, PHOTONS)

    assert float(lj) > 0 and abs(lt / float(lj) - 1.0) < 5e-3
    for k in PARAMS:
        j, t = to_np(gj[k]), to_np(gt[k])
        assert np.isfinite(t).all(), k
        if k == "g" and not grad_extras:
            assert np.abs(t).max() == np.abs(j).max() == 0.0
            continue
        assert np.abs(j).max() > 0, k
        err = np.abs(t - j).max()
        assert err <= 2e-3 * np.abs(j).max(), (k, err, np.abs(j).max())
    # more absorption -> dimmer, more scattering -> brighter in-scatter
    assert float(gt["sigma_a"].sum()) < 0 and float(gt["sigma_s"].sum()) > 0


def test_cornell_gradients_sparse_equal_dense():
    """The Cornell cut of test_torch_render.py (32x32, 4,000 photons),
    differentiated once with every sweep on the dense kernels
    (gather="pallas", no sparse cap) and once with the sparse cap at the
    block grid (full-film sweeps forward and backward on the sparse
    kernels): the same live blocks in the same order, so equal gradients."""
    W, P = 32, 4000
    scene = cornell_fog(TBuilder(), device="cpu")
    cam = tcam(ttfm.look_at((0, 0, -2.2), (0, 0, 1), (0, 1, 0)), 50.0, W, W,
               device="cpu")
    base = dict(maxdepth=5, photonsperiteration=P, initialbeamradius=0.12,
                grad_geometry=False,
                tr_crossings=tpb.default_tr_crossings(scene))
    n_blocks = -(-P * 7 // 256) * (W * W // 256)
    out = []
    for cfg in (tpb.PhotonBeamConfig(gather="pallas", **base),
                tpb.PhotonBeamConfig(gather="auto", gather_sparse_cap=n_blocks,
                                     **base)):
        out.append(torch_loss_and_grads(scene, cam, W, cfg, P, iter_idx=1))
    (l0, g0), (l1, g1) = out
    assert l0 > 0 and l0 == l1
    for k in PARAMS:
        assert torch.isfinite(g0[k]).all() and float(g0[k].abs().max()) > 0
        assert torch.equal(g0[k], g1[k]), k
