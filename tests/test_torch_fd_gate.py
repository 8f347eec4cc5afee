"""bre_tpu_torch vs bre_tpu on the finite-difference gradient gate
(tests/test_gradients.py:84-126): the mean image of the fog cube at 12x12,
512 photons, maxdepth 3, radius 0.35, gather_chunk 512, the default route
with the photon walk and the gather geometry attached.  Both configs set
depth_scan=True: the reference then compiles one depth-step body instead
of an unrolled loop (its values do not change; the port accepts the field
and ignores it), which keeps this file's JAX compile under a minute.

Tolerances and their reasons: the port's gradient against jax.grad, each
cotangent against its own max|ref| at 2e-4 (tests/test_pallas_gather.py:
97; the recompute backward sums in pieces, in another order than XLA);
against the port's own central differences, the reference's criterion
|fd - ad| <= 0.12 max + 2e-4 (tests/test_gradients.py:118-121)."""

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
from bre_tpu_torch.scene.builder import SceneBuilder as TBuilder
from bre_tpu_torch.scene.camera import make_perspective_camera as tcam
from test_torch_default_route import GRAD_RTOL
from torch_parity import to_np


def _fd_scene(builder, sigma_a=0.1, sigma_s=0.5, **build_kw):
    """tests/test_photonbeam.py's fog_cube_scene(sigma_a=0.1,
    sigma_s=0.5, g=0.0, intensity=1.0) on either builder."""
    fog = builder.homogeneous_medium((sigma_a,) * 3, (sigma_s,) * 3, 0.0)
    builder.box((-1, -1, -1), (1, 1, 1), material=-1, medium_inside=fog,
                medium_outside=-1)
    builder.point_light((0.0, 0.0, 0.0), (1.0,) * 3, medium=fog)
    return builder.build(**build_kw)


def test_fd_gate_gradient_matches():
    wh, look = 12, ((0, 0, -3.2), (0, 0, 0), (0, 1, 0))
    cfg_kw = dict(maxdepth=3, photonsperiteration=512, initialbeamradius=0.35,
                  gather_chunk=512, depth_scan=True)
    js = _fd_scene(JBuilder())
    jc = jcam(jtfm.look_at(*look), 45.0, wh, wh)
    jcfg = jpb.PhotonBeamConfig(**cfg_kw)
    distr = jdistr(js)

    def jloss(sa, ss):
        sc = js._replace(media=js.media._replace(sigma_a=sa, sigma_s=ss))
        beams, _ = jtrace(sc, distr, jnp.uint32(0), 512, 3, jnp.float32(0.35))
        ld, _ = jpb.camera_pass(sc, jc, wh, wh, beams, jnp.float32(0.35),
                                jnp.uint32(0), jcfg, 512)
        return jnp.mean(ld)

    g_j = jax.grad(jloss, argnums=(0, 1))(js.media.sigma_a, js.media.sigma_s)
    ts = _fd_scene(TBuilder(), device="cpu")
    tc = tcam(ttfm.look_at(*look), 45.0, wh, wh, device="cpu")
    tcfg = tpb.PhotonBeamConfig(**cfg_kw)
    tdist = tdistr(ts)

    def tloss(sa, ss):
        sc = ts._replace(media=ts.media._replace(sigma_a=sa, sigma_s=ss))
        beams, _ = ttrace(sc, tdist, 0, 512, 3, 0.35, detach_sampling=False)
        ld, _ = tpb.camera_pass(sc, tc, wh, wh, beams, 0.35, 0, tcfg, 512)
        return ld.mean()

    sa = ts.media.sigma_a.clone().requires_grad_()
    ss = ts.media.sigma_s.clone().requires_grad_()
    g_t = torch.autograd.grad(tloss(sa, ss), [sa, ss])
    for t, j in zip(g_t, g_j):
        t, j = to_np(t), to_np(j)
        assert np.isfinite(t).all() and np.abs(j).max() > 0
        assert np.abs(t - j).max() <= GRAD_RTOL * np.abs(j).max(), (t, j)
    eps = 1e-3
    with torch.no_grad():
        for arg, g in ((0, g_t[0]), (1, g_t[1])):
            delta = torch.zeros_like(sa)
            delta[0, 0] = eps
            x = [sa.detach(), ss.detach()]
            xp, xm = list(x), list(x)
            xp[arg], xm[arg] = x[arg] + delta, x[arg] - delta
            fd = (float(tloss(*xp)) - float(tloss(*xm))) / (2 * eps)
            ad = float(g[0, 0])
            assert abs(fd - ad) <= 0.12 * max(abs(fd), abs(ad)) + 2e-4, (
                arg, fd, ad)
    assert float(g_t[0].sum()) < 0 < float(g_t[1].sum())
