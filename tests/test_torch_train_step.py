"""bre_tpu_torch vs bre_tpu on the one-device training step at
``__graft_entry__.dryrun_multichip``'s config (__graft_entry__.py:68-92):
16x16, 256 photons, maxdepth 3, radius 0.3, gather_chunk 256, the default
route; loss = mean((render - 0)^2) and its gradients in sigma_a, sigma_s,
g and density.  Both configs set depth_scan=True: the reference then
compiles one depth-step body instead of an unrolled loop (its values do
not change; the port accepts the field and ignores it), which keeps this
file's JAX compile under a minute.

Tolerances: loss within 0.5% (a flipped path, tests/test_torch_render.py);
each gradient against its own max|ref| at 2e-4 (tests/test_pallas_gather.py:
97)."""

import jax.numpy as jnp
import numpy as np
import torch

from bre_tpu.core import transform as jtfm
from bre_tpu.integrators import photonbeam as jpb
from bre_tpu.parallel.mesh import make_inverse_train_step as jstep
from bre_tpu.parallel.mesh import make_mesh
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu.scene.camera import make_perspective_camera as jcam
from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.integrators import photonbeam as tpb
from bre_tpu_torch.parallel.mesh import make_inverse_train_step as tstep
from bre_tpu_torch.scene.builder import SceneBuilder as TBuilder
from bre_tpu_torch.scene.camera import make_perspective_camera as tcam
from test_torch_default_route import GRAD_RTOL, GRAFT_LOOK, _graft_scene
from torch_parity import to_np


def test_dryrun_multichip_one_device_step_matches():
    wh = 16
    cfg_kw = dict(maxdepth=3, photonsperiteration=256, initialbeamradius=0.3,
                  gather_chunk=256, depth_scan=True)
    js = _graft_scene(JBuilder(), wh)
    step_j = jstep(js, jcam(jtfm.look_at(*GRAFT_LOOK), 45.0, wh, wh), wh, wh,
                   jpb.PhotonBeamConfig(**cfg_kw), make_mesh(1))
    names = ("sigma_a", "sigma_s", "g", "density")
    loss_j, g_j = step_j({k: getattr(js.media, k) for k in names},
                         jnp.zeros((wh * wh, 3)), jnp.uint32(0),
                         jnp.float32(0.3))
    ts = _graft_scene(TBuilder(), wh, device="cpu")
    step_t = tstep(ts, tcam(ttfm.look_at(*GRAFT_LOOK), 45.0, wh, wh,
                            device="cpu"), wh, wh,
                   tpb.PhotonBeamConfig(**cfg_kw))
    loss_t, g_t = step_t({k: getattr(ts.media, k) for k in names},
                         torch.zeros((wh * wh, 3)), 0, 0.3)
    assert abs(float(loss_t) / float(loss_j) - 1.0) < 5e-3
    for k in names:
        t, j = to_np(g_t[k]), to_np(g_j[k])
        assert np.isfinite(t).all(), k
        if k == "density":  # no grid medium: the scene never reads it
            assert np.abs(t).max() == 0.0 == np.abs(j).max()
            continue
        assert np.abs(j).max() > 0, k
        assert np.abs(t - j).max() <= GRAD_RTOL * np.abs(j).max(), (k, t, j)
