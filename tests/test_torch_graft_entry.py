"""bre_tpu_torch vs bre_tpu on ``__graft_entry__.entry()``, the repo's
declared flagship step: one progressive iteration (photon trace, camera
pass) on the fog cube at its own config (32x32, 1,024 photons, maxdepth 4,
radius 0.25, gather_chunk 1024, the default route).  Tolerances: those of
tests/test_torch_default_route.py."""

import jax

from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.integrators import photonbeam as tpb
from bre_tpu_torch.integrators.photon_trace import trace_photon_beams as ttrace
from bre_tpu_torch.lights import light_power_distribution as tdistr
from bre_tpu_torch.scene.builder import SceneBuilder as TBuilder
from bre_tpu_torch.scene.camera import make_perspective_camera as tcam
from test_torch_default_route import GRAFT_LOOK, _graft_scene, _images_agree


def test_graft_entry_forward_step_matches():
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    ld_j = jax.jit(fn)(*args)
    wh = 32
    scene = _graft_scene(TBuilder(), wh, device="cpu")
    cam = tcam(ttfm.look_at(*GRAFT_LOOK), 45.0, wh, wh, device="cpu")
    cfg = tpb.PhotonBeamConfig(maxdepth=4, photonsperiteration=1024,
                               initialbeamradius=0.25, gather_chunk=1024)
    beams, _ = ttrace(scene, tdistr(scene), 0, 1024, 4, 0.25)
    ld_t, _ = tpb.camera_pass(scene, cam, wh, wh, beams, 0.25, 0, cfg,
                              photons_per_iter=1024)
    _images_agree(ld_t, ld_j)
