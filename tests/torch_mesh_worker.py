"""Rank processes for the bre_tpu_torch multi-rank tests
(tests/test_torch_mesh*.py).  This module imports no JAX: the ranks are
spawned processes, and each imports it to find its case.

``run_ranks(n, case, kw)`` spawns n processes, joins them in a gloo process
group through ``initialize_distributed`` (a ``file://`` rendezvous in a
fresh temporary directory unless ``init`` names another), runs
``CASES[case](mesh, **kw)`` on each rank and returns every rank's result; a
deadlocked collective fails the run after
``parallel.dryrun.JOIN_TIMEOUT_S``.
"""

import os
import tempfile

import torch
import torch.distributed as dist

from bre_tpu_torch.core import transform as tfm
from bre_tpu_torch.integrators.photonbeam import PhotonBeamConfig
from bre_tpu_torch.lights import light_power_distribution
from bre_tpu_torch.parallel.dryrun import _fog_scene, spawn_ranks
from bre_tpu_torch.parallel.mesh import (Mesh, initialize_distributed,
                                         make_inverse_train_step,
                                         sharded_photonbeam_iteration)
from bre_tpu_torch.scene.camera import make_perspective_camera

GRAFT_LOOK = ((0, 0, -3.5), (0, 0, 0), (0, 1, 0))
PARAMS = ("sigma_a", "sigma_s", "g", "density")


# __graft_entry__.dryrun_multichip's config (the default route, the
# geometry attached); depth_scan as in tests/test_torch_train_step.py (the
# port ignores it)
GRAFT_CFG = dict(maxdepth=3, photonsperiteration=256, initialbeamradius=0.3,
                 gather_chunk=256, depth_scan=True)


def graft_step(mesh, width, height, cfg, one_device=False, look=GRAFT_LOOK):
    """The graft scene's train step (target 0, iteration 0, the config's
    radius) and its rendered image over ``mesh``, seen from ``look``; with
    ``one_device`` the same on the one-device mesh too."""
    scene, _ = _fog_scene(2, "cpu")
    cam = make_perspective_camera(tfm.look_at(*look), 45.0, width, height,
                                  device="cpu")
    radius = cfg["initialbeamradius"]
    cfg = PhotonBeamConfig(**cfg)
    params = {k: getattr(scene.media, k) for k in PARAMS}
    target = torch.zeros((width * height, 3))
    out = {}
    for tag, m in [("", mesh)] + ([("_1", Mesh())] if one_device else []):
        step = make_inverse_train_step(scene, cam, width, height, cfg, m)
        loss, grads = step(params, target, 0, radius)
        run = sharded_photonbeam_iteration(scene, cam, width, height, cfg, m,
                                           light_power_distribution(scene))
        with torch.no_grad():
            image = run(0, radius)
        out.update({"loss" + tag: loss, "grads" + tag: grads,
                    "image" + tag: image})
    out.update(rank=mesh.rank, size=mesh.size)
    return out


CASES = {"graft_step": graft_step}


def _rank(rank, n, init, backend, case, kw, tmp):
    torch.set_num_threads(1)  # as tests/torch_parity.py
    mesh = initialize_distributed(init, n, rank, backend)
    try:
        torch.save(CASES[case](mesh, **kw), os.path.join(tmp, f"{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(n, case, kw, init=None, backend="gloo"):
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(_rank, (n, init or "file://" + os.path.join(tmp, "rdv"),
                            backend, case, kw, tmp), n)
        return [torch.load(os.path.join(tmp, f"{r}.pt")) for r in range(n)]
