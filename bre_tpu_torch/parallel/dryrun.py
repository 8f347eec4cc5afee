"""The multi-rank dry run: one sharded training step on n ranks against the
same step on one device (counterpart of ``__graft_entry__.dryrun_multichip``,
``__graft_entry__.py:56-103``).

``dryrun_multichip(n)`` spawns n processes (``torch.multiprocessing``), joins
them in a process group through a ``file://`` rendezvous in a fresh
temporary directory, runs ``make_inverse_train_step`` over the n-rank mesh,
then on rank 0 the same step on the one-device mesh, and holds the two to
the reference's invariant: loss within 1e-4 relative, the sigma_a gradient
within 1e-3 of the one-device step's max|sigma_a grad|.  The rank function
lives here, so the spawned processes import this package and nothing else.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..core import transform as tfm
from ..integrators.photonbeam import PhotonBeamConfig
from ..ops import gather as G
from ..ops import gather_bwd as GB
from ..scene.builder import SceneBuilder
from ..scene.camera import make_perspective_camera
from .mesh import Mesh, initialize_distributed, make_inverse_train_step

PARAMS = ("sigma_a", "sigma_s", "g", "density")
LOSS_RTOL, GRAD_RTOL = 1e-4, 1e-3  # __graft_entry__.py:92-99
# a rank that waits longer than this is stuck in a collective another rank
# never entered: the ranks are stopped and the run fails
JOIN_TIMEOUT_S = 600
# the kernel wrappers whose launch counts each rank reports
KERNELS = {"gather_forward": G.gather_forward,
           "gather_sparse": G.gather_sparse,
           "gather_backward_fused": GB.gather_backward_fused,
           "gather_backward_sparse": GB.gather_backward_sparse,
           "gather_backward_twopass": GB.gather_backward_twopass}


def _fog_scene(wh, device, g=0.0, wall=(0.6,) * 3, light_pos=(0.0, 0.0, 0.0),
               light_i=(1.0, 1.0, 1.0)):
    """A fog box lit from inside, a wall behind it (__graft_entry__.py:10-25;
    bench.py's variant has its own g, wall and light)."""
    b = SceneBuilder()
    fog = b.homogeneous_medium((0.05,) * 3, (0.5,) * 3, g)
    mat = b.matte(wall)
    b.box((-1, -1, -1), (1, 1, 1), material=-1, medium_inside=fog,
          medium_outside=-1)
    b.quad((-3, -3, 3.0), (-3, 3, 3.0), (3, 3, 3.0), (3, -3, 3.0),
           material=mat)
    b.point_light(light_pos, light_i, medium=fog)
    cam = make_perspective_camera(
        tfm.look_at((0, 0, -3.5), (0, 0, 0), (0, 1, 0)), 45.0, wh, wh,
        device=device)
    return b.build(device=device), cam


def _setup(size, device):
    """(scene, camera, wh, cfg, radius) of the dry run at ``size``: "graft",
    __graft_entry__.dryrun_multichip's 16x16 step (the default route,
    geometry attached), or "bench", bench.py's fog box at 128x128 and
    50,000 photons with the geometry detached (bench.py:63-93)."""
    if size == "graft":
        scene, cam = _fog_scene(16, device)
        cfg = PhotonBeamConfig(maxdepth=3, photonsperiteration=256,
                               initialbeamradius=0.3, gather_chunk=256)
        return scene, cam, 16, cfg, 0.3
    if size == "bench":
        scene, cam = _fog_scene(128, device, 0.3, (0.6, 0.5, 0.4),
                                (0.0, 0.3, 0.0), (1.0, 0.9, 0.8))
        cfg = PhotonBeamConfig(maxdepth=5, photonsperiteration=50_000,
                               initialbeamradius=0.2, gather="pallas",
                               gather_chunk=256, grad_geometry=False,
                               grad_extras=False)
        return scene, cam, 128, cfg, 0.2
    raise ValueError(f"dryrun_multichip: size {size!r} is not 'graft' or "
                     "'bench'")


def _timed_step(step, params, target, radius, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    loss, grads = step(params, target, 0, radius)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0, float(loss), {
        k: g.detach().cpu().numpy().astype(np.float64) for k, g in grads.items()}


def _rank_main(rank, n_devices, init_method, backend, device, size, tmp):
    """One rank: the n-rank step, its loss and this rank's kernel launches
    written to ``tmp/rank<r>.json``; rank 0 then runs the one-device step
    and writes both steps to ``tmp/result.json``."""
    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_devices))
    mesh = initialize_distributed(init_method, n_devices, rank, backend)
    try:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if device == "cuda" else torch.device(device))
        scene, cam, wh, cfg, radius = _setup(size, dev)
        params = {k: getattr(scene.media, k) for k in PARAMS}
        target = torch.zeros((wh * wh, 3), device=dev)
        step = make_inverse_train_step(scene, cam, wh, wh, cfg, mesh)
        for fn in KERNELS.values():
            fn.launches = 0
        t_n, loss, grads = _timed_step(step, params, target, radius, dev)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(dict(loss=loss, launches={
                k: fn.launches for k, fn in KERNELS.items()}), f)
        if rank == 0:
            step1 = make_inverse_train_step(scene, cam, wh, wh, cfg, Mesh())
            t_1, loss1, grads1 = _timed_step(step1, params, target, radius,
                                             dev)
            res = dict(n_devices=n_devices, backend=dist.get_backend(),
                       device=str(dev), size=size, loss=loss, loss_1=loss1,
                       step_s=t_n, step_1_s=t_1,
                       grad_max={k: float(np.abs(g).max())
                                 for k, g in grads.items()},
                       grad_max_1={k: float(np.abs(g).max())
                                   for k, g in grads1.items()},
                       grad_max_abs_diff={
                           k: float(np.abs(grads[k] - grads1[k]).max())
                           for k in grads},
                       bit_identical=loss == loss1 and all(
                           np.array_equal(grads[k], grads1[k])
                           for k in grads))
            with open(os.path.join(tmp, "result.json"), "w") as f:
                json.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, args, nprocs: int) -> None:
    """``fn(rank, *args)`` in ``nprocs`` spawned processes; raises what a
    rank raised, or TimeoutError (after stopping every rank) when they have
    not all finished within ``JOIN_TIMEOUT_S``."""
    ctx = mp.spawn(fn, args=args, nprocs=nprocs, join=False)
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{nprocs} ranks still running after "
                               f"{JOIN_TIMEOUT_S} s")


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend: Optional[str] = None,
                     size: str = "graft") -> dict:
    """One sharded training step on ``n_devices`` ranks against the same
    step on one device.  ``device`` "cuda" puts every rank on a card
    (``initialize_distributed`` picks which), "cpu" on the CPU; ``backend``
    None means NCCL with a card and gloo without.  Raises when the
    invariant fails or the ranks' losses differ; returns the losses, each
    gradient's max|diff| beside its max, the relative differences, the step
    times and each rank's kernel launches in its n-rank step."""
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(_rank_main,
                    (n_devices, "file://" + os.path.join(tmp, "rendezvous"),
                     backend, device, size, tmp), n_devices)
        with open(os.path.join(tmp, "result.json")) as f:
            res = json.load(f)
        ranks = []
        for r in range(n_devices):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    res["launches_per_rank"] = [r["launches"] for r in ranks]
    if any(r["loss"] != res["loss"] for r in ranks):
        raise AssertionError(f"dryrun_multichip({n_devices}): the ranks "
                             f"return different losses {ranks}")
    res["loss_rel"] = (abs(res["loss"] - res["loss_1"])
                       / max(abs(res["loss_1"]), 1e-12))
    res["grad_rel"] = {k: d / max(res["grad_max_1"][k], 1e-12)
                       for k, d in res["grad_max_abs_diff"].items()}
    if not (np.isfinite(res["loss"]) and res["grad_max"]["sigma_a"] > 0):
        raise AssertionError(f"dryrun_multichip({n_devices}): loss "
                             f"{res['loss']}, max|grad sigma_a| "
                             f"{res['grad_max']['sigma_a']}")
    if not res["loss_rel"] < LOSS_RTOL:
        raise AssertionError(f"dryrun_multichip({n_devices}): n-rank loss "
                             f"!= one-device loss (rel {res['loss_rel']})")
    if not res["grad_rel"]["sigma_a"] < GRAD_RTOL:
        raise AssertionError(f"dryrun_multichip({n_devices}): n-rank sigma_a "
                             "grad != one-device (rel "
                             f"{res['grad_rel']['sigma_a']})")
    return res
