"""Ranks of a ``torch.distributed`` process group as a 1-D device mesh: the
sharded photon-beam iteration and the inverse-rendering train step built
on it (counterpart of ``bre_tpu/parallel/mesh.py``).

The reference's design, with every collective written out:
- photons sharded over the ranks: rank r traces its slice of the global
  photon ids ``iter*photons + r*photons/n + arange`` (the streams depend
  on the global id only, so the union of the slices is the one-device
  photon map);
- the beams all-gathered along axis 0, rank-major (``_AllGatherBeams``),
  a replicated photon map;
- camera rays sharded: rank r gathers raster rows ``[r*shard, (r+1)*shard)``
  with stream ids ``iter*R_pad + r*shard + arange``;
- gradients: the all-gather's backward reduce-scatters (sums) the beam
  cotangents, so each rank gets the summed cotangent of the beams it
  traced, and the train step all-reduces (sums) the parameter gradients of
  the ranks' partial losses.  The reference gets both from the shard_map
  transpose.

One process per rank (``initialize_distributed``, or torchrun); without a
process group the mesh is the scene's one device, and every collective is
skipped.  At n ranks the beams reach the gather in another order than on
one device, so the sums add in another order: the n-rank step equals the
one-device step within float tolerances, not bit for bit.  A one-rank group
gives the one-device bits.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..integrators.common import default_tr_crossings
from ..integrators.photon_trace import Beams, trace_photon_beams_by_index
from ..integrators.photonbeam import PhotonBeamConfig, camera_pass_by_pixels
from ..lights import light_power_distribution
from ..scene.camera import Camera, pixel_centers
from ..scene.scene import Scene

_U32 = 0xFFFFFFFF
# the beam fields that can carry a gradient; ``medium`` and ``valid`` never
# do
_FLOAT_FIELDS = ("start", "end", "power_start", "power_end", "radius")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a 1-D mesh: its ``rank`` of ``size`` in
    ``group``.  ``Mesh()`` is the one-device mesh (no group, no
    collectives).  ``device`` is the device the group's collectives need
    (the current CUDA device under NCCL); None means any (gloo takes CPU and
    CUDA tensors, the one-device mesh runs on the scene's device)."""

    group: Optional[dist.ProcessGroup] = None
    rank: int = 0
    size: int = 1
    device: Optional[torch.device] = None


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The mesh over every rank of the initialized process group (its
    world size; ``n_devices``, if given, must equal it), or the one-device
    mesh when no group is initialized and ``n_devices`` is None or 1.

    Stricter than the reference's ``devs[:n]``: a torch process sees no
    in-process list of devices to slice, so n ranks need a group of n."""
    if not (dist.is_available() and dist.is_initialized()):
        if n_devices is None or n_devices == 1:
            return Mesh()
        raise ValueError(
            f"make_mesh({n_devices}): no process group is initialized; start "
            "one process per rank and call initialize_distributed (or run "
            "under torchrun) first")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"make_mesh({n_devices}): the process group has {size} ranks; "
            "initialize_distributed sets the number of ranks")
    device = None
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(dist.group.WORLD, dist.get_rank(), size, device)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> Mesh:
    """Join this process to the process group and return ``make_mesh()``.

    Wraps ``torch.distributed.init_process_group``: ``coordinator_address``
    ``host:port`` rendezvous over ``tcp://`` (a full URL such as
    ``file://...`` is taken as it is); None means ``env://``, the variables
    torchrun sets.  ``num_processes`` and ``process_id`` default to
    ``WORLD_SIZE`` and ``RANK``.  ``backend`` None means "nccl" when the
    process sees a CUDA card and "gloo" when it does not; it is never
    switched afterwards.  On a card the process takes the CUDA device of
    its local rank (``LOCAL_RANK``, else its rank): NCCL needs one card per
    rank on the host and raises with fewer, gloo ranks share the cards
    round-robin.  A process already in a group gets its mesh."""
    if dist.is_initialized():
        return make_mesh()
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    world = (num_processes if num_processes is not None
             else int(os.environ.get("WORLD_SIZE", "1")))
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", "0")))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl":
        if local_world > n_cards:
            raise ValueError(
                f"initialize_distributed: NCCL needs one CUDA card per rank; "
                f"{local_world} ranks on this host, {n_cards} cards visible")
        torch.cuda.set_device(local_rank)
    elif n_cards:
        torch.cuda.set_device(local_rank % n_cards)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    return make_mesh()


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Concatenate every rank's ``x`` along axis 0, rank-major."""
    out = x.new_empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.group)
    return out


def _reduce_scatter(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``x`` over the ranks and keep this rank's slice of axis 0."""
    out = x.new_empty((x.shape[0] // mesh.size,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), op=dist.ReduceOp.SUM,
                               group=mesh.group)
    return out


class _AllGatherBeams(torch.autograd.Function):
    """All-gather of the beams' float fields along axis 0, rank-major (the
    reference's ``all_gather(..., tiled=True)``); the backward reduce-scatters
    their cotangents, so each rank gets back the sum over every rank's
    camera pass of the cotangent of the beams it traced."""

    @staticmethod
    def forward(ctx, mesh, *fields):
        ctx.mesh = mesh
        return tuple(_all_gather(x, mesh) for x in fields)

    @staticmethod
    def backward(ctx, *cts):
        # cotangents arrive materialized (zeros where an output got none),
        # so every rank runs the same collectives
        return (None,) + tuple(_reduce_scatter(ct, ctx.mesh) for ct in cts)


class _Anchor(torch.autograd.Function):
    """A zero that depends on the gathered beams, added to each rank's
    camera-pass output: a rank whose pixels never gather (no ray in a
    medium) still reaches ``_AllGatherBeams.backward``, which every rank
    must enter for the reduce-scatter to complete."""

    @staticmethod
    def forward(ctx, *fields):
        ctx.shapes = [(f.shape, f.dtype, f.device) for f in fields]
        return fields[0].new_zeros(())

    @staticmethod
    def backward(ctx, _ct):
        return tuple(torch.zeros(s, dtype=dt, device=dv)
                     for s, dt, dv in ctx.shapes)


def _all_gather_beams(beams: Beams, mesh: Mesh) -> Beams:
    """Every rank's beams, rank-major, differentiable in the float fields
    that carry a gradient (the same fields on every rank).  The one-device
    mesh returns ``beams`` itself."""
    if mesh.group is None:
        return beams
    diff = [k for k in _FLOAT_FIELDS if getattr(beams, k).requires_grad]
    out = dict(zip(diff, _AllGatherBeams.apply(
        mesh, *(getattr(beams, k) for k in diff))))
    for k in beams._fields:
        if k not in out:  # valid travels as bool: gloo and NCCL carry it
            out[k] = _all_gather(getattr(beams, k), mesh)
    return Beams(**out)


def _iteration(scene: Scene, camera: Camera, width: int, height: int,
               cfg: PhotonBeamConfig, mesh: Mesh, light_distr):
    """(run_shard, run) of ``sharded_photonbeam_iteration``."""
    if mesh.device is not None and scene.device != mesh.device:
        raise ValueError(f"the scene is on {scene.device}; the mesh's "
                         f"collectives need {mesh.device}")
    if cfg.tr_crossings is None:
        cfg = dataclasses.replace(cfg, tr_crossings=default_tr_crossings(scene))
    n, rank = mesh.size, mesh.rank
    R = width * height
    photons = cfg.photonsperiteration if cfg.photonsperiteration > 0 else R
    photons = _round_up(photons, n)
    R_pad = _round_up(R, n)
    shard, p_shard = R_pad // n, photons // n
    lo, hi = min(rank * shard, R), min((rank + 1) * shard, R)
    dev = scene.device
    p_raster = pixel_centers(width, height, dev)
    if R_pad != R:
        p_raster = torch.cat(
            [p_raster, p_raster.new_zeros((R_pad - R, 2))], 0)
    p_raster = p_raster[rank * shard:(rank + 1) * shard]
    arange_p = torch.arange(p_shard, dtype=torch.int64, device=dev) \
        + rank * p_shard
    arange_r = torch.arange(shard, dtype=torch.int64, device=dev) \
        + rank * shard

    def run_shard(iter_idx, radius, scene_in: Scene = scene):
        """(Ld of raster rows [lo, hi), lo, hi): this rank's unpadded rows."""
        photon_ids = (int(iter_idx) * photons + arange_p) & _U32
        beams, _ = trace_photon_beams_by_index(
            scene_in, light_distr, photon_ids, cfg.maxdepth, radius,
            # the detached estimator pairs with the detached gather geometry
            detach_sampling=not cfg.grad_geometry)
        beams = _all_gather_beams(beams, mesh)
        stream_ids = (int(iter_idx) * R_pad + arange_r) & _U32
        Ld, _ = camera_pass_by_pixels(scene_in, camera, p_raster, stream_ids,
                                      beams, radius, cfg,
                                      photons_per_iter=photons)
        linked = [getattr(beams, k) for k in _FLOAT_FIELDS
                  if getattr(beams, k).requires_grad]
        if mesh.group is not None and linked:
            Ld = Ld + _Anchor.apply(*linked)
        return Ld[:hi - lo], lo, hi

    def run(iter_idx, radius, scene_in: Scene = scene):
        Ld, _, _ = run_shard(iter_idx, radius, scene_in)
        if mesh.group is None:
            return Ld
        # forward only: the train step differentiates each rank's own rows
        Ld = Ld.detach()
        padded = Ld.new_zeros((shard, 3))
        padded[:Ld.shape[0]] = Ld
        return _all_gather(padded, mesh)[:R]

    return run_shard, run


def sharded_photonbeam_iteration(scene: Scene, camera: Camera, width: int,
                                 height: int, cfg: PhotonBeamConfig,
                                 mesh: Optional[Mesh], light_distr):
    """One photon-beam iteration over ``mesh`` (None: the one-device mesh).
    Returns ``run(iter_idx, radius, scene_in=scene) -> Ld (R, 3)``, the
    whole image on every rank; ``scene_in`` carries the medium parameters.
    On the one-device mesh gradients flow to its media; over a group the
    image is gathered forward only (``make_inverse_train_step``
    differentiates)."""
    return _iteration(scene, camera, width, height, cfg, mesh or Mesh(),
                      light_distr)[1]


def make_inverse_train_step(scene: Scene, camera: Camera, width: int,
                            height: int, cfg: PhotonBeamConfig,
                            mesh: Optional[Mesh] = None):
    """Training step for inverse rendering over ``mesh`` (None: the
    one-device mesh): loss = mean((render - target)^2) and its gradient
    with respect to the medium parameters.

    Returns ``step(params, target, iter_idx, radius) -> (loss, grads)`` with
    ``params`` a dict of sigma_a, sigma_s, g and (grid media) density
    tensors; ``grads`` has the same keys.  Every rank returns the same loss
    and gradients.  ``radius`` is rounded to float32, as the reference's
    is.

    Each rank differentiates its partial loss, the sum of (Ld - target)^2
    over its own unpadded rows over 3R; the partials add up to the loss, so
    the sum of the ranks' gradients is its gradient.  (Differentiating the
    loss of the gathered image on every rank would count it n times.)"""
    mesh = mesh or Mesh()
    light_distr = light_power_distribution(scene)
    run_shard, _ = _iteration(scene, camera, width, height, cfg, mesh,
                              light_distr)
    R = width * height

    def step(params, target, iter_idx, radius):
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in params.items()}
        media = scene.media._replace(**leaves)
        rad32 = float(torch.tensor(float(radius), dtype=torch.float32))
        Ld, lo, hi = run_shard(iter_idx, rad32, scene._replace(media=media))
        partial = torch.sum((Ld - target.reshape(-1, 3)[lo:hi]) ** 2) / (3 * R)
        # a parameter the scene does not read (the (1,1,1) density of a
        # scene without a grid medium) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(partial, list(leaves.values()),
                                    allow_unused=True)
        grads = [torch.zeros_like(v) if g is None else g
                 for v, g in zip(leaves.values(), grads)]
        loss = partial.detach()
        if mesh.group is not None:
            # one all-reduce (sum) of the loss and every gradient
            flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
            loss = flat[0]
            sizes = [g.numel() for g in grads]
            grads = [f.reshape(g.shape) for f, g in
                     zip(torch.split(flat[1:], sizes), grads)]
        return loss, dict(zip(leaves, grads))

    return step
