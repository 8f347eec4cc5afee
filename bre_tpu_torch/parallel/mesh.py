"""One progressive iteration as a function of the medium parameters, and the
inverse-rendering train step built on it (counterpart of
``bre_tpu/parallel/mesh.py:55-183``), on one device.

The reference shards photons and pixels over a device mesh; the global
photon ids ``iter*photons + arange`` and pixel stream ids ``iter*R +
arange`` do not depend on the sharding, so the one-device iteration here
equals the reference's at any mesh size.  Several devices are ROADMAP
Queue 1 item 4 (multi-GPU) and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..integrators.common import default_tr_crossings
from ..integrators.photon_trace import trace_photon_beams_by_index
from ..integrators.photonbeam import PhotonBeamConfig, camera_pass_by_pixels
from ..lights import light_power_distribution
from ..scene.camera import Camera, pixel_centers
from ..scene.scene import Scene

_U32 = 0xFFFFFFFF


def check_devices(n_devices: Optional[int]) -> None:
    """None (the reference's "all devices") and 1 run on the scene's one
    device; more raise."""
    if n_devices is not None and n_devices > 1:
        raise NotImplementedError(
            f"n_devices={n_devices}: several devices are not ported (ROADMAP "
            "Queue 1 item 4: multi-GPU)")


def sharded_photonbeam_iteration(scene: Scene, camera: Camera, width: int,
                                 height: int, cfg: PhotonBeamConfig,
                                 light_distr, n_devices: Optional[int] = 1):
    """One photon-beam iteration on the scene's device.  Returns
    ``run(iter_idx, radius, scene_in=scene) -> Ld (R, 3)``; ``scene_in``
    carries the medium parameters, so gradients flow to its media."""
    check_devices(n_devices)
    if cfg.tr_crossings is None:
        cfg = dataclasses.replace(cfg, tr_crossings=default_tr_crossings(scene))
    R = width * height
    photons = cfg.photonsperiteration if cfg.photonsperiteration > 0 else R
    dev = scene.device
    p_raster = pixel_centers(width, height, dev)
    arange_p = torch.arange(photons, dtype=torch.int64, device=dev)
    arange_r = torch.arange(R, dtype=torch.int64, device=dev)

    def run(iter_idx, radius, scene_in: Scene = scene):
        photon_ids = (int(iter_idx) * photons + arange_p) & _U32
        beams, _ = trace_photon_beams_by_index(
            scene_in, light_distr, photon_ids, cfg.maxdepth, radius,
            # the detached estimator pairs with the detached gather geometry
            detach_sampling=not cfg.grad_geometry)
        stream_ids = (int(iter_idx) * R + arange_r) & _U32
        Ld, _ = camera_pass_by_pixels(scene_in, camera, p_raster, stream_ids,
                                      beams, radius, cfg,
                                      photons_per_iter=photons)
        return Ld

    return run


def make_inverse_train_step(scene: Scene, camera: Camera, width: int,
                            height: int, cfg: PhotonBeamConfig,
                            n_devices: Optional[int] = 1):
    """Training step for inverse rendering: loss = mean((render -
    target)^2) and its gradient with respect to the medium parameters.

    Returns ``step(params, target, iter_idx, radius) -> (loss, grads)`` with
    ``params`` a dict of sigma_a, sigma_s, g and (grid media) density
    tensors; ``grads`` has the same keys.  ``radius`` is rounded to float32,
    as the reference's is."""
    light_distr = light_power_distribution(scene)
    run = sharded_photonbeam_iteration(scene, camera, width, height, cfg,
                                       light_distr, n_devices)

    def step(params, target, iter_idx, radius):
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in params.items()}
        media = scene.media._replace(**leaves)
        rad32 = float(torch.tensor(float(radius), dtype=torch.float32))
        img = run(iter_idx, rad32, scene._replace(media=media))
        loss = torch.mean((img - target.reshape(-1, 3)) ** 2)
        # a parameter the scene does not read (the (1,1,1) density of a
        # scene without a grid medium) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        return loss.detach(), {
            k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(leaves.items(), grads)}

    return step
