"""Inverse rendering: recover medium parameters from target images
(counterpart of ``bre_tpu/integrators/inverse.py``).

Each optimizer step renders one progressive iteration with a fresh photon
seed (a stochastic gradient over photon populations) and takes one Adam
step on mean((render - target)^2), plus, when the density grid of a grid
medium is fitted, ``tv_weight`` times its total-variation prior.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..integrators.photonbeam import PhotonBeamConfig
from ..parallel.mesh import make_inverse_train_step, make_mesh
from ..scene.camera import Camera
from ..scene.scene import Scene
from ..utils.stats import profile_phase


@dataclasses.dataclass(frozen=True)
class InverseConfig:
    steps: int = 100
    learning_rate: float = 2e-2
    # None: every rank of the process group, or the scene's one device
    # without a group (parallel.mesh.make_mesh)
    n_devices: Optional[int] = None
    optimize: tuple = ("sigma_a", "sigma_s")  # subset of params to fit
    # total-variation prior on the density grid, loss += tv_weight *
    # sum over axes of mean(diff(density)^2); applies when density is fitted
    tv_weight: float = 0.0
    view_block: int = 25  # consecutive steps per view before cycling


def tv_prior(density: torch.Tensor, weight: float):
    """(weight * TV, its gradient) of a density grid, TV = the sum over the
    three axes of mean(diff(density)^2) (inverse.py:97-110)."""
    d = density.detach().requires_grad_()
    tv = sum(torch.mean(torch.diff(d, dim=ax) ** 2) for ax in range(3))
    (grad,) = torch.autograd.grad(weight * tv, d)
    return (weight * tv).detach(), grad


def optimize_medium(scene: Scene, camera, width: int, height: int, target,
                    render_cfg: PhotonBeamConfig,
                    inv_cfg: InverseConfig = InverseConfig(),
                    init_params: Optional[Dict[str, torch.Tensor]] = None,
                    callback: Optional[Callable] = None):
    """Adam descent on mean((render(params) - target)^2); parameters are
    clamped to >= 0 after each step.  Returns (params, losses).  Over
    several ranks every rank holds the same gradients, so every rank takes
    the same steps.

    ``camera``/``target`` may be lists of matching length: steps then cycle
    through the views, ``view_block`` steps per view."""
    mesh = make_mesh(inv_cfg.n_devices)
    cameras = [camera] if isinstance(camera, Camera) else list(camera)
    targets = [target] if len(cameras) == 1 and not isinstance(
        target, (list, tuple)) else list(target)
    if len(cameras) != len(targets):
        raise ValueError(f"{len(cameras)} cameras but {len(targets)} targets")
    step_fns = [make_inverse_train_step(scene, c, width, height, render_cfg,
                                        mesh) for c in cameras]
    dev = scene.device
    params = init_params or dict(sigma_a=scene.media.sigma_a,
                                 sigma_s=scene.media.sigma_s, g=scene.media.g,
                                 density=scene.media.density)
    params = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
              .detach().clone() for k, v in params.items()}
    # torch's Adam with eps=1e-8 is optax.adam's update lr*m_hat /
    # (sqrt(v_hat) + eps) (b1 0.9, b2 0.999, eps_root 0)
    fitted = [params[k].requires_grad_() for k in inv_cfg.optimize]
    opt = torch.optim.Adam(fitted, lr=inv_cfg.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    targets_flat = [torch.as_tensor(t, dtype=torch.float32, device=dev)
                    .reshape(-1, 3) for t in targets]
    radius = float(np.float32(render_cfg.initialbeamradius))
    losses_dev = []
    for it in range(inv_cfg.steps):
        vi = (it // max(inv_cfg.view_block, 1)) % len(cameras)
        loss, grads = step_fns[vi](params, targets_flat[vi], it, radius)
        with profile_phase("bre.optimizer"):
            if inv_cfg.tv_weight > 0.0 and "density" in inv_cfg.optimize:
                tv, tv_grad = tv_prior(params["density"], inv_cfg.tv_weight)
                loss = loss + tv
                grads = dict(grads, density=grads["density"] + tv_grad)
            opt.zero_grad(set_to_none=True)
            for k, p in zip(inv_cfg.optimize, fitted):
                p.grad = grads[k]
            opt.step()
            with torch.no_grad():
                for p in fitted:
                    p.clamp_(min=0.0)  # physical non-negativity
        losses_dev.append(loss)
        if callback is not None:
            callback(it, float(loss), params)
    losses = [float(v) for v in losses_dev]
    return {k: v.detach() for k, v in params.items()}, losses
