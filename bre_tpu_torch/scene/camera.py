"""Perspective camera and vectorized ray generation (counterpart of
``bre_tpu/scene/camera.py``; pbrt perspective.cpp GenerateRay)."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core import transform as tfm
from ..core.math import normalize
from .scene import resolve_device


class Camera(NamedTuple):
    camera_to_world: torch.Tensor  # (4,4)
    raster_to_camera: torch.Tensor  # (4,4)


def make_perspective_camera(camera_to_world, fov_deg: float, width: int,
                            height: int, device="cuda") -> Camera:
    """pbrt's ProjectiveCamera screen window: [-1,1] on the shorter axis,
    scaled by the aspect on the longer (api.cpp:651-680).  The matrices are
    built in numpy with the reference's exact arithmetic."""
    aspect = width / height
    if aspect > 1.0:
        sx0, sx1, sy0, sy1 = -aspect, aspect, -1.0, 1.0
    else:
        sx0, sx1, sy0, sy1 = -1.0, 1.0, -1.0 / aspect, 1.0 / aspect
    cam_to_screen = tfm.perspective(fov_deg, 1e-2, 1000.0).numpy()
    screen_to_raster = (
        np.diag([width / (sx1 - sx0), height / (sy0 - sy1), 1.0, 1.0]).astype(np.float32)
        @ np.array(
            [[1, 0, 0, -sx0], [0, 1, 0, -sy1], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32
        )
    )
    raster_to_screen = np.linalg.inv(screen_to_raster)
    raster_to_camera = np.linalg.inv(cam_to_screen) @ raster_to_screen
    c2w = np.asarray(camera_to_world, np.float32)
    device = resolve_device(device)
    return Camera(
        camera_to_world=torch.as_tensor(c2w, device=device),
        raster_to_camera=torch.as_tensor(raster_to_camera.astype(np.float32),
                                         device=device),
    )


def generate_rays(camera: Camera,
                  p_raster: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raster positions (R,2) -> world-space (origins, unit directions) of a
    pinhole perspective camera."""
    R = p_raster.shape[0]
    zeros = torch.zeros((R, 1), dtype=torch.float32, device=p_raster.device)
    p_cam = tfm.apply_point(camera.raster_to_camera,
                            torch.cat([p_raster, zeros], -1))
    d = normalize(p_cam)
    o = torch.zeros_like(d)
    o_w = tfm.apply_point(camera.camera_to_world, o)
    d_w = normalize(tfm.apply_vector(camera.camera_to_world, d))
    return o_w, d_w


def generate_rays_weighted(camera: Camera, p_raster: torch.Tensor,
                           u_lens=None):
    """``generate_rays`` with per-ray weights (camera.py:459-487): 1 for the
    pinhole perspective camera, the only one ported (the lens sample is
    read by the thin lens and the lens systems, ROADMAP Queue 1 item 5).
    Returns (origins, unit directions, weights (R,))."""
    o, d = generate_rays(camera, p_raster)
    return o, d, torch.ones((p_raster.shape[0],), dtype=torch.float32,
                            device=p_raster.device)


def pixel_centers(width: int, height: int, device="cpu") -> torch.Tensor:
    """(H*W, 2) raster positions at pixel centers (x+.5, y+.5), row-major."""
    xs = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    ys = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)
