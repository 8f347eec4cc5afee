"""Perspective camera: vectorized ray generation and, for the camera
endpoint of bidirectional paths, the importance queries ``pdf_we`` and
``sample_wi`` (counterpart of ``bre_tpu/scene/camera.py``; pbrt
perspective.cpp GenerateRay, Pdf_We, Sample_Wi).  Perspective is the only
camera the port builds (the parser raises on the others, ROADMAP Queue 1
item 5), as it is the only one pbrt-v3 gives importance to."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core import transform as tfm
from ..core.math import length, normalize
from .scene import resolve_device


class Camera(NamedTuple):
    camera_to_world: torch.Tensor  # (4,4)
    raster_to_camera: torch.Tensor  # (4,4)
    # their float32 inverses, for the importance queries (pdf_we,
    # sample_wi), which the reference takes on every call
    world_to_camera: torch.Tensor  # (4,4)
    camera_to_raster: torch.Tensor  # (4,4)


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
    c2w = torch.as_tensor(np.asarray(camera_to_world, np.float32))
    r2c = torch.as_tensor(raster_to_camera.astype(np.float32))
    device = resolve_device(device)
    return Camera(camera_to_world=c2w.to(device),
                  raster_to_camera=r2c.to(device),
                  world_to_camera=torch.linalg.inv(c2w).to(device),
                  camera_to_raster=torch.linalg.inv(r2c).to(device))


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


def generate_ray_differentials(camera: Camera, p_raster: torch.Tensor,
                               u_lens=None):
    """Camera::GenerateRayDifferential (camera.py:498-512): the main ray
    and the rays of the +1 pixel raster offsets in x and y.  Returns
    (o, d, weight, rx_o, rx_d, ry_o, ry_d)."""
    o, d, w = generate_rays_weighted(camera, p_raster, u_lens)
    dx = torch.zeros_like(p_raster)
    dx[:, 0] = 1.0
    rx_o, rx_d, _ = generate_rays_weighted(camera, p_raster + dx, u_lens)
    ry_o, ry_d, _ = generate_rays_weighted(camera, p_raster + dx.flip(-1),
                                           u_lens)
    return o, d, w, rx_o, rx_d, ry_o, ry_d


def pixel_centers(width: int, height: int, device="cpu") -> torch.Tensor:
    """(H*W, 2) raster positions at pixel centers (x+.5, y+.5), row-major."""
    xs = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    ys = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)


def _film_area_z1(camera: Camera, width: int, height: int) -> torch.Tensor:
    """Area of the film window projected to the z=1 camera-space plane
    (PerspectiveCamera ctor, perspective.cpp:~55-65; camera.py:169-179)."""
    corners = torch.zeros((2, 3), dtype=torch.float32,
                          device=camera.raster_to_camera.device)
    corners[1, 0].fill_(float(width))  # fills: no host copy
    corners[1, 1].fill_(float(height))
    pc = tfm.apply_point(camera.raster_to_camera, corners)
    pc = pc / pc[:, 2:3]
    return ((pc[1, 0] - pc[0, 0]) * (pc[1, 1] - pc[0, 1])).abs()


def camera_position(camera: Camera) -> torch.Tensor:
    """World-space pinhole position (camera-space origin)."""
    return camera.camera_to_world[:3, 3]


def _raster_of_direction(camera: Camera, width: int, height: int,
                         d_world: torch.Tensor):
    """The camera-space cos(theta) of world directions leaving the pinhole,
    their raster position on the film, and whether it lies inside the film
    window (perspective.cpp:~195-215).  The inverses are the camera's,
    taken once in float32 on the host (LAPACK), where the reference takes
    them in XLA on every call: they agree to a few ulps."""
    d_cam = normalize(d_world @ camera.world_to_camera[:3, :3].T)
    cos_t = d_cam[:, 2]
    ok = cos_t > 1e-6
    p_focus = d_cam / torch.where(ok, cos_t, torch.ones_like(cos_t))[:, None]
    p_raster = tfm.apply_point(camera.camera_to_raster, p_focus)
    inside = (ok & (p_raster[:, 0] >= 0.0) & (p_raster[:, 0] < width)
              & (p_raster[:, 1] >= 0.0) & (p_raster[:, 1] < height))
    return cos_t, p_raster, inside


def pdf_we(camera: Camera, width: int, height: int, d_world: torch.Tensor):
    """PerspectiveCamera::Pdf_We (perspective.cpp:~190-230; camera.py:
    186-214) for unit directions (R,3) leaving the pinhole: (pdf_pos,
    pdf_dir), 1 and 1/(A cos^3 theta) inside the film window, else 0."""
    cos_t, _, inside = _raster_of_direction(camera, width, height, d_world)
    A = _film_area_z1(camera, width, height)
    pdf_dir = torch.where(inside,
                          1.0 / (A * torch.clamp_min(cos_t, 1e-6) ** 3), 0.0)
    return torch.where(inside, torch.ones_like(cos_t), 0.0), pdf_dir


def sample_wi(camera: Camera, width: int, height: int, p_ref: torch.Tensor):
    """PerspectiveCamera::Sample_Wi, pinhole (perspective.cpp:~232-270;
    camera.py:217-246): connect points (R,3) to the camera.  Returns (wi
    toward the camera, pdf = dist^2/cos, We (R,3) = 1/(A cos^4) inside the
    film window, the raster position (R,2), dist)."""
    to_cam = camera_position(camera) - p_ref
    dist = torch.clamp_min(length(to_cam), 1e-12)
    wi = to_cam / dist[:, None]
    cos_t, p_raster, inside = _raster_of_direction(camera, width, height, -wi)
    A = _film_area_z1(camera, width, height)
    cos_c = torch.clamp_min(cos_t, 1e-6)
    We = torch.where(inside, 1.0 / (A * cos_c ** 4), 0.0)
    pdf = torch.where(inside, dist * dist / cos_c, 0.0)
    return wi, pdf, We[:, None].expand(-1, 3), p_raster[:, :2], dist
