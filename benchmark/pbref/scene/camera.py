"""Cameras: vectorized ray generation for the perspective (pinhole and
thin lens), orthographic, environment (equirectangular) and realistic
(lens-system) cameras, camera motion through an animated camera-to-world,
and, for the camera endpoint of bidirectional paths, the importance
queries ``pdf_we`` and ``sample_wi`` (counterpart of
``bre_tpu/scene/camera.py``; pbrt perspective.cpp, orthographic.cpp,
environment.cpp, realistic.cpp).

The camera kind (``ctype``), the lens radius and focal distance and the
lens stack live on the host as Python values, so every dispatch on them is
static: a captured CUDA graph holds no host read and no 0-d device index.
The host values are float32-exact, and the scalar arithmetic on them is
done in float32 (numpy), as the reference does it on its 0-d float32
arrays.  ``pdf_we`` and ``sample_wi`` are the pinhole perspective camera's
for every kind, as the reference's are (camera.py:186-244).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core import transform as tfm
from ..core.math import dot, length, normalize
from ..core.sampling import concentric_sample_disk
from .scene import resolve_device

CAMERA_PERSPECTIVE = 0
CAMERA_ORTHOGRAPHIC = 1
CAMERA_ENVIRONMENT = 2  # environment.cpp (equirectangular)
CAMERA_REALISTIC = 3  # realistic.cpp (lens element stack)

_F32 = np.float32


def _f32(x) -> float:
    """x rounded to float32, as a Python float (exact in float32)."""
    return float(_F32(x))


class Camera(NamedTuple):
    camera_to_world: torch.Tensor  # (4,4)
    raster_to_camera: torch.Tensor  # (4,4)
    # their float32 inverses, for the importance queries (pdf_we,
    # sample_wi), which the reference takes on every call
    world_to_camera: torch.Tensor  # (4,4)
    camera_to_raster: torch.Tensor  # (4,4)
    ctype: int = CAMERA_PERSPECTIVE
    lens_radius: float = 0.0  # thin lens (perspective only)
    focal_distance: float = 1e6
    # the realistic camera's lens stack, front to back (meters; empty for
    # the projective cameras): curvature radius (0 = the stop), thickness
    # to the next element, ior behind the interface, aperture radius
    lens_curv: Tuple[float, ...] = ()
    lens_thick: Tuple[float, ...] = ()
    lens_eta: Tuple[float, ...] = ()
    lens_aperture: Tuple[float, ...] = ()
    rear_radius: float = 0.0  # rear element's sampling radius
    rear_z: float = 0.0  # camera-space z of the rear element


def _camera(ctype, camera_to_world, raster_to_camera, device, **host):
    """A Camera with the float32 inverses of its two matrices taken on the
    host (LAPACK), then moved to ``device``."""
    c2w = torch.as_tensor(np.asarray(camera_to_world, np.float32))
    r2c = torch.as_tensor(np.asarray(raster_to_camera, np.float32))
    device = resolve_device(device)
    return Camera(camera_to_world=c2w.to(device),
                  raster_to_camera=r2c.to(device),
                  world_to_camera=torch.linalg.inv(c2w).to(device),
                  camera_to_raster=torch.linalg.inv(r2c).to(device),
                  ctype=ctype, **host)


def camera_to(camera: Camera, device) -> Camera:
    """The same camera with its matrices on ``device``."""
    return camera._replace(**{k: getattr(camera, k).to(device) for k in (
        "camera_to_world", "raster_to_camera", "world_to_camera",
        "camera_to_raster")})


def _screen_to_raster(width: int, height: int, screen_scale: float = 1.0):
    """pbrt's ProjectiveCamera screen window: [-1,1] on the shorter axis,
    scaled by the aspect on the longer (api.cpp:651-680)."""
    aspect = width / height
    if aspect > 1.0:
        sx0, sx1, sy0, sy1 = -aspect, aspect, -1.0, 1.0
    else:
        sx0, sx1, sy0, sy1 = -1.0, 1.0, -1.0 / aspect, 1.0 / aspect
    sx0, sx1, sy0, sy1 = (v * screen_scale for v in (sx0, sx1, sy0, sy1))
    return (np.diag([width / (sx1 - sx0), height / (sy0 - sy1), 1.0, 1.0])
            .astype(np.float32)
            @ np.array([[1, 0, 0, -sx0], [0, 1, 0, -sy1], [0, 0, 1, 0],
                        [0, 0, 0, 1]], np.float32))


def make_perspective_camera(camera_to_world, fov_deg: float, width: int,
                            height: int, lens_radius: float = 0.0,
                            focal_distance: float = 1e6,
                            device="cuda") -> Camera:
    """The perspective camera (camera.py:46-78), a thin lens where
    ``lens_radius`` > 0.  The matrices are built in numpy with the
    reference's exact arithmetic."""
    cam_to_screen = tfm.perspective(fov_deg, 1e-2, 1000.0).numpy()
    raster_to_screen = np.linalg.inv(_screen_to_raster(width, height))
    raster_to_camera = np.linalg.inv(cam_to_screen) @ raster_to_screen
    return _camera(CAMERA_PERSPECTIVE, camera_to_world,
                   raster_to_camera.astype(np.float32), device,
                   lens_radius=_f32(lens_radius),
                   focal_distance=_f32(focal_distance))


def make_orthographic_camera(camera_to_world, width: int, height: int,
                             screen_scale: float = 1.0,
                             device="cuda") -> Camera:
    """The orthographic camera (camera.py:81-103): camera-to-screen is the
    identity."""
    raster_to_camera = np.linalg.inv(_screen_to_raster(width, height,
                                                       screen_scale))
    return _camera(CAMERA_ORTHOGRAPHIC, camera_to_world,
                   raster_to_camera.astype(np.float32), device)


def make_environment_camera(camera_to_world, width: int, height: int,
                            device="cuda") -> Camera:
    """The equirectangular environment camera (environment.cpp;
    camera.py:106-121): theta over the rows, phi over the columns, rays
    from the camera origin; raster_to_camera holds the (1/width,
    1/height) scaling."""
    rtc = np.diag([1.0 / width, 1.0 / height, 1.0, 1.0]).astype(np.float32)
    return _camera(CAMERA_ENVIRONMENT, camera_to_world, rtc, device)


def generate_rays(camera: Camera, p_raster: torch.Tensor,
                  u_lens=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raster positions (R,2) -> world-space (origins, unit directions)
    (camera.py:124-166).  The perspective camera's rays leave the pinhole;
    the environment camera's leave the origin along the equirect
    direction; every other kind (orthographic, and a realistic camera,
    whose lens stack only ``generate_rays_weighted`` traces) takes the
    orthographic branch: rays from the film point along +z.  With
    ``u_lens`` (R,2), a perspective camera of ``lens_radius`` > 0 is a thin
    lens (perspective.cpp:96-110)."""
    R = p_raster.shape[0]
    zeros = torch.zeros((R, 1), dtype=torch.float32, device=p_raster.device)
    p_film = torch.cat([p_raster, zeros], -1)
    if camera.ctype == CAMERA_ENVIRONMENT:
        sxy = p_film @ camera.raster_to_camera[:3, :3].T
        theta = np.pi * sxy[:, 1]
        phi = 2.0 * np.pi * sxy[:, 0]
        st = torch.sin(theta)
        d = torch.stack([st * torch.cos(phi), torch.cos(theta),
                         st * torch.sin(phi)], -1)
        o = torch.zeros_like(d)
    else:
        p_cam = tfm.apply_point(camera.raster_to_camera, p_film)
        if camera.ctype == CAMERA_PERSPECTIVE:
            d = normalize(p_cam)
            o = torch.zeros_like(d)
        else:
            o = p_cam
            d = torch.zeros_like(p_cam)
            d[:, 2] = 1.0
    if (u_lens is not None and camera.lens_radius > 0.0
            and camera.ctype == CAMERA_PERSPECTIVE):
        p_lens = camera.lens_radius * concentric_sample_disk(u_lens)
        ft = camera.focal_distance / torch.clamp_min(d[:, 2], 1e-6)
        p_focus = o + ft[:, None] * d
        o = torch.cat([p_lens, zeros], -1)
        d = normalize(p_focus - o)
    o_w = tfm.apply_point(camera.camera_to_world, o)
    d_w = normalize(tfm.apply_vector(camera.camera_to_world, d))
    return o_w, d_w


# ---------------------------------------------------------------------------
# The realistic (lens-system) camera: realistic.cpp
# ---------------------------------------------------------------------------

def _trace_lenses_from_film_np(o, d, curv, thick, eta, aper):
    """Scalar numpy lens trace in float64 (the autofocus helper;
    TraceLensesFromFilm, realistic.cpp:92-139; camera.py:249-306): the
    elements back to front in lens space (camera z flipped), refraction
    at the spherical interfaces, clipping at the apertures.  Returns (o, d)
    past the front element, or None."""
    o = np.asarray(o, np.float64).copy()
    d = np.asarray(d, np.float64).copy()
    o[2] = -o[2]
    d[2] = -d[2]
    element_z = 0.0
    E = len(curv)
    for i in range(E - 1, -1, -1):
        element_z -= thick[i]
        is_stop = curv[i] == 0.0
        if is_stop:
            t = (element_z - o[2]) / d[2]
        else:
            radius = curv[i]
            z_center = element_z + radius
            oc = o - np.array([0, 0, z_center])
            a = d @ d
            b = 2 * (d @ oc)
            c = oc @ oc - radius * radius
            disc = b * b - 4 * a * c
            if disc < 0:
                return None
            sq = np.sqrt(disc)
            # the closer or farther root by the ray's direction against the
            # element's orientation (realistic.cpp:150-156)
            use_closer = (d[2] > 0) ^ (radius < 0)
            t0 = (-b - sq) / (2 * a)
            t1 = (-b + sq) / (2 * a)
            t = min(t0, t1) if use_closer else max(t0, t1)
            if t < 0:
                return None
        p = o + t * d
        if p[0] ** 2 + p[1] ** 2 > aper[i] ** 2:
            return None
        o = p
        if not is_stop:
            n = (o - np.array([0, 0, element_z + curv[i]]))
            n = n / np.linalg.norm(n)
            if n @ (-d) < 0:
                n = -n
            eta_i = eta[i]
            eta_t = eta[i - 1] if (i > 0 and eta[i - 1] != 0) else 1.0
            # refract -d about n with eta_i/eta_t (geometry.h Refract)
            wi = -d / np.linalg.norm(d)
            cos_i = n @ wi
            ratio = eta_i / eta_t
            sin2_t = ratio * ratio * max(0.0, 1.0 - cos_i * cos_i)
            if sin2_t >= 1.0:
                return None
            cos_t = np.sqrt(1.0 - sin2_t)
            d = ratio * -wi + (ratio * cos_i - cos_t) * n
    o[2] = -o[2]
    d[2] = -d[2]
    return o, d


def make_realistic_camera(camera_to_world, lens_rows, width: int,
                          height: int, aperture_diameter: float = 1.0,
                          focus_distance: float = 10.0,
                          film_diag: float = 0.035, device="cuda") -> Camera:
    """RealisticCamera (realistic.cpp:52-90; camera.py:309-399).
    ``lens_rows``: (E, 4) rows [curvature radius, thickness, eta, aperture
    diameter] front to back in millimeters (pbrt's lens files); the stop
    rows (curvature 0) take ``aperture_diameter``.  ``film_diag``: the
    film diagonal in meters.  Focusing moves the rear gap by a 46-step
    bisection on a traced axial ray (the effect of FocusThickLens), in
    float64 on the host with the reference's arithmetic, so the rear
    thickness comes out bit for bit."""
    rows = np.asarray(lens_rows, np.float64) * 1e-3  # mm -> m
    curv = rows[:, 0].copy()
    thick = rows[:, 1].copy()
    eta = np.asarray(lens_rows, np.float64)[:, 2].copy()  # ior unscaled
    aper = rows[:, 3].copy() / 2.0
    aper[curv == 0.0] = aperture_diameter * 1e-3 / 2.0
    rear_r = aper[-1]

    def focus_error():
        """Where an axial film ray of small slope crosses the axis again
        (the plane of sharp focus), less ``focus_distance``."""
        slope = 5e-3
        res = _trace_lenses_from_film_np(
            np.array([0.0, 0.0, 0.0]),
            np.array([0.0, slope, 1.0]) / np.linalg.norm([0.0, slope, 1.0]),
            curv, thick, eta, aper)
        if res is None:
            return None
        oo, dd = res
        if abs(dd[1]) < 1e-14 or dd[2] <= 0:
            return None
        t_axis = -oo[1] / dd[1]
        if t_axis <= 0:
            return None
        return oo[2] + t_axis * dd[2] - focus_distance

    # bisection over an added rear offset (the film farther from the lens
    # focuses nearer)
    base_thick = thick[-1]
    lo, hi = -0.5 * base_thick, 4.0 * base_thick + 0.05
    for _ in range(46):
        mid = 0.5 * (lo + hi)
        thick[-1] = base_thick + mid
        err = focus_error()
        if err is None or err > 0:
            lo = mid
        else:
            hi = mid
    thick[-1] = base_thick + 0.5 * (lo + hi)
    # raster -> physical film coordinates (meters): x right, y up,
    # centered, film at z = 0
    m_per_pix = film_diag / np.hypot(width, height)
    rtc = np.array(
        [[-m_per_pix, 0, 0, 0.5 * width * m_per_pix],
         [0, m_per_pix, 0, -0.5 * height * m_per_pix],
         [0, 0, 1, 0],
         [0, 0, 0, 1]], np.float32)

    def host(a):
        return tuple(float(x) for x in np.asarray(a, np.float32))

    return _camera(CAMERA_REALISTIC, camera_to_world, rtc, device,
                   focal_distance=_f32(focus_distance),
                   lens_curv=host(curv), lens_thick=host(thick),
                   lens_eta=host(eta), lens_aperture=host(aper),
                   rear_radius=_f32(rear_r), rear_z=_f32(thick[-1]))


def _trace_lenses_batch(camera: Camera, o, d):
    """Batched TraceLensesFromFilm (realistic.cpp:92-139; camera.py:
    402-456) in lens space (z flipped): o, d (R,3) camera-space film rays
    toward the rear element.  The element loop and the stop test are
    static; each element's scalars are float32 numpy.  Returns (o', d',
    ok) in camera space."""
    def flip(v):  # camera <-> lens space, no host tensor (graph-safe)
        return torch.cat([v[:, :2], -v[:, 2:]], -1)

    o = flip(o)
    d = flip(d)
    ok = torch.ones(o.shape[:1], dtype=torch.bool, device=o.device)
    element_z = _F32(0.0)
    for i in range(len(camera.lens_curv) - 1, -1, -1):
        curv = _F32(camera.lens_curv[i])
        element_z = element_z - _F32(camera.lens_thick[i])
        is_stop = curv == 0.0
        z_center = element_z + curv
        if is_stop:
            t = (float(element_z) - o[:, 2]) / d[:, 2]
            ok = ok & (t >= 0.0)
        else:
            # IntersectSphericalElement (realistic.cpp:141-160)
            oc = o.clone()
            oc[:, 2] = o[:, 2] - float(z_center)
            a = dot(d, d)
            b = 2.0 * dot(d, oc)
            c = dot(oc, oc) - float(curv * curv)
            disc = b * b - 4.0 * a * c
            sq = torch.sqrt(torch.clamp_min(disc, 0.0))
            t0 = (-b - sq) / (2.0 * a)
            t1 = (-b + sq) / (2.0 * a)
            use_closer = (d[:, 2] > 0.0) ^ bool(curv < 0.0)
            t = torch.where(use_closer, torch.minimum(t0, t1),
                            torch.maximum(t0, t1))
            ok = ok & (t >= 0.0) & (disc >= 0.0)
        p = o + t[:, None] * d
        r2 = p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]
        aper = _F32(camera.lens_aperture[i])
        ok = ok & (r2 <= float(aper * aper))
        o = p
        if is_stop:
            continue
        # refraction
        n = p.clone()
        n[:, 2] = p[:, 2] - float(z_center)
        n = n / torch.clamp_min(torch.sqrt(dot(n, n)), 1e-12)[:, None]
        wi = -d / torch.clamp_min(torch.sqrt(dot(d, d)), 1e-12)[:, None]
        cos_flip = dot(n, wi)
        n = torch.where((cos_flip < 0.0)[:, None], -n, n)
        cos_i = cos_flip.abs()
        eta_i = _F32(camera.lens_eta[i])
        eta_t = _F32(1.0)
        if i > 0 and camera.lens_eta[i - 1] != 0.0:
            eta_t = _F32(camera.lens_eta[i - 1])
        ratio = eta_i / eta_t
        sin2_t = float(ratio * ratio) * torch.clamp_min(1.0 - cos_i * cos_i,
                                                        0.0)
        cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
        d = float(ratio) * -wi + (float(ratio) * cos_i - cos_t)[:, None] * n
        ok = ok & ~(sin2_t >= 1.0)
    return flip(o), flip(d), ok


def generate_rays_weighted(camera: Camera, p_raster: torch.Tensor,
                           u_lens=None):
    """``generate_rays`` with per-ray weights (camera.py:459-487): 1 for
    the projective cameras; for a realistic camera the ray from the film
    point through a point of the rear element (at ``u_lens``, the disk's
    center without one) traced through the stack, weight 0 where the stack
    vignettes it, and then a ray far away pointing away from the scene.
    Returns (origins, unit directions, weights (R,))."""
    R = p_raster.shape[0]
    dev = p_raster.device
    if not camera.lens_curv:
        o, d = generate_rays(camera, p_raster, u_lens)
        return o, d, torch.ones((R,), dtype=torch.float32, device=dev)
    zeros = torch.zeros((R, 1), dtype=torch.float32, device=dev)
    p_f = tfm.apply_point(camera.raster_to_camera,
                          torch.cat([p_raster, zeros], -1))
    if u_lens is None:
        u_lens = torch.full((R, 2), 0.5, dtype=torch.float32, device=dev)
    p_disk = camera.rear_radius * concentric_sample_disk(u_lens)
    p_rear = torch.cat([p_disk, torch.full_like(zeros, camera.rear_z)], -1)
    o_l, d_l, ok = _trace_lenses_batch(camera, p_f, p_rear - p_f)
    o_w = tfm.apply_point(camera.camera_to_world, o_l)
    d_w = normalize(tfm.apply_vector(camera.camera_to_world, normalize(d_l)))
    far = torch.zeros_like(o_w)
    far[:, 2] = 1e7
    up = torch.zeros_like(d_w)
    up[:, 2] = 1.0
    ok3 = ok[:, None]
    return (torch.where(ok3, o_w, far), torch.where(ok3, d_w, up),
            ok.to(torch.float32))


def generate_ray_differentials(camera: Camera, p_raster: torch.Tensor,
                               u_lens=None):
    """Camera::GenerateRayDifferential (camera.py:498-510): the main ray
    and the rays of the +1 pixel raster offsets in x and y, with the same
    lens sample.  Returns (o, d, weight, rx_o, rx_d, ry_o, ry_d)."""
    o, d, w = generate_rays_weighted(camera, p_raster, u_lens)
    dx = torch.zeros_like(p_raster)
    dx[:, 0] = 1.0
    rx_o, rx_d, _ = generate_rays_weighted(camera, p_raster + dx, u_lens)
    ry_o, ry_d, _ = generate_rays_weighted(camera, p_raster + dx.flip(-1),
                                           u_lens)
    return o, d, w, rx_o, rx_d, ry_o, ry_d


def generate_rays_animated(camera: Camera, at, p_raster: torch.Tensor,
                           time: torch.Tensor, u_lens=None):
    """Motion-blurred rays (camera.py:513-530): camera-space rays taken
    through the animated camera-to-world ``at`` (core.animated) at each
    ray's time (R,).  Returns (o, d, weight)."""
    from ..core.animated import interpolate

    eye = torch.eye(4, dtype=torch.float32, device=p_raster.device)
    o_c, d_c, w = generate_rays_weighted(
        camera._replace(camera_to_world=eye, world_to_camera=eye), p_raster,
        u_lens)
    M = interpolate(at, time)  # (R, 4, 4)
    A = M[:, :3, :3]
    o = (A @ o_c[:, :, None])[:, :, 0] + M[:, :3, 3]
    d = normalize((A @ d_c[:, :, None])[:, :, 0])
    return o, d, w


def shutter_times(shutter_open: float, shutter_close: float, u_time):
    """[0,1) samples -> shutter times (CameraSample::time, camera.h:82)."""
    return shutter_open + (shutter_close - shutter_open) * u_time


def pixel_centers(width: int, height: int, device="cpu") -> torch.Tensor:
    """(H*W, 2) raster positions at pixel centers (x+.5, y+.5), row-major."""
    xs = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    ys = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)


def camera_from_jax(camera_jax, device="cuda") -> Camera:
    """A ``bre_tpu`` Camera (its leaves read with ``np.asarray``) -> this
    package's, on ``device``: the kind, the lens and the lens stack become
    host values."""
    a = lambda x: np.asarray(x, np.float32)  # noqa: E731
    host = lambda x: tuple(float(v) for v in a(x).reshape(-1))  # noqa: E731
    return _camera(int(np.asarray(camera_jax.ctype)),
                   a(camera_jax.camera_to_world),
                   a(camera_jax.raster_to_camera), device,
                   lens_radius=float(a(camera_jax.lens_radius)),
                   focal_distance=float(a(camera_jax.focal_distance)),
                   lens_curv=host(camera_jax.lens_curv),
                   lens_thick=host(camera_jax.lens_thick),
                   lens_eta=host(camera_jax.lens_eta),
                   lens_aperture=host(camera_jax.lens_aperture),
                   rear_radius=float(a(camera_jax.rear_radius)),
                   rear_z=float(a(camera_jax.rear_z)))


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
