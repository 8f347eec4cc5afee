"""The sky models of ``imgtool makesky``, the same as ``bre_tpu/tools/sky.py``.

pbrt's ``imgtool makesky`` (imgtool.cpp:87-188) renders a sky dome from the
Hosek-Wilkie model (``tools/hosek.py``).  The **Preetham-Shirley-Smits**
model ("A Practical Analytic Model for Daylight", SIGGRAPH 1999) is the
closed-form alternative: the Perez formula with coefficients linear in
turbidity and closed-form zenith values, no data tables.

Layouts: a square image over the upper hemisphere in the equal-area disk
parameterization (imgtool.cpp:120-151), or an equirect latitude-longitude
map (top half sky) for the ``infinite`` light.  Y is up; ``elevation`` is
the sun's angle above the horizon.  The per-direction evaluation runs in
float64 on the given device; the images come out float32, as the
reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..scene.scene import resolve_device
from .hosek import F64, HosekSky, channel_radiance, view_gamma


def _perez(theta, gamma, A, B, C, D, E):
    """Perez sky radiance distribution F(theta, gamma)."""
    cos_t = torch.clamp(torch.cos(theta), 1e-4, 1.0)
    cg = torch.cos(gamma)
    return ((1.0 + A * torch.exp(B / cos_t))
            * (1.0 + C * torch.exp(D * gamma) + E * cg * cg))


# XYZ -> linear sRGB
_XYZ_TO_RGB = ((3.240479, -1.537150, -0.498535),
               (-0.969256, 1.875991, 0.041556),
               (0.055648, -0.204043, 1.057311))


def preetham_sky(theta, phi, sun_theta, sun_phi=0.0, turbidity=3.0,
                 device="cuda"):
    """Spectral-to-RGB sky radiance for directions (theta from zenith, phi
    azimuth) of one shape.  Returns (..., 3) float32 linear RGB (relative
    radiance; scale to taste)."""
    dev = resolve_device(device)
    T = float(turbidity)
    theta = torch.as_tensor(theta, dtype=F64, device=dev)
    phi = torch.as_tensor(phi, dtype=F64, device=dev)
    # angle between view direction and sun
    cos_gamma = (torch.sin(theta) * float(np.sin(sun_theta))
                 * torch.cos(phi - sun_phi)
                 + torch.cos(theta) * float(np.cos(sun_theta)))
    gamma = torch.arccos(torch.clamp(cos_gamma, -1.0, 1.0))

    # Perez coefficients (Preetham A.2), linear in T
    AY, BY = 0.1787 * T - 1.4630, -0.3554 * T + 0.4275
    CY, DY = -0.0227 * T + 5.3251, 0.1206 * T - 2.5771
    EY = -0.0670 * T + 0.3703
    Ax, Bx = -0.0193 * T - 0.2592, -0.0665 * T + 0.0008
    Cx, Dx = -0.0004 * T + 0.2125, -0.0641 * T - 0.8989
    Ex = -0.0033 * T + 0.0452
    Ay_, By_ = -0.0167 * T - 0.2608, -0.0950 * T + 0.0092
    Cy_, Dy_ = -0.0079 * T + 0.2102, -0.0441 * T - 1.6537
    Ey_ = -0.0109 * T + 0.0529

    # zenith values (Preetham A.2), on the host
    ts = float(sun_theta)
    chi = (4.0 / 9.0 - T / 120.0) * (np.pi - 2.0 * ts)
    Yz = (4.0453 * T - 4.9710) * np.tan(chi) - 0.2155 * T + 2.4192  # kcd/m^2
    Yz = float(max(Yz, 1e-3))
    tv = np.array([ts ** 3, ts ** 2, ts, 1.0])
    xz = np.array([[0.00166, -0.00375, 0.00209, 0.0],
                   [-0.02903, 0.06377, -0.03202, 0.00394],
                   [0.11693, -0.21196, 0.06052, 0.25886]])
    yz = np.array([[0.00275, -0.00610, 0.00317, 0.0],
                   [-0.04214, 0.08970, -0.04153, 0.00516],
                   [0.15346, -0.26756, 0.06670, 0.26688]])
    Tv = np.array([T * T, T, 1.0])
    x_z = float(Tv @ xz @ tv)
    y_z = float(Tv @ yz @ tv)
    zenith = (torch.zeros((), dtype=F64, device=dev),
              torch.full((), ts, dtype=F64, device=dev))

    def ratio(A, B, C, D, E):
        return (_perez(theta, gamma, A, B, C, D, E)
                / _perez(*zenith, A, B, C, D, E))

    Y = Yz * ratio(AY, BY, CY, DY, EY)
    x = x_z * ratio(Ax, Bx, Cx, Dx, Ex)
    y = y_z * ratio(Ay_, By_, Cy_, Dy_, Ey_)

    # xyY -> XYZ -> linear RGB
    y_safe = torch.clamp_min(y, 1e-4)
    X = x / y_safe * Y
    Z = (1.0 - x - y) / y_safe * Y
    rgb = torch.stack([X * m[0] + Y * m[1] + Z * m[2] for m in _XYZ_TO_RGB],
                      -1)
    rgb = torch.clamp_min(rgb, 0.0)
    # below the horizon: black
    rgb = torch.where((torch.cos(theta) <= 0)[..., None], 0.0, rgb)
    return rgb.to(torch.float32)


def _hosek_rgb64(theta, phi, sun_theta, turbidity, albedo, dev):
    """hosek_rgb before its float32 cast: (..., 3) float64."""
    elevation = np.pi / 2.0 - float(sun_theta)
    sky = HosekSky(elevation, turbidity, albedo, device=dev)
    theta = torch.as_tensor(theta, dtype=F64, device=dev)
    phi = torch.as_tensor(phi, dtype=F64, device=dev)
    gamma = view_gamma(theta, phi, elevation)
    above = torch.cos(theta) > 0.0
    th_c = torch.where(above, theta, np.pi / 2.0)
    rgb = channel_radiance(sky, th_c, gamma)
    return torch.where(above[..., None], rgb, 0.0)


def hosek_rgb(theta, phi, sun_theta, turbidity=3.0, albedo=0.5,
              device="cuda"):
    """Hosek-Wilkie RGB sky+sun radiance for directions (theta from zenith,
    phi azimuth with the sun at phi = pi/2), imgtool makesky's
    9-wavelength channel averaging (imgtool.cpp:144-180); float32."""
    return _hosek_rgb64(theta, phi, sun_theta, turbidity, albedo,
                        resolve_device(device)).to(torch.float32)


def sky_directions(resolution, layout, dev):
    """(theta, phi, inside) of each pixel of a makesky layout, float64."""
    if layout == "equalarea":
        xs = (torch.arange(resolution, dtype=F64, device=dev) + 0.5) \
            / resolution * 2.0 - 1.0
        gy, gx = torch.meshgrid(xs, xs, indexing="ij")
        r2 = gx * gx + gy * gy
        inside = r2 <= 1.0
        # Lambert azimuthal equal-area: z = 1 - r^2
        z = 1.0 - r2
        theta = torch.arccos(torch.clamp(z, -1.0, 1.0))
        phi = torch.arctan2(gy, gx)
    elif layout == "equirect":
        half = resolution // 2
        vs = (torch.arange(half, dtype=F64, device=dev) + 0.5) / half
        us = (torch.arange(resolution, dtype=F64, device=dev) + 0.5) \
            / resolution
        gv, gu = torch.meshgrid(vs, us, indexing="ij")
        theta = gv * (np.pi / 2.0)  # top half: sky only
        phi = gu * 2.0 * np.pi
        inside = torch.ones_like(theta, dtype=torch.bool)
    else:
        raise ValueError(f"unknown layout {layout!r}")
    return theta, phi, inside


def make_sky_image(resolution=512, elevation_deg=30.0, turbidity=3.0,
                   layout="equalarea", sun_scale=8.0, model="hosek",
                   albedo=0.5, device="cuda"):
    """imgtool makesky (imgtool.cpp:87-188): render the sky dome, a float32
    (H, W, 3) tensor on ``device``.

    model 'hosek' (the reference tool's): the Hosek-Wilkie full-spectral
    model with its fitted solar disk; 'preetham': the analytic
    Preetham-Shirley-Smits model with a synthetic sun splat.

    layout 'equalarea': square equal-area disk over the upper hemisphere;
    'equirect': latitude-longitude map (top half sky) usable directly by
    the ``infinite`` light.
    """
    dev = resolve_device(device)
    sun_theta = np.deg2rad(90.0 - elevation_deg)
    theta, phi, inside = sky_directions(resolution, layout, dev)
    if model == "hosek":
        # hosek_rgb puts the sun at phi = pi/2 (the +z half-plane,
        # imgtool.cpp:154); the preetham path at phi = 0: rotate so both
        # agree on sun-at-phi=0
        rgb = _hosek_rgb64(theta, phi + np.pi / 2.0, sun_theta, turbidity,
                           albedo, dev).to(torch.float32)
    else:
        rgb = preetham_sky(theta, phi, sun_theta, 0.0, turbidity, device=dev)
        # synthetic sun disc (the Preetham model has no solar term)
        cos_gamma = (torch.sin(theta) * float(np.sin(sun_theta))
                     * torch.cos(phi)
                     + torch.cos(theta) * float(np.cos(sun_theta)))
        sun_disc = cos_gamma > float(np.cos(np.deg2rad(0.5355 / 2)))
        peak = rgb.max() if rgb.numel() else 1.0
        rgb = torch.where(sun_disc[..., None], sun_scale * peak, rgb)
    return torch.where(inside[..., None], rgb, 0.0)


def cmd_makesky(args) -> int:
    from ..io.image import write_image

    img = make_sky_image(resolution=args.resolution,
                         elevation_deg=args.elevation,
                         turbidity=args.turbidity,
                         layout=args.layout,
                         model=getattr(args, "model", "hosek"),
                         albedo=getattr(args, "albedo", 0.5),
                         device=getattr(args, "device", "cuda"))
    write_image(args.outfile, img.cpu().numpy())
    print(f"wrote {args.outfile} ({img.shape[1]}x{img.shape[0]}, "
          f"elevation {args.elevation} deg, turbidity {args.turbidity})")
    return 0
