"""Hosek-Wilkie full-spectral sky-dome radiance model, the same model as
``bre_tpu/tools/hosek.py``.

Hosek & Wilkie, "An Analytic Model for Full Spectral Sky-Dome Radiance"
(SIGGRAPH 2012), and the direct solar radiance of "Adding a Solar-Radiance
Function to the Hosek-Wilkie Skylight Model" (IEEE CG&A 2013), which pbrt's
``imgtool makesky`` drives through the authors' C code (ArHosekSkyModel.c;
imgtool.cpp:142-180).  The fitted tables are ``data/hosek_spectral.npz``, a
byte-for-byte copy of the reference's.

- 11 spectral bands at 320..720nm (step 40), linearly interpolated.
- Per band, 9 coefficients A..I of the extended Perez-style function
      F(theta, gamma) = (1 + A e^{B/(cos theta + 0.01)})
          * (C + D e^{E gamma} + F cos^2 gamma + G chi(H, gamma)
             + I sqrt(cos theta))
  with the Mie term chi(g, a) = (1 + cos^2 a) / (1 + g^2 - 2 g cos a)^1.5,
  times a per-band expected-value radiance scale.
- The coefficients of one (elevation, turbidity, albedo): linear in albedo
  and in turbidity, a quintic Bezier in t = (elevation / (pi/2))^(1/3)
  (ArHosekSkyModel.c:142-231).
- Direct solar radiance: per-band piecewise cubics in elevation over 45
  pieces with breaks uniform in (2 elev/pi)^(1/3), times a 5th-order
  limb-darkening polynomial in the sample cosine across the 0.51deg solar
  disk (ArHosekSkyModel.c:658-795).

``HosekSky`` cooks one sky's coefficients on the host in float64 numpy (a
few hundred scalars); its radiance functions evaluate direction tensors in
float64 on the sky's device.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from ..scene.scene import resolve_device

_DATA = None
SOLAR_RADIUS = np.deg2rad(0.51) / 2.0  # ArHosekSkyModel.c:325
WL0, WLSTEP, NBANDS = 320.0, 40.0, 11
F64 = torch.float64


def _data():
    global _DATA
    if _DATA is None:
        _DATA = dict(np.load(Path(__file__).parent / "data"
                             / "hosek_spectral.npz"))
    return _DATA


def _bezier5(ctrl, t, axis):
    """Quintic Bezier with 6 control points on ``axis`` of ``ctrl``."""
    s = 1.0 - t
    w = np.array([s**5, 5 * s**4 * t, 10 * s**3 * t**2,
                  10 * s**2 * t**3, 5 * s * t**4, t**5])
    return np.tensordot(w, np.moveaxis(ctrl, axis, 0), axes=(0, 0))


def _horner(coefs, x: torch.Tensor) -> torch.Tensor:
    """np.polyval(coefs, x): highest order first, from y = 0."""
    y = torch.zeros_like(x)
    for c in coefs:
        y = y * x + float(c)
    return y


class HosekSky:
    """Cooked model state for one (elevation, turbidity, albedo), evaluated
    on ``device``.  ``solar_elevation`` is the sun's angle above the
    horizon in radians."""

    def __init__(self, solar_elevation: float, turbidity: float,
                 albedo: float, device="cuda"):
        self.device = resolve_device(device)
        d = _data()
        self.elevation = float(solar_elevation)
        self.turbidity = float(turbidity)
        self.albedo = float(albedo)

        t_int = min(int(turbidity), 10)
        t_rem = turbidity - t_int
        te = (solar_elevation / (np.pi / 2.0)) ** (1.0 / 3.0)

        def cook(table):
            # table axes: (band, albedo{0,1}, turbidity 1..10, ctrl[, coef])
            axis = 2  # ctrl axis after slicing turbidity out
            lo = _bezier5(table[:, :, t_int - 1], te, axis)  # (band, 2, ...)
            v = (1.0 - t_rem) * ((1.0 - albedo) * lo[:, 0] + albedo * lo[:, 1])
            if t_int < 10:
                hi = _bezier5(table[:, :, t_int], te, axis)
                v += t_rem * ((1.0 - albedo) * hi[:, 0] + albedo * hi[:, 1])
            return v

        self.configs = cook(d["configs"])      # (11, 9) host float64
        self.radiances = cook(d["radiances"])  # (11,)
        self._solar = torch.as_tensor(d["solar"], dtype=F64,
                                      device=self.device)

    def _as(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=F64, device=self.device)

    # -- sky dome (in-scattered) radiance ---------------------------------
    def _F(self, theta, gamma, band):
        """The extended Perez-style distribution of one band."""
        c = [float(v) for v in self.configs[band]]
        cos_t = torch.cos(theta)
        cos_g = torch.cos(gamma)
        expM = torch.exp(c[4] * gamma)
        rayM = cos_g * cos_g
        mieM = (1.0 + cos_g * cos_g) / torch.pow(
            1.0 + c[8] * c[8] - 2.0 * c[8] * cos_g, 1.5)
        zenith = torch.sqrt(torch.clamp_min(cos_t, 0.0))
        return ((1.0 + c[0] * torch.exp(c[1] / (cos_t + 0.01)))
                * (c[2] + c[3] * expM + c[5] * rayM
                   + c[6] * mieM + c[7] * zenith))

    def radiance(self, theta, gamma, wavelength):
        """Spectral sky radiance, linear between the two bracketing bands
        (ArHosekSkyModel.c:522-564).  theta and gamma broadcast; the
        wavelength is a scalar (nm)."""
        theta, gamma = self._as(theta), self._as(gamma)
        pos = (wavelength - WL0) / WLSTEP
        low = int(np.floor(pos))
        if low < 0 or low >= NBANDS:
            return torch.zeros(theta.shape, dtype=F64, device=self.device)
        frac = pos - low

        def band(i):
            return self._F(theta, gamma, i) * float(self.radiances[i])
        out = (1.0 - frac) * band(low)
        if frac > 1e-6 and low + 1 < NBANDS:
            out = out + frac * band(low + 1)
        return out

    # -- direct solar radiance -------------------------------------------
    def _sr_band(self, turb_idx, band, elevation):
        """Piecewise-cubic direct radiance at one (turbidity idx, band)."""
        pieces = 45
        pos = torch.clamp_max(
            (torch.pow(2.0 * elevation / math.pi, 1.0 / 3.0) * pieces)
            .to(torch.int64), pieces - 1)
        break_x = torch.pow(pos.to(F64) / pieces, 3.0) * (np.pi * 0.5)
        x = elevation - break_x
        coefs = self._solar[band, turb_idx][pos]  # (..., 4) c3,c2,c1,c0
        return ((coefs[..., 0] * x + coefs[..., 1]) * x
                + coefs[..., 2]) * x + coefs[..., 3]

    def solar_disk_radiance(self, theta, gamma, wavelength):
        """Direct solar radiance through the 0.51deg disk with limb
        darkening; zero outside the disk (ArHosekSkyModel.c:693-795).
        Elevation argument of the C API is (pi/2 - theta)."""
        theta, gamma = self._as(theta), self._as(gamma)
        elevation = np.pi / 2.0 - theta

        sin_rad = np.sin(SOLAR_RADIUS)
        ar2 = float(1.0 / (sin_rad * sin_rad))
        sing = torch.sin(gamma)
        sc2 = torch.clamp_min(1.0 - ar2 * sing * sing, 0.0)
        sample_cos = torch.sqrt(sc2)

        turb_low = int(self.turbidity) - 1
        turb_frac = self.turbidity - (turb_low + 1)
        if turb_low == 9:
            turb_low, turb_frac = 8, 1.0
        wl_low = int((wavelength - WL0) / WLSTEP)
        wl_frac = float(np.fmod(wavelength, WLSTEP) / WLSTEP)
        if wl_low == NBANDS - 1:
            wl_low, wl_frac = NBANDS - 2, 1.0

        def at(turb, band):
            return self._sr_band(turb, band, elevation)

        direct = ((1.0 - turb_frac)
                  * ((1.0 - wl_frac) * at(turb_low, wl_low)
                     + wl_frac * at(turb_low, wl_low + 1))
                  + turb_frac
                  * ((1.0 - wl_frac) * at(turb_low + 1, wl_low)
                     + wl_frac * at(turb_low + 1, wl_low + 1)))

        limb = _data()["limb"]  # (11, 6)
        ld = (1.0 - wl_frac) * limb[wl_low] + wl_frac * limb[wl_low + 1]
        darkening = _horner(ld[::-1], sample_cos)
        return torch.where(sample_cos > 0.0, direct * darkening, 0.0)

    def solar_radiance(self, theta, gamma, wavelength):
        """Sky + solar-disk radiance, what imgtool makesky samples
        (imgtool.cpp:174-176 -> ArHosekSkyModel.c:800-825)."""
        return (self.solar_disk_radiance(theta, gamma, wavelength)
                + self.radiance(theta, gamma, wavelength))


# each channel: the mean of three model wavelengths (imgtool.cpp:144-180)
CHANNEL_WAVELENGTHS = ((630.0, 680.0, 710.0), (500.0, 530.0, 560.0),
                       (460.0, 480.0, 490.0))


def view_gamma(theta, phi, elevation):
    """The angle between each view direction (theta from zenith, phi
    azimuth; y up) and the sun in the +z half-plane at ``elevation``.  The
    dot product is summed in index order (the same bits on any device)."""
    sun_y, sun_z = math.sin(elevation), math.cos(elevation)  # sun_x = 0
    dot = (torch.cos(theta) * sun_y
           + torch.sin(phi) * torch.sin(theta) * sun_z)
    return torch.arccos(torch.clamp(dot, -1.0, 1.0))


def channel_radiance(sky: HosekSky, th, gamma) -> torch.Tensor:
    """(..., 3) float64: each channel's mean of solar_radiance over its
    three wavelengths, summed in the reference's order."""
    chans = []
    for wls in CHANNEL_WAVELENGTHS:
        acc = torch.zeros_like(th)
        for wl in wls:
            acc = acc + sky.solar_radiance(th, gamma, wl) / 3.0
        chans.append(acc)
    return torch.stack(chans, -1)


def hosek_sky_image(n_theta: int, elevation: float, turbidity: float = 3.0,
                    albedo: float = 0.5, device="cuda") -> torch.Tensor:
    """Equirect lat-long sky map as imgtool makesky builds it
    (imgtool.cpp:142-180): (n_theta, 2*n_theta, 3) float32, theta from
    zenith, RGB as the mean of three model wavelengths per channel; rows
    below the horizon are zero."""
    sky = HosekSky(elevation, turbidity, albedo, device=device)
    dev = sky.device
    n_phi = 2 * n_theta
    theta = (torch.arange(n_theta, dtype=F64, device=dev) + 0.5) / n_theta \
        * np.pi
    phi = (torch.arange(n_phi, dtype=F64, device=dev) + 0.5) / n_phi \
        * 2.0 * np.pi
    th, ph = torch.meshgrid(theta, phi, indexing="ij")
    above = th <= np.pi / 2.0
    th_c = torch.where(above, th, np.pi / 2.0)
    img = channel_radiance(sky, th_c, view_gamma(th_c, ph, elevation))
    return torch.where(above[..., None], img, 0.0).to(torch.float32)
