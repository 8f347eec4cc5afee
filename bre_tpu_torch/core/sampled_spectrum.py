"""SampledSpectrum: the 60-bin spectral alternative to RGB (counterpart of
``bre_tpu/core/sampled_spectrum.py``; pbrt spectrum.{h,cpp}, built with
PBRT_SAMPLED_SPECTRUM).

60 uniform bins over 400-700 nm.  The CIE matching functions are the
Wyman-Sloan-Shirley multi-lobe Gaussian fits (JCGT 2(2), 2013) and
RGB -> spectrum is the smoothest-metamer 60x3 matrix of one KKT solve, as
in the reference: both tables are computed in numpy float64 at import with
the reference's expressions.  A spectrum batch is a (..., 60) float32
tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from .spectrum import _RGB_TO_XYZ, xyz_to_rgb

N_SAMPLES = 60  # nSpectralSamples (spectrum.h:48)
LAMBDA_START = 400.0  # sampledLambdaStart
LAMBDA_END = 700.0  # sampledLambdaEnd

# bin-center wavelengths
LAMBDAS = np.linspace(LAMBDA_START, LAMBDA_END, N_SAMPLES + 1)
LAMBDAS = 0.5 * (LAMBDAS[:-1] + LAMBDAS[1:])


def _lobe(lam, mu, s1, s2):
    sig = np.where(lam < mu, s1, s2)
    t = (lam - mu) / sig
    return np.exp(-0.5 * t * t)


def cie_xyz_bar(lam):
    """CIE 1931 matching functions, the Wyman-Sloan-Shirley fits (max error
    below 1% of peak).  lam: (...,) nm -> (..., 3)."""
    lam = np.asarray(lam, np.float64)
    x = (1.056 * _lobe(lam, 599.8, 37.9, 31.0)
         + 0.362 * _lobe(lam, 442.0, 16.0, 26.7)
         - 0.065 * _lobe(lam, 501.1, 20.4, 26.2))
    y = (0.821 * _lobe(lam, 568.8, 46.9, 40.5)
         + 0.286 * _lobe(lam, 530.9, 16.3, 31.1))
    z = (1.217 * _lobe(lam, 437.0, 11.8, 36.0)
         + 0.681 * _lobe(lam, 459.0, 26.0, 13.8))
    return np.stack([x, y, z], -1)


_CMF = cie_xyz_bar(LAMBDAS)  # (60, 3)
_DLAM = (LAMBDA_END - LAMBDA_START) / N_SAMPLES
CIE_Y_INTEGRAL = float(_CMF[:, 1].sum() * _DLAM)


def _smoothest_metamer_matrix() -> np.ndarray:
    """60x3 M with spectrum = M @ xyz: the minimum-curvature spectrum
    matching the target XYZ, the KKT solution of min ||D2 s||^2 +
    1e-6 ||s||^2 subject to A s = xyz, in float64."""
    n = N_SAMPLES
    D = np.zeros((n - 2, n))
    for i in range(n - 2):
        D[i, i:i + 3] = [1.0, -2.0, 1.0]
    K = np.linalg.inv(D.T @ D + 1e-6 * np.eye(n))
    A = (_CMF * _DLAM).T  # (3, 60): s -> xyz
    return K @ A.T @ np.linalg.inv(A @ K @ A.T)


# spectrum = M @ (CIE_Y_integral * RGBToXYZ @ rgb): to_xyz divides by
# CIE_Y_integral, so the round trip is exact before clamping
_RGB_TO_SPECTRUM = _smoothest_metamer_matrix() @ (
    CIE_Y_INTEGRAL * np.asarray(_RGB_TO_XYZ))


def _f32(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                           device=like.device)


def from_rgb(rgb: torch.Tensor) -> torch.Tensor:
    """SampledSpectrum::FromRGB (spectrum.cpp:~390-470): the smooth
    spectrum whose XYZ matches the RGB's, clamped nonnegative.
    (..., 3) -> (..., 60)."""
    rgb = torch.as_tensor(rgb, dtype=torch.float32)
    return torch.clamp_min(rgb @ _f32(_RGB_TO_SPECTRUM.T, rgb), 0.0)


def to_xyz(s: torch.Tensor) -> torch.Tensor:
    """SampledSpectrum::ToXYZ (spectrum.h:340-358): binwise quadrature
    normalized by the CIE Y integral.  (..., 60) -> (..., 3)."""
    return s @ _f32(_CMF * _DLAM / CIE_Y_INTEGRAL, s)


def to_rgb(s: torch.Tensor) -> torch.Tensor:
    """SampledSpectrum::ToRGB (spectrum.h:360-366)."""
    return xyz_to_rgb(to_xyz(s))


def y_lum(s: torch.Tensor) -> torch.Tensor:
    """SampledSpectrum::y (spectrum.h:368-376)."""
    return s @ _f32(_CMF[:, 1] * _DLAM / CIE_Y_INTEGRAL, s)


def from_sampled(lambdas, values) -> torch.Tensor:
    """SampledSpectrum::FromSampled (spectrum.cpp:~70-120): a
    piecewise-linear SPD given at arbitrary wavelengths, resampled onto the
    60 bins (numpy, on the host)."""
    lambdas = np.asarray(lambdas, np.float64)
    values = np.asarray(values, np.float64)
    order = np.argsort(lambdas)
    return torch.as_tensor(np.interp(LAMBDAS, lambdas[order], values[order]),
                           dtype=torch.float32)


def blackbody(lambda_nm, T) -> torch.Tensor:
    """Blackbody (spectrum.cpp:40-56): Planck's law, W/(m^2 sr m), float32.
    lambda_nm (...,) nm, T scalar or (...,) K."""
    lam = torch.as_tensor(lambda_nm, dtype=torch.float32) * 1e-9
    T = torch.as_tensor(T, dtype=torch.float32, device=lam.device)
    c = 299792458.0
    h = 6.62606957e-34
    kb = 1.3806488e-23
    return (2.0 * h * c * c) / (
        lam ** 5 * (torch.exp(h * c / (lam * kb * T)) - 1.0))


def blackbody_normalized(lambda_nm, T) -> torch.Tensor:
    """BlackbodyNormalized (spectrum.cpp:58-68): 1 at the Wien peak."""
    lam_max = 2.8977721e-3 / torch.as_tensor(T, dtype=torch.float32) * 1e9
    return blackbody(lambda_nm, T) / blackbody(lam_max, T)


def blackbody_spectrum(T) -> torch.Tensor:
    """The normalized blackbody SPD on the 60 bin centers."""
    return blackbody_normalized(torch.as_tensor(LAMBDAS, dtype=torch.float32),
                                T)
