"""RGB spectrum helpers (counterpart of ``bre_tpu/core/spectrum.py``)."""

from __future__ import annotations

import torch

_Y_WEIGHT = (0.212671, 0.715160, 0.072169)
# spectrum.h:192-201 RGBToXYZ and :181-190 XYZToRGB
_RGB_TO_XYZ = ((0.412453, 0.357580, 0.180423),
               (0.212671, 0.715160, 0.072169),
               (0.019334, 0.119193, 0.950227))
_XYZ_TO_RGB = ((3.240479, -1.537150, -0.498535),
               (-0.969256, 1.875991, 0.041556),
               (0.055648, -0.204043, 1.057311))


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """RGBSpectrum::y() (spectrum.h:495-499), added in index order as
    ``core.math.dot``; the weights go to the kernels as scalars (no host
    copy, so a CUDA graph can hold it)."""
    w0, w1, w2 = _Y_WEIGHT
    return rgb[..., 0] * w0 + rgb[..., 1] * w1 + rgb[..., 2] * w2


def is_black(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb == 0.0).all(-1)


def _apply3(m, v: torch.Tensor) -> torch.Tensor:
    return v @ torch.tensor(m, dtype=torch.float32, device=v.device).T


def rgb_to_xyz(rgb: torch.Tensor) -> torch.Tensor:
    """spectrum.h:192-201 RGBToXYZ."""
    return _apply3(_RGB_TO_XYZ, rgb)


def xyz_to_rgb(xyz: torch.Tensor) -> torch.Tensor:
    """spectrum.h:181-190 XYZToRGB."""
    return _apply3(_XYZ_TO_RGB, xyz)
