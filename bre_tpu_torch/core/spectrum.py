"""RGB spectrum helpers (counterpart of ``bre_tpu/core/spectrum.py``)."""

from __future__ import annotations

import torch

_Y_WEIGHT = (0.212671, 0.715160, 0.072169)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """RGBSpectrum::y() (spectrum.h:495-499)."""
    w = torch.tensor(_Y_WEIGHT, dtype=torch.float32, device=rgb.device)
    return (rgb * w).sum(-1)
