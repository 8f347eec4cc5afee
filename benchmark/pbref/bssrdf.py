"""The tabulated BSSRDF's table type, trimmed from ``bre_tpu_torch/bssrdf.py``
at b8e63ac to what a scene without a subsurface material builds: the
stacked ``BSSRDFTables`` (none of them in the benchmark's scenes).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


N_RHO = 100
N_RADIUS = 64


class BSSRDFTables(NamedTuple):
    """Stacked beam-diffusion tables, one row per unique (g, eta)
    (BSSRDFTable, bssrdf.h:139-160), with the 2 pi r factor folded into
    ``profile`` as the reference stores it."""

    rho: torch.Tensor  # (Nt, N_RHO) single-scattering albedo samples
    radius: torch.Tensor  # (Nt, N_RADIUS) unitless optical radii
    profile: torch.Tensor  # (Nt, N_RHO, N_RADIUS) 2 pi r (Sss + Sms)
    rho_eff: torch.Tensor  # (Nt, N_RHO) effective albedo
    cdf: torch.Tensor  # (Nt, N_RHO, N_RADIUS) profile CDF over radius


def bssrdf_tables(tables, device) -> BSSRDFTables:
    """Stack ``compute_beam_diffusion_bssrdf`` dicts (or none) on device."""
    n = len(tables)

    def f(key, shape):
        a = (np.stack([t[key] for t in tables]) if n
             else np.zeros((0,) + shape, np.float32))
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return BSSRDFTables(rho=f("rho", (N_RHO,)), radius=f("radius", (N_RADIUS,)),
                        profile=f("profile", (N_RHO, N_RADIUS)),
                        rho_eff=f("rho_eff", (N_RHO,)),
                        cdf=f("cdf", (N_RHO, N_RADIUS)))
