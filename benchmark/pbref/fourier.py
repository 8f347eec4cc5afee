"""The FourierBSDF's table types, trimmed from ``bre_tpu_torch/fourier.py``
at b8e63ac to what a scene without a Fourier material builds: the stacked
``FourierTables`` (empty in the benchmark's scenes).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch



class FourierTable(NamedTuple):
    """One table, on the host (numpy)."""

    eta: float
    m_max: int
    n_channels: int
    mu: np.ndarray  # (nMu,)
    cdf: np.ndarray  # (nMu, nMu) [muO, muI] luminance CDF rows
    a0: np.ndarray  # (nMu, nMu) [muO, muI] the k=0 luminance coefficient
    a_offset: np.ndarray  # (nMu*nMu,) int32 into ``a``
    m: np.ndarray  # (nMu*nMu,) int32 series order per pair
    a: np.ndarray  # (nCoeffs,) coefficients, channel-major per pair


class FourierTables(NamedTuple):
    """A scene's stacked tables on the device; ``m_max`` is static."""

    eta: torch.Tensor  # (Nt,)
    mu: torch.Tensor  # (Nt, nMu)
    cdf: torch.Tensor  # (Nt, nMu, nMu)
    a0: torch.Tensor  # (Nt, nMu, nMu)
    a_offset: torch.Tensor  # (Nt, nMu*nMu) int64
    m: torch.Tensor  # (Nt, nMu*nMu) int64
    a: torch.Tensor  # (Nt, nCoeffsMax)
    n_channels: torch.Tensor  # (Nt,) int64
    m_max: int


def empty_fourier_tables(device="cpu") -> FourierTables:
    """The tables of a scene without a Fourier material (fourier.py:74-80)."""
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    zi = lambda *s: torch.zeros(s, dtype=torch.int64, device=device)  # noqa: E731
    return FourierTables(eta=z(0), mu=z(0, 2), cdf=z(0, 2, 2), a0=z(0, 2, 2),
                         a_offset=zi(0, 4), m=zi(0, 4), a=z(0, 1),
                         n_channels=zi(0), m_max=1)


def stack_fourier_tables(tables, device="cpu") -> FourierTables:
    """FourierTable rows -> the scene's stacked tables (fourier.py:83-106);
    all tables must share n_mu."""
    if not tables:
        return empty_fourier_tables(device)
    n_mu = tables[0].mu.shape[0]
    for t in tables:
        if t.mu.shape[0] != n_mu:
            raise ValueError("all scene .bsdf tables must share nMu "
                             f"({t.mu.shape[0]} != {n_mu})")
    n_coeff = max(t.a.shape[0] for t in tables)

    def f(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return FourierTables(
        eta=f(np.asarray([t.eta for t in tables], np.float32)),
        mu=f(np.stack([t.mu for t in tables])),
        cdf=f(np.stack([t.cdf for t in tables])),
        a0=f(np.stack([t.a0 for t in tables])),
        a_offset=f(np.stack([t.a_offset for t in tables]), torch.int64),
        m=f(np.stack([t.m for t in tables]), torch.int64),
        a=f(np.stack([np.pad(t.a, (0, n_coeff - t.a.shape[0]))
                      for t in tables])),
        n_channels=f([t.n_channels for t in tables], torch.int64),
        m_max=max(int(t.m_max) for t in tables))
