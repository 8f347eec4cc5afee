"""The FourierBSDF: measured BSDFs as Fourier series in the azimuth
(counterpart of ``bre_tpu/fourier.py``; pbrt reflection.{h,cpp}
FourierBSDFTable, FourierBSDF::f / Sample_f / Pdf; materials/fourier.cpp
and its SCATFUN v1 ``.bsdf`` format).

A table stores the coefficients a_k(mu_i, mu_o) of f(mu_i, mu_o, phi)
|mu_i| = sum_k a_k cos(k phi) on a non-uniform mu grid, each pair's series
order m, and a luminance CDF for sampling the zenith.  The files are read,
written and projected on the host in numpy with the reference's code, so a
table comes out bit for bit.  A scene's tables are stacked into
``FourierTables`` (one n_mu, the coefficients zero-padded to the longest
file); the lanes gather their 4x4 neighbouring coefficient blocks as masked
(R, m_max) reads, and ``core/interpolation``'s recurrences evaluate and
sample the series with the static ``m_max``.
"""

from __future__ import annotations

import math
import struct
from typing import NamedTuple

import numpy as np
import torch

from .bssrdf import _integrate_catmull_rom_np
from .core.interpolation import (catmull_rom_weights, fourier_eval,
                                 sample_catmull_rom_2d, sample_fourier)


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


# ---------------------------------------------------------------------------
# SCATFUN v1 file format (fourier.cpp:55-198)
# ---------------------------------------------------------------------------

_HEADER = b"SCATFUN\x01"


def read_bsdf_file(path) -> FourierTable:
    """FourierBSDFTable::Read (fourier.cpp:106-198): little-endian SCATFUN
    v1; only flags==1 (plain BSDF), nBases==1, 1 or 3 channels."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _HEADER:
        raise ValueError(f"{path}: not a SCATFUN v1 file")
    (flags, n_mu, n_coeffs, m_max, n_channels, n_bases, _u0, _u1, _u2,
     eta, _a0, _a1, _p0, _p1) = struct.unpack_from("<9i f 2f 2i", data, 8)
    if flags != 1 or n_bases != 1 or n_channels not in (1, 3):
        raise ValueError(f"{path}: unsupported SCATFUN variant "
                         f"(flags={flags} nBases={n_bases} nCh={n_channels})")
    off = 8 + 14 * 4
    mu = np.frombuffer(data, "<f4", n_mu, off)
    off += 4 * n_mu
    cdf = np.frombuffer(data, "<f4", n_mu * n_mu, off).reshape(n_mu, n_mu)
    off += 4 * n_mu * n_mu
    off_len = np.frombuffer(data, "<i4", 2 * n_mu * n_mu, off).reshape(-1, 2)
    off += 8 * n_mu * n_mu
    a = np.frombuffer(data, "<f4", n_coeffs, off)
    a_offset = off_len[:, 0].astype(np.int32).copy()
    m = off_len[:, 1].astype(np.int32).copy()
    a0 = np.where(m > 0, a[np.minimum(a_offset, n_coeffs - 1)], 0.0).reshape(n_mu, n_mu)
    return FourierTable(eta=float(eta), m_max=int(m_max),
                        n_channels=int(n_channels), mu=mu.copy(), cdf=cdf.copy(),
                        a0=a0.astype(np.float32), a_offset=a_offset, m=m,
                        a=a.copy())


def write_bsdf_file(path, table: FourierTable):
    """Emit the SCATFUN v1 layout read by pbrt and read_bsdf_file."""
    n_mu = table.mu.shape[0]
    with open(path, "wb") as f:
        f.write(_HEADER)
        f.write(struct.pack("<9i f 2f 2i", 1, n_mu, table.a.shape[0],
                            table.m_max, table.n_channels, 1, 0, 0, 0,
                            table.eta, 0.0, 0.0, 0, 0))
        f.write(np.asarray(table.mu, "<f4").tobytes())
        f.write(np.asarray(table.cdf, "<f4").tobytes())
        off_len = np.stack([table.a_offset, table.m], -1).astype("<i4")
        f.write(off_len.tobytes())
        f.write(np.asarray(table.a, "<f4").tobytes())


def project_bsdf_table(f, n_mu=32, m_max=32, n_channels=1, eta=1.0,
                       n_phi=256) -> FourierTable:
    """Numerically project a BSDF callable onto the SCATFUN representation.

    f(mu_i, mu_o, phi) -> (..., n_channels) evaluates the BSDF (pbrt
    conventions: mu_i = cos theta of -wi, so reflection has mu_i*mu_o < 0).
    The stored function is f * |mu_i|; coefficients via the cosine-series
    quadrature a_k = (2 - [k==0]) / (2 pi) * int_{-pi}^{pi} g(phi) cos(k phi)
    dphi.  Channel order matches GetAk (luminance, R, B; fourier.cpp header
    doc + reflection.cpp:351-359).
    """
    # zenith grid: cosine-spaced over [-1, 1] like the shipped files
    mu = -np.cos(np.linspace(0.0, np.pi, n_mu))
    mu[0], mu[-1] = -1.0, 1.0
    phi = (np.arange(n_phi) + 0.5) / n_phi * 2 * np.pi

    a_list = []
    a_offset = np.zeros(n_mu * n_mu, np.int32)
    m_arr = np.zeros(n_mu * n_mu, np.int32)
    a0 = np.zeros((n_mu, n_mu), np.float32)
    offset = 0
    for o in range(n_mu):
        for i in range(n_mu):
            g = np.asarray(f(mu[i], mu[o], phi))  # (n_phi, C)
            if g.ndim == 1:
                g = g[:, None]
            g = g * abs(mu[i])
            basis = np.cos(np.outer(np.arange(m_max), phi))  # (m_max, n_phi)
            ak = (basis @ g) / n_phi * 2.0  # (m_max, C)
            ak[0] /= 2.0
            # trim trailing negligible orders (the files store ragged m)
            mags = np.max(np.abs(ak), axis=1)
            nz = np.nonzero(mags > 1e-7 * max(mags[0], 1e-12))[0]
            m_pair = int(nz[-1]) + 1 if nz.size else 0
            idx = o * n_mu + i
            a_offset[idx] = offset
            m_arr[idx] = m_pair
            if m_pair:
                block = ak[:m_pair].T.reshape(-1)  # channel-major
                a_list.append(block.astype(np.float32))
                offset += block.size
                a0[o, i] = ak[0, 0]
    a = (np.concatenate(a_list) if a_list else np.zeros(1, np.float32))
    cdf, _tot = _integrate_catmull_rom_np(mu, a0)
    return FourierTable(eta=float(eta), m_max=int(m_max),
                        n_channels=int(n_channels), mu=mu.astype(np.float32),
                        cdf=cdf.astype(np.float32), a0=a0, a_offset=a_offset,
                        m=m_arr, a=a)


def lambertian_fourier_table(rho=0.5, n_mu=32) -> FourierTable:
    """Analytic test table: Lambertian reflection (f = rho/pi when
    mu_i * mu_o < 0 in pbrt's -wi convention)."""

    def f(mu_i, mu_o, phi):
        v = (rho / np.pi) if mu_i * mu_o < 0 else 0.0
        return np.full((phi.shape[0], 1), v)

    return project_bsdf_table(f, n_mu=n_mu, m_max=4, n_channels=1, eta=1.0)


# ---------------------------------------------------------------------------
# The per-bounce queries, over lanes
# ---------------------------------------------------------------------------

def _gather_ak(tables: FourierTables, tidx, off_i, w_i, off_o, w_o, channel):
    """The 4x4 neighbourhood of coefficient blocks summed into (R, m_max)
    (reflection.cpp:325-340), masked past each pair's order; channel 0
    luminance, 1 R, 2 B (blocks are channel-major)."""
    n_mu = tables.mu.shape[-1]
    NC = tables.a.shape[-1]
    ks = torch.arange(tables.m_max, device=tidx.device)
    ak = torch.zeros(off_i.shape + (tables.m_max,), dtype=tables.a.dtype,
                     device=tidx.device)
    ch_eff = torch.clamp_max(tables.n_channels[tidx] - 1, channel)
    for b in range(4):
        jo = torch.clamp(off_o + b, 0, n_mu - 1)
        for a_ in range(4):
            ji = torch.clamp(off_i + a_, 0, n_mu - 1)
            w = w_i[:, a_] * w_o[:, b]
            pair = jo * n_mu + ji
            m_p = tables.m[tidx, pair]
            off_p = tables.a_offset[tidx, pair]
            idx = off_p[:, None] + ch_eff[:, None] * m_p[:, None] + ks[None, :]
            vals = tables.a[tidx[:, None], torch.clamp(idx, 0, NC - 1)]
            vals = torch.where(ks[None, :] < m_p[:, None], vals,
                               torch.zeros_like(vals))
            ak = ak + w[:, None] * vals
    return ak


def _mu_weights(tables: FourierTables, tidx, mu_val):
    return catmull_rom_weights(tables.mu[tidx], mu_val)


def _scale_and_rgb(tables, tidx, ak_y, ak_r, ak_b, cos_phi, mu_i, mu_o,
                   mode):
    """The series' luminance Y and RGB (R and B series, G from Y), over
    |mu_i| and, in radiance mode, times eta^2 across the interface
    (reflection.cpp:341-361)."""
    from .materials import MODE_RADIANCE

    ones = torch.ones_like(ak_y)
    Y = torch.clamp_min(fourier_eval(ak_y, ones, cos_phi), 0.0)
    zero = torch.zeros_like(mu_i)
    scale = torch.where(mu_i != 0, 1.0 / torch.clamp_min(mu_i.abs(), 1e-9),
                        zero)
    if mode == MODE_RADIANCE:
        eta_t = tables.eta[tidx]
        eta_rel = torch.where(mu_i > 0, 1.0 / torch.clamp_min(eta_t, 1e-6),
                              eta_t)
        scale = torch.where(mu_i * mu_o > 0, scale * eta_rel * eta_rel, scale)
    nch = tables.n_channels[tidx]
    Rv = fourier_eval(ak_r, ones, cos_phi)
    Bv = fourier_eval(ak_b, ones, cos_phi)
    Gv = 1.39829 * Y - 0.100913 * Bv - 0.297375 * Rv
    rgb = torch.stack([Rv, Gv, Bv], -1) * scale[:, None]
    mono = (Y * scale)[:, None].expand(rgb.shape)
    return torch.clamp_min(torch.where((nch == 3)[:, None], rgb, mono),
                           0.0), Y


def _coefficients(tables, tidx, mu_i, mu_o):
    off_i, w_i, ok_i = _mu_weights(tables, tidx, mu_i)
    off_o, w_o, ok_o = _mu_weights(tables, tidx, mu_o)
    aks = [_gather_ak(tables, tidx, off_i, w_i, off_o, w_o, c)
           for c in range(3)]
    return aks, ok_i & ok_o, off_o, w_o


def fourier_f(tables: FourierTables, tidx, wo_l, wi_l, mode):
    """FourierBSDF::f (reflection.cpp:307-361) of local-frame directions
    (R,3).  Returns RGB (R,3)."""
    mu_i = -wi_l[:, 2]  # CosTheta(-wi)
    mu_o = wo_l[:, 2]
    cos_phi = _cos_d_phi(-wi_l, wo_l)
    (ak_y, ak_r, ak_b), ok, _, _ = _coefficients(tables, tidx, mu_i, mu_o)
    rgb, _ = _scale_and_rgb(tables, tidx, ak_y, ak_r, ak_b, cos_phi, mu_i,
                            mu_o, mode)
    return torch.where(ok[:, None], rgb, torch.zeros_like(rgb))


def fourier_pdf(tables: FourierTables, tidx, wo_l, wi_l):
    """FourierBSDF::Pdf (reflection.cpp:602-641): the luminance series over
    the hemispherical integral rho."""
    n_mu = tables.mu.shape[-1]
    mu_i = -wi_l[:, 2]
    mu_o = wo_l[:, 2]
    cos_phi = _cos_d_phi(-wi_l, wo_l)
    off_i, w_i, ok_i = _mu_weights(tables, tidx, mu_i)
    off_o, w_o, ok_o = _mu_weights(tables, tidx, mu_o)
    ak = _gather_ak(tables, tidx, off_i, w_i, off_o, w_o, 0)
    rho = 0.0
    for b in range(4):
        jo = torch.clamp(off_o + b, 0, n_mu - 1)
        rho = rho + w_o[:, b] * tables.cdf[tidx, jo, n_mu - 1] * (2.0
                                                                  * math.pi)
    Y = fourier_eval(ak, torch.ones_like(ak), cos_phi)
    zero = torch.zeros_like(Y)
    pdf = torch.where((rho > 0) & (Y > 0),
                      Y / torch.where(rho == 0, torch.ones_like(rho), rho),
                      zero)
    return torch.where(ok_i & ok_o, pdf, zero)


def fourier_sample_f(tables: FourierTables, tidx, wo_l, u, mode):
    """FourierBSDF::Sample_f (reflection.cpp:523-600): mu_i from the
    luminance CDF, then phi from the series.  Returns (wi_l (R,3), f (R,3),
    pdf (R,))."""
    mu_o = wo_l[:, 2]
    mu_rows = tables.mu[tidx]
    mu_i, _fval, pdf_mu = sample_catmull_rom_2d(
        mu_rows, mu_rows, tables.a0, tables.cdf, mu_o, u[:, 1],
        table_idx=tidx)
    (ak_y, ak_r, ak_b), ok, _, _ = _coefficients(tables, tidx, mu_i, mu_o)
    _Yf, pdf_phi, phi = sample_fourier(ak_y, torch.ones_like(ak_y), u[:, 0])
    pdf = torch.clamp_min(pdf_phi * pdf_mu, 0.0)
    # the scattered direction (reflection.cpp:568-585)
    sin2_i = torch.clamp_min(1.0 - mu_i * mu_i, 0.0)
    sin2_o = torch.clamp_min(1.0 - mu_o * mu_o, 0.0)
    norm = torch.sqrt(sin2_i / torch.clamp_min(sin2_o, 1e-12))
    norm = torch.where(sin2_o < 1e-12, torch.zeros_like(norm), norm)
    sp = torch.sin(phi)
    cp = torch.cos(phi)
    wi_l = -torch.stack([norm * (cp * wo_l[:, 0] - sp * wo_l[:, 1]),
                         norm * (sp * wo_l[:, 0] + cp * wo_l[:, 1]),
                         mu_i], -1)
    wi_l = wi_l / torch.clamp_min(torch.sqrt((wi_l * wi_l).sum(-1)), 1e-9
                                  )[:, None]
    rgb, _ = _scale_and_rgb(tables, tidx, ak_y, ak_r, ak_b, torch.cos(phi),
                            mu_i, mu_o, mode)
    ok = ok & (pdf > 0)
    return (wi_l, torch.where(ok[:, None], rgb, torch.zeros_like(rgb)),
            torch.where(ok, pdf, torch.zeros_like(pdf)))


def _cos_d_phi(wa, wb):
    """CosDPhi (reflection.h:110-117): the cosine of the azimuth
    difference."""
    waxy = wa[:, 0] ** 2 + wa[:, 1] ** 2
    wbxy = wb[:, 0] ** 2 + wb[:, 1] ** 2
    num = wa[:, 0] * wb[:, 0] + wa[:, 1] * wb[:, 1]
    den = torch.sqrt(torch.clamp_min(waxy * wbxy, 1e-20))
    c = torch.where((waxy == 0) | (wbxy == 0), torch.ones_like(num),
                    num / den)
    return torch.clamp(c, -1.0, 1.0)
