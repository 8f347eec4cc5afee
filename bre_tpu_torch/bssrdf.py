"""Tabulated BSSRDF (subsurface scattering) by photon-beam diffusion
(counterpart of ``bre_tpu/bssrdf.py``; pbrt bssrdf.{h,cpp}: FresnelMoment1/2,
BeamDiffusionMS/SS, ComputeBeamDiffusionBSSRDF, SubsurfaceFromDiffuse,
TabulatedBSSRDF::Sr/Sample_Sr/Pdf_Sr, SeparableBSSRDF::Pdf_Sp and Sw;
src/materials/subsurface.cpp and kdsubsurface.cpp), and the measured
scattering properties of ``MakeNamedMedium``'s "preset" (core/medium.cpp).

The (albedo rho) x (optical radius) profile tables are built on the host
in numpy with the reference's code, dtypes and order, so they come out bit
for bit: one table per unique (g, eta), stacked into ``BSSRDFTables``.
The queries evaluated per bounce (``bssrdf_sr``, ``bssrdf_pdf_sr``,
``bssrdf_sample_sr``, ``pdf_sp``, ``sw_factor``) are tensor code with per
lane gathers into the stacked tables, on ``core/interpolation``'s
Catmull-Rom splines.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .core.interpolation import catmull_rom_weights, sample_catmull_rom_2d
from .core.math import dot

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


# ---------------------------------------------------------------------------
# Fresnel moments (polynomial fits, bssrdf.cpp:43-66), on numpy or tensors
# ---------------------------------------------------------------------------

def _select(cond, a, b):
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return np.where(cond, a, b)


def fresnel_moment1(eta):
    e2 = eta * eta
    e3 = e2 * eta
    e4 = e3 * eta
    e5 = e4 * eta
    lo = (0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3
          + 2.49277 * e4 - 0.68441 * e5)
    hi = (-4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3
          - 1.27198 * e4 + 0.12746 * e5)
    return _select(eta < 1, lo, hi)


def fresnel_moment2(eta):
    e2 = eta * eta
    e3 = e2 * eta
    e4 = e3 * eta
    e5 = e4 * eta
    lo = (0.27614 - 0.87350 * eta + 1.12077 * e2 - 0.65095 * e3
          + 0.07883 * e4 + 0.04860 * e5)
    r = 1.0 / (torch.clamp_min(eta, 1e-6) if isinstance(eta, torch.Tensor)
               else np.maximum(eta, 1e-6))
    r2 = r * r
    r3 = r2 * r
    hi = (-547.033 + 45.3087 * r3 - 218.725 * r2 + 458.843 * r
          + 404.557 * eta - 189.519 * e2 + 54.9327 * e3 - 9.00603 * e4
          + 0.63942 * e5)
    return _select(eta < 1, lo, hi)


# ---------------------------------------------------------------------------
# Host-side table construction (numpy; runs once per material at build)
# ---------------------------------------------------------------------------

def _fr_dielectric_np(cos_i, eta_i, eta_t):
    """FrDielectric (reflection.cpp:47-76), numpy."""
    cos_i = np.clip(cos_i, -1.0, 1.0)
    entering = cos_i > 0
    ei = np.where(entering, eta_i, eta_t)
    et = np.where(entering, eta_t, eta_i)
    cos_i = np.abs(cos_i)
    sin_i = np.sqrt(np.maximum(0.0, 1.0 - cos_i * cos_i))
    sin_t = ei / et * sin_i
    cos_t = np.sqrt(np.maximum(0.0, 1.0 - sin_t * sin_t))
    r_parl = (et * cos_i - ei * cos_t) / np.maximum(et * cos_i + ei * cos_t, 1e-12)
    r_perp = (ei * cos_i - et * cos_t) / np.maximum(ei * cos_i + et * cos_t, 1e-12)
    f = 0.5 * (r_parl ** 2 + r_perp ** 2)
    return np.where(sin_t >= 1.0, 1.0, f)


def _phase_hg_np(cos_theta, g):
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return (1.0 / (4.0 * np.pi)) * (1.0 - g * g) / (denom * np.sqrt(np.maximum(denom, 1e-12)))


def beam_diffusion_ms(sigma_s, sigma_a, g, eta, r, n_samples=100):
    """BeamDiffusionMS (bssrdf.cpp:68-121): non-classical dipole with the
    Grosjean diffusion coefficient, averaged over exponentially distributed
    real-source depths.  Vectorized over r (numpy)."""
    r = np.asarray(r, np.float64)
    sigmap_s = sigma_s * (1 - g)
    sigmap_t = sigma_a + sigmap_s
    rhop = sigmap_s / sigmap_t
    D_g = (2 * sigma_a + sigmap_s) / (3 * sigmap_t * sigmap_t)
    sigma_tr = np.sqrt(sigma_a / D_g)
    fm1 = float(fresnel_moment1(np.float64(eta)))
    fm2 = float(fresnel_moment2(np.float64(eta)))
    ze = -2 * D_g * (1 + 3 * fm2) / (1 - 2 * fm1)
    c_phi = 0.25 * (1 - 2 * fm1)
    c_e = 0.5 * (1 - 3 * fm2)
    i = np.arange(n_samples, dtype=np.float64)
    zr = -np.log(1 - (i + 0.5) / n_samples) / sigmap_t  # (S,)
    zv = -zr + 2 * ze
    rr = r[..., None]
    dr = np.sqrt(rr * rr + zr * zr)
    dv = np.sqrt(rr * rr + zv * zv)
    inv4pi = 1.0 / (4.0 * np.pi)
    phi_d = inv4pi / D_g * (np.exp(-sigma_tr * dr) / dr - np.exp(-sigma_tr * dv) / dv)
    e_dn = inv4pi * (zr * (1 + sigma_tr * dr) * np.exp(-sigma_tr * dr) / dr ** 3
                     - zv * (1 + sigma_tr * dv) * np.exp(-sigma_tr * dv) / dv ** 3)
    E = phi_d * c_phi + e_dn * c_e
    kappa = 1 - np.exp(-2 * sigmap_t * (dr + zr))
    return np.mean(kappa * rhop * rhop * E, axis=-1)


def beam_diffusion_ss(sigma_s, sigma_a, g, eta, r, n_samples=100):
    """BeamDiffusionSS (bssrdf.cpp:122-144): single-scattering term along
    the refracted beam, starting below the critical depth.  Vectorized
    over r (numpy)."""
    r = np.asarray(r, np.float64)
    sigma_t = sigma_a + sigma_s
    rho = sigma_s / sigma_t
    t_crit = r * np.sqrt(max(eta * eta - 1.0, 0.0))
    i = np.arange(n_samples, dtype=np.float64)
    ti = t_crit[..., None] - np.log(1 - (i + 0.5) / n_samples) / sigma_t
    rr = r[..., None]
    d = np.sqrt(rr * rr + ti * ti)
    cos_theta_o = ti / d
    ess = (rho * np.exp(-sigma_t * (d + t_crit[..., None])) / (d * d)
           * _phase_hg_np(cos_theta_o, g)
           * (1 - _fr_dielectric_np(-cos_theta_o, 1.0, eta))
           * np.abs(cos_theta_o))
    return np.mean(ess, axis=-1)


def _integrate_catmull_rom_np(x, values):
    """IntegrateCatmullRom (interpolation.cpp:260-284), numpy over last axis."""
    x = np.asarray(x, np.float64)
    v = np.asarray(values, np.float64)
    x0, x1 = x[:-1], x[1:]
    f0, f1 = v[..., :-1], v[..., 1:]
    width = x1 - x0
    d0 = np.concatenate([
        (f1 - f0)[..., :1],
        width[1:] * (f1[..., 1:] - v[..., :-2]) / (x1[1:] - x[:-2])], axis=-1)
    d1 = np.concatenate([
        width[:-1] * (v[..., 2:] - f0[..., :-1]) / (x[2:] - x0[:-1]),
        (f1 - f0)[..., -1:]], axis=-1)
    seg = ((d0 - d1) / 12.0 + (f0 + f1) * 0.5) * width
    cdf = np.concatenate(
        [np.zeros(seg.shape[:-1] + (1,)), np.cumsum(seg, axis=-1)], axis=-1)
    return cdf, cdf[..., -1]


def compute_beam_diffusion_bssrdf(g: float, eta: float,
                                  n_rho: int = N_RHO,
                                  n_radius: int = N_RADIUS):
    """ComputeBeamDiffusionBSSRDF (bssrdf.cpp:145-176): build one
    (rho, r_optical) profile table.  Returns numpy dict of arrays."""
    radius = np.zeros(n_radius)
    radius[1] = 2.5e-3
    for i in range(2, n_radius):
        radius[i] = radius[i - 1] * 1.2
    i = np.arange(n_rho, dtype=np.float64)
    rho = (1 - np.exp(-8 * i / (n_rho - 1))) / (1 - np.exp(-8.0))

    profile = np.zeros((n_rho, n_radius))
    for k in range(n_rho):
        profile[k] = 2 * np.pi * radius * (
            beam_diffusion_ss(rho[k], 1 - rho[k], g, eta, radius)
            + beam_diffusion_ms(rho[k], 1 - rho[k], g, eta, radius))
    cdf, rho_eff = _integrate_catmull_rom_np(radius, profile)
    return dict(rho=rho.astype(np.float32), radius=radius.astype(np.float32),
                profile=profile.astype(np.float32),
                rho_eff=rho_eff.astype(np.float32), cdf=cdf.astype(np.float32))


def _invert_catmull_rom_np(x, values, u):
    """InvertCatmullRom (interpolation.cpp:286-345), scalar numpy."""
    n = len(x)
    if not u > values[0]:
        return x[0]
    if not u < values[-1]:
        return x[-1]
    i = int(np.searchsorted(values, u, side="right")) - 1
    i = min(max(i, 0), n - 2)
    x0, x1 = x[i], x[i + 1]
    f0, f1 = values[i], values[i + 1]
    width = x1 - x0
    d0 = width * (f1 - values[i - 1]) / (x1 - x[i - 1]) if i > 0 else f1 - f0
    d1 = width * (values[i + 2] - f0) / (x[i + 2] - x0) if i + 2 < n else f1 - f0
    a, b, t = 0.0, 1.0, 0.5
    for _ in range(64):
        if not (a < t < b):
            t = 0.5 * (a + b)
        t2, t3 = t * t, t * t * t
        Fhat = ((2 * t3 - 3 * t2 + 1) * f0 + (-2 * t3 + 3 * t2) * f1
                + (t3 - 2 * t2 + t) * d0 + (t3 - t2) * d1)
        fhat = ((6 * t2 - 6 * t) * f0 + (-6 * t2 + 6 * t) * f1
                + (3 * t2 - 4 * t + 1) * d0 + (3 * t2 - 2 * t) * d1)
        if abs(Fhat - u) < 1e-6 or b - a < 1e-6:
            break
        if Fhat - u < 0:
            a = t
        else:
            b = t
        t -= (Fhat - u) / fhat
    return x0 + t * width


def subsurface_from_diffuse(table: dict, rho_eff_target, mfp):
    """SubsurfaceFromDiffuse (bssrdf.cpp:177-186): invert the effective
    albedo to recover (sigma_a, sigma_s) from a diffuse color + mean free
    path (the kdsubsurface material).  numpy, per channel."""
    rho_eff_target = np.asarray(rho_eff_target, np.float64)
    mfp = np.asarray(mfp, np.float64)
    sigma_a = np.zeros(3)
    sigma_s = np.zeros(3)
    for c in range(3):
        rho = _invert_catmull_rom_np(table["rho"], table["rho_eff"],
                                     float(rho_eff_target[c]))
        sigma_s[c] = rho / mfp[c]
        sigma_a[c] = (1 - rho) / mfp[c]
    return sigma_a.astype(np.float32), sigma_s.astype(np.float32)


# ---------------------------------------------------------------------------
# The per-bounce queries: tensors, per-lane gathers into the stacked tables
# ---------------------------------------------------------------------------

def _tbl_idx(tables: BSSRDFTables, tidx):
    return torch.clamp(tidx, 0, max(tables.rho.shape[0] - 1, 0))


def _profile_sum(prof, t, off_r, w_r, off_d, w_d, eff_tab=None):
    """The 4x4 tensor spline of the profile at per-lane (t, rho, r), and
    with ``eff_tab`` the 4-tap spline of rho_eff, in the reference's
    order (bssrdf.cpp:199-231, 364-387)."""
    NR, ND = prof.shape[-2], prof.shape[-1]
    sr = 0.0
    eff = 0.0
    for i in range(4):
        ji = torch.clamp(off_r + i, 0, NR - 1)
        if eff_tab is not None:
            eff = eff + w_r[:, i] * eff_tab[t, ji]
        for j in range(4):
            jj = torch.clamp(off_d + j, 0, ND - 1)
            sr = sr + w_r[:, i] * w_d[:, j] * prof[t, ji, jj]
    return sr, eff


def _over_2pi_r(sr, r_opt):
    one = torch.ones_like(r_opt)
    return torch.where(r_opt != 0,
                       sr / (2.0 * math.pi * torch.where(r_opt == 0, one,
                                                         r_opt)), sr)


def bssrdf_sr(tables: BSSRDFTables, tidx, sigma_t, rho, r):
    """TabulatedBSSRDF::Sr (bssrdf.cpp:199-231): distances (R,) -> the
    profile (R,3), per channel by the 4x4 Catmull-Rom spline."""
    t = _tbl_idx(tables, tidx)
    rho_n = tables.rho[t]
    rad_n = tables.radius[t]
    out = []
    for ch in range(3):
        r_opt = r * sigma_t[:, ch]
        off_r, w_r, ok_r = catmull_rom_weights(rho_n, rho[:, ch])
        off_d, w_d, ok_d = catmull_rom_weights(rad_n, r_opt)
        sr, _ = _profile_sum(tables.profile, t, off_r, w_r, off_d, w_d)
        sr = _over_2pi_r(sr, r_opt)
        sr = torch.where(ok_r & ok_d, sr, torch.zeros_like(sr))
        out.append(torch.clamp_min(sr * sigma_t[:, ch] ** 2, 0.0))
    return torch.stack(out, -1)


def bssrdf_pdf_sr(tables: BSSRDFTables, tidx, sigma_t_ch, rho_ch, r):
    """TabulatedBSSRDF::Pdf_Sr (bssrdf.cpp:364-387) of one channel:
    sigma_t_ch, rho_ch, r (R,) -> the pdf per unit area (R,)."""
    t = _tbl_idx(tables, tidx)
    r_opt = r * sigma_t_ch
    off_r, w_r, ok_r = catmull_rom_weights(tables.rho[t], rho_ch)
    off_d, w_d, ok_d = catmull_rom_weights(tables.radius[t], r_opt)
    sr, eff = _profile_sum(tables.profile, t, off_r, w_r, off_d, w_d,
                           tables.rho_eff)
    sr = _over_2pi_r(sr, r_opt)
    pdf = sr * sigma_t_ch ** 2 / torch.where(eff == 0, torch.ones_like(eff),
                                             eff)
    pdf = torch.where(ok_r & ok_d & (eff > 0), pdf, torch.zeros_like(pdf))
    return torch.clamp_min(pdf, 0.0)


def bssrdf_sample_sr(tables: BSSRDFTables, tidx, sigma_t_ch, rho_ch, u):
    """TabulatedBSSRDF::Sample_Sr (bssrdf.cpp:350-362) of one channel: a
    world-space radius from the profile; -1 marks a failed lane
    (sigma_t == 0), as the reference's return."""
    t = _tbl_idx(tables, tidx)
    r_opt, _fval, _pdf = sample_catmull_rom_2d(
        tables.rho[t], tables.radius[t], tables.profile, tables.cdf, rho_ch,
        u, table_idx=t)
    zero = sigma_t_ch == 0
    r = r_opt / torch.where(zero, torch.ones_like(sigma_t_ch), sigma_t_ch)
    return torch.where(zero, torch.full_like(r, -1.0), r)


def pdf_sp(tables: BSSRDFTables, tidx, sigma_t, rho, d_world, ni_world,
           ss, ts, ns):
    """SeparableBSSRDF::Pdf_Sp (bssrdf.cpp:327-348): the pdf of the three
    projection axes x three channels for a probe hit at ``d_world = po -
    pi`` with normal ``ni_world``."""
    d_local = torch.stack([dot(ss, d_world), dot(ts, d_world),
                           dot(ns, d_world)], -1)
    n_local = torch.stack([dot(ss, ni_world), dot(ts, ni_world),
                           dot(ns, ni_world)], -1)
    dx, dy, dz = d_local[:, 0], d_local[:, 1], d_local[:, 2]
    r_proj = (torch.sqrt(dy ** 2 + dz ** 2), torch.sqrt(dz ** 2 + dx ** 2),
              torch.sqrt(dx ** 2 + dy ** 2))
    axis_prob = (0.25, 0.25, 0.5)
    pdf = 0.0
    for axis in range(3):
        for ch in range(3):
            pdf = pdf + (bssrdf_pdf_sr(tables, tidx, sigma_t[:, ch],
                                       rho[:, ch], r_proj[axis])
                         * n_local[:, axis].abs() * (1.0 / 3.0)
                         * axis_prob[axis])
    return pdf


def sw_factor(eta, cos_w):
    """SeparableBSSRDF::Sw (bssrdf.h:88-91): the exit term (1 - Fr(cos)) /
    (c pi), c = 1 - 2 FresnelMoment1(1 / eta)."""
    from .materials import fr_dielectric

    c = 1.0 - 2.0 * fresnel_moment1(1.0 / eta)
    fr = fr_dielectric(cos_w, torch.ones_like(cos_w),
                       torch.broadcast_to(eta, cos_w.shape))
    return (1.0 - fr) / (c * math.pi)


# ---------------------------------------------------------------------------
# Measured scattering properties (core/medium.cpp:49-181): Jensen et al.
# 2001 and Narasimhan et al. 2006, name -> (sigma_prime_s, sigma_a)
# ---------------------------------------------------------------------------

MEASURED_SS = {
    "Apple": ((2.29, 2.39, 1.97), (0.0030, 0.0034, 0.046)),
    "Chicken1": ((0.15, 0.21, 0.38), (0.015, 0.077, 0.19)),
    "Chicken2": ((0.19, 0.25, 0.32), (0.018, 0.088, 0.20)),
    "Cream": ((7.38, 5.47, 3.15), (0.0002, 0.0028, 0.0163)),
    "Ketchup": ((0.18, 0.07, 0.03), (0.061, 0.97, 1.45)),
    "Marble": ((2.19, 2.62, 3.00), (0.0021, 0.0041, 0.0071)),
    "Potato": ((0.68, 0.70, 0.55), (0.0024, 0.0090, 0.12)),
    "Skimmilk": ((0.70, 1.22, 1.90), (0.0014, 0.0025, 0.0142)),
    "Skin1": ((0.74, 0.88, 1.01), (0.032, 0.17, 0.48)),
    "Skin2": ((1.09, 1.59, 1.79), (0.013, 0.070, 0.145)),
    "Spectralon": ((11.6, 20.4, 14.9), (0.00, 0.00, 0.00)),
    "Wholemilk": ((2.55, 3.21, 3.77), (0.0011, 0.0024, 0.014)),
    "Lowfat Milk": ((0.89187, 1.5136, 2.532), (0.002875, 0.00575, 0.0115)),
    "Reduced Milk": ((2.4858, 3.1669, 4.5214), (0.0025556, 0.0051111, 0.012778)),
    "Regular Milk": ((4.5513, 5.8294, 7.136), (0.0015333, 0.0046, 0.019933)),
    "Espresso": ((0.72378, 0.84557, 1.0247), (4.7984, 6.5751, 8.8493)),
    "Mint Mocha Coffee": ((0.31602, 0.38538, 0.48131), (3.772, 5.8228, 7.82)),
    "Lowfat Soy Milk": ((0.30576, 0.34233, 0.61664), (0.0014375, 0.0071875, 0.035937)),
    "Regular Soy Milk": ((0.59223, 0.73866, 1.4693), (0.0019167, 0.0095833, 0.065167)),
    "Lowfat Chocolate Milk": ((0.64925, 0.83916, 1.1057), (0.0115, 0.0368, 0.1564)),
    "Regular Chocolate Milk": ((1.4585, 2.1289, 2.9527), (0.010063, 0.043125, 0.14375)),
    "Coke": ((8.9053e-05, 8.372e-05, 0.0), (0.10014, 0.16503, 0.2468)),
    "Pepsi": ((6.1697e-05, 4.2564e-05, 0.0), (0.091641, 0.14158, 0.20729)),
    "Sprite": ((6.0306e-06, 6.4139e-06, 6.5504e-06), (0.001886, 0.0018308, 0.0020025)),
    "Gatorade": ((0.0024574, 0.003007, 0.0037325), (0.024794, 0.019289, 0.008878)),
    "Chardonnay": ((1.7982e-05, 1.3758e-05, 1.2023e-05), (0.010782, 0.011855, 0.023997)),
    "White Zinfandel": ((1.7501e-05, 1.9069e-05, 1.288e-05), (0.012072, 0.016184, 0.019843)),
    "Merlot": ((2.1129e-05, 0.0, 0.0), (0.11632, 0.25191, 0.29434)),
    "Budweiser Beer": ((2.4356e-05, 2.4079e-05, 1.0564e-05), (0.011492, 0.024911, 0.057786)),
    "Coors Light Beer": ((5.0922e-05, 4.301e-05, 0.0), (0.006164, 0.013984, 0.034983)),
    "Clorox": ((0.0024035, 0.0031373, 0.003991), (0.0033542, 0.014892, 0.026297)),
    "Apple Juice": ((0.00013612, 0.00015836, 0.000227), (0.012957, 0.023741, 0.052184)),
    "Cranberry Juice": ((0.00010402, 0.00011646, 7.8139e-05), (0.039437, 0.094223, 0.12426)),
    "Grape Juice": ((5.382e-05, 0.0, 0.0), (0.10404, 0.23958, 0.29325)),
    "Ruby Grapefruit Juice": ((0.011002, 0.010927, 0.011036), (0.085867, 0.18314, 0.25262)),
    "White Grapefruit Juice": ((0.22826, 0.23998, 0.32748), (0.0138, 0.018831, 0.056781)),
    "Shampoo": ((0.0007176, 0.0008303, 0.0009016), (0.014107, 0.045693, 0.061717)),
    "Strawberry Shampoo": ((0.00015671, 0.00015947, 1.518e-05), (0.01449, 0.05796, 0.075823)),
    "Head & Shoulders Shampoo": ((0.023805, 0.028804, 0.034306), (0.084621, 0.15688, 0.20365)),
    "Lemon Tea Powder": ((0.040224, 0.045264, 0.051081), (2.4288, 4.5757, 7.2127)),
    "Orange Powder": ((0.00015617, 0.00017482, 0.0001762), (0.001449, 0.003441, 0.007863)),
    "Pink Lemonade Powder": ((0.00012103, 0.00013073, 0.00012528), (0.001165, 0.002366, 0.003195)),
    "Cappuccino Powder": ((1.8436, 2.5851, 2.1662), (35.844, 49.547, 61.084)),
    "Salt Powder": ((0.027333, 0.032451, 0.031979), (0.28415, 0.3257, 0.34148)),
    "Sugar Powder": ((0.00022272, 0.00025513, 0.000271), (0.012638, 0.031051, 0.050124)),
    "Suisse Mocha Powder": ((2.7979, 3.5452, 4.3365), (17.502, 27.004, 35.433)),
    "Pacific Ocean Surface Water": ((0.0001764, 0.00032095, 0.00019617),
                                    (0.031845, 0.031324, 0.030147)),
}


def get_medium_scattering_properties(name: str):
    """GetMediumScatteringProperties (medium.cpp:183-195): case-sensitive
    name lookup -> (sigma_prime_s, sigma_a) numpy arrays, or None."""
    if name in MEASURED_SS:
        s, a = MEASURED_SS[name]
        return np.asarray(s, np.float32), np.asarray(a, np.float32)
    return None
