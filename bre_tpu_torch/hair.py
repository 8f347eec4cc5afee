"""The hair BSDF: the Marschner / Chiang fiber scattering model over a
batch of lanes (counterpart of ``bre_tpu/hair.py``; pbrt
materials/hair.{h,cpp}: the longitudinal lobes Mp, the azimuthal lobes Np
as trimmed logistics about Phi(p), the attenuations Ap, the scale tilt by
2^k alpha, and the lobe-importance sampler).

Directions are in the hair frame: (sin theta, cos theta cos phi, cos theta
sin phi) with x the fiber's tangent.  The four lobes (R, TT, TRT and the
residual) unroll statically and the sampled lobe is a select.  ``h``, the
azimuthal offset in [-1, 1], comes from the tube's hit normal
(``h_from_tube_geometry``), as the reference's tessellated curves give no
curve v.  As there, the sampler takes four uniforms, split from two by
``demux_float``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .core.math import cross, dot

PI = math.pi
SQRT_PI_OVER_8 = 0.626657069


def _safe_sqrt(x):
    return torch.sqrt(torch.clamp_min(x, 0.0))


def _safe_asin(x):
    return torch.asin(torch.clamp(x, -1.0, 1.0))


def _i0(x):
    """Modified Bessel I0 by its 10-term series (hair.cpp:63-76)."""
    val = torch.zeros_like(x)
    x2 = x * x
    x2i = torch.ones_like(x)
    ifact = 1.0
    i4 = 1.0
    for i in range(10):
        if i > 1:
            ifact *= i
        val = val + x2i / (i4 * ifact * ifact)
        x2i = x2i * x2
        i4 *= 4.0
    return val


def _log_i0(x):
    """hair.cpp:78-83."""
    big = x + 0.5 * (-np.log(2.0 * PI)
                     + torch.log(1.0 / torch.clamp_min(x, 1e-8))
                     + 1.0 / (8.0 * torch.clamp_min(x, 1e-8)))
    small = torch.log(torch.clamp_min(_i0(x), 1e-30))
    return torch.where(x > 12.0, big, small)


def _mp(cos_ti, cos_to, sin_ti, sin_to, v):
    """The longitudinal lobe (hair.cpp:51-61)."""
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    low_v = torch.exp(_log_i0(a) - b - 1.0 / v + 0.6931
                      + torch.log(1.0 / (2.0 * v)))
    hi_v = torch.exp(-b) * _i0(a) / (torch.sinh(1.0 / v) * 2.0 * v)
    return torch.where(v <= 0.1, low_v, hi_v)


def _logistic(x, s):
    x = x.abs()
    e = torch.exp(-x / s)
    return e / (s * (1.0 + e) ** 2)


def _logistic_cdf(x, s):
    return 1.0 / (1.0 + torch.exp(-x / s))


def _trimmed_logistic(x, s):
    return _logistic(x, s) / (_logistic_cdf(PI, s) - _logistic_cdf(-PI, s))


def _sample_trimmed_logistic(u, s):
    k = _logistic_cdf(PI, s) - _logistic_cdf(-PI, s)
    x = -s * torch.log(1.0 / torch.clamp(u * k + _logistic_cdf(-PI, s),
                                         1e-7, 1.0 - 1e-7) - 1.0)
    return torch.clamp(x, -PI, PI)


def _phi_lobe(p, gamma_o, gamma_t):
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * PI


def _np_lobe(phi, p, s, gamma_o, gamma_t):
    dphi = phi - _phi_lobe(p, gamma_o, gamma_t)
    dphi = torch.remainder(dphi + PI, 2.0 * PI) - PI
    return _trimmed_logistic(dphi, s)


def _fr_dielectric_scalar(cos_i, eta):
    """FrDielectric for rays entering from outside (1 -> eta)."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin_t2 = (1.0 - cos_i * cos_i) / (eta * eta)
    cos_t = _safe_sqrt(1.0 - sin_t2)
    r_par = (eta * cos_i - cos_t) / torch.clamp_min(eta * cos_i + cos_t, 1e-9)
    r_perp = (cos_i - eta * cos_t) / torch.clamp_min(cos_i + eta * cos_t,
                                                     1e-9)
    return torch.clamp(0.5 * (r_par * r_par + r_perp * r_perp), 0.0, 1.0)


class HairParams(NamedTuple):
    """Per-lane hair parameters: sigma_a (R,3), the absorption inside the
    fiber; eta, beta_m, beta_n (longitudinal and azimuthal roughness) and
    alpha (the scale tilt in degrees), each (R,)."""

    sigma_a: torch.Tensor
    eta: torch.Tensor
    beta_m: torch.Tensor
    beta_n: torch.Tensor
    alpha: torch.Tensor


def sigma_a_from_concentration(eumelanin, pheomelanin=0.0):
    """HairBSDF::SigmaAFromConcentration (hair.cpp:~530): (3,) numpy."""
    eum = np.array([0.419, 0.697, 1.37], np.float32)
    pheo = np.array([0.187, 0.4, 1.05], np.float32)
    return eumelanin * eum + pheomelanin * pheo


def _lobe_constants(hp: HairParams):
    bm = hp.beta_m
    v0 = (0.726 * bm + 0.812 * bm * bm + 3.7 * bm ** 20) ** 2  # :243
    v = [v0, 0.25 * v0, 4.0 * v0, 4.0 * v0]
    bn = hp.beta_n
    s = SQRT_PI_OVER_8 * (0.265 * bn + 1.194 * bn * bn + 5.372 * bn ** 22)
    sin_a = torch.sin(torch.deg2rad(hp.alpha))
    cos_a = _safe_sqrt(1.0 - sin_a * sin_a)
    sin2k = [sin_a]
    cos2k = [cos_a]
    for i in range(1, 3):  # the doubling identities, :258-260
        sin2k.append(2.0 * cos2k[i - 1] * sin2k[i - 1])
        cos2k.append(cos2k[i - 1] ** 2 - sin2k[i - 1] ** 2)
    return v, s, sin2k, cos2k


def _refraction_terms(hp: HairParams, h, sin_to, cos_to):
    sin_tt = sin_to / hp.eta
    cos_tt = _safe_sqrt(1.0 - sin_tt * sin_tt)
    etap = (torch.sqrt(torch.clamp_min(hp.eta * hp.eta - sin_to * sin_to,
                                       1e-9))
            / torch.clamp_min(cos_to, 1e-6))
    sin_gt = h / etap
    cos_gt = _safe_sqrt(1.0 - sin_gt * sin_gt)
    gamma_t = _safe_asin(sin_gt)
    T = torch.exp(-hp.sigma_a
                  * (2.0 * cos_gt / torch.clamp_min(cos_tt, 1e-6))[..., None])
    return gamma_t, T


def _ap(hp: HairParams, h, cos_to, T):
    """The attenuations of the four lobes (hair.cpp:85-103), (R,3) each."""
    cos_go = _safe_sqrt(1.0 - h * h)
    f = _fr_dielectric_scalar(cos_to * cos_go, hp.eta)[..., None]
    ap0 = f.expand(T.shape)
    ap1 = (1.0 - f) ** 2 * T
    ap2 = ap1 * T * f
    ap3 = ap2 * f * T / torch.clamp_min(1.0 - T * f, 1e-4)
    return [ap0, ap1, ap2, ap3]


def _tilted_angles_f(p, sin_ti, cos_ti, sin2k, cos2k):
    """The scale-tilt rotations of f() and Pdf() (hair.cpp:293-311)."""
    if p == 0:
        s = sin_ti * cos2k[1] + cos_ti * sin2k[1]
        c = cos_ti * cos2k[1] - sin_ti * sin2k[1]
    elif p == 1:
        s = sin_ti * cos2k[0] - cos_ti * sin2k[0]
        c = cos_ti * cos2k[0] + sin_ti * sin2k[0]
    elif p == 2:
        s = sin_ti * cos2k[2] - cos_ti * sin2k[2]
        c = cos_ti * cos2k[2] + sin_ti * sin2k[2]
    else:
        s, c = sin_ti, cos_ti
    return s, c.abs()


def _angles(w):
    sin_t = w[..., 0]
    return (sin_t, _safe_sqrt(1.0 - sin_t * sin_t),
            torch.atan2(w[..., 2], w[..., 1]))


def hair_f(hp: HairParams, h, wo, wi):
    """HairBSDF::f (hair.cpp:264-326) in the hair frame.  Returns (R,3)."""
    sin_to, cos_to, phi_o = _angles(wo)
    sin_ti, cos_ti, phi_i = _angles(wi)
    gamma_o = _safe_asin(h)
    gamma_t, T = _refraction_terms(hp, h, sin_to, cos_to)
    ap = _ap(hp, h, cos_to, T)
    v, s, sin2k, cos2k = _lobe_constants(hp)
    phi = phi_i - phi_o
    fsum = torch.zeros_like(T)
    for p in range(3):
        s_ip, c_ip = _tilted_angles_f(p, sin_ti, cos_ti, sin2k, cos2k)
        mp = _mp(c_ip, cos_to, s_ip, sin_to, v[p])
        np_ = _np_lobe(phi, p, s, gamma_o, gamma_t)
        fsum = fsum + (mp * np_)[..., None] * ap[p]
    mp3 = _mp(cos_ti, cos_to, sin_ti, sin_to, v[3])
    fsum = fsum + (mp3 / (2.0 * PI))[..., None] * ap[3]
    abs_cos = cos_ti.abs()
    return torch.where(abs_cos[..., None] > 0.0,
                       fsum / torch.clamp_min(abs_cos, 1e-6)[..., None], fsum)


def _ap_pdf(hp: HairParams, h, cos_to):
    """ComputeApPdf (hair.cpp:328-356): the lobes' luminance weights."""
    sin_to = _safe_sqrt(1.0 - cos_to * cos_to)
    _, T = _refraction_terms(hp, h, sin_to, cos_to)
    ap = _ap(hp, h, cos_to, T)
    lum = torch.tensor([0.212671, 0.715160, 0.072169], dtype=torch.float32,
                       device=T.device)
    ys = [dot(a, lum) for a in ap]
    total = torch.clamp_min(ys[0] + ys[1] + ys[2] + ys[3], 1e-9)
    return [y / total for y in ys]


def hair_pdf(hp: HairParams, h, wo, wi):
    """HairBSDF::Pdf (hair.cpp:452-505)."""
    sin_to, cos_to, phi_o = _angles(wo)
    sin_ti, cos_ti, phi_i = _angles(wi)
    gamma_o = _safe_asin(h)
    gamma_t, _ = _refraction_terms(hp, h, sin_to, cos_to)
    v, s, sin2k, cos2k = _lobe_constants(hp)
    ap_pdf = _ap_pdf(hp, h, cos_to)
    phi = phi_i - phi_o
    pdf = torch.zeros_like(sin_to)
    for p in range(3):
        s_ip, c_ip = _tilted_angles_f(p, sin_ti, cos_ti, sin2k, cos2k)
        pdf = pdf + (_mp(c_ip, cos_to, s_ip, sin_to, v[p]) * ap_pdf[p]
                     * _np_lobe(phi, p, s, gamma_o, gamma_t))
    return pdf + (_mp(cos_ti, cos_to, sin_ti, sin_to, v[3]) * ap_pdf[3]
                  / (2.0 * PI))


def _pick(p_sel, vals):
    """vals[p_sel] lane by lane, as the reference's nested selects."""
    return torch.where(p_sel == 0, vals[0], torch.where(
        p_sel == 1, vals[1], torch.where(p_sel == 2, vals[2], vals[3])))


def hair_sample_f(hp: HairParams, h, wo, u4):
    """HairBSDF::Sample_f (hair.cpp:358-450) with four uniforms (R,4):
    the lobe by the cumulative Ap pdf, theta by Mp's inverse CDF, the
    tilt undone, phi about the lobe's Phi(p).  Returns (wi, f, pdf)."""
    sin_to, cos_to, phi_o = _angles(wo)
    v, s, sin2k, cos2k = _lobe_constants(hp)
    ap_pdf = _ap_pdf(hp, h, cos_to)
    gamma_o = _safe_asin(h)
    gamma_t, _ = _refraction_terms(hp, h, sin_to, cos_to)

    u0 = u4[..., 0]
    c0 = ap_pdf[0]
    c1 = c0 + ap_pdf[1]
    c2 = c1 + ap_pdf[2]
    p_sel = torch.where(u0 < c0, 0, torch.where(u0 < c1, 1, torch.where(
        u0 < c2, 2, 3)))

    v_sel = _pick(p_sel, v)
    u_m = torch.clamp_min(u4[..., 2], 1e-5)
    cos_theta = 1.0 + v_sel * torch.log(u_m + (1.0 - u_m)
                                        * torch.exp(-2.0 / v_sel))
    sin_theta = _safe_sqrt(1.0 - cos_theta * cos_theta)
    cos_phi_m = torch.cos(2.0 * PI * u4[..., 3])
    sin_ti = -cos_theta * sin_to + sin_theta * cos_phi_m * cos_to
    cos_ti = _safe_sqrt(1.0 - sin_ti * sin_ti)

    # undo the sampled lobe's scale tilt (:381-392)
    k = {0: 1, 1: 0, 2: 2}
    tilt = []
    for p in range(4):
        if p == 3:
            tilt.append((sin_ti, cos_ti))
        elif p == 0:
            tilt.append((sin_ti * cos2k[1] - cos_ti * sin2k[1],
                         cos_ti * cos2k[1] + sin_ti * sin2k[1]))
        else:
            tilt.append((sin_ti * cos2k[k[p]] + cos_ti * sin2k[k[p]],
                         cos_ti * cos2k[k[p]] - sin_ti * sin2k[k[p]]))
    sin_ti = _pick(p_sel, [t[0] for t in tilt])
    cos_ti = _pick(p_sel, [t[1] for t in tilt])

    # the azimuth (:394-409)
    dphi_lobe = torch.where(
        p_sel == 0, _phi_lobe(0, gamma_o, gamma_t), torch.where(
            p_sel == 1, _phi_lobe(1, gamma_o, gamma_t), torch.where(
                p_sel == 2, _phi_lobe(2, gamma_o, gamma_t),
                torch.zeros_like(gamma_t))))
    dphi_smooth = dphi_lobe + _sample_trimmed_logistic(u4[..., 1], s)
    dphi = torch.where(p_sel < 3, dphi_smooth, 2.0 * PI * u4[..., 1])
    phi_i = phi_o + dphi
    wi = torch.stack([sin_ti, cos_ti * torch.cos(phi_i),
                      cos_ti * torch.sin(phi_i)], -1)
    return wi, hair_f(hp, h, wo, wi), hair_pdf(hp, h, wo, wi)


def _compact_1by1(x):
    """The even bits of x packed into its low half."""
    x = x & 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    return (x | (x >> 8)) & 0x0000FFFF


def demux_float(u):
    """DemuxFloat (hair.cpp:36-46): one uniform split in two by
    de-interleaving the bits of u * 2^32 (int64 holds the uint32)."""
    bits = (torch.clamp(u, 0.0, 0.99999994) * 4294967296.0).to(torch.int64)
    a = _compact_1by1(bits)
    b = _compact_1by1(bits >> 1)
    return a.to(torch.float32) / 65536.0, b.to(torch.float32) / 65536.0


def h_from_tube_geometry(n, wo, tangent):
    """The azimuthal offset h in [-1, 1] at a tube's hit: the sine of the
    signed angle between n and -wo projected into the plane across the
    fiber (the reference's stand-in for pbrt's h = -1 + 2v)."""
    def proj(x):
        p = x - dot(x, tangent)[..., None] * tangent
        return p / torch.clamp_min(torch.sqrt(dot(p, p)), 1e-9)[..., None]

    n_az = proj(n)
    o_az = proj(-wo)
    cos_g = torch.clamp(dot(n_az, o_az), -1.0, 1.0)
    sign = torch.sign(dot(cross(o_az, n_az), tangent))
    return sign * _safe_sqrt(1.0 - cos_g * cos_g)
