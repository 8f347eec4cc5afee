"""BSDF sampling and evaluation over the tagged material table
(counterpart of ``bre_tpu/materials.py:123-594``; pbrt reflection.{h,cpp},
microfacet.{h,cpp} and src/materials/{matte,mirror,glass,metal,plastic,
uber,substrate,translucent,mixmat}.cpp).

A batch evaluates every material model as vector math and selects by each
lane's tag, in the reference's order and with its clamps, so a lane takes
the same lobe and Fresnel branch as there.  Directions are world-space;
the shading frame is built per lane from the normal and the dpdu tangent.
Diffuse colors may read the texture table (``kd_tex``).  The hair fiber
BSDF (``hair.py``) scatters on the whole sphere in the fiber's frame, and
the measured Fourier BSDF (``fourier.py``) in the frame of the unflipped
normal; the subsurface materials scatter as glass, their BSSRDF being the
volume path tracer's (bre_tpu/materials.py:405-410).  Each lobe is
computed only where the table holds its tag (``Materials.kinds``).

TransportMode (pbrt material.h:50): ``MODE_RADIANCE`` scales specular
transmission by eta^2 (camera paths), ``MODE_IMPORTANCE`` does not (photon
paths), reflection.cpp:230-238.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .core.math import (INV_PI, absdot, coordinate_system, cross, dot,
                        face_forward, length, length_squared, normalize)
from .core.sampling import cosine_hemisphere_pdf, cosine_sample_hemisphere
from .core.spectrum import luminance
from .scene.scene import (MAT_FOURIER, MAT_GLASS, MAT_HAIR,
                          MAT_KDSUBSURFACE, MAT_MATTE, MAT_METAL, MAT_MIRROR,
                          MAT_MIX, MAT_PLASTIC, MAT_SUBSTRATE,
                          MAT_SUBSURFACE, MAT_TRANSLUCENT, MAT_UBER,
                          Materials)
from .textures import eval_texture

MODE_RADIANCE = 0
MODE_IMPORTANCE = 1

# default conductor: copper at RGB (metal.cpp CopperN / CopperK)
COPPER_ETA = (0.2004, 0.9240, 1.1022)
COPPER_K = (3.9129, 2.4528, 2.1421)


class BSDFSample(NamedTuple):
    wi: torch.Tensor  # (R,3)
    f: torch.Tensor  # (R,3)
    pdf: torch.Tensor  # (R,)
    specular: torch.Tensor  # (R,) bool
    valid: torch.Tensor  # (R,) bool (false => terminate the path)


def reflect(wo: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of wo about n (reflection.h Reflect)."""
    return -wo + 2.0 * dot(wo, n)[..., None] * n


def fr_dielectric(cos_theta_i, eta_i, eta_t):
    """Fresnel reflectance of a dielectric (reflection.cpp:47-76)."""
    cos_i = torch.clamp(cos_theta_i, -1.0, 1.0)
    entering = cos_i > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    cos_i = cos_i.abs()
    sin_i = torch.sqrt(torch.clamp_min(1.0 - cos_i * cos_i, 0.0))
    sin_t = ei / et * sin_i
    tir = sin_t >= 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin_t * sin_t, 0.0))
    r_parl = (et * cos_i - ei * cos_t) / torch.clamp_min(
        et * cos_i + ei * cos_t, 1e-12)
    r_perp = (ei * cos_i - et * cos_t) / torch.clamp_min(
        ei * cos_i + et * cos_t, 1e-12)
    f = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(tir, torch.ones_like(f), f)


def fr_conductor(cos_theta_i, eta, k):
    """Fresnel of a conductor per channel (reflection.cpp:78-109):
    cos_theta_i (R,), eta and k (R,3) -> (R,3)."""
    c = torch.clamp(cos_theta_i.abs(), 0.0, 1.0)[:, None]
    c2 = c * c
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - s2
    a2b2 = torch.sqrt(torch.clamp_min(t0 * t0 + 4.0 * e2 * k2, 0.0))
    t1 = a2b2 + c2
    a = torch.sqrt(torch.clamp_min(0.5 * (a2b2 + t0), 0.0))
    t2 = 2.0 * a * c
    rs = (t1 - t2) / torch.clamp_min(t1 + t2, 1e-12)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / torch.clamp_min(t3 + t4, 1e-12)
    return 0.5 * (rp + rs)


def roughness_to_alpha(rough):
    """TrowbridgeReitzDistribution::RoughnessToAlpha (microfacet.h:86-95)."""
    x = torch.log(torch.clamp_min(rough, 1e-3))
    return (1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x ** 3
            + 0.000640711 * x ** 4)


def _ggx_d(cos_h, alpha):
    """Isotropic GGX (Trowbridge-Reitz) distribution D."""
    c2 = cos_h * cos_h
    a2 = alpha * alpha
    denom = c2 * (a2 - 1.0) + 1.0
    return a2 / torch.clamp_min(math.pi * denom * denom, 1e-12)


def _ggx_lambda(cos_w, alpha):
    c2 = torch.clamp(cos_w * cos_w, 1e-6, 1.0)
    tan2 = (1.0 - c2) / c2
    return 0.5 * (-1.0 + torch.sqrt(1.0 + alpha * alpha * tan2))


def _ggx_g(cos_o, cos_i, alpha):
    return 1.0 / (1.0 + _ggx_lambda(cos_o, alpha) + _ggx_lambda(cos_i, alpha))


def _ggx_sample_wh(u, alpha):
    """Sample the GGX distribution (microfacet.cpp Sample_wh): local xyz."""
    c2 = (1.0 - u[:, 0]) / torch.clamp_min(
        1.0 + (alpha * alpha - 1.0) * u[:, 0], 1e-12)
    cos_h = torch.sqrt(torch.clamp(c2, 0.0, 1.0))
    sin_h = torch.sqrt(torch.clamp_min(1.0 - c2, 0.0))
    phi = 2.0 * math.pi * u[:, 1]
    return torch.stack([sin_h * torch.cos(phi), sin_h * torch.sin(phi),
                        cos_h], -1)


def _effective_kd(materials: Materials, mi, kd, textures, p, uv,
                  duv_dx=None, duv_dy=None):
    """kd times the kd texture where the material has one
    (materials.py:212-223); with no ``uv`` the texture is read at
    ``p[:, :2]``, as the reference does."""
    if textures is None or p is None:
        return kd
    tex_idx = materials.kd_tex[mi]
    col = eval_texture(textures, tex_idx, p, uv if uv is not None else p[:, :2],
                       duv_dx=duv_dx, duv_dy=duv_dy)
    return torch.where((tex_idx >= 0)[:, None], kd * col, kd)


def _holds(materials: Materials):
    """holds(tag): whether the table has a material of that tag, read from
    ``Materials.kinds`` on the host (no device sync, so a CUDA graph can
    hold the caller): the lobes of absent tags are not computed, which
    changes no lane's result."""
    kinds = materials.kinds
    return lambda tag: bool(kinds[tag])


# the tags that scatter as smooth glass (subsurface.cpp:63-66)
_GLASS_LIKE = (MAT_GLASS, MAT_SUBSURFACE, MAT_KDSUBSURFACE)


def _holds_fourier(materials: Materials) -> bool:
    """The Fourier lobe runs where the table holds the tag and has tables
    to gather from (materials.py:59-69)."""
    return (bool(materials.kinds[MAT_FOURIER])
            and materials.fourier_tables.mu.shape[0] > 0)


def _hair_frame(n, wo, tangent):
    """The hair frame (materials.py:97-121): X the fiber tangent (a
    canonical axis from the normal where a lane has none), Z the normal
    across it, Y = Z x X; and the azimuthal offset h."""
    from .hair import h_from_tube_geometry

    has_t = (length(tangent) > 1e-6)[:, None]
    fx, _ = coordinate_system(n)
    X = torch.where(has_t, tangent, fx)
    X = X / torch.clamp_min(torch.sqrt(dot(X, X)), 1e-9)[:, None]
    Z = n - dot(n, X)[:, None] * X
    Z = Z / torch.clamp_min(torch.sqrt(dot(Z, Z)), 1e-9)[:, None]
    Y = cross(Z, X)

    def to_local(w):
        return torch.stack([dot(w, X), dot(w, Y), dot(w, Z)], -1)

    def to_world(wl):
        return wl[:, 0:1] * X + wl[:, 1:2] * Y + wl[:, 2:3] * Z

    return to_local, to_world, h_from_tube_geometry(n, wo, X)


def _hair_params(materials: Materials, mi, kd):
    """HairParams of the lanes' rows: sigma_a in kd, beta_m in roughness
    (builder.py:184-208)."""
    from .hair import HairParams

    return HairParams(sigma_a=kd, eta=materials.eta[mi],
                      beta_m=torch.clamp(materials.roughness[mi], 1e-3, 1.0),
                      beta_n=torch.clamp(materials.beta_n[mi], 1e-3, 1.0),
                      alpha=materials.hair_alpha[mi])


def _fourier_frame(materials: Materials, mi, n):
    """The Fourier lobe's table rows and its frame from the unflipped
    normal, so the mu sign convention holds (materials.py:458-468)."""
    ft = materials.fourier_tables
    tidx = torch.clamp(materials.fourier[mi], 0, ft.mu.shape[0] - 1)
    fvx, fvy = coordinate_system(n)

    def to_local(w):
        return torch.stack([dot(w, fvx), dot(w, fvy), dot(w, n)], -1)

    return ft, tidx, fvx, fvy, to_local


def _to_world(w_local, vx, vy, ns):
    return normalize(w_local[:, 0:1] * vx + w_local[:, 1:2] * vy
                     + w_local[:, 2:3] * ns)


def sample_bsdf(materials: Materials, mat_idx: torch.Tensor, n: torch.Tensor,
                wo: torch.Tensor, u: torch.Tensor, mode: int = MODE_RADIANCE,
                textures=None, p: Optional[torch.Tensor] = None,
                uv: Optional[torch.Tensor] = None,
                tangent: Optional[torch.Tensor] = None,
                duv_dx: Optional[torch.Tensor] = None,
                duv_dy: Optional[torch.Tensor] = None) -> BSDFSample:
    """Batched BSDF::Sample_f (reflection.cpp:568-615).  ``n``: the
    shading normal; ``wo``: unit, away from the surface; ``u`` (R,2):
    u[:,0] also picks the lobe (remapped), as pbrt's component choice."""
    R = mat_idx.shape[0]
    dev = n.device
    nm = materials.mtype.shape[0]
    if nm == 0:
        z3 = torch.zeros((R, 3), dtype=torch.float32, device=dev)
        zb = torch.zeros((R,), dtype=torch.bool, device=dev)
        return BSDFSample(z3, z3, z3[:, 0], zb, zb)
    has_mat = mat_idx >= 0
    mi = torch.clamp(mat_idx, 0, nm - 1)
    one = torch.ones((R,), dtype=torch.float32, device=dev)
    holds = _holds(materials)

    # mix: one-sample choice of a sub-material (mixmat.cpp), m1 with
    # probability lum(amount), reweighted
    mix_scale = None
    if holds(MAT_MIX):
        is_mix = materials.mtype[mi] == MAT_MIX
        amt = materials.mix_amount[mi]
        p1 = torch.clamp(luminance(amt), 0.01, 0.99)
        choose1 = u[:, 0] < p1
        u0r = torch.where(choose1, u[:, 0] / p1, (u[:, 0] - p1) / (1.0 - p1))
        u = torch.where(is_mix[:, None], torch.stack([u0r, u[:, 1]], -1), u)
        sub = torch.where(choose1, materials.mix_m1[mi], materials.mix_m2[mi])
        mi = torch.where(is_mix, torch.clamp(sub, 0, nm - 1), mi)
        mix_scale = torch.where(
            is_mix[:, None],
            torch.where(choose1[:, None], amt / p1[:, None],
                        (1.0 - amt) / (1.0 - p1)[:, None]),
            torch.ones_like(amt))

    mtype = materials.mtype[mi]
    kd = _effective_kd(materials, mi, materials.kd[mi], textures, p, uv,
                       duv_dx, duv_dy)
    ks = materials.ks[mi]
    eta = materials.eta[mi]
    alpha = torch.clamp(materials.roughness[mi], 1e-3, 1.0)

    # pbrt's BSDF frame (reflection.h:429-438, 502-505): ss = normalize of
    # dpdu from the unflipped normal, z on wo's side
    ns = face_forward(n, wo)
    t_in = tangent if tangent is not None else torch.zeros_like(n)
    ss_raw = t_in - n * dot(t_in, n)[:, None]
    ss_len = torch.sqrt(length_squared(ss_raw))
    ss_ok = (ss_len > 1e-6)[:, None]
    ss = ss_raw / torch.clamp_min(ss_len, 1e-12)[:, None]
    cvx, cvy = coordinate_system(ns)
    vx = torch.where(ss_ok, ss, cvx)
    vy = torch.where(ss_ok, cross(n, ss), cvy)
    cos_o = torch.clamp_min(absdot(wo, ns), 1e-6)

    # matte: cosine-sampled Lambertian (reflection.h:343-360), the default
    wl = cosine_sample_hemisphere(u)
    wi_matte = _to_world(wl, vx, vy, ns)
    pdf_matte = cosine_hemisphere_pdf(torch.clamp_min(wl[:, 2], 0.0))
    f_matte = kd * INV_PI
    # (mask, wi, f, pdf) of each other lobe the table holds, in the
    # reference's select order; the tags are disjoint
    lobes = []
    lobe_ok = torch.ones((R,), dtype=torch.bool, device=dev)

    if holds(MAT_MIRROR):
        # SpecularReflection with Fresnel 1 (mirror.cpp)
        wi_mirror = reflect(wo, ns)
        cos_mirror = torch.clamp_min(absdot(wi_mirror, ns), 1e-6)
        lobes.append((mtype == MAT_MIRROR, wi_mirror,
                      kd / cos_mirror[:, None], one))

    has_glass = any(holds(t) for t in _GLASS_LIKE)
    if has_glass:
        # FresnelSpecular (reflection.cpp:217-260); the subsurface
        # materials' BSDF too
        cos_i_sgn = dot(n, wo)
        F_g = fr_dielectric(cos_i_sgn, one, eta)
        choose_refl = u[:, 0] < F_g
        wi_g_refl = reflect(wo, ns)
        entering = cos_i_sgn > 0.0
        eta_rel = torch.where(entering, 1.0 / eta, eta)
        cos_ti = absdot(wo, ns)
        sin2_t = eta_rel * eta_rel * torch.clamp_min(1.0 - cos_ti * cos_ti,
                                                     0.0)
        cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
        wi_g_refr = normalize(eta_rel[:, None] * -wo
                              + (eta_rel * cos_ti - cos_t)[:, None] * ns)
        cos_refl = torch.clamp_min(absdot(wi_g_refl, ns), 1e-6)
        cos_refr = torch.clamp_min(absdot(wi_g_refr, ns), 1e-6)
        f_g_refl = (F_g / cos_refl)[:, None] * kd
        scale = eta_rel * eta_rel if mode == MODE_RADIANCE else one
        f_g_refr = ((1.0 - F_g) * scale / cos_refr)[:, None] * ks
        c3 = choose_refl[:, None]
        is_glass = mtype == MAT_GLASS
        for tag in _GLASS_LIKE[1:]:
            if holds(tag):
                is_glass = is_glass | (mtype == tag)
        lobes.append((is_glass,
                      torch.where(c3, wi_g_refl, wi_g_refr),
                      torch.where(c3, f_g_refl, f_g_refr),
                      torch.where(choose_refl, F_g, 1.0 - F_g)))

    if holds(MAT_METAL):
        # GGX reflection with conductor Fresnel
        wh = _to_world(_ggx_sample_wh(u, alpha), vx, vy, ns)
        wi_mf = reflect(wo, wh)
        cos_i_mf = dot(wi_mf, ns)
        cos_h = torch.clamp_min(dot(wh, ns), 1e-6)
        D = _ggx_d(cos_h, alpha)
        cos_i_mf_c = torch.clamp_min(cos_i_mf, 1e-6)
        G = _ggx_g(cos_o, cos_i_mf_c, alpha)
        do_wh = torch.clamp_min(absdot(wo, wh), 1e-6)
        F_meta = fr_conductor(do_wh, materials.metal_eta[mi],
                              materials.metal_k[mi])
        is_metal = mtype == MAT_METAL
        lobes.append((is_metal, wi_mf,
                      ks * F_meta * (D * G / (4.0 * cos_o * cos_i_mf_c))[:, None],
                      D * cos_h / (4.0 * do_wh)))
        lobe_ok = torch.where(is_metal, cos_i_mf > 1e-4, lobe_ok)

    has_plastic = holds(MAT_PLASTIC) or holds(MAT_UBER)
    if has_plastic or holds(MAT_TRANSLUCENT):
        # plastic / uber / translucent pick a lobe by u[:,0], remapped
        choose_spec = u[:, 0] < 0.5
        u_rm = torch.stack([torch.where(choose_spec, u[:, 0] * 2.0,
                                        (u[:, 0] - 0.5) * 2.0), u[:, 1]], -1)
        wl2 = cosine_sample_hemisphere(u_rm)
        wi_diff2 = _to_world(wl2, vx, vy, ns)
    if has_plastic:
        wi_spec2 = reflect(wo, _to_world(_ggx_sample_wh(u_rm, alpha), vx, vy,
                                         ns))
        wi_plastic = torch.where(choose_spec[:, None], wi_spec2, wi_diff2)
        cos_i_p = torch.clamp_min(dot(wi_plastic, ns), 1e-6)
        whp = normalize(wo + wi_plastic)
        cos_hp = torch.clamp_min(dot(whp, ns), 1e-6)
        Dp = _ggx_d(cos_hp, alpha)
        Gp = _ggx_g(cos_o, cos_i_p, alpha)
        Fp = fr_dielectric(absdot(wo, whp), one,
                           torch.clamp_min(eta, 1.01))[:, None]
        is_plastic = (mtype == MAT_PLASTIC) | (mtype == MAT_UBER)
        lobes.append((
            is_plastic, wi_plastic,
            kd * INV_PI + ks * Fp * (Dp * Gp / (4.0 * cos_o * cos_i_p))[:, None],
            0.5 * (cosine_hemisphere_pdf(cos_i_p)
                   + Dp * cos_hp / (4.0 * torch.clamp_min(absdot(wo, whp),
                                                          1e-6)))))
        lobe_ok = torch.where(is_plastic, dot(wi_plastic, ns) > 1e-4, lobe_ok)

    if holds(MAT_SUBSTRATE):
        # FresnelBlend's diffuse term (reflection.h:468-500)
        lobes.append((
            mtype == MAT_SUBSTRATE, wi_matte,
            kd * INV_PI * (28.0 / 23.0)
            * (1.0 - (1.0 - 0.5 * cos_o[:, None]) ** 5)
            * (1.0 - (1.0 - 0.5 * torch.clamp_min(wl[:, 2], 0.0)[:, None])
               ** 5),
            pdf_matte))

    if holds(MAT_TRANSLUCENT):
        # Lambertian reflection or transmission
        lobes.append((mtype == MAT_TRANSLUCENT,
                      torch.where(choose_spec[:, None], wi_diff2, -wi_diff2),
                      0.5 * (kd + ks) * INV_PI,
                      0.5 * cosine_hemisphere_pdf(wl2[:, 2].abs())))

    wi, f, pdf = wi_matte, f_matte, pdf_matte
    specular = torch.zeros((R,), dtype=torch.bool, device=dev)
    for mask, l_wi, l_f, l_pdf in lobes:
        m3 = mask[:, None]
        wi = torch.where(m3, l_wi, wi)
        f = torch.where(m3, l_f, f)
        pdf = torch.where(mask, l_pdf, pdf)
    for tag in (MAT_MIRROR,) + _GLASS_LIKE:
        if holds(tag):
            specular = specular | (mtype == tag)
    if mix_scale is not None:
        f = f * mix_scale

    # the hair fiber BSDF (hair.cpp Sample_f) and the FourierBSDF
    # (reflection.cpp:523-600) scatter on the whole sphere; they replace
    # the lanes' lobes after the mix's scale, as in the reference
    if holds(MAT_HAIR):
        from .hair import demux_float, hair_sample_f

        is_hair = mtype == MAT_HAIR
        to_local, to_world, h_off = _hair_frame(n, wo, t_in)
        ua, ub = demux_float(u[:, 0])
        uc, ud = demux_float(u[:, 1])
        wi_hl, f_h, pdf_h = hair_sample_f(
            _hair_params(materials, mi, kd), h_off, to_local(wo),
            torch.stack([ua, ub, uc, ud], -1))
        h3 = is_hair[:, None]
        wi = torch.where(h3, normalize(to_world(wi_hl)), wi)
        f = torch.where(h3, f_h, f)
        pdf = torch.where(is_hair, pdf_h, pdf)
        lobe_ok = lobe_ok | is_hair
    if _holds_fourier(materials):
        from .fourier import fourier_sample_f

        is_fourier = mtype == MAT_FOURIER
        ft, tidx, fvx, fvy, to_local = _fourier_frame(materials, mi, n)
        wi_fl, f_f, pdf_f = fourier_sample_f(ft, tidx, to_local(wo), u, mode)
        f3 = is_fourier[:, None]
        wi = torch.where(f3, normalize(wi_fl[:, 0:1] * fvx
                                       + wi_fl[:, 1:2] * fvy
                                       + wi_fl[:, 2:3] * n), wi)
        f = torch.where(f3, f_f, f)
        pdf = torch.where(is_fourier, pdf_f, pdf)
        lobe_ok = lobe_ok | is_fourier
    valid = has_mat & lobe_ok & (pdf > 0.0) & (f.abs().sum(-1) > 0.0)
    return BSDFSample(wi=wi, f=f, pdf=pdf, specular=specular, valid=valid)


def eval_bsdf(materials: Materials, mat_idx, n, wo, wi, textures=None,
              p: Optional[torch.Tensor] = None,
              uv: Optional[torch.Tensor] = None,
              tangent: Optional[torch.Tensor] = None,
              duv_dx: Optional[torch.Tensor] = None,
              duv_dy: Optional[torch.Tensor] = None):
    """Batched BSDF::f and Pdf of the non-specular lobes
    (reflection.cpp:617-637): (f (R,3), pdf (R,)).  Mirror and glass give
    (0, 0), as delta lobes never evaluate; a mix blends its two
    sub-materials, one level deep and without the tangent, as the
    reference's does (materials.py:492-505); the hair lobe reads the
    fiber ``tangent``."""
    nm = materials.mtype.shape[0]
    if nm == 0:
        return (torch.zeros(mat_idx.shape + (3,), dtype=torch.float32,
                            device=n.device),
                torch.zeros(mat_idx.shape, dtype=torch.float32,
                            device=n.device))
    f, pdf = _eval_bsdf_base(materials, mat_idx, n, wo, wi, textures, p, uv,
                             tangent, duv_dx, duv_dy)
    if not _holds(materials)(MAT_MIX):
        return f, pdf
    mi0 = torch.clamp(mat_idx, 0, nm - 1)
    is_mix = (mat_idx >= 0) & (materials.mtype[mi0] == MAT_MIX)
    amt = materials.mix_amount[mi0]
    neg = torch.full_like(mat_idx, -1)
    m1 = torch.where(is_mix, materials.mix_m1[mi0], neg)
    m2 = torch.where(is_mix, materials.mix_m2[mi0], neg)
    f1, pdf1 = _eval_bsdf_base(materials, m1, n, wo, wi, textures, p, uv)
    f2, pdf2 = _eval_bsdf_base(materials, m2, n, wo, wi, textures, p, uv)
    p1 = torch.clamp(luminance(amt), 0.01, 0.99)
    f = torch.where(is_mix[:, None], amt * f1 + (1.0 - amt) * f2, f)
    pdf = torch.where(is_mix, p1 * pdf1 + (1.0 - p1) * pdf2, pdf)
    return f, pdf


def _eval_bsdf_base(materials: Materials, mat_idx, n, wo, wi, textures=None,
                    p=None, uv=None, tangent=None, duv_dx=None, duv_dy=None):
    holds = _holds(materials)
    has_mat = mat_idx >= 0
    mi = torch.clamp(mat_idx, 0, materials.mtype.shape[0] - 1)
    mtype = materials.mtype[mi]
    kd = _effective_kd(materials, mi, materials.kd[mi], textures, p, uv,
                       duv_dx, duv_dy)
    ns = face_forward(n, wo)
    cos_o = torch.clamp_min(absdot(wo, ns), 1e-6)
    cos_i = dot(wi, ns)
    same_hemi = (cos_i > 0.0) & (dot(wo, ns) > 0.0)
    cos_i_c = torch.clamp_min(cos_i, 1e-6)

    f_lam = kd * INV_PI
    pdf_lam = cosine_hemisphere_pdf(cos_i_c)
    zero3 = torch.zeros_like(f_lam)
    zero = torch.zeros_like(pdf_lam)
    is_diffuse = (mtype == MAT_MATTE) | (mtype == MAT_SUBSTRATE)
    f = torch.where(is_diffuse[:, None], f_lam, zero3)
    pdf = torch.where(is_diffuse, pdf_lam, zero)

    has_metal = holds(MAT_METAL)
    has_plastic = holds(MAT_PLASTIC) or holds(MAT_UBER)
    if has_metal or has_plastic:
        ks = materials.ks[mi]
        alpha = torch.clamp(materials.roughness[mi], 1e-3, 1.0)
        wh = normalize(wo + wi)
        cos_h = torch.clamp_min(dot(wh, ns), 1e-6)
        D = _ggx_d(cos_h, alpha)
        G = _ggx_g(cos_o, cos_i_c, alpha)
        do_wh = torch.clamp_min(absdot(wo, wh), 1e-6)
        dg = (D * G / (4.0 * cos_o * cos_i_c))[:, None]
        pdf_mf = D * cos_h / (4.0 * do_wh)
    if has_metal:
        is_metal = mtype == MAT_METAL
        F_meta = fr_conductor(do_wh, materials.metal_eta[mi],
                              materials.metal_k[mi])
        f = torch.where(is_metal[:, None], ks * F_meta * dg, f)
        pdf = torch.where(is_metal, pdf_mf, pdf)
    if has_plastic:
        is_plastic = (mtype == MAT_PLASTIC) | (mtype == MAT_UBER)
        F_diel = fr_dielectric(do_wh, torch.ones_like(cos_o),
                               torch.clamp_min(materials.eta[mi], 1.01))[:, None]
        f = torch.where(is_plastic[:, None], f_lam + ks * F_diel * dg, f)
        pdf = torch.where(is_plastic, 0.5 * (pdf_lam + pdf_mf), pdf)
    f = torch.where(same_hemi[:, None], f, zero3)
    pdf = torch.where(same_hemi, pdf, zero)
    if holds(MAT_TRANSLUCENT):
        # translucent evaluates on both hemispheres
        is_transl = mtype == MAT_TRANSLUCENT
        f = torch.where(is_transl[:, None],
                        0.5 * (kd + materials.ks[mi]) * INV_PI, f)
        pdf = torch.where(is_transl, 0.5 * cosine_hemisphere_pdf(cos_i.abs()),
                          pdf)
    if holds(MAT_HAIR):
        # hair.cpp f / Pdf
        from .hair import hair_f, hair_pdf

        is_hair = mtype == MAT_HAIR
        t_in = tangent if tangent is not None else torch.zeros_like(n)
        to_local, _, h_off = _hair_frame(n, wo, t_in)
        hp = _hair_params(materials, mi, kd)
        wo_l, wi_l = to_local(wo), to_local(wi)
        f = torch.where(is_hair[:, None], hair_f(hp, h_off, wo_l, wi_l), f)
        pdf = torch.where(is_hair, hair_pdf(hp, h_off, wo_l, wi_l), pdf)
    if _holds_fourier(materials):
        # FourierBSDF f / Pdf (reflection.cpp:307-361, 602-641)
        from .fourier import fourier_f, fourier_pdf

        is_fourier = mtype == MAT_FOURIER
        ft, tidx, _, _, to_local = _fourier_frame(materials, mi, n)
        wo_l, wi_l = to_local(wo), to_local(wi)
        f = torch.where(is_fourier[:, None],
                        fourier_f(ft, tidx, wo_l, wi_l, MODE_RADIANCE), f)
        pdf = torch.where(is_fourier, fourier_pdf(ft, tidx, wo_l, wi_l), pdf)
    return (torch.where(has_mat[:, None], f, zero3),
            torch.where(has_mat, pdf, zero))
