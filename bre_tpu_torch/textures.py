"""Procedural and image textures, Perlin noise and the EWA image filter
(counterpart of ``bre_tpu/textures.py``; pbrt src/textures/*, the
Noise/FBm/Turbulence of src/core/texture.cpp and the MIPMap of
src/core/mipmap.{h,cpp}).

A tagged ``Textures`` table is evaluated in masked passes per shading batch:
``eval_texture(textures, tex_idx, p, uv)`` returns (R,3) colors.  Nested
graphs (texture-valued ``tex1``/``tex2``) link sub-textures through
``child0``/``child1``; evaluation recurses to the graph's depth, a Python
int fixed when the scene is built (``Textures.depth``), so a flat table
pays one pass.  Image maps share one MIPMap atlas; with ray-differential
footprints they are filtered by the fixed-window EWA of the reference.
Nothing here reads a tensor back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

TEX_CONSTANT = 0
TEX_CHECKERBOARD = 1  # 3D checker (checkerboard.cpp "dimension 3")
TEX_UV = 2
TEX_FBM = 3
TEX_WRINKLED = 4
TEX_MARBLE = 5
TEX_WINDY = 6
TEX_DOTS = 7
TEX_SCALE = 8
TEX_MIX = 9
TEX_IMAGE = 10  # imagemap.cpp + mipmap.h
TEX_BILERP = 11  # bilerp.cpp: 4-corner bilinear over uv

MAX_MIP_LEVELS = 12
MAX_ANISOTROPY = 8.0  # MIPMap maxAnisotropy default (mipmap.h)
_EWA_W = 9  # half-extent of the fixed EWA window, in texels
# exp(-2) in float32: the EWA weight's offset (mipmap.cpp weightLut)
_EXP_M2 = float(np.exp(np.float32(-2.0)))

# texture.cpp NoisePerm: the reference's table (bre_tpu/textures.py,
# numpy RandomState(1619).permutation(256)), stored twice over
_NOISE_PERM_SIZE = 256
_PERM_TABLE = (
    18, 29, 100, 198, 211, 241, 221, 189, 2, 5, 216, 242, 24, 217, 128,
    28, 147, 1, 195, 152, 222, 64, 171, 25, 235, 69, 46, 63, 3, 83, 131,
    6, 107, 12, 8, 233, 172, 16, 94, 72, 112, 193, 162, 250, 141, 218,
    146, 249, 228, 77, 50, 159, 93, 252, 126, 156, 71, 236, 127, 66,
    132, 105, 11, 240, 42, 10, 27, 38, 253, 22, 20, 52, 59, 55, 226,
    244, 44, 192, 157, 74, 238, 239, 7, 196, 224, 45, 161, 96, 65, 136,
    210, 36, 212, 229, 243, 73, 197, 170, 76, 118, 4, 181, 14, 33, 176,
    101, 111, 56, 31, 138, 203, 175, 183, 13, 99, 120, 129, 34, 180,
    113, 178, 204, 54, 90, 190, 255, 80, 185, 88, 85, 213, 26, 115, 102,
    219, 227, 230, 245, 199, 169, 186, 47, 17, 97, 91, 48, 68, 43, 149,
    110, 58, 53, 86, 82, 61, 254, 188, 168, 19, 57, 179, 173, 70, 145,
    114, 154, 23, 9, 139, 84, 79, 60, 95, 155, 223, 125, 103, 62, 130,
    194, 116, 124, 208, 184, 246, 177, 37, 160, 148, 75, 104, 81, 167,
    140, 78, 225, 191, 133, 200, 87, 142, 117, 182, 166, 108, 49, 209,
    237, 89, 144, 123, 205, 151, 248, 232, 32, 220, 251, 106, 109, 92,
    15, 231, 122, 201, 206, 134, 21, 153, 41, 247, 174, 135, 35, 51,
    121, 158, 164, 215, 67, 143, 0, 187, 150, 30, 40, 165, 39, 234, 163,
    137, 214, 207, 202, 119, 98)


class Textures(NamedTuple):
    ttype: torch.Tensor  # (Nt,) int64 TEX_* tag
    c0: torch.Tensor  # (Nt,3) primary color / tex1 constant
    c1: torch.Tensor  # (Nt,3) secondary color / tex2 constant
    scale: torch.Tensor  # (Nt,) spatial frequency; mix amount
    octaves: torch.Tensor  # (Nt,) int64 (stored; fbm runs 6 octaves)
    omega: torch.Tensor  # (Nt,) fbm roughness
    img_off: torch.Tensor  # (Nt,) int64 level-0 atlas row, -1 if none
    img_w: torch.Tensor  # (Nt,) int64 level-0 width
    img_h: torch.Tensor  # (Nt,) int64 level-0 height
    n_levels: torch.Tensor  # (Nt,) int64 pyramid depth
    uv_scale: torch.Tensor  # (Nt,2) (uscale, vscale)
    uv_delta: torch.Tensor  # (Nt,2) (udelta, vdelta)
    atlas: torch.Tensor  # (Ha, Wa, 3) every pyramid's levels; (1,1,3) if none
    child0: torch.Tensor  # (Nt,) int64 sub-texture of slot 0, -1 = c0
    child1: torch.Tensor  # (Nt,) int64 sub-texture of slot 1, -1 = c1
    c2: torch.Tensor  # (Nt,3) bilerp corner v01
    c3: torch.Tensor  # (Nt,3) bilerp corner v10
    perm: torch.Tensor  # (512,) int64 noise permutation, twice over
    depth: int  # the graph's nesting depth (0 = flat table)


def noise_permutation(device) -> torch.Tensor:
    """``Textures.perm``: the permutation table twice over, on ``device``."""
    return torch.as_tensor(np.tile(np.asarray(_PERM_TABLE, np.int64), 2),
                           device=device)


def empty_textures(device="cpu") -> Textures:
    z3 = torch.zeros((0, 3), dtype=torch.float32, device=device)
    z2 = torch.zeros((0, 2), dtype=torch.float32, device=device)
    z = torch.zeros((0,), dtype=torch.float32, device=device)
    zi = torch.zeros((0,), dtype=torch.int64, device=device)
    return Textures(ttype=zi, c0=z3, c1=z3, scale=z, octaves=zi, omega=z,
                    img_off=zi, img_w=zi, img_h=zi, n_levels=zi, uv_scale=z2,
                    uv_delta=z2,
                    atlas=torch.zeros((1, 1, 3), dtype=torch.float32,
                                      device=device),
                    child0=zi, child1=zi, c2=z3, c3=z3,
                    perm=noise_permutation(device), depth=0)


def textures_from_jax(tex, device) -> Textures:
    """A ``bre_tpu`` Textures table (leaves read with ``np.asarray``) ->
    this one on ``device``; the reference's ``nest`` shape marker becomes
    the int ``depth``."""
    def f(x):
        return torch.as_tensor(np.array(x), dtype=torch.float32, device=device)

    def i(x):
        return torch.as_tensor(np.array(x), dtype=torch.int64, device=device)

    return Textures(
        ttype=i(tex.ttype), c0=f(tex.c0), c1=f(tex.c1), scale=f(tex.scale),
        octaves=i(tex.octaves), omega=f(tex.omega), img_off=i(tex.img_off),
        img_w=i(tex.img_w), img_h=i(tex.img_h), n_levels=i(tex.n_levels),
        uv_scale=f(tex.uv_scale), uv_delta=f(tex.uv_delta),
        atlas=f(tex.atlas), child0=i(tex.child0), child1=i(tex.child1),
        c2=f(tex.c2), c3=f(tex.c3), perm=noise_permutation(device),
        depth=int(np.asarray(tex.nest).shape[0]))


def build_pyramid(image: np.ndarray, max_levels: int = MAX_MIP_LEVELS):
    """MIPMap pyramid by 2x2 box filtering (the reference's documented
    simplification of pbrt's Lanczos resampling).  [level0, ...] float32."""
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, -1)
    levels = [img]
    while (img.shape[0] > 1 or img.shape[1] > 1) and len(levels) < max_levels:
        h, w = img.shape[:2]
        h2, w2 = max(h // 2, 1), max(w // 2, 1)
        img = img[: h2 * 2, : w2 * 2].reshape(h2, min(2, h), w2, min(2, w), 3)
        img = img.mean(axis=(1, 3))
        levels.append(img.astype(np.float32))
    return levels


def pack_atlas(pyramids):
    """Every pyramid's levels as consecutive rows of one atlas.
    Returns (atlas (Ha, Wa, 3), level-0 row offsets)."""
    if not pyramids:
        return np.zeros((1, 1, 3), np.float32), []
    wa = max(lv.shape[1] for py in pyramids for lv in py)
    rows = sum(lv.shape[0] for py in pyramids for lv in py)
    atlas = np.zeros((rows, wa, 3), np.float32)
    offs = []
    r = 0
    for py in pyramids:
        offs.append(r)
        for lv in py:
            atlas[r:r + lv.shape[0], : lv.shape[1]] = lv
            r += lv.shape[0]
    return atlas, offs


# ---------------------------------------------------------------------------
# MIPMap lookups
# ---------------------------------------------------------------------------

def _level_geometry(tex: Textures, ti, level):
    """Atlas row offset, width and height of a pyramid level (the levels
    sit one below the other; sizes halve per level)."""
    w0, h0 = tex.img_w[ti], tex.img_h[ti]
    acc = off = tex.img_off[ti]
    w, h = w0, h0
    for lv in range(MAX_MIP_LEVELS):
        w_l = torch.clamp_min(w0 >> lv, 1)
        h_l = torch.clamp_min(h0 >> lv, 1)
        sel = level == lv
        off = torch.where(sel, acc, off)
        w = torch.where(sel, w_l, w)
        h = torch.where(sel, h_l, h)
        acc = acc + h_l
    return off, w, h


def _bilerp_level(tex: Textures, ti, uv, level):
    """MIPMap::Triangle(level, st): bilinear with repeat wrapping."""
    off, w, h = _level_geometry(tex, ti, level)
    s = uv[:, 0] * w.to(torch.float32) - 0.5
    t = uv[:, 1] * h.to(torch.float32) - 0.5
    s0 = torch.floor(s).to(torch.int64)
    t0 = torch.floor(t).to(torch.int64)
    ds = (s - s0)[:, None]
    dt = (t - t0)[:, None]
    w1, h1 = torch.clamp_min(w, 1), torch.clamp_min(h, 1)

    def texel(si, tj):
        return tex.atlas[off + torch.remainder(tj, h1), torch.remainder(si, w1)]

    return ((1 - ds) * (1 - dt) * texel(s0, t0)
            + (1 - ds) * dt * texel(s0, t0 + 1)
            + ds * (1 - dt) * texel(s0 + 1, t0)
            + ds * dt * texel(s0 + 1, t0 + 1))


def image_lookup(tex: Textures, ti, uv, lod=None):
    """MIPMap::Lookup: bilinear on level 0, or trilinear between the two
    levels around ``lod``.  uv (R,2) is the raw surface uv; the texture's
    (uscale, vscale, udelta, vdelta) mapping is applied here."""
    st = uv * tex.uv_scale[ti] + tex.uv_delta[ti]
    if lod is None:
        return _bilerp_level(tex, ti, st, torch.zeros_like(ti))
    nl = torch.clamp_min(tex.n_levels[ti], 1)
    lod = torch.minimum(torch.clamp_min(lod, 0.0), (nl - 1).to(torch.float32))
    l0 = torch.floor(lod).to(torch.int64)
    l1 = torch.minimum(l0 + 1, nl - 1)
    f = (lod - l0.to(torch.float32))[:, None]
    return ((1 - f) * _bilerp_level(tex, ti, st, l0)
            + f * _bilerp_level(tex, ti, st, l1))


def _ewa_level(tex: Textures, ti, st, dst0, dst1, level):
    """MIPMap::EWA on one level over a fixed (2W+1)^2 texel window, the
    texels outside the ellipse weighted zero (the level is picked so the
    minor axis is about a texel and the anisotropy is clamped to
    MAX_ANISOTROPY <= W texels)."""
    off, w, h = _level_geometry(tex, ti, level)
    wf, hf = w.to(torch.float32), h.to(torch.float32)
    s = st[:, 0] * wf - 0.5
    t = st[:, 1] * hf - 0.5
    d0s, d0t = dst0[:, 0] * wf, dst0[:, 1] * hf
    d1s, d1t = dst1[:, 0] * wf, dst1[:, 1] * hf
    # A u^2 + B u v + C v^2 < 1 after the divide by F
    A = d0t * d0t + d1t * d1t + 1.0
    B = -2.0 * (d0s * d0t + d1s * d1t)
    C = d0s * d0s + d1s * d1s + 1.0
    invF = 1.0 / torch.clamp_min(A * C - B * B * 0.25, 1e-12)
    A, B, C = A * invF, B * invF, C * invF

    si0 = torch.round(s).to(torch.int64)
    ti0 = torch.round(t).to(torch.int64)
    w1, h1 = torch.clamp_min(w, 1), torch.clamp_min(h, 1)
    acc = torch.zeros(st.shape[:1] + (3,), dtype=torch.float32,
                      device=st.device)
    wsum = torch.zeros(st.shape[:1], dtype=torch.float32, device=st.device)
    ds_grid = torch.arange(-_EWA_W, _EWA_W + 1, device=st.device)
    ss = si0[:, None] + ds_grid[None, :]  # (R, K)
    uu = ss.to(torch.float32) - s[:, None]
    x = torch.remainder(ss, w1[:, None])
    for dt_ in range(-_EWA_W, _EWA_W + 1):  # one gather per window row
        tt = ti0 + dt_
        vv = tt.to(torch.float32) - t
        r2 = (A[:, None] * uu * uu + B[:, None] * uu * vv[:, None]
              + C[:, None] * vv[:, None] * vv[:, None])
        wgt = torch.where(r2 < 1.0, torch.exp(-2.0 * r2) - _EXP_M2,
                          torch.zeros_like(r2))
        y = torch.remainder(tt, h1)
        acc = acc + (wgt[:, :, None]
                     * tex.atlas[(off + y)[:, None], x]).sum(1)
        wsum = wsum + wgt.sum(1)
    return acc / torch.clamp_min(wsum, 1e-9)[:, None]


def image_lookup_ewa(tex: Textures, ti, uv, duv_dx, duv_dy):
    """MIPMap::Lookup(st, dst0, dst1), the EWA path (mipmap.cpp:230-268):
    order the axes, clamp the eccentricity to MAX_ANISOTROPY, pick the
    level from the minor axis, filter two levels and lerp.  uv and the
    footprints are raw surface uv; the texture's mapping is applied here."""
    sc = tex.uv_scale[ti]
    st = uv * sc + tex.uv_delta[ti]
    dst0 = duv_dx * sc
    dst1 = duv_dy * sc
    l0sq = (dst0 * dst0).sum(-1)
    l1sq = (dst1 * dst1).sum(-1)
    swap = (l0sq < l1sq)[:, None]
    major = torch.where(swap, dst1, dst0)
    minor = torch.where(swap, dst0, dst1)
    maj_len = torch.sqrt(torch.maximum(l0sq, l1sq))
    min_len = torch.sqrt(torch.minimum(l0sq, l1sq))
    need = (min_len * MAX_ANISOTROPY < maj_len) & (min_len > 0)
    scale_f = torch.where(need, maj_len / (min_len * MAX_ANISOTROPY),
                          torch.ones_like(min_len))
    minor = minor * scale_f[:, None]
    min_len = torch.clamp_min(min_len * scale_f, 1e-8)

    nl = torch.clamp_min(tex.n_levels[ti], 1)
    n_levels0 = torch.log2(torch.clamp_min(
        torch.maximum(tex.img_w[ti], tex.img_h[ti]).to(torch.float32), 1.0))
    lod = torch.minimum(torch.clamp_min(n_levels0 + torch.log2(min_len), 0.0),
                        (nl - 1).to(torch.float32))
    lev0 = torch.floor(lod).to(torch.int64)
    lev1 = torch.minimum(lev0 + 1, nl - 1)
    f = (lod - lev0.to(torch.float32))[:, None]
    return ((1 - f) * _ewa_level(tex, ti, st, major, minor, lev0)
            + f * _ewa_level(tex, ti, st, major, minor, lev1))


# ---------------------------------------------------------------------------
# Perlin noise (texture.cpp Noise, Grad, FBm, Turbulence)
# ---------------------------------------------------------------------------

def _grad(perm, x, y, z, dx, dy, dz):
    h = perm[perm[perm[x] + y] + z] & 15
    u = torch.where(h < 8, dx, dy)
    v = torch.where(h < 4, dy, torch.where((h == 12) | (h == 14), dx, dz))
    u = torch.where((h & 1) != 0, -u, u)
    v = torch.where((h & 2) != 0, -v, v)
    return u + v


def _smooth(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def noise(p: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Perlin gradient noise at (..., 3) points, in [-1, 1]; ``perm`` is
    ``Textures.perm``."""
    fl = torch.floor(p)
    pi = fl.to(torch.int64)
    d = p - fl
    ix = pi[..., 0] & (_NOISE_PERM_SIZE - 1)
    iy = pi[..., 1] & (_NOISE_PERM_SIZE - 1)
    iz = pi[..., 2] & (_NOISE_PERM_SIZE - 1)
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    w = [_grad(perm, ix + a, iy + b, iz + c, dx - a, dy - b, dz - c)
         for a in (0, 1) for b in (0, 1) for c in (0, 1)]
    sx, sy, sz = _smooth(dx), _smooth(dy), _smooth(dz)
    x0 = w[0] + sz * (w[1] - w[0])
    x1 = w[2] + sz * (w[3] - w[2])
    x2 = w[4] + sz * (w[5] - w[4])
    x3 = w[6] + sz * (w[7] - w[6])
    y0 = x0 + sy * (x1 - x0)
    y1 = x2 + sy * (x3 - x2)
    return y0 + sx * (y1 - y0)


def fbm(p: torch.Tensor, omega: torch.Tensor, perm: torch.Tensor,
        max_octaves: int = 6) -> torch.Tensor:
    """Fractional Brownian motion (texture.cpp FBm), a fixed octave count
    as in the reference."""
    total = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    lam, o = 1.0, torch.ones_like(total)
    for _ in range(max_octaves):
        total = total + o * noise(p * lam, perm)
        lam = lam * 1.99
        o = o * omega
    return total


def turbulence(p: torch.Tensor, omega: torch.Tensor, perm: torch.Tensor,
               max_octaves: int = 6) -> torch.Tensor:
    total = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    lam, o = 1.0, torch.ones_like(total)
    for _ in range(max_octaves):
        total = total + o * noise(p * lam, perm).abs()
        lam = lam * 1.99
        o = o * omega
    return total


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

def _eval_one_level(tex: Textures, ti, tt, p, uv, v0, v1, duv_dx=None,
                    duv_dy=None) -> torch.Tensor:
    """One masked pass given the sub-values ``v0``/``v1`` (child colors, or
    the stored constants at the base).  ``ti``: clipped slot indices;
    ``tt``: their types."""
    def on(tag):
        return (tt == tag)[:, None]

    R = ti.shape[0]
    c0, c1 = tex.c0[ti], tex.c1[ti]
    s = tex.scale[ti]
    om = tex.omega[ti]
    ps = p * s[:, None]
    perm = tex.perm

    out = v0  # constant
    cell = torch.floor(ps).to(torch.int64)
    par = (cell[:, 0] + cell[:, 1] + cell[:, 2]) & 1
    out = torch.where(on(TEX_CHECKERBOARD),
                      torch.where((par == 0)[:, None], v0, v1), out)
    zero = torch.zeros((R,), dtype=torch.float32, device=p.device)
    uv_col = torch.stack([uv[:, 0] % 1.0, uv[:, 1] % 1.0, zero], -1)
    out = torch.where(on(TEX_UV), uv_col, out)
    # fbm, wrinkled, marble and windy share one base fbm
    f_base = fbm(ps, om, perm)
    f = f_base[:, None]
    out = torch.where(on(TEX_FBM), v0 * (0.5 + 0.5 * f), out)
    out = torch.where(on(TEX_WRINKLED), v0 * turbulence(ps, om, perm)[:, None],
                      out)
    m = torch.sin(ps[:, 1] + 4.0 * f_base)[:, None] * 0.5 + 0.5
    out = torch.where(on(TEX_MARBLE), c0 * m + c1 * (1.0 - m), out)
    wstrength = fbm(ps * 0.1, om, perm).abs()
    wheight = f_base.abs()
    out = torch.where(on(TEX_WINDY), v0 * (wstrength * wheight)[:, None], out)
    # polka dots over uv cells
    dd = uv - torch.floor(uv + 0.5)
    inside = (dd * dd).sum(-1) < 0.35 * 0.35
    out = torch.where(on(TEX_DOTS), torch.where(inside[:, None], v0, v1), out)
    # bilerp corners v00 = c0, v01 = c2, v10 = c3, v11 = c1
    if tex.c2.shape[0]:
        su = (uv[:, 0] % 1.0)[:, None]
        tv = (uv[:, 1] % 1.0)[:, None]
        bl = ((1 - su) * (1 - tv) * c0 + (1 - su) * tv * tex.c2[ti]
              + su * (1 - tv) * tex.c3[ti] + su * tv * c1)
        out = torch.where(on(TEX_BILERP), bl, out)
    out = torch.where(on(TEX_SCALE), v0 * v1, out)
    out = torch.where(on(TEX_MIX), v0 * (1.0 - s[:, None]) + v1 * s[:, None],
                      out)
    # image maps: the atlas is (1,1,3) iff the scene has none
    if tex.atlas.shape[0] > 1:
        if duv_dx is not None and duv_dy is not None:
            img_col = image_lookup_ewa(tex, ti, uv, duv_dx, duv_dy)
        else:
            img_col = image_lookup(tex, ti, uv)
        out = torch.where(on(TEX_IMAGE), v0 * img_col, out)
    return out


def eval_texture(tex: Textures, tex_idx: torch.Tensor, p: torch.Tensor,
                 uv: torch.Tensor, duv_dx=None, duv_dy=None) -> torch.Tensor:
    """Texture colors (R,3) for a shading batch: ``tex_idx`` (R,) (-1 ->
    white), ``p`` (R,3) world positions, ``uv`` (R,2); with ``duv_dx`` and
    ``duv_dy`` (R,2) footprints, image maps use EWA filtering.  Nested
    graphs evaluate bottom-up to ``tex.depth``: the children of both slots
    go through one pass per level, so the lanes double at each level, as
    in the reference."""
    R = tex_idx.shape[0]
    if tex.ttype.shape[0] == 0:
        return torch.ones((R, 3), dtype=torch.float32, device=p.device)

    def cat2(x):
        return None if x is None else torch.cat([x, x], 0)

    def value(ti, pp, uvv, dx, dy, level):
        if level > 0:
            n = ti.shape[0]
            ch0, ch1 = tex.child0[ti], tex.child1[ti]
            both = torch.cat([torch.clamp_min(ch0, 0), torch.clamp_min(ch1, 0)])
            v = value(both, cat2(pp), cat2(uvv), cat2(dx), cat2(dy), level - 1)
            v0 = torch.where((ch0 >= 0)[:, None], v[:n], tex.c0[ti])
            v1 = torch.where((ch1 >= 0)[:, None], v[n:], tex.c1[ti])
        else:
            v0, v1 = tex.c0[ti], tex.c1[ti]
        return _eval_one_level(tex, ti, tex.ttype[ti], pp, uvv, v0, v1, dx, dy)

    ti = torch.clamp(tex_idx, 0, tex.ttype.shape[0] - 1)
    out = value(ti, p, uv, duv_dx, duv_dy, tex.depth)
    return torch.where((tex_idx >= 0)[:, None], out, torch.ones_like(out))

