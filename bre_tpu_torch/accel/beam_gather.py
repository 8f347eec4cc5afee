"""Beam radiance gather (counterpart of ``bre_tpu/accel/beam_gather.py``):
the non-packed route of ``gather_beams_bruteforce`` and the packed route of
``gather_beams_packed``.

Non-packed route (beam_gather.py:150-823, 839-890, 1468-1485), what the
default config takes (``grad_geometry=True``) and every setting the packed
route does not serve: per call, the beams are validity-sorted (or arrive
sorted by ``compact_beams``), padded to ``gather_chunk`` and gathered by
``_GatherCore``.  ``backend="xla"`` (``gather="brute"``) runs the
reference's XLA chunk scan as plain torch, forward and backward;
``backend="pallas"`` launches the forward kernel of ``ops/gather.py`` on
the non-packed layout with no block mask.  ``kernel=KERNEL_COMPAT``, the
reference renderer's own unnormalized conical kernel, always takes the
chunk scan, on the card too: the reference keeps it dense XLA
(photonbeam.py:181-182), and the forward kernel computes the normalized
estimate only (``_pallas_forward`` refuses any other kernel id).  The
backward recomputes each
chunk's ``_chunk_contrib`` under autograd (the reference's O(rays x chunk)
custom VJP), split into pieces of at most ``_REF_BATCH_PAIRS_*`` pairs; with
the geometry detached (``grad_geometry=False``) and ``PALLAS_BWD_ENABLED``,
the pallas backend takes the analytic backward kernels instead:
``PALLAS_BWD_MODE`` "fused" (Queue 2 row 3) or "twopass" (row 6).  The
differentiable plain torch keeps the reference's tie semantics: every clip,
max and min goes through ``torch.maximum`` / ``torch.minimum``, which split
the cotangent at an exact tie as ``jnp.maximum`` / ``jnp.clip`` do (a
``torch.clamp`` would give it all to the input).

Packed route: the beam buffer is validity-compacted and Morton-sorted once per camera pass
(``pack_beams_compact``); each depth step puts its camera segments in
Morton order of their midpoints (``_ray_order``, so a ray tile's box is
small), packs them, builds the exact chunk x tile AABB cull mask
(``_block_overlap_mask``) and runs the
kernels of ``ops/gather.py``, picking at run time between the sparse
live-block kernel (live blocks within ``sparse_cap``) and the dense masked
kernel, as the reference does.  Ray tiles and beam chunks are 256 wide on
every device: the reference's own off-TPU branch (``_pallas_tile``,
beam_gather.py:74-75), so the pick matches it.

Grid-density media take the heterogeneous layouts: per segment, the
polynomial tables of ``medium_interval_poly`` (K = 8 quadrature nodes of the
trilinear density, fitted by fixed least-squares maps), once per camera
pass for the beams (packed beside them) and per sweep for the camera
segments.

The gradient is the reference's custom VJP (``_packed_bwd``): geometry is
detached where the reference stop-gradients it, and ``_GatherCorePacked``
returns the analytic cotangents of the backward kernels of
``ops/gather_bwd.py`` for the beam powers and radii, the camera
transmittance, sigma_s and g, and in grid media the tables' coefficients
(and through them the density grid and sigma_t), on the CPU and on the card
alike.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import transform as tfm
from ..core.math import cross, dot, length
from ..media import gather_medium, grid_density, phase_hg
from ..ops.gather import (_REF_BATCH_PAIRS_CARD, _REF_BATCH_PAIRS_CPU, BF_B0,
                          BF_B1, BF_PE, BF_PS, BF_RAD, BF_VALID, NB,
                          POLY_D_COEFS, POLY_DENS_COEFS, RF_A0, RF_A1, RF_DC,
                          RF_DENSC, RF_G, RF_INMED, RF_SIGS, RF_SIGTC, RF_TR,
                          gather_forward, gather_sparse, is_hetero,
                          pack_beams, pack_rays, ray_rows, sparse_block_ids,
                          tile_rows)
from ..ops.gather_bwd import (DR_CAMR, DR_DC, DR_DENS, DR_G, DR_SIGS,
                              DR_SIGTC, DR_TR, NDR, gather_backward_fused,
                              gather_backward_sparse, gather_backward_twopass,
                              sparse_block_ids_chunk_major)
from ..scene.scene import Media
from ..utils import stats
from .lbvh import morton3

TILE = 256  # camera segments per ray tile
CHUNK = 256  # beams per packed chunk

KERNEL_BRE = 0  # the normalized 1D-1D beam radiance estimate
KERNEL_COMPAT = 1  # the reference renderer's unnormalized conical kernel

HETERO_NODES = 8  # quadrature nodes per segment in grid media
POLY_D_DEG = 5  # D(f) = c1 f + ... + c5 f^5
POLY_DENS_DEG = 5  # dens(f) = e0 + e1 f + ... + e5 f^5

# The analytic backward of the non-packed route (grad_geometry=False,
# KERNEL_BRE, homogeneous media), beam_gather.py:612-620: "fused", the
# one-sweep kernels (the default), or "twopass", the historical two-pass
# kernels; PALLAS_BWD_ENABLED False takes the recompute backward.
PALLAS_BWD_ENABLED = True
PALLAS_BWD_MODE = "fused"  # "fused" | "twopass"


def medium_interval_nodes(media: Media, med_idx, p0, p1, K: int = HETERO_NODES):
    """Factored per-segment node tables (beam_gather.py:196-236) for
    segments p0 -> p1 (N, 3): ``(dk, dens, sigma_t)``, dk (N, K) the
    density times len/K at K midpoints (0 outside media), dens (N, K) the
    trilinear density (1 for homogeneous media and outside), sigma_t (N, 3)
    the segment medium's constant extinction (not masked: dk = 0 zeroes
    both tau and its sigma_t cotangent outside media)."""
    sigma_a, sigma_s, _, is_grid, in_med = gather_medium(media, med_idx)
    sigma_t = sigma_a + sigma_s
    seg_len = length(p1 - p0)
    fr = (torch.arange(K, dtype=torch.float32, device=p0.device) + 0.5) / K
    pts = p0[:, None, :] + fr[None, :, None] * (p1 - p0)[:, None, :]
    one = torch.ones((), dtype=torch.float32, device=p0.device)
    if media.density.numel() > 1:
        # grid_density samples medium space [0,1]^3 (grid.cpp:46-60)
        dens = grid_density(media.density,
                            tfm.apply_point(media.world_to_medium, pts))
        dens = torch.where(is_grid[:, None], dens, one)
    else:
        dens = torch.ones(seg_len.shape + (K,), dtype=torch.float32,
                          device=p0.device)
    dk = torch.where(in_med[:, None], dens * (seg_len / K)[:, None],
                     torch.zeros((), dtype=torch.float32, device=p0.device))
    dens = torch.where(in_med[:, None], dens, one)
    return dk, dens, sigma_t


@functools.lru_cache(maxsize=None)
def _fit_matrices(K: int):
    """Least-squares maps from K nodes to the polynomial coefficients
    (beam_gather.py:270-282), numpy float32 constants: D from the clamp
    basis of the cumulative sum, dens from the hat basis of the node
    interpolation, both sampled at 129 fractions."""
    fs = np.linspace(0.0, 1.0, 129)
    clamp_basis = np.clip(fs[:, None] * K - np.arange(K)[None, :], 0, 1)
    xq = np.clip(fs * K, 0.5, K - 0.5) - 0.5
    hat_basis = np.clip(1.0 - np.abs(xq[:, None] - np.arange(K)[None, :]), 0, 1)
    VD = np.stack([fs ** i for i in range(1, POLY_D_DEG + 1)], -1)
    VN = np.stack([fs ** i for i in range(0, POLY_DENS_DEG + 1)], -1)
    MD = np.linalg.lstsq(VD, clamp_basis, rcond=None)[0]  # (5, K)
    MN = np.linalg.lstsq(VN, hat_basis, rcond=None)[0]  # (6, K)
    return MD.astype(np.float32), MN.astype(np.float32)


def nodes_to_poly(dk, dens):
    """(N, K) node tables -> (d_poly (N, 5), dens_poly (N, 6)): the fixed
    linear fit maps, so autograd chains the coefficient cotangents back to
    the nodes and through them to the density grid.  Full float32 products
    (matmul TF32 is off by default on the card)."""
    MD, MN = (torch.from_numpy(m).to(dk.device)
              for m in _fit_matrices(dk.shape[-1]))
    return dk @ MD.T, dens @ MN.T


def medium_interval_poly(media: Media, med_idx, p0, p1, K: int = HETERO_NODES):
    """Per-segment polynomial tables: ``(d_poly (N, 5), dens_poly (N, 6),
    sigma_t (N, 3))`` with tau_ch(f) = sigma_t[ch] * D(f)."""
    dk, dens, sigma_t = medium_interval_nodes(media, med_idx, p0, p1, K)
    d_poly, dens_poly = nodes_to_poly(dk, dens)
    return d_poly, dens_poly, sigma_t


# ---------------------------------------------------------------------------
# The non-packed route's pair math, differentiable plain torch
# ---------------------------------------------------------------------------

def _const(x, v):
    return torch.full((), v, dtype=x.dtype, device=x.device)


def _max(x, v):
    """``jnp.maximum(x, v)``: the cotangent splits at an exact tie."""
    return torch.maximum(x, _const(x, v))


def _clip(x, lo, hi):
    """``jnp.clip(x, lo, hi)`` = min(max(x, lo), hi), ties split likewise."""
    return torch.minimum(torch.maximum(x, _const(x, lo)), _const(x, hi))


def _safe_div(cond, num, den):
    """where(cond, num / where(cond, den, 1), 0): both wheres, so neither
    the value nor the cotangent of an unselected lane is inf or NaN."""
    return torch.where(cond, num / torch.where(cond, den, _const(den, 1.0)),
                       _const(num, 0.0))


def closest_points_segments(a0, a1, b0, b1):
    """The reference renderer's ComputeClosestPoints (photonbeam.cpp:87-186;
    beam_gather.py:92-149), branchless: closest points of the infinite
    lines, the camera side clamped to its segment and the beam side
    reprojected, but the beam-side point itself never clamped (beams
    contribute from their backward extensions), as the reference does.
    Returns (pa, pb, valid), valid False for parallel lines unless a
    segment is a point."""
    A = a1 - a0
    B = b1 - b0
    mag_a = length(A)
    mag_b = length(B)
    An = A / torch.clamp_min(mag_a, 1e-30)[..., None]
    Bn = B / torch.clamp_min(mag_b, 1e-30)[..., None]
    cr = cross(An, Bn)
    denom = dot(cr, cr)
    parallel = denom < 1e-12
    t = b0 - a0
    # Determinant(t, Bn, cr) / Determinant(t, An, cr) (photonbeam.cpp:79-85)
    det_a = dot(t, cross(Bn, cr))
    det_b = dot(t, cross(An, cr))
    denom_safe = torch.where(parallel, _const(denom, 1.0), denom)
    t0 = det_a / denom_safe
    t1 = det_b / denom_safe
    pa = a0 + An * t0[..., None]
    pb = b0 + Bn * t1[..., None]
    # clamp a to its segment (photonbeam.cpp:169-172)
    pa = torch.where((t0 < 0.0)[..., None], a0, pa)
    pa = torch.where((t0 > mag_a)[..., None], a1, pa)
    # reproject b when a was clamped (:173-177)
    a_clamped = (t0 < 0.0) | (t0 > mag_a)
    dot_b = _clip_t(dot(Bn, pa - b0), mag_b)
    pb = torch.where(a_clamped[..., None], b0 + Bn * dot_b[..., None], pb)
    # reproject a when b's original t1 is out of range (:178-181), from the
    # possibly reprojected pb; pb itself stays unclamped
    b_out = (t1 < 0.0) | (t1 > mag_b)
    dot_a = _clip_t(dot(An, pb - a0), mag_a)
    pa = torch.where(b_out[..., None], a0 + An * dot_a[..., None], pa)
    # degenerate segments (:95-119): point-segment projections
    a_pt = mag_a < 1e-12
    b_pt = mag_b < 1e-12
    d_on_b = _clip_t(dot(Bn, a0 - b0), mag_b)
    pa = torch.where(a_pt[..., None], a0, pa)
    pb = torch.where(a_pt[..., None], b0 + Bn * d_on_b[..., None], pb)
    d_on_a = _clip_t(dot(An, b0 - a0), mag_a)
    b_only = (b_pt & ~a_pt)[..., None]
    pb = torch.where(b_only, b0, pb)
    pa = torch.where(b_only, a0 + An * d_on_a[..., None], pa)
    valid = ~parallel | a_pt | b_pt
    return pa, pb, valid


def _clip_t(x, hi):
    """``jnp.clip(x, 0, hi)`` for a tensor ``hi``."""
    return torch.minimum(torch.maximum(x, _const(x, 0.0)), hi)


def _compat_terms(a0, a1, d_r, seg_len, cam_radius, c_start, c_end, c_rad,
                  c_valid, c_pe):
    """Per-pair terms of the KERNEL_COMPAT pair math (photonbeam.cpp:
    494-508; beam_gather.py:365-420), broadcast over camera segments
    (a0, a1, d_r, seg_len) and beams (c_*): ``1e-5 * sqrt(1 - r^2) *
    power_end`` for pairs within the summed radii, counted only where the
    camera ray hits the beam's WorldBound box (PhotonBeamBVH::Intersect,
    photonbeambvh.cpp:685-723).  That box is the reference's: inflated by
    the beam radius alone, sized from the SIGNED direction (so it collapses
    on the axes a beam runs down), and hit by pbrt's slab test with the
    tFar fudge 1 + 2 gamma(3).  No power_scale and no camera throughput."""
    pa, pb, cp_valid = closest_points_segments(a0, a1, c_start, c_end)
    dist = length(pa - pb)
    r = dist / _max(cam_radius + c_rad, 1e-30)
    in_range = ((r < 1.0) & cp_valid).to(torch.float32) * c_valid
    blen = length(c_end - c_start)
    bdirn = (c_end - c_start) / _max(blen, 1e-30)[..., None]
    half = 0.5 * torch.abs(
        bdirn * blen[..., None]
        + 2.0 * c_rad[..., None] * torch.sqrt(_max(1.0 - bdirn * bdirn, 0.0)))
    center = 0.5 * (c_start + c_end)
    bmin = center - half
    bmax = center + half
    axis_ok = d_r.abs() > 1e-12
    inv = 1.0 / torch.where(axis_ok, d_r, _const(d_r, 1.0))
    tA = (bmin - a0) * inv
    tB = (bmax - a0) * inv
    t_lo = torch.where(axis_ok, torch.minimum(tA, tB), _const(tA, -1e30))
    t_hi = torch.where(axis_ok,
                       torch.maximum(tA, tB) * (1.0 + 2.0 * 1.7881393e-7),
                       _const(tA, 1e30))
    inside = (a0 >= bmin) & (a0 <= bmax)
    t0 = t_lo.amax(-1)
    t1 = t_hi.amin(-1)
    aabb_hit = ((t0 <= t1) & (t0 < seg_len) & (t1 > 0.0)
                & (axis_ok | inside).all(-1))
    in_range = in_range * aabb_hit.to(torch.float32)
    w = 1e-5 * torch.sqrt(_max(1.0 - r * r, 0.0))
    return (w[..., None] * c_pe) * in_range[..., None]


# slack of the pair cull's boxes, in world units: far above the float
# error of the slab test's entry point (a few ulps of coordinates of a few
# units), far below the beams' radii
_CULL_SLACK = 1e-3


def _compat_contrib(cb: dict, seg: dict, c_start, c_end, c_rad, c_valid):
    """(R, 3): the sum over a chunk's beams of ``_compat_terms``.  A pair
    can count only where the camera segment meets the beam's WorldBound
    box, which lies inside the beam's own box grown by its radius; the
    pairs whose boxes (grown by ``_CULL_SLACK``) miss, or whose beam is
    invalid, add an exact +0.  So the terms are computed on the other
    pairs only, written into the dense (R, C, 3) array of zeros and summed
    over the chunk as the dense terms would be: the same bits."""
    a0, a1 = seg["a0"], seg["a1"]  # (R, 3)
    R, C = a0.shape[0], c_start.shape[1]
    seg_lo = torch.minimum(a0, a1)[:, None] - _CULL_SLACK
    seg_hi = torch.maximum(a0, a1)[:, None] + _CULL_SLACK
    grow = c_rad[..., None] + _CULL_SLACK
    beam_lo = torch.minimum(c_start, c_end) - grow  # (1, C, 3)
    beam_hi = torch.maximum(c_start, c_end) + grow
    live = ((seg_lo <= beam_hi) & (beam_lo <= seg_hi)).all(-1) & (c_valid > 0)
    ri, ci = live.nonzero(as_tuple=True)
    terms = torch.zeros((R, C, 3), dtype=torch.float32, device=a0.device)
    terms[ri, ci] = _compat_terms(
        a0[ri], a1[ri], seg["dir"][ri], seg["len"][ri], seg["cam_radius"],
        c_start[0, ci], c_end[0, ci], c_rad[0, ci], c_valid[0, ci],
        cb["power_end"][ci])
    return terms.sum(1)


def closest_points_segments_exact(a0, a1, b0, b1):
    """True segment-segment closest points (Ericson, RTCD 5.1.9),
    branchless and differentiable (beam_gather.py:150-174).  Returns (pa,
    pb, valid), valid True everywhere (parallel pairs are handled)."""
    d1 = a1 - a0
    d2 = b1 - b0
    r = a0 - b0
    a = dot(d1, d1)
    e = dot(d2, d2)
    b = dot(d1, d2)
    c = dot(d1, r)
    f = dot(d2, r)
    denom = a * e - b * b
    s = _clip(_safe_div(denom > 1e-12, b * f - c * e, denom), 0.0, 1.0)
    t = _safe_div(e > 1e-12, b * s + f, e)
    t_cl = _clip(t, 0.0, 1.0)
    # re-derive s where t was clamped
    apos = a > 1e-12
    s_new = _clip((t_cl * b - c) / torch.where(apos, a, _const(a, 1.0)),
                  0.0, 1.0)
    s = torch.where((t != t_cl) & apos, s_new, s)
    pa = a0 + d1 * s[..., None]
    pb = b0 + d2 * t_cl[..., None]
    return pa, pb, torch.ones(s.shape, dtype=torch.bool, device=s.device)


def _interp_power(power_start, power_end, frac):
    """Power at fraction ``frac`` along a beam by exponential interpolation
    (beam_gather.py:177-190), fully where-isolated: dead lanes (start power
    <= 1e-20) never reach the log or the divide, and the decay ratio is
    floored at 1e-12."""
    ok = power_start > 1e-20
    one = _const(power_start, 1.0)
    ps = torch.where(ok, power_start, one)
    pe = torch.where(ok, torch.maximum(power_end, 1e-12 * ps), one)
    p = ps * torch.exp(frac[..., None] * torch.log(pe / ps))
    return torch.where(ok, p, _const(p, 0.0))


def _poly_D_at(coef, frac):
    """Horner evaluation of D(f) (no constant term), clamped at 0
    (beam_gather.py:300-306); coef (..., 5) broadcast against frac."""
    acc = coef[..., POLY_D_DEG - 1]
    for i in range(POLY_D_DEG - 2, -1, -1):
        acc = coef[..., i] + frac * acc
    return _max(frac * acc, 0.0)


def _poly_dens_at(coef, frac):
    """Horner evaluation of dens(f), clamped at 0; coef (..., 6)."""
    acc = coef[..., POLY_DENS_DEG]
    for i in range(POLY_DENS_DEG - 1, -1, -1):
        acc = coef[..., i] + frac * acc
    return _max(acc, 0.0)


def _chunk_contrib(cb: dict, seg: dict, kernel: int, power_scale: float,
                   min_sin_theta: float, grad_geometry: bool = True,
                   grad_extras: bool = True) -> torch.Tensor:
    """(R, 3) contribution of one beam chunk ``cb`` (C-sized tensors and the
    float validity) to the R camera segments of ``seg``
    (beam_gather.py:340-467): the normalized estimate, or with
    ``KERNEL_COMPAT`` the reference renderer's conical kernel
    (``_compat_contrib``).  ``grad_geometry`` False detaches the
    closest-point geometry, ``grad_extras`` False the blur radii and the
    HG g, where the reference stop-gradients them."""
    keep = lambda x: x  # noqa: E731
    sg = keep if grad_geometry else torch.Tensor.detach
    sx = keep if grad_extras else torch.Tensor.detach
    c_start = sg(cb["start"])[None]  # (1, C, 3)
    c_end = sg(cb["end"])[None]
    c_ps = cb["power_start"][None]
    c_pe = cb["power_end"][None]
    c_rad = sx(cb["radius"])[None]  # (1, C)
    c_valid = cb["valid_f"][None]
    if kernel == KERNEL_COMPAT:
        return _compat_contrib(cb, seg, c_start, c_end, c_rad, c_valid)
    a0 = sg(seg["a0"])[:, None]  # (R, 1, 3)
    a1 = sg(seg["a1"])[:, None]
    pa, pb, cp_valid = closest_points_segments_exact(a0, a1, c_start, c_end)
    dist = length(pa - pb)  # (R, C)
    width = sx(seg["cam_radius"]) + c_rad
    r = dist / _max(width, 1e-30)
    in_range = ((r < 1.0) & cp_valid).to(torch.float32) * c_valid

    # the physically normalized 1D-1D estimate
    beam_len = _max(length(c_end - c_start), 1e-30)
    b_dirn = (c_end - c_start) / beam_len[..., None]
    t_b = dot(pb - c_start, b_dirn)
    frac_b = _clip(t_b / beam_len, 0.0, 1.0)
    t_c = dot(pa - seg["a0"][:, None], seg["dir"][:, None])
    frac_c = _clip(t_c / seg["len"][:, None], 0.0, 1.0)
    if "d_cam_poly" in seg:
        # grid media: transmittance and sigma_s from the segments'
        # polynomial tables, tau_ch = sigma_t[ch] * D(f)
        Db = _poly_D_at(cb["d_poly_b"][None], frac_b)  # (R, C)
        p_at = c_ps * torch.exp(-Db[..., None] * cb["sigma_t_b"][None])
        Dc = _poly_D_at(seg["d_cam_poly"][:, None], frac_c)
        tr_cam = torch.exp(-Dc[..., None] * seg["sigma_t_cam"][:, None])
        dens_c = _poly_dens_at(seg["dens_cam_poly"][:, None], frac_c)
        sigs = seg["sigma_s"][:, None] * dens_c[..., None]
    else:
        p_at = _interp_power(c_ps, c_pe, frac_b)  # (R, C, 3)
        tr_cam = _interp_power(torch.ones_like(seg["tr_full"])[:, None],
                               _max(seg["tr_full"], 1e-30)[:, None], frac_c)
        sigs = seg["sigma_s"][:, None]

    cos_theta = dot(seg["dir"][:, None], b_dirn)
    rho = phase_hg(cos_theta, sx(seg["g"])[:, None])
    sin_theta = _max(torch.sqrt(_max(1.0 - cos_theta * cos_theta, 1e-12)),
                     min_sin_theta)
    # Epanechnikov line kernel, integral over [-W, W] == 1
    k1 = 0.75 * (1.0 - r * r) / _max(width, 1e-30)
    w = (rho * k1 / sin_theta)[..., None] * sigs
    contrib = power_scale * w * p_at * tr_cam
    contrib = contrib * seg["in_med_f"][:, None, None]
    return (contrib * in_range[..., None]).sum(1)


# seg entries that are scalars, not per-ray rows
_SEG_SCALARS = ("cam_radius", "n_valid_beams")


class _Cfg(NamedTuple):
    kernel: int
    chunk: int  # beams per chunk of the chunk loop (gather_chunk)
    n_chunks: int
    power_scale: float
    min_sin: float
    grad_geometry: bool
    grad_extras: bool
    backend: str  # "xla": plain torch forward; "pallas": the forward kernel


def _piece_rays(chunk: int, device) -> int:
    """Rays per piece of the chunk loop: at most 2^22 pairs on the CPU and
    2^24 on a card (the plain versions' batches), so one recompute's
    autograd graph stays within a few GB."""
    pairs = _REF_BATCH_PAIRS_CPU if device.type == "cpu" else _REF_BATCH_PAIRS_CARD
    return max(1, pairs // chunk)


def _seg_rows(seg: dict, lo: int, hi: int) -> dict:
    return {k: v if k in _SEG_SCALARS else v[lo:hi] for k, v in seg.items()}


def _n_live_chunks(cfg: _Cfg, n_valid: float) -> int:
    """Chunks ci with ci * chunk < n_valid: the beams arrive validity-sorted,
    so every later chunk is dead (the reference's scalar cond skips them)."""
    return min(cfg.n_chunks, math.ceil(n_valid / cfg.chunk))


def _gather_forward(cfg: _Cfg, pb: dict, seg: dict, n_valid: float):
    """The chunk scan (beam_gather.py:479-499) over the live chunks, each
    chunk's rays in pieces (rows are independent: the same sums)."""
    R = seg["a0"].shape[0]
    acc = torch.zeros((R, 3), dtype=torch.float32, device=seg["a0"].device)
    rp = _piece_rays(cfg.chunk, acc.device)
    for ci in range(_n_live_chunks(cfg, n_valid)):
        cb = {k: v[ci * cfg.chunk:(ci + 1) * cfg.chunk] for k, v in pb.items()}
        for lo in range(0, R, rp):
            acc[lo:lo + rp] += _chunk_contrib(
                cb, _seg_rows(seg, lo, lo + rp), cfg.kernel, cfg.power_scale,
                cfg.min_sin, cfg.grad_geometry, cfg.grad_extras)
    return acc


def _gather_bwd(cfg: _Cfg, pb: dict, seg: dict, ct, n_valid: float,
                need_pb: dict, need_seg: dict):
    """The recompute backward (beam_gather.py:506-550): each live chunk's
    ``_chunk_contrib`` is re-run under autograd, one piece of rays at a
    time, and its vector-Jacobian product taken with the output cotangent.
    Beam cotangents add into their chunk's rows, ray cotangents into their
    piece's rows, in chunk order then piece order: contiguous slices, no
    atomics, so repeated runs agree bit for bit.  The sum order over rays
    differs from the reference's single (R, C) VJP by the pieces.  Returns
    ({key: cotangent or None}, {key: cotangent or None})."""
    R = seg["a0"].shape[0]
    d_pb = {k: torch.zeros_like(v) if need_pb[k] else None
            for k, v in pb.items()}
    d_seg = {k: torch.zeros_like(v) if need_seg[k] else None
             for k, v in seg.items()}
    if not (any(need_pb.values()) or any(need_seg.values())):
        return d_pb, d_seg
    rp = _piece_rays(cfg.chunk, ct.device)
    for ci in range(_n_live_chunks(cfg, n_valid)):
        c0, c1 = ci * cfg.chunk, (ci + 1) * cfg.chunk
        for lo in range(0, R, rp):
            hi = min(lo + rp, R)
            with torch.enable_grad():
                cb = {k: v[c0:c1].detach().requires_grad_(need_pb[k])
                      for k, v in pb.items()}
                sp = {k: v.detach().requires_grad_(need_seg[k])
                      for k, v in _seg_rows(seg, lo, hi).items()}
                out = _chunk_contrib(cb, sp, cfg.kernel, cfg.power_scale,
                                     cfg.min_sin, cfg.grad_geometry,
                                     cfg.grad_extras)
                leaves = ([("pb", k, v) for k, v in cb.items() if need_pb[k]]
                          + [("seg", k, v) for k, v in sp.items()
                             if need_seg[k]])
                if not out.requires_grad:
                    continue
                grads = torch.autograd.grad(out, [v for _, _, v in leaves],
                                            ct[lo:hi], allow_unused=True)
            for (side, k, _), g in zip(leaves, grads):
                if g is None:
                    continue
                if side == "pb":
                    d_pb[k][c0:c1] += g
                elif k in _SEG_SCALARS:
                    d_seg[k] += g
                else:
                    d_seg[k][lo:hi] += g
    return d_pb, d_seg


def _fold_kernel_inputs(pb: dict, seg: dict, power_scale: float):
    """Fold power_scale * in_medium into the sigma_s rows and the validity
    into the beam powers, as the kernels assume (beam_gather.py:559-570)."""
    seg_f = dict(seg)
    seg_f["sigma_s"] = seg["sigma_s"] * (power_scale * seg["in_med_f"])[:, None]
    pb_f = dict(pb)
    pb_f["power_start"] = pb["power_start"] * pb["valid_f"][:, None]
    pb_f["power_end"] = pb["power_end"] * pb["valid_f"][:, None]
    return pb_f, seg_f


def _pack_kernel_inputs(cfg: _Cfg, pb: dict, seg: dict):
    """The non-packed route's kernel inputs (beam_gather.py:573-596): the
    folds, the rays zero-padded to whole 256-ray tiles and packed, the beams
    packed in 256-beam chunks (the buffer padded with zero beams to a
    multiple of 256 where ``gather_chunk`` is not one), and the (1, 4)
    scalars.  Returns (rays_packed, beams_packed, scalars)."""
    pb_f, seg_f = _fold_kernel_inputs(pb, seg, cfg.power_scale)
    R = seg["a0"].shape[0]
    R_pad = -(-R // TILE) * TILE
    if R_pad != R:
        seg_f = {k: v if k in _SEG_SCALARS else torch.cat(
            [v, v.new_zeros((R_pad - R,) + v.shape[1:])], 0)
            for k, v in seg_f.items()}
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32,  # noqa: E731
                                    device=seg["a0"].device).reshape(())
    scalars = torch.stack([f32(seg["cam_radius"]), f32(cfg.power_scale),
                           f32(cfg.min_sin), f32(seg["n_valid_beams"])])
    return (pack_rays(seg_f, TILE), pack_beams(pb_f, CHUNK),
            scalars.reshape(1, 4))


def _pallas_forward(cfg: _Cfg, pb: dict, seg: dict):
    """The forward kernel (row 1 of Queue 2) on the non-packed layout with
    no block mask: every block before ``n_valid`` is swept, as the
    reference's ``_pallas_forward`` (beam_gather.py:573-600).  (R, 3).
    The kernel computes the normalized estimate only: any other kernel id
    raises, so the compat kernel can never reach it."""
    if cfg.kernel != KERNEL_BRE:
        raise ValueError(
            f"the forward kernel computes the normalized estimate "
            f"(KERNEL_BRE) only, not kernel id {cfg.kernel}; KERNEL_COMPAT "
            "takes the chunk scan")
    rays_packed, beams_packed, scalars = _pack_kernel_inputs(cfg, pb, seg)
    out = gather_forward(rays_packed, beams_packed, scalars)
    R = seg["a0"].shape[0]
    return out[:, :3, :].transpose(1, 2).reshape(-1, 3)[:R]


def _gather_bwd_analytic(cfg: _Cfg, pb: dict, seg: dict, ct):
    """The analytic backward kernels on the non-packed layout
    (beam_gather.py:643-714): "fused" with an all-ones mask, or "twopass",
    then the cotangents unpacked and chained through the folds (d sigma_s
    times power_scale * in_medium, d powers times validity).  The geometry,
    in_med_f and n_valid get none; cam_radius gets the sum of its per-ray
    partials."""
    rays_packed, beams_packed, scalars = _pack_kernel_inputs(cfg, pb, seg)
    R, n_tiles = seg["a0"].shape[0], rays_packed.shape[0]
    ct_pad = torch.cat([ct, ct.new_zeros((n_tiles * TILE - R, 3))], 0)
    ct_packed = pack_ct(ct_pad, n_tiles)
    if PALLAS_BWD_MODE == "fused":
        d_rays, d_beams = gather_backward_fused(
            rays_packed, beams_packed, scalars, ct_packed,
            want_extras=cfg.grad_extras)
    else:
        d_rays, d_beams = gather_backward_twopass(
            rays_packed, beams_packed, scalars, ct_packed)
    dr = d_rays.transpose(1, 2).reshape(-1, NDR)[:R]
    fold_sig = cfg.power_scale * seg["in_med_f"]
    d_seg = dict(tr_full=dr[:, DR_TR:DR_TR + 3],
                 sigma_s=dr[:, DR_SIGS:DR_SIGS + 3] * fold_sig[:, None],
                 g=dr[:, DR_G], cam_radius=dr[:, DR_CAMR].sum())
    Bp = pb["radius"].shape[0]
    db = d_beams.transpose(0, 1).reshape(d_beams.shape[1], -1)[:, :Bp]
    valid_col = pb["valid_f"][:, None]
    d_pb = dict(power_start=db[BF_PS:BF_PS + 3].T * valid_col,
                power_end=db[BF_PE:BF_PE + 3].T * valid_col,
                radius=db[BF_RAD])
    return d_pb, d_seg


class _GatherCore(torch.autograd.Function):
    """The non-packed gather with the reference's custom VJPs
    (``_gather_core`` and ``_gather_core_pallas``, beam_gather.py:470-717):
    forward by the chunk scan (``backend="xla"``) or the forward kernel
    (``"pallas"``); backward by the recompute, or, for the pallas backend
    with the geometry detached in homogeneous media, by the analytic
    kernels that ``PALLAS_BWD_ENABLED`` and ``PALLAS_BWD_MODE`` select.
    The beam and segment dicts travel flattened: their keys, then the
    tensors in key order.  The live-beam count is read on the host once per
    call (one sync), where the chunk loop needs it."""

    @staticmethod
    def forward(ctx, cfg, pb_keys, seg_keys, *tensors):
        pb = dict(zip(pb_keys, tensors[:len(pb_keys)]))
        seg = dict(zip(seg_keys, tensors[len(pb_keys):]))
        ctx.cfg, ctx.keys, ctx.n_valid = cfg, (pb_keys, seg_keys), None
        ctx.save_for_backward(*tensors)
        if cfg.backend == "pallas":
            return _pallas_forward(cfg, pb, seg)
        ctx.n_valid = float(seg["n_valid_beams"])
        return _gather_forward(cfg, pb, seg, ctx.n_valid)

    @staticmethod
    def backward(ctx, ct):
        cfg, (pb_keys, seg_keys) = ctx.cfg, ctx.keys
        tensors = ctx.saved_tensors
        n_pb = len(pb_keys)
        pb = dict(zip(pb_keys, tensors[:n_pb]))
        seg = dict(zip(seg_keys, tensors[n_pb:]))
        need = ctx.needs_input_grad[3:]
        ct = ct.contiguous()
        if (cfg.backend == "pallas" and not cfg.grad_geometry
                and cfg.kernel == KERNEL_BRE and PALLAS_BWD_ENABLED
                and "d_poly_b" not in pb):
            d_pb, d_seg = _gather_bwd_analytic(cfg, pb, seg, ct)
        else:
            if ctx.n_valid is None:
                ctx.n_valid = float(seg["n_valid_beams"])
            d_pb, d_seg = _gather_bwd(cfg, pb, seg, ct, ctx.n_valid,
                                      dict(zip(pb_keys, need[:n_pb])),
                                      dict(zip(seg_keys, need[n_pb:])))
        grads = [d_pb.get(k) for k in pb_keys] + [d_seg.get(k) for k in seg_keys]
        return (None, None, None, *(g if n else None
                                    for g, n in zip(grads, need)))


class _Permute(torch.autograd.Function):
    """``x.index_select(dim, order)`` for a permutation ``order``, whose
    backward is the gather by the inverse permutation (beam_gather.py:
    839-886), not indexing's generic backward, which accumulates (a sort
    and a serial add per run of equal ids on a card)."""

    @staticmethod
    def forward(ctx, x, order, inv_order, dim):
        ctx.save_for_backward(inv_order)
        ctx.dim = dim
        return x.index_select(dim, order)

    @staticmethod
    def backward(ctx, ct):
        inv_order, = ctx.saved_tensors
        return ct.index_select(ctx.dim, inv_order), None, None, None


def permute_rows(x, order, inv_order):
    """``x[order]`` with the inverse-permutation gather as its backward."""
    return _Permute.apply(x, order, inv_order, 0)


def permute_cols(x, order, inv_order):
    """``x[:, order]`` with the inverse-permutation gather as its backward."""
    return _Permute.apply(x, order, inv_order, 1)


def _inverse_permutation(order):
    return torch.argsort(order).detach()


def validity_order(valid):
    """Stable sort order bringing the valid entries first (``jnp.argsort(
    ~valid)``), and its inverse, for ``permute_rows``."""
    order = torch.argsort((~valid).to(torch.uint8), stable=True).detach()
    return order, _inverse_permutation(order)


def compact_beams(beams):
    """The beams sorted so the valid ones come first, stably
    (beam_gather.py:1468-1485): once per camera pass, then every depth
    step's gather takes ``assume_compacted=True``.  The float fields go
    through ``permute_rows``."""
    order, inv_order = validity_order(beams.valid)
    p = lambda x: permute_rows(x, order, inv_order)  # noqa: E731
    return beams._replace(
        start=p(beams.start), end=p(beams.end),
        power_start=p(beams.power_start), power_end=p(beams.power_end),
        radius=p(beams.radius), medium=beams.medium[order],
        valid=beams.valid[order])


def pack_beams_compact(beams, d_poly=None, sigma_t=None):
    """Validity-compact and pack a Beams SoA into the (n_chunks, NB, CHUNK)
    field-major chunk layout.  Returns (beams_packed, n_valid f32 ()).
    ``d_poly`` (B, 5) and ``sigma_t`` (B, 3), a grid medium's per-beam
    tables (``medium_interval_poly``), append the NB_HET - NB extension
    fields, permuted and padded with the rest.

    Sort key: validity-major, Morton-minor, one stable argsort — valid beams
    first (the dead-chunk skip) and spatially local chunks (tight chunk
    AABBs for the block cull)."""
    dev = beams.start.device
    mid = (0.5 * (beams.start + beams.end)).detach()
    vcol = beams.valid[:, None]
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    mn = torch.where(vcol, mid, inf).amin(0)
    mx = torch.where(vcol, mid, -inf).amax(0)
    any_valid = beams.valid.any()
    mn = torch.where(any_valid, mn, torch.zeros_like(mn))
    mx = torch.where(any_valid, mx, torch.ones_like(mx))
    codes = morton3((mid - mn) / torch.clamp_min(mx - mn, 1e-12))  # < 2^30
    key = torch.where(beams.valid, codes, torch.full_like(codes, 1 << 30))
    order = torch.argsort(key, stable=True).detach()
    B = beams.capacity
    n_chunks = max(1, -(-B // CHUNK))
    Bp = n_chunks * CHUNK

    # validity folds into the beam powers (the kernels assume it)
    valid_f = beams.valid.to(torch.float32)
    ps = beams.power_start * valid_f[:, None]
    pe = beams.power_end * valid_f[:, None]
    zeros = torch.zeros((B,), dtype=torch.float32, device=dev)
    cols = [
        beams.start[:, 0], beams.start[:, 1], beams.start[:, 2],
        beams.end[:, 0], beams.end[:, 1], beams.end[:, 2],
        ps[:, 0], ps[:, 1], ps[:, 2],
        pe[:, 0], pe[:, 1], pe[:, 2],
        beams.radius, valid_f, zeros, zeros,
    ]
    if d_poly is not None:  # grid-medium extension fields
        cols += [d_poly[:, k] for k in range(POLY_D_COEFS)]
        cols += [sigma_t[:, ch] for ch in range(3)]
    nb = len(cols)
    # (nb, B), field-major; one column permute for every field
    mat = permute_cols(torch.stack(cols, 0), order, _inverse_permutation(order))
    if Bp != B:
        mat = torch.cat([mat, torch.zeros((nb, Bp - B), dtype=torch.float32,
                                          device=dev)], 1)
    packed = mat.reshape(nb, n_chunks, CHUNK).permute(1, 0, 2).contiguous()
    return packed, valid_f.sum()


def _block_overlap_mask(beams_packed, seg_a0, seg_a1, tile: int, cam_radius,
                        in_med_f):
    """(n_chunks, n_tiles) f32 conservative cull mask: 1 where the chunk's
    radius-inflated AABB overlaps the tile's cam_radius-inflated AABB of
    its in-medium segments.  Disjoint boxes guarantee zero contribution, so
    the skip is exact; dead chunks get empty boxes and mask 0.  A segment
    with ``in_med_f`` 0 widens no tile's box: its sigma_s is folded to 0,
    so each of its pairs adds +0.0; a tile with none in the medium gets an
    empty box and mask 0."""
    bp = beams_packed.detach()
    start = bp[:, BF_B0:BF_B0 + 3, :].transpose(1, 2)
    end = bp[:, BF_B1:BF_B1 + 3, :].transpose(1, 2)
    rad = bp[:, BF_RAD:BF_RAD + 1, :].transpose(1, 2)
    live = bp[:, BF_VALID:BF_VALID + 1, :].transpose(1, 2) > 0.0
    big = torch.tensor(3e37, dtype=torch.float32, device=bp.device)
    cmin = torch.where(live, torch.minimum(start, end) - rad, big).amin(1)
    cmax = torch.where(live, torch.maximum(start, end) + rad, -big).amax(1)

    n_tiles = seg_a0.shape[0] // tile
    a0 = seg_a0.detach().reshape(n_tiles, tile, 3)
    a1 = seg_a1.detach().reshape(n_tiles, tile, 3)
    out = (in_med_f.detach() <= 0.0).reshape(n_tiles, tile, 1)
    r = torch.as_tensor(cam_radius, dtype=torch.float32, device=bp.device)
    tmin = torch.minimum(a0, a1).masked_fill(out, 3e37).amin(1) - r
    tmax = torch.maximum(a0, a1).masked_fill(out, -3e37).amax(1) + r
    hit = ((cmax[:, None, :] >= tmin[None, :, :])
           & (cmin[:, None, :] <= tmax[None, :, :])).all(-1)
    return hit.to(torch.float32)


def _packed_forward(beams_packed, rays_packed, scalars, block_mask,
                    sparse_cap: int):
    """Run the forward kernel for one packed sweep: the sparse live-block
    kernel when the live blocks fit ``sparse_cap`` (the reference's runtime
    pick, a ``lax.cond`` there), the dense masked kernel otherwise (both
    exact).  The pick reads the live count on the host: the sweep's one
    host sync in this eager port.  The id lists and the sparse kernels'
    plans are built on the device (``sparse_block_ids``,
    ``sparse_ray_plan``, ``sparse_beam_plan``) and sync nothing.  While a
    profiler records, the sweep counts itself (``gather.sweeps``), its
    blocks (``gather.blocks``), the live ones (``gather.live_blocks``) and
    whether it took the sparse kernel (``gather.sparse_picks``, 0 or 1).
    Returns ((n_tiles*T, 3), the tile-major block ids of the sparse pick
    or None)."""
    idx = None
    stats.count("gather.sweeps", 1)
    stats.count("gather.blocks", block_mask.numel())
    if sparse_cap > 0:
        n_live = int((block_mask > 0).sum())
        stats.count("gather.live_blocks", n_live)
    else:
        stats.count("gather.live_blocks", lambda: (block_mask > 0).sum())
    if sparse_cap > 0 and n_live <= sparse_cap:
        idx, _ = sparse_block_ids(block_mask, sparse_cap)
        out = gather_sparse(rays_packed, beams_packed, scalars, idx)
    else:
        out = gather_forward(rays_packed, beams_packed, scalars, block_mask)
    stats.count("gather.sparse_picks", int(idx is not None))
    n_tiles, tile = rays_packed.shape[0], rays_packed.shape[2]
    return out[:, :3, :].transpose(1, 2).reshape(n_tiles * tile, 3), idx


def pack_ct(ct, n_tiles: int):
    """(n_tiles*T, 3) output cotangent -> the kernels' (n_tiles, 8, T)
    layout, RGB in rows 0-2 (beam_gather.py:1139-1141)."""
    return torch.cat(
        [ct.reshape(n_tiles, TILE, 3).transpose(1, 2),
         torch.zeros((n_tiles, NDR - 3, TILE), dtype=torch.float32,
                     device=ct.device)], 1).contiguous()


def _packed_backward(beams_packed, rays_packed, scalars, block_mask, ct,
                     idx_t, grad_extras: bool):
    """The reference's ``_packed_bwd`` (beam_gather.py:1121-1208): (n_tiles*T,
    3) output cotangent -> (d_beams, d_rays) in the packed layouts.  Takes
    the forward's pick: the sparse kernels over its tile-major ids ``idx_t``
    and chunk-major ids of the same cap, the dense kernels where ``idx_t``
    is None.  Grid media always take the dense kernels with the block mask
    (the reference has no sparse heterogeneous backward, :1147; the
    skipped blocks hold no in-range pair, so the result is the same).  The
    geometry rows get zero cotangents, and in grid media the tr_full rows
    too (the transmittance rides the tables)."""
    ct_packed = pack_ct(ct, rays_packed.shape[0])
    hetero = is_hetero(rays_packed)
    if idx_t is not None and not hetero:
        cap = idx_t.shape[0] - rays_packed.shape[0]
        idx_c, _ = sparse_block_ids_chunk_major(block_mask, cap)
        d_rays8, d_beams = gather_backward_sparse(
            rays_packed, beams_packed, scalars, ct_packed, idx_t, idx_c,
            want_extras=grad_extras)
    else:
        d_rays8, d_beams = gather_backward_fused(
            rays_packed, beams_packed, scalars, ct_packed, block_mask,
            want_extras=grad_extras)
    d_rays = torch.zeros_like(rays_packed)
    d_rays[:, RF_SIGS:RF_SIGS + 3] = d_rays8[:, DR_SIGS:DR_SIGS + 3]
    d_rays[:, RF_G] = d_rays8[:, DR_G]
    if hetero:
        d_rays[:, RF_DC:RF_DC + POLY_D_COEFS] = \
            d_rays8[:, DR_DC:DR_DC + POLY_D_COEFS]
        d_rays[:, RF_SIGTC:RF_SIGTC + 3] = d_rays8[:, DR_SIGTC:DR_SIGTC + 3]
        d_rays[:, RF_DENSC:RF_DENSC + POLY_DENS_COEFS] = \
            d_rays8[:, DR_DENS:DR_DENS + POLY_DENS_COEFS]
    else:
        d_rays[:, RF_TR:RF_TR + 3] = d_rays8[:, DR_TR:DR_TR + 3]
    return d_beams, d_rays


class _GatherCorePacked(torch.autograd.Function):
    """The packed gather with the reference's custom VJP
    (``_gather_core_packed``, beam_gather.py:1036-1211): the forward
    launches the forward kernels, the backward the backward kernels, on
    the CPU through their plain versions.  The cam_radius cotangent
    (``DR_CAMR``) is not returned: the progressive radius is a schedule,
    not a parameter, so scalars and mask get None."""

    @staticmethod
    def forward(ctx, beams_packed, rays_packed, scalars, block_mask,
                sparse_cap, grad_extras):
        out, idx_t = _packed_forward(beams_packed, rays_packed, scalars,
                                     block_mask, sparse_cap)
        ctx.save_for_backward(beams_packed, rays_packed, scalars, block_mask,
                              idx_t)
        ctx.grad_extras = grad_extras
        return out

    @staticmethod
    def backward(ctx, ct):
        beams_packed, rays_packed, scalars, block_mask, idx_t = \
            ctx.saved_tensors
        d_beams, d_rays = _packed_backward(
            beams_packed, rays_packed, scalars, block_mask, ct, idx_t,
            ctx.grad_extras)
        return d_beams, d_rays, None, None, None, None


def _ray_order(a0, a1, in_med_f):
    """Stable order of one sweep's camera segments by position, so that a
    256-ray tile's box holds nearby segments: those in the medium first,
    the rest last, each group by the 30-bit Morton code of the segment
    midpoint in the box of the in-medium midpoints.  Built on the device,
    with no host read and no Python constant copied to the card.  Returns
    (order, its inverse)."""
    mid = 0.5 * (a0 + a1)
    out = (in_med_f <= 0.0)[:, None]
    mn = mid.masked_fill(out, float("inf")).amin(0)
    mx = mid.masked_fill(out, float("-inf")).amax(0)
    any_in = ~out.all()
    mn = torch.where(any_in, mn, torch.zeros_like(mn))
    mx = torch.where(any_in, mx, torch.ones_like(mx))
    codes = morton3((mid - mn) / torch.clamp_min(mx - mn, 1e-12))  # < 2^30
    key = torch.where(out[:, 0], codes + (1 << 30), codes)
    order = torch.argsort(key, stable=True).detach()
    return order, _inverse_permutation(order)


def _sweep_rows(media: Media, seg_a0, seg_a1, seg_dir, seg_medium,
                seg_tr_full, power_scale: float, hetero: bool) -> dict:
    """One sweep's per-ray rows in the caller's order: the geometry
    detached, the medium factors gathered (power_scale * in_medium folded
    into sigma_s, as the kernels assume) and, in grid media, the camera
    segments' tables (geometry detached, medium parameters attached)."""
    _, sigma_s_seg, g_seg, _, seg_in_med = gather_medium(media, seg_medium)
    in_med_f = seg_in_med.to(torch.float32)
    seg = dict(
        a0=seg_a0.detach(), a1=seg_a1.detach(), dir=seg_dir.detach(),
        len=torch.clamp_min(length(seg_a1 - seg_a0), 1e-30).detach(),
        tr_full=seg_tr_full,
        sigma_s=sigma_s_seg * (power_scale * in_med_f)[:, None],
        g=g_seg, in_med_f=in_med_f,
    )
    if hetero:
        dp_c, dens_c, sigt_c = medium_interval_poly(
            media, seg_medium, seg_a0.detach(), seg_a1.detach())
        seg.update(d_cam_poly=dp_c, sigma_t_cam=sigt_c, dens_cam_poly=dens_c)
    return seg


def _pack_sweep(beams_packed, n_valid, seg: dict, cam_radius,
                power_scale: float, min_sin_theta: float, order=None,
                inv_order=None):
    """The rows of ``_sweep_rows``, put in ``order`` if one is given (one
    ``permute_cols`` of every field), zero-padded to whole tiles (a pad row
    is outside the medium) and packed; the (1, 4) scalars; the cull mask
    of that order.  Returns (rays_packed, scalars, block_mask)."""
    rows = ray_rows(seg)
    if order is not None:
        rows = permute_cols(rows, order, inv_order)
    nf, R = rows.shape
    dev = rows.device
    R_pad = -(-R // TILE) * TILE
    if R_pad != R:
        rows = torch.cat([rows, rows.new_zeros((nf, R_pad - R))], 1)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    scalars = torch.stack([f32(cam_radius), f32(power_scale),
                           f32(min_sin_theta), f32(n_valid)]).reshape(1, 4)
    mask = _block_overlap_mask(beams_packed, rows[RF_A0:RF_A0 + 3].T,
                               rows[RF_A1:RF_A1 + 3].T, TILE, cam_radius,
                               rows[RF_INMED])
    return tile_rows(rows, TILE), scalars, mask


def gather_beams_packed(beams_packed, n_valid, media: Media, seg_a0, seg_a1,
                        seg_dir, seg_medium, seg_tr_full, cam_radius,
                        power_scale: float = 1.0, min_sin_theta: float = 0.05,
                        grad_extras: bool = True,
                        sparse_cap: int = 0) -> torch.Tensor:
    """Packed-mode gather (normalized BRE, geometry detached) over
    ``pack_beams_compact``'s chunks: per-ray medium factors are gathered
    here (and, for beams packed with grid tables, the camera segments'
    tables, geometry detached, medium parameters attached); a sweep of
    more than one tile puts its rays in ``_ray_order`` (one
    ``permute_cols`` of the packed fields, whose backward brings the
    gradients back to the caller's order); the rays are padded to a tile
    multiple, packed and culled, and ``sparse_cap > 0`` enables the
    sparse-block kernels.  ``grad_extras`` False skips the radius and HG g
    cotangents.  Returns
    (R, 3) in the caller's order: each ray's sum is the same bits in any
    order, since the chunk splits depend on the shapes and n_valid alone
    and a chunk the cull drops holds no in-range pair of the ray.  Counts
    its calls in ``gather_beams_packed.calls``; while a profiler records,
    each sweep's rays (``gather.rays``) and those in the medium
    (``gather.rays_in_medium``, a device sum)."""
    gather_beams_packed.calls += 1
    R = seg_a0.shape[0]
    seg = _sweep_rows(media, seg_a0, seg_a1, seg_dir, seg_medium, seg_tr_full,
                      power_scale, beams_packed.shape[1] > NB)
    stats.count("gather.rays", R)
    stats.count("gather.rays_in_medium", lambda: seg["in_med_f"].sum())
    order = inv_order = None
    if R > TILE:  # a sweep of one tile has no box to tighten
        order, inv_order = _ray_order(seg["a0"], seg["a1"], seg["in_med_f"])
    rays_packed, scalars, mask = _pack_sweep(beams_packed, n_valid, seg,
                                             cam_radius, power_scale,
                                             min_sin_theta, order, inv_order)
    out = _GatherCorePacked.apply(beams_packed, rays_packed, scalars, mask,
                                  sparse_cap, grad_extras)[:R]
    return out if order is None else permute_rows(out, inv_order, order)


def gather_beams_bruteforce(beams, media: Media, seg_a0, seg_a1, seg_dir,
                            seg_medium, seg_tr_full, cam_radius,
                            kernel: int = KERNEL_BRE, chunk: int = 2048,
                            power_scale: float = 1.0,
                            min_sin_theta: float = 0.05, backend: str = "xla",
                            grad_geometry: bool = True,
                            grad_extras: bool = True,
                            assume_compacted: bool = False,
                            hetero: bool = False, beams_medium=None,
                            het_k: int = HETERO_NODES) -> torch.Tensor:
    """Accumulate beam radiance onto R camera segments, the non-packed route
    (beam_gather.py:720-823).  Returns (R, 3).

    The beams are sorted valid-first (stable) unless ``assume_compacted``
    (``compact_beams`` did it once per camera pass), padded with dead beams
    to whole ``chunk``s, and gathered by ``_GatherCore``: ``backend="xla"``
    the chunk scan in plain torch, ``"pallas"`` the forward kernel (grid
    media with ``het_k`` other than the kernels' 8 nodes take the chunk
    scan).  ``hetero`` adds the polynomial tables of the beams (of
    ``beams_medium``, default their own media) and of the camera segments,
    built on every call.  Differentiable in the beams' geometry, powers and
    radii, the segments' geometry and transmittance, the medium parameters
    and ``cam_radius`` (a tensor); ``grad_geometry`` and ``grad_extras``
    detach as in ``_chunk_contrib``.  Counts its calls in
    ``gather_beams_bruteforce.calls``."""
    gather_beams_bruteforce.calls += 1
    dev = seg_a0.device
    B = beams.capacity
    n_chunks = max(1, -(-B // chunk))
    Bp = n_chunks * chunk
    n_valid_beams = beams.valid.sum().to(torch.float32)
    order = None if assume_compacted else validity_order(beams.valid)

    def pad(x):
        if order is not None:
            x = (permute_rows(x, *order) if x.is_floating_point()
                 else x[order[0]])
        return torch.cat([x, x.new_zeros((Bp - B,) + x.shape[1:])], 0)

    pb = dict(start=pad(beams.start), end=pad(beams.end),
              power_start=pad(beams.power_start),
              power_end=pad(beams.power_end), radius=pad(beams.radius),
              valid_f=pad(beams.valid.to(torch.float32)))
    _, sigma_s_seg, g_seg, _, seg_in_med = gather_medium(media, seg_medium)
    len_ = length(seg_a1 - seg_a0)
    seg = dict(a0=seg_a0, a1=seg_a1, dir=seg_dir, len=_max(len_, 1e-30),
               tr_full=seg_tr_full, sigma_s=sigma_s_seg, g=g_seg,
               in_med_f=seg_in_med.to(torch.float32),
               cam_radius=torch.as_tensor(cam_radius, dtype=torch.float32,
                                          device=dev).reshape(()),
               n_valid_beams=n_valid_beams)
    if hetero and kernel == KERNEL_BRE:
        bm = beams_medium if beams_medium is not None else beams.medium
        dp_b, _, sigt_b = medium_interval_poly(media, bm, beams.start,
                                               beams.end, K=het_k)
        pb.update(d_poly_b=pad(dp_b), sigma_t_b=pad(sigt_b))
        dp_c, dens_c, sigt_c = medium_interval_poly(media, seg_medium, seg_a0,
                                                    seg_a1, K=het_k)
        seg.update(d_cam_poly=dp_c, sigma_t_cam=sigt_c, dens_cam_poly=dens_c)
    use_kernel = (backend == "pallas" and kernel == KERNEL_BRE
                  and het_k == HETERO_NODES)
    cfg = _Cfg(int(kernel), int(chunk), int(n_chunks), float(power_scale),
               float(min_sin_theta), bool(grad_geometry), bool(grad_extras),
               "pallas" if use_kernel else "xla")
    return _GatherCore.apply(cfg, tuple(pb), tuple(seg), *pb.values(),
                             *seg.values())


gather_beams_bruteforce.calls = 0
gather_beams_packed.calls = 0


# ---------------------------------------------------------------------------
# The LBVH-culled tile gather (gather="lbvh", beam_gather.py:1325-1504)
# ---------------------------------------------------------------------------

class _TileCfg(NamedTuple):
    kernel: int
    tile: int
    n_tiles: int
    power_scale: float
    min_sin: float


def _seg_slice(seg: dict, ti: int, tile: int) -> dict:
    """Tile ti's rows of the per-ray fields (the scalars whole)."""
    return _seg_rows(seg, ti * tile, (ti + 1) * tile)


def _tile_cb(pb: dict, cand_t: torch.Tensor) -> dict:
    """The candidate beams of one tile, (K, ...) each; the -1 padding reads
    beam 0 with its validity zeroed."""
    cb = {k: v[cand_t.clamp_min(0)] for k, v in pb.items()}
    cb["valid_f"] = cb["valid_f"] * (cand_t >= 0).to(torch.float32)
    return cb


def _tile_contrib(cfg: _TileCfg, cb: dict, seg_t: dict) -> torch.Tensor:
    return _chunk_contrib(cb, seg_t, cfg.kernel, cfg.power_scale,
                          cfg.min_sin)


class _GatherTilesCore(torch.autograd.Function):
    """The reference's ``_gather_tiles_core`` custom VJP: per ray tile, the
    dense tile x K contribution of its candidate beams; the backward
    recomputes one tile at a time under autograd (one tile's pairwise
    intermediates live at once), adds the beam cotangents into the rows of
    the tile's candidates (distinct ids within a tile, tiles in order) and
    the segment cotangents into the tile's rows.  The candidate ids are
    structure: they get no cotangent."""

    @staticmethod
    def forward(ctx, cfg, pb_keys, seg_keys, cand, *tensors):
        pb = dict(zip(pb_keys, tensors[:len(pb_keys)]))
        seg = dict(zip(seg_keys, tensors[len(pb_keys):]))
        ctx.cfg, ctx.keys = cfg, (pb_keys, seg_keys)
        ctx.save_for_backward(cand, *tensors)
        return torch.cat([
            _tile_contrib(cfg, _tile_cb(pb, cand[ti]),
                          _seg_slice(seg, ti, cfg.tile))
            for ti in range(cfg.n_tiles)], 0)

    @staticmethod
    def backward(ctx, ct):
        cfg, (pb_keys, seg_keys) = ctx.cfg, ctx.keys
        cand, *tensors = ctx.saved_tensors
        n_pb = len(pb_keys)
        pb = dict(zip(pb_keys, tensors[:n_pb]))
        seg = dict(zip(seg_keys, tensors[n_pb:]))
        need = ctx.needs_input_grad[4:]
        need_pb = dict(zip(pb_keys, need[:n_pb]))
        need_seg = dict(zip(seg_keys, need[n_pb:]))
        d_pb = {k: torch.zeros_like(v) if need_pb[k] else None
                for k, v in pb.items()}
        d_seg = {k: torch.zeros_like(v) if need_seg[k] else None
                 for k, v in seg.items()}
        ct = ct.contiguous()
        for ti in range(cfg.n_tiles):
            cand_t = cand[ti]
            lo, hi = ti * cfg.tile, (ti + 1) * cfg.tile
            with torch.enable_grad():
                cb = {k: v.detach().requires_grad_(need_pb[k])
                      for k, v in _tile_cb(pb, cand_t).items()}
                sp = {k: v.detach().requires_grad_(need_seg[k])
                      for k, v in _seg_slice(seg, ti, cfg.tile).items()}
                out = _tile_contrib(cfg, cb, sp)
                if not out.requires_grad:
                    continue
                leaves = ([("pb", k, v) for k, v in cb.items() if need_pb[k]]
                          + [("seg", k, v) for k, v in sp.items()
                             if need_seg[k]])
                grads = torch.autograd.grad(out, [v for _, _, v in leaves],
                                            ct[lo:hi], allow_unused=True)
            live = cand_t >= 0
            ids = cand_t[live]
            for (side, k, _), g in zip(leaves, grads):
                if g is None:
                    continue
                if side == "pb":
                    d_pb[k].index_add_(0, ids, g[live])
                elif k in _SEG_SCALARS:
                    d_seg[k] += g
                else:
                    d_seg[k][lo:hi] += g
        grads = [d_pb[k] for k in pb_keys] + [d_seg[k] for k in seg_keys]
        return (None, None, None, None, *grads)


def gather_beams_lbvh(beams, bvh, tile_cand: torch.Tensor, media: Media,
                      seg_a0, seg_a1, seg_dir, seg_medium, seg_tr_full,
                      cam_radius, kernel: int = KERNEL_BRE, tile: int = 128,
                      power_scale: float = 1.0,
                      min_sin_theta: float = 0.05) -> torch.Tensor:
    """The LBVH-culled gather (beam_gather.py:1415-1465): per ray tile,
    only the beams whose inflated boxes meet the tile's segment bounds, the
    (n_tiles, K) candidates of ``accel.lbvh.query_aabb_collect`` (-1
    padded), through the dense tile x K ``_chunk_contrib``.  R must be a
    multiple of ``tile`` (the caller pads).  ``bvh`` is the caller's tree,
    unused here as in the reference.  Returns (R, 3), differentiable in the
    beams and the segments as ``_GatherTilesCore`` says."""
    R = seg_a0.shape[0]
    n_tiles, _ = tile_cand.shape
    if R != n_tiles * tile:
        raise ValueError(f"{R} segments are not {n_tiles} tiles of {tile}")
    pb = dict(start=beams.start, end=beams.end,
              power_start=beams.power_start, power_end=beams.power_end,
              radius=beams.radius, valid_f=beams.valid.to(torch.float32))
    _, sigma_s_seg, g_seg, _, seg_in_med = gather_medium(media, seg_medium)
    seg = dict(a0=seg_a0, a1=seg_a1, dir=seg_dir,
               len=_max(length(seg_a1 - seg_a0), 1e-30),
               tr_full=seg_tr_full, sigma_s=sigma_s_seg, g=g_seg,
               in_med_f=seg_in_med.to(torch.float32),
               cam_radius=torch.as_tensor(cam_radius, dtype=torch.float32,
                                          device=seg_a0.device).reshape(()))
    cfg = _TileCfg(int(kernel), int(tile), int(n_tiles), float(power_scale),
                   float(min_sin_theta))
    return _GatherTilesCore.apply(cfg, tuple(pb), tuple(seg),
                                  tile_cand.detach(), *pb.values(),
                                  *seg.values())


def beam_aabbs(beams, extra_radius):
    """Radius-inflated beam boxes (photonbeambvh.h:48-73), the camera blur
    radius folded in so that the tile queries need no inflation."""
    r = (beams.radius + extra_radius)[:, None]
    return (torch.minimum(beams.start, beams.end) - r,
            torch.maximum(beams.start, beams.end) + r)


def tile_aabbs(seg_a0, seg_a1, tile: int):
    """Each tile's bounds over its camera segments (R a multiple of tile)."""
    n_tiles = seg_a0.shape[0] // tile
    a0 = seg_a0.reshape(n_tiles, tile, 3)
    a1 = seg_a1.reshape(n_tiles, tile, 3)
    return (torch.minimum(a0.amin(1), a1.amin(1)),
            torch.maximum(a0.amax(1), a1.amax(1)))
