"""Catmull-Rom spline and Fourier-series interpolation and sampling
(counterpart of ``bre_tpu/core/interpolation.py``; pbrt
interpolation.{h,cpp}: CatmullRomWeights, SampleCatmullRom2D,
IntegrateCatmullRom, InvertCatmullRom, Fourier, SampleFourier).

Every routine is batched over a leading lane axis.  The reference's
data-dependent Newton-bisection loops run a fixed ``_NEWTON_ITERS``
iterations, as the reference's do, so no call reads the device from the
host; ``FindInterval`` is ``torch.searchsorted(right=True)``.
"""

from __future__ import annotations

import math

import torch

_NEWTON_ITERS = 32


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[..., idx] lane by lane: a (..., N) (or (N,), shared), idx (...,)."""
    if a.dim() == 1:
        return a[idx]
    return torch.gather(a.expand(*idx.shape, a.shape[-1]), -1,
                        idx[..., None])[..., 0]


def find_interval(nodes: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """FindInterval (pbrt.h) over the last axis of ``nodes`` (N,) or
    (..., N), sorted ascending: the index in [0, N-2] with nodes[idx] <=
    x, clamped at the ends."""
    if nodes.dim() == 1:
        idx = torch.searchsorted(nodes, x.contiguous(), right=True) - 1
    else:
        idx = torch.searchsorted(nodes.contiguous(), x[..., None].contiguous(),
                                 right=True)[..., 0] - 1
    return torch.clamp(idx, 0, nodes.shape[-1] - 2)


def catmull_rom_weights(nodes: torch.Tensor, x: torch.Tensor):
    """CatmullRomWeights (interpolation.cpp:61-104).  nodes (N,) or
    (..., N); x (...,).  Returns (offset (...,) int64, weights (..., 4),
    valid (...,) bool); offset + i may leave [0, N) only where its weight
    is zero, so callers clamp at the gather."""
    N = nodes.shape[-1]
    valid = (x >= nodes[..., 0]) & (x <= nodes[..., -1])
    idx = find_interval(nodes, x)
    offset = idx - 1

    def g(i):
        return _take(nodes, torch.clamp(i, 0, N - 1))

    x0 = g(idx)
    x1 = g(idx + 1)
    one = torch.ones_like(x)
    t = (x - x0) / torch.where(x1 == x0, one, x1 - x0)
    t2 = t * t
    t3 = t2 * t
    w1 = 2 * t3 - 3 * t2 + 1
    w2 = -2 * t3 + 3 * t2
    has_prev = idx > 0
    den_prev = x1 - g(idx - 1)
    w0_in = (t3 - 2 * t2 + t) * (x1 - x0) / torch.where(has_prev, den_prev,
                                                        one)
    w0_edge = t3 - 2 * t2 + t
    w0 = torch.where(has_prev, -w0_in, torch.zeros_like(x))
    w1 = torch.where(has_prev, w1, w1 - w0_edge)
    w2 = torch.where(has_prev, w2 + w0_in, w2 + w0_edge)
    has_next = idx + 2 < N
    w3_in = (t3 - t2) * (x1 - x0) / torch.where(has_next, g(idx + 2) - x0,
                                                one)
    w3_edge = t3 - t2
    w3 = torch.where(has_next, w3_in, torch.zeros_like(x))
    w1 = torch.where(has_next, w1 - w3_in, w1 - w3_edge)
    w2 = torch.where(has_next, w2, w2 + w3_edge)
    weights = torch.stack([w0, w1, w2, w3], -1)
    weights = torch.where(valid[..., None], weights,
                          torch.zeros_like(weights))
    return offset, weights, valid


def spline_gather_1d(values, offset, weights):
    """sum_i weights[..., i] * values[offset + i], indices clamped;
    values (N,) or (..., N) matching offset's batch shape."""
    N = values.shape[-1]
    out = 0.0
    for i in range(4):
        v = _take(values, torch.clamp(offset + i, 0, N - 1))
        out = out + weights[..., i] * v
    return out


def integrate_catmull_rom(x: torch.Tensor, values: torch.Tensor):
    """IntegrateCatmullRom (interpolation.cpp:260-284) over the last axis:
    x (N,), values (..., N).  Returns (cdf (..., N), total (...,))."""
    v = values
    x0, x1 = x[:-1], x[1:]
    f0, f1 = v[..., :-1], v[..., 1:]
    width = x1 - x0
    d0_in = width[1:] * (f1[..., 1:] - v[..., :-2]) / (x1[1:] - x[:-2])
    d0 = torch.cat([(f1 - f0)[..., :1], d0_in], -1)
    d1_in = width[:-1] * (v[..., 2:] - f0[..., :-1]) / (x[2:] - x0[:-1])
    d1 = torch.cat([d1_in, (f1 - f0)[..., -1:]], -1)
    seg = ((d0 - d1) * (1.0 / 12.0) + (f0 + f1) * 0.5) * width
    cdf = torch.cat([torch.zeros_like(seg[..., :1]), torch.cumsum(seg, -1)],
                    -1)
    return cdf, cdf[..., -1]


def _newton_bisect(evaluate, u, t):
    """The reference's fixed-trip Newton-bisection on [0, 1]:
    evaluate(t) -> (F(t), F'(t)); solves F = u.  Returns (t, the last
    F')."""
    a = torch.zeros_like(u)
    b = torch.ones_like(u)
    fhat = torch.zeros_like(u)
    one = torch.ones_like(u)
    for _ in range(_NEWTON_ITERS):
        t = torch.where((t > a) & (t < b), t, 0.5 * (a + b))
        Fhat, fhat = evaluate(t)
        gt = Fhat - u < 0
        a = torch.where(gt, t, a)
        b = torch.where(gt, b, t)
        t = t - (Fhat - u) / torch.where(fhat == 0, one, fhat)
    return t, fhat


def invert_catmull_rom(x: torch.Tensor, values: torch.Tensor,
                       u: torch.Tensor) -> torch.Tensor:
    """InvertCatmullRom (interpolation.cpp:286-345): the x where the
    spline through a monotonically increasing ``values`` reaches u."""
    N = x.shape[0]
    below = ~(u > values[0])
    above = ~(u < values[-1])
    i = torch.clamp(torch.searchsorted(values, u.contiguous(), right=True) - 1,
                    0, N - 2)
    x0, x1 = x[i], x[i + 1]
    f0, f1 = values[i], values[i + 1]
    width = x1 - x0
    im1 = torch.clamp_min(i - 1, 0)
    ip2 = torch.clamp_max(i + 2, N - 1)
    d0 = torch.where(i > 0, width * (f1 - values[im1]) / (x1 - x[im1]),
                     f1 - f0)
    d1 = torch.where(i + 2 < N, width * (values[ip2] - f0) / (x[ip2] - x0),
                     f1 - f0)

    def evaluate(t):
        t2 = t * t
        t3 = t2 * t
        Fhat = ((2 * t3 - 3 * t2 + 1) * f0 + (-2 * t3 + 3 * t2) * f1
                + (t3 - 2 * t2 + t) * d0 + (t3 - t2) * d1)
        fhat = ((6 * t2 - 6 * t) * f0 + (-6 * t2 + 6 * t) * f1
                + (3 * t2 - 4 * t + 1) * d0 + (3 * t2 - 2 * t) * d1)
        return Fhat, fhat

    t, _ = _newton_bisect(evaluate, u, torch.full_like(u, 0.5))
    out = x0 + torch.clamp(t, 0.0, 1.0) * width
    return torch.where(below, x[0], torch.where(above, x[-1], out))


def _invert_spline_segment(f0, f1, d0, d1, u):
    """The Newton-bisection inverting one spline segment's integral (the
    loop of SampleCatmullRom2D, interpolation.cpp:224-252).  Returns
    (t, fhat)."""
    one = torch.ones_like(u)
    t_init = torch.where(
        f0 != f1,
        (f0 - torch.sqrt(torch.clamp_min(f0 * f0 + 2 * u * (f1 - f0), 0.0)))
        / torch.where(f0 == f1, one, f0 - f1),
        u / torch.where(f0 == 0, one, f0))

    def evaluate(t):
        Fhat = t * (f0 + t * (0.5 * d0 + t * (
            (1.0 / 3.0) * (-2 * d0 - d1) + f1 - f0
            + t * (0.25 * (d0 + d1) + 0.5 * (f0 - f1)))))
        fhat = f0 + t * (d0 + t * (-2 * d0 - d1 + 3 * (f1 - f0)
                                   + t * (d0 + d1 + 2 * (f0 - f1))))
        return Fhat, fhat

    t, fhat = _newton_bisect(evaluate, u, t_init)
    return torch.clamp(t, 0.0, 1.0), fhat


def sample_catmull_rom_2d(nodes1, nodes2, values, cdf, alpha, u,
                          table_idx=None):
    """SampleCatmullRom2D (interpolation.cpp:178-258) over lanes.
    nodes1 (N1,) or (..., N1); nodes2 (N2,) or (..., N2); values and cdf
    (N1, N2), or stacked (Nt, N1, N2) picked per lane by ``table_idx``;
    alpha, u (...,).  Returns (x, fval, pdf), each (...,)."""
    N2 = nodes2.shape[-1]
    off1, w1, ok = catmull_rom_weights(nodes1, alpha)

    def interp_row(arr):
        N1 = arr.shape[-2]
        out = 0.0
        for i in range(4):
            j1 = torch.clamp(off1 + i, 0, N1 - 1)
            v = arr[j1, :] if arr.dim() == 2 else arr[table_idx, j1, :]
            out = out + w1[..., i, None] * v
        return out

    cdf_row = interp_row(cdf)
    maximum = cdf_row[..., -1]
    u = u * maximum
    idx = torch.clamp((cdf_row <= u[..., None]).sum(-1) - 1, 0, N2 - 2)
    val_row = interp_row(values)

    def take2(row, j):
        return torch.gather(row, -1, torch.clamp(j, 0, N2 - 1)[..., None]
                            )[..., 0]

    def node2(j):
        return _take(nodes2, torch.clamp(j, 0, N2 - 1))

    f0 = take2(val_row, idx)
    f1 = take2(val_row, idx + 1)
    x0 = node2(idx)
    x1 = node2(idx + 1)
    width = x1 - x0
    one = torch.ones_like(u)
    u_seg = (u - take2(cdf_row, idx)) / torch.where(width == 0, one, width)
    d0 = torch.where(idx > 0, width * (f1 - take2(val_row, idx - 1))
                     / (x1 - node2(idx - 1)), f1 - f0)
    d1 = torch.where(idx + 2 < N2, width * (take2(val_row, idx + 2) - f0)
                     / (node2(idx + 2) - x0), f1 - f0)
    t, fhat = _invert_spline_segment(f0, f1, d0, d1, u_seg)
    x = x0 + width * t
    zero = torch.zeros_like(u)
    pdf = torch.where((maximum > 0) & ok,
                      fhat / torch.where(maximum == 0, one, maximum), zero)
    return (torch.where(ok, x, zero), torch.where(ok, fhat, zero), pdf)


# ---------------------------------------------------------------------------
# Fourier series (the FourierBSDF)
# ---------------------------------------------------------------------------

def fourier_eval(ak: torch.Tensor, m_mask: torch.Tensor,
                 cos_phi: torch.Tensor) -> torch.Tensor:
    """Fourier (interpolation.cpp:347-362): sum_k a_k cos(k phi) by the
    Chebyshev recurrence; ak, m_mask (..., M), cos_phi (...,).  float32,
    as the reference runs without x64."""
    value = torch.zeros_like(cos_phi)
    ckm1, ck = cos_phi, torch.ones_like(cos_phi)
    for k in range(ak.shape[-1]):
        value = value + ak[..., k] * m_mask[..., k] * ck
        ckm1, ck = ck, 2.0 * cos_phi * ck - ckm1
    return value


def sample_fourier(ak: torch.Tensor, m_mask: torch.Tensor, u: torch.Tensor):
    """SampleFourier (interpolation.cpp:364-421): phi in [0, 2 pi) from the
    CDF of the Fourier expansion by Newton-bisection with the sin/cos
    recurrences.  Returns (fval, pdf, phi)."""
    M = ak.shape[-1]
    flip = u >= 0.5
    u = torch.where(flip, 1.0 - 2.0 * (u - 0.5), 2.0 * u)
    pi = math.pi
    recip = torch.cat([torch.ones(1, dtype=ak.dtype, device=ak.device),
                       1.0 / torch.arange(1, M, dtype=ak.dtype,
                                          device=ak.device)])

    def eval_Ff(phi):
        cos_phi = torch.cos(phi)
        sin_phi = torch.sqrt(torch.clamp_min(1.0 - cos_phi * cos_phi, 0.0))
        F = ak[..., 0] * phi
        f = ak[..., 0]
        sin_prev, sin_cur = -sin_phi, torch.zeros_like(phi)
        cos_prev, cos_cur = cos_phi, torch.ones_like(phi)
        for k in range(1, M):
            sin_next = 2.0 * cos_phi * sin_cur - sin_prev
            cos_next = 2.0 * cos_phi * cos_cur - cos_prev
            a_k = ak[..., k] * m_mask[..., k]
            F = F + a_k * recip[k] * sin_next
            f = f + a_k * cos_next
            sin_prev, sin_cur = sin_cur, sin_next
            cos_prev, cos_cur = cos_cur, cos_next
        return F - u * ak[..., 0] * pi, f

    a = torch.zeros_like(u)
    b = torch.full_like(u, pi)
    phi = torch.full_like(u, 0.5 * pi)
    one = torch.ones_like(u)
    for _ in range(_NEWTON_ITERS):
        F, f = eval_Ff(phi)
        gt = F > 0
        b = torch.where(gt, phi, b)
        a = torch.where(gt, a, phi)
        phi = phi - F / torch.where(f == 0, one, f)
        phi = torch.where((phi > a) & (phi < b), phi, 0.5 * (a + b))
    _, f = eval_Ff(phi)
    phi = torch.where(flip, 2.0 * pi - phi, phi)
    pdf = f / torch.where(ak[..., 0] == 0, one, 2.0 * pi * ak[..., 0])
    pdf = torch.where(ak[..., 0] > 0, pdf, torch.zeros_like(pdf))
    return f, pdf, phi
