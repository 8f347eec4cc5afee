"""AnimatedTransform: keyframe matrix interpolation for motion blur
(counterpart of ``bre_tpu/core/animated.py``; pbrt transform.{h,cpp}
AnimatedTransform, Decompose, Interpolate, MotionBounds; quaternion.{h,cpp}).

The keyframes are decomposed on the host in float64 numpy with the
reference's arithmetic (its 100-step polar iteration included), so the
translations, rotations and scales come out bit for bit; ``interpolate``
runs on tensors over a whole batch of per-ray times.  ``motion_bounds``
is the reference's sampled sweep: the box's corners at 128 times, their
union inflated by 10% of the largest step of a corner.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Quaternions, (x, y, z, w) (quaternion.h)
# ---------------------------------------------------------------------------

def quat_from_matrix(m):
    """Quaternion(const Transform&) (quaternion.cpp:~60-100) of a numpy
    3x3 or 4x4, in float64."""
    m = np.asarray(m, np.float64)[:3, :3]
    trace = m[0, 0] + m[1, 1] + m[2, 2]
    q = np.zeros(4)
    if trace > 0:
        s = np.sqrt(trace + 1.0)
        q[3] = s / 2
        s = 0.5 / s
        q[0] = (m[2, 1] - m[1, 2]) * s
        q[1] = (m[0, 2] - m[2, 0]) * s
        q[2] = (m[1, 0] - m[0, 1]) * s
    else:
        nxt = [1, 2, 0]
        i = 0
        if m[1, 1] > m[0, 0]:
            i = 1
        if m[2, 2] > m[i, i]:
            i = 2
        j = nxt[i]
        k = nxt[j]
        s = np.sqrt((m[i, i] - (m[j, j] + m[k, k])) + 1.0)
        q[i] = s * 0.5
        if s != 0:
            s = 0.5 / s
        q[3] = (m[k, j] - m[j, k]) * s
        q[j] = (m[j, i] + m[i, j]) * s
        q[k] = (m[k, i] + m[i, k]) * s
    return q


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion::ToTransform (quaternion.cpp:~40-58): (..., 4) ->
    (..., 4, 4), the transpose of the rows pbrt writes."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    rows = [
        [1 - 2 * (yy + zz), 2 * (xy + wz), 2 * (xz - wy), zero],
        [2 * (xy - wz), 1 - 2 * (xx + zz), 2 * (yz + wx), zero],
        [2 * (xz + wy), 2 * (yz - wx), 1 - 2 * (xx + yy), zero],
        [zero, zero, zero, one],
    ]
    m = torch.stack([torch.stack(r, -1) for r in rows], -2)
    return m.transpose(-1, -2)


def _norm(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last axis, the squares added in index order."""
    sq = v * v
    acc = sq[..., 0]
    for k in range(1, v.shape[-1]):
        acc = acc + sq[..., k]
    return torch.sqrt(acc)[..., None]


def slerp(q0: torch.Tensor, q1: torch.Tensor, t: torch.Tensor):
    """Slerp (quaternion.cpp:~102-115) of two quaternions (4,) at times
    t (...,); a normalized lerp where they are nearly parallel."""
    cos_theta = (q0 * q1).sum(-1)
    q_lin = q0 + t[..., None] * (q1 - q0)
    q_lin = q_lin / _norm(q_lin)
    theta = torch.arccos(torch.clamp(cos_theta, -1.0, 1.0))
    thetap = theta * t
    qperp = q1 - q0 * cos_theta[..., None]
    qperp = qperp / torch.clamp_min(_norm(qperp), 1e-12)
    q_sph = (q0 * torch.cos(thetap)[..., None]
             + qperp * torch.sin(thetap)[..., None])
    return torch.where(cos_theta > 0.9995, q_lin, q_sph)


# ---------------------------------------------------------------------------
# Decomposition (host) and the AnimatedTransform
# ---------------------------------------------------------------------------

def decompose(m):
    """AnimatedTransform::Decompose (transform.cpp:~1130-1170): M = T R S,
    R from the polar iteration M_{i+1} = (M_i + (M_i^T)^-1) / 2 (at most
    100 steps, stopping below 1e-4), in float64.  Returns (T (3,),
    q (4,), S (4,4)) as float32 numpy."""
    m = np.asarray(m, np.float64)
    T = m[:3, 3].copy()
    M = m.copy()
    M[:3, 3] = 0.0
    M[3, :] = [0, 0, 0, 1]
    R = M.copy()
    for _ in range(100):
        Rnext = 0.5 * (R + np.linalg.inv(R.T))
        if np.max(np.abs(Rnext - R)) < 1e-4:
            R = Rnext
            break
        R = Rnext
    q = quat_from_matrix(R)
    S = np.linalg.inv(R) @ M
    return T.astype(np.float32), q.astype(np.float32), S.astype(np.float32)


class AnimatedTransform(NamedTuple):
    """Two decomposed keyframes and their time range."""

    t0: float  # start time (float32-exact)
    t1: float  # end time
    trans0: torch.Tensor  # (3,)
    trans1: torch.Tensor  # (3,)
    q0: torch.Tensor  # (4,)
    q1: torch.Tensor  # (4,)
    s0: torch.Tensor  # (4, 4)
    s1: torch.Tensor  # (4, 4)
    m_start: torch.Tensor  # (4, 4) the exact keyframe matrices
    m_end: torch.Tensor  # (4, 4)
    animated: bool


def make_animated_transform(m_start, m_end, t0=0.0, t1=1.0,
                            device="cpu") -> AnimatedTransform:
    """The AnimatedTransform of two keyframe matrices (transform.cpp
    AnimatedTransform ctor), the second rotation flipped to the first's
    hemisphere for the shortest-path slerp."""
    m_start = np.asarray(m_start, np.float32)
    m_end = np.asarray(m_end, np.float32)
    T0, q0, S0 = decompose(m_start)
    T1, q1, S1 = decompose(m_end)
    if np.dot(q0, q1) < 0:
        q1 = -q1

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return AnimatedTransform(
        t0=float(np.float32(t0)), t1=float(np.float32(t1)),
        trans0=f(T0), trans1=f(T1), q0=f(q0), q1=f(q1), s0=f(S0), s1=f(S1),
        m_start=f(m_start), m_end=f(m_end),
        animated=not np.allclose(m_start, m_end))


def interpolate(at: AnimatedTransform, time) -> torch.Tensor:
    """AnimatedTransform::Interpolate (transform.cpp:~1172-1205): times
    (...,) -> matrices (..., 4, 4); lerp T, slerp R, lerp S, clamped to
    [t0, t1], the keyframes' own matrices at the ends."""
    time = torch.as_tensor(time, dtype=torch.float32, device=at.q0.device)
    span = np.float32(max(np.float32(at.t1) - np.float32(at.t0),
                          np.float32(1e-12)))
    dt = torch.clamp((time - at.t0) / float(span), 0.0, 1.0)
    trans = (1 - dt)[..., None] * at.trans0 + dt[..., None] * at.trans1
    q = slerp(at.q0, at.q1, dt)
    S = (1 - dt)[..., None, None] * at.s0 + dt[..., None, None] * at.s1
    M = quat_to_matrix(q) @ S
    M[..., :3, 3] += trans
    M = torch.where((dt == 0.0)[..., None, None], at.m_start, M)
    return torch.where((dt == 1.0)[..., None, None], at.m_end, M)


_MB_SAMPLES = 128


def motion_bounds(at: AnimatedTransform, b_min, b_max):
    """AnimatedTransform::MotionBounds, as the reference redesigns it
    (animated.py:165-188): the box's eight corners at 128 times from t0 to
    t1, their union inflated by 10% of the largest step of a corner.
    Returns (min (3,), max (3,))."""
    dev = at.q0.device
    b_min = torch.as_tensor(b_min, dtype=torch.float32, device=dev)
    b_max = torch.as_tensor(b_max, dtype=torch.float32, device=dev)
    corners = torch.stack([
        torch.stack([b_max[0] if i & 1 else b_min[0],
                     b_max[1] if i & 2 else b_min[1],
                     b_max[2] if i & 4 else b_min[2]]) for i in range(8)])
    lin = torch.linspace(0.0, 1.0, _MB_SAMPLES, dtype=torch.float32,
                         device=dev)
    ts = at.t0 + float(np.float32(at.t1) - np.float32(at.t0)) * lin
    M = interpolate(at, ts)  # (N, 4, 4)
    pts = (torch.einsum("nij,cj->nci", M[:, :3, :3], corners)
           + M[:, None, :3, 3])
    lo = pts.amin(dim=(0, 1))
    hi = pts.amax(dim=(0, 1))
    step = _norm(pts[1:] - pts[:-1]).max()
    pad = 0.1 * step
    return lo - pad, hi + pad


def apply_animated_point(at: AnimatedTransform, time, p):
    """Points (R,3) at per-lane times (R,)."""
    M = interpolate(at, time)
    return (M[:, :3, :3] @ p[:, :, None])[:, :, 0] + M[:, :3, 3]


def apply_animated_vector(at: AnimatedTransform, time, v):
    """Vectors (R,3) at per-lane times (R,)."""
    M = interpolate(at, time)
    return (M[:, :3, :3] @ v[:, :, None])[:, :, 0]
