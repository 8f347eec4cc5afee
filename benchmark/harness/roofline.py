"""The yardstick of the gather kernels' roofline shares: the peaks of one
NVIDIA H100, the operations each (ray, beam) pair needs, and the count of
pairs within the blur width, taken from the gather's inputs.

Frozen copies, taken at commit b8e63ac:
- the peaks and the operations per pair: ``chip_smoke.py``'s
  ``PEAK_FP32``, ``PEAK_BYTES``, ``GEOM_OPS``, ``FWD_IN_OPS``,
  ``FWD_IN_OPS_HET``, ``BWD_IN_OPS``, ``BWD_EXTRAS_OPS``,
  ``BWD_IN_OPS_HET`` and ``BWD_EXTRAS_OPS_HET`` (each rounded multiply, add, subtract, min, max and
  comparison one; each divide, rsqrt, exp and log one more);
- the pair geometry: the closest points and r^2 < 1 of
  ``bre_tpu_torch/ops/gather.pair_geometry_ref``.

The work needed by a sweep is its in-range pairs times the geometry and
the forward (or backward) terms: the geometry of pairs outside the blur width, which a
cull decides not to compute, is no needed work.  Which pairs are in range
is counted from the inputs alone (the segments of the rays in a medium,
the valid beams, the two radii), never from the program's block mask,
sparse pick or launch grid.  A full-film sweep has some 10^11 pairs, more
than plain PyTorch can test in a run's time, so each sweep tests a fixed
systematic sample of its rays against every valid beam and scales the
count by rays / sampled rays: an estimate that repeats exactly on the same
inputs.  The bytes are the sweep's inputs read once and its output written
once; the operations bound every sweep by a factor of hundreds.  A
backward sweep pairs the same rays and beams as its forward sweep, so its
pairs are counted from the forward's inputs.
"""

from __future__ import annotations

import torch

PEAK_FP32 = 67e12  # FLOP/s, FP32 outside the tensor cores, H100 SXM, 700 W
PEAK_BYTES = 3.35e12  # B/s, HBM3
GEOM_OPS = 58
FWD_IN_OPS = 54
FWD_IN_OPS_HET = 30 + 31 + 30
BWD_IN_OPS, BWD_EXTRAS_OPS = 73, 39
BWD_IN_OPS_HET = 31 + 31 + 3 * (23 + 6) + 36 + 17
BWD_EXTRAS_OPS_HET = 22 + 3 * 15
# per ray: a0, a1, dir, transmittance, sigma_s (3 each), g, medium; out 3
RAY_FLOATS = 3 * 5 + 2 + 3
# per beam: start, end, start and end power (3 each), radius
BEAM_FLOATS = 3 * 4 + 1
# the backward also reads each ray's cotangent (3) and writes its d_rays
# (8), and writes each beam's d power (6) and d radius
BWD_RAY_FLOATS = RAY_FLOATS + 3 + 8
BWD_BEAM_FLOATS = BEAM_FLOATS + 7
SAMPLE_RAYS = 512  # rays of a sweep tested against every beam
_BATCH_PAIRS = 1 << 24


def in_range_pairs(a0, a1, b0, b1, width) -> int:
    """Pairs (ray i, beam j) whose closest points lie within ``width[j]``:
    rays a0, a1 (R, 3), beams b0, b1 (B, 3), width (B,).  The geometry of
    ``pair_geometry_ref``, its guards included."""
    total = 0
    step = max(1, _BATCH_PAIRS // max(1, a0.shape[0]))
    A0, D1 = a0[:, None, :], (a1 - a0)[:, None, :]
    a = (D1 * D1).sum(-1)
    for lo in range(0, b0.shape[0], step):
        B0 = b0[None, lo:lo + step, :]
        D2 = b1[None, lo:lo + step, :] - B0
        w = torch.clamp_min(width[None, lo:lo + step], 1e-30)
        e = (D2 * D2).sum(-1)
        rr = A0 - B0
        b = (D1 * D2).sum(-1)
        c_ = (D1 * rr).sum(-1)
        f = (D2 * rr).sum(-1)
        denom = a * e - b * b
        dpos = denom > 1e-12
        s = torch.where(dpos, (b * f - c_ * e) / torch.where(
            dpos, denom, torch.ones_like(denom)), torch.zeros_like(denom))
        s = torch.clamp(s, 0.0, 1.0)
        epos = e > 1e-12
        inv_e = torch.where(epos, 1.0 / torch.where(epos, e,
                                                    torch.ones_like(e)),
                            torch.zeros_like(e))
        t = (b * s + f) * inv_e
        t_cl = torch.clamp(t, 0.0, 1.0)
        apos = a > 1e-12
        inv_a = torch.where(apos, 1.0 / torch.where(apos, a,
                                                    torch.ones_like(a)),
                            torch.zeros_like(a))
        s_new = torch.clamp((t_cl * b - c_) * inv_a, 0.0, 1.0)
        s = torch.where((t != t_cl) & apos, s_new, s)
        diff = (A0 + D1 * s[..., None]) - (B0 + D2 * t_cl[..., None])
        dist2 = (diff * diff).sum(-1)
        inv_w = 1.0 / w
        total += int(((dist2 * (inv_w * inv_w)) < 1.0).sum())
    return total


def sweep_work(seg_a0, seg_a1, seg_medium, cam_radius, beams, hetero: bool,
               sample: int = SAMPLE_RAYS, backward: bool = False,
               extras: bool = False):
    """(operations, bytes, in-range pairs) one forward sweep needs, or
    with ``backward`` its backward sweep (``extras``: with the extra
    cotangents).  ``beams`` holds the valid beams' start, end and
    radius."""
    rays = torch.nonzero(seg_medium >= 0).reshape(-1)
    n_rays, n_beams = int(rays.shape[0]), int(beams["radius"].shape[0])
    if n_rays == 0 or n_beams == 0:
        return 0.0, 0.0, 0.0
    pick = rays[::max(1, n_rays // sample)]
    width = cam_radius + beams["radius"]
    hits = in_range_pairs(seg_a0[pick].float(), seg_a1[pick].float(),
                          beams["start"], beams["end"], width)
    pairs = hits * n_rays / pick.shape[0]
    if backward:
        in_ops = (BWD_IN_OPS_HET + (BWD_EXTRAS_OPS_HET if extras else 0)
                  if hetero else BWD_IN_OPS + (BWD_EXTRAS_OPS if extras
                                                else 0))
        n_bytes = 4.0 * (n_rays * BWD_RAY_FLOATS + n_beams * BWD_BEAM_FLOATS)
    else:
        in_ops = FWD_IN_OPS_HET if hetero else FWD_IN_OPS
        n_bytes = 4.0 * (n_rays * RAY_FLOATS + n_beams * BEAM_FLOATS)
    return pairs * (GEOM_OPS + in_ops), n_bytes, pairs


def least_seconds(ops: float, n_bytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / PEAK_FP32, n_bytes / PEAK_BYTES)


def valid_beams(beams) -> dict:
    """The valid beams' geometry, for the roofline yardstick."""
    v = beams.valid
    return dict(start=beams.start.detach()[v].float(),
                end=beams.end.detach()[v].float(),
                radius=beams.radius.detach()[v].float())


def forward_work(rd, backward: bool = False) -> tuple:
    """(least seconds, in-range pairs) of the traced iterations' forward
    sweeps, or with ``backward`` of their backward sweeps, summed sweep by
    sweep."""
    least, pairs = 0.0, 0.0
    for cap in rd.captures:
        beams = valid_beams(cap["beams"])
        for sw in cap["sweeps"]:
            ops, n_bytes, p = sweep_work(
                sw["a0"], sw["a1"], sw["medium"], sw["cam_radius"], beams,
                rd.hetero, backward=backward,
                extras=getattr(rd, "extras", False))
            least += least_seconds(ops, n_bytes)
            pairs += p
    return least, pairs
