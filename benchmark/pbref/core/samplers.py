"""Sampler streams, bit for bit with ``bre_tpu/core/samplers.py``.

- ``HaltonStream``: the fork's ``AwesomeHaltonSampler`` (vsppm.cpp:122-184),
  the radical inverse of a global index for dimensions 0-999 and PCG32
  past them; the photon pass of vsppm draws from it.
- The pixel samplers of pbrt's src/samplers/ as index -> sample functions
  (``vandercorput``, ``sobol2``, ``zero_two_sequence_2d``,
  ``maxmindist_2d``, ``stratified_2d``, ``halton_2d``, ``camera_jitter``).
- The per-dimension sampler protocol (GlobalSampler, sampler.h:106-116):
  ``make_stream_spec`` + ``make_sample_stream`` give a stream that
  ``stream_1d``/``stream_2d``/``stream_camera_sample`` draw from, for the
  kinds random, stratified, 02sequence, sobol, maxmindist and halton.  The
  "random" stream is the bare PCG32 state: every dimension is its next
  ``UniformFloat``.  The other kinds carry a ``SampleStream``.

Every draw advances every lane, so a stream's dimension counter is one
Python int for the batch (the reference keeps a scalar too).  The PCG32
streams under a sampler stream advance on every draw in lockstep, as the
reference's do, because grid tracking draws from them.  uint32 values live
in int64 tensors; products and sums wrap modulo 2^32 by masking.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .lowdiscrepancy import (N_SCRAMBLE_DIMS, inverse_radical_inverse,
                             radical_inverse, radical_inverse_dynamic,
                             reverse_bits_32, scrambled_radical_inverse_dynamic)
from .rng import PCG32State, pcg32_init, pcg32_next_f32, pcg32_next_u32
from .sobol import N_SOBOL_DIMS, sobol_interval_to_index, sobol_sample

_MASK32 = 0xFFFFFFFF
_TWO_M32 = 1.0 / 4294967296.0
_ONE_MINUS_EPS = 1.0 - 2.0 ** -24
_KMAX_RESOLUTION = 128  # halton.cpp kMaxResolution
KINDS = ("random", "stratified", "02sequence", "sobol", "maxmindist", "halton")


def _u32(a) -> torch.Tensor:
    return torch.as_tensor(a).to(torch.int64) & _MASK32


# ---------------------------------------------------------------------------
# AwesomeHaltonSampler
# ---------------------------------------------------------------------------

class HaltonStream(NamedTuple):
    """AwesomeHaltonSampler state (vsppm.cpp:122-184)."""

    index: torch.Tensor  # (P,) uint32 global Halton index, in int64
    dim: int  # the next dimension, shared by the batch
    rng: PCG32State  # fallback past dimension 999: RNG(haltonIndex)


def halton_stream_init(index: torch.Tensor) -> HaltonStream:
    index = _u32(index)
    return HaltonStream(index, 0, pcg32_init(index))


def halton_next_1d(s: HaltonStream) -> Tuple[HaltonStream, torch.Tensor]:
    """Get1D (vsppm.cpp:131-137): RadicalInverse(dim++, index) below
    dimension 1000, else the PCG32 draw, which advances on every call."""
    rng, val_r = pcg32_next_f32(s.rng)
    val = radical_inverse_dynamic(s.dim, s.index) if s.dim < 1000 else val_r
    return HaltonStream(s.index, s.dim + 1, rng), val


def halton_next_2d(s: HaltonStream) -> Tuple[HaltonStream, torch.Tensor]:
    """Get2D: ``Point2f(Get1D(), Get1D())``, which g++ evaluates right to
    left, so the pair is (second draw, first draw) (samplers.py:53-60)."""
    s, a = halton_next_1d(s)
    s, b = halton_next_1d(s)
    return s, torch.stack([b, a], -1)


# ---------------------------------------------------------------------------
# Pixel samplers: sample i of n for a pixel
# ---------------------------------------------------------------------------

def _xor_bits(a: torch.Tensor, cols) -> torch.Tensor:
    """XOR of the host constants cols[k] over the set bits k of a."""
    y = torch.zeros_like(a)
    for k, c in enumerate(cols):
        y = torch.where(((a >> k) & 1).bool(), y ^ int(c), y)
    return y


def _u32_to_unit(bits: torch.Tensor) -> torch.Tensor:
    return torch.clamp_max(bits.to(torch.float32) * _TWO_M32, _ONE_MINUS_EPS)


def vandercorput(idx: torch.Tensor, scramble) -> torch.Tensor:
    """Base-2 radical inverse with an XOR scramble (lowdiscrepancy.h
    VanDerCorput)."""
    return _u32_to_unit(reverse_bits_32(idx) ^ _u32(scramble))


def _sobol2_columns():
    v, cols = 1 << 31, []
    for _ in range(32):
        cols.append(v)
        v ^= v >> 1
    return cols


_SOBOL2_COLS = _sobol2_columns()


def sobol2(idx: torch.Tensor, scramble) -> torch.Tensor:
    """The (0,2)-sequence's second dimension (lowdiscrepancy.h Sobol2)."""
    return _u32_to_unit(_xor_bits(_u32(idx), _SOBOL2_COLS) ^ _u32(scramble))


def zero_two_sequence_2d(sample_idx: torch.Tensor,
                         scramble2: torch.Tensor) -> torch.Tensor:
    """(0,2)-sequence 2D samples; scramble2 (..., 2) uint32."""
    return torch.stack([vandercorput(sample_idx, scramble2[..., 0]),
                        sobol2(sample_idx, scramble2[..., 1])], -1)


CMAXMINDIST = Path(__file__).parent / "data" / "cmaxmindist.npy"
_CMAXMIN = None


def _cmaxmin_matrix(spp: int):
    """CMaxMinDist[Log2Int(spp)] (maxmin.h:61, lowdiscrepancy.cpp:249): the
    reference's generator matrices, the port's copy of the table."""
    global _CMAXMIN
    if _CMAXMIN is None:
        _CMAXMIN = np.load(CMAXMINDIST)
    return _CMAXMIN[max(0, min(16, int(spp).bit_length() - 1))]


def multiply_generator(C, a: torch.Tensor) -> torch.Tensor:
    """MultiplyGenerator (lowdiscrepancy.h:72-78): y ^= C[i] over the set
    bits i of a."""
    return _xor_bits(_u32(a), C)


def maxmindist_2d(sample_idx: torch.Tensor, spp: int, rot_x: torch.Tensor,
                  scramble_y) -> torch.Tensor:
    """MaxMinDistSampler's first 2D dimension (maxmin.cpp:44-47):
    (i/spp rotated by rot_x, the generator-matrix sample XOR scramble_y)."""
    C = _cmaxmin_matrix(spp)
    inv = 1.0 / float(max(spp, 1))
    x = torch.remainder(_u32(sample_idx).to(torch.float32), float(spp)) * inv
    x = torch.remainder(x + rot_x, 1.0)
    y = ((multiply_generator(C, sample_idx) ^ _u32(scramble_y))
         .to(torch.float32) * _TWO_M32)
    return torch.stack([x, y], -1)


def stratified_2d(sample_idx: torch.Tensor, n_samples: int,
                  u_jitter: torch.Tensor) -> torch.Tensor:
    """Jittered stratified 2D (stratified.cpp): sample i of n on a
    ceil(sqrt(n))^2 grid, jittered in its stratum."""
    nx = int(np.ceil(np.sqrt(n_samples)))
    idx = _u32(sample_idx)
    sx = (idx % nx).to(torch.float32)
    sy = torch.div(idx, nx, rounding_mode="floor").to(torch.float32)
    return torch.stack([(sx + u_jitter[..., 0]) / nx,
                        (sy + u_jitter[..., 1]) / nx], -1)


def halton_2d(sample_idx: torch.Tensor, pixel_hash) -> torch.Tensor:
    """Halton (2, 3) pixel samples with a per-pixel Cranley-Patterson
    rotation."""
    h0 = radical_inverse(0, sample_idx)
    h1 = radical_inverse(1, sample_idx)
    ph = _u32(pixel_hash)
    r0 = (ph & 0xFFFF).to(torch.float32) / 65536.0
    r1 = (ph >> 16).to(torch.float32) / 65536.0
    return torch.stack([torch.remainder(h0 + r0, 1.0),
                        torch.remainder(h1 + r1, 1.0)], -1)


def camera_jitter(sampler: str, pixel_idx: torch.Tensor, sample_idx,
                  n_samples: int, rng: PCG32State):
    """2D film jitter of a pixel sampler (samplers.py:434-490): (rng, (R,2)
    in [0,1)).  Two draws of the pixel's stream for every kind; the
    low-discrepancy kinds scramble per pixel from ``RNG(pixel_idx)``.
    ``sample_idx`` is one int for the batch, as in the reference, or an
    (R,) tensor: each lane's own sample, where several samples' passes
    walk together."""
    R = pixel_idx.shape[0]
    if isinstance(sample_idx, torch.Tensor):
        idx = _u32(sample_idx).to(pixel_idx.device).expand(R)
    else:
        idx = torch.full((R,), int(sample_idx) & _MASK32, dtype=torch.int64,
                         device=pixel_idx.device)
    rng, s0 = pcg32_next_f32(rng)
    rng, s1 = pcg32_next_f32(rng)
    if sampler in ("sobol", "maxmindist", "02sequence"):
        s_a = pcg32_init(pixel_idx)
        s_a, bits0 = pcg32_next_u32(s_a)
        s_a, bits1 = pcg32_next_u32(s_a)
        if sampler == "sobol":
            return rng, torch.stack([sobol_sample(idx, 0, bits0),
                                     sobol_sample(idx, 1, bits1)], -1)
        if sampler == "maxmindist":
            rot = bits0.to(torch.float32) * _TWO_M32
            return rng, maxmindist_2d(idx, max(n_samples, 1), rot, bits1)
        return rng, zero_two_sequence_2d(idx, torch.stack([bits0, bits1], -1))
    if sampler == "stratified":
        return rng, stratified_2d(idx, n_samples, torch.stack([s0, s1], -1))
    if sampler == "halton":
        _, bits0 = pcg32_next_u32(pcg32_init(pixel_idx))
        return rng, halton_2d(idx, bits0)
    if sampler != "random":
        raise ValueError(f"unknown sampler {sampler!r}")
    return rng, torch.stack([s0, s1], -1)


# ---------------------------------------------------------------------------
# The per-dimension sampler protocol
# ---------------------------------------------------------------------------

def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's finalizer, the per-(pixel, dimension) scramble hash."""
    h = _u32(h)
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _MASK32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _MASK32
    return h ^ (h >> 16)


def _scramble_hash(pix: torch.Tensor, dim: int) -> torch.Tensor:
    c = ((dim & _MASK32) * 0x6C078965 + 0x2545F491) & _MASK32
    return _fmix32(((_u32(pix) * 0x9E3779B9) & _MASK32) + c)


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """A sampler's static parameters (samplers.py:222-236): the halton
    GlobalSampler's constants (halton.cpp's constructor) and the sobol
    frame's log2 resolution."""

    kind: str
    spp: int
    base_scale2: int = 1
    base_scale3: int = 1
    base_exp2: int = 0
    base_exp3: int = 0
    mult_inv2: int = 0
    mult_inv3: int = 0
    log2res: int = 0


def make_stream_spec(kind: str, width: int, height: int, spp: int) -> StreamSpec:
    """The sampler's static parameters (samplers.py:239-260); an unknown
    kind raises."""
    if kind not in KINDS:
        raise ValueError(f"unknown sampler {kind!r}; one of {KINDS}")
    spp = int(spp)
    if kind == "halton":
        s2, e2 = 1, 0
        while s2 < min(width, _KMAX_RESOLUTION):
            s2, e2 = s2 * 2, e2 + 1
        s3, e3 = 1, 0
        while s3 < min(height, _KMAX_RESOLUTION):
            s3, e3 = s3 * 3, e3 + 1
        return StreamSpec(kind, spp, s2, s3, e2, e3,
                          pow(s3 % s2, -1, s2) if s2 > 1 else 0,
                          pow(s2 % s3, -1, s3) if s3 > 1 else 0)
    if kind == "sobol":
        m = 0
        while (1 << m) < max(width, height):
            m += 1
        return StreamSpec(kind, spp, log2res=m)
    return StreamSpec(kind, spp)


class SampleStream(NamedTuple):
    """A non-"random" sampler's per-lane stream: PCG32 streams, the (hi, lo)
    global sample index, the pixel (index, x, y), the sample number, and
    the next dimension (one int for the batch)."""

    spec: StreamSpec
    rng: PCG32State
    idx_hi: torch.Tensor
    idx_lo: torch.Tensor
    pix: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    samp: torch.Tensor
    dim: int


def make_sample_stream(spec: StreamSpec, pixel_idx, px, py, sample_idx,
                       rng: PCG32State):
    """The per-pass stream of ``rng``'s lanes (samplers.py:311-346):
    pixel_idx, px, py and sample_idx are (R,) tensors (a lane's sample
    number may differ from its neighbour's).  For "random" the stream is
    ``rng`` itself."""
    if spec.kind == "random":
        return rng
    pixel_idx, px, py = _u32(pixel_idx), _u32(px), _u32(py)
    samp = _u32(torch.as_tensor(sample_idx, device=pixel_idx.device)).expand(
        pixel_idx.shape)
    idx_hi = idx_lo = torch.zeros_like(pixel_idx)
    if spec.kind == "halton":
        # GetIndexForSample (halton.cpp:93-114)
        stride = spec.base_scale2 * spec.base_scale3
        off = torch.zeros_like(pixel_idx)
        if stride > 1:
            d2 = inverse_radical_inverse(2, px % _KMAX_RESOLUTION,
                                         spec.base_exp2)
            d3 = inverse_radical_inverse(3, py % _KMAX_RESOLUTION,
                                         spec.base_exp3)
            c2 = ((stride // spec.base_scale2) * spec.mult_inv2) & _MASK32
            c3 = ((stride // spec.base_scale3) * spec.mult_inv3) & _MASK32
            off = ((((d2 * c2) & _MASK32) + ((d3 * c3) & _MASK32))
                   & _MASK32) % stride
        idx_lo = (off + samp * stride) & _MASK32
    elif spec.kind == "sobol":
        idx_hi, idx_lo = sobol_interval_to_index(spec.log2res, samp, px, py)
    return SampleStream(spec, rng, idx_hi, idx_lo, pixel_idx, px, py, samp, 0)


def _generic_1d(s: SampleStream):
    """The current dimension (past the camera sample) and the next stream."""
    kind, dim = s.spec.kind, s.dim
    rng, v_pcg = pcg32_next_f32(s.rng)  # advances on every draw
    if kind == "halton":
        v = (scrambled_radical_inverse_dynamic(dim, s.idx_lo)
             if dim < N_SCRAMBLE_DIMS else v_pcg)
    elif kind == "sobol":
        v = (sobol_sample(s.idx_lo, dim, a_hi=s.idx_hi)
             if dim < N_SOBOL_DIMS else v_pcg)
    else:  # 02sequence, maxmindist, stratified
        v = vandercorput(s.samp, _scramble_hash(s.pix, dim))
    return s._replace(rng=rng, dim=dim + 1), v


def stream_1d(s):
    """Generic Get1D on a SampleStream or a bare PCG32 state."""
    if isinstance(s, SampleStream):
        return _generic_1d(s)
    return pcg32_next_f32(s)


def stream_2d(s):
    """Generic Get2D, (first, second); the (0,2) kinds pair VdC and Sobol2
    on one pair of dimensions."""
    if isinstance(s, SampleStream) and s.spec.kind in (
            "02sequence", "maxmindist", "stratified"):
        a = vandercorput(s.samp, _scramble_hash(s.pix, s.dim))
        b = sobol2(s.samp, _scramble_hash(s.pix, s.dim + 1))
        rng, _ = pcg32_next_f32(s.rng)
        rng, _ = pcg32_next_f32(rng)
        return s._replace(rng=rng, dim=s.dim + 2), torch.stack([a, b], -1)
    s, a = stream_1d(s)
    s, b = stream_1d(s)
    return s, torch.stack([a, b], -1)


def stream_rng(s) -> PCG32State:
    """The raw PCG32 streams under a sampler stream (inner tracking loops
    draw from them without consuming dimensions)."""
    return s.rng if isinstance(s, SampleStream) else s


def stream_with_rng(s, rng: PCG32State):
    """The stream ``s`` with its raw PCG32 streams replaced by ``rng``."""
    return s._replace(rng=rng) if isinstance(s, SampleStream) else rng


def stream_camera_sample(s):
    """Dimensions 0-4 in GetCameraSample's order: film offset (2), time
    (1), lens (2) (samplers.py:375-431).  Returns (stream, film (R,2), time
    (R,), lens (R,2)); called first, at dimension 0."""
    if isinstance(s, SampleStream):
        spec = s.spec
        if spec.kind == "halton":
            fx = radical_inverse(0, s.idx_lo >> spec.base_exp2)
            fy = radical_inverse(1, torch.div(s.idx_lo, spec.base_scale3,
                                              rounding_mode="floor"))
            film = torch.stack([fx, fy], -1)
            s = s._replace(dim=s.dim + 2)
        elif spec.kind == "sobol":
            res = float(1 << spec.log2res)
            fx = torch.clamp(sobol_sample(s.idx_lo, 0, a_hi=s.idx_hi) * res
                             - s.px.to(torch.float32), 0.0, _ONE_MINUS_EPS)
            fy = torch.clamp(sobol_sample(s.idx_lo, 1, a_hi=s.idx_hi) * res
                             - s.py.to(torch.float32), 0.0, _ONE_MINUS_EPS)
            film = torch.stack([fx, fy], -1)
            s = s._replace(dim=s.dim + 2)
        elif spec.kind == "stratified":
            rng, u0 = pcg32_next_f32(s.rng)
            rng, u1 = pcg32_next_f32(rng)
            film = stratified_2d(s.samp, spec.spp, torch.stack([u0, u1], -1))
            s = s._replace(rng=rng, dim=s.dim + 2)
        elif spec.kind == "maxmindist":
            rot = _scramble_hash(s.pix, 0).to(torch.float32) * _TWO_M32
            film = maxmindist_2d(s.samp, max(spec.spp, 1), rot,
                                 _scramble_hash(s.pix, 1))
            s = s._replace(dim=s.dim + 2)
        else:
            s, film = stream_2d(s)
    else:
        s, film = stream_2d(s)
    s, time = stream_1d(s)
    s, lens = stream_2d(s)
    return s, film, time, lens
