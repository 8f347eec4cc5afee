"""Sobol' samples from the reference's direction matrices, bit for bit with
pbrt and ``bre_tpu/core/sobol.py`` (pbrt lowdiscrepancy.h:230-276:
SobolIntervalToIndex, SobolSample, SobolSampleFloat; sobolmatrices.cpp).

The tables are data, the port's own copy in ``core/data/sobol_tables.npz``:
``sobol32`` (1024, 52) uint32 direction vectors and ``vdc`` / ``vdc_inv``
(25/26, 52) uint64 van der Corput matrices.  A missing file raises: there
is no generated stand-in.  Sample indices up to 52 bits are carried as
(hi, lo) uint32 pairs in int64 tensors, as the reference carries them.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

N_SOBOL_DIMS = 1024
SOBOL_MATRIX_SIZE = 52  # sobolmatrices.h:48
_SOBOL_BITS = 32
_MASK32 = 0xFFFFFFFF
ONE_MINUS_EPS = 0.99999994  # float32 1 - 2^-24
TABLES = Path(__file__).parent / "data" / "sobol_tables.npz"

_TABLES = None


def sobol_tables():
    """(sobol32 (1024, 52) int64, vdc (25, 52), vdc_inv (26, 52) uint64)
    numpy arrays from the port's table file; raises if it is missing."""
    global _TABLES
    if _TABLES is None:
        with np.load(TABLES) as z:
            _TABLES = (z["sobol32"].astype(np.int64), z["vdc"], z["vdc_inv"])
    return _TABLES


def _bits_xor(a, cols, n_bits, shift0=0):
    """XOR of cols[k] over the set bits k of a (k < n_bits); cols (n_bits,)
    int64 values or (n_bits, ...) per-lane tensors."""
    v = torch.zeros_like(a)
    for k in range(n_bits):
        bit = ((a >> k) & 1).bool()
        v = v ^ torch.where(bit, cols[shift0 + k], torch.zeros_like(v))
    return v


def sobol_sample_u32(a: torch.Tensor, dim, scramble=0,
                     a_hi=None) -> torch.Tensor:
    """SobolSample (lowdiscrepancy.h:261-276): the XOR of the direction
    vectors of ``dim`` selected by the set bits of the index (low bits
    ``a``, optional high bits 32..51 ``a_hi``), XOR ``scramble``.  ``dim``
    is an int or a per-lane tensor.  Returns uint32 bits in int64."""
    a = torch.as_tensor(a).to(torch.int64) & _MASK32
    mats = torch.as_tensor(sobol_tables()[0], device=a.device)
    n_hi = SOBOL_MATRIX_SIZE - _SOBOL_BITS if a_hi is not None else 0
    if isinstance(dim, (int, np.integer)):
        cols = mats[int(dim)]
    else:
        cols = mats[dim.to(torch.int64)].T  # (52, lanes)
    v = _bits_xor(a, cols, _SOBOL_BITS)
    if n_hi:
        v = v ^ _bits_xor(a_hi.to(torch.int64) & _MASK32, cols, n_hi,
                          shift0=_SOBOL_BITS)
    return v ^ (torch.as_tensor(scramble, device=a.device).to(torch.int64)
                & _MASK32)


def sobol_sample(a: torch.Tensor, dim, scramble=0, a_hi=None) -> torch.Tensor:
    """SobolSampleFloat: the uint32 bits times 2^-32, below 1."""
    bits = sobol_sample_u32(a, dim, scramble, a_hi)
    return torch.clamp_max(bits.to(torch.float32) * 2.3283064365386963e-10,
                           ONE_MINUS_EPS)


def _split64(tbl: np.ndarray):
    """uint64 table -> (lo, hi) int64 arrays of its uint32 halves."""
    return ((tbl & np.uint64(_MASK32)).astype(np.int64),
            (tbl >> np.uint64(32)).astype(np.int64))


def sobol_interval_to_index(m: int, frame, px, py):
    """SobolIntervalToIndex (lowdiscrepancy.h:230-250; sobol.py:201-249):
    the global index of sample ``frame`` of pixel (px, py) in a 2^m x 2^m
    frame.  Returns (hi, lo) uint32 halves in int64."""
    frame = torch.as_tensor(frame).to(torch.int64) & _MASK32
    px = torch.as_tensor(px).to(torch.int64) & _MASK32
    py = torch.as_tensor(py).to(torch.int64) & _MASK32
    shape = torch.broadcast_shapes(frame.shape, px.shape, py.shape)
    frame, px, py = (t.expand(shape) for t in (frame, px, py))
    if m == 0:
        z = torch.zeros(shape, dtype=torch.int64, device=frame.device)
        return z, z.clone()
    _, vdc, vdc_inv = sobol_tables()
    m2 = 2 * m  # m <= 25, so 2m <= 50 < 64
    if m2 < 32:
        lo = (frame << m2) & _MASK32
        hi = frame >> (32 - m2)
    else:
        lo = torch.zeros_like(frame)
        hi = (frame << (m2 - 32)) & _MASK32
    dev = frame.device
    vdc_lo, vdc_hi = (torch.as_tensor(x, device=dev) for x in _split64(vdc[m - 1]))
    inv_lo, inv_hi = (torch.as_tensor(x, device=dev)
                      for x in _split64(vdc_inv[m - 1]))
    d_lo = _bits_xor(frame, vdc_lo, _SOBOL_BITS)
    d_hi = _bits_xor(frame, vdc_hi, _SOBOL_BITS)
    b_lo = (((px << m) & _MASK32) | py) ^ d_lo
    b_hi = (px >> (32 - m)) ^ d_hi
    n_lo = min(m2, _SOBOL_BITS)
    lo = lo ^ _bits_xor(b_lo, inv_lo, n_lo)
    hi = hi ^ _bits_xor(b_lo, inv_hi, n_lo)
    n_hi = max(m2 - _SOBOL_BITS, 0)
    if n_hi:
        lo = lo ^ _bits_xor(b_hi, inv_lo, n_hi, shift0=_SOBOL_BITS)
        hi = hi ^ _bits_xor(b_hi, inv_hi, n_hi, shift0=_SOBOL_BITS)
    return hi, lo
