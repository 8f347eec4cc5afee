"""Radical inverses, bit for bit with pbrt and ``bre_tpu/core/lowdiscrepancy.py``
(pbrt lowdiscrepancy.{h,cpp}: RadicalInverse, ScrambledRadicalInverse,
InverseRadicalInverse, ComputeRadicalInversePermutations).

uint32 indices live in int64 tensors (values in [0, 2^32)).  The reversed
digits of an index below 2^32 stay below base * 2^32 < 2^45, so they are
accumulated exactly in int64 and converted to float as the reference does,
in two roundings: float(hi) * 2^32 + float(lo).  A base index may be a
per-lane tensor (a 32-trip masked digit loop, as the reference's) or a
Python int shared by the batch (the digit count of that base: the trips
past it are no-ops in the reference's loop, so the values are the same).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from .rng import ONE_MINUS_EPSILON

__all__ = ["PRIMES", "PRIME_SUMS", "N_SCRAMBLE_DIMS", "reverse_bits_32",
           "radical_inverse", "radical_inverse_dynamic",
           "radical_inverse_permutations", "scrambled_radical_inverse_dynamic",
           "inverse_radical_inverse"]

_MASK32 = 0xFFFFFFFF
_TWO_32 = 4294967296.0


def _sieve_primes(n: int) -> np.ndarray:
    """The first n primes (pbrt's Primes table)."""
    limit = 8000  # > the 1000th prime (7919)
    is_p = np.ones(limit, dtype=bool)
    is_p[:2] = False
    for i in range(2, int(limit ** 0.5) + 1):
        if is_p[i]:
            is_p[i * i::i] = False
    return np.nonzero(is_p)[0][:n].astype(np.int64)


PRIMES = _sieve_primes(1000)
PRIME_SUMS = np.concatenate([[0], np.cumsum(PRIMES)[:-1]])

# digit permutations exist for the first N_SCRAMBLE_DIMS primes; the
# Halton sampler's later dimensions take the PCG32 stream
N_SCRAMBLE_DIMS = 128


def _u32(a) -> torch.Tensor:
    return torch.as_tensor(a).to(torch.int64) & _MASK32


def reverse_bits_32(a: torch.Tensor) -> torch.Tensor:
    """ReverseBits32 (lowdiscrepancy.h:80-88) on uint32 values."""
    a = _u32(a)
    a = ((a << 16) | (a >> 16)) & _MASK32
    a = ((a & 0x00FF00FF) << 8) | ((a & 0xFF00FF00) >> 8)
    a = ((a & 0x0F0F0F0F) << 4) | ((a & 0xF0F0F0F0) >> 4)
    a = ((a & 0x33333333) << 2) | ((a & 0xCCCCCCCC) >> 2)
    a = ((a & 0x55555555) << 1) | ((a & 0xAAAAAAAA) >> 1)
    return a


def _ndigits(base: int) -> int:
    """The smallest k with base^k >= 2^32: digits of any uint32."""
    k = 1
    while base ** k < 2 ** 32:
        k += 1
    return k


def _to_f32(rd: torch.Tensor) -> torch.Tensor:
    """The reversed digits (< 2^45) as float32: hi * 2^32 + lo, each half
    rounded on its own, as the reference's two uint32 limbs."""
    return ((rd >> 32).to(torch.float32) * _TWO_32
            + (rd & _MASK32).to(torch.float32))


def _digit_loop(a, base, inv_base, trips, perm=None):
    """(reversed digits int64, inv_base^n float32) of ``a``: ``trips``
    masked trips of rd = rd * base + digit (a permuted digit when ``perm``
    is given), stopping where the index reaches 0."""
    rd = torch.zeros_like(a)
    inv_base_n = torch.ones(a.shape, dtype=torch.float32, device=a.device)
    cur = a
    for _ in range(trips):
        nxt = torch.div(cur, base, rounding_mode="floor")
        digit = cur - nxt * base
        if perm is not None:
            digit = perm(digit)
        live = cur > 0
        rd = torch.where(live, rd * base + digit, rd)
        inv_base_n = torch.where(live, inv_base_n * inv_base, inv_base_n)
        cur = nxt
    return rd, inv_base_n


def radical_inverse(base_index: int, a: torch.Tensor) -> torch.Tensor:
    """RadicalInverse(baseIndex, a) for uint32 ``a`` (lowdiscrepancy.cpp:437+;
    lowdiscrepancy.py:69-135): base 2 by bit reversal, the other bases with
    1/base rounded from double."""
    a = _u32(a)
    if base_index == 0:
        rev = reverse_bits_32(a)
        val = ((rev >> 16).to(torch.float32) * 2.0 ** -16
               + (rev & 0xFFFF).to(torch.float32) * 2.0 ** -32)
        return torch.clamp_max(val, ONE_MINUS_EPSILON)
    base = int(PRIMES[base_index])
    inv_base = float(np.float32(1.0 / base))
    rd, inv_base_n = _digit_loop(a, base, inv_base, _ndigits(base))
    return torch.clamp_max(_to_f32(rd) * inv_base_n, ONE_MINUS_EPSILON)


def _f32_recip(base: int) -> float:
    """1 / base in float32 arithmetic (the reference's 1.0 / float(base))."""
    return float(np.float32(1.0) / np.float32(base))


def radical_inverse_dynamic(base_index: Union[int, torch.Tensor],
                            a: torch.Tensor) -> torch.Tensor:
    """RadicalInverse with a per-lane (tensor) or batch-wide (int) base
    index in [0, 999] (lowdiscrepancy.py:247-281): the generic digit loop
    for every base, 2 included, with 1/base in float32."""
    a = _u32(a)
    if isinstance(base_index, int):
        base = int(PRIMES[min(max(base_index, 0), 999)])
        rd, inv_base_n = _digit_loop(a, base, _f32_recip(base), _ndigits(base))
    else:
        primes = torch.as_tensor(PRIMES, device=a.device)
        base = primes[torch.clamp(base_index.to(torch.int64), 0, 999)]
        inv_base = 1.0 / base.to(torch.float32)
        rd, inv_base_n = _digit_loop(a, base, inv_base, 32)
    return torch.clamp_max(_to_f32(rd) * inv_base_n, ONE_MINUS_EPSILON)


def _pcg32_host_default():
    """pbrt's scalar RNG() with its default state and stream (rng.h:61-63),
    as UniformUInt32(bound); only for the digit permutations."""
    state = 0x853C49E6748FEA9B
    inc = 0xDA3E39CB94B95BDB
    mult = 0x5851F42D4C957F2D
    m64 = (1 << 64) - 1

    def next_u32():
        nonlocal state
        old = state
        state = (old * mult + inc) & m64
        xorshifted = (((old >> 18) ^ old) >> 27) & 0xFFFFFFFF
        rot = old >> 59
        return ((xorshifted >> rot) | (xorshifted << ((-rot) & 31))) & 0xFFFFFFFF

    def uniform_u32_bounded(b):
        threshold = ((1 << 32) - b) % b
        while True:
            r = next_u32()
            if r >= threshold:
                return r % b

    return uniform_u32_bounded


_PERM_CACHE = {}


def radical_inverse_permutations(n_dims: int = N_SCRAMBLE_DIMS):
    """The first ``n_dims`` primes' digit permutations, as pbrt's
    ComputeRadicalInversePermutations(RNG()) (lowdiscrepancy.cpp:2500-2514
    with Shuffle): (flat uint16 permutations, int32 offsets), numpy."""
    if n_dims in _PERM_CACHE:
        return _PERM_CACHE[n_dims]
    draw = _pcg32_host_default()
    flat = []
    offsets = np.zeros(n_dims, np.int32)
    off = 0
    for i in range(n_dims):
        p = int(PRIMES[i])
        perm = list(range(p))
        for j in range(p):  # Shuffle: other = j + UniformUInt32(p - j)
            other = j + draw(p - j)
            perm[j], perm[other] = perm[other], perm[j]
        offsets[i] = off
        flat.extend(perm)
        off += p
    out = (np.asarray(flat, np.uint16), offsets)
    _PERM_CACHE[n_dims] = out
    return out


def scrambled_radical_inverse_dynamic(base_index: Union[int, torch.Tensor],
                                      a: torch.Tensor) -> torch.Tensor:
    """ScrambledRadicalInverse (lowdiscrepancy.cpp:417-435; lowdiscrepancy.py
    :197-233) for a base index below N_SCRAMBLE_DIMS, per lane (tensor) or
    batch-wide (int): permuted digits plus the tail perm[0] * invBase /
    (1 - invBase)."""
    a = _u32(a)
    perm_flat, offsets = radical_inverse_permutations()
    permt = torch.as_tensor(perm_flat.astype(np.int64), device=a.device)
    if isinstance(base_index, int):
        bi = min(max(base_index, 0), N_SCRAMBLE_DIMS - 1)
        base = int(PRIMES[bi])
        off = int(offsets[bi])
        table = permt[off:off + base]
        inv_base = _f32_recip(base)
        rd, inv_base_n = _digit_loop(a, base, inv_base, _ndigits(base),
                                     perm=lambda dg: table[dg])
        inv_t = torch.tensor(inv_base, dtype=torch.float32, device=a.device)
        perm0 = float(table[0])
    else:
        bi = torch.clamp(base_index.to(torch.int64), 0, N_SCRAMBLE_DIMS - 1)
        base = torch.as_tensor(PRIMES, device=a.device)[bi]
        off = torch.as_tensor(offsets.astype(np.int64), device=a.device)[bi]
        inv_t = 1.0 / base.to(torch.float32)
        rd, inv_base_n = _digit_loop(a, base, inv_t, 32,
                                     perm=lambda dg: permt[off + dg])
        perm0 = permt[off].to(torch.float32)
    tail = inv_t * perm0 / (1.0 - inv_t)
    return torch.clamp_max(inv_base_n * (_to_f32(rd) + tail), ONE_MINUS_EPSILON)


def inverse_radical_inverse(base: int, inverse: torch.Tensor,
                            n_digits: int) -> torch.Tensor:
    """InverseRadicalInverse<base> (lowdiscrepancy.h:~95): the ``n_digits``
    base-``base`` digits of ``inverse`` reversed, modulo 2^32."""
    inverse = _u32(inverse)
    index = torch.zeros_like(inverse)
    for _ in range(n_digits):
        digit = inverse % base
        inverse = torch.div(inverse, base, rounding_mode="floor")
        index = (index * base + digit) & _MASK32
    return index
