"""PCG32 random number generator, bit-exact with pbrt's ``RNG`` and with
``bre_tpu/core/rng.py`` (pbrt rng.h:61-150).

The 64-bit state lives in ONE int64 tensor holding the uint64 bit pattern.
Multiplication and addition wrap modulo 2^64 in two's complement, which is
the unsigned arithmetic pbrt does; every right shift is masked so it stays
logical (an arithmetic shift would smear the sign bit into the output).  The
JAX reference splits the state into uint32 pairs instead because JAX has no
uint64 without x64 mode; the bit streams are identical.

A batch of N independent streams is ``pcg32_init(seq)`` on an (N,) tensor of
sequence indices < 2^32, exactly as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

__all__ = ["PCG32State", "pcg32_init", "pcg32_next_u32", "pcg32_next_f32",
           "pcg32_advance", "ONE_MINUS_EPSILON"]


def _as_i64(v: int) -> int:
    """uint64 constant -> the int64 with the same bit pattern."""
    return v - (1 << 64) if v >= (1 << 63) else v


_PCG32_DEFAULT_STATE = _as_i64(0x853C49E6748FEA9B)  # pbrt rng.h:61-63
_PCG32_MULT = _as_i64(0x5851F42D4C957F2D)
_MASK32 = 0xFFFFFFFF

# Largest float32 < 1.0 (pbrt rng.h:48-53 FloatOneMinusEpsilon).
ONE_MINUS_EPSILON = 1.0 - 2.0 ** -24
_TWO_M32 = 2.3283064365386963e-10  # 2^-32, exact in float32


class PCG32State(NamedTuple):
    """A batch of PCG32 streams: uint64 bit patterns in int64 tensors."""

    state: torch.Tensor
    inc: torch.Tensor


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of the uint64 bit pattern held in int64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _pcg32_step(s: PCG32State) -> Tuple[PCG32State, torch.Tensor]:
    """One LCG step; returns (new_state, output u32 as int64). rng.h:138-144."""
    old = s.state
    new = old * _PCG32_MULT + s.inc  # wraps mod 2^64
    xorshifted = ((_shr(old, 18) ^ old) >> 27) & _MASK32
    rot = _shr(old, 59)
    out = ((xorshifted >> rot) | (xorshifted << ((-rot) & 31))) & _MASK32
    return PCG32State(new, s.inc), out


def pcg32_init(seq: torch.Tensor) -> PCG32State:
    """``RNG(sequenceIndex)`` / ``SetSequence`` (rng.h:130-136) for sequence
    indices < 2^32 (any integer tensor; values are taken modulo 2^32)."""
    seq = seq.to(torch.int64) & _MASK32
    inc = (seq << 1) | 1
    s = PCG32State(torch.zeros_like(seq), inc)
    s, _ = _pcg32_step(s)
    s = PCG32State(s.state + _PCG32_DEFAULT_STATE, s.inc)
    s, _ = _pcg32_step(s)
    return s


def pcg32_next_u32(s: PCG32State) -> Tuple[PCG32State, torch.Tensor]:
    """Draw the next uint32 (as int64) from each stream."""
    return _pcg32_step(s)


def pcg32_next_f32(s: PCG32State) -> Tuple[PCG32State, torch.Tensor]:
    """``UniformFloat`` = min(OneMinusEpsilon, u32 * 2^-32) (rng.h:78-84):
    the u32 rounds to float32 first, then the exact power-of-two scale."""
    s, u = _pcg32_step(s)
    f = u.to(torch.float32) * _TWO_M32
    return s, torch.clamp_max(f, ONE_MINUS_EPSILON)


def pcg32_advance(s: PCG32State, delta: int) -> PCG32State:
    """Every stream moved on by ``delta`` draws at once (pbrt rng.h
    ``Advance``): state' = M^delta state + inc (M^delta - 1)/(M - 1) mod
    2^64.  The two factors do not depend on the stream, so they are
    computed once on the host, the second by pbrt's square-and-multiply
    with a unit increment (the result is linear in inc)."""
    delta = int(delta)
    if delta <= 0:
        return s
    mult, plus = 1, 0
    cur_mult, cur_plus = _PCG32_MULT % (1 << 64), 1
    while delta > 0:
        if delta & 1:
            mult = (mult * cur_mult) % (1 << 64)
            plus = (plus * cur_mult + cur_plus) % (1 << 64)
        cur_plus = ((cur_mult + 1) * cur_plus) % (1 << 64)
        cur_mult = (cur_mult * cur_mult) % (1 << 64)
        delta >>= 1
    return PCG32State(s.state * _as_i64(mult) + s.inc * _as_i64(plus), s.inc)
