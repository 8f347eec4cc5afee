"""EFloat: float32 running-error interval arithmetic, the same operations as
``bre_tpu/core/efloat.py``.

pbrt's ``EFloat`` (efloat.h:48-214) carries an interval [low, high] that
holds the infinitely precise value; ``NextFloatUp/NextFloatDown``
(pbrt.h:~380-410) step one ulp by bit manipulation; the interval
``Quadratic`` (efloat.h:266-302) brackets the roots.  A batch is a NamedTuple
of three float32 tensors of any one shape (v, low, high); every operation
works element by element on that shape.

torch has almost no uint32 arithmetic, so the next-float steps go through an
int32 view of the bits: the sign is ``bits < 0``, and the +-1 step is taken
in int64 and wrapped back to 32 bits, which gives the bits the reference's
uint32 arithmetic gives for every input (+-0, +-inf, NaN, the largest finite
values, subnormals).  Subnormals are kept as IEEE arithmetic gives them, as
in pbrt's C++ and on the card; XLA's CPU backend flushes them to zero, so
the reference differs wherever an operand or a result is subnormal.  Every
square root is the correctly rounded one, as the reference's and the
card's, so the CPU and the card give the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["EFloat", "float_to_bits", "bits_to_float", "next_float_up",
           "next_float_down", "efloat", "ef_add", "ef_sub", "ef_mul",
           "ef_div", "ef_sqrt", "ef_abs", "ef_neg", "absolute_error",
           "ef_quadratic"]

_SIGN = -(1 << 31)  # 0x80000000 as an int32


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as the reference's and the
    card's: taken in float64 and rounded once.  torch's own float32 sqrt on
    the CPU is one ulp off in about 0.7% of lanes."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def float_to_bits(f) -> torch.Tensor:
    """FloatToBits (pbrt.h): the IEEE bit pattern, as int32 (the reference's
    uint32 bits, read as two's complement)."""
    return _f32(f).view(torch.int32)


def bits_to_float(b) -> torch.Tensor:
    return torch.as_tensor(b, dtype=torch.int32).view(torch.float32)


def _step(bits: torch.Tensor, toward_up_if_positive: bool) -> torch.Tensor:
    """bits + 1 where the sign bit is clear and bits - 1 where it is set
    (or the other way round), modulo 2^32 as the reference's uint32."""
    b = bits.to(torch.int64)
    d = 1 if toward_up_if_positive else -1
    return torch.where(bits >= 0, b + d, b - d).to(torch.int32)


def next_float_up(v) -> torch.Tensor:
    """NextFloatUp (pbrt.h): the smallest float32 > v (+inf and NaN kept)."""
    v = _f32(v)
    bits = float_to_bits(v)
    bits = torch.where(v == 0.0, torch.zeros_like(bits), bits)  # -0 -> +0
    out = bits_to_float(_step(bits, True))
    return torch.where(torch.isinf(v) & (v > 0), v, out)


def next_float_down(v) -> torch.Tensor:
    """NextFloatDown (pbrt.h): the largest float32 < v."""
    v = _f32(v)
    bits = float_to_bits(v)
    bits = torch.where(v == 0.0, torch.full_like(bits, _SIGN), bits)
    out = bits_to_float(_step(bits, False))
    return torch.where(torch.isinf(v) & (v < 0), v, out)


class EFloat(NamedTuple):
    v: torch.Tensor
    low: torch.Tensor
    high: torch.Tensor


def efloat(v, err=None) -> EFloat:
    """EFloat(v, err) (efloat.h:52-66)."""
    v = _f32(v)
    if err is None:
        return EFloat(v, v, v)
    err = _f32(err).to(v.device)
    lo = torch.where(err == 0, v, next_float_down(v - err))
    hi = torch.where(err == 0, v, next_float_up(v + err))
    return EFloat(v, lo, hi)


def ef_add(a: EFloat, b: EFloat) -> EFloat:
    return EFloat(a.v + b.v,
                  next_float_down(a.low + b.low),
                  next_float_up(a.high + b.high))


def ef_sub(a: EFloat, b: EFloat) -> EFloat:
    return EFloat(a.v - b.v,
                  next_float_down(a.low - b.high),
                  next_float_up(a.high - b.low))


def ef_mul(a: EFloat, b: EFloat) -> EFloat:
    p = torch.stack([a.low * b.low, a.high * b.low,
                     a.low * b.high, a.high * b.high])
    return EFloat(a.v * b.v,
                  next_float_down(p.amin(0)),
                  next_float_up(p.amax(0)))


def ef_div(a: EFloat, b: EFloat) -> EFloat:
    spans_zero = (b.low < 0) & (b.high > 0)
    d = torch.stack([a.low / b.low, a.high / b.low,
                     a.low / b.high, a.high / b.high])
    lo = torch.where(spans_zero, -torch.inf, next_float_down(d.amin(0)))
    hi = torch.where(spans_zero, torch.inf, next_float_up(d.amax(0)))
    return EFloat(a.v / b.v, lo, hi)


def ef_sqrt(a: EFloat) -> EFloat:
    return EFloat(_sqrt(a.v),
                  next_float_down(_sqrt(torch.clamp_min(a.low, 0.0))),
                  next_float_up(_sqrt(torch.clamp_min(a.high, 0.0))))


def ef_abs(a: EFloat) -> EFloat:
    all_pos = a.low >= 0
    all_neg = a.high <= 0
    zero = torch.zeros_like(a.v)
    lo = torch.where(all_pos, a.low, torch.where(all_neg, -a.high, zero))
    hi = torch.where(all_pos, a.high, torch.where(
        all_neg, -a.low, torch.maximum(-a.low, a.high)))
    return EFloat(torch.abs(a.v), lo, hi)


def ef_neg(a: EFloat) -> EFloat:
    return EFloat(-a.v, -a.high, -a.low)


def absolute_error(a: EFloat) -> torch.Tensor:
    """EFloat::GetAbsoluteError (efloat.h:~105)."""
    return next_float_up(torch.maximum(torch.abs(a.high - a.v),
                                       torch.abs(a.v - a.low)))


def _select(c: torch.Tensor, a: EFloat, b: EFloat) -> EFloat:
    return EFloat(*(torch.where(c, x, y) for x, y in zip(a, b)))


def ef_quadratic(A: EFloat, B: EFloat, C: EFloat):
    """Interval Quadratic (efloat.h:267-302): solve A t^2 + B t + C = 0 with
    the numerically stable +-q formulation.

    The discriminant is computed in float32, as the reference's code does
    (its docstring says f64; pbrt's C++ takes double).  Returns (ok bool,
    t0 EFloat, t1 EFloat) with t0.v <= t1.v.
    """
    disc = B.v * B.v - 4.0 * A.v * C.v
    ok = disc >= 0.0
    root = _sqrt(torch.clamp_min(disc, 0.0))
    root_e = efloat(root, 5.9604645e-08 * root)  # MachineEpsilon * root
    b_pm = _select(B.v < 0, ef_sub(B, root_e), ef_add(B, root_e))
    q = ef_mul(efloat(torch.full_like(B.v, -0.5)), b_pm)
    t0 = ef_div(q, A)
    t1 = ef_div(C, q)
    swap = t0.v > t1.v
    return ok, _select(swap, t1, t0), _select(swap, t0, t1)
