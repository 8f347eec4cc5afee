"""bre_tpu_torch.core.efloat against bre_tpu.core.efloat on the CPU: the
next-float steps, every interval operation and the interval quadratic bit
for bit on normal-range inputs, and the one place they differ by design
(XLA:CPU flushes subnormals, torch keeps them)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bre_tpu.core import efloat as J
from bre_tpu_torch.core import efloat as T


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x, np.float32).view(np.uint32)


def both(*arrays):
    """The same float32 arrays as (reference EFloat args, port EFloat args)."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


def assert_same_efloat(ref, port, what):
    for name, r, p in zip(("v", "low", "high"), ref, port):
        np.testing.assert_array_equal(bits(r), bits(p), err_msg=f"{what}.{name}")


# +-0, +-inf, NaNs of both signs and payloads, the largest finite values,
# the smallest normals, and normal values; uint32 patterns past 0x7FFFFFFF
# and at 0xFFFFFFFF exercise the 32-bit wrap of the int32 view
EDGE_BITS = np.concatenate([
    np.array([0.0, -0.0, np.inf, -np.inf, 3.4028235e38, -3.4028235e38,
              1.1754944e-38, -1.1754944e-38, 1.0, -1.0, 2.5, -2.5, 1e30,
              -1e30], np.float32).view(np.uint32),
    np.array([0x7FC00000, 0xFFC00000, 0x7FFFFFFF, 0xFFFFFFFF, 0x7F800001,
              0xFF800001], np.uint32)])


@pytest.mark.parametrize("fn", ["next_float_up", "next_float_down"])
def test_next_float_bits(fn):
    """The reference's uint32 steps, through the port's int32 view: the same
    bits on every edge value and on 4,096 random normal floats."""
    rs = np.random.RandomState(1)
    normal = (rs.choice([-1.0, 1.0], 4096) * rs.uniform(1, 3, 4096)
              * 10.0 ** rs.uniform(-37, 38, 4096))
    vals = np.concatenate([EDGE_BITS.view(np.float32),
                           normal.astype(np.float32)])
    got = getattr(T, fn)(torch.from_numpy(vals))
    want = getattr(J, fn)(jnp.asarray(vals))
    np.testing.assert_array_equal(bits(got), bits(want))
    assert T.float_to_bits(torch.tensor(-0.0)).item() == -(1 << 31)
    assert bits(T.bits_to_float(torch.tensor(0x3F800000, dtype=torch.int32))
                ) == 0x3F800000


def _operands(seed, R=2048):
    rs = np.random.RandomState(seed)
    a = rs.uniform(-6, 6, R).astype(np.float32)
    b = rs.uniform(-6, 6, R).astype(np.float32)
    b[np.abs(b) < 0.05] = 0.5  # no division by an interval around 0 here
    err = (np.abs(a) * rs.uniform(0, 1e-3, R)).astype(np.float32)
    err[::7] = 0.0  # err == 0: the exact EFloat
    return a, b, err


@pytest.mark.parametrize("op", ["ef_add", "ef_sub", "ef_mul", "ef_div"])
def test_binary_ops_bits(op):
    a, b, err = _operands(2)
    (ja, je, jb), (ta, te, tb) = both(a, err, b)
    ref_a, port_a = J.efloat(ja, je), T.efloat(ta, te)
    assert_same_efloat(ref_a, port_a, "efloat")
    ref = getattr(J, op)(ref_a, J.efloat(jb))
    port = getattr(T, op)(port_a, T.efloat(tb))
    assert_same_efloat(ref, port, op)


def test_ef_div_spanning_zero():
    """A divisor interval around 0 gives (-inf, inf), as the reference."""
    (jv, je, jw), (tv, te, tw) = both(np.float32([1.0, 2.0]),
                                      np.float32([0.0, 0.0]),
                                      np.float32([0.01, 3.0]))
    ref = J.ef_div(J.efloat(jv), J.efloat(jw, jnp.float32(0.1)))
    port = T.ef_div(T.efloat(tv), T.efloat(tw, torch.tensor(0.1)))
    assert_same_efloat(ref, port, "ef_div")
    assert port.low[0] == -np.inf and port.high[0] == np.inf


@pytest.mark.parametrize("op", ["ef_sqrt", "ef_abs", "ef_neg",
                                "absolute_error"])
def test_unary_ops_bits(op):
    a, _, err = _operands(3)
    if op == "ef_sqrt":
        a = np.abs(a)  # the square root of a negative v is a NaN
    (ja, je), (ta, te) = both(a, err)
    ref = getattr(J, op)(J.efloat(ja, je))
    port = getattr(T, op)(T.efloat(ta, te))
    if op == "absolute_error":
        np.testing.assert_array_equal(bits(ref), bits(port))
    else:
        assert_same_efloat(ref, port, op)


def test_ef_quadratic_bits_and_brackets():
    """Random coefficients (about a third of the lanes without a real
    root), A with a running error: ok, t0 and t1 bit for bit.  Where ok,
    the brackets hold the float64 roots taken with the float32
    discriminant; the discriminant's own rounding is not in the interval
    (the reference computes it in float32 with no error term, where pbrt's
    C++ takes double), so the exact roots are held within the slop of
    tests/test_efloat_spectrum_tools.py's quadratic test."""
    rs = np.random.RandomState(4)
    R = 4096
    a = rs.uniform(0.25, 4, R) * rs.choice([-1, 1], R)
    b = rs.uniform(-8, 8, R)
    c = rs.uniform(-4, 4, R)
    a, b, c = (x.astype(np.float32) for x in (a, b, c))
    ea = (np.abs(a) * 1e-6).astype(np.float32)
    (ja, je, jb, jc), (ta, te, tb, tc) = both(a, ea, b, c)
    ok_r, t0_r, t1_r = J.ef_quadratic(J.efloat(ja, je), J.efloat(jb),
                                      J.efloat(jc))
    ok_p, t0_p, t1_p = T.ef_quadratic(T.efloat(ta, te), T.efloat(tb),
                                      T.efloat(tc))
    np.testing.assert_array_equal(np.asarray(ok_r), ok_p.numpy())
    assert_same_efloat(t0_r, t0_p, "t0")
    assert_same_efloat(t1_r, t1_p, "t1")
    ok = ok_p.numpy()
    assert 0.2 < ok.mean() < 0.9
    assert (t0_p.v <= t1_p.v).all()
    disc32 = (b * b - np.float32(4.0) * a * c)[ok]
    a64, b64, c64 = (x.astype(np.float64)[ok] for x in (a, b, c))
    for disc, slop in ((disc32.astype(np.float64), 0.0),
                       (b64 * b64 - 4 * a64 * c64, 1e-3)):
        q = -0.5 * (b64 + np.copysign(np.sqrt(disc), b64))
        roots = np.sort(np.stack([q / a64, c64 / q]), 0)
        for r, t in zip(roots, (t0_p, t1_p)):
            lo, hi = (x.numpy()[ok].astype(np.float64)
                      for x in (t.low, t.high))
            s = slop * (1 + np.abs(r))
            assert ((lo - s <= r) & (r <= hi + s)).all()


def test_subnormal_flush_differs_from_reference():
    """XLA:CPU flushes subnormal operands and results to zero; torch keeps
    IEEE subnormals, as pbrt's C++ EFloat and the card do.  So
    ef_add(1e-40, 1e-40) is 2e-40 in the port and 0.0 in the reference
    (ROADMAP Queue 3), and the next float above 1e-40 is one ulp above it
    in the port and the smallest subnormal in the reference (which reads
    1e-40 == 0.0 as true).  next_float_up(0.0) is a bit step, not
    arithmetic, and agrees."""
    x32 = np.float32(1e-40)
    port = T.ef_add(T.efloat(torch.tensor(x32)), T.efloat(torch.tensor(x32)))
    ref = J.ef_add(J.efloat(jnp.float32(x32)), J.efloat(jnp.float32(x32)))
    assert bits(port.v) == 2 * bits(x32)
    assert float(ref.v) == 0.0
    up_p = T.next_float_up(torch.tensor(x32))
    up_r = J.next_float_up(jnp.float32(x32))
    assert bits(up_p) == bits(x32) + 1
    assert bits(up_r) == 1
    zero = np.float32(0.0)
    assert bits(T.next_float_up(torch.tensor(zero))) == bits(
        J.next_float_up(jnp.float32(zero))) == 1
