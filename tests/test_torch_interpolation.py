"""bre_tpu_torch.core.interpolation against bre_tpu.core.interpolation on
the same numpy inputs from a seed: FindInterval, the Catmull-Rom weights
(shared and per-lane nodes), the spline gather, IntegrateCatmullRom,
InvertCatmullRom, SampleCatmullRom2D (one table and stacked tables), and
the Fourier series' evaluation and sampling.

Tolerances: indices and validity flags exactly; floats rtol 1e-5 / atol
1e-6, where XLA:CPU's contracted multiply-adds and its cos differ from
torch's in the last bits (ROADMAP Queue 3).  The fixed 32-step
Newton-bisections converge to the same root, so their outputs are held
to the same bound, widened to 2e-5 where a sample inverts a CDF (its
conditioning is 1 / pdf) and for phi, an angle in [0, 2 pi)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bre_tpu.core import interpolation as ji
from bre_tpu_torch.core import interpolation as ti
from torch_parity import to_np

RTOL, ATOL = 1e-5, 1e-6
R = 4096


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=rtol, atol=atol)


def _nodes(rs, n):
    x = np.cumsum(rs.uniform(0.05, 1.0, n)).astype(np.float32)
    return x - x[0]


def test_find_interval_and_weights_match_jax():
    rs = np.random.RandomState(0)
    nodes = _nodes(rs, 17)
    x = rs.uniform(-0.5, nodes[-1] + 0.5, R).astype(np.float32)
    x[:17] = nodes  # on the nodes themselves
    T = torch.from_numpy
    np.testing.assert_array_equal(
        to_np(ti.find_interval(T(nodes), T(x))),
        np.asarray(ji.find_interval(jnp.asarray(nodes), jnp.asarray(x))))
    off, w, ok = ti.catmull_rom_weights(T(nodes), T(x))
    joff, jw, jok = ji.catmull_rom_weights(jnp.asarray(nodes), jnp.asarray(x))
    np.testing.assert_array_equal(to_np(off), np.asarray(joff))
    np.testing.assert_array_equal(to_np(ok), np.asarray(jok))
    _close(w, jw)
    vals = rs.normal(size=17).astype(np.float32)
    _close(ti.spline_gather_1d(T(vals), off, w),
           ji.spline_gather_1d(jnp.asarray(vals), joff, jw))
    # per-lane nodes (the BSSRDF's and the Fourier tables' rows)
    rows = np.stack([_nodes(rs, 9) for _ in range(R)])
    xr = rs.uniform(-0.1, 1.1, R).astype(np.float32) * rows[:, -1]
    off, w, ok = ti.catmull_rom_weights(T(rows), T(xr))
    joff, jw, jok = ji.catmull_rom_weights(jnp.asarray(rows), jnp.asarray(xr))
    np.testing.assert_array_equal(to_np(off), np.asarray(joff))
    np.testing.assert_array_equal(to_np(ok), np.asarray(jok))
    _close(w, jw)
    vr = rs.normal(size=(R, 9)).astype(np.float32)
    _close(ti.spline_gather_1d(T(vr), off, w),
           ji.spline_gather_1d(jnp.asarray(vr), joff, jw))


def test_integrate_and_invert_match_jax():
    rs = np.random.RandomState(1)
    x = _nodes(rs, 20)
    v = rs.uniform(0.1, 2.0, (3, 20)).astype(np.float32)
    T = torch.from_numpy
    cdf, tot = ti.integrate_catmull_rom(T(x), T(v))
    jcdf, jtot = ji.integrate_catmull_rom(jnp.asarray(x), jnp.asarray(v))
    _close(cdf, jcdf)
    _close(tot, jtot)
    mono = np.asarray(jcdf)[0].astype(np.float32)
    u = rs.uniform(-0.2, 1.2, R).astype(np.float32) * mono[-1]
    _close(ti.invert_catmull_rom(T(x), T(mono), T(u)),
           ji.invert_catmull_rom(jnp.asarray(x), jnp.asarray(mono),
                                 jnp.asarray(u)), rtol=2e-5)


@pytest.mark.parametrize("stacked", [False, True])
def test_sample_catmull_rom_2d_matches_jax(stacked):
    rs = np.random.RandomState(2 + stacked)
    n1, n2, nt = 12, 16, 3
    nodes1 = _nodes(rs, n1)
    nodes2 = _nodes(rs, n2)
    vals = rs.uniform(0.05, 1.0, (nt, n1, n2)).astype(np.float32)
    cdf = np.asarray(ji.integrate_catmull_rom(jnp.asarray(nodes2),
                                              jnp.asarray(vals))[0])
    alpha = rs.uniform(-0.1, 1.05, R).astype(np.float32) * nodes1[-1]
    u = rs.uniform(0, 1, R).astype(np.float32)
    T = torch.from_numpy
    if stacked:
        tidx = rs.randint(0, nt, R)
        rows1 = np.repeat(nodes1[None], R, 0)
        got = ti.sample_catmull_rom_2d(T(rows1), T(nodes2), T(vals), T(cdf),
                                       T(alpha), T(u), table_idx=T(tidx))
        want = ji.sample_catmull_rom_2d(
            jnp.asarray(rows1), jnp.asarray(nodes2), jnp.asarray(vals),
            jnp.asarray(cdf), jnp.asarray(alpha), jnp.asarray(u),
            table_idx=jnp.asarray(tidx))
    else:
        got = ti.sample_catmull_rom_2d(T(nodes1), T(nodes2), T(vals[0]),
                                       T(cdf[0]), T(alpha), T(u))
        want = ji.sample_catmull_rom_2d(
            jnp.asarray(nodes1), jnp.asarray(nodes2), jnp.asarray(vals[0]),
            jnp.asarray(cdf[0]), jnp.asarray(alpha), jnp.asarray(u))
    for a, b in zip(got, want):
        _close(a, b, rtol=2e-5, atol=2e-5)
    assert float(got[2].max()) > 0


def test_fourier_eval_and_sample_match_jax():
    rs = np.random.RandomState(4)
    M = 9
    ak = (rs.normal(size=(R, M)) / (1.0 + np.arange(M)) ** 2).astype(
        np.float32)
    ak[:, 0] = np.abs(ak[:, 0]) + 1.5  # a positive series
    mask = (np.arange(M)[None] < rs.randint(1, M + 1, (R, 1))).astype(
        np.float32)
    cp = rs.uniform(-1, 1, R).astype(np.float32)
    u = rs.uniform(0, 1, R).astype(np.float32)
    T = torch.from_numpy
    _close(ti.fourier_eval(T(ak), T(mask), T(cp)),
           ji.fourier_eval(jnp.asarray(ak), jnp.asarray(mask),
                           jnp.asarray(cp)), atol=5e-6)
    got = ti.sample_fourier(T(ak), T(mask), T(u))
    want = ji.sample_fourier(jnp.asarray(ak), jnp.asarray(mask),
                             jnp.asarray(u))
    for a, b in zip(got, want):
        _close(a, b, rtol=2e-5, atol=2e-5)
