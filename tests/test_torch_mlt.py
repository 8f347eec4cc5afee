"""The building blocks of Metropolis light transport in bre_tpu_torch
against bre_tpu, on the CPU: the regenerated bootstrap rows and the chain
picks (exact), ``_erf_inv``, and one ``_evaluate`` of 64 chains at
maxdepth 2 on the fog shell lit by a sphere light (tests/test_bdpt.py:
75-101).  The whole render is tests/test_torch_mlt_render.py.

Tolerances and their reasons:
- ``_regen_u``, the chain picks: exact.  The port adds the bootstrap CDF
  in index order on the host; bre_tpu's XLA cumsum rounds differently
  in the last bits, which would flip a pick only for a uniform within an
  ulp of a CDF entry.
- ``_erf_inv``: within 4 ulps (2 measured): the float32 log and sqrt of
  XLA:CPU and torch differ by an ulp.
- ``_evaluate``: L and p_raster rtol 1e-3, atol 1e-5 x the largest value,
  as the strategies in tests/test_torch_bdpt.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from bre_tpu.core import rng as jrng
from bre_tpu.integrators import mlt as jm
from bre_tpu.lights import light_choice_pmf as j_pmf
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu_torch.core import rng as trng
from bre_tpu_torch.integrators import mlt as tm
from bre_tpu_torch.lights import light_choice_pmf
from bre_tpu_torch.scene.builder import SceneBuilder
from test_torch_bdpt import cameras, fog_sphere_light
from torch_parity import to_np

WH = 8


@pytest.mark.parametrize("maxdepth", [1, 2, 5])
def test_n_dims_and_regen_u_bit_for_bit(maxdepth):
    D = tm._n_dims(maxdepth)
    assert D == jm._n_dims(maxdepth) == 12 * (2 * maxdepth + 1) + 11
    idx = np.array([0, 1, 7, 1000, 2 ** 31 + 5, 2 ** 32 - 1], np.int64)
    got = tm._regen_u(torch.from_numpy(idx), D)
    want = jm._regen_u(jnp.asarray(idx.astype(np.uint32)), D)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


def test_chain_picks_exact():
    rs = np.random.RandomState(21)
    w = rs.exponential(size=(96, 4)).astype(np.float32)
    w[rs.rand(96, 4) < 0.5] = 0.0  # most bootstrap paths carry nothing
    C = 256
    picks = to_np(tm.seed_chains(torch.from_numpy(w), C))
    # bre_tpu's seeding (mlt.py:179-188), on the same luminances
    cdf = jnp.cumsum(jnp.asarray(w).reshape(-1))
    total = jnp.maximum(cdf[-1], 1e-30)
    _, u = jrng.pcg32_next_f32(jrng.pcg32_init(
        jnp.arange(C, dtype=jnp.uint32) + jnp.uint32(0xC417)))
    ref = jnp.minimum(jnp.searchsorted(cdf / total, u, side="right"),
                      w.size - 1)
    np.testing.assert_array_equal(picks, np.asarray(ref))
    assert (w.reshape(-1)[picks] > 0).all()


def test_erf_inv_within_4_ulps():
    rs = np.random.RandomState(22)
    x = np.concatenate([rs.uniform(-1, 1, 20000), np.linspace(-1, 1, 2001),
                        [0.99999, -0.99999, 0.999999]]).astype(np.float32)
    a = to_np(tm._erf_inv(torch.from_numpy(x))).astype(np.float64)
    b = np.asarray(jm._erf_inv(jnp.asarray(x)))
    ulps = np.abs(a - b) / np.spacing(np.abs(b)).astype(np.float64)
    assert ulps.max() <= 4, ulps.max()


def test_evaluate_matches_jax():
    maxdepth, C = 2, 64
    D = tm._n_dims(maxdepth)
    rs = np.random.RandomState(23)
    u = rs.rand(C, D).astype(np.float32)
    depth = np.arange(C) % (maxdepth + 1)
    seq = np.arange(C) + 0x77E5
    ts = fog_sphere_light(SceneBuilder(), device="cpu")
    js = fog_sphere_light(JBuilder())
    cam_t, cam_j = cameras(WH)
    L_t, p_t = tm._evaluate(ts, cam_t, WH, WH, torch.from_numpy(u),
                            torch.from_numpy(depth),
                            trng.pcg32_init(torch.from_numpy(seq)), maxdepth,
                            light_choice_pmf(ts))
    pmf_j = j_pmf(js)
    L_j, p_j = jax.jit(lambda u_, d_, r_: jm._evaluate(
        js, cam_j, WH, WH, u_, d_, r_, maxdepth, pmf_j))(
        jnp.asarray(u), jnp.asarray(depth, jnp.int32),
        jrng.pcg32_init(jnp.asarray(seq, jnp.uint32)))
    L_j, p_j = np.asarray(L_j), np.asarray(p_j)
    assert (np.abs(L_j).sum(-1) > 0).sum() >= 4
    for a, b, what in ((L_t, L_j, "L"), (p_t, p_j, "p_raster")):
        np.testing.assert_allclose(to_np(a), b, rtol=1e-3,
                                   atol=1e-5 * np.abs(b).max(), err_msg=what)
