"""bre_tpu_torch.bssrdf against bre_tpu.bssrdf: the host-built tables bit
for bit, the per-bounce queries on the same numpy inputs from a seed.

- ``compute_beam_diffusion_bssrdf`` (rho, radius, profile, rho_eff, cdf),
  ``subsurface_from_diffuse``, the Fresnel moments on numpy inputs, and
  the builder's stacked tables and sigmas for subsurface (named and with
  parameters) and kdsubsurface: equal arrays (same numpy code, dtypes and
  order).
- ``bssrdf_sr``, ``bssrdf_pdf_sr``, ``bssrdf_sample_sr``, ``pdf_sp`` and
  ``sw_factor`` on 4,096 lanes over two stacked tables: rtol 1e-5 /
  atol 1e-6 of each output's largest magnitude (XLA:CPU contracts
  multiply-adds, ROADMAP Queue 3); the sampled radius, a 32-step
  Newton-bisection through a CDF, to rtol 2e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bre_tpu import bssrdf as jb
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu_torch import bssrdf as tb
from bre_tpu_torch.scene.builder import SceneBuilder as TBuilder
from bre_tpu_torch.scene.scene import scene_from_jax
from torch_parity import to_np

R = 4096


def _close(a, b, rtol=1e-5):
    b = np.asarray(b)
    np.testing.assert_allclose(to_np(a), b, rtol=rtol,
                               atol=1e-6 * max(float(np.abs(b).max()), 1e-30))


@pytest.mark.parametrize("g,eta", [(0.0, 1.33), (0.4, 1.5)])
def test_tables_bit_for_bit(g, eta):
    want = jb.compute_beam_diffusion_bssrdf(g, eta)
    got = tb.compute_beam_diffusion_bssrdf(g, eta)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for kd, mfp in (((0.5, 0.3, 0.2), (1, 1, 1)), ((0.9, 0.05, 0.6),
                                                   (0.2, 3.0, 0.5))):
        for a, b in zip(tb.subsurface_from_diffuse(got, kd, mfp),
                        jb.subsurface_from_diffuse(want, kd, mfp)):
            np.testing.assert_array_equal(a, b)
    e = np.linspace(0.5, 2.5, 41)
    np.testing.assert_array_equal(tb.fresnel_moment1(e), jb.fresnel_moment1(e))
    np.testing.assert_array_equal(tb.fresnel_moment2(e), jb.fresnel_moment2(e))


def _materials(b):
    b.subsurface(eta=1.4, scale=2.0)
    b.subsurface(name="Ketchup")
    b.subsurface(sigma_a=(0.1, 0.2, 0.3), sigma_s=(1, 2, 3), g=0.3)
    b.kdsubsurface(kd=(0.3, 0.5, 0.7), mfp=(0.5, 1.0, 2.0), eta=1.4)
    b.sphere((0, 0, 0), 1.0, material=0)
    return b


def test_builder_tables_bit_for_bit():
    """The builder's rows (one table per unique (g, eta), the sigmas) and
    their stack, against scene_from_jax of the reference's."""
    mine = _materials(TBuilder()).build(device="cpu").materials
    ref = scene_from_jax(_materials(JBuilder()).build(),
                         device="cpu").materials
    assert mine.bss_tables.rho.shape[0] == 3
    for k in ("bss_sigma_a", "bss_sigma_s", "bss_table", "eta", "kd", "ks"):
        assert torch.equal(getattr(mine, k), getattr(ref, k)), k
    for a, b in zip(mine.bss_tables, ref.bss_tables):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def lanes():
    tabs = [jb.compute_beam_diffusion_bssrdf(g, e)
            for g, e in ((0.0, 1.33), (0.3, 1.5))]
    jt = jb.BSSRDFTables(*(jnp.asarray(np.stack([t[k] for t in tabs]))
                           for k in ("rho", "radius", "profile", "rho_eff",
                                     "cdf")))
    tt = tb.bssrdf_tables(tabs, "cpu")
    rs = np.random.RandomState(7)
    tidx = rs.randint(0, 2, R)
    sigma_t = rs.uniform(0.5, 20.0, (R, 3)).astype(np.float32)
    rho = rs.uniform(0.0, 1.0, (R, 3)).astype(np.float32)
    rho[:64] = 0.0  # an absorbing channel
    r = rs.exponential(0.1, R).astype(np.float32)
    r[:32] = 0.0
    u = rs.uniform(0, 1, R).astype(np.float32)
    return jt, tt, tidx, sigma_t, rho, r, u


def test_sr_and_pdf_sr_match_jax(lanes):
    jt, tt, tidx, sigma_t, rho, r, _ = lanes
    T, J = torch.from_numpy, jnp.asarray
    _close(tb.bssrdf_sr(tt, T(tidx), T(sigma_t), T(rho), T(r)),
           jb.bssrdf_sr(jt, J(tidx), J(sigma_t), J(rho), J(r)))
    for ch in range(3):
        _close(tb.bssrdf_pdf_sr(tt, T(tidx), T(sigma_t[:, ch]),
                                T(rho[:, ch]), T(r)),
               jb.bssrdf_pdf_sr(jt, J(tidx), J(sigma_t[:, ch]),
                                J(rho[:, ch]), J(r)))


def test_sample_sr_matches_jax(lanes):
    jt, tt, tidx, sigma_t, rho, _, u = lanes
    T, J = torch.from_numpy, jnp.asarray
    st = sigma_t[:, 1].copy()
    st[:16] = 0.0  # failed lanes: -1
    got = tb.bssrdf_sample_sr(tt, T(tidx), T(st), T(rho[:, 1]), T(u))
    want = jb.bssrdf_sample_sr(jt, J(tidx), J(st), J(rho[:, 1]), J(u))
    _close(got, want, rtol=2e-5)
    assert (to_np(got)[:16] == -1.0).all()


def test_pdf_sp_and_sw_match_jax(lanes):
    jt, tt, tidx, sigma_t, rho, _, _ = lanes
    rs = np.random.RandomState(8)

    def unit(a):
        return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(
            np.float32)

    ns = unit(rs.normal(size=(R, 3)))
    ss = unit(np.cross(ns, rs.normal(size=(R, 3))))
    ts = np.cross(ns, ss).astype(np.float32)
    d = (rs.normal(size=(R, 3)) * 0.05).astype(np.float32)
    ni = unit(rs.normal(size=(R, 3)))
    T, J = torch.from_numpy, jnp.asarray
    _close(tb.pdf_sp(tt, T(tidx), T(sigma_t), T(rho), T(d), T(ni), T(ss),
                     T(ts), T(ns)),
           jb.pdf_sp(jt, J(tidx), J(sigma_t), J(rho), J(d), J(ni), J(ss),
                     J(ts), J(ns)))
    eta = rs.uniform(1.1, 1.8, R).astype(np.float32)
    cw = rs.uniform(-1, 1, R).astype(np.float32)
    _close(tb.sw_factor(T(eta), T(cw)), jb.sw_factor(J(eta), J(cw)))
