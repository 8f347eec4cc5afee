"""bre_tpu_torch.fourier against bre_tpu.fourier: the SCATFUN ``.bsdf``
files and the projected tables bit for bit, the Fourier BSDF's queries on
the same numpy inputs from a seed.

- A table projected by each package (a three-channel glossy one and the
  Lambertian test table) is the same numpy table; written by one package
  under ``tmp_path`` and read by the other, it comes back field for field,
  and ``FourierMaterial "bsdffile"`` builds the same stacked tables.
- ``fourier_f``, ``fourier_pdf`` and ``fourier_sample_f`` over two stacked
  tables (three channels and one) on 4,096 lanes, both transport modes,
  and the Fourier lobe of ``sample_bsdf`` / ``eval_bsdf``: rtol 1e-5 /
  atol 1e-6 of each output's largest magnitude where the series is
  evaluated at given directions; the sampled direction, f and pdf, which
  come out of two 32-step Newton-bisections (mu through the CDF, then
  phi), to rtol 1e-4 / atol 1e-4 of the largest magnitude, with at most
  0.1% of the lanes further (a bisection that ends on the other side of
  a spline node).  Measured: 1.1e-5 of the largest magnitude on the
  sampled f and 1.0e-5 on wi, no lane past the bound.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bre_tpu import fourier as jf
from bre_tpu import materials as jm
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu_torch import fourier as tf
from bre_tpu_torch import materials as tm
from bre_tpu_torch.scene.builder import SceneBuilder as TBuilder
from bre_tpu_torch.scene.scene import scene_from_jax
from torch_parity import glossy_fourier_table, to_np

R = 4096


def _tables_equal(a, b):
    for k in a._fields:
        x, y = getattr(a, k), getattr(b, k)
        if isinstance(x, np.ndarray):
            assert x.dtype == np.asarray(y).dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert x == y, k


def test_tables_and_files_bit_for_bit(tmp_path):
    mine = glossy_fourier_table()
    rgb = np.array([0.2, 0.6, 0.35])

    def f(mu_i, mu_o, phi):  # torch_parity.glossy_fourier_table's lobe
        if mu_i * mu_o >= 0:
            return np.zeros((phi.shape[0], 3))
        c = np.sqrt(max(0.0, 1 - mu_i * mu_i) * max(0.0, 1 - mu_o * mu_o))
        lobe = np.exp(4.0 * (abs(mu_i * mu_o) - c * np.cos(phi) - 1.0))
        return (0.3 / np.pi + 0.5 * lobe)[:, None] * rgb

    _tables_equal(mine, jf.project_bsdf_table(f, n_mu=16, m_max=8,
                                              n_channels=3, eta=1.0))
    _tables_equal(tf.lambertian_fourier_table(0.7, 12),
                  jf.lambertian_fourier_table(0.7, 12))
    tf.write_bsdf_file(tmp_path / "t.bsdf", mine)
    jf.write_bsdf_file(tmp_path / "j.bsdf", mine)
    assert (tmp_path / "t.bsdf").read_bytes() == (tmp_path / "j.bsdf"
                                                  ).read_bytes()
    _tables_equal(tf.read_bsdf_file(tmp_path / "t.bsdf"),
                  jf.read_bsdf_file(tmp_path / "t.bsdf"))

    def build(b):
        b.fourier_material(bsdffile=str(tmp_path / "t.bsdf"))
        b.fourier_material(table=b_lam(b))
        b.sphere((0, 0, 0), 1.0, material=0)
        return b

    def b_lam(b):
        mod = tf if isinstance(b, TBuilder) else jf
        return mod.lambertian_fourier_table(0.5, 16)

    got = build(TBuilder()).build(device="cpu").materials
    want = scene_from_jax(build(JBuilder()).build(), device="cpu").materials
    for a, b in zip(got.fourier_tables, want.fourier_tables):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b
    assert torch.equal(got.fourier, want.fourier)
    assert torch.equal(got.eta, want.eta)


@pytest.fixture(scope="module")
def tables():
    rows = [glossy_fourier_table(), tf.lambertian_fourier_table(0.6, 16)]
    return jf.stack_fourier_tables(rows), tf.stack_fourier_tables(rows)


def _dirs(rs, n):
    d = rs.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _close(a, b, rtol=1e-5, atol=1e-6):
    b = np.asarray(b)
    np.testing.assert_allclose(
        to_np(a), b, rtol=rtol, atol=atol * max(float(np.abs(b).max()), 1.0))


def _mostly_close(a, b, rtol=1e-4, atol=1e-4):
    a, b = to_np(a), np.asarray(b)
    tol = atol * max(float(np.abs(b).max()), 1.0) + rtol * np.abs(b)
    bad = np.abs(a - b) > tol
    if bad.ndim == 2:
        bad = bad.any(-1)
    assert bad.sum() <= R // 1000, (bad.sum(), np.nonzero(bad)[0][:8])


@pytest.mark.parametrize("mode", [0, 1])
def test_fourier_queries_match_jax(tables, mode):
    jt, tt = tables
    rs = np.random.RandomState(3 + mode)
    tidx = rs.randint(0, 2, R)
    wo, wi = _dirs(rs, R), _dirs(rs, R)
    u = rs.uniform(0, 1, (R, 2)).astype(np.float32)
    T, J = torch.from_numpy, jnp.asarray
    _close(tf.fourier_f(tt, T(tidx), T(wo), T(wi), mode),
           jf.fourier_f(jt, J(tidx), J(wo), J(wi), mode))
    _close(tf.fourier_pdf(tt, T(tidx), T(wo), T(wi)),
           jf.fourier_pdf(jt, J(tidx), J(wo), J(wi)))
    got = tf.fourier_sample_f(tt, T(tidx), T(wo), T(u), mode)
    want = jf.fourier_sample_f(jt, J(tidx), J(wo), J(u), mode)
    for a, b in zip(got, want):
        _mostly_close(a, b)
    assert float((got[2] > 0).float().mean()) > 0.3


def test_fourier_lobe_of_the_bsdf_matches_jax():
    """sample_bsdf and eval_bsdf on a table holding a Fourier material and
    a matte one, in the frame of the unflipped normal."""
    def build(b, table):
        ids = [b.fourier_material(table=table), b.matte((0.5, 0.4, 0.3))]
        b.sphere((0, 0, 0), 1.0, material=0)
        return ids

    table = glossy_fourier_table()
    jb = JBuilder()
    build(jb, table)
    js = jb.build()
    ts = scene_from_jax(js, device="cpu")
    rs = np.random.RandomState(11)
    mat = rs.randint(-1, 2, R)
    n, wo, wi = _dirs(rs, R), _dirs(rs, R), _dirs(rs, R)
    u = rs.uniform(0, 1, (R, 2)).astype(np.float32)
    T, J = torch.from_numpy, jnp.asarray
    for mode in (0, 1):
        got = tm.sample_bsdf(ts.materials, T(mat), T(n), T(wo), T(u),
                             mode=mode)
        want = jm.sample_bsdf(js.materials, J(mat), J(n), J(wo), J(u),
                              mode=mode)
        for k in ("specular", "valid"):
            flips = (to_np(getattr(got, k)) != np.asarray(getattr(want, k)))
            assert flips.sum() <= R // 1000, k
        for k in ("wi", "f", "pdf"):
            _mostly_close(getattr(got, k), getattr(want, k))
    f, pdf = tm.eval_bsdf(ts.materials, T(mat), T(n), T(wo), T(wi))
    jf_, jpdf = jm.eval_bsdf(js.materials, J(mat), J(n), J(wo), J(wi))
    _close(f, jf_)
    _close(pdf, jpdf)
