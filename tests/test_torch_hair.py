"""bre_tpu_torch.hair and the hair lobe of the BSDFs against bre_tpu's, on
the same numpy inputs from a seed.

- ``demux_float`` exactly (bit manipulation on the same float32 inputs).
- ``h_from_tube_geometry``, ``hair_f``, ``hair_pdf`` and
  ``hair_sample_f`` on 4,096 lanes of random hair parameters (beta_m and
  beta_n from 0.1 to 0.9, the narrow lobes among them), and
  ``sample_bsdf`` / ``eval_bsdf`` on torch_parity.fiber_materials' hairs,
  a mix holding a hair and a mix of mixes, with and without the fiber
  tangent, both transport modes.

Tolerances: the hair lobes chain exp, log, sinh, asin and atan2, which
XLA and torch each round in their own way, and a narrow lobe amplifies
the last bits.  Hence f and pdf to rtol 2e-3 / atol 1e-5 of the largest
magnitude, and wi to atol 1e-3, with at most 0.1% of the lanes further
and no lane further than 5% (measured on the BSDF lanes: 1.35e-3
relative in f on one lane of 4,096, where a float64 evaluation lies
between the two packages; 3.3e-4 in a component of wi).  h, a sine
sqrt(1 - c^2) of a cosine c near 1, is held to 1e-6 plus 4.8e-7 /
max(|h|, 4.9e-4): four float32 ulps of c carried through the square
root, up to sqrt(2 ulps) where c rounds to 1 in one package (measured:
3.45e-4 on such a lane, h * |dh| at most 2.4e-7 elsewhere).  The reference
runs eagerly, as its own tests run it (a jit fuses, and rounds,
differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bre_tpu import hair as jh
from bre_tpu import materials as jm
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu_torch import hair as th
from bre_tpu_torch import materials as tm
from bre_tpu_torch.scene.scene import scene_from_jax
from torch_parity import fiber_materials, to_np

R = 4096


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def _close(name, a, b, rtol=2e-3, atol=1e-5, far=0.05):
    a, b = to_np(a), np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-30)
    d = np.abs(a - b)
    bad = d > atol * scale + rtol * np.abs(b)
    worse = d > far * np.maximum(np.abs(b), atol * scale)
    if bad.ndim == 2:
        bad, worse = bad.any(-1), worse.any(-1)
    assert bad.sum() <= R // 1000, (name, bad.sum(), np.nonzero(bad)[0][:8])
    assert not (bad & worse).any(), (name, np.nonzero(bad & worse)[0][:8])


def _dir_close(name, a, b):
    _close(name, a, b, rtol=0.0, atol=1e-3)


def test_demux_float_exact():
    rs = np.random.RandomState(0)
    u = np.concatenate([rs.uniform(0, 1, R), [0.0, 0.99999994, 1.0, 0.5]])
    u = u.astype(np.float32)
    for a, b in zip(th.demux_float(torch.from_numpy(u)),
                    jh.demux_float(jnp.asarray(u))):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))


@pytest.fixture(scope="module")
def lanes():
    rs = np.random.RandomState(1)
    n = _unit(rs.normal(size=(R, 3)))
    t = _unit(np.cross(n, rs.normal(size=(R, 3))))
    wo = _unit(rs.normal(size=(R, 3)))
    hp = dict(sigma_a=rs.uniform(0.0, 2.0, (R, 3)).astype(np.float32),
              eta=rs.uniform(1.3, 1.7, R).astype(np.float32),
              beta_m=rs.uniform(0.1, 0.9, R).astype(np.float32),
              beta_n=rs.uniform(0.1, 0.9, R).astype(np.float32),
              alpha=rs.uniform(0.0, 4.0, R).astype(np.float32))
    # hair-frame directions: (sin theta, cos theta cos phi, cos theta sin
    # phi)
    wo_l, wi_l = _unit(rs.normal(size=(R, 3))), _unit(rs.normal(size=(R, 3)))
    h = rs.uniform(-0.99, 0.99, R).astype(np.float32)
    u4 = rs.uniform(0, 1, (R, 4)).astype(np.float32)
    return n, t, wo, hp, wo_l, wi_l, h, u4


def test_hair_functions_match_jax(lanes):
    n, t, wo, hp, wo_l, wi_l, h, u4 = lanes
    T, J = torch.from_numpy, jnp.asarray
    h_ref = np.asarray(jh.h_from_tube_geometry(J(n), J(wo), J(t)))
    # h = sqrt(1 - c^2) of a cosine c that carries a few ulps: dh = dc c /
    # h, up to sqrt(2 ulps) where c rounds to 1 in one package
    tol = 1e-6 + 4.8e-7 / np.maximum(np.abs(h_ref), 4.9e-4)
    assert (np.abs(to_np(th.h_from_tube_geometry(T(n), T(wo), T(t)))
                   - h_ref) <= tol).all()
    tp = th.HairParams(**{k: T(v) for k, v in hp.items()})
    jp = jh.HairParams(**{k: J(v) for k, v in hp.items()})
    f = jh.hair_f(jp, J(h), J(wo_l), J(wi_l))
    _close("f", th.hair_f(tp, T(h), T(wo_l), T(wi_l)), f)
    _close("pdf", th.hair_pdf(tp, T(h), T(wo_l), T(wi_l)),
           jh.hair_pdf(jp, J(h), J(wo_l), J(wi_l)))
    got = th.hair_sample_f(tp, T(h), T(wo_l), T(u4))
    want = jh.hair_sample_f(jp, J(h), J(wo_l), J(u4))
    _dir_close("sample wi", got[0], want[0])
    _close("sample f", got[1], want[1])
    _close("sample pdf", got[2], want[2])
    assert float(np.asarray(f).max()) > 0


@pytest.fixture(scope="module")
def tables():
    jb = JBuilder()
    ids = fiber_materials(jb)
    js = jb.build()
    return ids, js, scene_from_jax(js, device="cpu")


@pytest.mark.parametrize("mode", [tm.MODE_RADIANCE, tm.MODE_IMPORTANCE])
def test_hair_lobe_of_the_bsdf_matches_jax(tables, mode):
    """The hairs, a mix holding a hair and a mix of mixes (its eval reads
    the sub-materials without the tangent, as the reference's), with the
    fiber tangent (not perpendicular to n, as tessellated curves' are),
    and in radiance mode also without it (the canonical frame, evaluated
    at the sampled directions)."""
    ids, js, ts = tables
    names = ("hair", "hair_rough", "mix_hair", "mix_of_mixes")
    rs = np.random.RandomState(5 + mode)
    mat = np.asarray([ids[k] for k in names])[rs.randint(0, len(names), R)]
    mat[rs.uniform(size=R) < 0.05] = -1
    n, wo, wi = (_unit(rs.normal(size=(R, 3))) for _ in range(3))
    u = rs.uniform(0, 1, (R, 2)).astype(np.float32)
    tan = rs.normal(size=(R, 3)).astype(np.float32)
    T, J = torch.from_numpy, jnp.asarray

    def ref_sample(n_, wo_, u_, t_):
        return jm.sample_bsdf(js.materials, J(mat), n_, wo_, u_, mode=mode,
                              tangent=t_)

    def ref_eval(n_, wo_, wi_, t_):
        return jm.eval_bsdf(js.materials, J(mat), n_, wo_, wi_, tangent=t_)

    for t in ((tan, np.zeros_like(tan)) if mode == tm.MODE_RADIANCE
              else (tan,)):
        want = ref_sample(J(n), J(wo), J(u), J(t))
        got = tm.sample_bsdf(ts.materials, T(mat), T(n), T(wo), T(u),
                             mode=mode, tangent=T(t))
        for k in ("specular", "valid"):
            flips = to_np(getattr(got, k)) != np.asarray(getattr(want, k))
            assert flips.sum() <= R // 1000, k
        _dir_close("wi", got.wi, want.wi)
        _close("f", got.f, want.f)
        _close("pdf", got.pdf, want.pdf)
        assert np.asarray(want.valid).mean() > 0.5
        for w in ((wi, np.asarray(want.wi)) if t is tan
                  else (np.asarray(want.wi),)):
            jf_, jpdf = ref_eval(J(n), J(wo), J(w), J(t))
            f, pdf = tm.eval_bsdf(ts.materials, T(mat), T(n), T(wo),
                                  T(np.ascontiguousarray(w)), tangent=T(t))
            _close("eval f", f, jf_)
            _close("eval pdf", pdf, jpdf)
