"""bre_tpu_torch.materials against bre_tpu.materials: the Fresnel terms,
the GGX alpha map, and ``sample_bsdf`` / ``eval_bsdf`` of every ported
material (matte, mirror, glass, metal, plastic, uber, substrate,
translucent) and the mix, on the same numpy inputs from a seed.

The lanes (R = 4096): normals in every direction; wo on both sides of the
surface, a sixteenth of them grazing (|cos| about 1e-3) and a sixteenth
inside a dielectric past the critical angle (total internal reflection);
tangents absent or present (not perpendicular to n, as tessellated curve
tangents are); both transport modes; a tenth of the lanes without a
material (-1).

Tolerances: ``wi``, ``f`` and ``pdf`` rtol 1e-5 / atol 1e-6 (XLA:CPU
contracts multiply-adds and its sin/cos/log differ from torch's in the
last bits: ROADMAP Queue 3), widened on each lane by four times how far the
reference's own output moves when its inputs move by up to eight float32
ulps of max(|x|, 1) (three draws).  That spread is zero to the tolerance on well-conditioned lanes and
large only where the math amplifies last bits: near the peak of a narrow
GGX lobe (D's denominator cancels to about alpha^2; measured up to 3.5e-3
relative at roughness 0.01, on 5 lanes of 4096) and at grazing cosine
samples (z = sqrt(1 - x^2 - y^2)).  ``specular`` and ``valid`` are equal
on every lane but those whose lobe or validity choice the same input
perturbation flips in the reference (a branch threshold within an ulp);
those lanes are counted, at most 0.1% of a case, and skipped.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bre_tpu import materials as jm
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu_torch import materials as tm
from bre_tpu_torch.scene.builder import SceneBuilder as TBuilder
from bre_tpu_torch.scene.scene import check_slice, scene_from_jax
from torch_parity import every_material, fiber_materials, to_np

R = 4096
RTOL, ATOL = 1e-5, 1e-6
TIE = 1e-6


@pytest.fixture(scope="module")
def tables():
    jb = JBuilder()
    ids = every_material(jb)
    js = jb.build()
    return ids, js, scene_from_jax(js, device="cpu")


CASES = {
    "matte": ["matte"],
    "mirror": ["mirror"],
    "glass": ["glass", "glass_tinted"],
    "metal": ["metal", "metal_rough"],
    "plastic": ["plastic"],
    "uber": ["uber"],
    "substrate": ["substrate"],
    "translucent": ["translucent"],
    "mix": ["mix", "mix_specular"],
    # a mix of mixes reads one level: its lanes that pick the sub-mix take
    # the default lobe with the sub-mix's row, as the reference's do
    "mix_of_mixes": ["mix_of_mixes", "mix"],
    # their BSDF is glass's (subsurface.cpp:63-66)
    "subsurface": ["subsurface", "kdsubsurface"],
    "textured": ["matte_tex", "plastic_tex"],
}


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def _lanes(ids, names, seed):
    """(mat_idx, n, wo, wi, u, tangent, p, uv) as numpy arrays."""
    rs = np.random.RandomState(seed)
    n = _unit(rs.normal(size=(R, 3)))
    wo = _unit(rs.normal(size=(R, 3)))
    k = R // 16
    # grazing lanes: wo nearly in the tangent plane, on either side
    t = _unit(np.cross(n[:k], rs.normal(size=(k, 3))))
    side = np.where(rs.uniform(size=(k, 1)) < 0.5, -1.0, 1.0)
    wo[:k] = _unit(t + side * 1e-3 * n[:k])
    # inside lanes past the critical angle of eta 1.5 (sin > 1/1.5)
    t = _unit(np.cross(n[k:2 * k], rs.normal(size=(k, 3))))
    c = rs.uniform(0.05, 0.7, (k, 1))
    wo[k:2 * k] = _unit(np.sqrt(1 - c * c) * t - c * n[k:2 * k])
    wi = _unit(rs.normal(size=(R, 3)))
    u = rs.uniform(0, 1, (R, 2)).astype(np.float32)
    tangent = rs.normal(size=(R, 3)).astype(np.float32)
    p = rs.uniform(-2, 2, (R, 3)).astype(np.float32)
    uv = rs.uniform(-1, 2, (R, 2)).astype(np.float32)
    pick = np.asarray([ids[m] for m in names])
    mat = pick[rs.randint(0, len(pick), R)].astype(np.int64)
    mat[rs.uniform(size=R) < 0.1] = -1
    return mat, n, wo, wi, u, tangent, p, uv


def _perturbed(arrays, seed):
    """Each entry x moved by up to eight float32 ulps of max(|x|, 1): the
    internal roundings (of 2u - 1, of a sine) that two libraries may do
    differently are of that size even where x itself is small."""
    rs = np.random.RandomState(seed)
    out = []
    for a in arrays:
        k = rs.randint(-8, 9, a.shape) * 2.0 ** -23
        out.append((a + k * np.maximum(np.abs(a), 1.0)).astype(np.float32))
    return out


def _reference_spread(run, inputs, names):
    """run(*inputs) -> dict of reference outputs.  Returns (outputs, the
    per-lane spread of each float output over three perturbations of the
    inputs, the lanes where a bool output flips or wi moves off its
    lobe)."""
    out = run(*inputs)
    spread = {k: np.zeros(out[k].shape[:1]) for k in names}
    flips = np.zeros(R, bool)
    for seed in (1, 2, 3):
        o = run(*_perturbed(inputs, seed))
        for k in names:
            d = np.abs(o[k] - out[k])
            spread[k] = np.maximum(spread[k], d.max(-1) if d.ndim == 2 else d)
        for k in ("specular", "valid"):
            if k in out:
                flips |= o[k] != out[k]
        if "wi" in out:
            flips |= np.abs(o["wi"] - out["wi"]).max(-1) > 1e-3
    return out, spread, flips


def _assert_close(name, a, b, skip, spread=0.0):
    a, b = to_np(a), np.asarray(b)
    if a.dtype == bool:
        bad = (a != b) & ~skip
        assert not bad.any(), (name, np.nonzero(bad)[0][:8])
        return
    tol = ATOL + 4.0 * np.asarray(spread)
    if a.ndim == 2:
        tol, skip = (tol[:, None] if np.ndim(tol) else tol), skip[:, None]
    bad = ~skip & ~(np.abs(a - b) <= tol + RTOL * np.abs(b))
    assert not bad.any(), (name, np.argwhere(bad)[:8], a[bad][:8], b[bad][:8])


def _reference(js, mode, with_tangent, tex):
    """bre_tpu's sample_bsdf and eval_bsdf on ``js``'s tables, run eagerly
    as its own tests run them (a jit fuses differently): (sample(mat, n,
    wo, u, p, uv, t), eval(mat, n, wo, wi, p, uv, t)), each -> a dict of
    numpy arrays."""
    def kw(p, uv, t):
        d = dict(tangent=jnp.asarray(t) if with_tangent else None)
        if tex:
            d.update(textures=js.textures, p=jnp.asarray(p),
                     uv=jnp.asarray(uv))
        return d

    def sample(mat, n, wo, u, p, uv, t):
        b = jm.sample_bsdf(js.materials, jnp.asarray(mat), jnp.asarray(n),
                           jnp.asarray(wo), jnp.asarray(u), mode=mode,
                           **kw(p, uv, t))
        return {k: np.asarray(v) for k, v in b._asdict().items()}

    def evaluate(mat, n, wo, wi, p, uv, t):
        f, pdf = jm.eval_bsdf(js.materials, jnp.asarray(mat), jnp.asarray(n),
                              jnp.asarray(wo), jnp.asarray(wi), **kw(p, uv, t))
        return dict(f=np.asarray(f), pdf=np.asarray(pdf))

    return sample, evaluate


@pytest.mark.parametrize("mode", [tm.MODE_RADIANCE, tm.MODE_IMPORTANCE])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sample_and_eval_bsdf_match_jax(tables, case, mode):
    ids, js, ts = tables
    mat, n, wo, wi, u, tangent, p, uv = _lanes(ids, CASES[case],
                                               seed=len(case) * 7 + mode)
    tex = case == "textured"
    T = torch.from_numpy
    for with_tangent in (False, True):
        ref_sample, ref_eval = _reference(js, mode, with_tangent, tex)
        tkw = dict(tangent=T(tangent) if with_tangent else None)
        if tex:
            tkw.update(textures=ts.textures, p=T(p), uv=T(uv))
        ekw = tkw
        ref, spread, flips = _reference_spread(
            lambda *a: ref_sample(mat, *a), [n, wo, u, p, uv, tangent],
            ("wi", "f", "pdf"))
        bt = tm.sample_bsdf(ts.materials, T(mat), T(n), T(wo), T(u), mode=mode,
                            **tkw)
        skip = flips & (mat >= 0)
        assert skip.sum() <= R // 1000, skip.sum()
        for k in ("specular", "valid", "wi", "f", "pdf"):
            _assert_close(k, getattr(bt, k), ref[k], skip, spread.get(k, 0.0))
        assert ref["valid"].sum() > R // 4

        # eval at random directions and at the sampled ones
        none = np.zeros(R, bool)
        for w in (wi, ref["wi"]):
            e, es, _ = _reference_spread(lambda *a: ref_eval(mat, *a),
                                         [n, wo, w, p, uv, tangent],
                                         ("f", "pdf"))
            ft, pt = tm.eval_bsdf(ts.materials, T(mat), T(n), T(wo), T(w),
                                  **ekw)
            _assert_close("eval f", ft, e["f"], none, es["f"])
            _assert_close("eval pdf", pt, e["pdf"], none, es["pdf"])


def test_kinds_skip_changes_no_bits():
    """A matte table skips the hair, Fourier and glass lobes; computing
    them anyway (every kind on, with Fourier tables to gather from)
    changes no bit of sample_bsdf or eval_bsdf, nor of a volpath render
    (the BSSRDF branch's draws follow the table's subsurface tags, as the
    reference's do, so it stays off) or a photon-beam render."""
    from bre_tpu_torch.core import transform as tfm
    from bre_tpu_torch.integrators import photonbeam as tpb
    from bre_tpu_torch.integrators import volpath as tvp
    from bre_tpu_torch.scene.camera import make_perspective_camera
    from bre_tpu_torch.scene.scene import MAT_KDSUBSURFACE, MAT_SUBSURFACE
    from torch_parity import cornell_fog

    skip = cornell_fog(TBuilder(), point_light=True, device="cpu")
    fb = TBuilder()
    fiber_materials(fb)
    other = fb.build(device="cpu").materials
    kinds = torch.ones_like(skip.materials.kinds)
    kinds[MAT_SUBSURFACE] = kinds[MAT_KDSUBSURFACE] = False
    full = skip._replace(materials=skip.materials._replace(
        kinds=kinds, fourier_tables=other.fourier_tables))
    assert int(skip.materials.kinds.sum()) == 1
    ids = {"m": 0}
    mat, n, wo, wi, u, tangent, p, uv = _lanes(ids, ["m"], seed=3)
    T = torch.from_numpy
    for mode in (tm.MODE_RADIANCE, tm.MODE_IMPORTANCE):
        a, b = (tm.sample_bsdf(s.materials, T(mat), T(n), T(wo), T(u),
                               mode=mode, tangent=T(tangent))
                for s in (skip, full))
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    a, b = (tm.eval_bsdf(s.materials, T(mat), T(n), T(wo), T(wi),
                         tangent=T(tangent)) for s in (skip, full))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    W = 8
    cam = make_perspective_camera(tfm.look_at((0, 0, -2.2), (0, 0, 1),
                                              (0, 1, 0)), 50.0, W, W,
                                  device="cpu")
    cfg = tvp.VolPathConfig(maxdepth=3, spp=2, nee_mis=True)
    a, b = (tvp.render_volpath(s, cam, W, W, cfg) for s in (skip, full))
    assert float(a.mean()) > 0 and torch.equal(a, b)
    pcfg = tpb.PhotonBeamConfig(iterations=1, photonsperiteration=500,
                                maxdepth=3, initialbeamradius=0.15)
    a, b = (tpb.render_photonbeam(s, cam, W, W, pcfg)[0]
            for s in (skip, full))
    assert float(a.mean()) > 0 and torch.equal(a, b)


def test_fresnel_and_alpha_match_jax():
    rs = np.random.RandomState(5)
    cos = np.concatenate([rs.uniform(-1.2, 1.2, 4000),
                          [0.0, -0.0, 1.0, -1.0, 1e-7]]).astype(np.float32)
    eta = rs.uniform(1.0, 2.5, cos.shape).astype(np.float32)
    ones = np.ones_like(cos)
    np.testing.assert_allclose(
        to_np(tm.fr_dielectric(torch.from_numpy(cos), torch.from_numpy(ones),
                               torch.from_numpy(eta))),
        np.asarray(jm.fr_dielectric(jnp.asarray(cos), jnp.asarray(ones),
                                    jnp.asarray(eta))), rtol=RTOL, atol=ATOL)
    e3 = rs.uniform(0.1, 2.0, (cos.size, 3)).astype(np.float32)
    k3 = rs.uniform(0.0, 5.0, (cos.size, 3)).astype(np.float32)
    np.testing.assert_allclose(
        to_np(tm.fr_conductor(*(torch.from_numpy(x) for x in (cos, e3, k3)))),
        np.asarray(jm.fr_conductor(*(jnp.asarray(x) for x in (cos, e3, k3)))),
        rtol=RTOL, atol=ATOL)
    rough = np.concatenate([rs.uniform(0, 1, 1000), [0.0, 1e-4, 1e-3]])
    rough = rough.astype(np.float32)
    np.testing.assert_allclose(
        to_np(tm.roughness_to_alpha(torch.from_numpy(rough))),
        np.asarray(jm.roughness_to_alpha(jnp.asarray(rough))), rtol=RTOL,
        atol=ATOL)


def _one(build):
    b = TBuilder()
    build(b)
    b.sphere((0, 0, 0), 1.0, material=0)
    return b.build(device="cpu").materials


def _uniform(n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, 2), generator=g)


def test_mirror_reflects():
    """tests/test_lights_materials.py::test_mirror_reflects."""
    mats = _one(lambda b: b.mirror((0.9, 0.9, 0.9)))
    n = torch.tensor([[0.0, 0.0, 1.0]])
    wo = torch.tensor([[1.0, 0.0, 1.0]]) / np.sqrt(2)
    bs = tm.sample_bsdf(mats, torch.zeros(1, dtype=torch.int64), n, wo,
                        torch.zeros((1, 2)))
    np.testing.assert_allclose(to_np(bs.wi[0]), np.array([-1, 0, 1]) / np.sqrt(2),
                               atol=1e-6)
    assert bool(bs.specular[0])
    w = to_np(bs.f[0]) * abs(float((bs.wi * n).sum(-1)[0]))
    np.testing.assert_allclose(w, 0.9, rtol=1e-5)


def test_glass_energy_split_fresnel():
    """tests/test_lights_materials.py::test_glass_energy_split_fresnel:
    FresnelSpecular keeps energy for kr = kt = 1."""
    mats = _one(lambda b: b.glass())
    N = 50000
    n = torch.tensor([[0.0, 0.0, 1.0]]).repeat(N, 1)
    wo = torch.nn.functional.normalize(torch.tensor([[0.4, 0.0, 0.9165]]),
                                       dim=-1).repeat(N, 1)
    bs = tm.sample_bsdf(mats, torch.zeros(N, dtype=torch.int64), n, wo,
                        _uniform(N, 4), mode=tm.MODE_IMPORTANCE)
    w = to_np(bs.f * ((bs.wi * n).sum(-1).abs() / bs.pdf)[:, None])
    np.testing.assert_allclose(w.mean(0), 1.0, rtol=0.02)


def test_glass_refraction_direction_snell():
    """tests/test_lights_materials.py::test_glass_refraction_direction_snell,
    and Snell's law at an oblique angle from inside."""
    mats = _one(lambda b: b.glass(eta=1.5))
    n = torch.tensor([[0.0, 0.0, 1.0]])
    bs = tm.sample_bsdf(mats, torch.zeros(1, dtype=torch.int64), n,
                        torch.tensor([[0.0, 0.0, 1.0]]),
                        torch.tensor([[0.99, 0.0]]))
    np.testing.assert_allclose(to_np(bs.wi[0]), [0, 0, -1], atol=1e-5)
    s_in = 0.5  # inside, below the critical angle: sin_out = 1.5 sin_in
    wo = torch.tensor([[-s_in, 0.0, -np.sqrt(1 - s_in ** 2)]], dtype=torch.float32)
    bs = tm.sample_bsdf(mats, torch.zeros(1, dtype=torch.int64), n, wo,
                        torch.tensor([[0.999, 0.0]]))
    wi = to_np(bs.wi[0])
    np.testing.assert_allclose(wi[0], 1.5 * s_in, rtol=1e-5)
    assert wi[2] > 0 and bool(bs.specular[0])


def test_mix_material_blends_albedo():
    """tests/test_lights_materials.py::test_mix_material_blends_albedo: a
    0.5 mix of matte 0.8 and matte 0.2 samples and evaluates as matte 0.5."""
    b = TBuilder()
    ma, mb = b.matte((0.8,) * 3), b.matte((0.2,) * 3)
    b.mix(ma, mb, (0.5, 0.5, 0.5))
    b.sphere((0, 0, 0), 1.0, material=2)
    mats = b.build(device="cpu").materials
    N = 20000
    n = torch.tensor([[0.0, 0.0, 1.0]]).repeat(N, 1)
    wo = n.clone()
    mi = torch.full((N,), 2, dtype=torch.int64)
    bs = tm.sample_bsdf(mats, mi, n, wo, _uniform(N, 5))
    w = to_np(bs.f * ((bs.wi * n).sum(-1).abs() / bs.pdf)[:, None])
    np.testing.assert_allclose(w.mean(0), 0.5, rtol=0.02)
    f, pdf = tm.eval_bsdf(mats, mi, n, wo, bs.wi)
    np.testing.assert_allclose(to_np(f), 0.5 / np.pi, rtol=1e-5)
    np.testing.assert_allclose(to_np(pdf), to_np(bs.pdf), rtol=1e-4)


def test_metal_energy_and_direction():
    """tests/test_breadth.py::test_metal_energy_and_direction."""
    mats = _one(lambda b: b.metal(roughness=0.1))
    N = 20000
    n = torch.tensor([[0.0, 0.0, 1.0]]).repeat(N, 1)
    wo = torch.nn.functional.normalize(torch.tensor([[0.3, 0.0, 0.954]]),
                                       dim=-1).repeat(N, 1)
    bs = tm.sample_bsdf(mats, torch.zeros(N, dtype=torch.int64), n, wo,
                        _uniform(N, 0))
    v = to_np(bs.valid)
    assert v.mean() > 0.9
    wi = to_np(bs.wi)[v]
    mirror = np.array([-float(wo[0, 0]), 0.0, float(wo[0, 2])])
    assert np.median(wi @ mirror) > 0.9
    w = to_np(bs.f * ((bs.wi * n).sum(-1).abs()
                      / bs.pdf.clamp_min(1e-9))[:, None])[v]
    assert 0.2 < w.mean() < 1.2


def test_plastic_white_furnace_bound():
    """tests/test_breadth.py::test_plastic_white_furnace_bound."""
    mats = _one(lambda b: b.plastic(kd=(0.4,) * 3, ks=(0.3,) * 3,
                                    roughness=0.2))
    N = 30000
    n = torch.tensor([[0.0, 0.0, 1.0]]).repeat(N, 1)
    wo = n.clone()
    mi = torch.zeros(N, dtype=torch.int64)
    bs = tm.sample_bsdf(mats, mi, n, wo, _uniform(N, 1))
    v = to_np(bs.valid)
    w = to_np(bs.f * ((bs.wi * n).sum(-1).abs()
                      / bs.pdf.clamp_min(1e-9))[:, None])
    w = np.where(v[:, None], w, 0.0)
    assert 0.3 < w.mean() < 0.85, w.mean()
    f, pdf = tm.eval_bsdf(mats, mi, n, wo, bs.wi)
    assert torch.isfinite(f).all() and torch.isfinite(pdf).all()


def test_check_slice_takes_every_ported_material():
    """check_slice passes every material of the reference: the analytic
    ones, a one-level mix, hair, subsurface, kdsubsurface, the Fourier
    BSDF and a mix of mixes (read one level deep, as the reference
    reads it)."""
    from bre_tpu.fourier import lambertian_fourier_table

    b = JBuilder()
    every_material(b)
    check_slice(scene_from_jax(b.build(), device="cpu"))
    for name, make in (("hair", lambda b: b.hair()),
                       ("subsurface", lambda b: b.subsurface()),
                       ("kdsubsurface", lambda b: b.kdsubsurface()),
                       ("fourier", lambda b: b.fourier_material(
                           table=lambertian_fourier_table(n_mu=8)))):
        b = JBuilder()
        make(b)
        b.sphere((0, 0, 0), 1.0, material=0)
        check_slice(scene_from_jax(b.build(), device="cpu"))
    b = JBuilder()
    m = b.mix(b.matte(), b.glass())
    b.mix(m, b.matte())
    b.sphere((0, 0, 0), 1.0, material=0)
    check_slice(scene_from_jax(b.build(), device="cpu"))
