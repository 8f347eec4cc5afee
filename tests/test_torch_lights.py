"""The lights of bre_tpu_torch against bre_tpu, on the CPU, with no render:
each of the seven light types (the infinite light both constant and
image-mapped, the area light on a quad and on a sphere) in a table of its
own, and all of them in one table, built by both packages' SceneBuilder
and queried on 4,096 seeded lanes: ``sample_le``, ``sample_li``,
``pdf_le``, ``light_power``, ``light_choice_pmf``, ``infinite_Le_pdf``,
``escaped_radiance`` and ``spatial_light_distribution``; the env map's
row and column picks; the host-side ``Lights.kinds`` skip; and one test
for each behaviour of the reference that the port keeps on purpose
(ROADMAP Queue 3).

Tolerances and their reasons (tests/test_torch_camera_lights.py's):
- the builder: bit for bit (every light field, the atlas, the env map's
  three tables and the world bounds come from the same numpy float32
  expressions);
- the queries: rtol 1e-5, with an atol of 1e-5 x the field's largest
  magnitude for signed vectors (XLA:CPU contracts multiply-adds, torch
  does not, ROADMAP Queue 3; a coordinate near 0 keeps the absolute error
  of the others), and for the spot's radiance (its quartic falloff near
  the outer cone takes the absolute error of the cosine, not a relative
  one); ``sample_li``'s solid-angle pdf of an area light
  divides by the light's cosine, so its rtol grows by 1e-7 / |cos| at
  grazing samples, and an area light's emission pdf and the env map's
  density over sin(theta) take theirs through a square root or an arccos,
  so theirs grows by 1e-7 / cos^2 (sin^2); masks, picks and ids exact;
- the env map's picks: exact, except where a uniform lies within 1e-6 of
  a CDF entry (none of the seeded lanes does);
- ``spatial_light_distribution``: rtol 1e-4, a mean of 32 |Li|/pdf
  samples per voxel each within the queries' tolerance;
- the ``kinds`` skip: bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bre_tpu import lights as jl
from bre_tpu.integrators import bdpt as jbdpt
from bre_tpu.integrators import spectral as jspec
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu_torch import lights as tl
from bre_tpu_torch.integrators import bdpt as tbdpt
from bre_tpu_torch.integrators import spectral as tspec
from bre_tpu_torch.scene.builder import SceneBuilder
from bre_tpu_torch.scene.scene import (LIGHT_INFINITE, N_LIGHT_TAGS,
                                       check_slice, scene_from_jax)
from test_torch_parser import assert_scenes_equal
from torch_parity import LIGHT_KINDS, light_images, lights_scene, to_np

R = 4096
CASES = [(k,) for k in LIGHT_KINDS] + [LIGHT_KINDS]
IDS = list(LIGHT_KINDS) + ["mixed"]


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def scenes(request):
    return (lights_scene(SceneBuilder(), request.param, device="cpu"),
            lights_scene(JBuilder(), request.param))


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a, dtype=None):
    return jnp.asarray(a, dtype)


def _close(a, b, what, signed=False, rtol=1e-5):
    a, b = to_np(a).astype(np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    atol = 1e-5 * np.abs(b).max() if signed else 0.0
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


def _close_grazing(a, b, c, what):
    """rtol 1e-5 + 1e-7 / c^2: a density over a cosine or a sin(theta) c
    that the sample computed through a square root or an arccos."""
    a, b = to_np(a).astype(np.float64), np.asarray(b, np.float64)
    bad = np.abs(a - b) > (1e-5 + 1e-7 / np.maximum(c, 1e-12) ** 2) \
        * np.abs(b)
    assert not bad.any(), (what, a[bad], b[bad], c[bad])


def _lanes(scene, seed):
    rs = np.random.RandomState(seed)
    li = rs.randint(0, scene.n_lights, R)
    u1 = rs.rand(R, 2).astype(np.float32)
    u2 = rs.rand(R, 2).astype(np.float32)
    p = rs.uniform([-0.9, -0.9, 0.1], [0.9, 0.9, 1.9], (R, 3)).astype(
        np.float32)
    w = rs.normal(size=(R, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    return li, u1, u2, p, w


def test_builder_matches_reference(scenes):
    """Every light field, the light atlas, the env map's func and CDFs and
    the world bounds bit for bit scene_from_jax of bre_tpu's build."""
    ts, js = scenes
    assert_scenes_equal(ts, scene_from_jax(js, device="cpu"))
    check_slice(ts)
    L = ts.lights
    held = set(to_np(L.ltype).tolist())
    assert [bool(k) for k in L.kinds] == [t in held for t in range(
        N_LIGHT_TAGS)]
    if (L.img_off >= 0).any() and (L.ltype == LIGHT_INFINITE).any():
        assert L.env_func.shape == (16, 32) and int(L.env_light) >= 0


def test_queries_match_reference(scenes):
    """sample_le, sample_li, pdf_le, light_power, light_choice_pmf,
    infinite_Le_pdf and escaped_radiance on 4,096 seeded lanes."""
    ts, js = scenes
    li, u1, u2, p, w = _lanes(ts, 11)
    lij = _j(li, jnp.int32)
    _close(tl.light_power(ts), jl.light_power(js), "light_power")
    _close(tl.light_choice_pmf(ts), jl.light_choice_pmf(js), "pmf")

    le_t = tl.sample_le(ts, _t(li), _t(u1), _t(u2))
    le_j = jl.sample_le(js, lij, _j(u1), _j(u2))
    for name in ("o", "d", "n_light", "Le", "pdf_pos"):
        _close(getattr(le_t, name), getattr(le_j, name), f"sample_le.{name}",
               signed=name in ("o", "d", "n_light", "Le"))
    cos_e = np.abs((np.asarray(le_j.n_light) * np.asarray(le_j.d)).sum(-1))
    _close_grazing(le_t.pdf_dir, le_j.pdf_dir, cos_e, "sample_le.pdf_dir")
    np.testing.assert_array_equal(to_np(le_t.medium), np.asarray(le_j.medium))

    ls_t = tl.sample_li(ts, _t(li), _t(p), _t(u1))
    ls_j = jl.sample_li(js, lij, _j(p), _j(u1))
    for name in ("wi", "Li", "dist", "p_light", "n_light"):
        _close(getattr(ls_t, name), getattr(ls_j, name), f"sample_li.{name}",
               signed=name in ("wi", "Li", "p_light", "n_light"))
    cos = np.abs((to_np(ls_t.n_light) * to_np(ls_t.wi)).sum(-1))
    pdf_t, pdf_j = to_np(ls_t.pdf), np.asarray(ls_j.pdf)
    assert (np.abs(pdf_t - pdf_j)
            <= (1e-5 + 1e-7 / np.maximum(cos, 1e-12)) * np.abs(pdf_j)).all()

    # pdf_le at the sampled emission and at arbitrary directions
    w[::2] = np.asarray(le_j.d)[::2]
    n = np.asarray(le_j.n_light)
    for got, want, name in zip(
            tl.pdf_le(ts, _t(li), _t(n), _t(w)),
            jl.pdf_le(js, lij, _j(n), _j(w)), ("pdf_pos", "pdf_dir")):
        _close(got, want, f"pdf_le.{name}")
    Le_t, pdf_t = tl.infinite_Le_pdf(ts, _t(li), _t(w))
    Le_j, pdf_j = jl.infinite_Le_pdf(js, lij, _j(w))
    _close(Le_t, Le_j, "infinite_Le_pdf.Le")
    _, theta = jl._dir_to_equirect_uv(js.lights, lij, _j(w))
    _close_grazing(pdf_t, pdf_j, np.sin(np.asarray(theta)),
                   "infinite_Le_pdf.pdf")
    esc_t = tl.escaped_radiance(ts, _t(w))
    esc_j = jl.escaped_radiance(js, _j(w))
    _close(esc_t, esc_j, "escaped_radiance")
    if (ts.lights.ltype == LIGHT_INFINITE).any():
        assert np.asarray(esc_j).max() > 0


def test_env_picks_match_reference():
    """The env map's row and column picks (searchsorted side="right" - 1 on
    the marginal CDF and each lane's conditional row) equal the reference's
    expressions (lights.py:513-520) on its tables."""
    ts = lights_scene(SceneBuilder(), ("envmap",), device="cpu")
    js = lights_scene(JBuilder(), ("envmap",))
    rs = np.random.RandomState(12)
    u = rs.rand(R, 2).astype(np.float32)
    He, We = ts.lights.env_func.shape
    marg, cond = js.lights.env_marg_cdf, js.lights.env_cond_cdf
    row_j = jnp.clip(jnp.searchsorted(marg, _j(u[:, 1]), side="right") - 1,
                     0, He - 1)
    cond_r = cond[row_j]
    col_j = jnp.clip(jnp.stack([jnp.searchsorted(cr, uu, side="right")
                                for cr, uu in zip(cond_r, _j(u[:, 0]))]) - 1,
                     0, We - 1)
    row, col, _ = tl._env_pick(ts.lights, _t(u))
    near = (np.abs(u[:, 1:2] - np.asarray(marg)[None]).min(-1) < 1e-6) | (
        np.abs(u[:, 0:1] - np.asarray(cond_r)).min(-1) < 1e-6)
    np.testing.assert_array_equal(to_np(row)[~near], np.asarray(row_j)[~near])
    np.testing.assert_array_equal(to_np(col)[~near], np.asarray(col_j)[~near])
    assert len(np.unique(to_np(row))) > He // 2


def test_spatial_light_distribution_matches_reference():
    ts = lights_scene(SceneBuilder(), device="cpu")
    js = lights_scene(JBuilder())
    got = tl.spatial_light_distribution(ts, res=6, samples_per_voxel=8)
    want = jl.spatial_light_distribution(js, res=6, samples_per_voxel=8)
    _close(got.pmf, want.pmf, "pmf", rtol=1e-4)
    _close(got.cdf, want.cdf, "cdf", rtol=1e-4)
    assert (np.asarray(want.pmf) < 0.9).all()


def _every_kind(scene):
    L = scene.lights
    return scene._replace(lights=L._replace(
        kinds=torch.ones_like(L.kinds)))


def test_kinds_skip_changes_no_bits():
    """Without a light type its branches are skipped; computing them
    anyway changes no bit of the queries or of a render (volpath with MIS,
    the photon-beam render)."""
    from bre_tpu_torch.core import transform as tfm
    from bre_tpu_torch.integrators import photonbeam as tpb
    from bre_tpu_torch.integrators import volpath as tvp
    from bre_tpu_torch.scene.camera import make_perspective_camera
    from torch_parity import cornell_fog

    skip = cornell_fog(SceneBuilder(), point_light=True, device="cpu")
    full = _every_kind(skip)
    assert int(skip.lights.kinds.sum()) == 2
    li, u1, u2, p, w = _lanes(skip, 13)
    for fn, args in ((tl.sample_le, (_t(li), _t(u1), _t(u2))),
                     (tl.sample_li, (_t(li), _t(p), _t(u1))),
                     (tl.pdf_le, (_t(li), _t(w), _t(-w))),
                     (tl.escaped_radiance, (_t(w),))):
        for a, b in zip(fn(skip, *args), fn(full, *args)):
            assert torch.equal(a, b), fn.__name__
    W = 8
    cam = make_perspective_camera(tfm.look_at((0, 0, -2.2), (0, 0, 1),
                                              (0, 1, 0)), 50.0, W, W,
                                  device="cpu")
    cfg = tvp.VolPathConfig(maxdepth=3, spp=2, nee_mis=True,
                            lightsamplestrategy="power")
    a, b = (tvp.render_volpath(s, cam, W, W, cfg) for s in (skip, full))
    assert float(a.mean()) > 0 and torch.equal(a, b)
    pcfg = tpb.PhotonBeamConfig(iterations=1, photonsperiteration=500,
                                maxdepth=3, initialbeamradius=0.15)
    a, b = (tpb.render_photonbeam(s, cam, W, W, pcfg)[0] for s in (skip,
                                                                  full))
    assert float(a.mean()) > 0 and torch.equal(a, b)


# ---- the reference's own behaviour, kept on purpose (ROADMAP Queue 3) ----

def _two_env_maps(b, **build_kw):
    env, _, _ = light_images(0)
    b.infinite_light((0.3, 0.4, 0.5), image=env[::-1].copy())
    b.infinite_light((0.8, 0.8, 0.8), image=env)
    b.triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), material=b.matte())
    return b.build(**build_kw)


def test_one_env_map_per_scene():
    """The last image-mapped infinite light is the env map; an earlier one
    emits its constant L along escaped rays and sample_li samples it
    uniformly over the sphere, as the reference does."""
    ts = _two_env_maps(SceneBuilder(), device="cpu")
    js = _two_env_maps(JBuilder())
    assert int(ts.lights.env_light) == 1
    w = np.random.RandomState(14).normal(size=(64, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    _close(tl.escaped_radiance(ts, _t(w)), jl.escaped_radiance(js, _j(w)),
           "escaped_radiance")
    env_only = tl.escaped_radiance(ts._replace(lights=ts.lights._replace(
        emit=ts.lights.emit * torch.tensor([[0.0], [1.0]]))), _t(w))
    np.testing.assert_allclose(
        to_np(tl.escaped_radiance(ts, _t(w)) - env_only),
        np.broadcast_to([0.3, 0.4, 0.5], (64, 3)), rtol=1e-5, atol=1e-6)
    li = np.zeros(64, np.int64)
    u = np.random.RandomState(15).rand(64, 2).astype(np.float32)
    p = np.zeros((64, 3), np.float32)
    ls = tl.sample_li(ts, _t(li), _t(p), _t(u))
    assert (to_np(ls.pdf) == np.float32(1.0 / (4.0 * np.pi))).all()
    np.testing.assert_array_equal(to_np(ls.Li),
                                  np.broadcast_to(to_np(ts.lights.emit[0]),
                                                  (64, 3)))
    _close(ls.wi, jl.sample_li(js, _j(li, jnp.int32), _j(p), _j(u)).wi,
           "wi", signed=True)


def test_env_map_has_two_pdfs():
    """sample_li takes the env map's pdf at the searchsorted row and column
    of its sample; infinite_Le_pdf at the floor of the direction's
    equirect uv.  They agree inside a cell; a sample on a cell's edge (a
    uniform equal to a CDF entry) comes back through its direction on
    either side of the edge, and then the two differ, in both packages."""
    ts = lights_scene(SceneBuilder(), ("envmap",), device="cpu")
    js = lights_scene(JBuilder(), ("envmap",))
    rs = np.random.RandomState(16)
    u = rs.rand(R, 2).astype(np.float32)
    He, We = ts.lights.env_func.shape
    row, _, cond_r = tl._env_pick(ts.lights, _t(u))
    edge = np.arange(R) % 2 == 0  # on the edge of a column
    k = rs.randint(1, We, R)
    u[edge, 0] = to_np(cond_r)[np.arange(R), k][edge]
    li = np.zeros(R, np.int64)
    p = np.zeros((R, 3), np.float32)
    ls = tl.sample_li(ts, _t(li), _t(p), _t(u))
    _, pdf_t = tl.infinite_Le_pdf(ts, _t(li), ls.wi)
    ls_j = jl.sample_li(js, _j(li, jnp.int32), _j(p), _j(u))
    _, pdf_j = jl.infinite_Le_pdf(js, _j(li, jnp.int32), ls_j.wi)
    for a, b in ((ls.pdf, pdf_t), (ls_j.pdf, pdf_j)):
        differ = ~np.isclose(to_np(a), to_np(b), rtol=1e-3)
        assert differ[~edge].mean() < 0.01 and differ[edge].sum() > 10


def test_bdpt_env_map_origin_density_is_uniform():
    """BDPT's origin density of an escaped camera ray's light vertex is the
    infinite lights' pick mass over 4 pi, even for an env map
    (bdpt.py:550)."""
    K = ("point", "distant", "envmap", "infinite")
    ts = lights_scene(SceneBuilder(), K, device="cpu")
    js = lights_scene(JBuilder(), K)
    pmf_t, pmf_j = tl.light_choice_pmf(ts), jl.light_choice_pmf(js)
    n = 16
    p = np.random.RandomState(17).normal(size=(n, 3)).astype(np.float32)
    nxt = np.zeros((n, 3), np.float32)
    v_t = tbdpt._empty_vertex(n, torch.device("cpu"))._replace(
        p=_t(p), light_idx=torch.full((n,), -2))
    v_j = jbdpt._empty_vertex(n)._replace(
        p=_j(p), light_idx=jnp.full((n,), -2, jnp.int32))
    got = to_np(tbdpt._pdf_light_origin(ts, v_t, _t(nxt), pmf_t))
    want = np.asarray(jbdpt._pdf_light_origin(js, v_j, _j(nxt), pmf_j))
    inf = to_np(ts.lights.ltype) == LIGHT_INFINITE
    np.testing.assert_allclose(got, to_np(pmf_t)[inf].sum() / (4 * np.pi),
                               rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_goniometric_and_projection_emit_on_the_whole_sphere():
    """Both sample their emission directions uniformly over the sphere
    (pdf_dir 1/(4 pi)), not in pbrt's cone; the projection light's Le is 0
    outside its frustum."""
    ts = lights_scene(SceneBuilder(), ("goniometric", "projection"),
                      device="cpu")
    rs = np.random.RandomState(18)
    for li in (0, 1):
        le = tl.sample_le(ts, torch.full((R,), li),
                          _t(rs.rand(R, 2).astype(np.float32)),
                          _t(rs.rand(R, 2).astype(np.float32)))
        assert (to_np(le.pdf_dir) == np.float32(1.0 / (4.0 * np.pi))).all()
        axis = np.array([0.0, 0.0, 1.0]) if li == 0 else to_np(
            ts.lights.direction[1])
        along = to_np(le.d) @ axis
        assert (along < -0.5).mean() > 0.2 and (along > 0.5).mean() > 0.2
        if li == 1:
            dark = (to_np(le.Le) == 0).all(-1)
            assert dark[along < 0].all() and not dark.all()


def test_projection_keeps_cos_half_fov_in_a_spot_field():
    """The projection light keeps cos(fov/2) in cos_falloff_start and its
    frustum's corner cone in cos_total_width (builder.py:886-894)."""
    ts = lights_scene(SceneBuilder(), ("projection",), device="cpu")
    half = np.deg2rad(40.0) * 0.5
    assert float(ts.lights.cos_falloff_start[0]) == np.float32(np.cos(half))
    assert float(ts.lights.cos_total_width[0]) == np.float32(
        np.cos(np.arctan(np.tan(half) * np.sqrt(2.0))))


def test_spectral_mode_leaves_the_light_atlas_rgb():
    """slice_scene lifts each light's L and image mean to the slice's
    wavelengths and leaves the light atlas and the env map's tables RGB, as
    the reference does."""
    ts = lights_scene(SceneBuilder(), ("envmap", "goniometric"),
                      device="cpu")
    js = lights_scene(JBuilder(), ("envmap", "goniometric"))
    for k in (0, 7, 19):
        got, want = tspec.slice_scene(ts, k).lights, jspec.slice_scene(
            js, k).lights
        for name in ("atlas", "env_func", "env_marg_cdf", "env_cond_cdf"):
            assert torch.equal(getattr(got, name), getattr(ts.lights, name))
            np.testing.assert_array_equal(to_np(getattr(got, name)),
                                          np.asarray(getattr(want, name)))
        _close(got.img_mean, want.img_mean, "img_mean")
        _close(got.emit, want.emit, "emit")
        assert not torch.equal(got.img_mean, ts.lights.img_mean)
