"""The light, camera and medium queries of bidirectional path tracing in
bre_tpu_torch against bre_tpu, on the CPU, on the same seeded inputs:
the perspective camera's importance (``pdf_we``, ``sample_wi``), the
power pick's pmf, ``pdf_le``, sphere area lights (``sample_li``,
``sample_le``, ``light_power``, the builder), ``sample_medium(u12=)`` on
homogeneous and grid media, and ``camera_jitter`` with a per-lane sample
index.

Tolerances and their reasons:
- ``pdf_we`` and ``sample_wi``: rtol 2e-5.  Both packages invert the
  camera's matrices in float32 on every call, LAPACK there and XLA:CPU
  here, which round differently; the importance is 1/(A cos^4), so a few
  ulps of the direction become a few ulps to the fourth.  The inside
  masks agree except within 1e-3 pixel of the film's edge.
- Light queries: rtol 1e-5 (XLA:CPU contracts multiply-adds, torch does
  not; ROADMAP Queue 3); ``sample_li``'s solid-angle pdf 3e-5, as it
  divides by the light's cosine, which grazing samples make small; picks
  and masks exact.
- ``sample_medium``: the sampled flags exact, t and the weights rtol 1e-5,
  the PCG32 states exact.
- ``camera_jitter``: bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bre_tpu import lights as jl
from bre_tpu import media as jmedia
from bre_tpu.core import rng as jrng
from bre_tpu.core import samplers as jsamp
from bre_tpu.core import transform as jtfm
from bre_tpu.scene import camera as jcam
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu_torch import lights as tl
from bre_tpu_torch import media as tmedia
from bre_tpu_torch.core import rng as trng
from bre_tpu_torch.core import samplers as tsamp
from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.core import spectrum as tspec
from bre_tpu_torch.scene import camera as tcam
from bre_tpu_torch.scene.builder import SceneBuilder
from bre_tpu_torch.scene.scene import scene_from_jax
from torch_parity import SMOKE_W2M, leaves, pcg_state, smoke_density, to_np

LOOK = ((0.3, 0.5, -3.4), (0.0, 0.4, 0.0), (0, 1, 0))
W, H = 24, 16


def _cameras():
    return (tcam.make_perspective_camera(ttfm.look_at(*LOOK), 50.0, W, H,
                                         device="cpu"),
            jcam.make_perspective_camera(jtfm.look_at(*LOOK), 50.0, W, H))


def _lights_scene(b, **build_kw):
    """A point light, a two-sided triangle light, a one-sided sphere light
    and a two-sided sphere light in a medium, over a matte floor."""
    fog = b.homogeneous_medium((0.05,) * 3, (0.3,) * 3, 0.2)
    m = b.matte((0.6, 0.5, 0.4))
    b.quad((-3, -1, -3), (-3, -1, 3), (3, -1, 3), (3, -1, -3), material=m)
    b.point_light((0.5, 1.5, 0.0), (2.0, 1.5, 1.0))
    b.area_light_quad((-0.5, 1.9, -0.5), (-0.5, 1.9, 0.5), (0.5, 1.9, 0.5),
                      (0.5, 1.9, -0.5), (3.0, 3.0, 2.5), two_sided=True)
    b.area_light_sphere((-1.0, 0.2, 0.5), 0.3, (1.0, 2.0, 4.0), material=m)
    b.area_light_sphere((1.2, 0.0, -0.4), 0.45, (0.5, 0.5, 0.5), material=m,
                        two_sided=True, medium=fog, medium_inside=fog)
    return b.build(**build_kw)


@pytest.fixture(scope="module")
def scenes():
    js = _lights_scene(JBuilder())
    return _lights_scene(SceneBuilder(), device="cpu"), js


def test_sphere_area_light_builds_as_reference(scenes):
    ts, js = scenes
    ref = scene_from_jax(js, device="cpu")
    for part in ("spheres", "lights", "materials", "media"):
        for (name, a), (_, b) in zip(leaves(getattr(ts, part)),
                                     leaves(getattr(ref, part))):
            np.testing.assert_array_equal(to_np(a), to_np(b),
                                          err_msg=f"{part}.{name}")
    np.testing.assert_array_equal(to_np(ts.world_min), to_np(ref.world_min))
    np.testing.assert_array_equal(to_np(ts.world_max), to_np(ref.world_max))


def _dirs(rs, n):
    """Directions about the camera's axis, some outside the film."""
    cam_t, _ = _cameras()
    axis = to_np(cam_t.camera_to_world)[:3, 2]
    d = axis + rs.normal(0, 0.45, (n, 3))
    d[:8] = -axis + rs.normal(0, 0.1, (8, 3))  # behind the camera
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _inside_safe(cam_j, d):
    """Directions whose raster point lies 1e-3 pixel or more inside or
    outside the film window (an edge can flip with the inverse's ulps)."""
    w2c = np.linalg.inv(np.asarray(cam_j.camera_to_world, np.float64))
    dc = d @ w2c[:3, :3].T
    ok = dc[:, 2] > 1e-6
    pf = dc / np.where(ok, dc[:, 2], 1.0)[:, None]
    c2r = np.linalg.inv(np.asarray(cam_j.raster_to_camera, np.float64))
    pr = pf @ c2r[:3, :3].T + c2r[:3, 3]
    edge = np.minimum.reduce([np.abs(pr[:, 0]), np.abs(pr[:, 0] - W),
                              np.abs(pr[:, 1]), np.abs(pr[:, 1] - H)])
    return edge > 1e-3


def test_film_area_and_camera_position():
    cam_t, cam_j = _cameras()
    np.testing.assert_allclose(
        to_np(tcam._film_area_z1(cam_t, W, H)),
        np.asarray(jcam._film_area_z1(cam_j, W, H)), rtol=1e-6)
    np.testing.assert_array_equal(to_np(tcam.camera_position(cam_t)),
                                  np.asarray(jcam.camera_position(cam_j)))


def test_pdf_we_matches_jax():
    rs = np.random.RandomState(3)
    cam_t, cam_j = _cameras()
    d = _dirs(rs, 512)
    pos_t, dir_t = tcam.pdf_we(cam_t, W, H, torch.from_numpy(d))
    pos_j, dir_j = jcam.pdf_we(cam_j, W, H, jnp.asarray(d))
    safe = _inside_safe(cam_j, d)
    assert safe.mean() > 0.99 and (np.asarray(pos_j) > 0).sum() > 100
    np.testing.assert_array_equal(to_np(pos_t)[safe], np.asarray(pos_j)[safe])
    np.testing.assert_allclose(to_np(dir_t)[safe], np.asarray(dir_j)[safe],
                               rtol=2e-5)


def test_sample_wi_matches_jax():
    rs = np.random.RandomState(4)
    cam_t, cam_j = _cameras()
    o = np.asarray(LOOK[0], np.float32)
    d = _dirs(rs, 512)
    p = (o + d * rs.uniform(0.5, 6.0, (512, 1))).astype(np.float32)
    out_t = tcam.sample_wi(cam_t, W, H, torch.from_numpy(p))
    out_j = jcam.sample_wi(cam_j, W, H, jnp.asarray(p))
    safe = _inside_safe(cam_j, -np.asarray(out_j[0]))
    assert safe.mean() > 0.99
    for name, a, b in zip(("wi", "pdf", "We", "p_raster", "dist"), out_t,
                          out_j):
        a, b = to_np(a)[safe], np.asarray(b)[safe]
        if name in ("wi", "p_raster"):  # signed: compare against the scale
            np.testing.assert_allclose(a, b, rtol=2e-5,
                                       atol=2e-5 * np.abs(b).max(),
                                       err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=2e-5, err_msg=name)


def test_light_choice_pmf_and_power(scenes):
    ts, js = scenes
    np.testing.assert_allclose(to_np(tl.light_power(ts)),
                               np.asarray(jl.light_power(js)), rtol=1e-6)
    np.testing.assert_allclose(to_np(tl.light_choice_pmf(ts)),
                               np.asarray(jl.light_choice_pmf(js)), rtol=1e-6)
    np.testing.assert_allclose(
        to_np(tl.light_shape_area(ts, torch.arange(ts.n_lights))),
        np.asarray(jl.light_shape_area(js, jnp.arange(js.n_lights))),
        rtol=1e-6)


def _li_inputs(ts, rs, n=600):
    li = rs.randint(0, ts.n_lights, n)
    u = rs.rand(n, 2).astype(np.float32)
    u2 = rs.rand(n, 2).astype(np.float32)
    p = rs.uniform(-2, 2, (n, 3)).astype(np.float32)
    return li, u, u2, p


def test_pdf_le_matches_jax(scenes):
    ts, js = scenes
    rs = np.random.RandomState(5)
    li, u, u2, _ = _li_inputs(ts, rs)
    ls = jl.sample_le(js, jnp.asarray(li, jnp.int32), jnp.asarray(u),
                      jnp.asarray(u2))
    n = np.array(ls.n_light)
    w = rs.normal(size=n.shape).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    w[::3] = np.asarray(ls.d)[::3]  # the sampled directions too
    pos_t, dir_t = tl.pdf_le(ts, torch.from_numpy(li), torch.from_numpy(n),
                             torch.from_numpy(w))
    pos_j, dir_j = jl.pdf_le(js, jnp.asarray(li, jnp.int32), jnp.asarray(n),
                             jnp.asarray(w))
    np.testing.assert_allclose(to_np(pos_t), np.asarray(pos_j), rtol=1e-6)
    np.testing.assert_allclose(to_np(dir_t), np.asarray(dir_j), rtol=1e-5,
                               atol=1e-7)
    assert (np.asarray(dir_j) == 0).any() and (np.asarray(dir_j) > 0).any()


def test_sample_le_and_sample_li_match_jax(scenes):
    ts, js = scenes
    rs = np.random.RandomState(6)
    li, u, u2, p = _li_inputs(ts, rs)
    assert (li >= 2).sum() > 100  # the sphere lights
    lt = tl.sample_le(ts, torch.from_numpy(li), torch.from_numpy(u),
                      torch.from_numpy(u2))
    lj = jl.sample_le(js, jnp.asarray(li, jnp.int32), jnp.asarray(u),
                      jnp.asarray(u2))
    for name, a, b in zip(lt._fields, lt, lj):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    st = tl.sample_li(ts, torch.from_numpy(li), torch.from_numpy(p),
                      torch.from_numpy(u))
    sj = jl.sample_li(js, jnp.asarray(li, jnp.int32), jnp.asarray(p),
                      jnp.asarray(u))
    assert st._fields == sj._fields
    for name, a, b in zip(st._fields, st, sj):
        np.testing.assert_allclose(to_np(a), np.asarray(b),
                                   rtol=3e-5 if name == "pdf" else 1e-5,
                                   atol=1e-6, err_msg=name)


def _medium_scene(b, grid, **build_kw):
    if grid:
        med = b.grid_medium(smoke_density(16), SMOKE_W2M, sigma_a=(0.02,) * 3,
                            sigma_s=(0.9,) * 3, g=0.3)
    else:
        med = b.homogeneous_medium((0.1, 0.2, 0.3), (0.6, 0.5, 0.4), 0.2)
    b.box((-1, -1, -1), (1, 1, 1), material=-1, medium_inside=med,
          medium_outside=-1)
    b.point_light((0, 0, 0), (1, 1, 1), medium=med)
    return b.build(**build_kw)


@pytest.mark.parametrize("grid", [False, True])
def test_sample_medium_u12_matches_jax(grid):
    ts = _medium_scene(SceneBuilder(), grid, device="cpu")
    js = _medium_scene(JBuilder(), grid)
    rs = np.random.RandomState(7)
    n = 256
    o = rs.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = rs.uniform(0.2, 3.0, n).astype(np.float32)
    med = np.where(rs.rand(n) < 0.8, 0, -1)
    u12 = rs.rand(n, 2).astype(np.float32)
    seq = np.arange(n) + 17
    rng_t, ms_t, _ = tmedia.sample_medium(
        ts.media, torch.from_numpy(med), torch.from_numpy(o),
        torch.from_numpy(d), torch.from_numpy(t_max),
        trng.pcg32_init(torch.from_numpy(seq)), u12=torch.from_numpy(u12),
        early_exit=False)
    rng_j, ms_j, _ = jmedia.sample_medium(
        js.media, jnp.asarray(med, jnp.int32), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t_max), jrng.pcg32_init(jnp.asarray(seq, jnp.uint32)),
        u12=jnp.asarray(u12))
    np.testing.assert_array_equal(to_np(ms_t.sampled), np.asarray(ms_j.sampled))
    assert to_np(ms_t.sampled).any() and not to_np(ms_t.sampled).all()
    np.testing.assert_allclose(to_np(ms_t.t), np.asarray(ms_j.t), rtol=1e-5)
    np.testing.assert_allclose(to_np(ms_t.weight), np.asarray(ms_j.weight),
                               rtol=1e-5)
    # no draw without a grid; the tracking's fixed 2 x 256 draws with one
    np.testing.assert_array_equal(to_np(rng_t.state), pcg_state(rng_j))
    fresh = trng.pcg32_init(torch.from_numpy(seq))
    moved = not np.array_equal(to_np(rng_t.state), to_np(fresh.state))
    assert moved == grid


@pytest.mark.parametrize("sampler", tsamp.KINDS)
def test_camera_jitter_per_lane_index_bit_for_bit(sampler):
    """A per-lane index equal to the int gives the int form's bits, and
    a batch of two samples gives each sample's own pass."""
    R, spp = 96, 16
    pix = torch.arange(R, dtype=torch.int64)
    seq = lambda s: (s * R + pix + 0xB0D7) & 0xFFFFFFFF  # noqa: E731
    for s in (0, 5, 15):
        r_int, j_int = tsamp.camera_jitter(sampler, pix, s, spp,
                                           trng.pcg32_init(seq(s)))
        r_lane, j_lane = tsamp.camera_jitter(
            sampler, pix, torch.full((R,), s, dtype=torch.int64), spp,
            trng.pcg32_init(seq(s)))
        assert torch.equal(j_int, j_lane) and torch.equal(r_int.state,
                                                          r_lane.state)
        _, j_ref = jsamp.camera_jitter(
            sampler, jnp.arange(R, dtype=jnp.uint32), s, spp,
            jrng.pcg32_init(jnp.asarray(to_np(seq(s)), jnp.uint32)))
        np.testing.assert_array_equal(to_np(j_int), np.asarray(j_ref))
    two = torch.tensor([3, 9]).repeat_interleave(R)
    lanes = pix.repeat(2)
    _, j2 = tsamp.camera_jitter(
        sampler, lanes, two, spp,
        trng.pcg32_init((two * R + lanes + 0xB0D7) & 0xFFFFFFFF))
    for k, s in enumerate((3, 9)):
        _, j1 = tsamp.camera_jitter(sampler, pix, s, spp,
                                    trng.pcg32_init(seq(s)))
        assert torch.equal(j2[k * R:(k + 1) * R], j1)


def test_spectrum_helpers_match_jax():
    from bre_tpu.core import spectrum as jspec

    rs = np.random.RandomState(8)
    x = rs.uniform(-1, 2, (64, 3)).astype(np.float32)
    x[::4] = 0.0
    np.testing.assert_array_equal(to_np(tspec.is_black(torch.from_numpy(x))),
                                  np.asarray(jspec.is_black(jnp.asarray(x))))
    for f in ("rgb_to_xyz", "xyz_to_rgb"):
        np.testing.assert_allclose(
            to_np(getattr(tspec, f)(torch.from_numpy(x))),
            np.asarray(getattr(jspec, f)(jnp.asarray(x))), rtol=1e-6,
            atol=1e-6, err_msg=f)
