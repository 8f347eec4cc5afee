"""The volpath oracle in bre_tpu_torch against bre_tpu, on the CPU: ratio
tracking, transmittance and the fixed-trip delta tracking, the "random"
sampler stream, the weighted camera rays, and render_volpath in each
in-scope VolPathConfig variant; every out-of-scope setting raises.

Tolerances and their reasons:
- Tracking (``tr_grid``, ``transmittance``, fixed-trip ``sample_grid``):
  the streams bit for bit (each ends 2 x max_steps draws on, as the
  reference's scan leaves it), the decisions lane for lane, values within
  1e-6 (absolute, on transmittances and distances of magnitude <= ~3; the
  reference's XLA:CPU contracts multiply-adds, ROADMAP Queue 3).
- render_volpath at 8x8 x 4 spp: both packages run the same PCG32 streams
  and the same order of draws, so they differ only where a float-ulp
  difference flips a decision; 99% of pixels within rtol 1e-4 (atol 1e-6)
  and the image mean within 1e-4 (measured: every pixel within 2e-6).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bre_tpu import media as jmed
from bre_tpu.core import rng as jrng
from bre_tpu.core import samplers as jsamp
from bre_tpu.core import transform as jtfm
from bre_tpu.integrators import volpath as jvp
from bre_tpu.scene import camera as jcamera
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu.scene.scene import MAT_SUBSURFACE
from bre_tpu_torch import media as tmed
from bre_tpu_torch.core import rng as trng
from bre_tpu_torch.core import samplers as tsamp
from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.integrators import volpath as tvp
from bre_tpu_torch.scene import camera as tcamera
from bre_tpu_torch.scene.scene import scene_from_jax
from test_photonbeam import fog_cube_scene
from test_torch_grid_media import _draw_u32, _media_pair, _rays
from torch_parity import cornell_fog, smoke_hetero, to_np


def _seq(n):
    seq = np.arange(n, dtype=np.uint32) * 7 + 5
    return (jrng.pcg32_init(jnp.asarray(seq)),
            trng.pcg32_init(torch.from_numpy(seq.astype(np.int64))))


def _media_rays(n=2048, **kw):
    jm, tm = _media_pair(**kw)
    o, d, t_max = _rays(n)
    med = np.zeros((n,), np.int32)
    med[-200:] = -1  # vacuum lanes
    return jm, tm, o, d, t_max, med


def test_pcg32_advance_matches_stepping():
    s = trng.pcg32_init(torch.arange(64) * 3)
    for delta in (0, 1, 2, 511, 512, 1000):
        stepped = s
        for _ in range(delta):
            stepped, _ = trng.pcg32_next_u32(stepped)
        adv = trng.pcg32_advance(s, delta)
        assert torch.equal(adv.state, stepped.state), delta
        assert torch.equal(adv.inc, stepped.inc)


@pytest.mark.parametrize("max_steps", [512, 3])
def test_tr_grid_matches_jax(max_steps):
    """Ratio tracking with roulette: 512 trips (every lane ends), and 3
    trips (the overflow count reports the live lanes); a thick medium,
    so the roulette kills lanes."""
    jm, tm, o, d, t_max, med = _media_rays(sigma_s=4.0)
    sa_j, ss_j, _, _, _ = jmed.gather_medium(jm, jnp.asarray(med))
    sa_t, ss_t, _, _, _ = tmed.gather_medium(tm, torch.from_numpy(med).long())
    rj0, rt0 = _seq(o.shape[0])
    rj, tr_j, ovf_j = jmed.tr_grid(jm, sa_j, ss_j, *(jnp.asarray(x) for x in
                                                   (o, d, t_max)), rj0,
                                   max_steps)
    rt, tr_t, ovf_t = tmed.tr_grid(tm, sa_t, ss_t, *(torch.from_numpy(x) for x
                                                   in (o, d, t_max)), rt0,
                                   max_steps)
    np.testing.assert_array_equal(_draw_u32(rt, trng), _draw_u32(rj, jrng))
    tj = to_np(tr_j)
    if max_steps == 512:
        assert 0.05 < (tj == 0).mean() < 0.9  # the roulette kills lanes
        assert ((tj > 0) & (tj < 1)).any()
    np.testing.assert_array_equal(to_np(tr_t) == 0, tj == 0)
    np.testing.assert_allclose(to_np(tr_t), tj, rtol=0, atol=1e-6)
    assert int(ovf_t) == int(ovf_j)
    assert (int(ovf_j) > 0) == (max_steps == 3)


def test_transmittance_matches_jax():
    """Medium::Tr over a grid scene's table: grid lanes by ratio tracking,
    vacuum lanes 1; and a homogeneous scene (analytic, no draws)."""
    jm, tm, o, d, t_max, med = _media_rays()
    rj0, rt0 = _seq(o.shape[0])
    args_j = (jnp.asarray(med),) + tuple(jnp.asarray(x) for x in (o, d, t_max))
    args_t = (torch.from_numpy(med).long(),) + tuple(
        torch.from_numpy(x) for x in (o, d, t_max))
    rj, tr_j, ovf_j = jmed.transmittance(jm, *args_j, rj0)
    rt, tr_t, ovf_t = tmed.transmittance(tm, *args_t, rt0)
    np.testing.assert_array_equal(_draw_u32(rt, trng), _draw_u32(rj, jrng))
    np.testing.assert_allclose(to_np(tr_t), to_np(tr_j), rtol=0, atol=1e-6)
    assert (to_np(tr_t)[-200:] == 1.0).all() and int(ovf_t) == int(ovf_j) == 0
    js = fog_cube_scene(sigma_a=0.1, sigma_s=0.6).build()
    ts = scene_from_jax(js, device="cpu")
    med0 = np.where(med < 0, -1, 0).astype(np.int32)
    rj, h_j, _ = jmed.transmittance(js.media, jnp.asarray(med0), *args_j[1:],
                                    rj0)
    rt, h_t, _ = tmed.transmittance(ts.media, torch.from_numpy(med0).long(),
                                    *args_t[1:], rt0)
    np.testing.assert_allclose(to_np(h_t), to_np(h_j), rtol=1e-6, atol=1e-7)
    assert torch.equal(rt.state, rt0.state)  # homogeneous Tr draws nothing


def test_sample_grid_fixed_trip_matches_jax():
    """The fixed-trip delta tracking (early_exit=False) through
    sample_medium: the homogeneous draws, then 256 trips of two draws on
    every lane; the hit distance accumulated trip by trip."""
    jm, tm, o, d, t_max, med = _media_rays()
    rj0, rt0 = _seq(o.shape[0])
    rj, msj, ovf_j = jmed.sample_medium(
        jm, jnp.asarray(med), *(jnp.asarray(x) for x in (o, d, t_max)), rj0,
        early_exit=False)
    rt, mst, ovf_t = tmed.sample_medium(
        tm, torch.from_numpy(med).long(),
        *(torch.from_numpy(x) for x in (o, d, t_max)), rt0, early_exit=False)
    np.testing.assert_array_equal(_draw_u32(rt, trng), _draw_u32(rj, jrng))
    s_j = to_np(msj.sampled)
    assert 0.2 < s_j.mean() < 0.9
    np.testing.assert_array_equal(to_np(mst.sampled), s_j)
    np.testing.assert_allclose(to_np(mst.t), to_np(msj.t), rtol=0, atol=1e-6)
    np.testing.assert_allclose(to_np(mst.weight), to_np(msj.weight),
                               rtol=1e-6)
    assert int(ovf_t) == int(ovf_j) == 0
    # the stream ends 2 x 256 draws past the homogeneous pair
    skip = rt0
    for _ in range(2 + 512):
        skip, _ = trng.pcg32_next_u32(skip)
    assert torch.equal(rt.state, skip.state)


def test_random_sampler_stream_matches_jax():
    """make_sample_stream + stream_camera_sample + stream_1d/2d for
    "random": dims 0-4 (film, time, lens) and the next draws."""
    W, H, R = 5, 3, 15
    raw_j, raw_t = _seq(R)
    pix = np.arange(R, dtype=np.uint32)
    sj = jsamp.make_sample_stream(jsamp.make_stream_spec("random", W, H, 4),
                                  jnp.asarray(pix), jnp.asarray(pix % W),
                                  jnp.asarray(pix // W), jnp.uint32(2), raw_j)
    p = torch.from_numpy(pix.astype(np.int64))
    st = tsamp.make_sample_stream(tsamp.make_stream_spec("random", W, H, 4),
                                  p, p % W, p // W, 2, raw_t)
    sj, fj, tj, lj = jsamp.stream_camera_sample(sj)
    st, ft, tt, lt = tsamp.stream_camera_sample(st)
    sj, uj = jsamp.stream_2d(sj)
    st, ut = tsamp.stream_2d(st)
    for a, b in ((ft, fj), (tt, tj), (lt, lj), (ut, uj)):
        np.testing.assert_array_equal(to_np(a), to_np(b))
    assert int(sj.dim) == 7  # the reference's counter: 7 draws
    np.testing.assert_array_equal(_draw_u32(tsamp.stream_rng(st), trng),
                                  _draw_u32(jsamp.stream_rng(sj), jrng))


def test_generate_rays_weighted_matches_jax():
    W = 12
    look = ((0.3, 0.2, -3.0), (0, 0, 0), (0, 1, 0))
    cj = jcamera.make_perspective_camera(jtfm.look_at(*look), 45.0, W, W)
    ct = tcamera.make_perspective_camera(ttfm.look_at(*look), 45.0, W, W,
                                         device="cpu")
    rs = np.random.RandomState(0)
    p = (rs.rand(W * W, 2) * W).astype(np.float32)
    u = rs.rand(W * W, 2).astype(np.float32)
    oj, dj, wj = jcamera.generate_rays_weighted(cj, jnp.asarray(p),
                                                jnp.asarray(u))
    ot, dt, wt = tcamera.generate_rays_weighted(ct, torch.from_numpy(p),
                                                torch.from_numpy(u))
    np.testing.assert_allclose(to_np(ot), to_np(oj), atol=1e-6)
    np.testing.assert_allclose(to_np(dt), to_np(dj), atol=1e-6)
    np.testing.assert_array_equal(to_np(wt), to_np(wj))


W = 8
SCENES = {
    # the fog cube (BASELINE config 1's shape): a point light in a
    # homogeneous medium behind null boundaries
    "fog": (lambda: fog_cube_scene(sigma_a=0.05, sigma_s=0.4).build(),
            ((0, 0, -3.5), (0, 0, 0), (0, 1, 0))),
    # config 2 with an extra point light: an area light, matte walls
    "cornell": (lambda: cornell_fog(JBuilder(), point_light=True),
                ((0, 0, -2.2), (0, 0, 1), (0, 1, 0))),
    # config 3: the grid medium, tracked in the fixed-trip form
    "smoke": (lambda: smoke_hetero(JBuilder()),
              ((0, 0, -3.2), (0, 0, 0), (0, 1, 0))),
}
VARIANTS = {
    "full": {},
    "specular": dict(indirect="specular"),
    "all_lights": dict(samplealllights=True),
    "mis": dict(nee_mis=True),
    "clamp": dict(maxsampleluminance=0.05),
    "crossings0": dict(tr_crossings=0),
}
CASES = ([("cornell", v) for v in VARIANTS]
         + [("fog", "full"), ("fog", "mis"), ("smoke", "full"),
            ("smoke", "specular")])


def _render_pair(scene, variant, spp=4, maxdepth=5, **over):
    make, look = SCENES[scene]
    js = make()
    kw = dict(maxdepth=maxdepth, spp=spp, **VARIANTS[variant], **over)
    ij = jvp.render_volpath(
        js, jcamera.make_perspective_camera(jtfm.look_at(*look), 40.0, W, W),
        W, W, jvp.VolPathConfig(**kw))
    it = tvp.render_volpath(
        scene_from_jax(js, device="cpu"),
        tcamera.make_perspective_camera(ttfm.look_at(*look), 40.0, W, W,
                                        device="cpu"),
        W, W, tvp.VolPathConfig(**kw))
    return it.numpy(), np.asarray(ij)


@pytest.mark.parametrize("scene,variant", CASES)
def test_render_volpath_matches_jax(scene, variant):
    it, ij = _render_pair(scene, variant)
    assert it.shape == ij.shape == (W, W, 3)
    assert np.isfinite(it).all() and ij.mean() > 0
    assert abs(it.mean() / ij.mean() - 1.0) < 1e-4
    close = np.isclose(it, ij, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, close.mean()


@pytest.mark.parametrize("surface", [True, False])
def test_sample_all_lights_mis_matches_jax(surface):
    """UniformSampleAllLights with the two-sample MIS at surface or medium
    points of the Cornell fog scene (its area light and a point light), on
    random points; through render_volpath this variant's reference graph
    takes minutes to compile, so the estimator is held directly (rtol
    1e-5: the same draws, the last ulps of XLA's contracted products)."""
    from bre_tpu.integrators import common as jcom
    from bre_tpu_torch.integrators import common as tcom

    js = cornell_fog(JBuilder(), point_light=True)
    ts = scene_from_jax(js, device="cpu")
    R = 256
    rs = np.random.RandomState(3)
    if surface:  # points on the floor, normal up
        p = np.stack([rs.uniform(-0.9, 0.9, R), np.full(R, -1.0 + 1e-3),
                      rs.uniform(0.1, 1.9, R)], -1).astype(np.float32)
        n = np.tile(np.float32([0, 1, 0]), (R, 1))
        mat = np.zeros(R, np.int32)
    else:  # points in the fog
        p = rs.uniform([-0.9, -0.9, 0.1], [0.9, 0.9, 1.9],
                       (R, 3)).astype(np.float32)
        n = np.zeros((R, 3), np.float32)
        mat = np.full(R, -1, np.int32)
    wo = rs.normal(size=(R, 3)).astype(np.float32)
    wo[:, 1] = np.abs(wo[:, 1])
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    med = np.zeros(R, np.int32)
    is_s = np.full(R, surface)
    rj0, rt0 = _seq(R)
    rj, Lj = jcom.sample_all_lights(
        js, rj0, *(jnp.asarray(x) for x in (p, n, wo, mat, med, is_s)),
        tr_crossings=2, mis=True)
    rt, Lt = tcom.sample_all_lights(
        ts, rt0, torch.from_numpy(p), torch.from_numpy(n),
        torch.from_numpy(wo), torch.from_numpy(mat).long(),
        torch.from_numpy(med).long(), torch.from_numpy(is_s), tr_crossings=2,
        mis=True)
    np.testing.assert_array_equal(_draw_u32(rt, trng), _draw_u32(rj, jrng))
    Lj = to_np(Lj)
    assert (Lj > 0).any(-1).mean() > 0.5
    np.testing.assert_allclose(to_np(Lt), Lj, rtol=1e-5, atol=1e-7)


def test_volpath_config_fields_match_jax():
    fj = [(f.name, f.default) for f in dataclasses.fields(jvp.VolPathConfig)]
    ft = [(f.name, f.default) for f in dataclasses.fields(tvp.VolPathConfig)]
    assert ft == fj


def _tiny():
    js = fog_cube_scene().build()
    cam = tcamera.make_perspective_camera(
        ttfm.look_at((0, 0, -3.5), (0, 0, 0), (0, 1, 0)), 40.0, 4, 4,
        device="cpu")
    return scene_from_jax(js, device="cpu"), cam


@pytest.mark.parametrize("over,match", [
    (dict(lightsamplestrategy="bogus"), "lightsamplestrategy"),
    (dict(lightsamplestrategy="all"), "lightsamplestrategy"),
    (dict(sampler="pmj02bn"), "sampler"),
    (dict(sampler="bogus"), "sampler"),
    (dict(indirect="bogus"), "indirect"),
])
def test_volpath_out_of_scope_raises(over, match):
    """A strategy, sampler or indirect mode the reference does not know
    raises ValueError instead of falling back.  (texture_filter=True, which
    raised before the surface-material slice, renders against bre_tpu in
    tests/test_torch_surface_volpath.py.)"""
    scene, cam = _tiny()
    with pytest.raises((NotImplementedError, ValueError), match=match):
        tvp.render_volpath(scene, cam, 4, 4, tvp.VolPathConfig(spp=1, **over))


def test_volpath_subsurface_scene_raises():
    """The reference's BSSRDF branch runs where maybe_has_bssrdf holds; the
    port renders the analytic surface materials only, and a subsurface
    material raises (ROADMAP Queue 1 item 5, breadth: materials)."""
    scene, cam = _tiny()
    m = scene.materials
    mats = m._replace(mtype=torch.tensor([MAT_SUBSURFACE]),
                      kd=torch.ones(1, 3), kd_tex=torch.tensor([-1]))
    with pytest.raises(NotImplementedError,
                       match="'subsurface'.*Queue 1 item 5: breadth"):
        tvp.render_volpath(scene._replace(materials=mats), cam, 4, 4,
                           tvp.VolPathConfig(spp=1))


def test_volpath_sample_batches_change_nothing(monkeypatch):
    """Sample passes walking together (SAMPLE_LANES) give the image of one
    pass per sample bit for bit: no lane's arithmetic depends on the batch,
    and the samples reach the film in sample order either way."""
    make, look = SCENES["smoke"]
    ts = scene_from_jax(make(), device="cpu")
    cam = tcamera.make_perspective_camera(ttfm.look_at(*look), 40.0, W, W,
                                          device="cpu")
    cfg = tvp.VolPathConfig(maxdepth=5, spp=6, nee_mis=True)
    together = tvp.render_volpath(ts, cam, W, W, cfg)
    monkeypatch.setattr(tvp, "SAMPLE_LANES", W * W * 4)  # 4 + 2 samples
    split = tvp.render_volpath(ts, cam, W, W, cfg)
    monkeypatch.setattr(tvp, "SAMPLE_LANES", 1)  # one sample per pass
    single = tvp.render_volpath(ts, cam, W, W, cfg)
    assert float(together.abs().sum()) > 0
    assert torch.equal(together, split) and torch.equal(together, single)
