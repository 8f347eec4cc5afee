"""bre_tpu_torch grid-density media vs bre_tpu: the trilinear lookup, the
medium-space ray setup, early-exit delta tracking (streams, decisions and
the re-attached distance gradient), the grid branch of ``sample_medium``,
the 16-point segment transmittance, and the scene side (``SceneBuilder.
grid_medium``, ``scene_from_jax``, ``check_slice``) — identical numpy inputs
through both packages.

Tolerances and their reasons: integer results (PCG32 streams, hit flags,
overflow counts, builder leaves) are exact.  XLA:CPU contracts the
trilinear sum and the ray transforms into multiply-adds and torch does not
(ROADMAP Queue 3), so lookups and ray terms agree to a few float32 ulps
(rtol 1e-5, atol 1e-6 near zero).  A tracking decision ``dens * inv_max >
u2`` can flip where the two sit within an ulp; the tests state the share
of lanes that must match (all of them here; under 99% would be a bug, not
rounding) and hold the distances of the matching lanes to rtol 2e-5.
Gradients: 2e-4 * max|ref|, the reference's own criterion for the
attached early-exit chain (tests/test_media.py:291)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bre_tpu import media as jmed
from bre_tpu.core import rng as jrng
from bre_tpu.integrators import photon_trace as jpt
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu_torch import media as tmed
from bre_tpu_torch.core import rng as trng
from bre_tpu_torch.core.samplers import stream_rng, stream_with_rng
from bre_tpu_torch.integrators import photon_trace as tpt
from bre_tpu_torch.scene.builder import SceneBuilder as TBuilder
from bre_tpu_torch.scene.scene import check_slice, scene_from_jax
from torch_parity import SMOKE_W2M, smoke_density, smoke_hetero, to_np


def _grid(shape=(16, 16, 16), seed=0, tie=True):
    """A smooth random density brick; with ``tie`` its maximum is held by
    two voxels, so max(density)'s gradient splits between them."""
    rs = np.random.RandomState(seed)
    d = rs.uniform(0.0, 1.0, shape).astype(np.float32)
    if tie:
        d[1, 2, 3] = d[-2, -3, -4] = 1.5
    return d


def _points(n=5000, seed=1):
    """Medium-space points inside [0,1]^3, outside it, and on the cell
    borders of the clamped base cell."""
    rs = np.random.RandomState(seed)
    p = rs.uniform(-0.2, 1.2, (n, 3)).astype(np.float32)
    p[:200] = rs.uniform(0.0, 1.0 / 32, (200, 3))  # first half cell
    p[200:400] = rs.uniform(1.0 - 1.0 / 32, 1.0, (200, 3))  # last half cell
    return p


@pytest.mark.parametrize("shape", [(16, 16, 16), (12, 10, 7)])
def test_grid_density_matches_jax(shape):
    dens = _grid(shape)
    p = _points()
    w = np.random.RandomState(2).uniform(-1, 1, p.shape[0]).astype(np.float32)
    j = jmed.grid_density(jnp.asarray(dens), jnp.asarray(p))
    t = tmed.grid_density(torch.from_numpy(dens), torch.from_numpy(p))
    assert t.dtype == torch.float32 and t.shape == (p.shape[0],)
    np.testing.assert_allclose(to_np(t), to_np(j), rtol=1e-5, atol=1e-6)
    outside = ((p < -0.5 / np.array(shape[::-1]))
               | (p > 1 + 0.5 / np.array(shape[::-1]))).any(-1)
    assert outside.any() and not to_np(t)[outside].any()
    # gradient in the density brick (the 8-corner table's scatter) and in p
    gj_d, gj_p = jax.grad(
        lambda d_, p_: jnp.sum(jmed.grid_density(d_, p_) * w), (0, 1))(
            jnp.asarray(dens), jnp.asarray(p))
    dt = torch.from_numpy(dens).requires_grad_()
    pt = torch.from_numpy(p).requires_grad_()
    gt_d, gt_p = torch.autograd.grad(
        (tmed.grid_density(dt, pt) * torch.from_numpy(w)).sum(), (dt, pt))
    for g_t, g_j in ((gt_d, gj_d), (gt_p, gj_p)):
        g_j = to_np(g_j)
        assert np.abs(g_j).max() > 0
        assert np.abs(to_np(g_t) - g_j).max() <= 2e-4 * np.abs(g_j).max()


def _rays(n=4096, seed=3, t_max=3.0):
    rs = np.random.RandomState(seed)
    o = rs.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    o[:300] = rs.uniform(-3, 3, (300, 3))  # many start outside the grid
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:50] *= 2.5  # non-unit directions: t is in units of |d|
    d[50:60] = [0.0, 0.0, 1.0]  # axis-aligned: the slab test's tiny guard
    return o, d, np.full((n,), t_max, np.float32)


def _media_pair(dens=None, sigma_a=0.1, sigma_s=1.0, **kw):
    b = JBuilder()
    b.grid_medium(_grid() if dens is None else dens, SMOKE_W2M,
                  sigma_a=(sigma_a,) * 3, sigma_s=(sigma_s,) * 3, **kw)
    b.sphere((0, 0, 0), 5.0)
    js = b.build()
    return js.media, scene_from_jax(js, device="cpu").media


def test_grid_ray_setup_matches_jax():
    jm, tm = _media_pair()
    o, d, t_max = _rays()
    j = jmed._grid_ray_setup(jm, *(jnp.asarray(x) for x in (o, d, t_max)))
    t = tmed._grid_ray_setup(tm, *(torch.from_numpy(x) for x in (o, d, t_max)))
    names = ("om", "dm", "dlen", "t0", "t1")
    for name, a, b in zip(names, t[:5], j[:5]):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    hit_t, hit_j = to_np(t[5]), to_np(j[5])
    assert 0.3 < hit_j.mean() < 1.0
    # the box test may flip only where t0 and t1 touch within rounding
    flips = hit_t != hit_j
    assert (np.abs(to_np(j[3]) - to_np(j[4]))[flips] < 1e-5).all()


def _draw_u32(s, lib):
    return to_np(lib.pcg32_next_u32(s)[1]).astype(np.int64)


def test_sample_grid_early_exit_matches_jax():
    """Same streams, same trips: the batch-wide loop draws two uniforms per
    lane per trip until no lane is live, so every lane's stream ends at
    the same position as the reference's, and decisions and distances
    agree lane by lane."""
    jm, tm = _media_pair()
    o, d, t_max = _rays()
    n = o.shape[0]
    med = np.zeros((n,), np.int32)
    sa_j, ss_j, _, _, _ = jmed.gather_medium(jm, jnp.asarray(med))
    sa_t, ss_t, _, _, _ = tmed.gather_medium(tm, torch.from_numpy(med).long())
    seq = np.arange(n, dtype=np.uint32) + 99
    rj, msj, ovf_j = jmed.sample_grid(
        jm, sa_j, ss_j, *(jnp.asarray(x) for x in (o, d, t_max)),
        jrng.pcg32_init(jnp.asarray(seq)), early_exit=True)
    rt, mst, ovf_t = tmed.sample_grid(
        tm, sa_t, ss_t, *(torch.from_numpy(x) for x in (o, d, t_max)),
        trng.pcg32_init(torch.from_numpy(seq.astype(np.int64))))
    np.testing.assert_array_equal(_draw_u32(rt, trng), _draw_u32(rj, jrng))
    s_t, s_j = to_np(mst.sampled), to_np(msj.sampled)
    assert 0.2 < s_j.mean() < 0.9
    assert (s_t == s_j).mean() == 1.0
    np.testing.assert_allclose(to_np(mst.t), to_np(msj.t), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(to_np(mst.weight), to_np(msj.weight),
                               rtol=1e-6)
    assert int(ovf_t) == int(ovf_j) == 0
    # 3 trips cut the loop short: the overflow count reports the live lanes
    _, _, ovf3_j = jmed.sample_grid(
        jm, sa_j, ss_j, *(jnp.asarray(x) for x in (o, d, t_max)),
        jrng.pcg32_init(jnp.asarray(seq)), max_steps=3, early_exit=True)
    _, _, ovf3_t = tmed.sample_grid(
        tm, sa_t, ss_t, *(torch.from_numpy(x) for x in (o, d, t_max)),
        trng.pcg32_init(torch.from_numpy(seq.astype(np.int64))), max_steps=3)
    assert int(ovf3_t) == int(ovf3_j) > 0


def test_sample_grid_gradients_match_jax():
    """The distance chain t_hit = t0 + S * inv_max / sigma_med, re-attached
    outside the loop, against jax.grad of the reference's early-exit path:
    in the extinction scale and in the density brick (through max(density),
    whose gradient splits evenly over the tied voxels)."""
    dens = _grid(tie=True)
    jm, tm = _media_pair(dens)
    o, d, t_max = _rays(n=2048, seed=5)
    n = o.shape[0]
    med = np.zeros((n,), np.int32)
    seq = np.arange(n, dtype=np.uint32) + 5

    def loss_j(scale, dd):
        m = jm._replace(sigma_a=jm.sigma_a * scale, sigma_s=jm.sigma_s * scale,
                        density=dd)
        sa, ss, _, _, _ = jmed.gather_medium(m, jnp.asarray(med))
        _, ms, _ = jmed.sample_grid(
            m, sa, ss, *(jnp.asarray(x) for x in (o, d, t_max)),
            jrng.pcg32_init(jnp.asarray(seq)), early_exit=True)
        return jnp.sum(jnp.where(ms.sampled, ms.t, 0.0)) + jnp.sum(ms.weight)

    vj, (gsj, gdj) = jax.value_and_grad(loss_j, (0, 1))(
        jnp.float32(1.0), jnp.asarray(dens))
    scale = torch.tensor(1.0, requires_grad=True)
    dd = torch.from_numpy(dens).requires_grad_()
    m = tm._replace(sigma_a=tm.sigma_a * scale, sigma_s=tm.sigma_s * scale,
                    density=dd)
    sa, ss, _, _, _ = tmed.gather_medium(m, torch.from_numpy(med).long())
    _, ms, _ = tmed.sample_grid(
        m, sa, ss, *(torch.from_numpy(x) for x in (o, d, t_max)),
        trng.pcg32_init(torch.from_numpy(seq.astype(np.int64))))
    vt = (torch.where(ms.sampled, ms.t, torch.zeros(())).sum()
          + ms.weight.sum())
    gst, gdt = torch.autograd.grad(vt, (scale, dd))
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=2e-5)
    assert abs(float(gsj)) > 1e-3
    np.testing.assert_allclose(float(gst), float(gsj), rtol=2e-4)
    gdj = to_np(gdj)
    assert np.count_nonzero(gdj) == 2  # the two tied maxima, evenly
    assert gdj[1, 2, 3] == gdj[-2, -3, -4]
    assert np.abs(to_np(gdt) - gdj).max() <= 2e-4 * np.abs(gdj).max()


def test_sample_medium_grid_branch_matches_jax():
    """Medium::Sample over a table of one homogeneous and one grid medium
    with vacuum lanes: the two homogeneous draws first, then the tracking
    on the raw streams for every lane."""
    b = JBuilder()
    b.homogeneous_medium((0.05,) * 3, (0.4,) * 3, 0.1)
    b.grid_medium(smoke_density(16), SMOKE_W2M, sigma_a=(0.02,) * 3,
                  sigma_s=(0.6,) * 3, g=0.4)
    b.sphere((0, 0, 0), 5.0)
    js = b.build()
    jm, tm = js.media, scene_from_jax(js, device="cpu").media
    o, d, t_max = _rays(n=3000, seed=7)
    med = np.random.RandomState(8).randint(-1, 2, o.shape[0]).astype(np.int32)
    seq = np.arange(o.shape[0], dtype=np.uint32) * 3 + 1
    rj, msj, ovf_j = jmed.sample_medium(
        jm, jnp.asarray(med), *(jnp.asarray(x) for x in (o, d, t_max)),
        jrng.pcg32_init(jnp.asarray(seq)), early_exit=True)
    rt, mst, ovf_t = tmed.sample_medium(
        tm, torch.from_numpy(med).long(),
        *(torch.from_numpy(x) for x in (o, d, t_max)),
        trng.pcg32_init(torch.from_numpy(seq.astype(np.int64))))
    np.testing.assert_array_equal(_draw_u32(rt, trng), _draw_u32(rj, jrng))
    s_t, s_j = to_np(mst.sampled), to_np(msj.sampled)
    for m in (-1, 0, 1):  # vacuum, homogeneous, grid lanes
        sel = med == m
        assert (s_t[sel] == s_j[sel]).mean() == 1.0, m
    assert s_j[med == 1].any() and s_j[med == 0].any() and not s_j[med == -1].any()
    np.testing.assert_allclose(to_np(mst.t), to_np(msj.t), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(to_np(mst.weight), to_np(msj.weight),
                               rtol=1e-5, atol=1e-7)
    assert int(ovf_t) == int(ovf_j)
    # a bare PCG32 state is its own raw stream
    s = trng.pcg32_init(torch.arange(4))
    assert stream_rng(s) is s and stream_with_rng(s, rt) is rt


def test_segment_tr_grid_matches_jax():
    """The deterministic 16-point transmittance of the photon walk's beam
    bookkeeping, on grid, homogeneous and vacuum segments."""
    b = JBuilder()
    b.homogeneous_medium((0.05,) * 3, (0.4,) * 3, 0.1)
    smoke_hetero(b)
    jsc = b.build()
    tsc = scene_from_jax(jsc, device="cpu")
    o, d, _ = _rays(n=3000, seed=9)
    t_end = np.random.RandomState(10).uniform(0.0, 4.0, o.shape[0]).astype(np.float32)
    med = np.random.RandomState(11).randint(-1, 2, o.shape[0]).astype(np.int32)
    j = jpt._segment_tr(jsc, jnp.asarray(med), *(jnp.asarray(x) for x in (o, d, t_end)))
    t = tpt._segment_tr(tsc, torch.from_numpy(med).long(),
                        *(torch.from_numpy(x) for x in (o, d, t_end)))
    j, t = to_np(j), to_np(t)
    assert (j[med == 1] < 0.999).mean() > 0.3 and (j[med == -1] == 1).all()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    # and its gradient in the density brick
    w = np.random.RandomState(12).uniform(0, 1, j.shape).astype(np.float32)
    gj = jax.grad(lambda dd: jnp.sum(jpt._segment_tr(
        jsc._replace(media=jsc.media._replace(density=dd)), jnp.asarray(med),
        *(jnp.asarray(x) for x in (o, d, t_end))) * w))(jsc.media.density)
    dd = tsc.media.density.clone().requires_grad_()
    (gt,) = torch.autograd.grad((tpt._segment_tr(
        tsc._replace(media=tsc.media._replace(density=dd)),
        torch.from_numpy(med).long(),
        *(torch.from_numpy(x) for x in (o, d, t_end)))
        * torch.from_numpy(w)).sum(), dd)
    gj = to_np(gj)
    assert np.abs(to_np(gt) - gj).max() <= 2e-4 * np.abs(gj).max()


def test_grid_scene_builder_and_scene_from_jax():
    """SceneBuilder.grid_medium builds the JAX builder's scene leaf for leaf
    (the density brick, world_to_medium and the grid index carried across
    by scene_from_jax), and a second grid medium is refused by the builder
    and by check_slice."""
    ts = smoke_hetero(TBuilder(), density=smoke_density(16), device="cpu")
    cs = scene_from_jax(smoke_hetero(JBuilder(), density=smoke_density(16)),
                        device="cpu")
    for leaf in ts.media._fields:
        a, b = getattr(ts.media, leaf), getattr(cs.media, leaf)
        assert a.dtype == b.dtype and a.shape == b.shape, leaf
        np.testing.assert_array_equal(to_np(a), to_np(b), err_msg=leaf)
    assert tuple(ts.media.density.shape) == (16, 16, 16)
    assert int(ts.media.grid_medium) == 0
    check_slice(ts)
    for builder in (JBuilder(), TBuilder()):
        builder.grid_medium(np.ones((2, 2, 2), np.float32), np.eye(4))
        with pytest.raises(ValueError, match="one grid"):
            builder.grid_medium(np.ones((2, 2, 2), np.float32), np.eye(4))
    two = ts._replace(media=ts.media._replace(
        mtype=torch.tensor([1, 1]), sigma_a=ts.media.sigma_a.repeat(2, 1),
        sigma_s=ts.media.sigma_s.repeat(2, 1), g=ts.media.g.repeat(2)))
    with pytest.raises(NotImplementedError, match="more than one grid"):
        check_slice(two)
