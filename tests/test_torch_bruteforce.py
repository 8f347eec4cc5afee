"""bre_tpu_torch non-packed gather route (``gather_beams_bruteforce``) vs
bre_tpu: the differentiable geometry (``closest_points_segments_exact``,
``_interp_power``), the non-packed beam layout, ``compact_beams`` and the
permutes, the route's forward with ``backend="xla"`` (the plain chunk scan)
and ``"pallas"`` (the forward kernel's plain version against JAX's Pallas
kernel in interpret mode), and its geometry-attached gradients against
``jax.grad`` — identical numpy inputs through both packages.  Grid media:
tests/test_torch_bruteforce_hetero.py.

Tolerances and their reasons: sorting, packing and permuting are exact.
Values of the geometry and the forward sums: the Pallas tests' rtol 2e-4 /
atol 1e-8 (tests/test_pallas_gather.py:47): XLA contracts multiply-adds,
torch does not (ROADMAP Queue 3).  Gradients: each cotangent against its
own max|ref|, at 2e-4 (tests/test_pallas_gather.py:97), except the
cotangents of the segment and beam end points (start, end, a0, a1) at 1e-3.
Those run through the closest-point solve, whose conditioning is 1/sin^2 of
the pair's angle: on these inputs a pair 1.7 degrees from parallel (sin^2
8.9e-4) turns the frameworks' last-ulp differences into 2.2e-4 of that
pair's a0 cotangent (2.6e-4 of the ray's), and JAX's own float32 a0
cotangent is 3.2e-3 of its max from a float64 evaluation of the same
function.  No tie is involved: every clip, max and min of the port splits
the cotangent at a tie as JAX does (``_clip``, ``_max``; checked below)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bre_tpu.accel import beam_gather as jbg
from bre_tpu.ops import pallas_gather as jpg
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu_torch.accel import beam_gather as tbg
from bre_tpu_torch.ops import gather as tg
from bre_tpu_torch.scene.scene import scene_from_jax
from test_torch_gather import _beams_np, _jbeams, _segments, _tbeams
from torch_parity import to_np

RTOL, ATOL = 2e-4, 1e-8
GEOM_RTOL = 1e-3  # the closest-point solve's conditioning (docstring)
GEOM = ("start", "end", "a0", "a1")


def _t(x, grad=False):
    return torch.tensor(np.asarray(x)).requires_grad_(grad)


def _close_to_max(t, j, rtol):
    t, j = to_np(t), to_np(j)
    assert np.isfinite(t).all()
    err = np.abs(t - j).max()
    assert err <= rtol * (np.abs(j).max() + 1e-9), (err, np.abs(j).max())


def _pair_cases(n=400, seed=0):
    """Random segment pairs plus parallel, antiparallel, collinear,
    crossing and degenerate (zero-length) ones."""
    rs = np.random.RandomState(seed)
    a0, a1, b0, b1 = (rs.uniform(-1, 1, (n, 3)).astype(np.float32)
                      for _ in range(4))
    d = np.float32([0.3, -0.2, 0.5])
    a0[0], a1[0], b0[0], b1[0] = 0, d, [0, 0.1, 0], d + [0, 0.1, 0]
    a0[1], a1[1], b0[1], b1[1] = 0, d, d + [0, 0.1, 0], [0, 0.1, 0]
    a0[2], a1[2], b0[2], b1[2] = 0, d, 2 * d, 3 * d
    a0[3], a1[3], b0[3], b1[3] = [-1, 0, 0], [1, 0, 0], [0, -1, 0], [0, 1, 0]
    a1[4] = a0[4]  # zero-length camera segment
    b1[5] = b0[5]  # zero-length beam
    a1[6], b1[6] = a0[6], b0[6]  # both
    return a0, a1, b0, b1


def test_clip_and_max_split_ties_like_jax():
    x = np.float32([0.0, 0.5, 1.0, -1.0, 2.0])
    gj = jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.0, 1.0)
                                    + jnp.maximum(v, 0.0)))(jnp.asarray(x))
    xt = _t(x, True)
    (tbg._clip(xt, 0.0, 1.0) + tbg._max(xt, 0.0)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gj))


def test_closest_points_exact_matches():
    a0, a1, b0, b1 = _pair_cases()
    W = np.random.RandomState(1).rand(400, 2, 3).astype(np.float32)

    def jf(*xs):
        pa, pb, v = jbg.closest_points_segments_exact(*xs)
        return jnp.sum(pa * W[:, 0]) + jnp.sum(pb * W[:, 1]), (pa, pb, v)

    (_, (pa_j, pb_j, v_j)), g_j = jax.value_and_grad(
        jf, argnums=(0, 1, 2, 3), has_aux=True)(
            *(jnp.asarray(x) for x in (a0, a1, b0, b1)))
    xs = [_t(x, True) for x in (a0, a1, b0, b1)]
    pa_t, pb_t, v_t = tbg.closest_points_segments_exact(*xs)
    ((pa_t * torch.from_numpy(W[:, 0])).sum()
     + (pb_t * torch.from_numpy(W[:, 1])).sum()).backward()
    np.testing.assert_allclose(to_np(pa_t), to_np(pa_j), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(to_np(pb_t), to_np(pb_j), rtol=RTOL, atol=1e-6)
    assert to_np(v_t).all() and to_np(v_j).all()
    for x, g in zip(xs, g_j):
        _close_to_max(x.grad, g, GEOM_RTOL)
    # the parallel and degenerate pairs give the reference's exact points
    np.testing.assert_array_equal(to_np(pa_t)[[0, 4, 6]], to_np(pa_j)[[0, 4, 6]])


def test_interp_power_matches():
    """Live, dead (zero start power), floored (pe below 1e-12 ps) and
    ordinary lanes, fractions at 0, 1 and between: values and the
    cotangents of both powers and the fraction, all finite."""
    rs = np.random.RandomState(2)
    ps = rs.uniform(0.1, 2.0, (64, 3)).astype(np.float32)
    pe = (ps * rs.uniform(0.05, 1.0, (64, 3))).astype(np.float32)
    ps[:8] = 0.0  # dead lanes: never reach the log
    pe[8:16] = 1e-20  # below the 1e-12 floor
    frac = rs.uniform(0, 1, 64).astype(np.float32)
    frac[16:20], frac[20:24] = 0.0, 1.0
    W = rs.rand(64, 3).astype(np.float32)
    f = lambda a, b, c: jnp.sum(jbg._interp_power(a, b, c) * W)  # noqa: E731
    v_j = jbg._interp_power(*(jnp.asarray(x) for x in (ps, pe, frac)))
    g_j = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                          for x in (ps, pe, frac)))
    xs = [_t(x, True) for x in (ps, pe, frac)]
    v_t = tbg._interp_power(*xs)
    (v_t * torch.from_numpy(W)).sum().backward()
    np.testing.assert_allclose(to_np(v_t), to_np(v_j), rtol=RTOL, atol=ATOL)
    assert float(v_t.detach()[:8].abs().max()) == 0.0
    for x, g in zip(xs, g_j):
        _close_to_max(x.grad, g, RTOL)
        assert float(x.grad[:8].abs().max()) == 0.0 or x is xs[2]


def test_pack_beams_matches():
    """The non-packed layout equals pallas_gather.pack_beams; a buffer that
    is not a whole number of 256-beam chunks is padded with zero beams."""
    rs = np.random.RandomState(3)
    pb = {k: rs.rand(512, *s).astype(np.float32) for k, s in
          (("start", (3,)), ("end", (3,)), ("power_start", (3,)),
           ("power_end", (3,)), ("radius", ()), ("valid_f", ()),
           ("d_poly_b", (5,)), ("sigma_t_b", (3,)))}
    j = jpg.pack_beams({k: jnp.asarray(v) for k, v in pb.items()}, 256)
    t = tg.pack_beams({k: torch.from_numpy(v) for k, v in pb.items()}, 256)
    assert t.shape == (2, tg.NB_HET, 256)
    np.testing.assert_array_equal(to_np(t), to_np(j))
    odd = tg.pack_beams({k: torch.from_numpy(v[:300]) for k, v in pb.items()
                         if k not in ("d_poly_b", "sigma_t_b")}, 256)
    assert odd.shape == (2, tg.NB, 256)
    np.testing.assert_array_equal(to_np(odd[0]), to_np(t[0, :tg.NB]))
    assert float(odd[1, :, 44:].abs().max()) == 0.0


def test_compact_beams_and_permutes():
    """Validity order equal to the reference's; the permutes' backward is
    the gather by the inverse permutation (exact)."""
    b = _beams_np(B=900)
    cj = jbg.compact_beams(_jbeams(b))
    tb = _tbeams(b)
    tb = tb._replace(power_start=tb.power_start.clone().requires_grad_())
    ct = tbg.compact_beams(tb)
    for k in ct._fields:
        np.testing.assert_array_equal(to_np(getattr(ct, k)),
                                      to_np(getattr(cj, k)))
    W = torch.from_numpy(np.random.RandomState(4).rand(900, 3)
                         .astype(np.float32))
    (ct.power_start * W).sum().backward()
    order, _ = tbg.validity_order(tb.valid)
    expect = torch.empty_like(W)
    expect[order] = W
    assert torch.equal(tb.power_start.grad, expect)
    x = torch.rand(3, 900, dtype=torch.float64, requires_grad=True)
    order, inv = tbg.validity_order(tb.valid)
    y = tbg.permute_cols(x, order, inv)
    assert torch.equal(y, x[:, order])
    y.backward(torch.ones_like(y) * torch.arange(900.0, dtype=torch.float64))
    assert torch.equal(x.grad[:, order],
                       torch.arange(900.0, dtype=torch.float64).expand(3, 900))


def _homog_scene():
    jb = JBuilder()
    jb.homogeneous_medium((0.05,) * 3, (0.5,) * 3, 0.3)
    jb.triangle((0, 0, 0), (1, 0, 0), (0, 1, 0))
    js = jb.build()
    return js, scene_from_jax(js, device="cpu")


def _gather_both(js, ts, b, segs, **kw):
    a0, a1, sd, med, trf = segs
    j = jbg.gather_beams_bruteforce(
        _jbeams(b), js.media, *(jnp.asarray(x) for x in (a0, a1, sd, med, trf)),
        jnp.float32(0.2), power_scale=1e-3, **kw)
    t = tbg.gather_beams_bruteforce(
        _tbeams(b), ts.media, *(torch.from_numpy(x) for x in (a0, a1, sd)),
        torch.from_numpy(med.astype(np.int64)), torch.from_numpy(trf), 0.2,
        power_scale=1e-3, **kw)
    return t, j


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("assume_compacted", [False, True])
def test_forward_matches(backend, assume_compacted):
    """Homogeneous medium, chunk 256 (the last chunk past n_valid) and 384
    (not a whole number of kernel chunks: the kernel buffer is padded)."""
    js, ts = _homog_scene()
    b, segs = _beams_np(B=700), _segments(R=300)
    n0 = tbg.gather_beams_bruteforce.calls
    for chunk in (256, 384):
        t, j = _gather_both(js, ts, b, segs, chunk=chunk, backend=backend,
                            assume_compacted=assume_compacted)
        assert t.shape == (300, 3) and float(np.abs(to_np(j)).max()) > 0
        np.testing.assert_allclose(to_np(t), to_np(j), rtol=RTOL, atol=ATOL)
        assert float(t[torch.from_numpy(segs[3] < 0)].abs().max()) == 0.0
    assert tbg.gather_beams_bruteforce.calls == n0 + 2


def _grads_both(js, ts, b, segs, hetero, **kw):
    """Cotangents of sum(out * W) in every differentiable input, through
    the default route (backend "pallas", geometry attached)."""
    a0, a1, sd, med, trf = segs
    R = a0.shape[0]
    W = np.random.RandomState(5).rand(R, 3).astype(np.float32)
    m = js.media
    names = ("start", "end", "power_start", "power_end", "radius", "a0", "a1",
             "seg_dir", "tr_full", "sigma_s", "g", "cam_radius")
    vals = [b["start"], b["end"], b["power_start"], b["power_end"],
            b["radius"], a0, a1, sd, trf, m.sigma_s, m.g, np.float32(0.2)]
    if hetero:  # the tables read sigma_a and the density grid
        names += ("sigma_a", "density")
        vals += [m.sigma_a, m.density]

    def jloss(*xs):
        x = dict(zip(names, xs))
        bb = _jbeams(b)._replace(**{k: x[k] for k in names[:5]})
        md = m._replace(sigma_s=x["sigma_s"], g=x["g"],
                        **{k: x[k] for k in ("sigma_a", "density") if k in x})
        out = jbg.gather_beams_bruteforce(
            bb, md, x["a0"], x["a1"], x["seg_dir"], jnp.asarray(med),
            x["tr_full"], x["cam_radius"], power_scale=1e-3, hetero=hetero,
            **kw)
        return jnp.sum(out * W)

    g_j = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(v) for v in vals))
    xs = [_t(v, True) for v in vals]
    x = dict(zip(names, xs))
    tm = ts.media._replace(
        sigma_s=x["sigma_s"], g=x["g"],
        **{k: x[k] for k in ("sigma_a", "density") if k in x})
    out = tbg.gather_beams_bruteforce(
        _tbeams(b)._replace(**{k: x[k] for k in names[:5]}), tm, x["a0"],
        x["a1"], x["seg_dir"], torch.from_numpy(med.astype(np.int64)),
        x["tr_full"], x["cam_radius"], power_scale=1e-3, hetero=hetero, **kw)
    (out * torch.from_numpy(W)).sum().backward()
    return {n: (t.grad, g) for n, t, g in zip(names, xs, g_j)}


def test_attached_gradients_match():
    """grad_geometry=True (the default): every cotangent through the
    recompute backward against jax.grad."""
    js, ts = _homog_scene()
    got = _grads_both(js, ts, _beams_np(B=700), _segments(R=300), False,
                      chunk=256, backend="pallas")
    for name, (t, j) in got.items():
        assert t is not None, name
        assert float(np.abs(to_np(j)).max()) > 0, name
        _close_to_max(t, j, GEOM_RTOL if name in GEOM else RTOL)
