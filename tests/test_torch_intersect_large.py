"""Scenes above one sweep's primitives, against bre_tpu on the CPU: the
chunked sweep and the tri-BVH walk of ``bre_tpu_torch.scene.intersect``.

The scene is the reference's own tri-BVH test scene (tests/test_tri_bvh.py:
a bumpy 9 x 9 heightfield and a sphere, here with a material-less boundary
box around them), at 128 + 12 triangles; the chunk width and the tri-BVH
threshold are forced down so that both paths run at this size.

Tolerances: the chunked sweep equals the port's single sweep bit for bit
(every Hit field), and it and the tri-BVH walk give the reference's valid
flags, kinds and primitive indices exactly; t within 4 float32 ulps of
max(t, 1) (XLA:CPU contracts the products of the Moller-Trumbore dots into
FMAs, torch does not: measured 2.4e-7 relative); occlusion exactly.  The
vertex gradient through the recomputed winner within rtol 1e-4 plus an atol
of 1e-5 x its largest magnitude of ``jax.grad`` (the same contraction,
amplified by 1/det: measured 4e-6 x the largest, on 2 of 420 entries)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bre_tpu.scene import builder as jbuilder
from bre_tpu.scene import intersect as jisect
from bre_tpu_torch.integrators import mlt as tmlt
from bre_tpu_torch.scene import builder as tbuilder
from bre_tpu_torch.scene import intersect as tisect
from bre_tpu_torch.scene.scene import scene_from_jax
from torch_parity import to_np

N_RAYS = 512
ULPS = 4 * 2.0 ** -23


def _scene(mod, bvh, **build):
    b = mod.SceneBuilder()
    m = b.matte((0.6, 0.5, 0.4))
    z = 0.3 * np.random.default_rng(7).standard_normal((9, 9)).astype(
        np.float32)
    b.heightfield(z, origin=(-2, -2, 0), size=(4.0, 4.0), material=m)
    b.sphere((0, 0, 2.0), 0.5, material=m)
    b.box((-3, -3, -1), (3, 3, 5), material=-1, medium_inside=-1)
    b.point_light((0, 0, 4.0), (10, 10, 10))
    return b.build(**build)


@pytest.fixture(scope="module")
def scenes():
    """(port dense, port tri-BVH, reference dense, reference tri-BVH)."""
    out = []
    for bvh in (False, True):
        for mod in (tbuilder, jbuilder):
            saved = mod.BVH_MIN_TRIANGLES
            mod.BVH_MIN_TRIANGLES = 8 if bvh else 10 ** 9
            try:
                out.append(_scene(mod, bvh, **(
                    {"device": "cpu"} if mod is tbuilder else {})))
            finally:
                mod.BVH_MIN_TRIANGLES = saved
    td, jd, tb, jb = out
    assert tb.tri_bvh is not None and td.tri_bvh is None
    return td, tb, jd, jb


def _rays(n=N_RAYS, seed=3):
    """Rays from above the field toward it (the reference test's), and from
    inside the box in every direction."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[: n // 2, 2] = np.abs(o[: n // 2, 2]) + 2.5
    o[n // 2:] = rng.uniform(-2.5, 2.5, (n - n // 2, 3))
    tgt = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    tgt[:, 2] *= 0.2
    d = tgt - o
    d[n // 2:] = rng.normal(size=(n - n // 2, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = rng.uniform(0.5, 8.0, n).astype(np.float32)
    return o, d.astype(np.float32), t_max


def _t_close(a, b, valid):
    a, b = np.asarray(a)[valid], np.asarray(b)[valid]
    assert (np.abs(a - b) <= ULPS * np.maximum(np.abs(b), 1.0)).all()


def test_chunked_sweep_is_the_single_sweep(scenes, monkeypatch):
    td, _, jd, _ = scenes
    o, d, _ = _rays()
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    one = tisect.intersect(td, ot, dt)
    monkeypatch.setattr(tisect, "SWEEP_ELEMENTS", N_RAYS * 16)
    assert tisect._chunk_width(N_RAYS) == 16 < td.n_triangles
    chunked = tisect.intersect(td, ot, dt)
    for name in one._fields:
        assert torch.equal(getattr(one, name), getattr(chunked, name)), name
    # and the reference's chunked sweep at its own forced chunk
    monkeypatch.setattr(jisect, "_PRIM_CHUNK", 16)
    ref = jisect.intersect(jd, jnp.asarray(o), jnp.asarray(d))
    v = np.asarray(ref.valid)
    assert np.array_equal(to_np(chunked.valid), v)
    assert np.array_equal(to_np(chunked.prim_kind), np.asarray(ref.prim_kind))
    assert np.array_equal(to_np(chunked.prim_index)[v],
                          np.asarray(ref.prim_index)[v])
    _t_close(to_np(chunked.t), ref.t, v)


@pytest.mark.parametrize("chunk", [None, 16])
def test_chunked_occlusion_matches(scenes, chunk, monkeypatch):
    td, _, jd, _ = scenes
    o, d, t_max = _rays(seed=11)
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max))
    one = tisect.intersect_p(td, *args)
    if chunk:
        monkeypatch.setattr(tisect, "SWEEP_ELEMENTS", N_RAYS * chunk)
        monkeypatch.setattr(jisect, "_PRIM_CHUNK", chunk)
    got = tisect.intersect_p(td, *args)
    ref = jisect.intersect_p(jd, jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(t_max))
    assert torch.equal(one, got)
    assert np.array_equal(to_np(got), np.asarray(ref))
    assert 0 < float(got.float().mean()) < 1


def test_tri_bvh_nearest_hit_matches_reference(scenes):
    _, tb, _, jb = scenes
    for f in tb.tri_bvh._fields:  # the same tree in both packages
        assert np.array_equal(to_np(getattr(tb.tri_bvh, f)),
                              np.asarray(getattr(jb.tri_bvh, f))), f
    o, d, _ = _rays()
    tisect.TRAVERSAL_STATS.reset()
    got = tisect.intersect(tb, torch.from_numpy(o), torch.from_numpy(d))
    st = tisect.TRAVERSAL_STATS.as_dict()
    ref = jisect.intersect(jb, jnp.asarray(o), jnp.asarray(d))
    v = np.asarray(ref.valid)
    assert np.array_equal(to_np(got.valid), v) and 0.2 < v.mean() < 1
    assert np.array_equal(to_np(got.prim_kind), np.asarray(ref.prim_kind))
    assert np.array_equal(to_np(got.prim_index)[v],
                          np.asarray(ref.prim_index)[v])
    _t_close(to_np(got.t), ref.t, v)
    # one walk, whose host reads come every TRIPS_PER_READ trips
    assert st["calls"] == 1
    assert st["host_reads"] == st["trips"] // tisect.TRIPS_PER_READ + 1


def test_tri_bvh_occlusion_matches_reference(scenes):
    td, tb, _, jb = scenes
    o, d, t_max = _rays(seed=11)
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max))
    got = tisect.intersect_p(tb, *args)
    ref = jisect.intersect_p(jb, jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(t_max))
    assert np.array_equal(to_np(got), np.asarray(ref))
    assert torch.equal(got, tisect.intersect_p(td, *args))


def test_tri_bvh_skips_boundary_surfaces(monkeypatch):
    """Shadow rays pass material-less boundary triangles on the tri-BVH
    path too (tests/test_tri_bvh.py's case, both packages)."""
    outs = []
    for mod in (tbuilder, jbuilder):
        monkeypatch.setattr(mod, "BVH_MIN_TRIANGLES", 8)
        b = mod.SceneBuilder()
        m = b.matte((0.5,) * 3)
        med = b.homogeneous_medium((0.1,) * 3, (0.2,) * 3)
        b.box((-1, -1, -1), (1, 1, 1), material=-1, medium_inside=med,
              medium_outside=-1)
        b.quad((-2, -2, 3), (2, -2, 3), (2, 2, 3), (-2, 2, 3), material=m)
        b.point_light((0, 0, -4), (1, 1, 1))
        outs.append(b.build(device="cpu") if mod is tbuilder else b.build())
    ts, js = outs
    assert ts.tri_bvh is not None and ts.n_triangles == 14
    o = np.array([[0.0, 0.0, -4.0], [0.0, 0.0, -4.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]], np.float32)
    for t_max, want in ((10.0, [True, False]), (6.0, [False, False])):
        tm = np.full(2, t_max, np.float32)
        got = tisect.intersect_p(ts, torch.from_numpy(o), torch.from_numpy(d),
                                 torch.from_numpy(tm))
        ref = jisect.intersect_p(js, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(tm))
        assert to_np(got).tolist() == want == np.asarray(ref).tolist()


@pytest.mark.parametrize("path", ["tri_bvh", "chunked"])
def test_vertex_gradient_matches_jax_grad(scenes, path, monkeypatch):
    """d/d(vertices) of sum(t over hits) through the recomputed winner:
    the tri-BVH walk and the chunked sweep both run detached."""
    td, tb, jd, jb = scenes
    ts, js = (tb, jb) if path == "tri_bvh" else (td, jd)
    if path == "chunked":
        monkeypatch.setattr(tisect, "SWEEP_ELEMENTS", N_RAYS * 16)
        monkeypatch.setattr(jisect, "_PRIM_CHUNK", 16)
    o, d, _ = _rays(seed=5)
    tri = ts.triangles
    leaves = [getattr(tri, k).detach().clone().requires_grad_()
              for k in ("p0", "p1", "p2")]
    sc = ts._replace(triangles=tri._replace(p0=leaves[0], p1=leaves[1],
                                            p2=leaves[2]))
    h = tisect.intersect(sc, torch.from_numpy(o), torch.from_numpy(d))
    torch.where(h.valid, h.t, torch.zeros_like(h.t)).sum().backward()

    def f(p0, p1, p2):
        s = js._replace(triangles=js.triangles._replace(p0=p0, p1=p1, p2=p2))
        hj = jisect.intersect(s, jnp.asarray(o), jnp.asarray(d))
        return jnp.sum(jnp.where(hj.valid, hj.t, 0.0))

    jt = js.triangles
    ref = jax.grad(f, argnums=(0, 1, 2))(jt.p0, jt.p1, jt.p2)
    for leaf, g in zip(leaves, ref):
        assert leaf.grad is not None
        g = np.asarray(g)
        np.testing.assert_allclose(to_np(leaf.grad), g, rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max())
    assert float(leaves[0].grad.abs().sum()) > 0


def test_scene_from_jax_carries_the_tri_bvh(scenes):
    _, tb, _, jb = scenes
    carried = scene_from_jax(jb, device="cpu")
    for name in tb.tri_bvh._fields:
        a, b = getattr(tb.tri_bvh, name), getattr(carried.tri_bvh, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_mlt_runs_eagerly_on_a_tri_bvh_scene(scenes):
    """The walk's host reads cannot sit in a CUDA graph: MLT's chain step
    is captured only where the scene has neither a grid medium nor a
    tri-BVH, and runs eagerly on a tri-BVH scene, as on grid media."""
    td, tb, _, _ = scenes
    assert tmlt._capturable(td) and not tmlt._capturable(tb)
