"""bre_tpu_torch scene, intersection, media, lights, materials and NEE vs
bre_tpu on the Cornell fog scene (BASELINE config 2) — identical inputs
through both packages, scenes carried across by ``scene_from_jax``.

Tolerances: builder leaves, hit flags, primitive indices, material and
medium ids are exact.  Float results use rtol 1e-5 with a small atol: the
frameworks' sqrt/exp/log/sin/cos and XLA's contracted multiply-adds differ
in the last ulps (measured ~1e-7 relative), which the hit distances and the
NEE shadow walk amplify by at most a few tens of ulps."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bre_tpu import lights as jl
from bre_tpu import materials as jm
from bre_tpu import media as jmed
from bre_tpu.core import rng as jrng
from bre_tpu.integrators import common as jcommon
from bre_tpu.scene import intersect as jint
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu_torch import lights as tl
from bre_tpu_torch import materials as tm
from bre_tpu_torch import media as tmed
from bre_tpu_torch.core import rng as trng
from bre_tpu_torch.integrators import common as tcommon
from bre_tpu_torch.scene import intersect as tint
from bre_tpu_torch.scene.builder import SceneBuilder as TBuilder
from bre_tpu_torch.scene.camera import make_perspective_camera as tcam
from bre_tpu_torch.scene.scene import check_slice, scene_from_jax
from torch_parity import cornell_fog, to_np


@pytest.fixture(scope="module")
def scenes():
    js = cornell_fog(JBuilder(), point_light=True)
    return js, scene_from_jax(js, device="cpu")


def _rays(n=3000, seed=0):
    rs = np.random.RandomState(seed)
    o = rs.uniform([-0.95, -0.95, 0.05], [0.95, 0.95, 1.95], (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o[:200] = [0.0, 0.0, -2.2]  # camera-like rays entering the box
    d[:200] = (rs.uniform([-0.4, -0.4, 1], [0.4, 0.4, 1], (200, 3))
               / np.sqrt(1.32)).astype(np.float32)
    return o, d


def test_builder_matches_scene_from_jax():
    """The port's SceneBuilder leaves equal the JAX builder's scene carried
    across, leaf for leaf, on the Cornell scene."""
    ts = cornell_fog(TBuilder(), point_light=True, device="cpu")
    cs = scene_from_jax(cornell_fog(JBuilder(), point_light=True),
                        device="cpu")
    for group in ts._fields:
        a, b = getattr(ts, group), getattr(cs, group)
        if a is None:  # tri_bvh below builder.BVH_MIN_TRIANGLES
            assert b is None, group
            continue
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(to_np(a), to_np(b), err_msg=group)
            continue
        # the BSSRDF and Fourier tables are tuples inside Materials
        leaves = [((leaf,), getattr(a, leaf), getattr(b, leaf))
                  for leaf in a._fields]
        while leaves:
            name, x, y = leaves.pop()
            if hasattr(x, "_fields"):
                leaves += [(name + (k,), getattr(x, k), getattr(y, k))
                           for k in x._fields]
                continue
            if not isinstance(x, torch.Tensor):  # Textures.depth, an int
                assert x == y, (group, name)
                continue
            assert x.dtype == y.dtype, (group, name)
            np.testing.assert_array_equal(to_np(x), to_np(y),
                                          err_msg=f"{group}.{name}")
    assert ts.n_triangles == 24 and ts.n_lights == 3


def test_entry_points_default_to_cuda():
    """SceneBuilder.build, scene_from_jax and make_perspective_camera build
    on "cuda" unless the caller asks for the CPU; without a card the
    default call raises instead of carrying on on the CPU."""
    for fn in (TBuilder.build, scene_from_jax, tcam):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    b = TBuilder()
    b.triangle((0, 0, 0), (1, 0, 0), (0, 1, 0))
    calls = (b.build, lambda: scene_from_jax(JBuilder().build()),
             lambda: tcam(np.eye(4), 45.0, 8, 8))
    for call in calls:
        if torch.cuda.is_available():
            out = call()
            assert _device_of(out).type == "cuda"
        else:
            with pytest.raises(RuntimeError, match='device="cpu"'):
                call()


def _device_of(x):
    """Device of a Scene or Camera (the first tensor leaf)."""
    return x.world_min.device if hasattr(x, "world_min") else x[0].device


def test_unported_content_raises():
    """Scenes outside the slice fail loudly instead of rendering wrongly.
    Every material is ported now: a hair, subsurface, kdsubsurface or
    Fourier material passes."""
    from bre_tpu.fourier import lambertian_fourier_table

    b = JBuilder()
    b.hair()
    b.subsurface()
    b.kdsubsurface()
    b.fourier_material(table=lambertian_fourier_table(n_mu=8))
    b.triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), material=0)
    check_slice(scene_from_jax(b.build(), device="cpu"))
    # every light type is ported: sphere area lights, and the spot,
    # distant, infinite (constant and image-mapped), goniometric and
    # projection lights
    b = JBuilder()
    b.area_light_sphere((0, 0, 0), 0.5, (1, 1, 1))
    b.spot_light((0, 0, 0), (0, 0, 1), (1, 1, 1))
    b.distant_light((0, -1, 0), (1, 1, 1))
    b.infinite_light((0.1, 0.1, 0.1))
    img = np.ones((4, 8, 3), np.float32)
    b.infinite_light((1, 1, 1), image=img)
    b.goniometric_light((0, 1, 0), (1, 1, 1), image=img)
    b.projection_light((0, 1, 0), (1, 1, 1), image=img)
    lit = scene_from_jax(b.build(), device="cpu")
    check_slice(lit)
    # a diffuse area light on a shape that is neither a triangle nor a
    # sphere is still refused (ROADMAP Queue 1 item 5.5)
    other = lit._replace(lights=lit.lights._replace(
        shape_kind=torch.where(lit.lights.shape_kind >= 0, 2,
                               lit.lights.shape_kind)))
    with pytest.raises(NotImplementedError, match="area light"):
        check_slice(other)
    # one grid medium is ported; the scene holds one density brick, so a
    # second grid medium is refused
    b = JBuilder()
    b.grid_medium(np.ones((2, 2, 2), np.float32), np.eye(4))
    b.triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), medium_inside=0)
    one = scene_from_jax(b.build(), device="cpu")
    check_slice(one)
    two = one._replace(media=one.media._replace(
        mtype=one.media.mtype.repeat(2), sigma_a=one.media.sigma_a.repeat(2, 1),
        sigma_s=one.media.sigma_s.repeat(2, 1), g=one.media.g.repeat(2)))
    with pytest.raises(NotImplementedError, match="more than one grid"):
        check_slice(two)


def test_intersect_matches(scenes):
    js, ts = scenes
    b = JBuilder()
    b.matte()
    b.sphere((0.2, 0.1, 1.0), 0.3, material=0)
    b.triangle((-1, -1, 1.5), (1, -1, 1.5), (0, 1, 1.5), material=0)
    for jsc, tsc in ((js, ts), (b.build(), None)):
        tsc = tsc if tsc is not None else scene_from_jax(jsc, device="cpu")
        o, d = _rays()
        hj = jint.intersect(jsc, jnp.asarray(o), jnp.asarray(d))
        ht = tint.intersect(tsc, torch.from_numpy(o), torch.from_numpy(d))
        np.testing.assert_array_equal(to_np(ht.valid), to_np(hj.valid))
        assert to_np(ht.valid).mean() > 0.1
        for k in ("prim_kind", "prim_index", "material", "medium_inside",
                  "medium_outside", "area_light"):
            np.testing.assert_array_equal(to_np(getattr(ht, k)),
                                          to_np(getattr(hj, k)), err_msg=k)
        v = to_np(ht.valid)
        np.testing.assert_allclose(to_np(ht.t)[v], to_np(hj.t)[v], rtol=1e-5)
        for k in ("p", "n", "ns", "tangent"):
            np.testing.assert_allclose(to_np(getattr(ht, k)),
                                       to_np(getattr(hj, k)), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        tmax = np.random.RandomState(1).uniform(0.1, 3, o.shape[0]).astype(np.float32)
        np.testing.assert_array_equal(
            to_np(tint.intersect_p(tsc, torch.from_numpy(o), torch.from_numpy(d),
                                 torch.from_numpy(tmax))),
            to_np(jint.intersect_p(jsc, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(tmax))))


def test_media_match():
    rs = np.random.RandomState(2)
    n = 4000
    wo = rs.normal(size=(n, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    u = rs.rand(n, 2).astype(np.float32)
    g = rs.choice([0.0, 0.5, -0.3, 0.9], n).astype(np.float32)
    wj, pj = jmed.hg_sample_p(jnp.asarray(wo), jnp.asarray(g), jnp.asarray(u))
    wt, pt = tmed.hg_sample_p(torch.from_numpy(wo), torch.from_numpy(g),
                              torch.from_numpy(u))
    np.testing.assert_allclose(to_np(wt), to_np(wj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(pt), to_np(pj), rtol=1e-5)
    sa = rs.uniform(0, 0.5, (n, 3)).astype(np.float32)
    ss = rs.uniform(0, 1, (n, 3)).astype(np.float32)
    tmax = rs.uniform(0.1, 5, n).astype(np.float32)
    args_j = [jnp.asarray(x) for x in (sa, ss, wo, tmax, u[:, 0], u[:, 1])]
    args_t = [torch.from_numpy(x) for x in (sa, ss, wo, tmax, u[:, 0], u[:, 1])]
    mj = jmed.sample_homogeneous(*args_j)
    mt = tmed.sample_homogeneous(*args_t)
    np.testing.assert_array_equal(to_np(mt.sampled), to_np(mj.sampled))
    np.testing.assert_allclose(to_np(mt.t), to_np(mj.t), rtol=1e-5)
    np.testing.assert_allclose(to_np(mt.weight), to_np(mj.weight), rtol=1e-5)
    np.testing.assert_allclose(to_np(tmed.tr_homogeneous(*args_t[:4])),
                               to_np(jmed.tr_homogeneous(*args_j[:4])), rtol=1e-5)


def test_lights_and_bsdf_match(scenes):
    js, ts = scenes
    rs = np.random.RandomState(3)
    n = 3000
    dj, dt = jl.light_power_distribution(js), tl.light_power_distribution(ts)
    np.testing.assert_allclose(to_np(dt.func), to_np(dj.func), rtol=1e-6)
    np.testing.assert_allclose(to_np(dt.cdf), to_np(dj.cdf), rtol=1e-6)
    li = rs.randint(0, 3, n)
    u1, u2 = rs.rand(n, 2).astype(np.float32), rs.rand(n, 2).astype(np.float32)
    lj = jl.sample_le(js, jnp.asarray(li, jnp.int32), jnp.asarray(u1),
                      jnp.asarray(u2))
    lt = tl.sample_le(ts, torch.from_numpy(li), torch.from_numpy(u1),
                      torch.from_numpy(u2))
    for k in ("o", "d", "n_light", "Le", "pdf_pos", "pdf_dir", "medium"):
        np.testing.assert_allclose(to_np(getattr(lt, k)), to_np(getattr(lj, k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    p = rs.uniform(-0.9, 0.9, (n, 3)).astype(np.float32) + [0, 0, 1]
    p = p.astype(np.float32)
    sj = jl.sample_li(js, jnp.asarray(li, jnp.int32), jnp.asarray(p), jnp.asarray(u1))
    st = tl.sample_li(ts, torch.from_numpy(li), torch.from_numpy(p),
                      torch.from_numpy(u1))
    for k in ("wi", "Li", "pdf", "dist"):
        np.testing.assert_allclose(to_np(getattr(st, k)), to_np(getattr(sj, k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)

    o, d = _rays(n, seed=4)
    hj = jint.intersect(js, jnp.asarray(o), jnp.asarray(d))
    ht = tint.intersect(ts, torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_allclose(
        to_np(tl.area_light_emitted(ts, ht.area_light, ht.n, -torch.from_numpy(d))),
        to_np(jl.area_light_emitted(js, hj.area_light, hj.n, -jnp.asarray(d))))
    for mode in (jm.MODE_RADIANCE, jm.MODE_IMPORTANCE):
        bj = jm.sample_bsdf(js.materials, hj.material, hj.ns, -jnp.asarray(d),
                            jnp.asarray(u2), mode=mode, tangent=hj.tangent)
        bt = tm.sample_bsdf(ts.materials, ht.material, ht.ns,
                            -torch.from_numpy(d), torch.from_numpy(u2),
                            mode=mode, tangent=ht.tangent)
        for k in ("wi", "f", "pdf", "specular", "valid"):
            np.testing.assert_allclose(to_np(getattr(bt, k)), to_np(getattr(bj, k)),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    fj, pj = jm.eval_bsdf(js.materials, hj.material, hj.ns, -jnp.asarray(d),
                          bj.wi)
    ft, pt = tm.eval_bsdf(ts.materials, ht.material, ht.ns,
                          -torch.from_numpy(d), bt.wi)
    np.testing.assert_allclose(to_np(ft), to_np(fj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to_np(pt), to_np(pj), rtol=1e-5, atol=1e-6)


def test_nee_with_boundary_walk_matches():
    """sample_one_light through the shadow-ray boundary walk (tr_crossings
    resolves to 2 for the fog box): wall hits (BSDF), fog points and points
    in front of the box (phase function, shadow rays entering the fog).
    The fog box is inflated by 0.01 so walls, not the coplanar boundary,
    are hit from inside."""
    jb = JBuilder()
    cornell_fog(jb, point_light=True)
    jb._tri = jb._tri[12:]  # drop the coplanar box; re-add it inflated
    jb.box((-1.01, -1.01, -0.01), (1.01, 1.01, 2.01), material=-1,
           medium_inside=0, medium_outside=-1)
    js = jb.build()
    ts = scene_from_jax(js, device="cpu")
    assert jcommon.default_tr_crossings(js) == tcommon.default_tr_crossings(ts) == 2
    rs = np.random.RandomState(5)
    o, d = _rays(1000, seed=5)
    hj = jint.intersect(js, jnp.asarray(o), jnp.asarray(d))
    ht = tint.intersect(ts, torch.from_numpy(o), torch.from_numpy(d))
    m = 800
    p_fog = rs.uniform([-0.9, -0.9, 0.1], [0.9, 0.9, 1.9], (m, 3))
    p_out = rs.uniform([-0.9, -0.9, -1.0], [0.9, 0.9, -0.05], (m, 3))
    p = np.concatenate([to_np(hj.p), p_fog, p_out]).astype(np.float32)
    n = np.concatenate([to_np(hj.ns), np.zeros((2 * m, 3))]).astype(np.float32)
    tan = np.concatenate([to_np(hj.tangent), np.zeros((2 * m, 3))]).astype(np.float32)
    wo = np.concatenate([-d, rs.normal(size=(2 * m, 3))]).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    mat = np.concatenate([to_np(hj.material), -np.ones(2 * m, np.int64)])
    med = np.concatenate([np.zeros(1000 + m, np.int64), -np.ones(m, np.int64)])
    surf = np.concatenate([np.ones(1000, bool), np.zeros(2 * m, bool)])
    assert (to_np(ht.material) >= 0).mean() > 0.5
    seq = np.arange(p.shape[0], dtype=np.uint32) * 7 + 3
    rj, Lj = jcommon.sample_one_light(
        js, jrng.pcg32_init(jnp.asarray(seq)), *(jnp.asarray(x) for x in (p, n, wo)),
        jnp.asarray(mat, jnp.int32), jnp.asarray(med, jnp.int32),
        jnp.asarray(surf), tangent=jnp.asarray(tan), tr_crossings=2)
    rt, Lt = tcommon.sample_one_light(
        ts, trng.pcg32_init(torch.from_numpy(seq.astype(np.int64))),
        *(torch.from_numpy(x) for x in (p, n, wo, mat, med, surf)),
        tangent=torch.from_numpy(tan), tr_crossings=2)
    np.testing.assert_array_equal(to_np(rt.state) & 0xFFFFFFFF,
                                  to_np(rj.state_lo).astype(np.int64))
    Lj = to_np(Lj)
    for part in (slice(0, 1000), slice(1000, 1000 + m), slice(1000 + m, None)):
        assert (Lj[part] > 0).any(axis=1).mean() > 0.1
    np.testing.assert_allclose(to_np(Lt), Lj, rtol=1e-4, atol=1e-6)
