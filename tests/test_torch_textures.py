"""bre_tpu_torch.textures, the hits' uvs and the ray differentials against
bre_tpu, on the same numpy inputs from a seed: every texture kind, nested
graphs (tests/test_nested_textures.py), the MIP pyramid and the bilinear
and trilinear lookups (tests/test_image_maps.py:23-47), the EWA filter,
``generate_ray_differentials`` and ``compute_uv_differentials``
(tests/test_ewa.py:35-125), Perlin noise and its permutation table.

Tolerances: the Perlin family, the lookups and the EWA filter rtol 1e-5
(atol 1e-6: noise crosses zero); the pyramid and the table bit for bit;
the uvs, footprints and ray differentials rtol 1e-5 / atol 1e-6 (XLA:CPU
contracts multiply-adds, torch does not: ROADMAP Queue 3).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bre_tpu import textures as jt
from bre_tpu.core import transform as jtfm
from bre_tpu.scene import intersect as jisect
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu.scene.camera import generate_ray_differentials as jdiffs
from bre_tpu.scene.camera import make_perspective_camera as jcam
from bre_tpu.scene.parser import parse_string as jparse_string
from bre_tpu_torch import textures as tt
from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.scene import intersect as tisect
from bre_tpu_torch.scene.builder import SceneBuilder as TBuilder
from bre_tpu_torch.scene.camera import generate_ray_differentials as tdiffs
from bre_tpu_torch.scene.camera import make_perspective_camera as tcam
from bre_tpu_torch.scene.parser import parse_string as tparse_string
from bre_tpu_torch.scene.scene import scene_from_jax
from torch_parity import to_np

RTOL, ATOL = 1e-5, 1e-6
R = 4096


def _image(h=24, w=40, seed=0):
    return np.random.RandomState(seed).rand(h, w, 3).astype(np.float32)


def _every_kind(b):
    """One slot of each of the 12 kinds (and a second image), by name."""
    return dict(
        constant=b.tex_constant((0.3, 0.6, 0.9)),
        checkerboard=b.tex_checkerboard((1, 0.5, 0.2), (0.1, 0.2, 0.3),
                                        scale=2.5),
        uv=b.tex_uv(),
        fbm=b.tex_fbm((0.9, 0.8, 0.7), scale=1.7, omega=0.6),
        wrinkled=b.tex_wrinkled((0.5, 0.9, 0.4), scale=2.2, omega=0.45),
        marble=b.tex_marble(scale=1.3, omega=0.55),
        windy=b.tex_windy((0.8, 0.7, 0.9), scale=1.9),
        dots=b.tex_dots((1, 0.9, 0.8), (0.1, 0.05, 0.0)),
        scale=b.tex_scale((0.5, 0.6, 0.7), (0.9, 0.8, 0.2)),
        mix=b.tex_mix((0.1, 0.2, 0.3), (0.9, 0.8, 0.7), amount=0.3),
        imagemap=b.tex_imagemap(_image(), uscale=2.0, vscale=0.5,
                                udelta=0.1, vdelta=-0.2),
        imagemap_small=b.tex_imagemap(_image(7, 5, 1)),
        bilerp=b.tex_bilerp((0, 0.1, 0.2), (1, 0.9, 0.8), (0.3, 0.3, 0.3),
                            (0.7, 0.2, 0.9)),
    )


def _both(make):
    jb, tb = JBuilder(), TBuilder()
    ids = make(jb)
    assert make(tb) == ids
    for b in (jb, tb):
        b.sphere((0, 0, 0), 1.0)
    return ids, jb.build(), tb.build(device="cpu")


@pytest.fixture(scope="module")
def kinds():
    return _both(_every_kind)


def _points(seed, n=R):
    rs = np.random.RandomState(seed)
    p = rs.uniform(-6, 6, (n, 3)).astype(np.float32)
    uv = rs.uniform(-2, 3, (n, 2)).astype(np.float32)
    return p, uv


def _eval_both(js, ts, slots, p, uv, dx=None, dy=None):
    J, T = jnp.asarray, torch.from_numpy
    jo = np.asarray(jt.eval_texture(
        js.textures, J(slots.astype(np.int32)), J(p), J(uv),
        duv_dx=None if dx is None else J(dx), duv_dy=None if dy is None else J(dy)))
    to = to_np(tt.eval_texture(
        ts.textures, T(slots.astype(np.int64)), T(p), T(uv),
        duv_dx=None if dx is None else T(dx), duv_dy=None if dy is None else T(dy)))
    return to, jo


KINDS = ["constant", "checkerboard", "uv", "fbm", "wrinkled", "marble",
         "windy", "dots", "scale", "mix", "imagemap", "bilerp"]


@pytest.mark.parametrize("kind", KINDS)
def test_every_texture_kind_matches_jax(kinds, kind):
    ids, js, ts = kinds
    p, uv = _points(KINDS.index(kind))
    slots = np.full(R, ids[kind])
    slots[::10] = -1  # no texture: white
    to, jo = _eval_both(js, ts, slots, p, uv)
    np.testing.assert_allclose(to, jo, rtol=RTOL, atol=ATOL)
    assert np.ptp(jo[slots >= 0], 0).max() > 0 or kind in ("constant",
                                                          "scale", "mix")


def test_textures_table_matches_scene_from_jax(kinds):
    _, js, ts = kinds
    carried = scene_from_jax(js, device="cpu").textures
    for name in ts.textures._fields:
        a, b = getattr(ts.textures, name), getattr(carried, name)
        if isinstance(a, int):
            assert a == b, name
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), name
    np.testing.assert_array_equal(to_np(ts.textures.perm), jt._PERM_NP)


def test_perlin_noise_fbm_turbulence_match_jax():
    rs = np.random.RandomState(7)
    p = rs.uniform(-300, 300, (R, 3)).astype(np.float32)
    p[:64] = np.round(p[:64])  # lattice points
    om = rs.uniform(0.2, 0.8, R).astype(np.float32)
    perm = tt.empty_textures().perm
    T = torch.from_numpy
    np.testing.assert_allclose(to_np(tt.noise(T(p), perm)),
                               np.asarray(jt.noise(jnp.asarray(p))),
                               rtol=RTOL, atol=ATOL)
    for tf, jf in ((tt.fbm, jt.fbm), (tt.turbulence, jt.turbulence)):
        np.testing.assert_allclose(
            to_np(tf(T(p * 0.01), T(om), perm)),
            np.asarray(jf(jnp.asarray(p * 0.01), jnp.asarray(om))),
            rtol=RTOL, atol=ATOL)


def _nested(b):
    """tests/test_nested_textures.py's graphs: mix -> scale -> (checker,
    image), and a checkerboard over an fbm and a constant."""
    chk = b.tex_checkerboard((1, 0, 0), (0, 0, 1), scale=2.0)
    img = b.tex_imagemap(np.linspace(0, 1, 16 * 16 * 3).reshape(16, 16, 3))
    sc = b.tex_scale(tex1=chk, tex2=img)
    mx = b.tex_mix((0.2,) * 3, (0.8,) * 3, amount=0.25, tex1=sc)
    fb = b.tex_fbm((1.0, 1.0, 1.0))
    const = b.tex_constant((0.5, 0.25, 0.125))
    chk2 = b.tex_checkerboard(tex1=fb, tex2=const, scale=1.0)
    return dict(chk=chk, img=img, sc=sc, mx=mx, chk2=chk2)


def test_nested_graph_matches_jax():
    ids, js, ts = _both(_nested)
    assert ts.textures.depth == 2 == js.textures.nest.shape[0]
    p, uv = _points(11)
    for name in ("mx", "sc", "chk2"):
        to, jo = _eval_both(js, ts, np.full(R, ids[name]), p, uv)
        np.testing.assert_allclose(to, jo, rtol=RTOL, atol=ATOL, err_msg=name)
    # scale is the product of its children; mix lerps it with a constant
    def ev(name):
        return _eval_both(js, ts, np.full(R, ids[name]), p, uv)[0]
    np.testing.assert_allclose(ev("sc"), ev("chk") * ev("img"), rtol=1e-6)
    np.testing.assert_allclose(ev("mx"), 0.75 * ev("sc") + 0.25 * 0.8,
                               rtol=1e-5)
    # a mixed table: every slot, and none
    slots = np.random.RandomState(2).randint(-1, len(ids), R)
    to, jo = _eval_both(js, ts, slots, p, uv)
    np.testing.assert_allclose(to, jo, rtol=RTOL, atol=ATOL)


def test_nested_textures_parse_as_reference():
    text = ('Texture "c" "spectrum" "checkerboard" "rgb tex1" [1 0 0] '
            '"rgb tex2" [0 0 1]\n'
            'Texture "f" "spectrum" "fbm" "float roughness" 0.6\n'
            'Texture "s" "spectrum" "scale" "texture tex1" "c" '
            '"texture tex2" "f"\n'
            'Texture "m" "spectrum" "mix" "texture tex1" "s" '
            '"rgb tex2" [0.5 0.5 0.5] "float amount" 0.3\n'
            'Material "matte" "texture Kd" "m"\n'
            'Shape "sphere" "float radius" 1\n')
    text = 'Camera "perspective"\nWorldBegin\n' + text + 'WorldEnd\n'
    ts = tparse_string(text, device="cpu").build(device="cpu")
    js = jparse_string(text).build()
    ref = scene_from_jax(js, device="cpu")
    assert ts.textures.depth == ref.textures.depth == 2
    for name in ts.textures._fields:
        if name != "depth":
            assert torch.equal(getattr(ts.textures, name),
                               getattr(ref.textures, name)), name
    p, uv = _points(12, 512)
    to, jo = _eval_both(js, ts, np.full(512, 3), p, uv)
    np.testing.assert_allclose(to, jo, rtol=RTOL, atol=ATOL)


def test_mipmap_pyramid_and_atlas_bit_for_bit():
    for shape in ((16, 8, 3), (7, 5, 3), (1, 9, 3), (12, 12)):
        img = np.random.RandomState(0).rand(*shape).astype(np.float32)
        pt, pj = tt.build_pyramid(img), jt.build_pyramid(img)
        assert len(pt) == len(pj)
        for a, b in zip(pt, pj):
            np.testing.assert_array_equal(a, b)
    py = [tt.build_pyramid(_image()), tt.build_pyramid(_image(7, 5, 1))]
    (at, ot), (aj, oj) = tt.pack_atlas(py), jt.pack_atlas(py)
    np.testing.assert_array_equal(at, aj)
    assert ot == oj
    img = np.random.RandomState(0).rand(16, 8, 3).astype(np.float32)
    np.testing.assert_allclose(tt.build_pyramid(img)[-1][0, 0],
                               img.reshape(-1, 3).mean(0), rtol=1e-5)


def test_image_lookup_bilinear_and_trilinear(kinds):
    """tests/test_image_maps.py::test_imagemap_texture_bilinear_and_trilinear
    on the port, and both lookups against bre_tpu at random lods."""
    img = np.zeros((4, 4, 3), np.float32)
    img[:, :2] = 1.0
    b = TBuilder()
    t = b.tex_imagemap(img)
    b.sphere((0, 0, 0), 1.0, material=b.matte(kd_tex=t))
    tex = b.build(device="cpu").textures
    ti = torch.zeros(2, dtype=torch.int64)
    uv = torch.tensor([[0.25, 0.5], [0.75, 0.5]])
    col = tt.eval_texture(tex, ti, torch.zeros((2, 3)), uv)
    np.testing.assert_allclose(to_np(col)[:, 0], [1.0, 0.0], atol=1e-5)
    col2 = tt.image_lookup(tex, ti, uv, lod=torch.full((2,), 10.0))
    np.testing.assert_allclose(to_np(col2)[:, 0], 0.5, atol=1e-5)

    ids, js, ts = kinds
    _, uv = _points(13)
    rs = np.random.RandomState(14)
    slots = np.where(rs.rand(R) < 0.5, ids["imagemap"], ids["imagemap_small"])
    lod = rs.uniform(-1, 8, R).astype(np.float32)
    for lv in (None, lod):
        to = to_np(tt.image_lookup(ts.textures, torch.from_numpy(slots),
                                   torch.from_numpy(uv),
                                   None if lv is None else torch.from_numpy(lv)))
        jo = np.asarray(jt.image_lookup(js.textures, jnp.asarray(slots),
                                        jnp.asarray(uv),
                                        None if lv is None else jnp.asarray(lv)))
        np.testing.assert_allclose(to, jo, rtol=RTOL, atol=ATOL)


def test_image_lookup_ewa_matches_jax(kinds):
    ids, js, ts = kinds
    _, uv = _points(15, 1024)
    rs = np.random.RandomState(16)
    n = uv.shape[0]
    slots = np.where(rs.rand(n) < 0.5, ids["imagemap"], ids["imagemap_small"])
    scale = 10.0 ** rs.uniform(-4, -0.5, (n, 1))
    dx = (rs.normal(size=(n, 2)) * scale).astype(np.float32)
    dy = (rs.normal(size=(n, 2)) * scale).astype(np.float32)
    dy[:64] = dx[:64] * 0.01  # past MAX_ANISOTROPY
    dx[64:72] = 0.0  # degenerate footprints
    dy[64:72] = 0.0
    to, jo = _eval_both(js, ts, slots, np.zeros((n, 3), np.float32), uv, dx, dy)
    np.testing.assert_allclose(to, jo, rtol=RTOL, atol=ATOL)


def _checker_scene(b, ntex=64, vstripes=False):
    """tests/test_ewa.py's plane z=4 with a checker or stripe image."""
    img = np.zeros((ntex, ntex, 3), np.float32)
    if vstripes:
        img[:, ::2] = 1.0
    else:
        xx, yy = np.meshgrid(np.arange(ntex), np.arange(ntex))
        img[((xx // 2 + yy // 2) % 2) == 0] = 1.0
    m = b.matte(kd=(1, 1, 1), kd_tex=b.tex_imagemap(img))
    L = 2.0
    b.triangle((-L, -L, 4), (L, -L, 4), (L, L, 4), material=m)
    b.triangle((-L, -L, 4), (L, L, 4), (-L, L, 4), material=m)
    b.point_light((0, 0, 0), intensity=(30, 30, 30))
    return b.build(**({} if isinstance(b, JBuilder) else dict(device="cpu")))


def test_ewa_filter_properties():
    """tests/test_ewa.py's constant, wide/narrow and anisotropy checks on
    the port."""
    b = TBuilder()
    b.matte(kd=(1, 1, 1), kd_tex=b.tex_imagemap(np.full((16, 16, 3), 0.75,
                                                        np.float32)))
    tex = b.build(device="cpu").textures
    n = 8
    uv = torch.from_numpy(np.random.RandomState(0).uniform(0, 1, (n, 2))
                          .astype(np.float32))
    ti = torch.zeros(n, dtype=torch.int64)
    for s in (1e-3, 0.05, 0.4):
        col = tt.image_lookup_ewa(tex, ti, uv, torch.tensor([[s, 0.0]]).repeat(n, 1),
                                  torch.tensor([[0.0, s]]).repeat(n, 1))
        np.testing.assert_allclose(to_np(col), 0.75, rtol=1e-4)

    tex = _checker_scene(TBuilder()).textures
    n = 64
    uv = torch.from_numpy(np.random.RandomState(1).uniform(0.1, 0.9, (n, 2))
                          .astype(np.float32))
    ti = torch.zeros(n, dtype=torch.int64)

    def ewa(t, u, a, c):
        m = u.shape[0]
        return to_np(tt.image_lookup_ewa(t, ti[:m], u,
                                         torch.tensor([a]).repeat(m, 1),
                                         torch.tensor([c]).repeat(m, 1)))
    wide = ewa(tex, uv, [0.25, 0.0], [0.0, 0.25])
    np.testing.assert_allclose(wide.mean(0), 0.5, atol=0.06)
    assert wide.std() < 0.1
    narrow = ewa(tex, uv, [1e-4, 0.0], [0.0, 1e-4])
    np.testing.assert_allclose(narrow, to_np(tt.image_lookup(tex, ti, uv)),
                               atol=0.25)
    assert narrow.std() > 0.3
    tex = _checker_scene(TBuilder(), vstripes=True).textures
    m = 32
    us = (np.arange(m) % 32) / 64.0 + 1.0 / 128.0
    uv = torch.from_numpy(np.stack([us, np.full(m, 0.5)], -1).astype(np.float32))
    aniso = ewa(tex, uv, [1.0 / 64.0, 0.0], [0.0, 0.125])
    iso = ewa(tex, uv, [0.125, 0.0], [0.0, 0.125])
    assert aniso.std() > 2.0 * max(iso.std(), 1e-3), (aniso.std(), iso.std())
    np.testing.assert_allclose(iso.mean(), 0.5, atol=0.08)


def _uv_scene(b):
    """A sphere, and triangles with explicit and default uvs."""
    b.sphere((0.3, -0.2, 5.0), 1.2, material=b.matte())
    b.triangle((-3, -3, 7), (3, -3, 7), (3, 3, 7), material=0,
               uv0=(0.1, 0.2), uv1=(2.0, -0.5), uv2=(1.5, 3.0))
    b.triangle((-3, -3, 7), (3, 3, 7), (-3, 3, 7), material=0)
    return b.build(**({} if isinstance(b, JBuilder) else dict(device="cpu")))


def test_ray_differentials_and_uv_footprints_match_jax():
    W = H = 48
    look = ((0, 0, 0), (0, 0, 4), (0, 1, 0))
    jc = jcam(jtfm.look_at(*look), 40.0, W, H)
    tc = tcam(ttfm.look_at(*look), 40.0, W, H, device="cpu")
    js, ts = _uv_scene(JBuilder()), _uv_scene(TBuilder())
    pr = np.random.RandomState(3).uniform(0, W, (2048, 2)).astype(np.float32)
    rj = jdiffs(jc, jnp.asarray(pr))
    rt = tdiffs(tc, torch.from_numpy(pr))
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=RTOL, atol=ATOL)
    hj = jisect.intersect(js, rj[0], rj[1])
    ht = tisect.intersect(ts, rt[0], rt[1])
    assert to_np(ht.valid).mean() > 0.5
    np.testing.assert_array_equal(to_np(ht.valid), np.asarray(hj.valid))
    v = np.asarray(hj.valid)
    np.testing.assert_array_equal(to_np(ht.prim_kind)[v],
                                  np.asarray(hj.prim_kind)[v])
    np.testing.assert_allclose(to_np(ht.uv)[v], np.asarray(hj.uv)[v],
                               rtol=RTOL, atol=ATOL)
    for a, b in zip(tisect.hit_dpduv(ts, ht), jisect.hit_dpduv(js, hj)):
        np.testing.assert_allclose(to_np(a)[v], np.asarray(b)[v], rtol=RTOL,
                                   atol=ATOL)
    dj = jisect.compute_uv_differentials(js, hj, *rj[:2], *rj[3:])
    dt = tisect.compute_uv_differentials(ts, ht, *rt[:2], *rt[3:])
    for a, b in zip(dt, dj):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


def test_camera_ray_differentials_footprint():
    """tests/test_ewa.py::test_camera_ray_differentials_footprint on the
    port: the footprint on a frontal plane is 2 z tan(fov/2) / xres."""
    W = H = 32
    cam = tcam(ttfm.look_at((0, 0, 0), (0, 0, 4), (0, 1, 0)), 40.0, W, H,
               device="cpu")
    sc = _checker_scene(TBuilder())
    o, d, w, rx_o, rx_d, ry_o, ry_d = tdiffs(
        cam, torch.tensor([[W / 2 + 0.5, H / 2 + 0.5]]))
    h = tisect.intersect(sc, o, d)
    assert bool(h.valid[0])
    duv_dx, duv_dy = tisect.compute_uv_differentials(sc, h, o, d, rx_o, rx_d,
                                                     ry_o, ry_d)
    dpdu, dpdv = tisect.hit_dpduv(sc, h)
    expect = 2.0 * 4.0 * np.tan(np.deg2rad(40.0) / 2) / W
    for duv in (duv_dx, duv_dy):
        dp = duv[0, 0] * dpdu[0] + duv[0, 1] * dpdv[0]
        got = float(torch.linalg.norm(dp))
        assert abs(got - expect) / expect < 0.05, (got, expect)
