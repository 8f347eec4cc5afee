"""The building blocks of bidirectional path tracing in bre_tpu_torch
against bre_tpu, on the CPU: the camera and light subpaths of one pass,
every (s,t) strategy's contribution and MIS weight, and the whole render,
on tests/test_bdpt.py's fog shell lit by a small sphere light (medium and
surface vertices, a sphere area light, both transport modes) at 8x8,
2 samples per pixel, maxdepth 3.  bre_tpu renders once: its jitted pass
records the subpaths, the streams, each strategy's output and each MIS
weight through ordered ``jax.debug.callback`` taps on the module's
functions, so one compile serves the building blocks and the render.
The reference's reuse of draws in ``_segment_interaction`` is
tests/test_torch_bdpt_media.py.

Tolerances and their reasons:
- integer fields of every vertex (valid, vtype, light_idx, mat, med,
  area_light) and the delta and connectible flags: exact on every lane;
  the PCG32 state after the subpaths and after the strategies: exact.
- positions, normals and beta: rtol 1e-4, atol 1e-5 x the field's
  largest value (a unit normal's component near 0 differs in its last
  ulps of the other components' scale).  XLA:CPU contracts multiply-adds and torch does not
  (ROADMAP Queue 3), and the camera's inverse rounds differently
  (tests/test_torch_camera_lights.py); a vertex four bounces on carries
  the ulps of every bounce before it.
- the area pdfs, the MIS weights built from them and L: rtol 1e-3 (the
  same atol).  An area pdf divides by the squared length of its segment,
  and a short segment in the fog (a scatter 1e-3 from the last vertex)
  loses three digits of its length to the cancellation of p - p_prev.
- the whole render: the image mean within rtol 1e-5, the 4x4 region means
  (the splats land within a region whatever pixel edge a raster
  coordinate rounds to) within rtol 1e-4, and 99% of the pixels within
  rtol 1e-3, atol 1e-6.  The port walks both samples as one batch
  (bre_tpu runs one pass per sample) and splats the t = 1 strategies
  with a sorted segment sum in lane order (bre_tpu with ``.at[].add``).
"""

import numpy as np
import pytest
import torch

import jax
from bre_tpu.core import transform as jtfm
from bre_tpu.integrators import bdpt as jb
from bre_tpu.scene import camera as jcam
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.core.math import ordered_index_sum
from bre_tpu_torch.integrators import bdpt as tb
from bre_tpu_torch.lights import light_choice_pmf
from bre_tpu_torch.scene import camera as tcam
from bre_tpu_torch.scene.builder import SceneBuilder
from torch_parity import pcg_state, pixels_close, region_means, to_np

WH, MAXDEPTH, SPP, SAMPLE = 8, 3, 2, 1
LOOK = ((0, 0, 0), (0, 0, 1), (0, 1, 0))
INT_FIELDS = ("valid", "vtype", "light_idx", "mat", "med", "area_light",
              "delta", "connectible")
FLOAT_FIELDS = ("p", "n", "ns", "beta", "pdf_fwd", "pdf_rev", "wo")


def fog_sphere_light(b, **build_kw):
    """tests/test_bdpt.py:75-101's scene: a matte shell filled with fog, a
    small two-sided sphere light inside it, the camera in the fog."""
    med = b.homogeneous_medium(sigma_a=(0.1,) * 3, sigma_s=(0.6,) * 3, g=0.0)
    m = b.matte((0.5, 0.5, 0.5))
    b.sphere((0, 0, 0), 1.0, material=m, medium_inside=med)
    b.area_light_sphere((0.0, 0.4, 0.5), 0.15, (4.0, 4.0, 4.0), material=m,
                        two_sided=True, medium=med)
    b.camera_medium = med
    return b.build(**build_kw)


def sphere_point_light(b, **build_kw):
    """tests/test_bdpt.py:27-32's scene: a matte sphere lit from its
    center by a point light of intensity pi."""
    m = b.matte((0.5, 0.5, 0.5))
    b.sphere((0, 0, 0), 1.0, material=m)
    b.point_light((0, 0, 0), (np.pi,) * 3)
    return b.build(**build_kw)


def cameras(wh=WH):
    return (tcam.make_perspective_camera(ttfm.look_at(*LOOK), 60.0, wh, wh,
                                         device="cpu"),
            jcam.make_perspective_camera(jtfm.look_at(*LOOK), 60.0, wh, wh))


def _tap(store, tag, value):
    """Record ``value`` from inside a jitted function, in program order."""
    jax.debug.callback(lambda v: store.append(
        (tag, jax.tree_util.tree_map(np.array, v))), value, ordered=True)


def _tapping(store, tag, fn, smp_arg=None):
    """``fn`` that records its output, and the stream of its PathSampler
    argument (positional ``smp_arg``) after it."""
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        _tap(store, tag, out)
        if smp_arg is not None:
            _tap(store, tag + " rng", args[smp_arg].rng)
        return out
    return wrapped


def _reference_render(store):
    """bre_tpu's render of the fog shell, its pass's pieces tapped into
    ``store``.  Returns (image, the pieces of pass SAMPLE as
    (camera subpath, light subpath, stream after them, [strategy outputs],
    [MIS weights], stream after the strategies))."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jb, "_generate_camera_subpath",
               _tapping(store, "camera", jb._generate_camera_subpath))
    mp.setattr(jb, "_generate_light_subpath",
               _tapping(store, "light", jb._generate_light_subpath, 1))
    mp.setattr(jb, "connect_bdpt",
               _tapping(store, "strategy", jb.connect_bdpt, 8))
    mp.setattr(jb, "_mis_weight", _tapping(store, "mis", jb._mis_weight))
    try:
        img = np.asarray(jb.render_bdpt(
            fog_sphere_light(JBuilder()), cameras()[1], WH, WH,
            jb.BDPTConfig(maxdepth=MAXDEPTH, spp=SPP)))
    finally:
        mp.undo()
    starts = [i for i, (tag, _) in enumerate(store) if tag == "camera"]
    assert len(starts) == SPP
    rec = store[starts[SAMPLE]:(starts + [len(store)])[SAMPLE + 1]]

    def get(tag):
        return [v for t, v in rec if t == tag]
    return img, (get("camera")[0], get("light")[0], get("light rng")[0],
                 get("strategy"), get("mis"), get("strategy rng")[-1])


@pytest.fixture(scope="module")
def passes():
    """One pass of sample SAMPLE in both packages: the subpaths, the
    stream after them, each strategy's (L, MIS weight), and the stream
    after the strategies; and both packages' whole renders."""
    img_j, ref = _reference_render([])
    ts = fog_sphere_light(SceneBuilder(), device="cpu")
    cam_t = cameras()[0]
    R = WH * WH
    pairs = tb.strategies(MAXDEPTH)
    weights_t = []
    mp = pytest.MonkeyPatch()
    inner = tb._mis_weight

    def recording(*args, **kw):
        weights_t.append(inner(*args, **kw))
        return weights_t[-1]
    mp.setattr(tb, "_mis_weight", recording)
    pix = torch.arange(R, dtype=torch.int64)
    cfg = tb.BDPTConfig(maxdepth=MAXDEPTH, spp=SPP, tr_crossings=0)
    pmf_t = light_choice_pmf(ts)
    cam_vs, light_vs, smp = tb.subpaths(ts, cam_t, WH, WH, pix,
                                        torch.full((R,), SAMPLE), cfg, pmf_t)
    rng_paths = smp.rng
    out = [tb.connect_bdpt(ts, cam_t, WH, WH, cam_vs, light_vs, s, t, smp,
                           pmf_t, tr_crossings=0) for s, t in pairs]
    mp.undo()
    img_t = to_np(tb.render_bdpt(ts, cam_t, WH, WH,
                                 tb.BDPTConfig(maxdepth=MAXDEPTH, spp=SPP)))
    return dict(ref=ref, cam_vs=cam_vs, light_vs=light_vs,
                rng_paths=rng_paths, out=out, weights=weights_t,
                rng_end=smp.rng, pairs=pairs, img_t=img_t, img_j=img_j)


def assert_renders_close(img_t, img_j):
    """The whole-render tolerances of the module docstring."""
    assert img_t.shape == img_j.shape == (WH, WH, 3)
    assert np.isfinite(img_t).all() and img_j.mean() > 0
    np.testing.assert_allclose(img_t.mean(), img_j.mean(), rtol=1e-5)
    np.testing.assert_allclose(region_means(img_t), region_means(img_j),
                               rtol=1e-4, atol=1e-7)
    pixels_close(img_t, img_j)


def _close(a, b, what, rtol=1e-4):
    a, b = to_np(a).astype(np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=1e-5 * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("side", ["camera", "light"])
def test_subpaths_match_jax(passes, side):
    mine = passes["cam_vs" if side == "camera" else "light_vs"]
    ref = passes["ref"][0 if side == "camera" else 1]
    assert len(mine) == len(ref) == (MAXDEPTH + 2 if side == "camera"
                                     else MAXDEPTH + 1)
    kinds = set()
    for k, (vt, vj) in enumerate(zip(mine, ref)):
        for f in INT_FIELDS:
            np.testing.assert_array_equal(to_np(getattr(vt, f)),
                                          np.asarray(getattr(vj, f)),
                                          err_msg=f"{side} vertex {k} {f}")
        for f in FLOAT_FIELDS:
            _close(getattr(vt, f), getattr(vj, f), f"{side} vertex {k} {f}",
                   rtol=1e-3 if f.startswith("pdf") else 1e-4)
        kinds |= set(np.unique(np.asarray(vj.vtype)[np.asarray(vj.valid)]))
    # the walks reach medium and surface vertices (and the light, its own)
    assert {jb.VT_MEDIUM, jb.VT_SURFACE} <= kinds


def test_streams_after_subpaths_and_strategies(passes):
    ref = passes["ref"]
    np.testing.assert_array_equal(to_np(passes["rng_paths"].state),
                                  pcg_state(ref[2]))
    np.testing.assert_array_equal(to_np(passes["rng_end"].state),
                                  pcg_state(ref[5]))


def test_each_strategy_matches_jax(passes):
    ref_out, ref_w = passes["ref"][3], passes["ref"][4]
    assert len(passes["weights"]) == len(ref_w) == len(passes["pairs"])
    seen = 0
    for (s, t), mine, ref, w_t, w_j in zip(passes["pairs"], passes["out"],
                                           ref_out, passes["weights"], ref_w):
        L_t, raster_t, _, ok_t = mine
        L_j, raster_j, _, ok_j = ref
        _close(L_t, L_j, f"L of (s={s}, t={t})", rtol=1e-3)
        _close(w_t, w_j, f"MIS weight of (s={s}, t={t})", rtol=1e-3)
        np.testing.assert_array_equal(to_np(ok_t), ok_j)
        if t == 1:
            _close(raster_t, raster_j, f"raster of (s={s}, t={t})")
        seen += bool((np.abs(L_j).sum(-1) > 0).any())
    assert seen >= len(passes["pairs"]) - 2  # nearly every strategy adds


def test_render_bdpt_fog_sphere_light_matches_jax(passes):
    assert_renders_close(passes["img_t"], passes["img_j"])


def test_strategies_in_the_reference_order():
    assert tb.strategies(2) == [(2, 1), (3, 1), (0, 2), (1, 2), (2, 2),
                                (0, 3), (1, 3), (0, 4)]
    # (maxdepth + 2)(maxdepth + 3)/2 pairs of depth <= maxdepth, less the
    # two t = 1 pairs with s < 2
    for md in range(1, 7):
        assert len(tb.strategies(md)) == (md + 2) * (md + 3) // 2 - 2


def test_ordered_index_sum_is_index_add_in_lane_order():
    rs = np.random.RandomState(12)
    n, rows = 5000, 37
    ids = torch.from_numpy(rs.randint(0, rows, n))
    ids[:700] = 3  # a run longer than a piece
    vals = torch.from_numpy(rs.normal(size=(n, 3)).astype(np.float32))
    got = ordered_index_sum(ids, vals, rows + 2)
    want = torch.zeros((rows + 2, 3), dtype=torch.float64).index_add_(
        0, ids, vals.double())
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-5, atol=1e-5)
    assert torch.equal(got, ordered_index_sum(ids, vals, rows + 2))
    assert (got[rows:] == 0).all()
