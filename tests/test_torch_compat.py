"""kernel="compat" in bre_tpu_torch against bre_tpu: the reference
renderer's pair math, its splitting photon walk and the compat render, on
the CPU, the same inputs through both packages.

Tolerances and their reasons:
- ``closest_points_segments`` and the compat ``_chunk_contrib``: rtol 1e-5
  (atol 1e-6 on points of magnitude ~1 and 1e-12 on contributions of
  magnitude ~1e-6): XLA:CPU contracts multiply-adds, torch does not
  (ROADMAP Queue 3), so the last ulps differ.  The validity and the
  slab-test mask agree bit for bit except where a comparison sits within
  1e-5 of its tie.
- The homogeneous compat walk (fog_golden.pbrt): every integer bit for
  bit (beam validity, per-photon scatter, surface and beam counts, the
  final PCG32 states), beam floats rtol 1e-5 / atol 1e-5.
- The grid walk (smoke_golden.pbrt): the same; its scatters come from delta
  tracking on the auxiliary stream, and at these sizes no float flips a
  decision (measured: every integer equal).
- The compat render at 16x16, 2 iterations x 500 photons: image means
  within 0.5% and 99% of pixels within rtol 1e-3 (tests/test_torch_render.py's
  tolerances: a float-ulp difference may flip a photon or camera decision).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bre_tpu.accel import beam_gather as jbg
from bre_tpu.core import transform as jtfm
from bre_tpu.integrators import photonbeam as jpb
from bre_tpu.integrators.common import default_tr_crossings
from bre_tpu.integrators.photon_trace import \
    trace_photon_beams_compat as jtrace
from bre_tpu.lights import light_power_distribution as jlpd
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu.scene.camera import make_perspective_camera as jcam
from bre_tpu.scene.parser import parse_file as jparse
from bre_tpu_torch.accel import beam_gather as tbg
from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.integrators import photonbeam as tpb
from bre_tpu_torch.integrators.photon_trace import \
    trace_photon_beams_compat as ttrace
from bre_tpu_torch.lights import light_power_distribution as tlpd
from bre_tpu_torch.scene.camera import make_perspective_camera as tcam
from bre_tpu_torch.scene.parser import parse_file as tparse
from bre_tpu_torch.scene.scene import scene_from_jax
from test_photonbeam import fog_cube_scene
from torch_parity import smoke_hetero, to_np

DATA = Path(__file__).parent / "data"
FOG_GOLDEN = str(DATA / "fog_golden.pbrt")
SMOKE_GOLDEN = str(DATA / "smoke_golden.pbrt")


def _segments(n, seed):
    """Random camera and beam segments: general position, negative
    directions, axis-aligned (degenerate slab axes), parallel pairs and
    point segments."""
    rs = np.random.RandomState(seed)
    a0 = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    a1 = a0 + rs.normal(size=(n, 3)).astype(np.float32)
    b0 = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    b1 = b0 + rs.normal(size=(n, 3)).astype(np.float32)
    k = n // 8
    a1[:k] = a0[:k] + np.array([0.0, 0.0, -1.3], np.float32)  # one axis only
    b1[k:2 * k] = b0[k:2 * k] + np.array([-0.7, 0.0, 0.0], np.float32)
    b1[2 * k:3 * k] = b0[2 * k:3 * k] + 0.5 * (a1 - a0)[2 * k:3 * k]  # parallel
    a1[3 * k:3 * k + 8] = a0[3 * k:3 * k + 8]  # camera point segments
    b1[3 * k + 8:3 * k + 16] = b0[3 * k + 8:3 * k + 16]  # beam points
    return a0, a1, b0, b1


def test_closest_points_segments_matches_jax():
    a0, a1, b0, b1 = _segments(4096, 0)
    pj = jbg.closest_points_segments(*(jnp.asarray(x) for x in (a0, a1, b0, b1)))
    pt = tbg.closest_points_segments(*(torch.from_numpy(x)
                                       for x in (a0, a1, b0, b1)))
    vj, vt = to_np(pj[2]), to_np(pt[2])
    assert 0.05 < 1 - vj.mean() < 0.3  # the parallel pairs are invalid
    np.testing.assert_array_equal(vt, vj)
    for name, t, j in (("pa", pt[0], pj[0]), ("pb", pt[1], pj[1])):
        np.testing.assert_allclose(to_np(t)[vj], to_np(j)[vj], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def _chunk_inputs(R=512, C=384, seed=1):
    """Camera segments from a common eye region and beams of radius 0.2,
    many of them pointing toward -x/-y/-z (the collapsed signed boxes)."""
    rs = np.random.RandomState(seed)
    a0 = rs.uniform(-1, 1, (R, 3)).astype(np.float32)
    d = rs.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:16] = [0.0, 0.0, 1.0]  # axis-aligned camera rays
    d[16:24] = [-1.0, 0.0, 0.0]
    ln = rs.uniform(0.5, 2.0, (R,)).astype(np.float32)
    a1 = a0 + ln[:, None] * d
    start = rs.uniform(-1, 1, (C, 3)).astype(np.float32)
    bd = rs.normal(size=(C, 3)).astype(np.float32)
    bd[: C // 3] = -np.abs(bd[: C // 3])
    end = start + rs.uniform(0.1, 1.5, (C, 1)).astype(np.float32) * bd
    pe = rs.uniform(0.1, 3.0, (C, 3)).astype(np.float32)
    valid = (rs.rand(C) < 0.9).astype(np.float32)
    cb = dict(start=start, end=end, power_start=np.zeros_like(pe),
              power_end=pe, radius=np.full((C,), 0.2, np.float32),
              valid_f=valid)
    seg = dict(a0=a0, a1=a1, dir=d, len=np.linalg.norm(a1 - a0, axis=-1),
               tr_full=np.ones((R, 3), np.float32),
               sigma_s=np.ones((R, 3), np.float32),
               g=np.zeros((R,), np.float32), in_med_f=np.ones((R,), np.float32),
               cam_radius=np.float32(0.15))
    return cb, seg


def test_compat_chunk_contrib_matches_jax():
    cb, seg = _chunk_inputs()
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}  # noqa: E731
    out_j = to_np(jbg._chunk_contrib(j(cb), j(seg), jbg.KERNEL_COMPAT, 1.0,
                                     0.05))
    out_t = to_np(tbg._chunk_contrib(t(cb), t(seg), tbg.KERNEL_COMPAT, 1.0,
                                     0.05))
    assert (out_j > 0).any(-1).mean() > 0.3
    # the slab test and the range test decide the same pairs: each ray's
    # sum is non-zero in both or in neither
    np.testing.assert_array_equal(out_t > 0, out_j > 0)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-12)


def test_compat_slab_mask_matches_jax_pair_by_pair():
    """The pair mask itself, one beam at a time: the compat kernel of a
    one-beam chunk is non-zero exactly where the range and slab tests pass,
    so its pattern over rays is the mask.  Bit for bit except within 1e-5
    of a tie of r against 1 (none at this seed)."""
    cb, seg = _chunk_inputs(R=256, C=96, seed=2)
    cb["power_end"][:] = 1.0
    cb["valid_f"][:] = 1.0
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}  # noqa: E731
    mj, mt = [], []
    for c in range(96):
        one = {k: v[c:c + 1] for k, v in cb.items()}
        mj.append(to_np(jbg._chunk_contrib(j(one), j(seg), jbg.KERNEL_COMPAT,
                                           1.0, 0.05))[:, 0] > 0)
        mt.append(to_np(tbg._chunk_contrib(t(one), t(seg), tbg.KERNEL_COMPAT,
                                           1.0, 0.05))[:, 0] > 0)
    mj, mt = np.stack(mj), np.stack(mt)
    assert 0.01 < mj.mean() < 0.5
    np.testing.assert_array_equal(mt, mj)


def test_gather_core_kernel_forward_refuses_compat():
    """The forward kernel computes the normalized estimate only:
    _GatherCore's kernel forward raises for KERNEL_COMPAT before anything
    is packed or launched (on a card too; here its plain version would run)."""
    cb, seg = _chunk_inputs(R=16, C=256)
    pb = {k: torch.as_tensor(v) for k, v in cb.items()}
    sg = {k: torch.as_tensor(v) for k, v in seg.items()}
    sg["n_valid_beams"] = pb["valid_f"].sum()
    cfg = tbg._Cfg(tbg.KERNEL_COMPAT, 256, 1, 1.0, 0.05, True, True, "pallas")
    with pytest.raises(ValueError, match="KERNEL_BRE"):
        tbg._GatherCore.apply(cfg, tuple(pb), tuple(sg), *pb.values(),
                              *sg.values())
    # the route never sends compat there: "pallas" takes the chunk scan
    beams = tbg.compact_beams(_beams_of(pb))
    args = (beams, scene_from_jax(fog_cube_scene().build(), device="cpu").media,
            sg["a0"], sg["a1"], sg["dir"], torch.zeros(16, dtype=torch.int64),
            sg["tr_full"], 0.15)
    out = tbg.gather_beams_bruteforce(*args, kernel=tbg.KERNEL_COMPAT,
                                      chunk=256, backend="pallas",
                                      assume_compacted=True)
    ref = tbg.gather_beams_bruteforce(*args, kernel=tbg.KERNEL_COMPAT,
                                      chunk=256, backend="xla",
                                      assume_compacted=True)
    assert torch.equal(out, ref) and float(ref.abs().sum()) > 0


def _beams_of(pb):
    from bre_tpu_torch.integrators.photon_trace import Beams

    C = pb["radius"].shape[0]
    return Beams(start=pb["start"], end=pb["end"],
                 power_start=pb["power_start"], power_end=pb["power_end"],
                 radius=pb["radius"], medium=torch.zeros(C, dtype=torch.int64),
                 valid=pb["valid_f"] > 0)


def _u64(state_hi, state_lo):
    """A reference PCG32 (hi, lo) uint32 pair -> the port's int64 pattern."""
    v = (np.asarray(state_hi, np.uint64) << np.uint64(32)) | np.asarray(
        state_lo, np.uint64)
    return v.view(np.int64)


def _trace_pair(path, P, maxdepth, radius, ids=None, n_steps=0):
    js = jparse(path).build()
    ts = tparse(path, device="cpu").build(device="cpu")
    ids = np.arange(P, dtype=np.uint32) if ids is None else ids
    bj, sj = jtrace(js, jlpd(js), jnp.asarray(ids), maxdepth,
                    jnp.float32(radius), n_steps=n_steps,
                    per_photon_stats=True)
    bt, st = ttrace(ts, tlpd(ts), torch.from_numpy(ids.astype(np.int64)),
                    maxdepth, radius, per_photon_stats=True)
    return bj, sj, bt, st


def _assert_walks_equal(bj, sj, bt, st):
    for k in ("n_medium_scatter", "n_surface", "n_beams", "n_overflow_steps",
              "photon_paths"):
        assert int(st[k]) == int(sj[k]), k
    for k in ("lane_medium", "lane_surface", "lane_beam"):
        np.testing.assert_array_equal(to_np(st[k]), to_np(sj[k]), err_msg=k)
    vj = to_np(bj.valid)
    np.testing.assert_array_equal(to_np(bt.valid), vj)
    np.testing.assert_array_equal(to_np(bt.medium)[vj], to_np(bj.medium)[vj])
    for k in ("start", "end", "power_end", "radius"):
        np.testing.assert_allclose(to_np(getattr(bt, k))[vj],
                                   to_np(getattr(bj, k))[vj], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert not to_np(bt.power_start).any()


def test_trace_compat_fog_golden_matches_jax():
    """BASELINE config 1's scene at the fog gate's photons: the splitting
    walk bit for bit in every integer, and (below) the streams."""
    bj, sj, bt, st = _trace_pair(FOG_GOLDEN, 2000, 3, 0.25)
    _assert_walks_equal(bj, sj, bt, st)
    lane_m = to_np(st["lane_medium"])
    assert int(st["n_medium_scatter"]) > 1000 and lane_m.max() >= 3
    assert int(st["n_overflow_steps"]) == 0


def test_trace_compat_streams_match_jax():
    """The final PCG32 states, main and auxiliary, bit for bit, on the 8
    fog-golden photons that branch most (the reference's per-step
    diagnostic path holds at most 8 lanes; its state before step n_steps+1
    is the port's final state)."""
    _, _, _, st_all = _trace_pair(FOG_GOLDEN, 2000, 3, 0.25)
    order = np.argsort(-to_np(st_all["lane_medium"]), kind="stable")
    ids = np.sort(order[:8]).astype(np.uint32)
    n_steps = 4 * (3 + 1)
    _, _, _, st = _trace_pair(FOG_GOLDEN, 8, 3, 0.25, ids=ids,
                              n_steps=n_steps + 1)
    final = jtrace._last_trajectory[-1]
    for key, jkey in (("lane_rng", "rng"), ("lane_rng_grid", "rng_grid")):
        j = np.asarray(final[jkey])  # (state_hi, state_lo, inc_hi, inc_lo)
        np.testing.assert_array_equal(to_np(st[key].state), _u64(j[0], j[1]),
                                      err_msg=key)
        np.testing.assert_array_equal(to_np(st[key].inc), _u64(j[2], j[3]),
                                      err_msg=key)
    assert to_np(st["lane_medium"]).min() >= 2


def test_trace_compat_smoke_golden_matches_jax():
    """The grid scene (smoke_golden.pbrt, 32^3 density): delta tracking on
    the auxiliary stream and the quadrature Tr."""
    bj, sj, bt, st = _trace_pair(SMOKE_GOLDEN, 4000, 5, 0.15)
    assert int(st["n_medium_scatter"]) > 100
    _assert_walks_equal(bj, sj, bt, st)


LOOK = ((0, 0, -3.5), (0, 0, 0), (0, 1, 0))
W = 16
CFG = dict(iterations=2, maxdepth=4, photonsperiteration=500,
           initialbeamradius=0.2, alpha=0.5, kernel="compat")


def _assert_images_close(it, ij):
    assert it.shape == ij.shape == (W, W, 3)
    assert np.isfinite(it).all() and ij.mean() > 0
    assert abs(it.mean() / ij.mean() - 1.0) < 5e-3
    close = np.isclose(it, ij, rtol=1e-3, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, close.mean()


def test_render_compat_fog_matches_jax():
    js = fog_cube_scene(sigma_a=0.05, sigma_s=0.4).build()
    ij, sj = jpb.render_photonbeam(js, jcam(jtfm.look_at(*LOOK), 40.0, W, W),
                                   W, W, jpb.PhotonBeamConfig(**CFG))
    it, st = tpb.render_photonbeam(
        scene_from_jax(js, device="cpu"),
        tcam(ttfm.look_at(*LOOK), 40.0, W, W, device="cpu"), W, W,
        tpb.PhotonBeamConfig(**CFG))
    _assert_images_close(it.numpy(), np.asarray(ij))
    for k in ("n_beams", "n_medium_scatter", "n_overflow_steps"):
        assert st[k] == sj[k], k
    assert st["final_radius"] == pytest.approx(sj["final_radius"])


def test_render_compat_grid_matches_jax():
    """The grid medium: the reference's compat render of a grid scene
    compiles pathologically slowly as one jit (tests/
    test_reference_golden_smoke.py), so its side runs each iteration as
    trace + camera_pass, as render_photonbeam runs it, the port's through
    render_photonbeam."""
    js = smoke_hetero(JBuilder())
    cam = jcam(jtfm.look_at(*LOOK), 40.0, W, W)
    distr = jlpd(js)
    # render_photonbeam resolves the shadow rays' boundary crossings
    cfg = jpb.PhotonBeamConfig(**CFG,
                               tr_crossings=default_tr_crossings(js))
    P, radius, Ld = CFG["photonsperiteration"], CFG["initialbeamradius"], 0.0
    n_beams = 0
    for it_ in range(CFG["iterations"]):
        rad = jnp.float32(radius)
        beams, stats = jtrace(js, distr, jnp.uint32(it_ * P)
                              + jnp.arange(P, dtype=jnp.uint32),
                              CFG["maxdepth"], rad)
        L, _ = jpb.camera_pass(js, cam, W, W, beams, rad, jnp.uint32(it_),
                               cfg, P)
        Ld = Ld + np.asarray(L)
        n_beams += int(stats["n_beams"])
        radius = radius * (it_ + CFG["alpha"]) / (it_ + 1)
    ij = (Ld / CFG["iterations"]).reshape(W, W, 3)
    it, st = tpb.render_photonbeam(
        scene_from_jax(js, device="cpu"),
        tcam(ttfm.look_at(*LOOK), 40.0, W, W, device="cpu"), W, W,
        tpb.PhotonBeamConfig(**CFG))
    _assert_images_close(it.numpy(), ij)
    assert st["n_beams"] == n_beams
