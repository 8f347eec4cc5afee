"""The LBVH-culled gather (``gather="lbvh"``) against bre_tpu on the CPU.

``gather_beams_lbvh`` on 4 tiles of 64 camera segments and 400 beams (a
third of them invalid), with the candidates of each package's own LBVH
query (equal, tests/test_torch_lbvh.py): a cap above every tile's count and
one that drops candidates; its forward and its vector-Jacobian product
against ``jax.vjp`` of the reference's custom VJP.  Then the port's
``gather="lbvh"`` render against its ``gather="brute"`` one.

Tolerances: the forward at rtol 2e-4 / atol 1e-8 (tests/test_torch_gather.py:
the pair math's closest points differ in the last bits between XLA, which
contracts multiply-adds, and torch); each cotangent within 3e-4 x its
largest magnitude (tests/test_torch_gather_bwd.py's criterion for the
packed gather's gradients).  The render against gather="brute": rtol 2e-4
/ atol 1e-7, the reference's own bound (tests/test_lbvh_gather.py:38): the
LBVH only culls beams that add nothing."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bre_tpu.accel import beam_gather as jbg
from bre_tpu.accel import lbvh as jlbvh
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu_torch.accel import beam_gather as tbg
from bre_tpu_torch.accel import lbvh as tlbvh
from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.integrators import photonbeam as tpb
from bre_tpu_torch.scene.builder import SceneBuilder as TBuilder
from bre_tpu_torch.scene.camera import make_perspective_camera as tcam
from bre_tpu_torch.scene.scene import scene_from_jax
from test_torch_gather import _beams_np, _jbeams, _tbeams
from torch_parity import cornell_fog, to_np

TILE, N_TILES, RADIUS = 64, 4, 0.1
BEAM_KEYS = ("start", "end", "power_start", "power_end", "radius")
SEG_KEYS = ("a0", "a1", "tr_full")


def _segments(seed=4):
    """Short segments, each tile's in one corner of the beams' cube."""
    rs = np.random.RandomState(seed)
    R = TILE * N_TILES
    corner = np.repeat(rs.uniform(-0.6, 0.6, (N_TILES, 3)), TILE, 0)
    a0 = (corner + rs.uniform(-0.3, 0.3, (R, 3))).astype(np.float32)
    a1 = (a0 + rs.uniform(-0.4, 0.4, (R, 3))).astype(np.float32)
    sd = (a1 - a0) / np.linalg.norm(a1 - a0, axis=-1, keepdims=True)
    med = np.where(rs.rand(R) < 0.9, 0, -1).astype(np.int32)
    trf = rs.uniform(0.2, 0.9, (R, 3)).astype(np.float32)
    return a0, a1, sd.astype(np.float32), med, trf


@pytest.fixture(scope="module")
def inputs():
    jb = JBuilder()
    jb.homogeneous_medium((0.05,) * 3, (0.5,) * 3, 0.3)
    jb.triangle((0, 0, 0), (1, 0, 0), (0, 1, 0))
    js = jb.build()
    ts = scene_from_jax(js, device="cpu")
    b = _beams_np(B=400, seed=5)
    b["radius"] = np.random.RandomState(6).uniform(
        0.05, 0.2, 400).astype(np.float32)
    return js, ts, b, _segments()


def _run(inputs, K, ct, vjp):
    """(port out, port grads), (reference out, reference grads), overflow;
    no grads without ``vjp``."""
    js, ts, b, (a0, a1, sd, med, trf) = inputs
    tb = _tbeams(b)
    jbm = _jbeams(b)
    bvh_t = tlbvh.build_lbvh(*tbg.beam_aabbs(tb, RADIUS), tb.valid)
    bvh_j = jlbvh.build_lbvh(*jbg.beam_aabbs(jbm, RADIUS), jbm.valid)
    cand_t, _, over_t = tlbvh.query_aabb_collect(
        bvh_t, *tbg.tile_aabbs(torch.from_numpy(a0), torch.from_numpy(a1),
                               TILE), K)
    cand_j, _, over_j = jlbvh.query_aabb_collect(
        bvh_j, *jbg.tile_aabbs(jnp.asarray(a0), jnp.asarray(a1), TILE), K)
    assert np.array_equal(to_np(cand_t), np.asarray(cand_j))
    assert np.array_equal(to_np(over_t), np.asarray(over_j))

    leaves = {k: torch.from_numpy(b[k]).requires_grad_() for k in BEAM_KEYS}
    segs = {k: torch.from_numpy(v).requires_grad_()
            for k, v in zip(SEG_KEYS, (a0, a1, trf))}
    out_t = tbg.gather_beams_lbvh(
        tb._replace(**leaves), bvh_t, cand_t, ts.media, segs["a0"],
        segs["a1"], torch.from_numpy(sd), torch.from_numpy(med.astype(
            np.int64)), segs["tr_full"], RADIUS, tile=TILE, power_scale=1e-2)
    if not vjp:
        out_j = jbg.gather_beams_lbvh(
            jbm, bvh_j, cand_j, js.media, jnp.asarray(a0), jnp.asarray(a1),
            jnp.asarray(sd), jnp.asarray(med), jnp.asarray(trf),
            jnp.float32(RADIUS), tile=TILE, power_scale=1e-2)
        return (out_t, ()), (out_j, ()), to_np(over_t)
    grads_t = torch.autograd.grad(out_t, [*leaves.values(), *segs.values()],
                                  torch.from_numpy(ct))

    def f(bv, sv):
        return jbg.gather_beams_lbvh(
            jbm._replace(**bv), bvh_j, cand_j, js.media, sv["a0"], sv["a1"],
            jnp.asarray(sd), jnp.asarray(med), sv["tr_full"],
            jnp.float32(RADIUS), tile=TILE, power_scale=1e-2)

    out_j, pullback = jax.vjp(f, {k: jnp.asarray(b[k]) for k in BEAM_KEYS},
                              {k: jnp.asarray(v) for k, v in
                               zip(SEG_KEYS, (a0, a1, trf))})
    gb, gs = pullback(jnp.asarray(ct))
    grads_j = [gb[k] for k in BEAM_KEYS] + [gs[k] for k in SEG_KEYS]
    return (out_t, grads_t), (out_j, grads_j), to_np(over_t)


@pytest.mark.parametrize("K", [512, 24])
def test_gather_beams_lbvh_matches_reference(inputs, K):
    """At K = 24 the candidates past the cap are dropped alike; the VJP is
    held at K = 512, where no tile drops any."""
    ct = np.random.RandomState(9).uniform(
        -1, 1, (TILE * N_TILES, 3)).astype(np.float32)
    (out_t, grads_t), (out_j, grads_j), over = _run(inputs, K, ct,
                                                    vjp=K == 512)
    assert (over.sum() > 0) == (K == 24)
    assert float(np.abs(to_np(out_j)).max()) > 0
    np.testing.assert_allclose(to_np(out_t), np.asarray(out_j), rtol=2e-4,
                               atol=1e-8)
    for name, g_t, g_j in zip(BEAM_KEYS + SEG_KEYS, grads_t, grads_j):
        g_j = np.asarray(g_j)
        assert np.abs(g_j).max() > 0, name
        err = np.abs(to_np(g_t) - g_j).max()
        assert err <= 3e-4 * np.abs(g_j).max(), (name, err)


def test_lbvh_render_matches_brute():
    """The port's gather="lbvh" render, which builds the beams' LBVH once
    per pass and queries it per tile and depth step, against its
    gather="brute" render: the cull drops no contributing beam."""
    W = 16
    scene = cornell_fog(TBuilder(), device="cpu")
    cam = tcam(ttfm.look_at((0, 0, -2.2), (0, 0, 1), (0, 1, 0)), 50.0, W, W,
               device="cpu")
    cfg = tpb.PhotonBeamConfig(iterations=2, maxdepth=5,
                               photonsperiteration=600,
                               initialbeamradius=0.12, alpha=0.7, tile=64)
    brute, _ = tpb.render_photonbeam(scene, cam, W, W, dataclasses.replace(
        cfg, gather="brute"))
    lbvh, stats = tpb.render_photonbeam(scene, cam, W, W, dataclasses.replace(
        cfg, gather="lbvh"))
    assert stats["lbvh_overflow"] == 0 and float(brute.mean()) > 0
    np.testing.assert_allclose(to_np(lbvh), to_np(brute), rtol=2e-4,
                               atol=1e-7)
