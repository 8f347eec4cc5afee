"""bre_tpu_torch heterogeneous (grid-density) gather vs bre_tpu: the
segment tables (``medium_interval_nodes``, the least-squares maps of
``nodes_to_poly``, ``medium_interval_poly``), the hetero pack layouts, the
plain hetero forward against ``pallas_gather_forward`` /
``pallas_gather_sparse`` and the plain hetero backward against
``pallas_gather_backward_fused`` (Pallas interpret mode on the CPU), and the
autograd Function's gradients against ``jax.grad`` through the reference's
``gather_beams_packed`` — identical numpy inputs through both packages.

Tolerances and their reasons: the fit matrices are the same numpy float64
computation cast once, so they are equal; packing is a permutation and is
exact.  The node tables go through the trilinear lookup: XLA contracts
multiply-adds, torch does not (ROADMAP Queue 3), so they agree to rtol 1e-5
and atol 1e-6.  A polynomial coefficient is a sum of K node values times
fit weights of up to a few hundred that cancel to a small value, so its
rounding scales with the sum of the magnitudes: rtol 1e-5 plus 1e-6 times
that sum (``_coef_close``).  Forward sums: the Pallas tests' rtol 2e-4 /
atol 1e-8 (tests/test_pallas_gather.py:47, 284-295).  Backward: max|d| <=
2e-4 * (max|ref| + 1e-9) per cotangent (tests/test_pallas_gather.py:
298-318, 448), rows that must be zero exactly zero.  The autograd Function
against jax.grad: rtol 3e-4 forward and 3e-4 * max|ref| gradients (the
packed-gather criterion, tests/test_pallas_gather.py:196-202)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bre_tpu.accel import beam_gather as jbg
from bre_tpu.ops import pallas_gather as jpg
from bre_tpu.ops import pallas_gather_bwd as jpb
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu_torch.accel import beam_gather as tbg
from bre_tpu_torch.ops import gather as tg
from bre_tpu_torch.ops import gather_bwd as tgb
from bre_tpu_torch.scene.scene import scene_from_jax
from test_torch_gather import _beams_np, _jbeams, _packed_inputs, _tbeams
from torch_parity import SMOKE_W2M, smoke_density, to_np

RTOL, ATOL = 2e-4, 1e-8


def test_layout_constants_match():
    for name in ("NF_HET", "NB_HET", "RF_DC", "RF_SIGTC", "RF_DENSC",
                 "BF_DP", "BF_SIGT", "POLY_D_COEFS", "POLY_DENS_COEFS"):
        assert getattr(tg, name) == getattr(jpg, name), name
    for name in ("DR_DC", "DR_SIGTC", "DR_DENS", "NDR_HET"):
        assert getattr(tgb, name) == getattr(jpb, name), name
    assert tbg.HETERO_NODES == jbg.HETERO_NODES


def _scene_pair():
    """A homogeneous medium (0) and the smoke grid (1), vacuum outside."""
    b = JBuilder()
    b.homogeneous_medium((0.05,) * 3, (0.4,) * 3, 0.1)
    b.grid_medium(smoke_density(16), SMOKE_W2M, sigma_a=(0.05,) * 3,
                  sigma_s=(0.6,) * 3, g=0.3)
    b.sphere((0, 0, 0), 5.0)
    js = b.build()
    return js, scene_from_jax(js, device="cpu")


def _seg_np(n=600, seed=0):
    rs = np.random.RandomState(seed)
    p0 = rs.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    p1 = rs.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    med = rs.randint(-1, 2, n).astype(np.int32)
    return p0, p1, med


def _coef_close(t, j, nodes, M):
    """Coefficients ``nodes @ M.T``: within 1e-5 relative plus 1e-6 of the
    sum of the magnitudes of their terms."""
    t, j = to_np(t), to_np(j)
    scale = np.abs(to_np(nodes)) @ np.abs(M).T
    assert (np.abs(t - j) <= 1e-5 * np.abs(j) + 1e-6 * scale + 1e-9).all()


@pytest.mark.parametrize("K", [8, 4])
def test_medium_interval_tables_match_jax(K):
    js, ts = _scene_pair()
    p0, p1, med = _seg_np()
    jargs = (jnp.asarray(med), jnp.asarray(p0), jnp.asarray(p1))
    targs = (torch.from_numpy(med).long(), torch.from_numpy(p0),
             torch.from_numpy(p1))
    for a, b in zip(tbg._fit_matrices(K), jbg._fit_matrices(K)):
        np.testing.assert_array_equal(a, b)
    jn = jbg.medium_interval_nodes(js.media, *jargs, K=K)
    tn = tbg.medium_interval_nodes(ts.media, *targs, K=K)
    for name, a, b in zip(("dk", "dens", "sigma_t"), tn, jn):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    # outside media: no optical depth, unit density
    assert not to_np(tn[0])[med < 0].any() and (to_np(tn[1])[med < 0] == 1).all()
    MD, MN = jbg._fit_matrices(K)
    jp = jbg.medium_interval_poly(js.media, *jargs, K=K)
    tp = tbg.medium_interval_poly(ts.media, *targs, K=K)
    _coef_close(tp[0], jp[0], jn[0], MD)
    _coef_close(tp[1], jp[1], jn[1], MN)
    np.testing.assert_array_equal(to_np(tp[2]), to_np(jp[2]))
    # nodes_to_poly is the fixed linear map on any node tables
    dk, dens = (np.random.RandomState(1).uniform(0, 1, (50, K)).astype(
        np.float32) for _ in range(2))
    for a, b, nodes, M in zip(
            tbg.nodes_to_poly(torch.from_numpy(dk), torch.from_numpy(dens)),
            jbg.nodes_to_poly(jnp.asarray(dk), jnp.asarray(dens)),
            (dk, dens), (MD, MN)):
        _coef_close(a, b, nodes, M)


def _het_beams(js, ts, B=1100, seed=3):
    b = _beams_np(B, seed)
    b["medium"] = np.random.RandomState(seed).randint(0, 2, B).astype(np.int32)
    jb, tb = _jbeams(b), _tbeams(b)
    jt = jbg.medium_interval_poly(js.media, jb.medium, jb.start, jb.end)
    tt = tbg.medium_interval_poly(ts.media, tb.medium, tb.start, tb.end)
    return b, jb, tb, jt, tt


def test_hetero_pack_layouts_match_jax():
    """pack_beams_compact's NB_HET extension fields and pack_rays' NF_HET
    rows: the reference's layouts, permuted and padded with the rest."""
    js, ts = _scene_pair()
    _, jb, tb, (jdp, _, jst), _ = _het_beams(js, ts)
    bp_j, nv_j = jbg.pack_beams_compact(jb, 256, d_poly=jdp, sigma_t=jst)
    # the same tables on both sides: the layout is a permutation, exact
    bp_t, nv_t = tbg.pack_beams_compact(
        tb, d_poly=torch.from_numpy(np.array(jdp)),
        sigma_t=torch.from_numpy(np.array(jst)))
    assert bp_t.shape == (5, tg.NB_HET, 256) and float(nv_t) == float(nv_j)
    np.testing.assert_array_equal(to_np(bp_t), to_np(bp_j))
    rs = np.random.RandomState(5)
    seg = {k: rs.uniform(0, 1, (512,) + s).astype(np.float32) for k, s in
           dict(a0=(3,), a1=(3,), dir=(3,), len=(), tr_full=(3,),
                sigma_s=(3,), g=(), in_med_f=(), d_cam_poly=(5,),
                sigma_t_cam=(3,), dens_cam_poly=(6,)).items()}
    rj = jpg.pack_rays({k: jnp.asarray(v) for k, v in seg.items()}, 256)
    rt = tg.pack_rays({k: torch.from_numpy(v) for k, v in seg.items()}, 256)
    assert rt.shape == (2, tg.NF_HET, 256) and tg.is_hetero(rt)
    np.testing.assert_array_equal(to_np(rt), to_np(rj))


def _het_packed(n_tiles=4, n_chunks=6, seed=0, live=0.6):
    """Hetero packed inputs: the homogeneous rows of _packed_inputs plus
    tables from the reference's fit maps applied to positive node tables
    (D nodes up to 0.4 per node, densities up to 1.5, some negative fit
    overshoot clamped in the kernels), and a few lanes with all-zero
    density rows."""
    rays, beams, scal, mask = _packed_inputs(n_tiles, n_chunks, seed, live)
    rs = np.random.RandomState(seed + 11)
    MD, MN = jbg._fit_matrices(jbg.HETERO_NODES)
    K, T, C = jbg.HETERO_NODES, 256, 256
    dk_r = rs.uniform(0, 0.4, (n_tiles, T, K)).astype(np.float32)
    dens_r = rs.uniform(0, 1.5, (n_tiles, T, K)).astype(np.float32)
    dens_r[:, :20] = 0.0
    dk_b = rs.uniform(0, 0.4, (n_chunks, C, K)).astype(np.float32)
    rays_h = np.concatenate([
        rays, (dk_r @ MD.T).transpose(0, 2, 1),
        rs.uniform(0.3, 1.5, (n_tiles, 3, T)).astype(np.float32),
        (dens_r @ MN.T).transpose(0, 2, 1)], 1)
    rays_h[:, tg.RF_SIGS:tg.RF_SIGS + 3] *= 40.0  # sigma_s ~ 0.2 folded
    beams_h = np.concatenate([
        beams, (dk_b @ MD.T).transpose(0, 2, 1),
        rs.uniform(0.3, 1.5, (n_chunks, 3, C)).astype(np.float32)], 1)
    assert rays_h.shape[1] == tg.NF_HET and beams_h.shape[1] == tg.NB_HET
    return (np.ascontiguousarray(rays_h, np.float32),
            np.ascontiguousarray(beams_h, np.float32), scal, mask)


def test_hetero_forward_ref_matches_pallas():
    rays, beams, scal, mask = _het_packed()
    j = jpg.pallas_gather_forward(*(jnp.asarray(x) for x in (rays, beams, scal)),
                                  256, 256, block_mask=jnp.asarray(mask))
    t = tg.gather_forward_ref(*(torch.from_numpy(x) for x in
                                (rays, beams, scal, mask)))
    assert t.shape == (4, 8, 256)
    assert float(np.abs(to_np(j)).max()) > 0
    np.testing.assert_allclose(to_np(t), to_np(j), rtol=RTOL, atol=ATOL)
    assert float(t[0].abs().max()) == 0.0 and float(t[:, 3:].abs().max()) == 0.0


def test_hetero_sparse_ref_matches_pallas():
    rays, beams, scal, mask = _het_packed(seed=1, live=0.4)
    idx_j, _ = jpg.sparse_block_ids(jnp.asarray(mask), 16)
    idx_t, _ = tg.sparse_block_ids(torch.from_numpy(mask), 16)
    j = jpg.pallas_gather_sparse(*(jnp.asarray(x) for x in (rays, beams, scal)),
                                 256, 256, idx_j)
    t = tg.gather_sparse_ref(*(torch.from_numpy(x) for x in (rays, beams, scal)),
                             idx_t)
    np.testing.assert_allclose(to_np(t), to_np(j), rtol=RTOL, atol=ATOL)
    d = tg.gather_forward_ref(*(torch.from_numpy(x) for x in
                                (rays, beams, scal, mask)))
    torch.testing.assert_close(t, d, rtol=1e-6, atol=1e-9)


def _close_by_cotangent_het(t, j):
    (tr, tb), (jr, jb) = (to_np(x) for x in t), (to_np(x) for x in j)
    for t_out, j_out, rows in ((tr, jr, tgb.D_RAYS_ROWS_HET),
                               (tb, jb, tgb.D_BEAMS_ROWS_HET)):
        for name, sl in rows.items():
            ref = j_out[:, sl]
            err = np.abs(t_out[:, sl] - ref).max()
            assert err <= 2e-4 * (np.abs(ref).max() + 1e-9), (
                name, err, np.abs(ref).max())
    # the tr_full rows and the d_beams rows outside the cotangents (pe,
    # geometry, padding) are zero in both
    other = np.ones(tg.NB_HET, bool)
    for sl in tgb.D_BEAMS_ROWS_HET.values():
        other[sl] = False
    for x in (tr[:, tgb.DR_TR:tgb.DR_TR + 3], jr[:, tgb.DR_TR:tgb.DR_TR + 3],
              tb[:, other], jb[:, other]):
        assert not x.any()


@pytest.mark.parametrize("want_extras", [True, False])
def test_hetero_backward_ref_matches_pallas(want_extras):
    rays, beams, scal, mask = _het_packed()
    ct = np.random.RandomState(7).uniform(-1, 1, (4, tgb.NDR, 256)).astype(np.float32)
    ct[:, 3:] = 0.0
    jr, jb = jpb.pallas_gather_backward_fused(
        *(jnp.asarray(x) for x in (rays, beams, scal, ct)), 256, 256,
        want_extras=want_extras, block_mask=jnp.asarray(mask))
    tr, tb = tgb.gather_backward_fused_ref(
        *(torch.from_numpy(x) for x in (rays, beams, scal, ct, mask)),
        want_extras=want_extras)
    assert tr.shape == (4, tgb.NDR_HET, 256) and tb.shape == (6, tg.NB_HET, 256)
    _close_by_cotangent_het((tr, tb), (jr, jb))
    for name, sl in {**tgb.D_RAYS_ROWS_HET, **tgb.D_BEAMS_ROWS_HET}.items():
        if name not in ("g", "cam_radius", "radius"):
            assert (np.abs(to_np(jr if name in tgb.D_RAYS_ROWS_HET else jb)[:, sl]).max()
                    > 0), name
    extras = (tr[:, tgb.DR_G:tgb.DR_G + 2], tb[:, tg.BF_RAD])
    assert all((float(x.abs().max()) > 0) == want_extras for x in extras)
    # no sparse hetero backward, as in the reference: the wrapper refuses
    idx, _ = tg.sparse_block_ids(torch.from_numpy(mask), 24)
    with pytest.raises(ValueError, match="homogeneous only"):
        tgb.gather_backward_sparse(*(torch.from_numpy(x) for x in
                                     (rays, beams, scal, ct)), idx, idx)


def test_cpu_wrappers_take_the_hetero_plain_versions():
    rays, beams, scal, mask = (torch.from_numpy(x) for x in _het_packed(2, 3))
    ct = torch.zeros((2, tgb.NDR, 256))
    ct[:, :3] = 1.0
    n0 = (tg.gather_forward.launches_het, tg.gather_sparse.launches_het,
          tgb.gather_backward_fused.launches_het)
    assert torch.equal(tg.gather_forward(rays, beams, scal, mask),
                       tg.gather_forward_ref(rays, beams, scal, mask))
    idx, _ = tg.sparse_block_ids(mask, 6)
    assert torch.equal(tg.gather_sparse(rays, beams, scal, idx),
                       tg.gather_sparse_ref(rays, beams, scal, idx))
    for a, b in zip(tgb.gather_backward_fused(rays, beams, scal, ct, mask),
                    tgb.gather_backward_fused_ref(rays, beams, scal, ct, mask)):
        assert torch.equal(a, b)
    assert (tg.gather_forward.launches_het, tg.gather_sparse.launches_het,
            tgb.gather_backward_fused.launches_het) == n0


def _segments_het(R=300, seed=4):
    rs = np.random.RandomState(seed)
    a0 = rs.uniform(-1.5, -0.5, (R, 3)).astype(np.float32)
    a1 = rs.uniform(0.5, 1.5, (R, 3)).astype(np.float32)
    sd = ((a1 - a0) / np.linalg.norm(a1 - a0, axis=-1, keepdims=True)).astype(np.float32)
    med = rs.randint(-1, 2, R).astype(np.int32)
    trf = rs.uniform(0.2, 0.9, (R, 3)).astype(np.float32)
    return a0, a1, sd, med, trf


@pytest.mark.parametrize("grad_extras,sparse_cap", [(False, 0), (True, 4096)])
def test_hetero_gather_gradients_match_jax(grad_extras, sparse_cap):
    """The packed gather on grid tables end to end: beam tables packed once,
    camera tables per sweep, the forward (dense or sparse) and the dense
    hetero backward with the forward's block mask, against jax.grad through
    the reference's gather_beams_packed, in the beam powers, the density
    brick and sigma_s (and the radius with the extras)."""
    js, ts = _scene_pair()
    b = _beams_np(900, 6)
    b["medium"] = np.random.RandomState(6).randint(0, 2, 900).astype(np.int32)
    a0, a1, sd, med, trf = _segments_het()
    W = np.random.RandomState(9).rand(300, 3).astype(np.float32)

    def loss_j(ps, rad, dens, sig_s):
        mm = js.media._replace(density=dens, sigma_s=sig_s)
        bb = _jbeams(b)._replace(power_start=ps, radius=rad)
        dp, _, st = jbg.medium_interval_poly(mm, bb.medium, bb.start, bb.end)
        bp, nv = jbg.pack_beams_compact(bb, 256, d_poly=dp, sigma_t=st)
        out = jbg.gather_beams_packed(
            bp, nv, mm, *(jnp.asarray(x) for x in (a0, a1, sd, med, trf)),
            jnp.float32(0.2), chunk=256, power_scale=1e-3,
            grad_extras=grad_extras, sparse_cap=sparse_cap)
        return jnp.sum(out * W), out

    jargs = (jnp.asarray(b["power_start"]), jnp.asarray(b["radius"]),
             js.media.density, js.media.sigma_s)
    (_, oj), gj = jax.value_and_grad(loss_j, (0, 1, 2, 3), has_aux=True)(*jargs)
    leaves = [torch.from_numpy(b["power_start"]).requires_grad_(),
              torch.from_numpy(b["radius"]).requires_grad_(),
              ts.media.density.clone().requires_grad_(),
              ts.media.sigma_s.clone().requires_grad_()]
    mm = ts.media._replace(density=leaves[2], sigma_s=leaves[3])
    bb = _tbeams(b)._replace(power_start=leaves[0], radius=leaves[1])
    dp, _, st = tbg.medium_interval_poly(mm, bb.medium, bb.start, bb.end)
    bp, nv = tbg.pack_beams_compact(bb, d_poly=dp, sigma_t=st)
    ot = tbg.gather_beams_packed(
        bp, nv, mm, *(torch.from_numpy(x) for x in (a0, a1, sd)),
        torch.from_numpy(med).long(), torch.from_numpy(trf), 0.2,
        power_scale=1e-3, grad_extras=grad_extras, sparse_cap=sparse_cap)
    gt = torch.autograd.grad((ot * torch.from_numpy(W)).sum(), leaves)
    assert float(np.abs(to_np(oj)).max()) > 0
    np.testing.assert_allclose(to_np(ot), to_np(oj), rtol=3e-4, atol=1e-8)
    for name, g_t, g_j in zip(("power_start", "radius", "density", "sigma_s"),
                              gt, gj):
        g_j = to_np(g_j)
        if name == "radius" and not grad_extras:
            assert not g_j.any() and not to_np(g_t).any()
            continue
        assert np.abs(g_j).max() > 0, name
        err = np.abs(to_np(g_t) - g_j).max()
        assert err <= 3e-4 * np.abs(g_j).max(), (name, err, np.abs(g_j).max())
