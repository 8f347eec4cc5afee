"""bre_tpu_torch two-pass backward (kernel 6) and the analytic backward of
the non-packed route vs bre_tpu: ``gather_backward_twopass_ref`` against
``pallas_gather_backward`` (interpret mode on CPU), also on beams packed
as the route packs them with dead chunks; the kernels' skip of the chunks
without a live start power (``twopass_chunk_flags``) exact on the plain
version; and
``gather_beams_bruteforce(backend="pallas", grad_geometry=False)`` under
``PALLAS_BWD_MODE`` "fused" and "twopass" against the reference's run in
the same mode, with ``grad_extras`` both ways; the port's two routes
(packed and non-packed) against each other.  Identical numpy inputs
through both packages.

Tolerances and their reasons: every cotangent against its own max|ref| at
2e-4 (tests/test_pallas_gather.py:97): the frameworks round the
closest-point solve differently (XLA contracts multiply-adds, torch does
not) and sum in another order.  The routes' agreement: the packed-gather
test's 3e-4 (tests/test_pallas_gather.py:199-202), the sums running over
Morton-sorted chunks on one route and validity-sorted chunks on the
other."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bre_tpu.accel import beam_gather as jbg
from bre_tpu.ops import pallas_gather_bwd as jpb
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu_torch.accel import beam_gather as tbg
from bre_tpu_torch.ops import gather as tg
from bre_tpu_torch.ops import gather_bwd as tgb
from bre_tpu_torch.scene.scene import scene_from_jax
from test_torch_gather import _beams_np, _jbeams, _segments, _tbeams
from test_torch_gather_bwd import _bwd_inputs, _close_by_cotangent
from torch_parity import to_np

BWD_RTOL = 2e-4
ROUTES_RTOL = 3e-4


def test_twopass_ref_matches_pallas():
    """The plain version of kernel 6 against the reference's two-pass
    kernels: every block (no mask, no dead-chunk skip), the extras on."""
    rays, beams, scal, _, ct = _bwd_inputs(seed=2)
    jr, jb = jpb.pallas_gather_backward(
        *(jnp.asarray(x) for x in (rays, beams, scal[:, :3], ct)), 256, 256)
    tr, tb = tgb.gather_backward_twopass_ref(
        *(torch.from_numpy(x) for x in (rays, beams, scal, ct)))
    assert tr.shape == (4, 8, 256) and tb.shape == (6, tg.NB, 256)
    _close_by_cotangent((tr, tb), (jr, jb), BWD_RTOL)
    # the chunk past n_valid is swept too, and the extras are on
    assert float(tb[-1].abs().max()) > 0
    assert float(tr[:, tgb.DR_G:].abs().max()) > 0


def test_twopass_matches_fused_on_the_whole_grid():
    """On an all-ones mask with every chunk valid, the two-pass and the
    fused plain versions compute the same cotangents (extras on)."""
    rays, beams, scal, _, ct = (torch.from_numpy(x) for x in
                                _bwd_inputs(seed=3))
    scal = scal.clone()
    scal[0, 3] = beams.shape[0] * 256
    mask = torch.ones((beams.shape[0], rays.shape[0]))
    two = tgb.gather_backward_twopass_ref(rays, beams, scal, ct)
    fused = tgb.gather_backward_fused_ref(rays, beams, scal, ct, mask, True)
    _close_by_cotangent(two, fused, BWD_RTOL)


def test_twopass_wrapper_cpu_and_layouts():
    """CPU tensors take the plain version (no launch); grid-media layouts
    are refused, as the reference keeps them on the recompute backward."""
    rays, beams, scal, _, ct = (torch.from_numpy(x) for x in _bwd_inputs())
    n0 = tgb.gather_backward_twopass.launches
    for a, b in zip(tgb.gather_backward_twopass(rays, beams, scal, ct),
                    tgb.gather_backward_twopass_ref(rays, beams, scal, ct)):
        assert torch.equal(a, b)
    assert tgb.gather_backward_twopass.launches == n0
    rays_het = torch.zeros((rays.shape[0], tg.NF_HET, 256))
    with pytest.raises(ValueError, match="homogeneous only"):
        tgb.gather_backward_twopass(rays_het, beams, scal, ct)


def _dead_chunk_inputs(seed=4):
    """3 ray tiles x 7 chunks packed by the non-packed route's own
    ``_pack_kernel_inputs`` (validity folded into the powers, rays and
    beams zero-padded to whole tiles and chunks): chunk 2 valid beams whose
    powers are all 0 (dead in the middle), chunks 5-6 a dead tail (invalid
    beams, then 186 zero-padded ones), n_valid ending inside chunk 3, so
    chunk 4's live powers lie past it.  Numpy arrays (rays, beams, scal,
    ct)."""
    rs = np.random.RandomState(seed)
    R, B = 3 * 256 - 40, 6 * 256 + 70
    a0 = rs.uniform(-1, 1, (R, 3)).astype(np.float32)
    a1 = rs.uniform(-1, 1, (R, 3)).astype(np.float32)
    d = a1 - a0
    ln = np.linalg.norm(d, axis=1)
    seg = dict(a0=a0, a1=a1, dir=d / ln[:, None], len=ln,
               tr_full=rs.uniform(0.2, 1.0, (R, 3)),
               sigma_s=rs.uniform(1.0, 10.0, (R, 3)),
               g=rs.uniform(-0.6, 0.6, R), in_med_f=np.ones(R))
    pb = dict(start=rs.uniform(-1, 1, (B, 3)), end=rs.uniform(-1, 1, (B, 3)),
              power_start=rs.uniform(0.5, 2.0, (B, 3)),
              radius=np.full(B, 0.15), valid_f=np.ones(B))
    pb["power_end"] = pb["power_start"] * rs.uniform(0.05, 1.0, (B, 3))
    pb["power_start"][512:768] = 0.0
    pb["power_end"][512:768] = 0.0
    pb["valid_f"][5 * 256:] = 0.0
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32))  # noqa: E731
    seg = {k: t(v) for k, v in seg.items()}
    seg.update(cam_radius=t(0.1), n_valid_beams=t(3 * 256 + 100))
    cfg = tbg._Cfg(tbg.KERNEL_BRE, 256, 7, 1e-2, 0.05, False, True,
                   "pallas")
    rays, beams, scal = tbg._pack_kernel_inputs(
        cfg, {k: t(v) for k, v in pb.items()}, seg)
    assert rays.shape == (3, tg.NF, 256) and beams.shape == (7, tg.NB, 256)
    ct = rs.uniform(-1, 1, (3, tgb.NDR, 256)).astype(np.float32)
    ct[:, 3:] = 0.0
    return rays.numpy(), beams.numpy(), scal.numpy(), ct


DEAD, PAST_N_VALID = (2, 5, 6), 4  # _dead_chunk_inputs' chunks


def _flag_layouts():
    """Beam buffers for the flags: the route's dead chunks, and edits."""
    beams = _dead_chunk_inputs()[1]
    out = dict(route=beams)
    for name in ("all_dead", "none_dead", "last_only", "one_lane"):
        b = beams.copy()
        if name == "all_dead":
            b[:, tg.BF_PS:tg.BF_PS + 3] = 0.0
        elif name == "none_dead":
            b[:, tg.BF_PS:tg.BF_PS + 3] = 1.0
        elif name == "last_only":
            b[:-1, tg.BF_PS:tg.BF_PS + 3] = 0.0
            b[-1, tg.BF_PS + 2, 255] = 3.0
        else:  # one beam of chunk 5 live in one channel; 1e-20 is dead
            b[5, tg.BF_PS + 1, 17] = 2e-20
            b[6, tg.BF_PS, :] = 1e-20
        out[name] = b
    return out


@pytest.mark.parametrize("layout", ["route", "all_dead", "none_dead",
                                    "last_only", "one_lane"])
def test_twopass_chunk_flags_match_numpy(layout):
    """The kernels' pre-pass in plain torch: a chunk is flagged where some
    beam has ps > 1e-20 in some channel; the extent is 1 + the last
    flagged chunk (0 if none)."""
    beams = _flag_layouts()[layout]
    want = (beams[:, tg.BF_PS:tg.BF_PS + 3] > 1e-20).any(axis=(1, 2))
    flagged = np.nonzero(want)[0]
    flags, extent = tgb.twopass_chunk_flags(torch.from_numpy(beams))
    assert flags.dtype == torch.bool
    np.testing.assert_array_equal(flags.numpy(), want)
    assert int(extent) == (int(flagged[-1]) + 1 if flagged.size else 0)
    if layout == "route":
        assert list(np.nonzero(~want)[0]) == list(DEAD)


@pytest.mark.parametrize("side", ["rays", "beams"])
def test_twopass_skip_of_unflagged_chunks_is_exact(side):
    """Dropping the chunks without a live start power from the plain
    version's block lists changes no bit of d_rays, and those chunks'
    d_beams are exact zeros; the chunk with live powers past n_valid keeps
    its cotangents."""
    rays, beams, scal, ct = (torch.from_numpy(x)
                             for x in _dead_chunk_inputs())
    n_tiles, n_chunks = rays.shape[0], beams.shape[0]
    flags, extent = tgb.twopass_chunk_flags(beams)
    assert int(extent) == PAST_N_VALID + 1
    assert PAST_N_VALID * 256 > float(scal[0, 3])
    grid = torch.ones((n_tiles, n_chunks), dtype=torch.bool)
    kept = grid & flags[None, :]
    if side == "beams":
        grid, kept = grid.T, kept.T  # chunk-major
    out = []
    for blocks in (grid, kept):
        outer, inner = torch.nonzero(blocks, as_tuple=True)
        tiles, chunks = (outer, inner) if side == "rays" else (inner, outer)
        out.append(tgb._bwd_ref(rays, beams, scal, ct, tiles, chunks, True,
                                side, tgb._twopass_blocks_ref))
    full, skipped = out
    assert torch.equal(full, skipped)
    if side == "rays":
        assert float(full.abs().max()) > 0
        alone = tgb._bwd_ref(rays, beams, scal, ct,
                             torch.arange(n_tiles),
                             torch.full((n_tiles,), PAST_N_VALID), True,
                             "rays", tgb._twopass_blocks_ref)
        assert float(alone.abs().max()) > 0
    else:
        assert float(full[list(DEAD)].abs().max()) == 0.0
        assert float(full[PAST_N_VALID].abs().max()) > 0
        assert torch.equal(full, tgb.gather_backward_twopass_ref(
            rays, beams, scal, ct)[1])


def test_twopass_ref_matches_pallas_on_dead_chunks():
    """The plain version against the reference's two-pass kernels on the
    route's packing with dead chunks: per cotangent, zeros in the dead
    chunks' d_beams in both, cotangents in the chunk past n_valid."""
    rays, beams, scal, ct = _dead_chunk_inputs()
    jr, jb = jpb.pallas_gather_backward(
        *(jnp.asarray(x) for x in (rays, beams, scal[:, :3], ct)), 256, 256)
    tr, tb = tgb.gather_backward_twopass_ref(
        *(torch.from_numpy(x) for x in (rays, beams, scal, ct)))
    _close_by_cotangent((tr, tb), (jr, jb), BWD_RTOL)
    jb = to_np(jb)
    assert not jb[list(DEAD)].any() and float(tb[list(DEAD)].abs().max()) == 0
    assert np.abs(jb[PAST_N_VALID]).max() > 0
    assert float(tb[PAST_N_VALID].abs().max()) > 0


def _setup(B=512, R=256, seed=0):
    """tests/test_pallas_gather.py:13-33's inputs, as numpy."""
    rs = np.random.RandomState(seed)
    b = dict(start=rs.uniform(-1, 1, (B, 3)), end=rs.uniform(-1, 1, (B, 3)),
             power_start=rs.uniform(0.5, 2, (B, 3)),
             power_end=rs.uniform(0.05, 0.5, (B, 3)), radius=np.full(B, 0.2))
    b = {k: v.astype(np.float32) for k, v in b.items()}
    b["medium"] = np.zeros(B, np.int32)
    b["valid"] = rs.rand(B) > 0.1
    a0 = rs.uniform(-2, -1, (R, 3)).astype(np.float32)
    a1 = rs.uniform(1, 2, (R, 3)).astype(np.float32)
    sd = (a1 - a0) / np.linalg.norm(a1 - a0, axis=-1, keepdims=True)
    med = np.zeros(R, np.int32)
    trf = np.full((R, 3), 0.4, np.float32)
    jb = JBuilder()
    jb.homogeneous_medium((0.05,) * 3, (0.5,) * 3, 0.3)
    jb.sphere((0, 0, 0), 5.0)
    js = jb.build()
    return b, (a0, a1, sd, med, trf), js


NAMES = ("power_start", "power_end", "radius", "tr_full", "sigma_s", "g",
         "cam_radius")


def _analytic_grads(b, segs, js, backend, grad_extras, mode, monkeypatch,
                    enabled=True):
    """Cotangents of sum(out * W) in NAMES, geometry detached, through both
    packages with the same PALLAS_BWD_* settings."""
    a0, a1, sd, med, trf = segs
    W = np.random.RandomState(5).rand(a0.shape[0], 3).astype(np.float32)
    vals = [b["power_start"], b["power_end"], b["radius"], trf,
            np.asarray(js.media.sigma_s), np.asarray(js.media.g),
            np.float32(0.2)]
    for mod in (jbg, tbg):
        monkeypatch.setattr(mod, "PALLAS_BWD_ENABLED", enabled)
        monkeypatch.setattr(mod, "PALLAS_BWD_MODE", mode)
    kw = dict(chunk=256, power_scale=1e-3, backend=backend,
              grad_geometry=False, grad_extras=grad_extras)

    def jloss(ps, pe, rad, trf_, ss, g, cr):
        bb = _jbeams(b)._replace(power_start=ps, power_end=pe, radius=rad)
        out = jbg.gather_beams_bruteforce(
            bb, js.media._replace(sigma_s=ss, g=g),
            *(jnp.asarray(x) for x in (a0, a1, sd, med)), trf_, cr, **kw)
        return jnp.sum(out * W)

    g_j = jax.grad(jloss, argnums=tuple(range(7)))(
        *(jnp.asarray(v) for v in vals))
    ts = scene_from_jax(js, device="cpu")
    x = [torch.tensor(np.asarray(v), requires_grad=True) for v in vals]
    out = tbg.gather_beams_bruteforce(
        _tbeams(b)._replace(power_start=x[0], power_end=x[1], radius=x[2]),
        ts.media._replace(sigma_s=x[4], g=x[5]),
        *(torch.from_numpy(v) for v in (a0, a1, sd)),
        torch.from_numpy(med.astype(np.int64)), x[3], x[6], **kw)
    (out * torch.from_numpy(W)).sum().backward()
    return {n: (t.grad, to_np(j)) for n, t, j in zip(NAMES, x, g_j)}


def _check(got, rtol=BWD_RTOL, zero=()):
    for name, (t, j) in got.items():
        assert t is not None and np.isfinite(to_np(t)).all(), name
        if name in zero:
            assert float(t.abs().max()) == 0.0 == np.abs(j).max(), name
            continue
        assert np.abs(j).max() > 0, name
        err = np.abs(to_np(t) - j).max()
        assert err <= rtol * (np.abs(j).max() + 1e-9), (name, err,
                                                        np.abs(j).max())


@pytest.mark.parametrize("mode", ["fused", "twopass"])
def test_analytic_backward_matches_jax(mode, monkeypatch):
    """grad_geometry=False through the kernels' plain versions against the
    reference's Pallas backward in the same mode (tests/test_pallas_gather.py:
    70-97), and against the port's own recompute backward."""
    b, segs, js = _setup()
    n0 = (tgb.gather_backward_fused.launches,
          tgb.gather_backward_twopass.launches)
    got = _analytic_grads(b, segs, js, "pallas", True, mode, monkeypatch)
    _check(got)
    assert (tgb.gather_backward_fused.launches,
            tgb.gather_backward_twopass.launches) == n0  # CPU: plain versions
    recompute = _analytic_grads(b, segs, js, "pallas", True, mode,
                                monkeypatch, enabled=False)
    _check({n: (got[n][0], to_np(recompute[n][0])) for n in NAMES})


@pytest.mark.parametrize("mode", ["fused", "twopass"])
def test_grad_extras_off(mode, monkeypatch):
    """grad_extras=False (tests/test_pallas_gather.py:134-166): the fused
    backward and the recompute zero the radius, g and cam_radius
    cotangents; the two-pass kernels compute the extras always, in the
    reference as here.  The other cotangents are those with the extras."""
    b, segs, js = _setup(seed=1)
    extras = ("radius", "g", "cam_radius")
    off = _analytic_grads(b, segs, js, "pallas", False, mode, monkeypatch)
    _check(off, zero=extras if mode == "fused" else ())
    off_x = _analytic_grads(b, segs, js, "xla", False, mode, monkeypatch)
    _check(off_x, zero=extras)
    on = _analytic_grads(b, segs, js, "xla", True, mode, monkeypatch)
    for name in ("power_start", "power_end", "tr_full", "sigma_s"):
        ref = to_np(on[name][0])
        for got in (off, off_x):
            err = np.abs(to_np(got[name][0]) - ref).max()
            assert err <= BWD_RTOL * np.abs(ref).max(), name


def test_port_routes_agree():
    """The port's packed route (gather_beams_packed) against its non-packed
    route (gather_beams_bruteforce, backend "xla", geometry detached):
    values and the cotangents in the beam powers, sigma_s and tr_full
    (tests/test_pallas_gather.py:169-202)."""
    jb = JBuilder()
    jb.homogeneous_medium((0.05,) * 3, (0.5,) * 3, 0.3)
    jb.triangle((0, 0, 0), (1, 0, 0), (0, 1, 0))
    ts = scene_from_jax(jb.build(), device="cpu")
    b = _beams_np(B=700, seed=3)
    a0, a1, sd, med, trf = (torch.from_numpy(x) for x in _segments(R=300))
    med = med.to(torch.int64)
    W = torch.from_numpy(np.random.RandomState(9).rand(300, 3)
                         .astype(np.float32))
    res = []
    for packed in (False, True):
        ps = torch.from_numpy(b["power_start"]).requires_grad_()
        ss = ts.media.sigma_s.clone().requires_grad_()
        tr = trf.clone().requires_grad_()
        bb = _tbeams(b)._replace(power_start=ps)
        md = ts.media._replace(sigma_s=ss)
        if packed:
            bp, nv = tbg.pack_beams_compact(bb)
            out = tbg.gather_beams_packed(bp, nv, md, a0, a1, sd, med, tr, 0.2,
                                          power_scale=1e-3)
        else:
            out = tbg.gather_beams_bruteforce(
                bb, md, a0, a1, sd, med, tr, 0.2, chunk=256,
                power_scale=1e-3, backend="xla", grad_geometry=False)
        (out * W).sum().backward()
        res.append((out.detach(), ps.grad, ss.grad, tr.grad))
    assert float(res[0][0].abs().max()) > 0
    np.testing.assert_allclose(to_np(res[1][0]), to_np(res[0][0]),
                               rtol=ROUTES_RTOL, atol=1e-8)
    for x, p in zip(res[0][1:], res[1][1:]):
        assert float((x - p).abs().max()) <= ROUTES_RTOL * float(x.abs().max())
