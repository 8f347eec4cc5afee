"""bre_tpu_torch packed gather backward vs bre_tpu: the plain versions of
the two backward kernels against ``pallas_gather_backward_fused`` and
``pallas_gather_backward_sparse`` (interpret mode on CPU), the chunk-major
block ids, and the autograd Function of the packed gather against
``jax.grad`` through ``bre_tpu.accel.beam_gather.gather_beams_packed`` —
identical numpy inputs through both packages.

Tolerances: block ids are exact (integer results of identical masks).  The
plain backward versions meet the reference Pallas tests' criterion
max|d| <= 2e-4 * (max|ref| + 1e-9), held per cotangent as
tests/test_pallas_gather.py:448 holds it per gradient: the two frameworks
round the closest-point solve differently (XLA contracts multiply-adds,
torch does not) and sum in another order.  The
autograd Function meets the packed-gather test's rtol 3e-4 forward and
3e-4 * max|ref| gradients (tests/test_pallas_gather.py:196-202)."""

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
from test_torch_gather import (_beams_np, _count_sorts, _jbeams, _packed_inputs,
                               _segments, _tbeams)
from torch_parity import to_np


def _close_by_cotangent(t, j, rtol):
    """The criterion held per cotangent (each a few rows of d_rays or
    d_beams), not over the packed tensor, whose largest rows would hide
    the small ones; d_beams rows outside the cotangents stay zero."""
    (tr, tb), (jr, jb) = (to_np(x) for x in t), (to_np(x) for x in j)
    for t_out, j_out, rows in ((tr, jr, tgb.D_RAYS_ROWS),
                               (tb, jb, tgb.D_BEAMS_ROWS)):
        for name, sl in rows.items():
            ref = j_out[:, sl]
            err = np.abs(t_out[:, sl] - ref).max()
            assert err <= rtol * (np.abs(ref).max() + 1e-9), (
                name, err, np.abs(ref).max())
    other = np.ones(tg.NB, bool)
    for sl in tgb.D_BEAMS_ROWS.values():
        other[sl] = False
    assert not tb[:, other].any() and not jb[:, other].any()


def _bwd_inputs(seed=0):
    """4 ray tiles x 6 chunks, random mask, n_valid inside chunk 5, a tile
    with no live block, dead powers in the last chunk; ct rows 3-7 zero."""
    rays, beams, scal, mask = _packed_inputs(n_tiles=4, n_chunks=6,
                                             seed=seed, live=0.6)
    ct = np.random.RandomState(seed + 7).uniform(
        -1, 1, (4, tgb.NDR, 256)).astype(np.float32)
    ct[:, 3:] = 0.0
    return rays, beams, scal, mask, ct


@pytest.mark.parametrize("want_extras", [True, False])
def test_backward_fused_ref_matches_pallas(want_extras):
    rays, beams, scal, mask, ct = _bwd_inputs()
    jr, jb = jpb.pallas_gather_backward_fused(
        *(jnp.asarray(x) for x in (rays, beams, scal, ct)), 256, 256,
        want_extras=want_extras, block_mask=jnp.asarray(mask))
    tr, tb = tgb.gather_backward_fused_ref(
        *(torch.from_numpy(x) for x in (rays, beams, scal, ct, mask)),
        want_extras=want_extras)
    assert tr.shape == (4, 8, 256) and tb.shape == (6, tg.NB, 256)
    _close_by_cotangent((tr, tb), (jr, jb), 2e-4)
    # a tile without live blocks and the dead chunk past n_valid stay 0
    assert float(tr[0].abs().max()) == 0.0 and float(tb[-1].abs().max()) == 0.0
    extras = (tr[:, tgb.DR_G:], tb[:, tg.BF_RAD])
    assert all((float(x.abs().max()) > 0) == want_extras for x in extras)


@pytest.mark.parametrize("want_extras", [True, False])
def test_backward_sparse_ref_matches_pallas(want_extras):
    rays, beams, scal, mask, ct = _bwd_inputs(seed=1)
    cap = int(mask.sum()) + 3
    idx_t, _ = jpg.sparse_block_ids(jnp.asarray(mask), cap)
    idx_c, _ = jpb.sparse_block_ids_chunk_major(jnp.asarray(mask), cap)
    jr, jb = jpb.pallas_gather_backward_sparse(
        *(jnp.asarray(x) for x in (rays, beams, scal, ct)), 256, 256,
        idx_t, idx_c, want_extras=want_extras)
    t_in = [torch.from_numpy(x) for x in (rays, beams, scal, ct)]
    tr, tb = tgb.gather_backward_sparse_ref(
        *t_in, torch.tensor(to_np(idx_t)), torch.tensor(to_np(idx_c)),
        want_extras=want_extras)
    _close_by_cotangent((tr, tb), (jr, jb), 2e-4)
    # the same live blocks in the same order as the dense plain version
    dr, db = tgb.gather_backward_fused_ref(*t_in, torch.from_numpy(mask),
                                           want_extras=want_extras)
    assert torch.equal(tr, dr) and torch.equal(tb, db)


@pytest.mark.parametrize("cap", [0, 5, 64])
def test_sparse_block_ids_chunk_major_exact(cap):
    """Chunk-major ids, seeds, fill and truncation past the cap."""
    mask = (np.random.RandomState(cap + 1).rand(9, 5) < 0.5).astype(np.float32)
    idx_j, n_j = jpb.sparse_block_ids_chunk_major(jnp.asarray(mask), cap)
    idx_t, n_t = tgb.sparse_block_ids_chunk_major(torch.from_numpy(mask), cap)
    assert idx_t.dtype == torch.int32 and int(n_t) == int(n_j)
    np.testing.assert_array_equal(to_np(idx_t), to_np(idx_j))


def test_cpu_backward_wrappers_take_the_plain_version():
    rays, beams, scal, mask, ct = (torch.from_numpy(x) for x in _bwd_inputs())
    n0 = (tgb.gather_backward_fused.launches,
          tgb.gather_backward_sparse.launches)
    for a, b in zip(tgb.gather_backward_fused(rays, beams, scal, ct, mask),
                    tgb.gather_backward_fused_ref(rays, beams, scal, ct, mask)):
        assert torch.equal(a, b)
    idx_t, _ = tg.sparse_block_ids(mask, 24)
    idx_c, _ = tgb.sparse_block_ids_chunk_major(mask, 24)
    for a, b in zip(
            tgb.gather_backward_sparse(rays, beams, scal, ct, idx_t, idx_c),
            tgb.gather_backward_sparse_ref(rays, beams, scal, ct, idx_t,
                                           idx_c)):
        assert torch.equal(a, b)
    assert (tgb.gather_backward_fused.launches,
            tgb.gather_backward_sparse.launches) == n0


@pytest.mark.parametrize("grad_extras", [True, False])
@pytest.mark.parametrize("sparse_cap", [0, 4096, 1])
def test_packed_gather_grad_matches_jax(sparse_cap, grad_extras):
    """The autograd Function against jax.grad through the reference's
    custom VJP: dense tier, sparse tier, and a cap too small for the live
    blocks (both directions fall back to the dense kernels).  Gradients
    with respect to the beam powers, sigma_s, the camera transmittance and,
    with extras, g; without extras g gets none."""
    jb = JBuilder()
    jb.homogeneous_medium((0.05,) * 3, (0.5,) * 3, 0.3)
    jb.triangle((0, 0, 0), (1, 0, 0), (0, 1, 0))
    js = jb.build()
    ts = scene_from_jax(js, device="cpu")
    b = _beams_np(B=700, seed=3)
    a0, a1, sd, med, trf = _segments(R=300)
    W = np.random.RandomState(9).rand(300, 3).astype(np.float32)

    def jloss(ps, pe, ss, g, trf_):
        bb = _jbeams(b)._replace(power_start=ps, power_end=pe)
        md = js.media._replace(sigma_s=ss, g=g)
        bp, nv = jbg.pack_beams_compact(bb, 256)
        out = jbg.gather_beams_packed(
            bp, nv, md, *(jnp.asarray(x) for x in (a0, a1, sd, med)), trf_,
            jnp.float32(0.2), chunk=256, power_scale=1e-3,
            grad_extras=grad_extras, sparse_cap=sparse_cap)
        return jnp.sum(out * jnp.asarray(W)), out

    j_args = (jnp.asarray(b["power_start"]), jnp.asarray(b["power_end"]),
              js.media.sigma_s, js.media.g, jnp.asarray(trf))
    (_, j_out), j_grads = jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True)(*j_args)

    t_args = [torch.tensor(to_np(x), requires_grad=True) for x in j_args]
    ps, pe, ss, g, trf_t = t_args
    bb = _tbeams(b)._replace(power_start=ps, power_end=pe)
    bp, nv = tbg.pack_beams_compact(bb)
    t_out = tbg.gather_beams_packed(
        bp, nv, ts.media._replace(sigma_s=ss, g=g),
        *(torch.from_numpy(x) for x in (a0, a1, sd)),
        torch.from_numpy(med.astype(np.int64)), trf_t, 0.2,
        power_scale=1e-3, grad_extras=grad_extras, sparse_cap=sparse_cap)
    assert t_out.grad_fn is not None
    (t_out * torch.from_numpy(W)).sum().backward()
    np.testing.assert_allclose(to_np(t_out), to_np(j_out), rtol=3e-4,
                               atol=1e-8)
    for name, t, j in zip(("power_start", "power_end", "sigma_s", "g", "tr"),
                          t_args, j_grads):
        j = to_np(j)
        if name == "g" and not grad_extras:
            assert np.abs(j).max() == 0.0 and float(t.grad.abs().max()) == 0.0
            continue
        assert np.abs(j).max() > 0, name
        err = np.abs(to_np(t.grad) - j).max()
        assert err <= 3e-4 * np.abs(j).max(), (name, err, np.abs(j).max())


@pytest.mark.parametrize("R", [300, 200])
def test_packed_gather_grad_in_any_ray_order(R, monkeypatch):
    """Rays given in a shuffled order, a fifth of them outside the medium:
    the port sorts a sweep of more than one tile by position (200 rays fit
    one tile and take no sort), and ``permute_rows``' backward brings the
    gradients back unpermuted.  Output and gradients (beam powers,
    sigma_s, g, the camera transmittance) meet the row-order reference's
    criterion above; each output row is the port's row-order one."""
    jb = JBuilder()
    jb.homogeneous_medium((0.05,) * 3, (0.5,) * 3, 0.3)
    jb.triangle((0, 0, 0), (1, 0, 0), (0, 1, 0))
    js = jb.build()
    ts = scene_from_jax(js, device="cpu")
    b = _beams_np(B=700, seed=3)
    rows = _segments(R=R)
    W = np.random.RandomState(9).rand(R, 3).astype(np.float32)
    perm = np.random.RandomState(R).permutation(R)

    def jloss(ps, pe, ss, g, trf_):
        bb = _jbeams(b)._replace(power_start=ps, power_end=pe)
        md = js.media._replace(sigma_s=ss, g=g)
        bp, nv = jbg.pack_beams_compact(bb, 256)
        out = jbg.gather_beams_packed(
            bp, nv, md, *(jnp.asarray(x) for x in rows[:4]), trf_,
            jnp.float32(0.2), chunk=256, power_scale=1e-3)
        return jnp.sum(out * jnp.asarray(W)), out

    j_args = (jnp.asarray(b["power_start"]), jnp.asarray(b["power_end"]),
              js.media.sigma_s, js.media.g, jnp.asarray(rows[4]))
    (_, j_out), j_grads = jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True)(*j_args)

    sorts = _count_sorts(monkeypatch)

    def port(p):
        args = [torch.tensor(to_np(x), requires_grad=True) for x in j_args]
        ps, pe, ss, g, trf = args
        args[4] = trf_p = torch.tensor(to_np(trf)[p], requires_grad=True)
        a0, a1, sd, med, _ = (x[p] for x in rows)
        bp, nv = tbg.pack_beams_compact(_tbeams(b)._replace(
            power_start=ps, power_end=pe))
        out = tbg.gather_beams_packed(
            bp, nv, ts.media._replace(sigma_s=ss, g=g),
            *(torch.from_numpy(x) for x in (a0, a1, sd)),
            torch.from_numpy(med.astype(np.int64)), trf_p, 0.2,
            power_scale=1e-3)
        (out * torch.from_numpy(W[p])).sum().backward()
        return out, [x.grad for x in args]

    t_out, t_grads = port(perm)
    row_out, _ = port(np.arange(R))
    assert len(sorts) == (2 if R > 256 else 0)
    assert torch.equal(t_out, row_out[torch.from_numpy(perm)])
    np.testing.assert_allclose(to_np(t_out), to_np(j_out)[perm], rtol=3e-4,
                               atol=1e-8)
    for name, t, j in zip(("power_start", "power_end", "sigma_s", "g", "tr"),
                          t_grads, j_grads):
        j = to_np(j)[perm] if name == "tr" else to_np(j)
        assert np.abs(j).max() > 0, name
        err = np.abs(to_np(t) - j).max()
        assert err <= 3e-4 * np.abs(j).max(), (name, err, np.abs(j).max())
