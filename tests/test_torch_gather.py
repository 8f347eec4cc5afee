"""bre_tpu_torch packed gather vs bre_tpu: the plain versions of the two
forward kernels against the Pallas kernels (interpret mode on CPU), the beam
packing, the block cull mask, the sparse block ids and the packed gather
entry point — identical numpy inputs through both packages.

Tolerances: packing, Morton order, masks and block ids are exact (integer
and permutation results of identical float inputs).  Gather sums use the
Pallas tests' rtol 2e-4 / atol 1e-8 (tests/test_pallas_gather.py:47): the
two frameworks round the closest-point solve differently (XLA contracts
multiply-adds, torch does not) and sum beams in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bre_tpu.accel import beam_gather as jbg
from bre_tpu.integrators.photon_trace import Beams as JBeams
from bre_tpu.ops import pallas_gather as jpg
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu_torch.accel import beam_gather as tbg
from bre_tpu_torch.integrators.photon_trace import Beams as TBeams
from bre_tpu_torch.ops import gather as tg
from bre_tpu_torch.scene.scene import scene_from_jax
from torch_parity import to_np

RTOL, ATOL = 2e-4, 1e-8


def _packed_inputs(n_tiles=4, n_chunks=16, seed=0, live=0.6):
    """Packed rays/beams/scalars/mask at the kernel's 256 x 256 blocks."""
    rs = np.random.RandomState(seed)
    T = C = 256
    rays = rs.uniform(-1, 1, (n_tiles, tg.NF, T)).astype(np.float32)
    d = rays[:, 3:6] - rays[:, 0:3]
    rays[:, 6:9] = d / np.linalg.norm(d, axis=1, keepdims=True)
    rays[:, 9] = np.linalg.norm(d, axis=1)
    rays[:, 10:13] = rs.uniform(0.2, 1.0, (n_tiles, 3, T))
    rays[:, 13:16] = rs.uniform(0.0, 1e-2, (n_tiles, 3, T))
    rays[:, 16] = rs.uniform(-0.6, 0.6, (n_tiles, T))
    rays[:, 17] = 1.0
    beams = rs.uniform(-1, 1, (n_chunks, tg.NB, C)).astype(np.float32)
    beams[:, 6:9] = rs.uniform(0.5, 2.0, (n_chunks, 3, C))
    beams[:, 9:12] = beams[:, 6:9] * rs.uniform(0.05, 1.0, (n_chunks, 3, C))
    beams[:, 12] = 0.15
    beams[:, 13] = 1.0
    beams[:, 14:] = 0.0
    beams[-1, 6:12, 100:] = 0.0  # dead powers (the _log_decay guard)
    # n_valid ends inside the second-to-last chunk: the last chunk is dead
    scal = np.array([[0.1, 1.0, 0.05, (n_chunks - 1) * C - 30]], np.float32)
    mask = (rs.rand(n_chunks, n_tiles) < live).astype(np.float32)
    mask[:, 0] = 0.0  # one tile with no live block
    return rays, beams, scal, mask


def test_gather_forward_ref_matches_pallas():
    rays, beams, scal, mask = _packed_inputs()
    j = jpg.pallas_gather_forward(jnp.asarray(rays), jnp.asarray(beams),
                                  jnp.asarray(scal), 256, 256,
                                  block_mask=jnp.asarray(mask))
    t = tg.gather_forward_ref(*(torch.from_numpy(x) for x in
                                (rays, beams, scal, mask)))
    assert t.shape == (4, 8, 256) and t.dtype == torch.float32
    assert float(np.abs(to_np(j)).max()) > 0
    np.testing.assert_allclose(to_np(t), to_np(j), rtol=RTOL, atol=ATOL)
    assert float(t[0].abs().max()) == 0.0 and float(t[:, 3:].abs().max()) == 0.0


def test_gather_sparse_ref_matches_pallas():
    rays, beams, scal, mask = _packed_inputs(seed=1, live=0.4)
    cap = 48
    idx_j, n_live_j = jpg.sparse_block_ids(jnp.asarray(mask), cap)
    idx_t, n_live_t = tg.sparse_block_ids(torch.from_numpy(mask), cap)
    assert int(n_live_t) == int(n_live_j) <= cap
    np.testing.assert_array_equal(to_np(idx_t), to_np(idx_j))
    j = jpg.pallas_gather_sparse(jnp.asarray(rays), jnp.asarray(beams),
                                 jnp.asarray(scal), 256, 256, idx_j)
    t = tg.gather_sparse_ref(torch.from_numpy(rays), torch.from_numpy(beams),
                             torch.from_numpy(scal), idx_t)
    np.testing.assert_allclose(to_np(t), to_np(j), rtol=RTOL, atol=ATOL)
    # the dense plain version over the same mask gives the same sums
    d = tg.gather_forward_ref(*(torch.from_numpy(x) for x in
                                (rays, beams, scal, mask)))
    torch.testing.assert_close(t, d, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("cap", [0, 5, 64])
def test_sparse_block_ids_exact(cap):
    """Tile-major ids, seeds, fill and truncation past the cap."""
    mask = (np.random.RandomState(cap).rand(9, 5) < 0.5).astype(np.float32)
    idx_j, n_j = jpg.sparse_block_ids(jnp.asarray(mask), cap)
    idx_t, n_t = tg.sparse_block_ids(torch.from_numpy(mask), cap)
    assert idx_t.dtype == torch.int32 and int(n_t) == int(n_j)
    np.testing.assert_array_equal(to_np(idx_t), to_np(idx_j))


def test_cpu_wrappers_take_the_plain_version():
    """On CPU tensors the wrappers return the plain version's result and
    launch nothing."""
    rays, beams, scal, mask = [torch.from_numpy(x) for x in
                               _packed_inputs(n_tiles=2, n_chunks=3)]
    n0 = (tg.gather_forward.launches, tg.gather_sparse.launches)
    assert torch.equal(tg.gather_forward(rays, beams, scal, mask),
                       tg.gather_forward_ref(rays, beams, scal, mask))
    idx, _ = tg.sparse_block_ids(mask, 6)
    assert torch.equal(tg.gather_sparse(rays, beams, scal, idx),
                       tg.gather_sparse_ref(rays, beams, scal, idx))
    assert (tg.gather_forward.launches, tg.gather_sparse.launches) == n0


def _beams_np(B=1100, seed=3):
    rs = np.random.RandomState(seed)
    return dict(
        start=rs.uniform(-1, 1, (B, 3)).astype(np.float32),
        end=rs.uniform(-1, 1, (B, 3)).astype(np.float32),
        power_start=rs.uniform(0.5, 2, (B, 3)).astype(np.float32),
        power_end=rs.uniform(0.05, 0.5, (B, 3)).astype(np.float32),
        radius=np.full((B,), 0.2, np.float32),
        medium=np.zeros((B,), np.int32),
        valid=rs.rand(B) > 0.3,
    )


def _jbeams(b):
    return JBeams(**{k: jnp.asarray(v) for k, v in b.items()})


def _tbeams(b):
    return TBeams(**{k: torch.from_numpy(v.astype(np.int64) if k == "medium"
                                         else v) for k, v in b.items()})


def _segments(R=300, seed=4):
    rs = np.random.RandomState(seed)
    a0 = rs.uniform(-2, -1, (R, 3)).astype(np.float32)
    a1 = rs.uniform(1, 2, (R, 3)).astype(np.float32)
    sd = ((a1 - a0) / np.linalg.norm(a1 - a0, axis=-1, keepdims=True)).astype(np.float32)
    med = np.where(rs.rand(R) < 0.8, 0, -1).astype(np.int32)
    trf = rs.uniform(0.2, 0.9, (R, 3)).astype(np.float32)
    return a0, a1, sd, med, trf


def test_pack_beams_and_block_mask_exact():
    """Validity-major Morton order, folded powers, padding and the chunk x
    tile cull mask equal the reference exactly on the same beams."""
    b = _beams_np()
    bp_j, nv_j = jbg.pack_beams_compact(_jbeams(b), 256)
    bp_t, nv_t = tbg.pack_beams_compact(_tbeams(b))
    assert bp_t.shape == (5, tg.NB, 256)
    np.testing.assert_array_equal(to_np(bp_t), to_np(bp_j))
    assert float(nv_t) == float(nv_j)
    a0, a1, *_ = _segments(R=512)
    m_j = jbg._block_overlap_mask(bp_j, jnp.asarray(a0), jnp.asarray(a1), 256,
                                  jnp.float32(0.2))
    m_t = tbg._block_overlap_mask(bp_t, torch.from_numpy(a0),
                                  torch.from_numpy(a1), 256, 0.2)
    np.testing.assert_array_equal(to_np(m_t), to_np(m_j))
    assert 0 < float(m_t.sum()) < m_t.numel()  # dead chunk culled


@pytest.mark.parametrize("sparse_cap", [0, 4096, 1])
def test_gather_beams_packed_matches(sparse_cap):
    """The packed entry point: dense tier, sparse tier, and a cap too small
    for the live blocks (falls back to the dense kernel)."""
    jb = JBuilder()
    jb.homogeneous_medium((0.05,) * 3, (0.5,) * 3, 0.3)
    jb.triangle((0, 0, 0), (1, 0, 0), (0, 1, 0))
    js = jb.build()
    ts = scene_from_jax(js)
    b = _beams_np()
    bp_j, nv_j = jbg.pack_beams_compact(_jbeams(b), 256)
    bp_t, nv_t = tbg.pack_beams_compact(_tbeams(b))
    a0, a1, sd, med, trf = _segments()
    j = jbg.gather_beams_packed(
        bp_j, nv_j, js.media, *(jnp.asarray(x) for x in (a0, a1, sd, med, trf)),
        jnp.float32(0.2), chunk=256, power_scale=1e-3, grad_extras=False,
        sparse_cap=sparse_cap)
    t = tbg.gather_beams_packed(
        bp_t, nv_t, ts.media, *(torch.from_numpy(x) for x in (a0, a1, sd)),
        torch.from_numpy(med.astype(np.int64)), torch.from_numpy(trf), 0.2,
        power_scale=1e-3, sparse_cap=sparse_cap)
    assert t.shape == (300, 3)
    assert float(np.abs(to_np(j)).max()) > 0
    np.testing.assert_allclose(to_np(t), to_np(j), rtol=RTOL, atol=ATOL)
    assert float(t[torch.from_numpy(med < 0)].abs().max()) == 0.0
