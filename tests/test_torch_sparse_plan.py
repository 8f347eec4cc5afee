"""The sparse tier's id lists and work plans against the reference's.

``sparse_block_ids`` and ``sparse_block_ids_chunk_major`` build the
compacted lists on the device from one prefix sum over the mask (no
``torch.nonzero``, no host sync); they must equal the reference's
``jnp.nonzero(size=, fill_value=)`` lists bit for bit, the overflowing
(n_live > cap) and the empty ones too.  ``sparse_ray_plan`` and
``sparse_beam_plan`` are what the sparse kernels read: a launch order (the
runs largest first), each run's entries, and each entry's chunk or tile.
Taken block by block in launch order, they must fold every block that the
reference's sparse kernels sweep (``_sparse_kernel``,
bre_tpu/ops/pallas_gather.py:383-404; ``_sparse_bwd_rays_kernel`` and
``_sparse_bwd_beams_kernel``, pallas_gather_bwd.py:550-590) exactly once,
each output's blocks in ascending order.  All exact (integer results)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bre_tpu.ops import pallas_gather as jpg
from bre_tpu.ops import pallas_gather_bwd as jpgb
from bre_tpu_torch.ops import gather as tg
from bre_tpu_torch.ops import gather_bwd as tgb

C = tg.KERNEL_CHUNK


def _mask(kind, n_chunks, n_tiles, seed):
    """A block mask: ``random`` (a fifth live), ``clustered`` (a few heavy
    chunks and tiles over a sparse background, as in a sweep of the sparse
    regime), ``empty`` or ``full``."""
    rs = np.random.RandomState(seed)
    if kind == "empty":
        return np.zeros((n_chunks, n_tiles), np.float32)
    if kind == "full":
        return np.ones((n_chunks, n_tiles), np.float32)
    m = rs.rand(n_chunks, n_tiles) < (0.2 if kind == "random" else 0.03)
    if kind == "clustered":
        m[rs.choice(n_chunks, 3, replace=False)] = True  # heavy chunks
        m[:, rs.choice(n_tiles, 2, replace=False)] = True  # heavy tiles
        m[n_chunks // 3:n_chunks // 2, :n_tiles // 4] = True  # a patch
    return m.astype(np.float32)


CASES = [("random", 40, 64), ("clustered", 40, 64), ("clustered", 300, 17),
         ("empty", 12, 8), ("full", 12, 8)]


@pytest.mark.parametrize("kind,n_chunks,n_tiles", CASES)
@pytest.mark.parametrize("cap", ["all", "overflow", "zero"])
def test_id_lists_equal_the_reference(kind, n_chunks, n_tiles, cap):
    mask = _mask(kind, n_chunks, n_tiles, n_chunks + n_tiles)
    n_live = int((mask > 0).sum())
    cap = {"all": n_live, "overflow": n_live // 3, "zero": 0}[cap]
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    for ours, ref in ((tg.sparse_block_ids, jpg.sparse_block_ids),
                      (tgb.sparse_block_ids_chunk_major,
                       jpgb.sparse_block_ids_chunk_major)):
        idx, live = ours(tm, cap)
        ridx, rlive = ref(jm, cap)
        assert idx.dtype == torch.int32
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
        assert int(live) == int(rlive) == n_live


@pytest.mark.parametrize("size", [0, 5, 37, 200])
def test_nonzero_fixed_is_nonzero_with_size_and_fill(size):
    flat = np.random.RandomState(size).randn(150).astype(np.float32)
    flat[np.abs(flat) < 0.8] = 0.0
    flat[7] = -2.0  # negative entries count as nonzero, as in jnp.nonzero
    out = tg.nonzero_fixed(torch.from_numpy(flat), size, 999)
    (ref,) = jnp.nonzero(jnp.asarray(flat), size=size, fill_value=999)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _reference_runs(idx, n_outer, n_inner, n_valid, chunk_major):
    """{output: [block, ...]} the reference's sparse kernel sweeps for an id
    list: outer = tile (tile-major) or chunk (chunk-major), skipping the
    seed and fill entries and the chunks at or past n_valid."""
    out = {o: [] for o in range(n_outer)}
    for e in np.asarray(idx).tolist():
        outer, sub = divmod(e, n_inner + 1)
        if outer >= n_outer or sub == 0:
            continue
        chunk = outer if chunk_major else sub - 1
        if np.float32(chunk * C) < n_valid:
            out[outer].append(sub - 1)
    return out


def _assert_work_order(order, counts):
    """order is a permutation of the runs, largest count first, ties in
    index order."""
    order, counts = order.tolist(), counts.tolist()
    assert sorted(order) == list(range(len(counts)))
    keys = [(-counts[b], b) for b in order]
    assert keys == sorted(keys)


@pytest.mark.parametrize("kind,n_chunks,n_tiles", CASES)
@pytest.mark.parametrize("n_valid_chunks", [0.5, 0.7, 2.0])
def test_plans_cover_the_reference_blocks(kind, n_chunks, n_tiles,
                                          n_valid_chunks):
    mask = _mask(kind, n_chunks, n_tiles, 7 * n_chunks + n_tiles)
    n_valid = np.float32(int(n_valid_chunks * n_chunks) * C - 37)
    scal = torch.tensor([[0.1, 1.0, 0.05, n_valid]], dtype=torch.float32)
    cap = int(mask.sum())
    tm = torch.from_numpy(mask)
    # ray side: tile-major list, split at the dense kernels' chunk bounds
    idx, _ = tg.sparse_block_ids(tm, cap)
    n_splits = tg.split_count(n_tiles, n_chunks)
    chunk_of, run_start, order = tg.sparse_ray_plan(idx, scal, n_tiles,
                                                    n_chunks, n_splits)
    assert chunk_of.dtype == run_start.dtype == order.dtype == torch.int32
    assert run_start.shape == (n_splits + 1, n_tiles)
    assert order.shape == (n_splits * n_tiles,)
    counts = (run_start[1:] - run_start[:-1]).reshape(-1)
    _assert_work_order(order, counts)
    bounds = tg.split_bounds(scal[0, 3], n_chunks, n_splits).tolist()
    folded = {t: {} for t in range(n_tiles)}
    for b in order.tolist():  # launch order
        s, t = divmod(b, n_tiles)
        run = [j for j in chunk_of[run_start[s, t]:run_start[s + 1, t]]
               .tolist() if j >= 0 and np.float32(j * C) < n_valid]
        assert len(run) == counts[b]  # the count is the run's work
        assert all(bounds[s] <= j < bounds[s + 1] for j in run)
        folded[t][s] = run
    ref = _reference_runs(idx, n_tiles, n_chunks, n_valid, False)
    for t in range(n_tiles):  # splits added in order, each run ascending
        assert sum((folded[t][s] for s in range(n_splits)), []) == ref[t], t
    # d_beams side: chunk-major list, one block per chunk
    idx_c, _ = tgb.sparse_block_ids_chunk_major(tm, cap)
    tile_of, chunk_start, c_order = tgb.sparse_beam_plan(idx_c, n_chunks,
                                                         n_tiles)
    assert tile_of.dtype == chunk_start.dtype == c_order.dtype == torch.int32
    _assert_work_order(c_order, chunk_start[1:] - chunk_start[:-1])
    ref_c = _reference_runs(idx_c, n_chunks, n_tiles, n_valid, True)
    for j in c_order.tolist():
        run = [t for t in tile_of[chunk_start[j]:chunk_start[j + 1]].tolist()
               if t >= 0]
        live = np.float32(j * C) < n_valid  # the kernel writes 0 past it
        assert (run if live else []) == ref_c[j], j
        assert run == sorted(run)
