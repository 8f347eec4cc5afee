"""The split plan of the port's ray-side gather kernels against the blocks
the reference's kernels sweep.

The CUDA kernels split each ray tile's chunk range across ``split_count``
blocks (csrc/split_sweep.cuh): split s folds the live chunks in
``split_bounds``' range [b[s], b[s+1]) under the block mask, and the sparse
kernels take each split's part of a tile's run of listed blocks from
``split_run_starts``.  The kernels compute the same bounds on the card; here
the Python form of the plan, on the CPU, must cover exactly the blocks that
``pallas_gather_sparse`` (bre_tpu/ops/pallas_gather.py:399) sweeps for the
same mask, ids and n_valid: every live chunk of every tile in exactly one
split, in ascending order.  All exact (integer results)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bre_tpu.ops import pallas_gather as jpg
from bre_tpu_torch.ops import gather as tg

C = tg.KERNEL_CHUNK
N_CHUNKS = 40


def _reference_blocks(mask, n_valid):
    """{tile: [chunk, ...]} the reference's sparse kernel sweeps: its ids
    (tile-major, chunks ascending) with the kernel's skip of seed entries
    and of chunks at or past n_valid."""
    n_chunks, n_tiles = mask.shape
    idx, _ = jpg.sparse_block_ids(jnp.asarray(mask), int(mask.sum()))
    out = {t: [] for t in range(n_tiles)}
    for e in np.asarray(idx).tolist():
        tile, sub = divmod(e, n_chunks + 1)
        if tile < n_tiles and sub > 0 and np.float32((sub - 1) * C) < n_valid:
            out[tile].append(sub - 1)
    return out


def _dense_plan(mask, bounds):
    """{(split, tile): [chunk, ...]}: the dense kernels' walk."""
    n_tiles = mask.shape[1]
    b = bounds.tolist()
    return {(s, t): [j for j in range(b[s], b[s + 1]) if mask[j, t] > 0]
            for s in range(len(b) - 1) for t in range(n_tiles)}


@pytest.mark.parametrize("n_tiles", [1, 64, 256])
@pytest.mark.parametrize("n_valid", [0, 1, 17 * C + 101, N_CHUNKS * C + 999])
def test_split_plan_covers_the_reference_blocks(n_tiles, n_valid):
    rs = np.random.RandomState(n_tiles + n_valid)
    mask = (rs.rand(N_CHUNKS, n_tiles) < 0.45).astype(np.float32)
    mask[:, n_tiles // 2] = 0.0  # a tile with no live block
    mask[3:9, 0] = 1.0  # a run of live chunks
    n_splits = tg.split_count(n_tiles, N_CHUNKS)
    bounds = tg.split_bounds(torch.tensor(np.float32(n_valid)), N_CHUNKS,
                             n_splits)
    assert bounds.shape == (n_splits + 1,) and int(bounds[0]) == 0
    assert bool((bounds[1:] >= bounds[:-1]).all())
    # no split starts past the live chunks, and every live chunk is in one
    n_live = min(N_CHUNKS, -(-n_valid // C))
    assert int(bounds[-1]) == n_live
    dense = _dense_plan(mask, bounds)
    ref = _reference_blocks(mask, np.float32(n_valid))
    for t in range(n_tiles):
        walked = sum((dense[(s, t)] for s in range(n_splits)), [])
        assert walked == ref[t], t  # each once, ascending
    # the sparse kernels' part of each run: exactly the dense plan's blocks
    idx, _ = tg.sparse_block_ids(torch.from_numpy(mask), int(mask.sum()))
    starts = tg.split_run_starts(idx, n_tiles, N_CHUNKS, bounds)
    assert starts.shape == (n_splits + 1, n_tiles)
    assert starts.dtype == torch.int32
    ids = idx.tolist()
    for (s, t), chunks in dense.items():
        run = ids[int(starts[s, t]):int(starts[s + 1, t])]
        assert [e % (N_CHUNKS + 1) - 1 for e in run] == chunks, (s, t)
        assert all(e // (N_CHUNKS + 1) == t for e in run)


@pytest.mark.parametrize("n_tiles,n_chunks,want", [
    (64, 27_344, 66),   # the 256x256 step's R/4 sweep: 4,224 blocks
    (256, 27_344, 17),  # its full-film sweep: 4,352 blocks
    (1024, 2_735, 5),   # config 3's full film
    (1, 24, 24),        # one ray tile: one split per chunk
    (1, 5_000, 4_224),
])
def test_split_count_is_a_function_of_the_shapes(n_tiles, n_chunks, want):
    n_splits = tg.split_count(n_tiles, n_chunks)
    assert n_splits == want
    assert 1 <= n_splits <= n_chunks
    # 8 waves of 4 resident 256-thread blocks on each of 132 SMs, or one
    # split per chunk where the chunks run out first
    assert (n_tiles * n_splits >= tg.SPLIT_TARGET_BLOCKS
            or n_splits == n_chunks)
    assert n_tiles * (n_splits - 1) < tg.SPLIT_TARGET_BLOCKS


def test_split_bounds_stay_on_the_device_of_n_valid():
    """The bounds come from the n_valid tensor itself, with no host read:
    a tensor in, a tensor on its device out, at every n_valid."""
    for n_valid in (0.0, 255.0, 256.0, 257.0, 1e9):
        b = tg.split_bounds(torch.tensor(n_valid), 10, 4)
        assert b.device == torch.device("cpu") and b.dtype == torch.int64
        n_live = min(10, int(np.ceil(n_valid / C)))
        k = -(-n_live // 4)
        assert b.tolist() == [min(s * k, n_live) for s in range(5)]
