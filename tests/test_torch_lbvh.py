"""bre_tpu_torch.accel.lbvh against bre_tpu.accel.lbvh on the CPU.

The cases of tests/test_lbvh.py: random boxes with invalid primitives,
duplicate Morton codes, every box the same (candidate overflow), n = 1 and
n = 2, and a query set with no box at all.  The same numpy boxes go through
both packages' ``build_lbvh`` and ``query_aabb_collect``.

Tolerances: none.  The tree's integer arrays (sorted ids, children) must be
equal, so must the node and leaf boxes (exact min/max of float32 inputs),
and the candidates (in the reference walk's order), counts and overflow."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bre_tpu.accel import lbvh as jlbvh
from bre_tpu_torch.accel import lbvh as tlbvh


def _boxes(n, seed=0, span=10.0, size=0.5):
    rs = np.random.RandomState(seed)
    c = rs.uniform(-span, span, (n, 3)).astype(np.float32)
    h = rs.uniform(0.01, size, (n, 3)).astype(np.float32)
    return c - h, c + h


def _case(name):
    """(amin, amax, valid, qmin, qmax, K) of one case."""
    qmin, qmax = _boxes(50, seed=7, span=9.0, size=2.0)
    if name == "random":
        amin, amax = _boxes(777)
        valid = np.ones(777, bool)
        valid[::13] = False
        return amin, amax, valid, qmin, qmax, 64
    if name == "duplicate_codes":
        # pairs of identical boxes and a cluster inside one Morton cell
        amin, amax = _boxes(150, seed=3)
        amin = np.concatenate([amin, amin, np.full((40, 3), 2.0, np.float32)
                               + 1e-4 * np.arange(40, dtype=np.float32)[:,
                                                                        None]])
        amax = np.concatenate([amax, amax, amin[-40:] + 0.25])
        return amin, amax, np.ones(len(amin), bool), qmin, qmax, 128
    if name == "overflow":
        amin, amax = np.zeros((64, 3), np.float32), np.ones((64, 3), np.float32)
        valid = np.ones(64, bool)
        valid[5] = False
        return (amin, amax, valid, np.full((2, 3), 0.4, np.float32),
                np.array([[0.5] * 3, [0.45] * 3], np.float32), 16)
    if name == "all_invalid":
        amin, amax = _boxes(32)
        return amin, amax, np.zeros(32, bool), amin[:4], amax[:4], 8
    if name in ("n1", "n2"):
        n = int(name[1])
        amin = np.array([[0.0, 0.0, 0.0], [2.0, 0.5, 0.0]], np.float32)[:n]
        return (amin, amin + 1.0, np.ones(n, bool),
                np.array([[0.5] * 3, [5.0] * 3, [0.0, 0.0, 0.0]], np.float32),
                np.array([[0.6] * 3, [6.0] * 3, [2.5, 1.0, 0.5]], np.float32),
                4)
    raise KeyError(name)


CASES = ("random", "duplicate_codes", "overflow", "all_invalid", "n1", "n2")


@pytest.mark.parametrize("name", CASES)
def test_build_and_query_match_reference(name):
    amin, amax, valid, qmin, qmax, K = _case(name)
    ref = jlbvh.build_lbvh(jnp.asarray(amin), jnp.asarray(amax),
                           jnp.asarray(valid))
    mine = tlbvh.build_lbvh(torch.from_numpy(amin), torch.from_numpy(amax),
                            torch.from_numpy(valid))
    assert mine._fields == ref._fields and mine.n_leaves == ref.n_leaves
    for field in ref._fields:
        a, b = getattr(mine, field).numpy(), np.asarray(getattr(ref, field))
        assert a.shape == b.shape, field
        assert np.array_equal(a, b.astype(a.dtype)), field
    got = tlbvh.query_aabb_collect(mine, torch.from_numpy(qmin),
                                   torch.from_numpy(qmax), K)
    want = jlbvh.query_aabb_collect(ref, jnp.asarray(qmin), jnp.asarray(qmax),
                                    K)
    for what, a, b in zip(("candidates", "counts", "overflow"), got, want):
        assert np.array_equal(a.numpy(), np.asarray(b)), what
    if name == "overflow":
        assert got[1][0] == K and got[2][0] == 63 - K
    if name == "all_invalid":
        assert int(got[1].sum()) == 0


def test_query_is_the_brute_force_set():
    """Every query gets exactly the valid boxes that overlap it (the
    reference's own check, tests/test_lbvh.py), here on 2,000 boxes."""
    amin, amax = _boxes(2000, seed=11)
    valid = np.random.RandomState(1).rand(2000) > 0.1
    bvh = tlbvh.build_lbvh(torch.from_numpy(amin), torch.from_numpy(amax),
                           torch.from_numpy(valid))
    qmin, qmax = _boxes(40, seed=12, span=9.0, size=2.0)
    cand, counts, over = tlbvh.query_aabb_collect(
        bvh, torch.from_numpy(qmin), torch.from_numpy(qmax), 256)
    assert int(over.sum()) == 0
    for q in range(40):
        want = np.nonzero(valid & (qmax[q] >= amin).all(1)
                          & (qmin[q] <= amax).all(1))[0]
        assert sorted(cand[q, :counts[q]].tolist()) == want.tolist()


def test_clz_and_popcount_are_exact():
    """Count-leading-zeros without a float log2, exact at every bit width
    (the reference's warning: a float32 log2 is wrong above 2^24)."""
    v = torch.tensor([0, 1, 2, 3, (1 << 24) - 1, 1 << 24, (1 << 24) + 1,
                      (1 << 31) - 1, 1 << 31, 0xFFFFFFFF], dtype=torch.int64)
    want = [32 - int(x).bit_length() for x in v.tolist()]
    assert tlbvh._clz32(v).tolist() == want
    assert tlbvh._popcount32(v).tolist() == [bin(x).count("1")
                                             for x in v.tolist()]
    ref = np.asarray(jlbvh._clz32(jnp.asarray(v.numpy().astype(np.uint32))))
    assert ref.tolist() == want
