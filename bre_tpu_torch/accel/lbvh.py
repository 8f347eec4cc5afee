"""LBVH: a Morton-sorted linear BVH (counterpart of ``bre_tpu/accel/lbvh.py``).

Karras 2012 ("Maximally Parallel Construction of Linear BVHs"): every
internal node's child range is a function of the sorted Morton codes, so
the hierarchy is flat int64 arrays built in O(N) vectorized steps; node
boxes come from a doubling sparse table of leaf-box min/max over each
node's contiguous leaf range.  The beam-LBVH gather (``gather="lbvh"``)
queries it per ray tile (``query_aabb_collect``); the scene's tri-BVH
(``Scene.tri_bvh``) is traversed per ray by ``scene/intersect.py``.

Codes are uint32 values held in int64; each multiply is masked to 32 bits,
so the results are bit-equal to the reference's uint32 arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

_M32 = 0xFFFFFFFF
QUERY_BLOCK = 64  # query boxes tested against every leaf at a time


class LBVH(NamedTuple):
    """Flat LBVH over N primitives (N >= 1).  Internal nodes 0..N-2; a child
    >= 0 is an internal node, < 0 the sorted leaf ``~child``."""

    prim_ids: torch.Tensor  # (N,) int64 original primitive per sorted leaf
    left_child: torch.Tensor  # (N-1,) int64
    right_child: torch.Tensor  # (N-1,) int64
    node_min: torch.Tensor  # (N-1, 3) internal node bounds
    node_max: torch.Tensor  # (N-1, 3)
    leaf_min: torch.Tensor  # (N, 3) sorted leaf bounds
    leaf_max: torch.Tensor  # (N, 3)

    @property
    def n_leaves(self) -> int:
        return self.prim_ids.shape[0]


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every 3rd position."""
    v = (v * 0x00010001 & _M32) & 0xFF0000FF
    v = (v * 0x00000101 & _M32) & 0x0F00F00F
    v = (v * 0x00000011 & _M32) & 0xC30C30C3
    v = (v * 0x00000005 & _M32) & 0x49249249
    return v


def morton3(p01: torch.Tensor) -> torch.Tensor:
    """(N,3) float in [0,1] -> 30-bit Morton codes (int64)."""
    e = _expand_bits(torch.clamp(p01 * 1024.0, 0.0, 1023.0).to(torch.int64))
    return (e[..., 2] << 2) | (e[..., 1] << 1) | e[..., 0]


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _M32) >> 24


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Exact count of leading zeros of a uint32 (held in int64) by bit
    smearing and popcount: a float log2 is wrong above 2^24 in float32."""
    v = x
    for s in (1, 2, 4, 8, 16):
        v = v | (v >> s)
    return 32 - _popcount32(v)


def _common_prefix(codes: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
                   n: int) -> torch.Tensor:
    """delta(i, j): the common-prefix length of the 64-bit keys
    (code << 32) | index, -1 where j is out of range (Karras sec. 4)."""
    valid = (j >= 0) & (j < n)
    j_c = j.clamp(0, n - 1)
    x_hi = codes[i] ^ codes[j_c]
    x_lo = i ^ j_c
    prefix = torch.where(x_hi == 0, 32 + _clz32(x_lo), _clz32(x_hi))
    return torch.where(valid, prefix, torch.full_like(prefix, -1))


def build_lbvh(aabb_min: torch.Tensor, aabb_max: torch.Tensor,
               valid: torch.Tensor) -> LBVH:
    """Build from per-primitive boxes; invalid primitives get far-away boxes
    that no query meets and sort last (lbvh.py:99-194).  The sort is
    stable, as ``jnp.argsort``'s: the tie order fixes the tree."""
    n = aabb_min.shape[0]
    if n >= 1 << 30:
        raise ValueError(f"{n} primitives: the split search covers n < 2^30")
    dev = aabb_min.device
    vcol = valid[:, None]
    big = torch.full_like(aabb_min, 1e16)
    amin = torch.where(vcol, aabb_min, big)
    amax = torch.where(vcol, aabb_max, big)
    inf = torch.full_like(aabb_min, float("inf"))
    any_valid = valid.any()
    smin = torch.where(any_valid, torch.where(vcol, aabb_min, inf).amin(0),
                       torch.zeros(3, dtype=aabb_min.dtype, device=dev))
    smax = torch.where(any_valid, torch.where(vcol, aabb_max, -inf).amax(0),
                       torch.ones(3, dtype=aabb_min.dtype, device=dev))
    extent = torch.clamp_min(smax - smin, 1e-12)
    centroid = 0.5 * (amin + amax)
    codes = morton3((centroid - smin) / extent)
    codes = torch.where(valid, codes, torch.full_like(codes, _M32))
    order = torch.argsort(codes, stable=True)
    sorted_codes = codes[order]
    leaf_min, leaf_max = amin[order], amax[order]
    if n == 1:
        e = torch.zeros((0,), dtype=torch.int64, device=dev)
        z = torch.zeros((0, 3), dtype=aabb_min.dtype, device=dev)
        return LBVH(order, e, e, z, z, leaf_min, leaf_max)

    def delta(i, j):
        return _common_prefix(sorted_codes, i, j, n)

    i = torch.arange(n - 1, dtype=torch.int64, device=dev)
    d = torch.where(delta(i, i + 1) > delta(i, i - 1), 1, -1)
    delta_min = delta(i, i - d)
    # the range's other end: exponential then binary search (Karras fig. 4)
    lmax = torch.full_like(i, 2)
    cont = torch.ones_like(i, dtype=torch.bool)
    for _ in range(32):
        test = delta(i, i + lmax * d) > delta_min
        lmax = torch.where(test & cont, lmax * 2, lmax)
        cont = cont & test
    l_ = torch.zeros_like(i)
    t = lmax // 2
    for _ in range(32):
        cand = l_ + t
        ok = delta(i, i + cand * d) > delta_min
        l_ = torch.where((t > 0) & ok, cand, l_)
        t = t // 2
    j = i + l_ * d
    # the split: a binary search on the node's prefix, t = ceil(l / 2^k)
    delta_node = delta(i, j)
    s = torch.zeros_like(i)
    t = (l_ + 1) // 2
    for k in range(1, 31):
        cand = s + t
        ok = delta(i, i + cand * d) > delta_node
        s = torch.where((t > 0) & ok, cand, s)
        shift = min(k + 1, 30)
        t = torch.where(t > 1, (l_ + (1 << shift) - 1) >> shift,
                        torch.zeros_like(t))
    gamma = i + s * d + torch.clamp_max(d, 0)
    lo, hi = torch.minimum(i, j), torch.maximum(i, j)
    left_child = torch.where(lo == gamma, ~gamma, gamma)
    right_child = torch.where(hi == gamma + 1, ~(gamma + 1), gamma + 1)
    node_min, node_max = _range_minmax(leaf_min, leaf_max, lo, hi)
    return LBVH(order, left_child, right_child, node_min, node_max, leaf_min,
                leaf_max)


def _range_minmax(leaf_min, leaf_max, lo, hi):
    """Min/max of the leaf boxes over [lo, hi] by a doubling sparse table
    (lbvh.py:205-232): O(N log N) build, two lookups per node."""
    n = leaf_min.shape[0]
    levels = max(1, (n - 1).bit_length())
    ar = torch.arange(n, device=leaf_min.device)
    mins, maxs = [leaf_min], [leaf_max]
    for k in range(1, levels + 1):
        idx = torch.clamp_max(ar + (1 << (k - 1)), n - 1)
        mins.append(torch.minimum(mins[-1], mins[-1][idx]))
        maxs.append(torch.maximum(maxs[-1], maxs[-1][idx]))
    mins_t, maxs_t = torch.stack(mins), torch.stack(maxs)
    span = hi - lo + 1
    k = (31 - _clz32(torch.clamp_min(span, 1))).clamp(0, levels)
    second = (hi - torch.bitwise_left_shift(torch.ones_like(k), k) + 1).clamp(
        0, n - 1)
    return (torch.minimum(mins_t[k, lo], mins_t[k, second]),
            torch.maximum(maxs_t[k, lo], maxs_t[k, second]))


def emission_order(bvh: LBVH) -> torch.Tensor:
    """The sorted leaves in the order the reference's stack walk reaches
    them (lbvh.py:266-318): a popped node handles its left child, then its
    right one, and pushes the internal ones in that order, so the right
    subtree is walked first.  The walk's pops are the right-first pre-order
    of the internal nodes, which over Karras' contiguous ranges is the sort
    by (hi descending, lo ascending); each leaf comes at its parent's pop,
    the left one first.  Returns (N,) sorted-leaf positions."""
    n = bvh.n_leaves
    dev = bvh.prim_ids.device
    if n == 1:
        return torch.zeros(1, dtype=torch.int64, device=dev)
    lo, hi = _node_ranges(bvh)
    pre = torch.argsort(lo - hi * n, stable=True)  # hi desc, then lo asc
    rank = torch.empty_like(pre)
    rank[pre] = torch.arange(n - 1, device=dev)
    key = torch.empty(n, dtype=torch.int64, device=dev)
    for side, ch in enumerate((bvh.left_child, bvh.right_child)):
        leaf = ch < 0
        key[~ch[leaf]] = 2 * rank[leaf] + side
    return torch.argsort(key)


def _node_ranges(bvh: LBVH):
    """Each internal node's sorted-leaf range [lo, hi]: its leftmost leaf,
    reached by following left children, and its rightmost, by following
    right children (a tree of N < 2^30 leaves is under 64 levels deep)."""
    ends = []
    for ch in (bvh.left_child, bvh.right_child):
        ptr = ch.clone()
        for step in range(64):
            ptr = torch.where(ptr >= 0, ch[ptr.clamp_min(0)], ptr)
            if step % 8 == 7 and not bool((ptr >= 0).any()):
                break
        ends.append(~ptr)
    return ends[0], ends[1]


def query_aabb_collect(bvh: LBVH, q_min: torch.Tensor, q_max: torch.Tensor,
                       max_candidates: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For each query box, the primitive ids of the leaves it overlaps, in
    the order of the reference's per-query stack walk (lbvh.py:235-325).

    Returns (candidates (Q, K) int64, -1 padded; counts (Q,); overflow (Q,):
    the overlapping leaves past K).  A leaf box lies inside each of its
    ancestors' boxes (they are the exact min/max over it), so the walk
    reaches exactly the leaves whose boxes overlap the query, in the fixed
    order of ``emission_order``; here every query tests every leaf and
    keeps the first K in that order, ``QUERY_BLOCK`` queries at a time.
    The reference's 64-deep stack never overflows: a Karras node's prefix
    length grows strictly down the tree, over at most 1 + 30 + bitlen(N - 1)
    values, under 64 for the N < 2^30 that ``build_lbvh`` admits."""
    K = int(max_candidates)
    dev = q_min.device
    Q = q_min.shape[0]
    order = emission_order(bvh)
    lmin, lmax = bvh.leaf_min[order], bvh.leaf_max[order]
    ids = bvh.prim_ids[order]
    cand = torch.full((Q, K), -1, dtype=torch.int64, device=dev)
    counts = torch.zeros(Q, dtype=torch.int64, device=dev)
    over = torch.zeros(Q, dtype=torch.int64, device=dev)
    for q0 in range(0, Q, QUERY_BLOCK):
        qn, qx = q_min[q0:q0 + QUERY_BLOCK], q_max[q0:q0 + QUERY_BLOCK]
        hit = ((qx[:, None, :] >= lmin[None]).all(-1)
               & (qn[:, None, :] <= lmax[None]).all(-1))  # (q, N)
        pos = hit.cumsum(1) - 1
        keep = hit & (pos < K)
        qi = torch.arange(qn.shape[0], device=dev)[:, None].expand_as(pos)
        blk = cand[q0:q0 + QUERY_BLOCK]
        blk[qi[keep], pos[keep]] = ids[None].expand_as(pos)[keep]
        total = hit.sum(1)
        counts[q0:q0 + QUERY_BLOCK] = total.clamp_max(K)
        over[q0:q0 + QUERY_BLOCK] = (total - K).clamp_min(0)
    return cand, counts, over
