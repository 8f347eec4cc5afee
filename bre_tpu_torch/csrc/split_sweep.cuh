// The sweep design shared by the gather kernels (beam_gather_fwd.cu,
// beam_gather_bwd.cu): each ray tile's chunk range split across blocks, a
// fixed-order second pass over the splits, and a two-stage ring of staged
// blocks in shared memory fed by bulk copies.
//
// Split.  The ray-side sweeps (the forward, the backward's d_rays) run a
// grid of n_tiles x n_splits blocks; block (tile, s) folds the live chunks
// of split s in ascending order and writes its partial sums to a scratch
// array (n_splits, n_tiles, rows, T).  The live chunks are those with
// j*C < n_valid (the beams are validity-compacted); they are cut into
// n_splits ranges of K = ceil(n_live / n_splits) chunks, K read from the
// device's n_valid, so no block is spent on the dead tail and no host sync
// is needed.  A split with no live chunk writes zeros.  reduce_splits then
// adds the partials of each output element for s = 0 .. n_splits-1 in that
// order: one writer per element, no atomics, the same bits on every run.
// n_splits is a function of the shapes only (ops/gather.py split_count).
//
// Ring.  A pre-pass writes each chunk's staged terms once per call to
// device memory, field-major, exactly as a block would stage them in shared
// memory (pair_math.cuh stage_chunk).  A block then walks its
// live blocks with two stages in shared memory: while it sweeps one stage,
// one bulk copy fills the other, completed on that stage's mbarrier; one
// wait and one barrier per staged block.
#pragma once

#include "bulk_copy.cuh"
#include "pair_math.cuh"

namespace {

// Chunk j is live iff j*C < n_valid; n_valid / C is exact (C = 2^8), so
// this counts exactly the chunks that rule keeps.
__device__ __forceinline__ int live_chunk_count(float n_valid, int n_chunks) {
  const float n = ceilf(n_valid / static_cast<float>(C));
  if (!(n > 0.0f)) return 0;
  return n >= static_cast<float>(n_chunks) ? n_chunks : static_cast<int>(n);
}

// The chunks [lo, hi) of split s of n_splits (ops/gather.py split_bounds).
struct ChunkRange {
  int lo, hi;
};

__device__ __forceinline__ ChunkRange split_range(float n_valid, int n_chunks,
                                                  int n_splits, int s) {
  const int n_live = live_chunk_count(n_valid, n_chunks);
  const int k = (n_live + n_splits - 1) / n_splits;
  return {min(s * k, n_live), min((s + 1) * k, n_live)};
}

// The two stages of a ring and their barriers, in dynamic shared memory
// (ring_smem_bytes<Stage>() at the launch).
template <class Stage>
__device__ __forceinline__ Stage* ring_stages() {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  return reinterpret_cast<Stage*>(ring_smem);
}

template <class Stage>
__device__ __forceinline__ uint64_t* ring_bars() {
  return reinterpret_cast<uint64_t*>(ring_stages<Stage>() + 2);
}

template <class Stage>
constexpr size_t ring_smem_bytes() {
  static_assert(2 * sizeof(Stage) + 2 * sizeof(uint64_t) <= 48 * 1024,
                "a ring must fit the 48 KB of dynamic shared memory that a "
                "launch may take without raising the kernel's limit");
  return 2 * sizeof(Stage) + 2 * sizeof(uint64_t);
}

// Called by every thread of the block before its walk.
template <class Stage>
__device__ __forceinline__ void ring_init() {
  static_assert(sizeof(Stage) % 16 == 0,
                "bulk copies move multiples of 16 bytes");
  if (threadIdx.x == 0) {
    mbar_init(ring_bars<Stage>());
    mbar_init(ring_bars<Stage>() + 1);
  }
  __syncthreads();
}

// Walk the positions p, next(p), next(next(p)), ... while p < end: src(p)
// is the staged block (in device memory) of position p; body(stage, p)
// runs on every thread once it has landed in shared memory.  Thread 0
// issues the copy of the next position before the block waits for the
// current one, so each copy overlaps the previous block's sweep.  Every
// issued copy is consumed before the walk ends.
template <class Stage, class Next, class Src, class Body>
__device__ __forceinline__ void ring_walk(int p, int end, Next next, Src src,
                                          Body body) {
  Stage* stage = ring_stages<Stage>();
  uint64_t* bar = ring_bars<Stage>();
  constexpr unsigned kBytes = sizeof(Stage);
  if (threadIdx.x == 0 && p < end) bulk_load(stage, src(p), kBytes, bar);
  for (int it = 0; p < end; ++it) {
    const int pn = next(p);
    const int cur = it & 1, nxt = cur ^ 1;
    // stage nxt was last read in iteration it-1, behind its __syncthreads
    if (threadIdx.x == 0 && pn < end)
      bulk_load(stage + nxt, src(pn), kBytes, bar + nxt);
    mbar_wait(bar + cur, (it >> 1) & 1);
    body(stage[cur], p);
    __syncthreads();  // every thread is done with stage cur
    p = pn;
  }
}

// The positions j < hi whose block-mask entry line[j * stride] is > 0:
// the live chunks of a split for one ray tile (line = mask + tile, stride
// n_tiles).  (first, end, next) of a ring_walk.
struct MaskedChunks {
  const float* line;
  int stride, hi;

  __device__ __forceinline__ bool live(int j) const {
    return __ldg(line + static_cast<size_t>(j) * stride) > 0.0f;
  }
  __device__ __forceinline__ int next(int j) const {
    do {
      ++j;
    } while (j < hi && !live(j));
    return j;
  }
  __device__ __forceinline__ int first(int lo) const {
    return lo < hi && live(lo) ? lo : next(lo);
  }
  __device__ __forceinline__ int end() const { return hi; }
};

// The entries [k0, k1) of a tile-major compacted id list (ops/gather.py
// sparse_block_ids: tile*(n_chunks+1) + chunk+1, seed entries ...+0): the
// positions are list entries, skipping seeds and chunks past n_valid.
struct ListedChunks {
  const int* idx;
  int n1, k1;
  float n_valid;

  __device__ __forceinline__ int chunk(int k) const {
    return __ldg(idx + k) % n1 - 1;
  }
  __device__ __forceinline__ bool live(int k) const {
    const int j = chunk(k);
    return j >= 0 && static_cast<float>(j * C) < n_valid;
  }
  __device__ __forceinline__ int next(int k) const {
    do {
      ++k;
    } while (k < k1 && !live(k));
    return k;
  }
  __device__ __forceinline__ int first(int k0) const {
    return k0 < k1 && live(k0) ? k0 : next(k0);
  }
  __device__ __forceinline__ int end() const { return k1; }
};

// Pre-pass: each live chunk's per-beam terms, once per call, into staged
// (n_chunks, 16|21, C); chunks past n_valid are never read and not written.
template <bool HETERO>
__global__ void __launch_bounds__(C)
stage_beams(const float* __restrict__ beams, const float* __restrict__ scalars,
            float* __restrict__ staged) {
  constexpr int nb = HETERO ? NB_HET : NB;
  const int j = blockIdx.x;
  if (!(static_cast<float>(j * C) < scalars[3])) return;
  stage_chunk(beams + static_cast<size_t>(j) * nb * C,
              reinterpret_cast<ChunkT<HETERO>*>(staged)[j], threadIdx.x,
              scalars[0]);
}

// out (n_tiles, rows_out, T) = sum over s of partial (n_splits, n_tiles,
// rows_in, T), s ascending; rows rows_in .. rows_out-1 are 0.  Grid
// (n_tiles, rows_out), one thread per ray.
__global__ void __launch_bounds__(T)
reduce_splits(const float* __restrict__ partial, float* __restrict__ out,
              int n_splits, int n_tiles, int rows_in, int rows_out) {
  const int tile = blockIdx.x, row = blockIdx.y;
  const size_t split_stride = static_cast<size_t>(n_tiles) * rows_in * T;
  const float* p = partial +
                   (static_cast<size_t>(tile) * rows_in + row) * T + threadIdx.x;
  float v = 0.0f;
  if (row < rows_in)
    for (int s = 0; s < n_splits; ++s) v = add(v, p[s * split_stride]);
  out[(static_cast<size_t>(tile) * rows_out + row) * T + threadIdx.x] = v;
}

// Writes one block's partial sums: rows of split blockIdx.y, tile
// blockIdx.x.
template <int ROWS>
__device__ __forceinline__ void write_partial(float* __restrict__ partial,
                                              const float acc[ROWS]) {
  float* o = partial +
             (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * ROWS * T +
             threadIdx.x;
#pragma unroll
  for (int row = 0; row < ROWS; ++row) o[row * T] = acc[row];
}

}  // namespace
