// Beam radiance estimate gather, forward — hand-written CUDA for Hopper
// (sm_90a), built at first use by bre_tpu_torch/ops/cuda_build.py and bound
// through ctypes by bre_tpu_torch/ops/gather.py.
//
// Replaces the two Pallas TPU forward kernels of bre_tpu/ops/pallas_gather.py:
//   - pallas_gather_forward (:245, body _gather_kernel :105) — the dense
//     (beam chunk x ray tile) grid with the chunk x tile block mask;
//   - pallas_gather_sparse (:425, body _sparse_kernel :383) — the same pair
//     math over a tile-major compacted list of live (tile, chunk) blocks;
// both built on the shared pair math _pair_block_update (:134), each in two
// instances: homogeneous media (NF = 18 ray rows, NB = 16 beam fields) and
// grid-density media (template argument HETERO: NF_HET = 32, NB_HET = 24,
// the hetero branch of _pair_block_update, :208-232).
//
// What it computes: for every camera segment (ray) of a 256-ray tile and every
// photon beam of the live 256-beam chunks, the normalized 1D-1D beam radiance
// estimate: Ericson closest points, r^2 against the blur width, the
// Epanechnikov weight, the HG phase, a clamped 1/sin(theta), and one exp per
// channel for beam power times camera transmittance.  Output (n_tiles, 8, T),
// RGB in rows 0-2, rows 3-7 zero.  In a grid medium the power and
// transmittance come from the segments' polynomial tables instead: per
// in-range pair dens_c (6 coefficients) and D_c (5) by Horner at the camera
// fraction, D_b (5) at the beam fraction, each clamped at 0, then per
// channel ps * exp(-(sigma_t_b D_b + sigma_t_c D_c)) * sigma_s * dens_c.
//
// What bounds it on an H100: arithmetic, not bytes.  A live block is 65,536
// pairs read from 256 x (18 + 16) floats; each pair costs ~50 FP32
// instructions (an IEEE divide among them) and, inside the blur radius, two
// rsqrt and three exp on the SFU, in long chains of dependent operations.
// So the card is held back by how many warps it can keep in flight to hide
// those chains, and the design (split_sweep.cuh) fills it:
//   - a grid of n_tiles x n_splits blocks of 256 threads, one ray per thread,
//     the ray's fields (and log(tr), |d1|^2, 1/|d1|^2) in registers; block
//     (tile, s) folds the live chunks of split s of the tile's chunk range
//     (K = ceil(n_live / n_splits) chunks, read from n_valid on the device)
//     into partial sums, and reduce_splits adds the splits in order.  An R/4
//     sweep (64 ray tiles) thus runs 4,224 blocks, 8 waves over the 132
//     SMs, instead of 64 blocks on 64 of them;
//   - stage_beams writes each live chunk's per-beam terms (pair_math.cuh
//     BeamChunk, BeamChunkHet: the divides, rsqrt and logs a pair would
//     otherwise repeat) once per call; a block pulls its next live chunk
//     (16 KB; 21 KB with the grid tables) with one bulk copy into a
//     two-stage shared-memory ring while it sweeps the current one; a
//     grid-medium ray thread keeps its 14 table coefficients in registers;
//   - pairs outside the blur radius (most of them) branch past the phase,
//     kernel and exp work;
//   - FP32 on the CUDA cores, no tensor cores: TF32/bf16 rounding biased the
//     segment geometry on the TPU (pallas_gather.py:154-159).  Every product
//     and sum of the pair math is rounded on its own (pair_math.cuh), in the
//     plain version's order; this costs instruction count (no fused
//     multiply-adds) and buys agreement with the plain version to float ulps.
//     Compiled without fast-math, so exp, log and division are the accurate
//     ones.
// Each output element is written by exactly one thread of reduce_splits;
// each block walks its chunks in ascending order with one partial sum per
// chunk, and the splits are added in order, so results are deterministic
// run to run.  The sparse kernel splits each tile's run of listed blocks at
// the same chunk bounds (ops/gather.py split_run_starts) and folds the same
// chunks in the same order, so dense and sparse agree bit for bit on the
// same live blocks.

#include "split_sweep.cuh"

namespace {

constexpr int OUT_ROWS = 8;

// The pair weight shared by both instances: HG phase, Epanechnikov kernel
// and the clamped 1/sin(theta), for an in-range pair.
__device__ __forceinline__ float pair_weight(float g, float cos_t, float r2,
                                             float inv_w, float inv_min_sin) {
  const float rs = rsqrtf(fmaxf(add(add(1.0f, mul(g, g)), mul(mul(2.0f, g), cos_t)),
                                1e-12f));
  const float rho = mul(mul(0.07957747154594767f, sub(1.0f, mul(g, g))),
                        mul(mul(rs, rs), rs));
  const float inv_sin =
      fminf(rsqrtf(fmaxf(sub(1.0f, mul(cos_t, cos_t)), 1e-12f)), inv_min_sin);
  const float k1 = mul(mul(0.75f, sub(1.0f, r2)), inv_w);
  return mul(mul(rho, k1), inv_sin);
}

// The pair math of _pair_block_update for one (ray, beam k) pair, added to
// acc[0..2].  Operation order follows the plain version in ops/gather.py.
__device__ __forceinline__ void pair_accumulate(const Ray& r,
                                                const RayTables&,
                                                const BeamChunk& s, int k,
                                                float inv_min_sin,
                                                float acc[3]) {
  const float b0[3] = {s.b0[0][k], s.b0[1][k], s.b0[2][k]};
  const float d2[3] = {s.d2[0][k], s.d2[1][k], s.d2[2][k]};
  const float inv_w = s.inv_w[k];
  const PairGeom p = closest_points(r.a0, r.d1, r.a, r.inv_a, b0, d2, s.e[k],
                                    s.inv_e[k], inv_w);
  if (!(p.r2 < 1.0f)) return;  // outside the blur width: contributes 0
  const float w = pair_weight(r.g, cos_theta(r.dir, d2, s.ibl[k]), p.r2,
                              inv_w, inv_min_sin);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    // beam power at the closest point times camera transmittance, one exp
    const float pt = mul(s.ps[ch][k],
                         expf(add(mul(p.tc, s.lp[ch][k]), mul(p.sc, r.lt[ch]))));
    acc[ch] = add(acc[ch], mul(mul(w, pt), r.sigs[ch]));
  }
}

// The grid-medium instance (_pair_block_update, hetero branch).
__device__ __forceinline__ void pair_accumulate(const Ray& r,
                                                const RayTables& rt,
                                                const BeamChunkHet& s, int k,
                                                float inv_min_sin,
                                                float acc[3]) {
  const float b0[3] = {s.b0[0][k], s.b0[1][k], s.b0[2][k]};
  const float d2[3] = {s.d2[0][k], s.d2[1][k], s.d2[2][k]};
  const float inv_w = s.inv_w[k];
  const PairGeom p = closest_points(r.a0, r.d1, r.a, r.inv_a, b0, d2, s.e[k],
                                    s.inv_e[k], inv_w);
  if (!(p.r2 < 1.0f)) return;
  const float w = pair_weight(r.g, cos_theta(r.dir, d2, s.ibl[k]), p.r2,
                              inv_w, inv_min_sin);
  const float dp[D_COEFS] = {s.dp[0][k], s.dp[1][k], s.dp[2][k], s.dp[3][k],
                             s.dp[4][k]};
  const float dens = fmaxf(horner_dens(rt.densc, p.sc), 0.0f);
  const float Db = fmaxf(horner_D(dp, p.tc), 0.0f);
  const float Dc = fmaxf(horner_D(rt.dc, p.sc), 0.0f);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float pt =
        mul(s.ps[ch][k], het_decay(s.sigt[ch][k], Db, rt.sigtc[ch], Dc));
    acc[ch] = add(acc[ch], mul(mul(w, pt), mul(r.sigs[ch], dens)));
  }
}

// Sweep one staged chunk's 256 beams against this thread's ray; the
// chunk's partial sums are added to acc in a fixed order.
template <bool HETERO>
__device__ __forceinline__ void sweep_chunk(const ChunkT<HETERO>& s,
                                            const Ray& r, const RayTables& rt,
                                            float inv_min_sin, float acc[3]) {
  float part[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll 4
  for (int k = 0; k < C; ++k) pair_accumulate(r, rt, s, k, inv_min_sin, part);
  acc[0] = add(acc[0], part[0]);
  acc[1] = add(acc[1], part[1]);
  acc[2] = add(acc[2], part[2]);
}

// This thread's ray and, for a grid medium, its tables.
template <bool HETERO>
__device__ __forceinline__ void load_ray_all(const float* __restrict__ rays,
                                             int tile, Ray& r, RayTables& rt) {
  constexpr int nf = HETERO ? NF_HET : NF;
  const float* tile_rows = rays + static_cast<size_t>(tile) * nf * T;
  r = load_ray(tile_rows, threadIdx.x);
  if (HETERO) rt = load_ray_tables(tile_rows, threadIdx.x);
}

// Resident blocks per SM that the register budget must allow (the split
// count aims at 4 blocks per SM): 64 registers a thread for the
// homogeneous sweep, 80 with the grid tables.
template <bool HETERO>
constexpr int kFwdMinBlocks = HETERO ? 3 : 4;

// The ray-side sweep of either kernel: this block's ray against the
// positions p = walk.first(lo) ... of its walk, each a staged chunk of
// `staged` (stage_beams); the partial sums go to `partial`.
template <bool HETERO, class Walk, class ChunkOf>
__device__ __forceinline__ void ray_sweep(const float* __restrict__ rays,
                                          const float* __restrict__ staged,
                                          const float* __restrict__ scalars,
                                          const Walk& walk, int lo,
                                          ChunkOf chunk_of,
                                          float* __restrict__ partial) {
  using Stage = ChunkT<HETERO>;
  ring_init<Stage>();
  Ray r;
  RayTables rt;
  load_ray_all<HETERO>(rays, blockIdx.x, r, rt);
  const float inv_min_sin = 1.0f / scalars[2];
  const Stage* chunks = reinterpret_cast<const Stage*>(staged);
  float acc[3] = {0.0f, 0.0f, 0.0f};
  ring_walk<Stage>(
      walk.first(lo), walk.end(),
      [&](int p) { return walk.next(p); },
      [&](int p) { return chunks + chunk_of(p); },
      [&](const Stage& s, int) {
        sweep_chunk<HETERO>(s, r, rt, inv_min_sin, acc);
      });
  write_partial<3>(partial, acc);
}

// scalars: cam_radius, power_scale (folded into sigma_s), min_sin, n_valid.
// mask: (n_chunks, n_tiles), 0 = skip the block.  Grid (n_tiles, n_splits):
// block (tile, s) sweeps the live chunks of split s into partial
// (n_splits, n_tiles, 3, T).
template <bool HETERO>
__global__ void __launch_bounds__(T, kFwdMinBlocks<HETERO>)
gather_dense_kernel(const float* __restrict__ rays,
                    const float* __restrict__ staged,
                    const float* __restrict__ scalars,
                    const float* __restrict__ mask,
                    float* __restrict__ partial, int n_tiles, int n_chunks) {
  const ChunkRange cr =
      split_range(scalars[3], n_chunks, gridDim.y, blockIdx.y);
  const MaskedChunks walk{mask + blockIdx.x, n_tiles, cr.hi};
  ray_sweep<HETERO>(rays, staged, scalars, walk, cr.lo,
                    [](int j) { return j; }, partial);
}

// idx: tile-major extended block ids tile*(n_chunks+1) + chunk+1, with a seed
// entry tile*(n_chunks+1) per tile and fill entries n_tiles*(n_chunks+1)
// (ops/gather.py sparse_block_ids); run_start (n_splits+1, n_tiles):
// run_start[s][t] .. run_start[s+1][t] are the entries of tile t whose
// chunk lies in split s (ops/gather.py split_run_starts).
template <bool HETERO>
__global__ void __launch_bounds__(T, kFwdMinBlocks<HETERO>)
gather_sparse_kernel(const float* __restrict__ rays,
                     const float* __restrict__ staged,
                     const float* __restrict__ scalars,
                     const int* __restrict__ idx,
                     const int* __restrict__ run_start,
                     float* __restrict__ partial, int n_tiles, int n_chunks) {
  const int* rs = run_start + static_cast<size_t>(blockIdx.y) * n_tiles + blockIdx.x;
  const ListedChunks walk{idx, n_chunks + 1, rs[n_tiles], scalars[3]};
  ray_sweep<HETERO>(rays, staged, scalars, walk, rs[0],
                    [&](int k) { return walk.chunk(k); }, partial);
}

// stage_beams, one ray-side kernel over the (n_tiles, n_splits) grid, then
// reduce_splits into out (n_tiles, 8, T).
template <bool HETERO, class Launch>
int launch_forward(const float* beams, const float* scalars, float* staged,
                   float* partial, float* out, int n_tiles, int n_chunks,
                   int n_splits, cudaStream_t stream, Launch ray_kernel) {
  stage_beams<HETERO><<<n_chunks, C, 0, stream>>>(beams, scalars, staged);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = ray_kernel(dim3(n_tiles, n_splits),
                   ring_smem_bytes<ChunkT<HETERO>>());
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_splits<<<dim3(n_tiles, OUT_ROWS), T, 0, stream>>>(
      partial, out, n_splits, n_tiles, 3, OUT_ROWS);
  return static_cast<int>(cudaGetLastError());
}

template <bool HETERO>
int forward_dense(const float* rays, const float* beams, const float* scalars,
                  const float* mask, float* staged, float* partial, float* out,
                  int n_tiles, int n_chunks, int n_splits,
                  cudaStream_t stream) {
  return launch_forward<HETERO>(
      beams, scalars, staged, partial, out, n_tiles, n_chunks, n_splits,
      stream, [&](dim3 grid, size_t smem) {
        gather_dense_kernel<HETERO><<<grid, T, smem, stream>>>(
            rays, staged, scalars, mask, partial, n_tiles, n_chunks);
        return cudaGetLastError();
      });
}

template <bool HETERO>
int forward_sparse(const float* rays, const float* beams,
                   const float* scalars, const int* idx, const int* run_start,
                   float* staged, float* partial, float* out, int n_tiles,
                   int n_chunks, int n_splits, cudaStream_t stream) {
  return launch_forward<HETERO>(
      beams, scalars, staged, partial, out, n_tiles, n_chunks, n_splits,
      stream, [&](dim3 grid, size_t smem) {
        gather_sparse_kernel<HETERO><<<grid, T, smem, stream>>>(
            rays, staged, scalars, idx, run_start, partial, n_tiles, n_chunks);
        return cudaGetLastError();
      });
}

}  // namespace

extern "C" {

const char* bre_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// staged: (n_chunks, 16|21, C) scratch; partial: (n_splits, n_tiles, 3, T)
// scratch; out: (n_tiles, 8, T).  hetero: 0 = homogeneous layouts (NF, NB),
// 1 = grid media (NF_HET, NB_HET).
int bre_gather_forward(const float* rays, const float* beams,
                       const float* scalars, const float* mask, float* staged,
                       float* partial, float* out, int n_tiles, int n_chunks,
                       int n_splits, int hetero, cudaStream_t stream) {
  return hetero ? forward_dense<true>(rays, beams, scalars, mask, staged,
                                      partial, out, n_tiles, n_chunks,
                                      n_splits, stream)
                : forward_dense<false>(rays, beams, scalars, mask, staged,
                                       partial, out, n_tiles, n_chunks,
                                       n_splits, stream);
}

// run_start: (n_splits+1, n_tiles) int32 (ops/gather.py split_run_starts).
int bre_gather_sparse(const float* rays, const float* beams,
                      const float* scalars, const int* idx,
                      const int* run_start, float* staged, float* partial,
                      float* out, int n_tiles, int n_chunks, int n_splits,
                      int hetero, cudaStream_t stream) {
  return hetero ? forward_sparse<true>(rays, beams, scalars, idx, run_start,
                                       staged, partial, out, n_tiles, n_chunks,
                                       n_splits, stream)
                : forward_sparse<false>(rays, beams, scalars, idx, run_start,
                                        staged, partial, out, n_tiles,
                                        n_chunks, n_splits, stream);
}

}  // extern "C"
