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
// rsqrt and three exp on the SFU.  The design answers that:
//   - one block of 256 threads per ray tile, one ray per thread, the ray's
//     fields (and log(tr), |d1|^2, 1/|d1|^2) in registers for the whole sweep;
//   - each live chunk is staged once in shared memory (16 KB; 24 KB with the
//     grid tables) together with its per-beam derived terms (pair_math.cuh
//     BeamChunk, BeamChunkHet), so the per-beam divides, rsqrt and logs are
//     paid once per chunk, not once per pair; a grid-medium ray thread
//     keeps its 14 table coefficients in registers beside the ray;
//   - pairs outside the blur radius (most of them) branch past the phase,
//     kernel and exp work;
//   - FP32 on the CUDA cores, no tensor cores: TF32/bf16 rounding biased the
//     segment geometry on the TPU (pallas_gather.py:154-159).  Every product
//     and sum of the pair math is rounded on its own (pair_math.cuh), in the
//     plain version's order; this costs instruction count (no fused
//     multiply-adds) and buys agreement with the plain version to float ulps.
//     Compiled without fast-math, so exp, log and division are the accurate
//     ones.
// Each output element is written by exactly one thread, chunks are walked in
// ascending order with one partial sum per chunk, so results are
// deterministic run to run and the dense and sparse kernels agree bit for bit
// on the same live blocks.

#include "pair_math.cuh"

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

// Stage one chunk and sweep its 256 beams against this thread's ray; the
// chunk's partial sums are added to acc in a fixed order.
template <bool HETERO>
__device__ void sweep_chunk(const float* __restrict__ chunk,
                            ChunkT<HETERO>& s, const Ray& r,
                            const RayTables& rt, float cam_radius,
                            float inv_min_sin, float acc[3]) {
  const int lane = threadIdx.x;
  stage_chunk(chunk, s, lane, cam_radius);
  __syncthreads();
  float part[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll 4
  for (int k = 0; k < C; ++k) pair_accumulate(r, rt, s, k, inv_min_sin, part);
  acc[0] = add(acc[0], part[0]);
  acc[1] = add(acc[1], part[1]);
  acc[2] = add(acc[2], part[2]);
  __syncthreads();  // the next chunk overwrites s
}

__device__ void write_tile(float* __restrict__ out, int tile,
                           const float acc[3]) {
  float* o = out + static_cast<size_t>(tile) * OUT_ROWS * T + threadIdx.x;
#pragma unroll
  for (int row = 0; row < 3; ++row) o[row * T] = acc[row];
#pragma unroll
  for (int row = 3; row < OUT_ROWS; ++row) o[row * T] = 0.0f;
}

// This thread's ray and, for a grid medium, its tables.
template <bool HETERO>
__device__ void load_ray_all(const float* __restrict__ rays, int tile, Ray& r,
                             RayTables& rt) {
  constexpr int nf = HETERO ? NF_HET : NF;
  const float* tile_rows = rays + static_cast<size_t>(tile) * nf * T;
  r = load_ray(tile_rows, threadIdx.x);
  if (HETERO) rt = load_ray_tables(tile_rows, threadIdx.x);
}

// scalars: cam_radius, power_scale (folded into sigma_s), min_sin, n_valid.
// mask: (n_chunks, n_tiles), 0 = skip the block.
template <bool HETERO>
__global__ void __launch_bounds__(T)
gather_dense_kernel(const float* __restrict__ rays,
                    const float* __restrict__ beams,
                    const float* __restrict__ scalars,
                    const float* __restrict__ mask, float* __restrict__ out,
                    int n_tiles, int n_chunks) {
  constexpr int nb = HETERO ? NB_HET : NB;
  __shared__ ChunkT<HETERO> s;
  const int tile = blockIdx.x;
  Ray r;
  RayTables rt;
  load_ray_all<HETERO>(rays, tile, r, rt);
  const float cam_radius = scalars[0];
  const float inv_min_sin = 1.0f / scalars[2];
  const float n_valid = scalars[3];
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int j = 0; j < n_chunks; ++j) {
    // beams are validity-compacted: every chunk past n_valid is dead
    if (!(static_cast<float>(j * C) < n_valid)) break;
    if (!(__ldg(mask + static_cast<size_t>(j) * n_tiles + tile) > 0.0f)) continue;
    sweep_chunk<HETERO>(beams + static_cast<size_t>(j) * nb * C, s, r, rt,
                        cam_radius, inv_min_sin, acc);
  }
  write_tile(out, tile, acc);
}

// idx: tile-major extended block ids tile*(n_chunks+1) + chunk+1, with a seed
// entry tile*(n_chunks+1) per tile and fill entries n_tiles*(n_chunks+1)
// (ops/gather.py sparse_block_ids); tile_start[t]..tile_start[t+1] is tile
// t's run of idx.
template <bool HETERO>
__global__ void __launch_bounds__(T)
gather_sparse_kernel(const float* __restrict__ rays,
                     const float* __restrict__ beams,
                     const float* __restrict__ scalars,
                     const int* __restrict__ idx,
                     const int* __restrict__ tile_start,
                     float* __restrict__ out, int n_tiles, int n_chunks) {
  constexpr int nb = HETERO ? NB_HET : NB;
  __shared__ ChunkT<HETERO> s;
  const int tile = blockIdx.x;
  Ray r;
  RayTables rt;
  load_ray_all<HETERO>(rays, tile, r, rt);
  const float cam_radius = scalars[0];
  const float inv_min_sin = 1.0f / scalars[2];
  const float n_valid = scalars[3];
  const int n1 = n_chunks + 1;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  const int k1 = tile_start[tile + 1];
  for (int k = tile_start[tile]; k < k1; ++k) {
    const int sub = __ldg(idx + k) % n1;  // 0 = seed entry
    if (sub == 0 || !(static_cast<float>((sub - 1) * C) < n_valid)) continue;
    sweep_chunk<HETERO>(beams + static_cast<size_t>(sub - 1) * nb * C, s, r,
                        rt, cam_radius, inv_min_sin, acc);
  }
  write_tile(out, tile, acc);
}

}  // namespace

extern "C" {

const char* bre_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// hetero: 0 = homogeneous layouts (NF, NB), 1 = grid media (NF_HET, NB_HET)
int bre_gather_forward(const float* rays, const float* beams,
                       const float* scalars, const float* mask, float* out,
                       int n_tiles, int n_chunks, int hetero,
                       cudaStream_t stream) {
  if (hetero)
    gather_dense_kernel<true><<<n_tiles, T, 0, stream>>>(
        rays, beams, scalars, mask, out, n_tiles, n_chunks);
  else
    gather_dense_kernel<false><<<n_tiles, T, 0, stream>>>(
        rays, beams, scalars, mask, out, n_tiles, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

int bre_gather_sparse(const float* rays, const float* beams,
                      const float* scalars, const int* idx,
                      const int* tile_start, float* out, int n_tiles,
                      int n_chunks, int hetero, cudaStream_t stream) {
  if (hetero)
    gather_sparse_kernel<true><<<n_tiles, T, 0, stream>>>(
        rays, beams, scalars, idx, tile_start, out, n_tiles, n_chunks);
  else
    gather_sparse_kernel<false><<<n_tiles, T, 0, stream>>>(
        rays, beams, scalars, idx, tile_start, out, n_tiles, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
