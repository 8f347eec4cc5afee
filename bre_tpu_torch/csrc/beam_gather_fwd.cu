// Beam radiance estimate gather, forward — hand-written CUDA for Hopper
// (sm_90a), built at first use by bre_tpu_torch/ops/cuda_build.py and bound
// through ctypes by bre_tpu_torch/ops/gather.py.
//
// Replaces the two Pallas TPU forward kernels of bre_tpu/ops/pallas_gather.py:
//   - pallas_gather_forward (:245, body _gather_kernel :105) — the dense
//     (beam chunk x ray tile) grid with the chunk x tile block mask;
//   - pallas_gather_sparse (:425, body _sparse_kernel :383) — the same pair
//     math over a tile-major compacted list of live (tile, chunk) blocks;
// both built on the shared pair math _pair_block_update (:134).
//
// What it computes: for every camera segment (ray) of a 256-ray tile and every
// photon beam of the live 256-beam chunks, the normalized 1D-1D beam radiance
// estimate: Ericson closest points, r^2 against the blur width, the
// Epanechnikov weight, the HG phase, a clamped 1/sin(theta), and one exp per
// channel for beam power times camera transmittance.  Output (n_tiles, 8, T),
// RGB in rows 0-2, rows 3-7 zero.
//
// What bounds it on an H100: arithmetic, not bytes.  A live block is 65,536
// pairs read from 256 x (18 + 16) floats; each pair costs ~50 FP32
// instructions (an IEEE divide among them) and, inside the blur radius, two
// rsqrt and three exp on the SFU.  The design answers that:
//   - one block of 256 threads per ray tile, one ray per thread, the ray's
//     fields (and log(tr), |d1|^2, 1/|d1|^2) in registers for the whole sweep;
//   - each live chunk is staged once in shared memory (16 KB) together with
//     its per-beam derived terms (d2, |d2|^2, 1/|d2|^2, 1/width, 1/|d2|, the
//     safe start power and log(pe/ps) per channel), so the per-beam divides,
//     rsqrt and logs are paid once per chunk, not once per pair; every thread
//     then reads the same beam at once (a shared-memory broadcast);
//   - pairs outside the blur radius (most of them) branch past the phase,
//     kernel and exp work;
//   - FP32 on the CUDA cores, no tensor cores: TF32/bf16 rounding biased the
//     segment geometry on the TPU (pallas_gather.py:154-159).  Every product
//     and sum of the pair math is rounded on its own (__fmul_rn/__fadd_rn,
//     never contracted to FMA), in the plain version's order, because the
//     closest-point solve is ill-conditioned for near-parallel pairs; this
//     costs instruction count (no fused multiply-adds) and buys agreement
//     with the plain version to float ulps.  Compiled without fast-math, so
//     exp, log and division are the accurate ones.
// Each output element is written by exactly one thread, chunks are walked in
// ascending order with one partial sum per chunk, so results are
// deterministic run to run and the dense and sparse kernels agree bit for bit
// on the same live blocks.

#include <cuda_runtime.h>

namespace {

constexpr int T = 256;   // rays per tile == threads per block
constexpr int C = 256;   // beams per chunk
constexpr int NF = 18;   // packed ray rows (ops/gather.py RF_*)
constexpr int NB = 16;   // packed beam fields (ops/gather.py BF_*)
constexpr int OUT_ROWS = 8;

constexpr int RF_A0 = 0, RF_A1 = 3, RF_DIR = 6, RF_TR = 10, RF_SIGS = 13,
              RF_G = 16;
constexpr int BF_B0 = 0, BF_B1 = 3, BF_PS = 6, BF_PE = 9, BF_RAD = 12;

struct Ray {
  float a0[3], d1[3], dir[3], lt[3], sigs[3];
  float a, inv_a, g;
};

// One staged beam chunk with its per-beam derived terms, field-major.
struct BeamChunk {
  float b0[3][C];
  float d2[3][C];
  float e[C];
  float inv_e[C];
  float inv_w[C];
  float ibl[C];     // 1/|d2|
  float ps[3][C];   // start power, 0 where the power is dead (ps <= 1e-20)
  float lp[3][C];   // log(pe/ps) with the reference's where-isolation
};

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// Explicitly rounded products and sums: never contracted into an FMA.  The
// closest-point solve cancels catastrophically for near-parallel pairs
// (a*e - b*b), so one extra rounding step there moves s and t far; rounding
// every step as the plain version does keeps the kernel within float ulps of
// it on every pair instead of within the problem's conditioning.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dot3(float x0, float x1, float x2, float y0,
                                      float y1, float y2) {
  return add(add(mul(x0, y0), mul(x1, y1)), mul(x2, y2));
}

__device__ Ray load_ray(const float* __restrict__ tile_rows, int lane) {
  Ray r;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r.a0[c] = tile_rows[(RF_A0 + c) * T + lane];
    r.d1[c] = sub(tile_rows[(RF_A1 + c) * T + lane], r.a0[c]);
    r.dir[c] = tile_rows[(RF_DIR + c) * T + lane];
    r.lt[c] = logf(fmaxf(tile_rows[(RF_TR + c) * T + lane], 1e-30f));
    r.sigs[c] = tile_rows[(RF_SIGS + c) * T + lane];
  }
  r.g = tile_rows[RF_G * T + lane];
  r.a = dot3(r.d1[0], r.d1[1], r.d1[2], r.d1[0], r.d1[1], r.d1[2]);
  r.inv_a = r.a > 1e-12f ? 1.0f / r.a : 0.0f;
  return r;
}

// Thread `lane` stages beam `lane` of one chunk (coalesced field rows).
__device__ void stage_chunk(const float* __restrict__ chunk, BeamChunk& s,
                            int lane, float cam_radius) {
  float d2[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float b0 = chunk[(BF_B0 + c) * C + lane];
    d2[c] = sub(chunk[(BF_B1 + c) * C + lane], b0);
    s.b0[c][lane] = b0;
    s.d2[c][lane] = d2[c];
  }
  const float e = dot3(d2[0], d2[1], d2[2], d2[0], d2[1], d2[2]);
  s.e[lane] = e;
  s.inv_e[lane] = e > 1e-12f ? 1.0f / e : 0.0f;
  s.inv_w[lane] = 1.0f / fmaxf(add(cam_radius, chunk[BF_RAD * C + lane]), 1e-30f);
  s.ibl[lane] = rsqrtf(fmaxf(e, 1e-30f));
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    // _log_decay (pallas_gather.py:94-102): real branches, so no inf or NaN
    // is ever formed for dead powers
    const float ps = chunk[(BF_PS + c) * C + lane];
    const float pe = chunk[(BF_PE + c) * C + lane];
    if (ps > 1e-20f) {
      s.ps[c][lane] = ps;
      s.lp[c][lane] = logf(fmaxf(pe, mul(1e-12f, ps)) / ps);
    } else {
      s.ps[c][lane] = 0.0f;
      s.lp[c][lane] = 0.0f;
    }
  }
}

// The pair math of _pair_block_update for one (ray, beam k) pair, added to
// acc[0..2].  Operation order follows the plain version in ops/gather.py.
__device__ __forceinline__ void pair_accumulate(const Ray& r,
                                                const BeamChunk& s, int k,
                                                float inv_min_sin,
                                                float acc[3]) {
  const float b0x = s.b0[0][k], b0y = s.b0[1][k], b0z = s.b0[2][k];
  const float d2x = s.d2[0][k], d2y = s.d2[1][k], d2z = s.d2[2][k];
  const float e = s.e[k];
  // Ericson 5.1.9 segment-segment closest points
  const float rr0 = sub(r.a0[0], b0x), rr1 = sub(r.a0[1], b0y),
              rr2 = sub(r.a0[2], b0z);
  const float b = dot3(r.d1[0], r.d1[1], r.d1[2], d2x, d2y, d2z);
  const float c_ = dot3(r.d1[0], r.d1[1], r.d1[2], rr0, rr1, rr2);
  const float f = dot3(d2x, d2y, d2z, rr0, rr1, rr2);
  const float denom = sub(mul(r.a, e), mul(b, b));
  float sc = denom > 1e-12f ? sub(mul(b, f), mul(c_, e)) / denom : 0.0f;
  sc = clip01(sc);
  const float t = mul(add(mul(b, sc), f), s.inv_e[k]);
  const float tc = clip01(t);
  if (t != tc && r.a > 1e-12f) sc = clip01(mul(sub(mul(tc, b), c_), r.inv_a));
  const float dx = sub(add(r.a0[0], mul(r.d1[0], sc)), add(b0x, mul(d2x, tc)));
  const float dy = sub(add(r.a0[1], mul(r.d1[1], sc)), add(b0y, mul(d2y, tc)));
  const float dz = sub(add(r.a0[2], mul(r.d1[2], sc)), add(b0z, mul(d2z, tc)));
  const float inv_w = s.inv_w[k];
  const float r2 = mul(dot3(dx, dy, dz, dx, dy, dz), mul(inv_w, inv_w));
  if (!(r2 < 1.0f)) return;  // outside the blur width: contributes 0
  const float ibl = s.ibl[k];
  const float cos_t = dot3(r.dir[0], r.dir[1], r.dir[2], mul(d2x, ibl),
                           mul(d2y, ibl), mul(d2z, ibl));
  const float g = r.g;
  const float rs = rsqrtf(fmaxf(add(add(1.0f, mul(g, g)), mul(mul(2.0f, g), cos_t)),
                                1e-12f));
  const float rho = mul(mul(0.07957747154594767f, sub(1.0f, mul(g, g))),
                        mul(mul(rs, rs), rs));
  const float inv_sin =
      fminf(rsqrtf(fmaxf(sub(1.0f, mul(cos_t, cos_t)), 1e-12f)), inv_min_sin);
  const float k1 = mul(mul(0.75f, sub(1.0f, r2)), inv_w);
  const float w = mul(mul(rho, k1), inv_sin);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    // beam power at the closest point times camera transmittance, one exp
    const float pt =
        mul(s.ps[ch][k], expf(add(mul(tc, s.lp[ch][k]), mul(sc, r.lt[ch]))));
    acc[ch] = add(acc[ch], mul(mul(w, pt), r.sigs[ch]));
  }
}

// Stage one chunk and sweep its 256 beams against this thread's ray; the
// chunk's partial sums are added to acc in a fixed order.
__device__ void sweep_chunk(const float* __restrict__ chunk, BeamChunk& s,
                            const Ray& r, float cam_radius, float inv_min_sin,
                            float acc[3]) {
  const int lane = threadIdx.x;
  stage_chunk(chunk, s, lane, cam_radius);
  __syncthreads();
  float part[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll 4
  for (int k = 0; k < C; ++k) pair_accumulate(r, s, k, inv_min_sin, part);
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

// scalars: cam_radius, power_scale (folded into sigma_s), min_sin, n_valid.
// mask: (n_chunks, n_tiles), 0 = skip the block.
__global__ void __launch_bounds__(T)
gather_dense_kernel(const float* __restrict__ rays,
                    const float* __restrict__ beams,
                    const float* __restrict__ scalars,
                    const float* __restrict__ mask, float* __restrict__ out,
                    int n_tiles, int n_chunks) {
  __shared__ BeamChunk s;
  const int tile = blockIdx.x;
  const Ray r = load_ray(rays + static_cast<size_t>(tile) * NF * T, threadIdx.x);
  const float cam_radius = scalars[0];
  const float inv_min_sin = 1.0f / scalars[2];
  const float n_valid = scalars[3];
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int j = 0; j < n_chunks; ++j) {
    // beams are validity-compacted: every chunk past n_valid is dead
    if (!(static_cast<float>(j * C) < n_valid)) break;
    if (!(__ldg(mask + static_cast<size_t>(j) * n_tiles + tile) > 0.0f)) continue;
    sweep_chunk(beams + static_cast<size_t>(j) * NB * C, s, r, cam_radius,
                inv_min_sin, acc);
  }
  write_tile(out, tile, acc);
}

// idx: tile-major extended block ids tile*(n_chunks+1) + chunk+1, with a seed
// entry tile*(n_chunks+1) per tile and fill entries n_tiles*(n_chunks+1)
// (ops/gather.py sparse_block_ids); tile_start[t]..tile_start[t+1] is tile
// t's run of idx.
__global__ void __launch_bounds__(T)
gather_sparse_kernel(const float* __restrict__ rays,
                     const float* __restrict__ beams,
                     const float* __restrict__ scalars,
                     const int* __restrict__ idx,
                     const int* __restrict__ tile_start,
                     float* __restrict__ out, int n_tiles, int n_chunks) {
  __shared__ BeamChunk s;
  const int tile = blockIdx.x;
  const Ray r = load_ray(rays + static_cast<size_t>(tile) * NF * T, threadIdx.x);
  const float cam_radius = scalars[0];
  const float inv_min_sin = 1.0f / scalars[2];
  const float n_valid = scalars[3];
  const int n1 = n_chunks + 1;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  const int k1 = tile_start[tile + 1];
  for (int k = tile_start[tile]; k < k1; ++k) {
    const int sub = __ldg(idx + k) % n1;  // 0 = seed entry
    if (sub == 0 || !(static_cast<float>((sub - 1) * C) < n_valid)) continue;
    sweep_chunk(beams + static_cast<size_t>(sub - 1) * NB * C, s, r,
                cam_radius, inv_min_sin, acc);
  }
  write_tile(out, tile, acc);
}

}  // namespace

extern "C" {

const char* bre_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int bre_gather_forward(const float* rays, const float* beams,
                       const float* scalars, const float* mask, float* out,
                       int n_tiles, int n_chunks, cudaStream_t stream) {
  gather_dense_kernel<<<n_tiles, T, 0, stream>>>(rays, beams, scalars, mask,
                                                 out, n_tiles, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

int bre_gather_sparse(const float* rays, const float* beams,
                      const float* scalars, const int* idx,
                      const int* tile_start, float* out, int n_tiles,
                      int n_chunks, cudaStream_t stream) {
  gather_sparse_kernel<<<n_tiles, T, 0, stream>>>(
      rays, beams, scalars, idx, tile_start, out, n_tiles, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
