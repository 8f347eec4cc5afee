// Beam radiance estimate gather, backward — hand-written CUDA for Hopper
// (sm_90a), built at first use by bre_tpu_torch/ops/cuda_build.py and bound
// through ctypes by bre_tpu_torch/ops/gather_bwd.py.
//
// Replaces the two Pallas TPU backward kernels of
// bre_tpu/ops/pallas_gather_bwd.py (homogeneous layouts):
//   - pallas_gather_backward_fused (:373, body _bwd_fused_body :182 over
//     _pair_quantities :73) — one sweep over the dense (chunk x tile) grid
//     with the block mask: bre_gather_backward launches bwd_rays_dense and
//     bwd_beams_dense;
//   - pallas_gather_backward_sparse (:607, bodies _ray_rows_update :470 and
//     _beam_cols_update :510) — the same cotangents over the compacted live
//     blocks, tile-major for d_rays and chunk-major for d_beams:
//     bre_gather_backward_sparse launches bwd_rays_sparse and
//     bwd_beams_sparse.
//
// What it computes: with the geometry held fixed (grad_geometry=False), the
// analytic cotangents of the forward's per-ray sums, given the output
// cotangent ct: per ray d tr, d sigma_s and (want_extras) d g, d cam_radius,
// summed over beams; per beam d ps, d pe and (want_extras) d radius, summed
// over rays.  Gates as the reference: dead start powers, the pe floor
// (pe_live), the tr floor (trf_live); every sum over a block is taken before
// its division by ps_s, pe_s or tr.
//
// What bounds it on an H100: arithmetic, as in the forward.  Each live pair
// recomputes the forward geometry (~40 FP32 operations) and, inside the blur
// radius, the phase, kernel and power terms with their derivatives (two
// rsqrt, three exp).  The TPU kernel's design does not carry over: it sums
// d_beams[chunk] across a grid loop that runs in order and keeps all of
// d_rays resident in VMEM; blocks on the card run in parallel in no order,
// and per-block partials of d_beams at config-2 size would take ~50 GB.  So
// the design is two sweeps, each output element with exactly one writer:
//   - d_rays: one 256-thread block per ray tile, one ray per thread in
//     registers, walking its live chunks in ascending order, each chunk
//     staged in shared memory with its per-beam terms (as the forward);
//   - d_beams: one 256-thread block per beam chunk, one beam per thread in
//     registers, walking its live ray tiles in ascending order, each tile
//     staged in shared memory (18 KB) with its per-ray terms and ct*sigma_s;
//     chunks past n_valid write zeros and exit.
// The pair work is paid twice (once per sweep): the price of deterministic
// sums without atomics.  Dense and sparse kernels visit the same blocks in
// the same order, so they agree bit for bit.  Small sweeps (64 ray tiles at
// config 2's R/4 budget) leave SMs idle in the d_rays sweep; splitting a
// tile's chunk range across blocks is later work.

#include "pair_math.cuh"

namespace {

constexpr int DR_TR = 0, DR_SIGS = 3, DR_G = 6, DR_CAMR = 7, NDR = 8;
constexpr int NBC = 7;  // per-beam cotangents: d ps (3), d pe (3), d radius
constexpr float kInv4Pi = 0.07957747154594767f;

// The per-ray terms of the backward besides the Ray: ct, ct * sigma_s and
// the transmittance floor (trf, trf_live).
struct RayCt {
  float ct[3], coef[3], trf[3], trf_live[3];
};

__device__ RayCt load_ray_ct(const float* __restrict__ tile_rows,
                             const float* __restrict__ ct_rows, int lane) {
  RayCt rc;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float tr = tile_rows[(RF_TR + c) * T + lane];
    rc.ct[c] = ct_rows[c * T + lane];
    rc.coef[c] = mul(rc.ct[c], tile_rows[(RF_SIGS + c) * T + lane]);
    rc.trf[c] = fmaxf(tr, 1e-30f);
    rc.trf_live[c] = tr > 1e-30f ? 1.0f : 0.0f;
  }
  return rc;
}

// The weights of one in-range pair (_pair_quantities,
// pallas_gather_bwd.py:115-149, with base = 1/sin(theta)): w0 = base rho k1
// and, with the extras, wrad = base rho dk1/dwidth and wg = base k1 drho/dg.
struct PairWeights {
  float w0, wrad, wg;
};

template <bool EXTRAS>
__device__ __forceinline__ PairWeights pair_weights(float cos_t, float g,
                                                    float r2, float inv_w,
                                                    float inv_min_sin) {
  const float g2 = mul(g, g);
  const float rs = rsqrtf(fmaxf(add(add(1.0f, g2), mul(mul(2.0f, g), cos_t)),
                                1e-12f));
  const float rs3 = mul(mul(rs, rs), rs);
  const float rho = mul(mul(kInv4Pi, sub(1.0f, g2)), rs3);
  const float base =
      fminf(rsqrtf(fmaxf(sub(1.0f, mul(cos_t, cos_t)), 1e-12f)), inv_min_sin);
  const float k1 = mul(mul(0.75f, sub(1.0f, r2)), inv_w);
  PairWeights w{mul(mul(base, rho), k1), 0.0f, 0.0f};
  if (EXTRAS) {
    const float drho_dg = mul(
        kInv4Pi,
        add(mul(mul(-2.0f, g), rs3),
            mul(mul(mul(sub(1.0f, g2), -1.5f), mul(mul(rs3, rs), rs)),
                add(mul(2.0f, g), mul(2.0f, cos_t)))));
    const float dk1_dw =
        mul(mul(0.75f, mul(inv_w, inv_w)), sub(mul(3.0f, r2), 1.0f));
    w.wrad = mul(mul(base, rho), dk1_dw);
    w.wg = mul(mul(base, k1), drho_dg);
  }
  return w;
}

// ---- sweep 1: d_rays, one thread per ray --------------------------------

// Stage one chunk and sweep its beams against this thread's ray; the
// chunk's sums over beams are turned into cotangents and added to acc.
template <bool EXTRAS>
__device__ void rays_sweep_chunk(const float* __restrict__ chunk,
                                 BeamChunk& s, const Ray& r, const RayCt& rc,
                                 float cam_radius, float inv_min_sin,
                                 float acc[NDR]) {
  stage_chunk(chunk, s, threadIdx.x, cam_radius);
  __syncthreads();
  float sum_a[3] = {0.0f, 0.0f, 0.0f}, sum_af[3] = {0.0f, 0.0f, 0.0f};
  float sum_g = 0.0f, sum_camr = 0.0f;
#pragma unroll 2
  for (int k = 0; k < C; ++k) {
    const float b0[3] = {s.b0[0][k], s.b0[1][k], s.b0[2][k]};
    const float d2[3] = {s.d2[0][k], s.d2[1][k], s.d2[2][k]};
    const float inv_w = s.inv_w[k];
    const PairGeom p = closest_points(r.a0, r.d1, r.a, r.inv_a, b0, d2,
                                      s.e[k], s.inv_e[k], inv_w);
    if (!(p.r2 < 1.0f)) continue;  // outside the blur width: no cotangent
    const PairWeights w = pair_weights<EXTRAS>(
        cos_theta(r.dir, d2, s.ibl[k]), r.g, p.r2, inv_w, inv_min_sin);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float pt = mul(
          s.ps[ch][k], expf(add(mul(p.tc, s.lp[ch][k]), mul(p.sc, r.lt[ch]))));
      const float A = mul(w.w0, pt);
      sum_a[ch] = add(sum_a[ch], A);
      sum_af[ch] = add(sum_af[ch], mul(A, p.sc));
      if (EXTRAS) {
        sum_g = add(sum_g, mul(mul(rc.coef[ch], w.wg), pt));
        sum_camr = add(sum_camr, mul(mul(rc.coef[ch], w.wrad), pt));
      }
    }
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    acc[DR_SIGS + ch] = add(acc[DR_SIGS + ch], mul(rc.ct[ch], sum_a[ch]));
    acc[DR_TR + ch] = add(
        acc[DR_TR + ch],
        mul(mul(rc.coef[ch], sum_af[ch]) / rc.trf[ch], rc.trf_live[ch]));
  }
  acc[DR_G] = add(acc[DR_G], sum_g);
  acc[DR_CAMR] = add(acc[DR_CAMR], sum_camr);
  __syncthreads();  // the next chunk overwrites s
}

__device__ void write_rays(float* __restrict__ d_rays, int tile,
                           const float acc[NDR]) {
  float* o = d_rays + static_cast<size_t>(tile) * NDR * T + threadIdx.x;
#pragma unroll
  for (int row = 0; row < NDR; ++row) o[row * T] = acc[row];
}

// scalars: cam_radius, power_scale (folded into sigma_s), min_sin, n_valid.
// mask: (n_chunks, n_tiles), 0 = skip the block.  ct: (n_tiles, 8, T).
template <bool EXTRAS>
__global__ void __launch_bounds__(T)
bwd_rays_dense(const float* __restrict__ rays, const float* __restrict__ beams,
               const float* __restrict__ scalars,
               const float* __restrict__ mask, const float* __restrict__ ct,
               float* __restrict__ d_rays, int n_tiles, int n_chunks) {
  __shared__ BeamChunk s;
  const int tile = blockIdx.x;
  const float* tile_rows = rays + static_cast<size_t>(tile) * NF * T;
  const Ray r = load_ray(tile_rows, threadIdx.x);
  const RayCt rc = load_ray_ct(
      tile_rows, ct + static_cast<size_t>(tile) * NDR * T, threadIdx.x);
  const float cam_radius = scalars[0];
  const float inv_min_sin = 1.0f / scalars[2];
  const float n_valid = scalars[3];
  float acc[NDR] = {};
  for (int j = 0; j < n_chunks; ++j) {
    // beams are validity-compacted: every chunk past n_valid is dead
    if (!(static_cast<float>(j * C) < n_valid)) break;
    if (!(__ldg(mask + static_cast<size_t>(j) * n_tiles + tile) > 0.0f)) continue;
    rays_sweep_chunk<EXTRAS>(beams + static_cast<size_t>(j) * NB * C, s, r,
                             rc, cam_radius, inv_min_sin, acc);
  }
  write_rays(d_rays, tile, acc);
}

// idx: tile-major ids of ops/gather.py sparse_block_ids; tile_start[t] ..
// tile_start[t+1] is tile t's run.
template <bool EXTRAS>
__global__ void __launch_bounds__(T)
bwd_rays_sparse(const float* __restrict__ rays, const float* __restrict__ beams,
                const float* __restrict__ scalars, const int* __restrict__ idx,
                const int* __restrict__ tile_start,
                const float* __restrict__ ct, float* __restrict__ d_rays,
                int n_chunks) {
  __shared__ BeamChunk s;
  const int tile = blockIdx.x;
  const float* tile_rows = rays + static_cast<size_t>(tile) * NF * T;
  const Ray r = load_ray(tile_rows, threadIdx.x);
  const RayCt rc = load_ray_ct(
      tile_rows, ct + static_cast<size_t>(tile) * NDR * T, threadIdx.x);
  const float cam_radius = scalars[0];
  const float inv_min_sin = 1.0f / scalars[2];
  const float n_valid = scalars[3];
  const int n1 = n_chunks + 1;
  float acc[NDR] = {};
  const int k1 = tile_start[tile + 1];
  for (int k = tile_start[tile]; k < k1; ++k) {
    const int sub = __ldg(idx + k) % n1;  // 0 = seed entry
    if (sub == 0 || !(static_cast<float>((sub - 1) * C) < n_valid)) continue;
    rays_sweep_chunk<EXTRAS>(beams + static_cast<size_t>(sub - 1) * NB * C, s,
                             r, rc, cam_radius, inv_min_sin, acc);
  }
  write_rays(d_rays, tile, acc);
}

// ---- sweep 2: d_beams, one thread per beam -------------------------------

// One staged ray tile with its per-ray terms, field-major.
struct RayTile {
  float a0[3][T];
  float d1[3][T];
  float dir[3][T];
  float lt[3][T];
  float coef[3][T];  // ct * sigma_s
  float a[T];
  float inv_a[T];
  float g[T];
};

// Stage one ray tile and sweep its rays against this thread's beam; the
// tile's sums over rays are turned into cotangents and added to acc
// (d ps 0..2, d pe 3..5, d radius 6).
template <bool EXTRAS>
__device__ void beams_sweep_tile(const float* __restrict__ tile_rows,
                                 const float* __restrict__ ct_rows,
                                 RayTile& s, const Beam& bm,
                                 float inv_min_sin, float acc[NBC]) {
  const int lane = threadIdx.x;
  const Ray r = load_ray(tile_rows, lane);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.a0[c][lane] = r.a0[c];
    s.d1[c][lane] = r.d1[c];
    s.dir[c][lane] = r.dir[c];
    s.lt[c][lane] = r.lt[c];
    s.coef[c][lane] = mul(ct_rows[c * T + lane], r.sigs[c]);
  }
  s.a[lane] = r.a;
  s.inv_a[lane] = r.inv_a;
  s.g[lane] = r.g;
  __syncthreads();
  float sum_ps[3] = {0.0f, 0.0f, 0.0f}, sum_pe[3] = {0.0f, 0.0f, 0.0f};
  float sum_rad = 0.0f;
#pragma unroll 2
  for (int i = 0; i < T; ++i) {
    const float a0[3] = {s.a0[0][i], s.a0[1][i], s.a0[2][i]};
    const float d1[3] = {s.d1[0][i], s.d1[1][i], s.d1[2][i]};
    const PairGeom p = closest_points(a0, d1, s.a[i], s.inv_a[i], bm.b0,
                                      bm.d2, bm.e, bm.inv_e, bm.inv_w);
    if (!(p.r2 < 1.0f)) continue;
    const float dir[3] = {s.dir[0][i], s.dir[1][i], s.dir[2][i]};
    const PairWeights w = pair_weights<EXTRAS>(
        cos_theta(dir, bm.d2, bm.ibl), s.g[i], p.r2, bm.inv_w, inv_min_sin);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float pt = mul(
          bm.ps[ch], expf(add(mul(p.tc, bm.lp[ch]), mul(p.sc, s.lt[ch][i]))));
      const float coef = s.coef[ch][i];
      const float cA = mul(coef, mul(w.w0, pt));
      sum_ps[ch] = add(sum_ps[ch], mul(cA, sub(1.0f, p.tc)));
      sum_pe[ch] = add(sum_pe[ch], mul(cA, p.tc));
      if (EXTRAS) sum_rad = add(sum_rad, mul(mul(coef, w.wrad), pt));
    }
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    acc[ch] = add(acc[ch], sum_ps[ch] / bm.ps_s[ch]);
    acc[3 + ch] = add(acc[3 + ch], mul(sum_pe[ch], bm.pe_live[ch]) / bm.pe_s[ch]);
  }
  acc[6] = add(acc[6], sum_rad);
  __syncthreads();  // the next tile overwrites s
}

// d_beams rows: zeros for the geometry and padding fields, d ps at BF_PS,
// d pe at BF_PE, d radius at BF_RAD.
__device__ void write_beams(float* __restrict__ d_beams, int chunk,
                            const float acc[NBC]) {
  float* o = d_beams + static_cast<size_t>(chunk) * NB * C + threadIdx.x;
#pragma unroll
  for (int row = 0; row < NB; ++row) {
    const int k = row - BF_PS;
    o[row * C] = (k >= 0 && k < NBC) ? acc[k] : 0.0f;
  }
}

template <bool EXTRAS>
__global__ void __launch_bounds__(T)
bwd_beams_dense(const float* __restrict__ rays, const float* __restrict__ beams,
                const float* __restrict__ scalars,
                const float* __restrict__ mask, const float* __restrict__ ct,
                float* __restrict__ d_beams, int n_tiles) {
  __shared__ RayTile s;
  const int chunk = blockIdx.x;
  float acc[NBC] = {};
  // chunks past n_valid hold no live beam: zeros, and the block exits
  if (static_cast<float>(chunk * C) < scalars[3]) {
    const Beam bm = load_beam(beams + static_cast<size_t>(chunk) * NB * C,
                              threadIdx.x, scalars[0]);
    const float inv_min_sin = 1.0f / scalars[2];
    const float* mrow = mask + static_cast<size_t>(chunk) * n_tiles;
    for (int i = 0; i < n_tiles; ++i) {
      if (!(__ldg(mrow + i) > 0.0f)) continue;
      beams_sweep_tile<EXTRAS>(rays + static_cast<size_t>(i) * NF * T,
                               ct + static_cast<size_t>(i) * NDR * T, s, bm,
                               inv_min_sin, acc);
    }
  }
  write_beams(d_beams, chunk, acc);
}

// idx: chunk-major ids of ops/gather_bwd.py sparse_block_ids_chunk_major;
// chunk_start[j] .. chunk_start[j+1] is chunk j's run.
template <bool EXTRAS>
__global__ void __launch_bounds__(T)
bwd_beams_sparse(const float* __restrict__ rays,
                 const float* __restrict__ beams,
                 const float* __restrict__ scalars,
                 const int* __restrict__ idx,
                 const int* __restrict__ chunk_start,
                 const float* __restrict__ ct, float* __restrict__ d_beams,
                 int n_tiles) {
  __shared__ RayTile s;
  const int chunk = blockIdx.x;
  float acc[NBC] = {};
  if (static_cast<float>(chunk * C) < scalars[3]) {
    const Beam bm = load_beam(beams + static_cast<size_t>(chunk) * NB * C,
                              threadIdx.x, scalars[0]);
    const float inv_min_sin = 1.0f / scalars[2];
    const int n1 = n_tiles + 1;
    const int k1 = chunk_start[chunk + 1];
    for (int k = chunk_start[chunk]; k < k1; ++k) {
      const int sub = __ldg(idx + k) % n1;  // 0 = seed entry
      if (sub == 0) continue;
      beams_sweep_tile<EXTRAS>(rays + static_cast<size_t>(sub - 1) * NF * T,
                               ct + static_cast<size_t>(sub - 1) * NDR * T, s,
                               bm, inv_min_sin, acc);
    }
  }
  write_beams(d_beams, chunk, acc);
}

template <bool EXTRAS>
int launch_dense(const float* rays, const float* beams, const float* scalars,
                 const float* mask, const float* ct, float* d_rays,
                 float* d_beams, int n_tiles, int n_chunks,
                 cudaStream_t stream) {
  bwd_rays_dense<EXTRAS><<<n_tiles, T, 0, stream>>>(
      rays, beams, scalars, mask, ct, d_rays, n_tiles, n_chunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_beams_dense<EXTRAS><<<n_chunks, T, 0, stream>>>(
      rays, beams, scalars, mask, ct, d_beams, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <bool EXTRAS>
int launch_sparse(const float* rays, const float* beams,
                  const float* scalars, const float* ct, const int* idx_t,
                  const int* tile_start, const int* idx_c,
                  const int* chunk_start, float* d_rays, float* d_beams,
                  int n_tiles, int n_chunks, cudaStream_t stream) {
  bwd_rays_sparse<EXTRAS><<<n_tiles, T, 0, stream>>>(
      rays, beams, scalars, idx_t, tile_start, ct, d_rays, n_chunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_beams_sparse<EXTRAS><<<n_chunks, T, 0, stream>>>(
      rays, beams, scalars, idx_c, chunk_start, ct, d_beams, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int bre_gather_backward(const float* rays, const float* beams,
                        const float* scalars, const float* mask,
                        const float* ct, float* d_rays, float* d_beams,
                        int n_tiles, int n_chunks, int want_extras,
                        cudaStream_t stream) {
  return want_extras
             ? launch_dense<true>(rays, beams, scalars, mask, ct, d_rays,
                                  d_beams, n_tiles, n_chunks, stream)
             : launch_dense<false>(rays, beams, scalars, mask, ct, d_rays,
                                   d_beams, n_tiles, n_chunks, stream);
}

int bre_gather_backward_sparse(const float* rays, const float* beams,
                               const float* scalars, const float* ct,
                               const int* idx_t, const int* tile_start,
                               const int* idx_c, const int* chunk_start,
                               float* d_rays, float* d_beams, int n_tiles,
                               int n_chunks, int want_extras,
                               cudaStream_t stream) {
  return want_extras
             ? launch_sparse<true>(rays, beams, scalars, ct, idx_t,
                                   tile_start, idx_c, chunk_start, d_rays,
                                   d_beams, n_tiles, n_chunks, stream)
             : launch_sparse<false>(rays, beams, scalars, ct, idx_t,
                                    tile_start, idx_c, chunk_start, d_rays,
                                    d_beams, n_tiles, n_chunks, stream);
}

}  // extern "C"
