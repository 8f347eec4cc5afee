// Beam radiance estimate gather, backward — hand-written CUDA for Hopper
// (sm_90a), built at first use by bre_tpu_torch/ops/cuda_build.py and bound
// through ctypes by bre_tpu_torch/ops/gather_bwd.py.
//
// Replaces the two Pallas TPU backward kernels of
// bre_tpu/ops/pallas_gather_bwd.py:
//   - pallas_gather_backward_fused (:373, body _bwd_fused_body :182 over
//     _pair_quantities :73) — one sweep over the dense (chunk x tile) grid
//     with the block mask: bre_gather_backward launches bwd_rays_dense and
//     bwd_beams_dense; their grid-medium instances (template argument
//     HETERO) replace its heterogeneous body _bwd_fused_body_het (:241);
//   - pallas_gather_backward_sparse (:607, bodies _ray_rows_update :470 and
//     _beam_cols_update :510) — the same cotangents over the compacted live
//     blocks, tile-major for d_rays and chunk-major for d_beams:
//     bre_gather_backward_sparse launches bwd_rays_sparse and
//     bwd_beams_sparse;
//   - pallas_gather_backward (:775, bodies _bwd_rays_kernel :708 and
//     _bwd_beams_kernel :741) — the historical two-pass backward of the
//     non-packed route (PALLAS_BWD_MODE "twopass"), every block of the grid
//     with the extras on: bre_gather_backward_twopass launches
//     bwd_rays_twopass and bwd_beams_twopass (design at their definition).
//
// What it computes: with the geometry held fixed (grad_geometry=False), the
// analytic cotangents of the forward's per-ray sums, given the output
// cotangent ct: per ray d tr, d sigma_s and (want_extras) d g, d cam_radius,
// summed over beams; per beam d ps, d pe and (want_extras) d radius, summed
// over rays.  Gates as the reference: dead start powers, the pe floor
// (pe_live), the tr floor (trf_live); every sum over a block is taken before
// its division by ps_s, pe_s or tr.  In a grid medium (HETERO): per ray
// d sigma_s, d sigma_t_c and the camera tables' coefficient cotangents
// (d D_c coefficients gated by D_c > 0, d dens coefficients gated by
// dens_c > 0), with the extras d g and d cam_radius; per beam d ps, d
// sigma_t_b, the beam table's d D_b coefficients (gated by D_b > 0) and d
// radius.  tau's cotangent -cA chains into the factored tables.
//
// What bounds it on an H100: arithmetic, as in the forward.  Each live pair
// recomputes the forward geometry (~40 FP32 operations) and, inside the blur
// radius, the phase, kernel and power terms with their derivatives (two
// rsqrt, three exp), in long chains of dependent operations: the card is
// held back by how many warps it keeps in flight.  The TPU kernel's design
// does not carry over: it sums d_beams[chunk] across a grid loop that runs
// in order and keeps all of d_rays resident in VMEM; blocks on the card run
// in parallel in no order, and per-block partials of d_beams at config-2
// size would take ~50 GB.  So the design is two sweeps, each output element
// with exactly one writer, the d_rays sweep on split_sweep.cuh's split and
// ring:
//   - pre-pass: stage_beams writes each live chunk's per-beam terms
//     (BeamChunk, BeamChunkHet) once per call, instead of once per block
//     that reads them;
//   - d_rays: a grid of n_tiles x n_splits blocks of 256 threads, one ray
//     per thread in registers; block (tile, s) walks the live chunks of
//     split s of the tile's chunk range in ascending order, pulling each
//     staged chunk through a two-stage shared-memory ring of bulk copies,
//     into partial cotangents; reduce_splits adds the splits in order.  An
//     R/4 sweep (64 ray tiles) thus runs 4,224 blocks, 8 waves over the
//     132 SMs, where one block per tile used 64 of them;
//   - d_beams: one block per beam chunk (27,344 at the 256x256 / 1M step:
//     it fills the card as it is), one beam per thread in registers, walking
//     its live ray tiles in ascending order, each staged in shared memory by
//     the block (RayTile: the per-ray terms with ct*sigma_s; RayTileHet with
//     ct, sigma_s and the camera tables); chunks past n_valid write zeros.
// The grid-medium instances keep that design.  A ray thread of the d_rays
// sweep holds its ray, ct and its 14 table coefficients in registers with 22
// accumulators and their per-chunk partial sums; the staged chunks carry the
// beam tables (21 KB).  A beam thread of the d_beams sweep holds its beam
// and tables; the staged ray tile carries ct, sigma_s and the camera tables
// (32 KB).
// Both sum each tile's or chunk's partials before adding them, as the plain
// versions do.  The pair work is paid twice (once per sweep): the price of
// deterministic sums without atomics.  The sparse d_rays sweep splits each
// tile's run of listed blocks at the dense sweep's chunk bounds and its
// d_beams sweep walks the same tiles in the same order, so dense and sparse
// agree bit for bit.

#include "split_sweep.cuh"

namespace {

constexpr int DR_TR = 0, DR_SIGS = 3, DR_G = 6, DR_CAMR = 7, NDR = 8;
constexpr int CT_ROWS = 8;  // rows of the output cotangent ct (RGB in 0-2)
constexpr int NBC = 7;  // per-beam cotangents: d ps (3), d pe (3), d radius
// grid media: d_rays rows after the homogeneous 8 (ops/gather_bwd.py)
constexpr int DR_DC = 8, DR_SIGTC = 13, DR_DENS = 16, NDR_HET = 22;
// grid media, per-beam cotangents: d ps (3), d sigma_t_b (3), d D_b
// coefficients (5), d radius
constexpr int HB_PS = 0, HB_SIGT = 3, HB_DP = 6, HB_RAD = 11, NBC_HET = 12;
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

// Grid media: the camera segment's tables and ct.
struct RayCtHet {
  RayTables rt;
  float ct[3];
};

// This thread's per-ray terms of either instance.
template <bool HETERO>
__device__ auto load_ray_terms(const float* __restrict__ tile_rows,
                               const float* __restrict__ ct_rows, int lane) {
  if constexpr (HETERO) {
    return RayCtHet{load_ray_tables(tile_rows, lane),
                    {ct_rows[lane], ct_rows[T + lane], ct_rows[2 * T + lane]}};
  } else {
    return load_ray_ct(tile_rows, ct_rows, lane);
  }
}

// The terms of one in-range pair (_pair_quantities,
// pallas_gather_bwd.py:115-149): base = 1/sin(theta), the HG phase rho, the
// kernel k1 and, with the extras, drho/dg and dk1/dwidth.
struct PairTerms {
  float base, rho, k1, drho_dg, dk1_dw;
};

template <bool EXTRAS>
__device__ __forceinline__ PairTerms pair_terms(float cos_t, float g, float r2,
                                                float inv_w,
                                                float inv_min_sin) {
  const float g2 = mul(g, g);
  const float rs = rsqrtf(fmaxf(add(add(1.0f, g2), mul(mul(2.0f, g), cos_t)),
                                1e-12f));
  const float rs3 = mul(mul(rs, rs), rs);
  PairTerms t;
  t.rho = mul(mul(kInv4Pi, sub(1.0f, g2)), rs3);
  t.base =
      fminf(rsqrtf(fmaxf(sub(1.0f, mul(cos_t, cos_t)), 1e-12f)), inv_min_sin);
  t.k1 = mul(mul(0.75f, sub(1.0f, r2)), inv_w);
  t.drho_dg = t.dk1_dw = 0.0f;
  if (EXTRAS) {
    t.drho_dg = mul(
        kInv4Pi,
        add(mul(mul(-2.0f, g), rs3),
            mul(mul(mul(sub(1.0f, g2), -1.5f), mul(mul(rs3, rs), rs)),
                add(mul(2.0f, g), mul(2.0f, cos_t)))));
    t.dk1_dw = mul(mul(0.75f, mul(inv_w, inv_w)), sub(mul(3.0f, r2), 1.0f));
  }
  return t;
}

// The weights of one in-range pair: w0 = base rho k1 and, with the extras,
// wrad = base rho dk1/dwidth and wg = base k1 drho/dg.
struct PairWeights {
  float w0, wrad, wg;
};

template <bool EXTRAS>
__device__ __forceinline__ PairWeights pair_weights(float cos_t, float g,
                                                    float r2, float inv_w,
                                                    float inv_min_sin) {
  const PairTerms t = pair_terms<EXTRAS>(cos_t, g, r2, inv_w, inv_min_sin);
  PairWeights w{mul(mul(t.base, t.rho), t.k1), 0.0f, 0.0f};
  if (EXTRAS) {
    w.wrad = mul(mul(t.base, t.rho), t.dk1_dw);
    w.wg = mul(mul(t.base, t.k1), t.drho_dg);
  }
  return w;
}

// Resident blocks per SM that the register budget must allow (the split
// count aims at 4 blocks per SM): 80 registers a thread for the
// homogeneous d_rays sweeps, 128 for the grid-medium ones with their 22
// accumulators and partial sums.
template <bool HETERO>
constexpr int kBwdMinBlocks = HETERO ? 2 : 3;

// The dense d_beams sweep's: 64 registers a thread (4 blocks per SM) for
// the homogeneous instance without the extras, 85 (3) for the others,
// which spill at 64.
template <bool EXTRAS, bool HETERO>
constexpr int kBeamsMinBlocks = EXTRAS || HETERO ? 3 : 4;

// ---- sweep 1: d_rays, one thread per ray --------------------------------

// Sweep one staged chunk's beams against this thread's ray; the chunk's
// sums over beams are turned into cotangents and added to acc.
template <bool EXTRAS>
__device__ __forceinline__ void rays_sweep_chunk(const BeamChunk& s,
                                                 const Ray& r, const RayCt& rc,
                                                 float inv_min_sin,
                                                 float acc[NDR]) {
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
}

// The grid-medium instance of rays_sweep_chunk (_bwd_fused_body_het, ray
// side): acc holds the NDR_HET rows of d_rays; the DR_TR rows stay 0.
template <bool EXTRAS>
__device__ __forceinline__ void rays_sweep_chunk(const BeamChunkHet& s,
                                                 const Ray& r,
                                                 const RayCtHet& rc,
                                                 float inv_min_sin,
                                                 float acc[NDR_HET]) {
  const RayTables& rt = rc.rt;
  const float* ct = rc.ct;
  float part[NDR_HET] = {};
#pragma unroll 1
  for (int k = 0; k < C; ++k) {
    const float b0[3] = {s.b0[0][k], s.b0[1][k], s.b0[2][k]};
    const float d2[3] = {s.d2[0][k], s.d2[1][k], s.d2[2][k]};
    const float inv_w = s.inv_w[k];
    const PairGeom p = closest_points(r.a0, r.d1, r.a, r.inv_a, b0, d2,
                                      s.e[k], s.inv_e[k], inv_w);
    if (!(p.r2 < 1.0f)) continue;  // outside the blur width: no cotangent
    const PairWeights w = pair_weights<EXTRAS>(
        cos_theta(r.dir, d2, s.ibl[k]), r.g, p.r2, inv_w, inv_min_sin);
    const float dp[D_COEFS] = {s.dp[0][k], s.dp[1][k], s.dp[2][k],
                               s.dp[3][k], s.dp[4][k]};
    const float dens_raw = horner_dens(rt.densc, p.sc);
    const float dens = fmaxf(dens_raw, 0.0f);
    const float Db = fmaxf(horner_D(dp, p.tc), 0.0f);
    const float Dc_raw = horner_D(rt.dc, p.sc);
    const float Dc = fmaxf(Dc_raw, 0.0f);
    float m_D = 0.0f, cw = 0.0f;  // sum_ch cA sigma_t_c, ct w0 sigma_s pt
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float sig = r.sigs[ch], ps = s.ps[ch][k], stc = rt.sigtc[ch];
      const float decay = het_decay(s.sigt[ch][k], Db, stc, Dc);
      const float pt = mul(ps, decay);
      const float cB = mul(mul(ct[ch], mul(mul(w.w0, sig), dens)), decay);
      const float cA = mul(cB, ps);
      part[DR_SIGTC + ch] = add(part[DR_SIGTC + ch], mul(-cA, Dc));
      m_D = add(m_D, mul(cA, stc));
      part[DR_SIGS + ch] = add(part[DR_SIGS + ch], mul(mul(w.w0, pt), dens));
      cw = add(cw, mul(mul(ct[ch], mul(w.w0, sig)), pt));
      if (EXTRAS) {
        part[DR_G] = add(part[DR_G],
                         mul(mul(mul(mul(ct[ch], w.wg), pt), sig), dens));
        part[DR_CAMR] = add(part[DR_CAMR],
                            mul(mul(mul(mul(ct[ch], w.wrad), pt), sig), dens));
      }
    }
    // d c_i = dL/dD_c f^(i+1) where D_c > 0; d e_i = dL/d dens f^i where
    // dens_c > 0
    const float m_Dm = Dc_raw > 0.0f ? -m_D : 0.0f;
    float f = p.sc;
#pragma unroll
    for (int i = 0; i < D_COEFS; ++i) {
      part[DR_DC + i] = add(part[DR_DC + i], mul(m_Dm, f));
      f = mul(f, p.sc);
    }
    const float cw_m = dens_raw > 0.0f ? cw : 0.0f;
    f = 1.0f;
#pragma unroll
    for (int i = 0; i < DENS_COEFS; ++i) {
      part[DR_DENS + i] = add(part[DR_DENS + i], mul(cw_m, f));
      f = mul(f, p.sc);
    }
  }
  // d sigma_s = ct * (the chunk's sum over beams), as the plain version
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) part[DR_SIGS + ch] = mul(ct[ch], part[DR_SIGS + ch]);
#pragma unroll
  for (int row = DR_SIGS; row < NDR_HET; ++row) acc[row] = add(acc[row], part[row]);
}

template <int ROWS>
__device__ void write_rays(float* __restrict__ d_rays, int tile,
                           const float acc[ROWS]) {
  float* o = d_rays + static_cast<size_t>(tile) * ROWS * T + threadIdx.x;
#pragma unroll
  for (int row = 0; row < ROWS; ++row) o[row * T] = acc[row];
}

// The d_rays sweep of either kernel: this block's ray (tile blockIdx.x)
// against the positions p = walk.first(lo) ... of its walk, each a staged
// chunk of `staged` (stage_beams); the partial cotangents go to `partial`.
template <bool EXTRAS, bool HETERO, class Walk, class ChunkOf>
__device__ __forceinline__ void d_rays_sweep(
    const float* __restrict__ rays, const float* __restrict__ staged,
    const float* __restrict__ scalars, const float* __restrict__ ct,
    const Walk& walk, int lo, ChunkOf chunk_of, float* __restrict__ partial) {
  constexpr int nf = HETERO ? NF_HET : NF;
  constexpr int ndr = HETERO ? NDR_HET : NDR;
  using Stage = ChunkT<HETERO>;
  ring_init<Stage>();
  const int tile = blockIdx.x;
  const float* tile_rows = rays + static_cast<size_t>(tile) * nf * T;
  const float* ct_rows = ct + static_cast<size_t>(tile) * CT_ROWS * T;
  const Ray r = load_ray(tile_rows, threadIdx.x);
  const auto rc = load_ray_terms<HETERO>(tile_rows, ct_rows, threadIdx.x);
  const float inv_min_sin = 1.0f / scalars[2];
  const Stage* chunks = reinterpret_cast<const Stage*>(staged);
  float acc[ndr] = {};
  ring_walk<Stage>(
      walk.first(lo), walk.end(), [&](int p) { return walk.next(p); },
      [&](int p) { return chunks + chunk_of(p); },
      [&](const Stage& s, int) {
        rays_sweep_chunk<EXTRAS>(s, r, rc, inv_min_sin, acc);
      });
  write_partial<ndr>(partial, acc);
}

// scalars: cam_radius, power_scale (folded into sigma_s), min_sin, n_valid.
// mask: (n_chunks, n_tiles), 0 = skip the block.  ct: (n_tiles, 8, T).
// Grid (n_tiles, n_splits): block (tile, s) sweeps the live chunks of split
// s into partial (n_splits, n_tiles, 8|NDR_HET, T).
template <bool EXTRAS, bool HETERO>
__global__ void __launch_bounds__(T, kBwdMinBlocks<HETERO>)
bwd_rays_dense(const float* __restrict__ rays,
               const float* __restrict__ staged,
               const float* __restrict__ scalars,
               const float* __restrict__ mask, const float* __restrict__ ct,
               float* __restrict__ partial, int n_tiles, int n_chunks) {
  const ChunkRange cr =
      split_range(scalars[3], n_chunks, gridDim.y, blockIdx.y);
  const MaskedChunks walk{mask + blockIdx.x, n_tiles, cr.hi};
  d_rays_sweep<EXTRAS, HETERO>(rays, staged, scalars, ct, walk, cr.lo,
                               [](int j) { return j; }, partial);
}

// idx: tile-major ids of ops/gather.py sparse_block_ids; run_start
// (n_splits+1, n_tiles): run_start[s][t] .. run_start[s+1][t] are the
// entries of tile t whose chunk lies in split s.
template <bool EXTRAS>
__global__ void __launch_bounds__(T, kBwdMinBlocks<false>)
bwd_rays_sparse(const float* __restrict__ rays,
                const float* __restrict__ staged,
                const float* __restrict__ scalars, const int* __restrict__ idx,
                const int* __restrict__ run_start,
                const float* __restrict__ ct, float* __restrict__ partial,
                int n_tiles, int n_chunks) {
  const int* rs = run_start + static_cast<size_t>(blockIdx.y) * n_tiles + blockIdx.x;
  const ListedChunks walk{idx, n_chunks + 1, rs[n_tiles], scalars[3]};
  d_rays_sweep<EXTRAS, false>(rays, staged, scalars, ct, walk, rs[0],
                              [&](int k) { return walk.chunk(k); }, partial);
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

// Thread `lane` stages ray `lane` of one tile (coalesced rows).
__device__ void stage_tile(const float* __restrict__ tile_rows,
                           const float* __restrict__ ct_rows, RayTile& s,
                           int lane) {
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
}

// Sweep one staged ray tile's rays against this thread's beam; the tile's
// sums over rays are turned into cotangents and added to acc (d ps 0..2,
// d pe 3..5, d radius 6).
template <bool EXTRAS>
__device__ __forceinline__ void beams_sweep_tile(const RayTile& s,
                                                 const Beam& bm,
                                                 float inv_min_sin,
                                                 float acc[NBC]) {
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
}

// One staged grid-medium ray tile, field-major (33 KB).
struct RayTileHet {
  float a0[3][T];
  float d1[3][T];
  float dir[3][T];
  float ct[3][T];
  float sigs[3][T];
  float sigtc[3][T];
  float dc[D_COEFS][T];
  float densc[DENS_COEFS][T];
  float a[T];
  float inv_a[T];
  float g[T];
};

__device__ void stage_tile(const float* __restrict__ tile_rows,
                           const float* __restrict__ ct_rows, RayTileHet& s,
                           int lane) {
  const Ray r = load_ray(tile_rows, lane);
  const RayTables rt = load_ray_tables(tile_rows, lane);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.a0[c][lane] = r.a0[c];
    s.d1[c][lane] = r.d1[c];
    s.dir[c][lane] = r.dir[c];
    s.ct[c][lane] = ct_rows[c * T + lane];
    s.sigs[c][lane] = r.sigs[c];
    s.sigtc[c][lane] = rt.sigtc[c];
  }
#pragma unroll
  for (int i = 0; i < D_COEFS; ++i) s.dc[i][lane] = rt.dc[i];
#pragma unroll
  for (int i = 0; i < DENS_COEFS; ++i) s.densc[i][lane] = rt.densc[i];
  s.a[lane] = r.a;
  s.inv_a[lane] = r.inv_a;
  s.g[lane] = r.g;
}

// The grid-medium instance of beams_sweep_tile (_bwd_fused_body_het, beam
// side): acc holds d ps, d sigma_t_b, d D_b coefficients and d radius
// (HB_* slots).
template <bool EXTRAS>
__device__ __forceinline__ void beams_sweep_tile(const RayTileHet& s,
                                                 const BeamHet& bm,
                                                 float inv_min_sin,
                                                 float acc[NBC_HET]) {
  float part[NBC_HET] = {};
#pragma unroll 1
  for (int i = 0; i < T; ++i) {
    const float a0[3] = {s.a0[0][i], s.a0[1][i], s.a0[2][i]};
    const float d1[3] = {s.d1[0][i], s.d1[1][i], s.d1[2][i]};
    const PairGeom p = closest_points(a0, d1, s.a[i], s.inv_a[i], bm.b0,
                                      bm.d2, bm.e, bm.inv_e, bm.inv_w);
    if (!(p.r2 < 1.0f)) continue;
    const float dir[3] = {s.dir[0][i], s.dir[1][i], s.dir[2][i]};
    const PairWeights w = pair_weights<EXTRAS>(
        cos_theta(dir, bm.d2, bm.ibl), s.g[i], p.r2, bm.inv_w, inv_min_sin);
    float densc[DENS_COEFS], dc[D_COEFS];
#pragma unroll
    for (int j = 0; j < DENS_COEFS; ++j) densc[j] = s.densc[j][i];
#pragma unroll
    for (int j = 0; j < D_COEFS; ++j) dc[j] = s.dc[j][i];
    const float dens = fmaxf(horner_dens(densc, p.sc), 0.0f);
    const float Dc = fmaxf(horner_D(dc, p.sc), 0.0f);
    const float Db_raw = horner_D(bm.dp, p.tc);
    const float Db = fmaxf(Db_raw, 0.0f);
    float m_D = 0.0f;  // sum_ch cA sigma_t_b
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float ct = s.ct[ch][i], sig = s.sigs[ch][i];
      const float decay = het_decay(bm.sigt[ch], Db, s.sigtc[ch][i], Dc);
      const float pt = mul(bm.ps[ch], decay);
      const float cB = mul(mul(ct, mul(mul(w.w0, sig), dens)), decay);
      const float cA = mul(cB, bm.ps[ch]);
      part[HB_PS + ch] = add(part[HB_PS + ch], cB);
      part[HB_SIGT + ch] = add(part[HB_SIGT + ch], mul(-cA, Db));
      m_D = add(m_D, mul(cA, bm.sigt[ch]));
      if (EXTRAS)
        part[HB_RAD] = add(part[HB_RAD],
                           mul(mul(mul(mul(ct, w.wrad), pt), sig), dens));
    }
    const float m_Dm = Db_raw > 0.0f ? -m_D : 0.0f;
    float f = p.tc;
#pragma unroll
    for (int j = 0; j < D_COEFS; ++j) {
      part[HB_DP + j] = add(part[HB_DP + j], mul(m_Dm, f));
      f = mul(f, p.tc);
    }
  }
#pragma unroll
  for (int k = 0; k < NBC_HET; ++k) acc[k] = add(acc[k], part[k]);
}

// d_beams rows: zeros for the geometry and padding fields, d ps at BF_PS,
// d pe at BF_PE, d radius at BF_RAD.  Grid media: d ps at BF_PS, d radius
// at BF_RAD, the D_b coefficients' cotangents at BF_DP, d sigma_t_b at
// BF_SIGT; zeros elsewhere (pe too).
template <bool HETERO>
__device__ void write_beams(float* __restrict__ d_beams, int chunk,
                            const float* acc) {
  constexpr int nb = HETERO ? NB_HET : NB;
  float* o = d_beams + static_cast<size_t>(chunk) * nb * C + threadIdx.x;
#pragma unroll
  for (int row = 0; row < nb; ++row) {
    float v = 0.0f;
    if constexpr (HETERO) {
      if (row >= BF_PS && row < BF_PS + 3) v = acc[HB_PS + row - BF_PS];
      if (row == BF_RAD) v = acc[HB_RAD];
      if (row >= BF_DP && row < BF_DP + D_COEFS) v = acc[HB_DP + row - BF_DP];
      if (row >= BF_SIGT && row < BF_SIGT + 3) v = acc[HB_SIGT + row - BF_SIGT];
    } else {
      const int k = row - BF_PS;
      if (k >= 0 && k < NBC) v = acc[k];
    }
    o[row * C] = v;
  }
}

// Beam `lane` of a chunk with its derived terms, either instance.
template <bool HETERO>
__device__ auto load_beam_any(const float* __restrict__ chunk, int lane,
                              float cam_radius) {
  if constexpr (HETERO) {
    return load_beam_het(chunk, lane, cam_radius);
  } else {
    return load_beam(chunk, lane, cam_radius);
  }
}

// One block per beam chunk: the live ray tiles of its mask row, ascending,
// each staged in shared memory by the block itself.  (Recomputing a tile's
// per-ray terms here timed faster on the H100 than copying them in from a
// pre-pass, through a bulk-copy ring or plain loads.)
template <bool EXTRAS, bool HETERO>
__global__ void __launch_bounds__(T, kBeamsMinBlocks<EXTRAS, HETERO>)
bwd_beams_dense(const float* __restrict__ rays, const float* __restrict__ beams,
                const float* __restrict__ scalars,
                const float* __restrict__ mask, const float* __restrict__ ct,
                float* __restrict__ d_beams, int n_tiles) {
  constexpr int nf = HETERO ? NF_HET : NF, nb = HETERO ? NB_HET : NB;
  __shared__ typename std::conditional<HETERO, RayTileHet, RayTile>::type s;
  const int chunk = blockIdx.x;
  const float* mrow = mask + static_cast<size_t>(chunk) * n_tiles;
  const float inv_min_sin = 1.0f / scalars[2];
  // chunks past n_valid hold no live beam: zeros
  float acc[HETERO ? NBC_HET : NBC] = {};
  if (static_cast<float>(chunk * C) < scalars[3]) {
    const auto bm = load_beam_any<HETERO>(
        beams + static_cast<size_t>(chunk) * nb * C, threadIdx.x, scalars[0]);
    for (int i = 0; i < n_tiles; ++i) {
      if (!(__ldg(mrow + i) > 0.0f)) continue;
      stage_tile(rays + static_cast<size_t>(i) * nf * T,
                 ct + static_cast<size_t>(i) * CT_ROWS * T, s, threadIdx.x);
      __syncthreads();
      beams_sweep_tile<EXTRAS>(s, bm, inv_min_sin, acc);
      __syncthreads();  // the next tile overwrites s
    }
  }
  write_beams<HETERO>(d_beams, chunk, acc);
}

// idx: chunk-major ids of ops/gather_bwd.py sparse_block_ids_chunk_major;
// chunk_start[j] .. chunk_start[j+1] is chunk j's run.  Each listed tile is
// staged in shared memory by the block itself.
template <bool EXTRAS>
__global__ void __launch_bounds__(T, kBwdMinBlocks<false>)
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
      stage_tile(rays + static_cast<size_t>(sub - 1) * NF * T,
                 ct + static_cast<size_t>(sub - 1) * CT_ROWS * T, s,
                 threadIdx.x);
      __syncthreads();
      beams_sweep_tile<EXTRAS>(s, bm, inv_min_sin, acc);
      __syncthreads();  // the next tile overwrites s
    }
  }
  write_beams<false>(d_beams, chunk, acc);
}

// ---- the two-pass dense backward (Queue 2 row 6) -------------------------
//
// pallas_gather_backward (pallas_gather_bwd.py:775; bodies _bwd_rays_kernel
// :708 and _bwd_beams_kernel :741): the same cotangents with the extras
// always on, over EVERY block of the (chunk x tile) grid: no block mask and
// no dead-chunk skip (dead beams carry zero powers and add exact zeros).
// Per pair it follows the reference's form, not the fused kernels': p_at
// and tr_cam = exp(frac_c log(max(tr, 1e-30))) are two exps, and the
// per-beam partials dp/dps, dp/dpe divide per pair.  The channel terms are
// rounded in the plain version's order (ops/gather_bwd.py
// _twopass_blocks_ref).

// d_rays: one block per ray tile, one thread per ray, walking every chunk
// in ascending order, each staged in shared memory; per chunk the sums over
// its beams are turned into cotangents and added, as the reference adds each
// grid step's block sums.  d g and d cam_radius sum each pair's three
// channel terms first (the reference's (C, T) accumulators).
__global__ void __launch_bounds__(T)
bwd_rays_twopass(const float* __restrict__ rays,
                 const float* __restrict__ beams,
                 const float* __restrict__ scalars,
                 const float* __restrict__ ct, float* __restrict__ d_rays,
                 int n_chunks) {
  __shared__ BeamChunk s;
  const int tile = blockIdx.x;
  const float* tile_rows = rays + static_cast<size_t>(tile) * NF * T;
  const Ray r = load_ray(tile_rows, threadIdx.x);
  const RayCt rc = load_ray_ct(
      tile_rows, ct + static_cast<size_t>(tile) * CT_ROWS * T, threadIdx.x);
  const float cam_radius = scalars[0];
  const float inv_min_sin = 1.0f / scalars[2];
  float acc[NDR] = {};
  for (int j = 0; j < n_chunks; ++j) {
    stage_chunk(beams + static_cast<size_t>(j) * NB * C, s, threadIdx.x,
                cam_radius);
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
      if (!(p.r2 < 1.0f)) continue;  // base = 0 outside the blur width
      const PairTerms q = pair_terms<true>(cos_theta(r.dir, d2, s.ibl[k]),
                                           r.g, p.r2, inv_w, inv_min_sin);
      const float w0 = mul(mul(q.base, q.rho), q.k1);
      const float wg = mul(mul(q.base, q.k1), q.drho_dg);
      const float wrad = mul(mul(q.base, q.rho), q.dk1_dw);
      float g_pair = 0.0f, camr_pair = 0.0f;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float p_at = mul(s.ps[ch][k], expf(mul(p.tc, s.lp[ch][k])));
        const float tr_cam = expf(mul(p.sc, r.lt[ch]));
        const float A = mul(mul(w0, p_at), tr_cam);
        sum_a[ch] = add(sum_a[ch], A);
        sum_af[ch] = add(sum_af[ch], mul(A, p.sc));
        g_pair = add(g_pair, mul(mul(mul(rc.coef[ch], wg), p_at), tr_cam));
        camr_pair =
            add(camr_pair, mul(mul(mul(rc.coef[ch], wrad), p_at), tr_cam));
      }
      sum_g = add(sum_g, g_pair);
      sum_camr = add(sum_camr, camr_pair);
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      acc[DR_SIGS + ch] = add(acc[DR_SIGS + ch], mul(rc.ct[ch], sum_a[ch]));
      acc[DR_TR + ch] =
          add(acc[DR_TR + ch],
              mul(mul(rc.coef[ch], sum_af[ch] / rc.trf[ch]), rc.trf_live[ch]));
    }
    acc[DR_G] = add(acc[DR_G], sum_g);
    acc[DR_CAMR] = add(acc[DR_CAMR], sum_camr);
    __syncthreads();  // the next chunk overwrites s
  }
  write_rays<NDR>(d_rays, tile, acc);
}

// d_beams: one block per beam chunk, one thread per beam, walking every ray
// tile in ascending order, each staged in shared memory; per tile the sums
// over its rays are added (d radius: the three channels' sums, in channel
// order, as the reference adds them).
__global__ void __launch_bounds__(T)
bwd_beams_twopass(const float* __restrict__ rays,
                  const float* __restrict__ beams,
                  const float* __restrict__ scalars,
                  const float* __restrict__ ct, float* __restrict__ d_beams,
                  int n_tiles) {
  __shared__ RayTile s;
  const int chunk = blockIdx.x;
  const Beam bm = load_beam(beams + static_cast<size_t>(chunk) * NB * C,
                            threadIdx.x, scalars[0]);
  const float inv_min_sin = 1.0f / scalars[2];
  float acc[NBC] = {};
  for (int i = 0; i < n_tiles; ++i) {
    stage_tile(rays + static_cast<size_t>(i) * NF * T,
               ct + static_cast<size_t>(i) * CT_ROWS * T, s, threadIdx.x);
    __syncthreads();
    float sum_ps[3] = {0.0f, 0.0f, 0.0f}, sum_pe[3] = {0.0f, 0.0f, 0.0f};
    float sum_rad[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll 2
    for (int k = 0; k < T; ++k) {
      const float a0[3] = {s.a0[0][k], s.a0[1][k], s.a0[2][k]};
      const float d1[3] = {s.d1[0][k], s.d1[1][k], s.d1[2][k]};
      const PairGeom p = closest_points(a0, d1, s.a[k], s.inv_a[k], bm.b0,
                                        bm.d2, bm.e, bm.inv_e, bm.inv_w);
      if (!(p.r2 < 1.0f)) continue;
      const float dir[3] = {s.dir[0][k], s.dir[1][k], s.dir[2][k]};
      const PairTerms q = pair_terms<true>(cos_theta(dir, bm.d2, bm.ibl),
                                           s.g[k], p.r2, bm.inv_w,
                                           inv_min_sin);
      const float w0 = mul(mul(q.base, q.rho), q.k1);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const bool ok = bm.ps[ch] > 0.0f;  // 0 exactly where ps is dead
        const float tr_cam = expf(mul(p.sc, s.lt[ch][k]));
        const float p_at = mul(bm.ps[ch], expf(mul(p.tc, bm.lp[ch])));
        const float dp_dps =
            ok ? mul(p_at, sub(1.0f, p.tc)) / bm.ps_s[ch] : 0.0f;
        const float dp_dpe =
            mul(ok ? mul(p_at, p.tc) / bm.pe_s[ch] : 0.0f, bm.pe_live[ch]);
        const float coef = mul(mul(s.coef[ch][k], w0), tr_cam);
        sum_ps[ch] = add(sum_ps[ch], mul(coef, dp_dps));
        sum_pe[ch] = add(sum_pe[ch], mul(coef, dp_dpe));
        sum_rad[ch] = add(
            sum_rad[ch],
            mul(mul(mul(mul(mul(s.coef[ch][k], q.base), q.rho), q.dk1_dw),
                    p_at),
                tr_cam));
      }
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      acc[ch] = add(acc[ch], sum_ps[ch]);
      acc[3 + ch] = add(acc[3 + ch], sum_pe[ch]);
    }
    acc[6] = add(acc[6], add(add(sum_rad[0], sum_rad[1]), sum_rad[2]));
    __syncthreads();  // the next tile overwrites s
  }
  write_beams<false>(d_beams, chunk, acc);
}

// stage_beams, the d_rays sweep over the (n_tiles, n_splits) grid,
// reduce_splits into d_rays, the d_beams sweep.
template <bool EXTRAS, bool HETERO>
int launch_dense(const float* rays, const float* beams, const float* scalars,
                 const float* mask, const float* ct, float* staged_beams,
                 float* partial, float* d_rays, float* d_beams, int n_tiles,
                 int n_chunks, int n_splits, cudaStream_t stream) {
  constexpr int ndr = HETERO ? NDR_HET : NDR;
  stage_beams<HETERO><<<n_chunks, C, 0, stream>>>(beams, scalars, staged_beams);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem_r = ring_smem_bytes<ChunkT<HETERO>>();
  bwd_rays_dense<EXTRAS, HETERO><<<dim3(n_tiles, n_splits), T, smem_r, stream>>>(
      rays, staged_beams, scalars, mask, ct, partial, n_tiles, n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  reduce_splits<<<dim3(n_tiles, ndr), T, 0, stream>>>(
      partial, d_rays, n_splits, n_tiles, ndr, ndr);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_beams_dense<EXTRAS, HETERO><<<n_chunks, T, 0, stream>>>(
      rays, beams, scalars, mask, ct, d_beams, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// stage_beams, the d_rays sweep over the (n_tiles, n_splits) grid, reduce_splits,
// the d_beams sweep over the chunk-major list.
template <bool EXTRAS>
int launch_sparse(const float* rays, const float* beams,
                  const float* scalars, const float* ct, const int* idx_t,
                  const int* run_start, const int* idx_c,
                  const int* chunk_start, float* staged_beams, float* partial,
                  float* d_rays, float* d_beams, int n_tiles, int n_chunks,
                  int n_splits, cudaStream_t stream) {
  stage_beams<false><<<n_chunks, C, 0, stream>>>(beams, scalars, staged_beams);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem_r = ring_smem_bytes<BeamChunk>();
  bwd_rays_sparse<EXTRAS><<<dim3(n_tiles, n_splits), T, smem_r, stream>>>(
      rays, staged_beams, scalars, idx_t, run_start, ct, partial, n_tiles,
      n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  reduce_splits<<<dim3(n_tiles, NDR), T, 0, stream>>>(
      partial, d_rays, n_splits, n_tiles, NDR, NDR);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_beams_sparse<EXTRAS><<<n_chunks, T, 0, stream>>>(
      rays, beams, scalars, idx_c, chunk_start, ct, d_beams, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// staged_beams: (n_chunks, 16|21, C) and partial: (n_splits, n_tiles,
// 8|NDR_HET, T) scratch.  hetero: 0 = homogeneous layouts, 1 = grid media
// (NF_HET rays, NB_HET beams, NDR_HET d_rays rows).
int bre_gather_backward(const float* rays, const float* beams,
                        const float* scalars, const float* mask,
                        const float* ct, float* staged_beams, float* partial,
                        float* d_rays, float* d_beams, int n_tiles,
                        int n_chunks, int n_splits, int want_extras,
                        int hetero, cudaStream_t stream) {
  auto* f = hetero ? (want_extras ? &launch_dense<true, true>
                                  : &launch_dense<false, true>)
                   : (want_extras ? &launch_dense<true, false>
                                  : &launch_dense<false, false>);
  return f(rays, beams, scalars, mask, ct, staged_beams, partial, d_rays,
           d_beams, n_tiles, n_chunks, n_splits, stream);
}

// run_start: (n_splits+1, n_tiles) int32 (ops/gather.py split_run_starts);
// staged_beams and partial as above.
int bre_gather_backward_sparse(const float* rays, const float* beams,
                               const float* scalars, const float* ct,
                               const int* idx_t, const int* run_start,
                               const int* idx_c, const int* chunk_start,
                               float* staged_beams, float* partial,
                               float* d_rays, float* d_beams, int n_tiles,
                               int n_chunks, int n_splits, int want_extras,
                               cudaStream_t stream) {
  auto* f = want_extras ? &launch_sparse<true> : &launch_sparse<false>;
  return f(rays, beams, scalars, ct, idx_t, run_start, idx_c, chunk_start,
           staged_beams, partial, d_rays, d_beams, n_tiles, n_chunks, n_splits,
           stream);
}

// scalars: cam_radius, power_scale (folded into sigma_s), min_sin; a fourth
// entry (n_valid) is not read.  ct: (n_tiles, 8, T); d_rays: (n_tiles, 8,
// T); d_beams: (n_chunks, NB, C).
int bre_gather_backward_twopass(const float* rays, const float* beams,
                                const float* scalars, const float* ct,
                                float* d_rays, float* d_beams, int n_tiles,
                                int n_chunks, cudaStream_t stream) {
  bwd_rays_twopass<<<n_tiles, T, 0, stream>>>(rays, beams, scalars, ct,
                                              d_rays, n_chunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_beams_twopass<<<n_chunks, T, 0, stream>>>(rays, beams, scalars, ct,
                                                d_beams, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
