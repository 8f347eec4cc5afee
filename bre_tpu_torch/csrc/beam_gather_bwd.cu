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
//     with the extras on: bre_gather_backward_twopass launches the dense
//     sweeps' two-pass instances (TWOPASS, design below).
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
// The two-pass backward runs the same two sweeps in its own form (TWOPASS:
// the reference's operation order, as ops/gather_bwd.py
// _twopass_blocks_ref: p_at and tr_cam as two exps, the per-beam partials
// dp/dps and dp/dpe divided per pair, the extras always on).  It sweeps
// every block of the grid whatever n_valid says, but a chunk in which no
// beam has a live start power (ps > 1e-20, load_beam's gate) in any
// channel adds exact zeros to every sum of both sweeps (p_at, dp/dps and
// dp/dpe vanish with finite pair weights), so its pre-pass,
// stage_power_chunks, flags the chunks with a live power and stages those
// (past n_valid too), and flagged_extent writes 1 + the last flagged chunk.
// The d_rays splits cut [0, extent) and walk the flagged chunks of every
// ray tile; a d_beams block of an unflagged chunk writes zeros.  The
// validity-compacted buffers of both routes end in such chunks (dead
// powers: the validity is folded into them).  Nothing is read on the host.
// Both sum each tile's or chunk's partials before adding them, as the plain
// versions do.  The pair work is paid twice (once per sweep): the price of
// deterministic sums without atomics.  The sparse d_rays sweep splits each
// tile's run of listed blocks at the dense sweep's chunk bounds and its
// d_beams sweep walks the same tiles in the same order, so dense and sparse
// agree bit for bit.  The sparse sweeps read a plan built on the device
// (ops/gather.py sparse_ray_plan, ops/gather_bwd.py sparse_beam_plan): each
// entry's chunk or tile, and a launch order with the longest runs and
// chunks first.  A block's work is its run's length, and in index order the
// long runs of a sweep's busiest region start late and set the tail:
// launched largest first, the last wave holds the shortest ones (the
// modelled tail falls from 1.09 to 1.03 of the ideal on the ray side and
// from 1.06 to 1.02 on d_beams at the regime sweep of chip_smoke.py phase
// 33).  Reordering blocks changes no sum.  The sparse d_beams sweep runs
// at the dense one's 4 resident blocks per SM without the extras.  Staging
// the next tile into a second buffer during the sweep (one barrier per
// tile instead of two) timed 0.7-1.0% slower on the H100 and was dropped
// (PERF.md §6, the sparse tier).

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

// The two-pass form of rays_sweep_chunk (_bwd_rays_kernel,
// pallas_gather_bwd.py:708-738): the extras always on, p_at and tr_cam =
// exp(frac_c log(max(tr, 1e-30))) as two exps, d g and d cam_radius summing
// each pair's three channel terms first (the reference's (C, T)
// accumulators); the chunk's sums over beams are turned into cotangents and
// added to acc, rounded in the plain version's order.
__device__ __forceinline__ void rays_sweep_chunk_twopass(const BeamChunk& s,
                                                         const Ray& r,
                                                         const RayCt& rc,
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
    if (!(p.r2 < 1.0f)) continue;  // base = 0 outside the blur width
    const PairTerms q = pair_terms<true>(cos_theta(r.dir, d2, s.ibl[k]), r.g,
                                         p.r2, inv_w, inv_min_sin);
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
}

// The d_rays sweep of either kernel: ray tile `tile` against the positions
// p = walk.first(lo) ... of its walk, each a staged chunk of `staged`
// (stage_beams, stage_power_chunks); the partial cotangents go to (split,
// tile) of `partial`.  TWOPASS: the two-pass form (homogeneous, extras on).
template <bool EXTRAS, bool HETERO, bool TWOPASS, class Walk, class ChunkOf>
__device__ __forceinline__ void d_rays_sweep(
    const float* __restrict__ rays, const float* __restrict__ staged,
    const float* __restrict__ scalars, const float* __restrict__ ct,
    const Walk& walk, int lo, ChunkOf chunk_of, int tile, int split,
    int n_tiles, float* __restrict__ partial) {
  constexpr int nf = HETERO ? NF_HET : NF;
  constexpr int ndr = HETERO ? NDR_HET : NDR;
  using Stage = ChunkT<HETERO>;
  ring_init<Stage>();
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
        if constexpr (TWOPASS) {
          rays_sweep_chunk_twopass(s, r, rc, inv_min_sin, acc);
        } else {
          rays_sweep_chunk<EXTRAS>(s, r, rc, inv_min_sin, acc);
        }
      });
  write_partial<ndr>(partial, acc, tile, split, n_tiles);
}

// scalars: cam_radius, power_scale (folded into sigma_s), min_sin, n_valid.
// mask: (n_chunks, n_tiles), 0 = skip the block.  ct: (n_tiles, 8, T).
// Grid (n_tiles, n_splits): block (tile, s) sweeps the live chunks of split
// s into partial (n_splits, n_tiles, 8|NDR_HET, T).  TWOPASS: mask is the
// pre-pass's (n_chunks + 1,) flags, one column for every ray tile, and the
// splits cut [0, extent) (flags[n_chunks]), not the chunks before n_valid.
template <bool EXTRAS, bool HETERO, bool TWOPASS = false>
__global__ void __launch_bounds__(T, kBwdMinBlocks<HETERO>)
bwd_rays_dense(const float* __restrict__ rays,
               const float* __restrict__ staged,
               const float* __restrict__ scalars,
               const float* __restrict__ mask, const float* __restrict__ ct,
               float* __restrict__ partial, int n_tiles, int n_chunks) {
  const int n_live = TWOPASS ? static_cast<int>(mask[n_chunks])
                             : live_chunk_count(scalars[3], n_chunks);
  const ChunkRange cr = split_range(n_live, gridDim.y, blockIdx.y);
  const MaskedChunks walk = TWOPASS
                                ? MaskedChunks{mask, 1, cr.hi}
                                : MaskedChunks{mask + blockIdx.x, n_tiles, cr.hi};
  d_rays_sweep<EXTRAS, HETERO, TWOPASS>(rays, staged, scalars, ct, walk,
                                        cr.lo, [](int j) { return j; },
                                        blockIdx.x, blockIdx.y, n_tiles,
                                        partial);
}

// chunk_of, run_start and order: the tile-major list's plan (ops/gather.py
// sparse_ray_plan), as for gather_sparse_kernel: one block per (tile,
// split) run, largest first; an empty run writes zeros.
template <bool EXTRAS>
__global__ void __launch_bounds__(T, kBwdMinBlocks<false>)
bwd_rays_sparse(const float* __restrict__ rays,
                const float* __restrict__ staged,
                const float* __restrict__ scalars,
                const int* __restrict__ chunk_of,
                const int* __restrict__ run_start,
                const int* __restrict__ order, const float* __restrict__ ct,
                float* __restrict__ partial, int n_tiles) {
  const SparseRun run = sparse_run(order, run_start, n_tiles);
  if (run.k0 == run.k1) {
    const float zero[NDR] = {};
    write_partial<NDR>(partial, zero, run.tile, run.split, n_tiles);
    return;
  }
  const ListedChunks walk{chunk_of, run.k1, scalars[3]};
  d_rays_sweep<EXTRAS, false, false>(rays, staged, scalars, ct, walk, run.k0,
                              [&](int k) { return walk.chunk(k); }, run.tile,
                              run.split, n_tiles, partial);
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

// The two-pass form of beams_sweep_tile (_bwd_beams_kernel,
// pallas_gather_bwd.py:741-772): the extras always on, p_at and tr_cam as
// two exps, dp/dps and dp/dpe divided per pair; the tile's sums over rays
// are added once (d radius: the three channels' sums, in channel order).
__device__ __forceinline__ void beams_sweep_tile_twopass(const RayTile& s,
                                                         const Beam& bm,
                                                         float inv_min_sin,
                                                         float acc[NBC]) {
  float sum_ps[3] = {0.0f, 0.0f, 0.0f}, sum_pe[3] = {0.0f, 0.0f, 0.0f};
  float sum_rad[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll 2
  for (int i = 0; i < T; ++i) {
    const float a0[3] = {s.a0[0][i], s.a0[1][i], s.a0[2][i]};
    const float d1[3] = {s.d1[0][i], s.d1[1][i], s.d1[2][i]};
    const PairGeom p = closest_points(a0, d1, s.a[i], s.inv_a[i], bm.b0,
                                      bm.d2, bm.e, bm.inv_e, bm.inv_w);
    if (!(p.r2 < 1.0f)) continue;
    const float dir[3] = {s.dir[0][i], s.dir[1][i], s.dir[2][i]};
    const PairTerms q = pair_terms<true>(cos_theta(dir, bm.d2, bm.ibl),
                                         s.g[i], p.r2, bm.inv_w, inv_min_sin);
    const float w0 = mul(mul(q.base, q.rho), q.k1);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const bool ok = bm.ps[ch] > 0.0f;  // 0 exactly where ps is dead
      const float tr_cam = expf(mul(p.sc, s.lt[ch][i]));
      const float p_at = mul(bm.ps[ch], expf(mul(p.tc, bm.lp[ch])));
      const float dp_dps = ok ? mul(p_at, sub(1.0f, p.tc)) / bm.ps_s[ch] : 0.0f;
      const float dp_dpe =
          mul(ok ? mul(p_at, p.tc) / bm.pe_s[ch] : 0.0f, bm.pe_live[ch]);
      const float coef = mul(mul(s.coef[ch][i], w0), tr_cam);
      sum_ps[ch] = add(sum_ps[ch], mul(coef, dp_dps));
      sum_pe[ch] = add(sum_pe[ch], mul(coef, dp_dpe));
      sum_rad[ch] = add(
          sum_rad[ch],
          mul(mul(mul(mul(mul(s.coef[ch][i], q.base), q.rho), q.dk1_dw), p_at),
              tr_cam));
    }
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    acc[ch] = add(acc[ch], sum_ps[ch]);
    acc[3 + ch] = add(acc[3 + ch], sum_pe[ch]);
  }
  acc[6] = add(acc[6], add(add(sum_rad[0], sum_rad[1]), sum_rad[2]));
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
// pre-pass, through a bulk-copy ring or plain loads.)  TWOPASS: mask is
// the pre-pass's flags; a flagged chunk sweeps every ray tile in the
// two-pass form, an unflagged one writes zeros.
template <bool EXTRAS, bool HETERO, bool TWOPASS = false>
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
  // chunks past n_valid (two-pass: unflagged chunks) add nothing: zeros
  float acc[HETERO ? NBC_HET : NBC] = {};
  const bool live = TWOPASS ? __ldg(mask + chunk) > 0.0f
                            : static_cast<float>(chunk * C) < scalars[3];
  if (live) {
    const auto bm = load_beam_any<HETERO>(
        beams + static_cast<size_t>(chunk) * nb * C, threadIdx.x, scalars[0]);
    for (int i = 0; i < n_tiles; ++i) {
      if (!TWOPASS && !(__ldg(mrow + i) > 0.0f)) continue;
      stage_tile(rays + static_cast<size_t>(i) * nf * T,
                 ct + static_cast<size_t>(i) * CT_ROWS * T, s, threadIdx.x);
      __syncthreads();
      if constexpr (TWOPASS) {
        beams_sweep_tile_twopass(s, bm, inv_min_sin, acc);
      } else {
        beams_sweep_tile<EXTRAS>(s, bm, inv_min_sin, acc);
      }
      __syncthreads();  // the next tile overwrites s
    }
  }
  write_beams<HETERO>(d_beams, chunk, acc);
}

// The chunk-major list's plan (ops/gather_bwd.py sparse_beam_plan):
// tile_of, each entry's ray tile (-1 for seed and fill entries);
// chunk_start[j] .. chunk_start[j+1], chunk j's run; chunk_order, the chunks
// by listed tiles, largest first, so the longest runs start in the first
// wave.  Block b folds chunk chunk_order[b]'s tiles in ascending order,
// each staged in shared memory by the block itself, exactly as
// bwd_beams_dense folds them, at the dense sweep's resident blocks per SM.
template <bool EXTRAS>
__global__ void __launch_bounds__(T, kBeamsMinBlocks<EXTRAS, false>)
bwd_beams_sparse(const float* __restrict__ rays,
                 const float* __restrict__ beams,
                 const float* __restrict__ scalars,
                 const int* __restrict__ tile_of,
                 const int* __restrict__ chunk_start,
                 const int* __restrict__ chunk_order,
                 const float* __restrict__ ct, float* __restrict__ d_beams) {
  __shared__ RayTile s;
  const int chunk = __ldg(chunk_order + blockIdx.x);
  float acc[NBC] = {};
  if (static_cast<float>(chunk * C) < scalars[3]) {
    const Beam bm = load_beam(beams + static_cast<size_t>(chunk) * NB * C,
                              threadIdx.x, scalars[0]);
    const float inv_min_sin = 1.0f / scalars[2];
    const int k1 = __ldg(chunk_start + chunk + 1);
    for (int k = __ldg(chunk_start + chunk); k < k1; ++k) {
      const int tile = __ldg(tile_of + k);
      if (tile < 0) continue;  // the seed entry
      stage_tile(rays + static_cast<size_t>(tile) * NF * T,
                 ct + static_cast<size_t>(tile) * CT_ROWS * T, s,
                 threadIdx.x);
      __syncthreads();
      beams_sweep_tile<EXTRAS>(s, bm, inv_min_sin, acc);
      __syncthreads();  // the next tile overwrites s
    }
  }
  write_beams<false>(d_beams, chunk, acc);
}

// ---- the two-pass backward's pre-pass (Queue 2 row 6) ------------------

// flags[j] = 1 where some beam of chunk j has a live start power in some
// channel, else 0; the flagged chunks are staged as stage_beams stages them,
// whatever n_valid says.
__global__ void __launch_bounds__(C)
stage_power_chunks(const float* __restrict__ beams,
                   const float* __restrict__ scalars,
                   float* __restrict__ staged, float* __restrict__ flags) {
  const int j = blockIdx.x;
  const float* chunk = beams + static_cast<size_t>(j) * NB * C;
  const float* ps = chunk + BF_PS * C + threadIdx.x;
  const bool live =
      __syncthreads_or(ps[0] > 1e-20f || ps[C] > 1e-20f || ps[2 * C] > 1e-20f);
  if (threadIdx.x == 0) flags[j] = live ? 1.0f : 0.0f;
  if (live)
    stage_chunk(chunk, reinterpret_cast<BeamChunk*>(staged)[j], threadIdx.x,
                scalars[0]);
}

// flags[n_chunks] = 1 + the last flagged chunk (0 if none), exact as a float
// (n_chunks < 2^24: _check_packed's int32 offsets).  One block of
// kExtentThreads, a maximum over threads: no atomics.
constexpr int kExtentThreads = 1024;

__global__ void __launch_bounds__(kExtentThreads)
flagged_extent(float* __restrict__ flags, int n_chunks) {
  __shared__ int warp_hi[kExtentThreads / 32];
  int hi = 0;
  for (int j = threadIdx.x; j < n_chunks; j += kExtentThreads)
    if (flags[j] > 0.0f) hi = j + 1;
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((threadIdx.x & 31) == 0) warp_hi[threadIdx.x >> 5] = hi;
  __syncthreads();
  if (threadIdx.x < 32) {
    hi = __reduce_max_sync(0xffffffffu, warp_hi[threadIdx.x]);
    if (threadIdx.x == 0) flags[n_chunks] = static_cast<float>(hi);
  }
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

// stage_beams, the d_rays sweep over the tile-major list's runs,
// reduce_splits, the d_beams sweep over the chunk-major list.
template <bool EXTRAS>
int launch_sparse(const float* rays, const float* beams,
                  const float* scalars, const float* ct, const int* chunk_of,
                  const int* run_start, const int* run_order,
                  const int* tile_of, const int* chunk_start,
                  const int* chunk_order, float* staged_beams, float* partial,
                  float* d_rays, float* d_beams, int n_tiles, int n_chunks,
                  int n_splits, cudaStream_t stream) {
  stage_beams<false><<<n_chunks, C, 0, stream>>>(beams, scalars, staged_beams);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem_r = ring_smem_bytes<BeamChunk>();
  bwd_rays_sparse<EXTRAS><<<n_tiles * n_splits, T, smem_r, stream>>>(
      rays, staged_beams, scalars, chunk_of, run_start, run_order, ct,
      partial, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  reduce_splits<<<dim3(n_tiles, NDR), T, 0, stream>>>(
      partial, d_rays, n_splits, n_tiles, NDR, NDR);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_beams_sparse<EXTRAS><<<n_chunks, T, 0, stream>>>(
      rays, beams, scalars, tile_of, chunk_start, chunk_order, ct, d_beams);
  return static_cast<int>(cudaGetLastError());
}

// The two-pass backward: stage_power_chunks, flagged_extent, the d_rays
// sweep over the flagged chunks on the (n_tiles, n_splits) grid,
// reduce_splits, the d_beams sweep.
int launch_twopass(const float* rays, const float* beams, const float* scalars,
                   const float* ct, float* staged_beams, float* flags,
                   float* partial, float* d_rays, float* d_beams, int n_tiles,
                   int n_chunks, int n_splits, cudaStream_t stream) {
  stage_power_chunks<<<n_chunks, C, 0, stream>>>(beams, scalars, staged_beams,
                                                 flags);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flagged_extent<<<1, kExtentThreads, 0, stream>>>(flags, n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_rays_dense<true, false, true>
      <<<dim3(n_tiles, n_splits), T, ring_smem_bytes<BeamChunk>(), stream>>>(
          rays, staged_beams, scalars, flags, ct, partial, n_tiles, n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  reduce_splits<<<dim3(n_tiles, NDR), T, 0, stream>>>(
      partial, d_rays, n_splits, n_tiles, NDR, NDR);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_beams_dense<true, false, true><<<n_chunks, T, 0, stream>>>(
      rays, beams, scalars, flags, ct, d_beams, n_tiles);
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

// chunk_of, run_start, run_order: the tile-major list's plan
// (ops/gather.py sparse_ray_plan); tile_of, chunk_start, chunk_order: the
// chunk-major list's (ops/gather_bwd.py sparse_beam_plan); all int32.
// staged_beams and partial as above.
int bre_gather_backward_sparse(const float* rays, const float* beams,
                               const float* scalars, const float* ct,
                               const int* chunk_of, const int* run_start,
                               const int* run_order, const int* tile_of,
                               const int* chunk_start, const int* chunk_order,
                               float* staged_beams, float* partial,
                               float* d_rays, float* d_beams, int n_tiles,
                               int n_chunks, int n_splits, int want_extras,
                               cudaStream_t stream) {
  auto* f = want_extras ? &launch_sparse<true> : &launch_sparse<false>;
  return f(rays, beams, scalars, ct, chunk_of, run_start, run_order, tile_of,
           chunk_start, chunk_order, staged_beams, partial, d_rays, d_beams,
           n_tiles, n_chunks, n_splits, stream);
}

// scalars: cam_radius, power_scale (folded into sigma_s), min_sin; a fourth
// entry (n_valid) is not read.  ct: (n_tiles, 8, T); d_rays: (n_tiles, 8,
// T); d_beams: (n_chunks, NB, C).  staged_beams (n_chunks, 16, C), flags
// (n_chunks + 1,) and partial (n_splits, n_tiles, 8, T): scratch.
int bre_gather_backward_twopass(const float* rays, const float* beams,
                                const float* scalars, const float* ct,
                                float* staged_beams, float* flags,
                                float* partial, float* d_rays, float* d_beams,
                                int n_tiles, int n_chunks, int n_splits,
                                cudaStream_t stream) {
  return launch_twopass(rays, beams, scalars, ct, staged_beams, flags,
                        partial, d_rays, d_beams, n_tiles, n_chunks, n_splits,
                        stream);
}

}  // extern "C"
