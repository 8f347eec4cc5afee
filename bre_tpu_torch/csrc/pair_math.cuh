// Device code shared by the gather kernels (beam_gather_fwd.cu,
// beam_gather_bwd.cu): the packed layouts of ops/gather.py, explicitly
// rounded arithmetic, one ray and one beam with their derived terms, the
// grid-media (heterogeneous) tables, and the pair geometry.  The geometry
// decides whether a (ray, beam) pair counts at all, so every kernel computes
// it with these functions, rounding for rounding as the plain versions in
// ops/gather.py do.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int T = 256;   // rays per tile == threads per block
constexpr int C = 256;   // beams per chunk
constexpr int NF = 18;   // packed ray rows (ops/gather.py RF_*)
constexpr int NB = 16;   // packed beam fields (ops/gather.py BF_*)

constexpr int RF_A0 = 0, RF_A1 = 3, RF_DIR = 6, RF_TR = 10, RF_SIGS = 13,
              RF_G = 16;
constexpr int BF_B0 = 0, BF_B1 = 3, BF_PS = 6, BF_PE = 9, BF_RAD = 12;

// Heterogeneous extension (ops/gather.py): per segment, D(f) (5
// coefficients, no constant term) and dens(f) (6) polynomials and the
// medium's sigma_t; tau_ch(f) = sigma_t[ch] * D(f).
constexpr int D_COEFS = 5, DENS_COEFS = 6;
constexpr int NF_HET = 32, NB_HET = 24;
constexpr int RF_DC = 18, RF_SIGTC = 23, RF_DENSC = 26;
constexpr int BF_DP = 16, BF_SIGT = 21;

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// Explicitly rounded products and sums: never contracted into an FMA.  The
// closest-point solve cancels catastrophically for near-parallel pairs
// (a*e - b*b), so one extra rounding step there moves s and t far; rounding
// every step as the plain version does keeps the kernels within float ulps
// of it on every pair instead of within the problem's conditioning.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dot3(float x0, float x1, float x2, float y0,
                                      float y1, float y2) {
  return add(add(mul(x0, y0), mul(x1, y1)), mul(x2, y2));
}

// One camera segment (ray) and its per-ray terms.
struct Ray {
  float a0[3], d1[3], dir[3], lt[3], sigs[3];
  float a, inv_a, g;
};

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

// One photon beam and its per-beam terms: the divides, rsqrt and logs a
// pair would otherwise repeat.  The power terms carry the reference's
// where-isolation (_log_decay, pallas_gather.py:94-102; the gates of
// _bwd_fused_body, pallas_gather_bwd.py:207-222): dead powers
// (ps <= 1e-20) form no inf or NaN.
struct Beam {
  float b0[3], d2[3];
  float e, inv_e, inv_w;
  float ibl;        // 1/|d2|
  float ps[3];      // start power, 0 where dead
  float lp[3];      // log(pe_s/ps_s), 0 where dead
  float ps_s[3];    // safe start power (1 where dead)
  float pe_s[3];    // safe end power, floored at 1e-12 ps_s (1 where dead)
  float pe_live[3]; // 1 where pe is above the floor
};

// The geometry terms of beam `lane` of a chunk, into any beam struct with
// the fields b0, d2, e, inv_e, inv_w, ibl.
template <class B>
__device__ void load_beam_geom(const float* __restrict__ chunk, int lane,
                               float cam_radius, B& b) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    b.b0[c] = chunk[(BF_B0 + c) * C + lane];
    b.d2[c] = sub(chunk[(BF_B1 + c) * C + lane], b.b0[c]);
  }
  b.e = dot3(b.d2[0], b.d2[1], b.d2[2], b.d2[0], b.d2[1], b.d2[2]);
  b.inv_e = b.e > 1e-12f ? 1.0f / b.e : 0.0f;
  b.inv_w = 1.0f / fmaxf(add(cam_radius, chunk[BF_RAD * C + lane]), 1e-30f);
  b.ibl = rsqrtf(fmaxf(b.e, 1e-30f));
}

__device__ Beam load_beam(const float* __restrict__ chunk, int lane,
                          float cam_radius) {
  Beam b;
  load_beam_geom(chunk, lane, cam_radius, b);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float ps = chunk[(BF_PS + c) * C + lane];
    const float pe = chunk[(BF_PE + c) * C + lane];
    const bool ok = ps > 1e-20f;
    b.ps_s[c] = ok ? ps : 1.0f;
    b.pe_s[c] = ok ? fmaxf(pe, mul(1e-12f, ps)) : 1.0f;
    b.ps[c] = ok ? ps : 0.0f;
    b.lp[c] = ok ? logf(b.pe_s[c] / ps) : 0.0f;
    b.pe_live[c] = pe > mul(1e-12f, b.ps_s[c]) ? 1.0f : 0.0f;
  }
  return b;
}

// One staged beam chunk with its per-beam terms, field-major; every thread
// of a block then reads the same beam at once (a shared-memory broadcast).
struct BeamChunk {
  float b0[3][C];
  float d2[3][C];
  float e[C];
  float inv_e[C];
  float inv_w[C];
  float ibl[C];
  float ps[3][C];
  float lp[3][C];
};

// Thread `lane` stages beam `lane` of one chunk (coalesced field rows).
__device__ void stage_chunk(const float* __restrict__ chunk, BeamChunk& s,
                            int lane, float cam_radius) {
  const Beam b = load_beam(chunk, lane, cam_radius);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.b0[c][lane] = b.b0[c];
    s.d2[c][lane] = b.d2[c];
    s.ps[c][lane] = b.ps[c];
    s.lp[c][lane] = b.lp[c];
  }
  s.e[lane] = b.e;
  s.inv_e[lane] = b.inv_e;
  s.inv_w[lane] = b.inv_w;
  s.ibl[lane] = b.ibl;
}

// One photon beam of a grid medium: the geometry terms, the raw start
// power (the decay rides the tables, so pe is not read) and the tables.
struct BeamHet {
  float b0[3], d2[3];
  float e, inv_e, inv_w, ibl;
  float ps[3];
  float dp[D_COEFS];  // D(f) coefficients
  float sigt[3];      // the beam medium's sigma_t
};

__device__ BeamHet load_beam_het(const float* __restrict__ chunk, int lane,
                                 float cam_radius) {
  BeamHet b;
  load_beam_geom(chunk, lane, cam_radius, b);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    b.ps[c] = chunk[(BF_PS + c) * C + lane];
    b.sigt[c] = chunk[(BF_SIGT + c) * C + lane];
  }
#pragma unroll
  for (int i = 0; i < D_COEFS; ++i) b.dp[i] = chunk[(BF_DP + i) * C + lane];
  return b;
}

// One staged grid-medium beam chunk, field-major (24 KB).
struct BeamChunkHet {
  float b0[3][C];
  float d2[3][C];
  float e[C];
  float inv_e[C];
  float inv_w[C];
  float ibl[C];
  float ps[3][C];
  float dp[D_COEFS][C];
  float sigt[3][C];
};

__device__ void stage_chunk(const float* __restrict__ chunk, BeamChunkHet& s,
                            int lane, float cam_radius) {
  const BeamHet b = load_beam_het(chunk, lane, cam_radius);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.b0[c][lane] = b.b0[c];
    s.d2[c][lane] = b.d2[c];
    s.ps[c][lane] = b.ps[c];
    s.sigt[c][lane] = b.sigt[c];
  }
#pragma unroll
  for (int i = 0; i < D_COEFS; ++i) s.dp[i][lane] = b.dp[i];
  s.e[lane] = b.e;
  s.inv_e[lane] = b.inv_e;
  s.inv_w[lane] = b.inv_w;
  s.ibl[lane] = b.ibl;
}

// The staged chunk of either instance.
template <bool HETERO>
using ChunkT = typename std::conditional<HETERO, BeamChunkHet, BeamChunk>::type;

// The camera segment's grid-medium tables (rows RF_DC, RF_SIGTC, RF_DENSC).
struct RayTables {
  float dc[D_COEFS];
  float sigtc[3];
  float densc[DENS_COEFS];
};

__device__ RayTables load_ray_tables(const float* __restrict__ tile_rows,
                                     int lane) {
  RayTables t;
#pragma unroll
  for (int i = 0; i < D_COEFS; ++i) t.dc[i] = tile_rows[(RF_DC + i) * T + lane];
#pragma unroll
  for (int c = 0; c < 3; ++c) t.sigtc[c] = tile_rows[(RF_SIGTC + c) * T + lane];
#pragma unroll
  for (int i = 0; i < DENS_COEFS; ++i)
    t.densc[i] = tile_rows[(RF_DENSC + i) * T + lane];
  return t;
}

// Horner evaluations of the tables at fraction f, before their clamps at 0,
// in the plain version's order (ops/gather.py hetero_tables_ref):
// dens(f) = e0 + f (e1 + f (...)), D(f) = f (c1 + f (c2 + ...)).  Rounded
// step by step like the geometry; Horner is well conditioned, so this
// costs only the unfused multiply-adds.
__device__ __forceinline__ float horner_dens(const float e[DENS_COEFS],
                                             float f) {
  float acc = e[DENS_COEFS - 1];
#pragma unroll
  for (int k = DENS_COEFS - 2; k >= 0; --k) acc = add(e[k], mul(f, acc));
  return acc;
}

__device__ __forceinline__ float horner_D(const float c[D_COEFS], float f) {
  float acc = c[D_COEFS - 1];
#pragma unroll
  for (int k = D_COEFS - 2; k >= 0; --k) acc = add(c[k], mul(f, acc));
  return mul(f, acc);
}

// exp(-tau) for one channel, tau = sigma_t_b D_b + sigma_t_c D_c.
__device__ __forceinline__ float het_decay(float sigt_b, float Db,
                                           float sigt_c, float Dc) {
  return expf(-add(mul(sigt_b, Db), mul(sigt_c, Dc)));
}

struct PairGeom {
  float sc;  // closest point's fraction along the camera segment
  float tc;  // ... and along the beam
  float r2;  // squared distance over the squared blur width
};

// Ericson 5.1.9 segment-segment closest points and r^2, in the plain
// version's operation order (ops/gather.py pair_geometry_ref).
__device__ __forceinline__ PairGeom closest_points(
    const float a0[3], const float d1[3], float a, float inv_a,
    const float b0[3], const float d2[3], float e, float inv_e, float inv_w) {
  const float rr0 = sub(a0[0], b0[0]), rr1 = sub(a0[1], b0[1]),
              rr2 = sub(a0[2], b0[2]);
  const float b = dot3(d1[0], d1[1], d1[2], d2[0], d2[1], d2[2]);
  const float c_ = dot3(d1[0], d1[1], d1[2], rr0, rr1, rr2);
  const float f = dot3(d2[0], d2[1], d2[2], rr0, rr1, rr2);
  const float denom = sub(mul(a, e), mul(b, b));
  float sc = denom > 1e-12f ? sub(mul(b, f), mul(c_, e)) / denom : 0.0f;
  sc = clip01(sc);
  const float t = mul(add(mul(b, sc), f), inv_e);
  const float tc = clip01(t);
  if (t != tc && a > 1e-12f) sc = clip01(mul(sub(mul(tc, b), c_), inv_a));
  const float dx = sub(add(a0[0], mul(d1[0], sc)), add(b0[0], mul(d2[0], tc)));
  const float dy = sub(add(a0[1], mul(d1[1], sc)), add(b0[1], mul(d2[1], tc)));
  const float dz = sub(add(a0[2], mul(d1[2], sc)), add(b0[2], mul(d2[2], tc)));
  return {sc, tc, mul(dot3(dx, dy, dz, dx, dy, dz), mul(inv_w, inv_w))};
}

// cos(theta) between the camera segment and the beam.
__device__ __forceinline__ float cos_theta(const float dir[3],
                                           const float d2[3], float ibl) {
  return dot3(dir[0], dir[1], dir[2], mul(d2[0], ibl), mul(d2[1], ibl),
              mul(d2[2], ibl));
}

}  // namespace
