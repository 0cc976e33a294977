// Device code shared by the spectral MCM forward (mcm_spectral.cu) and the
// packed-adjoint backward (spectral_backward.cu): the parameter block, the
// hash chain and draws, the packed-table lookups, and one Woodcock step.
//
// Both kernels run the SAME step function, so the taped forward of the
// backward leaves a state bit-identical to the forward step kernel's: the
// tape is an optional per-step record (REC = true) that only adds stores.
// The forward's other modes are compile-time parameters too (MAJ: the
// super-voxel majorant, ENV: the environment map, XY: the xy half-packed
// volume, RAW: raw or partly packed tables), so the default instantiation
// compiles to the code it had before they existed; the quasicubic weight
// warp is a uniform runtime flag (I_QUASICUBIC), and so are the table kinds
// inside the RAW instantiation (I_VOL_RAW, I_NEAREST, I_TF_KIND,
// I_LIGHT_KIND, I_ENV_RAW).
//
// Numerics (see mcm_spectral.cu): built without fast math and with
// -fmad=false; every quotient equals the IEEE one and every sqrt is IEEE;
// accurate logf/sinf/cosf; min/max propagate NaN like jnp/torch. Where
// several quotients share a divisor (a u8 code over 255, the deposit over
// the sample count, the flight over the extinction, a ray point over its
// w, the slab test over a direction component) the step takes one
// correctly rounded reciprocal and corrects each product with two
// explicit FMAs (Markstein's theorem): the IEEE quotient whenever the
// operands lie in [2^-60, 2^60] (or the numerator is zero); outside that
// range it divides. tests/test_torch_step_identities.py checks each
// identity in numpy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_BINS 32

// threads per block of the step kernels (K1 step_kernel, K4
// tape_forward_kernel). Their __launch_bounds__ ask ptxas to fit 10 (K1)
// and 8 (K4) such blocks on one SM, which caps their registers at 48 and
// 64. A sweep of geometries (PERF.md) found K4 faster at 64 registers than
// uncapped (91), and K1 flat within its run-to-run spread from 40 to 64
// registers and from 64- to 256-thread blocks.
#define STEP_THREADS 128

namespace {

// parameter block layout, mirrored by vpt_tpu_torch/kernels/mcm_spectral.py
enum FParam {
  F_INV_MVP = 0,   // 16 floats, row-major
  F_EXTINCTION = 16,
  F_BLUR = 17,
  F_INV_RES = 18,
  F_LDX = 19, F_LDY = 20, F_LDZ = 21,  // normalized light direction
  F_LAM_LO = 22,
  F_LAM_SPAN = 23,
  F_BOUNDARIES = 24,  // MAX_BINS + 1 floats
  F_COUNT = 24 + MAX_BINS + 1,
};
enum IParam {
  I_ISOTROPIC = 0, I_N_BINS, I_MAX_BOUNCES, I_STEPS, I_N_SEEDS, I_STREAMS,
  I_RES, I_VOL_U8, I_VOL_D, I_VOL_H, I_VOL_W, I_TF_H, I_TF_W, I_N_LANES,
  I_QUASICUBIC,                  // 1: smoothstep-warped trilinear weights
  I_MAJ_GZ, I_MAJ_GY, I_MAJ_GX,  // majorant grid cells (0 without one)
  I_ENV_H, I_ENV_W,              // packed env table dims He+1, We+1
  I_VOL_XY,                      // 1: an xy half-packed (rows, 4) volume table (selects XY)
  // the raw-table kinds, read only by the RAW instantiations. A raw table
  // of n texels along an axis gives that axis as n + 1, as a packed table
  // of the same texture would, so both address it by base_frac(t, n).
  I_RAW,         // 1: some table is raw or partly packed (selects RAW)
  I_VOL_RAW,     // 1: a raw (D, H, W) f32 grid; I_VOL_D/H/W hold D+1, H+1, W+1
  I_NEAREST,     // 1: the nearest filter (raw grid only)
  I_TF_KIND,     // TF_FUSED (257, 257, 18), TF_RAW (H, W, 4), TF_PACKED (Hp, Wp, 16)
  I_LIGHT_KIND,  // LIGHT_FUSED (in the TF rows), LIGHT_RAW (N,), LIGHT_PAIR (N+1, 2)
  I_LIGHT_N,     // N, the light's texels
  I_ENV_RAW,     // 1: a raw (He, We, 3) map; I_ENV_H/W hold He+1, We+1
  I_COUNT,
};
enum TfKind { TF_FUSED = 0, TF_RAW = 1, TF_PACKED = 2 };
enum LightKind { LIGHT_FUSED = 0, LIGHT_RAW = 1, LIGHT_PAIR = 2 };

struct Params {
  float f[F_COUNT];
  int i[I_COUNT];
};

constexpr float kInvU32Max = 0x1p-32f;  // f32(1) / f32(0xFFFFFFFF)
constexpr float kTwoPi = 6.28318530718f;
constexpr float kEps = 1e-5f;
constexpr float kIntLimit = 2147483520.0f;  // 2^31 - 128, exact in f32
constexpr float kInvPi = 0x1.45f306p-2f;  // f32(1 / pi), rounded once
constexpr float kEnvGain = 2.7f;
// operand range in which the reciprocal-and-correction quotient is exact
constexpr float kDivLo = 0x1p-60f;
constexpr float kDivHi = 0x1p60f;
constexpr float kInv255 = 0x1.010102p-8f;  // RN(1 / 255)

// A divisor b shared by several quotients with its correctly rounded
// reciprocal y, and whether b lies in the exact range.
struct Recip {
  float b, y;
  bool ok;
};

__device__ __forceinline__ Recip recip(float b) {
  Recip R;
  R.b = b;
  R.y = __frcp_rn(b);
  R.ok = fabsf(b) >= kDivLo && fabsf(b) <= kDivHi;  // false for NaN
  return R;
}

// Markstein's correction of q = RN(a * y): r = a - b*q is exact, and
// RN(q + r*y) is the IEEE quotient for operands in the exact range. A zero
// numerator keeps q, whose sign is IEEE's (sign(a) ^ sign(b)).
__device__ __forceinline__ float quot_fast(float a, float b, float y) {
  const float q = __fmul_rn(a, y);
  const float r = __fmaf_rn(-b, q, a);
  return (a == 0.0f) ? q : __fmaf_rn(r, y, q);
}

__device__ __forceinline__ bool quot_range(float a) {
  return a == 0.0f || (fabsf(a) >= kDivLo && fabsf(a) <= kDivHi);
}

// a / R.b, equal to the IEEE quotient for every a
__device__ __forceinline__ float quot(float a, const Recip& R) {
  if (R.ok && quot_range(a)) return quot_fast(a, R.b, R.y);
  return __fdiv_rn(a, R.b);
}

// byte k (0..3) of `word` as float(code) / 255, exactly: the code placed
// in the low mantissa bits of 2^23 minus 2^23 is float(code), and every
// code over 255 is exact by the correction (all 256 are tested)
__device__ __forceinline__ float u8_unit(uint32_t word, int k) {
  const float v = __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440u + k)) - 8388608.0f;
  return quot_fast(v, 255.0f, kInv255);
}

__device__ __forceinline__ uint32_t pcg_hash(uint32_t x) {
  x = x * 747796405u + 2891336453u;
  x = ((x >> ((x >> 28u) + 4u)) ^ x) * 277803737u;
  return (x >> 22u) ^ x;
}

__device__ __forceinline__ uint32_t hash3(uint32_t x, uint32_t y, uint32_t z) {
  return pcg_hash(19u * x + 47u * y + 101u * z + 131u);
}

__device__ __forceinline__ float uniform_from_state(uint32_t s) {
  return __uint2float_rn(s) * kInvU32Max;
}

__device__ __forceinline__ float draw(uint32_t& s) {
  s = pcg_hash(s);
  return uniform_from_state(s);
}

// NaN-propagating min/max (fminf/fmaxf return the non-NaN operand)
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// normalized coord -> clamped row index into the padded table + frac
__device__ __forceinline__ void base_frac(float t, int n, int& b, float& frac) {
  float s = t * (float)n - 0.5f;
  float i0 = floorf(s);
  frac = s - i0;
  float c = (i0 != i0) ? 0.0f : fminf(fmaxf(i0, -kIntLimit), kIntLimit);
  int i = (int)c + 1;
  b = min(max(i, 0), n);
}

__device__ __forceinline__ float lerp(float a, float b, float f) {
  return a + (b - a) * f;
}

// where a trilinear lookup read: its corner row (full table), or the rows
// of its z0 and z1 planes (xy table), and fractions (warped under the
// quasicubic filter)
struct VolAddr {
  int row, row1;
  float fx, fy, fz;
};

// smoothstep weight warp of the quasicubic filter, f*f*(3 - 2f)
__device__ __forceinline__ float quasicubic(float f) {
  return f * f * (3.0f - 2.0f * f);
}

// The addressing of a packed volume lookup (interp.volume_rows): the base
// row(s) and the unwarped fractions. Full table (xy false): padded dims
// (Dp, Hp, Wp), one 8-wide row, row1 == row. xy table: dims (D, Hp, Wp),
// the 4-wide rows of planes z0 = clamp(i, 0, D-1) and z1 = clamp(i+1, 0,
// D-1), from the padded index b = clamp(i + 1, 0, D) as max(b - 1, 0) and
// min(b, D - 1).
__device__ __forceinline__ void volume_rows(bool xy, int D0, int Hp, int Wp, float u,
                                            float v, float w, int64_t& row, int64_t& row1,
                                            float& fx, float& fy, float& fz) {
  int bx, by, bz;
  base_frac(u, Wp - 1, bx, fx);
  base_frac(v, Hp - 1, by, fy);
  base_frac(w, xy ? D0 : D0 - 1, bz, fz);
  if (xy) {
    const int64_t plane = (int64_t)by * Wp + bx, hw = (int64_t)Hp * Wp;
    row = (int64_t)max(bz - 1, 0) * hw + plane;
    row1 = (int64_t)min(bz, D0 - 1) * hw + plane;
  } else {
    row = ((int64_t)bz * Hp + by) * Wp + bx;
    row1 = row;
  }
}

// The 8 corners of a lookup, dequantized: one 8-wide row of a full table
// (one 8-byte u8 load or two float4), or the two 4-wide plane rows of an xy
// table (two 4-byte u8 loads or two float4); the same values in the same
// order either way, so an xy lookup equals the full one bit for bit.
__device__ __forceinline__ void volume_corners(const void* table, int is_u8, bool xy,
                                               int64_t row, int64_t row1, float c[8]) {
  const int64_t e0 = xy ? row * 4 : row * 8, e1 = xy ? row1 * 4 : row * 8 + 4;
  if (is_u8) {
    const uint8_t* t = static_cast<const uint8_t*>(table);
    uint32_t w0, w1;
    if (xy) {
      w0 = __ldg(reinterpret_cast<const uint32_t*>(t + e0));
      w1 = __ldg(reinterpret_cast<const uint32_t*>(t + e1));
    } else {
      const uint2 raw = __ldg(reinterpret_cast<const uint2*>(t + e0));
      w0 = raw.x;
      w1 = raw.y;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[k] = u8_unit(w0, k);
      c[4 + k] = u8_unit(w1, k);
    }
  } else {
    const float* t = static_cast<const float*>(table);
    const float4 a = __ldg(reinterpret_cast<const float4*>(t + e0));
    const float4 b = __ldg(reinterpret_cast<const float4*>(t + e1));
    c[0] = a.x; c[1] = a.y; c[2] = a.z; c[3] = a.w;
    c[4] = b.x; c[5] = b.y; c[6] = b.z; c[7] = b.w;
  }
}

// trilinear (or, with qc, quasicubic) sample of a flat packed volume table:
// (rows, 8) at padded dims (Dp, Hp, Wp), or with xy (rows, 4) at (D, Hp, Wp)
__device__ __forceinline__ float sample_volume(const void* table, int is_u8,
                                               int D0, int Hp, int Wp, float u,
                                               float v, float w, VolAddr* addr,
                                               bool qc = false, bool xy = false) {
  int64_t row, row1;
  float fx, fy, fz;
  volume_rows(xy, D0, Hp, Wp, u, v, w, row, row1, fx, fy, fz);
  if (qc) {
    fx = quasicubic(fx);
    fy = quasicubic(fy);
    fz = quasicubic(fz);
  }
  if (addr != nullptr) {
    addr->row = (int)row;
    addr->row1 = (int)row1;
    addr->fx = fx; addr->fy = fy; addr->fz = fz;
  }
  float c[8];
  volume_corners(table, is_u8, xy, row, row1, c);
  const float c00 = lerp(c[0], c[1], fx);
  const float c01 = lerp(c[2], c[3], fx);
  const float c10 = lerp(c[4], c[5], fx);
  const float c11 = lerp(c[6], c[7], fx);
  const float c0 = lerp(c00, c01, fy);
  const float c1 = lerp(c10, c11, fy);
  return lerp(c0, c1, fz);
}

// a raw axis of n = np1 - 1 texels: the two clamped texels and the frac
// of a normalized coordinate (JAX _coords), from the padded-table index b
// of base_frac as clamp(i, 0, n-1) = max(b - 1, 0) and clamp(i + 1, 0,
// n-1) = min(b, n - 1): the frac and the corner values of the packed
// lookup, so a raw lookup equals it bit for bit
__device__ __forceinline__ void raw_axis(float t, int np1, int& i0, int& i1, float& frac) {
  int b;
  base_frac(t, np1 - 1, b, frac);
  i0 = max(b - 1, 0);
  i1 = min(b, np1 - 2);
}

// an integral float as int, saturating (NaN -> 0) as XLA's f32 -> i32 does
__device__ __forceinline__ int sat_int(float c) {
  return (int)((c != c) ? 0.0f : fminf(fmaxf(c, -kIntLimit), kIntLimit));
}

// clip(int(floor(p * n)), 0, n - 1): a nearest lookup's texel, a majorant
// grid cell along one axis from the pre-step position
__device__ __forceinline__ int floor_cell(float p, int n) {
  return min(max(sat_int(floorf(p * (float)n)), 0), n - 1);
}

// sample of a raw (D, H, W) f32 grid given as (Dp, Hp, Wp) = (D+1, H+1,
// W+1): the nearest voxel (1 scalar load), or 8 scalar corner loads lerped
// as the packed row's corners (quasicubic: the warped fractions)
__device__ __forceinline__ float sample_volume_raw(const float* __restrict__ g, int Dp, int Hp,
                                                   int Wp, float u, float v, float w, bool qc,
                                                   bool nearest) {
  const int D = Dp - 1, H = Hp - 1, W = Wp - 1;
  if (nearest) {
    const int x = floor_cell(u, W), y = floor_cell(v, H), z = floor_cell(w, D);
    return __ldg(g + ((int64_t)z * H + y) * W + x);
  }
  int x0, x1, y0, y1, z0, z1;
  float fx, fy, fz;
  raw_axis(u, Wp, x0, x1, fx);
  raw_axis(v, Hp, y0, y1, fy);
  raw_axis(w, Dp, z0, z1, fz);
  if (qc) {
    fx = quasicubic(fx);
    fy = quasicubic(fy);
    fz = quasicubic(fz);
  }
  const int64_t p00 = ((int64_t)z0 * H + y0) * W, p01 = ((int64_t)z0 * H + y1) * W;
  const int64_t p10 = ((int64_t)z1 * H + y0) * W, p11 = ((int64_t)z1 * H + y1) * W;
  const float c00 = lerp(__ldg(g + p00 + x0), __ldg(g + p00 + x1), fx);
  const float c01 = lerp(__ldg(g + p01 + x0), __ldg(g + p01 + x1), fx);
  const float c10 = lerp(__ldg(g + p10 + x0), __ldg(g + p10 + x1), fx);
  const float c11 = lerp(__ldg(g + p11 + x0), __ldg(g + p11 + x1), fx);
  const float c0 = lerp(c00, c01, fy);
  const float c1 = lerp(c10, c11, fy);
  return lerp(c0, c1, fz);
}

// the volume lookup of the RAW instantiations: the raw grid, or a packed
// table (full or xy) read as the default instantiations read it
__device__ __forceinline__ float sample_volume_any(const void* vol, const Params& P, float u,
                                                   float v, float w) {
  if (P.i[I_VOL_RAW] != 0)
    return sample_volume_raw(static_cast<const float*>(vol), P.i[I_VOL_D], P.i[I_VOL_H],
                             P.i[I_VOL_W], u, v, w, P.i[I_QUASICUBIC] != 0, P.i[I_NEAREST] != 0);
  return sample_volume(vol, P.i[I_VOL_U8], P.i[I_VOL_D], P.i[I_VOL_H], P.i[I_VOL_W], u, v, w,
                       nullptr, P.i[I_QUASICUBIC] != 0, P.i[I_VOL_XY] != 0);
}

// where a TF lookup read: its row, fractions, and the per-channel slope
// d(value)/d(density coordinate) = (x-lerped row1 - row0) * (Hp - 1)
struct TfAddr {
  int row;
  float fx, fy;
  float slope[3];
};

// the TF's wavelength coordinate (lam - 400) / 300 as its column bx and
// fraction fx: it changes only when a lane respawns, so the lane holds it
__device__ __forceinline__ void wavelength_coord(float lam, int Wp, int& bx, float& fx) {
  base_frac((lam - 400.0f) / 300.0f, Wp - 1, bx, fx);
}

// channels 0..2 of one corner of a fused TF row: a 16-byte-aligned slot
// (rows start at multiples of 72 B, corners at 16 B), read as float2 + float
__device__ __forceinline__ float3 tf_corner(const float* p) {
  const float2 a = __ldg(reinterpret_cast<const float2*>(p));
  return make_float3(a.x, a.y, __ldg(p + 2));
}

// bilinear sample of the fused (Hp, Wp, 18) TF+light table at wavelength
// column (bx, fx) and density v: channels 0..2 of the TF, and with
// `light` the light pair lerped by fx alone
__device__ __forceinline__ void sample_tf(const float* tf, int Hp, int Wp, int bx,
                                          float fx, float v, float mat[3],
                                          float* light, TfAddr* addr) {
  int by;
  float fy;
  base_frac(v, Hp - 1, by, fy);
  const float* r = tf + ((int64_t)by * Wp + bx) * 18;
  const float3 k00 = tf_corner(r), k01 = tf_corner(r + 4);
  const float3 k10 = tf_corner(r + 8), k11 = tf_corner(r + 12);
  const float a00[3] = {k00.x, k00.y, k00.z}, a01[3] = {k01.x, k01.y, k01.z};
  const float a10[3] = {k10.x, k10.y, k10.z}, a11[3] = {k11.x, k11.y, k11.z};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float c0 = lerp(a00[c], a01[c], fx);
    const float c1 = lerp(a10[c], a11[c], fx);
    mat[c] = lerp(c0, c1, fy);
    if (addr != nullptr) addr->slope[c] = (c1 - c0) * (float)(Hp - 1);
  }
  if (light != nullptr) {
    const float2 l = __ldg(reinterpret_cast<const float2*>(r + 16));
    *light = lerp(l.x, l.y, fx);
  }
  if (addr != nullptr) {
    addr->row = by * Wp + bx;
    addr->fx = fx;
    addr->fy = fy;
  }
}

// channels 0..2 of the TF at wavelength column (bx, fx) and density v in
// the RAW instantiations, in sample_tf's lerp order: the fused table as
// sample_tf reads it; the 16-wide packed row as four float4 corners; the
// raw (H, W, 4) texture (given as Hp, Wp = H+1, W+1) as four float4 texels
// (16-byte rows), the columns max(bx - 1, 0) and min(bx, W - 1) of the
// raw axis. `slope` (optional): d(value)/d(density coordinate) per channel,
// (x-lerped row1 - row0) * H.
__device__ __forceinline__ void sample_tf_any(const float* tf, int kind, int Hp, int Wp, int bx,
                                              float fx, float v, float mat[3],
                                              float* slope = nullptr) {
  if (kind == TF_FUSED) {
    sample_tf(tf, Hp, Wp, bx, fx, v, mat, nullptr, nullptr);
    return;
  }
  int by;
  float fy;
  base_frac(v, Hp - 1, by, fy);
  float4 k00, k01, k10, k11;
  if (kind == TF_PACKED) {
    const float4* r = reinterpret_cast<const float4*>(tf + ((int64_t)by * Wp + bx) * 16);
    k00 = __ldg(r); k01 = __ldg(r + 1); k10 = __ldg(r + 2); k11 = __ldg(r + 3);
  } else {
    const int W = Wp - 1, x0 = max(bx - 1, 0), x1 = min(bx, W - 1);
    const int y0 = max(by - 1, 0), y1 = min(by, Hp - 2);
    const float4* t = reinterpret_cast<const float4*>(tf);
    k00 = __ldg(t + (int64_t)y0 * W + x0); k01 = __ldg(t + (int64_t)y0 * W + x1);
    k10 = __ldg(t + (int64_t)y1 * W + x0); k11 = __ldg(t + (int64_t)y1 * W + x1);
  }
  const float a00[3] = {k00.x, k00.y, k00.z}, a01[3] = {k01.x, k01.y, k01.z};
  const float a10[3] = {k10.x, k10.y, k10.z}, a11[3] = {k11.x, k11.y, k11.z};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float c0 = lerp(a00[c], a01[c], fx);
    const float c1 = lerp(a10[c], a11[c], fx);
    mat[c] = lerp(c0, c1, fy);
    if (slope != nullptr) slope[c] = (c1 - c0) * (float)(Hp - 1);
  }
}

// the light value at wavelength column (bx, fx): the fused table holds the
// same light pair in every density row (interp.pack_tex2d_with_tex1d
// broadcasts it), so row 0's pair is the pair of any row a lookup reads
__device__ __forceinline__ float sample_light(const float* tf, int bx, float fx) {
  const float2 l = __ldg(reinterpret_cast<const float2*>(tf + (int64_t)bx * 18 + 16));
  return lerp(l.x, l.y, fx);
}

// the light value of wavelength lam in the RAW instantiations: from the
// fused TF (sample_light), or from the light's own table of N texels at
// t = (lam - 400) / 300, a pair row (N+1, 2) or two texels of the raw (N,)
// table (JAX sample_tex1d)
__device__ __forceinline__ float sample_light_any(const float* tf, const float* light,
                                                  const Params& P, int bx, float fx, float lam) {
  const int kind = P.i[I_LIGHT_KIND], n = P.i[I_LIGHT_N];
  if (kind == LIGHT_FUSED) return sample_light(tf, bx, fx);
  const float t = (lam - 400.0f) / 300.0f;
  if (kind == LIGHT_PAIR) {
    int b;
    float f;
    base_frac(t, n, b, f);
    const float2 l = __ldg(reinterpret_cast<const float2*>(light) + b);
    return lerp(l.x, l.y, f);
  }
  int i0, i1;
  float f;
  raw_axis(t, n + 1, i0, i1, f);
  return lerp(__ldg(light + i0), __ldg(light + i1), f);
}

// where an escape's environment lookup read: its 12-wide row, fractions
// and the wavelength's channel (band)
struct EnvAddr {
  int row, band;
  float fx, fy;
};

// the equirect coordinates of a direction: the reference's mapping (y
// quirk kept)
__device__ __forceinline__ void env_coords(float dx, float dy, float dz, float& u, float& v) {
  u = atan2f(dx, -dz) * kInvPi * 0.5f + 0.5f;
  v = asinf(-dy) * 2.0f * kInvPi * 0.5f + 0.5f;
}

// the channel of a wavelength: < 500 nm blue, < 600 green, else red
__device__ __forceinline__ int env_band(float lam) {
  return (lam < 500.0f) ? 2 : ((lam < 600.0f) ? 1 : 0);
}

// escape radiance from a packed (He+1, We+1, 12) equirect map, or with
// `raw` from a raw (He, We, 3) one given as (Hp, Wp) = (He+1, We+1) (12-byte
// texels, scalar loads): the wavelength's channel, gain 2.7. |dy| may
// exceed 1 by an ulp: asinf then gives NaN, which base_frac maps to row 0
// like the plain version, and the NaN frac carries into the value as it
// does there. With `addr` (packed only), records where the lookup read.
__device__ __forceinline__ float sample_environment(const float* env, int Hp,
                                                    int Wp, float dx, float dy,
                                                    float dz, float lam,
                                                    EnvAddr* addr = nullptr,
                                                    bool raw = false) {
  float u, v;
  env_coords(dx, dy, dz, u, v);
  int bx, by;
  float fx, fy;
  base_frac(u, Wp - 1, bx, fx);
  base_frac(v, Hp - 1, by, fy);
  const int c = env_band(lam);
  if (raw) {
    const int W = Wp - 1, x0 = max(bx - 1, 0), x1 = min(bx, W - 1);
    const int64_t r0 = (int64_t)max(by - 1, 0) * W, r1 = (int64_t)min(by, Hp - 2) * W;
    const float c0 = lerp(__ldg(env + (r0 + x0) * 3 + c), __ldg(env + (r0 + x1) * 3 + c), fx);
    const float c1 = lerp(__ldg(env + (r1 + x0) * 3 + c), __ldg(env + (r1 + x1) * 3 + c), fx);
    return lerp(c0, c1, fy) * kEnvGain;
  }
  const float* r = env + ((int64_t)by * Wp + bx) * 12;
  if (addr != nullptr) {
    addr->row = by * Wp + bx;
    addr->band = c;
    addr->fx = fx;
    addr->fy = fy;
  }
  const float c0 = lerp(__ldg(r + c), __ldg(r + 3 + c), fx);
  const float c1 = lerp(__ldg(r + 6 + c), __ldg(r + 9 + c), fx);
  return lerp(c0, c1, fy) * kEnvGain;
}

__device__ __forceinline__ void apply_homogeneous(const float* m, float x,
                                                  float y, float z, float& ox,
                                                  float& oy, float& oz) {
  float r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r[i] = m[4 * i] * x + m[4 * i + 1] * y + m[4 * i + 2] * z + m[4 * i + 3] * 1.0f;
  }
  const Recip w = recip(r[3]);
  ox = quot(r[0], w);
  oy = quot(r[1], w);
  oz = quot(r[2], w);
}

struct Ray {
  float px, py, pz, dx, dy, dz, lam;
  int bin;
};

// a point of the unit disk from the lane's next two draws: the first two
// draws of both a respawn (unprojectRand's lens sample) and an HG scatter
// (sampling.draw_hg's sphere sample), in their order and rounding
__device__ __forceinline__ void draw_disk(uint32_t& s, float& ox, float& oy) {
  const float u1 = draw(s);
  const float u2 = draw(s);
  const float radius = sqrtf(u1);
  const float angle = u2 * kTwoPi;
  ox = radius * cosf(angle);
  oy = radius * sinf(angle);
}

// PhotonSpectral_reset: new camera ray + hero wavelength, from the lens
// disk point (ox, oy) already drawn.
// Draw order: disk(2) + square(2) inside unprojectRand, then wavelength(1).
__device__ Ray respawn_from_disk(uint32_t& s, float ox, float oy, float sx, float sy,
                                 const Params& P) {
  const float* f = P.f;
  const float near_x = sx + ox * f[F_BLUR];
  const float near_y = sy + oy * f[F_BLUR];
  const float ax = draw(s);
  const float ay = draw(s);
  const float far_x = sx + (ax * 2.0f - 1.0f) * f[F_INV_RES];
  const float far_y = sy + (ay * 2.0f - 1.0f) * f[F_INV_RES];
  float fx, fy, fz, tx, ty, tz;
  apply_homogeneous(f + F_INV_MVP, near_x, near_y, -1.0f, fx, fy, fz);
  apply_homogeneous(f + F_INV_MVP, far_x, far_y, 1.0f, tx, ty, tz);
  const float vx = tx - fx, vy = ty - fy, vz = tz - fz;
  // __frcp_rn(x) is 1.0f / x, correctly rounded, for every x
  const float inv = __frcp_rn(sqrtf(vx * vx + vy * vy + vz * vz));
  Ray r;
  r.dx = vx * inv;
  r.dy = vy * inv;
  r.dz = vz * inv;
  const Recip rx = recip(r.dx), ry = recip(r.dy), rz = recip(r.dz);
  const float t0x = quot(0.0f - fx, rx), t0y = quot(0.0f - fy, ry), t0z = quot(0.0f - fz, rz);
  const float t1x = quot(1.0f - fx, rx), t1y = quot(1.0f - fy, ry), t1z = quot(1.0f - fz, rz);
  float tnear = nmax(nmax(nmin(t0x, t1x), nmin(t0y, t1y)), nmin(t0z, t1z));
  tnear = nmax(tnear, 0.0f);
  r.px = fx + tnear * r.dx;
  r.py = fy + tnear * r.dy;
  r.pz = fz + tnear * r.dz;
  const float u = draw(s);
  r.lam = u * f[F_LAM_SPAN] + f[F_LAM_LO];
  int b = 0;
  for (int i = 1; i < P.i[I_N_BINS]; ++i) b += (r.lam >= f[F_BOUNDARIES + i]) ? 1 : 0;
  r.bin = b;
  return r;
}

__device__ __forceinline__ Ray respawn(uint32_t& s, float sx, float sy, const Params& P) {
  float ox, oy;
  draw_disk(s, ox, oy);
  return respawn_from_disk(s, ox, oy, sx, sy, P);
}

// Henyey-Greenstein direction about d from the disk point (kx, ky) already
// drawn (sphere sample + cosine draw where |g| >= EPS), in the order and
// rounding of sampling.draw_hg
__device__ __forceinline__ void draw_hg(uint32_t& s, float kx, float ky, float g,
                                        float& dx, float& dy, float& dz) {
  const float norm = kx * kx + ky * ky;
  const float rr = 2.0f * sqrtf(nmax(1.0f - norm, 0.0f));
  const float ux = rr * kx, uy = rr * ky, uz = 1.0f - 2.0f * norm;
  if (!(fabsf(g) >= kEps)) {
    dx = ux; dy = uy; dz = uz;
    return;
  }
  const float ucos = draw(s);
  const float g2 = g * g;
  const float c = (1.0f - g2) / (1.0f - g + 2.0f * g * ucos);
  const float hgcos = (1.0f + g2 - c * c) / (2.0f * g);
  const float udotd = ux * dx + uy * dy + uz * dz;
  const float cx = ux - udotd * dx;
  const float cy = uy - udotd * dy;
  const float cz = uz - udotd * dz;
  const float cl = cx * cx + cy * cy + cz * cz;
  const float cn = (cl > 0.0f) ? 1.0f / sqrtf(fmaxf(cl, 1e-30f)) : 0.0f;
  const float sn = sqrtf(nmax(1.0f - hgcos * hgcos, 0.0f));
  const float ox = sn * cx * cn + hgcos * dx;
  const float oy = sn * cy * cn + hgcos * dy;
  const float oz = sn * cz * cn + hgcos * dz;
  dx = ox; dy = oy; dz = oz;
}

__device__ __forceinline__ void lane_coords(int lane, int res, uint32_t& ix,
                                            uint32_t& iy, uint32_t& seed_iy,
                                            float inv_res, float& sx, float& sy) {
  const int hw = res * res;
  const int s = lane / hw;
  const int rem = lane - s * hw;
  iy = (uint32_t)(rem / res);
  ix = (uint32_t)(rem - (int)iy * res);
  seed_iy = iy + (uint32_t)s * (uint32_t)res;
  sx = (((float)ix + 0.5f) * inv_res - 0.5f) * 2.0f;
  sy = (((float)iy + 0.5f) * inv_res - 0.5f) * -2.0f;
}

// the lane's pixel: from the lane tables of hit-lane compaction when given
// (lane_ix non-null), else from the (S, H, W) grid
__device__ __forceinline__ void lane_pixel(int lane, const Params& P,
                                           const uint32_t* __restrict__ lane_ix,
                                           const uint32_t* __restrict__ lane_iy,
                                           const uint32_t* __restrict__ lane_seed_iy,
                                           uint32_t& ix, uint32_t& iy,
                                           uint32_t& seed_iy, float& sx, float& sy) {
  if (lane_ix == nullptr) {
    lane_coords(lane, P.i[I_RES], ix, iy, seed_iy, P.f[F_INV_RES], sx, sy);
    return;
  }
  ix = __ldg(lane_ix + lane);
  iy = __ldg(lane_iy + lane);
  seed_iy = __ldg(lane_seed_iy + lane);
  sx = (((float)ix + 0.5f) * P.f[F_INV_RES] - 0.5f) * 2.0f;
  sy = (((float)iy + 0.5f) * P.f[F_INV_RES] - 0.5f) * -2.0f;
}

// One lane's photon state, held in registers across a launch, plus the
// TF column of its wavelength (tbx, tfx), which changes only on respawn.
struct Lane {
  float px, py, pz, dx, dy, dz, lam;
  int bounces, samples, bin;
  int tbx;
  float tfx;
};

// What the packed-adjoint backward needs from one step (the `collect`
// internals of the JAX _render_body, reduced to the taped fields).
struct StepRecord {
  float dist, emitted, alpha, albedo, g, hg_cos, light_w;
  int pre_bin;
  bool respawn, null_event, scatter;
  TfAddr tf;
  VolAddr vol;
  // ENV: the escape's env lookup and its weight 2.7; zero where the lane
  // did not escape
  EnvAddr env;
  float env_w;
};

// What the autodiff surrogate's tape needs from one step (SUR): the events,
// the flight, the lane's chain before its disk draw, the pre-step direction
// and wavelength, the sample position and the local majorant. No lookup
// value: the reverse pass (surrogate.cu) re-derives the material. The raw
// replay backward (raw_backward.cu) reads the same record and the deposit.
struct SurRecord {
  float dist, emitted;
  int pre_bin;
  bool respawn, null_event, scatter, oob, capped;
  uint32_t rng;
  float pdx, pdy, pdz, spx, spy, spz, lam, maj;
};

// Per-launch constants of the step: the extinction as a shared divisor.
struct StepConsts {
  Recip ext;
};

__device__ __forceinline__ StepConsts step_consts(const Params& P) {
  StepConsts C;
  C.ext = recip(P.f[F_EXTINCTION]);
  return C;
}

// incremental one-hot mean over the NB bins: rad += (target - rad) / denom,
// one reciprocal of denom for all bins (each quotient IEEE's; the lane
// divides when a numerator leaves the exact range)
template <int NB>
__device__ __forceinline__ void deposit(float (&rad)[NB], int bin, float emitted, int samples) {
  const float denom = (float)max(samples, 1);
  const Recip d = recip(denom);
  float a[NB];
  bool fast = d.ok;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const float target = (b == bin) ? emitted : 0.0f;
    a[b] = target - rad[b];
    fast = fast && quot_range(a[b]);
  }
  if (fast) {
#pragma unroll
    for (int b = 0; b < NB; ++b) rad[b] = rad[b] + quot_fast(a[b], d.b, d.y);
  } else {
#pragma unroll
    for (int b = 0; b < NB; ++b) rad[b] = rad[b] + __fdiv_rn(a[b], denom);
  }
}

// One Woodcock iteration of one lane (the JAX _render_body): free flight,
// material lookup, event wheel, deposit + respawn or HG scatter. With
// REC, also fills `rec`; the state update is the same either way.
// MAJ: the super-voxel majorant mode (`maj`: the (Gz, Gy, Gx) grid of
// (majorant, flight cap) pairs): the flight samples at the local rate
// extinction * m and stops at the cap, a capped flight is no event, and a
// real event is taken with probability alpha / m. A capped lane inside
// the volume skips both lookups (their values go unused) but still draws
// its wheel, so every later draw of the lane stays in step.
// ENV: escape radiance from the packed environment map `env`.
// XY: the volume is an xy half-packed (rows, 4) table (two plane rows per
// lookup); a template parameter, so the full-table instantiations carry
// no branch and no second row for it.
// RAW: some table is raw or partly packed (the reference's pack_tables
// other than True): the volume a raw (D, H, W) f32 grid (8 scalar gathers,
// 1 for the nearest filter) or a packed table (full or xy, a runtime flag
// here), the TF fused, 16-wide packed or raw (4 float4 texel loads), the
// light from the fused rows or its own raw or pair table, the env map
// packed or raw; each kind a uniform runtime flag (I_VOL_RAW, I_NEAREST,
// I_TF_KIND, I_LIGHT_KIND, I_ENV_RAW) inside the one RAW instantiation,
// so the packed builds carry none of this code. `light`: the light table.
//
// Without REC (the forward) a lane that leaves the volume reads no
// material: its wheel cannot take an event, and its escape light is the
// light pair of its wavelength column (sample_light). With REC the step
// records the full lookup of every lane, as the reference's tape does.
// A lane that respawns or scatters draws its disk point once, before the
// branch (draw_disk: the first two draws of either), so a warp holding
// both kinds runs the sqrt / cos / sin once.
// SUR (without REC): fill `sur`, the surrogate tape's record. The step then
// looks up the material under the forward's own condition and records no
// lookup, so a surrogate step costs K1's step and the record's stores. The
// surrogate tape has a majorant mode, the PRB tape has none.
template <int NB, bool REC, bool MAJ = false, bool ENV = false, bool SUR = false,
          bool XY = false, bool RAW = false>
__device__ __forceinline__ void woodcock_step(Lane& L, float (&rad)[NB],
                                              uint32_t& s, float sx, float sy,
                                              const Params& P, const StepConsts& C,
                                              const void* __restrict__ vol,
                                              const float* __restrict__ tf,
                                              StepRecord* rec,
                                              const float2* __restrict__ maj = nullptr,
                                              const float* __restrict__ env = nullptr,
                                              SurRecord* sur = nullptr,
                                              const float* __restrict__ light = nullptr) {
  static_assert(!(REC && (MAJ || SUR)), "the PRB tape has no majorant mode");
  static_assert(!(REC && RAW) && !(XY && RAW), "the PRB tape reads packed tables; RAW reads "
                "an xy table by its runtime flag");
  const float* f = P.f;
  // free flight
  float dist, m = 0.0f;
  bool capped = false;
  if constexpr (MAJ) {
    const int cz = floor_cell(L.pz, P.i[I_MAJ_GZ]);
    const int cy = floor_cell(L.py, P.i[I_MAJ_GY]);
    const int cx = floor_cell(L.px, P.i[I_MAJ_GX]);
    const float2 row = __ldg(maj + ((int64_t)cz * P.i[I_MAJ_GY] + cy) * P.i[I_MAJ_GX] + cx);
    m = nmax(row.x, 1e-12f);
    const float rate = f[F_EXTINCTION] * m;
    dist = -logf(draw(s)) / rate;
    capped = dist >= row.y;
    dist = nmin(dist, row.y);
  } else {
    dist = quot(-logf(draw(s)), C.ext);
  }
  const float npx = L.px + dist * L.dx;
  const float npy = L.py + dist * L.dy;
  const float npz = L.pz + dist * L.dz;
  const bool oob = (npx > 1.0f) | (npx < 0.0f) | (npy > 1.0f) |
                   (npy < 0.0f) | (npz > 1.0f) | (npz < 0.0f);
  // material lookup (the taped step samples it even when out of bounds,
  // like the reference)
  float mat[3] = {0.0f, 0.0f, 0.0f}, light_raw = 0.0f;
  if (REC ? true : (!oob && !(MAJ && capped))) {
    if constexpr (RAW) {
      const float dens = sample_volume_any(vol, P, npx, npy, npz);
      sample_tf_any(tf, P.i[I_TF_KIND], P.i[I_TF_H], P.i[I_TF_W], L.tbx, L.tfx, dens, mat);
    } else {
      const float dens = sample_volume(vol, P.i[I_VOL_U8], P.i[I_VOL_D], P.i[I_VOL_H],
                                       P.i[I_VOL_W], npx, npy, npz,
                                       REC ? &rec->vol : nullptr, P.i[I_QUASICUBIC] != 0, XY);
      sample_tf(tf, P.i[I_TF_H], P.i[I_TF_W], L.tbx, L.tfx, dens, mat,
                REC ? &light_raw : nullptr, REC ? &rec->tf : nullptr);
    }
  }
  const float albedo = mat[0], alpha = mat[1];
  const float g = mat[2] * 2.0f - 1.0f;
  // event wheel
  float p_scatter, p_absorb;
  if constexpr (MAJ) {
    const float p_real = nmin(alpha / m, 1.0f);
    p_scatter = (L.bounces >= P.i[I_MAX_BOUNCES]) ? 0.0f : p_real * albedo;
    p_absorb = p_real - p_scatter;
  } else {
    const float p_null = 1.0f - alpha;
    p_scatter = (L.bounces >= P.i[I_MAX_BOUNCES]) ? 0.0f : alpha * albedo;
    p_absorb = 1.0f - p_null - p_scatter;
  }
  const float wheel = draw(s);
  const bool event = !oob && !capped;
  const bool absorb = event && (wheel < p_absorb);
  const bool scatter = event && !absorb && (wheel < p_absorb + p_scatter);
  const bool isotropic = P.i[I_ISOTROPIC] != 0;
  // escape radiance: the env map, or light_raw * 5 with a cosine lobe
  // unless isotropic
  float emitted = 0.0f;
  float ddot = 0.0f;
  if constexpr (REC && ENV) {
    rec->env = EnvAddr{0, 0, 0.0f, 0.0f};
    rec->env_w = oob ? kEnvGain : 0.0f;
  }
  if (oob) {
    if constexpr (ENV) {
      emitted = sample_environment(env, P.i[I_ENV_H], P.i[I_ENV_W], L.dx, L.dy,
                                   L.dz, L.lam, REC ? &rec->env : nullptr,
                                   RAW && P.i[I_ENV_RAW] != 0);
    } else {
      if constexpr (RAW) {
        light_raw = sample_light_any(tf, light, P, L.tbx, L.tfx, L.lam);
      } else if (!REC) {
        light_raw = sample_light(tf, L.tbx, L.tfx);
      }
      const float intensity = light_raw * 5.0f;
      ddot = L.dx * f[F_LDX] + L.dy * f[F_LDY] + L.dz * f[F_LDZ];
      emitted = isotropic ? intensity : nmax(ddot * intensity, 0.0f);
    }
  }
  if (REC) {
    rec->dist = dist;
    rec->emitted = emitted;
    rec->alpha = alpha;
    rec->albedo = albedo;
    rec->g = g;
    rec->pre_bin = L.bin;
    rec->respawn = oob || absorb;
    rec->null_event = event && !absorb && !scatter;
    rec->scatter = scatter;
    // pathwise d(emitted)/d(light texel) weight at escape; in env mode the
    // light is never sampled, so its weight is 0
    rec->light_w = (oob && !ENV) ? (isotropic ? 1.0f : (emitted > 0.0f ? ddot : 0.0f)) * 5.0f
                                 : 0.0f;
    rec->hg_cos = 0.0f;
  }
  if constexpr (SUR) {
    sur->dist = dist;
    sur->emitted = emitted;
    sur->pre_bin = L.bin;
    sur->respawn = oob || absorb;
    sur->null_event = event && !absorb && !scatter;
    sur->scatter = scatter;
    sur->oob = oob;
    sur->capped = capped;
    sur->rng = s;
    sur->pdx = L.dx; sur->pdy = L.dy; sur->pdz = L.dz;
    sur->spx = npx; sur->spy = npy; sur->spz = npz;
    sur->lam = L.lam;
    sur->maj = m;
  }
  const bool respawn_now = oob || absorb;
  float kx = 0.0f, ky = 0.0f;
  if (respawn_now || scatter) draw_disk(s, kx, ky);
  if (respawn_now) {
    // incremental one-hot mean over all bins, then a new camera path
    L.samples += 1;
    deposit<NB>(rad, L.bin, emitted, L.samples);
    const Ray r = respawn_from_disk(s, kx, ky, sx, sy, P);
    L.px = r.px; L.py = r.py; L.pz = r.pz;
    L.dx = r.dx; L.dy = r.dy; L.dz = r.dz;
    L.lam = r.lam; L.bin = r.bin;
    L.bounces = 0;
    wavelength_coord(L.lam, P.i[I_TF_W], L.tbx, L.tfx);
  } else {
    L.px = npx; L.py = npy; L.pz = npz;
    if (scatter) {
      const float ox = L.dx, oy = L.dy, oz = L.dz;
      draw_hg(s, kx, ky, g, L.dx, L.dy, L.dz);
      L.bounces += 1;
      if (REC) rec->hg_cos = L.dx * ox + L.dy * oy + L.dz * oz;
    }
  }
}

// a lane's state from the launch's state arrays, its TF column included
__device__ __forceinline__ Lane load_lane(int lane, const Params& P, const float* px_,
                                          const float* py_, const float* pz_,
                                          const float* dx_, const float* dy_,
                                          const float* dz_, const int* bounces_,
                                          const int* samples_, const int* bin_,
                                          const float* lam_) {
  Lane L;
  L.px = px_[lane]; L.py = py_[lane]; L.pz = pz_[lane];
  L.dx = dx_[lane]; L.dy = dy_[lane]; L.dz = dz_[lane];
  L.bounces = bounces_[lane]; L.samples = samples_[lane]; L.bin = bin_[lane];
  L.lam = lam_[lane];
  wavelength_coord(L.lam, P.i[I_TF_W], L.tbx, L.tfx);
  return L;
}

__device__ __forceinline__ void store_lane(const Lane& L, int lane, float* px_, float* py_,
                                           float* pz_, float* dx_, float* dy_, float* dz_,
                                           int* bounces_, int* samples_, int* bin_,
                                           float* lam_) {
  px_[lane] = L.px; py_[lane] = L.py; pz_[lane] = L.pz;
  dx_[lane] = L.dx; dy_[lane] = L.dy; dz_[lane] = L.dz;
  bounces_[lane] = L.bounces; samples_[lane] = L.samples; bin_[lane] = L.bin;
  lam_[lane] = L.lam;
}

// the step kernels' radiance bins: NB, the bin count rounded up to 4
inline int bins_rounded(int n_bins) { return (n_bins + 3) / 4 * 4; }

Params make_params(const float* fparams, const int* iparams) {
  Params P;
  for (int k = 0; k < F_COUNT; ++k) P.f[k] = fparams[k];
  for (int k = 0; k < I_COUNT; ++k) P.i[k] = iparams[k];
  return P;
}

inline int blocks_for(int n, int threads) { return (n + threads - 1) / threads; }

}  // namespace
