// Local ambient occlusion + soft shadows (LAO) kernel for Hopper (sm_90a),
// plain C interface.
//
//   K25 lao_frame_kernel<LAO, SHADOWS, MODE>
//                         replaces vpt_tpu/models/lao.py::lao_frame (:51-158):
//                         the whole frame, (R, R, 3). LAO and SHADOWS are the
//                         reference's static lao_enabled and shadows_enabled,
//                         MODE the table kind and filter (LaoMode).
//
// One thread per pixel and one launch per frame; the march state lives in
// registers. Per pixel: the camera ray clamped to the cube (cube_ray, as
// K15's), the per-pixel constant rx = rand2(ndc * (3.14, 2.71)).x with the
// NDC by IEEE division by the resolution (lao.py:69), and the frame's
// constant g_rx = rand2(3.14, 2.71).x; then slices + 1 samples from t0 =
// clip(rx * step * 1.5). A sample reads the volume 7 times (the value and a
// +-1/32 central difference), with LAO 20 more along the light cone (the
// host's f32 table of tt and (1 - tt)^2), with SHADOWS once toward the
// light, and the 2D TF at (value, |gradient|) (mcm_common.cuh
// sample_tex2d_rgba). The volume is a packed "full" corner table (u8 or
// f32, linear or quasicubic) beside the packed (Hp, Wp, 16) TF, or the raw
// (D, H, W) f32 grid under the nearest filter beside the raw (H, W, 4) TF.
// The reference's dead code (the half vector hx, hy, hz and inv_g,
// lao.py:104, :107-109) is not computed.
//
// The march stops at the first inactive sample where that is exact
// (LI_EXACT_STOP, set by the wrapper from the renderer's tables and this
// frame's light, kernels/lao.py::early_stop_exact and cone_clear), else it
// takes every sample masked as the reference does. An inactive sample adds
// w * c with w = +0 and acc_a + 0, exactly +0, when c is finite: the TF,
// the volume and the weights finite, light_coef not 0 (a cone integral of 0
// over 0 is NaN) and no cone direction 0/0 (the light's cone off the
// samples' box). A sample is
// inactive once t >= 1 or acc_a > 0.9; t only grows, and acc_a cannot fall
// while active (acc_a <= 0.9 < 1, so (1 - acc_a) * value * extinction >= 0
// when the density and the extinction are >= 0), so once inactive a ray
// stays inactive. A pixel whose ray misses the cube renders black and skips
// its march.
//
// What bounds it on this card. At 512^2 and 64 slices a ray takes up to 65
// samples of 28 volume lookups and 1 TF lookup (14.0 M samples, 392 M
// lookups a frame on the bench volume), each cone lookup waiting on a sqrt
// and three quotients; a warp pays for its longest ray (chip_smoke.py
// phase 25 counts the trips per ray). The bound is the operations (1,676
// FP32 operations a sample, 0.35 ms a frame). The first design took 1.97
// ms: every lookup carried every table kind by runtime flags and 64-bit
// row arithmetic (4,456 SASS instructions in <1,1>), and a warp of 32
// pixels of one row paid 1.17x its rays' mean trips (the longest ray's
// trips over the mean). The redesign, each lever timed in turns on the
// card (probes/lao_variants.py; PERF.md), takes 1.17 ms:
// - MODE is a template parameter (LaoMode: the packed u8 or f32 corner
//   table, linear or quasicubic, and the raw f32 grid with the nearest
//   filter, the pairs LAORenderer builds with their TF, packed or raw), so
//   each instance inlines one lookup path 28 times (2,232 instructions); a
//   lookup's row is a 32-bit plane offset plus one 32 x 32 -> 64-bit
//   multiply by the plane size, the only 64-bit arithmetic before the
//   address;
// - a warp takes an 8 x 4 tile of pixels and a block 16 x 8, so that a
//   warp's rays end together (a warp pays 1.06x the mean trips); other
//   tile shapes of 32 pixels time the same, one row of 32 is 27% slower;
// - __launch_bounds__ asks room for 6 blocks an SM (at most 80 registers;
//   75 taken, no spills): at 8 blocks (64 registers) or with no minimum
//   (56) it runs 18% and 13% slower;
// - the value and the central difference share their axes: 9 rows and
//   fractions for 7 lookups instead of 21; a u8 corner's quotient by 255
//   drops u8_unit's zero test (5 instructions a corner, 8 a lookup);
// - the quotients stay IEEE divisions: one reciprocal a shared divisor
//   with Markstein's correction (mcm_common.cuh quot) gives the same bits
//   but runs 23% slower here, its range tests and fallback dearer than the
//   division's own range check. Reading every lookup from one row is no
//   faster, so the rows' scatter in the L1 does not bound it.
// The 32 B stack frame (2 local stores, 3 local loads in the SASS) is in
// every variant, rand2_x out of line too.
//
// Numerics: built without fast math and with -fmad=false, so every
// expression rounds as the plain PyTorch version's (kernels/lao.py):
// quotients IEEE (__fdiv_rn), sqrt IEEE, cosf the accurate one (which
// torch.cos calls on the card), min/max propagate NaN like torch.clamp.
// Constants the reference folds in float64 come as the f32 rounding of
// the double: the literal's double cast to float (F32), or from the host.

#include "mcm_common.cuh"

namespace {

#define LAO_THREADS 128
// a block's pixel tile (LAO_THREADS pixels), as four warps of 8 x 4
#define LAO_TILE_W 16
#define LAO_TILE_H 8
// blocks an SM that __launch_bounds__ asks room for: at most 80 registers
#define LAO_MIN_BLOCKS 6
#define F32(x) ((float)(x))

// parameter block layout, mirrored by vpt_tpu_torch/kernels/lao.py
enum LaoF {
  LF_INV_MVP = 0,  // 16 floats, row-major
  LF_LX = 16, LF_LY, LF_LZ,  // inv_mvp @ [light, 1] without the divide
  LF_INV_RES,      // 1 / resolution (the camera rays' NDC)
  LF_STEP,         // 1 / slices
  LF_EXTINCTION,
  LF_LAO_WEIGHT,
  LF_SHADOWS_WEIGHT,
  LF_LIGHT_RADIUS,
  LF_LIGHT_COEF,
  LF_H,            // 1 / 32, the gradient step
  LF_SHADOW_BIAS,  // 1.0 * (1.0 - 1.2)
  LF_COUNT,
};
enum LaoI {
  LI_RES = 0,
  LI_TRIPS,        // slices + 1
  LI_VOL_RAW,      // 1: a raw (D, H, W) f32 grid, given as D+1, H+1, W+1
  LI_VOL_U8,       // packed table: 1 u8, 0 f32
  LI_VOL_D, LI_VOL_H, LI_VOL_W,
  LI_QUASICUBIC,
  LI_NEAREST,      // raw grid only
  LI_TF_RAW,       // 1: a raw (H, W, 4) texture, given as H+1, W+1
  LI_TF_H, LI_TF_W,
  LI_CONE,         // the cone's sample count, ceil(0.999 / lao_step)
  LI_EXACT_STOP,   // 1: stopping at the first inactive sample is exact
  LI_COUNT,
};

// the table modes K25 is built for, each with its TF: packed (Hp, Wp, 16)
// beside a packed volume, raw (H, W, 4) beside the raw grid
enum LaoMode {
  LM_U8 = 0,     // packed u8 corner table, linear
  LM_F32,        // packed f32 corner table, linear
  LM_U8_QC,      // packed u8, quasicubic
  LM_F32_QC,     // packed f32, quasicubic
  LM_NEAREST,    // raw f32 grid, nearest
  LM_COUNT,
};

struct LaoP {
  float f[LF_COUNT];
  int i[LI_COUNT];
};

// the volume's addressing: the packed table's padded dims (Dp, Hp, Wp) or
// the raw grid's (D, H, W), and a z plane's rows (below 2^31)
struct LaoVol {
  int d, h, w, plane;
};

// one axis of a lookup: the packed table's row index and (warped)
// fraction, mcm_common.cuh's base_frac (then quasicubic), or the raw grid's
// nearest texel (floor_cell); n the axis's entry of LaoVol
struct LaoAxis {
  int b;
  float f;
};

template <int MODE>
__device__ __forceinline__ LaoAxis lao_axis(float t, int n) {
  LaoAxis a;
  if constexpr (MODE == LM_NEAREST) {
    a.b = floor_cell(t, n);
    a.f = 0.0f;
  } else {
    base_frac(t, n - 1, a.b, a.f);
    if constexpr (MODE == LM_U8_QC || MODE == LM_F32_QC) a.f = quasicubic(a.f);
  }
  return a;
}

// a u8 code of `word` over 255: u8_unit's byte permute and corrected
// product without its zero test, which a code, never negative, needs not
// (the product of +0 is +0 either way; all 256 codes are tested)
__device__ __forceinline__ float lao_u8(uint32_t word, int k) {
  const float v = __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440u + k)) - 8388608.0f;
  const float q = __fmul_rn(v, kInv255);
  return __fmaf_rn(__fmaf_rn(-255.0f, q, v), kInv255, q);
}

// the lookup at the axes (x, y, z) in MODE's table, as mcm_common.cuh's
// sample_volume (a packed full table) or sample_volume_raw's nearest texel
// computes it, bit for bit: the plane offset in 32 bits, the row by one
// widening multiply
template <int MODE>
__device__ __forceinline__ float lao_fetch(const void* __restrict__ vol, const LaoVol& V,
                                           LaoAxis x, LaoAxis y, LaoAxis z) {
  const int64_t row = (int64_t)z.b * V.plane + (y.b * V.w + x.b);
  if constexpr (MODE == LM_NEAREST) {
    return __ldg(static_cast<const float*>(vol) + row);
  } else {
    float c[8];
    if constexpr (MODE == LM_U8 || MODE == LM_U8_QC) {
      const uint2 raw = __ldg(static_cast<const uint2*>(vol) + row);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        c[k] = lao_u8(raw.x, k);
        c[4 + k] = lao_u8(raw.y, k);
      }
    } else {
      const float4* t = static_cast<const float4*>(vol) + row * 2;
      const float4 a = __ldg(t), b = __ldg(t + 1);
      c[0] = a.x; c[1] = a.y; c[2] = a.z; c[3] = a.w;
      c[4] = b.x; c[5] = b.y; c[6] = b.z; c[7] = b.w;
    }
    const float c00 = lerp(c[0], c[1], x.f);
    const float c01 = lerp(c[2], c[3], x.f);
    const float c10 = lerp(c[4], c[5], x.f);
    const float c11 = lerp(c[6], c[7], x.f);
    const float c0 = lerp(c00, c01, y.f);
    const float c1 = lerp(c10, c11, y.f);
    return lerp(c0, c1, z.f);
  }
}

template <int MODE>
__device__ __forceinline__ float lao_volume(const void* __restrict__ vol, const LaoVol& V,
                                            float x, float y, float z) {
  return lao_fetch<MODE>(vol, V, lao_axis<MODE>(x, V.w), lao_axis<MODE>(y, V.h),
                         lao_axis<MODE>(z, V.d));
}

// rand2's first uniform: fract(cos(dx) * 1235.6789), dx = 23.14... * px +
// 2.665... * py (the second, from sin, no pixel reads)
__device__ __forceinline__ float rand2_x(float px, float py) {
  const float dx = F32(23.14069263277926) * px + F32(2.665144142690225) * py;
  const float mx = cosf(dx) * F32(1235.6789);
  return mx - floorf(mx);
}

__device__ __forceinline__ float clamp01(float x) { return nmin(nmax(x, 0.0f), 1.0f); }

// this thread's pixel: the warp's 8 x 4 tile of the block's 16 x 8
__device__ __forceinline__ void lao_pixel(int& ix, int& iy) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ix = blockIdx.x * LAO_TILE_W + (warp & 1) * 8 + (lane & 7);
  iy = blockIdx.y * LAO_TILE_H + (warp >> 1) * 4 + (lane >> 3);
}

// K25: one LAO frame into out (R, R, 3). cone: LI_CONE float2 (tt, (1 - tt)^2).
template <bool LAO, bool SHADOWS, int MODE>
__global__ void __launch_bounds__(LAO_THREADS, LAO_MIN_BLOCKS)
lao_frame_kernel(const LaoP P, const void* __restrict__ vol, const float* __restrict__ tf,
                 const float2* __restrict__ cone, float* __restrict__ out) {
  const int res = P.i[LI_RES];
  int ix, iy;
  lao_pixel(ix, iy);
  if (ix >= res || iy >= res) return;
  float* o = out + ((int64_t)iy * res + ix) * 3;
  const CubeRay r = cube_ray(P.f + LF_INV_MVP, P.f[LF_INV_RES], ix, iy);
  if (r.miss) {
    o[0] = 0.0f;
    o[1] = 0.0f;
    o[2] = 0.0f;
    return;
  }
  constexpr bool kRawTf = MODE == LM_NEAREST;
  // a raw grid of n texels along an axis comes as n + 1
  const int dd = kRawTf ? 1 : 0;
  const LaoVol V = {P.i[LI_VOL_D] - dd, P.i[LI_VOL_H] - dd, P.i[LI_VOL_W] - dd,
                    (P.i[LI_VOL_H] - dd) * (P.i[LI_VOL_W] - dd)};
  const int tf_h = P.i[LI_TF_H], tf_w = P.i[LI_TF_W];
  const float fres = (float)res;
  const float ndc_x = (__fdiv_rn((float)ix + 0.5f, fres) - 0.5f) * 2.0f;
  const float ndc_y = (__fdiv_rn((float)iy + 0.5f, fres) - 0.5f) * -2.0f;
  const float rx = rand2_x(ndc_x * F32(3.14), ndc_y * F32(2.71));
  const float g_rx = rand2_x(F32(3.14), F32(2.71));
  const float step = P.f[LF_STEP], h = P.f[LF_H], lr = P.f[LF_LIGHT_RADIUS];
  const float lx = P.f[LF_LX], ly = P.f[LF_LY], lz = P.f[LF_LZ];
  const float t0 = clamp01(rx * step * 1.5f);
  // the per-pixel constant cone jitter and shadow direction
  const float q = 2.0f * rx - 1.0f;
  const float lao_dx = __fdiv_rn(q, sqrtf(3.0f * (q * q) + F32(1e-20))) * rx;
  float sdx = -1.0f + lx * rx;
  float sdy = ly + rx * lz;
  float sdz = -1.0f + 2.0f * g_rx;
  const float sn = sqrtf(sdx * sdx + sdy * sdy + sdz * sdz);
  sdx = __fdiv_rn(sdx, sn) * rx;
  sdy = __fdiv_rn(sdy, sn) * rx;
  sdz = __fdiv_rn(sdz, sn) * rx;
  const float ext = P.f[LF_EXTINCTION], lw = P.f[LF_LAO_WEIGHT];
  const float sw = P.f[LF_SHADOWS_WEIGHT], coef = P.f[LF_LIGHT_COEF];
  const float bias = P.f[LF_SHADOW_BIAS];
  const bool exact_stop = P.i[LI_EXACT_STOP] != 0;
  const int trips = P.i[LI_TRIPS], n_cone = P.i[LI_CONE];

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_a = 0.0f;
  for (int k = 0; k < trips; ++k) {
    const float t = t0 + (float)k * step;
    const bool active = t < 1.0f && acc_a <= F32(0.9);
    if (!active && exact_stop) break;
    const float p0 = lerp(r.nx, r.xx, t), p1 = lerp(r.ny, r.xy, t), p2 = lerp(r.nz, r.xz, t);
    // the value and the central difference: 7 lookups over 9 axes
    const LaoAxis x0 = lao_axis<MODE>(p0 - h, V.w), x1 = lao_axis<MODE>(p0, V.w);
    const LaoAxis x2 = lao_axis<MODE>(p0 + h, V.w), y0 = lao_axis<MODE>(p1 - h, V.h);
    const LaoAxis y1 = lao_axis<MODE>(p1, V.h), y2 = lao_axis<MODE>(p1 + h, V.h);
    const LaoAxis z0 = lao_axis<MODE>(p2 - h, V.d), z1 = lao_axis<MODE>(p2, V.d);
    const LaoAxis z2 = lao_axis<MODE>(p2 + h, V.d);
    const float gx = lao_fetch<MODE>(vol, V, x0, y1, z1) - lao_fetch<MODE>(vol, V, x2, y1, z1);
    const float gy = lao_fetch<MODE>(vol, V, x1, y0, z1) - lao_fetch<MODE>(vol, V, x1, y2, z1);
    const float gz = lao_fetch<MODE>(vol, V, x1, y1, z0) - lao_fetch<MODE>(vol, V, x1, y1, z2);
    const float gmag = sqrtf(gx * gx + gy * gy + gz * gz);
    const float value = lao_fetch<MODE>(vol, V, x1, y1, z1);

    float lao = 0.0f;
    if (LAO) {
      float acc_lao = 0.0f;
      for (int i = 0; i < n_cone; ++i) {
        const float2 c = __ldg(cone + i);  // (tt, (1 - tt)^2)
        const float d = lao_dx * (lr * c.x);
        const float jx = lx + d - p0, jy = ly + d - p1, jz = lz + d - p2;
        const float jn = sqrtf(jx * jx + jy * jy + jz * jz);
        const float s = lao_volume<MODE>(vol, V, p0 + __fdiv_rn(jx, jn) * c.x,
                                         p1 + __fdiv_rn(jy, jn) * c.x,
                                         p2 + __fdiv_rn(jz, jn) * c.x);
        acc_lao = acc_lao + s * c.y;
      }
      lao = clamp01(__fdiv_rn(acc_lao, coef));
    }
    float shadow = 0.0f;
    if (SHADOWS) {
      const float s = lao_volume<MODE>(vol, V, p0 + sdx * lr, p1 + sdy * lr, p2 + sdz * lr);
      const float contrib = s * (s * F32(0.2)) * rx;
      shadow = clamp01(contrib * 20.0f);
      shadow = clamp01(__fdiv_rn(bias + shadow * F32(1.2), F32(1.3)));
    }

    const float4 c4 = sample_tex2d_rgba(tf, kRawTf, tf_h, tf_w, value, gmag);
    float cr = c4.x, cg = c4.y, cb = c4.z;
    // the tint mixes (the reference shader's blue-grey constants)
    const float wl = lao * lw;
    cr = cr + (cr * F32(0.15) - cr) * wl;
    cg = cg + (cg * F32(0.18) - cg) * wl;
    cb = cb + (cb * F32(0.32) - cb) * wl;
    const float ws = shadow * sw;
    cr = cr + (cr * F32(0.15) - cr) * ws;
    cg = cg + (cg * F32(0.18) - cg) * ws;
    cb = cb + (cb * F32(0.22) - cb) * ws;

    const float w = active ? (1.0f - acc_a) * value : 0.0f;
    acc_r = acc_r + w * cr;
    acc_g = acc_g + w * cg;
    acc_b = acc_b + w * cb;
    acc_a = acc_a + (active ? __fdiv_rn((1.0f - acc_a) * value * ext, 100.0f) : 0.0f);
  }
  const float scale = (acc_a > 1.0f) ? __fdiv_rn(1.0f, acc_a) : 1.0f;
  o[0] = acc_r * scale;
  o[1] = acc_g * scale;
  o[2] = acc_b * scale;
}

template <bool LAO, bool SHADOWS>
int launch_lao(int mode, dim3 grid, cudaStream_t st, const LaoP& P, const void* vol,
               const float* tf, const float2* cone, float* out) {
  switch (mode) {
#define VPT_LAO_MODE(M)                                                                        \
  case M:                                                                                      \
    lao_frame_kernel<LAO, SHADOWS, M><<<grid, LAO_THREADS, 0, st>>>(P, vol, tf, cone, out); \
    break;
    VPT_LAO_MODE(LM_U8) VPT_LAO_MODE(LM_F32) VPT_LAO_MODE(LM_U8_QC) VPT_LAO_MODE(LM_F32_QC)
    VPT_LAO_MODE(LM_NEAREST)
#undef VPT_LAO_MODE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// the table mode of a parameter block, or -1 where K25 has no instance
// (a raw grid under a linear or quasicubic filter, a TF of the other kind)
int lao_mode(const LaoP& P) {
  const bool raw = P.i[LI_VOL_RAW] != 0, qc = P.i[LI_QUASICUBIC] != 0;
  const bool nearest = P.i[LI_NEAREST] != 0, tf_raw = P.i[LI_TF_RAW] != 0;
  if (raw) return (nearest && !qc && tf_raw) ? LM_NEAREST : -1;
  if (nearest || tf_raw) return -1;
  if (P.i[LI_VOL_U8] != 0) return qc ? LM_U8_QC : LM_U8;
  return qc ? LM_F32_QC : LM_F32;
}

}  // namespace

extern "C" {

int vpt_lao_layout(int which) {
  switch (which) {
    case 0: return LF_COUNT;
    case 1: return LI_COUNT;
    default: return -1;
  }
}

// one LAO frame into out (R*R*3 floats); cone: LI_CONE (tt, (1 - tt)^2)
// float pairs on the device; lao, shadows: the template flags; the table
// mode from the parameters (lao_mode; none: cudaErrorInvalidValue)
int vpt_lao_frame(const float* fparams, const int* iparams, int lao, int shadows,
                  const void* vol, const float* tf, const float* cone, float* out,
                  void* stream) {
  LaoP P;
  for (int k = 0; k < LF_COUNT; ++k) P.f[k] = fparams[k];
  for (int k = 0; k < LI_COUNT; ++k) P.i[k] = iparams[k];
  const int res = P.i[LI_RES], mode = lao_mode(P);
  if (res <= 0 || P.i[LI_TRIPS] < 0 || vol == nullptr || tf == nullptr || out == nullptr ||
      (lao != 0 && (cone == nullptr || P.i[LI_CONE] < 0)) || mode < 0 ||
      (int64_t)P.i[LI_VOL_H] * P.i[LI_VOL_W] >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks_for(res, LAO_TILE_W), (unsigned)blocks_for(res, LAO_TILE_H));
  const float2* c = reinterpret_cast<const float2*>(cone);
  if (lao != 0 && shadows != 0) return launch_lao<true, true>(mode, grid, st, P, vol, tf, c, out);
  if (lao != 0) return launch_lao<true, false>(mode, grid, st, P, vol, tf, c, out);
  if (shadows != 0) return launch_lao<false, true>(mode, grid, st, P, vol, tf, c, out);
  return launch_lao<false, false>(mode, grid, st, P, vol, tf, c, out);
}

}  // extern "C"
