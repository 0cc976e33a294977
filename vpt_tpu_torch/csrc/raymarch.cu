// Ray-march renderer kernels for Hopper (sm_90a), plain C interface.
//
//   K15 march_kernel<EAM>   replaces vpt_tpu/models/raymarch.py::eam_frame
//                           (:99-134) and EAMRenderer.render's running
//                           average (:170-173): front-to-back compositing
//                           over slices + 1 samples, then acc += (img - acc)
//                           / frame, in place; or, given an output image and
//                           no running average, the frame alone (eam_frame,
//                           the forward of the differentiable frame that
//                           optim.fit_density trains through).
//   K15 march_kernel<DEPTH> replaces depth_frame (:343-373) and
//                           DepthRenderer.render's display (:404): the same
//                           opacity march up to the threshold, written as the
//                           grey display image.
//   K16 mip_kernel          replaces mip_frame (:179-198) and MIPRenderer's
//                           max merge (:222), in place.
//   K17 iso_kernel          replaces iso_frame (:229-256) and ISORenderer's
//                           closest-hit merge (:321-329), in place.
//   K18 iso_shade_kernel    replaces iso_shade (:259-280): Lambert shading
//                           from a central difference of the TF alpha, white
//                           where nothing was hit.
//   K19 eam_backward_kernel<LEARN_TF>
//                           replaces eam_frame under jax.grad (through
//                           vpt_tpu/optim.py::eam_loss, :88-100): the
//                           cotangent of the frame scattered into the raw
//                           density grid and, with LEARN_TF, into the raw
//                           TF's row 0.
//
// One thread per pixel; the march state lives in registers and each kernel
// reads and writes its pixel's state once. The volume is a packed "full"
// corner table (u8 or f32, linear or quasicubic) or a raw (D, H, W) f32 grid
// (also nearest), read through mcm_common.cuh's samplers; the classic 2D TF
// is a packed (257, 257, 16) corner table or the raw (256, 256, 4) texture,
// read at (density, 0) by mcm_common.cuh's sample_rgba. K19 takes the raw
// grid and the raw TF only (what fit_density learns).
//
// What bounds them on this card. Per sample a thread does one random
// volume lookup (an 8-byte u8 or 32-byte f32 row, or 8 scalar loads of a
// raw grid) and one TF row (64 bytes, or 4 float4 texels), plus ~100 FP32
// operations. At the bench size (512^2 pixels, up to 65 samples) the
// volume rows the samples touch sit in the L2 (the whole 129^3 x 8 u8
// table is 17 MB), and the TF is read at v = 0 only, one row of the table
// (16 KB packed); the bytes and operations a pass needs (counted by
// chip_smoke.py's phase 19) bound it far below its time. A pass lasts as
// long as its longest rays (those that graze the cube or cross its empty
// margin take every sample), each sample two dependent gathers (the TF row
// waits on the density) and the instructions of its lookups. K17-K19 run
// that chain one sample at a time, their tables' layout read from the
// parameter block at every lookup; a thread holds 40-72 registers, a block
// 128 threads (K19 without the TF 256). K19 walks each ray twice (the
// march replayed, then its steps backwards) and adds 8 float atomics per
// step into the density gradient (1 for nearest); neighbouring pixels'
// rays share voxels, so those atomics meet on the same addresses (counted
// by chip_smoke.py's phase 20).
//
// K15 and K16 (redesigned; each lever timed in turns on the card,
// probes/raymarch_variants.py, PERF.md): an instance per table pair
// (MarchMode, written by the wrapper into RI_MODE: the pairs the renderers
// and fit_density build inline their one lookup path, a generic instance
// reads the flags); a warp marches an 8 x 4 pixel tile, a block 16 x 8, so
// a warp's rays are alike in length; the lookups of a batch of samples
// (MIP_BATCH, EAM_BATCH, DEPTH_BATCH) are issued together, their volume
// gathers and then their TF gathers, and folded in order, so a thread waits
// on two gathers a batch instead of two a sample (K15 composites a batch's
// samples in order and stops where the one-sample loop stops; only whole
// batches whose every t is < 1 are batched, the rest runs one sample at a
// time, so no lookup is issued for t >= 1); K16's offset wrap is exact
// without fmodf where the offsets lie in [0, 2); K16 and Depth load the
// TF's alpha words only, the TF's row at v = 0 located once a thread, the
// raw TF's one row read once a lookup; a u8 corner is dequantized without
// u8_unit's zero test. A dynamic queue of tiles (a warp taking the next
// tile from a global counter) lost 10-40% to the static grid.
//
// The marches stop early where nothing later can change the result, which
// the masked scans of the JAX code cannot: EAM once acc_a >= 0.99 or t >= 1,
// Depth once the threshold is crossed or t >= 1 (an inactive step leaves the
// accumulators as they are, and t only grows), ISO by walking near -> far
// and stopping at the first hit (the far -> near overwrite keeps the same,
// smallest t). A pixel whose ray misses the cube skips its march. For a TF
// with finite entries every pixel equals the masked march bit for bit. An
// inactive EAM step gets no cotangent under jax.grad either (jnp.where
// selects 0), so K19's walk over the active steps alone is exact.
//
// Numerics: built without fast math and with -fmad=false, so every
// expression rounds as the plain PyTorch version's (kernels/raymarch.py);
// every quotient is the IEEE one (__fdiv_rn), sqrt is IEEE, min/max
// propagate NaN like torch.minimum/maximum, and the lerps keep the order
// a + (b - a) * t. K19's sums differ from autograd's in order (the atomics
// add in no fixed order), so it agrees with its plain version to rounding.

#include "mcm_common.cuh"

namespace {

#define MARCH_THREADS 128
// K15's and K16's block: a 16 x 8 pixel tile, as four warps of 8 x 4
#define MARCH_TILE_W 16
#define MARCH_TILE_H 8
// samples whose lookups a thread issues together: K16, K15 EAM, K15 Depth
#define MIP_BATCH 8
#define EAM_BATCH 8
#define DEPTH_BATCH 2
// K15's minimum of blocks an SM (__launch_bounds__): EAM, Depth
#define EAM_MIN_BLOCKS 3
#define DEPTH_MIN_BLOCKS 8

// parameter block layout, mirrored by vpt_tpu_torch/kernels/raymarch.py
enum MarchF {
  RF_INV_MVP = 0,  // 16 floats, row-major
  RF_INV_RES = 16,
  RF_STEP,         // 1 / slices (EAM, Depth) or 1 / steps (MIP, ISO), rounded to f32
  RF_OFFSET,
  RF_EXTINCTION,
  RF_THRESHOLD,    // Depth
  RF_ISOVALUE,     // ISO
  RF_LX, RF_LY, RF_LZ,  // ISO shade: the light in model space
  RF_H,            // ISO shade: the central difference's step
  RF_COUNT,
};
enum MarchI {
  RI_RES = 0,
  RI_TRIPS,        // samples per ray: slices + 1 (EAM, Depth) or steps (MIP, ISO)
  RI_VOL_RAW,      // 1: a raw (D, H, W) f32 grid, given as D+1, H+1, W+1
  RI_VOL_U8,       // packed table: 1 u8, 0 f32
  RI_VOL_D, RI_VOL_H, RI_VOL_W,
  RI_QUASICUBIC,
  RI_NEAREST,      // raw grid only
  RI_TF_RAW,       // 1: a raw (H, W, 4) texture, given as H+1, W+1
  RI_TF_H, RI_TF_W,
  RI_MODE,         // K15, K16: the tables' MarchMode (kernels/raymarch.py march_mode)
  RI_COUNT,
};
enum MarchKind { EAM = 0, DEPTH = 1 };
// K15's and K16's instance by table pair: the pairs the renderers and
// fit_density build, each inlining its one lookup path, and every other
// pair the wrapper takes in the generic instance, which reads the flags
enum MarchMode {
  MM_U8 = 0,     // packed u8 corner table, linear, beside the packed TF
  MM_F32,        // packed f32 corner table, linear, packed TF
  MM_U8_QC,      // packed u8, quasicubic, packed TF
  MM_F32_QC,     // packed f32, quasicubic, packed TF
  MM_RAW,        // raw f32 grid, linear, raw TF
  MM_RAW_QC,     // raw f32 grid, quasicubic, raw TF
  MM_NEAREST,    // raw f32 grid, nearest, raw TF
  MM_GENERIC,    // any other pair, by the runtime flags
  MM_COUNT,
};

struct March {
  float f[RF_COUNT];
  int i[RI_COUNT];
};

March make_march(const float* fparams, const int* iparams) {
  March P;
  for (int k = 0; k < RF_COUNT; ++k) P.f[k] = fparams[k];
  for (int k = 0; k < RI_COUNT; ++k) P.i[k] = iparams[k];
  return P;
}

__device__ __forceinline__ float march_density(const void* vol, const March& P, float u,
                                               float v, float w) {
  if (P.i[RI_VOL_RAW] != 0)
    return sample_volume_raw(static_cast<const float*>(vol), P.i[RI_VOL_D], P.i[RI_VOL_H],
                             P.i[RI_VOL_W], u, v, w, P.i[RI_QUASICUBIC] != 0,
                             P.i[RI_NEAREST] != 0);
  return sample_volume(vol, P.i[RI_VOL_U8], P.i[RI_VOL_D], P.i[RI_VOL_H], P.i[RI_VOL_W], u, v,
                       w, nullptr, P.i[RI_QUASICUBIC] != 0, false);
}

// the classic TF's RGBA at (x, 0) in the layout P names (mcm_common.cuh
// sample_rgba: one packed row or four raw texels, the same bits)
__device__ __forceinline__ float4 march_rgba(const float* __restrict__ tf, const March& P,
                                             float x) {
  return sample_rgba(tf, P.i[RI_TF_RAW] != 0, P.i[RI_TF_H], P.i[RI_TF_W], x);
}

// raymarch.sample_tf: the volume density at a point, then its TF RGBA
__device__ __forceinline__ float4 sample_point(const void* vol, const float* tf, const March& P,
                                               float x, float y, float z) {
  return march_rgba(tf, P, march_density(vol, P, x, y, z));
}

// the ray's length inside the cube over the sample count: ray_step_len
__device__ __forceinline__ float step_length(const CubeRay& r, float step) {
  const float ex = r.xx - r.nx, ey = r.xy - r.ny, ez = r.xz - r.nz;
  return sqrtf(ex * ex + ey * ey + ez * ez) * step;
}

// ---------------------------------------------------------------------------
// K15 and K16: an instance per table pair, batches of samples
// ---------------------------------------------------------------------------
template <int MODE>
__host__ __device__ constexpr bool mode_raw() {
  return MODE == MM_RAW || MODE == MM_RAW_QC || MODE == MM_NEAREST;
}
template <int MODE>
__host__ __device__ constexpr bool mode_u8() {
  return MODE == MM_U8 || MODE == MM_U8_QC;
}

// byte k of a packed u8 corner row as float(code) / 255: u8_unit's
// corrected product with RN(1/255) without its zero test (a code of 0
// gives +0 either way; tests/test_torch_raymarch_modes.py holds all 256)
__device__ __forceinline__ float march_u8(uint32_t word, int k) {
  const float v = __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440u + k)) - 8388608.0f;
  const float q = __fmul_rn(v, kInv255);
  return __fmaf_rn(__fmaf_rn(-255.0f, q, v), kInv255, q);
}

// sample_volume on a packed u8 "full" table (the same row, corners, lerps
// and bits), its corners dequantized by march_u8
template <bool QC>
__device__ __forceinline__ float sample_volume_u8(const void* table, int Dp, int Hp, int Wp,
                                                  float u, float v, float w) {
  int64_t row, row1;
  float fx, fy, fz;
  volume_rows(false, Dp, Hp, Wp, u, v, w, row, row1, fx, fy, fz);
  if (QC) {
    fx = quasicubic(fx);
    fy = quasicubic(fy);
    fz = quasicubic(fz);
  }
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(static_cast<const uint8_t*>(table) +
                                                         row * 8));
  const float c00 = lerp(march_u8(raw.x, 0), march_u8(raw.x, 1), fx);
  const float c01 = lerp(march_u8(raw.x, 2), march_u8(raw.x, 3), fx);
  const float c10 = lerp(march_u8(raw.y, 0), march_u8(raw.y, 1), fx);
  const float c11 = lerp(march_u8(raw.y, 2), march_u8(raw.y, 3), fx);
  const float c0 = lerp(c00, c01, fy);
  const float c1 = lerp(c10, c11, fy);
  return lerp(c0, c1, fz);
}

// the volume density at (u, v, w) in MODE's table: one lookup path inlined
// in each instance, march_density's runtime flags in the generic one
template <int MODE>
__device__ __forceinline__ float mode_density(const void* vol, const March& P, float u, float v,
                                              float w) {
  if constexpr (MODE == MM_GENERIC)
    return march_density(vol, P, u, v, w);
  else if constexpr (mode_raw<MODE>())
    return sample_volume_raw(static_cast<const float*>(vol), P.i[RI_VOL_D], P.i[RI_VOL_H],
                             P.i[RI_VOL_W], u, v, w, MODE == MM_RAW_QC, MODE == MM_NEAREST);
  else if constexpr (mode_u8<MODE>())
    return sample_volume_u8<MODE == MM_U8_QC>(vol, P.i[RI_VOL_D], P.i[RI_VOL_H], P.i[RI_VOL_W],
                                              u, v, w);
  else
    return sample_volume(vol, 0, P.i[RI_VOL_D], P.i[RI_VOL_H], P.i[RI_VOL_W], u, v, w, nullptr,
                         MODE == MM_F32_QC, false);
}

// The classic TF read at v = 0 (sample_rgba's y): the rows its four
// texels come from and their fraction, the same for every lookup, located
// once a thread. Packed: the 16-wide corner row by of the (Hp, Wp, 16)
// table (k00, k01, k10, k11 as four float4 at column bx); raw: rows y0 (r0)
// and y1 (r1) of the (H, W, 4) texture.
struct TfAt0 {
  const float4* r0;
  const float4* r1;
  float fy;
  int Wp;
  bool raw;
};

template <int MODE>
__device__ __forceinline__ TfAt0 tf_at0(const float* __restrict__ tf, const March& P) {
  TfAt0 q;
  if constexpr (MODE == MM_GENERIC)
    q.raw = P.i[RI_TF_RAW] != 0;
  else
    q.raw = mode_raw<MODE>();
  const int Hp = P.i[RI_TF_H];
  q.Wp = P.i[RI_TF_W];
  int by;
  base_frac(0.0f, Hp - 1, by, q.fy);
  const float4* t = reinterpret_cast<const float4*>(tf);
  q.r0 = q.raw ? t + (int64_t)max(by - 1, 0) * (q.Wp - 1) : t + ((int64_t)by * q.Wp) * 4;
  // the raw y1 = min(by, H - 1) is y0: base_frac puts v = 0 at by = 0 for
  // every H, so both rows of a lookup are row 0 and its k10, k11 are k00,
  // k01 (the packed row holds all four)
  q.r1 = q.r0;
  return q;
}

// the four texels of a lookup at x, as sample_tex2d_rgba addresses them
__device__ __forceinline__ void tf_texels(const TfAt0& q, float x, const float4*& p00,
                                          const float4*& p01, const float4*& p10,
                                          const float4*& p11, float& fx) {
  int bx;
  base_frac(x, q.Wp - 1, bx, fx);
  if (q.raw) {
    const int x0 = max(bx - 1, 0), x1 = min(bx, q.Wp - 2);
    p00 = q.r0 + x0;
    p01 = q.r0 + x1;
    p10 = q.r1 + x0;
    p11 = q.r1 + x1;
  } else {
    p00 = q.r0 + bx * 4;
    p01 = p00 + 1;
    p10 = p00 + 2;
    p11 = p00 + 3;
  }
}

// sample_rgba(tf, ..., x): the same texels, lerps and bits
__device__ __forceinline__ float4 tf_rgba(const TfAt0& q, float x) {
  const float4 *p00, *p01, *p10, *p11;
  float fx;
  tf_texels(q, x, p00, p01, p10, p11, fx);
  const float4 k00 = __ldg(p00), k01 = __ldg(p01), k10 = __ldg(p10), k11 = __ldg(p11);
  const float fy = q.fy;
  float4 o;
  o.x = lerp(lerp(k00.x, k01.x, fx), lerp(k10.x, k11.x, fx), fy);
  o.y = lerp(lerp(k00.y, k01.y, fx), lerp(k10.y, k11.y, fx), fy);
  o.z = lerp(lerp(k00.z, k01.z, fx), lerp(k10.z, k11.z, fx), fy);
  o.w = lerp(lerp(k00.w, k01.w, fx), lerp(k10.w, k11.w, fx), fy);
  return o;
}

// sample_rgba(...).w with only the four alpha words loaded
__device__ __forceinline__ float tf_alpha(const TfAt0& q, float x) {
  const float4 *p00, *p01, *p10, *p11;
  float fx;
  tf_texels(q, x, p00, p01, p10, p11, fx);
  const float a00 = __ldg(&p00->w), a01 = __ldg(&p01->w);
  const float a10 = __ldg(&p10->w), a11 = __ldg(&p11->w);
  return lerp(lerp(a00, a01, fx), lerp(a10, a11, fx), q.fy);
}

// this thread's pixel: the warp's 8 x 4 tile of the block's 16 x 8 (the
// blocks a grid over the image's tiles)
__device__ __forceinline__ void march_pixel(int& ix, int& iy) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ix = blockIdx.x * MARCH_TILE_W + (warp & 1) * 8 + (lane & 7);
  iy = blockIdx.y * MARCH_TILE_H + (warp >> 1) * 4 + (lane >> 3);
}

// The march's samples along r at t: the point lerped from entry to exit
__device__ __forceinline__ void ray_point(const CubeRay& r, float t, float& x, float& y,
                                          float& z) {
  x = lerp(r.nx, r.xx, t);
  y = lerp(r.ny, r.xy, t);
  z = lerp(r.nz, r.xz, t);
}

// K15: EAM (composite, renormalize, running average into acc (R, R, 3) with
// the frame count already advanced, or the frame itself into out (R, R, 3)
// when out is given) or Depth (march to the threshold, write the display
// image out (R, R, 3)); MODE the tables' MarchMode. Sample k sits at t =
// step * offset + k * step, which grows with k, so a batch whose last t is
// < 1 has every t < 1: such batches issue their lookups together; the rest
// of the ray runs one sample at a time. Both stop at the first sample with
// t >= 1 or the accumulated opacity past its limit, as the one-sample loop.
template <int KIND, int MODE>
__device__ __forceinline__ void march_ray(const March& P, const void* __restrict__ vol,
                                          const float* __restrict__ tf, float* __restrict__ acc,
                                          const int* __restrict__ frame, float* __restrict__ out,
                                          int ix, int iy) {
  constexpr int B = KIND == EAM ? EAM_BATCH : DEPTH_BATCH;
  const int pix = iy * P.i[RI_RES] + ix;
  const CubeRay r = cube_ray(P.f + RF_INV_MVP, P.f[RF_INV_RES], ix, iy);
  const float step = P.f[RF_STEP], offset = P.f[RF_OFFSET], ext = P.f[RF_EXTINCTION];
  const float rsl = step_length(r, step);
  const int trips = P.i[RI_TRIPS];
  const float t0 = step * offset;
  const TfAt0 q = tf_at0<MODE>(tf, P);
  if (KIND == EAM) {
    float ar = 0.0f, ag = 0.0f, ab = 0.0f, aa = 0.0f;
    if (!r.miss) {
      int k = 0;
      bool live = true;
      for (; k + B <= trips; k += B) {
        if (!(t0 + (float)(k + B - 1) * step < 1.0f) || !(aa < 0.99f)) break;
        float d[B];
#pragma unroll
        for (int j = 0; j < B; ++j) {
          float x, y, z;
          ray_point(r, t0 + (float)(k + j) * step, x, y, z);
          d[j] = mode_density<MODE>(vol, P, x, y, z);
        }
        float4 c[B];
#pragma unroll
        for (int j = 0; j < B; ++j) c[j] = tf_rgba(q, d[j]);
#pragma unroll
        for (int j = 0; j < B; ++j) {
          if (!(aa < 0.99f)) {
            live = false;
            break;
          }
          const float w = (1.0f - aa) * (c[j].w * rsl * ext);
          ar = ar + w * c[j].x;
          ag = ag + w * c[j].y;
          ab = ab + w * c[j].z;
          aa = aa + w;
        }
        if (!live) break;
      }
      for (; live && k < trips; ++k) {
        const float t = t0 + (float)k * step;
        if (!(t < 1.0f) || !(aa < 0.99f)) break;
        float x, y, z;
        ray_point(r, t, x, y, z);
        const float4 c = tf_rgba(q, mode_density<MODE>(vol, P, x, y, z));
        const float w = (1.0f - aa) * (c.w * rsl * ext);
        ar = ar + w * c.x;
        ag = ag + w * c.y;
        ab = ab + w * c.z;
        aa = aa + w;
      }
    }
    // over-saturation renormalization; a miss renders black
    const float scale = (aa > 1.0f) ? __fdiv_rn(1.0f, nmax(aa, 1.0f)) : 1.0f;
    const float img[3] = {r.miss ? 0.0f : ar * scale, r.miss ? 0.0f : ag * scale,
                          r.miss ? 0.0f : ab * scale};
    if (out != nullptr) {  // the frame alone
      float* o = out + (int64_t)pix * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) o[c] = img[c];
      return;
    }
    const float mix = __fdiv_rn(1.0f, (float)__ldg(frame));
    float* a = acc + (int64_t)pix * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) a[c] = a[c] + (img[c] - a[c]) * mix;
  } else {
    const float thr = P.f[RF_THRESHOLD];
    float a = 0.0f, t_stop = -1.0f;
    if (!r.miss) {
      int k = 0;
      bool live = true;
      for (; k + B <= trips; k += B) {
        if (!(t0 + (float)(k + B - 1) * step < 1.0f) || !(a < thr)) break;
        float d[B];
#pragma unroll
        for (int j = 0; j < B; ++j) {
          float x, y, z;
          ray_point(r, t0 + (float)(k + j) * step, x, y, z);
          d[j] = mode_density<MODE>(vol, P, x, y, z);
        }
        float al[B];
#pragma unroll
        for (int j = 0; j < B; ++j) al[j] = tf_alpha(q, d[j]);
#pragma unroll
        for (int j = 0; j < B; ++j) {
          if (!(a < thr)) {
            live = false;
            break;
          }
          a = a + (1.0f - a) * al[j] * rsl * ext;
          if (a >= thr) t_stop = (t0 + (float)(k + j) * step) + step;
        }
        if (!live) break;
      }
      for (; live && k < trips; ++k) {
        const float t = t0 + (float)k * step;
        if (!(t < 1.0f) || !(a < thr)) break;
        float x, y, z;
        ray_point(r, t, x, y, z);
        a = a + (1.0f - a) * tf_alpha(q, mode_density<MODE>(vol, P, x, y, z)) * rsl * ext;
        if (a >= thr) t_stop = t + step;
      }
    }
    const float depth = (r.miss || !(a >= thr)) ? -1.0f : r.tn + (r.tf - r.tn) * t_stop;
    // display: normalized depth as grey, misses white
    const float vis = (depth < 0.0f) ? 1.0f : nmin(nmax(depth, 0.0f), 1.0f);
    float* o = out + (int64_t)pix * 3;
    o[0] = vis;
    o[1] = vis;
    o[2] = vis;
  }
}

// K15's minimum of blocks an SM: EAM's 3 leave ptxas the registers to keep
// a batch's lookups in flight (167 on the u8 table, against 72 without a
// minimum); Depth's short rays keep to 61 at 8 (none spills there)
template <int KIND>
__host__ __device__ constexpr int march_min_blocks() {
  return KIND == EAM ? EAM_MIN_BLOCKS : DEPTH_MIN_BLOCKS;
}

template <int KIND, int MODE>
__global__ void __launch_bounds__(MARCH_THREADS, march_min_blocks<KIND>())
march_kernel(const March P, const void* __restrict__ vol, const float* __restrict__ tf,
             float* __restrict__ acc, const int* __restrict__ frame,
             float* __restrict__ out) {
  int ix, iy;
  march_pixel(ix, iy);
  if (ix < P.i[RI_RES] && iy < P.i[RI_RES])
    march_ray<KIND, MODE>(P, vol, tf, acc, frame, out, ix, iy);
}

// jnp.mod / torch.remainder of x by 1: fmodf, then the divisor's sign
__device__ __forceinline__ float mip_wrap(float x) {
  float o = fmodf(x, 1.0f);
  if (o < 0.0f) o = o + 1.0f;
  return o;
}

// mip_wrap on [0, 2): x < 1 ? x : x - 1 (x - 1 exact by Sterbenz's lemma,
// fmodf's bits)
__device__ __forceinline__ float mip_wrap_02(float x) {
  return x < 1.0f ? x : x - 1.0f;
}

// K16: the maximum TF alpha over the offset-wrapped march, max-merged into
// acc (R, R); MODE the tables' MarchMode. The maximum folds in sample order,
// a batch's lookups issued together. x_k = offset + k * step is monotone in
// k and the same in every thread: where its ends lie in [0, 2), so does
// every x_k, and the march wraps them without fmodf.
template <int MODE>
__device__ __forceinline__ void mip_ray(const March& P, const void* __restrict__ vol,
                                        const float* __restrict__ tf, float* __restrict__ acc,
                                        int ix, int iy) {
  constexpr int B = MIP_BATCH;
  const int pix = iy * P.i[RI_RES] + ix;
  const CubeRay r = cube_ray(P.f + RF_INV_MVP, P.f[RF_INV_RES], ix, iy);
  const float step = P.f[RF_STEP], offset = P.f[RF_OFFSET];
  const int trips = P.i[RI_TRIPS];
  float val = 0.0f;
  if (!r.miss) {
    const TfAt0 q = tf_at0<MODE>(tf, P);
    const float x0 = offset + 0.0f * step, x1 = offset + (float)(trips - 1) * step;
    if (x0 >= 0.0f && x0 < 2.0f && x1 >= 0.0f && x1 < 2.0f) {
      int k = 0;
      for (; k + B <= trips; k += B) {
        float d[B];
#pragma unroll
        for (int j = 0; j < B; ++j) {
          float x, y, z;
          ray_point(r, mip_wrap_02(offset + (float)(k + j) * step), x, y, z);
          d[j] = mode_density<MODE>(vol, P, x, y, z);
        }
        float al[B];
#pragma unroll
        for (int j = 0; j < B; ++j) al[j] = tf_alpha(q, d[j]);
#pragma unroll
        for (int j = 0; j < B; ++j) val = nmax(val, al[j]);
      }
      for (; k < trips; ++k) {
        float x, y, z;
        ray_point(r, mip_wrap_02(offset + (float)k * step), x, y, z);
        val = nmax(val, tf_alpha(q, mode_density<MODE>(vol, P, x, y, z)));
      }
    } else {
      for (int k = 0; k < trips; ++k) {
        float x, y, z;
        ray_point(r, mip_wrap(offset + (float)k * step), x, y, z);
        val = nmax(val, tf_alpha(q, mode_density<MODE>(vol, P, x, y, z)));
      }
    }
  }
  acc[pix] = nmax(acc[pix], val);
}

// a minimum of one block an SM leaves ptxas the registers to keep a
// batch's lookups in flight (77 on the u8 table, against 40 without it)
template <int MODE>
__global__ void __launch_bounds__(MARCH_THREADS, 1)
mip_kernel(const March P, const void* __restrict__ vol, const float* __restrict__ tf,
           float* __restrict__ acc) {
  int ix, iy;
  march_pixel(ix, iy);
  if (ix < P.i[RI_RES] && iy < P.i[RI_RES]) mip_ray<MODE>(P, vol, tf, acc, ix, iy);
}

// K17: the closest sample with alpha >= isovalue, merged into the state's
// closest hit (cx, cy, cz, ct), each (R, R), in place: a new hit replaces
// the old one when it is nearer or the old one is none (t > 0 marks a hit).
__global__ void __launch_bounds__(MARCH_THREADS)
iso_kernel(const March P, const void* __restrict__ vol, const float* __restrict__ tf,
           float* __restrict__ cx, float* __restrict__ cy, float* __restrict__ cz,
           float* __restrict__ ct) {
  const int res = P.i[RI_RES];
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= res * res) return;
  const int iy = pix / res, ix = pix - iy * res;
  const CubeRay r = cube_ray(P.f + RF_INV_MVP, P.f[RF_INV_RES], ix, iy);
  if (r.miss) return;  // t = -1: the merge keeps the state
  const float step = P.f[RF_STEP], offset = P.f[RF_OFFSET], iso = P.f[RF_ISOVALUE];
  const float t_far = 1.0f - offset * step;
  for (int k = P.i[RI_TRIPS] - 1; k >= 0; --k) {
    const float t = t_far - (float)k * step;
    const float x = lerp(r.nx, r.xx, t), y = lerp(r.ny, r.xy, t), z = lerp(r.nz, r.xz, t);
    const float4 c = sample_point(vol, tf, P, x, y, z);
    if (c.w >= iso && t >= 0.0f) {
      const float old = ct[pix];
      const bool both = t > 0.0f && old > 0.0f;
      if ((both && t < old) || (!both && t > 0.0f)) {
        cx[pix] = x;
        cy[pix] = y;
        cz[pix] = z;
        ct[pix] = t;
      }
      return;
    }
  }
}

// K18: Lambert shading at the merged closest hit into out (R, R, 3).
__global__ void __launch_bounds__(MARCH_THREADS)
iso_shade_kernel(const March P, const void* __restrict__ vol, const float* __restrict__ tf,
                 const float* __restrict__ cx, const float* __restrict__ cy,
                 const float* __restrict__ cz, const float* __restrict__ ct,
                 float* __restrict__ out) {
  const int res = P.i[RI_RES];
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= res * res) return;
  float* o = out + (int64_t)pix * 3;
  if (!(__ldg(ct + pix) > 0.0f)) {
    o[0] = 1.0f;
    o[1] = 1.0f;
    o[2] = 1.0f;
    return;
  }
  const float x = __ldg(cx + pix), y = __ldg(cy + pix), z = __ldg(cz + pix);
  const float h = P.f[RF_H];
  const float gx = sample_point(vol, tf, P, x + h, y, z).w - sample_point(vol, tf, P, x - h, y, z).w;
  const float gy = sample_point(vol, tf, P, x, y + h, z).w - sample_point(vol, tf, P, x, y - h, z).w;
  const float gz = sample_point(vol, tf, P, x, y, z + h).w - sample_point(vol, tf, P, x, y, z - h).w;
  const float norm = sqrtf(gx * gx + gy * gy + gz * gz);
  const float inv = __fdiv_rn(1.0f, nmax(norm, 1e-20f));
  const float lambert =
      nmax((gx * P.f[RF_LX] + gy * P.f[RF_LY] + gz * P.f[RF_LZ]) * inv, 0.0f);
  const float4 m = sample_point(vol, tf, P, x, y, z);
  o[0] = m.x * lambert;
  o[1] = m.y * lambert;
  o[2] = m.z * lambert;
}

// ---------------------------------------------------------------------------
// K19: the EAM frame's reverse
// ---------------------------------------------------------------------------
// Most samples a ray may take (slices + 1): K19 keeps each active step's
// opacity before it and its density in the thread's local memory (a float2
// a step, 2 KB a thread at most), because the compositing recurrence cannot
// be run backwards by division (an unclamped a = c.a * ray_step_len * ext
// may reach 1 or more, and then A_k = (A_k+1 - a) / (1 - a) is undefined).
#define EAM_BWD_MAX_TRIPS 256
// widest raw TF whose row-0 gradient a block sums in shared memory (48 KB
// of doubles)
#define EAM_BWD_MAX_TF_W 1536

// K19's threads a block: 256 for the density alone, 128 learning the TF
// (timed in turns, probes/eam_tf_sums.py: 256 took K19<0> 0.75-0.85x the
// time of 128, and K19<1> 1.00-1.05x)
template <bool LEARN_TF>
constexpr int eam_bwd_threads() {
  return LEARN_TF ? 128 : 256;
}

// The raw TF's texels that a classic lookup at (x, 0) reads, and its value
// with sample_rgba's bits: base_frac(0, H) puts v = 0 on rows y0 = y1 = 0
// (fy = 0.5) for every H, so sample_rgba's four texels are row 0's columns
// x0, x1 twice, and its lerps are repeated here on those two.
struct TfRow0 {
  int x0, x1;
  float fx;
  float4 k0, k1;
};

__device__ __forceinline__ float4 tf_row0(const float* __restrict__ tf, const March& P, float x,
                                          TfRow0& q) {
  const int W = P.i[RI_TF_W] - 1;
  int bx, by;
  float fx, fy;
  base_frac(x, W, bx, fx);
  base_frac(0.0f, P.i[RI_TF_H] - 1, by, fy);
  q.x0 = max(bx - 1, 0);
  q.x1 = min(bx, W - 1);
  q.fx = fx;
  const float4* t = reinterpret_cast<const float4*>(tf);
  q.k0 = __ldg(t + q.x0);
  q.k1 = __ldg(t + q.x1);
  float4 o;
  o.x = lerp(lerp(q.k0.x, q.k1.x, fx), lerp(q.k0.x, q.k1.x, fx), fy);
  o.y = lerp(lerp(q.k0.y, q.k1.y, fx), lerp(q.k0.y, q.k1.y, fx), fy);
  o.z = lerp(lerp(q.k0.z, q.k1.z, fx), lerp(q.k0.z, q.k1.z, fx), fy);
  o.w = lerp(lerp(q.k0.w, q.k1.w, fx), lerp(q.k0.w, q.k1.w, fx), fy);
  return o;
}

// The cotangent dd of a raw-grid lookup at (u, v, w) added into g (D, H, W)
// as jax.grad transposes interp.sample_volume: the one voxel read (nearest),
// or the 8 clamped corners by the transposed lerps (quasicubic: the warped
// fractions); corners clamped onto one voxel add up.
__device__ __forceinline__ void scatter_volume_raw(float* __restrict__ g, const March& P, float u,
                                                   float v, float w, float dd) {
  const int Dp = P.i[RI_VOL_D], Hp = P.i[RI_VOL_H], Wp = P.i[RI_VOL_W];
  const int D = Dp - 1, H = Hp - 1, W = Wp - 1;
  if (P.i[RI_NEAREST] != 0) {
    const int x = floor_cell(u, W), y = floor_cell(v, H), z = floor_cell(w, D);
    atomicAdd(g + ((int64_t)z * H + y) * W + x, dd);
    return;
  }
  int x0, x1, y0, y1, z0, z1;
  float fx, fy, fz;
  raw_axis(u, Wp, x0, x1, fx);
  raw_axis(v, Hp, y0, y1, fy);
  raw_axis(w, Dp, z0, z1, fz);
  if (P.i[RI_QUASICUBIC] != 0) {
    fx = quasicubic(fx);
    fy = quasicubic(fy);
    fz = quasicubic(fz);
  }
  // out = c0 + (c1 - c0) fz, c0 = c00 + (c01 - c00) fy, c00 = v000 + (v001 - v000) fx
  const float g1 = dd * fz, g0 = dd - g1;
  const float g01 = g0 * fy, g00 = g0 - g01, g11 = g1 * fy, g10 = g1 - g11;
  const int64_t p00 = ((int64_t)z0 * H + y0) * W, p01 = ((int64_t)z0 * H + y1) * W;
  const int64_t p10 = ((int64_t)z1 * H + y0) * W, p11 = ((int64_t)z1 * H + y1) * W;
  atomicAdd(g + p00 + x0, g00 - g00 * fx);
  atomicAdd(g + p00 + x1, g00 * fx);
  atomicAdd(g + p01 + x0, g01 - g01 * fx);
  atomicAdd(g + p01 + x1, g01 * fx);
  atomicAdd(g + p10 + x0, g10 - g10 * fx);
  atomicAdd(g + p10 + x1, g10 * fx);
  atomicAdd(g + p11 + x0, g11 - g11 * fx);
  atomicAdd(g + p11 + x1, g11 * fx);
}

// K19's TF terms of one thread's current run: the samples whose lookups
// read the same texel pair (x0, x1) of row 0, summed in double in
// registers (channels of x0, then of x1); x0 < 0 before the first sample.
// Along a ray the density changes slowly: every sample in empty space reads
// the pair (0, 0), and a piecewise-constant volume keeps one pair across
// each region, so a run spans many samples.
struct TfRun {
  int x0, x1;
  double s[8];
};

// The run's sums added into the block's row s_tf, one shared atomic per
// channel and texel for each group of the warp's lanes that flush the same
// pair together (__match_any_sync over the lanes that reach the flush): the
// group's sums meet by a tree of shuffles, and its lowest lane adds them.
// A double add on shared memory is a compare-and-swap loop, and a row's
// few hot texels (texel 0 above all) take the whole block's terms, so the
// aggregation keeps the loops from spinning on each other.
__device__ __forceinline__ void flush_tf_run(const TfRun& run, double* s_tf) {
  const unsigned active = __activemask();
  const unsigned key = ((unsigned)run.x0 << 16) | (unsigned)run.x1;
  unsigned peers = __match_any_sync(active, key);
  const int lane = threadIdx.x & 31;
  const bool leader = (peers & ((1u << lane) - 1u)) == 0u;
  double s[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) s[c] = run.s[c];
  // a tree over the group's ranks: in round r the lanes whose rank is a
  // multiple of 2^r add the next remaining peer above them
  int rank = __popc(peers & ((1u << lane) - 1u));
  peers &= 0xfffffffeu << lane;
  while (__any_sync(active, peers != 0u)) {
    const int next = __ffs(peers);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const double t = __shfl_sync(active, s[c], (next - 1) & 31);
      if (next != 0) s[c] += t;
    }
    peers &= ~__ballot_sync(active, rank & 1);
    rank >>= 1;
  }
  if (!leader) return;
  if (run.x0 == run.x1) {  // the row's edge: both corners on one texel
#pragma unroll
    for (int c = 0; c < 4; ++c) atomicAdd(s_tf + run.x0 * 4 + c, s[c] + s[4 + c]);
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    atomicAdd(s_tf + run.x0 * 4 + c, s[c]);
    atomicAdd(s_tf + run.x1 * 4 + c, s[4 + c]);
  }
}

// One pixel of K19. Forward: K15<EAM>'s march replayed with the same
// rounding, taping (A, d) per active step. Then the renormalization's
// adjoint and the compositing recurrence walked backwards. With A the
// opacity before a step, a = c.a * ray_step_len * ext and w = (1 - A) a:
//   lambda_C = scale * g (the RGB sums' adjoint, constant along the ray);
//   lambda_A starts at -(g . C) * scale^2 where A_final > 1 (scale =
//   1 / A_final), else 0; per step from the last, with u = lambda_A +
//   lambda_C . c_rgb (dL/dw): dL/dc_rgb = w lambda_C, dL/da = (1 - A) u,
//   dL/dc.a = dL/da * ext * ray_step_len, lambda_A -= a u.
// dL/dc reaches d through the TF row's slope, (k1 - k0) * W, and the
// texels x0, x1 by the transposed lerp (LEARN_TF: each texel's term in
// float, summed in double in the thread's run, TfRun, which is flushed
// into the block's shared row s_tf when the pair changes and at the ray's
// end).
template <bool LEARN_TF>
__device__ __forceinline__ void eam_backward_pixel(const March& P, const float* __restrict__ vol,
                                                   const float* __restrict__ tf,
                                                   const float* __restrict__ g_img,
                                                   float* __restrict__ g_vol, double* s_tf,
                                                   TfRun& run, int pix) {
  const int res = P.i[RI_RES];
  const int iy = pix / res, ix = pix - iy * res;
  const CubeRay r = cube_ray(P.f + RF_INV_MVP, P.f[RF_INV_RES], ix, iy);
  if (r.miss) return;  // the frame is 0 there whatever the tables
  const float step = P.f[RF_STEP], offset = P.f[RF_OFFSET], ext = P.f[RF_EXTINCTION];
  const float rsl = step_length(r, step);
  const int trips = P.i[RI_TRIPS];
  float2 tape[EAM_BWD_MAX_TRIPS];
  float ar = 0.0f, ag = 0.0f, ab = 0.0f, aa = 0.0f;
  int n = 0;
  for (; n < trips; ++n) {
    const float t = step * offset + (float)n * step;
    if (!(t < 1.0f) || !(aa < 0.99f)) break;
    const float d = march_density(vol, P, lerp(r.nx, r.xx, t), lerp(r.ny, r.xy, t),
                                  lerp(r.nz, r.xz, t));
    const float4 c = march_rgba(tf, P, d);
    tape[n] = make_float2(aa, d);
    const float w = (1.0f - aa) * (c.w * rsl * ext);
    ar = ar + w * c.x;
    ag = ag + w * c.y;
    ab = ab + w * c.z;
    aa = aa + w;
  }
  const float* gp = g_img + (int64_t)pix * 3;
  const float g0 = __ldg(gp), g1 = __ldg(gp + 1), g2 = __ldg(gp + 2);
  const bool over = aa > 1.0f;
  const float scale = over ? __fdiv_rn(1.0f, nmax(aa, 1.0f)) : 1.0f;
  const float lr = g0 * scale, lg = g1 * scale, lb = g2 * scale;
  // d(1 / A)/dA = -(1 / A)^2, as torch.reciprocal's backward takes it
  float lam = over ? -((g0 * ar + g1 * ag + g2 * ab) * (scale * scale)) : 0.0f;
  const float fW = (float)(P.i[RI_TF_W] - 1);
  for (int k = n - 1; k >= 0; --k) {
    const float A = tape[k].x, d = tape[k].y;
    TfRow0 q;
    const float4 c = tf_row0(tf, P, d, q);
    const float a = c.w * rsl * ext;
    const float w = (1.0f - A) * a;
    const float u = lam + (lr * c.x + lg * c.y + lb * c.z);
    const float da = (1.0f - A) * u;
    lam = lam - a * u;
    const float4 gc = make_float4(w * lr, w * lg, w * lb, da * ext * rsl);
    if (LEARN_TF) {
      const float gx[4] = {gc.x, gc.y, gc.z, gc.w};
      if (q.x0 != run.x0 || q.x1 != run.x1) {
        if (run.x0 >= 0) flush_tf_run(run, s_tf);
        run.x0 = q.x0;
        run.x1 = q.x1;
#pragma unroll
        for (int c8 = 0; c8 < 8; ++c8) run.s[c8] = 0.0;
      }
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        const float hi = gx[ch] * q.fx;
        run.s[ch] += (double)(gx[ch] - hi);
        run.s[4 + ch] += (double)hi;
      }
    }
    const float dd = (gc.x * (q.k1.x - q.k0.x) + gc.y * (q.k1.y - q.k0.y) +
                      gc.z * (q.k1.z - q.k0.z) + gc.w * (q.k1.w - q.k0.w)) * fW;
    if (dd != 0.0f) {  // a flat TF column moves nothing (a NaN passes)
      const float t = step * offset + (float)k * step;
      scatter_volume_raw(g_vol, P, lerp(r.nx, r.xx, t), lerp(r.ny, r.xy, t), lerp(r.nz, r.xz, t),
                         dd);
    }
  }
}

// K19: g_vol (D, H, W) += the density's gradient; with LEARN_TF, g_row
// (the TF's row 0, W x 4) += the TF's, summed per block in shared memory
// and flushed once per block: every sample reads row 0, so global atomics
// there would serialise on W x 4 addresses. The row is summed in double:
// a texel takes ~1e6 terms at 512^2 (every empty-space sample lands on
// texel 0's alpha), which under a signed cotangent cancel ~1000-fold, and
// float32 sums then lose ~1e-4 of the result. A thread sums its run of
// samples on one texel pair in registers (TfRun) and a warp's lanes that
// flush one pair together add it once (flush_tf_run), so the block's
// compare-and-swap loops on its few hot texels stay rare.
template <bool LEARN_TF>
__global__ void __launch_bounds__(eam_bwd_threads<LEARN_TF>())
eam_backward_kernel(const March P, const float* __restrict__ vol, const float* __restrict__ tf,
                    const float* __restrict__ g_img, float* __restrict__ g_vol,
                    double* __restrict__ g_row) {
  extern __shared__ double s_tf[];
  const int row = (P.i[RI_TF_W] - 1) * 4;
  if (LEARN_TF) {
    for (int k = threadIdx.x; k < row; k += blockDim.x) s_tf[k] = 0.0;
    __syncthreads();
  }
  TfRun run;
  run.x0 = -1;
  run.x1 = -1;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix < P.i[RI_RES] * P.i[RI_RES])
    eam_backward_pixel<LEARN_TF>(P, vol, tf, g_img, g_vol, s_tf, run, pix);
  if (LEARN_TF) {
    if (run.x0 >= 0) flush_tf_run(run, s_tf);  // the ray's last run
    __syncthreads();
    for (int k = threadIdx.x; k < row; k += blockDim.x)
      if (s_tf[k] != 0.0) atomicAdd(g_row + k, s_tf[k]);
  }
}

bool march_ok(const March& P, const void* vol, const float* tf) {
  return vol != nullptr && tf != nullptr && P.i[RI_RES] > 0 && P.i[RI_TRIPS] >= 0 &&
         (P.i[RI_NEAREST] == 0 || P.i[RI_VOL_RAW] != 0);
}

unsigned march_blocks(const March& P) {
  return (unsigned)blocks_for(P.i[RI_RES] * P.i[RI_RES], MARCH_THREADS);
}

// K15's and K16's instance: RI_MODE a MarchMode whose tables are the ones
// the flags describe (the generic instance takes any)
bool mode_ok(const March& P) {
  const int m = P.i[RI_MODE];
  if (m < 0 || m >= MM_COUNT) return false;
  if (m == MM_GENERIC) return true;
  const bool raw = m == MM_RAW || m == MM_RAW_QC || m == MM_NEAREST;
  const bool qc = m == MM_U8_QC || m == MM_F32_QC || m == MM_RAW_QC;
  return (P.i[RI_VOL_RAW] != 0) == raw && (P.i[RI_TF_RAW] != 0) == raw &&
         (P.i[RI_QUASICUBIC] != 0) == qc && (P.i[RI_NEAREST] != 0) == (m == MM_NEAREST) &&
         (raw || (P.i[RI_VOL_U8] != 0) == (m == MM_U8 || m == MM_U8_QC));
}

// K15's and K16's grid: 16 x 8 pixel tiles
dim3 march_grid(const March& P) {
  return dim3((unsigned)blocks_for(P.i[RI_RES], MARCH_TILE_W),
              (unsigned)blocks_for(P.i[RI_RES], MARCH_TILE_H));
}

}  // namespace

extern "C" {

int vpt_march_layout(int which) {
  switch (which) {
    case 0: return RF_COUNT;
    case 1: return RI_COUNT;
    case 2: return EAM_BWD_MAX_TRIPS;
    case 3: return EAM_BWD_MAX_TF_W;
    default: return -1;
  }
}

// mode 0 (EAM): acc (R*R*3 floats) updated in place, frame a device int
// holding the advanced frame count, out null; or the frame alone: out
// (R*R*3 floats) written, acc and frame null; mode 1 (Depth): out (R*R*3
// floats) written, acc and frame null. The instance: RI_MODE (MarchMode).
int vpt_march(const float* fparams, const int* iparams, int mode, const void* vol,
              const float* tf, float* acc, const int* frame, float* out, void* stream) {
  const March P = make_march(fparams, iparams);
  if (!march_ok(P, vol, tf) || !mode_ok(P)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == EAM) {
    const bool merge = acc != nullptr && frame != nullptr && out == nullptr;
    const bool alone = acc == nullptr && frame == nullptr && out != nullptr;
    if (!merge && !alone) return (int)cudaErrorInvalidValue;
  } else if (mode == DEPTH) {
    if (acc != nullptr || frame != nullptr || out == nullptr) return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid = march_grid(P);
  switch (P.i[RI_MODE] * 2 + mode) {
#define VPT_MARCH_MODE(M)                                                                       \
  case M * 2 + EAM:                                                                             \
    march_kernel<EAM, M><<<grid, MARCH_THREADS, 0, st>>>(P, vol, tf, acc, frame, out);          \
    break;                                                                                      \
  case M * 2 + DEPTH:                                                                           \
    march_kernel<DEPTH, M><<<grid, MARCH_THREADS, 0, st>>>(P, vol, tf, acc, frame, out);        \
    break;
    VPT_MARCH_MODE(MM_U8) VPT_MARCH_MODE(MM_F32) VPT_MARCH_MODE(MM_U8_QC)
    VPT_MARCH_MODE(MM_F32_QC) VPT_MARCH_MODE(MM_RAW) VPT_MARCH_MODE(MM_RAW_QC)
    VPT_MARCH_MODE(MM_NEAREST) VPT_MARCH_MODE(MM_GENERIC)
#undef VPT_MARCH_MODE
  }
  return (int)cudaGetLastError();
}

// The instance: RI_MODE (MarchMode).
int vpt_mip(const float* fparams, const int* iparams, const void* vol, const float* tf,
            float* acc, void* stream) {
  const March P = make_march(fparams, iparams);
  if (!march_ok(P, vol, tf) || !mode_ok(P) || acc == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid = march_grid(P);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P.i[RI_MODE]) {
#define VPT_MIP_MODE(M)                                                                         \
  case M:                                                                                       \
    mip_kernel<M><<<grid, MARCH_THREADS, 0, st>>>(P, vol, tf, acc);                             \
    break;
    VPT_MIP_MODE(MM_U8) VPT_MIP_MODE(MM_F32) VPT_MIP_MODE(MM_U8_QC) VPT_MIP_MODE(MM_F32_QC)
    VPT_MIP_MODE(MM_RAW) VPT_MIP_MODE(MM_RAW_QC) VPT_MIP_MODE(MM_NEAREST)
    VPT_MIP_MODE(MM_GENERIC)
#undef VPT_MIP_MODE
  }
  return (int)cudaGetLastError();
}

int vpt_iso(const float* fparams, const int* iparams, const void* vol, const float* tf,
            float* cx, float* cy, float* cz, float* ct, void* stream) {
  const March P = make_march(fparams, iparams);
  if (!march_ok(P, vol, tf) || !cx || !cy || !cz || !ct) return (int)cudaErrorInvalidValue;
  iso_kernel<<<march_blocks(P), MARCH_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      P, vol, tf, cx, cy, cz, ct);
  return (int)cudaGetLastError();
}

int vpt_iso_shade(const float* fparams, const int* iparams, const void* vol, const float* tf,
                  const float* cx, const float* cy, const float* cz, const float* ct,
                  float* out, void* stream) {
  const March P = make_march(fparams, iparams);
  if (!march_ok(P, vol, tf) || !cx || !cy || !cz || !ct || !out)
    return (int)cudaErrorInvalidValue;
  iso_shade_kernel<<<march_blocks(P), MARCH_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      P, vol, tf, cx, cy, cz, ct, out);
  return (int)cudaGetLastError();
}

// K19: g_vol (D*H*W floats, zeroed by the caller) += the density's
// gradient of <g_img, eam_frame> for the cotangent g_img (R*R*3 floats);
// g_row (W*4 doubles, zeroed) += the gradient of the raw TF's row 0, the
// only row a classic lookup reads, when not null. The volume must be a raw
// grid and the TF a raw texture, the parameter block as K15<EAM>'s.
int vpt_eam_backward(const float* fparams, const int* iparams, const float* vol, const float* tf,
                     const float* g_img, float* g_vol, double* g_row, void* stream) {
  const March P = make_march(fparams, iparams);
  if (!march_ok(P, vol, tf) || P.i[RI_VOL_RAW] == 0 || P.i[RI_TF_RAW] == 0 || g_img == nullptr ||
      g_vol == nullptr || P.i[RI_TRIPS] > EAM_BWD_MAX_TRIPS ||
      P.i[RI_TF_W] - 1 > EAM_BWD_MAX_TF_W)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vol);
  const int pixels = P.i[RI_RES] * P.i[RI_RES];
  if (g_row != nullptr) {
    constexpr int threads = eam_bwd_threads<true>();
    const size_t smem = (size_t)(P.i[RI_TF_W] - 1) * 4 * sizeof(double);
    eam_backward_kernel<true><<<blocks_for(pixels, threads), threads, smem, st>>>(
        P, v, tf, g_img, g_vol, g_row);
  } else {
    constexpr int threads = eam_bwd_threads<false>();
    eam_backward_kernel<false><<<blocks_for(pixels, threads), threads, 0, st>>>(
        P, v, tf, g_img, g_vol, g_row);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
