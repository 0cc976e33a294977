// Local ambient occlusion + soft shadows (LAO) kernel for Hopper (sm_90a),
// plain C interface.
//
//   K25 lao_frame_kernel<LAO, SHADOWS>
//                         replaces vpt_tpu/models/lao.py::lao_frame (:51-158):
//                         the whole frame, (R, R, 3). LAO and SHADOWS are the
//                         reference's static lao_enabled and shadows_enabled.
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
// f32, linear or quasicubic) or a raw (D, H, W) f32 grid (also nearest),
// runtime flags as in K15. The reference's dead code (the half vector hx,
// hy, hz and inv_g, lao.py:104, :107-109) is not computed.
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
// samples of 28 volume lookups and 1 TF lookup, up to ~0.48 G lookups a
// frame against K15's 3.55 M, each cone lookup waiting on a sqrt and two
// divisions; a warp pays for its longest ray (chip_smoke.py phase 25 counts
// the trips per ray).
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

struct LaoP {
  float f[LF_COUNT];
  int i[LI_COUNT];
};

__device__ __forceinline__ float lao_volume(const void* vol, const LaoP& P, float x, float y,
                                            float z) {
  return sample_volume_flags(vol, P.i[LI_VOL_RAW], P.i[LI_VOL_U8], P.i[LI_VOL_D], P.i[LI_VOL_H],
                             P.i[LI_VOL_W], P.i[LI_QUASICUBIC] != 0, P.i[LI_NEAREST] != 0, x,
                             y, z);
}

// rand2's first uniform: fract(cos(dx) * 1235.6789), dx = 23.14... * px +
// 2.665... * py (the second, from sin, no pixel reads)
__device__ __forceinline__ float rand2_x(float px, float py) {
  const float dx = F32(23.14069263277926) * px + F32(2.665144142690225) * py;
  const float mx = cosf(dx) * F32(1235.6789);
  return mx - floorf(mx);
}

__device__ __forceinline__ float clamp01(float x) { return nmin(nmax(x, 0.0f), 1.0f); }

// K25: one LAO frame into out (R, R, 3). cone: LI_CONE float2 (tt, (1 - tt)^2).
template <bool LAO, bool SHADOWS>
__global__ void __launch_bounds__(LAO_THREADS)
lao_frame_kernel(const LaoP P, const void* __restrict__ vol, const float* __restrict__ tf,
                 const float2* __restrict__ cone, float* __restrict__ out) {
  const int res = P.i[LI_RES];
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= res * res) return;
  const int iy = pix / res, ix = pix - iy * res;
  float* o = out + (int64_t)pix * 3;
  const CubeRay r = cube_ray(P.f + LF_INV_MVP, P.f[LF_INV_RES], ix, iy);
  if (r.miss) {
    o[0] = 0.0f;
    o[1] = 0.0f;
    o[2] = 0.0f;
    return;
  }
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
    const float gx = lao_volume(vol, P, p0 - h, p1, p2) - lao_volume(vol, P, p0 + h, p1, p2);
    const float gy = lao_volume(vol, P, p0, p1 - h, p2) - lao_volume(vol, P, p0, p1 + h, p2);
    const float gz = lao_volume(vol, P, p0, p1, p2 - h) - lao_volume(vol, P, p0, p1, p2 + h);
    const float gmag = sqrtf(gx * gx + gy * gy + gz * gz);
    const float value = lao_volume(vol, P, p0, p1, p2);

    float lao = 0.0f;
    if (LAO) {
      float acc_lao = 0.0f;
      for (int i = 0; i < n_cone; ++i) {
        const float2 c = __ldg(cone + i);  // (tt, (1 - tt)^2)
        const float d = lao_dx * (lr * c.x);
        const float jx = lx + d - p0, jy = ly + d - p1, jz = lz + d - p2;
        const float jn = sqrtf(jx * jx + jy * jy + jz * jz);
        const float s = lao_volume(vol, P, p0 + __fdiv_rn(jx, jn) * c.x,
                                   p1 + __fdiv_rn(jy, jn) * c.x, p2 + __fdiv_rn(jz, jn) * c.x);
        acc_lao = acc_lao + s * c.y;
      }
      lao = clamp01(__fdiv_rn(acc_lao, coef));
    }
    float shadow = 0.0f;
    if (SHADOWS) {
      const float s = lao_volume(vol, P, p0 + sdx * lr, p1 + sdy * lr, p2 + sdz * lr);
      const float contrib = s * (s * F32(0.2)) * rx;
      shadow = clamp01(contrib * 20.0f);
      shadow = clamp01(__fdiv_rn(bias + shadow * F32(1.2), F32(1.3)));
    }

    const float4 c4 = sample_tex2d_rgba(tf, P.i[LI_TF_RAW] != 0, P.i[LI_TF_H], P.i[LI_TF_W],
                                        value, gmag);
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
// float pairs on the device; lao, shadows: the template flags
int vpt_lao_frame(const float* fparams, const int* iparams, int lao, int shadows,
                  const void* vol, const float* tf, const float* cone, float* out,
                  void* stream) {
  LaoP P;
  for (int k = 0; k < LF_COUNT; ++k) P.f[k] = fparams[k];
  for (int k = 0; k < LI_COUNT; ++k) P.i[k] = iparams[k];
  const int res = P.i[LI_RES];
  if (res <= 0 || P.i[LI_TRIPS] < 0 || vol == nullptr || tf == nullptr || out == nullptr ||
      (lao != 0 && (cone == nullptr || P.i[LI_CONE] < 0)) ||
      (P.i[LI_NEAREST] != 0 && P.i[LI_VOL_RAW] == 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)blocks_for(res * res, LAO_THREADS);
  const float2* c = reinterpret_cast<const float2*>(cone);
  if (lao != 0 && shadows != 0)
    lao_frame_kernel<true, true><<<blocks, LAO_THREADS, 0, st>>>(P, vol, tf, c, out);
  else if (lao != 0)
    lao_frame_kernel<true, false><<<blocks, LAO_THREADS, 0, st>>>(P, vol, tf, c, out);
  else if (shadows != 0)
    lao_frame_kernel<false, true><<<blocks, LAO_THREADS, 0, st>>>(P, vol, tf, c, out);
  else
    lao_frame_kernel<false, false><<<blocks, LAO_THREADS, 0, st>>>(P, vol, tf, c, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
