// The step kernels as they were before their redesign for Hopper, kept
// unchanged below the blank line so that chip_smoke.py can build and time
// them beside the current ones (kernels/_build.py: load(BASELINE_DIR)).
// Nothing else loads them.

// Device code shared by the spectral MCM forward (mcm_spectral.cu) and the
// packed-adjoint backward (spectral_backward.cu): the parameter block, the
// hash chain and draws, the packed-table lookups, and one Woodcock step.
//
// Both kernels run the SAME step function, so the taped forward of the
// backward leaves a state bit-identical to the forward step kernel's: the
// tape is an optional per-step record (REC = true) that only adds stores.
// The forward's other modes are compile-time parameters too (MAJ: the
// super-voxel majorant, ENV: the environment map), so the default
// instantiation compiles to the code it had before they existed; the
// quasicubic weight warp is a uniform runtime flag (I_QUASICUBIC).
//
// Numerics (see mcm_spectral.cu): built without fast math and with
// -fmad=false; IEEE division and sqrt; accurate logf/sinf/cosf; u8 codes
// dequantize by IEEE division; min/max propagate NaN like jnp/torch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_BINS 32

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
  I_COUNT,
};

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

// where a trilinear lookup read: its corner row and fractions
struct VolAddr {
  int row;
  float fx, fy, fz;
};

// smoothstep weight warp of the quasicubic filter, f*f*(3 - 2f)
__device__ __forceinline__ float quasicubic(float f) {
  return f * f * (3.0f - 2.0f * f);
}

// trilinear (or, with qc, quasicubic) sample of a flat (rows, 8) corner
// table, padded dims (Dp,Hp,Wp)
__device__ __forceinline__ float sample_volume(const void* table, int is_u8,
                                               int Dp, int Hp, int Wp, float u,
                                               float v, float w, VolAddr* addr,
                                               bool qc = false) {
  int bx, by, bz;
  float fx, fy, fz;
  base_frac(u, Wp - 1, bx, fx);
  base_frac(v, Hp - 1, by, fy);
  base_frac(w, Dp - 1, bz, fz);
  if (qc) {
    fx = quasicubic(fx);
    fy = quasicubic(fy);
    fz = quasicubic(fz);
  }
  const int64_t row = ((int64_t)bz * Hp + by) * Wp + bx;
  if (addr != nullptr) {
    addr->row = (int)row;
    addr->fx = fx; addr->fy = fy; addr->fz = fz;
  }
  float c[8];
  if (is_u8) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const uint8_t*>(table) + row * 8));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[k] = __fdiv_rn((float)((raw.x >> (8 * k)) & 0xFFu), 255.0f);
      c[4 + k] = __fdiv_rn((float)((raw.y >> (8 * k)) & 0xFFu), 255.0f);
    }
  } else {
    const float4* r = reinterpret_cast<const float4*>(
        static_cast<const float*>(table) + row * 8);
    const float4 a = __ldg(r), b = __ldg(r + 1);
    c[0] = a.x; c[1] = a.y; c[2] = a.z; c[3] = a.w;
    c[4] = b.x; c[5] = b.y; c[6] = b.z; c[7] = b.w;
  }
  const float c00 = lerp(c[0], c[1], fx);
  const float c01 = lerp(c[2], c[3], fx);
  const float c10 = lerp(c[4], c[5], fx);
  const float c11 = lerp(c[6], c[7], fx);
  const float c0 = lerp(c00, c01, fy);
  const float c1 = lerp(c10, c11, fy);
  return lerp(c0, c1, fz);
}

// where a TF lookup read: its row, fractions, and the per-channel slope
// d(value)/d(density coordinate) = (x-lerped row1 - row0) * (Hp - 1)
struct TfAddr {
  int row;
  float fx, fy;
  float slope[3];
};

// bilinear sample of the fused (Hp, Wp, 18) TF+light table at (u, v):
// channels 0..2 of the TF and the light pair lerped by fx alone
__device__ __forceinline__ void sample_tf(const float* tf, int Hp, int Wp,
                                          float u, float v, float mat[3],
                                          float& light, TfAddr* addr) {
  int bx, by;
  float fx, fy;
  base_frac(u, Wp - 1, bx, fx);
  base_frac(v, Hp - 1, by, fy);
  const float* r = tf + ((int64_t)by * Wp + bx) * 18;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float c0 = lerp(__ldg(r + c), __ldg(r + 4 + c), fx);
    const float c1 = lerp(__ldg(r + 8 + c), __ldg(r + 12 + c), fx);
    mat[c] = lerp(c0, c1, fy);
    if (addr != nullptr) addr->slope[c] = (c1 - c0) * (float)(Hp - 1);
  }
  light = lerp(__ldg(r + 16), __ldg(r + 17), fx);
  if (addr != nullptr) {
    addr->row = by * Wp + bx;
    addr->fx = fx;
    addr->fy = fy;
  }
}

// escape radiance from a packed (He+1, We+1, 12) equirect map: the
// reference's mapping (y quirk kept), the wavelength's channel (< 500 nm
// blue, < 600 green, else red), gain 2.7. |dy| may exceed 1 by an ulp:
// asinf then gives NaN, which base_frac maps to row 0 like the plain
// version, and the NaN frac carries into the value as it does there.
__device__ __forceinline__ float sample_environment(const float* env, int Hp,
                                                    int Wp, float dx, float dy,
                                                    float dz, float lam) {
  const float u = atan2f(dx, -dz) * kInvPi * 0.5f + 0.5f;
  const float v = asinf(-dy) * 2.0f * kInvPi * 0.5f + 0.5f;
  int bx, by;
  float fx, fy;
  base_frac(u, Wp - 1, bx, fx);
  base_frac(v, Hp - 1, by, fy);
  const float* r = env + ((int64_t)by * Wp + bx) * 12;
  const int c = (lam < 500.0f) ? 2 : ((lam < 600.0f) ? 1 : 0);
  const float c0 = lerp(__ldg(r + c), __ldg(r + 3 + c), fx);
  const float c1 = lerp(__ldg(r + 6 + c), __ldg(r + 9 + c), fx);
  return lerp(c0, c1, fy) * kEnvGain;
}

// majorant grid cell along one axis from the pre-step position:
// clip(int(floor(p * n)), 0, n - 1), the f32 -> int conversion saturating
// (NaN -> 0) as XLA's does
__device__ __forceinline__ int majorant_cell(float p, int n) {
  const float c = floorf(p * (float)n);
  const float cc = (c != c) ? 0.0f : fminf(fmaxf(c, -kIntLimit), kIntLimit);
  return min(max((int)cc, 0), n - 1);
}

__device__ __forceinline__ void apply_homogeneous(const float* m, float x,
                                                  float y, float z, float& ox,
                                                  float& oy, float& oz) {
  float r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r[i] = m[4 * i] * x + m[4 * i + 1] * y + m[4 * i + 2] * z + m[4 * i + 3] * 1.0f;
  }
  ox = r[0] / r[3];
  oy = r[1] / r[3];
  oz = r[2] / r[3];
}

struct Ray {
  float px, py, pz, dx, dy, dz, lam;
  int bin;
};

// PhotonSpectral_reset: new camera ray + hero wavelength.
// Draw order: disk(2) + square(2) inside unprojectRand, then wavelength(1).
__device__ Ray respawn(uint32_t& s, float sx, float sy, const Params& P) {
  const float* f = P.f;
  const float u1 = draw(s);
  const float u2 = draw(s);
  const float radius = sqrtf(u1);
  const float angle = u2 * kTwoPi;
  const float ox = radius * cosf(angle);
  const float oy = radius * sinf(angle);
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
  const float inv = 1.0f / sqrtf(vx * vx + vy * vy + vz * vz);
  Ray r;
  r.dx = vx * inv;
  r.dy = vy * inv;
  r.dz = vz * inv;
  const float t0x = (0.0f - fx) / r.dx, t0y = (0.0f - fy) / r.dy, t0z = (0.0f - fz) / r.dz;
  const float t1x = (1.0f - fx) / r.dx, t1y = (1.0f - fy) / r.dy, t1z = (1.0f - fz) / r.dz;
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

// Henyey-Greenstein direction about d (sphere draw + cosine draw where
// |g| >= EPS), in the order and rounding of sampling.draw_hg
__device__ __forceinline__ void draw_hg(uint32_t& s, float g, float& dx,
                                        float& dy, float& dz) {
  const float u1 = draw(s);
  const float u2 = draw(s);
  const float radius = sqrtf(u1);
  const float angle = u2 * kTwoPi;
  const float kx = radius * cosf(angle);
  const float ky = radius * sinf(angle);
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

// One lane's photon state, held in registers across a launch.
struct Lane {
  float px, py, pz, dx, dy, dz, lam;
  int bounces, samples, bin;
};

// What the packed-adjoint backward needs from one step (the `collect`
// internals of the JAX _render_body, reduced to the taped fields).
struct StepRecord {
  float dist, emitted, alpha, albedo, g, hg_cos, light_w;
  int pre_bin;
  bool respawn, null_event, scatter;
  TfAddr tf;
  VolAddr vol;
};

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
template <int NB, bool REC, bool MAJ = false, bool ENV = false>
__device__ __forceinline__ void woodcock_step(Lane& L, float (&rad)[NB],
                                              uint32_t& s, float sx, float sy,
                                              const Params& P,
                                              const void* __restrict__ vol,
                                              const float* __restrict__ tf,
                                              StepRecord* rec,
                                              const float2* __restrict__ maj = nullptr,
                                              const float* __restrict__ env = nullptr) {
  static_assert(!(REC && (MAJ || ENV)), "the taped step has no majorant or env mode");
  const float* f = P.f;
  // free flight
  float dist, m = 0.0f;
  bool capped = false;
  if constexpr (MAJ) {
    const int cz = majorant_cell(L.pz, P.i[I_MAJ_GZ]);
    const int cy = majorant_cell(L.py, P.i[I_MAJ_GY]);
    const int cx = majorant_cell(L.px, P.i[I_MAJ_GX]);
    const float2 row = __ldg(maj + ((int64_t)cz * P.i[I_MAJ_GY] + cy) * P.i[I_MAJ_GX] + cx);
    m = nmax(row.x, 1e-12f);
    const float rate = f[F_EXTINCTION] * m;
    dist = -logf(draw(s)) / rate;
    capped = dist >= row.y;
    dist = nmin(dist, row.y);
  } else {
    dist = -logf(draw(s)) / f[F_EXTINCTION];
  }
  const float npx = L.px + dist * L.dx;
  const float npy = L.py + dist * L.dy;
  const float npz = L.pz + dist * L.dz;
  const bool oob = (npx > 1.0f) | (npx < 0.0f) | (npy > 1.0f) |
                   (npy < 0.0f) | (npz > 1.0f) | (npz < 0.0f);
  // material lookup (sampled even when out of bounds, like the reference)
  float mat[3] = {0.0f, 0.0f, 0.0f}, light_raw = 0.0f;
  if (!(MAJ && capped && !oob)) {
    const float t = (L.lam - 400.0f) / 300.0f;
    const float dens = sample_volume(vol, P.i[I_VOL_U8], P.i[I_VOL_D], P.i[I_VOL_H],
                                     P.i[I_VOL_W], npx, npy, npz,
                                     REC ? &rec->vol : nullptr, P.i[I_QUASICUBIC] != 0);
    sample_tf(tf, P.i[I_TF_H], P.i[I_TF_W], t, dens, mat, light_raw,
              REC ? &rec->tf : nullptr);
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
  if (oob) {
    if constexpr (ENV) {
      emitted = sample_environment(env, P.i[I_ENV_H], P.i[I_ENV_W], L.dx, L.dy,
                                   L.dz, L.lam);
    } else {
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
    // pathwise d(emitted)/d(light texel) weight at escape
    rec->light_w = oob ? (isotropic ? 1.0f : (emitted > 0.0f ? ddot : 0.0f)) * 5.0f : 0.0f;
    rec->hg_cos = 0.0f;
  }
  if (oob || absorb) {
    // incremental one-hot mean over all bins, then a new camera path
    L.samples += 1;
    const float denom = (float)max(L.samples, 1);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const float target = (b == L.bin) ? emitted : 0.0f;
      rad[b] = rad[b] + (target - rad[b]) / denom;
    }
    const Ray r = respawn(s, sx, sy, P);
    L.px = r.px; L.py = r.py; L.pz = r.pz;
    L.dx = r.dx; L.dy = r.dy; L.dz = r.dz;
    L.lam = r.lam; L.bin = r.bin;
    L.bounces = 0;
  } else {
    L.px = npx; L.py = npy; L.pz = npz;
    if (scatter) {
      const float ox = L.dx, oy = L.dy, oz = L.dz;
      draw_hg(s, g, L.dx, L.dy, L.dz);
      L.bounces += 1;
      if (REC) rec->hg_cos = L.dx * ox + L.dy * oy + L.dz * oz;
    }
  }
}

Params make_params(const float* fparams, const int* iparams) {
  Params P;
  for (int k = 0; k < F_COUNT; ++k) P.f[k] = fparams[k];
  for (int k = 0; k < I_COUNT; ++k) P.i[k] = iparams[k];
  return P;
}

inline int blocks_for(int n, int threads) { return (n + threads - 1) / threads; }

}  // namespace
