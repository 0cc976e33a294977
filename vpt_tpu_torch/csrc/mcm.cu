// RGB MCM kernels for Hopper (sm_90a), plain C interface.
//
//   K20 mcm_step_kernel   replaces vpt_tpu/models/mcm.py::_render_body
//                         (:111-168) looped by render (:173-185) and
//                         render_many (:190-212), and, over a lane table,
//                         mcm_compact.py::render_compact_many (:55-75).
//   K21 mcm_reset_kernel  replaces vpt_tpu/models/mcm.py::full_reset
//                         (:94-108) and mcm_compact.py::compact_reset
//                         (:33-48).
//
// One thread per photon lane, as the spectral step (K1, mcm_spectral.cu):
// K20 holds the lane's state (6 position/direction words, 2 counters, RGB
// transmittance and radiance) in registers across all K dispatches x
// `steps` Woodcock iterations and reads and writes it once per launch. The
// RNG is re-seeded per dispatch from hash3(ix, iy, seed_k), as the JAX
// version does. Per lane-step: the flight, one volume lookup and one TF
// lookup inside the volume (none for a lane that leaves it: its wheel
// cannot take an event), the wheel; on an escape one equirect lookup of
// the raw (He, We, 3) environment map (four 12-byte texels, scalar loads);
// a respawn or an HG scatter drawing one shared disk point first
// (mcm_common.cuh draw_disk), as K1 does.
//
// The step differs from the spectral one (so it is its own function, over
// mcm_common.cuh's pieces): the respawn draws no wavelength
// (camera_ray_from_disk); the material is the classic 2D TF's RGBA at
// (density, 0) (sample_rgba), P_scatter = alpha * max(r, g, b), and a
// scatter multiplies the transmittance by the TF's rgb and samples HG with
// the global anisotropy; the escape reads all three channels of the raw map
// with -dy clipped to [-1, 1] and no gain (mcm_common.cuh sample_env_rgb), at
// the pre-step direction; the deposit is a running mean of the three channels.
//
// Modes, all uniform runtime flags of the one instantiation: the volume a
// packed "full" corner table (u8 or f32, linear or quasicubic) or a raw
// (D, H, W) f32 grid (linear, quasicubic or nearest); the TF the packed
// (257, 257, 16) corner table or the raw (256, 256, 4) texture; an optional
// lane table (hit-lane compaction, one stream: a lane seeds from its
// pixel's (ix, iy)).
//
// What bounds it on this card: as K1, instruction issue per lane-step (the
// state is read and written once per launch, ~112 bytes a lane, and the
// bench tables sit in the L2), a respawning lane-step costing as much as
// one inside the volume.
//
// Numerics: built without fast math and with -fmad=false, so every
// expression rounds as the plain PyTorch version's (kernels/mcm.py); the
// flight's and the deposit's quotients are IEEE's, sqrt is IEEE,
// logf/sinf/cosf/atan2f/asinf the accurate forms, min/max propagate NaN
// like torch. The forward has no atomics, so the kernel equals its plain
// version bit for bit.

#include "mcm_common.cuh"

namespace {

#define MCM_THREADS 128

// parameter block layout, mirrored by vpt_tpu_torch/kernels/mcm.py
enum McmF {
  MF_INV_MVP = 0,  // 16 floats, row-major
  MF_EXTINCTION = 16,
  MF_BLUR,
  MF_INV_RES,
  MF_ANISOTROPY,
  MF_COUNT,
};
enum McmI {
  MI_MAX_BOUNCES = 0, MI_STEPS, MI_N_SEEDS, MI_RES, MI_N_LANES,
  MI_VOL_RAW,      // 1: a raw (D, H, W) f32 grid, given as D+1, H+1, W+1
  MI_VOL_U8,       // packed table: 1 u8, 0 f32
  MI_VOL_D, MI_VOL_H, MI_VOL_W,
  MI_QUASICUBIC,
  MI_NEAREST,      // raw grid only
  MI_TF_RAW,       // 1: a raw (H, W, 4) texture, given as H+1, W+1
  MI_TF_H, MI_TF_W,
  MI_ENV_H, MI_ENV_W,  // the raw map's He, We
  MI_COUNT,
};

struct McmParams {
  float f[MF_COUNT];
  int i[MI_COUNT];
};

// One lane's RGB photon state, held in registers across a launch.
struct McmLane {
  float px, py, pz, dx, dy, dz;
  int bounces, samples;
  float tr, tg, tb, rr, rg, rb;
};

// the state arrays, in the JAX PhotonState's leaf order
struct McmState {
  float *px, *py, *pz, *dx, *dy, *dz;
  int *bounces, *samples;
  float *tr, *tg, *tb, *rr, *rg, *rb;
};

__device__ __forceinline__ float mcm_density(const void* vol, const McmParams& P, float u,
                                             float v, float w) {
  if (P.i[MI_VOL_RAW] != 0)
    return sample_volume_raw(static_cast<const float*>(vol), P.i[MI_VOL_D], P.i[MI_VOL_H],
                             P.i[MI_VOL_W], u, v, w, P.i[MI_QUASICUBIC] != 0,
                             P.i[MI_NEAREST] != 0);
  return sample_volume(vol, P.i[MI_VOL_U8], P.i[MI_VOL_D], P.i[MI_VOL_H], P.i[MI_VOL_W], u, v,
                       w, nullptr, P.i[MI_QUASICUBIC] != 0, false);
}

// the lane's pixel and screen point: from the lane table when given, else
// lane = iy * res + ix of the (H, W) grid
__device__ __forceinline__ void mcm_pixel(int lane, const McmParams& P,
                                          const uint32_t* __restrict__ lane_ix,
                                          const uint32_t* __restrict__ lane_iy, uint32_t& ix,
                                          uint32_t& iy, float& sx, float& sy) {
  const float inv_res = P.f[MF_INV_RES];
  if (lane_ix == nullptr) {
    const int res = P.i[MI_RES];
    iy = (uint32_t)(lane / res);
    ix = (uint32_t)(lane - (int)iy * res);
  } else {
    ix = __ldg(lane_ix + lane);
    iy = __ldg(lane_iy + lane);
  }
  sx = (((float)ix + 0.5f) * inv_res - 0.5f) * 2.0f;
  sy = (((float)iy + 0.5f) * inv_res - 0.5f) * -2.0f;
}

// a new camera path (resetPhoton) from the disk point (kx, ky) already drawn
__device__ __forceinline__ void mcm_respawn(McmLane& L, uint32_t& s, float kx, float ky, float sx,
                                            float sy, const McmParams& P) {
  Ray r;
  camera_ray_from_disk(s, kx, ky, sx, sy, P.f + MF_INV_MVP, P.f[MF_BLUR], P.f[MF_INV_RES], r);
  L.px = r.px; L.py = r.py; L.pz = r.pz;
  L.dx = r.dx; L.dy = r.dy; L.dz = r.dz;
}

// One Woodcock iteration of one lane (the JAX _render_body). Draws: the
// flight, the wheel, then a respawn's disk + square or a scatter's disk (+
// the HG cosine where |g| >= EPS).
__device__ __forceinline__ void mcm_woodcock_step(McmLane& L, uint32_t& s, float sx, float sy,
                                                  const McmParams& P, const Recip& ext,
                                                  const void* __restrict__ vol,
                                                  const float* __restrict__ tf,
                                                  const float* __restrict__ env) {
  const float dist = quot(-logf(draw(s)), ext);
  const float npx = L.px + dist * L.dx;
  const float npy = L.py + dist * L.dy;
  const float npz = L.pz + dist * L.dz;
  const bool oob = (npx > 1.0f) | (npx < 0.0f) | (npy > 1.0f) | (npy < 0.0f) | (npz > 1.0f) |
                   (npz < 0.0f);
  // the material (a lane outside the volume takes no event, so reads none)
  float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (!oob)
    c = sample_rgba(tf, P.i[MI_TF_RAW] != 0, P.i[MI_TF_H], P.i[MI_TF_W],
                    mcm_density(vol, P, npx, npy, npz));
  const float p_null = 1.0f - c.w;
  const float max3 = nmax(c.x, nmax(c.y, c.z));
  const float p_scatter = (L.bounces >= P.i[MI_MAX_BOUNCES]) ? 0.0f : c.w * max3;
  const float p_absorb = (1.0f - p_null) - p_scatter;
  const float wheel = draw(s);
  const bool absorb = !oob && (wheel < p_absorb);
  const bool scatter = !oob && !absorb && (wheel < p_absorb + p_scatter);
  const bool respawn = oob || absorb;
  float kx = 0.0f, ky = 0.0f;
  if (respawn || scatter) draw_disk(s, kx, ky);
  if (respawn) {
    // the escape's environment at the pre-step direction (0 on an absorb),
    // then the running mean over the lane's samples
    float er = 0.0f, eg = 0.0f, eb = 0.0f;
    if (oob) {
      const float3 e = sample_env_rgb(env, P.i[MI_ENV_H], P.i[MI_ENV_W], L.dx, L.dy, L.dz);
      er = L.tr * e.x;
      eg = L.tg * e.y;
      eb = L.tb * e.z;
    }
    L.samples += 1;
    const float denom = (float)max(L.samples, 1);
    L.rr = L.rr + __fdiv_rn(er - L.rr, denom);
    L.rg = L.rg + __fdiv_rn(eg - L.rg, denom);
    L.rb = L.rb + __fdiv_rn(eb - L.rb, denom);
    mcm_respawn(L, s, kx, ky, sx, sy, P);
    L.bounces = 0;
    L.tr = 1.0f; L.tg = 1.0f; L.tb = 1.0f;
  } else {
    L.px = npx; L.py = npy; L.pz = npz;
    if (scatter) {
      draw_hg(s, kx, ky, P.f[MF_ANISOTROPY], L.dx, L.dy, L.dz);
      L.bounces += 1;
      L.tr = L.tr * c.x;
      L.tg = L.tg * c.y;
      L.tb = L.tb * c.z;
    }
  }
}

// K20: K dispatches x `steps` Woodcock iterations per lane, in place.
__global__ void __launch_bounds__(MCM_THREADS)
mcm_step_kernel(const McmParams P, McmState S, const void* __restrict__ vol,
                const float* __restrict__ tf, const float* __restrict__ env,
                const uint32_t* __restrict__ lane_ix, const uint32_t* __restrict__ lane_iy,
                const uint32_t* __restrict__ seeds) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= P.i[MI_N_LANES]) return;
  uint32_t ix, iy;
  float sx, sy;
  mcm_pixel(lane, P, lane_ix, lane_iy, ix, iy, sx, sy);
  McmLane L;
  L.px = S.px[lane]; L.py = S.py[lane]; L.pz = S.pz[lane];
  L.dx = S.dx[lane]; L.dy = S.dy[lane]; L.dz = S.dz[lane];
  L.bounces = S.bounces[lane]; L.samples = S.samples[lane];
  L.tr = S.tr[lane]; L.tg = S.tg[lane]; L.tb = S.tb[lane];
  L.rr = S.rr[lane]; L.rg = S.rg[lane]; L.rb = S.rb[lane];
  const Recip ext = recip(P.f[MF_EXTINCTION]);
  const int steps = P.i[MI_STEPS];
  for (int k = 0; k < P.i[MI_N_SEEDS]; ++k) {
    uint32_t s = hash3(ix, iy, __ldg(seeds + k));
    for (int it = 0; it < steps; ++it) mcm_woodcock_step(L, s, sx, sy, P, ext, vol, tf, env);
  }
  S.px[lane] = L.px; S.py[lane] = L.py; S.pz[lane] = L.pz;
  S.dx[lane] = L.dx; S.dy[lane] = L.dy; S.dz[lane] = L.dz;
  S.bounces[lane] = L.bounces; S.samples[lane] = L.samples;
  S.tr[lane] = L.tr; S.tg[lane] = L.tg; S.tb[lane] = L.tb;
  S.rr[lane] = L.rr; S.rg[lane] = L.rg; S.rb[lane] = L.rb;
}

// K21: a fresh photon per lane (a respawn from hash3(ix, iy, seed)),
// transmittance and radiance 1 (the reference's quirk), counters 0.
__global__ void __launch_bounds__(MCM_THREADS)
mcm_reset_kernel(const McmParams P, uint32_t seed, McmState S,
                 const uint32_t* __restrict__ lane_ix, const uint32_t* __restrict__ lane_iy) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= P.i[MI_N_LANES]) return;
  uint32_t ix, iy;
  float sx, sy;
  mcm_pixel(lane, P, lane_ix, lane_iy, ix, iy, sx, sy);
  uint32_t s = hash3(ix, iy, seed);
  float kx, ky;
  draw_disk(s, kx, ky);
  McmLane L;
  mcm_respawn(L, s, kx, ky, sx, sy, P);
  S.px[lane] = L.px; S.py[lane] = L.py; S.pz[lane] = L.pz;
  S.dx[lane] = L.dx; S.dy[lane] = L.dy; S.dz[lane] = L.dz;
  S.bounces[lane] = 0; S.samples[lane] = 0;
  S.tr[lane] = 1.0f; S.tg[lane] = 1.0f; S.tb[lane] = 1.0f;
  S.rr[lane] = 1.0f; S.rg[lane] = 1.0f; S.rb[lane] = 1.0f;
}

McmParams make_mcm_params(const float* fparams, const int* iparams) {
  McmParams P;
  for (int k = 0; k < MF_COUNT; ++k) P.f[k] = fparams[k];
  for (int k = 0; k < MI_COUNT; ++k) P.i[k] = iparams[k];
  return P;
}

McmState make_state(float* px, float* py, float* pz, float* dx, float* dy, float* dz,
                    int* bounces, int* samples, float* tr, float* tg, float* tb, float* rr,
                    float* rg, float* rb) {
  return McmState{px, py, pz, dx, dy, dz, bounces, samples, tr, tg, tb, rr, rg, rb};
}

}  // namespace

extern "C" {

int vpt_mcm_layout(int which) {
  switch (which) {
    case 0: return MF_COUNT;
    case 1: return MI_COUNT;
    default: return -1;
  }
}

// lane_ix and lane_iy (n_lanes uint32 each) are optional together: null
// selects the (H, W) pixel grid
int vpt_mcm_step(const float* fparams, const int* iparams, float* px, float* py, float* pz,
                 float* dx, float* dy, float* dz, int* bounces, int* samples, float* tr,
                 float* tg, float* tb, float* rr, float* rg, float* rb, const void* vol,
                 const float* tf, const float* env, const uint32_t* lane_ix,
                 const uint32_t* lane_iy, const uint32_t* seeds, void* stream) {
  const McmParams P = make_mcm_params(fparams, iparams);
  const int n = P.i[MI_N_LANES];
  if (n <= 0 || P.i[MI_N_SEEDS] <= 0) return 0;
  if ((lane_ix == nullptr) != (lane_iy == nullptr) || env == nullptr ||
      P.i[MI_ENV_H] < 1 || P.i[MI_ENV_W] < 1 || (P.i[MI_NEAREST] != 0 && P.i[MI_VOL_RAW] == 0))
    return (int)cudaErrorInvalidValue;
  mcm_step_kernel<<<blocks_for(n, MCM_THREADS), MCM_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      P, make_state(px, py, pz, dx, dy, dz, bounces, samples, tr, tg, tb, rr, rg, rb), vol, tf,
      env, lane_ix, lane_iy, seeds);
  return (int)cudaGetLastError();
}

int vpt_mcm_reset(const float* fparams, const int* iparams, uint32_t seed, float* px,
                  float* py, float* pz, float* dx, float* dy, float* dz, int* bounces,
                  int* samples, float* tr, float* tg, float* tb, float* rr, float* rg, float* rb,
                  const uint32_t* lane_ix, const uint32_t* lane_iy, void* stream) {
  const McmParams P = make_mcm_params(fparams, iparams);
  const int n = P.i[MI_N_LANES];
  if (n <= 0) return 0;
  if ((lane_ix == nullptr) != (lane_iy == nullptr)) return (int)cudaErrorInvalidValue;
  mcm_reset_kernel<<<blocks_for(n, MCM_THREADS), MCM_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      P, seed, make_state(px, py, pz, dx, dy, dz, bounces, samples, tr, tg, tb, rr, rg, rb),
      lane_ix, lane_iy);
  return (int)cudaGetLastError();
}

}  // extern "C"
