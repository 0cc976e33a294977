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
// Modes: the volume a packed "full" corner table (u8 or f32, linear or
// quasicubic) or a raw (D, H, W) f32 grid (linear, quasicubic or nearest);
// the TF the packed (257, 257, 16) corner table or the raw (256, 256, 4)
// texture; an optional lane table (hit-lane compaction, one stream: a lane
// seeds from its pixel's (ix, iy)). K20 is an instance per table pair
// (McmMode: the pairs MCMRenderer builds, each inlining its one lookup path,
// and a generic one reading the table kinds at run time); the environment
// and the lane table are runtime values.
//
// What bounds it on this card: as K1, instruction issue per lane-step (the
// state is read and written once per launch, ~112 bytes a lane, and the
// bench tables sit in the L2), a respawning lane-step costing as much as
// one inside the volume. Most lanes of a view leave the cube on most steps,
// so the escape and the respawn are the hot path: K20's design, each lever
// timed in turns on the card (probes/mcs_mcm_variants.py; PERF.md), takes a
// one-texel environment's texel as the escape's radiance where that is
// exact (lerp_fixed: no atan2f, asinf and 12 loads), computes the camera
// rays' near point once a lane where blur is +0 (the respawn's disk point
// then moves it by +0, unless a screen coordinate is -0), merges the
// running mean by one reciprocal and quot, draws the disk with one sincosf,
// and asks room for 10 blocks an SM (48 registers, no spills in the table
// pairs' instances). 8 x 4 pixel tiles a warp did not pay here.
//
// Numerics: built without fast math and with -fmad=false, so every
// expression rounds as the plain PyTorch version's (kernels/mcm.py); the
// flight's and the deposit's quotients are IEEE's (quot, the exact
// reciprocal-and-correction quotient), sqrt is IEEE,
// logf/sinf/cosf/sincosf/atan2f/asinf the accurate forms, min/max propagate
// NaN like torch. The forward has no atomics, so the kernel equals its plain
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
  MI_MODE,             // K20: the tables' McmMode (kernels/mcm.py step_mode)
  MI_COUNT,
};

// K20's instances by table pair: the pairs MCMRenderer builds (a packed u8
// or f32 corner table, linear or quasicubic, beside the packed TF; the raw
// grid under the linear, quasicubic or nearest filter beside the raw TF),
// each inlining its one lookup path, and every other pair the wrapper takes
// in the generic instance, which reads the table flags at run time
enum McmMode {
  MC_U8 = 0,     // packed u8 corner table, linear
  MC_F32,        // packed f32 corner table, linear
  MC_U8_QC,      // packed u8, quasicubic
  MC_F32_QC,     // packed f32, quasicubic
  MC_RAW,        // raw f32 grid, linear, raw TF
  MC_RAW_QC,     // raw f32 grid, quasicubic, raw TF
  MC_NEAREST,    // raw f32 grid, nearest, raw TF
  MC_GENERIC,    // any other pair, by the runtime flags
  MC_COUNT,
};

// blocks an SM that K20's __launch_bounds__ asks room for
#define MCM_MIN_BLOCKS 10

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

// the TF's RGBA at the density at (u, v, w) in MODE's tables: one lookup
// path inlined in each instance, mcm_density's runtime flags in the generic
template <int MODE>
__device__ __forceinline__ float4 mode_material(const void* vol, const float* __restrict__ tf,
                                                const McmParams& P, float u, float v, float w) {
  constexpr bool raw = MODE == MC_RAW || MODE == MC_RAW_QC || MODE == MC_NEAREST;
  float d;
  if constexpr (MODE == MC_GENERIC)
    d = mcm_density(vol, P, u, v, w);
  else if constexpr (raw)
    d = sample_volume_raw(static_cast<const float*>(vol), P.i[MI_VOL_D], P.i[MI_VOL_H],
                          P.i[MI_VOL_W], u, v, w, MODE == MC_RAW_QC, MODE == MC_NEAREST);
  else
    d = sample_volume(vol, MODE == MC_U8 || MODE == MC_U8_QC, P.i[MI_VOL_D], P.i[MI_VOL_H],
                      P.i[MI_VOL_W], u, v, w, nullptr, MODE == MC_U8_QC || MODE == MC_F32_QC,
                      false);
  const bool tf_raw = MODE == MC_GENERIC ? P.i[MI_TF_RAW] != 0 : raw;
  return sample_rgba(tf, tf_raw, P.i[MI_TF_H], P.i[MI_TF_W], d);
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

// draw_disk with the angle's sine and cosine by one sincosf, which gives
// sinf's and cosf's bits on every angle u2 * 2 pi takes (probes/
// mcsp_variants.py checks all of them)
__device__ __forceinline__ void draw_disk_sincos(uint32_t& s, float& ox, float& oy) {
  const float u1 = draw(s);
  const float u2 = draw(s);
  const float radius = sqrtf(u1);
  const float angle = u2 * kTwoPi;
  float sa, ca;
  sincosf(angle, &sa, &ca);
  ox = radius * ca;
  oy = radius * sa;
}

// What a lane of K20 keeps for all its respawns and escapes: its screen
// point, the near point of its camera rays where blur is +0 (then
// sx + ox * blur is sx + 0 for every disk point ox, unless sx is -0 and ox
// is negative or -0, so the point is computed once and those respawns
// compute their own), and a one-texel environment's texel
struct McmLaneConst {
  float sx, sy;
  float nx, ny, nz;  // the near point at blur +0
  bool hoisted;      // blur is +0
  bool sx_neg0, sy_neg0;
  float3 texel;
  bool one_texel;    // a one-texel map whose channels are lerp_fixed
};

__device__ __forceinline__ McmLaneConst mcm_lane_const(const McmParams& P,
                                                       const float* __restrict__ env, float sx,
                                                       float sy) {
  McmLaneConst c;
  c.sx = sx;
  c.sy = sy;
  c.hoisted = __float_as_uint(P.f[MF_BLUR]) == 0u;
  c.sx_neg0 = __float_as_uint(sx) == 0x80000000u;
  c.sy_neg0 = __float_as_uint(sy) == 0x80000000u;
  c.nx = c.ny = c.nz = 0.0f;
  if (c.hoisted) apply_homogeneous(P.f + MF_INV_MVP, sx + 0.0f, sy + 0.0f, -1.0f, c.nx, c.ny, c.nz);
  c.texel = make_float3(__ldg(env), __ldg(env + 1), __ldg(env + 2));
  c.one_texel = P.i[MI_ENV_H] == 1 && P.i[MI_ENV_W] == 1 && lerp_fixed(c.texel.x) &&
                lerp_fixed(c.texel.y) && lerp_fixed(c.texel.z);
  return c;
}

// resetPhoton (camera_ray_from_disk) from the disk point (kx, ky) already
// drawn, its near point the lane's hoisted one where that is the same
// point; draws the far-plane square (2)
__device__ __forceinline__ void mcm_respawn_lane(McmLane& L, uint32_t& s, float kx, float ky,
                                                 const McmLaneConst& c, const McmParams& P) {
  const float* inv_mvp = P.f + MF_INV_MVP;
  const float inv_res = P.f[MF_INV_RES];
  float fx = c.nx, fy = c.ny, fz = c.nz;
  if (!c.hoisted || (c.sx_neg0 && signbit(kx)) || (c.sy_neg0 && signbit(ky))) {
    const float blur = P.f[MF_BLUR];
    apply_homogeneous(inv_mvp, c.sx + kx * blur, c.sy + ky * blur, -1.0f, fx, fy, fz);
  }
  const float ax = draw(s);
  const float ay = draw(s);
  const float far_x = c.sx + (ax * 2.0f - 1.0f) * inv_res;
  const float far_y = c.sy + (ay * 2.0f - 1.0f) * inv_res;
  float tx, ty, tz;
  apply_homogeneous(inv_mvp, far_x, far_y, 1.0f, tx, ty, tz);
  const float vx = tx - fx, vy = ty - fy, vz = tz - fz;
  const float inv = __frcp_rn(sqrtf(vx * vx + vy * vy + vz * vz));
  L.dx = vx * inv;
  L.dy = vy * inv;
  L.dz = vz * inv;
  const Recip rx = recip(L.dx), ry = recip(L.dy), rz = recip(L.dz);
  const float t0x = quot(0.0f - fx, rx), t0y = quot(0.0f - fy, ry), t0z = quot(0.0f - fz, rz);
  const float t1x = quot(1.0f - fx, rx), t1y = quot(1.0f - fy, ry), t1z = quot(1.0f - fz, rz);
  float tnear = nmax(nmax(nmin(t0x, t1x), nmin(t0y, t1y)), nmin(t0z, t1z));
  tnear = nmax(tnear, 0.0f);
  L.px = fx + tnear * L.dx;
  L.py = fy + tnear * L.dy;
  L.pz = fz + tnear * L.dz;
}

// One Woodcock iteration of one lane (the JAX _render_body). Draws: the
// flight, the wheel, then a respawn's disk + square or a scatter's disk (+
// the HG cosine where |g| >= EPS).
template <int MODE>
__device__ __forceinline__ void mcm_woodcock_step(McmLane& L, uint32_t& s, const McmLaneConst& c,
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
  float4 m = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (!oob) m = mode_material<MODE>(vol, tf, P, npx, npy, npz);
  const float p_null = 1.0f - m.w;
  const float max3 = nmax(m.x, nmax(m.y, m.z));
  const float p_scatter = (L.bounces >= P.i[MI_MAX_BOUNCES]) ? 0.0f : m.w * max3;
  const float p_absorb = (1.0f - p_null) - p_scatter;
  const float wheel = draw(s);
  const bool absorb = !oob && (wheel < p_absorb);
  const bool scatter = !oob && !absorb && (wheel < p_absorb + p_scatter);
  const bool respawn = oob || absorb;
  float kx = 0.0f, ky = 0.0f;
  if (respawn || scatter) draw_disk_sincos(s, kx, ky);
  if (respawn) {
    // the escape's environment at the pre-step direction (0 on an absorb):
    // a one-texel map's texel at a finite direction (sample_env_rgb returns
    // it there), then the running mean over the lane's samples
    float er = 0.0f, eg = 0.0f, eb = 0.0f;
    if (oob) {
      const float3 e = c.one_texel && isfinite(L.dx) && isfinite(L.dy) && isfinite(L.dz)
                           ? c.texel
                           : sample_env_rgb(env, P.i[MI_ENV_H], P.i[MI_ENV_W], L.dx, L.dy, L.dz);
      er = L.tr * e.x;
      eg = L.tg * e.y;
      eb = L.tb * e.z;
    }
    L.samples += 1;
    const Recip denom = recip((float)max(L.samples, 1));
    L.rr = L.rr + quot(er - L.rr, denom);
    L.rg = L.rg + quot(eg - L.rg, denom);
    L.rb = L.rb + quot(eb - L.rb, denom);
    mcm_respawn_lane(L, s, kx, ky, c, P);
    L.bounces = 0;
    L.tr = 1.0f; L.tg = 1.0f; L.tb = 1.0f;
  } else {
    L.px = npx; L.py = npy; L.pz = npz;
    if (scatter) {
      draw_hg(s, kx, ky, P.f[MF_ANISOTROPY], L.dx, L.dy, L.dz);
      L.bounces += 1;
      L.tr = L.tr * m.x;
      L.tg = L.tg * m.y;
      L.tb = L.tb * m.z;
    }
  }
}

// K20: K dispatches x `steps` Woodcock iterations per lane, in place; MODE
// the tables' McmMode.
template <int MODE>
__global__ void __launch_bounds__(MCM_THREADS, MCM_MIN_BLOCKS)
mcm_step_kernel(const McmParams P, McmState S, const void* __restrict__ vol,
                const float* __restrict__ tf, const float* __restrict__ env,
                const uint32_t* __restrict__ lane_ix, const uint32_t* __restrict__ lane_iy,
                const uint32_t* __restrict__ seeds) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= P.i[MI_N_LANES]) return;
  uint32_t ix, iy;
  float sx, sy;
  mcm_pixel(lane, P, lane_ix, lane_iy, ix, iy, sx, sy);
  const McmLaneConst c = mcm_lane_const(P, env, sx, sy);
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
    for (int it = 0; it < steps; ++it) mcm_woodcock_step<MODE>(L, s, c, P, ext, vol, tf, env);
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
// selects the (H, W) pixel grid. The instance: MI_MODE (McmMode).
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
  const int mode = P.i[MI_MODE];
  if (mode < 0 || mode >= MC_COUNT) return (int)cudaErrorInvalidValue;
  const McmState S = make_state(px, py, pz, dx, dy, dz, bounces, samples, tr, tg, tb, rr, rg, rb);
  const dim3 grid((unsigned)blocks_for(n, MCM_THREADS));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
#define VPT_MCM_MODE(M)                                                                          \
  case M:                                                                                        \
    mcm_step_kernel<M><<<grid, MCM_THREADS, 0, st>>>(P, S, vol, tf, env, lane_ix, lane_iy, seeds); \
    break;
    VPT_MCM_MODE(MC_U8) VPT_MCM_MODE(MC_F32) VPT_MCM_MODE(MC_U8_QC) VPT_MCM_MODE(MC_F32_QC)
    VPT_MCM_MODE(MC_RAW) VPT_MCM_MODE(MC_RAW_QC) VPT_MCM_MODE(MC_NEAREST)
    VPT_MCM_MODE(MC_GENERIC)
#undef VPT_MCM_MODE
  }
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
