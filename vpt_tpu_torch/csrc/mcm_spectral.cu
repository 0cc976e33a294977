// Spectral MCM forward kernels for Hopper (sm_90a), plain C interface.
//
// Four kernels share the __device__ code of mcm_common.cuh (hash chain,
// draws, geometry, packed-table lookups, the Woodcock step):
//
//   mcm_spectral_step   replaces vpt_tpu/models/mcm_spectral.py::_render_body
//                       (:212-416) looped by render_many (:466-505), in all
//                       its packed-table modes: the super-voxel majorant
//                       (:228-251, :319-332), the environment map
//                       (:148-162, :347-348), the quasicubic filter
//                       (ops/interp.py:389-392), the xy half-packed volume
//                       (ops/interp.py:226-266); and, over a lane table,
//                       mcm_spectral_compact.py::render_compact_many (:352).
//   mcm_spectral_reset  replaces vpt_tpu/models/mcm_spectral.py::full_reset
//                       (:181-200) and mcm_spectral_compact.py::compact_reset
//                       (:328).
//   compact_image       replaces the scatter-add of
//                       mcm_spectral_compact.py::compact_image (:380-392).
//   sample_volume_packed replaces vpt_tpu/ops/interp.py::_sample_volume_packed
//                       + _dequantize_rows (:354-408), and
//                       _sample_volume_packed_xy (:226-266), as a standalone
//                       lookup.
//
// What bounds them on this card. The step kernel is one thread per photon
// lane. Per lane-step it does one random 8-byte (u8) or 32-byte (f32) load
// of a packed volume corner row and one random load of a fused TF row
// (channels 0..2 of its four corners), plus a few hundred instructions of
// arithmetic, hashing and transcendentals. At the bench shape both tables
// fit in the 50 MB L2 (129^3 x 8 u8 = 17 MB, 257x257x18 f32 = 4.8 MB), and
// the photon state (~13 words + n_bins radiance words per lane) is read
// once and written once per launch: each thread keeps it in registers
// across all K dispatches x `steps` iterations, so HBM traffic is
// ~185 MB per launch at 1M lanes and 12 bins regardless of K. The bytes
// bound a dispatch at ~0.06 ms; the kernel runs ~10x that. It is bound by
// instruction issue: a respawning lane-step (a miss lane respawns every
// step) costs as much as one inside the volume, and a warp that holds
// both a respawning and a scattering lane runs both branches.
//
// The design therefore cuts instructions per lane-step, each change equal
// to the plain version bit for bit (mcm_common.cuh):
// - u8 codes dequantize by a byte permute, a subtract and Markstein's
//   correction of the product with RN(1/255), not 8 IEEE divisions;
// - the deposit (one quotient per bin), the flight (over the extinction),
//   the ray's homogeneous divide and the slab test share one correctly
//   rounded reciprocal per divisor plus two FMAs per quotient;
// - the radiance array has NB = the bin count rounded up to 4 (12 at the
//   bench, not 16);
// - the TF column of the wavelength is held from one respawn to the next;
// - a lane outside the volume reads no material, only its light pair;
// - a respawn and an HG scatter share one disk draw (sqrt, cos, sin),
//   drawn before the branch.
// The RNG is re-seeded per dispatch from hash3(ix, iy + s*H, seed_k),
// exactly as the JAX version does, so nothing but the photon state
// carries between dispatches.
//
// The modes. Majorant mode adds one 8-byte load of a (majorant, cap) pair
// per lane-step from a grid of a few MB (L2-resident); its gain is fewer
// steps per path in empty space, and a capped lane inside the volume skips
// both table loads. Env mode adds, for escaping lanes only, atan2f/asinf
// and one random 48-byte row load from the packed map. Both are template
// parameters, so the default build carries none of their code. An xy
// half-packed volume (the big-volume mode: a 512^3 u8 grid's table is 539
// MB instead of 1.08 GB) reads two 4-wide plane rows per lookup instead of
// one 8-wide row; it is a template parameter too (XY, selected by
// I_VOL_XY), so the full-table builds keep their code. The corner values
// and the lerps are the same, so an xy render equals the full-table render
// bit for bit. A lane
// table (hit-lane compaction) replaces the lane -> pixel arithmetic by
// three coalesced 4-byte loads per launch.
//
// compact_image is one thread per (bin, pixel): a hit pixel sums its S
// stream lanes in stream order (no atomics, so every run gives the same
// bits) and divides by S; a miss pixel copies its closed-form value.
// It moves ~B * res^2 * (S + 2) * 4 bytes: HBM-bound and small.
//
// Numerics: built without fast math and with -fmad=false, so every lerp
// rounds like the reference (the only FMAs are the explicit __fmaf_rn of
// the quotient correction); every quotient equals the IEEE one and sqrt
// is IEEE; logf/sinf/cosf are the accurate (not __intrinsic) forms; u8
// codes dequantize to exactly float(k)/255 for all 256 codes; min/max
// propagate NaN like jnp.minimum/maximum (the slab test divides by zero on
// purpose: a zero direction component takes the division fallback).

#include "mcm_common.cuh"

namespace {

// K dispatches x `steps` Woodcock iterations per lane, state in registers.
template <int NB, bool MAJ, bool ENV, bool XY>
__global__ void __launch_bounds__(STEP_THREADS, 10)
step_kernel(const Params P, float* __restrict__ px_, float* __restrict__ py_,
            float* __restrict__ pz_, float* __restrict__ dx_,
            float* __restrict__ dy_, float* __restrict__ dz_,
            int* __restrict__ bounces_, int* __restrict__ samples_,
            int* __restrict__ bin_, float* __restrict__ lam_,
            float* __restrict__ radiance, const void* __restrict__ vol,
            const float* __restrict__ tf, const float2* __restrict__ maj,
            const float* __restrict__ env, const uint32_t* __restrict__ lane_ix,
            const uint32_t* __restrict__ lane_iy,
            const uint32_t* __restrict__ lane_seed_iy,
            const uint32_t* __restrict__ seeds) {
  const int n_lanes = P.i[I_N_LANES];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const int n_bins = P.i[I_N_BINS];
  uint32_t ix, iy, seed_iy;
  float sx, sy;
  lane_pixel(lane, P, lane_ix, lane_iy, lane_seed_iy, ix, iy, seed_iy, sx, sy);

  Lane L = load_lane(lane, P, px_, py_, pz_, dx_, dy_, dz_, bounces_, samples_, bin_, lam_);
  float rad[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) rad[b] = (b < n_bins) ? radiance[(int64_t)b * n_lanes + lane] : 0.0f;

  const StepConsts C = step_consts(P);
  const int steps = P.i[I_STEPS];
  for (int k = 0; k < P.i[I_N_SEEDS]; ++k) {
    uint32_t s = hash3(ix, seed_iy, seeds[k]);
    for (int it = 0; it < steps; ++it) {
      woodcock_step<NB, false, MAJ, ENV, false, XY>(L, rad, s, sx, sy, P, C, vol, tf, nullptr,
                                                    maj, env);
    }
  }

  store_lane(L, lane, px_, py_, pz_, dx_, dy_, dz_, bounces_, samples_, bin_, lam_);
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (b < n_bins) radiance[(int64_t)b * n_lanes + lane] = rad[b];
}

__global__ void __launch_bounds__(128)
reset_kernel(const Params P, uint32_t seed, float* __restrict__ px_,
             float* __restrict__ py_, float* __restrict__ pz_,
             float* __restrict__ dx_, float* __restrict__ dy_,
             float* __restrict__ dz_, int* __restrict__ bounces_,
             int* __restrict__ samples_, int* __restrict__ bin_,
             float* __restrict__ lam_, float* __restrict__ radiance,
             float* __restrict__ transmittance,
             const uint32_t* __restrict__ lane_ix,
             const uint32_t* __restrict__ lane_iy,
             const uint32_t* __restrict__ lane_seed_iy) {
  const int n_lanes = P.i[I_N_LANES];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  uint32_t ix, iy, seed_iy;
  float sx, sy;
  lane_pixel(lane, P, lane_ix, lane_iy, lane_seed_iy, ix, iy, seed_iy, sx, sy);
  uint32_t s = hash3(ix, seed_iy, seed);
  const Ray r = respawn(s, sx, sy, P);
  px_[lane] = r.px; py_[lane] = r.py; pz_[lane] = r.pz;
  dx_[lane] = r.dx; dy_[lane] = r.dy; dz_[lane] = r.dz;
  lam_[lane] = r.lam; bin_[lane] = r.bin;
  bounces_[lane] = 0;
  samples_[lane] = 0;
  // radiance = transmittance = 1: the reference's white-before-convergence quirk
  for (int b = 0; b < P.i[I_N_BINS]; ++b) {
    radiance[(int64_t)b * n_lanes + lane] = 1.0f;
    transmittance[(int64_t)b * n_lanes + lane] = 1.0f;
  }
}

__global__ void __launch_bounds__(256)
compact_image_kernel(const float* __restrict__ radiance, int64_t n_lanes,
                     const int* __restrict__ pixel_hit,
                     const float* __restrict__ miss, float* __restrict__ out,
                     int n_bins, int n_pixels, int n_hit, int streams) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)n_bins * n_pixels) return;
  const int b = (int)(i / n_pixels);
  const int p = (int)(i - (int64_t)b * n_pixels);
  const int k = pixel_hit[p];
  if (k < 0) {
    out[i] = miss[i];
    return;
  }
  const float* r = radiance + (int64_t)b * n_lanes + k;
  float acc = 0.0f;
  for (int s = 0; s < streams; ++s) acc = acc + r[(int64_t)s * n_hit];
  out[i] = acc / (float)streams;
}

__global__ void __launch_bounds__(256)
sample_volume_kernel(const void* __restrict__ table, int is_u8, int xy, int D0, int Hp,
                     int Wp, const float* __restrict__ u,
                     const float* __restrict__ v, const float* __restrict__ w,
                     float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = sample_volume(table, is_u8, D0, Hp, Wp, u[i], v[i], w[i], nullptr, false, xy != 0);
}

template <int NB, bool MAJ, bool ENV, bool XY>
void launch_step(const Params& P, cudaStream_t st, float* px, float* py,
                 float* pz, float* dx, float* dy, float* dz, int* bounces,
                 int* samples, int* bin, float* wavelength, float* radiance,
                 const void* vol, const float* tf, const float* maj,
                 const float* env, const uint32_t* lane_ix,
                 const uint32_t* lane_iy, const uint32_t* lane_seed_iy,
                 const uint32_t* seeds) {
  step_kernel<NB, MAJ, ENV, XY><<<blocks_for(P.i[I_N_LANES], STEP_THREADS), STEP_THREADS,
                                  0, st>>>(
      P, px, py, pz, dx, dy, dz, bounces, samples, bin, wavelength, radiance,
      vol, tf, reinterpret_cast<const float2*>(maj), env, lane_ix, lane_iy,
      lane_seed_iy, seeds);
}

template <int NB>
void launch_step_modes(const Params& P, cudaStream_t st, float* px, float* py,
                       float* pz, float* dx, float* dy, float* dz, int* bounces,
                       int* samples, int* bin, float* wavelength,
                       float* radiance, const void* vol, const float* tf,
                       const float* maj, const float* env,
                       const uint32_t* lane_ix, const uint32_t* lane_iy,
                       const uint32_t* lane_seed_iy, const uint32_t* seeds) {
#define VPT_STEP(M, E, X)                                                        \
  launch_step<NB, M, E, X>(P, st, px, py, pz, dx, dy, dz, bounces, samples, bin, \
                           wavelength, radiance, vol, tf, maj, env, lane_ix,     \
                           lane_iy, lane_seed_iy, seeds)
#define VPT_STEP_MODES(X)                                          \
  if (maj == nullptr && env == nullptr) VPT_STEP(false, false, X); \
  else if (env == nullptr) VPT_STEP(true, false, X);               \
  else if (maj == nullptr) VPT_STEP(false, true, X);               \
  else VPT_STEP(true, true, X);
  if (P.i[I_VOL_XY] != 0) {
    VPT_STEP_MODES(true)
  } else {
    VPT_STEP_MODES(false)
  }
#undef VPT_STEP_MODES
#undef VPT_STEP
}

}  // namespace

extern "C" {

int vpt_layout(int which) {
  switch (which) {
    case 0: return MAX_BINS;
    case 1: return F_COUNT;
    case 2: return I_COUNT;
    default: return -1;
  }
}

// maj (Gz*Gy*Gx*2 floats), env (packed Hp*Wp*12 floats) and the three
// lane tables (n_lanes uint32 each) are optional: null selects the
// default form of each.
int vpt_mcm_spectral_step(const float* fparams, const int* iparams, float* px,
                          float* py, float* pz, float* dx, float* dy, float* dz,
                          int* bounces, int* samples, int* bin, float* wavelength,
                          float* radiance, const void* vol, const float* tf,
                          const float* maj, const float* env,
                          const uint32_t* lane_ix, const uint32_t* lane_iy,
                          const uint32_t* lane_seed_iy, const uint32_t* seeds,
                          void* stream) {
  const Params P = make_params(fparams, iparams);
  const int n = P.i[I_N_LANES];
  if (n <= 0) return 0;
  if ((maj != nullptr) != (P.i[I_MAJ_GZ] > 0) || (env != nullptr) != (P.i[I_ENV_H] > 0) ||
      (lane_ix == nullptr) != (lane_iy == nullptr) ||
      (lane_ix == nullptr) != (lane_seed_iy == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bins_rounded(P.i[I_N_BINS])) {
#define VPT_NB(NB)                                                                       \
  case NB:                                                                               \
    launch_step_modes<NB>(P, st, px, py, pz, dx, dy, dz, bounces, samples, bin,          \
                          wavelength, radiance, vol, tf, maj, env, lane_ix, lane_iy,     \
                          lane_seed_iy, seeds);                                          \
    break;
    VPT_NB(4) VPT_NB(8) VPT_NB(12) VPT_NB(16) VPT_NB(20) VPT_NB(24) VPT_NB(28) VPT_NB(32)
#undef VPT_NB
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int vpt_mcm_spectral_reset(const float* fparams, const int* iparams,
                           uint32_t seed, float* px, float* py, float* pz,
                           float* dx, float* dy, float* dz, int* bounces,
                           int* samples, int* bin, float* wavelength,
                           float* radiance, float* transmittance,
                           const uint32_t* lane_ix, const uint32_t* lane_iy,
                           const uint32_t* lane_seed_iy, void* stream) {
  const Params P = make_params(fparams, iparams);
  const int n = P.i[I_N_LANES];
  if (n <= 0) return 0;
  if ((lane_ix == nullptr) != (lane_iy == nullptr) ||
      (lane_ix == nullptr) != (lane_seed_iy == nullptr))
    return (int)cudaErrorInvalidValue;
  reset_kernel<<<blocks_for(n, 128), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      P, seed, px, py, pz, dx, dy, dz, bounces, samples, bin, wavelength,
      radiance, transmittance, lane_ix, lane_iy, lane_seed_iy);
  return (int)cudaGetLastError();
}

int vpt_compact_image(const float* radiance, int64_t n_lanes,
                      const int* pixel_hit, const float* miss, float* out,
                      int n_bins, int n_pixels, int n_hit, int streams,
                      void* stream) {
  const int64_t n = (int64_t)n_bins * n_pixels;
  if (n <= 0) return 0;
  if (streams < 1 || (int64_t)streams * n_hit > n_lanes) return (int)cudaErrorInvalidValue;
  compact_image_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      radiance, n_lanes, pixel_hit, miss, out, n_bins, n_pixels, n_hit, streams);
  return (int)cudaGetLastError();
}

// xy: a (rows, 4) xy table at dims (D, Hp, Wp), else a (rows, 8) full table
// at padded dims (Dp, Hp, Wp)
int vpt_sample_volume_packed(const void* table, int is_u8, int xy, int D0, int Hp,
                             int Wp, const float* u, const float* v,
                             const float* w, float* out, int n, void* stream) {
  if (n <= 0) return 0;
  sample_volume_kernel<<<blocks_for(n, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      table, is_u8, xy, D0, Hp, Wp, u, v, w, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
