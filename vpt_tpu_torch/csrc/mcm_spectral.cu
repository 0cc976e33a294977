// Spectral MCM forward kernels for Hopper (sm_90a), plain C interface.
//
// Three kernels share the __device__ code of mcm_common.cuh (hash chain,
// draws, geometry, packed-table lookups, the Woodcock step):
//
//   mcm_spectral_step   replaces vpt_tpu/models/mcm_spectral.py::_render_body
//                       (:212-416) looped by render_many (:466-505).
//   mcm_spectral_reset  replaces vpt_tpu/models/mcm_spectral.py::full_reset
//                       (:181-200).
//   sample_volume_packed replaces vpt_tpu/ops/interp.py::_sample_volume_packed
//                       + _dequantize_rows (:354-408) as a standalone lookup.
//
// What bounds them on this card. The step kernel is one thread per photon
// lane. Per lane-step it does one random 8-byte (u8) or 32-byte (f32) load
// of a packed volume corner row and one random 72-byte load of a fused
// TF+light row, plus ~100 flops and a few transcendentals. At the bench
// shape both tables fit in the 50 MB L2 (129^3 x 8 u8 = 17 MB, 257x257x18
// f32 = 4.8 MB), so the bound is random L2 row loads and the latency of the
// dependent hash -> flight -> lookup -> wheel chain, not HBM bandwidth.
// The photon state (~13 words + n_bins radiance words per lane) is read
// once and written once per launch: each thread keeps it in registers
// across all K dispatches x `steps` iterations, so HBM traffic is
// ~140 MB per launch at 1M lanes regardless of K. The RNG is re-seeded per
// dispatch from hash3(ix, iy + s*H, seed_k), exactly as the JAX version
// does, so nothing but the photon state carries between dispatches.
// Making it fast (occupancy tuning, FMA contraction, coalesced row loads)
// is later work; here it has to be right.
//
// Numerics: built without fast math and with -fmad=false, so every lerp
// rounds like the reference; IEEE division and sqrt; logf/sinf/cosf are
// the accurate (not __intrinsic) forms; u8 codes dequantize by IEEE
// division (exactly float(k)/255 for all 256 codes); min/max propagate NaN
// like jnp.minimum/maximum (the slab test divides by zero on purpose).

#include "mcm_common.cuh"

namespace {

// K dispatches x `steps` Woodcock iterations per lane, state in registers.
template <int NB>
__global__ void __launch_bounds__(128)
step_kernel(const Params P, float* __restrict__ px_, float* __restrict__ py_,
            float* __restrict__ pz_, float* __restrict__ dx_,
            float* __restrict__ dy_, float* __restrict__ dz_,
            int* __restrict__ bounces_, int* __restrict__ samples_,
            int* __restrict__ bin_, float* __restrict__ lam_,
            float* __restrict__ radiance, const void* __restrict__ vol,
            const float* __restrict__ tf, const uint32_t* __restrict__ seeds) {
  const int n_lanes = P.i[I_N_LANES];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const int n_bins = P.i[I_N_BINS];
  uint32_t ix, iy, seed_iy;
  float sx, sy;
  lane_coords(lane, P.i[I_RES], ix, iy, seed_iy, P.f[F_INV_RES], sx, sy);

  Lane L;
  L.px = px_[lane]; L.py = py_[lane]; L.pz = pz_[lane];
  L.dx = dx_[lane]; L.dy = dy_[lane]; L.dz = dz_[lane];
  L.bounces = bounces_[lane]; L.samples = samples_[lane]; L.bin = bin_[lane];
  L.lam = lam_[lane];
  float rad[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) rad[b] = (b < n_bins) ? radiance[(int64_t)b * n_lanes + lane] : 0.0f;

  const int steps = P.i[I_STEPS];
  for (int k = 0; k < P.i[I_N_SEEDS]; ++k) {
    uint32_t s = hash3(ix, seed_iy, seeds[k]);
    for (int it = 0; it < steps; ++it) {
      woodcock_step<NB, false>(L, rad, s, sx, sy, P, vol, tf, nullptr);
    }
  }

  px_[lane] = L.px; py_[lane] = L.py; pz_[lane] = L.pz;
  dx_[lane] = L.dx; dy_[lane] = L.dy; dz_[lane] = L.dz;
  bounces_[lane] = L.bounces; samples_[lane] = L.samples; bin_[lane] = L.bin;
  lam_[lane] = L.lam;
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
             float* __restrict__ transmittance) {
  const int n_lanes = P.i[I_N_LANES];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  uint32_t ix, iy, seed_iy;
  float sx, sy;
  lane_coords(lane, P.i[I_RES], ix, iy, seed_iy, P.f[F_INV_RES], sx, sy);
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
sample_volume_kernel(const void* __restrict__ table, int is_u8, int Dp, int Hp,
                     int Wp, const float* __restrict__ u,
                     const float* __restrict__ v, const float* __restrict__ w,
                     float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = sample_volume(table, is_u8, Dp, Hp, Wp, u[i], v[i], w[i], nullptr);
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

int vpt_mcm_spectral_step(const float* fparams, const int* iparams, float* px,
                          float* py, float* pz, float* dx, float* dy, float* dz,
                          int* bounces, int* samples, int* bin, float* wavelength,
                          float* radiance, const void* vol, const float* tf,
                          const uint32_t* seeds, void* stream) {
  const Params P = make_params(fparams, iparams);
  const int n = P.i[I_N_LANES];
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_for(n, 128)), block(128);
  if (P.i[I_N_BINS] <= 16) {
    step_kernel<16><<<grid, block, 0, st>>>(P, px, py, pz, dx, dy, dz, bounces,
                                            samples, bin, wavelength, radiance,
                                            vol, tf, seeds);
  } else {
    step_kernel<MAX_BINS><<<grid, block, 0, st>>>(P, px, py, pz, dx, dy, dz,
                                                  bounces, samples, bin,
                                                  wavelength, radiance, vol, tf,
                                                  seeds);
  }
  return (int)cudaGetLastError();
}

int vpt_mcm_spectral_reset(const float* fparams, const int* iparams,
                           uint32_t seed, float* px, float* py, float* pz,
                           float* dx, float* dy, float* dz, int* bounces,
                           int* samples, int* bin, float* wavelength,
                           float* radiance, float* transmittance, void* stream) {
  const Params P = make_params(fparams, iparams);
  const int n = P.i[I_N_LANES];
  if (n <= 0) return 0;
  reset_kernel<<<blocks_for(n, 128), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      P, seed, px, py, pz, dx, dy, dz, bounces, samples, bin, wavelength,
      radiance, transmittance);
  return (int)cudaGetLastError();
}

int vpt_sample_volume_packed(const void* table, int is_u8, int Dp, int Hp,
                             int Wp, const float* u, const float* v,
                             const float* w, float* out, int n, void* stream) {
  if (n <= 0) return 0;
  sample_volume_kernel<<<blocks_for(n, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      table, is_u8, Dp, Hp, Wp, u, v, w, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
