// The step kernels as they were before their redesign for Hopper, kept
// unchanged below the blank line so that chip_smoke.py can build and time
// them beside the current ones (kernels/_build.py: load(BASELINE_DIR)).
// Nothing else loads them.

// Packed-adjoint PRB backward kernels for Hopper (sm_90a), plain C interface.
//
//   prb_tape_forward  replaces vpt_tpu/kernels/spectral_backward.py
//                     ::spectral_backward_packed pass 1 `fwd_body`
//                     (:660-743) scanned by _tape_forward_sweep (:1096-1110).
//                     The K1 step (mcm_common.cuh::woodcock_step, the same
//                     device code as mcm_spectral_step) plus one tape row per
//                     lane-step; its final state is bit-identical to K1's.
//   prb_reverse       replaces the reverse scans (:864-950), the importance
//                     path _importance_metric + _importance_scatter
//                     (:411-540), and the reverse dispatch loop of
//                     _tape_reverse_sweep / _prb_many_core (:1076-1139).
//
// The tape is one f32 tensor (K, steps, F, lanes), lanes innermost so every
// warp writes and reads whole 128-byte lines. Int and bool fields are
// bit-cast into f32 slots (bools as 0.0 / 1.0). Which fields are present
// depends on `wrt`; `slot[field]` gives each field's index in F or -1. The
// field list is mirrored by vpt_tpu_torch/kernels/spectral_backward.py
// (TAPE_FIELDS), and vpt_bwd_layout() lets the wrapper check that the two
// agree.
//
// What bounds them on this card.
// - prb_tape_forward is K1 plus F x 4 B of tape stores per lane-step: at the
//   bench shape (1M lanes, 8 steps, K = 4, 17 fields with wrt={density})
//   that is 2.3 GB of coalesced writes per window, ~0.7 ms of HBM time at
//   3.35 TB/s, next to K1's ~2.5 ms of dependent lookups for 4 dispatches.
//   The tape is stored, not recomputed: simple and right first (recompute
//   is a lever for a later PR).
// - prb_reverse reads the tape once (stride mode; importance mode reads the
//   rows it picks a second time) and issues random f32 atomics: one 8-wide
//   row into the volume adjoint (69 MB at 129^3, larger than the 50 MB L2)
//   and one 18-wide row into the TF adjoint (4.8 MB, L2-resident) per
//   scattering lane-step. Rows whose values are all zero (lanes whose
//   path contributes nothing) are skipped, which changes no sum. The
//   extinction score is summed per lane, reduced per block, and added with
//   one atomic per block.
//
// One thread per lane walks the K dispatches in reverse and threads the
// deposit-cotangent carry (c, cb) in registers across dispatch boundaries
// (the window-exact estimator); the carry is read from and written back to
// c_io / cb_io, so the host can also run one dispatch per launch.
//
// Numerics: the scores follow the JAX op order (:784-798), IEEE division,
// NaN-propagating max. The scatter order of the atomics varies from run to
// run, so adjoints agree with the plain version to rounding, not bitwise.

#include "mcm_common.cuh"

namespace {

// tape fields, mirrored by TAPE_FIELDS in kernels/spectral_backward.py
enum TapeField {
  T_EMITTED = 0, T_RESPAWN, T_PRE_BIN, T_ALPHA, T_ALBEDO, T_G, T_HG_COS,
  T_NULL, T_SCATTER, T_FX,                       // always
  T_DIST,                                        // extinction
  T_TF_ROW, T_FY, T_LIGHT_W,                     // material_tf / light
  T_SLOPE0, T_SLOPE1, T_SLOPE2, T_VOL_ROW0, T_VFX, T_VFY, T_VFZ,  // density
  T_COUNT,
};

// reverse-pass integer parameters, mirrored by the wrapper
enum RParam {
  R_N_LANES = 0, R_RES, R_STEPS, R_N_DISPATCH, R_N_FIELDS, R_STRIDE,
  R_IMPORTANCE, R_WANT_EXT, R_WANT_TF, R_WANT_VOL, R_N_BINS,
  R_PICK_BITS_SET, R_PICK_BITS, R_COUNT,
};

// importance mode keeps per-step c, cb, metric and cdf in local arrays
#define MAX_IMP_STEPS 32

struct TapeSpec {
  int n_fields;
  int slot[T_COUNT];
};

struct Rev {
  int i[R_COUNT];
  float inv_mu;
  int slot[T_COUNT];
};

__device__ __forceinline__ void put(float* row, const TapeSpec& T, int field,
                                    int64_t lanes, int lane, float v) {
  const int s = T.slot[field];
  if (s >= 0) row[(int64_t)s * lanes + lane] = v;
}

// K seeds x `steps` Woodcock iterations per lane (K1), one tape row per step
template <int NB>
__global__ void __launch_bounds__(128)
tape_forward_kernel(const Params P, const TapeSpec T, float* __restrict__ px_,
                    float* __restrict__ py_, float* __restrict__ pz_,
                    float* __restrict__ dx_, float* __restrict__ dy_,
                    float* __restrict__ dz_, int* __restrict__ bounces_,
                    int* __restrict__ samples_, int* __restrict__ bin_,
                    float* __restrict__ lam_, float* __restrict__ radiance,
                    const void* __restrict__ vol, const float* __restrict__ tf,
                    const uint32_t* __restrict__ seeds, float* __restrict__ tape) {
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
  const int64_t lanes = n_lanes;
  for (int k = 0; k < P.i[I_N_SEEDS]; ++k) {
    uint32_t s = hash3(ix, seed_iy, seeds[k]);
    for (int it = 0; it < steps; ++it) {
      StepRecord r;
      woodcock_step<NB, true>(L, rad, s, sx, sy, P, vol, tf, &r);
      float* row = tape + ((int64_t)k * steps + it) * T.n_fields * lanes;
      put(row, T, T_EMITTED, lanes, lane, r.emitted);
      put(row, T, T_RESPAWN, lanes, lane, r.respawn ? 1.0f : 0.0f);
      put(row, T, T_PRE_BIN, lanes, lane, __int_as_float(r.pre_bin));
      put(row, T, T_ALPHA, lanes, lane, r.alpha);
      put(row, T, T_ALBEDO, lanes, lane, r.albedo);
      put(row, T, T_G, lanes, lane, r.g);
      put(row, T, T_HG_COS, lanes, lane, r.hg_cos);
      put(row, T, T_NULL, lanes, lane, r.null_event ? 1.0f : 0.0f);
      put(row, T, T_SCATTER, lanes, lane, r.scatter ? 1.0f : 0.0f);
      put(row, T, T_FX, lanes, lane, r.tf.fx);
      put(row, T, T_DIST, lanes, lane, r.dist);
      put(row, T, T_TF_ROW, lanes, lane, __int_as_float(r.tf.row));
      put(row, T, T_FY, lanes, lane, r.tf.fy);
      put(row, T, T_LIGHT_W, lanes, lane, r.light_w);
      put(row, T, T_SLOPE0, lanes, lane, r.tf.slope[0]);
      put(row, T, T_SLOPE1, lanes, lane, r.tf.slope[1]);
      put(row, T, T_SLOPE2, lanes, lane, r.tf.slope[2]);
      put(row, T, T_VOL_ROW0, lanes, lane, __int_as_float(r.vol.row));
      put(row, T, T_VFX, lanes, lane, r.vol.fx);
      put(row, T, T_VFY, lanes, lane, r.vol.fy);
      put(row, T, T_VFZ, lanes, lane, r.vol.fz);
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

// one tape row (dispatch k, step it) of one lane
struct Row {
  const float* base;
  int64_t lanes;
  int lane;
  const int* slot;
  __device__ __forceinline__ float f(int field) const {
    return base[(int64_t)slot[field] * lanes + lane];
  }
  __device__ __forceinline__ int i(int field) const { return __float_as_int(f(field)); }
  __device__ __forceinline__ bool b(int field) const { return f(field) > 0.5f; }
};

// per-channel value gradients from the event scores (JAX :784-798)
struct EventGrads {
  float alpha, albedo, graw;
};

__device__ __forceinline__ EventGrads event_grads(const Row& t, float q) {
  const float alpha = t.f(T_ALPHA), albedo = t.f(T_ALBEDO), g = t.f(T_G);
  const bool nul = t.b(T_NULL), scat = t.b(T_SCATTER);
  EventGrads G;
  G.alpha = (nul ? -q / nmax(1.0f - alpha, 1e-12f) : 0.0f) +
            (scat ? q / nmax(alpha, 1e-12f) : 0.0f);
  G.albedo = scat ? q / nmax(albedo, 1e-12f) : 0.0f;
  const bool aniso = fabsf(g) >= kEps;
  const float cosd = t.f(T_HG_COS);
  const float g2 = g * g;
  const float hg_score = -2.0f * g / nmax(1.0f - g2, 1e-9f) -
                         3.0f * (g - cosd) / nmax(1.0f + g2 - 2.0f * g * cosd, 1e-9f);
  G.graw = ((scat && aniso) ? q * hg_score : 0.0f) * 2.0f;
  return G;
}

// sm_90 vector atomics (float2 / float4, global memory, CUDA >= 12.1)
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && \
    (__CUDACC_VER_MAJOR__ > 12 || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1))
#define VPT_VECTOR_ATOMICS 1
#endif

__device__ __forceinline__ void add2(float* p, float a, float b) {
#ifdef VPT_VECTOR_ATOMICS
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
#else
  atomicAdd(p, a);
  atomicAdd(p + 1, b);
#endif
}

__device__ __forceinline__ void add4(float* p, float a, float b, float c, float d) {
#ifdef VPT_VECTOR_ATOMICS
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
#else
  atomicAdd(p, a);
  atomicAdd(p + 1, b);
  atomicAdd(p + 2, c);
  atomicAdd(p + 3, d);
#endif
}

// the analytic per-step table scatters of one tape row (JAX scatter_step,
// :781-862): one 18-wide TF+light row and one 8-wide volume row
__device__ __forceinline__ void scatter_step(const Row& t, const Rev& R, float c,
                                             float cb, float weight,
                                             float* __restrict__ g_tf,
                                             float* __restrict__ g_vol) {
  const float q = cb * c * weight;
  const EventGrads G = event_grads(t, q);
  if (R.i[R_WANT_TF]) {
    const float gl = cb * weight * t.f(T_LIGHT_W);
    if (G.albedo != 0.0f || G.alpha != 0.0f || G.graw != 0.0f || gl != 0.0f) {
      const float fx = t.f(T_FX), fy = t.f(T_FY);
      const float w[4] = {(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy};
      // an 18-wide row starts at a multiple of 72 B: 8-byte aligned
      float* r = g_tf + (int64_t)t.i(T_TF_ROW) * 18;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        add2(r + 4 * k, G.albedo * w[k], G.alpha * w[k]);
        add2(r + 4 * k + 2, G.graw * w[k], 0.0f);
      }
      add2(r + 16, gl * (1 - fx), gl * fx);
    }
  }
  if (R.i[R_WANT_VOL]) {
    const float gd = G.albedo * t.f(T_SLOPE0) + G.alpha * t.f(T_SLOPE1) +
                     G.graw * t.f(T_SLOPE2);
    if (gd != 0.0f) {
      const float vfx = t.f(T_VFX), vfy = t.f(T_VFY), vfz = t.f(T_VFZ);
      const float w0 = (1 - vfy) * (1 - vfx), w1 = (1 - vfy) * vfx;
      const float w2 = vfy * (1 - vfx), w3 = vfy * vfx;
      const float a0 = gd * (1 - vfz), a1 = gd * vfz;
      // an 8-wide row is 32 B: two 16-byte-aligned float4 adds
      float* r = g_vol + (int64_t)t.i(T_VOL_ROW0) * 8;
      add4(r, a0 * w0, a0 * w1, a0 * w2, a0 * w3);
      add4(r + 4, a1 * w0, a1 * w1, a1 * w2, a1 * w3);
    }
  }
}

// importance-thinning selection weight (JAX _importance_metric, :411-450)
__device__ __forceinline__ float importance_metric(const Row& t, const Rev& R,
                                                   float c, float cb) {
  const float q = c * cb;
  const EventGrads G = event_grads(t, q);
  float m = 0.0f;
  if (R.i[R_WANT_VOL]) {
    m = m + fabsf(G.albedo * t.f(T_SLOPE0) + G.alpha * t.f(T_SLOPE1) +
                  G.graw * t.f(T_SLOPE2));
  }
  if (R.i[R_WANT_TF]) {
    m = m + (fabsf(G.albedo) + fabsf(G.alpha) + fabsf(G.graw) +
             fabsf(cb * t.f(T_LIGHT_W)));
  }
  return m;
}

// block sum of one value per thread, added to *out with one atomic
__device__ __forceinline__ void block_add(float v, float* out) {
  __shared__ float warp_sums[4];  // blockDim.x == 128
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(out, ((warp_sums[0] + warp_sums[1]) + warp_sums[2]) + warp_sums[3]);
}

__global__ void __launch_bounds__(128)
reverse_kernel(const Rev R, const float* __restrict__ tape,
               const float* __restrict__ g_rad_scaled, float* __restrict__ c_io,
               float* __restrict__ cb_io, const int* __restrict__ phases,
               const uint32_t* __restrict__ seeds, float* __restrict__ g_ext,
               float* __restrict__ g_tf, float* __restrict__ g_vol) {
  // no early return: every thread reaches block_add's __syncthreads
  const int n_lanes = R.i[R_N_LANES];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = lane < n_lanes;
  float ext = 0.0f;
  if (active) {
    const int steps = R.i[R_STEPS];
    const int F = R.i[R_N_FIELDS];
    const int n_bins = R.i[R_N_BINS];
    const int stride = R.i[R_STRIDE];
    const bool importance = R.i[R_IMPORTANCE] != 0 && stride > 1;
    const bool want_ext = R.i[R_WANT_EXT] != 0;
    const bool want_scatter = R.i[R_WANT_TF] != 0 || R.i[R_WANT_VOL] != 0;
    const int64_t lanes = n_lanes;
    float c = c_io[lane], cb = cb_io[lane];
    Row t;
    t.lanes = lanes;
    t.lane = lane;
    t.slot = R.slot;
    const float weight = (float)stride;

    for (int k = R.i[R_N_DISPATCH] - 1; k >= 0; --k) {
      const float* disp = tape + (int64_t)k * steps * F * lanes;
      float c_all[MAX_IMP_STEPS], cb_all[MAX_IMP_STEPS];
      const int phase = phases[k];
      for (int it = steps - 1; it >= 0; --it) {
        t.base = disp + (int64_t)it * F * lanes;
        // cotangent_update (:864-873): a deposit restarts the carry
        if (t.b(T_RESPAWN)) {
          c = t.f(T_EMITTED);
          const int b = t.i(T_PRE_BIN);
          cb = (b >= 0 && b < n_bins) ? g_rad_scaled[(int64_t)b * lanes + lane] : 0.0f;
        }
        if (want_ext) ext += c * cb * (R.inv_mu - t.f(T_DIST));
        if (importance) {
          c_all[it] = c;
          cb_all[it] = cb;
        } else if (want_scatter && it % stride == phase) {
          scatter_step(t, R, c, cb, weight, g_tf, g_vol);
        }
      }
      if (importance && want_scatter) {
        // per-lane i.i.d. step picks proportional to the scatter magnitude,
        // reweighted S / (count * metric); S and the cdf are sequential sums
        float absq[MAX_IMP_STEPS], cdf[MAX_IMP_STEPS];
        float S = 0.0f;
        for (int it = 0; it < steps; ++it) {
          t.base = disp + (int64_t)it * F * lanes;
          absq[it] = importance_metric(t, R, c_all[it], cb_all[it]);
          S = S + absq[it];
        }
        const float Sd = nmax(S, 1e-30f);
        float run = 0.0f;
        for (int it = 0; it < steps; ++it) {
          run = run + absq[it] / Sd;
          cdf[it] = run;
        }
        uint32_t ix, iy, seed_iy;
        float sx, sy;
        lane_coords(lane, R.i[R_RES], ix, iy, seed_iy, 1.0f, sx, sy);
        const uint32_t bits =
            (R.i[R_PICK_BITS_SET] ? (uint32_t)R.i[R_PICK_BITS] : seeds[k]) ^ 0x7F4A7C15u;
        const uint32_t pick_state = hash3(ix, seed_iy, bits);
        const int count = steps / stride;
        for (int j = 0; j < count; ++j) {
          const float u = uniform_from_state(pcg_hash(pick_state ^ (0x9E3779B9u * (uint32_t)(j + 1))));
          int sel = 0;
          for (int it = 0; it < steps; ++it) sel += (cdf[it] < u) ? 1 : 0;
          sel = min(max(sel, 0), steps - 1);
          const float a = absq[sel];
          const float w = (a > 0.0f) ? S / ((float)count * nmax(a, 1e-30f)) : 0.0f;
          t.base = disp + (int64_t)sel * F * lanes;
          scatter_step(t, R, c_all[sel], cb_all[sel], w, g_tf, g_vol);
        }
      }
    }
    c_io[lane] = c;
    cb_io[lane] = cb;
  }
  if (R.i[R_WANT_EXT]) block_add(ext, g_ext);
}

}  // namespace

extern "C" {

int vpt_bwd_layout(int which) {
  switch (which) {
    case 0: return T_COUNT;
    case 1: return R_COUNT;
    case 2: return MAX_IMP_STEPS;
    case 3: return F_COUNT;
    case 4: return I_COUNT;
    default: return -1;
  }
}

int vpt_prb_tape_forward(const float* fparams, const int* iparams,
                         const int* slots, int n_fields, float* px, float* py,
                         float* pz, float* dx, float* dy, float* dz,
                         int* bounces, int* samples, int* bin, float* wavelength,
                         float* radiance, const void* vol, const float* tf,
                         const uint32_t* seeds, float* tape, void* stream) {
  const Params P = make_params(fparams, iparams);
  TapeSpec T;
  T.n_fields = n_fields;
  for (int k = 0; k < T_COUNT; ++k) T.slot[k] = slots[k];
  const int n = P.i[I_N_LANES];
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_for(n, 128)), block(128);
  if (P.i[I_N_BINS] <= 16) {
    tape_forward_kernel<16><<<grid, block, 0, st>>>(P, T, px, py, pz, dx, dy, dz, bounces,
                                                    samples, bin, wavelength, radiance,
                                                    vol, tf, seeds, tape);
  } else {
    tape_forward_kernel<MAX_BINS><<<grid, block, 0, st>>>(P, T, px, py, pz, dx, dy, dz,
                                                          bounces, samples, bin, wavelength,
                                                          radiance, vol, tf, seeds, tape);
  }
  return (int)cudaGetLastError();
}

int vpt_prb_reverse(const int* rparams, float inv_mu, const int* slots,
                    const float* tape, const float* g_rad_scaled, float* c,
                    float* cb, const int* phases, const uint32_t* seeds,
                    float* g_ext, float* g_tf, float* g_vol, void* stream) {
  Rev R;
  for (int k = 0; k < R_COUNT; ++k) R.i[k] = rparams[k];
  for (int k = 0; k < T_COUNT; ++k) R.slot[k] = slots[k];
  R.inv_mu = inv_mu;
  const int n = R.i[R_N_LANES];
  if (n <= 0) return 0;
  if (R.i[R_IMPORTANCE] && R.i[R_STEPS] > MAX_IMP_STEPS) return (int)cudaErrorInvalidValue;
  reverse_kernel<<<blocks_for(n, 128), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      R, tape, g_rad_scaled, c, cb, phases, seeds, g_ext, g_tf, g_vol);
  return (int)cudaGetLastError();
}

}  // extern "C"
