// The raw-table replay backward for Hopper (sm_90a), plain C interface.
//
//   raw_tape     (K13) replaces vpt_tpu/kernels/spectral_backward.py
//                ::spectral_backward pass 1 `fwd_body` (:140-153): one
//                dispatch of the K1 step over raw tables (the RAW
//                instantiation of mcm_common.cuh::woodcock_step, the device
//                code of mcm_spectral_step), recording per lane-step what the
//                reverse scan reads: the deposit (emitted, f32), and the
//                respawn flag with the pre-step bin (one int32). 8 bytes per
//                lane-step. Its final state is bit-identical to K1's: the
//                step is K1's, with the surrogate record (SUR), which adds
//                stores only.
//   raw_replay   (K14) replaces the reverse scan `rev_body` (:175-185) and
//                the replay `rep_body` with its analytic scatters
//                (:198-287): one thread per lane
//                - walks its own tape column forward, holding the next
//                  respawn's (c, cb): the reverse scan's value at each step
//                  is the deposit of the first respawn at or after it, so a
//                  lane needs no per-step array;
//                - replays the dispatch from state0 on the same RNG chain (the
//                  same step, so the same events), re-deriving the material
//                  where an event scores (null or scatter with q != 0);
//                - scatters per lane-step: 8 volume corners into the raw
//                  (D, H, W) grid adjoint (scalar atomics, trilinear weights,
//                  warped under the quasicubic filter; the nearest filter
//                  scatters trilinear too, as the reference does); the TF's
//                  3 channels x 4 corners as 4 float4 atomics into its (H, W,
//                  4) rows (channel 3 zero); an escape's light as 2 scalar
//                  atomics weighted by cb (pathwise); the extinction score
//                  q (1/mu - dist), summed per block in f64.
//                Zero-valued scatters (q or cb zero) are skipped, which
//                changes no sum. The light's atomics cost 7% of K14 on the
//                bench scene, and summing them over a warp's lanes first
//                (as add_env_texels does) made it 3% slower, so every
//                escaping lane adds its 2 terms itself (probes/raw_scatter.py).
//
// What bounds them on this card. K13 is K1 over raw tables plus 8 B of tape
// stores per lane-step (67 MB at the bench's 1M lanes x 8 steps). K14 reads
// the tape once (twice at most: the lookahead and the step) and replays the
// step, so it costs about a K1 dispatch plus the scatters: per scoring
// event 8 scalar + 4 float4 atomics, per escape 2 scalar atomics into a
// light table of N texels. Every escaping lane of the bench adds to the
// same few hundred light texels, whose atomics serialize in the L2; the
// volume adjoint (8.4 MB at 128^3) and the TF adjoint (1 MB) stay in the
// L2. A lane's gradients depend on no other lane's.
//
// Numerics: the scores follow the JAX op order (spectral_backward.py
// :211-287), IEEE division, NaN-propagating max; the atomics' order varies
// from run to run, so the adjoints agree with the plain version to
// rounding, not bitwise.

#include "adjoint_common.cuh"
#include "mcm_common.cuh"

namespace {

// the raw tape's fields per lane-step, mirrored by the wrapper
// (kernels/spectral_backward.py RAW_TAPE_FIELDS): the deposit, and bit 0
// respawn with bits 8.. the pre-step bin
enum RawTapeField { RT_EMITTED = 0, RT_FLAGS, RT_COUNT };

__device__ __forceinline__ void lane_setup(int lane, const Params& P, uint32_t seed,
                                           uint32_t& s, float& sx, float& sy) {
  uint32_t ix, iy, seed_iy;
  lane_coords(lane, P.i[I_RES], ix, iy, seed_iy, P.f[F_INV_RES], sx, sy);
  s = hash3(ix, seed_iy, seed);
}

// K13: one taped dispatch over raw tables, the state in place. 8 blocks
// per SM (64 registers, no spills) rather than K1's 10 (48 registers, 88 B
// of spills at 12 bins): 3% faster in turns on an H100 80GB HBM3, 700 W
// (probes/raw_scatter.py)
template <int NB>
__global__ void __launch_bounds__(STEP_THREADS, 8)
raw_tape_kernel(const Params P, uint32_t seed, float* __restrict__ px_, float* __restrict__ py_,
                float* __restrict__ pz_, float* __restrict__ dx_, float* __restrict__ dy_,
                float* __restrict__ dz_, int* __restrict__ bounces_,
                int* __restrict__ samples_, int* __restrict__ bin_, float* __restrict__ lam_,
                float* __restrict__ radiance, const void* __restrict__ vol,
                const float* __restrict__ tf, const float* __restrict__ light,
                float* __restrict__ tape) {
  const int n = P.i[I_N_LANES];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const int n_bins = P.i[I_N_BINS];
  uint32_t s;
  float sx, sy;
  lane_setup(lane, P, seed, s, sx, sy);
  Lane L = load_lane(lane, P, px_, py_, pz_, dx_, dy_, dz_, bounces_, samples_, bin_, lam_);
  float rad[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) rad[b] = (b < n_bins) ? radiance[(int64_t)b * n + lane] : 0.0f;
  const StepConsts C = step_consts(P);
  for (int it = 0; it < P.i[I_STEPS]; ++it) {
    SurRecord r;
    woodcock_step<NB, false, false, false, true, false, true>(L, rad, s, sx, sy, P, C, vol, tf,
                                                              nullptr, nullptr, nullptr, &r,
                                                              light);
    float* row = tape + (int64_t)it * RT_COUNT * n + lane;
    row[RT_EMITTED * (int64_t)n] = r.emitted;
    row[RT_FLAGS * (int64_t)n] = __int_as_float((r.pre_bin << 8) | (r.respawn ? 1 : 0));
  }
  store_lane(L, lane, px_, py_, pz_, dx_, dy_, dz_, bounces_, samples_, bin_, lam_);
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (b < n_bins) radiance[(int64_t)b * n + lane] = rad[b];
}

// K14: the reverse scan, the replay and the scatters of one dispatch
template <int NB>
__global__ void __launch_bounds__(STEP_THREADS, 8)
raw_replay_kernel(const Params P, uint32_t seed, float inv_mu, const float* __restrict__ px_,
                  const float* __restrict__ py_, const float* __restrict__ pz_,
                  const float* __restrict__ dx_, const float* __restrict__ dy_,
                  const float* __restrict__ dz_, const int* __restrict__ bounces_,
                  const int* __restrict__ samples_, const int* __restrict__ bin_,
                  const float* __restrict__ lam_, const void* __restrict__ vol,
                  const float* __restrict__ tf, const float* __restrict__ light,
                  const float* __restrict__ tape, const float* __restrict__ g_rs,
                  float* __restrict__ g_vol, float* __restrict__ g_tf,
                  float* __restrict__ g_light, double* __restrict__ ext_acc) {
  const int n = P.i[I_N_LANES];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  double ext = 0.0;
  if (lane < n) {
    const float* f = P.f;
    const int steps = P.i[I_STEPS], n_bins = P.i[I_N_BINS];
    const bool isotropic = P.i[I_ISOTROPIC] != 0, qc = P.i[I_QUASICUBIC] != 0;
    const int TH = P.i[I_TF_H] - 1, TW = P.i[I_TF_W] - 1, LN = P.i[I_LIGHT_N];
    const int VD = P.i[I_VOL_D], VH = P.i[I_VOL_H], VW = P.i[I_VOL_W];
    const int H = VH - 1, W = VW - 1;
    uint32_t s;
    float sx, sy;
    lane_setup(lane, P, seed, s, sx, sy);
    Lane L = load_lane(lane, P, px_, py_, pz_, dx_, dy_, dz_, bounces_, samples_, bin_, lam_);
    float rad[NB];  // the deposits go unused: the replay needs the events only
#pragma unroll
    for (int b = 0; b < NB; ++b) rad[b] = 0.0f;
    const StepConsts C = step_consts(P);
    const float4* tf4 = reinterpret_cast<const float4*>(tf);
    // (c, cb) of the next respawn at or after step `it` (the reverse scan's
    // carry); `nxt` is that step, re-searched once `it` passes it
    float c = 0.0f, cb = 0.0f;
    int nxt = -1;
    for (int it = 0; it < steps; ++it) {
      if (nxt < it) {
        c = 0.0f;
        cb = 0.0f;
        nxt = steps;
        for (int j = it; j < steps; ++j) {
          const float* row = tape + (int64_t)j * RT_COUNT * n + lane;
          const int flags = __float_as_int(row[RT_FLAGS * (int64_t)n]);
          if (flags & 1) {
            const int b = flags >> 8;
            c = row[RT_EMITTED * (int64_t)n];
            cb = (b >= 0 && b < n_bins) ? g_rs[(int64_t)b * n + lane] : 0.0f;
            nxt = j;
            break;
          }
        }
      }
      SurRecord r;
      woodcock_step<NB, false, false, false, true, false, true>(L, rad, s, sx, sy, P, C, vol,
                                                                tf, nullptr, nullptr, nullptr,
                                                                &r, light);
      const float q = cb * c;
      // the extinction score of every step's free flight
      ext += (double)(q * (inv_mu - r.dist));
      // the light spectrum, pathwise at escape
      if (r.oob) {
        const float ddot = r.pdx * f[F_LDX] + r.pdy * f[F_LDY] + r.pdz * f[F_LDZ];
        const float dI = isotropic ? 1.0f : (r.emitted > 0.0f ? ddot : 0.0f);
        const float gl = cb * dI * 5.0f;
        if (gl != 0.0f) {
          const float tl = ((r.lam - 400.0f) / 300.0f) * (float)LN - 0.5f;
          const float fl = floorf(tl);
          const int i0 = sat_int(fl);
          const float lf = tl - fl;
          atomicAdd(g_light + min(max(i0, 0), LN - 1), gl * (1.0f - lf));
          atomicAdd(g_light + min(max(i0 + 1, 0), LN - 1), gl * lf);
        }
      }
      // the event scores: the material at the sample point, as K1 read it
      if (q != 0.0f && (r.null_event || r.scatter)) {
        const float dens = sample_volume_any(vol, P, r.spx, r.spy, r.spz);
        int bx, by;
        float fx, fy;
        wavelength_coord(r.lam, P.i[I_TF_W], bx, fx);
        base_frac(dens, TH, by, fy);
        const int x0 = max(bx - 1, 0), x1 = min(bx, TW - 1);
        const int y0 = max(by - 1, 0), y1 = min(by, TH - 1);
        const float4 k00 = __ldg(tf4 + (int64_t)y0 * TW + x0);
        const float4 k01 = __ldg(tf4 + (int64_t)y0 * TW + x1);
        const float4 k10 = __ldg(tf4 + (int64_t)y1 * TW + x0);
        const float4 k11 = __ldg(tf4 + (int64_t)y1 * TW + x1);
        const float a00[3] = {k00.x, k00.y, k00.z}, a01[3] = {k01.x, k01.y, k01.z};
        const float a10[3] = {k10.x, k10.y, k10.z}, a11[3] = {k11.x, k11.y, k11.z};
        float mat[3], slope[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float r0 = lerp(a00[ch], a01[ch], fx);
          const float r1 = lerp(a10[ch], a11[ch], fx);
          mat[ch] = lerp(r0, r1, fy);
          slope[ch] = (r1 - r0) * (float)TH;
        }
        const float albedo = mat[0], alpha = mat[1], g = mat[2] * 2.0f - 1.0f;
        const float ga = (r.null_event ? -q / nmax(1.0f - alpha, 1e-12f) : 0.0f) +
                         (r.scatter ? q / nmax(alpha, 1e-12f) : 0.0f);
        const float gb = r.scatter ? q / nmax(albedo, 1e-12f) : 0.0f;
        float gg = 0.0f;
        if (r.scatter && fabsf(g) >= kEps) {
          // the HG cosine: the new direction against the pre-step one
          const float cosd = L.dx * r.pdx + L.dy * r.pdy + L.dz * r.pdz;
          const float g2 = g * g;
          const float hg = -2.0f * g / nmax(1.0f - g2, 1e-9f) -
                           3.0f * (g - cosd) / nmax(1.0f + g2 - 2.0f * g * cosd, 1e-9f);
          gg = q * hg;
        }
        gg = gg * 2.0f;
        // the TF texels: 3 channels of 4 corners, one float4 per corner
        const float w[4] = {(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy};
        const int64_t ti[4] = {(int64_t)y0 * TW + x0, (int64_t)y0 * TW + x1,
                               (int64_t)y1 * TW + x0, (int64_t)y1 * TW + x1};
#pragma unroll
        for (int k = 0; k < 4; ++k) add4(g_tf + ti[k] * 4, gb * w[k], ga * w[k], gg * w[k], 0.0f);
        // the density chain: the channel slopes, scattered to the 8 corners
        // with trilinear weights (warped for quasicubic; nearest scatters
        // trilinear too, as the reference's _trilinear_corners does)
        const float gd = gb * slope[0] + ga * slope[1] + gg * slope[2];
        if (gd != 0.0f) {
          int vx0, vx1, vy0, vy1, vz0, vz1;
          float vfx, vfy, vfz;
          raw_axis(r.spx, VW, vx0, vx1, vfx);
          raw_axis(r.spy, VH, vy0, vy1, vfy);
          raw_axis(r.spz, VD, vz0, vz1, vfz);
          if (qc) {
            vfx = quasicubic(vfx);
            vfy = quasicubic(vfy);
            vfz = quasicubic(vfz);
          }
          const int zi[2] = {vz0, vz1}, yi[2] = {vy0, vy1}, xi[2] = {vx0, vx1};
          const float wz[2] = {1 - vfz, vfz}, wy[2] = {1 - vfy, vfy}, wx[2] = {1 - vfx, vfx};
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                atomicAdd(g_vol + ((int64_t)zi[a] * H + yi[b]) * W + xi[e],
                          gd * (wz[a] * wy[b] * wx[e]));
        }
      }
    }
  }
  block_add<STEP_THREADS>(ext, ext_acc);
}

}  // namespace

extern "C" {

int vpt_raw_layout(int which) {
  switch (which) {
    case 0: return F_COUNT;
    case 1: return I_COUNT;
    case 2: return RT_COUNT;
    default: return -1;
  }
}

// one dispatch (seed) of `steps` (I_STEPS) iterations over raw tables,
// updating the state in place; tape: (steps, RT_COUNT, n_lanes) f32
int vpt_raw_tape(const float* fparams, const int* iparams, uint32_t seed, float* px, float* py,
                 float* pz, float* dx, float* dy, float* dz, int* bounces, int* samples,
                 int* bin, float* wavelength, float* radiance, const void* vol,
                 const float* tf, const float* light, float* tape, void* stream) {
  const Params P = make_params(fparams, iparams);
  const int n = P.i[I_N_LANES];
  if (n <= 0) return 0;
  if (P.i[I_RAW] == 0 || P.i[I_MAJ_GZ] != 0 || P.i[I_ENV_H] != 0 ||
      (light != nullptr) != (P.i[I_LIGHT_KIND] != LIGHT_FUSED))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bins_rounded(P.i[I_N_BINS])) {
#define VPT_NB(NB)                                                                          \
  case NB:                                                                                  \
    raw_tape_kernel<NB><<<blocks_for(n, STEP_THREADS), STEP_THREADS, 0, st>>>(              \
        P, seed, px, py, pz, dx, dy, dz, bounces, samples, bin, wavelength, radiance, vol, \
        tf, light, tape);                                                                   \
    break;
    VPT_NB(4) VPT_NB(8) VPT_NB(12) VPT_NB(16) VPT_NB(20) VPT_NB(24) VPT_NB(28) VPT_NB(32)
#undef VPT_NB
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// the reverse scan, replay and scatters of that dispatch from the start
// state: g_rs (n_bins, n_lanes) the per-lane deposit cotangents g_rad /
// m_final; adds into g_vol (D*H*W), g_tf (H*W*4), g_light (N) and, in f64,
// *ext_acc. The tables must be the fully raw ones (grid, (H, W, 4) TF, (N,)
// light).
int vpt_raw_replay(const float* fparams, const int* iparams, uint32_t seed, float inv_mu,
                   const float* px, const float* py, const float* pz, const float* dx,
                   const float* dy, const float* dz, const int* bounces, const int* samples,
                   const int* bin, const float* wavelength, const void* vol, const float* tf,
                   const float* light, const float* tape, const float* g_rs, float* g_vol,
                   float* g_tf, float* g_light, double* ext_acc, void* stream) {
  const Params P = make_params(fparams, iparams);
  const int n = P.i[I_N_LANES];
  if (n <= 0) return 0;
  if (P.i[I_VOL_RAW] == 0 || P.i[I_TF_KIND] != TF_RAW || P.i[I_LIGHT_KIND] != LIGHT_RAW ||
      P.i[I_MAJ_GZ] != 0 || P.i[I_ENV_H] != 0 || light == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bins_rounded(P.i[I_N_BINS])) {
#define VPT_NB(NB)                                                                          \
  case NB:                                                                                  \
    raw_replay_kernel<NB><<<blocks_for(n, STEP_THREADS), STEP_THREADS, 0, st>>>(            \
        P, seed, inv_mu, px, py, pz, dx, dy, dz, bounces, samples, bin, wavelength, vol, tf, \
        light, tape, g_rs, g_vol, g_tf, g_light, ext_acc);                                  \
    break;
    VPT_NB(4) VPT_NB(8) VPT_NB(12) VPT_NB(16) VPT_NB(20) VPT_NB(24) VPT_NB(28) VPT_NB(32)
#undef VPT_NB
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
