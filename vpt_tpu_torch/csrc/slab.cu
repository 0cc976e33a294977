// Slab-sharded spectral render kernels for Hopper (sm_90a), plain C interface.
//
// The slab render (vpt_tpu_torch/parallel/slab.py) splits the full packed
// corner table (rows, 8) along z into slabs, one a rank, and runs each
// Woodcock step as
//
//   K27 slab_advance  -> all-gather of the row requests -> K26 slab_rows
//   -> reduce-scatter of the rows -> K28 slab_finish
//
// so the step's one volume lookup becomes a routed gather between the ranks.
//
//   slab_rows     (K26) replaces the owner side of vpt_tpu/parallel/slab.py::
//                 _distributed_rows (:64-86): for every gathered request
//                 (n ranks x N lanes, -1 = none) the row of this rank's slab,
//                 dequantized (u8 code / 255, an IEEE division, before any
//                 masking), where lo <= idx < lo + rows, and +0.0 elsewhere.
//                 Every row of the reduce-scatter that follows then has
//                 exactly one nonzero term (its owner's), so the sum is exact
//                 in any order: x + 0 = x (a -0.0 corner would come back as
//                 +0.0; the packed tables hold none below zero).
//   slab_advance  (K27) and slab_finish (K28) replace the per-step body of
//                 render_slab (:680-688), vpt_tpu/models/mcm_spectral.py::
//                 _render_body with the slab sampler _sample_volume_slab
//                 (:87-117): K1's Woodcock step (mcm_common.cuh woodcock_step)
//                 cut at its one volume lookup. K27 loads the lane, seeds the
//                 RNG word at the dispatch's first step with hash3(ix, seed_iy,
//                 seed) as K1 does (else reads it back), draws the free flight
//                 (with the replicated majorant grid in MAJ mode) and writes the
//                 flat row ((bz * Hp + by) * Wp + bx) of the table it would look
//                 up, its fractions (quasicubic-warped by the runtime flag), the
//                 flight and its majorant, or -1 where K1 looks nothing up (the
//                 flight left the volume, or hit its cap). K28 lerps the routed
//                 row in K1's order, reads the fused TF, and runs the rest of the
//                 step: the event wheel, the escape (the env map in ENV mode),
//                 the deposit, the respawn or the HG scatter; it stores the lane
//                 and the RNG word. The draws happen in K1's order with K1's
//                 arithmetic, so a slab render equals K1's render from the same
//                 state bit for bit, in every state field.
//
// The two halves are written here beside woodcock_step rather than by cutting
// it, so K1's and K4's code stays as it was; the equality tests hold the two
// copies in step (tests/test_torch_slab.py on the plain versions, chip_smoke
// phase 26 on the card).
//
// What bounds them. K26 moves bytes: a 4-byte index per request, a table row
// (8 B u8, 32 B f32) per owned request, 32 B out per request; one thread a
// request, two 16-byte stores. K27 and K28 are K1's step split in two: K1
// keeps a lane's state in registers for a whole dispatch, the halves load and
// store it around every collective (~90 B a lane-step for 12 bins, plus the
// 24 B handoff and the 32 B row), so they are bound by those bytes where K1
// is bound by instruction issue. The design is the simplest right one: one
// thread a lane, the handoff in structure-of-arrays buffers.
//
// Numerics as mcm_spectral.cu: no fast math, -fmad=false; the flight's
// quotient is IEEE's (quot), the u8 code's IEEE division equals K1's
// u8_unit bit for bit for all 256 codes.

#include "mcm_common.cuh"

namespace {

__global__ void __launch_bounds__(256)
slab_rows_kernel(const void* __restrict__ slab, int is_u8, int64_t lo, int64_t rows,
                 const int* __restrict__ req, float4* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = __ldg(req + i);
  const int64_t local = (int64_t)r - lo;
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
  if (r >= 0 && local >= 0 && local < rows) {
    if (is_u8) {
      const uint2 w = __ldg(reinterpret_cast<const uint2*>(static_cast<const uint8_t*>(slab) +
                                                           local * 8));
      float c[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        c[k] = __fdiv_rn((float)((w.x >> (8 * k)) & 0xFFu), 255.0f);
        c[4 + k] = __fdiv_rn((float)((w.y >> (8 * k)) & 0xFFu), 255.0f);
      }
      a = make_float4(c[0], c[1], c[2], c[3]);
      b = make_float4(c[4], c[5], c[6], c[7]);
    } else {
      const float4* t = reinterpret_cast<const float4*>(static_cast<const float*>(slab) + local * 8);
      a = __ldg(t);
      b = __ldg(t + 1);
    }
  }
  out[2 * i] = a;
  out[2 * i + 1] = b;
}

// K27: the free flight of woodcock_step and the address of its lookup
template <bool MAJ>
__global__ void __launch_bounds__(STEP_THREADS)
slab_advance_kernel(const Params P, const float* __restrict__ px_, const float* __restrict__ py_,
                    const float* __restrict__ pz_, const float* __restrict__ dx_,
                    const float* __restrict__ dy_, const float* __restrict__ dz_,
                    const uint32_t* __restrict__ lane_ix,
                    const uint32_t* __restrict__ lane_seed_iy, uint32_t seed, int first,
                    uint32_t* __restrict__ rng, const float2* __restrict__ maj,
                    int* __restrict__ idx, float* __restrict__ frac, float* __restrict__ dist_,
                    float* __restrict__ m_) {
  const int n = P.i[I_N_LANES];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint32_t s = first ? hash3(__ldg(lane_ix + lane), __ldg(lane_seed_iy + lane), seed) : rng[lane];
  const float px = px_[lane], py = py_[lane], pz = pz_[lane];
  const float dx = dx_[lane], dy = dy_[lane], dz = dz_[lane];
  const float* f = P.f;
  float dist, m = 0.0f;
  bool capped = false;
  if constexpr (MAJ) {
    const int cz = floor_cell(pz, P.i[I_MAJ_GZ]);
    const int cy = floor_cell(py, P.i[I_MAJ_GY]);
    const int cx = floor_cell(px, P.i[I_MAJ_GX]);
    const float2 row = __ldg(maj + ((int64_t)cz * P.i[I_MAJ_GY] + cy) * P.i[I_MAJ_GX] + cx);
    m = nmax(row.x, 1e-12f);
    const float rate = f[F_EXTINCTION] * m;
    dist = -logf(draw(s)) / rate;
    capped = dist >= row.y;
    dist = nmin(dist, row.y);
  } else {
    dist = quot(-logf(draw(s)), recip(f[F_EXTINCTION]));
  }
  const float npx = px + dist * dx;
  const float npy = py + dist * dy;
  const float npz = pz + dist * dz;
  const bool oob = (npx > 1.0f) | (npx < 0.0f) | (npy > 1.0f) |
                   (npy < 0.0f) | (npz > 1.0f) | (npz < 0.0f);
  int r = -1;
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
  if (!oob && !(MAJ && capped)) {
    int64_t row, row1;
    volume_rows(false, P.i[I_VOL_D], P.i[I_VOL_H], P.i[I_VOL_W], npx, npy, npz, row, row1, fx, fy,
                fz);
    if (P.i[I_QUASICUBIC] != 0) {
      fx = quasicubic(fx);
      fy = quasicubic(fy);
      fz = quasicubic(fz);
    }
    r = (int)row;
  }
  idx[lane] = r;
  frac[lane] = fx;
  frac[n + lane] = fy;
  frac[2 * n + lane] = fz;
  dist_[lane] = dist;
  if constexpr (MAJ) m_[lane] = m;
  rng[lane] = s;
}

// K28: the rest of woodcock_step (no tape) from the routed row
template <int NB, bool MAJ, bool ENV>
__global__ void __launch_bounds__(STEP_THREADS)
slab_finish_kernel(const Params P, float* __restrict__ px_, float* __restrict__ py_,
                   float* __restrict__ pz_, float* __restrict__ dx_, float* __restrict__ dy_,
                   float* __restrict__ dz_, int* __restrict__ bounces_,
                   int* __restrict__ samples_, int* __restrict__ bin_,
                   float* __restrict__ lam_, float* __restrict__ radiance,
                   const uint32_t* __restrict__ lane_ix, const uint32_t* __restrict__ lane_iy,
                   uint32_t* __restrict__ rng, const float4* __restrict__ rows,
                   const float* __restrict__ frac, const float* __restrict__ dist_,
                   const float* __restrict__ m_, const int* __restrict__ idx,
                   const float* __restrict__ tf, const float* __restrict__ env) {
  const int n = P.i[I_N_LANES];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const int n_bins = P.i[I_N_BINS];
  const float* f = P.f;
  const float sx = (((float)__ldg(lane_ix + lane) + 0.5f) * f[F_INV_RES] - 0.5f) * 2.0f;
  const float sy = (((float)__ldg(lane_iy + lane) + 0.5f) * f[F_INV_RES] - 0.5f) * -2.0f;
  Lane L = load_lane(lane, P, px_, py_, pz_, dx_, dy_, dz_, bounces_, samples_, bin_, lam_);
  float rad[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) rad[b] = (b < n_bins) ? radiance[(int64_t)b * n + lane] : 0.0f;
  uint32_t s = rng[lane];
  const float dist = dist_[lane];
  const float npx = L.px + dist * L.dx;
  const float npy = L.py + dist * L.dy;
  const float npz = L.pz + dist * L.dz;
  const bool oob = (npx > 1.0f) | (npx < 0.0f) | (npy > 1.0f) |
                   (npy < 0.0f) | (npz > 1.0f) | (npz < 0.0f);
  // K27 requested no row for a lane in bounds only where the flight hit its cap
  const bool capped = MAJ && !oob && idx[lane] < 0;
  const float m = MAJ ? m_[lane] : 0.0f;
  float mat[3] = {0.0f, 0.0f, 0.0f};
  if (!oob && !capped) {
    const float4 a = rows[2 * (int64_t)lane], b = rows[2 * (int64_t)lane + 1];
    const float fx = frac[lane], fy = frac[n + lane], fz = frac[2 * n + lane];
    const float c00 = lerp(a.x, a.y, fx);
    const float c01 = lerp(a.z, a.w, fx);
    const float c10 = lerp(b.x, b.y, fx);
    const float c11 = lerp(b.z, b.w, fx);
    const float c0 = lerp(c00, c01, fy);
    const float c1 = lerp(c10, c11, fy);
    const float dens = lerp(c0, c1, fz);
    sample_tf(tf, P.i[I_TF_H], P.i[I_TF_W], L.tbx, L.tfx, dens, mat, nullptr, nullptr);
  }
  const float albedo = mat[0], alpha = mat[1];
  const float g = mat[2] * 2.0f - 1.0f;
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
  float emitted = 0.0f;
  if (oob) {
    if constexpr (ENV) {
      emitted = sample_environment(env, P.i[I_ENV_H], P.i[I_ENV_W], L.dx, L.dy, L.dz, L.lam);
    } else {
      const float intensity = sample_light(tf, L.tbx, L.tfx) * 5.0f;
      const float ddot = L.dx * f[F_LDX] + L.dy * f[F_LDY] + L.dz * f[F_LDZ];
      emitted = (P.i[I_ISOTROPIC] != 0) ? intensity : nmax(ddot * intensity, 0.0f);
    }
  }
  const bool respawn_now = oob || absorb;
  float kx = 0.0f, ky = 0.0f;
  if (respawn_now || scatter) draw_disk(s, kx, ky);
  if (respawn_now) {
    L.samples += 1;
    deposit<NB>(rad, L.bin, emitted, L.samples);
    const Ray r = respawn_from_disk(s, kx, ky, sx, sy, P);
    L.px = r.px; L.py = r.py; L.pz = r.pz;
    L.dx = r.dx; L.dy = r.dy; L.dz = r.dz;
    L.lam = r.lam; L.bin = r.bin;
    L.bounces = 0;
  } else {
    L.px = npx; L.py = npy; L.pz = npz;
    if (scatter) {
      draw_hg(s, kx, ky, g, L.dx, L.dy, L.dz);
      L.bounces += 1;
    }
  }
  store_lane(L, lane, px_, py_, pz_, dx_, dy_, dz_, bounces_, samples_, bin_, lam_);
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (b < n_bins) radiance[(int64_t)b * n + lane] = rad[b];
  rng[lane] = s;
}

// the slab render's tables: the full packed volume (no xy, no raw table),
// the fused TF, a packed env map
bool slab_layout_ok(const Params& P) {
  return P.i[I_RAW] == 0 && P.i[I_VOL_XY] == 0 && P.i[I_VOL_RAW] == 0 && P.i[I_TF_KIND] == TF_FUSED;
}

template <int NB>
void launch_finish(const Params& P, cudaStream_t st, float* px, float* py, float* pz, float* dx,
                   float* dy, float* dz, int* bounces, int* samples, int* bin, float* lam,
                   float* radiance, const uint32_t* lane_ix, const uint32_t* lane_iy,
                   uint32_t* rng, const float* rows, const float* frac, const float* dist,
                   const float* m, const int* idx, const float* tf, const float* env) {
#define VPT_FINISH(M, E)                                                                      \
  slab_finish_kernel<NB, M, E><<<blocks_for(P.i[I_N_LANES], STEP_THREADS), STEP_THREADS, 0,  \
                                 st>>>(P, px, py, pz, dx, dy, dz, bounces, samples, bin, lam, \
                                       radiance, lane_ix, lane_iy, rng,                       \
                                       reinterpret_cast<const float4*>(rows), frac, dist, m,  \
                                       idx, tf, env)
  if (m == nullptr && env == nullptr) VPT_FINISH(false, false);
  else if (env == nullptr) VPT_FINISH(true, false);
  else if (m == nullptr) VPT_FINISH(false, true);
  else VPT_FINISH(true, true);
#undef VPT_FINISH
}

}  // namespace

extern "C" {

int vpt_slab_layout(int which) {
  switch (which) {
    case 0: return MAX_BINS;
    case 1: return F_COUNT;
    case 2: return I_COUNT;
    default: return -1;
  }
}

// slab: (rows, 8) u8 or f32, this rank's rows [lo, lo + rows) of the global
// table; req: n int32 requests (-1 = none); out: (n, 8) f32
int vpt_slab_rows(const void* slab, int is_u8, int64_t lo, int64_t rows, const int* req,
                  float* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  if (lo < 0 || rows < 0) return (int)cudaErrorInvalidValue;
  slab_rows_kernel<<<(unsigned)((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      slab, is_u8, lo, rows, req, reinterpret_cast<float4*>(out), n);
  return (int)cudaGetLastError();
}

// first != 0: the dispatch's first step (seed the RNG words); maj and m: the
// majorant grid and the (N,) majorant handoff, both or neither; frac: (3, N)
int vpt_slab_advance(const float* fparams, const int* iparams, const float* px, const float* py,
                     const float* pz, const float* dx, const float* dy, const float* dz,
                     const uint32_t* lane_ix, const uint32_t* lane_seed_iy, uint32_t seed,
                     int first, uint32_t* rng, const float* maj, int* idx, float* frac,
                     float* dist, float* m, void* stream) {
  const Params P = make_params(fparams, iparams);
  const int n = P.i[I_N_LANES];
  if (n <= 0) return 0;
  if (!slab_layout_ok(P) || (maj != nullptr) != (P.i[I_MAJ_GZ] > 0) ||
      (maj != nullptr) != (m != nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(n, STEP_THREADS);
  if (maj != nullptr)
    slab_advance_kernel<true><<<blocks, STEP_THREADS, 0, st>>>(
        P, px, py, pz, dx, dy, dz, lane_ix, lane_seed_iy, seed, first, rng,
        reinterpret_cast<const float2*>(maj), idx, frac, dist, m);
  else
    slab_advance_kernel<false><<<blocks, STEP_THREADS, 0, st>>>(
        P, px, py, pz, dx, dy, dz, lane_ix, lane_seed_iy, seed, first, rng, nullptr, idx, frac,
        dist, nullptr);
  return (int)cudaGetLastError();
}

// rows: the (N, 8) f32 rows routed back to this rank's lanes; m: the
// majorant handoff (MAJ mode) or null; env: the packed map or null
int vpt_slab_finish(const float* fparams, const int* iparams, float* px, float* py, float* pz,
                    float* dx, float* dy, float* dz, int* bounces, int* samples, int* bin,
                    float* lam, float* radiance, const uint32_t* lane_ix,
                    const uint32_t* lane_iy, uint32_t* rng, const float* rows,
                    const float* frac, const float* dist, const float* m, const int* idx,
                    const float* tf, const float* env, void* stream) {
  const Params P = make_params(fparams, iparams);
  const int n = P.i[I_N_LANES];
  if (n <= 0) return 0;
  if (!slab_layout_ok(P) || (m != nullptr) != (P.i[I_MAJ_GZ] > 0) ||
      (env != nullptr) != (P.i[I_ENV_H] > 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bins_rounded(P.i[I_N_BINS])) {
#define VPT_NB(NB)                                                                            \
  case NB:                                                                                    \
    launch_finish<NB>(P, st, px, py, pz, dx, dy, dz, bounces, samples, bin, lam, radiance,    \
                      lane_ix, lane_iy, rng, rows, frac, dist, m, idx, tf, env);              \
    break;
    VPT_NB(4) VPT_NB(8) VPT_NB(12) VPT_NB(16) VPT_NB(20) VPT_NB(24) VPT_NB(28) VPT_NB(32)
#undef VPT_NB
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
