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

#include "adjoint_common.cuh"
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
                    float* __restrict__ m_, int every_lane) {
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
  // every_lane (the taped step): every lane looks up, out of bounds too
  if (every_lane || (!oob && !(MAJ && capped))) {
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

// K28: the rest of woodcock_step from the routed row. TAPE (the taped
// step of the slab backward, exact mode only): every lane lerps its routed
// row, out of bounds too, and the lane-step's tape row is written as K4
// writes it (woodcock_step's REC record): `tape` points at the step's (F,
// lanes) rows, `vol_row0` is the global row K27 addressed.
template <int NB, bool MAJ, bool ENV, bool TAPE>
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
                   const float* __restrict__ tf, const float* __restrict__ env, const TapeSpec T,
                   float* __restrict__ tape) {
  static_assert(!(TAPE && MAJ), "the PRB tape has no majorant mode");
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
  float mat[3] = {0.0f, 0.0f, 0.0f}, light_raw = 0.0f;
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
  TfAddr ta = {};
  if (TAPE || (!oob && !capped)) {
    const float4 a = rows[2 * (int64_t)lane], b = rows[2 * (int64_t)lane + 1];
    fx = frac[lane];
    fy = frac[n + lane];
    fz = frac[2 * n + lane];
    const float c00 = lerp(a.x, a.y, fx);
    const float c01 = lerp(a.z, a.w, fx);
    const float c10 = lerp(b.x, b.y, fx);
    const float c11 = lerp(b.z, b.w, fx);
    const float c0 = lerp(c00, c01, fy);
    const float c1 = lerp(c10, c11, fy);
    const float dens = lerp(c0, c1, fz);
    sample_tf(tf, P.i[I_TF_H], P.i[I_TF_W], L.tbx, L.tfx, dens, mat, TAPE ? &light_raw : nullptr,
              TAPE ? &ta : nullptr);
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
  const bool isotropic = P.i[I_ISOTROPIC] != 0;
  float emitted = 0.0f, ddot = 0.0f;
  EnvAddr ea = {0, 0, 0.0f, 0.0f};
  if (oob) {
    if constexpr (ENV) {
      emitted = sample_environment(env, P.i[I_ENV_H], P.i[I_ENV_W], L.dx, L.dy, L.dz, L.lam,
                                   TAPE ? &ea : nullptr);
    } else {
      // the taped step read the light pair with its lookup's row
      if (!TAPE) light_raw = sample_light(tf, L.tbx, L.tfx);
      const float intensity = light_raw * 5.0f;
      ddot = L.dx * f[F_LDX] + L.dy * f[F_LDY] + L.dz * f[F_LDZ];
      emitted = isotropic ? intensity : nmax(ddot * intensity, 0.0f);
    }
  }
  float* row = TAPE ? tape + lane : nullptr;
  if constexpr (TAPE) {
    // woodcock_step's REC record, in K4's slots
    put(row, T, T_EMITTED, emitted);
    put(row, T, T_RESPAWN, (oob || absorb) ? 1.0f : 0.0f);
    put(row, T, T_PRE_BIN, __int_as_float(L.bin));
    put(row, T, T_ALPHA, alpha);
    put(row, T, T_ALBEDO, albedo);
    put(row, T, T_G, g);
    put(row, T, T_NULL, (event && !absorb && !scatter) ? 1.0f : 0.0f);
    put(row, T, T_SCATTER, scatter ? 1.0f : 0.0f);
    put(row, T, T_FX, ta.fx);
    put(row, T, T_DIST, dist);
    put(row, T, T_TF_ROW, __int_as_float(ta.row));
    put(row, T, T_FY, ta.fy);
    put(row, T, T_LIGHT_W,
        (oob && !ENV) ? (isotropic ? 1.0f : (emitted > 0.0f ? ddot : 0.0f)) * 5.0f : 0.0f);
    put(row, T, T_SLOPE0, ta.slope[0]);
    put(row, T, T_SLOPE1, ta.slope[1]);
    put(row, T, T_SLOPE2, ta.slope[2]);
    put(row, T, T_VOL_ROW0, __int_as_float(idx[lane]));
    put(row, T, T_VFX, fx);
    put(row, T, T_VFY, fy);
    put(row, T, T_VFZ, fz);
    if constexpr (ENV) {
      put(row, T, T_ENV_ROW, __int_as_float(ea.row));
      put(row, T, T_ENV_FX, ea.fx);
      put(row, T, T_ENV_FY, ea.fy);
      put(row, T, T_ENV_BAND, __int_as_float(ea.band));
      put(row, T, T_ENV_W, oob ? kEnvGain : 0.0f);
    }
  }
  float hg_cos = 0.0f;
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
      const float ox = L.dx, oy = L.dy, oz = L.dz;
      draw_hg(s, kx, ky, g, L.dx, L.dy, L.dz);
      L.bounces += 1;
      if (TAPE) hg_cos = L.dx * ox + L.dy * oy + L.dz * oz;
    }
  }
  if constexpr (TAPE) put(row, T, T_HG_COS, hg_cos);
  store_lane(L, lane, px_, py_, pz_, dx_, dy_, dz_, bounces_, samples_, bin_, lam_);
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (b < n_bins) radiance[(int64_t)b * n + lane] = rad[b];
  rng[lane] = s;
}

// K29: the owner side of the routed adjoint scatter, the exact transpose of
// K26. `pairs` is every rank's pair list (K5 ROUTED's, spectral_backward.cu)
// gathered in rank order, n_ranks blocks of 4 + 10 m floats: the count
// (int32) in a 16-byte header, m slot ids, m int32 global rows, then m
// 8-wide rows of values; only the first count pairs are read. blockIdx.y is
// the rank; the blocks of a rank walk its count with a grid-stride loop, so
// the count stays on the device and nothing reads an empty slot. A pair's
// values are added into this rank's (rows, 8) slab where lo <= row < lo +
// rows, by two float4 atomics as K5 adds a row.
//
// What bounds it: per pair a 4-byte row and 32 bytes of values read, per
// touched adjoint row 32 bytes read and written by the atomics; at the bench
// scale (53,080 pairs in 16.8 M slots) that is ~4.4 MB, ~1.3 us at 3.35
// TB/s, below a launch's own latency. The first design read every slot's
// row to find the 0.32% that held one (67 MB) and lost 13x to index_add_
// over the owned pairs; the list is compacted where K5 makes it.
__global__ void __launch_bounds__(256)
slab_scatter_kernel(const float* __restrict__ pairs, int64_t m, int64_t lo, int64_t rows,
                    float* __restrict__ adj) {
  const float* block = pairs + (int64_t)blockIdx.y * (4 + 10 * m);
  const int64_t n = __ldg(reinterpret_cast<const int*>(block)), count = n < m ? n : m;
  const int* row_of = reinterpret_cast<const int*>(block) + 4 + m;
  const float4* val = reinterpret_cast<const float4*>(block + 4 + 2 * m);
  for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < count;
       k += (int64_t)gridDim.x * blockDim.x) {
    const int row = __ldcs(row_of + k);
    const int64_t local = (int64_t)row - lo;
    if (row < 0 || local < 0 || local >= rows) continue;
    const float4 a = __ldcs(val + 2 * k), b = __ldcs(val + 2 * k + 1);
    float* p = adj + local * 8;
    add4(p, a.x, a.y, a.z, a.w);
    add4(p + 4, b.x, b.y, b.z, b.w);
  }
}

// one packed axis entry of raw index a under corner bit `bit` (the edge
// pad's transpose, vpt_tpu/parallel/slab.py::_unpad_transpose): the main
// entry a + 1 - bit, and the edge entry (0 for bit 0 at a = 0, n for bit 1
// at a = n - 1) or -1
__device__ __forceinline__ void unpad_entries(int a, int bit, int n, int& main, int& edge) {
  main = a + 1 - bit;
  edge = bit == 0 ? (a == 0 ? 0 : -1) : (a == n - 1 ? n : -1);
}

// plane k of this slab's adjoint A (slab_z, Hp, Wp, 8) at raw (y, x),
// corners c0 .. c0 + 3 (one z bit): the sum B of _contract_slab_adjoint's
// B0 (c0 = 0) or B1 (c0 = 4), in its order: each corner's y transpose,
// then its x transpose, the corners added in turn to 0
__device__ __forceinline__ float slab_corners(const float* __restrict__ adj, int k, int y, int x,
                                              int H, int W, int c0) {
  const int64_t Hp = H + 1, Wp = W + 1;
  const float* plane = adj + (int64_t)k * Hp * Wp * 8;
  float acc = 0.0f;
#pragma unroll
  for (int c = c0; c < c0 + 4; ++c) {
    int ym, ye, xm, xe;
    unpad_entries(y, (c >> 1) & 1, H, ym, ye);
    unpad_entries(x, c & 1, W, xm, xe);
    // the y transpose's entries at column xi: main, plus the edge's
    auto col = [&](int xi) {
      float t = __ldg(plane + ((int64_t)ym * Wp + xi) * 8 + c);
      if (ye >= 0) t = t + __ldg(plane + ((int64_t)ye * Wp + xi) * 8 + c);
      return t;
    };
    float g = col(xm);
    if (xe >= 0) g = g + col(xe);
    acc = acc + g;
  }
  return acc;
}

// the local partial L[k] (raw plane lo - 1 + k) before the folds:
// B0[k] (k < slab_z) + B1[k - 1] (k >= 1), the missing term 0
__device__ __forceinline__ float slab_partial(const float* __restrict__ adj, int k, int y, int x,
                                              int slab_z, int H, int W) {
  const float b0 = k < slab_z ? slab_corners(adj, k, y, x, H, W, 0) : 0.0f;
  const float b1 = k >= 1 ? slab_corners(adj, k - 1, y, x, H, W, 4) : 0.0f;
  return b0 + b1;
}

// K30: this rank's share of _contract_slab_adjoint (:160-209), the packed
// volume adjoint's transpose over its slab (packed planes [lo, lo +
// slab_z)): out (slab_z + 1, H, W), raw planes [lo - 1, lo + slab_z - 1],
// both folds applied (plane -1 into plane 0; planes >= D zeroed and their
// sum added at kstar = clip(D - lo, 0, slab_z), the plane D - 1 or, when
// lo >= D, plane 0, which the halo then carries to the rank before). One
// thread a raw element; the kstar plane's thread also sums the overflow.
__global__ void __launch_bounds__(256)
slab_contract_kernel(const float* __restrict__ adj, int lo, int slab_z, int D, int H, int W,
                     float* __restrict__ out) {
  const int64_t cell = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= (int64_t)(slab_z + 1) * H * W) return;
  const int x = (int)(cell % W);
  const int64_t ky = cell / W;
  const int y = (int)(ky % H), k = (int)(ky / H);
  // the fold of plane -1 (this rank's L[0] when lo == 0) into plane 0 (L[1])
  auto folded = [&](int kk) {
    float v = slab_partial(adj, kk, y, x, slab_z, H, W);
    if (kk == 1) v = v + (lo == 0 ? slab_partial(adj, 0, y, x, slab_z, H, W) : 0.0f);
    return v;
  };
  const int kstar = min(max(D - lo, 0), slab_z);
  float v = (lo - 1 + k >= D) ? 0.0f : folded(k);
  if (k == kstar) {
    float overflow = 0.0f;
    for (int kk = max(D - lo + 1, 0); kk <= slab_z; ++kk) overflow = overflow + folded(kk);
    v = v + overflow;
  }
  out[cell] = v;
}

// K31: _pack_slab_rows (:405-428), this rank's packed planes [lo, lo +
// slab_z) of the f32 corner table from the replicated raw (D, H, W) grid:
// packed row (z, y, x) holds the 8 corners of raw planes clip(z - 1) and
// clip(z) with xy edge padding (pack_volume_kernel's, corners.cu); planes
// z > D are zero (the pad of pad_packed_for_slabs). One thread a row.
__global__ void __launch_bounds__(256)
slab_pack_kernel(const float* __restrict__ d, int lo, int slab_z, int D, int H, int W,
                 float* __restrict__ out) {
  const int64_t Hp = H + 1, Wp = W + 1;
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= (int64_t)slab_z * Hp * Wp) return;
  const int x = (int)(row % Wp);
  const int64_t zy = row / Wp;
  const int y = (int)(zy % Hp), z = lo + (int)(zy / Hp);
  float4* o = reinterpret_cast<float4*>(out + row * 8);
  if (z > D) {
    o[0] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    o[1] = o[0];
    return;
  }
  const int64_t z0 = min(max(z - 1, 0), D - 1), z1 = min(max(z, 0), D - 1);
  const int64_t y0 = min(max(y - 1, 0), H - 1), y1 = min(y, H - 1);
  const int64_t x0 = min(max(x - 1, 0), W - 1), x1 = min(x, W - 1);
  const float* p00 = d + (z0 * H + y0) * W;
  const float* p01 = d + (z0 * H + y1) * W;
  const float* p10 = d + (z1 * H + y0) * W;
  const float* p11 = d + (z1 * H + y1) * W;
  o[0] = make_float4(__ldg(p00 + x0), __ldg(p00 + x1), __ldg(p01 + x0), __ldg(p01 + x1));
  o[1] = make_float4(__ldg(p10 + x0), __ldg(p10 + x1), __ldg(p11 + x0), __ldg(p11 + x1));
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
                   const float* m, const int* idx, const float* tf, const float* env,
                   const TapeSpec& T, float* tape) {
#define VPT_FINISH(M, E, TP)                                                                  \
  slab_finish_kernel<NB, M, E, TP><<<blocks_for(P.i[I_N_LANES], STEP_THREADS), STEP_THREADS, \
                                     0, st>>>(P, px, py, pz, dx, dy, dz, bounces, samples,    \
                                              bin, lam, radiance, lane_ix, lane_iy, rng,      \
                                              reinterpret_cast<const float4*>(rows), frac,    \
                                              dist, m, idx, tf, env, T, tape)
  if (tape != nullptr) {
    if (env == nullptr) VPT_FINISH(false, false, true);
    else VPT_FINISH(false, true, true);
  } else if (m == nullptr && env == nullptr) VPT_FINISH(false, false, false);
  else if (env == nullptr) VPT_FINISH(true, false, false);
  else if (m == nullptr) VPT_FINISH(false, true, false);
  else VPT_FINISH(true, true, false);
#undef VPT_FINISH
}

}  // namespace

extern "C" {

int vpt_slab_layout(int which) {
  switch (which) {
    case 0: return MAX_BINS;
    case 1: return F_COUNT;
    case 2: return I_COUNT;
    case 3: return T_COUNT;
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
// every_lane != 0 (the taped step, exact mode only): every lane requests its
// row, out of bounds too
int vpt_slab_advance(const float* fparams, const int* iparams, const float* px, const float* py,
                     const float* pz, const float* dx, const float* dy, const float* dz,
                     const uint32_t* lane_ix, const uint32_t* lane_seed_iy, uint32_t seed,
                     int first, uint32_t* rng, const float* maj, int* idx, float* frac,
                     float* dist, float* m, int every_lane, void* stream) {
  const Params P = make_params(fparams, iparams);
  const int n = P.i[I_N_LANES];
  if (n <= 0) return 0;
  if (!slab_layout_ok(P) || (maj != nullptr) != (P.i[I_MAJ_GZ] > 0) ||
      (maj != nullptr) != (m != nullptr) || (every_lane && maj != nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(n, STEP_THREADS);
  if (maj != nullptr)
    slab_advance_kernel<true><<<blocks, STEP_THREADS, 0, st>>>(
        P, px, py, pz, dx, dy, dz, lane_ix, lane_seed_iy, seed, first, rng,
        reinterpret_cast<const float2*>(maj), idx, frac, dist, m, every_lane);
  else
    slab_advance_kernel<false><<<blocks, STEP_THREADS, 0, st>>>(
        P, px, py, pz, dx, dy, dz, lane_ix, lane_seed_iy, seed, first, rng, nullptr, idx, frac,
        dist, nullptr, every_lane);
  return (int)cudaGetLastError();
}

// rows: the (N, 8) f32 rows routed back to this rank's lanes; m: the
// majorant handoff (MAJ mode) or null; env: the packed map or null; tape
// (TAPE mode, exact only): the step's (F, N) tape rows, `slots` each
// TapeField's slot in F or -1, else null
int vpt_slab_finish(const float* fparams, const int* iparams, float* px, float* py, float* pz,
                    float* dx, float* dy, float* dz, int* bounces, int* samples, int* bin,
                    float* lam, float* radiance, const uint32_t* lane_ix,
                    const uint32_t* lane_iy, uint32_t* rng, const float* rows,
                    const float* frac, const float* dist, const float* m, const int* idx,
                    const float* tf, const float* env, const int* slots, int n_fields,
                    float* tape, void* stream) {
  const Params P = make_params(fparams, iparams);
  const int n = P.i[I_N_LANES];
  if (n <= 0) return 0;
  if (!slab_layout_ok(P) || (m != nullptr) != (P.i[I_MAJ_GZ] > 0) ||
      (env != nullptr) != (P.i[I_ENV_H] > 0) || (tape != nullptr && m != nullptr) ||
      (tape != nullptr) != (slots != nullptr))
    return (int)cudaErrorInvalidValue;
  const int no_slots[T_COUNT] = {};
  const TapeSpec T = make_tape_spec(slots != nullptr ? slots : no_slots, n_fields, n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bins_rounded(P.i[I_N_BINS])) {
#define VPT_NB(NB)                                                                            \
  case NB:                                                                                    \
    launch_finish<NB>(P, st, px, py, pz, dx, dy, dz, bounces, samples, bin, lam, radiance,    \
                      lane_ix, lane_iy, rng, rows, frac, dist, m, idx, tf, env, T, tape);     \
    break;
    VPT_NB(4) VPT_NB(8) VPT_NB(12) VPT_NB(16) VPT_NB(20) VPT_NB(24) VPT_NB(28) VPT_NB(32)
#undef VPT_NB
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K29: pairs, every rank's pair list gathered (n_ranks blocks of 4 + 10 m
// floats, m a multiple of 4); adj: this rank's (rows, 8) slab of the
// adjoint, global rows [lo, lo + rows), added into. A few blocks an SM in
// all, shared by the ranks.
int vpt_slab_scatter(const float* pairs, int64_t m, int n_ranks, int64_t lo, int64_t rows,
                     float* adj, void* stream) {
  if (m <= 0 || n_ranks <= 0) return 0;
  if (lo < 0 || rows < 0 || m % 4 != 0 || n_ranks > 65535) return (int)cudaErrorInvalidValue;
  // the device's SM count, asked once a device
  static int sms_of[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& sms = sms_of[dev & 63];
  if (sms == 0) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t fill = (int64_t)4 * sms / n_ranks, need = (m + 255) / 256;
  const int64_t per_rank = fill < 1 ? 1 : fill < need ? fill : need;
  slab_scatter_kernel<<<dim3((unsigned)per_rank, (unsigned)n_ranks), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(pairs, m, lo, rows, adj);
  return (int)cudaGetLastError();
}

// K30: adj (slab_z (H+1)(W+1), 8), this rank's packed planes [lo, lo +
// slab_z); out (slab_z + 1, H, W)
int vpt_slab_contract(const float* adj, int lo, int slab_z, int D, int H, int W, float* out,
                      void* stream) {
  const int64_t n = (int64_t)(slab_z + 1) * H * W;
  if (n <= 0) return 0;
  if (lo < 0 || D <= 0) return (int)cudaErrorInvalidValue;
  slab_contract_kernel<<<(unsigned)((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      adj, lo, slab_z, D, H, W, out);
  return (int)cudaGetLastError();
}

// K31: raw (D, H, W) f32; out (slab_z (H+1)(W+1), 8) f32, packed planes
// [lo, lo + slab_z)
int vpt_slab_pack(const float* raw, int lo, int slab_z, int D, int H, int W, float* out,
                  void* stream) {
  const int64_t n = (int64_t)slab_z * (H + 1) * (W + 1);
  if (n <= 0) return 0;
  if (lo < 0 || D <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  slab_pack_kernel<<<(unsigned)((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      raw, lo, slab_z, D, H, W, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
