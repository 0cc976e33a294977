// K12 surrogate_reverse for Hopper (sm_90a), plain C interface.
//
//   surrogate_reverse  replaces jax.grad's reverse of
//                      vpt_tpu/models/mcm_spectral.py::render_diff
//                      (:508-556; the diff branches of _render_body,
//                      :253-279, :352-355, :379-383, and _surrogate,
//                      :203-209): the autodiff surrogate's backward, one
//                      thread per lane walking K stored dispatch tapes
//                      (K4's surrogate mode, spectral_backward.cu) in
//                      reverse. With the environment map (ENV, the escape
//                      of :148-162), the quasicubic filter
//                      (ops/interp.py:389-392), the xy half-packed
//                      volume (XY, ops/interp.py:226-266) and raw or partly
//                      packed tables and the nearest filter (RAW,
//                      ops/interp.py:411-648 under jax.grad).
//
// Per lane it carries the score cotangent c (the deposit cotangents after
// this step up to the next respawn), the adjoints of the position and the
// direction, and the radiance adjoint of every bin; a respawn's running
// mean r += (target - r) / n sends g / n to the deposit and leaves
// g (1 - 1/n). Per lane-step it adds the extinction score, the event scores
// into alpha and albedo (majorant mode: p_real = min(alpha / m, 1), nothing
// where clipped), the HG inversion's pathwise terms into g and the incoming
// direction, the light's into the direction (in env mode the equirect
// lookup's: its slopes in u and v times d(u, v)/d(direction) through
// atan2(dx, -dz) and asin(-dy), unbounded at the poles as jax.grad's; and
// the escape's 4 texel terms, one channel of a 12-wide row, into the env
// adjoint, summed over a warp's lanes that share the row and channel
// first: add_env_texels), the density lookup's spatial gradient into
// the position (through the warp's derivative 6f(1 - f) under the
// quasicubic filter, whose corner weights are the warped ones), dist x
// g_pos into the direction, and
// slopes x (g_albedo, g_alpha, 2 g_g) into the density. It adds one 8-wide
// volume row per event lane-step (over an xy volume the two 4-wide rows of
// the z0 and z1 planes, one float4 each; at a clamped z plane both land on
// one row, as JAX's scatter adds both) and the TF+light rows into the
// packed adjoints with float2/float4 atomics, as K5 does; K9 contracts them. A
// respawn drops the position and direction adjoints: the camera ray depends
// on no parameter. The carry is read from and written back to its arrays,
// so the adjoints at the tapes' end go in and those at their start come
// out: one launch walks a whole window back, and dispatches also chain
// launch to launch.
//
// The tape holds what cannot be recomputed: the flags and bin, the flight,
// the pre-step direction, the chain's state before its disk draw, the
// sample position and the wavelength (and m in majorant mode), 10-11
// fields per lane-step. The rest comes from the forward's own device code
// (mcm_common.cuh), so it equals the forward's values bit for bit: the
// escape light from the wavelength's light pair, the HG sample redrawn
// from the chain's state, and, on event steps only, the material and its
// slopes from the volume row re-gathered at the sample position and then
// the TF row (L2-resident, 4.8 MB at 257^2).
//
// What bounds it. The parent design (one thread per lane, everything in
// registers, 96 registers, 5 blocks per SM) was split by variant builds
// timed in one call on an NVIDIA H100 80GB HBM3 at its 700 W power limit
// (PERF.md section 6; 2 dispatches at 512^2 x 4, exact mode): the tape
// stream and the carry alone took 0.33 ms (the tape's 0.67 GB of
// evict-first reads run at ~3/4 of the HBM rate),
// the event re-gathers 0.09 ms more, the HG reverse 0.06, the volume
// atomics 0.02; with all four tables the TF atomics took 0.76 ms more, 60%
// of the kernel: every event added 8 float2 rows into one 18-wide TF row,
// 4 of them a constant 0 in one half, and 40k distinct rows took 5.8 M
// events (4% of a warp's event rows coincide, so warp aggregation cannot
// help). The design:
// - a lane keeps the sums of the TF row its events read (per corner:
//   albedo, alpha, 2 g) and adds them when its events move to another row
//   or at the end: a lane's wavelength column holds until it respawns and
//   the density row of a homogeneous region stays, so runs of events share
//   a row; the g channel's atomic only where it is not 0, none for the
//   fourth channel;
// - the radiance adjoints live in shared memory, a column per thread (read
//   and written at respawns only), and so do the TF-row sums, which leaves
//   registers for SUR_MIN_BLOCKS = 6 blocks per SM (80 registers, 12 B of spill stores); in
//   the same call 5 blocks (93 registers) took 0.540 ms with wrt={density}
//   and 8 (64 registers, 120 B of spills) 0.509, against 0.500 at 6.
// The per-lane sums change only the order of the additions into the TF
// adjoint, as the atomics' order does. Tried and not adopted, in the same
// calls: the volume row requested before the carry's arithmetic (0.534
// against 0.500 ms), and the respawn's quotients by one shared reciprocal
// (0.68 against 0.54 ms; IEEE division per bin stays).
//
// RAW (raw or partly packed tables, K1's RAW kinds as uniform runtime
// flags) re-gathers what K1's RAW step read and scatters into adjoints of
// the tables' own kinds: a raw grid's 8 voxels by 8 scalar atomics (the
// nearest voxel by 1, with no position term: floor has no gradient), a
// full or xy table's rows as above; a raw TF's 4 texels or a 16-wide row's
// 4 corners by the per-lane sums of the fused row (flush_tf_any); a light
// table of its own by 2 scalars (raw) or one float2 (pair); a raw env
// map's 4 texels of the band's channel by 4 scalar atomics. A raw axis of
// n texels (passed as n + 1) scales the position's slope by n, as a packed
// table's does. RAW is a template parameter, so the packed instantiations
// keep their code (their ptxas rows are unchanged); on the bench scene a
// fully raw ctx takes 1.8x the full table's time (PERF.md section 6).
//
// Numerics: -fmad=false and IEEE division, in the op order of the plain
// version (kernels/surrogate.py::reverse_plain), so the two differ only by
// the order of the additions into the packed adjoints and of the block
// sums.

#include "adjoint_common.cuh"
#include "mcm_common.cuh"

namespace {

// threads per block, and the blocks per SM that __launch_bounds__ asks
// ptxas to fit (see the note above)
#define SUR_THREADS 128
#define SUR_MIN_BLOCKS 6

__device__ __forceinline__ float tie_max(float x, float lo) {
  return x > lo ? 1.0f : (x == lo ? 0.5f : 0.0f);
}

__device__ __forceinline__ float tie_min(float x, float hi) {
  return x < hi ? 1.0f : (x == hi ? 0.5f : 0.0f);
}

// The reverse of sampling.draw_hg's anisotropic branch at (g, d) with the
// sphere sample u and cosine draw ucos, for the output adjoint go: adds
// into g_g and gd_out (the incoming direction's adjoint). The forward's
// intermediates first, then their transposes, in kernels/surrogate.py::
// _hg_reverse's order.
__device__ __forceinline__ void hg_reverse(float g, const float d[3], const float u[3], float ucos,
                                           const float go[3], float& g_g, float gd_out[3]) {
  const float g2 = g * g;
  const float den = (1.0f - g) + 2.0f * g * ucos;
  const float cc = (1.0f - g2) / den;
  const float num = (1.0f + g2) - cc * cc;
  const float g2x = 2.0f * g;
  const float h = num / g2x;
  const float udotd = u[0] * d[0] + u[1] * d[1] + u[2] * d[2];
  float cv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) cv[a] = u[a] - udotd * d[a];
  const float cl = cv[0] * cv[0] + cv[1] * cv[1] + cv[2] * cv[2];
  const bool pos = cl > 0.0f;
  const float y = sqrtf(nmax(cl, 1e-30f));
  const float cn = pos ? 1.0f / y : 0.0f;
  const float m_arg = 1.0f - h * h;
  const float sn = sqrtf(nmax(m_arg, 0.0f));
  // o = (sn c) cn + h d
  float g_h = go[0] * d[0] + go[1] * d[1] + go[2] * d[2];
  float gd[3], gc[3];
  float g_cn = 0.0f, g_sn = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) gd[a] = go[a] * h;
  float gt[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) gt[a] = go[a] * cn;
  g_cn = go[0] * (sn * cv[0]) + go[1] * (sn * cv[1]) + go[2] * (sn * cv[2]);
  g_sn = gt[0] * cv[0] + gt[1] * cv[1] + gt[2] * cv[2];
#pragma unroll
  for (int a = 0; a < 3; ++a) gc[a] = gt[a] * sn;
  // sn = sqrt(max(1 - h^2, 0)): inf / NaN at sn == 0, as jax.grad gives
  const float g_marg = g_sn / (2.0f * sn) * tie_max(m_arg, 0.0f);
  g_h = g_h - 2.0f * h * g_marg;
  // cn = 1 / sqrt(max(cl, 1e-30)) where cl > 0
  const float g_y = -(g_cn * cn * cn);
  const float g_cl = pos ? g_y / (2.0f * y) * tie_max(cl, 1e-30f) : 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) gc[a] = gc[a] + 2.0f * cv[a] * g_cl;
  // c = u - (u . d) d
  const float g_ud = -(gc[0] * d[0] + gc[1] * d[1] + gc[2] * d[2]);
#pragma unroll
  for (int a = 0; a < 3; ++a) gd[a] = gd[a] - udotd * gc[a];
#pragma unroll
  for (int a = 0; a < 3; ++a) gd_out[a] = gd[a] + g_ud * u[a];
  // h = (1 + g^2 - c^2) / (2 g), c = (1 - g^2) / (1 - g + 2 g ucos)
  const float g_num = g_h / g2x;
  float gg = 2.0f * (-(g_h * h / g2x));
  const float g_cc = -2.0f * cc * g_num;
  const float g_den = -(g_cc * cc / den);
  const float g_g2 = g_num - g_cc / den;
  gg = gg - g_den + 2.0f * ucos * g_den + 2.0f * g * g_g2;
  g_g = gg;
}

// adds a lane's pending TF-row sums (albedo, alpha, 2 g per corner) into
// the packed TF adjoint: a float2 atomic per corner, and the g channel's
// only where it is not 0 (the fourth channel takes nothing)
__device__ __forceinline__ void flush_tf(float* g_tf, int row, float (*acc)[SUR_THREADS], int t) {
  float* r = g_tf + (int64_t)row * 18;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    add2(r + 4 * q, acc[3 * q][t], acc[3 * q + 1][t]);
    const float g2 = acc[3 * q + 2][t];
    if (g2 != 0.0f) atomicAdd(r + 4 * q + 2, g2);
  }
}

// flush_tf for the RAW instantiations' TF kinds, the padded row
// by * Wp + bx: the fused row as flush_tf adds it, a 16-wide row's corners
// (4 channels each, no light pair), or the 4 texels of a raw (H, W, 4)
// TF given as (Hp, Wp) = (H+1, W+1), the raw axes' clamps of sample_tf_any
__device__ __forceinline__ void flush_tf_any(float* g_tf, int kind, int Hp, int Wp, int row,
                                             float (*acc)[SUR_THREADS], int t) {
  if (kind == TF_FUSED) {
    flush_tf(g_tf, row, acc, t);
    return;
  }
  const int by = row / Wp, bx = row - by * Wp;
  const int W = Wp - 1, x0 = max(bx - 1, 0), x1 = min(bx, W - 1);
  const int y0 = max(by - 1, 0), y1 = min(by, Hp - 2);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float* r = kind == TF_PACKED ? g_tf + (int64_t)row * 16 + 4 * q
                                 : g_tf + ((int64_t)(q & 2 ? y1 : y0) * W + (q & 1 ? x1 : x0)) * 4;
    add2(r, acc[3 * q][t], acc[3 * q + 1][t]);
    const float g2 = acc[3 * q + 2][t];
    if (g2 != 0.0f) atomicAdd(r + 2, g2);
  }
}

// The escape's environment lookup in reverse, for the adjoint g_emit of
// the emitted value (the forward's sample_environment x 2.7): the 4 texel
// terms into the packed env adjoint g_env (when given), and the
// direction's adjoint into gdl, in kernels/surrogate.py::_env_reverse's
// order. The slope of asin is 1/sqrt(1 - dy^2): inf or NaN at the poles,
// as jax.grad gives.
__device__ __forceinline__ void env_reverse(const float* env, int Hp, int Wp, const float d[3],
                                            float lam, float g_emit, float* g_env,
                                            float gdl[3]) {
  float u, v;
  env_coords(d[0], d[1], d[2], u, v);
  int bx, by;
  float fx, fy;
  base_frac(u, Wp - 1, bx, fx);
  base_frac(v, Hp - 1, by, fy);
  const int64_t row = (int64_t)by * Wp + bx;
  const int c = env_band(lam);
  const float* r = env + row * 12 + c;
  const float a00 = __ldg(r), a01 = __ldg(r + 3), a10 = __ldg(r + 6), a11 = __ldg(r + 9);
  const float c0 = lerp(a00, a01, fx), c1 = lerp(a10, a11, fx);
  const float g = g_emit * kEnvGain;
  if (g_env != nullptr && g != 0.0f) add_env_texels(g_env, row, c, g, fx, fy);
  const float g_fx = g * (1 - fy) * (a01 - a00) + g * fy * (a11 - a10);
  const float g_fy = g * (c1 - c0);
  const float g_at = g_fx * (float)(Wp - 1) * 0.5f * kInvPi;
  const float g_as = g_fy * (float)(Hp - 1) * 0.5f * 2.0f * kInvPi;
  const float r2 = d[0] * d[0] + d[2] * d[2];
  gdl[0] = g_at * -d[2] / r2;
  gdl[1] = -(g_as / sqrtf(1.0f - d[1] * d[1]));
  gdl[2] = g_at * d[0] / r2;
}

// env_reverse over a raw (He, We, 3) map given as (Hp, Wp) = (He+1, We+1):
// the band's channel of the 4 texels that sample_environment's raw path
// reads, and 4 scalar atomics into the (He * We, 3) adjoint; the same
// derivative, in the same order
__device__ __forceinline__ void env_reverse_raw(const float* env, int Hp, int Wp,
                                                const float d[3], float lam, float g_emit,
                                                float* g_env, float gdl[3]) {
  float u, v;
  env_coords(d[0], d[1], d[2], u, v);
  int bx, by;
  float fx, fy;
  base_frac(u, Wp - 1, bx, fx);
  base_frac(v, Hp - 1, by, fy);
  const int c = env_band(lam);
  const int W = Wp - 1, x0 = max(bx - 1, 0), x1 = min(bx, W - 1);
  const int64_t r0 = (int64_t)max(by - 1, 0) * W, r1 = (int64_t)min(by, Hp - 2) * W;
  const int64_t e00 = (r0 + x0) * 3 + c, e01 = (r0 + x1) * 3 + c;
  const int64_t e10 = (r1 + x0) * 3 + c, e11 = (r1 + x1) * 3 + c;
  const float a00 = __ldg(env + e00), a01 = __ldg(env + e01);
  const float a10 = __ldg(env + e10), a11 = __ldg(env + e11);
  const float c0 = lerp(a00, a01, fx), c1 = lerp(a10, a11, fx);
  const float g = g_emit * kEnvGain;
  if (g_env != nullptr && g != 0.0f) {
    atomicAdd(g_env + e00, g * ((1 - fx) * (1 - fy)));
    atomicAdd(g_env + e01, g * (fx * (1 - fy)));
    atomicAdd(g_env + e10, g * ((1 - fx) * fy));
    atomicAdd(g_env + e11, g * (fx * fy));
  }
  const float g_fx = g * (1 - fy) * (a01 - a00) + g * fy * (a11 - a10);
  const float g_fy = g * (c1 - c0);
  const float g_at = g_fx * (float)(Wp - 1) * 0.5f * kInvPi;
  const float g_as = g_fy * (float)(Hp - 1) * 0.5f * 2.0f * kInvPi;
  const float r2 = d[0] * d[0] + d[2] * d[2];
  gdl[0] = g_at * -d[2] / r2;
  gdl[1] = -(g_as / sqrtf(1.0f - d[1] * d[1]));
  gdl[2] = g_at * d[0] / r2;
}

// adds the adjoint g of the light's value at wavelength lam into the
// light's own table's adjoint g_lt, as sample_light_any reads the table: a
// pair (N+1, 2) table's row (one float2), or a raw (N,) table's two texels
// (2 scalars; at a clamped edge both on one texel)
__device__ __forceinline__ void add_light(float* g_lt, const Params& P, float lam, float g) {
  const int n = P.i[I_LIGHT_N];
  const float t = (lam - 400.0f) / 300.0f;
  float f;
  if (P.i[I_LIGHT_KIND] == LIGHT_PAIR) {
    int b;
    base_frac(t, n, b, f);
    add2(g_lt + (int64_t)b * 2, g * (1 - f), g * f);
  } else {
    int i0, i1;
    raw_axis(t, n + 1, i0, i1, f);
    atomicAdd(g_lt + i0, g * (1 - f));
    atomicAdd(g_lt + i1, g * f);
  }
}

// one lane walks K dispatch tapes back (NB: the bins rounded up to 4; MAJ:
// the majorant mode, whose tape holds m; ENV: escapes read the environment
// map; XY: the volume is an xy half-packed (rows, 4) table; RAW: raw or
// partly packed tables, their kinds runtime flags as in K1's RAW step: the
// volume a raw grid (I_VOL_RAW; I_NEAREST) or a full or xy table
// (I_VOL_XY), the TF fused, 16-wide or raw (I_TF_KIND), the light in the
// fused rows or its own raw or pair table (I_LIGHT_KIND, `light`), the env
// map packed or raw (I_ENV_RAW); each adjoint of its table's kind)
template <int NB, bool MAJ, bool ENV, bool XY, bool RAW>
__global__ void __launch_bounds__(SUR_THREADS, SUR_MIN_BLOCKS)
surrogate_reverse_kernel(const Params P, const SurSpec T, const float* __restrict__ tape,
                         const int* __restrict__ samples, float* __restrict__ c_io,
                         float* __restrict__ gpx_io, float* __restrict__ gpy_io,
                         float* __restrict__ gpz_io, float* __restrict__ gdx_io,
                         float* __restrict__ gdy_io, float* __restrict__ gdz_io,
                         float* __restrict__ grad_io, const void* __restrict__ vol,
                         const float* __restrict__ tf, const float* __restrict__ env,
                         double* __restrict__ ext_acc, float* __restrict__ g_tf,
                         float* __restrict__ g_vol, float* __restrict__ g_env,
                         const float* __restrict__ light, float* __restrict__ g_lt) {
  // per thread, in its own column: the radiance adjoint of every bin (read
  // and written at respawns only) and the pending sums of the TF row its
  // last events read
  __shared__ float grad_s[NB][SUR_THREADS];
  __shared__ float tf_acc[12][SUR_THREADS];
  // no early return: every thread reaches block_add's __syncthreads
  const int t = threadIdx.x;
  const int n_lanes = P.i[I_N_LANES];
  const int lane = blockIdx.x * blockDim.x + t;
  const bool active = lane < n_lanes;
  float ext = 0.0f;
  if (active) {
    const int n_bins = P.i[I_N_BINS];
    const int steps = P.i[I_STEPS];
    const int tf_h = P.i[I_TF_H], tf_w = P.i[I_TF_W];
    const int vd = P.i[I_VOL_D], vh = P.i[I_VOL_H], vw = P.i[I_VOL_W], u8 = P.i[I_VOL_U8];
    const bool iso = P.i[I_ISOTROPIC] != 0;
    const bool qc = P.i[I_QUASICUBIC] != 0;
    // the RAW kinds; constants of the packed instantiations
    const bool vol_raw = RAW && P.i[I_VOL_RAW] != 0, nearest = RAW && P.i[I_NEAREST] != 0;
    const bool xy = XY || (RAW && P.i[I_VOL_XY] != 0);
    const int tf_kind = RAW ? P.i[I_TF_KIND] : TF_FUSED;
    const float ldx = P.f[F_LDX], ldy = P.f[F_LDY], ldz = P.f[F_LDZ];
    const float mu = P.f[F_EXTINCTION];
    const float inv_mu = __frcp_rn(mu);
    const int64_t lanes = n_lanes;
    const int64_t step_rows = (int64_t)T.n_fields * lanes;
    float c = c_io[lane];
    float gp[3] = {gpx_io[lane], gpy_io[lane], gpz_io[lane]};
    float gd[3] = {gdx_io[lane], gdy_io[lane], gdz_io[lane]};
#pragma unroll
    for (int b = 0; b < NB; ++b)
      grad_s[b][t] = (b < n_bins) ? grad_io[(int64_t)b * lanes + lane] : 0.0f;
    int n = samples[lane];
    int acc_row = -1;  // the TF row whose sums tf_acc holds, -1 for none

    for (int k = P.i[I_N_SEEDS] - 1; k >= 0; --k) {
      for (int it = steps - 1; it >= 0; --it) {
        const float* row = tape + ((int64_t)k * steps + it) * step_rows + lane;
        const int flags = __float_as_int(__ldcs(row + T.off[S_FLAGS]));
        const float dist = __ldcs(row + T.off[S_DIST]);
        const float d[3] = {__ldcs(row + T.off[S_DX]), __ldcs(row + T.off[S_DY]),
                            __ldcs(row + T.off[S_DZ])};
        const uint32_t rng = __float_as_uint(__ldcs(row + T.off[S_RNG]));
        const float pos[3] = {__ldcs(row + T.off[S_PX]), __ldcs(row + T.off[S_PY]),
                              __ldcs(row + T.off[S_PZ])};
        const float lam = __ldcs(row + T.off[S_LAM]);
        const float m = MAJ ? __ldcs(row + T.off[S_MAJ]) : 1.0f;
        const bool respawn = flags & SF_RESPAWN, oob = flags & SF_OOB;
        const bool nul = flags & SF_NULL, scat = flags & SF_SCATTER;
        const bool capped = flags & SF_CAPPED;
        const int pre_bin = flags >> 8;
        // the deposit: g / n to it, g (1 - 1/n) stays
        float g_dep = 0.0f;
        if (respawn) {
          const float denom = (float)max(n, 1);
          float gb[NB];
#pragma unroll
          for (int b = 0; b < NB; ++b) gb[b] = grad_s[b][t];
          if (pre_bin >= 0 && pre_bin < n_bins) g_dep = __fdiv_rn(grad_s[pre_bin][t], denom);
#pragma unroll
          for (int b = 0; b < NB; ++b) grad_s[b][t] = gb[b] - __fdiv_rn(gb[b], denom);
          n -= 1;
        }
        // the escape light, recomputed from the wavelength's light pair
        // (or the environment map)
        int bx;
        float tfx;
        wavelength_coord(lam, tf_w, bx, tfx);
        float emitted = 0.0f, intensity = 0.0f, ddot = 0.0f, prod = 0.0f;
        if (ENV && oob) {
          emitted = sample_environment(env, P.i[I_ENV_H], P.i[I_ENV_W], d[0], d[1], d[2], lam,
                                       nullptr, RAW && P.i[I_ENV_RAW] != 0);
        } else if (oob) {
          intensity = (RAW ? sample_light_any(tf, light, P, bx, tfx, lam)
                           : sample_light(tf, bx, tfx)) * 5.0f;
          if (iso) {
            emitted = intensity;
          } else {
            ddot = d[0] * ldx + d[1] * ldy + d[2] * ldz;
            prod = ddot * intensity;
            emitted = nmax(prod, 0.0f);
          }
        }
        // the score cotangent: cut at a respawn, restarted by its deposit
        const float c_mid = respawn ? 0.0f : c;
        const float gs1 = c_mid + g_dep * emitted;
        if (MAJ) {
          const float rate = mu * m;
          ext = ext + ((capped ? 0.0f : __fdiv_rn(gs1, rate)) - gs1 * dist) * m;
        } else {
          ext = ext + (gs1 * inv_mu - gs1 * dist);
        }
        // the light's pathwise terms
        float gdl[3] = {0.0f, 0.0f, 0.0f};
        if (ENV && oob) {
          if (RAW && P.i[I_ENV_RAW] != 0) {
            env_reverse_raw(env, P.i[I_ENV_H], P.i[I_ENV_W], d, lam, g_dep, g_env, gdl);
          } else {
            env_reverse(env, P.i[I_ENV_H], P.i[I_ENV_W], d, lam, g_dep, g_env, gdl);
          }
        } else if (oob) {
          float g_int = g_dep;
          if (!iso) {
            const float g_prod = g_dep * tie_max(prod, 0.0f);
            g_int = g_prod * ddot;
            const float g_dot = g_prod * intensity;
            gdl[0] = g_dot * ldx;
            gdl[1] = g_dot * ldy;
            gdl[2] = g_dot * ldz;
          }
          const float g_light = g_int * 5.0f;
          if (RAW && P.i[I_LIGHT_KIND] != LIGHT_FUSED) {
            if (g_lt != nullptr && g_light != 0.0f) add_light(g_lt, P, lam, g_light);
          } else if (g_tf != nullptr && g_light != 0.0f) {
            add2(g_tf + (int64_t)bx * 18 + 16, g_light * (1 - tfx), g_light * tfx);
          }
        }
        // events: the material at the sample position, the scores, the HG
        // inversion, the TF row, the density row and its position
        float gpd[3] = {0.0f, 0.0f, 0.0f};
        float gd_hg[3] = {0.0f, 0.0f, 0.0f};
        if (nul || scat) {
          int64_t vrow, vrow1;
          float vr[3], vf[3];
          float cc[8];
          // a raw grid's clamped axes (x0, x1), (y0, y1), (z0, z1); under
          // the nearest filter vrow is the voxel read
          int vx[2] = {0, 0}, vy[2] = {0, 0}, vz[2] = {0, 0};
          float dens;
          if (RAW && vol_raw) {
            const float* grid = static_cast<const float*>(vol);
            const int H = vh - 1, W = vw - 1;
            if (nearest) {
              vrow = ((int64_t)floor_cell(pos[2], vd - 1) * H + floor_cell(pos[1], H)) * W +
                     floor_cell(pos[0], W);
              dens = __ldg(grid + vrow);
            } else {
              raw_axis(pos[0], vw, vx[0], vx[1], vr[0]);
              raw_axis(pos[1], vh, vy[0], vy[1], vr[1]);
              raw_axis(pos[2], vd, vz[0], vz[1], vr[2]);
#pragma unroll
              for (int k = 0; k < 8; ++k)
                cc[k] = __ldg(grid + ((int64_t)vz[k >> 2] * H + vy[(k >> 1) & 1]) * W + vx[k & 1]);
            }
          } else {
            volume_rows(xy, vd, vh, vw, pos[0], pos[1], pos[2], vrow, vrow1, vr[0], vr[1], vr[2]);
            volume_corners(vol, u8, xy, vrow, vrow1, cc);
          }
          float l00 = 0.0f, l01 = 0.0f, l10 = 0.0f, l11 = 0.0f, l0 = 0.0f, l1 = 0.0f;
          if (!(RAW && nearest)) {
#pragma unroll
            for (int a = 0; a < 3; ++a) vf[a] = qc ? quasicubic(vr[a]) : vr[a];
            l00 = lerp(cc[0], cc[1], vf[0]);
            l01 = lerp(cc[2], cc[3], vf[0]);
            l10 = lerp(cc[4], cc[5], vf[0]);
            l11 = lerp(cc[6], cc[7], vf[0]);
            l0 = lerp(l00, l01, vf[1]);
            l1 = lerp(l10, l11, vf[1]);
            dens = lerp(l0, l1, vf[2]);
          }
          float mat[3];
          TfAddr ta;
          if (RAW) {
            sample_tf_any(tf, tf_kind, tf_h, tf_w, bx, tfx, dens, mat, &ta);
          } else {
            sample_tf(tf, tf_h, tf_w, bx, tfx, dens, mat, nullptr, &ta);
          }
          const float albedo = mat[0], alpha = mat[1], g = mat[2] * 2.0f - 1.0f;
          float x = 0.0f, p_real = 0.0f, p_null, p_s;
          if (MAJ) {
            x = alpha / m;
            p_real = nmin(x, 1.0f);
            p_null = 1.0f - p_real;
            p_s = p_real * albedo;
          } else {
            p_null = 1.0f - alpha;
            p_s = alpha * albedo;
          }
          const float g_pn = nul ? c_mid / nmax(p_null, 1e-12f) * tie_max(p_null, 1e-12f) : 0.0f;
          const float g_ps = scat ? c_mid / nmax(p_s, 1e-12f) * tie_max(p_s, 1e-12f) : 0.0f;
          float g_alpha, g_albedo;
          if (MAJ) {
            const float g_preal = -g_pn + g_ps * albedo;
            g_albedo = g_ps * p_real;
            g_alpha = g_preal * tie_min(x, 1.0f) / m;
          } else {
            g_alpha = -g_pn + g_ps * albedo;
            g_albedo = g_ps * alpha;
          }
          float g_mat2 = 0.0f;
          if (scat && fabsf(g) >= kEps) {
            uint32_t s = rng;
            float kx, ky;
            draw_disk(s, kx, ky);
            const float norm = kx * kx + ky * ky;
            const float rr = 2.0f * sqrtf(nmax(1.0f - norm, 0.0f));
            const float u[3] = {rr * kx, rr * ky, 1.0f - 2.0f * norm};
            const float ucos = draw(s);
            float g_g;
            hg_reverse(g, d, u, ucos, gd, g_g, gd_hg);
            g_mat2 = g_g * 2.0f;
          }
          // the TF row's adjoint: summed per lane while its events stay on
          // one row, added to the table when the row changes
          if (g_tf != nullptr && (g_albedo != 0.0f || g_alpha != 0.0f || g_mat2 != 0.0f)) {
            if (ta.row != acc_row) {
              if (acc_row >= 0) {
                if (RAW) {
                  flush_tf_any(g_tf, tf_kind, tf_h, tf_w, acc_row, tf_acc, t);
                } else {
                  flush_tf(g_tf, acc_row, tf_acc, t);
                }
              }
#pragma unroll
              for (int j = 0; j < 12; ++j) tf_acc[j][t] = 0.0f;
              acc_row = ta.row;
            }
            const float fx = ta.fx, fy = ta.fy;
            const float w[4] = {(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              tf_acc[3 * q][t] += g_albedo * w[q];
              tf_acc[3 * q + 1][t] += g_alpha * w[q];
              tf_acc[3 * q + 2][t] += g_mat2 * w[q];
            }
          }
          const float g_dens = g_albedo * ta.slope[0] + g_alpha * ta.slope[1] + g_mat2 * ta.slope[2];
          if (RAW && nearest && g_dens != 0.0f) {
            // the one voxel read; floor has no gradient, so no position term
            if (g_vol != nullptr) atomicAdd(g_vol + vrow, g_dens);
          } else if (g_dens != 0.0f) {
            const float vfx = vf[0], vfy = vf[1], vfz = vf[2];
            if (g_vol != nullptr) {
              const float w0 = (1 - vfy) * (1 - vfx), w1 = (1 - vfy) * vfx;
              const float w2 = vfy * (1 - vfx), w3 = vfy * vfx;
              const float a0 = g_dens * (1 - vfz), a1 = g_dens * vfz;
              if (RAW && vol_raw) {
                // the 8 voxels, 8 scalar atomics; at a clamped edge two
                // corners are one voxel, which takes both terms
                const int H = vh - 1, W = vw - 1;
                const float wq[4] = {w0, w1, w2, w3};
#pragma unroll
                for (int k = 0; k < 8; ++k)
                  atomicAdd(g_vol + ((int64_t)vz[k >> 2] * H + vy[(k >> 1) & 1]) * W + vx[k & 1],
                            (k >> 2 ? a1 : a0) * wq[k & 3]);
              } else {
                // a full table's 8-wide row is 32 B, two float4 halves; an
                // xy table's plane rows are 16 B each
                float* r0 = xy ? g_vol + vrow * 4 : g_vol + vrow * 8;
                float* r1 = xy ? g_vol + vrow1 * 4 : r0 + 4;
                add4(r0, a0 * w0, a0 * w1, a0 * w2, a0 * w3);
                add4(r1, a1 * w0, a1 * w1, a1 * w2, a1 * w3);
              }
            }
            const float g_fz = g_dens * (l1 - l0);
            const float g_l0 = g_dens * (1 - vfz), g_l1 = g_dens * vfz;
            const float g_fy = g_l0 * (l01 - l00) + g_l1 * (l11 - l10);
            const float g_fx = g_l0 * (1 - vfy) * (cc[1] - cc[0]) + g_l0 * vfy * (cc[3] - cc[2]) +
                               g_l1 * (1 - vfy) * (cc[5] - cc[4]) + g_l1 * vfy * (cc[7] - cc[6]);
            // the quasicubic warp's derivative 6f(1 - f) at the unwarped frac
            const float s0 = qc ? 6.0f * vr[0] * (1.0f - vr[0]) : 1.0f;
            const float s1 = qc ? 6.0f * vr[1] * (1.0f - vr[1]) : 1.0f;
            const float s2 = qc ? 6.0f * vr[2] * (1.0f - vr[2]) : 1.0f;
            gpd[0] = g_fx * s0 * (float)(vw - 1);
            gpd[1] = g_fy * s1 * (float)(vh - 1);
            // z's scale is D every way: a full table's and a raw grid's vd
            // is D + 1, an xy one's D
            gpd[2] = g_fz * s2 * (float)(xy ? vd : vd - 1);
          }
        }
        // the position and direction adjoints before the step
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float gps = (respawn ? 0.0f : gp[a]) + gpd[a];
          gd[a] = ((respawn ? 0.0f : (scat ? gd_hg[a] : gd[a])) + gdl[a]) + dist * gps;
          gp[a] = gps;
        }
        c = gs1;
      }
    }
    if (acc_row >= 0) {
      if (RAW) {
        flush_tf_any(g_tf, tf_kind, tf_h, tf_w, acc_row, tf_acc, t);
      } else {
        flush_tf(g_tf, acc_row, tf_acc, t);
      }
    }
    c_io[lane] = c;
    gpx_io[lane] = gp[0]; gpy_io[lane] = gp[1]; gpz_io[lane] = gp[2];
    gdx_io[lane] = gd[0]; gdy_io[lane] = gd[1]; gdz_io[lane] = gd[2];
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < n_bins) grad_io[(int64_t)b * lanes + lane] = grad_s[b][t];
  }
  if (ext_acc != nullptr) block_add<SUR_THREADS>(ext, ext_acc);
}

}  // namespace

extern "C" {

int vpt_sur_layout(int which) {
  switch (which) {
    case 0: return S_COUNT;
    case 1: return F_COUNT;
    case 2: return I_COUNT;
    default: return -1;
  }
}

// the adjoints at the tapes' end in (c, gp*, gd*, grad: bins x lanes), at
// their start out; g_tf / g_vol / g_light / g_env / ext_acc null when not
// wanted, each of its table's kind; majorant mode when the tape has the m
// field; env: the environment map, or null; an xy half-packed vol (and a
// (rows, 4) g_vol) when I_VOL_XY is set; with I_RAW raw or partly packed
// tables (K1's RAW kinds), `light` the light's own table beside a TF
// without it (else null) and g_light its adjoint
int vpt_surrogate_reverse(const float* fparams, const int* iparams, const int* slots,
                          int n_fields, const float* tape, const int* samples, float* c,
                          float* gpx, float* gpy, float* gpz, float* gdx, float* gdy,
                          float* gdz, float* grad, const void* vol, const float* tf,
                          const float* light, const float* env, double* ext_acc, float* g_tf,
                          float* g_vol, float* g_light, float* g_env, void* stream) {
  const Params P = make_params(fparams, iparams);
  const int n = P.i[I_N_LANES];
  const SurSpec T = make_sur_spec(slots, n_fields, n);
  if (n <= 0) return 0;
  if ((env != nullptr) != (P.i[I_ENV_H] > 0) || (g_env != nullptr && env == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool raw = P.i[I_RAW] != 0;
  if ((light != nullptr) != (raw && P.i[I_LIGHT_KIND] != LIGHT_FUSED) ||
      (g_light != nullptr && light == nullptr) ||
      (!raw && (P.i[I_VOL_RAW] | P.i[I_NEAREST] | P.i[I_TF_KIND] | P.i[I_ENV_RAW]) != 0))
    return (int)cudaErrorInvalidValue;
  const bool maj = T.off[S_MAJ] >= 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_for(n, SUR_THREADS)), block(SUR_THREADS);
  // NB is a multiple of 4, so NB * 4 leaves the low 4 bits to the mode; RAW
  // reads an xy table by its runtime flag, so its modes take 8 + MAJ + 2 ENV
  switch (bins_rounded(P.i[I_N_BINS]) * 4 + (maj ? 1 : 0) + (env != nullptr ? 2 : 0) +
          (raw ? 8 : (P.i[I_VOL_XY] != 0 ? 4 : 0))) {
#define VPT_NB_MODE(NB, M, MB, EB, XB, RB)                                                     \
  case NB * 4 + M:                                                                             \
    surrogate_reverse_kernel<NB, MB, EB, XB, RB><<<grid, block, 0, st>>>(                      \
        P, T, tape, samples, c, gpx, gpy, gpz, gdx, gdy, gdz, grad, vol, tf, env, ext_acc,     \
        g_tf, g_vol, g_env, light, g_light);                                                   \
    break;
#define VPT_NB(NB)                               \
  VPT_NB_MODE(NB, 0, false, false, false, false) \
  VPT_NB_MODE(NB, 1, true, false, false, false)  \
  VPT_NB_MODE(NB, 2, false, true, false, false)  \
  VPT_NB_MODE(NB, 3, true, true, false, false)   \
  VPT_NB_MODE(NB, 4, false, false, true, false)  \
  VPT_NB_MODE(NB, 5, true, false, true, false)   \
  VPT_NB_MODE(NB, 6, false, true, true, false)   \
  VPT_NB_MODE(NB, 7, true, true, true, false)    \
  VPT_NB_MODE(NB, 8, false, false, false, true)  \
  VPT_NB_MODE(NB, 9, true, false, false, true)   \
  VPT_NB_MODE(NB, 10, false, true, false, true)  \
  VPT_NB_MODE(NB, 11, true, true, false, true)
    VPT_NB(4) VPT_NB(8) VPT_NB(12) VPT_NB(16) VPT_NB(20) VPT_NB(24) VPT_NB(28) VPT_NB(32)
#undef VPT_NB
#undef VPT_NB_MODE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
