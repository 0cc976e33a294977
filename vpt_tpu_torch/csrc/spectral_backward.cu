// Packed-adjoint PRB backward kernels for Hopper (sm_90a), plain C interface.
//
//   prb_tape_forward  replaces vpt_tpu/kernels/spectral_backward.py
//                     ::spectral_backward_packed pass 1 `fwd_body`
//                     (:660-743) scanned by _tape_forward_sweep (:1096-1110).
//                     The K1 step (mcm_common.cuh::woodcock_step, the same
//                     device code as mcm_spectral_step) plus one tape row per
//                     lane-step; its final state is bit-identical to K1's.
//                     All of the packed backward's branches: the
//                     environment map (ENV: the escape's env row, fractions
//                     and band), the quasicubic filter (warped volume
//                     fractions) and the xy half-packed volume (the two
//                     plane rows).
//   prb_reverse       replaces the reverse scans (:864-950), the importance
//                     path _importance_metric + _importance_scatter
//                     (:411-540), and the reverse dispatch loop of
//                     _tape_reverse_sweep / _prb_many_core (:1076-1139);
//                     with the env row scatter (:821-836) and the xy
//                     volume's two 4-wide rows (:849-855).
//   surrogate_tape    K4's surrogate mode: K1's step (no REC record, so it
//                     looks up the material only where K1 does) with
//                     woodcock_step's SUR record, in exact or majorant mode,
//                     with the light or the environment map (ENV), over
//                     packed, xy (XY) or raw and partly packed (RAW) tables,
//                     writing the autodiff surrogate's tape (SurField,
//                     adjoint_common.cuh) that K12 (surrogate.cu) walks back;
//                     its own template, so the PRB instantiations keep their
//                     code.
//
// The tape is one f32 tensor (K, steps, F, lanes), lanes innermost so every
// warp writes and reads whole 128-byte lines. Int and bool fields are
// bit-cast into f32 slots (bools as 0.0 / 1.0). Which fields are present
// depends on `wrt`; `slot[field]` gives each field's index in F or -1. The
// field list (TapeField, adjoint_common.cuh, which K28's TAPE mode in
// slab.cu writes too) is mirrored by vpt_tpu_torch/kernels/
// spectral_backward.py (TAPE_FIELDS), and vpt_bwd_layout() lets the wrapper
// check that the two agree.
//
// prb_reverse's ROUTED mode (R_ROUTED; the slab-sharded backward,
// vpt_tpu_torch/parallel/slab.py, replacing the volume half of scatter_step
// under vpt_tpu/parallel/slab.py's vol_scatter_fn hook, :279-280) adds no
// volume row: where the plain mode adds a lane-step's nonzero 8-wide row it
// appends the pair (slot id, global row, the 8 values) to a pair list, the
// slot id the (scatter slot) x lanes + lane; the owner of each row adds it
// (K29 slab_scatter, slab.cu) after an all-gather of the lists. The list is
// a 16-byte header holding the count (int32), then cap slot ids, cap rows
// (int32) and (cap, 8) values; the wrapper sizes it at one pair a slot, so
// it never overflows, and the kernel writes nothing at or past cap. A warp
// appends its nonzero rows with one atomic on the count (a ballot over the
// lanes that got here together, the leader's atomicAdd, a shuffle of the
// base), so the list's order is the atomics' order and an empty slot costs
// nothing; the slot ids put it back in slot order. A dispatch has steps /
// stride slots (the steps of its stride phase, or its importance picks).
// The carry, the extinction score and the TF and env scatters are the plain
// mode's. A lane table (ix, seed_iy) gives the lanes' global pixels, which
// seed the importance picks; without one the lane index does, on the (S, H,
// W) grid.
//
// What bounds them on this card.
// - prb_tape_forward is K1 plus F x 4 B of tape stores per lane-step: at the
//   bench shape (1M lanes, 8 steps, K = 4, 17 fields with wrt={density})
//   that is 2.3 GB of coalesced writes per window, ~0.7 ms of HBM time at
//   3.35 TB/s, next to K1's instruction-bound step for 4 dispatches. It
//   runs K1's redesigned step (mcm_common.cuh), but every lane reads its
//   full material row, since the tape records it. The tape is written with
//   evict-first stores (st.global.cs), so the 2.3 GB stream does not push
//   the 22 MB of tables every lookup reads out of the L2; each field's
//   offset (slot x lanes) is computed once per launch on the host. The
//   tape is stored, not recomputed (recompute is a lever for later work).
// - prb_reverse reads the tape once (stride mode; importance mode reads the
//   rows it picks a second time) and issues random f32 atomics: one 8-wide
//   row into the volume adjoint (69 MB at 129^3, larger than the 50 MB L2)
//   and one 18-wide row into the TF adjoint (4.8 MB, L2-resident) per
//   scattering lane-step; an xy volume takes two 4-wide rows (two float4
//   atomics, as the full row's two halves), and an escaping lane-step of
//   the env mode adds its 4 nonzero texel terms (one channel of each
//   corner of a 12-wide row), summed first over the lanes of a warp that
//   share the row and channel (adjoint_common.cuh add_env_texels: miss
//   lanes of neighbouring pixels escape towards the same texels, and their
//   atomics on one address serialize). Rows whose values are all zero
//   (lanes whose path contributes nothing) are skipped, which changes no
//   sum. The
//   extinction score is summed per lane, reduced per block in f64, and
//   added with one f64 atomic per block into `ext_acc`, which the wrapper
//   adds to the f32 adjoint. Its bound is the tape's bytes: 2.28 GB in a
//   stride-1 window of 4 dispatches x 8 steps x 1M lanes x 17 fields.
//
//   The first design reached a third of that bound: every field
//   read went through a slot table and waited on the branch before it (the
//   carry's respawn test, then the scores, then the scatter's addresses),
//   123 registers allowed 4 blocks per SM, and importance mode's per-step
//   arrays were indexed at run time, a 512 B local frame in every mode.
//   Variant builds timed in one call on the H100 (PERF.md) split the
//   redesign's time at the phase-8 shape: the carry alone (4 fields per
//   lane-step and the deposit gather) 0.18 ms, with the scatter fields and
//   scores but no atomics 0.58 ms, all of it 0.65-0.68 ms; the atomics
//   alone, on a window's own rows, run at ~29 G lane-steps/s and overlap
//   the loads. So the redesign
//   - computes each field's offset (slot x lanes) once per launch;
//   - issues a lane-step's tape reads together, before the branches that
//     use them, as evict-first loads (ld.global.cs; __ldg and plain loads
//     were 5-7% slower): the carry's fields on every step, the scatter's on
//     a step of the stride's phase, which is uniform across the warp;
//   - makes importance mode a template on the step count rounded up to 8,
//     16 or 32: its per-step carry, metric and cdf stay in registers (every
//     loop over the steps is unrolled), the metric is scored in the reverse
//     pass itself, and only the picked rows are read again;
//   - fits 8 blocks per SM in stride mode (rev_min_blocks).
//   Warp-level aggregation of coinciding rows was not adopted: 1.1% of a
//   window's event rows repeat within a warp's 32 lanes.
// One thread per lane walks the K dispatches in reverse and threads the
// deposit-cotangent carry (c, cb) in registers across dispatch boundaries
// (the window-exact estimator); the carry is read from and written back to
// c_io / cb_io, so the host can also run one dispatch per launch.
//
// Numerics: the scores follow the JAX op order (:784-798), IEEE division,
// NaN-propagating max. The scatter order of the atomics varies from run to
// run, so adjoints agree with the plain version to rounding, not bitwise.

#include "adjoint_common.cuh"
#include "mcm_common.cuh"

namespace {

// reverse-pass integer parameters, mirrored by the wrapper
enum RParam {
  R_N_LANES = 0, R_RES, R_STEPS, R_N_DISPATCH, R_N_FIELDS, R_STRIDE,
  R_IMPORTANCE, R_WANT_EXT, R_WANT_TF, R_WANT_VOL, R_N_BINS,
  R_PICK_BITS_SET, R_PICK_BITS, R_WANT_ENV, R_VOL_XY, R_ROUTED, R_COUNT,
};

// importance mode keeps per-step c, cb, metric and cdf in registers, sized
// by the step count rounded up to 8, 16 or 32
#define MAX_IMP_STEPS 32

// threads per block of the reverse kernel, and the blocks per SM its
// __launch_bounds__ ask ptxas to fit, per instantiation (rev_min_blocks):
// 8 for stride mode (61 registers, no spills) and importance over <= 8
// steps (64 registers, 92 B of spills), which a probe on the H100 found
// 2-15% faster than 1-6 blocks; 4 over <= 16 steps (122 registers, no
// spills; 8 would spill 236 B); 2 over <= 32 (190 registers)
#define REV_THREADS 128
constexpr int rev_min_blocks(int ns) { return ns > 16 ? 2 : (ns > 8 ? 4 : 8); }

// reverse-pass parameters: the integer block, 1 / mu, and each tape
// field's element offset within a step's rows (slot x lanes, -1 when
// absent), computed once per launch on the host
struct Rev {
  int i[R_COUNT];
  float inv_mu;
  long long off[T_COUNT];
};

// K seeds x `steps` Woodcock iterations per lane (K1), one tape row per
// step; ENV: escapes read the environment map; XY: an xy half-packed volume
template <int NB, bool ENV, bool XY>
__global__ void __launch_bounds__(STEP_THREADS, 8)
tape_forward_kernel(const Params P, const TapeSpec T, float* __restrict__ px_,
                    float* __restrict__ py_, float* __restrict__ pz_,
                    float* __restrict__ dx_, float* __restrict__ dy_,
                    float* __restrict__ dz_, int* __restrict__ bounces_,
                    int* __restrict__ samples_, int* __restrict__ bin_,
                    float* __restrict__ lam_, float* __restrict__ radiance,
                    const void* __restrict__ vol, const float* __restrict__ tf,
                    const float* __restrict__ env, const uint32_t* __restrict__ seeds,
                    float* __restrict__ tape) {
  const int n_lanes = P.i[I_N_LANES];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const int n_bins = P.i[I_N_BINS];
  uint32_t ix, iy, seed_iy;
  float sx, sy;
  lane_coords(lane, P.i[I_RES], ix, iy, seed_iy, P.f[F_INV_RES], sx, sy);

  Lane L = load_lane(lane, P, px_, py_, pz_, dx_, dy_, dz_, bounces_, samples_, bin_, lam_);
  float rad[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) rad[b] = (b < n_bins) ? radiance[(int64_t)b * n_lanes + lane] : 0.0f;

  const StepConsts C = step_consts(P);
  const int steps = P.i[I_STEPS];
  const int64_t step_rows = (int64_t)T.n_fields * n_lanes;
  float* row = tape + lane;
  for (int k = 0; k < P.i[I_N_SEEDS]; ++k) {
    uint32_t s = hash3(ix, seed_iy, seeds[k]);
    for (int it = 0; it < steps; ++it, row += step_rows) {
      StepRecord r;
      woodcock_step<NB, true, false, ENV, false, XY>(L, rad, s, sx, sy, P, C, vol, tf, &r,
                                                     nullptr, env);
      put(row, T, T_EMITTED, r.emitted);
      put(row, T, T_RESPAWN, r.respawn ? 1.0f : 0.0f);
      put(row, T, T_PRE_BIN, __int_as_float(r.pre_bin));
      put(row, T, T_ALPHA, r.alpha);
      put(row, T, T_ALBEDO, r.albedo);
      put(row, T, T_G, r.g);
      put(row, T, T_HG_COS, r.hg_cos);
      put(row, T, T_NULL, r.null_event ? 1.0f : 0.0f);
      put(row, T, T_SCATTER, r.scatter ? 1.0f : 0.0f);
      put(row, T, T_FX, r.tf.fx);
      put(row, T, T_DIST, r.dist);
      put(row, T, T_TF_ROW, __int_as_float(r.tf.row));
      put(row, T, T_FY, r.tf.fy);
      put(row, T, T_LIGHT_W, r.light_w);
      put(row, T, T_SLOPE0, r.tf.slope[0]);
      put(row, T, T_SLOPE1, r.tf.slope[1]);
      put(row, T, T_SLOPE2, r.tf.slope[2]);
      put(row, T, T_VOL_ROW0, __int_as_float(r.vol.row));
      put(row, T, T_VFX, r.vol.fx);
      put(row, T, T_VFY, r.vol.fy);
      put(row, T, T_VFZ, r.vol.fz);
      if constexpr (XY) put(row, T, T_VOL_ROW1, __int_as_float(r.vol.row1));
      if constexpr (ENV) {
        put(row, T, T_ENV_ROW, __int_as_float(r.env.row));
        put(row, T, T_ENV_FX, r.env.fx);
        put(row, T, T_ENV_FY, r.env.fy);
        put(row, T, T_ENV_BAND, __int_as_float(r.env.band));
        put(row, T, T_ENV_W, r.env_w);
      }
    }
  }

  store_lane(L, lane, px_, py_, pz_, dx_, dy_, dz_, bounces_, samples_, bin_, lam_);
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (b < n_bins) radiance[(int64_t)b * n_lanes + lane] = rad[b];
}

// one surrogate tape value of this lane, evict-first
__device__ __forceinline__ void sput(float* row, const SurSpec& T, int field, float v) {
  const long long o = T.off[field];
  if (o >= 0) __stcs(row + o, v);
}

// K4's surrogate mode (replaces the residuals jax.grad keeps of
// vpt_tpu/models/mcm_spectral.py::render_diff, :508-556): K1's step with
// woodcock_step's SUR record, in exact or majorant mode (MAJ), one
// surrogate tape row per lane-step (SurField, adjoint_common.cuh). Its own
// template, so the PRB instantiations above keep their code. The record
// holds no lookup value, so the step looks up the material only where K1
// does (not on a lane that left the volume or was capped, as the PRB
// tape's every-lane record must): its time is K1's plus the tape's
// evict-first stores, and the state it leaves equals K1's bit for bit.
// XY: an xy half-packed volume (K1's two plane-row lookup); the tape is the
// same, since K12 re-gathers the rows from the taped position. RAW: raw or
// partly packed tables, K1's RAW step (replaces the residuals of
// render_diff over ops/interp.py:411-648's raw lookups), the table kinds
// runtime flags as there (an xy table too, by I_VOL_XY), `light` the
// light's own table beside a TF without it; the tape is again the same.
template <int NB, bool MAJ, bool ENV, bool XY, bool RAW>
__global__ void __launch_bounds__(STEP_THREADS, 8)
surrogate_tape_kernel(const Params P, const SurSpec T, float* __restrict__ px_,
                      float* __restrict__ py_, float* __restrict__ pz_,
                      float* __restrict__ dx_, float* __restrict__ dy_,
                      float* __restrict__ dz_, int* __restrict__ bounces_,
                      int* __restrict__ samples_, int* __restrict__ bin_,
                      float* __restrict__ lam_, float* __restrict__ radiance,
                      const void* __restrict__ vol, const float* __restrict__ tf,
                      const float2* __restrict__ maj, const float* __restrict__ env,
                      const uint32_t* __restrict__ seeds, float* __restrict__ tape,
                      const float* __restrict__ light) {
  const int n_lanes = P.i[I_N_LANES];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const int n_bins = P.i[I_N_BINS];
  uint32_t ix, iy, seed_iy;
  float sx, sy;
  lane_coords(lane, P.i[I_RES], ix, iy, seed_iy, P.f[F_INV_RES], sx, sy);

  Lane L = load_lane(lane, P, px_, py_, pz_, dx_, dy_, dz_, bounces_, samples_, bin_, lam_);
  float rad[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) rad[b] = (b < n_bins) ? radiance[(int64_t)b * n_lanes + lane] : 0.0f;

  const StepConsts C = step_consts(P);
  const int steps = P.i[I_STEPS];
  const int64_t step_rows = (int64_t)T.n_fields * n_lanes;
  float* row = tape + lane;
  for (int k = 0; k < P.i[I_N_SEEDS]; ++k) {
    uint32_t s = hash3(ix, seed_iy, seeds[k]);
    for (int it = 0; it < steps; ++it, row += step_rows) {
      SurRecord r;
      woodcock_step<NB, false, MAJ, ENV, true, XY, RAW>(L, rad, s, sx, sy, P, C, vol, tf,
                                                        nullptr, maj, env, &r, light);
      const int flags = (r.respawn ? SF_RESPAWN : 0) | (r.oob ? SF_OOB : 0) |
                        (r.null_event ? SF_NULL : 0) | (r.scatter ? SF_SCATTER : 0) |
                        (r.capped ? SF_CAPPED : 0) | (r.pre_bin << 8);
      sput(row, T, S_FLAGS, __int_as_float(flags));
      sput(row, T, S_DIST, r.dist);
      sput(row, T, S_DX, r.pdx);
      sput(row, T, S_DY, r.pdy);
      sput(row, T, S_DZ, r.pdz);
      sput(row, T, S_RNG, __uint_as_float(r.rng));
      sput(row, T, S_PX, r.spx);
      sput(row, T, S_PY, r.spy);
      sput(row, T, S_PZ, r.spz);
      sput(row, T, S_LAM, r.lam);
      if (MAJ) sput(row, T, S_MAJ, r.maj);
    }
  }

  store_lane(L, lane, px_, py_, pz_, dx_, dy_, dz_, bounces_, samples_, bin_, lam_);
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (b < n_bins) radiance[(int64_t)b * n_lanes + lane] = rad[b];
}

// a tape read: evict-first, since the tape streams through once and the
// L2 is better spent on the adjoint tables the scatters add into
__device__ __forceinline__ float tape_at(const float* row, long long off) {
  return __ldcs(row + off);
}

// the fields a step's carry update and extinction score read
struct CarryIn {
  float respawn, emitted, dist;
  int pre_bin;
};

// the event fields the scores read
struct EventIn {
  float alpha, albedo, g, hg_cos;
  bool nul, scat;
};

// the fields that weight (slopes, light_w, env_w) and address (the rest)
// the scatters
struct ScatterIn {
  float slope[3], light_w, env_w;
  float fx, fy;
  int tf_row;
  float vfx, vfy, vfz;
  int vol_row, vol_row1;
  float efx, efy;
  int env_row, env_band;
};

__device__ __forceinline__ CarryIn load_carry(const float* row, const Rev& R, bool want_ext) {
  CarryIn t;
  t.respawn = tape_at(row, R.off[T_RESPAWN]);
  t.emitted = tape_at(row, R.off[T_EMITTED]);
  t.pre_bin = __float_as_int(tape_at(row, R.off[T_PRE_BIN]));
  t.dist = want_ext ? tape_at(row, R.off[T_DIST]) : 0.0f;
  return t;
}

__device__ __forceinline__ EventIn load_event(const float* row, const Rev& R) {
  EventIn e;
  e.alpha = tape_at(row, R.off[T_ALPHA]);
  e.albedo = tape_at(row, R.off[T_ALBEDO]);
  e.g = tape_at(row, R.off[T_G]);
  e.hg_cos = tape_at(row, R.off[T_HG_COS]);
  e.nul = tape_at(row, R.off[T_NULL]) > 0.5f;
  e.scat = tape_at(row, R.off[T_SCATTER]) > 0.5f;
  return e;
}

// the importance metric's weights (with `address`: the scatter's addresses
// too) of the tables the pass differentiates
__device__ __forceinline__ ScatterIn load_scatter(const float* row, const Rev& R,
                                                  bool want_tf, bool want_vol,
                                                  bool address) {
  ScatterIn s = {};
  if (want_vol) {
    s.slope[0] = tape_at(row, R.off[T_SLOPE0]);
    s.slope[1] = tape_at(row, R.off[T_SLOPE1]);
    s.slope[2] = tape_at(row, R.off[T_SLOPE2]);
    if (address) {
      s.vfx = tape_at(row, R.off[T_VFX]);
      s.vfy = tape_at(row, R.off[T_VFY]);
      s.vfz = tape_at(row, R.off[T_VFZ]);
      s.vol_row = __float_as_int(tape_at(row, R.off[T_VOL_ROW0]));
      if (R.i[R_VOL_XY]) s.vol_row1 = __float_as_int(tape_at(row, R.off[T_VOL_ROW1]));
    }
  }
  if (R.i[R_WANT_ENV]) {
    s.env_w = tape_at(row, R.off[T_ENV_W]);
    if (address) {
      s.efx = tape_at(row, R.off[T_ENV_FX]);
      s.efy = tape_at(row, R.off[T_ENV_FY]);
      s.env_row = __float_as_int(tape_at(row, R.off[T_ENV_ROW]));
      s.env_band = __float_as_int(tape_at(row, R.off[T_ENV_BAND]));
    }
  }
  if (want_tf) {
    s.light_w = tape_at(row, R.off[T_LIGHT_W]);
    if (address) {
      s.fx = tape_at(row, R.off[T_FX]);
      s.fy = tape_at(row, R.off[T_FY]);
      s.tf_row = __float_as_int(tape_at(row, R.off[T_TF_ROW]));
    }
  }
  return s;
}

// cotangent_update (:864-873): a deposit restarts the carry
__device__ __forceinline__ void carry_update(const CarryIn& t, const float* __restrict__ g_rad_scaled,
                                             int64_t lanes, int lane, int n_bins, float& c,
                                             float& cb) {
  if (t.respawn > 0.5f) {
    c = t.emitted;
    const int b = t.pre_bin;
    cb = (b >= 0 && b < n_bins) ? __ldg(g_rad_scaled + (int64_t)b * lanes + lane) : 0.0f;
  }
}

// per-channel value gradients from the event scores (JAX :784-798)
struct EventGrads {
  float alpha, albedo, graw;
};

__device__ __forceinline__ EventGrads event_grads(const EventIn& e, float q) {
  EventGrads G;
  G.alpha = (e.nul ? -q / nmax(1.0f - e.alpha, 1e-12f) : 0.0f) +
            (e.scat ? q / nmax(e.alpha, 1e-12f) : 0.0f);
  G.albedo = e.scat ? q / nmax(e.albedo, 1e-12f) : 0.0f;
  const bool aniso = fabsf(e.g) >= kEps;
  const float g2 = e.g * e.g;
  const float hg_score = -2.0f * e.g / nmax(1.0f - g2, 1e-9f) -
                         3.0f * (e.g - e.hg_cos) / nmax(1.0f + g2 - 2.0f * e.g * e.hg_cos, 1e-9f);
  G.graw = ((e.scat && aniso) ? q * hg_score : 0.0f) * 2.0f;
  return G;
}

// ROUTED mode's output: the pair list a lane-step's nonzero volume row is
// appended to instead of g_vol (its count, slot ids, rows and values, cap
// pairs), and this scatter's slot id (slot x lanes + lane)
struct PairOut {
  int* count;
  int* slot;
  int* row;
  float* upd;
  int cap;
  int at;
};

// ROUTED mode: append this lane's pair where `has`, one atomic a warp: the
// lanes that arrive together vote, the leader reserves their places, and
// each takes the place of its rank among them
__device__ __forceinline__ void append_pair(const PairOut& po, bool has, int vol_row, float a0,
                                            float a1, float w0, float w1, float w2, float w3) {
  const unsigned mask = __activemask();
  const unsigned vote = __ballot_sync(mask, has);
  if (vote == 0u) return;
  const int me = threadIdx.x & 31, leader = __ffs(vote) - 1;
  int base = 0;
  if (me == leader) base = atomicAdd(po.count, __popc(vote));
  base = __shfl_sync(mask, base, leader);
  const int at = base + __popc(vote & ((1u << me) - 1u));
  if (!has || at >= po.cap) return;
  // the values start 16-byte aligned (the wrapper's layout): two 16-byte stores
  float4* u = reinterpret_cast<float4*>(po.upd + (int64_t)at * 8);
  u[0] = make_float4(a0 * w0, a0 * w1, a0 * w2, a0 * w3);
  u[1] = make_float4(a1 * w0, a1 * w1, a1 * w2, a1 * w3);
  po.slot[at] = po.at;
  po.row[at] = vol_row;
}

// the analytic per-step table scatters of one tape row (JAX scatter_step,
// :781-862): one 18-wide TF+light row, one 8-wide volume row (two 4-wide
// plane rows of an xy volume; in ROUTED mode stored as a pair), and an
// escape's env texels
__device__ __forceinline__ void scatter_step(const EventIn& e, const ScatterIn& s, const Rev& R,
                                             float c, float cb, float weight,
                                             float* __restrict__ g_tf,
                                             float* __restrict__ g_vol,
                                             float* __restrict__ g_env, const PairOut& po) {
  const float q = cb * c * weight;
  const EventGrads G = event_grads(e, q);
  if (R.i[R_WANT_TF]) {
    const float gl = cb * weight * s.light_w;
    if (G.albedo != 0.0f || G.alpha != 0.0f || G.graw != 0.0f || gl != 0.0f) {
      const float fx = s.fx, fy = s.fy;
      const float w[4] = {(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy};
      // an 18-wide row starts at a multiple of 72 B: 8-byte aligned
      float* r = g_tf + (int64_t)s.tf_row * 18;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        add2(r + 4 * k, G.albedo * w[k], G.alpha * w[k]);
        add2(r + 4 * k + 2, G.graw * w[k], 0.0f);
      }
      add2(r + 16, gl * (1 - fx), gl * fx);
    }
  }
  if (R.i[R_WANT_VOL]) {
    const float gd = G.albedo * s.slope[0] + G.alpha * s.slope[1] + G.graw * s.slope[2];
    // ROUTED mode (uniform): every lane takes part in its warp's append
    if (gd != 0.0f || R.i[R_ROUTED]) {
      const float vfx = s.vfx, vfy = s.vfy, vfz = s.vfz;
      const float w0 = (1 - vfy) * (1 - vfx), w1 = (1 - vfy) * vfx;
      const float w2 = vfy * (1 - vfx), w3 = vfy * vfx;
      const float a0 = gd * (1 - vfz), a1 = gd * vfz;
      if (R.i[R_ROUTED]) {
        append_pair(po, gd != 0.0f, s.vol_row, a0, a1, w0, w1, w2, w3);
      } else {
        // an 8-wide row is 32 B: two 16-byte-aligned float4 adds; an xy
        // volume's plane rows are 16 B each
        float* r0 = R.i[R_VOL_XY] ? g_vol + (int64_t)s.vol_row * 4 : g_vol + (int64_t)s.vol_row * 8;
        float* r1 = R.i[R_VOL_XY] ? g_vol + (int64_t)s.vol_row1 * 4 : r0 + 4;
        add4(r0, a0 * w0, a0 * w1, a0 * w2, a0 * w3);
        add4(r1, a1 * w0, a1 * w1, a1 * w2, a1 * w3);
      }
    }
  }
  if (R.i[R_WANT_ENV]) {
    // the 12-wide row holds 4 corners x 3 channels; only the band's
    // channel of each corner takes a term
    const float gE = cb * weight * s.env_w;
    if (gE != 0.0f) add_env_texels(g_env, s.env_row, s.env_band, gE, s.efx, s.efy);
  }
}

// importance-thinning selection weight (JAX _importance_metric, :411-450)
__device__ __forceinline__ float importance_metric(const EventIn& e, const ScatterIn& s,
                                                   const Rev& R, float c, float cb) {
  const float q = c * cb;
  const EventGrads G = event_grads(e, q);
  float m = 0.0f;
  if (R.i[R_WANT_VOL]) {
    m = m + fabsf(G.albedo * s.slope[0] + G.alpha * s.slope[1] + G.graw * s.slope[2]);
  }
  if (R.i[R_WANT_TF]) {
    m = m + (fabsf(G.albedo) + fabsf(G.alpha) + fabsf(G.graw) + fabsf(cb * s.light_w));
  }
  if (R.i[R_WANT_ENV]) m = m + fabsf(cb * s.env_w);
  return m;
}

// The reverse pass, stride mode (NS == 0) or importance mode over at most
// NS steps. A lane-step's tape reads are issued together, before the carry
// branch and the scores need them (a scatter step's fields are read only
// on a step of the stride's phase, which is the same for the whole warp).
// Importance mode keeps each step's carry and metric in registers (NS is a
// template parameter and every loop over the steps is unrolled), scores
// the metric in the reverse pass itself, and re-reads only the picked
// rows' fields.
template <int NS>
__global__ void __launch_bounds__(REV_THREADS, rev_min_blocks(NS))
reverse_kernel(const Rev R, const float* __restrict__ tape,
               const float* __restrict__ g_rad_scaled, float* __restrict__ c_io,
               float* __restrict__ cb_io, const int* __restrict__ phases,
               const uint32_t* __restrict__ seeds, double* __restrict__ ext_acc,
               float* __restrict__ g_tf, float* __restrict__ g_vol,
               float* __restrict__ g_env, const uint32_t* __restrict__ lane_ix,
               const uint32_t* __restrict__ lane_seed_iy, const PairOut pairs) {
  // no early return: every thread reaches block_add's __syncthreads
  const int n_lanes = R.i[R_N_LANES];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = lane < n_lanes;
  const bool want_ext = R.i[R_WANT_EXT] != 0;
  float ext = 0.0f;
  if (active) {
    const int steps = R.i[R_STEPS];
    const int n_bins = R.i[R_N_BINS];
    const int stride = R.i[R_STRIDE];
    const bool want_tf = R.i[R_WANT_TF] != 0, want_vol = R.i[R_WANT_VOL] != 0;
    const bool want_scatter = want_tf || want_vol || R.i[R_WANT_ENV] != 0;
    const int64_t lanes = n_lanes;
    const int64_t step_rows = (int64_t)R.i[R_N_FIELDS] * lanes;
    float c = c_io[lane], cb = cb_io[lane];
    // ROUTED: a dispatch's steps / stride scatter slots
    const int per_disp = steps / stride;
    PairOut po = pairs;

    for (int k = R.i[R_N_DISPATCH] - 1; k >= 0; --k) {
      const float* disp = tape + (int64_t)k * steps * step_rows + lane;
      if constexpr (NS == 0) {
        const float weight = (float)stride;
        const int phase = phases[k];
        for (int it = steps - 1; it >= 0; --it) {
          const float* row = disp + it * step_rows;
          const CarryIn t = load_carry(row, R, want_ext);
          const bool now = want_scatter && it % stride == phase;
          EventIn e = {};
          ScatterIn s = {};
          if (now) {
            e = load_event(row, R);
            s = load_scatter(row, R, want_tf, want_vol, true);
          }
          carry_update(t, g_rad_scaled, lanes, lane, n_bins, c, cb);
          if (want_ext) ext += c * cb * (R.inv_mu - t.dist);
          if (now) {
            po.at = (k * per_disp + it / stride) * n_lanes + lane;
            scatter_step(e, s, R, c, cb, weight, g_tf, g_vol, g_env, po);
          }
        }
      } else {
        // per-lane i.i.d. step picks proportional to the scatter magnitude,
        // reweighted S / (count * metric); S and the cdf are sequential sums
        float c_all[NS], cb_all[NS], absq[NS];
#pragma unroll
        for (int it = NS - 1; it >= 0; --it) {
          if (it >= steps) continue;
          const float* row = disp + it * step_rows;
          const CarryIn t = load_carry(row, R, want_ext);
          const EventIn e = load_event(row, R);
          const ScatterIn s = load_scatter(row, R, want_tf, want_vol, false);
          carry_update(t, g_rad_scaled, lanes, lane, n_bins, c, cb);
          if (want_ext) ext += c * cb * (R.inv_mu - t.dist);
          c_all[it] = c;
          cb_all[it] = cb;
          absq[it] = importance_metric(e, s, R, c, cb);
        }
        float S = 0.0f;
#pragma unroll
        for (int it = 0; it < NS; ++it)
          if (it < steps) S = S + absq[it];
        const float Sd = nmax(S, 1e-30f);
        float cdf[NS];
        float run = 0.0f;
#pragma unroll
        for (int it = 0; it < NS; ++it) {
          if (it < steps) run = run + absq[it] / Sd;
          cdf[it] = run;
        }
        uint32_t ix, iy, seed_iy;
        float sx, sy;
        lane_coords(lane, R.i[R_RES], ix, iy, seed_iy, 1.0f, sx, sy);
        if (lane_ix != nullptr) {
          ix = __ldg(lane_ix + lane);
          seed_iy = __ldg(lane_seed_iy + lane);
        }
        const uint32_t bits =
            (R.i[R_PICK_BITS_SET] ? (uint32_t)R.i[R_PICK_BITS] : seeds[k]) ^ 0x7F4A7C15u;
        const uint32_t pick_state = hash3(ix, seed_iy, bits);
        const int count = steps / stride;
        for (int j = 0; j < count; ++j) {
          const float u = uniform_from_state(pcg_hash(pick_state ^ (0x9E3779B9u * (uint32_t)(j + 1))));
          int sel = 0;
#pragma unroll
          for (int it = 0; it < NS; ++it) sel += (it < steps && cdf[it] < u) ? 1 : 0;
          sel = min(max(sel, 0), steps - 1);
          float a = 0.0f, cs = 0.0f, cbs = 0.0f;
#pragma unroll
          for (int it = 0; it < NS; ++it) {
            if (it == sel) {
              a = absq[it];
              cs = c_all[it];
              cbs = cb_all[it];
            }
          }
          const float w = (a > 0.0f) ? S / ((float)count * nmax(a, 1e-30f)) : 0.0f;
          const float* row = disp + sel * step_rows;
          po.at = (k * per_disp + j) * n_lanes + lane;
          scatter_step(load_event(row, R), load_scatter(row, R, want_tf, want_vol, true), R,
                       cs, cbs, w, g_tf, g_vol, g_env, po);
        }
      }
    }
    c_io[lane] = c;
    cb_io[lane] = cb;
  }
  if (want_ext) block_add<REV_THREADS>(ext, ext_acc);
}

// the scatter ceiling (bench.py:210-276 measure_ceilings' scatter_run):
// K5's volume-row scatter alone, two float4 atomics of ones per index
__global__ void __launch_bounds__(256)
scatter_rows_kernel(const int* __restrict__ rows, int64_t n, float* __restrict__ table) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = __ldcs(rows + i);
  if (r < 0) return;
  float* p = table + (int64_t)r * 8;
  add4(p, 1.0f, 1.0f, 1.0f, 1.0f);
  add4(p + 4, 1.0f, 1.0f, 1.0f, 1.0f);
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

// env: the packed (He+1, We+1, 12) environment map, or null
int vpt_prb_tape_forward(const float* fparams, const int* iparams,
                         const int* slots, int n_fields, float* px, float* py,
                         float* pz, float* dx, float* dy, float* dz,
                         int* bounces, int* samples, int* bin, float* wavelength,
                         float* radiance, const void* vol, const float* tf,
                         const float* env, const uint32_t* seeds, float* tape,
                         void* stream) {
  const Params P = make_params(fparams, iparams);
  const int n = P.i[I_N_LANES];
  const TapeSpec T = make_tape_spec(slots, n_fields, n);
  if (n <= 0) return 0;
  if ((env != nullptr) != (P.i[I_ENV_H] > 0)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_for(n, STEP_THREADS)), block(STEP_THREADS);
  switch (bins_rounded(P.i[I_N_BINS]) * 4 + (env != nullptr ? 1 : 0) +
          (P.i[I_VOL_XY] != 0 ? 2 : 0)) {
#define VPT_NB_ENV(NB, M, EB, XB)                                                          \
  case NB * 4 + M:                                                                         \
    tape_forward_kernel<NB, EB, XB><<<grid, block, 0, st>>>(P, T, px, py, pz, dx, dy, dz,  \
                                                            bounces, samples, bin,         \
                                                            wavelength, radiance, vol, tf, \
                                                            env, seeds, tape);             \
    break;
#define VPT_NB(NB)                       \
  VPT_NB_ENV(NB, 0, false, false)        \
  VPT_NB_ENV(NB, 1, true, false)         \
  VPT_NB_ENV(NB, 2, false, true)         \
  VPT_NB_ENV(NB, 3, true, true)
    VPT_NB(4) VPT_NB(8) VPT_NB(12) VPT_NB(16) VPT_NB(20) VPT_NB(24) VPT_NB(28) VPT_NB(32)
#undef VPT_NB
#undef VPT_NB_ENV
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K4's surrogate mode: the majorant table `maj` (Gz, Gy, Gx) x (majorant,
// flight cap), or null for the exact mode; `env` the packed environment
// map, or null; an xy half-packed `vol` when I_VOL_XY is set; with I_RAW
// raw or partly packed tables (K1's RAW kinds; `env` packed or raw,
// `light` the light's own table beside a TF without it, else null)
int vpt_surrogate_tape_forward(const float* fparams, const int* iparams, const int* slots,
                               int n_fields, float* px, float* py, float* pz, float* dx,
                               float* dy, float* dz, int* bounces, int* samples, int* bin,
                               float* wavelength, float* radiance, const void* vol,
                               const float* tf, const float2* maj, const float* env,
                               const uint32_t* seeds, float* tape, const float* light,
                               void* stream) {
  const Params P = make_params(fparams, iparams);
  const int n = P.i[I_N_LANES];
  const SurSpec T = make_sur_spec(slots, n_fields, n);
  if (n <= 0) return 0;
  if ((env != nullptr) != (P.i[I_ENV_H] > 0) || (maj != nullptr) != (P.i[I_MAJ_GZ] > 0))
    return (int)cudaErrorInvalidValue;
  const bool raw = P.i[I_RAW] != 0;
  if ((light != nullptr) != (raw && P.i[I_LIGHT_KIND] != LIGHT_FUSED) ||
      (!raw && (P.i[I_VOL_RAW] | P.i[I_NEAREST] | P.i[I_TF_KIND] | P.i[I_ENV_RAW]) != 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_for(n, STEP_THREADS)), block(STEP_THREADS);
  // NB is a multiple of 4, so NB * 4 leaves the low 4 bits to the mode; RAW
  // reads an xy table by its runtime flag, so its modes take 8 + MAJ + 2 ENV
  switch (bins_rounded(P.i[I_N_BINS]) * 4 + (maj != nullptr ? 1 : 0) + (env != nullptr ? 2 : 0) +
          (raw ? 8 : (P.i[I_VOL_XY] != 0 ? 4 : 0))) {
#define VPT_NB_MODE(NB, M, MB, EB, XB, RB)                                                 \
  case NB * 4 + M:                                                                         \
    surrogate_tape_kernel<NB, MB, EB, XB, RB><<<grid, block, 0, st>>>(                     \
        P, T, px, py, pz, dx, dy, dz, bounces, samples, bin, wavelength, radiance, vol, tf, \
        maj, env, seeds, tape, light);                                                     \
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

// lane_ix / lane_seed_iy: the lanes' global pixels (both or neither);
// pairs: ROUTED mode's pair list of pair_cap pairs (R_ROUTED set, g_vol
// null): the count, then pair_cap slot ids, pair_cap rows, (pair_cap, 8)
// values; pair_cap a multiple of 4 below 2^31 and at least every slot
int vpt_prb_reverse(const int* rparams, float inv_mu, const int* slots,
                    const float* tape, const float* g_rad_scaled, float* c,
                    float* cb, const int* phases, const uint32_t* seeds,
                    double* ext_acc, float* g_tf, float* g_vol, float* g_env,
                    const uint32_t* lane_ix, const uint32_t* lane_seed_iy, int* pairs,
                    int64_t pair_cap, void* stream) {
  Rev R;
  for (int k = 0; k < R_COUNT; ++k) R.i[k] = rparams[k];
  R.inv_mu = inv_mu;
  const int n = R.i[R_N_LANES];
  for (int k = 0; k < T_COUNT; ++k) R.off[k] = slots[k] < 0 ? -1 : (long long)slots[k] * n;
  if (n <= 0) return 0;
  const int steps = R.i[R_STEPS];
  const bool importance = R.i[R_IMPORTANCE] && R.i[R_STRIDE] > 1 &&
                          (R.i[R_WANT_TF] || R.i[R_WANT_VOL] || R.i[R_WANT_ENV]);
  if (importance && steps > MAX_IMP_STEPS) return (int)cudaErrorInvalidValue;
  if ((lane_ix == nullptr) != (lane_seed_iy == nullptr) ||
      (R.i[R_ROUTED] != 0) != (pairs != nullptr) ||
      (R.i[R_ROUTED] && (g_vol != nullptr || !R.i[R_WANT_VOL] || R.i[R_VOL_XY] ||
                         pair_cap % 4 != 0 || pair_cap >= INT32_MAX ||
                         pair_cap < (int64_t)R.i[R_N_DISPATCH] * (steps / R.i[R_STRIDE]) * n)))
    return (int)cudaErrorInvalidValue;
  const int cap = (int)pair_cap;
  const PairOut po = {pairs, pairs == nullptr ? nullptr : pairs + 4,
                      pairs == nullptr ? nullptr : pairs + 4 + cap,
                      pairs == nullptr ? nullptr : reinterpret_cast<float*>(pairs + 4 + 2 * cap),
                      cap, 0};
  const int ns = !importance ? 0 : steps <= 8 ? 8 : steps <= 16 ? 16 : 32;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_for(n, REV_THREADS)), block(REV_THREADS);
  switch (ns) {
#define VPT_NS(NS)                                                                          \
  case NS:                                                                                  \
    reverse_kernel<NS><<<grid, block, 0, st>>>(R, tape, g_rad_scaled, c, cb, phases, seeds, \
                                               ext_acc, g_tf, g_vol, g_env, lane_ix,        \
                                               lane_seed_iy, po);                           \
    break;
    VPT_NS(0) VPT_NS(8) VPT_NS(16) VPT_NS(32)
#undef VPT_NS
  }
  return (int)cudaGetLastError();
}

// the scatter ceiling: two float4 atomics of ones per index into the
// 8-wide row it names (rows < 0 skip), one thread per index
int vpt_scatter_rows(const int* rows, int64_t n, float* table, void* stream) {
  if (n <= 0) return 0;
  scatter_rows_kernel<<<(unsigned)((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, n, table);
  return (int)cudaGetLastError();
}

}  // extern "C"
