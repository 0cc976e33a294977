// The single-scattering MCS kernels for Hopper (sm_90a), plain C interface.
//
//   K22 mcs_frames_kernel      replaces vpt_tpu/models/mcs.py::_mcs_frame_impl
//                              (:174-243) looped by mcs_frames (:256-275), and
//                              MCSRenderer.render's running average (:400-406).
//   K23 mcs_persistent_kernel  replaces _mcs_persistent_dispatch_impl
//                              (:473-615) looped by mcs_persistent_many
//                              (:625-641): the persistent lanes.
//
// K22. One thread per pixel, an 8 x 4 pixel tile a warp. The pixel's
// camera ray, its cube interval, its view direction's environment and its uv
// seed bits are the same for every frame, so a thread computes them once and
// keeps them in registers. The block computes each frame's values once into
// shared memory: the light
// (the environment at the frame's scattering direction, alpha 1), the
// reciprocals of the direction's components and of the running mean's
// divisor, the seed. Then each lane runs its K frames: per frame the chain
// hash3(bits(u), bits(v), seed); a Woodcock free flight from the cube's
// entry to a real collision or an escape (_woodcock_distance); at the
// collision the TF's RGBA (from the density the collision's trip looked
// up), the light and a ratio-tracked transmittance toward the cube's exit
// along that direction (_woodcock_transmittance); diffuse x light x
// transmittance, or the environment on a miss or an escape; the running
// mean acc + (img - acc) / frame. `acc` is read and
// written once per launch, in place. The frame count is read, never
// written: the wrapper advances it on the same stream after the launch.
//
// Both loops run per lane, capped at max_collisions trips. That equals the
// reference's all-lanes-done while_loops under their global trip counter:
// there every active lane takes exactly one trip per iteration and a done
// lane never moves again. The RNG advances only where the reference's mask
// is on: the flight's exponential on an active lane, the distance loop's
// acceptance uniform on a lane that neither escaped nor was capped, no
// uniform in the transmittance loop. A pixel whose ray misses the cube
// skips both loops: the reference runs them there too, but its result is
// the environment, whatever they draw. With the majorant (a (Gz, Gy, Gx)
// grid of (majorant, flight cap) pairs) a flight samples at the rate
// extinction * m of the cell at the lane's current distance and stops at
// the cap; a capped trip is a pure advance (no lookup, no uniform), and a
// tentative collision counts with alpha / m.
//
// K23. One thread per lane of the (S, R, R) lanes (S streams of the R x R
// pixels). A lane reads its 16 state fields once (13 f32, `phase` as the
// bool tensor's byte, `samples`, `acc` as a float4), runs the launch's K
// dispatches x `steps` iterations in registers and writes them back once,
// in place. Its camera segment (the ray's stretch inside the cube; a ray
// that misses gets length 0, so its first step escapes), the segment's
// direction (seg * (1 / max(length, 1e-30))) and its view direction's
// environment are the same for every dispatch and are computed once; each
// dispatch restarts the chain at hash3(bits(u), bits(v), seed), v of the
// row iy + s R (stream s seeds as the rows of a taller framebuffer). Each
// iteration: the exponential step (at extinction * m of the majorant cell
// at the lane's point b + d * dist, capped, with the grid), the point b +
// d * dist2, the TF's RGBA there unless the step escaped or was capped; the
// acceptance uniform in the distance phase only; draw_sphere's two
// uniforms on every lane (their cos/sin and the shadow ray's cube exit only
// where the lane scatters). A distance-phase escape deposits the view's
// environment, a shadow-phase escape diffuse x light x transmittance (the
// light the environment at the sample's direction); the deposit enters the
// incremental mean acc + (value - acc) / samples. A distance-phase real
// collision (uniform < alpha) turns the lane into a shadow ray from the
// point along the drawn direction; a shadow ray multiplies its
// transmittance by (1 - alpha) at each tentative collision.
//
// Modes: the volume a packed "full" corner table (u8 or f32, linear or
// quasicubic) or a raw (D, H, W) f32 grid (linear, quasicubic or nearest);
// the TF the packed (257, 257, 16) corner table or the raw (256, 256, 4)
// texture, read at (density, 0) (mcm_common.cuh sample_rgba); the
// environment a raw (He, We, 3) map (sample_env_rgb); the majorant grid
// present or not; K23's stream count. K22 and K23 are each an instance per
// table pair (McsMode) and majorant (MAJ); the environment and the streams
// are runtime values.
//
// What bounds them on this card: each trip is a dependent chain (a hash, a
// log, a volume row, then the TF row the density selects), and a warp
// lasts as long as its slowest lane's trips; the bytes (the state once, the
// rows the lookups touch, most in the L2) and the FP32 operations bound them
// far below that (counted by chip_smoke.py's phases 22 and 23). K22 keeps a
// lane in registers for all K frames and pays per warp, not per frame as
// the reference's lockstep loops do; K23 keeps every lane busy every
// iteration (a finished sample starts the next at once), and pays for it
// with a sphere draw and four hashes each step.
//
// K22's design, each lever timed in turns on the card (probes/
// mcs_mcm_variants.py; PERF.md): each instance inlines one table pair's
// lookup path and the majorant only where it has one; the per-frame values
// are computed once a block; the collision's density comes from its trip,
// the RGB only where a frame is shaded; cube_exit takes one quotient an axis
// where the direction's signs pick the face; a warp takes an 8 x 4 pixel
// tile. A minimum of blocks an SM in __launch_bounds__ (6 to 12) lost in
// most scenes, and the camera segment and view environment in shared memory
// instead of registers lost 2-6%. A warp keeps per-frame loops: one stream
// of trips a lane (a warp paying its slowest lane's total trips, the lanes
// whose loop ended turning together) won 6% on the default scene but lost
// 15-27% where loops are short and alike.
//
// Numerics: built without fast math and with -fmad=false, so every
// expression rounds as the plain PyTorch versions' (kernels/mcs.py); every
// quotient is IEEE's (__fdiv_rn, or the exact reciprocal-and-correction
// quot), sqrt is IEEE, logf/atan2f/asinf/sinf/cosf/sincosf the accurate
// forms (sincosf gives sinf's and cosf's bits on every angle a sphere draw
// can take, probes/mcsp_variants.py), min/max propagate NaN like torch.
// There are no atomics, so each kernel equals its plain version bit for
// bit.

#include "mcm_common.cuh"

namespace {

#define MCS_THREADS 128

// parameter block layout, mirrored by vpt_tpu_torch/kernels/mcs.py
enum McsF {
  SF_INV_MVP = 0,  // 16 floats, row-major
  SF_EXTINCTION = 16,
  SF_INV_RES,      // f32(1 / R), the camera rays' pixel step
  SF_COUNT,
};
enum McsI {
  SI_RES = 0,
  SI_N_FRAMES,     // K22's frames, K23's dispatches
  SI_MAX_COLLISIONS,
  SI_VOL_RAW,      // 1: a raw (D, H, W) f32 grid, given as D+1, H+1, W+1
  SI_VOL_U8,       // packed table: 1 u8, 0 f32
  SI_VOL_D, SI_VOL_H, SI_VOL_W,
  SI_QUASICUBIC,
  SI_NEAREST,      // raw grid only
  SI_TF_RAW,       // 1: a raw (H, W, 4) texture, given as H+1, W+1
  SI_TF_H, SI_TF_W,
  SI_ENV_H, SI_ENV_W,               // the raw map's He, We
  SI_MAJ_GZ, SI_MAJ_GY, SI_MAJ_GX,  // majorant grid cells (0 without one)
  SI_STEPS, SI_STREAMS,             // K23: iterations a dispatch, streams
  SI_MODE,                          // the tables' McsMode (kernels/mcs.py persistent_mode)
  SI_COUNT,
};

// K22's and K23's instances by table pair: the pairs MCSRenderer builds (a
// packed u8 or f32 corner table, linear or quasicubic, beside the packed TF;
// the raw grid under the nearest filter beside the raw TF), each inlining its
// one lookup path, and every other pair they take (a raw grid under a linear
// or quasicubic filter, a TF of the other kind) in the generic instance,
// which reads the table flags at run time
enum McsMode {
  MM_U8 = 0,    // packed u8 corner table, linear
  MM_F32,       // packed f32 corner table, linear
  MM_U8_QC,     // packed u8, quasicubic
  MM_F32_QC,    // packed f32, quasicubic
  MM_NEAREST,   // raw f32 grid, nearest, raw TF
  MM_GENERIC,   // any other pair, by the runtime flags
  MM_COUNT,
};

// K22's and K23's block: a 16 x 8 pixel tile (of one stream), as four warps
// of 8 x 4
#define MCSP_TILE_W 16
#define MCSP_TILE_H 8
// blocks an SM that K23's __launch_bounds__ asks room for
#define MCSP_MIN_BLOCKS 8

struct McsParams {
  float f[SF_COUNT];
  int i[SI_COUNT];
};

// A segment from (fx, fy, fz) to (tx, ty, tz): its length and the divisor
// max(length, 1e-30) of the fraction t = dist / divisor along it
struct Segment {
  float fx, fy, fz, tx, ty, tz, len, den;
};

__device__ __forceinline__ Segment segment(float fx, float fy, float fz, float tx, float ty,
                                           float tz) {
  Segment g{fx, fy, fz, tx, ty, tz, 0.0f, 0.0f};
  const float ex = tx - fx, ey = ty - fy, ez = tz - fz;
  g.len = sqrtf(ex * ex + ey * ey + ez * ez);
  g.den = nmax(g.len, 1e-30f);
  return g;
}

// the (majorant, flight cap) row of the grid cell at normalized (x, y, z):
// _majorant_lookup's cell
__device__ __forceinline__ float2 majorant_row(const float2* __restrict__ maj, const McsParams& P,
                                               float x, float y, float z) {
  const int gz = P.i[SI_MAJ_GZ], gy = P.i[SI_MAJ_GY], gx = P.i[SI_MAJ_GX];
  const int cz = floor_cell(z, gz), cy = floor_cell(y, gy), cx = floor_cell(x, gx);
  return __ldg(maj + ((int64_t)cz * gy + cy) * gx + cx);
}

// One trip's free flight from distance `dist`: the step (capped at the
// majorant cell's flight range), whether it was capped, and the cell's
// majorant m (1 without a grid)
template <bool MAJ>
__device__ __forceinline__ float flight(uint32_t& s, const McsParams& P, const Recip& ext,
                                        const float2* __restrict__ maj, const Segment& g,
                                        float dist, bool& capped, float& m) {
  capped = false;
  m = 1.0f;
  if (!MAJ) return quot(-logf(draw(s)), ext);
  const float t0 = __fdiv_rn(dist, g.den);
  const float2 row = majorant_row(maj, P, lerp(g.fx, g.tx, t0), lerp(g.fy, g.ty, t0),
                                  lerp(g.fz, g.tz, t0));
  m = nmax(row.x, 1e-12f);
  const float step = __fdiv_rn(-logf(draw(s)), m * P.f[SF_EXTINCTION]);
  capped = step >= row.y;
  return nmin(step, row.y);
}

// the far end of the ray from (x, y, z) along d in the unit cube, clamped
// at 0: intersect_cube's tfar
__device__ __forceinline__ float cube_exit(float x, float y, float z, float dx, float dy,
                                           float dz) {
  const float t0x = __fdiv_rn(0.0f - x, dx), t0y = __fdiv_rn(0.0f - y, dy);
  const float t0z = __fdiv_rn(0.0f - z, dz);
  const float t1x = __fdiv_rn(1.0f - x, dx), t1y = __fdiv_rn(1.0f - y, dy);
  const float t1z = __fdiv_rn(1.0f - z, dz);
  return nmax(nmin(nmin(nmax(t0x, t1x), nmax(t0y, t1y)), nmax(t0z, t1z)), 0.0f);
}

// A pixel's camera ray (camera_rays) clamped to the cube (ray_bounds): its
// points at tn and tfar, whether it misses, and its normalized direction
// (normalize3: x * (1 / |d|), the reciprocal correctly rounded)
struct PixelRay {
  float ex, ey, ez, xx, xy, xz, vx, vy, vz;
  bool miss;
};

__device__ __forceinline__ PixelRay pixel_ray(const McsParams& P, int ix, int iy) {
  const float inv_res = P.f[SF_INV_RES];
  const float sx = (((float)ix + 0.5f) * inv_res - 0.5f) * 2.0f;
  const float sy = (((float)iy + 0.5f) * inv_res - 0.5f) * -2.0f;
  float fx, fy, fz, tx, ty, tz;
  apply_homogeneous(P.f + SF_INV_MVP, sx, sy, -1.0f, fx, fy, fz);
  apply_homogeneous(P.f + SF_INV_MVP, sx, sy, 1.0f, tx, ty, tz);
  const float dx = tx - fx, dy = ty - fy, dz = tz - fz;
  const float t0x = __fdiv_rn(0.0f - fx, dx), t0y = __fdiv_rn(0.0f - fy, dy);
  const float t0z = __fdiv_rn(0.0f - fz, dz);
  const float t1x = __fdiv_rn(1.0f - fx, dx), t1y = __fdiv_rn(1.0f - fy, dy);
  const float t1z = __fdiv_rn(1.0f - fz, dz);
  const float tn = nmax(nmax(nmax(nmin(t0x, t1x), nmin(t0y, t1y)), nmin(t0z, t1z)), 0.0f);
  const float tfar = nmax(nmin(nmin(nmax(t0x, t1x), nmax(t0y, t1y)), nmax(t0z, t1z)), 0.0f);
  const float inv = __frcp_rn(sqrtf(dx * dx + dy * dy + dz * dz));
  return PixelRay{lerp(fx, tx, tn), lerp(fy, ty, tn), lerp(fz, tz, tn), lerp(fx, tx, tfar),
                  lerp(fy, ty, tfar), lerp(fz, tz, tfar), dx * inv, dy * inv, dz * inv,
                  tn >= tfar};
}

// The persistent lanes' state: each field an (S, R, R) array, `phase` the
// bool tensor's bytes (0 or 1), `acc` float4
struct McsLanes {
  uint8_t* phase;
  float *dist, *trans, *sdx, *sdy, *sdz, *smax, *scx, *scy, *scz, *dr, *dg, *db, *da;
  float4* acc;
  int* samples;
};

// K22's and K23's density at (x, y, z) in MODE's table: one lookup path
// inlined in each instance (a packed full table with its kind and filter
// fixed, or the raw grid's nearest texel), the table flags read at run time
// in the generic one
template <int MODE>
__device__ __forceinline__ float mode_density(const void* vol, const McsParams& P, float x,
                                              float y, float z) {
  if constexpr (MODE == MM_GENERIC)
    return sample_volume_flags(vol, P.i[SI_VOL_RAW], P.i[SI_VOL_U8], P.i[SI_VOL_D],
                               P.i[SI_VOL_H], P.i[SI_VOL_W], P.i[SI_QUASICUBIC] != 0,
                               P.i[SI_NEAREST] != 0, x, y, z);
  else if constexpr (MODE == MM_NEAREST)
    return sample_volume_raw(static_cast<const float*>(vol), P.i[SI_VOL_D], P.i[SI_VOL_H],
                             P.i[SI_VOL_W], x, y, z, false, true);
  else
    return sample_volume(vol, MODE == MM_U8 || MODE == MM_U8_QC, P.i[SI_VOL_D], P.i[SI_VOL_H],
                         P.i[SI_VOL_W], x, y, z, nullptr, MODE == MM_U8_QC || MODE == MM_F32_QC,
                         false);
}

// the TF's RGBA at (density, 0) in MODE's layout (raw beside the raw grid)
template <int MODE>
__device__ __forceinline__ float4 mode_rgba(const float* __restrict__ tf, const McsParams& P,
                                            float d) {
  const bool raw = MODE == MM_GENERIC ? P.i[SI_TF_RAW] != 0 : MODE == MM_NEAREST;
  return sample_rgba(tf, raw, P.i[SI_TF_H], P.i[SI_TF_W], d);
}

// this thread's lane: the warp's 8 x 4 pixel tile of the block's 16 x 8;
// the blocks run over the tiles of stream 0, then of stream 1, ...
__device__ __forceinline__ void mcsp_pixel(int res, int& ix, int& iy, int& stream) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles_x = (res + MCSP_TILE_W - 1) / MCSP_TILE_W;
  const int tiles_y = (res + MCSP_TILE_H - 1) / MCSP_TILE_H;
  const int tx = blockIdx.x % tiles_x, rest = blockIdx.x / tiles_x;
  const int ty = rest % tiles_y;
  stream = rest / tiles_y;
  ix = tx * MCSP_TILE_W + (warp & 1) * 8 + (lane & 7);
  iy = ty * MCSP_TILE_H + (warp >> 1) * 4 + (lane >> 3);
}

// K22's per-frame values, the same for every pixel, computed once per block:
// the running mean's divisor (the count + k + 1); the scattering direction's
// components as divisors, the cube face each leaves through (1 where it is
// positive, else 0) and whether all three are finite and nonzero (then, from
// a finite point, the larger of cube_exit's two quotients on each axis is the
// face's: rounding is monotone); the light (the environment at the
// direction, alpha 1); the seed's bits
struct McsFrame {
  Recip n, dx, dy, dz;
  float face_x, face_y, face_z;
  bool faces;
  float3 light;
  uint32_t seed;
};

// K22's frames a block holds in shared memory: a launch of more runs them in
// chunks, the block's lanes meeting at each chunk's end
#define MCS_CHUNK 32

// frames k0 .. k0 + kn - 1 of the launch into F, one a thread
__device__ __forceinline__ void fill_frames(McsFrame* F, const McsParams& P,
                                            const float* __restrict__ env,
                                            const float4* __restrict__ inputs, int count, int k0,
                                            int kn) {
  for (int j = threadIdx.x; j < kn; j += blockDim.x) {
    const float4 in = __ldg(inputs + k0 + j);
    McsFrame f;
    f.n = recip((float)(count + k0 + j + 1));
    f.dx = recip(in.y);
    f.dy = recip(in.z);
    f.dz = recip(in.w);
    f.face_x = in.y > 0.0f ? 1.0f : 0.0f;
    f.face_y = in.z > 0.0f ? 1.0f : 0.0f;
    f.face_z = in.w > 0.0f ? 1.0f : 0.0f;
    f.faces = isfinite(in.y) && isfinite(in.z) && isfinite(in.w) && in.y != 0.0f &&
              in.z != 0.0f && in.w != 0.0f;
    f.light = sample_env_rgb(env, P.i[SI_ENV_H], P.i[SI_ENV_W], in.y, in.z, in.w);
    f.seed = __float_as_uint(in.x);
    F[j] = f;
  }
}

// cube_exit from (x, y, z) along the frame's direction, each quotient by
// quot; one quotient an axis where the faces decide
__device__ __forceinline__ float cube_exit_frame(float x, float y, float z, const McsFrame& f) {
  if (f.faces && isfinite(x) && isfinite(y) && isfinite(z))
    return nmax(nmin(nmin(quot(f.face_x - x, f.dx), quot(f.face_y - y, f.dy)),
                     quot(f.face_z - z, f.dz)), 0.0f);
  const float t0x = quot(0.0f - x, f.dx), t0y = quot(0.0f - y, f.dy);
  const float t0z = quot(0.0f - z, f.dz);
  const float t1x = quot(1.0f - x, f.dx), t1y = quot(1.0f - y, f.dy);
  const float t1z = quot(1.0f - z, f.dz);
  return nmax(nmin(nmin(nmax(t0x, t1x), nmax(t0y, t1y)), nmax(t0z, t1z)), 0.0f);
}

// the running mean acc + (img - acc) / n
__device__ __forceinline__ void mean_add(float4& a, const float4& img, const Recip& n) {
  a.x = a.x + quot(img.x - a.x, n);
  a.y = a.y + quot(img.y - a.y, n);
  a.z = a.z + quot(img.z - a.z, n);
  a.w = a.w + quot(img.w - a.w, n);
}

// One chunk of frames F[0 .. kn) merged into `a` (`run`: a live pixel whose
// ray hits the cube; a live miss takes the view's environment for every
// frame). Per frame, from the chain base + 101 seed (hash3(bits(u), bits(v),
// seed)): the distance loop; at a collision (or its cap) the shadow segment
// to the cube's exit along the frame's direction and the transmittance
// loop, each loop capped at max_collisions trips; the collision's density
// from the distance loop's last trip where that trip looked it up there, its
// RGB only where the frame is shaded.
template <int MODE, bool MAJ>
__device__ __forceinline__ void frames_chunk(float4& a, bool live, bool run, uint32_t base,
                                             const Segment& g, const float4& view,
                                             const McsFrame* F, int kn, const McsParams& P,
                                             const Recip& ext, const void* __restrict__ vol,
                                             const float* __restrict__ tf,
                                             const float2* __restrict__ maj) {
  if (live && !run)  // a miss takes no trips: every frame is the view's environment
    for (int k = 0; k < kn; ++k) mean_add(a, view, F[k].n);
  const int cap = P.i[SI_MAX_COLLISIONS];
  if (!run) return;
  for (int k = 0; k < kn; ++k) {
    const McsFrame& f = F[k];
    uint32_t s = pcg_hash(base + 101u * f.seed);
    float dist = 0.0f, density = 0.0f;
    bool looked = false;  // the last trip looked up the density at `dist`
    for (int trips = 0; trips < cap; ++trips) {
      bool capped;
      float m;
      dist = dist + flight<MAJ>(s, P, ext, maj, g, dist, capped, m);
      looked = false;
      if (dist > g.len) break;  // escaped
      if (capped) continue;     // a pure advance: no lookup, no uniform
      const float t = __fdiv_rn(dist, g.den);
      const float d = mode_density<MODE>(vol, P, lerp(g.fx, g.tx, t), lerp(g.fy, g.ty, t),
                                         lerp(g.fz, g.tz, t));
      float alpha = mode_rgba<MODE>(tf, P, d).w;
      const float u = draw(s);
      if (MAJ) alpha = nmin(__fdiv_rn(alpha, m), 1.0f);
      density = d;
      looked = true;
      if (u < alpha) break;  // a real collision
    }
    float4 img = view;
    if (!(dist > g.len)) {
      const float t = __fdiv_rn(dist, g.den);
      const float cx = lerp(g.fx, g.tx, t), cy = lerp(g.fy, g.ty, t), cz = lerp(g.fz, g.tz, t);
      if (!looked) density = mode_density<MODE>(vol, P, cx, cy, cz);
      const float stf = cube_exit_frame(cx, cy, cz, f);
      const Segment sh = segment(cx, cy, cz, cx + f.dx.b * stf, cy + f.dy.b * stf,
                                 cz + f.dz.b * stf);
      float sd = 0.0f, trans = 1.0f;
      for (int trips = 0; trips < cap; ++trips) {
        bool capped;
        float m;
        sd = sd + flight<MAJ>(s, P, ext, maj, sh, sd, capped, m);
        if (sd > sh.len) break;
        if (capped) continue;
        const float t2 = __fdiv_rn(sd, sh.den);
        float alpha = mode_rgba<MODE>(tf, P, mode_density<MODE>(
            vol, P, lerp(sh.fx, sh.tx, t2), lerp(sh.fy, sh.ty, t2), lerp(sh.fz, sh.tz, t2))).w;
        if (MAJ) alpha = nmin(__fdiv_rn(alpha, m), 1.0f);
        trans = trans * (1.0f - alpha);  // ratio tracking
      }
      // frame k's image: the collision's diffuse x light x transmittance
      const float4 diffuse = mode_rgba<MODE>(tf, P, density);
      const float3 light = f.light;
      img = make_float4(diffuse.x * light.x * trans, diffuse.y * light.y * trans,
                        diffuse.z * light.z * trans, diffuse.w * 1.0f * trans);
    }
    mean_add(a, img, f.n);
  }
}

// K22: K frames per pixel merged into acc (R, R, 4) in place; MODE the
// tables' McsMode, MAJ the majorant grid. A warp takes an 8 x 4 pixel tile,
// a block 16 x 8 (mcsp_pixel, as K23's stream 0). inputs: K float4 (the
// frame seed's bits, the scattering direction); frame: the count before this
// launch.
template <int MODE, bool MAJ>
__global__ void __launch_bounds__(MCS_THREADS)
mcs_frames_kernel(const McsParams P, const void* __restrict__ vol, const float* __restrict__ tf,
                  const float* __restrict__ env, const float2* __restrict__ maj,
                  const float4* __restrict__ inputs, float4* __restrict__ acc,
                  const int* __restrict__ frame) {
  __shared__ McsFrame F[MCS_CHUNK];
  const int res = P.i[SI_RES];
  int ix, iy, stream;
  mcsp_pixel(res, ix, iy, stream);
  const bool live = ix < res && iy < res;  // every thread takes part in the fills
  const int pix = iy * res + ix;
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), view = a;
  Segment ray{};
  uint32_t base = 0;
  bool run = false;
  if (live) {
    // the camera ray, its segment inside the cube, the view direction's
    // environment; the chain's uv bits ((i + 0.5) / R by IEEE division)
    const PixelRay pr = pixel_ray(P, ix, iy);
    ray = segment(pr.ex, pr.ey, pr.ez, pr.xx, pr.xy, pr.xz);
    const float3 v = sample_env_rgb(env, P.i[SI_ENV_H], P.i[SI_ENV_W], pr.vx, pr.vy, pr.vz);
    view = make_float4(v.x, v.y, v.z, 1.0f);
    const uint32_t ubits = __float_as_uint(__fdiv_rn((float)ix + 0.5f, (float)res));
    const uint32_t vbits = __float_as_uint(__fdiv_rn((float)iy + 0.5f, (float)res));
    base = 19u * ubits + 47u * vbits + 131u;
    run = !pr.miss;
    a = acc[pix];
  }
  const Recip ext = recip(P.f[SF_EXTINCTION]);
  const int count = __ldg(frame), n_frames = P.i[SI_N_FRAMES];
  for (int k0 = 0; k0 < n_frames; k0 += MCS_CHUNK) {
    const int kn = min(n_frames - k0, MCS_CHUNK);
    if (k0 > 0) __syncthreads();  // every lane is done with the last chunk
    fill_frames(F, P, env, inputs, count, k0, kn);
    __syncthreads();
    frames_chunk<MODE, MAJ>(a, live, run, base, ray, view, F, kn, P, ext, vol, tf, maj);
  }
  if (live) acc[pix] = a;
}

// K23: K dispatches (one per seed) of SI_STEPS iterations on each lane, its
// state updated in place; MODE the tables' McsMode, MAJ the majorant grid.
template <int MODE, bool MAJ>
__global__ void __launch_bounds__(MCS_THREADS, MCSP_MIN_BLOCKS)
mcs_persistent_kernel(const McsParams P, const void* __restrict__ vol,
                      const float* __restrict__ tf, const float* __restrict__ env,
                      const float2* __restrict__ maj, const uint32_t* __restrict__ seeds,
                      const McsLanes L) {
  const int res = P.i[SI_RES];
  int ix, iy, stream;
  mcsp_pixel(res, ix, iy, stream);
  if (ix >= res || iy >= res) return;
  const int lane = (stream * res + iy) * res + ix;
  // the camera segment: its start, its direction seg * (1 / max(len,
  // 1e-30)) and its length, 0 for a ray that misses the cube
  const PixelRay pr = pixel_ray(P, ix, iy);
  const float segx = pr.xx - pr.ex, segy = pr.xy - pr.ey, segz = pr.xz - pr.ez;
  const float max_dist = pr.miss ? 0.0f : sqrtf(segx * segx + segy * segy + segz * segz);
  const float inv_md = __frcp_rn(nmax(max_dist, 1e-30f));
  const float rdx = segx * inv_md, rdy = segy * inv_md, rdz = segz * inv_md;
  const int He = P.i[SI_ENV_H], We = P.i[SI_ENV_W];
  const float3 view = sample_env_rgb(env, He, We, pr.vx, pr.vy, pr.vz);
  // a one-texel map whose channels are lerp_fixed: sample_env_rgb returns
  // its texel for every finite direction, whose fractions are then finite
  // (tests/test_torch_mcs_modes.py)
  const float3 texel = make_float3(__ldg(env), __ldg(env + 1), __ldg(env + 2));
  const bool one_texel = He == 1 && We == 1 && lerp_fixed(texel.x) && lerp_fixed(texel.y) &&
                         lerp_fixed(texel.z);
  // the chain's uv bits: (ix + 0.5) / R and (iy + s R + 0.5) / R
  const uint32_t ubits = __float_as_uint(__fdiv_rn((float)ix + 0.5f, (float)res));
  const float row = (float)iy + (float)stream * (float)res;
  const uint32_t vbits = __float_as_uint(__fdiv_rn(row + 0.5f, (float)res));
  const Recip ext = recip(P.f[SF_EXTINCTION]);

  bool shadow = L.phase[lane] != 0;
  float dist = L.dist[lane], trans = L.trans[lane];
  float sdx = L.sdx[lane], sdy = L.sdy[lane], sdz = L.sdz[lane], smax = L.smax[lane];
  float scx = L.scx[lane], scy = L.scy[lane], scz = L.scz[lane];
  float dr = L.dr[lane], dg = L.dg[lane], db = L.db[lane], da = L.da[lane];
  float4 acc = L.acc[lane];
  int samples = L.samples[lane];
  // the light of the shadow ray, which depends on its direction alone: taken
  // where the lane scatters, and here for a lane that starts in the shadow
  // phase (its stored direction may be any bits)
  float3 light = make_float3(0.0f, 0.0f, 0.0f);
  if (shadow) light = sample_env_rgb(env, He, We, sdx, sdy, sdz);
  const int steps = P.i[SI_STEPS];
  for (int k = 0; k < P.i[SI_N_FRAMES]; ++k) {
    uint32_t s = hash3(ubits, vbits, __ldg(seeds + k));
    for (int it = 0; it < steps; ++it) {
      // the segment: the camera ray (distance phase) or the shadow ray
      const float bx = shadow ? scx : pr.ex, by = shadow ? scy : pr.ey;
      const float bz = shadow ? scz : pr.ez;
      const float dx = shadow ? sdx : rdx, dy = shadow ? sdy : rdy, dz = shadow ? sdz : rdz;
      const float seg_max = shadow ? smax : max_dist;
      float m = 1.0f, step;
      bool capped = false;
      if (MAJ) {
        const float2 cell = majorant_row(maj, P, bx + dx * dist, by + dy * dist, bz + dz * dist);
        m = nmax(cell.x, 1e-12f);
        step = __fdiv_rn(-logf(draw(s)), m * P.f[SF_EXTINCTION]);
        capped = step >= cell.y;
        step = nmin(step, cell.y);
      } else {
        step = quot(-logf(draw(s)), ext);
      }
      const float dist2 = dist + step;
      const bool escaped = dist2 > seg_max;
      const float px = bx + dx * dist2, py = by + dy * dist2, pz = bz + dz * dist2;
      const bool tentative = !escaped && !capped;
      // the lookup only where its result is taken (no draw depends on it);
      // the TF's RGB only where the lane scatters
      float density = 0.0f, alpha = 0.0f;
      if (tentative) {
        density = mode_density<MODE>(vol, P, px, py, pz);
        const float w = mode_rgba<MODE>(tf, P, density).w;
        alpha = nmin(MAJ ? __fdiv_rn(w, m) : w, 1.0f);  // w / 1 exactly
      }
      bool scatter = false;
      if (!shadow) {
        const float wheel = draw(s);  // the acceptance uniform, distance phase only
        scatter = tentative && wheel < alpha;
      }
      // draw_sphere's two uniforms: every lane, every step
      const float u1 = draw(s);
      const float u2 = draw(s);
      if (escaped) {
        // a deposit: the view's environment, or the shaded collision
        // (dr * l.x * trans rounds as (dr * l.x) * trans)
        const float4 v = shadow ? make_float4(dr * light.x * trans, dg * light.y * trans,
                                              db * light.z * trans, da * trans)
                                : make_float4(view.x, view.y, view.z, 1.0f);
        samples += 1;
        const float n = (float)max(samples, 1);
        acc.x = acc.x + __fdiv_rn(v.x - acc.x, n);
        acc.y = acc.y + __fdiv_rn(v.y - acc.y, n);
        acc.z = acc.z + __fdiv_rn(v.z - acc.z, n);
        acc.w = acc.w + __fdiv_rn(v.w - acc.w, n);
        shadow = false;
        dist = 0.0f;
        trans = 1.0f;
      } else if (scatter) {
        // a real collision: a shadow ray from it along a uniform direction
        const float radius = sqrtf(u1);
        const float angle = u2 * kTwoPi;
        float sa, ca;
        sincosf(angle, &sa, &ca);
        const float ox = radius * ca, oy = radius * sa;
        const float norm = ox * ox + oy * oy;
        const float r2 = 2.0f * sqrtf(nmax(1.0f - norm, 0.0f));
        sdx = r2 * ox;
        sdy = r2 * oy;
        sdz = 1.0f - 2.0f * norm;
        smax = cube_exit(px, py, pz, sdx, sdy, sdz);
        scx = px;
        scy = py;
        scz = pz;
        const float4 c = mode_rgba<MODE>(tf, P, density);
        dr = c.x;
        dg = c.y;
        db = c.z;
        da = c.w;
        // the shadow ray's light (a drawn direction is finite)
        light = one_texel ? texel : sample_env_rgb(env, He, We, sdx, sdy, sdz);
        shadow = true;
        dist = 0.0f;
        trans = 1.0f;
      } else {
        if (shadow && tentative) trans = trans * (1.0f - alpha);  // ratio tracking
        dist = dist2;
      }
    }
  }
  L.phase[lane] = shadow ? 1 : 0;
  L.dist[lane] = dist;
  L.trans[lane] = trans;
  L.sdx[lane] = sdx;
  L.sdy[lane] = sdy;
  L.sdz[lane] = sdz;
  L.smax[lane] = smax;
  L.scx[lane] = scx;
  L.scy[lane] = scy;
  L.scz[lane] = scz;
  L.dr[lane] = dr;
  L.dg[lane] = dg;
  L.db[lane] = db;
  L.da[lane] = da;
  L.acc[lane] = acc;
  L.samples[lane] = samples;
}

template <bool MAJ>
int launch_frames(int mode, dim3 grid, cudaStream_t st, const McsParams& P, const void* vol,
                  const float* tf, const float* env, const float2* maj, const float4* inputs,
                  float4* acc, const int* frame) {
  switch (mode) {
#define VPT_MCS_MODE(M)                                                                       \
  case M:                                                                                     \
    mcs_frames_kernel<M, MAJ><<<grid, MCS_THREADS, 0, st>>>(P, vol, tf, env, maj, inputs, acc, \
                                                             frame);                          \
    break;
    VPT_MCS_MODE(MM_U8) VPT_MCS_MODE(MM_F32) VPT_MCS_MODE(MM_U8_QC)
    VPT_MCS_MODE(MM_F32_QC) VPT_MCS_MODE(MM_NEAREST) VPT_MCS_MODE(MM_GENERIC)
#undef VPT_MCS_MODE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <bool MAJ>
int launch_persistent(int mode, dim3 grid, cudaStream_t st, const McsParams& P, const void* vol,
                      const float* tf, const float* env, const float2* maj,
                      const uint32_t* seeds, const McsLanes& L) {
  switch (mode) {
#define VPT_MCSP_MODE(M)                                                                      \
  case M:                                                                                     \
    mcs_persistent_kernel<M, MAJ><<<grid, MCS_THREADS, 0, st>>>(P, vol, tf, env, maj, seeds, \
                                                                 L);                          \
    break;
    VPT_MCSP_MODE(MM_U8) VPT_MCSP_MODE(MM_F32) VPT_MCSP_MODE(MM_U8_QC)
    VPT_MCSP_MODE(MM_F32_QC) VPT_MCSP_MODE(MM_NEAREST) VPT_MCSP_MODE(MM_GENERIC)
#undef VPT_MCSP_MODE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

McsParams make_mcs_params(const float* fparams, const int* iparams) {
  McsParams P;
  for (int k = 0; k < SF_COUNT; ++k) P.f[k] = fparams[k];
  for (int k = 0; k < SI_COUNT; ++k) P.i[k] = iparams[k];
  return P;
}

}  // namespace

extern "C" {

int vpt_mcs_layout(int which) {
  switch (which) {
    case 0: return SF_COUNT;
    case 1: return SI_COUNT;
    default: return -1;
  }
}

// maj (Gz*Gy*Gx float2) may be null: exact mode. inputs: n_frames float4.
// The instance: SI_MODE (McsMode), and the majorant's presence.
int vpt_mcs_frames(const float* fparams, const int* iparams, const void* vol, const float* tf,
                   const float* env, const float* maj, const float* inputs, float* acc,
                   const int* frame, void* stream) {
  const McsParams P = make_mcs_params(fparams, iparams);
  const int res = P.i[SI_RES];
  if (res <= 0 || P.i[SI_N_FRAMES] <= 0) return 0;
  if (env == nullptr || P.i[SI_ENV_H] < 1 || P.i[SI_ENV_W] < 1 ||
      (maj != nullptr) != (P.i[SI_MAJ_GZ] > 0) ||
      (P.i[SI_NEAREST] != 0 && P.i[SI_VOL_RAW] == 0) || res > 46340)
    return (int)cudaErrorInvalidValue;
  const int mode = P.i[SI_MODE];
  if (mode < 0 || mode >= MM_COUNT) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((int64_t)blocks_for(res, MCSP_TILE_W) * blocks_for(res, MCSP_TILE_H)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* m = reinterpret_cast<const float2*>(maj);
  const float4* in = reinterpret_cast<const float4*>(inputs);
  float4* out = reinterpret_cast<float4*>(acc);
  if (m != nullptr) return launch_frames<true>(mode, grid, st, P, vol, tf, env, m, in, out, frame);
  return launch_frames<false>(mode, grid, st, P, vol, tf, env, m, in, out, frame);
}

// maj may be null: exact mode. seeds: n_frames (dispatches) uint32. The 16
// state arrays: S * R * R lanes each (acc S * R * R float4), updated in place.
// The instance: SI_MODE (McsMode), and the majorant's presence.
int vpt_mcs_persistent(const float* fparams, const int* iparams, const void* vol,
                       const float* tf, const float* env, const float* maj, const uint32_t* seeds,
                       uint8_t* phase, float* dist, float* trans, float* sdx, float* sdy,
                       float* sdz, float* smax, float* scx, float* scy, float* scz, float* dr,
                       float* dg, float* db, float* da, float* acc, int* samples, void* stream) {
  const McsParams P = make_mcs_params(fparams, iparams);
  const int res = P.i[SI_RES], streams = P.i[SI_STREAMS];
  if (res <= 0 || P.i[SI_N_FRAMES] <= 0 || P.i[SI_STEPS] <= 0) return 0;
  if (env == nullptr || P.i[SI_ENV_H] < 1 || P.i[SI_ENV_W] < 1 ||
      (maj != nullptr) != (P.i[SI_MAJ_GZ] > 0) ||
      (P.i[SI_NEAREST] != 0 && P.i[SI_VOL_RAW] == 0) || streams < 1 ||
      (int64_t)streams * res * res > 2147483647LL || (int64_t)streams * res > (1 << 23))
    return (int)cudaErrorInvalidValue;
  const int mode = P.i[SI_MODE];
  if (mode < 0 || mode >= MM_COUNT) return (int)cudaErrorInvalidValue;
  const McsLanes L{phase, dist, trans, sdx, sdy, sdz, smax, scx, scy, scz, dr, dg, db, da,
                   reinterpret_cast<float4*>(acc), samples};
  const int64_t tiles = (int64_t)blocks_for(res, MCSP_TILE_W) * blocks_for(res, MCSP_TILE_H);
  const dim3 grid((unsigned)(tiles * streams));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* m = reinterpret_cast<const float2*>(maj);
  if (m != nullptr) return launch_persistent<true>(mode, grid, st, P, vol, tf, env, m, seeds, L);
  return launch_persistent<false>(mode, grid, st, P, vol, tf, env, m, seeds, L);
}

}  // extern "C"
