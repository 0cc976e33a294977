// Device code shared by the two backward sources: the vector atomics that
// add packed adjoint rows (spectral_backward.cu K5, surrogate.cu K12) and
// an escape's environment texels, the
// f64 block sum of the extinction score, and the surrogate tape's layout,
// which K4's surrogate mode (spectral_backward.cu) writes and K12 reads.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// adds an escape's environment texel terms into the packed (rows, 12)
// adjoint: g times the bilinear weights of (fx, fy), on channel `band` of
// the 4 corners (y0x0, y0x1, y1x0, y1x1) of row `row`; the other 8 entries
// take nothing. Miss lanes of neighbouring pixels escape towards the same
// texels, so the lanes of a warp that reach this together and share (row,
// band) first sum their 4 terms (a tree of shuffles over the peers that
// __match_any_sync finds), and one of them adds the sums with 4 scalar
// atomics. On an H100 80GB HBM3 (700 W), over the bench's env-lit
// stride-1 reverse, this took K5 from 0.81 to 0.52 ms and K12 from 0.98
// to 0.73 ms against every lane's 4 scalar atomics (3 float4 atomics of
// the whole row: 0.91 / 1.21; tools/env_scatter_probe.py).
__device__ __forceinline__ void add_env_texels(float* g_env, int64_t row, int band, float g,
                                               float fx, float fy) {
  float w[4] = {g * ((1 - fx) * (1 - fy)), g * (fx * (1 - fy)), g * ((1 - fx) * fy),
                g * (fx * fy)};
  const unsigned active = __activemask();
  const unsigned peers = __match_any_sync(active, (unsigned long long)row * 4 + band);
  const int lane = threadIdx.x & 31;
  const unsigned below = peers & ((1u << lane) - 1u);
  unsigned above = peers & (0xfffffffeu << lane);
  // round r: each remaining peer adds the next remaining one's sums; the
  // peers whose rank has bit r set are then consumed
  int rank = __popc(below);
  while (__any_sync(active, above)) {
    const int next = __ffs(above);  // 1 + the next peer's lane, 0 if none
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float t = __shfl_sync(active, w[k], next - 1);
      if (next) w[k] += t;
    }
    above &= __ballot_sync(active, !(rank & 1));
    rank >>= 1;
  }
  if (below == 0) {
    float* p = g_env + row * 12 + band;
    atomicAdd(p, w[0]);
    atomicAdd(p + 3, w[1]);
    atomicAdd(p + 6, w[2]);
    atomicAdd(p + 9, w[3]);
  }
}

// block sum of one value per thread of a THREADS-thread block, added to
// *out with one atomic; in f64, so the order in which the blocks' atomics
// land moves the sum by f64 rounding only (an f32 sum over 8192 blocks
// moved it by up to ~3e-6). Every thread of the block must call it.
template <int THREADS>
__device__ __forceinline__ void block_add(double v, double* out) {
  __shared__ double warp_sums[THREADS / 32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = warp_sums[0];
    for (int w = 1; w < THREADS / 32; ++w) t += warp_sums[w];
    atomicAdd(out, t);
  }
}

// PRB tape fields, mirrored by TAPE_FIELDS in kernels/spectral_backward.py:
// written by K4 (spectral_backward.cu) and by K28's TAPE mode (slab.cu),
// read by K5
enum TapeField {
  T_EMITTED = 0, T_RESPAWN, T_PRE_BIN, T_ALPHA, T_ALBEDO, T_G, T_HG_COS,
  T_NULL, T_SCATTER, T_FX,                       // always
  T_DIST,                                        // extinction
  T_TF_ROW, T_FY, T_LIGHT_W,                     // material_tf / light
  T_SLOPE0, T_SLOPE1, T_SLOPE2, T_VOL_ROW0, T_VFX, T_VFY, T_VFZ,  // density
  T_VOL_ROW1,                                    // density, xy volume
  T_ENV_ROW, T_ENV_FX, T_ENV_FY, T_ENV_BAND, T_ENV_W,  // environment
  T_COUNT,
};

// each field's element offset within a step's tape rows (slot x lanes),
// -1 for a field the tape does not hold
struct TapeSpec {
  int n_fields;
  long long off[T_COUNT];
};

inline TapeSpec make_tape_spec(const int* slots, int n_fields, int n_lanes) {
  TapeSpec T;
  T.n_fields = n_fields;
  for (int k = 0; k < T_COUNT; ++k) T.off[k] = slots[k] < 0 ? -1 : (long long)slots[k] * n_lanes;
  return T;
}

// one tape value of this lane (`row` points at the lane's slot 0 of the
// step), written with an evict-first store
__device__ __forceinline__ void put(float* row, const TapeSpec& T, int field, float v) {
  const long long o = T.off[field];
  if (o >= 0) __stcs(row + o, v);
}

// surrogate tape fields, mirrored by SUR_FIELDS in kernels/surrogate.py;
// S_MAJ only in majorant mode
enum SurField {
  S_FLAGS = 0, S_DIST, S_DX, S_DY, S_DZ, S_RNG, S_PX, S_PY, S_PZ, S_LAM, S_MAJ,
  S_COUNT,
};
// bits of S_FLAGS; bits 8.. hold the pre-step bin
enum SurFlag { SF_RESPAWN = 1, SF_OOB = 2, SF_NULL = 4, SF_SCATTER = 8, SF_CAPPED = 16 };

// each surrogate field's element offset within a step's tape rows
// (slot x lanes, -1 when absent), computed once per launch on the host
struct SurSpec {
  int n_fields;
  long long off[S_COUNT];
};

inline SurSpec make_sur_spec(const int* slots, int n_fields, int n_lanes) {
  SurSpec T;
  T.n_fields = n_fields;
  for (int k = 0; k < S_COUNT; ++k) T.off[k] = slots[k] < 0 ? -1 : (long long)slots[k] * n_lanes;
  return T;
}

}  // namespace
