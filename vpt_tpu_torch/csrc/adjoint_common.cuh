// Device code shared by the two backward sources: the vector atomics that
// add packed adjoint rows (spectral_backward.cu K5, surrogate.cu K12), the
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
