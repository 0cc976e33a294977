// Gather microbenchmark kernels for Hopper (sm_90a), plain C interface.
//
//   gather_scalar    out[i] = flat[idx[i]]: replaces the TPU kernel
//                    tools/gather_bench.py:54 pallas_gather_scalar (a scalar
//                    gather from a table held whole in VMEM).
//   gather_lanewise  out[m, l] = tab[idx[m, l], l] for a (N, 128) table:
//                    replaces tools/gather_bench.py:75 pallas_gather_lanewise,
//                    tools/gather_bench2.py:76 mk_lanewise and
//                    tools/gather_bench3.py:38 mk_dg (the same lane-wise
//                    take_along_axis at several N and block shapes).
//
// What bounds them on this card: one 4-byte random load and one coalesced
// 4-byte store per output, plus the coalesced 4-byte index load. On the TPU
// the table had to fit in VMEM; here the 50 MB L2 plays that part: the 8 MB
// scalar table and every lane-wise table up to N = 32768 (16 MB) stay
// L2-resident, so the rate is set by L2 sector traffic (a 32-byte sector per
// random 4-byte load) rather than by HBM. One thread per output, no shared
// memory: the simple form, and the yardstick for the random row accesses of
// the render and backward kernels. Indices must lie in the table; the
// wrapper's callers generate them so.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256)
gather_scalar_kernel(const float* __restrict__ flat, const int* __restrict__ idx,
                     float* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = __ldg(flat + idx[i]);
}

__global__ void __launch_bounds__(256)
gather_lanewise_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                       float* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t l = i & 127;
  out[i] = __ldg(tab + (int64_t)idx[i] * 128 + l);
}

inline unsigned blocks_for(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

int vpt_gather_scalar(const float* flat, const int* idx, float* out, int64_t n,
                      void* stream) {
  if (n <= 0) return 0;
  gather_scalar_kernel<<<blocks_for(n, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      flat, idx, out, n);
  return (int)cudaGetLastError();
}

int vpt_gather_lanewise(const float* tab, const int* idx, float* out, int64_t n,
                        void* stream) {
  if (n <= 0) return 0;
  gather_lanewise_kernel<<<blocks_for(n, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      tab, idx, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
