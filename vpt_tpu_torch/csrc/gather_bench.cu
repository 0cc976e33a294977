// Gather kernels of the gather tool for Hopper (sm_90a), plain C interface.
//
// What each function replaces (TPU kernels, by file and line):
//   gather_scalar    out[i] = flat[idx[i]]: tools/gather_bench.py:54
//                    pallas_gather_scalar, a scalar gather from an 8 MB
//                    table held whole in VMEM.
//   gather_lanewise  out[m, l] = tab[idx[m, l], l] for a (N, 128) table:
//                    tools/gather_bench.py:75 pallas_gather_lanewise,
//                    tools/gather_bench2.py:76 mk_lanewise and
//                    tools/gather_bench3.py:38 mk_dg, the same lane-wise
//                    take_along_axis at N = 8 ... 32768 and two block shapes.
//
// What bounds them on this card. Every lookup streams a 4-byte index in and
// a 4-byte output out: 8 bytes of HBM traffic, 40 us for 16M lookups at
// 3.35 TB/s. The table read is random. No block's shared memory (227 KB)
// holds the 8 MB scalar table, and even a 16-block cluster's distributed
// shared memory (~3.6 MB) does not, so the fast memory that plays VMEM's
// part is the 50 MB L2, and each random 4-byte read moves a 32-byte L2
// sector: four times the streams' bytes, through L2.
//
// The L2 design (gather_scalar, and gather_lanewise when no slab of >= 16
// lanes fits in shared memory, N = 32768). A thread owns 8 outputs, as two
// runs of 4 that lie 128 outputs apart, so that each of its two 16-byte
// index loads and two float4 stores is one 512-byte contiguous access per
// warp (8 consecutive outputs per thread would split every warp access into
// half-used sectors: 149 against 142 us at 16M lookups on the H100). It
// starts all 8 table loads before it uses one: 8 random reads in flight per
// thread. Table loads carry an L2 evict_last policy (createpolicy +
// ld.global.nc.L2::cache_hint); index loads and output stores are
// evict-first (ld/st .cs), so the streams pass through L2 without pushing
// the table out. The n % 256 outputs of a last, partial tile go one per
// thread. The lane-wise form adds the output's lane to the row offset. The
// grid covers the work in one pass; a persistent grid (SMs x resident
// blocks, striding) measured 1-2 us slower at 16M lookups. Measured on the
// H100, neither the 8 reads in flight nor the cache policies move this
// kernel: one thread per output without hints runs 2% faster. It is bound
// by the rate at which L2 serves random 32-byte sectors (~120 G lookups/s).
//
// The shared-memory design (gather_lanewise, N <= 3631). Laid out row-major
// with a row width W that is a multiple of 32 floats, tab[n][l] lies in
// bank l mod 32 for every n, so a warp whose 32 threads take 32 consecutive
// lanes reads 32 distinct banks whatever its indices: the lane-wise gather
// is conflict-free from shared memory, as the TPU's per-lane sublane gather
// was. A thread keeps one lane and walks rows, 8 rows in flight and the next
// 8 rows' indices loading; a thread that owned 4 consecutive lanes would put
// threads t and t + 8 on one bank. The host plan
// (vpt_tpu_torch/tools/gather_bench.py::lanewise_plan) takes the widest slab
// of lanes whose N rows fit in a block: the whole table (W = 128, N <= 453:
// N = 8 and 256), 32-lane slabs (N <= 1815: 128 KB at N = 1024) or 16-lane
// slabs (N <= 3631: 128 KB at N = 2048). A 16-lane slab puts two rows in a
// warp, so two of its threads can meet on one bank (2-way conflicts). That
// was chosen over a 2-block cluster sharing one 32-lane slab through
// distributed shared memory: a conflicted shared load still serves ~16
// lookups a clock per SM, several times the HBM stream rate, whereas the
// cluster would make half of all reads remote ones, each with a remote
// round trip.
//
// Staging. Each block stages its slab once, by TMA: cp.async.bulk copies
// from global to shared memory that complete on one mbarrier (transaction
// bytes), one copy per table row of a slab (64 or 128 bytes, 16-byte
// aligned) or 4 KB pieces of the contiguous whole table. Every thread of
// the block starts some of the copies, then loads its first indices while
// the copies land, then waits on the barrier. Staging costs blocks x slab
// bytes of L2 reads (up to 17 MB for 132 blocks of 128 KB). The plan fills
// the card with one wave of blocks and splits the rows evenly among them:
// at 1M lookups that beat giving each block at least as many streamed bytes
// as it stages (half the blocks) by 15-20% on the H100.
//
// Indices must lie in the table; the callers make them so. The wrappers
// check 16-byte alignment of the indices and of gather_lanewise's table;
// outputs come from PyTorch's allocator, which aligns them further.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L2_THREADS = 256;
constexpr int LW_THREADS = 512;     // gather_bench.py SMEM_THREADS
constexpr int LW_UNROLL = 8;        // rows in flight per thread
constexpr int LW_BARRIER = 16;      // bytes after the slab for the mbarrier
constexpr uint32_t WHOLE_CHUNK = 4096;  // bytes per bulk copy of a whole table
constexpr int MAX_DEVICES = 64;

// ---------------------------------------------------------------- L2 design

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ float ld_keep(const float* p, uint64_t policy) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(p), "l"(policy));
  return v;
}

// table offset of output i whose index is row
template <bool LANEWISE>
__device__ __forceinline__ int64_t offset(int row, int64_t i) {
  return LANEWISE ? (int64_t)row * 128 + (i & 127) : (int64_t)row;
}

// Outputs go in tiles of 256. Thread slot v (tile v / 32, lane v % 32) owns
// two runs of 4 outputs, int4 units p0 = 64 (v / 32) + v % 32 and p0 + 32,
// so each warp-wide 16-byte index load and float4 store covers 512
// contiguous bytes. The n % 256 outputs of the last, partial tile go one per
// thread.
template <bool LANEWISE>
__global__ void __launch_bounds__(L2_THREADS)
gather_l2_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                 float* __restrict__ out, int64_t n) {
  const uint64_t keep = evict_last_policy();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t slots = (n >> 8) << 5;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  float4* out4 = reinterpret_cast<float4*>(out);
  for (int64_t v = t; v < slots; v += stride) {
    const int64_t p0 = ((v >> 5) << 6) + (v & 31), p1 = p0 + 32;
    const int4 a = __ldcs(idx4 + p0);
    const int4 b = __ldcs(idx4 + p1);
    const int64_t i = 4 * p0, j = 4 * p1;
    const float r0 = ld_keep(tab + offset<LANEWISE>(a.x, i), keep);
    const float r1 = ld_keep(tab + offset<LANEWISE>(a.y, i + 1), keep);
    const float r2 = ld_keep(tab + offset<LANEWISE>(a.z, i + 2), keep);
    const float r3 = ld_keep(tab + offset<LANEWISE>(a.w, i + 3), keep);
    const float r4 = ld_keep(tab + offset<LANEWISE>(b.x, j), keep);
    const float r5 = ld_keep(tab + offset<LANEWISE>(b.y, j + 1), keep);
    const float r6 = ld_keep(tab + offset<LANEWISE>(b.z, j + 2), keep);
    const float r7 = ld_keep(tab + offset<LANEWISE>(b.w, j + 3), keep);
    __stcs(out4 + p0, make_float4(r0, r1, r2, r3));
    __stcs(out4 + p1, make_float4(r4, r5, r6, r7));
  }
  for (int64_t i = ((n >> 8) << 8) + t; i < n; i += stride)
    __stcs(out + i, ld_keep(tab + offset<LANEWISE>(__ldcs(idx + i), i), keep));
}

// ------------------------------------------------------ shared-memory design

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                              uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Block (x, y) stages lanes [y W, y W + W) of all n_tab rows and gathers
// rows [x rows_per_block, ...) of those lanes.
template <int W>
__global__ void __launch_bounds__(LW_THREADS)
gather_lanewise_smem_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                            float* __restrict__ out, int64_t m_rows, int n_tab,
                            int rows_per_block) {
  constexpr int P = LW_THREADS / W;  // rows one pass of the block covers
  extern __shared__ __align__(128) unsigned char smem[];
  const float* slab = reinterpret_cast<const float*>(smem);
  const uint32_t slab_bytes = (uint32_t)n_tab * W * 4;
  const uint32_t bar = smem_addr(smem + slab_bytes);
  const int lane0 = blockIdx.y * W;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_arrive_expect_tx(bar, slab_bytes);  // before any copy can complete
  }
  __syncthreads();
  if constexpr (W == 128) {  // the whole table, one contiguous run
    for (uint32_t off = threadIdx.x * WHOLE_CHUNK; off < slab_bytes; off += LW_THREADS * WHOLE_CHUNK)
      bulk_copy_g2s(smem_addr(smem + off), reinterpret_cast<const unsigned char*>(tab) + off,
                    slab_bytes - off < WHOLE_CHUNK ? slab_bytes - off : WHOLE_CHUNK, bar);
  } else {  // one copy per table row of the slab
    for (int r = threadIdx.x; r < n_tab; r += LW_THREADS)
      bulk_copy_g2s(smem_addr(smem + (size_t)r * W * 4), tab + (int64_t)r * 128 + lane0, W * 4, bar);
  }

  const int l = threadIdx.x % W;
  const int64_t col = lane0 + l;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < m_rows ? r0 + rows_per_block : m_rows;
  int64_t m = r0 + threadIdx.x / W;
  int cur[LW_UNROLL];
#pragma unroll
  for (int k = 0; k < LW_UNROLL; ++k) {
    const int64_t mk = m + (int64_t)k * P;
    cur[k] = mk < r1 ? __ldcs(idx + mk * 128 + col) : 0;
  }
  mbar_wait(bar, 0);
  for (; m < r1; m += (int64_t)LW_UNROLL * P) {
    int nxt[LW_UNROLL];
#pragma unroll
    for (int k = 0; k < LW_UNROLL; ++k) {
      const int64_t mk = m + (int64_t)(LW_UNROLL + k) * P;
      nxt[k] = mk < r1 ? __ldcs(idx + mk * 128 + col) : 0;
    }
#pragma unroll
    for (int k = 0; k < LW_UNROLL; ++k) {
      const int64_t mk = m + (int64_t)k * P;
      if (mk < r1) __stcs(out + mk * 128 + col, slab[cur[k] * W + l]);
    }
#pragma unroll
    for (int k = 0; k < LW_UNROLL; ++k) cur[k] = nxt[k];
  }
}

// ------------------------------------------------------------------- host

struct DeviceLimits {
  bool known;
  int sms, smem_optin;
};
DeviceLimits g_limits[MAX_DEVICES];

// Queried, and the kernels' shared-memory limit raised, once per device: on
// the first call, which the wrappers make before any graph capture.
cudaError_t device_limits(const DeviceLimits** out) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  DeviceLimits& d = g_limits[dev];
  if (!d.known) {
    if ((e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev))) return e;
    if ((e = cudaDeviceGetAttribute(&d.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
      return e;
    const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
    if ((e = cudaFuncSetAttribute(gather_lanewise_smem_kernel<128>, a, d.smem_optin))) return e;
    if ((e = cudaFuncSetAttribute(gather_lanewise_smem_kernel<32>, a, d.smem_optin))) return e;
    if ((e = cudaFuncSetAttribute(gather_lanewise_smem_kernel<16>, a, d.smem_optin))) return e;
    d.known = true;
  }
  *out = &d;
  return cudaSuccess;
}

// One pass: a thread per slot (at least one block, for the tail alone).
template <bool LANEWISE>
void launch_l2(const float* tab, const int* idx, float* out, int64_t n, cudaStream_t stream) {
  const int64_t blocks = (((n >> 8) << 5) + L2_THREADS - 1) / L2_THREADS;
  gather_l2_kernel<LANEWISE><<<blocks < 1 ? 1 : (unsigned)blocks, L2_THREADS, 0, stream>>>(
      tab, idx, out, n);
}

}  // namespace

extern "C" {

// out[0] = SM count, out[1] = opt-in shared memory per block (bytes)
int vpt_gather_limits(int* out) {
  const DeviceLimits* d;
  const cudaError_t e = device_limits(&d);
  if (e != cudaSuccess) return (int)e;
  out[0] = d->sms;
  out[1] = d->smem_optin;
  return 0;
}

int vpt_gather_scalar(const float* flat, const int* idx, float* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  launch_l2<false>(flat, idx, out, n, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// slab 0: the L2 design; 128, 32 or 16: the shared-memory design with that
// many lanes per slab, grid (blocks_per_slab, 128 / slab), smem bytes each.
int vpt_gather_lanewise(const float* tab, const int* idx, float* out, int64_t m_rows, int n_tab,
                        int slab, int blocks_per_slab, int rows_per_block, int smem,
                        void* stream) {
  if (m_rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slab == 0) {
    launch_l2<true>(tab, idx, out, m_rows * 128, s);
    return (int)cudaGetLastError();
  }
  const DeviceLimits* d;
  const cudaError_t e = device_limits(&d);
  if (e != cudaSuccess) return (int)e;
  if (n_tab <= 0 || blocks_per_slab <= 0 || rows_per_block <= 0 ||
      (int64_t)blocks_per_slab * rows_per_block < m_rows ||
      (int64_t)smem < (int64_t)n_tab * slab * 4 + LW_BARRIER)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_per_slab, 128 / slab);
  switch (slab) {
    case 128:
      gather_lanewise_smem_kernel<128><<<grid, LW_THREADS, smem, s>>>(tab, idx, out, m_rows, n_tab,
                                                                      rows_per_block);
      break;
    case 32:
      gather_lanewise_smem_kernel<32><<<grid, LW_THREADS, smem, s>>>(tab, idx, out, m_rows, n_tab,
                                                                     rows_per_block);
      break;
    case 16:
      gather_lanewise_smem_kernel<16><<<grid, LW_THREADS, smem, s>>>(tab, idx, out, m_rows, n_tab,
                                                                     rows_per_block);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
