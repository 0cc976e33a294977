// Corner-packing kernels for Hopper (sm_90a), plain C interface: the pack
// of learned raw tables and its transpose, the contraction of packed
// adjoints back to the raw tables.
//
//   contract_corners (K9)  replaces vpt_tpu/kernels/spectral_backward.py
//                          ::_contract_packed_adjoints (:355-397), the
//                          jax.vjp of ops/interp.py::pack_volume_corners_jnp,
//                          pack_volume_corners_xy_jnp, pack_tex2d_corners_jnp
//                          and pack_tex1d_corners_jnp (:269-316): packed
//                          volume adjoint (full or xy) -> density gradient;
//                          fused TF+light adjoint -> material_tf and
//                          light_spectrum gradients; packed (12-wide)
//                          environment adjoint -> environment gradient.
//   pack_corners (K10)     replaces the re-pack of learned raw tables in
//                          vpt_tpu/optim.py::_pack_params_into_ctx (:185-236):
//                          pack_volume_corners_jnp, pack_volume_corners_xy_jnp,
//                          pack_tex2d_with_tex1d_jnp and the environment's
//                          pack_tex2d_corners_jnp.
//
// The packing (ops/interp.py): a raw axis of n cells, edge-padded to n + 2,
// gives n + 1 packed indices i; corner bit b of packed index i holds raw
// cell clamp(i + b - 1, 0, n - 1). A volume row (z, y, x) holds its 8
// corners (bit2 = z, bit1 = y, bit0 = x); an xy volume row (z, y, x) holds
// the 4 corners (bit1 = y, bit0 = x) of its z plane, whose axis is not
// padded; a fused TF row (y, x) holds 4 corners (y0x0, y0x1, y1x0, y1x1) x
// 4 channels and the light pair of column x, the same for every row y; an
// environment row (y, x) the same 4 corners x 3 channels.
//
// The transpose is a gather, one thread per raw cell, with no atomics: raw
// index a of an axis is held by the packed (i, b) pairs, in ascending
// order, (0, 0) if a == 0; (a, 1); (a + 1, 0); (n, 1) if a == n - 1. An
// interior voxel sums its 8 entries, a voxel on the edge of the padding up
// to 27 (64 where an axis has one cell), z slot outermost, x innermost,
// into one f32 sum that starts at 0. A TF texel does the same over its
// 2-D slots for each of its 4 channels. A light texel first sums its
// packed column's pair entry over all TF rows, in row order (the light
// pair was broadcast over the rows), then its 1-D slots. An xy voxel sums
// the 2-D slots of its plane, an environment texel those of each of its 3
// channels. The plain
// versions (kernels/corners.py) add the same terms in the same order, so
// kernel and plain version agree bit for bit and every run gives the same
// bits.
//
// The pack is one thread per packed row: its clamped raw neighbours read
// (from the L2: the raw tables are 1/8 of the packed ones), its row written
// as two float4 (volume), one float4 (xy volume), three float4 (12-wide
// environment) or nine float2 (18-wide TF) stores.
//
// What bounds them on this card: bytes. At the bench shape (128^3 density,
// 129^3 x 8 f32 packed rows) each moves the 68.7 MB packed volume once and
// the 8.4 MB raw volume once: 77 MB, 0.023 ms at 3.35 TB/s. A transpose
// thread's 8 loads are 4-byte reads from 8 different 32-byte rows; the
// neighbouring threads of a warp read the neighbouring rows, so each
// sector comes from the L2 once per (y, z) corner pair rather than once in
// all, and the L2, not the HBM, may set the pace. The TF tables are small
// (257 x 257 x 18 f32, 4.8 MB); the light texels' row sums run 257 adds in
// a chain each, 256 threads in all.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// slot s (0..3) of raw index a on an axis of n cells: whether it exists,
// its packed index and its corner bit (see the header)
__device__ __forceinline__ bool slot_valid(int s, int a, int n) {
  return s == 0 ? a == 0 : (s == 3 ? a == n - 1 : true);
}
__device__ __forceinline__ int slot_index(int s, int a, int n) {
  return s == 0 ? 0 : (s == 1 ? a : (s == 2 ? a + 1 : n));
}

__device__ __forceinline__ int clamp_cell(int i, int n) { return min(max(i, 0), n - 1); }

__global__ void __launch_bounds__(256)
contract_volume_kernel(const float* __restrict__ g, float* __restrict__ out, int D, int H,
                       int W) {
  const int64_t cell = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= (int64_t)D * H * W) return;
  const int x = (int)(cell % W);
  const int64_t zy = cell / W;
  const int y = (int)(zy % H), z = (int)(zy / H);
  const int64_t Hp = H + 1, Wp = W + 1;
  float acc = 0.0f;
#pragma unroll
  for (int sz = 0; sz < 4; ++sz) {
    if (!slot_valid(sz, z, D)) continue;
    const int64_t iz = slot_index(sz, z, D);
#pragma unroll
    for (int sy = 0; sy < 4; ++sy) {
      if (!slot_valid(sy, y, H)) continue;
      const int64_t iy = slot_index(sy, y, H);
#pragma unroll
      for (int sx = 0; sx < 4; ++sx) {
        if (!slot_valid(sx, x, W)) continue;
        const int64_t ix = slot_index(sx, x, W);
        const int k = (sz & 1) * 4 + (sy & 1) * 2 + (sx & 1);
        acc = acc + __ldg(g + ((iz * Hp + iy) * Wp + ix) * 8 + k);
      }
    }
  }
  out[cell] = acc;
}

// blocks [0, tf_blocks): one thread per TF texel (4 channels), into g_mtf;
// the blocks after: one thread per light texel, into g_light
__global__ void __launch_bounds__(256)
contract_tf_kernel(const float* __restrict__ g, float* __restrict__ g_mtf,
                   float* __restrict__ g_light, int TH, int TW, int tf_blocks) {
  const int Hp = TH + 1, Wp = TW + 1;
  if ((int)blockIdx.x < tf_blocks) {
    const int texel = blockIdx.x * blockDim.x + threadIdx.x;
    if (texel >= TH * TW) return;
    const int x = texel % TW, y = texel / TW;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int sy = 0; sy < 4; ++sy) {
      if (!slot_valid(sy, y, TH)) continue;
      const int iy = slot_index(sy, y, TH);
#pragma unroll
      for (int sx = 0; sx < 4; ++sx) {
        if (!slot_valid(sx, x, TW)) continue;
        const int ix = slot_index(sx, x, TW);
        const int corner = (sy & 1) * 2 + (sx & 1);
        // an 18-wide row starts at a multiple of 72 B, a corner at 16 B: 8-byte aligned
        const float* p = g + ((int64_t)iy * Wp + ix) * 18 + 4 * corner;
        const float2 a = __ldg(reinterpret_cast<const float2*>(p));
        const float2 b = __ldg(reinterpret_cast<const float2*>(p + 2));
        acc[0] = acc[0] + a.x;
        acc[1] = acc[1] + a.y;
        acc[2] = acc[2] + b.x;
        acc[3] = acc[3] + b.y;
      }
    }
    reinterpret_cast<float4*>(g_mtf)[texel] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    return;
  }
  const int x = (blockIdx.x - tf_blocks) * blockDim.x + threadIdx.x;
  if (x >= TW) return;
  float acc = 0.0f;
#pragma unroll
  for (int sx = 0; sx < 4; ++sx) {
    if (!slot_valid(sx, x, TW)) continue;
    const float* p = g + (int64_t)slot_index(sx, x, TW) * 18 + 16 + (sx & 1);
    float rows = 0.0f;
#pragma unroll 32
    for (int y = 0; y < Hp; ++y) rows = rows + __ldg(p + (int64_t)y * Wp * 18);
    acc = acc + rows;
  }
  g_light[x] = acc;
}

// one thread per raw voxel of an xy table's adjoint ((D, H+1, W+1) x 4)
__global__ void __launch_bounds__(256)
contract_volume_xy_kernel(const float* __restrict__ g, float* __restrict__ out, int D, int H,
                          int W) {
  const int64_t cell = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= (int64_t)D * H * W) return;
  const int x = (int)(cell % W);
  const int64_t zy = cell / W;
  const int y = (int)(zy % H);
  const int64_t z = zy / H;
  const int64_t Hp = H + 1, Wp = W + 1;
  float acc = 0.0f;
#pragma unroll
  for (int sy = 0; sy < 4; ++sy) {
    if (!slot_valid(sy, y, H)) continue;
    const int64_t iy = slot_index(sy, y, H);
#pragma unroll
    for (int sx = 0; sx < 4; ++sx) {
      if (!slot_valid(sx, x, W)) continue;
      const int64_t ix = slot_index(sx, x, W);
      acc = acc + __ldg(g + ((z * Hp + iy) * Wp + ix) * 4 + (sy & 1) * 2 + (sx & 1));
    }
  }
  out[cell] = acc;
}

// one thread per texel of a (TH, TW, 3) environment map, from its packed
// (TH+1, TW+1, 12) adjoint
__global__ void __launch_bounds__(256)
contract_env_kernel(const float* __restrict__ g, float* __restrict__ out, int TH, int TW) {
  const int texel = blockIdx.x * blockDim.x + threadIdx.x;
  if (texel >= TH * TW) return;
  const int x = texel % TW, y = texel / TW;
  const int Wp = TW + 1;
  float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int sy = 0; sy < 4; ++sy) {
    if (!slot_valid(sy, y, TH)) continue;
    const int iy = slot_index(sy, y, TH);
#pragma unroll
    for (int sx = 0; sx < 4; ++sx) {
      if (!slot_valid(sx, x, TW)) continue;
      const int ix = slot_index(sx, x, TW);
      const float* p = g + ((int64_t)iy * Wp + ix) * 12 + 3 * ((sy & 1) * 2 + (sx & 1));
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[c] = acc[c] + __ldg(p + c);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) out[(int64_t)texel * 3 + c] = acc[c];
}

__global__ void __launch_bounds__(256)
pack_volume_kernel(const float* __restrict__ d, float* __restrict__ out, int D, int H, int W) {
  const int64_t Hp = H + 1, Wp = W + 1;
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= (D + 1) * Hp * Wp) return;
  const int x = (int)(row % Wp);
  const int64_t zy = row / Wp;
  const int y = (int)(zy % Hp), z = (int)(zy / Hp);
  const int64_t z0 = clamp_cell(z - 1, D), z1 = clamp_cell(z, D);
  const int64_t y0 = clamp_cell(y - 1, H), y1 = clamp_cell(y, H);
  const int64_t x0 = clamp_cell(x - 1, W), x1 = clamp_cell(x, W);
  const float* p00 = d + (z0 * H + y0) * W;
  const float* p01 = d + (z0 * H + y1) * W;
  const float* p10 = d + (z1 * H + y0) * W;
  const float* p11 = d + (z1 * H + y1) * W;
  float4* o = reinterpret_cast<float4*>(out + row * 8);
  o[0] = make_float4(__ldg(p00 + x0), __ldg(p00 + x1), __ldg(p01 + x0), __ldg(p01 + x1));
  o[1] = make_float4(__ldg(p10 + x0), __ldg(p10 + x1), __ldg(p11 + x0), __ldg(p11 + x1));
}

// one thread per xy row (z, y, x): the 4 xy corners of plane z
__global__ void __launch_bounds__(256)
pack_volume_xy_kernel(const float* __restrict__ d, float* __restrict__ out, int D, int H,
                      int W) {
  const int64_t Hp = H + 1, Wp = W + 1;
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= D * Hp * Wp) return;
  const int x = (int)(row % Wp);
  const int64_t zy = row / Wp;
  const int y = (int)(zy % Hp);
  const int64_t z = zy / Hp;
  const int64_t y0 = clamp_cell(y - 1, H), y1 = clamp_cell(y, H);
  const int64_t x0 = clamp_cell(x - 1, W), x1 = clamp_cell(x, W);
  const float* p0 = d + (z * H + y0) * W;
  const float* p1 = d + (z * H + y1) * W;
  reinterpret_cast<float4*>(out)[row] =
      make_float4(__ldg(p0 + x0), __ldg(p0 + x1), __ldg(p1 + x0), __ldg(p1 + x1));
}

// one thread per packed environment row (y, x): 4 corners x 3 channels
__global__ void __launch_bounds__(256)
pack_env_kernel(const float* __restrict__ e, float* __restrict__ out, int TH, int TW) {
  const int Wp = TW + 1;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= (TH + 1) * Wp) return;
  const int x = row % Wp, y = row / Wp;
  const int y0 = clamp_cell(y - 1, TH), y1 = clamp_cell(y, TH);
  const int x0 = clamp_cell(x - 1, TW), x1 = clamp_cell(x, TW);
  const float* c[4] = {e + ((int64_t)y0 * TW + x0) * 3, e + ((int64_t)y0 * TW + x1) * 3,
                       e + ((int64_t)y1 * TW + x0) * 3, e + ((int64_t)y1 * TW + x1) * 3};
  float v[12];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) v[3 * k + ch] = __ldg(c[k] + ch);
  // a 12-wide row is 48 B: three 16-byte-aligned float4 stores
  float4* o = reinterpret_cast<float4*>(out + (int64_t)row * 12);
  o[0] = make_float4(v[0], v[1], v[2], v[3]);
  o[1] = make_float4(v[4], v[5], v[6], v[7]);
  o[2] = make_float4(v[8], v[9], v[10], v[11]);
}

// one thread per fused row (y, x); rows y == 0 also write the light pair
// of column x into `pairs` when given
__global__ void __launch_bounds__(256)
pack_tf_kernel(const float* __restrict__ mtf, const float* __restrict__ light,
               float* __restrict__ out, float* __restrict__ pairs, int TH, int TW) {
  const int Wp = TW + 1;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= (TH + 1) * Wp) return;
  const int x = row % Wp, y = row / Wp;
  const int y0 = clamp_cell(y - 1, TH), y1 = clamp_cell(y, TH);
  const int x0 = clamp_cell(x - 1, TW), x1 = clamp_cell(x, TW);
  const float4* t = reinterpret_cast<const float4*>(mtf);
  const float4 c[4] = {__ldg(t + (int64_t)y0 * TW + x0), __ldg(t + (int64_t)y0 * TW + x1),
                       __ldg(t + (int64_t)y1 * TW + x0), __ldg(t + (int64_t)y1 * TW + x1)};
  const float2 l = make_float2(__ldg(light + x0), __ldg(light + x1));
  float2* o = reinterpret_cast<float2*>(out + (int64_t)row * 18);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    o[2 * k] = make_float2(c[k].x, c[k].y);
    o[2 * k + 1] = make_float2(c[k].z, c[k].w);
  }
  o[8] = l;
  if (pairs != nullptr && y == 0) reinterpret_cast<float2*>(pairs)[x] = l;
}

inline unsigned blocks_of(int64_t n, int threads) { return (unsigned)((n + threads - 1) / threads); }

}  // namespace

extern "C" {

// g_packed: ((D+1)(H+1)(W+1), 8); g_raw: (D, H, W)
int vpt_contract_volume(const float* g_packed, float* g_raw, int D, int H, int W,
                        void* stream) {
  const int64_t n = (int64_t)D * H * W;
  if (D < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  contract_volume_kernel<<<blocks_of(n, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      g_packed, g_raw, D, H, W);
  return (int)cudaGetLastError();
}

// g_tf: ((TH+1)(TW+1), 18); g_mtf: (TH, TW, 4) or null; g_light: (TW,) or null
int vpt_contract_tf(const float* g_tf, float* g_mtf, float* g_light, int TH, int TW,
                    void* stream) {
  if (TH < 1 || TW < 1 || (g_mtf == nullptr && g_light == nullptr))
    return (int)cudaErrorInvalidValue;
  const int tf_blocks = g_mtf != nullptr ? (int)blocks_of((int64_t)TH * TW, 256) : 0;
  const int light_blocks = g_light != nullptr ? (int)blocks_of(TW, 256) : 0;
  contract_tf_kernel<<<tf_blocks + light_blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      g_tf, g_mtf, g_light, TH, TW, tf_blocks);
  return (int)cudaGetLastError();
}

// g_packed: (D(H+1)(W+1), 4), an xy table's adjoint; g_raw: (D, H, W)
int vpt_contract_volume_xy(const float* g_packed, float* g_raw, int D, int H, int W,
                           void* stream) {
  const int64_t n = (int64_t)D * H * W;
  if (D < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  contract_volume_xy_kernel<<<blocks_of(n, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      g_packed, g_raw, D, H, W);
  return (int)cudaGetLastError();
}

// g_env: ((TH+1)(TW+1), 12); g_raw: (TH, TW, 3)
int vpt_contract_env(const float* g_env, float* g_raw, int TH, int TW, void* stream) {
  if (TH < 1 || TW < 1) return (int)cudaErrorInvalidValue;
  contract_env_kernel<<<blocks_of((int64_t)TH * TW, 256), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(g_env, g_raw, TH, TW);
  return (int)cudaGetLastError();
}

// raw: (D, H, W); packed: (D(H+1)(W+1), 4), 16-byte aligned
int vpt_pack_volume_xy(const float* raw, float* packed, int D, int H, int W, void* stream) {
  if (D < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)D * (H + 1) * (W + 1);
  pack_volume_xy_kernel<<<blocks_of(rows, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      raw, packed, D, H, W);
  return (int)cudaGetLastError();
}

// raw: (TH, TW, 3); packed: ((TH+1)(TW+1), 12), 16-byte aligned
int vpt_pack_env(const float* raw, float* packed, int TH, int TW, void* stream) {
  if (TH < 1 || TW < 1) return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)(TH + 1) * (TW + 1);
  pack_env_kernel<<<blocks_of(rows, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      raw, packed, TH, TW);
  return (int)cudaGetLastError();
}

// raw: (D, H, W); packed: ((D+1)(H+1)(W+1), 8), 16-byte aligned
int vpt_pack_volume(const float* raw, float* packed, int D, int H, int W, void* stream) {
  if (D < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)(D + 1) * (H + 1) * (W + 1);
  pack_volume_kernel<<<blocks_of(rows, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      raw, packed, D, H, W);
  return (int)cudaGetLastError();
}

// mtf: (TH, TW, 4), 16-byte aligned; light: (TW,); packed: ((TH+1)(TW+1), 18);
// pairs: (TW+1, 2) or null
int vpt_pack_tf(const float* mtf, const float* light, float* packed, float* pairs, int TH,
                int TW, void* stream) {
  if (TH < 1 || TW < 1) return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)(TH + 1) * (TW + 1);
  pack_tf_kernel<<<blocks_of(rows, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      mtf, light, packed, pairs, TH, TW);
  return (int)cudaGetLastError();
}

}  // extern "C"
