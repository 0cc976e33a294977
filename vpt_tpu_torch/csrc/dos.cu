// Directional occlusion shading (DOS) slice kernel for Hopper (sm_90a),
// plain C interface.
//
//   K24 dos_slice_kernel  replaces vpt_tpu/models/dos.py::dos_slice (:51-92)
//                         looped by DOSRenderer.render (:129-160): one slice
//                         of the sweep, the emission-absorption colour of
//                         the view-space plane at the slice's depth composited
//                         into the colour buffer (R, R, 4) in place, lit by
//                         the occlusion buffer, and the occlusion advanced by
//                         the mean of its bilinear self-samples at the disk
//                         offsets times the slice's transmittance. The launch
//                         of a render's last slice also writes the display
//                         image, 1 * (1 - a) + rgb * a (dos.py:156-159).
//   dos_display_kernel    that display alone, for a render past the sweep's
//                         end (no slice).
//
// One thread per pixel and one launch per slice: a slice's occlusion reads
// its neighbours' occlusion from the previous slice (dos.py:82-87), so a
// slice needs the whole previous buffer. Each launch reads one occlusion
// buffer and writes the other (the two ping-pong); a pixel whose plane
// point leaves the unit cube copies its old value (dos.py:89-90). The colour
// is per pixel and updated in place. One call of vpt_dos_sweep enqueues a
// render's slices; their scalars (the slice's NDC depth and occlusion
// scale, the f32 roundings of the host's float64 schedule) are passed by
// value from the host's table.
//
// What bounds it on this card. A launch is ~0.26 M pixels (512^2), each
// reading one volume row, one TF row (row 0: the classic TF at (d, 0)) and
// 4 x samples occlusion texels that its neighbours read too, so the
// launch moves a few MB and lasts a few microseconds; a render is up to
// `steps` launches, so the gaps between launches weigh as much as the
// kernels (chip_smoke.py phase 24 measures both).
//
// Numerics: built without fast math and with -fmad=false, so every
// expression rounds as the plain PyTorch version's (kernels/dos.py): the uv
// by IEEE division by the resolution (__fdiv_rn), as the reference divides;
// the occlusion sum over the samples divided by their count the same way;
// expf is the accurate one, which torch.exp calls on the card; min
// propagates NaN like torch.clamp_max.

#include "mcm_common.cuh"

namespace {

#define DOS_THREADS 128

// parameter block layout, mirrored by vpt_tpu_torch/kernels/dos.py
enum DosF {
  DF_INV_MVP = 0,  // 16 floats, row-major
  DF_SLICE_DISTANCE = 16,
  DF_EXTINCTION,
  DF_COUNT,
};
enum DosI {
  DI_RES = 0,
  DI_SAMPLES,      // the disk offsets' count
  DI_VOL_RAW,      // 1: a raw (D, H, W) f32 grid, given as D+1, H+1, W+1
  DI_VOL_U8,       // packed table: 1 u8, 0 f32
  DI_VOL_D, DI_VOL_H, DI_VOL_W,
  DI_QUASICUBIC,
  DI_NEAREST,      // raw grid only
  DI_TF_RAW,       // 1: a raw (H, W, 4) texture, given as H+1, W+1
  DI_TF_H, DI_TF_W,
  DI_COUNT,
};

struct DosP {
  float f[DF_COUNT];
  int i[DI_COUNT];
};

// bilinear sample of a raw 1-channel (R, R) texture at (u, v), clamped to
// the edge: interp.sample_tex2d of the (R, R, 1) occlusion (raw_axis is
// interp._coords)
__device__ __forceinline__ float sample_occlusion(const float* __restrict__ t, int res, float u,
                                                  float v) {
  int x0, x1, y0, y1;
  float fx, fy;
  raw_axis(u, res + 1, x0, x1, fx);
  raw_axis(v, res + 1, y0, y1, fy);
  const float c00 = __ldg(t + (int64_t)y0 * res + x0), c01 = __ldg(t + (int64_t)y0 * res + x1);
  const float c10 = __ldg(t + (int64_t)y1 * res + x0), c11 = __ldg(t + (int64_t)y1 * res + x1);
  return lerp(lerp(c00, c01, fx), lerp(c10, c11, fx), fy);
}

__device__ __forceinline__ void write_display(float* __restrict__ out, int pix, float4 c) {
  float* o = out + (int64_t)pix * 3;
  o[0] = 1.0f * (1.0f - c.w) + c.x * c.w;
  o[1] = 1.0f * (1.0f - c.w) + c.y * c.w;
  o[2] = 1.0f * (1.0f - c.w) + c.z * c.w;
}

// K24: one slice at NDC depth `depth_ndc` with occlusion scale (sx, sy):
// color (R, R) float4 in place, occlusion occ_in -> occ_out, and, where
// `display` is given, the display image (R, R, 3) of the new colour.
__global__ void __launch_bounds__(DOS_THREADS)
dos_slice_kernel(const DosP P, float depth_ndc, float sx, float sy, const void* __restrict__ vol,
                 const float* __restrict__ tf, const float2* __restrict__ samples,
                 float4* __restrict__ color, const float* __restrict__ occ_in,
                 float* __restrict__ occ_out, float* __restrict__ display) {
  const int res = P.i[DI_RES];
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= res * res) return;
  const int iy = pix / res, ix = pix - iy * res;
  const float fres = (float)res;
  // fullscreen-triangle interpolation: uv in [0, 1], NDC in [-1, 1]
  const float u2 = __fdiv_rn((float)ix + 0.5f, fres);
  const float v2 = __fdiv_rn((float)iy + 0.5f, fres);
  const float ndc_x = u2 * 2.0f - 1.0f, ndc_y = v2 * 2.0f - 1.0f;
  float px, py, pz;
  apply_homogeneous(P.f + DF_INV_MVP, ndc_x, ndc_y, depth_ndc, px, py, pz);
  float4 c = color[pix];
  const bool oob = px > 1.0f || px < 0.0f || py > 1.0f || py < 0.0f || pz > 1.0f || pz < 0.0f;
  if (oob) {
    occ_out[pix] = __ldg(occ_in + pix);
  } else {
    const float d = sample_volume_flags(vol, P.i[DI_VOL_RAW], P.i[DI_VOL_U8], P.i[DI_VOL_D],
                                        P.i[DI_VOL_H], P.i[DI_VOL_W], P.i[DI_QUASICUBIC] != 0,
                                        P.i[DI_NEAREST] != 0, px, py, pz);
    const float4 t4 = sample_rgba(tf, P.i[DI_TF_RAW] != 0, P.i[DI_TF_H], P.i[DI_TF_W], d);
    const float local_ext = t4.w * P.f[DF_EXTINCTION];
    const float trans = expf(-local_ext * P.f[DF_SLICE_DISTANCE]);
    const float alpha = 1.0f - trans;
    const float occ0 = __ldg(occ_in + pix);
    const float keep = 1.0f - c.w;
    c.x = c.x + t4.x * occ0 * alpha * keep;
    c.y = c.y + t4.y * occ0 * alpha * keep;
    c.z = c.z + t4.z * occ0 * alpha * keep;
    c.w = nmin(c.w + alpha, 1.0f);
    color[pix] = c;
    // occlusion advance: mean of bilinear self-samples at disk offsets
    const int n = P.i[DI_SAMPLES];
    float occ = 0.0f;
    for (int k = 0; k < n; ++k) {
      const float2 s = __ldg(samples + k);
      occ = occ + sample_occlusion(occ_in, res, u2 + s.x * sx, v2 + s.y * sy);
    }
    occ_out[pix] = __fdiv_rn(occ, (float)n) * trans;
  }
  if (display != nullptr) write_display(display, pix, c);
}

// the display of the colour as it stands (a render past the sweep's end)
__global__ void __launch_bounds__(DOS_THREADS)
dos_display_kernel(int res, const float4* __restrict__ color, float* __restrict__ display) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= res * res) return;
  write_display(display, pix, color[pix]);
}

}  // namespace

extern "C" {

int vpt_dos_layout(int which) {
  switch (which) {
    case 0: return DF_COUNT;
    case 1: return DI_COUNT;
    default: return -1;
  }
}

// n slices, schedule (host, n x 3 floats: depth_ndc, occlusion scale x, y);
// color (R*R float4) updated in place; slice k reads occlusion buffer k % 2
// of (occ_a, occ_b) and writes the other, so after n slices the occlusion
// lies in occ_a (n even) or occ_b (n odd); the last slice writes display
// (R*R*3 floats), and with n == 0 one display launch writes it.
int vpt_dos_sweep(const float* fparams, const int* iparams, int n, const float* schedule,
                  const void* vol, const float* tf, const float* samples, float* color,
                  float* occ_a, float* occ_b, float* display, void* stream) {
  DosP P;
  for (int k = 0; k < DF_COUNT; ++k) P.f[k] = fparams[k];
  for (int k = 0; k < DI_COUNT; ++k) P.i[k] = iparams[k];
  const int res = P.i[DI_RES];
  if (n < 0 || res <= 0 || P.i[DI_SAMPLES] < 1 || vol == nullptr || tf == nullptr ||
      samples == nullptr || color == nullptr || occ_a == nullptr || occ_b == nullptr ||
      display == nullptr || (n > 0 && schedule == nullptr) ||
      (P.i[DI_NEAREST] != 0 && P.i[DI_VOL_RAW] == 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)blocks_for(res * res, DOS_THREADS);
  float4* c = reinterpret_cast<float4*>(color);
  const float2* s = reinterpret_cast<const float2*>(samples);
  if (n == 0) {
    dos_display_kernel<<<blocks, DOS_THREADS, 0, st>>>(res, c, display);
    return (int)cudaGetLastError();
  }
  for (int k = 0; k < n; ++k) {
    const float* in = (k % 2 == 0) ? occ_a : occ_b;
    float* out = (k % 2 == 0) ? occ_b : occ_a;
    dos_slice_kernel<<<blocks, DOS_THREADS, 0, st>>>(
        P, schedule[3 * k], schedule[3 * k + 1], schedule[3 * k + 2], vol, tf, s, c, in, out,
        k == n - 1 ? display : nullptr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
