// K6: the shear-warp fast renderer's final homography warp, for NVIDIA Hopper
// (sm_90a): a bilinear lookup of a (C, Iv, Iu) float32 intermediate at
// per-pixel fractional coordinates (av, bu).
//
// Replaces vokselis_tpu/ops/pallas/warp2d.py:_warp_kernel_mxu (launched by
// warp_bilinear_packed) together with the two kernels that only existed for
// the TPU's windows: _rewarp_kernel (K6b, the re-warp of tiles whose
// footprint overflowed the VMEM window) and _warp_kernel/_warp_kernel_impl
// (K6c, the banded row-scan for intermediates above the VMEM cap). One thread
// per screen pixel reads the intermediate directly, so there is no window
// and no tap can overflow one; every intermediate size takes this kernel.
// Per pixel and channel (the semantics of warp2d.py:255-259, 313-343):
//   a = clamp(av, 0, Iv-1), b = clamp(bu, 0, Iu-1);
//   taps floor and floor+1, the latter clamped to the edge;
//   t0 = x[v0,u0] + (x[v0,u1] - x[v0,u0]) * fb, t1 likewise on row v1;
//   out = t0 + (t1 - t0) * fa;
// and 0 where the pixel's hit mask is 0 (misses and rays the intermediate
// cannot reconstruct, parked at +1e6 by the caller, are masked, not shown as
// edge-clamped taps). The intermediate is read as float32: the TPU's bf16
// cast of the channels was a VMEM economy, not part of the function.
// What bounds it: bytes. At 1024^2 and I=512 it reads ~3 MB of intermediate
// (L2-resident), 12 MB of coordinates and mask and writes 12 MB of output:
// ~8 us at 3.35 TB/s. Consecutive threads take consecutive pixels of a row, so
// the coordinate, mask and output streams coalesce; neighbouring pixels tap
// neighbouring texels, which the L1 and L2 serve.
// Numerics: the plain version (vokselis_torch/ops/cuda/warp2d.py:warp_plain)
// repeats these float32 operations in order; the library is built with
// --fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WP_BLOCK = 256;
constexpr int MAX_CH = 4;

__global__ void __launch_bounds__(WP_BLOCK)
    warp_kernel(const float* __restrict__ chans, int n_ch, int iv, int iu,
                const float* __restrict__ av, const float* __restrict__ bu,
                const uint8_t* __restrict__ hit, int npix, float* __restrict__ out) {
  const int p = blockIdx.x * WP_BLOCK + threadIdx.x;
  if (p >= npix) return;
  if (hit != nullptr && hit[p] == 0) {
    for (int c = 0; c < n_ch; ++c) out[(size_t)c * npix + p] = 0.0f;
    return;
  }
  const float a = fminf(fmaxf(av[p], 0.0f), (float)(iv - 1));
  const float b = fminf(fmaxf(bu[p], 0.0f), (float)(iu - 1));
  const float v0f = floorf(a), u0f = floorf(b);
  const float fa = a - v0f, fb = b - u0f;
  const int v0 = (int)v0f, u0 = (int)u0f;
  const int v1 = min(v0 + 1, iv - 1), u1 = min(u0 + 1, iu - 1);
  const size_t plane = (size_t)iv * iu;
  const size_t r0 = (size_t)v0 * iu, r1 = (size_t)v1 * iu;
#pragma unroll
  for (int c = 0; c < MAX_CH; ++c) {
    if (c >= n_ch) break;
    const float* x = chans + c * plane;
    const float x00 = __ldg(x + r0 + u0), x01 = __ldg(x + r0 + u1);
    const float x10 = __ldg(x + r1 + u0), x11 = __ldg(x + r1 + u1);
    const float t0 = x00 + (x01 - x00) * fb;
    const float t1 = x10 + (x11 - x10) * fb;
    out[(size_t)c * npix + p] = t0 + (t1 - t0) * fa;
  }
}

}  // namespace

extern "C" {

const char* vk_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K6 on `stream`; returns the launch's cudaError_t (0 on success). Device
// pointers: chans (n_ch * iv * iu f32, n_ch <= 4), av and bu (npix f32 each),
// hit (npix uint8, or null: every pixel participates), out (n_ch * npix f32).
int vk_warp_bilinear(const void* chans, int n_ch, int iv, int iu, const void* av,
                     const void* bu, const void* hit, int npix, void* out, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_ch < 1 || n_ch > MAX_CH) return (int)cudaErrorInvalidValue;
  if (npix <= 0) return (int)cudaSuccess;
  warp_kernel<<<(npix + WP_BLOCK - 1) / WP_BLOCK, WP_BLOCK, 0, (cudaStream_t)stream>>>(
      (const float*)chans, n_ch, iv, iu, (const float*)av, (const float*)bu,
      (const uint8_t*)hit, npix, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
