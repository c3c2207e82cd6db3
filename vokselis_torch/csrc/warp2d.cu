// K6: the shear-warp fast renderer's final homography warp, for NVIDIA Hopper
// (sm_90a): a bilinear lookup of a (C, Iv, Iu) float32 intermediate at
// per-pixel fractional coordinates (av, bu). K5 (below): the same lookup with
// the hybrid renderer's per-tile score statistics.
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
//
// K5, the hybrid renderer's stats warp, replaces
// vokselis_tpu/ops/pallas/warp2d.py:_warp_kernel_mxu_stats (launched by
// warp_stats_packed) and its overflow re-warp _rewarp_kernel_stats (K5b): the
// same windowless gather over four channels (r, g, b and the intermediate's
// curvature), then every per-tile scoring ingredient of the hybrid reduced in
// the kernel while the tile is on chip. One block of 32x8 threads per 32x32
// screen tile of the tile grid padded to whole tiles; each thread takes one
// column and four rows. Per pixel, with ok the warp's reconstruction mask and
// box the volume-box hit mask (both 0 outside the frame):
//   r, g, b, c = the K6 lookup where ok, else 0 (r, g, b are written out);
//   lum = max((r + g + b) * (1/3), 1e-6); t = expf(logf(lum) * (1/2.4));
//   slope = lum > 0.0031308 ? (1.055/2.4) * t / lum : 12.92;
//   lums  = lum > 0.0031308 ? 1.055 * t - 0.055 : 12.92 * lum;
//   edge = |lums - left| (0 in the tile's first column)
//        + |lums - above| (0 in the tile's first row);
// and per tile (vokselis_tpu/ops/pallas/warp2d.py:454-458, one row of 5):
//   CURV = sum(c * slope), EDGE = sum(edge), OVF = 0 (no window overflows),
//   EXT = count(box and not ok), PEAK = max(lums).
// Pixels of the padding take lum = 1e-6 and so enter EDGE and PEAK, as the
// packed TPU planes' padding does. The tile's luminances go through shared
// memory for the edge term; sums and the max reduce by warp shuffles, then
// across the block's 8 warps in shared memory. What bounds it: bytes, as K6
// (~26 MB at 1024^2 and I=512: ~8 us). Numerics: the lookup, lum, slope and
// lums repeat the plain version's (warp2d.py:warp_stats_plain) float32
// operations in order; the sums add in another order than torch.sum, so they
// agree within rounding, while the count and the max are exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WP_BLOCK = 256;
constexpr int MAX_CH = 4;
constexpr int TILE = 32;     // screen tile side
constexpr int ST_ROWS = 8;   // K5 block: TILE x ST_ROWS threads, TILE / ST_ROWS rows each
constexpr int N_STATS = 5;   // STAT_CURV, STAT_EDGE, STAT_OVF, STAT_EXT, STAT_PEAK
constexpr float THIRD = (float)(1.0 / 3.0);
constexpr float INV_GAMMA = (float)(1.0 / 2.4);
constexpr float SLOPE_K = (float)(1.055 / 2.4);

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(TILE* ST_ROWS)
    warp_stats_kernel(const float* __restrict__ chans, int iv, int iu,
                      const float* __restrict__ av, const float* __restrict__ bu,
                      const uint8_t* __restrict__ ok, const uint8_t* __restrict__ box,
                      int height, int width, int nx, float* __restrict__ out,
                      float* __restrict__ stats) {
  __shared__ float lum_s[TILE][TILE + 1];
  __shared__ float part[4][ST_ROWS];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int y0 = (blockIdx.x / nx) * TILE, x0 = (blockIdx.x % nx) * TILE;
  const size_t npix = (size_t)height * width;
  const size_t plane = (size_t)iv * iu;
  float s_curv = 0.0f, s_ext = 0.0f;
#pragma unroll
  for (int j = 0; j < TILE / ST_ROWS; ++j) {
    const int r = ty + ST_ROWS * j;
    const int y = y0 + r, x = x0 + tx;
    float c[MAX_CH] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (y < height && x < width) {
      const size_t p = (size_t)y * width + x;
      if (ok[p] != 0) {
        const float a = fminf(fmaxf(av[p], 0.0f), (float)(iv - 1));
        const float b = fminf(fmaxf(bu[p], 0.0f), (float)(iu - 1));
        const float v0f = floorf(a), u0f = floorf(b);
        const float fa = a - v0f, fb = b - u0f;
        const int v0 = (int)v0f, u0 = (int)u0f;
        const int v1 = min(v0 + 1, iv - 1), u1 = min(u0 + 1, iu - 1);
        const size_t r0 = (size_t)v0 * iu, r1 = (size_t)v1 * iu;
#pragma unroll
        for (int ch = 0; ch < MAX_CH; ++ch) {
          const float* xc = chans + ch * plane;
          const float x00 = __ldg(xc + r0 + u0), x01 = __ldg(xc + r0 + u1);
          const float x10 = __ldg(xc + r1 + u0), x11 = __ldg(xc + r1 + u1);
          const float t0 = x00 + (x01 - x00) * fb;
          const float t1 = x10 + (x11 - x10) * fb;
          c[ch] = t0 + (t1 - t0) * fa;
        }
      } else if (box[p] != 0) {
        s_ext += 1.0f;
      }
      out[p] = c[0];
      out[npix + p] = c[1];
      out[2 * npix + p] = c[2];
    }
    const float lum = fmaxf((c[0] + c[1] + c[2]) * THIRD, 1e-6f);
    const float t = expf(logf(lum) * INV_GAMMA);
    const bool hi = lum > 0.0031308f;
    const float slope = hi ? SLOPE_K * t / lum : 12.92f;
    lum_s[r][tx] = hi ? 1.055f * t - 0.055f : 12.92f * lum;
    s_curv += c[3] * slope;
  }
  __syncthreads();
  float s_edge = 0.0f, peak = 0.0f;
#pragma unroll
  for (int j = 0; j < TILE / ST_ROWS; ++j) {
    const int r = ty + ST_ROWS * j;
    const float l = lum_s[r][tx];
    const float cd = tx == 0 ? 0.0f : fabsf(l - lum_s[r][tx - 1]);
    const float rd = r == 0 ? 0.0f : fabsf(l - lum_s[r - 1][tx]);
    s_edge += cd + rd;
    peak = fmaxf(peak, l);
  }
  s_curv = warp_sum(s_curv);
  s_edge = warp_sum(s_edge);
  s_ext = warp_sum(s_ext);
  peak = warp_max(peak);
  if (tx == 0) {
    part[0][ty] = s_curv;
    part[1][ty] = s_edge;
    part[2][ty] = s_ext;
    part[3][ty] = peak;
  }
  __syncthreads();
  if (ty == 0 && tx == 0) {
    float v[4] = {part[0][0], part[1][0], part[2][0], part[3][0]};
#pragma unroll
    for (int w = 1; w < ST_ROWS; ++w) {
      v[0] += part[0][w];
      v[1] += part[1][w];
      v[2] += part[2][w];
      v[3] = fmaxf(v[3], part[3][w]);
    }
    float* st = stats + (size_t)blockIdx.x * N_STATS;
    st[0] = v[0];  // STAT_CURV
    st[1] = v[1];  // STAT_EDGE
    st[2] = 0.0f;  // STAT_OVF
    st[3] = v[2];  // STAT_EXT
    st[4] = v[3];  // STAT_PEAK
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

// K5 on `stream`; returns the launch's cudaError_t. Device pointers: chans
// (4 * iv * iu f32: r, g, b, curvature), av and bu (height * width f32), ok
// and box (height * width uint8), out (3 * height * width f32), stats
// (cdiv(height, 32) * cdiv(width, 32) * 5 f32, tile-major, raster tile order).
int vk_warp_stats(const void* chans, int iv, int iu, const void* av, const void* bu,
                  const void* ok, const void* box, int height, int width, void* out,
                  void* stats, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (height <= 0 || width <= 0) return (int)cudaSuccess;
  const int nx = (width + TILE - 1) / TILE, ny = (height + TILE - 1) / TILE;
  warp_stats_kernel<<<ny * nx, dim3(TILE, ST_ROWS), 0, (cudaStream_t)stream>>>(
      (const float*)chans, iv, iu, (const float*)av, (const float*)bu,
      (const uint8_t*)ok, (const uint8_t*)box, height, width, nx, (float*)out,
      (float*)stats);
  return (int)cudaGetLastError();
}

}  // extern "C"
