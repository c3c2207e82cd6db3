// K6: the shear-warp fast renderer's final homography warp, for NVIDIA Hopper
// (sm_90a): a bilinear lookup of a (C, Iv, Iu) float32 intermediate at
// per-pixel fractional coordinates (av, bu). K5 (below): the same lookup with
// the hybrid renderer's per-tile score statistics.
//
// Replaces vokselis_tpu/ops/pallas/warp2d.py:_warp_kernel_mxu (launched by
// warp_bilinear_packed) together with the two kernels that only existed for
// the TPU's windows: _rewarp_kernel (K6b, the re-warp of tiles whose
// footprint overflowed the VMEM window) and _warp_kernel/_warp_kernel_impl
// (K6c, the banded row-scan for intermediates above the VMEM cap). The
// kernels read the intermediate directly, so there is no window and no tap
// can overflow one; every intermediate size takes them.
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
// (L2-resident), the mask and the hit pixels' coordinates (~4 MB) and writes
// 12 MB of output: ~6 us at 3.35 TB/s. The design: one block per 32x32
// screen tile, a thread per K6_VX = 4 consecutive pixels of a tile row. A
// thread reads its pixels' masks as one 32-bit word and, where any is set,
// their coordinates as one float4 a plane, issues every tap of its pixels
// before it uses any (a masked pixel taps texel 0, whose value is
// discarded), and writes each plane as one streaming float4 store. The 2-D
// tile keeps the rows of a tile, which tap the same intermediate rows, on
// one SM's L1 (a block over 1024 consecutive pixels of a row took 1.8-2.3x as
// long). Widths that are not a multiple of 4, or unaligned buffers, take
// the same kernel with one load and store a pixel. Numerics: the plain
// version (vokselis_torch/ops/cuda/warp2d.py:warp_plain) repeats these
// float32 operations in order; the library is built with --fmad=false.
//
// K5, the hybrid renderer's stats warp, replaces
// vokselis_tpu/ops/pallas/warp2d.py:_warp_kernel_mxu_stats (launched by
// warp_stats_packed) and its overflow re-warp _rewarp_kernel_stats (K5b): the
// same windowless gather over four channels (r, g, b and the intermediate's
// curvature), then every per-tile scoring ingredient of the hybrid reduced in
// the kernel while the tile is on chip. One block per 32x32 screen tile of
// the tile grid padded to whole tiles. Per pixel, with ok the warp's
// reconstruction mask and box the volume-box hit mask (both 0 outside the
// frame):
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
// packed TPU planes' padding does. What bounds it: bytes, as K6 (~23 MB at
// 1024^2 and I=512: ~7 us). The design is K6's with K5_VX = 8 pixels a
// thread (128 threads a tile): the masks, then the ok pixels' coordinates,
// then the taps (in the SASS 124 of a thread's 128 are in flight before any
// is used); 8 pixels beat 4, 2 and 1 a thread, and the wide path's launch
// bound holds it to 168 registers, 3 blocks an SM (186 registers, 2 blocks,
// took 1.13x as long). What holds it at ~2.4x its bound is the gather: the
// curvature plane's taps alone take ~15 % of it, and K5 takes ~3 % longer
// than K6 does with 4 channels.
// The edge term takes the left and upper neighbours by warp shuffles and
// only the row above a warp's first row through shared memory; the sums and
// the max reduce by shuffles, then the block's 4 warps in order. t is
// computed only where the branch reads it. Numerics: the lookup, lum, slope
// and lums repeat the plain version's (warp2d.py:warp_stats_plain) float32
// operations in order; the sums add in another order than torch.sum, so
// they agree within rounding, while the count and the max are exact.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int TILE = 32;    // screen tile side
constexpr int K6_VX = 4;    // K6: consecutive pixels of a tile row a thread
constexpr int K5_VX = 8;    // K5: the same
constexpr int K6_BLOCK = TILE * TILE / K6_VX, K5_BLOCK = TILE * TILE / K5_VX;
constexpr int K5_WIDE_BLOCKS = 3;  // K5's wide path: blocks an SM (<= 168 registers)
constexpr int MAX_CH = 4;
constexpr int N_STATS = 5;  // STAT_CURV, STAT_EDGE, STAT_OVF, STAT_EXT, STAT_PEAK
constexpr unsigned FULL = 0xffffffffu;
constexpr float THIRD = (float)(1.0 / 3.0);
constexpr float INV_GAMMA = (float)(1.0 / 2.4);
constexpr float SLOPE_K = (float)(1.055 / 2.4);

// The lookup's four tap offsets in a plane and its two fractions.
struct Taps {
  int o00, o01, o10, o11;
  float fa, fb;
};

__device__ __forceinline__ Taps taps_at(float av, float bu, int iv, int iu) {
  const float a = fminf(fmaxf(av, 0.0f), (float)(iv - 1));
  const float b = fminf(fmaxf(bu, 0.0f), (float)(iu - 1));
  const float v0f = floorf(a), u0f = floorf(b);
  const int v0 = (int)v0f, u0 = (int)u0f;
  const int v1 = min(v0 + 1, iv - 1), u1 = min(u0 + 1, iu - 1);
  return {v0 * iu + u0, v0 * iu + u1, v1 * iu + u0, v1 * iu + u1, a - v0f, b - u0f};
}

__device__ __forceinline__ float lerp2(const float x[4], float fa, float fb) {
  const float t0 = x[0] + (x[1] - x[0]) * fb;
  const float t1 = x[2] + (x[3] - x[2]) * fb;
  return t0 + (t1 - t0) * fa;
}

// A thread's group: the VX pixels from (y, x) of tile `t` of an nx-wide
// grid of TILE-wide, TILE-tall tiles; p their first pixel's index, lim how
// many of them lie in the frame (<= 0: none).
struct Group {
  int p, lim;
};

template <int VX>
__device__ __forceinline__ Group group_of(int t, int nx, int height, int width) {
  constexpr int TX = TILE / VX;
  const int x = (t % nx) * TILE + VX * (threadIdx.x % TX);
  const int y = (t / nx) * TILE + threadIdx.x / TX;
  return {y * width + x, y < height ? width - x : 0};
}

// bits of the group's pixels in the frame that `mask` marks (all of them
// when mask is null). WIDE: the width is a multiple of VX and the buffers
// are aligned, so a group is whole and one 4-byte load per 4 pixels.
template <int VX, bool WIDE>
__device__ __forceinline__ uint32_t load_mask(const uint8_t* __restrict__ mask, Group g) {
  if constexpr (WIDE) {
    if (g.lim <= 0) return 0u;
    if (mask == nullptr) return (1u << VX) - 1u;
    uint32_t m = 0;
#pragma unroll
    for (int q = 0; q < VX / 4; ++q) {
      const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(mask + g.p) + q);
#pragma unroll
      for (int i = 0; i < 4; ++i) m |= ((w >> (8 * i)) & 0xffu) != 0 ? 1u << (4 * q + i) : 0u;
    }
    return m;
  } else {
    uint32_t m = 0;
#pragma unroll
    for (int i = 0; i < VX; ++i)
      m |= i < g.lim && (mask == nullptr || __ldg(mask + g.p + i) != 0) ? 1u << i : 0u;
    return m;
  }
}

// the coordinates of the group's pixels marked in `on` (0 elsewhere): one
// 16-byte load a plane (WIDE), else one a pixel
template <int VX, bool WIDE>
__device__ __forceinline__ void load_coords(const float* __restrict__ av,
                                            const float* __restrict__ bu, Group g, uint32_t on,
                                            float a[VX], float b[VX]) {
#pragma unroll
  for (int i = 0; i < VX; ++i) a[i] = b[i] = 0.0f;
  if constexpr (WIDE) {
#pragma unroll
    for (int q = 0; q < VX / 4; ++q) {
      if ((on >> (4 * q)) & 0xfu) {
        const float4 a4 = __ldg(reinterpret_cast<const float4*>(av + g.p) + q);
        const float4 b4 = __ldg(reinterpret_cast<const float4*>(bu + g.p) + q);
        a[4 * q] = a4.x, a[4 * q + 1] = a4.y, a[4 * q + 2] = a4.z, a[4 * q + 3] = a4.w;
        b[4 * q] = b4.x, b[4 * q + 1] = b4.y, b[4 * q + 2] = b4.z, b[4 * q + 3] = b4.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < VX; ++i)
      if ((on >> i) & 1u) a[i] = __ldg(av + g.p + i), b[i] = __ldg(bu + g.p + i);
  }
}

// one output plane's values of the group: one streaming store (WIDE), else
// one a pixel in the frame
template <int VX, bool WIDE>
__device__ __forceinline__ void store_group(float* __restrict__ o, int lim, const float v[VX]) {
  if constexpr (WIDE) {
    if (lim > 0)
#pragma unroll
      for (int q = 0; q < VX / 4; ++q)
        __stcs(reinterpret_cast<float4*>(o) + q,
               make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
  } else {
#pragma unroll
    for (int i = 0; i < VX; ++i)
      if (i < lim) __stcs(o + i, v[i]);
  }
}

// the four taps of NCH channels at each of the group's pixels
template <int VX, int NCH>
__device__ __forceinline__ void load_taps(const float* __restrict__ chans, int iv, int iu,
                                          const float a[VX], const float b[VX], Taps tp[VX],
                                          float xs[VX][NCH][4]) {
  const size_t plane = (size_t)iv * iu;
#pragma unroll
  for (int i = 0; i < VX; ++i) {
    tp[i] = taps_at(a[i], b[i], iv, iu);
    const int o[4] = {tp[i].o00, tp[i].o01, tp[i].o10, tp[i].o11};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int c = 0; c < NCH; ++c) xs[i][c][k] = __ldg(chans + c * plane + o[k]);
  }
}

// K6: one block per 32x32 tile.
template <int NCH, bool WIDE>
__global__ void __launch_bounds__(K6_BLOCK)
    warp_kernel(const float* __restrict__ chans, int iv, int iu,
                const float* __restrict__ av, const float* __restrict__ bu,
                const uint8_t* __restrict__ hit, int height, int width, int nx,
                float* __restrict__ out) {
  constexpr int VX = K6_VX;
  const Group g = group_of<VX>(blockIdx.x, nx, height, width);
  if (g.lim <= 0) return;
  const uint32_t on = load_mask<VX, WIDE>(hit, g);
  float a[VX], b[VX];
  load_coords<VX, WIDE>(av, bu, g, on, a, b);
  Taps tp[VX];
  float xs[VX][NCH][4];
  load_taps<VX, NCH>(chans, iv, iu, a, b, tp, xs);
  const size_t npix = (size_t)height * width;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    float r[VX];
#pragma unroll
    for (int i = 0; i < VX; ++i)
      r[i] = (on >> i) & 1u ? lerp2(xs[i][c], tp[i].fa, tp[i].fb) : 0.0f;
    store_group<VX, WIDE>(out + c * npix + g.p, g.lim, r);
  }
}

// K5: one block per 32x32 tile; warp w takes the tile rows from
// WARP_ROWS w, lane l row WARP_ROWS w + l / TX and columns VX (l % TX) ..
// VX (l % TX) + VX - 1.
template <bool WIDE>
__global__ void __launch_bounds__(K5_BLOCK, WIDE ? K5_WIDE_BLOCKS : 1)
    warp_stats_kernel(const float* __restrict__ chans, int iv, int iu,
                      const float* __restrict__ av, const float* __restrict__ bu,
                      const uint8_t* __restrict__ ok, const uint8_t* __restrict__ box,
                      int height, int width, int nx, float* __restrict__ out,
                      float* __restrict__ stats) {
  constexpr int VX = K5_VX, TX = TILE / VX, NWARP = TILE * TX / 32, WARP_ROWS = 32 / TX;
  __shared__ float last_row[NWARP][TILE];  // each warp's last row of sRGB luminances
  __shared__ float part[NWARP][4];         // each warp's CURV, EDGE, EXT sums and PEAK
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col0 = VX * (threadIdx.x % TX), rr = lane / TX;
  const size_t npix = (size_t)height * width;
  const Group g = group_of<VX>(blockIdx.x, nx, height, width);
  const uint32_t okm = load_mask<VX, WIDE>(ok, g), boxm = load_mask<VX, WIDE>(box, g);
  float a[VX], b[VX];
  load_coords<VX, WIDE>(av, bu, g, okm, a, b);
  Taps tp[VX];
  float xs[VX][MAX_CH][4];
  load_taps<VX, MAX_CH>(chans, iv, iu, a, b, tp, xs);
  float c[MAX_CH][VX];
#pragma unroll
  for (int i = 0; i < VX; ++i)
#pragma unroll
    for (int ch = 0; ch < MAX_CH; ++ch)
      c[ch][i] = (okm >> i) & 1u ? lerp2(xs[i][ch], tp[i].fa, tp[i].fb) : 0.0f;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) store_group<VX, WIDE>(out + ch * npix + g.p, g.lim, c[ch]);
  // sRGB luminance and slope (t = lum^(1/2.4) only where the branch reads it)
  float s_curv = 0.0f, lums[VX];
#pragma unroll
  for (int i = 0; i < VX; ++i) {
    const float lum = fmaxf((c[0][i] + c[1][i] + c[2][i]) * THIRD, 1e-6f);
    float slope = 12.92f;
    lums[i] = 12.92f * lum;
    if (lum > 0.0031308f) {
      const float tt = expf(logf(lum) * INV_GAMMA);
      slope = SLOPE_K * tt / lum;
      lums[i] = 1.055f * tt - 0.055f;
    }
    s_curv += c[3][i] * slope;
  }
  float s_ext = (float)__popc(boxm & ~okm);
  // the edge term: the left neighbour in the thread or the lane before,
  // the pixel above in the lane TX before; a warp's first row takes the
  // row above from the warp before through shared memory (0 in the
  // tile's first column and row)
  const float left = __shfl_up_sync(FULL, lums[VX - 1], 1);
  float s_edge = 0.0f, peak = 0.0f;
#pragma unroll
  for (int i = 0; i < VX; ++i) {
    const float above = __shfl_up_sync(FULL, lums[i], TX);
    const float cd = i > 0 ? fabsf(lums[i] - lums[i - 1])
                           : col0 == 0 ? 0.0f : fabsf(lums[0] - left);
    s_edge += cd + (rr > 0 ? fabsf(lums[i] - above) : 0.0f);
    peak = fmaxf(peak, lums[i]);
  }
  if (rr == WARP_ROWS - 1)
#pragma unroll
    for (int i = 0; i < VX; ++i) last_row[warp][col0 + i] = lums[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s_curv += __shfl_down_sync(FULL, s_curv, o);
    s_ext += __shfl_down_sync(FULL, s_ext, o);
    peak = fmaxf(peak, __shfl_down_sync(FULL, peak, o));
  }
  __syncthreads();
  if (warp > 0 && rr == 0)
#pragma unroll
    for (int i = 0; i < VX; ++i) s_edge += fabsf(lums[i] - last_row[warp - 1][col0 + i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s_edge += __shfl_down_sync(FULL, s_edge, o);
  if (lane == 0) {
    part[warp][0] = s_curv;
    part[warp][1] = s_edge;
    part[warp][2] = s_ext;
    part[warp][3] = peak;
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the warps' parts, summed in order
    float v[4] = {part[0][0], part[0][1], part[0][2], part[0][3]};
#pragma unroll
    for (int w = 1; w < NWARP; ++w) {
      v[0] += part[w][0];
      v[1] += part[w][1];
      v[2] += part[w][2];
      v[3] = fmaxf(v[3], part[w][3]);
    }
    float* st = stats + (size_t)blockIdx.x * N_STATS;
    st[0] = v[0];  // STAT_CURV
    st[1] = v[1];  // STAT_EDGE
    st[2] = 0.0f;  // STAT_OVF
    st[3] = v[2];  // STAT_EXT
    st[4] = v[3];  // STAT_PEAK
  }
}

bool aligned(const void* p, uintptr_t n) { return ((uintptr_t)p % n) == 0; }

// the width a multiple of VX and every plane aligned: one vector access a group
bool wide(int vx, int width, const void* av, const void* bu, const void* out,
          std::initializer_list<const void*> masks) {
  bool w = width % vx == 0 && aligned(av, 16) && aligned(bu, 16) && aligned(out, 16);
  for (const void* m : masks) w = w && aligned(m, 4);
  return w;
}

template <int NCH>
void launch_warp(bool w, cudaStream_t s, const float* chans, int iv, int iu, const float* av,
                 const float* bu, const uint8_t* hit, int height, int width, float* out) {
  const int nx = (width + TILE - 1) / TILE, n = nx * ((height + TILE - 1) / TILE);
  if (w)
    warp_kernel<NCH, true><<<n, K6_BLOCK, 0, s>>>(chans, iv, iu, av, bu, hit, height, width, nx,
                                                  out);
  else
    warp_kernel<NCH, false><<<n, K6_BLOCK, 0, s>>>(chans, iv, iu, av, bu, hit, height, width, nx,
                                                   out);
}

}  // namespace

extern "C" {

const char* vk_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K6 on `stream`; returns the launch's cudaError_t (0 on success). Device
// pointers: chans (n_ch * iv * iu f32, n_ch <= 4), av and bu (height * width
// f32 each), hit (height * width uint8, or null: every pixel participates),
// out (n_ch * height * width f32).
int vk_warp_bilinear(const void* chans, int n_ch, int iv, int iu, const void* av,
                     const void* bu, const void* hit, int height, int width, void* out,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_ch < 1 || n_ch > MAX_CH || (long long)iv * iu > INT_MAX ||
      (long long)height * width > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (height <= 0 || width <= 0) return (int)cudaSuccess;
  const bool w = wide(K6_VX, width, av, bu, out, {hit});
  const cudaStream_t s = (cudaStream_t)stream;
  const float *c = (const float*)chans, *a = (const float*)av, *b = (const float*)bu;
  const uint8_t* h = (const uint8_t*)hit;
  float* o = (float*)out;
  switch (n_ch) {
    case 1: launch_warp<1>(w, s, c, iv, iu, a, b, h, height, width, o); break;
    case 2: launch_warp<2>(w, s, c, iv, iu, a, b, h, height, width, o); break;
    case 3: launch_warp<3>(w, s, c, iv, iu, a, b, h, height, width, o); break;
    default: launch_warp<4>(w, s, c, iv, iu, a, b, h, height, width, o); break;
  }
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
  if ((long long)iv * iu > INT_MAX || (long long)height * width > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (height <= 0 || width <= 0) return (int)cudaSuccess;
  const int nx = (width + TILE - 1) / TILE, n = nx * ((height + TILE - 1) / TILE);
  const cudaStream_t s = (cudaStream_t)stream;
  const float *c = (const float*)chans, *a = (const float*)av, *b = (const float*)bu;
  const uint8_t *o = (const uint8_t*)ok, *x = (const uint8_t*)box;
  float *rgb = (float*)out, *st = (float*)stats;
  if (wide(K5_VX, width, av, bu, out, {ok, box}))
    warp_stats_kernel<true><<<n, K5_BLOCK, 0, s>>>(c, iv, iu, a, b, o, x, height, width, nx, rgb,
                                                   st);
  else
    warp_stats_kernel<false><<<n, K5_BLOCK, 0, s>>>(c, iv, iu, a, b, o, x, height, width, nx, rgb,
                                                    st);
  return (int)cudaGetLastError();
}

}  // extern "C"
