// Exact front-to-back raymarch of a uint8 voxel volume (the bonsai path), one
// thread per pixel, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel vokselis_tpu/ops/pallas/march_bonsai.py:_march_kernel
// (launched by render_bonsai_rays_pallas). It computes what that kernel and
// the oracle vokselis_torch/ops/reference.py:render_bonsai_rays compute, for
// each pixel (shaders/raycast_naive.wgsl fs_main, :84-125):
//   1. clip the ray to the [0,1]^3 box (slab test);
//   2. dt = 1 / (D * max|d|): each step moves the dominant axis one voxel;
//   3. march while t < t1 and alpha < 0.95, position accumulated p += d * dt;
//   4. trilinear R8Unorm sample with wgpu ClampToEdge taps (texel x = p*D - 0.5,
//      taps floor(x) and floor(x)+1, each clamped to [0, D-1]);
//   5. transfer tv = smoothstep(0.10, 1.2, min(0.9, samp)) (the clamp-argument
//      quirk) and the vertigo palette (TAU = 6.28318);
//   6. composite under: rgb += (1-a)*tv*c, a += (1-a)*tv;
//   7. optional linear_to_srgb on rgb; alpha out is 1.
//
// What bounds it on this card: gather latency and L2 traffic. A ray takes up
// to MAX_STEPS (444 at D=256) steps of 8 one-byte taps, each a dependent
// load whose address comes from the previous step's position; the arithmetic
// per step (three cosf, a few dozen flops) is small beside the load latency.
// The design: the volume stays one contiguous (D, D, D) buffer indexed
// [z][y][x] (256^3 = 16.8 MB, resident in the 50 MB L2 across frames) and is
// read through __ldg; threads run in 16x8 pixel blocks so that neighbouring
// rays, which sample neighbouring voxels, share L1 lines; each thread breaks
// out at alpha >= 0.95. None of the TPU kernel's slab-pair layouts, DMA
// windows or overflow plane exist here: a thread can gather directly.
//
// Numerics: the march repeats the oracle's float32 operations in the
// oracle's order, and the library is built with --fmad=false so that no
// a*b+c is contracted into an fma the oracle does not have. A division by a
// constant is a multiplication by its reciprocal, taken in double and rounded
// to float, as PyTorch's CUDA division by a Python scalar computes it (a true
// float division differs in the last bit). Hardware texture filtering is not used:
// its 8-bit fixed-point weights would break the 1e-3 / 1e-5 parity contract.
// Empty-space skipping (the TPU kernel's OCC_CUT occupancy table), shared
// memory staging and TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_X = 16;
constexpr int BLOCK_Y = 8;

constexpr float TAU = 6.28318f;  // shaders/raycast_naive.wgsl:70, not 2*pi
constexpr float INV_255 = (float)(1.0 / 255.0);
constexpr float INV_SMOOTH_SPAN = (float)(1.0 / (1.2 - 0.10));  // smoothstep(0.10, 1.2, .)
constexpr float SRGB_EXP = (float)(1.0 / 2.4);

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__device__ __forceinline__ float lerp(float a, float b, float f) {
  return a + (b - a) * f;
}

// sample_trilinear_r8 of an R8Unorm (D, D, D) volume at normalized p.
__device__ __forceinline__ float sample_trilinear(const uint8_t* __restrict__ vol,
                                                  int dims, float fdims, float px,
                                                  float py, float pz) {
  const float x = px * fdims - 0.5f;
  const float y = py * fdims - 0.5f;
  const float z = pz * fdims - 0.5f;
  const float x0f = floorf(x), y0f = floorf(y), z0f = floorf(z);
  const float fx = x - x0f, fy = y - y0f, fz = z - z0f;
  const int hi = dims - 1;
  const int x0 = clampi((int)x0f, hi), x1 = clampi((int)x0f + 1, hi);
  const int y0 = clampi((int)y0f, hi), y1 = clampi((int)y0f + 1, hi);
  const int z0 = clampi((int)z0f, hi), z1 = clampi((int)z0f + 1, hi);
  const size_t row = (size_t)dims, slab = (size_t)dims * dims;
  const uint8_t* r00 = vol + z0 * slab + y0 * row;
  const uint8_t* r10 = vol + z0 * slab + y1 * row;
  const uint8_t* r01 = vol + z1 * slab + y0 * row;
  const uint8_t* r11 = vol + z1 * slab + y1 * row;
  const float c000 = (float)__ldg(r00 + x0) * INV_255;
  const float c100 = (float)__ldg(r00 + x1) * INV_255;
  const float c010 = (float)__ldg(r10 + x0) * INV_255;
  const float c110 = (float)__ldg(r10 + x1) * INV_255;
  const float c001 = (float)__ldg(r01 + x0) * INV_255;
  const float c101 = (float)__ldg(r01 + x1) * INV_255;
  const float c011 = (float)__ldg(r11 + x0) * INV_255;
  const float c111 = (float)__ldg(r11 + x1) * INV_255;
  const float c00 = lerp(c000, c100, fx);
  const float c10 = lerp(c010, c110, fx);
  const float c01 = lerp(c001, c101, fx);
  const float c11 = lerp(c011, c111, fx);
  const float c0 = lerp(c00, c10, fy);
  const float c1 = lerp(c01, c11, fy);
  return lerp(c0, c1, fz);
}

__device__ __forceinline__ float linear_to_srgb(float x) {
  return x <= 0.0031308f ? 12.92f * x
                         : 1.055f * powf(fmaxf(x, 1e-12f), SRGB_EXP) - 0.055f;
}

__global__ void __launch_bounds__(BLOCK_X* BLOCK_Y)
    march_bonsai_kernel(const uint8_t* __restrict__ vol, int dims,
                        const float* __restrict__ dxs, const float* __restrict__ dys,
                        const float* __restrict__ dzs, const float* __restrict__ eye,
                        int height, int width, int max_steps, int srgb,
                        float* __restrict__ out) {
  const int ix = blockIdx.x * BLOCK_X + threadIdx.x;
  const int iy = blockIdx.y * BLOCK_Y + threadIdx.y;
  if (ix >= width || iy >= height) return;
  const size_t pix = (size_t)iy * width + ix;
  const float dx = dxs[pix], dy = dys[pix], dz = dzs[pix];
  const float ex = __ldg(eye), ey = __ldg(eye + 1), ez = __ldg(eye + 2);
  const float fdims = (float)dims;

  // slab test against [0,1]^3 (geometry.intersect_box_unit)
  const float inx = 1.0f / dx, iny = 1.0f / dy, inz = 1.0f / dz;
  const float ax0 = (0.0f - ex) * inx, ax1 = (1.0f - ex) * inx;
  const float ay0 = (0.0f - ey) * iny, ay1 = (1.0f - ey) * iny;
  const float az0 = (0.0f - ez) * inz, az1 = (1.0f - ez) * inz;
  const float t0 = fmaxf(fminf(ax0, ax1), fmaxf(fminf(ay0, ay1), fminf(az0, az1)));
  const float t1 = fminf(fmaxf(ax0, ax1), fminf(fmaxf(ay0, ay1), fmaxf(az0, az1)));
  const bool hit = t0 <= t1;
  float t = fmaxf(t0, 0.0f);

  // one voxel along the dominant axis per step (raycast_naive.wgsl:97-99)
  const float dt = fminf(1.0f / (fdims * fabsf(dx)),
                         fminf(1.0f / (fdims * fabsf(dy)), 1.0f / (fdims * fabsf(dz))));

  float px = ex + t * dx, py = ey + t * dy, pz = ez + t * dz;
  float r = 0.0f, g = 0.0f, b = 0.0f, a = 0.0f;
  if (hit) {
    for (int i = 0; i < max_steps; ++i) {
      if (!(t < t1) || !(a < 0.95f)) break;
      const float samp = sample_trilinear(vol, dims, fdims, px, py, pz);
      // transfer: smoothstep(0.10, 1.2, min(0.9, samp)) + vertigo
      float s = (fminf(samp, 0.9f) - 0.10f) * INV_SMOOTH_SPAN;
      s = fminf(fmaxf(s, 0.0f), 1.0f);
      const float tv = s * s * (3.0f - 2.0f * s);
      const float cr = 0.5f + 0.5f * cosf(TAU * (1.0f * tv + 0.0f));
      const float cg = 0.5f + 0.5f * cosf(TAU * (1.7f * tv + 0.15f));
      const float cb = 0.5f + 0.5f * cosf(TAU * (0.4f * tv + 0.20f));
      // front-to-back under-compositing (raycast_naive.wgsl:110-114)
      const float w = (1.0f - a) * tv;
      r = r + w * cr;
      g = g + w * cg;
      b = b + w * cb;
      a = a + (1.0f - a) * tv;
      px = px + dx * dt;
      py = py + dy * dt;
      pz = pz + dz * dt;
      t = t + dt;
    }
  }
  if (srgb) {
    r = linear_to_srgb(r);
    g = linear_to_srgb(g);
    b = linear_to_srgb(b);
  }
  float4 o = make_float4(r, g, b, 1.0f);
  reinterpret_cast<float4*>(out)[pix] = o;
}

}  // namespace

extern "C" {

const char* vk_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches the march on `stream` and returns the cudaError_t of the launch
// (0 on success). All pointers are device pointers: vol (dims^3 uint8,
// [z][y][x]), dx/dy/dz (height*width float32 each), eye (3 float32), out
// (height*width*4 float32, 16-byte aligned).
int vk_march_bonsai(const void* vol, int dims, const void* dx, const void* dy,
                    const void* dz, const void* eye, int height, int width,
                    int max_steps, int srgb, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (height <= 0 || width <= 0) return (int)cudaSuccess;
  const dim3 block(BLOCK_X, BLOCK_Y);
  const dim3 grid((width + BLOCK_X - 1) / BLOCK_X, (height + BLOCK_Y - 1) / BLOCK_Y);
  march_bonsai_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)vol, dims, (const float*)dx, (const float*)dy, (const float*)dz,
      (const float*)eye, height, width, max_steps, srgb, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
