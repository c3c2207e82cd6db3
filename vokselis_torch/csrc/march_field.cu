// K7: front-to-back raymarch of a procedural density field (the xor demo's
// compute raymarch and the trig field), one thread per pixel, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel vokselis_tpu/ops/pallas/march_field.py:_march_kernel
// (launched by render_field_pallas). For each pixel, from the ray's eye e,
// normalized direction d and the [t0, t1) span and step dt that the wrapper
// computed in torch (slab test against [-1,1]^3, the dt floor of 0.01 and the
// exact bounding-sphere clip), it runs shaders/raycast_compute.wgsl get_col2
// (:60-95):
//   1. color starts at (clear.rgb, 0.1);
//   2. while t < t1 and alpha < 0.95 (at most max_steps): p = e + t d,
//      optionally quantized to the voxel centre of a dims^3 texture
//      (floor((p+1) dims/2), clamped, then (g - dims/2) / dims);
//   3. the field at that coordinate: the fbm "noise" field, the bitwise "xor"
//      field or the "trig" field (fields.cuh); noise and xor take sin(time),
//      trig the raw time;
//   4. shading "xor": Lambert against (0,-1,0), a red directional light with
//      a positional mask and a blue bottom fill, with the normal of the NOISE
//      field (from the hash-shared one-sided difference, or its closed-form
//      gradient when ANALYTIC, for the fused noise march; from five
//      independent evaluations for the other fields); shading "emission":
//      the value as colour;
//   5. composite with the clear colour's ambient term (clear.a = 0);
//   6. misses keep the clear colour; alpha out is 1.
//
// What bounds it on this card: arithmetic and divergence. A noise step
// takes ~600 float operations beside its 24 (analytic) or 60 (one-sided
// difference) lattice hashes, and those it reads from a table instead of
// computing them (fields.cuh TableHash: 132111 floats, 0.53 MB, L2-resident,
// built by the plain version's own hash, hash_table.py, shared with K9 and
// K8): the
// octave-1 and -2 arguments (1.3e5-3.5e5) lie past sinf's fast reduction,
// where the accurate sinf took a Payne-Hanek reduction through local memory,
// and one load replaces each, bit for bit. A lattice cell outside the table
// traps: no clamp, no fallback to sinf. Rays stop at their own alpha exit
// and step count, so a warp runs as long as its longest ray (lane efficiency
// 0.70 at 512^2, 0.76 at the demo's 1280x720, PERF.md). The reads are nine
// (H, W) planes once per pixel. The design: one thread per pixel with its
// own loop, so each ray stops at its own alpha exit (the TPU kernel looped a
// whole tile until every lane was done); 32-wide blocks along a row keep the
// plane loads coalesced. The block's height (tile_h) is the xor demo's
// SinglePass/Tile toggle: it changes the schedule, never a pixel.
//
// Numerics: the march repeats its plain version
// (vokselis_torch/ops/cuda/march_field.py:render_field_plain) operation for
// operation, built with --fmad=false; see fields.cuh for the hash and its
// table. Field, shading and gradient are template arguments (7
// instantiations); quantize is a runtime flag.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fields.cuh"

namespace {

constexpr int BLOCK_X = 32;
constexpr int MAX_TILE_H = 16;

enum Field { NOISE = 0, XOR = 1, TRIG = 2 };

// raycast_compute.wgsl:119, the clear colour; its alpha is 0
constexpr float CLEAR_R = 0.023f, CLEAR_G = 0.02f, CLEAR_B = 0.02f;
// the red directional light (-2,-2,-1)/3 and the mask direction (1,1,-1)/sqrt(3)
constexpr float L_XY = (float)(-2.0 / 3.0);
constexpr float L_Z = (float)(-1.0 / 3.0);
constexpr float MASK_N = (float)0.5773502691896258;
constexpr float INV_DMASK = (float)(1.0 / (1.5 - 0.3));  // smoothstep(0.3, 1.5, .)
constexpr float INV_VOL_ALPHA = (float)(1.0 / (0.7 - 0.0));  // smoothstep(0.0, 0.7, .)

// K2 shading (raycast_compute.wgsl:73-86) of the value val with normal n at
// the world position p
__device__ __forceinline__ void xor_shade(float val, float nx, float ny, float nz, float px,
                                          float py, float pz, float& cr, float& cg,
                                          float& cb) {
  const float v = val * 0.5f;
  const float sh = fmaxf(-ny, 0.0f);
  const float dshade = fmaxf(nx * L_XY + ny * L_XY + nz * L_Z, 0.0f);
  const float dmask = vkf::smoothstep(0.3f, INV_DMASK, px * MASK_N + py * MASK_N + pz * -MASK_N);
  const float d = 3.0f * dshade * dmask;
  const float vr = v + d * 1.0f;
  const float vg = v + d * 0.1f;
  const float vb = v + d * 0.13f;
  const float bottom = 0.9f * vkf::clamp01(0.5f - 0.5f * ny);
  const float shrg = vkf::mix(sh, bottom * 0.0f, 0.2f);
  const float shb = vkf::mix(sh, bottom * 0.6f, 0.2f);
  cr = vr * shrg;
  cg = vg * shrg;
  cb = vb * shb;
}

template <int FIELD>
__device__ __forceinline__ float field_value(float cx, float cy, float cz, float time,
                                             float& alpha, const vkf::TableHash& tab) {
  if (FIELD == NOISE) return vkf::noise_volume(cx, cy, cz, time, alpha, tab);
  if (FIELD == XOR) return vkf::xor_field(cx, cy, cz, time, alpha);
  return vkf::trig_field(cx, cy, cz, time, alpha);
}

template <int FIELD, bool XOR_SHADE, bool ANALYTIC>
__global__ void __launch_bounds__(BLOCK_X* MAX_TILE_H)
    march_field_kernel(const float* __restrict__ tvec, const float* __restrict__ exs,
                       const float* __restrict__ eys, const float* __restrict__ ezs,
                       const float* __restrict__ dxs, const float* __restrict__ dys,
                       const float* __restrict__ dzs, const float* __restrict__ t0s,
                       const float* __restrict__ t1s, const float* __restrict__ dts,
                       int height, int width, int dims, float inv_dims, int quantize,
                       int max_steps, const vkf::TableHash tab, float* __restrict__ out) {
  const int ix = blockIdx.x * BLOCK_X + threadIdx.x;
  const int iy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ix >= width || iy >= height) return;
  const size_t pix = (size_t)iy * width + ix;
  const float t_raw = __ldg(tvec), sin_t = __ldg(tvec + 1);
  const float field_time = FIELD == TRIG ? t_raw : sin_t;
  const float ex = exs[pix], ey = eys[pix], ez = ezs[pix];
  const float dx = dxs[pix], dy = dys[pix], dz = dzs[pix];
  const float t1 = t1s[pix], dt = dts[pix];
  float t = t0s[pix];
  const bool hit = t < t1;
  const float half = 0.5f * (float)dims, hi = (float)(dims - 1);

  float r = CLEAR_R, g = CLEAR_G, b = CLEAR_B, a = 0.1f;
  if (hit) {
    for (int i = 0; i < max_steps; ++i) {
      if (!(t < t1) || !(a < 0.95f)) break;
      const float px = ex + t * dx, py = ey + t * dy, pz = ez + t * dz;
      float cx = px, cy = py, cz = pz;
      if (quantize) {
        // textureLoad at ivec3((p+1)*dims/2) -> the voxel-centre coordinate
        cx = (fminf(fmaxf(floorf((px + 1.0f) * half), 0.0f), hi) - half) * inv_dims;
        cy = (fminf(fmaxf(floorf((py + 1.0f) * half), 0.0f), hi) - half) * inv_dims;
        cz = (fminf(fmaxf(floorf((pz + 1.0f) * half), 0.0f), hi) - half) * inv_dims;
      }
      float val, valpha, cr, cg, cb;
      if (FIELD == NOISE && XOR_SHADE) {
        float nx, ny, nz;
        val = ANALYTIC
                  ? vkf::noise_volume_grad_analytic(cx, cy, cz, sin_t, valpha, nx, ny, nz, tab)
                  : vkf::noise_volume_grad(cx, cy, cz, sin_t, valpha, nx, ny, nz, tab);
        xor_shade(val, nx, ny, nz, px, py, pz, cr, cg, cb);
      } else {
        val = field_value<FIELD>(cx, cy, cz, field_time, valpha, tab);
        if (XOR_SHADE) {
          // the normal is the noise field's, whatever the field
          float nx, ny, nz;
          vkf::gradient(cx, cy, cz, sin_t, nx, ny, nz, tab);
          xor_shade(val, nx, ny, nz, px, py, pz, cr, cg, cb);
        } else {
          cr = cg = cb = val;
        }
      }
      const float vol_alpha = vkf::smoothstep(0.0f, INV_VOL_ALPHA, valpha * valpha * valpha);
      // front-to-back with the clear colour's ambient term (:88-91), whose
      // factor clear.rgb * clear.a is 0
      const float w = (1.0f - a) * vol_alpha;
      const float ambient = 0.0f * (1.0f - vol_alpha);
      r = r + w * cr + ambient;
      g = g + w * cg + ambient;
      b = b + w * cb + ambient;
      a = a + w * 1.0f;
      t = t + dt;
    }
  }
  reinterpret_cast<float4*>(out)[pix] = make_float4(r, g, b, 1.0f);
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*, const float*,
                          const float*, const float*, const float*, const float*, const float*,
                          int, int, int, float, int, int, const vkf::TableHash, float*);

KernelFn pick(int field, int xor_shade, int analytic) {
  if (field == NOISE && xor_shade)
    return analytic ? march_field_kernel<NOISE, true, true> : march_field_kernel<NOISE, true, false>;
  if (field == NOISE) return march_field_kernel<NOISE, false, false>;
  if (field == XOR)
    return xor_shade ? march_field_kernel<XOR, true, false> : march_field_kernel<XOR, false, false>;
  if (field == TRIG)
    return xor_shade ? march_field_kernel<TRIG, true, false>
                     : march_field_kernel<TRIG, false, false>;
  return nullptr;
}

}  // namespace

extern "C" {

const char* vk_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches K7 on `stream` and returns the launch's cudaError_t (0 on
// success). Device pointers: tvec (2 f32: raw time, sin(time)); ex..dt (nine
// height*width f32 planes: eye, direction, t0, t1, dt); hash (the f32 hash
// table: octave o's hash(n) at hash[off_o + n - lo_o] for n - lo_o in
// [0, last_o + 271]); out (height*width*4 f32, 16-byte aligned). field: 0
// noise, 1 xor, 2 trig; tile_h: the block's rows (1, 2, 4, 8 or 16), 32
// columns each. A lattice cell outside the table traps in the kernel: the
// launch fails, and the stream's next synchronization reports it.
int vk_march_field(const void* tvec, const void* ex, const void* ey, const void* ez,
                   const void* dx, const void* dy, const void* dz, const void* t0,
                   const void* t1, const void* dt, int height, int width, int field,
                   int xor_shade, int analytic, int quantize, int dims, float inv_dims,
                   int max_steps, int tile_h, const void* hash, int lo0, int lo1, int lo2,
                   int off0, int off1, int off2, int last0, int last1, int last2, void* out,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (height <= 0 || width <= 0) return (int)cudaSuccess;
  KernelFn kernel = pick(field, xor_shade, analytic);
  if (kernel == nullptr || tile_h < 1 || tile_h > MAX_TILE_H || (tile_h & (tile_h - 1)))
    return (int)cudaErrorInvalidValue;
  if (hash == nullptr || last0 < 0 || last1 < 0 || last2 < 0)
    return (int)cudaErrorInvalidValue;
  const vkf::TableHash tab{(const float*)hash, {lo0, lo1, lo2}, {off0, off1, off2},
                           {last0, last1, last2}};
  const dim3 block(BLOCK_X, tile_h);
  const dim3 grid((width + BLOCK_X - 1) / BLOCK_X, (height + tile_h - 1) / tile_h);
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)tvec, (const float*)ex, (const float*)ey, (const float*)ez,
      (const float*)dx, (const float*)dy, (const float*)dz, (const float*)t0,
      (const float*)t1, (const float*)dt, height, width, dims, inv_dims, quantize, max_steps,
      tab, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
