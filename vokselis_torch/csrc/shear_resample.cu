// The shear-warp fast renderer's two slab stages, for NVIDIA Hopper (sm_90a):
// K3 resamples every pre-blended slab onto the intermediate grid, K4
// composites the resampled stack front to back.
//
// K3 replaces vokselis_tpu/ops/pallas/shear_resample.py:_resample_kernel
// (launched by resample_slabs). Slab k's value at intermediate texel (i, u) is
//   sum_dv sum_du wv[k,dv,i] * volm[k,dv,du] * wu[k,du,u],
// hat weights max(0, 1 - |pos - col|) over cols [0, D-1]: a bilinear sample of
// the slab at (pos_v[k,i], pos_u[k,u]) that is zero outside [0, D-1]. The TPU
// ran it as two hat-weight matmuls on the MXU (bf16 weights, bf16 partial
// product); here one thread per (k, i, u), u fastest, gathers the four taps
// from the bf16 slab and lerps in float32, then rounds to bf16 once:
//   f = pos - floor(pos); a tap outside [0, D-1] reads 0;
//   top = a00 + (a01 - a00) * fu; bot = a10 + (a11 - a10) * fu;
//   val = top + (bot - top) * fv.
// Rows k >= G (padding, pos = -1e6) and slabs whose occupancy gate is 0 are
// written as exact zeros, so a reader that ignores the gates still sees what
// the TPU kernel wrote (shear_resample.py:169-173).
// What bounds it: bytes. It writes the (gp, I, I) bf16 stack (134 MB at
// gp=256, I=512: ~40 us at 3.35 TB/s) and reads the occupied slabs (<= 33 MB,
// resident in the 50 MB L2 across frames). The design writes the stack in the
// order the composite reads it, with consecutive threads on consecutive u so
// that both the stores and the tap loads (neighbouring u sample neighbouring
// columns of one slab row) coalesce. The dominant axis m picks the pack on the
// device (*m), so the host never reads it.
//
// K4 replaces vokselis_tpu/ops/pallas/shear_resample.py:_composite_chunks_kernel
// (composite_chunks) and, in its exact-transfer mode, composite.py:
// _composite_kernel (composite_pallas). One thread per intermediate texel
// (i, u) walks the slabs in marching order (ascending k when *sgn > 0) with
// the rgba sum in registers:
//   tv = smoothstep(0.10, 1.2, min(0.9, s)) (the clamp-argument quirk);
//   low-degree mode: palette from the _PAL_*_LO Horner polynomials of
//     u = (2 / TVMAX) * tv - 1 (colors.bonsai_transfer_pow_lowdeg_soa);
//   exact mode: palette 0.5 + 0.5 * cosf(TAU * (c * tv + d))
//     (colors.bonsai_transfer_soa);
//   both: alpha = 1 - expf(irho * logf(1 - tv)) (irho >= 1 exact-march steps
//     per slab), w = (1 - a) * alpha, rgb += w * palette, a += w.
// A slab whose (slab, row-block) occupancy gate is 0 is skipped (its samples
// are <= OCC_EPS = 0.1, transfer 0), and the loop stops once a >= 0.95: the
// TPU's live mask zeroes every later weight (shear_resample.py:293-295), so
// both are exact. What bounds it: reading the stack (134 MB at I=512, ~40 us)
// against ~40 float operations a sample plus expf/logf (cosf in the exact
// mode); stack reads are coalesced across u, and empty and saturated texels
// read nothing. None of the TPU's chunked (C, nrb, 8, 8, I) layout, scalar
// prefetch or DMA double-buffering exists here: the stack is a plain
// (gp, I, I) array.
//
// Numerics: both kernels repeat their plain versions' float32 operations in
// order (vokselis_torch/ops/cuda/shear_resample.py) and the library is built
// with --fmad=false, so no a*b+c becomes an fma the plain version lacks. A
// division by a constant is a multiplication by its reciprocal taken in
// double and rounded to float, as PyTorch's CUDA division by a Python scalar
// computes it; every other constant is a double rounded to float, as a Python
// scalar meets a float32 tensor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RS_BLOCK = 128;  // K3 threads per block, along u
constexpr int CP_BLOCK = 128;  // K4 threads per block, along u

constexpr float TAU = 6.28318f;  // shaders/raycast_naive.wgsl:70, not 2*pi
constexpr float INV_SMOOTH_SPAN = (float)(1.0 / (1.2 - 0.10));  // smoothstep(0.10, 1.2, .)
constexpr double TVMAX = 0.8174305033809168;  // smoothstep(0.10, 1.2, 0.9)
constexpr float U_SCALE = (float)(2.0 / TVMAX);

// colors._PAL_R_LO / _PAL_G_LO / _PAL_B_LO, highest degree first
__constant__ float PAL_R_LO[9] = {
    (float)-0.01637626811861992, (float)0.032187458127737045, (float)0.16447384655475616,
    (float)-0.2470930814743042, (float)-0.7600758671760559, (float)0.7643266916275024,
    (float)1.384738564491272, (float)-0.696631133556366, (float)0.08001549541950226};
__constant__ float PAL_G_LO[12] = {
    (float)-0.07604426890611649, (float)-0.12505008280277252, (float)0.6126497983932495,
    (float)0.8453051447868347, (float)-2.4561009407043457, (float)-2.66123104095459,
    (float)5.46185302734375, (float)4.237965106964111, (float)-5.73836088180542,
    (float)-2.6728928089141846, (float)1.8067647218704224, (float)0.7805516123771667};
__constant__ float PAL_B_LO[6] = {
    (float)-0.003448813920840621, (float)-0.014389974996447563, (float)0.0682404488325119,
    (float)0.17226645350456238, (float)-0.38846614956855774, (float)0.17294341325759888};

template <int N>
__device__ __forceinline__ float horner(const float (&c)[N], float u) {
  float acc = c[0];
#pragma unroll
  for (int j = 1; j < N; ++j) acc = acc * u + c[j];
  return acc;
}

__device__ __forceinline__ float tap(const __nv_bfloat16* __restrict__ slab, int d,
                                     bool ok, int v, int u) {
  return ok ? __bfloat162float(slab[(size_t)v * d + u]) : 0.0f;
}

__global__ void __launch_bounds__(RS_BLOCK)
    resample_kernel(const __nv_bfloat16* __restrict__ packs, int n_packs,
                    const int* __restrict__ m_ptr, int g, int d,
                    const float* __restrict__ pos_u, const float* __restrict__ pos_v,
                    const uint8_t* __restrict__ occ, int iv, int iu,
                    __nv_bfloat16* __restrict__ out) {
  const int u = blockIdx.x * RS_BLOCK + threadIdx.x;
  const int i = blockIdx.y;
  const int k = blockIdx.z;
  if (u >= iu) return;
  float val = 0.0f;
  if (k < g && (occ == nullptr || occ[k] != 0)) {
    int m = __ldg(m_ptr);
    m = m < 0 ? 0 : (m >= n_packs ? n_packs - 1 : m);
    const __nv_bfloat16* slab = packs + ((size_t)m * g + k) * (size_t)d * d;
    const float pv = __ldg(pos_v + (size_t)k * iv + i);
    const float pu = __ldg(pos_u + (size_t)k * iu + u);
    const float v0f = floorf(pv), u0f = floorf(pu);
    const float fv = pv - v0f, fu = pu - u0f;
    const float hi = (float)(d - 1);
    // range tests in float: a far-off position never reaches an int cast
    const bool v0ok = v0f >= 0.0f && v0f <= hi;
    const bool v1ok = v0f >= -1.0f && v0f <= hi - 1.0f;
    const bool u0ok = u0f >= 0.0f && u0f <= hi;
    const bool u1ok = u0f >= -1.0f && u0f <= hi - 1.0f;
    const int v0 = (v0ok || v1ok) ? (int)v0f : 0;
    const int u0 = (u0ok || u1ok) ? (int)u0f : 0;
    const float a00 = tap(slab, d, v0ok && u0ok, v0, u0);
    const float a01 = tap(slab, d, v0ok && u1ok, v0, u0 + 1);
    const float a10 = tap(slab, d, v1ok && u0ok, v0 + 1, u0);
    const float a11 = tap(slab, d, v1ok && u1ok, v0 + 1, u0 + 1);
    const float top = a00 + (a01 - a00) * fu;
    const float bot = a10 + (a11 - a10) * fu;
    val = top + (bot - top) * fv;
  }
  out[((size_t)k * iv + i) * iu + u] = __float2bfloat16_rn(val);
}

__global__ void __launch_bounds__(CP_BLOCK)
    composite_kernel(const __nv_bfloat16* __restrict__ stack, int g, int iv, int iu,
                     const int* __restrict__ sgn_ptr, const float* __restrict__ irho,
                     const uint8_t* __restrict__ occ, int nrb, int rows_per_block,
                     int exact, float* __restrict__ out) {
  const int u = blockIdx.x * CP_BLOCK + threadIdx.x;
  const int i = blockIdx.y;
  if (u >= iu) return;
  const size_t plane = (size_t)iv * iu;
  const size_t px = (size_t)i * iu + u;
  const bool ascending = __ldg(sgn_ptr) > 0;
  const float rho = irho[px];
  const int rb = i / rows_per_block;
  float r = 0.0f, gg = 0.0f, b = 0.0f, a = 0.0f;
  for (int t = 0; t < g; ++t) {
    if (!(a < 0.95f)) break;
    const int k = ascending ? t : g - 1 - t;
    if (occ != nullptr && occ[(size_t)k * nrb + rb] == 0) continue;
    const float s = __bfloat162float(stack[(size_t)k * plane + px]);
    float tv = (fminf(s, 0.9f) - 0.10f) * INV_SMOOTH_SPAN;
    tv = fminf(fmaxf(tv, 0.0f), 1.0f);
    tv = tv * tv * (3.0f - 2.0f * tv);
    float cr, cg, cb;
    if (exact) {
      cr = 0.5f + 0.5f * cosf(TAU * (1.0f * tv + 0.0f));
      cg = 0.5f + 0.5f * cosf(TAU * (1.7f * tv + 0.15f));
      cb = 0.5f + 0.5f * cosf(TAU * (0.4f * tv + 0.20f));
    } else {
      const float pu = U_SCALE * tv - 1.0f;
      cr = horner(PAL_R_LO, pu);
      cg = horner(PAL_G_LO, pu);
      cb = horner(PAL_B_LO, pu);
    }
    const float alpha = 1.0f - expf(rho * logf(1.0f - tv));
    const float w = (1.0f - a) * alpha;
    r = r + w * cr;
    gg = gg + w * cg;
    b = b + w * cb;
    a = a + w;
  }
  out[px] = r;
  out[plane + px] = gg;
  out[2 * plane + px] = b;
  out[3 * plane + px] = a;
}

}  // namespace

extern "C" {

const char* vk_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K3 on `stream`; returns the launch's cudaError_t (0 on success). Device
// pointers: packs (n_packs * g * d * d bf16), m (1 int32: the pack to
// resample), pos_u (gp * iu f32), pos_v (gp * iv f32), occ (gp uint8, or
// null for all hot), out (gp * iv * iu bf16).
int vk_resample_slabs(const void* packs, int n_packs, const void* m, int g, int d,
                      const void* pos_u, const void* pos_v, const void* occ, int gp,
                      int iv, int iu, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (gp <= 0 || iv <= 0 || iu <= 0) return (int)cudaSuccess;
  const dim3 grid((iu + RS_BLOCK - 1) / RS_BLOCK, iv, gp);
  resample_kernel<<<grid, RS_BLOCK, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)packs, n_packs, (const int*)m, g, d, (const float*)pos_u,
      (const float*)pos_v, (const uint8_t*)occ, iv, iu, (__nv_bfloat16*)out);
  return (int)cudaGetLastError();
}

// K4 on `stream`; returns the launch's cudaError_t. Device pointers: stack
// (g * iv * iu bf16), sgn (1 int32: > 0 marches ascending k), irho (iv * iu
// f32), occ (g * nrb uint8 per (slab, block of rows_per_block rows), or null),
// out (4 * iv * iu f32: r, g, b, a planes). exact != 0 selects the
// transcendental transfer.
int vk_composite(const void* stack, int g, int iv, int iu, const void* sgn,
                 const void* irho, const void* occ, int nrb, int rows_per_block,
                 int exact, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (iv <= 0 || iu <= 0) return (int)cudaSuccess;
  const dim3 grid((iu + CP_BLOCK - 1) / CP_BLOCK, iv);
  composite_kernel<<<grid, CP_BLOCK, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)stack, g, iv, iu, (const int*)sgn, (const float*)irho,
      (const uint8_t*)occ, nrb, rows_per_block, exact, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
