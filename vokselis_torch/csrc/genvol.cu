// K9 and K8: procedural volume generation (shaders/xor.wgsl cs_main, :69-78),
// one thread per voxel, for NVIDIA Hopper (sm_90a).
//
// K9 replaces the TPU kernel vokselis_tpu/ops/pallas/genvol.py:_genvol_kernel
// (launched by generate_xor_volumes_pallas): at every voxel centre of a dims^3
// grid, c = (index - dims/2) / dims, the fbm field's value and alpha and the
// one-sided-difference normal of its alpha, written straight into the two
// (D, D, D, 4) f32 textures the oracle render_compute_tex reads:
// density (val/2, val/2, val/2, alpha) and normal (n, |n|). The TPU kernel wrote
// five planes that XLA then stacked; here each thread stores two float4s.
// It takes the hash-shared fbm4 (fields.cuh): 60 sines a voxel instead of the
// plain version's 120, bitwise the same values (the lattice arithmetic is
// exact, so shared corner hashes are the same hashes).
//
// K8 replaces genvol.py:_gendensity_kernel (generate_density_u8_pallas): the
// fbm alpha at every voxel centre, quantized to the bonsai march's uint8
// format, clip(alpha * 255 + 0.5, 0, 255) truncated, in one pass (the TPU
// kernel wrote f32 alpha and XLA quantized it).
//
// What bounds them on this card: arithmetic (24 or 60 sines a voxel, the
// octave-2/3 arguments on sinf's slow path) far more than the stores (32 B or
// 1 B a voxel). Blocks of 32 x 8 voxels along x and y, one z-slice per grid
// row, keep the stores coalesced. sin(time) is read from device memory.
//
// Numerics: each thread repeats the plain versions
// (vokselis_torch/ops/cuda/genvol.py) operation for operation, built with
// --fmad=false; see fields.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fields.cuh"

namespace {

constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;

// the voxel-centre coordinate of this thread: (index - dims/2) / dims
__device__ __forceinline__ bool voxel(int dims, float inv_dims, float& cx, float& cy,
                                      float& cz, size_t& idx) {
  const int x = blockIdx.x * BLOCK_X + threadIdx.x;
  const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
  const int z = blockIdx.z;
  if (x >= dims || y >= dims) return false;
  const float half = 0.5f * (float)dims;
  cx = ((float)x - half) * inv_dims;
  cy = ((float)y - half) * inv_dims;
  cz = ((float)z - half) * inv_dims;
  idx = ((size_t)z * dims + y) * dims + x;
  return true;
}

__global__ void __launch_bounds__(BLOCK_X* BLOCK_Y)
    genvol_kernel(const float* __restrict__ sin_t_ptr, int dims, float inv_dims,
                  float* __restrict__ density, float* __restrict__ normal) {
  float cx, cy, cz;
  size_t idx;
  if (!voxel(dims, inv_dims, cx, cy, cz, idx)) return;
  const float sin_t = __ldg(sin_t_ptr);
  float alpha, nx, ny, nz;
  const float val = vkf::noise_volume_grad(cx, cy, cz, sin_t, alpha, nx, ny, nz);
  const float nmag = sqrtf(nx * nx + ny * ny + nz * nz);
  const float v2 = val * 0.5f;
  reinterpret_cast<float4*>(density)[idx] = make_float4(v2, v2, v2, alpha);
  reinterpret_cast<float4*>(normal)[idx] = make_float4(nx, ny, nz, nmag);
}

__global__ void __launch_bounds__(BLOCK_X* BLOCK_Y)
    gendensity_kernel(const float* __restrict__ sin_t_ptr, int dims, float inv_dims,
                      uint8_t* __restrict__ out) {
  float cx, cy, cz;
  size_t idx;
  if (!voxel(dims, inv_dims, cx, cy, cz, idx)) return;
  const float alpha = vkf::noise_volume_alpha(cx, cy, cz, __ldg(sin_t_ptr));
  out[idx] = (uint8_t)fminf(fmaxf(alpha * 255.0f + 0.5f, 0.0f), 255.0f);
}

dim3 grid_of(int dims) {
  return dim3((dims + BLOCK_X - 1) / BLOCK_X, (dims + BLOCK_Y - 1) / BLOCK_Y, dims);
}

}  // namespace

extern "C" {

const char* vk_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K9 on `stream`; returns the launch's cudaError_t. Device pointers: sin_t (1
// f32), density and normal (dims^3 * 4 f32 each, [z][y][x][channel], 16-byte
// aligned).
int vk_genvol(const void* sin_t, int dims, float inv_dims, void* density, void* normal,
              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dims <= 0) return (int)cudaSuccess;
  genvol_kernel<<<grid_of(dims), dim3(BLOCK_X, BLOCK_Y), 0, (cudaStream_t)stream>>>(
      (const float*)sin_t, dims, inv_dims, (float*)density, (float*)normal);
  return (int)cudaGetLastError();
}

// K8 on `stream`; returns the launch's cudaError_t. Device pointers: sin_t (1
// f32), out (dims^3 uint8, [z][y][x]).
int vk_gendensity(const void* sin_t, int dims, float inv_dims, void* out, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dims <= 0) return (int)cudaSuccess;
  gendensity_kernel<<<grid_of(dims), dim3(BLOCK_X, BLOCK_Y), 0, (cudaStream_t)stream>>>(
      (const float*)sin_t, dims, inv_dims, (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
