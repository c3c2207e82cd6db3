// K9 and K8: procedural volume generation (shaders/xor.wgsl cs_main, :69-78)
// for NVIDIA Hopper (sm_90a).
//
// K9 replaces the TPU kernel vokselis_tpu/ops/pallas/genvol.py:_genvol_kernel
// (launched by generate_xor_volumes_pallas): at every voxel centre of a dims^3
// grid, c = (index - dims/2) / dims, the fbm field's value and alpha and the
// one-sided-difference normal of its alpha, written straight into the two
// (D, D, D, 4) f32 textures the oracle render_compute_tex reads:
// density (val/2, val/2, val/2, alpha) and normal (n, |n|). The TPU kernel wrote
// five planes that XLA then stacked; here each voxel stores two float4s.
//
// K8 replaces genvol.py:_gendensity_kernel (generate_density_u8_pallas): the
// fbm alpha at every voxel centre, quantized to the bonsai march's uint8
// format, clip(alpha * 255 + 0.5, 0, 255) truncated, in one pass (the TPU
// kernel wrote f32 alpha and XLA quantized it).
//
// What bounds them on this card: arithmetic. Evaluated voxel by voxel, the
// field takes 24 lattice hashes a voxel (K8; 60 for K9's value and its three
// offset points), each a sine whose octave-1 and -2 arguments (1.3e5-3.5e5)
// lie past sinf's fast reduction, and ~280 (K8) or ~840 (K9) float
// operations. The design removes most of both:
//   1. Hashes come from the shared table (hash_table.py; the plain version's
//      own hash, filled on the card), not sinf. At block start each octave's
//      window of the table that the block's brick can reach is copied into
//      shared memory (cp.async): the lattice argument n = px + 157 py + 113 pz
//      is monotone in every voxel index and sin t is one value per launch, so
//      the window is the interval from the brick's low corner's cell (for K9
//      its one-sided offset point's) to its high corner's cell + 271. A
//      window outside the table or its capacity, or a read outside the
//      window, traps.
//   2. A block covers a brick: 32 voxels along x, brick_y rows of y and
//      brick_z slices of z that each thread walks in order. Along the walk x
//      and y stay fixed, so each octave's x and y floors and smoothed
//      fractions are computed once, and so is each lattice plane's x-y mix:
//        mix8(h0..h7, fx, fy, fz) = mix(P(pz), P(pz + 1), fz),
//        P(p) = mix(mix(h(n_p), h(n_p + 1), fx), mix(h(n_p + 157), h(n_p + 158), fx), fy)
//      with n_p = px + 157 py + 113 p (n_pz + 113 is n_(pz+1) exactly). P is
//      a function of the plane alone, so it is mixed once per walk and reused
//      while pz stays (16 voxels at octave 0 at 512^3, 4 at octave 2); every
//      thread of a block is at the same z, so the reuse never diverges. K9's
//      offset points read the planes of their own x (or y) column, or the
//      plane below.
//   3. K8 gives each thread 4 consecutive x voxels, stored as one uchar4;
//      K9's two float4s a voxel coalesce as they are.
//
// Numerics: every voxel's float32 operations are the plain versions'
// (vokselis_torch/ops/cuda/genvol.py: fields_soa.noise_volume and gradient)
// in the same order, built with --fmad=false; only where a hash comes from and
// which thread computes (or has computed) a value change, so both kernels are
// bitwise equal to their plain versions. See fields.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fields.cuh"

namespace {

constexpr int OCTAVES = 3;
constexpr int BRICK_X = 32;  // voxels along x of a brick
constexpr int K8_VX = 4;     // K8: consecutive x voxels a thread (one uchar4)
constexpr int MAX_THREADS = 256;
constexpr int NO_PLANE = -0x7fffffff;  // a plane key no lattice plane has

// the launch's table, and each octave's window capacity (floats) and start
// in the kernel's dynamic shared memory
struct Windows {
  vkf::TableHash tab;
  int cap[OCTAVES], seg[OCTAVES];
};

__device__ __forceinline__ float centre(int i, float half, float inv_dims) {
  return ((float)i - half) * inv_dims;
}

// one axis's lattice terms of every octave at lattice coordinate v: the
// floor and the smoothed fraction (fields_soa.noise, fbm's scaling)
struct Axis {
  float p[OCTAVES], f[OCTAVES];
};

__device__ __forceinline__ Axis axis(float v) {
  Axis a;
#pragma unroll
  for (int o = 0; o < OCTAVES; ++o) {
    a.p[o] = floorf(v);
    a.f[o] = vkf::smooth(v - a.p[o]);
    if (o < OCTAVES - 1) v = v * vkf::scale(o);
  }
  return a;
}

// Copy each octave's window of the table for the brick lo..hi (voxel indices,
// inclusive) into shared memory, asynchronously (wait_windows waits). With
// OFFSETS the low end is the low corner's one-sided offset point (K9).
// Returns each octave's first lattice argument (base) and the largest window
// index a plane's first corner may take (lim; its last is + 158). Traps if a
// window leaves the table or its capacity.
template <bool OFFSETS>
__device__ __forceinline__ void load_windows(const Windows& w, float* smem, int3 lo, int3 hi,
                                             float half, float inv_dims, float sin_t,
                                             int (&base)[OCTAVES], int (&lim)[OCTAVES]) {
  float cx = centre(lo.x, half, inv_dims), cy = centre(lo.y, half, inv_dims),
        cz = centre(lo.z, half, inv_dims);
  if (OFFSETS) {
    cx = cx - vkf::EPS;
    cy = cy - vkf::EPS;
    cz = cz - vkf::EPS;
  }
  const Axis lx = axis(vkf::lattice_x(cx)), ly = axis(vkf::lattice_y(cy, sin_t)),
             lz = axis(vkf::lattice_z(cz));
  const Axis hx = axis(vkf::lattice_x(centre(hi.x, half, inv_dims))),
             hy = axis(vkf::lattice_y(centre(hi.y, half, inv_dims), sin_t)),
             hz = axis(vkf::lattice_z(centre(hi.z, half, inv_dims)));
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, n_threads = blockDim.x * blockDim.y;
#pragma unroll
  for (int o = 0; o < OCTAVES; ++o) {
    // exact: integers below 2^24; a NaN fails every test
    const float i_lo = vkf::lattice_n(lx.p[o], ly.p[o], lz.p[o]) - (float)w.tab.lo[o];
    const float i_hi = vkf::lattice_n(hx.p[o], hy.p[o], hz.p[o]) - (float)w.tab.lo[o];
    if (!(i_lo >= 0.0f && i_hi <= (float)w.tab.last[o] &&
          i_hi - i_lo + 272.0f <= (float)w.cap[o]))
      __trap();
    const int len = (int)(i_hi - i_lo) + 272;
    base[o] = w.tab.lo[o] + (int)i_lo;
    lim[o] = len - 159;
    const float* src = w.tab.values + w.tab.off[o] + (int)i_lo;
    float* dst = smem + w.seg[o];
    for (int k = tid; k < len; k += n_threads) {
      const unsigned d = (unsigned)__cvta_generic_to_shared(dst + k);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src + k)
                   : "memory");
    }
  }
}

__device__ __forceinline__ void wait_windows() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// the window index of lattice column (px, py) at plane 0: (px + 157 py) - base
__device__ __forceinline__ int column(float px, float py, int base) {
  return (int)(px + py * 157.0f) - base;
}

// P(p): the x-y mix of the lattice plane whose first corner sits at window
// index i (n_p - base); traps outside the window
__device__ __forceinline__ float plane(const float* win, int i, int lim, float fx, float fy) {
  if ((unsigned)i > (unsigned)lim) __trap();
  return vkf::mix(vkf::mix(win[i], win[i + 1], fx), vkf::mix(win[i + 157], win[i + 158], fx),
                  fy);
}

__global__ void __launch_bounds__(MAX_THREADS)
    gendensity_kernel(const float* __restrict__ sin_t_ptr, int dims, float inv_dims,
                      int brick_z, const Windows w, uint8_t* __restrict__ out) {
  extern __shared__ float smem[];
  const float sin_t = __ldg(sin_t_ptr);
  const float half = 0.5f * (float)dims;
  const int x0 = blockIdx.x * BRICK_X, y0 = blockIdx.y * blockDim.y, z0 = blockIdx.z * brick_z;
  const int z1 = min(z0 + brick_z, dims);
  int base[OCTAVES], lim[OCTAVES];
  load_windows<false>(w, smem, make_int3(x0, y0, z0),
                      make_int3(min(x0 + BRICK_X, dims) - 1,
                                min(y0 + (int)blockDim.y, dims) - 1, z1 - 1),
                      half, inv_dims, sin_t, base, lim);

  // this thread's 4 voxels of a row (clamped into the grid; only those
  // inside store) and their lattice columns
  const int xt = x0 + K8_VX * threadIdx.x, y = y0 + threadIdx.y;
  const float cy = centre(min(y, dims - 1), half, inv_dims);
  const Axis ay = axis(vkf::lattice_y(cy, sin_t));
  float cx[K8_VX], fx[K8_VX][OCTAVES];
  int col[K8_VX][OCTAVES];
#pragma unroll
  for (int v = 0; v < K8_VX; ++v) {
    cx[v] = centre(min(xt + v, dims - 1), half, inv_dims);
    const Axis ax = axis(vkf::lattice_x(cx[v]));
#pragma unroll
    for (int o = 0; o < OCTAVES; ++o) {
      fx[v][o] = ax.f[o];
      col[v][o] = column(ax.p[o], ay.p[o], base[o]);
    }
  }
  wait_windows();

  // per octave: planes pz (p0) and pz + 1 (p1) of each voxel's column
  float p0[K8_VX][OCTAVES], p1[K8_VX][OCTAVES];
  int key[OCTAVES];
#pragma unroll
  for (int o = 0; o < OCTAVES; ++o) key[o] = NO_PLANE;
  const bool vec = dims % K8_VX == 0;
  for (int z = z0; z < z1; ++z) {
    const float cz = centre(z, half, inv_dims);
    const Axis az = axis(vkf::lattice_z(cz));
    float f[K8_VX];
#pragma unroll
    for (int o = 0; o < OCTAVES; ++o) {
      const float* win = smem + w.seg[o];
      const int pz = (int)az.p[o];
      if (pz != key[o]) {  // the same for every thread of the block
        const bool next = pz == key[o] + 1;
#pragma unroll
        for (int v = 0; v < K8_VX; ++v) {
          p0[v][o] = next ? p1[v][o]
                          : plane(win, col[v][o] + 113 * pz, lim[o], fx[v][o], ay.f[o]);
          p1[v][o] = plane(win, col[v][o] + 113 * (pz + 1), lim[o], fx[v][o], ay.f[o]);
        }
        key[o] = pz;
      }
#pragma unroll
      for (int v = 0; v < K8_VX; ++v) {
        const float n = vkf::mix(p0[v][o], p1[v][o], az.f[o]);
        f[v] = o == 0 ? vkf::amp(0) * n : f[v] + vkf::amp(o) * n;
      }
    }
    if (y >= dims) continue;
    uint8_t q[K8_VX];
#pragma unroll
    for (int v = 0; v < K8_VX; ++v) {
      const float alpha =
          f[v] * vkf::smoothstep(0.5f, vkf::INV_NOISE_WIN, vkf::radius(cx[v], cy, cz));
      q[v] = (uint8_t)fminf(fmaxf(alpha * 255.0f + 0.5f, 0.0f), 255.0f);
    }
    const size_t row = ((size_t)z * dims + y) * dims;
    if (vec && xt < dims) {
      *reinterpret_cast<uchar4*>(out + row + xt) = make_uchar4(q[0], q[1], q[2], q[3]);
    } else {
#pragma unroll
      for (int v = 0; v < K8_VX; ++v)
        if (xt + v < dims) out[row + xt + v] = q[v];
    }
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
    genvol_kernel(const float* __restrict__ sin_t_ptr, int dims, float inv_dims, int brick_z,
                  const Windows w, float* __restrict__ density, float* __restrict__ normal) {
  extern __shared__ float smem[];
  const float sin_t = __ldg(sin_t_ptr);
  const float half = 0.5f * (float)dims;
  const int x0 = blockIdx.x * BRICK_X, y0 = blockIdx.y * blockDim.y, z0 = blockIdx.z * brick_z;
  const int z1 = min(z0 + brick_z, dims);
  int base[OCTAVES], lim[OCTAVES];
  load_windows<true>(w, smem, make_int3(x0, y0, z0),
                     make_int3(min(x0 + BRICK_X, dims) - 1, min(y0 + (int)blockDim.y, dims) - 1,
                               z1 - 1),
                     half, inv_dims, sin_t, base, lim);

  // this thread's voxel column (clamped into the grid; only one inside
  // stores): the lattice columns of its value's cells and of its x- and
  // y-offset points' cells
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  const float cx = centre(min(x, dims - 1), half, inv_dims);
  const float cy = centre(min(y, dims - 1), half, inv_dims);
  const float ox = cx - vkf::EPS, oy = cy - vkf::EPS;
  const Axis ax = axis(vkf::lattice_x(cx)), ay = axis(vkf::lattice_y(cy, sin_t));
  const Axis axe = axis(vkf::lattice_x(ox)), aye = axis(vkf::lattice_y(oy, sin_t));
  int col[OCTAVES], col_x[OCTAVES], col_y[OCTAVES];
#pragma unroll
  for (int o = 0; o < OCTAVES; ++o) {
    col[o] = column(ax.p[o], ay.p[o], base[o]);
    col_x[o] = column(axe.p[o], ay.p[o], base[o]);
    col_y[o] = column(ax.p[o], aye.p[o], base[o]);
  }
  wait_windows();

  // per octave: planes pz and pz + 1 of the value's column (b0, b1) and of
  // the x- and y-offset columns (xp0/1, yp0/1), and plane pz - 1 of the
  // value's column (bm, valid when bm_ok) for the z-offset point
  float b0[OCTAVES], b1[OCTAVES], bm[OCTAVES], xp0[OCTAVES], xp1[OCTAVES], yp0[OCTAVES],
      yp1[OCTAVES];
  int key[OCTAVES];
  bool bm_ok[OCTAVES];
#pragma unroll
  for (int o = 0; o < OCTAVES; ++o) {
    key[o] = NO_PLANE;
    bm_ok[o] = false;
  }
  const bool store = x < dims && y < dims;
  for (int z = z0; z < z1; ++z) {
    const float cz = centre(z, half, inv_dims);
    const float oz = cz - vkf::EPS;
    const Axis az = axis(vkf::lattice_z(cz)), aze = axis(vkf::lattice_z(oz));
    float f0, fxo, fyo, fzo;
#pragma unroll
    for (int o = 0; o < OCTAVES; ++o) {
      const float* win = smem + w.seg[o];
      const int pz = (int)az.p[o], pze = (int)aze.p[o];
      const float fx = ax.f[o], fy = ay.f[o];
      if (pz != key[o]) {  // the same for every thread of the block
        if (pz == key[o] + 1) {
          bm[o] = b0[o];
          bm_ok[o] = true;
          b0[o] = b1[o];
          xp0[o] = xp1[o];
          yp0[o] = yp1[o];
        } else {
          bm_ok[o] = false;
          b0[o] = plane(win, col[o] + 113 * pz, lim[o], fx, fy);
          xp0[o] = plane(win, col_x[o] + 113 * pz, lim[o], axe.f[o], fy);
          yp0[o] = plane(win, col_y[o] + 113 * pz, lim[o], fx, aye.f[o]);
        }
        b1[o] = plane(win, col[o] + 113 * (pz + 1), lim[o], fx, fy);
        xp1[o] = plane(win, col_x[o] + 113 * (pz + 1), lim[o], axe.f[o], fy);
        yp1[o] = plane(win, col_y[o] + 113 * (pz + 1), lim[o], fx, aye.f[o]);
        key[o] = pz;
      }
      // the z-offset point's cell: this one, or the one below (eps moves a
      // point 0.013 cells at most); any other is mixed from the window as is
      float zp0 = b0[o], zp1 = b1[o];
      if (pze != pz) {
        if (pze == pz - 1) {
          if (!bm_ok[o]) {
            bm[o] = plane(win, col[o] + 113 * pze, lim[o], fx, fy);
            bm_ok[o] = true;
          }
          zp0 = bm[o];
          zp1 = b0[o];
        } else {
          zp0 = plane(win, col[o] + 113 * pze, lim[o], fx, fy);
          zp1 = plane(win, col[o] + 113 * (pze + 1), lim[o], fx, fy);
        }
      }
      // each point's noise of this octave, added as fbm adds them
      const float v0 = vkf::mix(b0[o], b1[o], az.f[o]);
      const float vx = vkf::mix(xp0[o], xp1[o], az.f[o]);
      const float vy = vkf::mix(yp0[o], yp1[o], az.f[o]);
      const float vz = vkf::mix(zp0, zp1, aze.f[o]);
      f0 = o == 0 ? vkf::amp(0) * v0 : f0 + vkf::amp(o) * v0;
      fxo = o == 0 ? vkf::amp(0) * vx : fxo + vkf::amp(o) * vx;
      fyo = o == 0 ? vkf::amp(0) * vy : fyo + vkf::amp(o) * vy;
      fzo = o == 0 ? vkf::amp(0) * vz : fzo + vkf::amp(o) * vz;
    }
    if (!store) continue;
    // gradient: alpha at the voxel minus alpha at each offset point
    const float a0 = f0 * vkf::smoothstep(0.5f, vkf::INV_NOISE_WIN, vkf::radius(cx, cy, cz));
    const float gx = a0 - fxo * vkf::smoothstep(0.5f, vkf::INV_NOISE_WIN, vkf::radius(ox, cy, cz));
    const float gy = a0 - fyo * vkf::smoothstep(0.5f, vkf::INV_NOISE_WIN, vkf::radius(cx, oy, cz));
    const float gz = a0 - fzo * vkf::smoothstep(0.5f, vkf::INV_NOISE_WIN, vkf::radius(cx, cy, oz));
    float nx, ny, nz;
    vkf::normalize(gx, gy, gz, nx, ny, nz);
    const float nmag = sqrtf(nx * nx + ny * ny + nz * nz);
    const float v2 = f0 * 0.5f;
    const size_t idx = ((size_t)z * dims + y) * dims + x;
    reinterpret_cast<float4*>(density)[idx] = make_float4(v2, v2, v2, a0);
    reinterpret_cast<float4*>(normal)[idx] = make_float4(nx, ny, nz, nmag);
  }
}

// Check a launch's brick and table, fill its Windows and shapes. Returns a
// cudaError_t.
template <class Kernel>
int configure(Kernel kernel, int threads_x, int dims, int brick_y, int brick_z,
              const void* hash, const int* lo, const int* off, const int* last,
              const int* cap, Windows& w, dim3& grid, dim3& block, size_t& smem_bytes) {
  if (brick_y < 1 || brick_z < 1 || threads_x * brick_y > MAX_THREADS || hash == nullptr)
    return (int)cudaErrorInvalidValue;
  w.tab.values = (const float*)hash;
  int seg = 0;
  for (int o = 0; o < OCTAVES; ++o) {
    if (last[o] < 0 || cap[o] < 272) return (int)cudaErrorInvalidValue;
    w.tab.lo[o] = lo[o];
    w.tab.off[o] = off[o];
    w.tab.last[o] = last[o];
    w.cap[o] = cap[o];
    w.seg[o] = seg;
    seg += cap[o];
  }
  smem_bytes = (size_t)seg * sizeof(float);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  grid = dim3((dims + BRICK_X - 1) / BRICK_X, (dims + brick_y - 1) / brick_y,
              (dims + brick_z - 1) / brick_z);
  block = dim3(threads_x, brick_y);
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

const char* vk_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K9 on `stream`; returns the launch's cudaError_t. Device pointers: sin_t (1
// f32), hash (the f32 hash table: octave o's hash(n) at hash[off_o + n - lo_o]
// for n - lo_o in [0, last_o + 271]), density and normal (dims^3 * 4 f32 each,
// [z][y][x][channel], 16-byte aligned). A block covers a brick of 32 x
// brick_y x brick_z voxels, a thread per x (32 * brick_y <= 256); cap_o is
// octave o's window capacity in floats (genvol.py:window_capacity). A window
// outside the table or its capacity traps in the kernel: the launch fails,
// and the stream's next synchronization reports it.
int vk_genvol(const void* sin_t, int dims, float inv_dims, int brick_y, int brick_z,
              const void* hash, int lo0, int lo1, int lo2, int off0, int off1, int off2,
              int last0, int last1, int last2, int cap0, int cap1, int cap2, void* density,
              void* normal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dims <= 0) return (int)cudaSuccess;
  const int lo[] = {lo0, lo1, lo2}, off[] = {off0, off1, off2}, last[] = {last0, last1, last2},
            cap[] = {cap0, cap1, cap2};
  Windows w;
  dim3 grid, block;
  size_t smem;
  const int e = configure(genvol_kernel, BRICK_X, dims, brick_y, brick_z, hash, lo, off, last,
                          cap, w, grid, block, smem);
  if (e != 0) return e;
  genvol_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)sin_t, dims, inv_dims, brick_z, w, (float*)density, (float*)normal);
  return (int)cudaGetLastError();
}

// K8 on `stream`; returns the launch's cudaError_t. Device pointers: sin_t (1
// f32), hash (as vk_genvol), out (dims^3 uint8, [z][y][x]). A block covers a
// brick of 32 x brick_y x brick_z voxels, 4 consecutive x voxels a thread
// (8 * brick_y <= 256); cap_o as vk_genvol.
int vk_gendensity(const void* sin_t, int dims, float inv_dims, int brick_y, int brick_z,
                  const void* hash, int lo0, int lo1, int lo2, int off0, int off1, int off2,
                  int last0, int last1, int last2, int cap0, int cap1, int cap2, void* out,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dims <= 0) return (int)cudaSuccess;
  const int lo[] = {lo0, lo1, lo2}, off[] = {off0, off1, off2}, last[] = {last0, last1, last2},
            cap[] = {cap0, cap1, cap2};
  Windows w;
  dim3 grid, block;
  size_t smem;
  const int e = configure(gendensity_kernel, BRICK_X / K8_VX, dims, brick_y, brick_z, hash, lo,
                          off, last, cap, w, grid, block, smem);
  if (e != 0) return e;
  gendensity_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)sin_t, dims, inv_dims, brick_z, w, (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
