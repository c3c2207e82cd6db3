// Exact front-to-back raymarch of a uint8 voxel volume (the bonsai path), one
// thread per pixel, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel vokselis_tpu/ops/pallas/march_bonsai.py:_march_kernel
// (launched by render_bonsai_rays_pallas; the JAX package's view batches vmap
// it, which puts a view axis on its grid: here the grid's z, so that a batch
// of views is one launch). It computes what that kernel and
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
// What bounds it on this card: the steps, one after another. A ray takes up
// to MAX_STEPS (444 at D=256) steps, each from the position the previous
// one left. Empty-space skipping (march_ray) makes most of them cheap: at
// the bench pose 97 % of the steps lie in cells with no voxel above OCC_CUT
// and cost only the position arithmetic and, on entering a cell, one read
// of the 32 KB occupancy table; the rest gather 8 one-byte taps whose
// addresses depend on the step's position, and take the transfer and three
// cosf, divergent within a warp at the volume's surfaces. The design: the
// volume stays one contiguous (D, D, D) buffer indexed [z][y][x] (256^3 =
// 16.8 MB, resident in the 50 MB L2 across frames) and is read through
// __ldg, as is the table (not staged into shared memory: every block would
// copy it); threads run in 16x8 pixel blocks so that neighbouring rays,
// which sample neighbouring voxels and cross the same cells, share L1 lines
// and skip together; each thread breaks out at alpha >= 0.95. None of the
// TPU kernel's slab-pair layouts, DMA windows or overflow plane exist here:
// a thread can gather directly.
//
// Numerics: the march repeats the oracle's float32 operations in the
// oracle's order, and the library is built with --fmad=false so that no
// a*b+c is contracted into an fma the oracle does not have. A division by a
// constant is a multiplication by its reciprocal, taken in double and rounded
// to float, as PyTorch's CUDA division by a Python scalar computes it (a true
// float division differs in the last bit). Hardware texture filtering is not used:
// its 8-bit fixed-point weights would break the 1e-3 / 1e-5 parity contract.
// The skip changes no bit (march_ray). Shared memory staging and TMA are
// later work.
//
// K2 (march_tiles_kernel below) replaces the hybrid renderer's re-march,
// vokselis_tpu/ops/pallas/march_bonsai.py:_march_kernel_ids_into (launched by
// render_bonsai_tiles_into), and in its compact mode K1b, _march_kernel_ids
// (render_bonsai_tiles_pallas): the same march for the pixels of a list of
// selected 32x32 tiles or horizontal tile pairs only, written in place into
// the fast frame's linear rgb planes. One block per (unit, 8 rows of one of its
// tiles), 32x8 threads, one pixel each; parked ids return at once. The hybrid
// takes the palette's polynomial form (FAST) there. None of the TPU's
// scalar-prefetched index maps, aliased outputs or padded sentinel tile exists
// here: a block reads its own id and writes through a pointer. The palette
// (FAST) and the output mode (COMPACT) are template arguments, so each of the
// four kernels carries one march loop, with K1's skip over the same table.
// What bounds it: as K1, the serial steps of the longest rays; the selected
// tiles are the frame's silhouettes and dense edges, so they are the long
// ones, and fewer of their steps skip (88 % at the bench pose).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_X = 16;
constexpr int BLOCK_Y = 8;
constexpr int TILE = 32;  // K2/K1b: screen tile side
// empty-space skipping (march_bonsai.py:OCC_CELL, OCC_CUT; the TPU kernel's
// OCC_CUT, vokselis_tpu/ops/pallas/march_bonsai.py:107-115)
constexpr int OCC_CELL = 8;
constexpr int OCC_CUT = 25;  // floor(0.1 * 255): tv is 0 for samples <= 0.1

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

// One step's texel-space position (wgpu linear filtering, ClampToEdge): the
// lower taps x0, y0, z0, the upper taps x1, y1, z1 (each floor + 1, clamped,
// so x1 is x0 or x0 + 1) and the lerp fractions.
struct Taps {
  int x0, x1, y0, y1, z0, z1;
  float fx, fy, fz;
};

__device__ __forceinline__ Taps taps_at(int dims, float fdims, float px, float py, float pz) {
  const float x = px * fdims - 0.5f;
  const float y = py * fdims - 0.5f;
  const float z = pz * fdims - 0.5f;
  const float x0f = floorf(x), y0f = floorf(y), z0f = floorf(z);
  const int hi = dims - 1;
  Taps t;
  t.fx = x - x0f;
  t.fy = y - y0f;
  t.fz = z - z0f;
  t.x0 = clampi((int)x0f, hi);
  t.x1 = clampi((int)x0f + 1, hi);
  t.y0 = clampi((int)y0f, hi);
  t.y1 = clampi((int)y0f + 1, hi);
  t.z0 = clampi((int)z0f, hi);
  t.z1 = clampi((int)z0f + 1, hi);
  return t;
}

// sample_trilinear_r8 of an R8Unorm (D, D, D) volume at the taps tp.
__device__ __forceinline__ float sample_trilinear(const uint8_t* __restrict__ vol, int dims,
                                                  const Taps& tp) {
  const size_t row = (size_t)dims, slab = (size_t)dims * dims;
  const uint8_t* r00 = vol + tp.z0 * slab + tp.y0 * row;
  const uint8_t* r10 = vol + tp.z0 * slab + tp.y1 * row;
  const uint8_t* r01 = vol + tp.z1 * slab + tp.y0 * row;
  const uint8_t* r11 = vol + tp.z1 * slab + tp.y1 * row;
  const float c000 = (float)__ldg(r00 + tp.x0) * INV_255;
  const float c100 = (float)__ldg(r00 + tp.x1) * INV_255;
  const float c010 = (float)__ldg(r10 + tp.x0) * INV_255;
  const float c110 = (float)__ldg(r10 + tp.x1) * INV_255;
  const float c001 = (float)__ldg(r01 + tp.x0) * INV_255;
  const float c101 = (float)__ldg(r01 + tp.x1) * INV_255;
  const float c011 = (float)__ldg(r11 + tp.x0) * INV_255;
  const float c111 = (float)__ldg(r11 + tp.x1) * INV_255;
  const float c00 = lerp(c000, c100, tp.fx);
  const float c10 = lerp(c010, c110, tp.fx);
  const float c01 = lerp(c001, c101, tp.fx);
  const float c11 = lerp(c011, c111, tp.fx);
  const float c0 = lerp(c00, c10, tp.fy);
  const float c1 = lerp(c01, c11, tp.fy);
  return lerp(c0, c1, tp.fz);
}

__device__ __forceinline__ float linear_to_srgb(float x) {
  return x <= 0.0031308f ? 12.92f * x
                         : 1.055f * powf(fmaxf(x, 1e-12f), SRGB_EXP) - 0.055f;
}

// colors._PAL_R / _PAL_G / _PAL_B (the palette's Chebyshev fits, <= 1.4e-6 per
// channel), highest degree first
__constant__ float PAL_R[15] = {
    (float)2.3406275886372896e-06, (float)-8.178023563232273e-06,
    (float)-7.169197488110512e-05, (float)0.00021621925407089293,
    (float)0.0014433319447562099, (float)-0.003630567342042923,
    (float)-0.019702181220054626, (float)0.03964952751994133, (float)0.16730359196662903,
    (float)-0.2525175213813782, (float)-0.7610723376274109, (float)0.765809953212738,
    (float)1.3848620653152466, (float)-0.6967412829399109, (float)0.08001303672790527};
__constant__ float PAL_G[18] = {
    (float)6.774119538022205e-05, (float)0.00017599744023755193,
    (float)-0.0012224658858031034, (float)-0.0028367959894239902,
    (float)0.013864136300981045, (float)0.027970831841230392, (float)-0.1138000339269638,
    (float)-0.19436828792095184, (float)0.6569516658782959, (float)0.9181039929389954,
    (float)-2.4818410873413086, (float)-2.6976795196533203, (float)5.469216823577881,
    (float)4.246329307556152, (float)-5.739269733428955, (float)-2.6735997200012207,
    (float)1.806796908378601, (float)0.7805613875389099};
__constant__ float PAL_B[10] = {
    (float)-1.2924492693855427e-06, (float)-9.764691640157253e-06,
    (float)9.051700180862099e-05, (float)0.000533417914994061,
    (float)-0.0036043107975274324, (float)-0.015173014253377914, (float)0.0683177188038826,
    (float)0.17255795001983643, (float)-0.38847577571868896, (float)0.17292727530002594};
constexpr double TVMAX = 0.8174305033809168;  // smoothstep(0.10, 1.2, 0.9)
constexpr float U_SCALE = (float)(2.0 / TVMAX);

template <int N>
__device__ __forceinline__ float horner(const float (&c)[N], float u) {
  float acc = c[0];
#pragma unroll
  for (int j = 1; j < N; ++j) acc = acc * u + c[j];
  return acc;
}

// One ray's exact march (steps 1-6 above) from eye e along the normalized
// direction d; returns the linear rgb. FAST swaps the vertigo palette's three
// cosf for their polynomials (colors.bonsai_transfer_fast_soa): the hybrid's
// re-march (K2) uses it, K1 never does.
//
// Empty-space skipping: occ holds the max voxel of each OCC_CELL^3 cell with
// one voxel of overlap toward + (march_bonsai.py:occupancy_table), so both
// taps of every pair whose lower tap lies in the cell are inside it. Where
// the cell of the lower taps holds no voxel above OCC_CUT, every tap is <=
// 25/255, the sample is below 0.1, the transfer tv is exactly 0, and the
// step's composite leaves r, g, b and a unchanged bit for bit: the step
// skips its 8 loads, the transfer and the palette, and still advances p
// and t, so positions and step counts stay the plain version's. The cell's
// value is reloaded only when the step enters another cell.
template <bool FAST>
__device__ __forceinline__ float3 march_ray(const uint8_t* __restrict__ vol,
                                            const uint8_t* __restrict__ occ, int dims,
                                            float ex, float ey, float ez, float dx,
                                            float dy, float dz, int max_steps) {
  const float fdims = (float)dims;
  const int cells = (dims + OCC_CELL - 1) / OCC_CELL;

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
  int cell = -1;
  bool empty = false;
  if (hit) {
    for (int i = 0; i < max_steps; ++i) {
      if (!(t < t1) || !(a < 0.95f)) break;
      const Taps tp = taps_at(dims, fdims, px, py, pz);
      const int c = ((tp.z0 / OCC_CELL) * cells + tp.y0 / OCC_CELL) * cells + tp.x0 / OCC_CELL;
      if (c != cell) {
        cell = c;
        empty = __ldg(occ + c) <= OCC_CUT;
      }
      if (!empty) {
        const float samp = sample_trilinear(vol, dims, tp);
        // transfer: smoothstep(0.10, 1.2, min(0.9, samp)) + vertigo
        float s = (fminf(samp, 0.9f) - 0.10f) * INV_SMOOTH_SPAN;
        s = fminf(fmaxf(s, 0.0f), 1.0f);
        const float tv = s * s * (3.0f - 2.0f * s);
        float cr, cg, cb;
        if (FAST) {
          const float u = U_SCALE * tv - 1.0f;
          cr = horner(PAL_R, u);
          cg = horner(PAL_G, u);
          cb = horner(PAL_B, u);
        } else {
          cr = 0.5f + 0.5f * cosf(TAU * (1.0f * tv + 0.0f));
          cg = 0.5f + 0.5f * cosf(TAU * (1.7f * tv + 0.15f));
          cb = 0.5f + 0.5f * cosf(TAU * (0.4f * tv + 0.20f));
        }
        // front-to-back under-compositing (raycast_naive.wgsl:110-114)
        const float w = (1.0f - a) * tv;
        r = r + w * cr;
        g = g + w * cg;
        b = b + w * cb;
        a = a + (1.0f - a) * tv;
      }
      px = px + dx * dt;
      py = py + dy * dt;
      pz = pz + dz * dt;
      t = t + dt;
    }
  }
  return make_float3(r, g, b);
}

__global__ void __launch_bounds__(BLOCK_X* BLOCK_Y)
    march_bonsai_kernel(const uint8_t* __restrict__ vol, const uint8_t* __restrict__ occ,
                        int dims,
                        const float* __restrict__ dxs, const float* __restrict__ dys,
                        const float* __restrict__ dzs, const float* __restrict__ eye,
                        int height, int width, int max_steps, int srgb,
                        float* __restrict__ out) {
  const int ix = blockIdx.x * BLOCK_X + threadIdx.x;
  const int iy = blockIdx.y * BLOCK_Y + threadIdx.y;
  if (ix >= width || iy >= height) return;
  // view blockIdx.z of the batch: its eye, ray planes and output frame
  const size_t v = blockIdx.z;
  const float* e = eye + 3 * v;
  const size_t pix = v * height * width + (size_t)iy * width + ix;
  float3 c = march_ray<false>(vol, occ, dims, __ldg(e), __ldg(e + 1), __ldg(e + 2),
                              dxs[pix], dys[pix], dzs[pix], max_steps);
  if (srgb) {
    c.x = linear_to_srgb(c.x);
    c.y = linear_to_srgb(c.y);
    c.z = linear_to_srgb(c.z);
  }
  float4 o = make_float4(c.x, c.y, c.z, 1.0f);
  reinterpret_cast<float4*>(out)[pix] = o;
}

// K2 and K1b: the march over listed units of TILE x TILE screen tiles (unit p
// = tiles p * tpu .. p * tpu + tpu - 1 in raster order of the padded tile
// grid, nx tiles a row). Grid (n_sel, tpu * TILE / BLOCK_Y), block
// (TILE, BLOCK_Y): block (i, j) takes rows (j % 4) * 8 .. + 7 of tile j / 4 of
// unit ids[i]. The rays are the compact (n_sel * tpu * TILE, TILE) planes of
// the selected tiles, pixel (i, t, row, col) at row (i * tpu + t) * TILE + row.
// Into mode (compact == 0, K2): a parked id (outside [0, n_units)) returns at
// once, pixels outside the frame are skipped, and the linear rgb is written
// into out's three (height, width) planes at the pixel's place, nothing else.
// Compact mode (K1b): out holds three planes shaped like the rays; parked ids
// and pixels outside the frame write 0.
template <bool FAST, bool COMPACT>
__global__ void __launch_bounds__(TILE* BLOCK_Y)
    march_tiles_kernel(const uint8_t* __restrict__ vol, const uint8_t* __restrict__ occ,
                       int dims,
                       const float* __restrict__ dxs, const float* __restrict__ dys,
                       const float* __restrict__ dzs, const float* __restrict__ eye,
                       const int* __restrict__ ids, int n_sel, int n_units, int tpu,
                       int nx, int height, int width, int max_steps,
                       float* __restrict__ out) {
  const int i = blockIdx.x;
  const int id = __ldg(ids + i);
  const bool parked = id < 0 || id >= n_units;
  if (parked && !COMPACT) return;
  const int t = blockIdx.y / (TILE / BLOCK_Y);
  const int row = (blockIdx.y % (TILE / BLOCK_Y)) * BLOCK_Y + threadIdx.y;
  const int col = threadIdx.x;
  const int tile = id * tpu + t;
  const int iy = (tile / nx) * TILE + row, ix = (tile % nx) * TILE + col;
  const bool inside = !parked && iy < height && ix < width;
  const size_t k = ((size_t)i * tpu + t) * (TILE * TILE) + row * TILE + col;
  float3 c = make_float3(0.0f, 0.0f, 0.0f);
  if (inside) {
    const float ex = __ldg(eye), ey = __ldg(eye + 1), ez = __ldg(eye + 2);
    c = march_ray<FAST>(vol, occ, dims, ex, ey, ez, dxs[k], dys[k], dzs[k], max_steps);
  }
  if (COMPACT) {
    const size_t n = (size_t)n_sel * tpu * TILE * TILE;
    out[k] = c.x;
    out[n + k] = c.y;
    out[2 * n + k] = c.z;
  } else if (inside) {
    const size_t npix = (size_t)height * width, p = (size_t)iy * width + ix;
    out[p] = c.x;
    out[npix + p] = c.y;
    out[2 * npix + p] = c.z;
  }
}

}  // namespace

extern "C" {

const char* vk_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches the march of n_views views on `stream` and returns the
// cudaError_t of the launch (0 on success). All pointers are device
// pointers: vol (dims^3 uint8, [z][y][x]), occ (cells^3 uint8, cells =
// ceil(dims / 8), [z][y][x]: the occupancy table, one for every view),
// dx/dy/dz (n_views*height*width float32 each, view-major), eye (n_views*3
// float32), out (n_views*height*width*4 float32, 16-byte aligned). The view
// is the grid's z (at most 65535), so each view's blocks and pixels are a
// single-view launch's, bit for bit.
int vk_march_bonsai(const void* vol, const void* occ, int dims, const void* dx, const void* dy,
                    const void* dz, const void* eye, int n_views, int height, int width,
                    int max_steps, int srgb, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_views <= 0 || height <= 0 || width <= 0) return (int)cudaSuccess;
  if (n_views > 65535) return (int)cudaErrorInvalidValue;
  const dim3 block(BLOCK_X, BLOCK_Y);
  const dim3 grid((width + BLOCK_X - 1) / BLOCK_X, (height + BLOCK_Y - 1) / BLOCK_Y, n_views);
  march_bonsai_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)vol, (const uint8_t*)occ, dims, (const float*)dx, (const float*)dy,
      (const float*)dz, (const float*)eye, height, width, max_steps, srgb, (float*)out);
  return (int)cudaGetLastError();
}

// K2 (compact == 0) or K1b (compact != 0) on `stream`; returns the launch's
// cudaError_t. Device pointers: vol, occ, eye as above; dx/dy/dz (n_sel * tpu *
// 32 * 32 f32 each: the compact rays of the listed units); ids (n_sel int32,
// unit ids, parked where outside [0, n_units)); out: K2 the three (height,
// width) f32 rgb planes, written in place; K1b three planes shaped like dx.
int vk_march_tiles(const void* vol, const void* occ, int dims, const void* dx, const void* dy,
                   const void* dz, const void* eye, const void* ids, int n_sel, int n_units,
                   int tpu, int nx, int height, int width, int max_steps, int fast,
                   int compact, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_sel <= 0) return (int)cudaSuccess;
  if (tpu < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  const dim3 block(TILE, BLOCK_Y);
  const dim3 grid(n_sel, tpu * (TILE / BLOCK_Y));
  auto kernel = fast ? (compact ? march_tiles_kernel<true, true>
                                : march_tiles_kernel<true, false>)
                     : (compact ? march_tiles_kernel<false, true>
                                : march_tiles_kernel<false, false>);
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)vol, (const uint8_t*)occ, dims, (const float*)dx, (const float*)dy,
      (const float*)dz, (const float*)eye, (const int*)ids, n_sel, n_units, tpu, nx, height,
      width, max_steps, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
