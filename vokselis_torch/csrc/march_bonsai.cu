// Exact front-to-back raymarch of a uint8 or float32 voxel volume (the bonsai
// path), one thread per pixel, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel vokselis_tpu/ops/pallas/march_bonsai.py:_march_kernel
// (launched by render_bonsai_rays_pallas; the JAX package's view batches vmap
// it, which puts a view axis on its grid: here the grid's z, so that a batch
// of views is one launch). It computes what that kernel and
// the oracle vokselis_torch/ops/reference.py:render_bonsai_rays compute, for
// each pixel (shaders/raycast_naive.wgsl fs_main, :84-125):
//   1. clip the ray to the [0,1]^3 box (slab test);
//   2. dt = min over the axes a of 1 / (N_a * |d_a|), (N_x, N_y, N_z) =
//      (W, H, D): each step moves one voxel along the axis that crosses
//      voxels fastest (for a cube, 1 / (D * max|d|));
//   3. march while t < t1 and alpha < 0.95, position accumulated p += d * dt;
//   4. trilinear R8Unorm sample with wgpu ClampToEdge taps (texel x = p*W - 0.5,
//      taps floor(x) and floor(x)+1, each clamped to [0, W-1]; y with H, z
//      with D); a float32 volume's taps are mapped by its data range,
//      (v - lo) * inv with inv = 1 / (hi - lo) (0 for a constant volume),
//      before the same seven lerps (VoxelMap);
//   5. transfer tv = smoothstep(0.10, 1.2, min(0.9, samp)) (the clamp-argument
//      quirk) and the vertigo palette (TAU = 6.28318);
//   6. composite under: rgb += (1-a)*tv*c, a += (1-a)*tv;
//   7. optional linear_to_srgb on rgb; alpha out is 1.
//
// What bounds it on this card: the steps, one after another. A ray takes up
// to max_steps (the volume's full diagonal: 445 at 256^3) steps, each from
// the position the previous one left. Empty-space skipping (march_ray) makes
// most of them cheap: 84-97 % of the steps lie in cells with no voxel above
// OCC_CUT (the bonsai's poses, the views' fbm ball, the kingsnake's stand-in),
// and those take no sample; the rest gather 8 one-byte taps whose addresses
// depend on the step's position (4-byte taps for a float32 volume), and take
// the transfer and three cosf,
// divergent within a warp at the volume's surfaces. An empty cell is crossed
// in one run: the step that finds its cell empty computes, from the ray's
// per-axis texel step, how many further steps provably keep their lower taps
// in that cell, and takes them as bare advances (p += d * dt, t += dt, the
// same additions in the same order), with no taps, no cell id and no loop
// test; a cell visit of ~5-6 steps costs one full step, the run's set-up and
// ~6 instructions a bare step instead of ~33 (cubic) or ~45 (per axis) a step.
// The design: the volume stays one contiguous (D, H, W) buffer indexed
// [z][y][x] (256^3 = 16.8 MB, resident in the 50 MB L2 across frames; a
// 1024x1024x795 scan, 834 MB, or a 1024^3 float32 field, 4.3 GB, read from
// DRAM) and is read through __ldg, as
// is the table (not staged into shared memory: every block would
// copy it); threads run in 16x8 pixel blocks so that neighbouring rays,
// which sample neighbouring voxels and cross the same cells, share L1 lines
// and skip together; each thread breaks out at alpha >= 0.95. None of the
// TPU kernel's slab-pair layouts, DMA windows or overflow plane exist here:
// a thread can gather directly. The voxel type is a template argument of the
// march (K1's frame entry and its counting kernel; K1's ray-plane entry and
// K2/K1b take uint8 only): the uint8 instantiations' VoxelMap is empty, so
// they carry no range. Registers
// (ptxas, sm_90a): K1 48 cubic, 56 per axis (44 and 48 without the runs,
// whose per-ray constants are three inverse texel steps, 1 / dt and t's
// limit), its float32 instantiations 53 cubic and 55 per axis, K2/K1b
// 53-60 (48), the counting kernel 48 and 56 (54 float); no spills (the
// 32-byte stack frames, cosf's and powf's slow paths, are unchanged).
//
// Numerics: the march repeats the oracle's float32 operations in the
// oracle's order, and the library is built with --fmad=false so that no
// a*b+c is contracted into an fma the oracle does not have. A division by a
// constant is a multiplication by its reciprocal, taken in double and rounded
// to float, as PyTorch's CUDA division by a Python scalar computes it (a true
// float division differs in the last bit). Hardware texture filtering is not used:
// its 8-bit fixed-point weights would break the 1e-3 / 1e-5 parity contract.
// The skip and its runs change no bit (march_ray). Shared memory staging
// and TMA are later work.
//
// Rays: the renderer's frames (vk_march_bonsai_frame, K1 with INLINE_RAYS)
// make each pixel's fragment ray in the kernel from the view's inverse
// proj*view and eye, instead of reading three (H, W) direction planes that
// torch wrote (vk_march_bonsai, kept for callers that hand in rays). The
// thread repeats geometry.rays_fragment_soa's float32 operations in its
// order, each rounded as its eager torch op rounds on the card, so that the
// ray (and so the frame) is bitwise the plane path's: the far-plane
// unprojection turns one ulp of its inputs into ~1e4 ulp of the direction.
//   ndc_x = (2 * (ix + 0.5)) * inv_w - 1, ndc_y = 1 - (2 * (iy + 0.5)) * inv_h,
//     inv_w = 1.0f / W rounded once on the host (PyTorch's CUDA division by a
//     Python int multiplies by that reciprocal; for a whole W it is also the
//     double quotient rounded to float);
//   near/far row i = ((m[i][0] * ndc_x + m[i][1] * ndc_y) + m[i][2] * z) + m[i][3]
//     (mat4_apply: one op each, the z = 0 product kept for its signed zero);
//   d = far.xyz / far.w - near.xyz / near.w (IEEE divisions);
//   d *= 1.0f / sqrtf((dx * dx + dy * dy) + dz * dz) (sqrt and reciprocal
//     correctly rounded, as torch.sqrt and Tensor.__rtruediv__ are).
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

// The volume's extent per axis, voxels (nx, ny, nz) = (W, H, D), and as floats.
struct Dims {
  int nx, ny, nz;
  float fx, fy, fz;
};

__device__ __forceinline__ Dims dims_of(int w, int h, int d) {
  return Dims{w, h, d, (float)w, (float)h, (float)d};
}

__device__ __forceinline__ Taps taps_at(const Dims& n, float px, float py, float pz) {
  const float x = px * n.fx - 0.5f;
  const float y = py * n.fy - 0.5f;
  const float z = pz * n.fz - 0.5f;
  const float x0f = floorf(x), y0f = floorf(y), z0f = floorf(z);
  Taps t;
  t.fx = x - x0f;
  t.fy = y - y0f;
  t.fz = z - z0f;
  t.x0 = clampi((int)x0f, n.nx - 1);
  t.x1 = clampi((int)x0f + 1, n.nx - 1);
  t.y0 = clampi((int)y0f, n.ny - 1);
  t.y1 = clampi((int)y0f + 1, n.ny - 1);
  t.z0 = clampi((int)z0f, n.nz - 1);
  t.z1 = clampi((int)z0f + 1, n.nz - 1);
  return t;
}

// A voxel's value as the sample sees it (step 4): a uint8 voxel's R8Unorm
// value, u8 * (1/255); a float32 voxel mapped by the volume's data range,
// (v - lo) * inv, two float32 operations (sample_trilinear_r8's value_range).
template <typename T>
struct VoxelMap;

template <>
struct VoxelMap<uint8_t> {
  __device__ __forceinline__ float operator()(uint8_t v) const { return (float)v * INV_255; }
};

template <>
struct VoxelMap<float> {
  float lo, inv;
  __device__ __forceinline__ float operator()(float v) const { return (v - lo) * inv; }
};

// sample_trilinear_r8 of a (D, H, W) volume at the taps tp, each tap mapped by map.
template <typename T>
__device__ __forceinline__ float sample_trilinear(const T* __restrict__ vol,
                                                  const VoxelMap<T>& map, const Dims& n,
                                                  const Taps& tp) {
  const size_t row = (size_t)n.nx, slab = (size_t)n.nx * n.ny;
  const T* r00 = vol + tp.z0 * slab + tp.y0 * row;
  const T* r10 = vol + tp.z0 * slab + tp.y1 * row;
  const T* r01 = vol + tp.z1 * slab + tp.y0 * row;
  const T* r11 = vol + tp.z1 * slab + tp.y1 * row;
  const float c000 = map(__ldg(r00 + tp.x0));
  const float c100 = map(__ldg(r00 + tp.x1));
  const float c010 = map(__ldg(r10 + tp.x0));
  const float c110 = map(__ldg(r10 + tp.x1));
  const float c001 = map(__ldg(r01 + tp.x0));
  const float c101 = map(__ldg(r01 + tp.x1));
  const float c011 = map(__ldg(r11 + tp.x0));
  const float c111 = map(__ldg(r11 + tp.x1));
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

// A run's margin: 2^-17 of the unit box on each axis (n_a * RUN_EPS texels)
// and of t1 (march_ray's runs; march_bonsai.py:RUN_EPS).
constexpr float RUN_EPS = 1.0f / 131072.0f;

// The steps of a run along one axis: how many texel steps s (1 / inv_s) fit
// between the step's texel coordinate x (lower tap x0, clamped) and the face
// of x0's cell in the direction of travel d, less the margin m. An axis with
// d == 0 (either sign) takes the + face, which its x lies below, and inv_s
// is inf there: +inf, no bound (p never moves along it).
__device__ __forceinline__ float run_axis(float x, int x0, float d, float inv_s, float m) {
  const float g = (float)(x0 & ~(OCC_CELL - 1)) - x;
  const float dist = d >= 0.0f ? g + (float)OCC_CELL : -g;
  return (dist - m) * inv_s;
}

// One ray's exact march (steps 1-6 above) from eye e along the normalized
// direction d; returns the linear rgb. FAST swaps the vertigo palette's three
// cosf for their polynomials (colors.bonsai_transfer_fast_soa): the hybrid's
// re-march (K2) uses it, K1 never does. COUNT adds the ray's steps and bare
// steps (below) to *steps and *bare (step_counts' kernel; the timed kernels
// count nothing).
//
// Empty-space skipping: occ holds the max voxel of each OCC_CELL^3 cell with
// one voxel of overlap toward + (march_bonsai.py:occupancy_table; of a
// float32 volume the max mapped by the range and rounded up to the uint8
// table), so both taps of every pair whose lower tap lies in the cell are
// inside it. Where the cell of the lower taps holds no voxel above OCC_CUT,
// every mapped tap is <= 25/255, the sample is below 0.1, the transfer tv is exactly 0, and the
// step's composite leaves r, g, b and a unchanged bit for bit: the step
// skips its 8 loads, the transfer and the palette, and still advances p
// and t, so positions and step counts stay the plain version's. The cell's
// value is reloaded only when the step enters another cell.
//
// Runs (march_bonsai.py:march_runs_plain is the plain twin): the step that
// finds its cell empty then takes run further steps as bare advances, p += d
// * dt and t += dt as the loop's own advance, with no taps, no cell, no
// composite (nothing composites in an empty cell, so a is unchanged and the
// alpha test would pass) and no loop test. run is the largest count that
// provably keeps every bare step inside the loop and its lower taps in the
// cell: the minimum of
//   - per moving axis, (distance from x = p * n - 0.5 to the cell's face in
//     the direction of travel, less m = n * RUN_EPS texels) / the texel step
//     n * |d| * dt (<= 1), floored. Along +, the lower tap of a bare step
//     clamps to x0's cell while x < 8c + 8: p only grows, and the clamp at
//     the volume's faces keeps a tap in the first or last cell; along -,
//     while x >= 8c. So the clamp only shortens the run, never lengthens it;
//   - (t1 * (1 - RUN_EPS) - t) / dt, floored: every bare step has t < t1;
//   - max_steps - 1 - i: every bare step is a step of the loop.
// The margin: a bare step's x differs from x + j * s by at most the j
// additions' roundings of p (|p| < 2: j * 2^-24 each, times n), the two x's
// own (n * 2^-22 each) and the float step's (3 * 2^-24 a step), and the
// run's own arithmetic by ~4 ulps: with j <= 8 (the fastest axis has s ~ 1
// and at most 8.5 texels to its face), under (17 n + 80) * 2^-24 texels,
// ~1e-3 at n = 1024, below n * 2^-17 for every n >= 1 (~7.8e-3 at n =
// 1024). t's j additions and the run's arithmetic err by under 16 * 2^-24
// * t1, below t1 * 2^-17. A run therefore ends up to m / s of a step short
// of its face (one step in ~1 / (128 s) of runs at n = 1024): the next
// full step finds the same cell and runs again.
template <typename T, bool FAST, bool COUNT = false>
__device__ __forceinline__ float3 march_ray(const T* __restrict__ vol, const VoxelMap<T>& map,
                                            const uint8_t* __restrict__ occ, const Dims& n,
                                            float ex, float ey, float ez, float dx,
                                            float dy, float dz, int max_steps,
                                            int* steps = nullptr, int* bare = nullptr) {
  // the occupancy table's cells along x and y ([z][y][x], march_bonsai.py:occupancy_table)
  const int cells_x = (n.nx + OCC_CELL - 1) / OCC_CELL;
  const int cells_y = (n.ny + OCC_CELL - 1) / OCC_CELL;

  // slab test against [0,1]^3 (geometry.intersect_box_unit)
  const float inx = 1.0f / dx, iny = 1.0f / dy, inz = 1.0f / dz;
  const float ax0 = (0.0f - ex) * inx, ax1 = (1.0f - ex) * inx;
  const float ay0 = (0.0f - ey) * iny, ay1 = (1.0f - ey) * iny;
  const float az0 = (0.0f - ez) * inz, az1 = (1.0f - ez) * inz;
  const float t0 = fmaxf(fminf(ax0, ax1), fmaxf(fminf(ay0, ay1), fminf(az0, az1)));
  const float t1 = fminf(fmaxf(ax0, ax1), fminf(fmaxf(ay0, ay1), fmaxf(az0, az1)));
  const bool hit = t0 <= t1;
  float t = fmaxf(t0, 0.0f);

  // one voxel per step along the axis that crosses voxels fastest
  // (raycast_naive.wgsl:97-99, there with the cube's 256 on every axis)
  const float dt = fminf(1.0f / (n.fx * fabsf(dx)),
                         fminf(1.0f / (n.fy * fabsf(dy)), 1.0f / (n.fz * fabsf(dz))));
  // the runs' per-ray constants: inverse texel steps (inf on an axis with
  // d == 0), 1 / dt and t's limit
  const float inv_sx = 1.0f / ((n.fx * fabsf(dx)) * dt);
  const float inv_sy = 1.0f / ((n.fy * fabsf(dy)) * dt);
  const float inv_sz = 1.0f / ((n.fz * fabsf(dz)) * dt);
  const float inv_dt = 1.0f / dt;
  const float t_lim = t1 * (1.0f - RUN_EPS);

  float px = ex + t * dx, py = ey + t * dy, pz = ez + t * dz;
  float r = 0.0f, g = 0.0f, b = 0.0f, a = 0.0f;
  int cell = -1;
  bool empty = false;
  if (hit) {
    for (int i = 0; i < max_steps; ++i) {
      if (!(t < t1) || !(a < 0.95f)) break;
      const Taps tp = taps_at(n, px, py, pz);
      const int c =
          ((tp.z0 / OCC_CELL) * cells_y + tp.y0 / OCC_CELL) * cells_x + tp.x0 / OCC_CELL;
      if (c != cell) {
        cell = c;
        empty = __ldg(occ + c) <= OCC_CUT;
      }
      int run = 0;
      if (!empty) {
        const float samp = sample_trilinear(vol, map, n, tp);
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
      } else {
        // the same texel coordinates taps_at computed
        const float qx = run_axis(px * n.fx - 0.5f, tp.x0, dx, inv_sx, n.fx * RUN_EPS);
        const float qy = run_axis(py * n.fy - 0.5f, tp.y0, dy, inv_sy, n.fy * RUN_EPS);
        const float qz = run_axis(pz * n.fz - 0.5f, tp.z0, dz, inv_sz, n.fz * RUN_EPS);
        const float q = fmaxf(fminf(fminf(qx, qy), fminf(qz, (t_lim - t) * inv_dt)), 0.0f);
        run = min((int)q, max_steps - 1 - i);
      }
      px = px + dx * dt;
      py = py + dy * dt;
      pz = pz + dz * dt;
      t = t + dt;
      for (int j = 0; j < run; ++j) {
        px = px + dx * dt;
        py = py + dy * dt;
        pz = pz + dz * dt;
        t = t + dt;
      }
      i += run;
      if (COUNT) {
        *steps += 1 + run;
        *bare += run;
      }
    }
  }
  return make_float3(r, g, b);
}

// The fragment-path ray of pixel (ix, iy) through the row-major 4x4 inverse
// proj*view m, normalized: geometry.rays_fragment_soa's operations in its
// order (see the header's Rays note).
__device__ __forceinline__ float3 fragment_ray(const float* __restrict__ m, int ix, int iy,
                                               float inv_w, float inv_h) {
  const float ndc_x = 2.0f * ((float)ix + 0.5f) * inv_w - 1.0f;
  const float ndc_y = 1.0f - 2.0f * ((float)iy + 0.5f) * inv_h;
  float near[4], far[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float xy = __ldg(m + 4 * i) * ndc_x + __ldg(m + 4 * i + 1) * ndc_y;
    const float m2 = __ldg(m + 4 * i + 2), m3 = __ldg(m + 4 * i + 3);
    // z = 0 (near) or 1 (far), w = 1: a product by 1 is exact, one by 0 signs its zero
    near[i] = (xy + m2 * 0.0f) + m3;
    far[i] = (xy + m2) + m3;
  }
  const float dx = far[0] / far[3] - near[0] / near[3];
  const float dy = far[1] / far[3] - near[1] / near[3];
  const float dz = far[2] / far[3] - near[2] / near[3];
  const float inv_len = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
  return make_float3(dx * inv_len, dy * inv_len, dz * inv_len);
}

// K1 over a volume of voxel type T (uint8_t, or float with map's range).
// INLINE_RAYS: view v's ray is made here from inv_proj[16 v ..] and its
// eye read from view_position at 4 v (dx/dy/dz unused); else the ray is read
// from the dx/dy/dz planes and the eye at 3 v (inv_proj unused). One march
// loop either way. CUBE: vol_w == vol_h == vol_d, and the march takes that one
// size on every axis, so that the compiler keeps one of each per-axis value:
// the same operations, in the cubic kernel's instructions. (With three sizes
// the loop reloads them from the constant bank and clamps the upper taps
// before the skip's branch; on an H100 that took K1 on the 256^3 bonsai at
// 1024^2 from 0.27 to 0.32 ms.)
template <typename T, bool INLINE_RAYS, bool CUBE>
__global__ void __launch_bounds__(BLOCK_X* BLOCK_Y)
    march_bonsai_kernel(const T* __restrict__ vol, const VoxelMap<T> map,
                        const uint8_t* __restrict__ occ, int vol_w, int vol_h, int vol_d,
                        const float* __restrict__ dxs, const float* __restrict__ dys,
                        const float* __restrict__ dzs, const float* __restrict__ inv_proj,
                        const float* __restrict__ eye, int height, int width, float inv_w,
                        float inv_h, int max_steps, int srgb, float* __restrict__ out) {
  const int ix = blockIdx.x * BLOCK_X + threadIdx.x;
  const int iy = blockIdx.y * BLOCK_Y + threadIdx.y;
  if (ix >= width || iy >= height) return;
  // view blockIdx.z of the batch: its eye, its rays and its output frame
  const size_t v = blockIdx.z;
  const float* e = eye + (INLINE_RAYS ? 4 : 3) * v;
  const size_t pix = v * height * width + (size_t)iy * width + ix;
  const float3 d = INLINE_RAYS ? fragment_ray(inv_proj + 16 * v, ix, iy, inv_w, inv_h)
                               : make_float3(dxs[pix], dys[pix], dzs[pix]);
  const Dims n = CUBE ? dims_of(vol_w, vol_w, vol_w) : dims_of(vol_w, vol_h, vol_d);
  float3 c = march_ray<T, false>(vol, map, occ, n, __ldg(e), __ldg(e + 1), __ldg(e + 2), d.x,
                                 d.y, d.z, max_steps);
  if (srgb) {
    c.x = linear_to_srgb(c.x);
    c.y = linear_to_srgb(c.y);
    c.z = linear_to_srgb(c.z);
  }
  float4 o = make_float4(c.x, c.y, c.z, 1.0f);
  reinterpret_cast<float4*>(out)[pix] = o;
}

template <typename T, bool INLINE_RAYS>
int launch_march(const void* vol, VoxelMap<T> map, const void* occ, int vol_w, int vol_h,
                 int vol_d,
                 const void* dx, const void* dy, const void* dz, const void* inv_proj,
                 const void* eye, int n_views, int height, int width, int max_steps, int srgb,
                 void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_views <= 0 || height <= 0 || width <= 0) return (int)cudaSuccess;
  if (n_views > 65535) return (int)cudaErrorInvalidValue;
  // the reciprocals PyTorch's CUDA division by a Python scalar multiplies by
  const float inv_w = 1.0f / (float)width, inv_h = 1.0f / (float)height;
  const dim3 block(BLOCK_X, BLOCK_Y);
  const dim3 grid((width + BLOCK_X - 1) / BLOCK_X, (height + BLOCK_Y - 1) / BLOCK_Y, n_views);
  const bool cube = vol_w == vol_h && vol_h == vol_d;
  auto kernel = cube ? march_bonsai_kernel<T, INLINE_RAYS, true>
                     : march_bonsai_kernel<T, INLINE_RAYS, false>;
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)vol, map, (const uint8_t*)occ, vol_w, vol_h, vol_d, (const float*)dx,
      (const float*)dy, (const float*)dz, (const float*)inv_proj, (const float*)eye, height, width,
      inv_w, inv_h, max_steps, srgb, (float*)out);
  return (int)cudaGetLastError();
}

// K1's step counts: march_bonsai_kernel<T, true, CUBE>'s march of every pixel,
// each thread making its ray, writing the pixel's (steps, bare steps) as two
// int32 at counts[2 pix] instead of its colour (step_counts; no frame or batch
// path launches it, and the timed kernel counts nothing).
template <typename T, bool CUBE>
__global__ void __launch_bounds__(BLOCK_X* BLOCK_Y)
    march_bonsai_count_kernel(const T* __restrict__ vol, const VoxelMap<T> map,
                              const uint8_t* __restrict__ occ, int vol_w, int vol_h, int vol_d,
                              const float* __restrict__ inv_proj, const float* __restrict__ eye,
                              int height, int width, float inv_w, float inv_h, int max_steps,
                              int* __restrict__ counts) {
  const int ix = blockIdx.x * BLOCK_X + threadIdx.x;
  const int iy = blockIdx.y * BLOCK_Y + threadIdx.y;
  if (ix >= width || iy >= height) return;
  const size_t v = blockIdx.z;
  const float* e = eye + 4 * v;
  const size_t pix = v * height * width + (size_t)iy * width + ix;
  const float3 d = fragment_ray(inv_proj + 16 * v, ix, iy, inv_w, inv_h);
  const Dims n = CUBE ? dims_of(vol_w, vol_w, vol_w) : dims_of(vol_w, vol_h, vol_d);
  int steps = 0, bare = 0;
  march_ray<T, false, true>(vol, map, occ, n, __ldg(e), __ldg(e + 1), __ldg(e + 2), d.x, d.y,
                            d.z, max_steps, &steps, &bare);
  counts[2 * pix] = steps;
  counts[2 * pix + 1] = bare;
}

template <typename T>
int launch_counts(const void* vol, VoxelMap<T> map, const void* occ, int vol_w, int vol_h,
                  int vol_d, const void* inv_proj, const void* view_position, int n_views,
                  int height, int width, int max_steps, void* counts, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_views <= 0 || height <= 0 || width <= 0) return (int)cudaSuccess;
  if (n_views > 65535) return (int)cudaErrorInvalidValue;
  const float inv_w = 1.0f / (float)width, inv_h = 1.0f / (float)height;
  const dim3 block(BLOCK_X, BLOCK_Y);
  const dim3 grid((width + BLOCK_X - 1) / BLOCK_X, (height + BLOCK_Y - 1) / BLOCK_Y, n_views);
  const bool cube = vol_w == vol_h && vol_h == vol_d;
  auto kernel = cube ? march_bonsai_count_kernel<T, true> : march_bonsai_count_kernel<T, false>;
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)vol, map, (const uint8_t*)occ, vol_w, vol_h, vol_d, (const float*)inv_proj,
      (const float*)view_position, height, width, inv_w, inv_h, max_steps, (int*)counts);
  return (int)cudaGetLastError();
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
    c = march_ray<uint8_t, FAST>(vol, VoxelMap<uint8_t>{}, occ, dims_of(dims, dims, dims), ex, ey,
                                 ez, dxs[k], dys[k], dzs[k], max_steps);
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
// pointers: vol (vol_d * vol_h * vol_w uint8, [z][y][x]), occ (ceil(vol_d / 8)
// * ceil(vol_h / 8) * ceil(vol_w / 8) uint8, [z][y][x]: the occupancy table,
// one for every view), dx/dy/dz (n_views*height*width float32 each,
// view-major), eye (n_views*3 float32), out (n_views*height*width*4 float32,
// 16-byte aligned). The view is the grid's z (at most 65535), so each view's
// blocks and pixels are a single-view launch's, bit for bit.
int vk_march_bonsai(const void* vol, const void* occ, int vol_w, int vol_h, int vol_d,
                    const void* dx, const void* dy, const void* dz, const void* eye,
                    int n_views, int height, int width, int max_steps, int srgb, void* out,
                    int device, void* stream) {
  return launch_march<uint8_t, false>(vol, VoxelMap<uint8_t>{}, occ, vol_w, vol_h, vol_d, dx, dy,
                                      dz, nullptr, eye, n_views, height, width, max_steps, srgb,
                                      out, device, stream);
}

// The march of n_views whole frames with each pixel's ray made in the kernel
// (K1 with INLINE_RAYS), as vk_march_bonsai marches geometry.rays_fragment_soa's
// rays, bit for bit. inv_proj: n_views * 16 float32 (each view's row-major
// inverse proj*view); view_position: n_views * 4 float32 (eye xyz, 1); the
// rest as vk_march_bonsai.
int vk_march_bonsai_frame(const void* vol, const void* occ, int vol_w, int vol_h, int vol_d,
                          const void* inv_proj, const void* view_position, int n_views,
                          int height, int width, int max_steps, int srgb, void* out, int device,
                          void* stream) {
  return launch_march<uint8_t, true>(vol, VoxelMap<uint8_t>{}, occ, vol_w, vol_h, vol_d, nullptr,
                                     nullptr, nullptr, inv_proj, view_position, n_views, height,
                                     width, max_steps, srgb, out, device, stream);
}

// K1's step counts of n_views whole frames: as vk_march_bonsai_frame, but
// each pixel writes its steps and bare steps, two int32, into counts
// (n_views*height*width*2 int32) instead of its colour.
int vk_march_bonsai_counts(const void* vol, const void* occ, int vol_w, int vol_h, int vol_d,
                           const void* inv_proj, const void* view_position, int n_views,
                           int height, int width, int max_steps, void* counts, int device,
                           void* stream) {
  return launch_counts<uint8_t>(vol, VoxelMap<uint8_t>{}, occ, vol_w, vol_h, vol_d, inv_proj,
                                view_position, n_views, height, width, max_steps, counts, device,
                                stream);
}

// The frame and count entries above over a float32 volume (vol_d * vol_h *
// vol_w float32, [z][y][x]), each tap mapped by the volume's data range: lo its
// smallest voxel and inv = 1 / (largest - lo) in float32, 0 for a constant
// volume (march_bonsai.py:volume_range); occ is its table
// (march_bonsai.py:occupancy_table of the float volume).
int vk_march_bonsai_frame_f32(const void* vol, float lo, float inv, const void* occ, int vol_w,
                              int vol_h, int vol_d, const void* inv_proj,
                              const void* view_position, int n_views, int height, int width,
                              int max_steps, int srgb, void* out, int device, void* stream) {
  return launch_march<float, true>(vol, VoxelMap<float>{lo, inv}, occ, vol_w, vol_h, vol_d,
                                   nullptr, nullptr, nullptr, inv_proj, view_position, n_views,
                                   height, width, max_steps, srgb, out, device, stream);
}

int vk_march_bonsai_counts_f32(const void* vol, float lo, float inv, const void* occ, int vol_w,
                               int vol_h, int vol_d, const void* inv_proj,
                               const void* view_position, int n_views, int height, int width,
                               int max_steps, void* counts, int device, void* stream) {
  return launch_counts<float>(vol, VoxelMap<float>{lo, inv}, occ, vol_w, vol_h, vol_d, inv_proj,
                              view_position, n_views, height, width, max_steps, counts, device,
                              stream);
}

// K2 (compact == 0) or K1b (compact != 0) on `stream`; returns the launch's
// cudaError_t. Device pointers: vol (dims^3 uint8: the hybrid's volume is a
// cube), occ, eye as above; dx/dy/dz (n_sel * tpu *
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
