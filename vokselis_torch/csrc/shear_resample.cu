// The shear-warp fast renderer's two slab stages, for NVIDIA Hopper (sm_90a):
// K3 resamples every pre-blended slab onto the intermediate grid, K4
// composites the resampled stack front to back, and resample_composite_kernel
// does both in one pass, the one the fast and hybrid frames launch.
//
// K3 replaces vokselis_tpu/ops/pallas/shear_resample.py:_resample_kernel
// (launched by resample_slabs). Slab k's value at intermediate texel (i, u) is
//   sum_dv sum_du wv[k,dv,i] * volm[k,dv,du] * wu[k,du,u],
// hat weights max(0, 1 - |pos - col|) over cols [0, D-1]: a bilinear sample of
// the slab at (pos_v[k,i], pos_u[k,u]) that is zero outside [0, D-1]. The TPU
// ran it as two hat-weight matmuls on the MXU; here one thread per (k, i, u),
// u fastest, gathers the four taps from the bf16 slab and rounds as those
// matmuls round, so that K3 is bit for bit the TPU kernel:
//   c0 = floor(pos), c1 = c0 + 1; w_c = bf16(max(0, 1 - |pos - c|)) (not
//   1 - frac and frac: a different float); a tap outside [0, D-1] reads 0;
//   top = bf16(a00 * wu0 + a01 * wu1); bot = bf16(a10 * wu0 + a11 * wu1);
//   val = bf16(top * wv0 + bot * wv1).
// Each product of a bf16 tap and a bf16 weight is exact in float32, so each
// sum rounds once, as the MXU's float32 accumulation does.
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
// resample_composite_kernel replaces the pair K3 -> K4 (the JAX package's
// shear_resample.py:resample_composite, which chains the two TPU kernels).
// It computes composite(resample_slabs(...)) bit for bit: each sample K4
// would read is resampled in place with K3's taps, range tests, weights and
// roundings, widened back from bf16 (what the stack held), then composited
// with K4's operations in K4's order; the (gp, I, I) bf16 stack (134 MB at
// I=512, 537 MB at I=1024) never reaches device memory. Design:
//   - one CTA of 256 threads per tile of 8 intermediate rows (one occ_rb row
//     block) x RC_COLS = 32 columns, one texel a thread. Of the widths swept
//     once (32, 64, 128; PERF.md), 32 was the fastest (0.1257 ms at I=512
//     on an H100, against 0.1751 and 0.3920): more, narrower tiles shorten
//     the longest serial walk;
//   - in-kernel compaction in place of the TPU's scalar prefetch of
//     occupied-chunk ids: one thread per slab reads sgn and both gates, and
//     a ballot and prefix sum list the live slabs in marching order in
//     shared memory. A slab gated off by either gate, or a padding row,
//     adds an exact zero in the pair (sample 0, transfer 0, alpha 0), so
//     leaving it out changes no bit;
//   - pos_u and pos_v are affine per slab, so a tile's taps in slab k lie in
//     the rectangle spanned by its first and last row and column (clamped
//     into [0, D-1] in float, columns widened to 16-byte groups). cp.async
//     streams the windows of RC_GROUP slabs at a time into shared memory,
//     one group ahead of the composite (double-buffered). A window over
//     RC_WIN_CAP texels (eye-inside poses, coarse intermediates) is not
//     staged: its taps come from the pack through __ldg, the same bf16, and
//     the tile is counted in *over;
//   - a tap's hat weights and index depend on its slab and on its row or
//     its column alone, so they are made once per tile, slab and row or
//     column (RC_ROWS + RC_COLS entries a slab), one group ahead, into a
//     double-buffered table in shared memory; a texel reads its two entries;
//   - a group's taps and weighted sums are independent of alpha and run
//     first; then only a sample above 0.1 at a texel below alpha 0.95 is
//     shaded: in the pair a sample <= 0.1 adds an exact zero and K4 stops at
//     0.95, so the kernel shades fewer samples than K4 and gives the same
//     bits;
//   - the CTA stops when no texel of the tile is below alpha 0.95
//     (__syncthreads_or).
// No tensor cores: a sample is a 4-tap gather, not a dot product; the TPU's
// hat-weight matmuls on the MXU existed because Mosaic cannot gather. What
// bounds it: the larger of the bytes it must move (the pack texels that
// its composited samples tap, positions, irho and the planes written) and
// the float operations: 9 a resampled sample (6 multiplies, 3 adds), 8 a
// position's two weights (once per live slab, row and column), K4's 73
// (K4b's 41) a shaded sample; at I=512 and the bench pose both are a few microseconds
// (chip_smoke.py prints them). What holds it above that is the serial
// walk, one barrier pair per group of slabs, over up to ~150
// live slabs in the tiles that never saturate.
//
// Numerics: all kernels repeat their plain versions' float32 operations in
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
constexpr int RC_THREADS = 256;  // fused kernel: threads per block
constexpr int RC_ROWS = 8;  // fused kernel: tile rows (one occ_rb row block at I // 8 blocks)
constexpr int RC_COLS = RC_THREADS / RC_ROWS;  // fused kernel: tile columns, one texel a thread
constexpr int RC_WIN_CAP = 2048;  // bf16 elements of a slab window in shared memory (4 KB)
constexpr int RC_GROUP = 4;  // fused kernel: slabs a pipeline stage holds
constexpr int RC_TAPS = RC_ROWS + RC_COLS;  // fused kernel: tap-table entries a slab

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

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The TPU kernel's hat weight of column col at pos: max(0, 1 - |pos - col|)
// in float32 in that order, rounded to bf16 (shear_resample.py:131-133). A
// NaN passes through, as torch.clamp_min passes it.
__device__ __forceinline__ float hat(float pos, float col) {
  const float w = 1.0f - fabsf(pos - col);
  return round_bf16(w < 0.0f ? 0.0f : w);
}

// Bilinear taps of one position over cols [0, d-1] (hi = d - 1): the two
// taps' hat weights, the first tap's index and whether each tap is inside.
// The range tests run in float, so a far-off position never reaches an int
// cast.
struct Taps {
  float w0, w1;
  int i0;
  bool ok0, ok1;
};

__device__ __forceinline__ Taps taps_of(float pos, float hi) {
  const float p0 = floorf(pos);
  Taps t;
  t.w0 = hat(pos, p0);
  t.w1 = hat(pos, p0 + 1.0f);
  t.ok0 = p0 >= 0.0f && p0 <= hi;
  t.ok1 = p0 >= -1.0f && p0 <= hi - 1.0f;
  t.i0 = (t.ok0 || t.ok1) ? (int)p0 : 0;
  return t;
}

// One resampled value from its four taps (0 outside the slab), rounded as
// the TPU kernel's two hat-weight matmuls round (shear_resample.py:135-167):
// each tap row's sum along u to bf16, then the sum along v. A bf16 tap times
// a bf16 weight is exact in float32, so each sum rounds once; the caller
// rounds the result to bf16.
__device__ __forceinline__ float resample_value(float a00, float a01, float a10, float a11,
                                                const Taps& tu, const Taps& tv) {
  const float top = round_bf16(a00 * tu.w0 + a01 * tu.w1);
  const float bot = round_bf16(a10 * tu.w0 + a11 * tu.w1);
  return top * tv.w0 + bot * tv.w1;
}

// A tap-table entry of the fused kernel: the two bf16 hat weights, then the
// first tap's index + 1 (>= 0) with ok0 and ok1 in bits 16 and 17. The
// weights are bf16 already, so the entry gives back the same floats.
__device__ __forceinline__ uint2 pack_taps(const Taps& t) {
  const unsigned w = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(t.w0)) |
                     ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(t.w1)) << 16);
  return make_uint2(w, (unsigned)(t.i0 + 1) | (t.ok0 ? 1u << 16 : 0u) | (t.ok1 ? 1u << 17 : 0u));
}

__device__ __forceinline__ Taps unpack_taps(uint2 e) {
  Taps t;
  t.w0 = __uint_as_float(e.x << 16);
  t.w1 = __uint_as_float(e.x & 0xffff0000u);
  t.i0 = (int)(e.y & 0xffffu) - 1;
  t.ok0 = (e.y >> 16) & 1u;
  t.ok1 = (e.y >> 17) & 1u;
  return t;
}

__device__ __forceinline__ float tap(const __nv_bfloat16* __restrict__ slab, int d,
                                     bool ok, int v, int u) {
  return ok ? __bfloat162float(slab[(size_t)v * d + u]) : 0.0f;
}

// One sample s of the composite at a texel with irho rho: its transfer and
// alpha, then the front-to-back update, in K4's order.
struct Shade {
  float alpha, cr, cg, cb;
};

__device__ __forceinline__ Shade shade_sample(float s, float rho, bool exact) {
  float tv = (fminf(s, 0.9f) - 0.10f) * INV_SMOOTH_SPAN;
  tv = fminf(fmaxf(tv, 0.0f), 1.0f);
  tv = tv * tv * (3.0f - 2.0f * tv);
  Shade c;
  if (exact) {
    c.cr = 0.5f + 0.5f * cosf(TAU * (1.0f * tv + 0.0f));
    c.cg = 0.5f + 0.5f * cosf(TAU * (1.7f * tv + 0.15f));
    c.cb = 0.5f + 0.5f * cosf(TAU * (0.4f * tv + 0.20f));
  } else {
    const float pu = U_SCALE * tv - 1.0f;
    c.cr = horner(PAL_R_LO, pu);
    c.cg = horner(PAL_G_LO, pu);
    c.cb = horner(PAL_B_LO, pu);
  }
  c.alpha = 1.0f - expf(rho * logf(1.0f - tv));
  return c;
}

__device__ __forceinline__ void composite_step(const Shade& c, float& r, float& gg, float& b,
                                               float& a) {
  const float w = (1.0f - a) * c.alpha;
  r = r + w * c.cr;
  gg = gg + w * c.cg;
  b = b + w * c.cb;
  a = a + w;
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
    const float hi = (float)(d - 1);
    const Taps tv = taps_of(__ldg(pos_v + (size_t)k * iv + i), hi);
    const Taps tu = taps_of(__ldg(pos_u + (size_t)k * iu + u), hi);
    val = resample_value(tap(slab, d, tv.ok0 && tu.ok0, tv.i0, tu.i0),
                         tap(slab, d, tv.ok0 && tu.ok1, tv.i0, tu.i0 + 1),
                         tap(slab, d, tv.ok1 && tu.ok0, tv.i0 + 1, tu.i0),
                         tap(slab, d, tv.ok1 && tu.ok1, tv.i0 + 1, tu.i0 + 1), tu, tv);
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
    composite_step(shade_sample(__bfloat162float(stack[(size_t)k * plane + px]), rho, exact), r,
                   gg, b, a);
  }
  out[px] = r;
  out[plane + px] = gg;
  out[2 * plane + px] = b;
  out[3 * plane + px] = a;
}

// ---- the fused slab stage: resample_composite_kernel ----------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A tap of slab k, from its window in shared memory (w: first row, rows,
// first column, pitch; rows 0 for a window over capacity) or, outside it,
// from the pack in device memory: the same bf16 either way.
__device__ __forceinline__ float win_tap(const __nv_bfloat16* __restrict__ win, short4 w,
                                         const __nv_bfloat16* __restrict__ slab, int d, bool ok,
                                         int v, int u) {
  if (!ok) return 0.0f;
  const unsigned dv = (unsigned)(v - w.x), du = (unsigned)(u - w.z);
  if (dv < (unsigned)w.y && du < (unsigned)w.w) return __bfloat162float(win[dv * w.w + du]);
  const unsigned short* p = (const unsigned short*)slab + (size_t)v * d + u;
  return __bfloat162float(__ushort_as_bfloat16(__ldg(p)));
}

__device__ __forceinline__ int clamp_index(float x, float hi) {
  return (int)fminf(fmaxf(x, 0.0f), hi);
}

// one slab's slot of a fused-kernel pipeline stage, its window; a stage
// holds RC_GROUP slots
constexpr int RC_SLOT = RC_WIN_CAP * 2;
constexpr int RC_STAGE = RC_GROUP * RC_SLOT;
static_assert(RC_SLOT % 16 == 0, "slot alignment");

template <bool EXACT>
__global__ void __launch_bounds__(RC_THREADS)
    resample_composite_kernel(const __nv_bfloat16* __restrict__ packs, int n_packs,
                              const int* __restrict__ m_ptr, int g, int d,
                              const float* __restrict__ pos_u, const float* __restrict__ pos_v,
                              int gp, int iv, int iu, const int* __restrict__ sgn_ptr,
                              const float* __restrict__ irho, const uint8_t* __restrict__ occ_k,
                              const uint8_t* __restrict__ occ_rb, int nrb, int rows_per_block,
                              float* __restrict__ out, int* __restrict__ over) {
  extern __shared__ __align__(16) unsigned char smem[];
  short4* wins = (short4*)(smem + 2 * RC_STAGE);  // per live slab, marching order
  int* slabs = (int*)(wins + gp);
  __shared__ int warp_live[RC_THREADS / 32];
  // per group parity, slab of the group and tile row (then column): its taps
  __shared__ uint2 tap_tab[2][RC_GROUP * RC_TAPS];
  __shared__ int n_live, n_over;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * RC_COLS;
  const int c1 = min(c0 + RC_COLS, iu) - 1;
  const int i0 = blockIdx.y * RC_ROWS;
  const int rb = i0 / rows_per_block;
  const bool ascending = __ldg(sgn_ptr) > 0;
  int m = __ldg(m_ptr);
  m = m < 0 ? 0 : (m >= n_packs ? n_packs - 1 : m);
  const __nv_bfloat16* vol = packs + (size_t)m * g * d * d;
  const float hi = (float)(d - 1);

  // 1. the live slabs in marching order, each with its window: a slab
  // gated off by occ_k or occ_rb, or a padding row k >= g, adds an exact
  // zero in the K3 -> K4 pair (sample 0, transfer 0, alpha 0) and is left out
  if (tid == 0) n_live = n_over = 0;
  __syncthreads();
  for (int base = 0; base < gp; base += RC_THREADS) {
    const int t = base + tid;
    const int k = ascending ? t : gp - 1 - t;
    const bool live = t < gp && k < g && (occ_k == nullptr || occ_k[k] != 0) &&
                      (occ_rb == nullptr || occ_rb[(size_t)k * nrb + rb] != 0);
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    if (live) {
      int at = n_live + __popc(ballot & ((1u << lane) - 1u));
      for (int q = 0; q < warp; ++q) at += warp_live[q];
      // positions are affine in the row and column, so the tile's taps lie
      // between its first and last row's and column's
      const float va = __ldg(pos_v + (size_t)k * iv + i0);
      const float vb = __ldg(pos_v + (size_t)k * iv + i0 + RC_ROWS - 1);
      const float ua = __ldg(pos_u + (size_t)k * iu + c0);
      const float ub = __ldg(pos_u + (size_t)k * iu + c1);
      const int v_lo = clamp_index(floorf(fminf(va, vb)), hi);
      const int v_hi = clamp_index(floorf(fmaxf(va, vb)) + 1.0f, hi);
      const int u_lo = clamp_index(floorf(fminf(ua, ub)), hi) & ~7;
      const int u_hi = clamp_index(floorf(fmaxf(ua, ub)) + 1.0f, hi) | 7;
      const int rows = v_hi - v_lo + 1, pitch = u_hi - u_lo + 1;
      const bool fits = rows * pitch <= RC_WIN_CAP;
      if (!fits) atomicAdd(&n_over, 1);
      slabs[at] = k;
      wins[at] = make_short4((short)v_lo, (short)(fits ? rows : 0), (short)u_lo, (short)pitch);
    }
    __syncthreads();
    if (tid == 0) {
      int sum = 0;
      for (int q = 0; q < RC_THREADS / 32; ++q) sum += warp_live[q];
      n_live += sum;
    }
    __syncthreads();
  }
  const int n = n_live;
  if (tid == 0 && n_over > 0) {
    atomicAdd(over, 1);
    atomicAdd(over + 1, n_over);
  }

  // 2. stream groups of RC_GROUP live slabs' windows into shared memory,
  // one group ahead of the composite
  const int n_groups = (n + RC_GROUP - 1) / RC_GROUP;
  auto issue = [&](int grp) {
    unsigned char* stage = smem + (grp & 1) * RC_STAGE;
    const int first = grp * RC_GROUP;
    const int count = min(RC_GROUP, n - first);
    for (int sl = 0; sl < count; ++sl) {
      unsigned char* st = stage + sl * RC_SLOT;
      const int k = slabs[first + sl];
      const short4 w = wins[first + sl];
      const int chunks = w.w / 8;
      for (int e = tid; e < w.y * chunks; e += RC_THREADS) {
        const int row = e / chunks, ch = e - row * chunks;
        cp_async16(st + 16 * e, vol + ((size_t)k * d + w.x + row) * d + w.z + 8 * ch);
      }
    }
    cp_async_commit();
  };
  // and their tap tables: thread tid < RC_GROUP * RC_TAPS loads one slab's
  // position of one tile row or column before the group ahead composites
  // (its latency hidden there) and writes its entry after
  const int tab_sl = tid / RC_TAPS, tab_q = tid - tab_sl * RC_TAPS;
  auto load_pos = [&](int grp) -> float {
    if (tab_sl >= RC_GROUP || grp * RC_GROUP + tab_sl >= n) return 0.0f;
    const int k = slabs[grp * RC_GROUP + tab_sl];
    if (tab_q < RC_ROWS) return __ldg(pos_v + (size_t)k * iv + i0 + tab_q);
    const int uq = c0 + tab_q - RC_ROWS;
    return uq < iu ? __ldg(pos_u + (size_t)k * iu + uq) : 0.0f;
  };
  auto store_taps = [&](int grp, float pos) {
    if (tab_sl < RC_GROUP && grp * RC_GROUP + tab_sl < n)
      tap_tab[grp & 1][tid] = pack_taps(taps_of(pos, hi));
  };

  // 3. composite: each thread holds one texel. A group's samples do not
  // depend on alpha, so their taps are read and weighted first (independent
  // work across slabs); then, slab after slab, only a sample above 0.1 at a
  // texel still below alpha 0.95 is shaded and composited. In the pair, a
  // sample <= 0.1 (bf16, so <= 0.0996) has transfer 0 and alpha exactly 0
  // (irho finite) and adds an exact zero, and K4 stops a texel at 0.95; a
  // NaN sample is shaded, as K4 shades it
  const int row = tid / RC_COLS, col = tid % RC_COLS;
  const int u = c0 + col;
  const bool col_ok = u < iu;
  const size_t px = (size_t)(i0 + row) * iu + u;
  const float rho = col_ok ? __ldg(irho + px) : 0.0f;
  float r = 0.0f, gg = 0.0f, b = 0.0f, a = 0.0f;
  if (n_groups > 0) {
    issue(0);
    store_taps(0, load_pos(0));
  }
  for (int grp = 0; grp < n_groups; ++grp) {
    if (grp + 1 < n_groups) {
      issue(grp + 1);
    } else {
      cp_async_commit();
    }
    const float next_pos = load_pos(grp + 1);
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* stage = smem + (grp & 1) * RC_STAGE;
    const uint2* tab = tap_tab[grp & 1];
    const int first = grp * RC_GROUP;
    const int count = min(RC_GROUP, n - first);
    bool alive = false;
    if (col_ok) {
      float sv[RC_GROUP];
#pragma unroll
      for (int sl = 0; sl < RC_GROUP; ++sl) {
        if (sl < count) {
          const __nv_bfloat16* win = (const __nv_bfloat16*)(stage + sl * RC_SLOT);
          const short4 w = wins[first + sl];
          const __nv_bfloat16* slab = vol + (size_t)slabs[first + sl] * d * d;
          const Taps tu = unpack_taps(tab[sl * RC_TAPS + RC_ROWS + col]);
          const Taps tv = unpack_taps(tab[sl * RC_TAPS + row]);
          const float val = resample_value(
              win_tap(win, w, slab, d, tv.ok0 && tu.ok0, tv.i0, tu.i0),
              win_tap(win, w, slab, d, tv.ok0 && tu.ok1, tv.i0, tu.i0 + 1),
              win_tap(win, w, slab, d, tv.ok1 && tu.ok0, tv.i0 + 1, tu.i0),
              win_tap(win, w, slab, d, tv.ok1 && tu.ok1, tv.i0 + 1, tu.i0 + 1), tu, tv);
          // the stack between K3 and K4 held the sample in bf16
          sv[sl] = __bfloat162float(__float2bfloat16_rn(val));
        }
      }
#pragma unroll
      for (int sl = 0; sl < RC_GROUP; ++sl) {
        if (sl < count && a < 0.95f && !(sv[sl] <= 0.1f))
          composite_step(shade_sample(sv[sl], rho, EXACT), r, gg, b, a);
      }
      alive = a < 0.95f;
    }
    // the table grp + 1 reads was last read by group grp - 1, before the
    // barrier that ended it
    store_taps(grp + 1, next_pos);
    // stop once no texel of the tile is below alpha 0.95; the barrier
    // also frees this stage for group grp + 2 and shows grp + 1 its table
    if (!__syncthreads_or(alive)) break;
  }
  cp_async_wait<0>();
  if (!col_ok) return;
  const size_t plane = (size_t)iv * iu;
  out[px] = r;
  out[plane + px] = gg;
  out[2 * plane + px] = b;
  out[3 * plane + px] = a;
}

template <bool EXACT>
cudaError_t launch_resample_composite(const void* packs, int n_packs, const void* m, int g,
                                      int d, const void* pos_u, const void* pos_v, int gp, int iv,
                                      int iu, const void* sgn, const void* irho,
                                      const void* occ_k, const void* occ_rb, int nrb,
                                      int rows_per_block, void* out, void* over,
                                      cudaStream_t stream) {
  const size_t smem = 2 * (size_t)RC_STAGE + (size_t)gp * (sizeof(short4) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        resample_composite_kernel<EXACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((iu + RC_COLS - 1) / RC_COLS, iv / RC_ROWS);
  resample_composite_kernel<EXACT><<<grid, RC_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)packs, n_packs, (const int*)m, g, d, (const float*)pos_u,
      (const float*)pos_v, gp, iv, iu, (const int*)sgn, (const float*)irho,
      (const uint8_t*)occ_k, (const uint8_t*)occ_rb, nrb, rows_per_block, (float*)out,
      (int*)over);
  return cudaGetLastError();
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

// K3 -> K4 fused on `stream`; returns the launch's cudaError_t. Pointers as
// vk_resample_slabs's and vk_composite's (occ_k: gp uint8, occ_rb: gp * nrb
// uint8, either null), over (2 int32, accumulated: tiles with a window over
// the shared capacity, and such windows). Needs d % 8 == 0, iv % 8 == 0,
// rows_per_block % 8 == 0, iu % 4 == 0 and 16-byte aligned packs, pos_u and
// pos_v.
int vk_resample_composite(const void* packs, int n_packs, const void* m, int g, int d,
                          const void* pos_u, const void* pos_v, int gp, int iv, int iu,
                          const void* sgn, const void* irho, const void* occ_k,
                          const void* occ_rb, int nrb, int rows_per_block, int exact, void* out,
                          void* over, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (iv <= 0 || iu <= 0) return (int)cudaSuccess;
  if (d % 8 || iv % RC_ROWS || rows_per_block % RC_ROWS || iu % 4 || gp < 0)
    return (int)cudaErrorInvalidValue;
  auto launch = exact ? launch_resample_composite<true> : launch_resample_composite<false>;
  return (int)launch(packs, n_packs, m, g, d, pos_u, pos_v, gp, iv, iu, sgn, irho, occ_k, occ_rb,
                     nrb, rows_per_block, out, over, (cudaStream_t)stream);
}

}  // extern "C"
