// The procedural fields of the xor demo (shaders/xor.wgsl) as device
// functions: the fields and normals of march_field.cu (K7), and the lattice
// and window helpers genvol.cu (K9, K8) builds its walk from.
//
// Every function repeats its plain version in vokselis_torch/volume/fields_soa.py
// operation for operation, in the same order, so that the kernels agree with
// those plain versions bitwise on the card. The sources are built with
// --fmad=false (no contracted a*b+c the plain version does not have). The
// hash fract(sin(h) * 43758.5453123) amplifies any one-ulp difference of its
// sine ~4e4 times, so the kernels read it from a table that the plain
// version's own hash filled on the card (the trig field's sines are the
// accurate sinf, as PyTorch's CUDA sin, never __sinf or fast math). A
// plain-version multiplication or division by a Python scalar is a float32
// multiplication by the scalar (a division by the reciprocal taken in double
// and rounded to float), as PyTorch computes it on the card; the constants
// below are written that way.
//
// The lattice argument n = px + 157 py + 113 pz of the hash is built from
// floor-valued floats far below 2^24, so it is exact integer arithmetic; the
// fused field-and-gradient evaluations below rely on that to share corner
// hashes between the base point and its eps-offset points bitwise.
//
// The noise functions take their hashes from their last parameter, a
// TableHash: hash(n) read from the table that the plain version's own hash
// filled for every integer n each octave can reach
// (vokselis_torch/ops/cuda/hash_table.py). Octaves 1 and 2 hash arguments of
// 1.3e5-3.5e5, past sinf's fast reduction (~1.05e5): there the accurate sinf
// takes the Payne-Hanek path through local memory, and one table load
// replaces it, bitwise.

#pragma once

#include <cuda_runtime.h>

namespace vkf {

constexpr float EPS = 1e-4f;  // the one-sided difference step (xor.wgsl:63-67)
constexpr float RES = 25.0f;  // the xor field's lattice scale (xor.wgsl:48)
constexpr float INV_RES = (float)(1.0 / 25.0);
// 1 / (edge1 - edge0) of each smoothstep the fields and shading take
constexpr float INV_NOISE_WIN = (float)(1.0 / (0.25 - 0.5));  // smoothstep(0.5, 0.25, r)
constexpr float INV_XOR_WIN = (float)(1.0 / (0.0 - 0.7));     // smoothstep(0.7, 0.0, r)
constexpr float INV_TRIG_WIN = (float)(1.0 / (0.2 - 0.9));    // smoothstep(0.9, 0.2, r)

// octave o's amplitude and the lattice scale after it (xor.wgsl:37-44), and
// amp * the octave's cumulative scale taken in double, as the plain version's
// Python floats are (fbm_grad_base); o is a constant in unrolled loops
__device__ __forceinline__ float amp(int o) { return o == 0 ? 0.5f : (o == 1 ? 0.25f : 0.125f); }
__device__ __forceinline__ float scale(int o) { return o == 0 ? 2.01f : 2.02f; }
__device__ __forceinline__ float grad_w(int o) {
  return o == 0 ? (float)(0.5 * 1.0)
                : (o == 1 ? (float)(0.25 * 2.01) : (float)(0.125 * (2.01 * 2.02)));
}

// The hashes of lattice cell n of octave o: cell(o, n) once, then at(cell, k)
// is hash(n + k) for the corner offsets k in [0, 271], from the table:
// hash(n) of octave o at values[off[o] + n - lo[o]] for n in [lo[o], lo[o] +
// last[o] + 271]. A cell outside its octave's range (or a NaN n) traps: the
// launch fails rather than read a wrong hash.
struct TableHash {
  const float* values;
  int lo[3], off[3], last[3];
  struct Cell {
    const float* p;
  };
  __device__ __forceinline__ Cell cell(int o, float n) const {
    const float i = n - (float)lo[o];  // exact: both are integers below 2^24
    if (!(i >= 0.0f && i <= (float)last[o])) __trap();
    return {values + off[o] + (int)i};
  }
  __device__ __forceinline__ float at(Cell c, float k) const { return __ldg(c.p + (int)k); }
};

__device__ __forceinline__ float mix(float a, float b, float t) { return a + (b - a) * t; }

__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// smoothstep(edge0, edge1, x) with inv = 1 / (edge1 - edge0)
__device__ __forceinline__ float smoothstep(float edge0, float inv, float x) {
  const float t = clamp01((x - edge0) * inv);
  return t * t * (3.0f - 2.0f * t);
}

__device__ __forceinline__ float smooth(float f) { return f * f * (3.0f - 2.0f * f); }

__device__ __forceinline__ float mix8(float h0, float h1, float h2, float h3, float h4,
                                      float h5, float h6, float h7, float fx, float fy,
                                      float fz) {
  return mix(mix(mix(h0, h1, fx), mix(h2, h3, fx), fy),
             mix(mix(h4, h5, fx), mix(h6, h7, fx), fy), fz);
}

__device__ __forceinline__ float lattice_n(float px, float py, float pz) {
  return px + py * 157.0f + 113.0f * pz;
}

// The 8 corner hashes of lattice cell n (offsets 0, 1, 157, 158, 113, 114,
// 270, 271).
struct Corners {
  float h0, h1, h2, h3, h4, h5, h6, h7;
};

__device__ __forceinline__ Corners corners(const TableHash& h, int o, float n) {
  const TableHash::Cell q = h.cell(o, n);
  Corners c;
  c.h0 = h.at(q, 0.0f);
  c.h1 = h.at(q, 1.0f);
  c.h2 = h.at(q, 157.0f);
  c.h3 = h.at(q, 158.0f);
  c.h4 = h.at(q, 113.0f);
  c.h5 = h.at(q, 114.0f);
  c.h6 = h.at(q, 270.0f);
  c.h7 = h.at(q, 271.0f);
  return c;
}

// value noise (xor.wgsl:22-35) of octave o
__device__ __forceinline__ float noise(float x, float y, float z, int o, const TableHash& h) {
  const float px = floorf(x), py = floorf(y), pz = floorf(z);
  float fx = x - px, fy = y - py, fz = z - pz;
  fx = fx * fx * (3.0f - 2.0f * fx);
  fy = fy * fy * (3.0f - 2.0f * fy);
  fz = fz * fz * (3.0f - 2.0f * fz);
  const Corners c = corners(h, o, lattice_n(px, py, pz));
  return mix8(c.h0, c.h1, c.h2, c.h3, c.h4, c.h5, c.h6, c.h7, fx, fy, fz);
}

__device__ __forceinline__ float fbm(float x, float y, float z, const TableHash& h) {
  float f = amp(0) * noise(x, y, z, 0, h);
  x = x * scale(0);
  y = y * scale(0);
  z = z * scale(0);
  f = f + amp(1) * noise(x, y, z, 1, h);
  x = x * scale(1);
  y = y * scale(1);
  z = z * scale(1);
  f = f + amp(2) * noise(x, y, z, 2, h);
  return f;
}

// the fbm field's lattice coordinates (xor.wgsl:57), axis by axis
__device__ __forceinline__ float lattice_x(float cx) { return (cx + 1.0f) * 32.0f; }
__device__ __forceinline__ float lattice_y(float cy, float sin_t) {
  return (cy + sin_t * 0.1f) * 32.0f;
}
__device__ __forceinline__ float lattice_z(float cz) { return (cz + 21.0f) * 32.0f; }

__device__ __forceinline__ void lattice(float cx, float cy, float cz, float sin_t, float& x,
                                        float& y, float& z) {
  x = lattice_x(cx);
  y = lattice_y(cy, sin_t);
  z = lattice_z(cz);
}

__device__ __forceinline__ float radius(float cx, float cy, float cz) {
  return sqrtf(cx * cx + cy * cy + cz * cz);
}

// noise_volume (xor.wgsl:55-61): (val, alpha)
__device__ __forceinline__ float noise_volume(float cx, float cy, float cz, float sin_t,
                                              float& alpha, const TableHash& h) {
  float x, y, z;
  lattice(cx, cy, cz, sin_t, x, y, z);
  const float val = fbm(x, y, z, h);
  alpha = val * smoothstep(0.5f, INV_NOISE_WIN, radius(cx, cy, cz));
  return val;
}

__device__ __forceinline__ float noise_volume_alpha(float cx, float cy, float cz, float sin_t,
                                                    const TableHash& h) {
  float alpha;
  noise_volume(cx, cy, cz, sin_t, alpha, h);
  return alpha;
}

__device__ __forceinline__ void normalize(float gx, float gy, float gz, float& nx, float& ny,
                                          float& nz) {
  const float n = sqrtf(gx * gx + gy * gy + gz * gz);
  const float inv = 1.0f / fmaxf(n, 1e-20f);
  nx = gx * inv;
  ny = gy * inv;
  nz = gz * inv;
}

// gradient (xor.wgsl:63-67): the one-sided difference normal of the alpha,
// from five independent field evaluations
__device__ __forceinline__ void gradient(float cx, float cy, float cz, float sin_t, float& nx,
                                         float& ny, float& nz, const TableHash& h) {
  const float a0 = noise_volume_alpha(cx, cy, cz, sin_t, h);
  const float gx = a0 - noise_volume_alpha(cx - EPS, cy, cz, sin_t, h);
  const float gy = a0 - noise_volume_alpha(cx, cy - EPS, cz, sin_t, h);
  const float gz = a0 - noise_volume_alpha(cx, cy, cz - EPS, sin_t, h);
  normalize(gx, gy, gz, nx, ny, nz);
}

// fbm4 (fields_soa.fbm_base + fbm_offsets_from_base): fbm at (x, y, z) and
// at the three one-sided offset points, hash-shared: 60 sins instead of 96,
// bitwise the same values.
__device__ __forceinline__ void fbm4(float x, float y, float z, float xe, float ye, float ze,
                                     float& f0, float& fxo, float& fyo, float& fzo,
                                     const TableHash& h) {
  f0 = 0.0f;
  fxo = 0.0f;
  fyo = 0.0f;
  fzo = 0.0f;
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    const float px = floorf(x), py = floorf(y), pz = floorf(z);
    const float fx = smooth(x - px), fy = smooth(y - py), fz = smooth(z - pz);
    const Corners c = corners(h, o, lattice_n(px, py, pz));
    f0 = f0 + amp(o) * mix8(c.h0, c.h1, c.h2, c.h3, c.h4, c.h5, c.h6, c.h7, fx, fy, fz);

    const float pxe = floorf(xe);
    const bool cxs = pxe < px;
    const TableHash::Cell q_x = h.cell(o, lattice_n(pxe, py, pz));
    const float fxe = smooth(xe - pxe);
    const float vx = mix8(h.at(q_x, 0.0f), cxs ? c.h0 : c.h1, h.at(q_x, 157.0f),
                          cxs ? c.h2 : c.h3, h.at(q_x, 113.0f), cxs ? c.h4 : c.h5,
                          h.at(q_x, 270.0f), cxs ? c.h6 : c.h7, fxe, fy, fz);

    const float pye = floorf(ye);
    const bool cys = pye < py;
    const TableHash::Cell q_y = h.cell(o, lattice_n(px, pye, pz));
    const float fye = smooth(ye - pye);
    const float vy = mix8(h.at(q_y, 0.0f), h.at(q_y, 1.0f), cys ? c.h0 : c.h2,
                          cys ? c.h1 : c.h3, h.at(q_y, 113.0f), h.at(q_y, 114.0f),
                          cys ? c.h4 : c.h6, cys ? c.h5 : c.h7, fx, fye, fz);

    const float pze = floorf(ze);
    const bool czs = pze < pz;
    const TableHash::Cell q_z = h.cell(o, lattice_n(px, py, pze));
    const float fze = smooth(ze - pze);
    const float vz = mix8(h.at(q_z, 0.0f), h.at(q_z, 1.0f), h.at(q_z, 157.0f),
                          h.at(q_z, 158.0f), czs ? c.h0 : c.h4, czs ? c.h1 : c.h5,
                          czs ? c.h2 : c.h6, czs ? c.h3 : c.h7, fx, fy, fze);
    fxo = fxo + amp(o) * vx;
    fyo = fyo + amp(o) * vy;
    fzo = fzo + amp(o) * vz;
    if (o < 2) {
      x = x * scale(o);
      y = y * scale(o);
      z = z * scale(o);
      xe = xe * scale(o);
      ye = ye * scale(o);
      ze = ze * scale(o);
    }
  }
}

// noise_volume_grad: (val, alpha, normal) of the fbm field from one fbm4,
// bitwise noise_volume + gradient
__device__ __forceinline__ float noise_volume_grad(float cx, float cy, float cz, float sin_t,
                                                   float& a0, float& nx, float& ny, float& nz,
                                                   const TableHash& h) {
  const float ox = cx - EPS, oy = cy - EPS, oz = cz - EPS;
  float x, y, z, xe, ye, ze;
  lattice(cx, cy, cz, sin_t, x, y, z);
  lattice(ox, oy, oz, sin_t, xe, ye, ze);
  float f0, fxo, fyo, fzo;
  fbm4(x, y, z, xe, ye, ze, f0, fxo, fyo, fzo, h);
  a0 = f0 * smoothstep(0.5f, INV_NOISE_WIN, radius(cx, cy, cz));
  const float gx = a0 - fxo * smoothstep(0.5f, INV_NOISE_WIN, radius(ox, cy, cz));
  const float gy = a0 - fyo * smoothstep(0.5f, INV_NOISE_WIN, radius(cx, oy, cz));
  const float gz = a0 - fzo * smoothstep(0.5f, INV_NOISE_WIN, radius(cx, cy, oz));
  normalize(gx, gy, gz, nx, ny, nz);
  return f0;
}

// noise_volume_grad_analytic: the normal from the closed-form gradient of
// alpha, from the value's own 24 corner hashes (fbm_grad_base)
__device__ __forceinline__ float noise_volume_grad_analytic(float cx, float cy, float cz,
                                                            float sin_t, float& a0, float& nx,
                                                            float& ny, float& nz,
                                                            const TableHash& h) {
  float x, y, z;
  lattice(cx, cy, cz, sin_t, x, y, z);
  float f0 = 0.0f, gpx = 0.0f, gpy = 0.0f, gpz = 0.0f;
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    const float px = floorf(x), py = floorf(y), pz = floorf(z);
    const float tx = x - px, ty = y - py, tz = z - pz;
    const float fx = smooth(tx), fy = smooth(ty), fz = smooth(tz);
    const float dsx = 6.0f * tx * (1.0f - tx);
    const float dsy = 6.0f * ty * (1.0f - ty);
    const float dsz = 6.0f * tz * (1.0f - tz);
    const Corners c = corners(h, o, lattice_n(px, py, pz));
    const float m01 = mix(c.h0, c.h1, fx);
    const float m23 = mix(c.h2, c.h3, fx);
    const float m45 = mix(c.h4, c.h5, fx);
    const float m67 = mix(c.h6, c.h7, fx);
    const float a = mix(m01, m23, fy);
    const float b = mix(m45, m67, fy);
    f0 = f0 + amp(o) * mix(a, b, fz);
    const float dfx = mix(mix(c.h1 - c.h0, c.h3 - c.h2, fy), mix(c.h5 - c.h4, c.h7 - c.h6, fy),
                          fz);
    const float dfy = mix(m23 - m01, m67 - m45, fz);
    const float dfz = b - a;
    gpx = gpx + grad_w(o) * dfx * dsx;
    gpy = gpy + grad_w(o) * dfy * dsy;
    gpz = gpz + grad_w(o) * dfz * dsz;
    if (o < 2) {
      x = x * scale(o);
      y = y * scale(o);
      z = z * scale(o);
    }
  }
  const float r = radius(cx, cy, cz);
  const float mask = smoothstep(0.5f, INV_NOISE_WIN, r);
  a0 = f0 * mask;
  const float t = clamp01((r - 0.5f) * -4.0f);
  const float dmask = 6.0f * t * (1.0f - t) * -4.0f;
  const float w_rad = f0 * dmask / fmaxf(r, 1e-20f);
  const float gx = 32.0f * mask * gpx + w_rad * cx;
  const float gy = 32.0f * mask * gpy + w_rad * cy;
  const float gz = 32.0f * mask * gpz + w_rad * cz;
  normalize(gx, gy, gz, nx, ny, nz);
  return f0;
}

// the bitwise x&y&z field (xor.wgsl:46-53)
__device__ __forceinline__ float xor_field(float cx, float cy, float cz, float sin_t,
                                           float& alpha) {
  float x, y, z;
  lattice(cx, cy, cz, sin_t, x, y, z);
  const int qx = (int)(x * RES), qy = (int)(y * RES), qz = (int)(z * RES);
  const float val = (float)(qx & qy & qz) * INV_RES;
  alpha = val * smoothstep(0.7f, INV_XOR_WIN, radius(cx, cy, cz));
  return val;
}

// the framework-defined trig field; takes RAW time
__device__ __forceinline__ float trig_field(float cx, float cy, float cz, float time,
                                            float& alpha) {
  const float val = 0.5f * sinf(8.0f * cx + time) * sinf(8.0f * cy + 0.5f * time) *
                        sinf(8.0f * cz) +
                    0.5f;
  alpha = val * smoothstep(0.9f, INV_TRIG_WIN, radius(cx, cy, cz));
  return val;
}

}  // namespace vkf
