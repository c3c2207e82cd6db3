"""The xor demo's frame, plain torch: the procedural fbm field marched by the
compute pass.

A frozen copy of upstream's ``examples/xor`` (github.com/pudnax/vokselis):
the field of shaders/xor.wgsl and the march of shaders/raycast_compute.wgsl.

- Rays (raycast_compute.wgsl:99-117): screen point from the integer pixel
  id, y scaled by -H/W; eye and tangent point unprojected at depths 0 and 1
  through inv_proj (elementwise, never a matmul); the direction normalised.
- The slab test against [-1, 1]^3 (:42-53); t from max(t0, 0); dt =
  max(min over axes of 1 / (dims |d|), 0.01) (:65-68).
- At each sample the nearest texel of the dims^3 grid, ivec3((p + 1) dims /
  2), and its centre c = (g - dims/2) / dims (xor.wgsl:71-72); the field
  ``noise_volume`` there (xor.wgsl:18-61): value noise with hash
  fract(sin(n) 43758.5453123) on the lattice n = x + 157 y + 113 z, three
  octaves of fbm at (c + (1, 0.1 sin t, 21)) 32, scaled 2.01 and 2.02,
  alpha = fbm * smoothstep(0.5, 0.25, |c|); the normal the normalised
  one-sided difference a(c) - a(c - eps e_i), eps 1e-4 (xor.wgsl:63-67).
- Shading (raycast_compute.wgsl:64-86): the texel's rgb is val / 2; Lambert
  against (0, -1, 0); a red-tinted light along normalize(-2, -2, -1),
  masked by smoothstep(0.3, 1.5, p . normalize(1, 1, -1)); the blue bottom
  fill mixed in at 0.2; vol_alpha = smoothstep(0, 0.7, alpha^3).
- Front-to-back compositing from (clear.rgb, 0.1), with the clear colour's
  term (clear.a = 0), while t < t1 and alpha < 0.95 (:88-95); a pixel whose
  ray misses takes the clear colour; alpha out 1 (:121-128).

The normal's form is the configuration's: ``grad`` "fd" is upstream's
one-sided difference, "analytic" the port's default, the closed-form
gradient of the same alpha (the difference's limit as eps -> 0: it reads
the value's own 24 corner hashes where the difference reads 60).

Departures from upstream, each exact in real arithmetic:

- upstream generates the field once into two Rgba16Float textures and the
  march loads them; here it is evaluated at the texel's centre in float32
  at every sample (the same texel, no 16-bit rounding);
- a ray's span is cut to the ball outside which alpha is exactly zero
  (|c| >= 0.5; in p, radius 1 plus the texel's reach 2 sqrt(3) / dims),
  its first sample moved forward onto the ray's own steps t0 + j dt. A
  step there composites exactly nothing (alpha 0, clear.a 0), so the cut
  changes only how t is rounded;
- a zero difference gives a zero normal (its length floored at 1e-20)
  where WGSL's normalize is undefined, and normalize(v) is v (1 / |v|);
- alpha^3 is alpha alpha alpha, and the products of a step are grouped as
  (1 - a) vol_alpha (rgb shade), 3 dshade mask then the tint's channel.

The groupings are those of the port's own float32 version, so that a
float32 program with the same operations reads the same bits.

Rays are flat sets, all the frames' together, marched in blocks; a step
evaluates only the rays still active (a ray never becomes active again).
``dtype`` is the precision of the per-sample arithmetic: float32 is the
reference, bfloat16 the control; positions, the lattice and the hashes
stay float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import strict_float32
from benchmark.reference.march import mat4_apply, smoothstep

CLEAR = (0.023, 0.02, 0.02, 0.0)  # raycast_compute.wgsl:119
ALPHA_START = 0.1  # get_col2's initial alpha (:61)
OPACITY_CUT = 0.95
EPS = 1e-4  # the gradient's offset (xor.wgsl:63-67)
L_DIR = tuple(c / math.sqrt(9.0) for c in (-2.0, -2.0, -1.0))
MASK_DIR = tuple(c / math.sqrt(3.0) for c in (1.0, 1.0, -1.0))
OCTAVES = ((0.5, 2.01), (0.25, 2.02), (0.125, None))
CORNERS = (0.0, 1.0, 157.0, 158.0, 113.0, 114.0, 270.0, 271.0)
# rays a block marches at once: bounds the temporaries at a few GB
BLOCK_RAYS = 1 << 23


def field_time(seed: int) -> float:
    """The field's time for ``seed``: uniform in [0, 2 pi), as float32.
    Upstream freezes the clock's time at init (examples/xor/main.rs:135-146)."""
    t = np.random.default_rng([seed, 2]).uniform(0.0, 2.0 * math.pi)
    return float(np.float32(t))


def rays(inv_proj, width: int, height: int, dims: int):
    """One view's rays and spans: nine flat (H * W,) float32 tensors on
    ``inv_proj``'s device, pixel (row i, column j) at i * W + j: the eye
    (ex, ey, ez), the direction (dx, dy, dz), the span t0 <= t < t1 cut to
    the field's ball (t0 = t1 where the ray misses it) and the step dt."""
    dev = inv_proj.device
    gx = torch.arange(width, dtype=torch.float32, device=dev)[None, :].expand(height, width)
    gy = torch.arange(height, dtype=torch.float32, device=dev)[:, None].expand(height, width)
    sx = 2.0 * gx / width - 1.0
    sy = (2.0 * gy / height - 1.0) * (-(float(height) / float(width)))
    nx, ny, nz, nw = mat4_apply(inv_proj, sx, sy, 0.0)
    fx, fy, fz, fw = mat4_apply(inv_proj, sx, sy, 1.0)
    ex, ey, ez = nx / nw, ny / nw, nz / nw
    dx, dy, dz = fx / fw - ex, fy / fw - ey, fz / fw - ez
    inv_len = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * inv_len, dy * inv_len, dz * inv_len
    # the slab test against [-1, 1]^3
    ix, iy, iz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    ax0, ax1 = (-1.0 - ex) * ix, (1.0 - ex) * ix
    ay0, ay1 = (-1.0 - ey) * iy, (1.0 - ey) * iy
    az0, az1 = (-1.0 - ez) * iz, (1.0 - ez) * iz
    t0 = torch.maximum(torch.minimum(ax0, ax1),
                       torch.maximum(torch.minimum(ay0, ay1), torch.minimum(az0, az1)))
    t1 = torch.minimum(torch.maximum(ax0, ax1),
                       torch.minimum(torch.maximum(ay0, ay1), torch.maximum(az0, az1)))
    t0 = torch.clamp(t0, min=0.0)
    dt = torch.clamp(torch.minimum(1.0 / (dims * torch.abs(dx)),
                                   torch.minimum(1.0 / (dims * torch.abs(dy)),
                                                 1.0 / (dims * torch.abs(dz)))), min=0.01)
    # the ball beyond which alpha is exactly zero: |e + t d|^2 = R^2
    r2 = (1.0 + 2.0 * math.sqrt(3.0) / dims) ** 2
    bq = ex * dx + ey * dy + ez * dz
    cq = ex * ex + ey * ey + ez * ez - r2
    disc = bq * bq - cq
    inside = disc > 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    ts0, ts1 = -bq - sq, -bq + sq
    j0 = torch.ceil(torch.clamp(ts0 - t0, min=0.0) / dt)
    t_begin = t0 + j0 * dt
    t_end = torch.minimum(t1, ts1)
    t0, t1 = torch.where(inside, t_begin, t1), torch.where(inside, t_end, t1)
    return tuple(x.reshape(-1) for x in (ex, ey, ez, dx, dy, dz, t0, t1, dt))


def _hash(n):
    v = torch.sin(n) * 43758.5453123
    return v - torch.floor(v)


def _mix(a, b, t):
    return a + (b - a) * t


def _fbm(x, y, z, dtype, grad=False):
    """Three octaves of value noise at lattice coordinates x, y, z: the value,
    and with ``grad`` its closed-form gradient in the first octave's lattice
    units (the smooth weights' derivative 6 t (1 - t), each octave's by its
    cumulative scale), from the same 24 corner hashes."""
    f, g, cum = 0.0, [0.0, 0.0, 0.0], 1.0
    for amp, scale in OCTAVES:
        p = [torch.floor(v) for v in (x, y, z)]
        t = [(v - q).to(dtype) for v, q in zip((x, y, z), p)]
        w = [u * u * (3.0 - 2.0 * u) for u in t]
        n = p[0] + p[1] * 157.0 + 113.0 * p[2]
        h = [_hash(n + k).to(dtype) for k in CORNERS]
        m01, m23, m45, m67 = (_mix(h[i], h[i + 1], w[0]) for i in (0, 2, 4, 6))
        a, b = _mix(m01, m23, w[1]), _mix(m45, m67, w[1])
        f = f + amp * _mix(a, b, w[2])
        if grad:
            d = (_mix(_mix(h[1] - h[0], h[3] - h[2], w[1]), _mix(h[5] - h[4], h[7] - h[6], w[1]),
                      w[2]),
                 _mix(m23 - m01, m67 - m45, w[2]), b - a)
            g = [gi + amp * cum * di * (6.0 * ti * (1.0 - ti)) for gi, di, ti in zip(g, d, t)]
        if scale is not None:
            x, y, z = x * scale, y * scale, z * scale
            cum = cum * scale
    return (f, *g) if grad else f


def _lattice(cx, cy, cz, sin_t):
    return (cx + 1.0) * 32.0, (cy + sin_t * 0.1) * 32.0, (cz + 21.0) * 32.0


def _radius(cx, cy, cz):
    return torch.sqrt(cx * cx + cy * cy + cz * cz)


def _normalize(gx, gy, gz):
    inv = 1.0 / torch.clamp(torch.sqrt(gx * gx + gy * gy + gz * gz), min=1e-20)
    return gx * inv, gy * inv, gz * inv


def noise_volume(cx, cy, cz, sin_t, dtype=torch.float32):
    """``(val, alpha)`` of the fbm field at texel centres (xor.wgsl:55-61)."""
    val = _fbm(*_lattice(cx, cy, cz, sin_t), dtype)
    return val, val * smoothstep(0.5, 0.25, _radius(cx, cy, cz).to(dtype))


def shaded_field(cx, cy, cz, sin_t, grad: str, dtype=torch.float32):
    """``(val, alpha, nx, ny, nz)`` at texel centres: with ``grad`` "fd"
    upstream's normalised one-sided difference a(c) - a(c - eps e_i)
    (xor.wgsl:63-67); with "analytic" the normalised closed-form gradient
    of the same alpha, fbm(lattice(c)) smoothstep(0.5, 0.25, |c|)."""
    if grad == "fd":
        val, a0 = noise_volume(cx, cy, cz, sin_t, dtype)
        gx = a0 - noise_volume(cx - EPS, cy, cz, sin_t, dtype)[1]
        gy = a0 - noise_volume(cx, cy - EPS, cz, sin_t, dtype)[1]
        gz = a0 - noise_volume(cx, cy, cz - EPS, sin_t, dtype)[1]
        return (val, a0) + _normalize(gx, gy, gz)
    if grad != "analytic":
        raise ValueError(f"grad must be 'fd' or 'analytic', got {grad!r}")
    val, gpx, gpy, gpz = _fbm(*_lattice(cx, cy, cz, sin_t), dtype, grad=True)
    r = _radius(cx, cy, cz).to(dtype)
    mask = smoothstep(0.5, 0.25, r)
    # the window's derivative along r, zero where its clamp is flat; the
    # lattice scales every axis by 32
    t = torch.clamp((r - 0.5) * -4.0, 0.0, 1.0)
    w_rad = val * (6.0 * t * (1.0 - t) * -4.0) / torch.clamp(r, min=1e-20)
    cx, cy, cz = cx.to(dtype), cy.to(dtype), cz.to(dtype)
    return (val, val * mask) + _normalize(32.0 * mask * gpx + w_rad * cx,
                                          32.0 * mask * gpy + w_rad * cy,
                                          32.0 * mask * gpz + w_rad * cz)


def _texel(q, dims: int):
    """The centre of the texel that ivec3((q + 1) dims / 2) loads."""
    half = dims / 2.0
    return (torch.clamp(torch.floor((q + 1.0) * half), 0, dims - 1) - half) / dims


def _shade(val, nx, ny, nz, px, py, pz, dtype):
    """The texel's shaded colour (raycast_compute.wgsl:64-86)."""
    v = val * 0.5
    sh = torch.clamp(-ny, min=0.0)
    dshade = torch.clamp(nx * L_DIR[0] + ny * L_DIR[1] + nz * L_DIR[2], min=0.0)
    dmask = smoothstep(0.3, 1.5, px * MASK_DIR[0] + py * MASK_DIR[1] + pz * MASK_DIR[2]).to(dtype)
    d = 3.0 * dshade * dmask
    bottom = 0.9 * torch.clamp(0.5 - 0.5 * ny, 0.0, 1.0)
    return tuple((v + d * tint) * _mix(sh, bottom * fill, 0.2)
                 for tint, fill in ((1.0, 0.0), (0.1, 0.0), (0.13, 0.6)))


@torch.no_grad()
def _march_block(ray, sin_t, dims, steps, dtype, grad):
    """March one block of rays (nine flat planes) with the normals ``grad``;
    returns the (n, 3) linear rgb, or with ``grad`` None each ray's samples
    inside the ball (n,) int64 (the march of alpha alone)."""
    ex, ey, ez, dx, dy, dz, t0, t1, dt = ray
    n, dev = t0.shape[0], t0.device
    rgb = torch.tensor(CLEAR[:3], dtype=dtype, device=dev).repeat(n, 1)
    inside = torch.zeros((n,), dtype=torch.int64, device=dev)
    live = torch.nonzero(t0 < t1).squeeze(1)
    la = torch.full((live.numel(),), ALPHA_START, dtype=dtype, device=dev)
    lt, lrgb = t0[live], rgb[live]
    for _ in range(steps):
        keep = torch.nonzero((lt < t1[live]) & (la < OPACITY_CUT)).squeeze(1)
        if keep.numel() == 0:
            break
        live, lt, la, lrgb = live[keep], lt[keep], la[keep], lrgb[keep]
        px, py, pz = ex[live] + lt * dx[live], ey[live] + lt * dy[live], ez[live] + lt * dz[live]
        cx, cy, cz = _texel(px, dims), _texel(py, dims), _texel(pz, dims)
        if grad is None:
            alpha = noise_volume(cx, cy, cz, sin_t, dtype)[1]
            inside.index_add_(0, live, (_radius(cx, cy, cz) < 0.5).long())
        else:
            val, alpha, nx, ny, nz = shaded_field(cx, cy, cz, sin_t, grad, dtype)
        vol_alpha = smoothstep(0.0, 0.7, alpha * alpha * alpha)
        one_m_a = 1.0 - la
        if grad is not None:
            shaded = _shade(val, nx, ny, nz, px, py, pz, dtype)
            lrgb = torch.stack([lrgb[:, i] + one_m_a * vol_alpha * shaded[i]
                                + CLEAR[i] * CLEAR[3] * (1.0 - vol_alpha) for i in range(3)],
                               dim=-1)
            rgb[live] = lrgb
        la = la + one_m_a * vol_alpha * (1.0 - CLEAR[3])
        lt = lt + dt[live]
    return inside if grad is None else rgb.to(torch.float32)


def _sin_t(time: float, device):
    return torch.sin(torch.full((), time, dtype=torch.float32, device=device) * 1.0)


def _blocks(ray):
    n = ray[0].shape[0]
    for lo in range(0, n, BLOCK_RAYS):
        yield tuple(x[lo:lo + BLOCK_RAYS] for x in ray)


@torch.no_grad()
def march(ray, time: float, dims: int, steps: int, grad: str, dtype=torch.float32):
    """The (N, 4) float32 backbuffer of the rays ``ray`` (nine flat planes,
    :func:`rays`) through the field at ``time``, with the normals ``grad``
    ("fd" or "analytic", :func:`shaded_field`): linear rgb, alpha 1."""
    strict_float32()
    sin_t = _sin_t(time, ray[0].device)
    out = torch.ones((ray[0].shape[0], 4), dtype=torch.float32, device=ray[0].device)
    out[:, :3] = torch.cat([_march_block(block, sin_t, dims, steps, dtype, grad)
                            for block in _blocks(ray)])
    return out


@torch.no_grad()
def samples(ray, time: float, dims: int, steps: int):
    """Each ray's number of samples (N,) int64 inside the ball (the texel
    centre's |c| < 0.5, |p| < 1 up to a texel), beyond which alpha is
    exactly zero, taken before the ray leaves its span or saturates: the
    samples whose work no implementation can skip."""
    strict_float32()
    sin_t = _sin_t(time, ray[0].device)
    return torch.cat([_march_block(block, sin_t, dims, steps, torch.float32, None)
                      for block in _blocks(ray)])
