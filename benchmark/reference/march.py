"""Ray generation and the exact bonsai march, plain torch.

A frozen copy of the fragment path (shaders/raycast_naive.wgsl:40-125): one
ray per pixel centre, unprojected at depths 0 and 1 through the inverse of
proj @ view (elementwise float32, never a matmul), clipped to the [0, 1]^3
box; dt = 1 / (D * max|d|); while t < t1 and alpha < 0.95, a trilinear
R8Unorm sample with ClampToEdge taps, the transfer smoothstep(0.10, 1.2,
min(0.9, s)) with the vertigo palette (TAU = 6.28318), front-to-back
compositing, p += d * dt; the result sRGB-encoded with alpha 1. Each float32
operation is the one the upstream shader takes, in its order.

Rays are flat (N, 3) sets, marched in blocks; rays that have finished are
dropped from a block every few steps, which changes no ray's operations.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import strict_float32

TAU = 6.28318  # shaders/raycast_naive.wgsl:70, deliberately not 2 pi
OPACITY_CUT = 0.95
# rays a block marches at once: bounds the temporaries at a few GB
BLOCK_RAYS = 1 << 23
COMPACT_EVERY = 16


def max_steps(dims: int) -> int:
    """Steps for a ray across the whole box diagonal."""
    return int(math.ceil(math.sqrt(3.0) * dims)) + 1


def mat4_apply(m, x, y, z: float, w: float = 1.0):
    return [m[i, 0] * x + m[i, 1] * y + m[i, 2] * z + m[i, 3] * w for i in range(4)]


def rays(view_position, inv_proj, width: int, height: int):
    """One view's rays: ``(eye (3,), dirs (H * W, 3))`` on ``inv_proj``'s
    device, pixel (row i, column j) at i * W + j."""
    dev = inv_proj.device
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None, :].expand(height, width)
    py = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5)[:, None].expand(height, width)
    ndc_x, ndc_y = 2.0 * px / width - 1.0, 1.0 - 2.0 * py / height
    nx, ny, nz, nw = mat4_apply(inv_proj, ndc_x, ndc_y, 0.0)
    fx, fy, fz, fw = mat4_apply(inv_proj, ndc_x, ndc_y, 1.0)
    dx, dy, dz = fx / fw - nx / nw, fy / fw - ny / nw, fz / fw - nz / nw
    inv_len = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    dirs = torch.stack([dx * inv_len, dy * inv_len, dz * inv_len], dim=-1)
    return view_position[:3], dirs.reshape(-1, 3)


def _taps(vol, p):
    """The 8 R8Unorm taps (float32 in [0, 1]) and the 3 fractions at ``p``."""
    d, h, w = vol.shape
    size = torch.tensor([w, h, d], dtype=torch.float32, device=vol.device)
    x = p * size - 0.5
    i0 = torch.floor(x)
    f = x - i0
    i0 = i0.to(torch.int64)
    flat = vol.reshape(-1)

    def tap(ix, iy, iz):
        ix, iy, iz = ix.clamp(0, w - 1), iy.clamp(0, h - 1), iz.clamp(0, d - 1)
        return flat[(iz * h + iy) * w + ix].to(torch.float32) * (1.0 / 255.0)

    x0, y0, z0 = i0[:, 0], i0[:, 1], i0[:, 2]
    taps = [tap(x0 + i, y0 + j, z0 + k) for k in (0, 1) for j in (0, 1) for i in (0, 1)]
    return taps, f


def _trilinear(taps, f):
    c000, c100, c010, c110, c001, c101, c011, c111 = taps
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    c00 = c000 + (c100 - c000) * fx
    c10 = c010 + (c110 - c010) * fx
    c01 = c001 + (c101 - c001) * fx
    c11 = c011 + (c111 - c011) * fx
    c0 = c00 + (c10 - c00) * fy
    c1 = c01 + (c11 - c01) * fy
    return c0 + (c1 - c0) * fz


def smoothstep(edge0, edge1, x):
    t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _transfer(s):
    """(tv, (r, g, b)): smoothstep(0.10, 1.2, min(0.9, s)) and vertigo(tv)."""
    tv = smoothstep(0.10, 1.2, torch.clamp(s, max=0.9))
    rgb = [0.5 + 0.5 * torch.cos(TAU * (c * tv + d))
           for c, d in ((1.0, 0.0), (1.7, 0.15), (0.4, 0.20))]
    return tv, rgb


def linear_to_srgb(x):
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * torch.pow(torch.clamp(x, min=1e-12), 1.0 / 2.4) - 0.055)


def _march_block(vol, eye, d, steps, dtype, count):
    """March one block of rays (eye and d (n, 3)); returns the (n, 3) linear
    rgb, or with ``count`` each ray's number of samples whose footprint
    touches a non-zero voxel (n,)."""
    n = d.shape[0]
    dev = d.device
    inv = 1.0 / d
    ta, tb = (0.0 - eye) * inv, (1.0 - eye) * inv
    t0 = torch.amax(torch.minimum(ta, tb), dim=-1)
    t1 = torch.amin(torch.maximum(ta, tb), dim=-1)
    t = torch.clamp(t0, min=0.0)
    dt = 1.0 * torch.amin(1.0 / (float(vol.shape[0]) * torch.abs(d)), dim=-1)
    p = eye + t[:, None] * d
    rgb = torch.zeros((n, 3), dtype=dtype, device=dev)
    a = torch.zeros((n,), dtype=dtype, device=dev)
    live = torch.nonzero(t0 <= t1).squeeze(1)  # rays that hit the box
    touched = torch.zeros((n,), dtype=torch.int64, device=dev) if count else None
    # the state of the live rays only
    lp, ld, ldt, lt, lt1 = p[live], d[live], dt[live], t[live], t1[live]
    lrgb, la = rgb[live], a[live]
    for i in range(steps):
        active = (lt < lt1) & (la < OPACITY_CUT)
        if i % COMPACT_EVERY == 0:
            keep = torch.nonzero(active).squeeze(1)
            rgb[live], a[live] = lrgb, la
            if keep.numel() == 0:
                break
            live, lp, ld, ldt, lt, lt1 = (x[keep] for x in (live, lp, ld, ldt, lt, lt1))
            lrgb, la, active = lrgb[keep], la[keep], active[keep]
        taps, f = _taps(vol, lp)
        if count:
            touched.index_add_(0, live, (active & (torch.stack(taps).amax(dim=0) > 0.0)).long())
        s = _trilinear(taps, f).to(dtype)
        tv, (cr, cg, cb) = _transfer(s)
        if not count:
            w = (1.0 - la) * tv
            new_rgb = torch.stack([lrgb[:, 0] + w * cr, lrgb[:, 1] + w * cg,
                                   lrgb[:, 2] + w * cb], dim=-1)
            lrgb = torch.where(active[:, None], new_rgb, lrgb)
        la = torch.where(active, la + (1.0 - la) * tv, la)
        lp = torch.where(active[:, None], lp + ld * ldt[:, None], lp)
        lt = torch.where(active, lt + ldt, lt)
    else:
        rgb[live], a[live] = lrgb, la
    return touched if count else rgb.to(torch.float32)


@torch.no_grad()
def march(vol, eye, dirs, steps: int, dtype=torch.float32, srgb: bool = True):
    """The frame of rays ``dirs`` (N, 3) from ``eye`` ((3,) or (N, 3))
    through the (D, D, D) uint8 volume ``vol``: (N, 4) float32, rgb
    sRGB-encoded when ``srgb``, alpha 1. ``dtype`` is the precision of the
    sample's transfer, palette and compositing (positions stay float32)."""
    strict_float32()
    out = torch.empty((dirs.shape[0], 4), dtype=torch.float32, device=dirs.device)
    out[:, 3] = 1.0
    eye = eye.expand(dirs.shape)
    for lo in range(0, dirs.shape[0], BLOCK_RAYS):
        hi = min(lo + BLOCK_RAYS, dirs.shape[0])
        rgb = _march_block(vol, eye[lo:hi], dirs[lo:hi], steps, dtype, False)
        out[lo:hi, :3] = linear_to_srgb(rgb) if srgb else rgb
    return out


@torch.no_grad()
def touched_samples(vol, eye, dirs, steps: int):
    """Each ray's number of samples (N,) int64 whose 8 taps are not all zero,
    taken by the march of ``dirs`` before the ray leaves the box or
    saturates: the samples whose work no implementation can skip."""
    strict_float32()
    eye = eye.expand(dirs.shape)
    return torch.cat([_march_block(vol, eye[lo:lo + BLOCK_RAYS], dirs[lo:lo + BLOCK_RAYS], steps,
                                   torch.float32, True)
                      for lo in range(0, dirs.shape[0], BLOCK_RAYS)])
