"""The exact march of a (D, H, W) uint8 volume, plain torch.

:mod:`.march`'s march, with the step taken per axis: the volume fills the
unit box whatever its shape (upstream's normalised texture coordinates), so
dt = min over the axes of 1 / (N_a * |d_a|), (N_x, N_y, N_z) = (W, H, D),
one voxel a step along the axis that crosses voxels fastest; a ray takes up
to the steps of the box's whole diagonal at the largest dim. At a cube every
operation is :mod:`.march`'s, in its order. Rays, taps, the trilinear
sample, the transfer and the sRGB encoding are :mod:`.march`'s own
(``march.rays`` makes the rays).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import strict_float32
from benchmark.reference.march import (BLOCK_RAYS, COMPACT_EVERY, OPACITY_CUT, _taps,
                                       _transfer, _trilinear, linear_to_srgb)


def max_steps(shape) -> int:
    """Steps for a ray across the whole box diagonal of a ``shape`` volume:
    dt is at least 1 / max(shape)."""
    return int(math.ceil(math.sqrt(3.0) * max(shape))) + 1


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
    # (W, H, D) in _taps' axis order: x, y, z
    size = torch.tensor(vol.shape[::-1], dtype=torch.float32, device=dev)
    dt = 1.0 * torch.amin(1.0 / (size * torch.abs(d)), dim=-1)
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
    through the (D, H, W) uint8 volume ``vol``: (N, 4) float32, rgb
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
