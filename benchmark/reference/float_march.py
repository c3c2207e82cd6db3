"""The exact march of a (D, H, W) float32 volume mapped by its data range,
plain torch.

:mod:`.volume_march`'s march (rays from ``march.rays``, the step per axis,
up to the steps of the box's whole diagonal, :func:`volume_march.max_steps`)
over a float32 field: each of a sample's 8 ClampToEdge taps is mapped onto
the transfer's [0, 1] by the volume's data range, ``(v - lo) * inv`` with
``lo`` the smallest voxel and ``inv = 1 / (hi - lo)``, ``hi`` the largest,
in float32 (0 for a constant volume, which then renders blank), and then
takes :mod:`.march`'s seven lerps, transfer, palette, compositing and sRGB
encoding, in their order. The volume is read as it is: float32, never
quantised.

Departures from the source's description: upstream's bonsai demo samples
an R8Unorm texture, which holds [0, 1]; a simulation field such as the
Open SciVis Miranda density (1 to 3) is mapped onto that range by its data
range, the default colour map range of ParaView and VisIt (the Open SciVis
collection gives no transfer of its own). The field fills the unit box
(its voxel spacing is not applied), as :mod:`.volume_march`'s volumes do.

:func:`touched_samples` counts each ray's samples whose mapped taps are not
all zero, and :func:`frame_work` also the distinct voxels those samples
tap, a frame at a time (K1's roofline over a float field,
:mod:`benchmark.roofline.k1_float`). :func:`quantised` is the field cut to
the bytes a uint8 volume holds, ``round(255 * mapped)``: the shortcut that
``correct`` must refuse.
"""

from __future__ import annotations

import torch

from benchmark.reference import strict_float32
from benchmark.reference.march import (BLOCK_RAYS, COMPACT_EVERY, OPACITY_CUT, _transfer,
                                       _trilinear, linear_to_srgb)


def value_range(vol):
    """``(lo, inv)``, float32 0-dim tensors: the smallest voxel and 1 / (the
    largest - lo), 0 where the two are equal."""
    lo, hi = torch.aminmax(vol)
    span = hi - lo
    return lo, torch.where(span > 0, 1.0 / span, torch.zeros_like(span))


def _taps(vol, lo, inv, p):
    """The 8 mapped taps (float32), the 3 fractions and the 8 taps' flat
    voxel indices at ``p``."""
    d, h, w = vol.shape
    size = torch.tensor([w, h, d], dtype=torch.float32, device=vol.device)
    x = p * size - 0.5
    i0 = torch.floor(x)
    f = x - i0
    i0 = i0.to(torch.int64)
    flat = vol.reshape(-1)
    x0, y0, z0 = i0[:, 0], i0[:, 1], i0[:, 2]
    idx = [(((z0 + k).clamp(0, d - 1) * h + (y0 + j).clamp(0, h - 1)) * w
            + (x0 + i).clamp(0, w - 1))
           for k in (0, 1) for j in (0, 1) for i in (0, 1)]
    return [(flat[t] - lo) * inv for t in idx], f, idx


def _march_block(vol, lo, inv, eye, d, steps, dtype, count, mark=None, frame=None):
    """March one block of rays (eye and d (n, 3)); returns the (n, 3) linear
    rgb, or with ``count`` each ray's number of samples whose mapped taps
    are not all zero (n,), setting, where ``mark`` is given, ``mark[frame *
    D * H * W + voxel]`` for every tap of those samples (``frame`` (n,) the
    ray's frame)."""
    n = d.shape[0]
    dev = d.device
    inv_d = 1.0 / d
    ta, tb = (0.0 - eye) * inv_d, (1.0 - eye) * inv_d
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
        taps, f, idx = _taps(vol, lo, inv, lp)
        if count:
            hot = active & (torch.stack(taps).amax(dim=0) > 0.0)
            touched.index_add_(0, live, hot.long())
            if mark is not None:
                base = frame[live[hot]] * vol.numel()
                for t_idx in idx:
                    mark[base + t_idx[hot]] = True
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
    through the (D, H, W) float32 volume ``vol``, mapped by its data range:
    (N, 4) float32, rgb sRGB-encoded when ``srgb``, alpha 1. ``dtype`` is
    the precision of the sample's transfer, palette and compositing (the
    taps' mapping and positions stay float32)."""
    strict_float32()
    lo, inv = value_range(vol)
    out = torch.empty((dirs.shape[0], 4), dtype=torch.float32, device=dirs.device)
    out[:, 3] = 1.0
    eye = eye.expand(dirs.shape)
    for b0 in range(0, dirs.shape[0], BLOCK_RAYS):
        b1 = min(b0 + BLOCK_RAYS, dirs.shape[0])
        rgb = _march_block(vol, lo, inv, eye[b0:b1], dirs[b0:b1], steps, dtype, False)
        out[b0:b1, :3] = linear_to_srgb(rgb) if srgb else rgb
    return out


@torch.no_grad()
def touched_samples(vol, eye, dirs, steps: int):
    """Each ray's number of samples (N,) int64 whose 8 mapped taps are not
    all zero, taken by the march of ``dirs`` before the ray leaves the box
    or saturates: the samples whose work no implementation can skip."""
    strict_float32()
    lo, inv = value_range(vol)
    eye = eye.expand(dirs.shape)
    return torch.cat([_march_block(vol, lo, inv, eye[b0:b0 + BLOCK_RAYS],
                                   dirs[b0:b0 + BLOCK_RAYS], steps, torch.float32, True)
                      for b0 in range(0, dirs.shape[0], BLOCK_RAYS)])


@torch.no_grad()
def frame_work(vol, eye, dirs, steps: int, rays_per_frame: int):
    """Per frame of ``rays_per_frame`` consecutive rays of ``dirs``: the
    samples :func:`touched_samples` counts, and the distinct voxels among
    the 8 taps of those samples. Two lists of ints, a frame each. The
    frames are marched a block of :data:`march.BLOCK_RAYS` rays at a time,
    with a boolean mask over the volume for each frame of the block."""
    strict_float32()
    lo, inv = value_range(vol)
    eye = eye.expand(dirs.shape)
    frames = dirs.shape[0] // rays_per_frame
    group = max(1, min(frames, BLOCK_RAYS // rays_per_frame))
    samples, voxels = [], []
    for g0 in range(0, frames, group):
        g1 = min(g0 + group, frames)
        b0, b1 = g0 * rays_per_frame, g1 * rays_per_frame
        mark = torch.zeros(((g1 - g0) * vol.numel(),), dtype=torch.bool, device=dirs.device)
        frame = torch.arange(b1 - b0, device=dirs.device) // rays_per_frame
        touched = _march_block(vol, lo, inv, eye[b0:b1], dirs[b0:b1], steps, torch.float32,
                               True, mark, frame)
        samples += touched.reshape(g1 - g0, rays_per_frame).sum(dim=1).tolist()
        voxels += [_count(m) for m in mark.reshape(g1 - g0, -1)]
        del mark
    return samples, voxels


def _count(mask, chunk: int = 1 << 26) -> int:
    """The True entries of a flat boolean ``mask``, a chunk at a time: a sum
    over a boolean tensor first casts the whole of it to int64."""
    return sum(int(mask[i:i + chunk].sum()) for i in range(0, mask.numel(), chunk))


@torch.no_grad()
def quantised(vol) -> torch.Tensor:
    """The field cut to uint8, ``round(255 * mapped)``, mapped by its data
    range: read as u8 / 255 (:mod:`.volume_march`), the shortcut of handing
    the field to a uint8 renderer."""
    lo, inv = value_range(vol)
    return torch.round((vol - lo) * inv * 255.0).to(torch.uint8)
