"""K1, K2 and K1b: the exact bonsai raymarch as hand-written CUDA kernels
for Hopper.

The kernels (``vokselis_torch/csrc/march_bonsai.cu``) replace the TPU
kernels ``vokselis_tpu/ops/pallas/march_bonsai.py:_march_kernel`` (K1, the
full frame), ``_march_kernel_ids_into`` (K2, the hybrid's in-place re-march
of selected tiles) and ``_march_kernel_ids`` (K1b, K2's compact-output
mode). They are compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use on a CUDA device, into
``build/vokselis_torch/`` under the checkout, and loaded with ``ctypes``.
Importing this module builds nothing.

:func:`render_bonsai_frame_cuda`, :func:`render_bonsai_rays_cuda`,
:func:`render_bonsai_tiles_into` and :func:`render_bonsai_tiles` launch
their kernel for CUDA tensors and use their plain versions (built on
:func:`vokselis_torch.ops.reference.render_bonsai_rays`) only for tensors
that lie on the CPU. A failed build or launch raises; there is no fallback.
The frame wrapper takes a camera uniform, and K1 makes each pixel's ray
from it; the rays wrapper takes ray planes that the caller made.

``LAUNCHES_FRAME``, ``LAUNCHES``, ``LAUNCHES_TILES`` and
``LAUNCHES_TILES_COMPACT`` count the kernels' launches (one per successful
launch, and nowhere else), so that a run can show its frames went through
the kernels.

The kernels skip empty space exactly: :func:`occupancy_table` holds each
8^3 cell's largest voxel, and a step whose lower taps lie in a cell with no
voxel above ``OCC_CUT`` adds nothing (its transfer is exactly 0), so it
only advances. The wrappers look the table up in a cache of their own,
keyed on the volume tensor: it is built at a volume's first launch and
again only after the volume's data changed.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from vokselis_torch.core import geometry
from vokselis_torch.core.compiled import CompiledFrame
from vokselis_torch.ops import reference
from vokselis_torch.ops.cuda.build import CSRC, NVCC_FLAGS, check_launch, load_library
from vokselis_torch.ops.reference import MAX_STEPS_BONSAI
from vokselis_torch.utils.grid import TILE, cdiv
from vokselis_torch.utils.spans import count

SOURCE = CSRC / "march_bonsai.cu"
# empty-space skipping: cells of OCC_CELL^3 voxels; a sample whose every tap
# is <= OCC_CUT is <= 25/255 < 0.1, where the transfer
# smoothstep(0.10, 1.2, min(0.9, s)) is 0 (the TPU kernel's OCC_CUT,
# vokselis_tpu/ops/pallas/march_bonsai.py:107-115)
OCC_CELL = 8
OCC_CUT = 25

# K1's views a launch: the grid's z extent
MAX_VIEWS = 65535

LAUNCHES_FRAME = 0
LAUNCHES = 0
LAUNCHES_TILES = 0
LAUNCHES_TILES_COMPACT = 0
# compiler output of this process's build (ptxas register / spill report);
# empty when the library was already built
BUILD_LOG = ""
_lib = None


def build() -> ctypes.CDLL:
    """Compile (once per source and flag set) and load the kernel library."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    lib, BUILD_LOG = load_library(SOURCE, NVCC_FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vk_march_bonsai.argtypes = [p, p, i, p, p, p, p, i, i, i, i, i, p, i, p]
    lib.vk_march_bonsai.restype = i
    lib.vk_march_bonsai_frame.argtypes = [p, p, i, p, p, i, i, i, i, i, p, i, p]
    lib.vk_march_bonsai_frame.restype = i
    lib.vk_march_tiles.argtypes = [p, p, i, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p, i, p]
    lib.vk_march_tiles.restype = i
    _lib = lib
    return lib


def _cell_max(x, axis: int):
    """Max over the OCC_CELL + 1 voxels 8c .. min(8c + 8, D - 1) of each cell
    c along ``axis``: each cell's own block, and for every cell but the
    last (which already ends at D - 1) the first voxel of the next."""
    d = x.shape[axis]
    cells = -(-d // OCC_CELL)
    full = OCC_CELL * cells
    if full > d:  # replicate the last voxel so that the last block is whole
        shape = list(x.shape)
        shape[axis] = full - d
        x = torch.cat([x, x.narrow(axis, d - 1, 1).expand(shape)], dim=axis)
    blocks = x.reshape(x.shape[:axis] + (cells, OCC_CELL) + x.shape[axis + 1:])
    blocks = blocks.amax(dim=axis + 1)
    step = [slice(None)] * x.ndim
    step[axis] = slice(OCC_CELL, full, OCC_CELL)
    head = torch.maximum(blocks.narrow(axis, 0, cells - 1), x[tuple(step)])
    return torch.cat([head, blocks.narrow(axis, cells - 1, 1)], dim=axis)


def occupancy_table(vol) -> torch.Tensor:
    """The march's occupancy table of the (D, D, D) uint8 volume ``vol``:
    the largest voxel of each OCC_CELL^3 cell with one voxel of overlap
    toward +, cell c covering voxels 8c .. min(8c + 8, D - 1) on each axis,
    so that both taps of every trilinear pair (x0, x0 + 1) whose lower tap
    lies in the cell lie inside it. (C, C, C) uint8, C = ceil(D / 8),
    [z, y, x], on the volume's device: 32 KB at 256^3, 256 KB at 512^3.
    Three separable max passes of plain torch, x first (the contiguous
    axis, which shrinks the volume 8x for the other two)."""
    occ = vol
    for axis in (2, 1, 0):
        occ = _cell_max(occ, axis)
    return occ


# id(volume tensor) -> (weak reference to it, its data_ptr, its version
# counter, its occupancy table); an entry leaves with its volume
_occ_cache: dict = {}


def volume_occupancy(vol) -> torch.Tensor:
    """:func:`occupancy_table` of ``vol``, kept while ``vol`` lives: built
    at the first call for this tensor and again only when its storage or
    its version counter (which every in-place write, through any view,
    advances) has changed. An inference-mode tensor has no version
    counter: its table is built at every call."""
    if vol.is_inference():
        return occupancy_table(vol)
    key = id(vol)
    hit = _occ_cache.get(key)
    if hit is not None and hit[0]() is vol and hit[1:3] == (vol.data_ptr(), vol._version):
        return hit[3]
    occ = occupancy_table(vol)
    ref = weakref.ref(vol, lambda _, key=key: _occ_cache.pop(key, None))
    _occ_cache[key] = (ref, vol.data_ptr(), vol._version, occ)
    return occ


def _check_tensors(vol, tensors):
    """``vol`` and the named ``tensors``: tensors, contiguous, on vol's
    device (the CPU or a card); vol a cubic uint8 volume."""
    for name, t in {"vol": vol, **tensors}.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.device != vol.device:
            raise ValueError(f"{name} is on {t.device}, vol on {vol.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if vol.device.type not in ("cpu", "cuda"):
        raise ValueError(f"march_bonsai runs on cpu or cuda, not {vol.device}")
    if vol.dtype != torch.uint8:
        raise TypeError(f"vol must be uint8, got {vol.dtype}")
    if vol.ndim != 3 or len(set(vol.shape)) != 1:
        raise ValueError(f"vol must be a cubic (D, D, D) volume, got {tuple(vol.shape)}")


def _check_max_steps(max_steps):
    if not isinstance(max_steps, int) or max_steps < 0:
        raise ValueError(f"max_steps must be a non-negative int, got {max_steps!r}")


def _check_inputs(vol, eye, dx, dy, dz, max_steps):
    _check_tensors(vol, {"eye": eye, "dx": dx, "dy": dy, "dz": dz})
    if eye.dtype != torch.float32 or eye.ndim not in (1, 2) or eye.shape[-1] != 3:
        raise TypeError("eye must be a (3,) or (V, 3) float32 tensor, got "
                        f"{eye.dtype} {tuple(eye.shape)}")
    views = tuple(eye.shape[:-1])
    if views and not 1 <= views[0] <= MAX_VIEWS:
        raise ValueError(f"a batch holds 1 to {MAX_VIEWS} views, got {views[0]}")
    for name, t in (("dx", dx), ("dy", dy), ("dz", dz)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.shape != dx.shape or tuple(t.shape[:-2]) != views or t.ndim != len(views) + 2:
            raise ValueError(f"{name} must be (H, W) for a (3,) eye, (V, H, W) for a (V, 3) "
                             f"one, like dx, got {tuple(t.shape)} for eye {tuple(eye.shape)}")
    _check_max_steps(max_steps)


def _check_frame(vol, camera_uniform, width, height, max_steps):
    """The frame wrapper's inputs; returns the uniform's ``(inv_proj,
    view_position)``: (4, 4) and (4,), or (V, 4, 4) and (V, 4)."""
    inv, pos = camera_uniform.inv_proj, camera_uniform.view_position
    _check_tensors(vol, {"inv_proj": inv, "view_position": pos})
    for name, t in (("inv_proj", inv), ("view_position", pos)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if inv.ndim not in (2, 3) or tuple(inv.shape[-2:]) != (4, 4):
        raise ValueError(f"inv_proj must be (4, 4) or (V, 4, 4), got {tuple(inv.shape)}")
    views = tuple(inv.shape[:-2])
    if tuple(pos.shape) != views + (4,):
        raise ValueError(f"view_position must be {views + (4,)} for inv_proj "
                         f"{tuple(inv.shape)}, got {tuple(pos.shape)}")
    if views and not 1 <= views[0] <= MAX_VIEWS:
        raise ValueError(f"a batch holds 1 to {MAX_VIEWS} views, got {views[0]}")
    for name, n in (("width", width), ("height", height)):
        if not isinstance(n, (int, np.integer)) or n < 1:
            raise ValueError(f"{name} must be a positive int, got {n!r}")
    _check_max_steps(max_steps)
    return inv, pos


@torch.no_grad()
def render_bonsai_frame_cuda(vol, camera_uniform, width: int, height: int,
                             max_steps: int = MAX_STEPS_BONSAI, srgb: bool = True):
    """The exact frame of ``camera_uniform`` in one K1 launch whose threads
    make their own fragment rays: each pixel's ray is
    :func:`geometry.rays_fragment_soa`'s, bit for bit, made from the view's
    ``inv_proj`` and ``view_position`` without any ray plane in memory.

    ``vol``: (D, D, D) uint8 [z, y, x]; ``camera_uniform``: one view
    (``inv_proj`` (4, 4), ``view_position`` (4,)) or a batch of V views
    ((V, 4, 4), (V, 4)), float32, contiguous, on the volume's device.
    Returns the (height, width, 4), or (V, height, width, 4), float32 image
    as :func:`render_bonsai_rays_cuda` returns it for those rays. CPU
    tensors take the plain frame: :func:`geometry.rays_fragment_soa`, then
    :func:`render_bonsai_rays_cuda`'s plain march."""
    global LAUNCHES_FRAME
    inv, pos = _check_frame(vol, camera_uniform, width, height, max_steps)
    if vol.device.type == "cpu":
        eye, dxyz = geometry.rays_fragment_soa(camera_uniform, width, height)
        return render_bonsai_rays_cuda(vol, eye, dxyz, max_steps=max_steps, srgb=srgb)
    occ = volume_occupancy(vol)
    lib = build()
    views = tuple(inv.shape[:-2])
    out = torch.empty(views + (height, width, 4), dtype=torch.float32, device=vol.device)
    err = lib.vk_march_bonsai_frame(
        vol.data_ptr(), occ.data_ptr(), vol.shape[0], inv.data_ptr(), pos.data_ptr(),
        views[0] if views else 1, int(height), int(width), max_steps, int(srgb), out.data_ptr(),
        vol.device.index, torch.cuda.current_stream(vol.device).cuda_stream,
    )
    check_launch(lib, err, "march_bonsai_frame")
    LAUNCHES_FRAME += 1
    return out


@torch.no_grad()
def render_bonsai_rays_cuda(vol, eye, dxyz, max_steps: int = MAX_STEPS_BONSAI,
                            srgb: bool = True):
    """March SoA rays through a uint8 volume — the counterpart of
    ``render_bonsai_rays_pallas``, and of its ``vmap`` over a batch of views.

    ``vol``: (D, D, D) uint8 [z, y, x]; ``eye``: (3,) float32; ``dxyz``:
    (dx, dy, dz), each (H, W) float32 and normalized; or a batch of V views,
    ``eye`` (V, 3) and each plane (V, H, W); all contiguous and on one
    device. Returns the (H, W, 4), or (V, H, W, 4), float32 image (sRGB-encoded
    rgb when ``srgb``, alpha 1). CUDA tensors launch the kernel once for all
    views, skipping empty space over :func:`volume_occupancy`; CPU tensors
    take :func:`render_bonsai_rays_plain`.
    """
    global LAUNCHES
    dx, dy, dz = dxyz
    _check_inputs(vol, eye, dx, dy, dz, max_steps)
    if vol.device.type == "cpu":
        return render_bonsai_rays_plain(vol, eye, dxyz, max_steps=max_steps, srgb=srgb)
    occ = volume_occupancy(vol)
    lib = build()
    n_views = eye.shape[0] if eye.ndim == 2 else 1
    out = torch.empty(tuple(dx.shape) + (4,), dtype=torch.float32, device=vol.device)
    err = lib.vk_march_bonsai(
        vol.data_ptr(), occ.data_ptr(), vol.shape[0], dx.data_ptr(), dy.data_ptr(),
        dz.data_ptr(), eye.data_ptr(), n_views, dx.shape[-2], dx.shape[-1], max_steps,
        int(srgb), out.data_ptr(), vol.device.index,
        torch.cuda.current_stream(vol.device).cuda_stream,
    )
    check_launch(lib, err, "march_bonsai")
    LAUNCHES += 1
    return out


@torch.no_grad()
def render_bonsai_rays_plain(vol, eye, dxyz, max_steps: int = MAX_STEPS_BONSAI,
                             srgb: bool = True):
    """Plain torch version of K1, for the inputs of
    :func:`render_bonsai_rays_cuda`: :func:`reference.render_bonsai_rays`,
    of each view in turn for a batch."""
    dx, dy, dz = dxyz
    _check_inputs(vol, eye, dx, dy, dz, max_steps)
    dirs = torch.stack([dx, dy, dz], dim=-1)
    if eye.ndim == 1:
        return reference.render_bonsai_rays(vol, eye, dirs, max_steps=max_steps, srgb=srgb)
    return torch.stack([reference.render_bonsai_rays(vol, e, d, max_steps=max_steps, srgb=srgb)
                        for e, d in zip(eye, dirs)])


def tile_rays_compact(camera_uniform, unit_ids, width: int, height: int,
                      tiles_per_unit: int = 1):
    """Fragment-path rays of the listed units of 32x32 tiles only (the
    counterpart of ``_tile_rays_compact``, march_bonsai.py:1037): unit p
    covers tiles p * tpu .. p * tpu + tpu - 1, raster-consecutive in the tile
    grid padded to whole tiles (``tiles_per_unit=2``: a horizontal pair,
    which needs an even tile row). The rays are
    :func:`geometry.rays_fragment_soa`'s operations on the selected pixels'
    centres, so each is bitwise the full frame's ray at that pixel.

    Returns ``(eye, (dx, dy, dz), (iy, ix))``: the (n_sel * tpu * 32, 32)
    f32 direction planes, pixel (unit i, tile t, row r, col c) at row
    (i * tpu + t) * 32 + r, and the int64 frame coordinates of each of
    those pixels (outside the frame for parked ids, >= the unit count, and
    for the padding of partial tiles)."""
    tpu = tiles_per_unit
    nx = cdiv(width, TILE)
    dev = unit_ids.device
    tile = unit_ids.long()[:, None] * tpu + torch.arange(tpu, device=dev)[None, :]
    rows = torch.arange(TILE, device=dev)
    iy = ((tile // nx) * TILE)[:, :, None, None] + rows[:, None]
    ix = ((tile % nx) * TILE)[:, :, None, None] + rows[None, :]
    shape = (unit_ids.shape[0] * tpu * TILE, TILE)
    iy, ix = iy.expand(-1, -1, TILE, TILE).reshape(shape), ix.expand(
        -1, -1, TILE, TILE).reshape(shape)
    # geometry.rays_fragment_soa on these pixel centres, op for op
    ndc_x = 2.0 * (ix.float() + 0.5) / width - 1.0
    ndc_y = 1.0 - 2.0 * (iy.float() + 0.5) / height
    inv = camera_uniform.inv_proj
    nx4, ny4, nz4, nw4 = geometry.mat4_apply(inv, ndc_x, ndc_y, 0.0)
    fx, fy, fz, fw = geometry.mat4_apply(inv, ndc_x, ndc_y, 1.0)
    dx = fx / fw - nx4 / nw4
    dy = fy / fw - ny4 / nw4
    dz = fz / fw - nz4 / nw4
    inv_len = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    return (camera_uniform.view_position[:3],
            (dx * inv_len, dy * inv_len, dz * inv_len), (iy, ix))


def _check_tiles(vol, unit_ids, width, height, tiles_per_unit):
    if not isinstance(unit_ids, torch.Tensor):
        raise TypeError(f"unit_ids must be a torch.Tensor, got {type(unit_ids)}")
    if unit_ids.device != vol.device:
        raise ValueError(f"unit_ids is on {unit_ids.device}, vol on {vol.device}")
    if unit_ids.dtype != torch.int32 or unit_ids.ndim != 1:
        raise TypeError(f"unit_ids must be (n_sel,) int32, got {unit_ids.dtype} "
                        f"{tuple(unit_ids.shape)}")
    if tiles_per_unit not in (1, 2):
        raise ValueError(f"tiles_per_unit must be 1 or 2, got {tiles_per_unit}")
    if tiles_per_unit == 2 and cdiv(width, TILE) % 2:
        raise ValueError(f"tile pairs need an even tile row, got width {width}")
    if width < 1 or height < 1:
        raise ValueError(f"bad frame {width}x{height}")


def _check_base(base_rgb, device, width, height):
    if not isinstance(base_rgb, torch.Tensor):
        raise TypeError(f"base_rgb must be a torch.Tensor, got {type(base_rgb)}")
    if base_rgb.device != device or base_rgb.dtype != torch.float32:
        raise TypeError(f"base_rgb must be float32 on {device}, got {base_rgb.dtype} on "
                        f"{base_rgb.device}")
    if tuple(base_rgb.shape) != (3, height, width) or not base_rgb.is_contiguous():
        raise ValueError(f"base_rgb must be contiguous (3, {height}, {width}), got "
                         f"{tuple(base_rgb.shape)}")


def _n_units(width, height, tiles_per_unit):
    return cdiv(width, TILE) * cdiv(height, TILE) // tiles_per_unit


def _launch_tiles(vol, rays, unit_ids, width, height, tpu, max_steps, fast, out,
                  compact):
    lib = build()
    eye, (dx, dy, dz), _ = rays
    _check_inputs(vol, eye, dx, dy, dz, max_steps)
    occ = volume_occupancy(vol)
    err = lib.vk_march_tiles(
        vol.data_ptr(), occ.data_ptr(), vol.shape[0], dx.data_ptr(), dy.data_ptr(), dz.data_ptr(),
        eye.data_ptr(), unit_ids.data_ptr(), unit_ids.shape[0],
        _n_units(width, height, tpu), tpu, cdiv(width, TILE), height, width, max_steps,
        int(fast), int(compact), out.data_ptr(), vol.device.index,
        torch.cuda.current_stream(vol.device).cuda_stream,
    )
    check_launch(lib, err, "march_tiles")


def _march_compact_plain(vol, rays, unit_ids, width, height, tpu, max_steps, fast):
    """The plain march of every compact ray (:func:`reference.render_bonsai_rays`,
    linear rgb) and the mask of pixels that belong to the frame."""
    eye, dxyz, (iy, ix) = rays
    img = reference.render_bonsai_rays(vol, eye, torch.stack(dxyz, dim=-1),
                                       max_steps=max_steps, srgb=False,
                                       fast_transfer=fast)
    listed = (unit_ids >= 0) & (unit_ids < _n_units(width, height, tpu))
    inside = (listed.repeat_interleave(tpu * TILE)[:, None] & (iy < height) & (ix < width))
    return img[..., :3].permute(2, 0, 1), inside


@torch.no_grad()
def render_bonsai_tiles_into(vol, base_rgb, camera_uniform, unit_ids, width: int,
                             height: int, tiles_per_unit: int = 1,
                             fast_transfer: bool = False,
                             max_steps: int = MAX_STEPS_BONSAI):
    """K2: march the listed units of 32x32 tiles exactly and write their
    linear rgb IN PLACE into ``base_rgb``, the (3, height, width) f32 planes
    of a frame (the hybrid's fast frame); every other pixel keeps its value
    bit for bit. ``unit_ids``: (n_sel,) int32 on the volume's device, unit
    p covering tiles p * tpu .. p * tpu + tpu - 1 of the padded tile grid;
    an id outside [0, unit count) is parked and changes nothing. The ids
    stay on the device: the launch has n_sel blocks of units whatever they
    hold. ``fast_transfer`` takes the palette's polynomial form (the
    hybrid's setting). Returns ``base_rgb``. CUDA tensors launch the kernel;
    CPU tensors take :func:`render_bonsai_tiles_into_plain`."""
    global LAUNCHES_TILES
    _check_tiles(vol, unit_ids, width, height, tiles_per_unit)
    _check_base(base_rgb, vol.device, width, height)
    if vol.device.type == "cpu":
        return render_bonsai_tiles_into_plain(vol, base_rgb, camera_uniform, unit_ids, width,
                                              height, tiles_per_unit, fast_transfer,
                                              max_steps)
    rays = tile_rays_compact(camera_uniform, unit_ids, width, height, tiles_per_unit)
    _launch_tiles(vol, rays, unit_ids, width, height, tiles_per_unit, max_steps,
                  fast_transfer, base_rgb, compact=False)
    LAUNCHES_TILES += 1
    return base_rgb


@torch.no_grad()
def render_bonsai_tiles_into_plain(vol, base_rgb, camera_uniform, unit_ids, width: int,
                                   height: int, tiles_per_unit: int = 1,
                                   fast_transfer: bool = False,
                                   max_steps: int = MAX_STEPS_BONSAI):
    """Plain torch version of K2: :func:`reference.render_bonsai_rays` over
    the compact rays, scattered into ``base_rgb`` at the listed units'
    pixels inside the frame. Returns ``base_rgb``."""
    _check_tiles(vol, unit_ids, width, height, tiles_per_unit)
    _check_base(base_rgb, vol.device, width, height)
    rays = tile_rays_compact(camera_uniform, unit_ids, width, height, tiles_per_unit)
    planes, inside = _march_compact_plain(vol, rays, unit_ids, width, height,
                                          tiles_per_unit, max_steps, fast_transfer)
    iy, ix = rays[2]
    for c in range(3):
        base_rgb[c].index_put_((iy[inside], ix[inside]), planes[c][inside])
    return base_rgb


@torch.no_grad()
def render_bonsai_tiles(vol, camera_uniform, unit_ids, width: int, height: int,
                        tiles_per_unit: int = 1, fast_transfer: bool = False,
                        max_steps: int = MAX_STEPS_BONSAI):
    """K1b, K2's compact-output mode: the exact linear rgb of the listed
    units' pixels as (3, n_sel * tpu * 32, 32) f32 planes laid out as
    :func:`tile_rays_compact`'s rays (0 for parked ids and for pixels
    outside the frame). CUDA tensors launch the kernel; CPU tensors take
    :func:`render_bonsai_tiles_plain`."""
    global LAUNCHES_TILES_COMPACT
    _check_tiles(vol, unit_ids, width, height, tiles_per_unit)
    if vol.device.type == "cpu":
        return render_bonsai_tiles_plain(vol, camera_uniform, unit_ids, width, height,
                                         tiles_per_unit, fast_transfer, max_steps)
    rays = tile_rays_compact(camera_uniform, unit_ids, width, height, tiles_per_unit)
    out = torch.empty((3,) + tuple(rays[1][0].shape), dtype=torch.float32,
                      device=vol.device)
    _launch_tiles(vol, rays, unit_ids, width, height, tiles_per_unit, max_steps,
                  fast_transfer, out, compact=True)
    LAUNCHES_TILES_COMPACT += 1
    return out


@torch.no_grad()
def render_bonsai_tiles_plain(vol, camera_uniform, unit_ids, width: int, height: int,
                              tiles_per_unit: int = 1, fast_transfer: bool = False,
                              max_steps: int = MAX_STEPS_BONSAI):
    """Plain torch version of K1b."""
    _check_tiles(vol, unit_ids, width, height, tiles_per_unit)
    rays = tile_rays_compact(camera_uniform, unit_ids, width, height, tiles_per_unit)
    planes, inside = _march_compact_plain(vol, rays, unit_ids, width, height,
                                          tiles_per_unit, max_steps, fast_transfer)
    return torch.where(inside, planes, 0.0)


def volume_tensor(vol_u8, device) -> torch.Tensor:
    """The (D, D, D) uint8 volume as one contiguous tensor on ``device``."""
    if isinstance(vol_u8, torch.Tensor):
        vol = vol_u8
    else:
        vol = torch.from_numpy(np.ascontiguousarray(vol_u8))
    if vol.dtype != torch.uint8 or vol.ndim != 3 or len(set(vol.shape)) != 1:
        raise ValueError("the bonsai kernel wants a cubic (D, D, D) uint8 volume, "
                         f"got {vol.dtype} {tuple(vol.shape)}")
    return vol.to(device=torch.device(device)).contiguous()


def render_frame(vol, camera_uniform, width: int, height: int,
                 max_steps: int = MAX_STEPS_BONSAI, srgb: bool = True):
    """The exact frame, eagerly (the JAX package's ``_render_bonsai_pallas``
    un-jitted): :func:`render_bonsai_frame_cuda`, on a card one K1 launch
    for every view of the uniform, its threads making their own rays.
    :class:`BonsaiRenderer` and :func:`build_renderer` replay it from a CUDA
    graph; this is the frame they are held to."""
    return render_bonsai_frame_cuda(vol, camera_uniform, width, height, max_steps, srgb)


def _exact_frame(vol, compiled, camera_uniform, width, height, max_steps, srgb):
    """:func:`render_frame` of ``vol`` through ``compiled``, one graph per
    ``(width, height, max_steps, srgb)`` and uniform shape. On a card each
    call adds the rays K1 makes itself, views x width x height, to the
    counter ``k1.inline_rays`` of an active ``spans.recording()``."""
    def fn(u):
        return render_frame(vol, u, width, height, max_steps, srgb)

    if vol.is_cuda:
        views = len(camera_uniform) if camera_uniform.batched else 1
        count("k1.inline_rays", views * width * height)
    return compiled(("exact", width, height, max_steps, bool(srgb)), fn, (camera_uniform,),
                    reads=vol)


class BonsaiRenderer:
    """Holds the volume on its device, and on a card builds its occupancy
    table; call to render (the analog of the reference's VolumeTexture +
    RaycastPipeline pair, examples/bonsai/raycast.rs:12-141). On a card a
    call replays the frame's CUDA graph (``compiled``, one per width,
    height, max_steps and srgb; see :mod:`vokselis_torch.core.compiled`);
    :func:`render_frame` is the eager frame. ``compiled`` may be shared
    with another renderer of the same volume (the hybrid's), whose graphs
    then share its memory pool."""

    def __init__(self, vol_u8, device, compiled: CompiledFrame | None = None):
        self.device = torch.device(device)
        self.vol = volume_tensor(vol_u8, self.device)
        if self.vol.is_cuda:
            volume_occupancy(self.vol)
        self.dims = self.vol.shape[0]
        self.compiled = CompiledFrame("BonsaiRenderer") if compiled is None else compiled

    def __call__(
        self,
        camera_uniform,
        width: int = 1280,
        height: int = 720,
        max_steps: int = MAX_STEPS_BONSAI,
        srgb: bool = True,
    ):
        """Render one frame, or (V, H, W, 4) frames of a batched uniform's
        views in one launch."""
        return _exact_frame(self.vol, self.compiled, camera_uniform, width, height,
                            max_steps, srgb)


def build_renderer(vol_u8, device):
    """Functional API: returns (render_fn, pack) where
    ``render_fn(pack, camera_uniform, width, height, max_steps=, srgb=)``
    renders a frame and ``pack`` is the volume tensor on ``device``. A
    batched ``camera_uniform`` renders its V views as (V, H, W, 4) with one
    ray pass and one K1 launch: the counterpart of the JAX package's
    ``vmap`` of its render over a view batch. On a card render_fn replays
    one CUDA graph per static key, as :class:`BonsaiRenderer` does; another
    ``pack`` than the last one captures again."""
    pack = volume_tensor(vol_u8, device)
    compiled = CompiledFrame("build_renderer")

    def render(pk, camera_uniform, width, height,
               max_steps=MAX_STEPS_BONSAI, srgb=True):
        return _exact_frame(pk, compiled, camera_uniform, width, height, max_steps, srgb)

    return render, pack
