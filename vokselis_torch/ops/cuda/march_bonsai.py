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

:func:`render_bonsai_rays_cuda`, :func:`render_bonsai_tiles_into` and
:func:`render_bonsai_tiles` launch their kernel for CUDA tensors and use
their plain versions (built on
:func:`vokselis_torch.ops.reference.render_bonsai_rays`) only for tensors
that lie on the CPU. A failed build or launch raises; there is no fallback.

``LAUNCHES``, ``LAUNCHES_TILES`` and ``LAUNCHES_TILES_COMPACT`` count the
kernels' launches (one per successful launch, and nowhere else), so that a
run can show its frames went through the kernels.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vokselis_torch.core import geometry
from vokselis_torch.ops import reference
from vokselis_torch.ops.cuda.build import CSRC, NVCC_FLAGS, check_launch, load_library
from vokselis_torch.ops.reference import MAX_STEPS_BONSAI
from vokselis_torch.utils.grid import TILE, cdiv

SOURCE = CSRC / "march_bonsai.cu"

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
    lib.vk_march_bonsai.argtypes = [p, i, p, p, p, p, i, i, i, i, p, i, p]
    lib.vk_march_bonsai.restype = i
    lib.vk_march_tiles.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p, i, p]
    lib.vk_march_tiles.restype = i
    _lib = lib
    return lib


def _check_inputs(vol, eye, dx, dy, dz, max_steps):
    tensors = {"vol": vol, "eye": eye, "dx": dx, "dy": dy, "dz": dz}
    for name, t in tensors.items():
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
    if eye.dtype != torch.float32 or tuple(eye.shape) != (3,):
        raise TypeError(f"eye must be a (3,) float32 tensor, got {eye.dtype} {tuple(eye.shape)}")
    for name, t in (("dx", dx), ("dy", dy), ("dz", dz)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.ndim != 2 or t.shape != dx.shape:
            raise ValueError(f"{name} must be (H, W) like dx, got {tuple(t.shape)}")
    if not isinstance(max_steps, int) or max_steps < 0:
        raise ValueError(f"max_steps must be a non-negative int, got {max_steps!r}")


@torch.no_grad()
def render_bonsai_rays_cuda(vol, eye, dxyz, max_steps: int = MAX_STEPS_BONSAI,
                            srgb: bool = True):
    """March SoA rays through a uint8 volume — the counterpart of
    ``render_bonsai_rays_pallas``.

    ``vol``: (D, D, D) uint8 [z, y, x]; ``eye``: (3,) float32; ``dxyz``:
    (dx, dy, dz), each (H, W) float32 and normalized; all contiguous and on
    one device. Returns the (H, W, 4) float32 image (sRGB-encoded rgb when
    ``srgb``, alpha 1). CUDA tensors launch the kernel; CPU tensors take the
    plain version.
    """
    global LAUNCHES
    dx, dy, dz = dxyz
    _check_inputs(vol, eye, dx, dy, dz, max_steps)
    if vol.device.type == "cpu":
        return reference.render_bonsai_rays(
            vol, eye, torch.stack([dx, dy, dz], dim=-1),
            max_steps=max_steps, srgb=srgb,
        )
    lib = build()
    height, width = dx.shape
    out = torch.empty((height, width, 4), dtype=torch.float32, device=vol.device)
    err = lib.vk_march_bonsai(
        vol.data_ptr(), vol.shape[0], dx.data_ptr(), dy.data_ptr(),
        dz.data_ptr(), eye.data_ptr(), height, width, max_steps, int(srgb),
        out.data_ptr(), vol.device.index,
        torch.cuda.current_stream(vol.device).cuda_stream,
    )
    check_launch(lib, err, "march_bonsai")
    LAUNCHES += 1
    return out


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
    err = lib.vk_march_tiles(
        vol.data_ptr(), vol.shape[0], dx.data_ptr(), dy.data_ptr(), dz.data_ptr(),
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


class BonsaiRenderer:
    """Holds the volume on its device; call to render (the analog of the
    reference's VolumeTexture + RaycastPipeline pair,
    examples/bonsai/raycast.rs:12-141)."""

    def __init__(self, vol_u8, device):
        self.device = torch.device(device)
        self.vol = volume_tensor(vol_u8, self.device)
        self.dims = self.vol.shape[0]
        # a windowless kernel cannot overflow; kept for API parity
        self.last_overflow = 0

    def __call__(
        self,
        camera_uniform,
        width: int = 1280,
        height: int = 720,
        max_steps: int = MAX_STEPS_BONSAI,
        srgb: bool = True,
        strict: bool = False,
    ):
        """Render one frame. ``strict`` is accepted for API parity and does
        nothing: every pixel of this kernel is exact, there is no window
        overflow to re-render."""
        eye, dxyz = geometry.rays_fragment_soa(camera_uniform, width, height)
        return render_bonsai_rays_cuda(self.vol, eye, dxyz,
                                       max_steps=max_steps, srgb=srgb)


def build_renderer(vol_u8, device, with_overflow: bool = False):
    """Functional API: returns (render_fn, pack) where
    ``render_fn(pack, camera_uniform, width, height, max_steps=, srgb=)``
    renders a frame and ``pack`` is the volume tensor on ``device``.
    ``with_overflow=True`` makes render_fn return ``(img, 0)``: the kernel
    has no window that could overflow."""
    pack = volume_tensor(vol_u8, device)

    def render(pk, camera_uniform, width, height,
               max_steps=MAX_STEPS_BONSAI, srgb=True):
        eye, dxyz = geometry.rays_fragment_soa(camera_uniform, width, height)
        img = render_bonsai_rays_cuda(pk, eye, dxyz, max_steps=max_steps,
                                      srgb=srgb)
        return (img, 0) if with_overflow else img

    return render, pack
