"""K6 and K5: the shear-warp renderers' bilinear homography warps as
hand-written CUDA kernels for Hopper.

The kernels (``vokselis_torch/csrc/warp2d.cu``) replace the TPU kernels
``vokselis_tpu/ops/pallas/warp2d.py:_warp_kernel_mxu`` (K6, the plain warp
of ``renderer="fast"``) and ``_warp_kernel_mxu_stats`` (K5, the hybrid
renderer's warp with its per-tile score statistics), and the kernels that
existed only for their VMEM windows: ``_rewarp_kernel`` and
``_rewarp_kernel_stats`` (the overflow re-warps) and
``_warp_kernel``/``_warp_kernel_impl`` (the row scan for large
intermediates). The kernels read the intermediate directly, so one kernel
serves every intermediate size and no footprint overflows: a block per
32x32 screen tile, each thread 4 (K6) or 8 (K5) consecutive pixels of a
tile row, with every tap in flight before any is used. The library is built
with ``nvcc`` at first use on a CUDA device; importing builds nothing.

:func:`warp_bilinear` and :func:`warp_stats` launch their kernel for CUDA
tensors and take :func:`warp_plain` and :func:`warp_stats_plain` only for
tensors on the CPU. A failed build or launch raises; there is no fallback.
``LAUNCHES_WARP`` and ``LAUNCHES_STATS`` count successful launches and
nothing else.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vokselis_torch.ops.cuda.build import CSRC, NVCC_FLAGS, check_launch, load_library
from vokselis_torch.utils.grid import TILE, cdiv

SOURCE = CSRC / "warp2d.cu"
MAX_CHANNELS = 4

# per-tile stats columns (vokselis_tpu/ops/pallas/warp2d.py:454-458)
STAT_CURV = 0  # sum(warped curvature x sRGB slope) over ok pixels
STAT_EDGE = 1  # sum of within-tile |grad| of the sRGB luminance
STAT_OVF = 2  # ok pixels whose warp window overflowed: 0, there is no window
STAT_EXT = 3  # box-hit pixels outside the warp extent (hit and not ok)
STAT_PEAK = 4  # max sRGB luminance in the tile
N_STATS = 5

LAUNCHES_WARP = 0
LAUNCHES_STATS = 0
# compiler output of this process's build (ptxas register / spill report)
BUILD_LOG = ""
_lib = None


def build() -> ctypes.CDLL:
    """Compile (once per source and flag set) and load the kernel library."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    lib, BUILD_LOG = load_library(SOURCE, NVCC_FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vk_warp_bilinear.argtypes = [p, i, i, i, p, p, p, i, i, p, i, p]
    lib.vk_warp_bilinear.restype = i
    lib.vk_warp_stats.argtypes = [p, i, i, p, p, p, p, i, i, p, p, i, p]
    lib.vk_warp_stats.restype = i
    _lib = lib
    return lib


def _check_inputs(chans, av, bu, hit):
    if not isinstance(chans, torch.Tensor):
        raise TypeError(f"chans must be a torch.Tensor, got {type(chans)}")
    dev = chans.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"warp2d runs on cpu or cuda, not {dev}")
    for name, t, dtype in (("chans", chans, torch.float32), ("av", av, torch.float32),
                           ("bu", bu, torch.float32), ("hit", hit, torch.bool)):
        if t is None and name == "hit":
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, chans on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if chans.ndim != 3 or not 1 <= chans.shape[0] <= MAX_CHANNELS:
        raise ValueError(f"chans must be (C <= {MAX_CHANNELS}, Iv, Iu), got "
                         f"{tuple(chans.shape)}")
    if av.ndim != 2 or bu.shape != av.shape or (hit is not None and hit.shape != av.shape):
        raise ValueError("av, bu (and hit) must be (H, W) planes of one shape")


@torch.no_grad()
def warp_bilinear(chans, av, bu, hit=None, with_overflow: bool = False):
    """K6: bilinear lookup of ``chans`` (C <= 4, Iv, Iu) f32 at the (H, W)
    f32 coordinates (``av`` rows, ``bu`` columns), clamped to the edge.
    ``hit`` (H, W) bool zeroes the pixels that do not participate; their
    coordinates are never read. Coordinates must be finite where ``hit``.

    Returns the (C, H, W) f32 planes, and with ``with_overflow`` also an
    (H, W) f32 overflow plane that is all zeros: the TPU kernel flagged
    pixels whose footprint overflowed its VMEM window, and this kernel has
    no window. CUDA tensors launch the kernel; CPU tensors take
    :func:`warp_plain`."""
    global LAUNCHES_WARP
    _check_inputs(chans, av, bu, hit)
    if chans.device.type == "cpu":
        planes = warp_plain(chans, av, bu, hit)
    else:
        lib = build()
        n_ch, iv, iu = chans.shape
        planes = torch.empty((n_ch,) + tuple(av.shape), dtype=torch.float32,
                             device=chans.device)
        err = lib.vk_warp_bilinear(
            chans.data_ptr(), n_ch, iv, iu, av.data_ptr(), bu.data_ptr(),
            None if hit is None else hit.data_ptr(), *av.shape, planes.data_ptr(),
            chans.device.index, torch.cuda.current_stream(chans.device).cuda_stream,
        )
        check_launch(lib, err, "warp_bilinear")
        LAUNCHES_WARP += 1
    if with_overflow:
        return planes, torch.zeros_like(av)
    return planes


@torch.no_grad()
def warp_plain(chans, av, bu, hit=None):
    """Plain torch version of K6: the kernel's float32 operations over whole
    planes (the coordinates of non-participating pixels are replaced by 0
    before the gather, and their output by 0)."""
    _check_inputs(chans, av, bu, hit)
    n_ch, iv, iu = chans.shape
    if hit is not None:
        av = torch.where(hit, av, 0.0)
        bu = torch.where(hit, bu, 0.0)
    a = torch.clamp(av, 0.0, iv - 1.0)
    b = torch.clamp(bu, 0.0, iu - 1.0)
    v0f, u0f = torch.floor(a), torch.floor(b)
    fa, fb = a - v0f, b - u0f
    v0, u0 = v0f.long(), u0f.long()
    v1, u1 = (v0 + 1).clamp(max=iv - 1), (u0 + 1).clamp(max=iu - 1)
    flat = chans.reshape(n_ch, iv * iu)

    def tap(v, u):
        return flat[:, (v * iu + u).reshape(-1)].reshape((n_ch,) + tuple(av.shape))

    x00, x01, x10, x11 = tap(v0, u0), tap(v0, u1), tap(v1, u0), tap(v1, u1)
    t0 = x00 + (x01 - x00) * fb
    t1 = x10 + (x11 - x10) * fb
    out = t0 + (t1 - t0) * fa
    if hit is not None:
        out = torch.where(hit, out, 0.0)
    return out


# -- K5: the stats warp ------------------------------------------------------

def srgb_score_lum(lum):
    """(slope, srgb_lum) of the scoring luminance from one log + exp pair
    (vokselis_tpu/ops/pallas/warp2d.py:_srgb_score_lum): t = lum^(1/2.4)
    gives both the sRGB transfer's slope (1.055/2.4) * t / lum and the sRGB
    luminance 1.055 * t - 0.055 (12.92 and 12.92 * lum in the linear toe)."""
    t = torch.exp(torch.log(lum) * (1.0 / 2.4))
    hi = lum > 0.0031308
    slope = torch.where(hi, (1.055 / 2.4) * t / lum, 12.92)
    srgb_lum = torch.where(hi, 1.055 * t - 0.055, 12.92 * lum)
    return slope, srgb_lum


def tile_edge(x):
    """|d/dx| + |d/dy| of an (H, W) plane whose sides are whole tiles,
    within each 32x32 tile only: the difference with the left neighbour is
    0 in a tile's first column, the one with the pixel above 0 in its first
    row. That is the JAX package's packed ``_packed_edge`` (warp2d.py:412)
    in frame layout: it too drops the differences across tile borders."""
    cd = torch.zeros_like(x)
    cd[:, 1:] = torch.abs(x[:, 1:] - x[:, :-1])
    cd[:, ::TILE] = 0.0
    rd = torch.zeros_like(x)
    rd[1:] = torch.abs(x[1:] - x[:-1])
    rd[::TILE] = 0.0
    return cd + rd


def tile_stats(rgb, curv, ok, box):
    """The per-tile score statistics of the ok-masked warped planes: ``rgb``
    (3, H, W) and ``curv`` (H, W) f32 (zero where not ok), ``ok`` and
    ``box`` (H, W) bool. The frame is padded to whole 32x32 tiles with
    pixels that are neither ok nor box hits (rgb 0, so luminance 1e-6: they
    enter the edge sum and the peak, as the JAX package's padded tiles do).
    Returns (cdiv(H,32) * cdiv(W,32), 5) f32, tiles in raster order, the
    columns STAT_*. The counterpart of ``warp2d.stats_from_packed`` (:601)
    in frame layout."""
    h, w = curv.shape
    ny, nx = cdiv(h, TILE), cdiv(w, TILE)

    def pad(x):
        return F.pad(x, (0, nx * TILE - w, 0, ny * TILE - h))

    def tiles(x):
        return x.reshape(ny, TILE, nx, TILE).transpose(1, 2).reshape(ny * nx, TILE * TILE)

    r, g, b = (pad(c) for c in rgb)
    lum = torch.clamp((r + g + b) * (1.0 / 3.0), min=1e-6)
    slope, lums = srgb_score_lum(lum)
    okf, boxf = pad(ok.float()), pad(box.float())
    vals = [
        tiles(pad(curv) * slope).sum(dim=1),
        tiles(tile_edge(lums)).sum(dim=1),
        torch.zeros((ny * nx,), dtype=torch.float32, device=curv.device),
        tiles(boxf * (1.0 - okf)).sum(dim=1),
        tiles(lums).amax(dim=1),
    ]
    return torch.stack(vals, dim=1)


def _check_stats_inputs(chans, av, bu, ok, box):
    if ok is None or box is None:
        raise TypeError("ok and box are required (H, W) bool planes")
    _check_inputs(chans, av, bu, ok)
    _check_inputs(chans, av, bu, box)
    if chans.shape[0] != 4:
        raise ValueError(f"chans must be (4, Iv, Iu): r, g, b and curvature, got "
                         f"{tuple(chans.shape)}")


@torch.no_grad()
def warp_stats(chans, av, bu, ok, box):
    """K5: warp ``chans`` (4, Iv, Iu) f32 (r, g, b and the intermediate's
    curvature) to the screen as :func:`warp_bilinear` does, masked by
    ``ok`` (H, W) bool, and reduce the hybrid's score statistics per 32x32
    tile (:func:`tile_stats`), ``box`` (H, W) bool being the volume-box hit
    mask.

    Returns the ok-masked (3, H, W) f32 r, g, b planes and the
    (cdiv(H,32) * cdiv(W,32), 5) f32 stats. STAT_OVF is 0: the TPU's
    overflow re-warp (K5b) has nothing to do without a window. The sums
    add in another order than the plain version's, so they agree within
    float32 rounding; the rgb planes, STAT_EXT and STAT_PEAK are the plain
    version's bit for bit. CUDA tensors launch the kernel; CPU tensors take
    :func:`warp_stats_plain`."""
    global LAUNCHES_STATS
    _check_stats_inputs(chans, av, bu, ok, box)
    if chans.device.type == "cpu":
        return warp_stats_plain(chans, av, bu, ok, box)
    lib = build()
    _, iv, iu = chans.shape
    h, w = av.shape
    rgb = torch.empty((3, h, w), dtype=torch.float32, device=chans.device)
    stats = torch.empty((cdiv(h, TILE) * cdiv(w, TILE), N_STATS), dtype=torch.float32,
                        device=chans.device)
    err = lib.vk_warp_stats(
        chans.data_ptr(), iv, iu, av.data_ptr(), bu.data_ptr(), ok.data_ptr(),
        box.data_ptr(), h, w, rgb.data_ptr(), stats.data_ptr(), chans.device.index,
        torch.cuda.current_stream(chans.device).cuda_stream,
    )
    check_launch(lib, err, "warp_stats")
    LAUNCHES_STATS += 1
    return rgb, stats


@torch.no_grad()
def warp_stats_plain(chans, av, bu, ok, box):
    """Plain torch version of K5: :func:`warp_plain` of the four channels
    masked by ``ok``, then :func:`tile_stats`."""
    _check_stats_inputs(chans, av, bu, ok, box)
    planes = warp_plain(chans, av, bu, ok)
    return planes[:3], tile_stats(planes[:3], planes[3], ok, box)
