"""K6: the shear-warp fast renderer's bilinear homography warp as a
hand-written CUDA kernel for Hopper.

The kernel (``vokselis_torch/csrc/warp2d.cu``) replaces the TPU kernel
``vokselis_tpu/ops/pallas/warp2d.py:_warp_kernel_mxu`` and the two that
existed only for its VMEM windows, ``_rewarp_kernel`` (the overflow
re-warp) and ``_warp_kernel``/``_warp_kernel_impl`` (the row scan for large
intermediates): a thread per pixel reads the intermediate directly, so one
kernel serves every intermediate size and no footprint overflows. It is
built with ``nvcc`` at first use on a CUDA device; importing builds nothing.

:func:`warp_bilinear` launches the kernel for CUDA tensors and takes
:func:`warp_plain` only for tensors on the CPU. A failed build or launch
raises; there is no fallback. ``LAUNCHES_WARP`` counts successful launches
and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from vokselis_torch.ops.cuda.build import CSRC, NVCC_FLAGS, check_launch, load_library

SOURCE = CSRC / "warp2d.cu"
MAX_CHANNELS = 4

LAUNCHES_WARP = 0
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
    lib.vk_warp_bilinear.argtypes = [p, i, i, i, p, p, p, i, p, i, p]
    lib.vk_warp_bilinear.restype = i
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
            None if hit is None else hit.data_ptr(), av.numel(), planes.data_ptr(),
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
