"""K1: the exact bonsai raymarch as a hand-written CUDA kernel for Hopper.

The kernel (``vokselis_torch/csrc/march_bonsai.cu``) replaces the TPU kernel
``vokselis_tpu/ops/pallas/march_bonsai.py:_march_kernel``. It is compiled
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
at first use on a CUDA device, into ``build/vokselis_torch/`` under the
checkout, and loaded with ``ctypes``. Importing this module builds nothing.

:func:`render_bonsai_rays_cuda` launches the kernel for CUDA tensors and
uses its plain version, :func:`vokselis_torch.ops.reference.render_bonsai_rays`,
only for tensors that lie on the CPU. A failed build or launch raises; there
is no fallback.

``LAUNCHES`` counts the kernel's launches (one per successful launch, and
nowhere else), so that a run can show its frames went through the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vokselis_torch.core import geometry
from vokselis_torch.ops import reference
from vokselis_torch.ops.cuda.build import CSRC, NVCC_FLAGS, check_launch, load_library
from vokselis_torch.ops.reference import MAX_STEPS_BONSAI

SOURCE = CSRC / "march_bonsai.cu"

LAUNCHES = 0
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
