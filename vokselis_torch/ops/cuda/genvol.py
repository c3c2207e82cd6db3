"""K9 and K8: procedural volume generation as hand-written CUDA kernels for
Hopper.

The kernels (``vokselis_torch/csrc/genvol.cu``, with the fields in
``csrc/fields.cuh``) replace the TPU kernels
``vokselis_tpu/ops/pallas/genvol.py:_genvol_kernel`` (K9,
``generate_xor_volumes_pallas``: the xor demo's density and normal textures)
and ``_gendensity_kernel`` (K8, ``generate_density_u8_pallas``: config 5's
time-varying uint8 density). They are compiled with ``nvcc`` for ``sm_90a``
at first use on a CUDA device into ``build/vokselis_torch/`` and loaded with
``ctypes``; importing this module builds nothing.

:func:`generate_xor_volumes` and :func:`generate_density_u8` launch their
kernel on a CUDA device and take their plain versions
(:func:`generate_xor_volumes_plain`, :func:`generate_density_u8_plain`) only
on the CPU. A failed build or launch raises; there is no fallback.
``LAUNCHES_GENVOL`` and ``LAUNCHES_DENSITY`` count the launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vokselis_torch.ops.cuda.build import CSRC, NVCC_FLAGS, check_launch, load_library
from vokselis_torch.volume import fields_soa

SOURCE = CSRC / "genvol.cu"

LAUNCHES_GENVOL = 0
LAUNCHES_DENSITY = 0
# compiler output of this process's build (ptxas register / spill report);
# empty when the library was already built
BUILD_LOG = ""
_lib = None

# voxels per slab of the plain versions: bounds their temporaries (each a
# float32 copy of the slab) at 64 MB
_SLAB_VOXELS = 1 << 24


def build() -> ctypes.CDLL:
    """Compile (once per source and flag set) and load the kernel library."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    lib, BUILD_LOG = load_library(SOURCE, NVCC_FLAGS)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vk_genvol.argtypes = [p, i, f, p, p, i, p]
    lib.vk_genvol.restype = i
    lib.vk_gendensity.argtypes = [p, i, f, p, i, p]
    lib.vk_gendensity.restype = i
    _lib = lib
    return lib


def _device(time, device):
    if isinstance(time, torch.Tensor):
        return time.device
    return torch.device("cuda" if device is None else device)


def _sin_t(time, dims, device):
    """sin(time) as a 0-d f32 tensor on ``device``, as the kernels read it."""
    if not isinstance(dims, int) or dims < 1:
        raise ValueError(f"dims must be a positive int, got {dims!r}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"genvol runs on cpu or cuda, not {device}")
    t = torch.as_tensor(time, dtype=torch.float32, device=device).reshape(())
    return torch.sin(t * 1.0)


def _slabs(dims, device):
    """Voxel-centre coordinates (index - dims/2) / dims of z-slabs of the
    dims^3 grid: yields (z0, z1, (cx, cy, cz)), each (z1 - z0, dims, dims)."""
    c = (torch.arange(dims, dtype=torch.float32, device=device) - dims / 2.0) / dims
    step = max(1, _SLAB_VOXELS // (dims * dims))
    for z0 in range(0, dims, step):
        z1 = min(dims, z0 + step)
        shape = (z1 - z0, dims, dims)
        yield z0, z1, (c[None, None, :].expand(shape), c[None, :, None].expand(shape),
                       c[z0:z1, None, None].expand(shape))


def _inv(dims):
    # PyTorch's division by a Python scalar on the card: times the reciprocal
    return float(np.float32(1.0 / dims))


@torch.no_grad()
def generate_xor_volumes_plain(time=0.0, dims: int = 256, device=None):
    """K9's plain version (genvol.py:27-52, 80-83): the fbm field's value,
    alpha and one-sided-difference normal at every voxel centre, as the
    density texture (val/2, val/2, val/2, alpha) and the normal texture
    (n, |n|), each (D, D, D, 4) f32 [z, y, x, channel]."""
    device = _device(time, device)
    sin_t = _sin_t(time, dims, device)
    density = torch.empty((dims, dims, dims, 4), dtype=torch.float32, device=device)
    normal = torch.empty_like(density)
    for z0, z1, (cx, cy, cz) in _slabs(dims, device):
        val, alpha = fields_soa.noise_volume(cx, cy, cz, sin_t)
        nx, ny, nz = fields_soa.gradient(cx, cy, cz, sin_t)
        nmag = torch.sqrt(nx * nx + ny * ny + nz * nz)
        density[z0:z1] = torch.stack([val / 2.0, val / 2.0, val / 2.0, alpha], dim=-1)
        normal[z0:z1] = torch.stack([nx, ny, nz, nmag], dim=-1)
    return density, normal


@torch.no_grad()
def generate_xor_volumes(time=0.0, dims: int = 256, device=None):
    """The xor demo's density + normal volumes (the counterpart of
    ``generate_xor_volumes_pallas``): (density, normal), each (D, D, D, 4)
    f32, matching :func:`vokselis_torch.volume.fields.generate_xor_volumes`.
    ``time`` is a Python float or a 0-d tensor (whose device is taken);
    ``device`` defaults to "cuda". CUDA launches K9; the CPU takes
    :func:`generate_xor_volumes_plain`."""
    global LAUNCHES_GENVOL
    device = _device(time, device)
    if device.type == "cpu":
        return generate_xor_volumes_plain(time, dims, device)
    sin_t = _sin_t(time, dims, device)
    lib = build()
    density = torch.empty((dims, dims, dims, 4), dtype=torch.float32, device=device)
    normal = torch.empty_like(density)
    dev = density.device
    err = lib.vk_genvol(sin_t.data_ptr(), dims, _inv(dims), density.data_ptr(),
                        normal.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, err, "genvol")
    LAUNCHES_GENVOL += 1
    return density, normal


@torch.no_grad()
def generate_density_u8_plain(time=0.0, dims: int = 512, device=None):
    """K8's plain version (genvol.py:86-104, 131): the radially masked fbm
    alpha at every voxel centre, clip(alpha * 255 + 0.5, 0, 255) truncated
    to uint8, (D, D, D) [z, y, x]; computed in z-slabs to bound memory."""
    device = _device(time, device)
    sin_t = _sin_t(time, dims, device)
    out = torch.empty((dims, dims, dims), dtype=torch.uint8, device=device)
    for z0, z1, (cx, cy, cz) in _slabs(dims, device):
        alpha = fields_soa.noise_volume_alpha(cx, cy, cz, sin_t)
        out[z0:z1] = torch.clamp(alpha * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
    return out


@torch.no_grad()
def generate_density_u8(time=0.0, dims: int = 512, device=None):
    """Time-varying uint8 density volume (the counterpart of
    ``generate_density_u8_pallas``): config 5's per-batch volume update, the
    bonsai march kernel's voxel format. Arguments as
    :func:`generate_xor_volumes`; CUDA launches K8, the CPU takes
    :func:`generate_density_u8_plain`."""
    global LAUNCHES_DENSITY
    device = _device(time, device)
    if device.type == "cpu":
        return generate_density_u8_plain(time, dims, device)
    sin_t = _sin_t(time, dims, device)
    lib = build()
    out = torch.empty((dims, dims, dims), dtype=torch.uint8, device=device)
    dev = out.device
    err = lib.vk_gendensity(sin_t.data_ptr(), dims, _inv(dims), out.data_ptr(), dev.index,
                            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, err, "gendensity")
    LAUNCHES_DENSITY += 1
    return out
