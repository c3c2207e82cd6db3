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
``LAUNCHES_GENVOL`` and ``LAUNCHES_DENSITY`` count the launches (one per
successful kernel launch, and nowhere else).

The kernels read the fbm hashes from the device's shared table
(:func:`hash_table.hash_table`, K7's too), not from ``sinf``. A block covers
a brick of voxels and first copies, for each octave, the window of the table
its brick can reach into shared memory: :func:`brick_windows` is that rule
in plain torch and :func:`window_capacity` the size each window may take.
A lattice argument outside the table traps the kernel.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from vokselis_torch.ops.cuda.build import CSRC, NVCC_FLAGS, check_launch, load_library
from vokselis_torch.ops.cuda.hash_table import (CORNER_MAX, LATTICE_W, OCTAVE_SCALES,
                                                hash_table, table_args)
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

# The kernels' bricks (x, y, z voxels; a block covers one and walks its z
# slices). K8 takes 4 consecutive x voxels a thread, K9 one; x is always 32
# and a block at most 256 threads. Chosen by measurement on the card
# (PERF.md); a brick never changes a voxel.
K8_BRICK = (32, 32, 64)
K9_BRICK = (32, 8, 32)
# shared memory a block's windows may take (the card allows 227 KB); a brick
# whose windows would need more is cut, z first, at small dims
_SMEM_LIMIT = 200 * 1024
_EPS = 1e-4  # fields_soa.gradient's one-sided step (fields.cuh EPS)
# rounding slack of a window bound, in lattice cells (f32 lattice values up to
# ~2900 carry a few ulps, ~1e-3)
_SLACK = 1e-2


def build() -> ctypes.CDLL:
    """Compile (once per source and flag set) and load the kernel library."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    lib, BUILD_LOG = load_library(SOURCE, NVCC_FLAGS)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vk_genvol.argtypes = [p, i, f, i, i, p] + [i] * 12 + [p, p, i, p]
    lib.vk_genvol.restype = i
    lib.vk_gendensity.argtypes = [p, i, f, i, i, p] + [i] * 12 + [p, i, p]
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


def window_capacity(dims: int, brick, offsets: bool = False) -> tuple:
    """Each octave's window length (floats) that a brick of ``brick`` voxels
    may need at ``dims``, whatever sin t: along each axis the brick spans at
    most (b - 1) / dims of c, 32 s lattice cells per unit at octave scale s
    (plus the one-sided offset's 1e-4 with ``offsets``), so its floors differ
    by at most floor(extent) + 1; the window is those differences weighted
    as n = px + 157 py + 113 pz, plus the 272 corners of a cell."""
    caps = []
    for s in OCTAVE_SCALES:
        cells = []
        for b in brick:
            extent = ((min(b, dims) - 1) / dims + (_EPS if offsets else 0.0)) * 32.0 * s
            cells.append(math.floor(extent + _SLACK) + 1)
        caps.append(sum(w * c for w, c in zip(LATTICE_W, cells)) + CORNER_MAX + 1)
    return tuple(caps)


def brick_windows(dims: int, sin_t, brick, offsets: bool = False) -> torch.Tensor:
    """The kernels' window rule in plain torch: for every brick of the dims^3
    grid (``brick`` voxels along x, y, z; the last ones cut by the grid) and
    every octave, the first and last lattice argument whose hash the brick's
    block copies into shared memory, as an int64 tensor (bricks along z, y,
    x, octave, 2). The first is the cell of the brick's low corner voxel
    (with ``offsets``, as K9, of its one-sided offset point), the last the
    high corner's cell + 271: the argument n = px + 157 py + 113 pz is
    monotone in every voxel index, so every voxel's cells lie between."""
    sin_t = torch.as_tensor(sin_t, dtype=torch.float32)
    c = (torch.arange(dims, dtype=torch.float32) - dims / 2.0) * _inv(dims)
    ends = []
    for b in brick:
        lo = torch.arange(0, dims, b)
        ends.append((c[lo], c[torch.clamp(lo + b, max=dims) - 1]))
    (xl, xh), (yl, yh), (zl, zh) = ends
    if offsets:
        xl, yl, zl = xl - _EPS, yl - _EPS, zl - _EPS
    out = []
    for corner in (fields_soa._lattice(xl, yl, zl, sin_t), fields_soa._lattice(xh, yh, zh, sin_t)):
        x, y, z = corner
        per_octave = []
        for _, scale in fields_soa._OCTAVES:
            px, py, pz = torch.floor(x), torch.floor(y), torch.floor(z)
            per_octave.append(px[None, None, :] + py[None, :, None] * 157.0
                              + 113.0 * pz[:, None, None])
            if scale is not None:
                x, y, z = x * scale, y * scale, z * scale
        out.append(torch.stack(per_octave, dim=-1).long())
    return torch.stack([out[0], out[1] + CORNER_MAX], dim=-1)


def _brick(brick, dims: int, offsets: bool):
    """The launch's brick (``brick``, cut z first, then y, until its windows
    fit the shared-memory limit at a small dims) and its windows'
    capacities (``offsets`` for K9)."""
    bx, by, bz = brick
    while True:
        caps = window_capacity(dims, (bx, by, bz), offsets)
        if 4 * sum(caps) <= _SMEM_LIMIT or (by == 1 and bz == 1):
            return (bx, by, bz), caps
        if bz > 1:
            bz = (bz + 1) // 2
        else:
            by = (by + 1) // 2


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


def _launch(k9: bool, sin_t, dims: int, table=None, brick=None):
    """Launch K9 (``k9``; returns (density, normal)) or K8 (the (D, D, D)
    u8 volume) on ``sin_t``, sin(time) as a 0-d f32 tensor on a CUDA device,
    over bricks of ``brick`` voxels (default :data:`K9_BRICK` /
    :data:`K8_BRICK`; another one changes no voxel, which the card's tests
    check). The kernel reads ``table`` (default the device's
    :func:`hash_table`); a lattice argument outside it makes the kernel
    trap, which the stream's next synchronization raises."""
    global LAUNCHES_DENSITY, LAUNCHES_GENVOL
    if not isinstance(dims, int) or dims < 1 or sin_t.numel() != 1:
        raise ValueError(f"genvol wants a positive int dims and one sin t, got {dims!r}, "
                         f"{tuple(sin_t.shape)}")
    lib = build()
    dev = sin_t.device
    table = hash_table(dev) if table is None else table
    for x in (sin_t, table.values):
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("genvol wants sin t and the hash table as f32 on one device")
    brick, caps = _brick((K9_BRICK if k9 else K8_BRICK) if brick is None else brick, dims, k9)
    if k9:
        outs = tuple(torch.empty((dims, dims, dims, 4), dtype=torch.float32, device=dev)
                     for _ in range(2))
        fn, name = lib.vk_genvol, "genvol"
    else:
        outs = (torch.empty((dims, dims, dims), dtype=torch.uint8, device=dev),)
        fn, name = lib.vk_gendensity, "gendensity"
    err = fn(sin_t.data_ptr(), dims, _inv(dims), brick[1], brick[2], *table_args(table), *caps,
             *(x.data_ptr() for x in outs), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, err, name)
    if k9:
        LAUNCHES_GENVOL += 1
        return outs
    LAUNCHES_DENSITY += 1
    return outs[0]


def launch_xor(sin_t, dims: int, table=None):
    """K9 on ``sin_t`` (a 0-d f32 CUDA tensor): (density, normal), each
    (D, D, D, 4) f32. ``table`` is a test hook: another hash table (one cut
    short, to show the trap) in place of the device's."""
    return _launch(True, sin_t, dims, table)


def launch_density(sin_t, dims: int, table=None):
    """K8 on ``sin_t`` (a 0-d f32 CUDA tensor): the (D, D, D) u8 volume.
    ``table`` as :func:`launch_xor`."""
    return _launch(False, sin_t, dims, table)


@torch.no_grad()
def generate_xor_volumes(time=0.0, dims: int = 256, device=None):
    """The xor demo's density + normal volumes (the counterpart of
    ``generate_xor_volumes_pallas``): (density, normal), each (D, D, D, 4)
    f32, matching :func:`vokselis_torch.volume.fields.generate_xor_volumes`.
    ``time`` is a Python float or a 0-d tensor (whose device is taken);
    ``device`` defaults to "cuda". CUDA launches K9 (:func:`launch_xor`); the
    CPU takes :func:`generate_xor_volumes_plain`."""
    device = _device(time, device)
    if device.type == "cpu":
        return generate_xor_volumes_plain(time, dims, device)
    return launch_xor(_sin_t(time, dims, device), dims)


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
    :func:`generate_xor_volumes`; CUDA launches K8 (:func:`launch_density`), the CPU
    takes :func:`generate_density_u8_plain`."""
    device = _device(time, device)
    if device.type == "cpu":
        return generate_density_u8_plain(time, dims, device)
    return launch_density(_sin_t(time, dims, device), dims)
