"""K7: the procedural-field march (the xor demo's compute raymarch and the trig
field) as a hand-written CUDA kernel for Hopper.

The kernel (``vokselis_torch/csrc/march_field.cu``, with the fields in
``csrc/fields.cuh``) replaces the TPU kernel
``vokselis_tpu/ops/pallas/march_field.py:_march_kernel``; :func:`render_field`
is the counterpart of ``render_field_pallas``, and :class:`FieldRenderer`
of that function's ``jax.jit``: one CUDA graph per static key. The kernel
takes the camera's ``inv_proj`` and the raw time: each thread makes its
pixel's ray (:func:`geometry.rays_compute_soa`), the slab test, the per-ray
dt, the exact bounding-sphere clip with its lattice snap and sin(time), bit
for bit as :func:`field_rays` and :func:`time_vector` compute them in torch
(the JAX package computes them in XLA), then runs the march body. It is
compiled with ``nvcc`` for ``sm_90a`` at first use on a CUDA device into
``build/vokselis_torch/`` and loaded with ``ctypes``; importing this module
builds nothing.

:func:`render_field` launches the kernel for a camera uniform on a CUDA
device and takes its plain twin, :func:`field_rays` and :func:`time_vector`
marched by :func:`_march_plain` operation for operation, only on the CPU.
A failed build or launch raises; there is no fallback. ``LAUNCHES_FIELD``
counts the kernel's launches (one per successful launch, and nowhere else).

The kernel reads the fbm field's lattice hashes from :func:`hash_table`
(``hash_table.py``, shared with K9 and K8: built once per device by the
plain version's own hash over every lattice argument the field can reach,
:data:`HASH_RANGES`) instead of evaluating sinf: the same values bit for
bit, without sinf's slow reduction of the large arguments. An argument
outside the table makes the kernel trap.

Normals of the fused noise + xor march: ``grad="analytic"`` (the default,
or ``VOK_XOR_GRAD=analytic``) differentiates alpha in closed form from the
value's own 24 corner hashes; ``grad="fd"`` (``VOK_XOR_GRAD=fd``) is the
reference's eps = 1e-4 one-sided difference, hash-shared, which the oracle
:func:`vokselis_torch.ops.reference.render_compute_inline` computes.
"""

from __future__ import annotations

import ctypes
import math
import os

import numpy as np
import torch

from vokselis_torch.core import geometry
from vokselis_torch.core.colors import mix, smoothstep
from vokselis_torch.core.compiled import CompiledFrame
from vokselis_torch.ops.cuda.build import CSRC, NVCC_FLAGS, check_launch, load_library
# the shared hash table (hash_table.py), importable from here too
from vokselis_torch.ops.cuda.hash_table import (  # noqa: F401
    HASH_RANGES, HashTable, build_hash_table, hash_table, table_args, table_hash)
from vokselis_torch.ops.reference import MAX_STEPS_COMPUTE
from vokselis_torch.utils.spans import count
from vokselis_torch.volume import fields_soa

SOURCE = CSRC / "march_field.cu"

FIELDS = ("noise", "xor", "trig")
SHADINGS = ("xor", "emission")
GRADS = ("analytic", "fd")
# the kernel's block is 32 pixels wide and tile_h rows high; the xor demo's
# SinglePass mode takes 8 rows, its Tile mode 16
TILE_HS = (1, 2, 4, 8, 16)
DEFAULT_TILE_H = 8

LAUNCHES_FIELD = 0
# compiler output of this process's build (ptxas register / spill report);
# empty when the library was already built
BUILD_LOG = ""
_lib = None

_CLEAR = (0.023, 0.02, 0.02, 0.0)  # raycast_compute.wgsl:119
_L_DIR_N = tuple(c / math.sqrt(9.0) for c in (-2.0, -2.0, -1.0))
_MASK_DIR_N = tuple(c / math.sqrt(3.0) for c in (1.0, 1.0, -1.0))
# each field windows its alpha to zero beyond this |p| (noise and xor in the
# quantized coordinate (g - D/2)/D ~ p/2, trig at p itself)
_RADIUS = {"noise": 1.0, "xor": 1.4, "trig": 0.9}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launch function's C signature on a loaded K7 library
    (this module's own, or one the hot-reload loop rebuilt from an edited
    source); returns ``lib``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vk_march_field_frame.argtypes = ([p, p, i, i, f] + [i] * 5 + [f, i, i, p] + [i] * 9
                                         + [p, i, p])
    lib.vk_march_field_frame.restype = i
    return lib


def build() -> ctypes.CDLL:
    """Compile (once per source and flag set) and load the kernel library."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    lib, BUILD_LOG = load_library(SOURCE, NVCC_FLAGS)
    _lib = bind(lib)
    return _lib


def default_grad() -> str:
    """The normal source of the fused noise + xor march: ``VOK_XOR_GRAD``
    ("analytic" unless set to "fd")."""
    grad = os.environ.get("VOK_XOR_GRAD", "analytic")
    if grad not in GRADS:
        raise ValueError(f"VOK_XOR_GRAD must be one of {GRADS}, got {grad!r}")
    return grad


def time_vector(time, device) -> torch.Tensor:
    """``[raw time, sin(time)]`` as a (2,) f32 tensor on ``device``, which
    the plain march reads (K7 takes the raw time and makes the sine): the
    noise and xor fields take sin(time), the trig field the raw time. A 0-d
    tensor already on the device is not copied."""
    t = torch.as_tensor(time, dtype=torch.float32, device=device).reshape(())
    return torch.stack([t, torch.sin(t * 1.0)])


def _sphere_r2(field: str, dims: int, quantize: bool, sphere_clip: bool) -> float:
    """The squared radius of the field's bounding sphere (a Python float,
    which meets the rays as float32): the field's radius, grown by one
    voxel's reach when quantized; 1e9 without the clip."""
    radius = _RADIUS[field] if sphere_clip else 1e9
    pad = (2.0 * math.sqrt(3.0) / dims) if quantize else 0.0
    return (radius + pad) ** 2


def field_rays(camera_uniform, width: int, height: int, field: str = "noise",
               dims: int = 256, quantize: bool = True, sphere_clip: bool = True):
    """The nine (H, W) f32 planes the plain march reads
    (march_field.py:239-283): eye (ex, ey, ez), direction (dx, dy, dz), the
    span t0 <= t < t1 and the step dt. dt is one voxel of a dims^3 grid
    along the dominant axis, floored at 0.01 (raycast_compute.wgsl:65-68).
    K7's threads make each pixel's nine values themselves, bit for bit as
    these torch ops make them on the card (``csrc/march_field.cu``).

    The exact empty-space clip: every field windows its alpha to zero beyond
    a radius, and with clear.a == 0 a zero-alpha step composites nothing, so
    the span is cut to the bounding sphere, its entry snapped forward onto
    the ray's own lattice t0 + j dt. Quantized fields see coordinates up to
    one voxel below p/2 per axis, so their radius grows by 2 sqrt(3)/dims.
    ``sphere_clip=False`` keeps the whole box span."""
    (ex, ey, ez), (dx, dy, dz) = geometry.rays_compute_soa(camera_uniform, width, height)
    t0, t1 = geometry.intersect_box_soa(ex, ey, ez, dx, dy, dz, -1.0, 1.0)
    t0 = torch.clamp(t0, min=0.0)
    dt = torch.clamp(
        torch.minimum(
            1.0 / (dims * torch.abs(dx)),
            torch.minimum(1.0 / (dims * torch.abs(dy)), 1.0 / (dims * torch.abs(dz))),
        ),
        min=0.01,
    )
    r2 = _sphere_r2(field, dims, quantize, sphere_clip)
    # |e + t d|^2 = R^2  (d normalized)
    bq = ex * dx + ey * dy + ez * dz
    cq = ex * ex + ey * ey + ez * ez - r2
    disc = bq * bq - cq
    sph_hit = disc > 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    ts0 = -bq - sq
    ts1 = -bq + sq
    j0 = torch.ceil(torch.clamp(ts0 - t0, min=0.0) / dt)
    t_begin = t0 + j0 * dt
    t_end = torch.minimum(t1, ts1)
    t0 = torch.where(sph_hit, t_begin, t1)  # no sphere hit -> zero steps
    t1 = torch.where(sph_hit, t_end, t1)
    return ex, ey, ez, dx, dy, dz, t0, t1, dt


def _xor_shade(val, nx, ny, nz, px, py, pz):
    """K2 shading (raycast_compute.wgsl:73-86) -> (cr, cg, cb)."""
    vr = vg = vb = val * 0.5  # the density texture stores vol.rgb / 2
    # Lambert vs light (0,-1,0): dot = -ny (raycast_compute.wgsl:64,73)
    sh = torch.clamp(-ny, min=0.0)
    shr = shg = shb = sh
    # red-tinted directional with positional mask (:81-83)
    dshade = torch.clamp(nx * _L_DIR_N[0] + ny * _L_DIR_N[1] + nz * _L_DIR_N[2], min=0.0)
    dmask = smoothstep(0.3, 1.5, px * _MASK_DIR_N[0] + py * _MASK_DIR_N[1]
                       + pz * _MASK_DIR_N[2])
    d = 3.0 * dshade * dmask
    vr = vr + d * 1.0
    vg = vg + d * 0.1
    vb = vb + d * 0.13
    # blue bottom fill (:85-86)
    bottom = 0.9 * torch.clamp(0.5 - 0.5 * ny, 0.0, 1.0)
    shr = mix(shr, bottom * 0.0, 0.2)
    shg = mix(shg, bottom * 0.0, 0.2)
    shb = mix(shb, bottom * 0.6, 0.2)
    return vr * shr, vg * shg, vb * shb


def _march_plain(tvec, rays, field, shading, dims, quantize, max_steps, grad,
                 return_steps=False, fields=fields_soa):
    """K7's plain version: the kernel's march of every ray, its arithmetic
    operation for operation. Each step evaluates only the rays still active
    (a ray never becomes active again), which changes no value. ``fields``
    is the module of field functions (:mod:`fields_soa`, or an edited copy
    that the hot-reload loop loaded)."""
    ex, ey, ez, dx, dy, dz, t0, t1, dt = (x.reshape(-1) for x in rays)
    t_raw, sin_t = tvec[0], tvec[1]
    field_time = t_raw if field == "trig" else sin_t
    hit = t0 < t1
    clear_r, clear_g, clear_b, clear_a = _CLEAR
    # get_col2 init: color = (clear.rgb, 0.1) (raycast_compute.wgsl:61)
    r = torch.full_like(t0, clear_r)
    g = torch.full_like(t0, clear_g)
    b = torch.full_like(t0, clear_b)
    a = torch.full_like(t0, 0.1)
    t = t0.clone()
    steps = torch.zeros(t0.shape, dtype=torch.int32, device=t0.device)
    half = dims / 2.0
    grad_fn = (fields.noise_volume_grad_analytic if grad == "analytic"
               else fields.noise_volume_grad)

    def quant(q):
        # textureLoad at ivec3((p+1)*dims/2) -> the voxel-centre coordinate
        return (torch.clamp(torch.floor((q + 1.0) * half), 0, dims - 1) - half) / dims

    for _ in range(max_steps):
        idx = torch.nonzero(hit & (t < t1) & (a < 0.95)).squeeze(1)
        if idx.numel() == 0:
            break
        steps[idx] += 1
        ts = t[idx]
        px = ex[idx] + ts * dx[idx]
        py = ey[idx] + ts * dy[idx]
        pz = ez[idx] + ts * dz[idx]
        cx, cy, cz = (quant(px), quant(py), quant(pz)) if quantize else (px, py, pz)
        if shading == "xor" and field == "noise":
            val, valpha, nx, ny, nz = grad_fn(cx, cy, cz, sin_t)
            cr, cg, cb = _xor_shade(val, nx, ny, nz, px, py, pz)
        else:
            val, valpha = fields.FIELDS[field](cx, cy, cz, field_time)
            if shading == "xor":
                # the normal is the noise field's, whatever the field
                nx, ny, nz = fields.gradient(cx, cy, cz, sin_t)
                cr, cg, cb = _xor_shade(val, nx, ny, nz, px, py, pz)
            else:  # emission
                cr = cg = cb = val
        vol_alpha = smoothstep(0.0, 0.7, valpha * valpha * valpha)
        # front-to-back composite with clear-color ambient (:88-91)
        ai = a[idx]
        one_m_a = 1.0 - ai
        r[idx] = r[idx] + one_m_a * vol_alpha * cr + clear_r * clear_a * (1.0 - vol_alpha)
        g[idx] = g[idx] + one_m_a * vol_alpha * cg + clear_g * clear_a * (1.0 - vol_alpha)
        b[idx] = b[idx] + one_m_a * vol_alpha * cb + clear_b * clear_a * (1.0 - vol_alpha)
        a[idx] = ai + one_m_a * vol_alpha * (1.0 - clear_a)
        t[idx] = ts + dt[idx]

    # render(): miss pixels get the clear color, alpha forced to 1 (:121-128)
    shape = rays[0].shape
    img = torch.stack([torch.where(hit, r, clear_r), torch.where(hit, g, clear_g),
                       torch.where(hit, b, clear_b), torch.ones_like(r)], dim=-1)
    img = img.reshape(*shape, 4)
    if return_steps:
        return img, steps.reshape(shape)
    return img


def _check_args(camera_uniform, width, height, field, shading, dims, max_steps, tile_h, grad):
    """Check the arguments; returns the resolved ``grad``."""
    grad = default_grad() if grad is None else grad
    device = camera_uniform.inv_proj.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"march_field runs on cpu or cuda, not {device}")
    if field not in FIELDS:
        raise ValueError(f"field must be one of {FIELDS}, got {field!r}")
    if shading not in SHADINGS:
        raise ValueError(f"shading must be one of {SHADINGS}, got {shading!r}")
    if grad not in GRADS:
        raise ValueError(f"grad must be one of {GRADS}, got {grad!r}")
    if tile_h not in TILE_HS:
        raise ValueError(f"tile_h must be one of {TILE_HS}, got {tile_h!r}")
    if not isinstance(dims, int) or dims < 1:
        raise ValueError(f"dims must be a positive int, got {dims!r}")
    if not isinstance(max_steps, int) or max_steps < 0:
        raise ValueError(f"max_steps must be a non-negative int, got {max_steps!r}")
    if width < 1 or height < 1:
        raise ValueError(f"bad frame {width}x{height}")
    return grad


def _check_frame(camera_uniform, time):
    """The kernel's inputs: the uniform's ``inv_proj``, a contiguous (4, 4)
    float32 tensor on a CUDA device, and ``time``, a Python number (uploaded)
    or a one-element tensor on that device; returns ``(inv_proj, the time as
    a 0-d float32 tensor there)``."""
    inv = camera_uniform.inv_proj
    if not isinstance(inv, torch.Tensor):
        raise TypeError(f"inv_proj must be a torch.Tensor, got {type(inv)}")
    if inv.dtype != torch.float32:
        raise TypeError(f"inv_proj must be float32, got {inv.dtype}")
    if tuple(inv.shape) != (4, 4) or not inv.is_contiguous():
        raise ValueError(f"inv_proj must be a contiguous (4, 4) tensor, got "
                         f"{tuple(inv.shape)} with strides {inv.stride()}")
    if isinstance(time, torch.Tensor):
        if time.device != inv.device:
            raise ValueError(f"time is on {time.device}, the uniform on {inv.device}")
        if time.numel() != 1:
            raise ValueError(f"time must hold one value, got {tuple(time.shape)}")
    elif not isinstance(time, (int, float, np.integer, np.floating)):
        raise TypeError(f"time must be a number or a tensor, got {type(time)}")
    if inv.device.type != "cuda":
        raise ValueError(f"K7 launches on a CUDA device, not {inv.device}")
    return inv, torch.as_tensor(time, dtype=torch.float32, device=inv.device).reshape(())


def launch(camera_uniform, time, width, height, field, shading, dims, quantize, max_steps,
           grad, tile_h, sphere_clip=True, table=None, lib=None):
    """Launch K7 for the (height, width) frame of ``camera_uniform`` at
    ``time`` on its CUDA device; returns the (H, W, 4) f32 image. Each thread
    makes its pixel's ray, span and step (:func:`field_rays`) and sin(time)
    (:func:`time_vector`) bit for bit from the uniform's ``inv_proj`` and
    the raw time: no ray plane is written. The kernel reads the device's
    :func:`hash_table`; a lattice argument outside it makes the kernel trap,
    which the stream's next synchronization raises. ``table`` is a test
    hook: another table (one cut short, to show the trap) in place of the
    device's. ``lib`` is a K7 library already bound by :func:`bind` (one the
    hot-reload loop rebuilt) in place of this module's :func:`build`."""
    global LAUNCHES_FIELD
    inv, t = _check_frame(camera_uniform, time)
    lib = build() if lib is None else lib
    dev = inv.device
    table = hash_table(dev) if table is None else table
    if table.values.device != dev or table.values.dtype != torch.float32:
        raise ValueError("march_field wants the hash table as f32 on the uniform's device")
    out = torch.empty((height, width, 4), dtype=torch.float32, device=dev)
    err = lib.vk_march_field_frame(
        inv.data_ptr(), t.data_ptr(), height, width,
        float(np.float32(_sphere_r2(field, dims, quantize, sphere_clip))), FIELDS.index(field),
        int(shading == "xor"), int(grad == "analytic"), int(quantize), dims,
        float(np.float32(1.0 / dims)), max_steps, tile_h, *table_args(table), out.data_ptr(),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(lib, err, "march_field")
    LAUNCHES_FIELD += 1
    return out


def count_inline_rays(camera_uniform, width: int, height: int) -> None:
    """On a card, add the rays K7 makes itself for a frame, width x height,
    to the counter ``k7.inline_rays`` of an active ``spans.recording()``.
    The compiled entries call it outside their captured frame, so that
    every replay counts; a CPU frame counts nothing."""
    if camera_uniform.inv_proj.is_cuda:
        count("k7.inline_rays", width * height)


@torch.no_grad()
def render_field(camera_uniform, time=0.0, width: int = 1280, height: int = 720,
                 field: str = "noise", shading: str = "xor", dims: int = 256,
                 quantize: bool = True, max_steps: int = MAX_STEPS_COMPUTE,
                 tile_h: int = DEFAULT_TILE_H, sphere_clip: bool = True,
                 grad: str | None = None, lib=None, fields=None):
    """Render the compute path with the field evaluated inline by K7 — the
    counterpart of ``render_field_pallas``. Returns (height, width, 4) f32
    on the camera uniform's device, matching
    :func:`vokselis_torch.ops.reference.render_compute_inline` (noise/xor)
    or :func:`~vokselis_torch.ops.reference.render_field` (trig/emission,
    ``quantize=False``). ``time`` is a Python float or a 0-d tensor on that
    device (then nothing is uploaded). ``tile_h`` sets the kernel block's
    rows and never changes a pixel. ``grad`` defaults to
    :func:`default_grad`. A CUDA uniform launches the kernel, which makes
    its own rays (``lib``: a rebuilt library in place of this module's, see
    :func:`launch`); a CPU uniform takes the plain twin, :func:`field_rays`
    and :func:`time_vector` marched by :func:`_march_plain` (``fields``: a
    field module in place of :mod:`fields_soa`)."""
    grad = _check_args(camera_uniform, width, height, field, shading, dims, max_steps, tile_h,
                       grad)
    if camera_uniform.inv_proj.device.type == "cpu":
        rays = field_rays(camera_uniform, width, height, field, dims, quantize, sphere_clip)
        return _march_plain(time_vector(time, "cpu"), rays, field, shading, dims, quantize,
                            max_steps, grad, fields=fields_soa if fields is None else fields)
    if fields is not None:
        raise ValueError("a Python field module drives only the plain version (CPU); "
                         "the kernel's fields are csrc/fields.cuh")
    return launch(camera_uniform, time, width, height, field, shading, dims, quantize,
                  max_steps, grad, tile_h, sphere_clip, lib=lib)


@torch.no_grad()
def render_field_plain(camera_uniform, time=0.0, width: int = 1280, height: int = 720,
                       field: str = "noise", shading: str = "xor", dims: int = 256,
                       quantize: bool = True, max_steps: int = MAX_STEPS_COMPUTE,
                       tile_h: int = DEFAULT_TILE_H, sphere_clip: bool = True,
                       grad: str | None = None, return_steps: bool = False):
    """K7's plain torch version on any device, with :func:`render_field`'s
    arguments (``tile_h`` is checked and has no effect): the ray planes of
    :func:`field_rays` and :func:`time_vector`, marched by
    :func:`_march_plain`. With ``return_steps`` also returns the (H, W)
    int32 count of samples each ray took (the work the kernel does for these
    rays)."""
    grad = _check_args(camera_uniform, width, height, field, shading, dims, max_steps, tile_h,
                       grad)
    rays = field_rays(camera_uniform, width, height, field, dims, quantize, sphere_clip)
    tvec = time_vector(time, camera_uniform.inv_proj.device)
    return _march_plain(tvec, rays, field, shading, dims, quantize, max_steps, grad,
                        return_steps)


class FieldRenderer:
    """The compiled field frame: the counterpart of ``render_field_pallas``
    as a ``jax.jit`` entry (``vokselis_tpu/ops/pallas/march_field.py:203-214``). A call takes
    :func:`render_field`'s arguments; on a card it replays one CUDA graph
    (``compiled``) per static key, JAX's static argnames less ``tile_w`` and
    ``interpret`` (``width, height, field, shading, dims, quantize,
    max_steps, tile_h, sphere_clip, grad``, ``grad`` resolved by
    :func:`default_grad`). The camera uniform's three tensors and the time (a
    Python float or a 0-d f32 tensor on the device) are the graph's inputs,
    so a new pose or time replays; each call on a card adds its rays to
    ``k7.inline_rays`` (:func:`count_inline_rays`). On the CPU a call is
    :func:`render_field`, which is also the eager frame the graphs capture.
    A uniform on another type of device than ``device`` raises."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.compiled = CompiledFrame("FieldRenderer")

    def __call__(self, camera_uniform, time=0.0, width: int = 1280, height: int = 720,
                 field: str = "noise", shading: str = "xor", dims: int = 256,
                 quantize: bool = True, max_steps: int = MAX_STEPS_COMPUTE,
                 tile_h: int = DEFAULT_TILE_H, sphere_clip: bool = True,
                 grad: str | None = None):
        if camera_uniform.inv_proj.device.type != self.device.type:
            raise ValueError(f"FieldRenderer({self.device}) got a uniform on "
                             f"{camera_uniform.inv_proj.device}")
        grad = default_grad() if grad is None else grad
        key = (width, height, field, shading, dims, bool(quantize), max_steps, tile_h,
               bool(sphere_clip), grad)

        def fn(u, t):
            return render_field(u, t, width, height, field, shading, dims, quantize, max_steps,
                                tile_h, sphere_clip, grad)

        count_inline_rays(camera_uniform, width, height)
        return self.compiled(key, fn, (camera_uniform, time))
