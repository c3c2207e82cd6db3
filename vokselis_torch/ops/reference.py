"""Plain-torch oracle renderers — exact ports of the reference's march
semantics. :func:`render_bonsai_rays` is also the plain version of the
hand-written bonsai march kernel (:mod:`vokselis_torch.ops.cuda.march_bonsai`).

:func:`render_bonsai` ports shaders/raycast_naive.wgsl fs_main (:84-125):
fragment-raymarch of an R8Unorm voxel grid, trilinear sampling, front-to-back
compositing, quirks preserved:

* ``clamp(vec3(0.4), vec3(0.9), val)`` passes 0.4 as the value and 0.9/val
  as the bounds, i.e. ``min(0.9, val)`` (:105);
* sampling R8Unorm yields alpha 1, so ``pow(a, 2)`` is 1 and the
  background-bleed term (:112) vanishes;
* per-ray ``dt = dt_scale * min(1/(256*|d|))`` — one voxel along the
  dominant axis per step (:97-99);
* position accumulates ``p += dir*dt`` (:118), it is not recomputed from t.

:func:`render_compute_tex` / :func:`render_compute_inline` port
shaders/raycast_compute.wgsl ``render``/``get_col2`` (:60-131): nearest
``textureLoad`` of density + normal volumes, Lambert + directional + bottom
fill lighting, clear-color ambient, initial alpha 0.1, dt effectively always
0.01. The ``_inline`` variant evaluates the procedural field at the
quantized voxel coordinate instead of loading a precomputed texture —
bitwise identical placement of samples. :func:`render_field` is the
framework-defined march of a continuous field sampled at the exact position
with emission shading (the trig benchmark config). These are the oracles of
the field march kernel (:mod:`vokselis_torch.ops.cuda.march_field`), whose
plain version lives beside it.

The reference's per-pixel ``break`` at opacity 0.95 (:115-117) becomes a
``done`` mask over all rays; the loop stops once no ray is active, which
changes no pixel (an inactive ray never becomes active again).
"""

from __future__ import annotations

import functools
import math

import torch

from vokselis_torch.core import geometry
from vokselis_torch.core.colors import (
    bonsai_transfer_fast_soa,
    linear_to_srgb,
    mix,
    smoothstep,
    vertigo,
)
from vokselis_torch.volume import fields
from vokselis_torch.volume.sample import sample_nearest, sample_trilinear_r8

# worst case: box diagonal sqrt(3) at dt = dt_scale/N (dominant axis = 1/sqrt(3)
# ... conservatively |d|max >= 1/sqrt(3) -> dt >= dt_scale/N)
MAX_STEPS_BONSAI = int(math.ceil(math.sqrt(3.0) * 256.0)) + 1  # 444
# [-1,1]^3 diagonal 2*sqrt(3) at dt = 0.01 (see module docstring)
MAX_STEPS_COMPUTE = int(math.ceil(2.0 * math.sqrt(3.0) / 0.01)) + 1  # 348

_CLEAR_COLOR = (0.023, 0.02, 0.02, 0.0)  # raycast_compute.wgsl:119

# steps between host checks for "no ray is active any more"
_ACTIVE_CHECK_EVERY = 16


def _bonsai_transfer(r):
    """raycast_naive.wgsl:101-108 for an R8Unorm sample ``r`` -> (rgb, alpha)."""
    v = torch.clamp(r, max=0.9)  # the clamp-arg-order quirk (:105)
    v = smoothstep(0.10, 1.2, v)  # (:106)
    return vertigo(v), v


@torch.no_grad()
def render_bonsai(
    vol,
    camera_uniform,
    width: int = 1280,
    height: int = 720,
    max_steps: int = MAX_STEPS_BONSAI,
    dt_scale: float = 1.0,
    srgb: bool = True,
):
    """Fragment-path bonsai raymarch (raycast_naive.wgsl fs_main).

    ``vol``: (D, H, W) uint8 or float in [0,1], on the camera uniform's
    device. Returns (height, width, 4) f32.
    Pixels whose ray misses the box return opaque black — identical to the
    pass clear color (wgpu::Color::BLACK, examples/bonsai/main.rs:40), so no
    rasterization-coverage emulation is needed.
    """
    eye, dirs = geometry.rays_fragment(camera_uniform, width, height)
    return render_bonsai_rays(vol, eye, dirs, max_steps=max_steps,
                              dt_scale=dt_scale, srgb=srgb)


@torch.no_grad()
def render_bonsai_rays(
    vol,
    eye,
    dirs,
    max_steps: int = MAX_STEPS_BONSAI,
    dt_scale: float = 1.0,
    srgb: bool = True,
    return_steps: bool = False,
    fast_transfer: bool = False,
):
    """March an arbitrary (H, W, 3) ray set with the bonsai semantics —
    the single implementation shared by :func:`render_bonsai` and the
    march kernels' wrappers on CPU tensors. With ``return_steps`` also
    returns the (H, W) int32 count of samples each ray took (the work the
    march kernel does for these rays). ``fast_transfer`` takes the vertigo
    palette's polynomial form (``colors.bonsai_transfer_fast_soa``, <=
    1.4e-6 per channel, alpha exact), as the hybrid's re-march does."""
    height, width = dirs.shape[:2]
    npix = width * height
    d = dirs.reshape(npix, 3)
    eye_b = eye.expand(npix, 3)

    t0, t1 = geometry.intersect_box_unit(eye_b, d)
    hit = t0 <= t1
    t_start = torch.clamp(t0, min=0.0)

    n = float(vol.shape[0])  # shader hardcodes 256 (:97)
    dt_vec = 1.0 / (n * torch.abs(d))
    dt = dt_scale * torch.amin(dt_vec, dim=-1)

    p = eye_b + t_start[:, None] * d
    rgb = torch.zeros((npix, 3), dtype=torch.float32, device=d.device)
    a = torch.zeros((npix,), dtype=torch.float32, device=d.device)
    t = t_start
    steps = torch.zeros((npix,), dtype=torch.int32, device=d.device) if return_steps else None
    for i in range(max_steps):
        active = hit & (t < t1) & (a < 0.95)
        if i % _ACTIVE_CHECK_EVERY == 0 and not bool(active.any()):
            break
        if return_steps:
            steps += active
        r = sample_trilinear_r8(vol, p)
        if fast_transfer:
            c_a, cr, cg, cb = bonsai_transfer_fast_soa(r)
            c_rgb = torch.stack([cr, cg, cb], dim=-1)
        else:
            c_rgb, c_a = _bonsai_transfer(r)
        # front-to-back under-compositing (:110-114); the background-bleed
        # term is identically zero for R8Unorm (val_alpha == 1)
        new_rgb = rgb + (1.0 - a)[:, None] * c_a[:, None] * c_rgb
        new_a = a + (1.0 - a) * c_a
        rgb = torch.where(active[:, None], new_rgb, rgb)
        a = torch.where(active, new_a, a)
        p = torch.where(active[:, None], p + d * dt[:, None], p)
        t = torch.where(active, t + dt, t)

    rgb = torch.where(hit[:, None], rgb, 0.0)
    if srgb:
        rgb = linear_to_srgb(rgb)
    out = torch.cat([rgb, torch.ones((npix, 1), dtype=torch.float32,
                                     device=d.device)], dim=-1)
    out = out.reshape(height, width, 4)
    if return_steps:
        return out, steps.reshape(height, width)
    return out


@functools.lru_cache(maxsize=None)
def _shade_consts(device):
    """get_col2's constant vectors (raycast_compute.wgsl:64-86), made once
    per device in float32 as the JAX oracle makes them."""

    def vec(*v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    l_dir = vec(-2.0, -2.0, -1.0)
    mask_dir = vec(1.0, 1.0, -1.0)
    return {
        "light": vec(0.0, -1.0, 0.0),
        "l_dir": l_dir / torch.sqrt(torch.sum(l_dir * l_dir)),
        "tint": 3.0 * vec(1.0, 0.1, 0.13),
        "mask_dir": mask_dir / torch.sqrt(torch.sum(mask_dir * mask_dir)),
        "blue": vec(0.0, 0.0, 0.6),
        "clear_rgb": vec(*_CLEAR_COLOR[:3]),
    }


def _compute_shade(p, vol_rgba, normal_rgba, color_rgb, color_a):
    """One step of get_col2's transfer + lighting + composite with the clear
    colour's ambient term (raycast_compute.wgsl:69-95). Returns (new_rgb,
    new_a)."""
    k = _shade_consts(p.device)
    normal = normal_rgba[..., :3]
    shade = torch.clamp(torch.sum(k["light"] * normal, dim=-1), min=0.0)[..., None]
    shade = shade.expand(normal.shape)

    vol_color = vol_rgba[..., :3]
    vol_alpha = smoothstep(0.0, 0.7, torch.pow(vol_rgba[..., 3], 3.0))

    directional = k["tint"] * torch.clamp(
        torch.sum(normal * k["l_dir"], dim=-1), min=0.0)[..., None]
    directional = directional * smoothstep(
        0.3, 1.5, torch.sum(p * k["mask_dir"], dim=-1))[..., None]
    vol_color = vol_color + directional

    bottom_light = 0.9 * torch.clamp(0.5 - 0.5 * normal[..., 1], 0.0, 1.0)
    shade = mix(shade, bottom_light[..., None] * k["blue"], 0.2)

    clear_a = _CLEAR_COLOR[3]
    va = vol_alpha[..., None]
    new_rgb = color_rgb + (1.0 - color_a)[..., None] * va * vol_color * shade
    new_rgb = new_rgb + k["clear_rgb"] * clear_a * (1.0 - va)
    new_a = color_a + (1.0 - color_a) * vol_alpha * (1.0 - clear_a)
    return new_rgb, new_a


def _compute_rays(camera_uniform, width, height, block_size, offset=(0.0, 0.0)):
    """Flattened compute-path rays with the slab test and per-ray dt
    (raycast_compute.wgsl:60-68, 99-122): (eye, d, hit, t_start, t1, dt)."""
    eyes, dirs = geometry.rays_compute(camera_uniform, width, height, offset[0], offset[1])
    npix = width * height
    d = dirs.reshape(npix, 3)
    eye = eyes.reshape(npix, 3)
    t0, t1 = geometry.intersect_box_sym(eye, d)
    hit = t0 < t1  # strict: the reference tests t_hit.x < t_hit.y (:122)
    t_start = torch.clamp(t0, min=0.0)
    dt_vec = 1.0 / (block_size * torch.abs(d))
    dt = torch.clamp(torch.amin(dt_vec, dim=-1), min=0.01)  # (:65-68)
    return eye, d, hit, t_start, t1, dt


def _march_compute(camera_uniform, width, height, max_steps, block_size, step, offset):
    """The compute path's loop (render/get_col2): ``step(p, rgb, a)`` returns
    the composited (new_rgb, new_a) at world positions p (npix, 3)."""
    eye, d, hit, t, t1, dt = _compute_rays(camera_uniform, width, height, block_size, offset)
    npix = width * height
    clear_rgb = _shade_consts(d.device)["clear_rgb"]
    # get_col2 initial color = (clear.rgb, 0.1) (:61)
    rgb = clear_rgb.expand(npix, 3)
    a = torch.full((npix,), 0.1, dtype=torch.float32, device=d.device)
    for i in range(max_steps):
        active = hit & (t < t1) & (a < 0.95)
        if i % _ACTIVE_CHECK_EVERY == 0 and not bool(active.any()):
            break
        p = eye + t[:, None] * d
        new_rgb, new_a = step(p, rgb, a)
        rgb = torch.where(active[:, None], new_rgb, rgb)
        a = torch.where(active, new_a, a)
        t = torch.where(active, t + dt, t)
    # render(): hit -> (marched rgb, 1); miss -> (clear rgb, 1) (:121-128)
    rgb = torch.where(hit[:, None], rgb, clear_rgb)
    out = torch.cat([rgb, torch.ones((npix, 1), dtype=torch.float32, device=d.device)],
                    dim=-1)
    return out.reshape(height, width, 4)


def _render_compute_core(lookup, camera_uniform, width, height, max_steps,
                         block_size: float = 256.0, offset=(0.0, 0.0)):
    """Shared body of the compute path (raycast_compute.wgsl render/get_col2).
    ``lookup(p)`` must return (vol_rgba, normal_rgba) for world positions p
    (..., 3) in [-1,1]^3."""

    def step(p, rgb, a):
        vol_rgba, normal_rgba = lookup(p)
        return _compute_shade(p, vol_rgba, normal_rgba, rgb, a)

    return _march_compute(camera_uniform, width, height, max_steps, block_size, step, offset)


@torch.no_grad()
def render_compute_tex(density_tex, normal_tex, camera_uniform, width: int = 1280,
                       height: int = 720, max_steps: int = MAX_STEPS_COMPUTE):
    """Compute path with precomputed (D, H, W, 4) textures — the reference's
    exact structure (textureLoad at ivec3((p+1)*dims/2), :70-72)."""
    dims = density_tex.shape[0]

    def lookup(p):
        samp = ((p + 1.0) * (dims / 2.0)).to(torch.int32)
        return (sample_nearest(density_tex, samp).to(torch.float32),
                sample_nearest(normal_tex, samp).to(torch.float32))

    return _render_compute_core(lookup, camera_uniform, width, height, max_steps, float(dims))


@torch.no_grad()
def render_compute_inline(camera_uniform, time=0.0, width: int = 1280, height: int = 720,
                          max_steps: int = MAX_STEPS_COMPUTE, dims: int = 256,
                          field=fields.noise_volume):
    """Compute path with the procedural field evaluated inline at the
    quantized voxel coordinate — samples land exactly where the texture
    variant's do, with no precomputation and no gather."""
    time = torch.as_tensor(time, dtype=torch.float32, device=camera_uniform.inv_proj.device)

    def lookup(p):
        samp = ((p + 1.0) * (dims / 2.0)).to(torch.int32)
        g = torch.clamp(samp, 0, dims - 1).to(torch.float32)
        coord = (g - dims / 2.0) / dims
        vol = field(coord, time)
        density = torch.cat([vol[..., :3] / 2.0, vol[..., 3:4]], dim=-1)
        nrm = fields.gradient(coord, time, 1e-4)
        normal = torch.cat([nrm, torch.sqrt(torch.sum(nrm * nrm, dim=-1, keepdim=True))],
                           dim=-1)
        return density, normal

    return _render_compute_core(lookup, camera_uniform, width, height, max_steps, float(dims))


@torch.no_grad()
def render_field(camera_uniform, time=0.0, field=fields.trig_field, width: int = 512,
                 height: int = 512, max_steps: int = MAX_STEPS_COMPUTE,
                 block_size: float = 256.0):
    """Framework-defined: compute-path march with a continuous field sampled
    at the exact position (no voxel quantization) and emission-style shading
    (no normals). Used by the trig benchmark config (BASELINE.json config 1)."""
    time = torch.as_tensor(time, dtype=torch.float32, device=camera_uniform.inv_proj.device)

    def step(p, rgb, a):
        v = field(p, time)
        vol_alpha = smoothstep(0.0, 0.7, torch.pow(v[..., 3], 3.0))
        va = vol_alpha[..., None]
        return rgb + (1.0 - a)[..., None] * va * v[..., :3], a + (1.0 - a) * vol_alpha

    return _march_compute(camera_uniform, width, height, max_steps, block_size, step,
                          (0.0, 0.0))
