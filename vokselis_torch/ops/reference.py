"""Plain-torch oracle renderer — the exact port of the reference's bonsai
march semantics, and the plain version of the hand-written march kernel
(:mod:`vokselis_torch.ops.cuda.march_bonsai`).

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

The reference's per-pixel ``break`` at opacity 0.95 (:115-117) becomes a
``done`` mask over all rays; the loop stops once no ray is active, which
changes no pixel (an inactive ray never becomes active again).
"""

from __future__ import annotations

import math

import torch

from vokselis_torch.core import geometry
from vokselis_torch.core.colors import (
    bonsai_transfer_fast_soa,
    linear_to_srgb,
    smoothstep,
    vertigo,
)
from vokselis_torch.volume.sample import sample_trilinear_r8

# worst case: box diagonal sqrt(3) at dt = dt_scale/N (dominant axis = 1/sqrt(3)
# ... conservatively |d|max >= 1/sqrt(3) -> dt >= dt_scale/N)
MAX_STEPS_BONSAI = int(math.ceil(math.sqrt(3.0) * 256.0)) + 1  # 444

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
