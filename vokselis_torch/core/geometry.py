"""Ray generation and ray-AABB intersection (plain float32 torch, any shape).

Reference sources:
- slab test vs [0,1]^3: shaders/raycast_naive.wgsl:50-61
- slab test vs [-1,1]^3: shaders/raycast_compute.wgsl:42-53
- fragment-path ray gen (perspective-correct interpolation of cube-surface
  position minus eye — equivalent to unprojecting through pixel centers):
  shaders/raycast_naive.wgsl:40-48
- compute-path ray gen with the reference's ``screen.y *= -aspect`` quirk:
  shaders/raycast_compute.wgsl:99-117

Tensors are created on the device of the camera uniform they derive from.
"""

from __future__ import annotations

import torch


def intersect_box(orig, direction, box_min, box_max):
    """Slab test. Returns (t0, t1); hit iff t0 <= t1 (reference tests t0 > t1
    as the miss condition). ``orig``/``direction``: (..., 3)."""
    inv_dir = 1.0 / direction
    tmin_tmp = (box_min - orig) * inv_dir
    tmax_tmp = (box_max - orig) * inv_dir
    tmin = torch.minimum(tmin_tmp, tmax_tmp)
    tmax = torch.maximum(tmin_tmp, tmax_tmp)
    t0 = torch.amax(tmin, dim=-1)
    t1 = torch.amin(tmax, dim=-1)
    return t0, t1


def intersect_box_unit(orig, direction):
    """[0,1]^3 box (bonsai path, shaders/raycast_naive.wgsl:50-61)."""
    return intersect_box(orig, direction, 0.0, 1.0)


def intersect_box_sym(orig, direction):
    """[-1,1]^3 box (compute path, shaders/raycast_compute.wgsl:42-53)."""
    return intersect_box(orig, direction, -1.0, 1.0)


def pixel_centers(width: int, height: int, device, dtype=torch.float32):
    """Framebuffer-space coordinates of pixel centers: (H, W) each of x, y."""
    xs = (torch.arange(width, dtype=dtype, device=device) + 0.5)[None, :]
    ys = (torch.arange(height, dtype=dtype, device=device) + 0.5)[:, None]
    return xs.expand(height, width), ys.expand(height, width)


def mat4_apply(m, x, y, z, w=1.0):
    """Apply a row-major 4x4 to a homogeneous point with explicit f32
    arithmetic, never a matmul: a reduced-precision product (TF32 on the
    card) destroys the tiny clip-space w of far-plane points.

    ``m`` (4, 4), or (V, 4, 4) for a batch of views, whose entries then
    broadcast as (V, 1, 1) against (H, W) planes: each view's values are
    bitwise those of its own (4, 4) matrix. Returns four tensors (X, Y, Z,
    W) broadcast over the inputs.
    """
    if m.ndim == 3:
        m = m.permute(1, 2, 0)[..., None, None]
    return [m[i, 0] * x + m[i, 1] * y + m[i, 2] * z + m[i, 3] * w
            for i in range(4)]


def unproject(inv_proj, ndc_x, ndc_y, ndc_z: float):
    """Apply the inverse proj*view matrix to an NDC point, divide by w.

    ``ndc_*`` broadcastable tensors; returns (..., 3) world-space points.
    """
    z = torch.tensor(ndc_z, dtype=torch.float32, device=inv_proj.device)
    x, y, z, w = mat4_apply(inv_proj, ndc_x, ndc_y, z)
    return torch.stack([x / w, y / w, z / w], dim=-1)


def _ndc(width: int, height: int, device):
    px, py = pixel_centers(width, height, device)
    return 2.0 * px / width - 1.0, 1.0 - 2.0 * py / height


def rays_fragment(camera_uniform, width: int, height: int):
    """Bonsai-style rays: one per pixel center, through the camera.

    The reference rasterizes the unit cube and interpolates
    ``ray_dir = surface_pos - eye`` perspective-correct across the fragment
    (shaders/raycast_naive.wgsl:40-48), which is exactly the ray through the
    pixel center. wgpu NDC: x right in [-1,1], y up in [-1,1]; pixel (i, j)
    center maps to ndc (2*(i+.5)/W - 1, 1 - 2*(j+.5)/H).

    Returns (eye (3,), dirs (H, W, 3) normalized).
    """
    inv = camera_uniform.inv_proj
    ndc_x, ndc_y = _ndc(width, height, inv.device)
    eye = camera_uniform.view_position[:3]
    # any point along the view ray: unproject at two depths, direction is
    # their difference (projective depths 0 = near, 1 = far in wgpu).
    p_near = unproject(inv, ndc_x, ndc_y, 0.0)
    p_far = unproject(inv, ndc_x, ndc_y, 1.0)
    d = p_far - p_near
    d = d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    return eye, d


def rays_fragment_soa(camera_uniform, width: int, height: int):
    """SoA variant of :func:`rays_fragment` — the form the march kernel
    reads: returns (eye (3,), (dx, dy, dz) each (H, W)); for a batched
    uniform (the JAX package's ``vmap`` of this function) eye (V, 3) and
    each plane (V, H, W), every view bitwise its own uniform's rays. The
    depths are Python floats, so no scalar is uploaded to the device."""
    inv = camera_uniform.inv_proj
    ndc_x, ndc_y = _ndc(width, height, inv.device)
    nx, ny, nz, nw = mat4_apply(inv, ndc_x, ndc_y, 0.0)
    fx, fy, fz, fw = mat4_apply(inv, ndc_x, ndc_y, 1.0)
    dx = fx / fw - nx / nw
    dy = fy / fw - ny / nw
    dz = fz / fw - nz / nw
    inv_len = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    # a batch's (V, 4) view positions sliced to (V, 3) are strided: the
    # kernel reads eye v at 3 v
    eye = camera_uniform.view_position[..., :3].contiguous()
    return eye, (dx * inv_len, dy * inv_len, dz * inv_len)


def intersect_box_soa(ex, ey, ez, dx, dy, dz, box_min: float, box_max: float):
    """SoA slab test; returns (t0, t1) tensors."""
    ix, iy, iz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    ax0, ax1 = (box_min - ex) * ix, (box_max - ex) * ix
    ay0, ay1 = (box_min - ey) * iy, (box_max - ey) * iy
    az0, az1 = (box_min - ez) * iz, (box_max - ez) * iz
    t0 = torch.maximum(
        torch.minimum(ax0, ax1),
        torch.maximum(torch.minimum(ay0, ay1), torch.minimum(az0, az1)),
    )
    t1 = torch.minimum(
        torch.maximum(ax0, ax1),
        torch.minimum(torch.maximum(ay0, ay1), torch.maximum(az0, az1)),
    )
    return t0, t1


def center_ray_dir(camera_uniform, width: int, height: int):
    """Normalized fragment-path ray direction through the CENTER pixel
    (row H//2, col W//2) — the single ray the fast renderer's dominant-axis
    pick needs, without materializing the (H, W) frame. The NDC constants
    are Python floats (rounded to float32 where they meet the matrix), so
    no scalar is uploaded to the device. Returns a (3,) f32 vector."""
    ndc_x = 2.0 * ((width // 2) + 0.5) / width - 1.0
    ndc_y = 1.0 - 2.0 * ((height // 2) + 0.5) / height
    inv = camera_uniform.inv_proj
    nx, ny, nz, nw = mat4_apply(inv, ndc_x, ndc_y, 0.0)
    fx, fy, fz, fw = mat4_apply(inv, ndc_x, ndc_y, 1.0)
    dx = fx / fw - nx / nw
    dy = fy / fw - ny / nw
    dz = fz / fw - nz / nw
    inv_len = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    return torch.stack([dx * inv_len, dy * inv_len, dz * inv_len])


def _screen_compute(width: int, height: int, device, offset_x=0.0, offset_y=0.0):
    """Compute-path screen coordinates (raycast_compute.wgsl:99-104): the
    reference uses the integer gid + offset, not the pixel center, and
    scales y by -aspect (aspect = H/W)."""
    px, py = pixel_centers(width, height, device)
    coord_x = px - 0.5 + offset_x
    coord_y = py - 0.5 + offset_y
    aspect_ratio = float(height) / float(width)
    sx = 2.0 * coord_x / width - 1.0
    sy = (2.0 * coord_y / height - 1.0) * (-aspect_ratio)
    return sx, sy


def rays_compute(camera_uniform, width: int, height: int, offset_x=0.0, offset_y=0.0):
    """Compute-path rays, replicating shaders/raycast_compute.wgsl:99-117
    verbatim, including the ``screen.y *= -aspect_ratio`` quirk
    (aspect_ratio = H/W) and the screen-point/tangent-point unprojection.

    Returns (eyes (H, W, 3), dirs (H, W, 3)); note the compute path derives a
    per-pixel eye from unprojection (they all coincide up to fp error).
    """
    inv = camera_uniform.inv_proj
    sx, sy = _screen_compute(width, height, inv.device, offset_x, offset_y)
    eye = unproject(inv, sx, sy, 0.0)
    tang = unproject(inv, sx, sy, 1.0)
    d = tang - eye
    d = d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    return eye, d


def rays_compute_soa(camera_uniform, width: int, height: int, offset_x=0.0, offset_y=0.0):
    """SoA variant of :func:`rays_compute` — the form the field march kernel
    reads: returns ((ex, ey, ez), (dx, dy, dz)), each component (H, W). The
    depths are Python floats, so no scalar is uploaded to the device."""
    inv = camera_uniform.inv_proj
    sx, sy = _screen_compute(width, height, inv.device, offset_x, offset_y)
    nx, ny, nz, nw = mat4_apply(inv, sx, sy, 0.0)
    fx, fy, fz, fw = mat4_apply(inv, sx, sy, 1.0)
    ex, ey, ez = nx / nw, ny / nw, nz / nw
    dx = fx / fw - ex
    dy = fy / fw - ey
    dz = fz / fw - ez
    inv_len = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    return (ex, ey, ez), (dx * inv_len, dy * inv_len, dz * inv_len)
