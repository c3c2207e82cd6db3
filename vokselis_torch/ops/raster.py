"""Tiny triangle rasterizer in plain torch — the trig demo's render path.

The reference's trig demo draws one camera-transformed triangle with a
solid-ish fragment color (shaders/shader_with_camera.wgsl:26-45,
examples/trig.rs). A 3-vertex draw is an elementwise coverage test: clip ->
NDC -> viewport, then edge functions at pixel centers (the wgpu default
PrimitiveState: no culling, CCW front face — coverage here is
winding-agnostic like a cull_mode=None draw). There is no kernel here.

Vertices may be (3,) tensors or sequences of Python floats, and colours
(4,) tensors or sequences; Python numbers are never uploaded to the device
(constant tensors are filled there).
"""

from __future__ import annotations

import torch

from vokselis_torch.core.geometry import mat4_apply, pixel_centers


def _rgba(c, device):
    if isinstance(c, torch.Tensor):
        return c.to(device=device, dtype=torch.float32)
    return torch.stack([torch.full((), float(x), dtype=torch.float32, device=device)
                        for x in c])


@torch.no_grad()
def rasterize_triangle(proj_view, v0, v1, v2, color, width: int, height: int,
                       background=(0.0, 0.0, 0.0, 1.0)):
    """Rasterize one triangle over a (height, width, 4) framebuffer.

    ``v*``: (3,) object-space vertices; ``color``: (4,); transforms by
    ``proj_view`` like vs_main (shader_with_camera.wgsl:26-40).
    """
    device = proj_view.device
    verts = []
    for v in (v0, v1, v2):
        x, y, z, w = mat4_apply(proj_view, v[0], v[1], v[2])
        # viewport transform at pixel centers (wgpu NDC: y up)
        sx = (x / w + 1.0) * 0.5 * width
        sy = (1.0 - y / w) * 0.5 * height
        verts.append((sx, sy, w))
    px, py = pixel_centers(width, height, device)

    def edge(ax, ay, bx, by):
        return (bx - ax) * (py - ay) - (by - ay) * (px - ax)

    e01 = edge(verts[0][0], verts[0][1], verts[1][0], verts[1][1])
    e12 = edge(verts[1][0], verts[1][1], verts[2][0], verts[2][1])
    e20 = edge(verts[2][0], verts[2][1], verts[0][0], verts[0][1])
    inside = ((e01 >= 0) & (e12 >= 0) & (e20 >= 0)) | ((e01 <= 0) & (e12 <= 0) & (e20 <= 0))
    # reject triangles behind the camera (all w <= 0)
    visible = (verts[0][2] > 0) & (verts[1][2] > 0) & (verts[2][2] > 0)
    inside = inside & visible
    return torch.where(inside[..., None], _rgba(color, device), _rgba(background, device))


# --- unreferenced reference leftovers, kept for inventory parity -----------

def _identity(device):
    return torch.eye(4, dtype=torch.float32, device=device)


@torch.no_grad()
def cameraless_triangle(time, width: int, height: int, device="cpu"):
    """shaders/shader.wgsl:19-36 — clip-space triangle, no camera; FS color
    (fract(time), 0, 1, 1)-style. Not used by any demo (like the original)."""
    time = torch.as_tensor(time, dtype=torch.float32, device=device)
    t = time - torch.floor(time)
    color = torch.stack([t, torch.zeros_like(t), torch.ones_like(t), torch.ones_like(t)])
    return rasterize_triangle(_identity(device), (-0.5, -0.5, 0.0), (0.5, -0.5, 0.0),
                              (0.0, 0.5, 0.0), color, width, height)


@torch.no_grad()
def magenta_mini_triangle(width: int, height: int, device="cpu"):
    """shaders/shader_sec.wgsl:6-22 — small magenta triangle. Unused."""
    return rasterize_triangle(_identity(device), (-0.25, -0.25, 0.0), (0.25, -0.25, 0.0),
                              (0.0, 0.25, 0.0), (1.0, 0.0, 1.0, 1.0), width, height)


@torch.no_grad()
def fullscreen_quad(width: int, height: int, color=(1.0, 1.0, 1.0, 1.0), device="cpu"):
    """shaders/quad.wgsl:6-14 — fullscreen white quad. Unused."""
    return _rgba(color, torch.device(device)).expand(height, width, 4)
