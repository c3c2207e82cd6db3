"""Procedural density fields (plain float32 torch), AoS form.

Replicates shaders/xor.wgsl verbatim: ``hash`` (:3-5), value ``noise``
(:7-22), 3-octave ``fbm`` (:24-33), the animated ``noise_volume`` field
(:55-61), the bitwise ``xor`` field (:46-53, unused by the reference demo but
kept for parity), and the one-sided-difference ``gradient`` normals (:63-67).

All functions take ``coord`` of shape (..., 3) and ``time`` as a Python
float or a 0-d tensor on ``coord``'s device; they are the field callables of
the oracle renderers in :mod:`vokselis_torch.ops.reference`. The march and
volume-generation kernels evaluate the structure-of-arrays twins in
:mod:`vokselis_torch.volume.fields_soa`.

``trig_field`` is framework-defined (no reference analog): BASELINE.json
config 1 calls for a "procedural trig density field" benchmark; the reference
trig demo is a rasterized triangle (examples/trig.rs), reproduced separately
in :mod:`vokselis_torch.models.trig`.
"""

from __future__ import annotations

import torch

from vokselis_torch.core.colors import fract, mix, smoothstep


def _time(time, like):
    return torch.as_tensor(time, dtype=torch.float32, device=like.device)


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def hash_(h):
    """fract(sin(h) * 43758.5453123) — shaders/xor.wgsl:18-20."""
    return fract(torch.sin(h) * 43758.5453123)


def noise(x):
    """Value noise on a 157/113 lattice — shaders/xor.wgsl:22-35.

    ``x``: (..., 3); returns (...,).
    """
    p = torch.floor(x)
    f = fract(x)
    f = f * f * (3.0 - 2.0 * f)
    n = p[..., 0] + p[..., 1] * 157.0 + 113.0 * p[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return mix(
        mix(
            mix(hash_(n + 0.0), hash_(n + 1.0), fx),
            mix(hash_(n + 157.0), hash_(n + 158.0), fx),
            fy,
        ),
        mix(
            mix(hash_(n + 113.0), hash_(n + 114.0), fx),
            mix(hash_(n + 270.0), hash_(n + 271.0), fx),
            fy,
        ),
        fz,
    )


def fbm(p):
    """3-octave fbm — shaders/xor.wgsl:37-44."""
    f = 0.5000 * noise(p)
    p = p * 2.01
    f = f + 0.2500 * noise(p)
    p = p * 2.02
    f = f + 0.1250 * noise(p)
    return f


def _animated_pos(coord, time):
    """shaders/xor.wgsl:57 — pos = (coord + (1, 0.1*sin t, 21)) * 32."""
    shift = torch.stack(
        [torch.ones_like(time), torch.sin(time * 1.0) * 0.1, torch.full_like(time, 21.0)],
        dim=-1,
    )
    return (coord + shift) * 32.0


def xor_field(coord, time=0.0):
    """The bitwise x&y&z field — shaders/xor.wgsl:46-53. Returns (..., 4)."""
    pos = _animated_pos(coord, _time(time, coord))
    res = 25.0
    q = (pos * res).to(torch.int32)
    val = (q[..., 0] & q[..., 1] & q[..., 2]).to(torch.float32) / res
    alpha = val * smoothstep(0.7, 0.0, _norm(coord))
    return torch.stack([val, val, val, alpha], dim=-1)


def noise_volume(coord, time=0.0):
    """The fbm field actually rendered by the xor demo — shaders/xor.wgsl:55-61.

    Returns (..., 4) = (val, val, val, alpha)."""
    pos = _animated_pos(coord, _time(time, coord))
    val = fbm(pos)
    alpha = val * smoothstep(0.5, 0.25, _norm(coord))
    return torch.stack([val, val, val, alpha], dim=-1)


def gradient(coord, time=0.0, eps: float = 1e-4):
    """One-sided difference normal of ``noise_volume``'s alpha —
    shaders/xor.wgsl:63-67 (the point minus the backward-offset points,
    normalized)."""
    a0 = noise_volume(coord, time)[..., 3]
    offs = torch.eye(3, dtype=torch.float32, device=coord.device) * eps
    ax = noise_volume(coord - offs[0], time)[..., 3]
    ay = noise_volume(coord - offs[1], time)[..., 3]
    az = noise_volume(coord - offs[2], time)[..., 3]
    g = torch.stack([a0 - ax, a0 - ay, a0 - az], dim=-1)
    n = _norm(g)[..., None]
    return g / torch.clamp(n, min=1e-20)


def generate_xor_volumes(dims: int = 256, time=0.0, device="cpu"):
    """The reference's one-time volume-generation dispatch
    (shaders/xor.wgsl:69-78 via examples/xor/main.rs:135-146): fills two
    (D, H, W, 4) float32 tensors — the density texture ``(vol.rgb/2, vol.a)``
    and the normal texture ``(normal, |normal|)``. The reference stores
    Rgba16Float textures; float32 is kept for accumulation parity."""
    g = torch.arange(dims, dtype=torch.float32, device=device)
    zz, yy, xx = torch.meshgrid(g, g, g, indexing="ij")
    gid = torch.stack([xx, yy, zz], dim=-1)  # texel coord (x, y, z)
    coord = (gid - dims / 2.0) / dims
    vol = noise_volume(coord, time)
    nrm = gradient(coord, time, 1e-4)
    density_tex = torch.cat([vol[..., :3] / 2.0, vol[..., 3:4]], dim=-1)
    normal_tex = torch.cat([nrm, _norm(nrm)[..., None]], dim=-1)
    return density_tex, normal_tex


def trig_field(coord, time=0.0):
    """Framework-defined trigonometric density field (BASELINE.json config 1).

    A smooth product-of-sines density windowed to the [-1,1] box — the same
    march/composite path as ``noise_volume`` with a cheaper, fully analytic
    integrand. Returns (..., 4).
    """
    time = _time(time, coord)
    x, y, z = coord[..., 0], coord[..., 1], coord[..., 2]
    val = 0.5 + 0.5 * torch.sin(8.0 * x + time) * torch.sin(8.0 * y + 0.5 * time) * torch.sin(
        8.0 * z
    )
    alpha = val * smoothstep(0.9, 0.2, _norm(coord))
    return torch.stack([val, val, val, alpha], dim=-1)
