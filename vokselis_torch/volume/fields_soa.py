"""Structure-of-arrays procedural fields (plain float32 torch).

The same math as :mod:`vokselis_torch.volume.fields` (shaders/xor.wgsl) over
separate component tensors instead of a trailing (..., 3) axis. These are
the plain versions of the field kernels: ``csrc/fields.cuh`` repeats every
function here operation for operation, in the same order, so the kernels
(K7 the field march, K9 and K8 the volume generators) can be held to them
bitwise on the card. A change here must be made there too.

Arguments are tensors on one device; ``sin_t`` / ``time`` may be a 0-d
tensor on that device (the kernels read it from device memory) or a Python
float.
"""

from __future__ import annotations

import torch

from vokselis_torch.core.colors import fract, mix, smoothstep


def hash_(h):
    """fract(sin(h) * 43758.5453123) — shaders/xor.wgsl:18-20."""
    return fract(torch.sin(h) * 43758.5453123)


def noise(x, y, z):
    """Value noise (shaders/xor.wgsl:22-35), SoA."""
    px, py, pz = torch.floor(x), torch.floor(y), torch.floor(z)
    fx, fy, fz = x - px, y - py, z - pz
    fx = fx * fx * (3.0 - 2.0 * fx)
    fy = fy * fy * (3.0 - 2.0 * fy)
    fz = fz * fz * (3.0 - 2.0 * fz)
    n = px + py * 157.0 + 113.0 * pz
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


def fbm(x, y, z):
    f = 0.5000 * noise(x, y, z)
    x, y, z = x * 2.01, y * 2.01, z * 2.01
    f = f + 0.2500 * noise(x, y, z)
    x, y, z = x * 2.02, y * 2.02, z * 2.02
    f = f + 0.1250 * noise(x, y, z)
    return f


def _lattice(cx, cy, cz, sin_t):
    """The fbm field's lattice coordinates (shaders/xor.wgsl:57)."""
    return (cx + 1.0) * 32.0, (cy + sin_t * 0.1) * 32.0, (cz + 21.0) * 32.0


def _radius(cx, cy, cz):
    return torch.sqrt(cx * cx + cy * cy + cz * cz)


def noise_volume(cx, cy, cz, sin_t):
    """fbm field (shaders/xor.wgsl:55-61). ``sin_t`` is sin(time) precomputed
    (constant across march steps). Returns (val, alpha)."""
    val = fbm(*_lattice(cx, cy, cz, sin_t))
    alpha = val * smoothstep(0.5, 0.25, _radius(cx, cy, cz))
    return val, alpha


def noise_volume_alpha(cx, cy, cz, sin_t):
    """Alpha channel only (used by the gradient)."""
    return noise_volume(cx, cy, cz, sin_t)[1]


def _normalize(gx, gy, gz):
    n = torch.sqrt(gx * gx + gy * gy + gz * gz)
    inv = 1.0 / torch.clamp(n, min=1e-20)
    return gx * inv, gy * inv, gz * inv


def gradient(cx, cy, cz, sin_t, eps: float = 1e-4):
    """One-sided difference normal of the alpha (shaders/xor.wgsl:63-67)."""
    a0 = noise_volume_alpha(cx, cy, cz, sin_t)
    gx = a0 - noise_volume_alpha(cx - eps, cy, cz, sin_t)
    gy = a0 - noise_volume_alpha(cx, cy - eps, cz, sin_t)
    gz = a0 - noise_volume_alpha(cx, cy, cz - eps, sin_t)
    return _normalize(gx, gy, gz)


# ---- fused density+gradient (hash-sharing) --------------------------------
#
# The raymarch needs the field at p AND at three eps-offset points per step.
# The lattice hash argument n = px + 157*py + 113*pz is built from floor-valued
# float32s far below 2^24, so it is exact integer arithmetic: an offset
# point's lattice differs from the base only where its floor crossed (by
# exactly 1), and its corner hashes then coincide bitwise with base corners.
# Each offset needs only the 4 corners on its own side plus 4 selects: 60
# sins per step instead of 120, bitwise the same results.


def _smooth(f):
    return f * f * (3.0 - 2.0 * f)


def _mix8(h0, h1, h2, h3, h4, h5, h6, h7, fx, fy, fz):
    return mix(
        mix(mix(h0, h1, fx), mix(h2, h3, fx), fy),
        mix(mix(h4, h5, fx), mix(h6, h7, fx), fy),
        fz,
    )


_OCTAVES = ((0.5000, 2.01), (0.2500, 2.02), (0.1250, None))
_CORNERS = (0.0, 1.0, 157.0, 158.0, 113.0, 114.0, 270.0, 271.0)


def fbm_base(x, y, z):
    """3-octave fbm base eval (24 sins) that also returns the per-octave
    lattice state (floors, smoothed fracs, 8 corner hashes) so
    :func:`fbm_offsets_from_base` can evaluate the three eps-offset points
    with 4 new hashes per octave each."""
    f0 = 0.0
    state = []
    for amp, s in _OCTAVES:
        px, py, pz = torch.floor(x), torch.floor(y), torch.floor(z)
        fx, fy, fz = _smooth(x - px), _smooth(y - py), _smooth(z - pz)
        n0 = px + py * 157.0 + 113.0 * pz
        h = tuple(hash_(n0 + k) for k in _CORNERS)
        f0 = f0 + amp * _mix8(*h, fx, fy, fz)
        state.append((px, py, pz, fx, fy, fz) + h)
        if s is not None:
            x, y, z = x * s, y * s, z * s
    return f0, tuple(state)


def fbm_offsets_from_base(state, xe, ye, ze):
    """fbm at the three one-sided offset points, reusing the base lattice
    state (36 sins for all three). Bitwise-equal to independent fbm calls."""
    fx_ = fy_ = fz_ = 0.0
    for (amp, s), st in zip(_OCTAVES, state):
        px, py, pz, fx, fy, fz, h0, h1, h2, h3, h4, h5, h6, h7 = st

        pxe = torch.floor(xe)
        cx_ = pxe < px
        n_x = pxe + py * 157.0 + 113.0 * pz
        fxe = _smooth(xe - pxe)
        vx = _mix8(
            hash_(n_x + 0.0), torch.where(cx_, h0, h1),
            hash_(n_x + 157.0), torch.where(cx_, h2, h3),
            hash_(n_x + 113.0), torch.where(cx_, h4, h5),
            hash_(n_x + 270.0), torch.where(cx_, h6, h7),
            fxe, fy, fz,
        )

        pye = torch.floor(ye)
        cy_ = pye < py
        n_y = px + pye * 157.0 + 113.0 * pz
        fye = _smooth(ye - pye)
        vy = _mix8(
            hash_(n_y + 0.0), hash_(n_y + 1.0),
            torch.where(cy_, h0, h2), torch.where(cy_, h1, h3),
            hash_(n_y + 113.0), hash_(n_y + 114.0),
            torch.where(cy_, h4, h6), torch.where(cy_, h5, h7),
            fx, fye, fz,
        )

        pze = torch.floor(ze)
        cz_ = pze < pz
        n_z = px + py * 157.0 + 113.0 * pze
        fze = _smooth(ze - pze)
        vz = _mix8(
            hash_(n_z + 0.0), hash_(n_z + 1.0),
            hash_(n_z + 157.0), hash_(n_z + 158.0),
            torch.where(cz_, h0, h4), torch.where(cz_, h1, h5),
            torch.where(cz_, h2, h6), torch.where(cz_, h3, h7),
            fx, fy, fze,
        )
        fx_ = fx_ + amp * vx
        fy_ = fy_ + amp * vy
        fz_ = fz_ + amp * vz
        if s is not None:
            xe, ye, ze = xe * s, ye * s, ze * s
    return fx_, fy_, fz_


def fbm4(x, y, z, xe, ye, ze):
    """fbm at the base point and the three one-sided offsets, hash-shared."""
    f0, state = fbm_base(x, y, z)
    fx_, fy_, fz_ = fbm_offsets_from_base(state, xe, ye, ze)
    return f0, fx_, fy_, fz_


def noise_volume_grad(cx, cy, cz, sin_t, eps: float = 1e-4):
    """Fused (val, alpha, nx, ny, nz) of the fbm field: one hash-shared fbm4
    instead of 5 independent field evals. Bitwise equal to
    ``noise_volume(...) + gradient(...)``."""
    ox = cx - eps
    oy = cy - eps
    oz = cz - eps
    x, y, z = _lattice(cx, cy, cz, sin_t)
    xe, ye, ze = _lattice(ox, oy, oz, sin_t)
    f0, fx_, fy_, fz_ = fbm4(x, y, z, xe, ye, ze)

    def window(v, ax, ay, az):
        return v * smoothstep(0.5, 0.25, _radius(ax, ay, az))

    a0 = window(f0, cx, cy, cz)
    gx = a0 - window(fx_, ox, cy, cz)
    gy = a0 - window(fy_, cx, oy, cz)
    gz = a0 - window(fz_, cx, cy, oz)
    return (f0, a0) + _normalize(gx, gy, gz)


def fbm_grad_base(x, y, z):
    """fbm value + ANALYTIC lattice-space gradient from the SAME 24 corner
    hashes as the value (no extra transcendentals). Value noise is a
    trilinear mix of corner hashes with C1 smoothstep weights, so within a
    cell d(noise)/dx = d(mix8)/dfx * s'(x - px), where s'(t) = 6t(1-t);
    octave o's coordinates carry a cumulative scale (2.01, 2.02) whose
    chain-rule factor multiplies its gradient. Returns (f, gx, gy, gz)
    with the gradient in LATTICE units of the first octave."""
    f0 = 0.0
    gx = gy = gz = 0.0
    cum = 1.0
    for amp, s in _OCTAVES:
        px, py, pz = torch.floor(x), torch.floor(y), torch.floor(z)
        tx, ty, tz = x - px, y - py, z - pz
        fx, fy, fz = _smooth(tx), _smooth(ty), _smooth(tz)
        dsx = 6.0 * tx * (1.0 - tx)
        dsy = 6.0 * ty * (1.0 - ty)
        dsz = 6.0 * tz * (1.0 - tz)
        n0 = px + py * 157.0 + 113.0 * pz
        h0, h1, h2, h3, h4, h5, h6, h7 = (hash_(n0 + k) for k in _CORNERS)
        m01 = mix(h0, h1, fx)
        m23 = mix(h2, h3, fx)
        m45 = mix(h4, h5, fx)
        m67 = mix(h6, h7, fx)
        a = mix(m01, m23, fy)
        b = mix(m45, m67, fy)
        f0 = f0 + amp * mix(a, b, fz)
        dfx = mix(mix(h1 - h0, h3 - h2, fy), mix(h5 - h4, h7 - h6, fy), fz)
        dfy = mix(m23 - m01, m67 - m45, fz)
        dfz = b - a
        w = amp * cum
        gx = gx + w * dfx * dsx
        gy = gy + w * dfy * dsy
        gz = gz + w * dfz * dsz
        if s is not None:
            x, y, z = x * s, y * s, z * s
            cum = cum * s
    return f0, gx, gy, gz


def noise_volume_grad_analytic(cx, cy, cz, sin_t):
    """(val, alpha, nx, ny, nz) of the fbm field with the normal from the
    ANALYTIC gradient of alpha = fbm(p(c)) * smoothstep(0.5, 0.25, r(c))
    instead of the reference's eps = 1e-4 one-sided difference
    (shaders/xor.wgsl:63-67): 24 hash sins per step instead of 60.

    val and alpha are bitwise those of :func:`noise_volume_grad`; the
    normal is not (it equals the normalized one-sided difference up to
    O(eps * |f''| / |f'|), except on lanes whose offset point crossed a
    lattice cell)."""
    x, y, z = _lattice(cx, cy, cz, sin_t)
    f0, gpx, gpy, gpz = fbm_grad_base(x, y, z)
    r = _radius(cx, cy, cz)
    mask = smoothstep(0.5, 0.25, r)
    a0 = f0 * mask
    # d/dr of smoothstep(0.5, 0.25, r): t = clamp((r-0.5)/-0.25, 0, 1),
    # mask = t^2(3-2t) -> dmask/dr = 6t(1-t) * (-4); the clamp zeroes it
    # outside (0.25, 0.5) exactly like the FD of a flat mask
    t = torch.clamp((r - 0.5) * -4.0, 0.0, 1.0)
    dmask = 6.0 * t * (1.0 - t) * -4.0
    # the lattice map p(c) scales every axis by 32 (the sin_t shift is a
    # translation); radial term via c/r with an r ~ 0 guard
    w_rad = f0 * dmask / torch.clamp(r, min=1e-20)
    gx = 32.0 * mask * gpx + w_rad * cx
    gy = 32.0 * mask * gpy + w_rad * cy
    gz = 32.0 * mask * gpz + w_rad * cz
    return (f0, a0) + _normalize(gx, gy, gz)


def xor_field(cx, cy, cz, sin_t):
    """Bitwise x&y&z field (shaders/xor.wgsl:46-53), SoA."""
    px, py, pz = _lattice(cx, cy, cz, sin_t)
    res = 25.0
    qx = (px * res).to(torch.int32)
    qy = (py * res).to(torch.int32)
    qz = (pz * res).to(torch.int32)
    val = (qx & qy & qz).to(torch.float32) / res
    alpha = val * smoothstep(0.7, 0.0, _radius(cx, cy, cz))
    return val, alpha


def trig_field(cx, cy, cz, time):
    """Framework-defined trig density (see fields.trig_field), SoA. Takes
    RAW time, not sin(time)."""
    val = 0.5 + 0.5 * torch.sin(8.0 * cx + time) * torch.sin(
        8.0 * cy + 0.5 * time
    ) * torch.sin(8.0 * cz)
    alpha = val * smoothstep(0.9, 0.2, _radius(cx, cy, cz))
    return val, alpha


FIELDS = {"noise": noise_volume, "xor": xor_field, "trig": trig_field}
