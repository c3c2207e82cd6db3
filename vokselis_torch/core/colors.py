"""Color transforms shared by the render paths (plain float32 torch).

Reference sources:
- scalar ``linear_to_srgb`` branch form: shaders/raycast_naive.wgsl:63-68
- vectorized ceil-select form: shaders/present.wgsl:23-30 (note exponent
  0.41666, not 1/2.4 — replicated verbatim)
- ACES filmic tonemap: shaders/present.wgsl:32-35
- cosine palette / vertigo: shaders/raycast_naive.wgsl:70-81 (TAU = 6.28318,
  the truncated constant used by the shader)

``csrc/march_bonsai.cu`` repeats ``bonsai_transfer_soa`` and
``linear_to_srgb`` in CUDA; a change here must be made there too.
"""

from __future__ import annotations

import torch

TAU = 6.28318  # shaders/raycast_naive.wgsl:70 — deliberately not 2*pi


def smoothstep(edge0, edge1, x):
    """WGSL smoothstep: Hermite interpolation between edge0 and edge1."""
    t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def mix(a, b, t):
    """WGSL mix(a, b, t) = a*(1-t) + b*t."""
    return a + (b - a) * t


def linear_to_srgb(x):
    """Per-channel sRGB OETF, branch form (shaders/raycast_naive.wgsl:63-68)."""
    return torch.where(
        x <= 0.0031308,
        12.92 * x,
        1.055 * torch.pow(torch.clamp(x, min=1e-12), 1.0 / 2.4) - 0.055,
    )


def linear_to_srgb_present(rgb):
    """Vectorized ceil-select form used by the present pass
    (shaders/present.wgsl:23-30): selector = ceil(x - 0.0031308) blended with
    mix(), exponent 0.41666."""
    selector = torch.clamp(torch.ceil(rgb - 0.0031308), 0.0, 1.0)
    under = 12.92 * rgb
    over = 1.055 * torch.pow(torch.clamp(rgb, min=1e-12), 0.41666) - 0.055
    return mix(under, over, selector)


def aces_film(x):
    """ACES filmic tonemap (shaders/present.wgsl:32-35)."""
    return torch.clamp(
        (x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14), 0.0, 1.0
    )


def palette(t, a, b, c, d):
    """IQ cosine palette (shaders/raycast_naive.wgsl:71-73)."""
    return a + b * torch.cos(TAU * (c * t + d))


def vertigo(t):
    """The 'vertigo' palette (shaders/raycast_naive.wgsl:75-81).

    ``t`` may be any shape; returns shape ``t.shape + (3,)``.
    """

    def vec(*v):
        return torch.tensor(v, dtype=torch.float32, device=t.device)

    return palette(t[..., None], vec(0.5, 0.5, 0.5), vec(0.5, 0.5, 0.5),
                   vec(1.0, 1.7, 0.4), vec(0.0, 0.15, 0.20))


def vertigo_soa(t):
    """vertigo palette with SoA channel outputs (r, g, b)."""
    r = 0.5 + 0.5 * torch.cos(TAU * (1.0 * t + 0.0))
    g = 0.5 + 0.5 * torch.cos(TAU * (1.7 * t + 0.15))
    b = 0.5 + 0.5 * torch.cos(TAU * (0.4 * t + 0.20))
    return r, g, b


def bonsai_transfer_soa(samp):
    """K1 transfer function (raycast_naive.wgsl:101-108) in SoA form:
    sample -> (step_alpha, r, g, b). The ``min(0.9, v)`` clamp-arg-order
    quirk + smoothstep(0.10, 1.2) + vertigo — never fix the quirk in one
    place only."""
    tv = smoothstep(0.10, 1.2, torch.clamp(samp, max=0.9))
    r, g, b = vertigo_soa(tv)
    return tv, r, g, b
