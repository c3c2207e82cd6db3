"""The present pass at the backbuffer's own size (shaders/present.wgsl:23-35,
106-119): the ACES filmic tonemap, then the ceil-select sRGB encode with
exponent 0.41666, alpha passed through."""

from __future__ import annotations

import torch


def aces_film(x):
    return torch.clamp((x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14), 0.0, 1.0)


def srgb_present(rgb):
    selector = torch.clamp(torch.ceil(rgb - 0.0031308), 0.0, 1.0)
    under = 12.92 * rgb
    over = 1.055 * torch.pow(torch.clamp(rgb, min=1e-12), 0.41666) - 0.055
    return under + (over - under) * selector


@torch.no_grad()
def present(hdr):
    """(..., 4) float32 backbuffer -> (..., 4) display image in [0, 1]."""
    return torch.cat([srgb_present(aces_film(hdr[..., :3])), hdr[..., 3:4]], dim=-1)
