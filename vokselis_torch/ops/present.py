"""Present pass: ACES tonemap + sRGB encode + capture (shaders/present.wgsl).

The reference draws a fullscreen triangle sampling the fixed 1280x720 HDR
backbuffer with a bilinear ClampToEdge sampler into two targets at window
resolution — the swapchain surface and the rgb capture texture
(shaders/present.wgsl:106-119, src/context.rs:262-283,
src/context/present_pipeline.rs:36-112). Here that is an optional bilinear
resize followed by ``srgb(ACES(x))`` (the vectorized ceil-select sRGB form
the present shader uses), returned once — the two wgpu targets receive
identical bytes. Only the shader's live "linear" filter is ported so far.
"""

from __future__ import annotations

import torch

from vokselis_torch.core.colors import aces_film, linear_to_srgb_present


def _sample_bilinear_sep(img, xs, ys):
    """Bilinear ClampToEdge lookup of ``img`` (H, W, C) at SEPARABLE texel
    coordinates: ``xs`` (out_W,), ``ys`` (out_H,) in texel space (uv*size -
    0.5, wgpu half-texel centers). Returns (out_H, out_W, C)."""
    h, w = img.shape[:2]
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = (xs - x0)[None, :, None]
    fy = (ys - y0)[:, None, None]
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    x0c = torch.clamp(x0, 0, w - 1)
    x1c = torch.clamp(x0 + 1, 0, w - 1)
    y0c = torch.clamp(y0, 0, h - 1)
    y1c = torch.clamp(y0 + 1, 0, h - 1)
    top = img[y0c][:, x0c] * (1 - fx) + img[y0c][:, x1c] * fx
    bot = img[y1c][:, x0c] * (1 - fx) + img[y1c][:, x1c] * fx
    return top * (1 - fy) + bot * fy


def _resize_bilinear(img, out_h: int, out_w: int):
    """Sample ``img`` (H, W, C) at the output grid's pixel-center uvs with
    wgpu linear/ClampToEdge semantics (half-texel centers)."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img
    u = (torch.arange(out_w, dtype=torch.float32, device=img.device) + 0.5) / out_w
    v = (torch.arange(out_h, dtype=torch.float32, device=img.device) + 0.5) / out_h
    return _sample_bilinear_sep(img, u * w - 0.5, v * h - 0.5)


@torch.no_grad()
def present(hdr, out_height: int | None = None, out_width: int | None = None,
            tonemap: bool = True):
    """Tonemap the HDR backbuffer for display/capture.

    ``hdr``: (H, W, 4) linear. Returns (out_H, out_W, 4) in [0,1] sRGB-encoded
    on ``hdr``'s device. ``tonemap=False`` is the present shader's
    ``fs_main_raw`` passthrough (shaders/present.wgsl:121-124).
    """
    out_h = out_height or hdr.shape[0]
    out_w = out_width or hdr.shape[1]
    img = _resize_bilinear(hdr.to(torch.float32), out_h, out_w)
    if not tonemap:
        return img
    rgb = linear_to_srgb_present(aces_film(img[..., :3]))
    return torch.cat([rgb, img[..., 3:4]], dim=-1)


def to_uint8(img):
    """Quantize a [0,1] float image to uint8 (the Rgba8Unorm capture target,
    src/context.rs:339-359): round-to-nearest like the GPU's unorm store."""
    return torch.clamp(torch.round(img * 255.0), 0, 255).to(torch.uint8)
