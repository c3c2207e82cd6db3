"""Present pass: ACES tonemap + sRGB encode + capture (shaders/present.wgsl).

The reference draws a fullscreen triangle sampling the fixed 1280x720 HDR
backbuffer with a bilinear ClampToEdge sampler into two targets at window
resolution — the swapchain surface and the rgb capture texture
(shaders/present.wgsl:106-119, src/context.rs:262-283,
src/context/present_pipeline.rs:36-112). Here that is an optional resize
(the shader's live bilinear filter, or its quadratic and bicubic upsamplers)
followed by ``srgb(ACES(x))`` (the vectorized ceil-select sRGB form the
present shader uses), returned once — the two wgpu targets receive
identical bytes. Plain torch: the JAX package computes this outside any
Pallas kernel too. :class:`vokselis_torch.engine.context.Presenter` replays the pass
from a CUDA graph on a card, as the JAX package jits it.
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


def _div(x, d: float):
    """``x / d`` rounded once, on every device: PyTorch's CUDA kernels
    multiply by the reciprocal of a Python-scalar divisor (one more
    rounding, an ulp off the CPU's and the JAX package's quotient), not of a
    tensor one."""
    return x / torch.full((), float(d), dtype=torch.float32, device=x.device)


def _out_uv(out_h: int, out_w: int, device):
    u = _div(torch.arange(out_w, dtype=torch.float32, device=device) + 0.5, out_w)
    v = _div(torch.arange(out_h, dtype=torch.float32, device=device) + 0.5, out_h)
    return u, v


def _resize_bilinear(img, out_h: int, out_w: int):
    """Sample ``img`` (H, W, C) at the output grid's pixel-center uvs with
    wgpu linear/ClampToEdge semantics (half-texel centers)."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img
    u, v = _out_uv(out_h, out_w, img.device)
    return _sample_bilinear_sep(img, u * w - 0.5, v * h - 0.5)


def _resize_quadratic(img, out_h: int, out_w: int):
    """``texture_quadratic`` (shaders/present.wgsl:41-56): a smoothstepped
    quadratic reconstruction from four half-texel-offset bilinear samples.
    Keeps the shader's quirk of using textureDimensions(tex).x as the texel
    size for BOTH axes."""
    h, w = img.shape[:2]
    n = float(w)  # tex_size = .x only (present.wgsl:42) — quirk kept
    u, v = _out_uv(out_h, out_w, img.device)
    px = u * n
    py = v * n
    ix = torch.floor(px)
    iy = torch.floor(py)
    fx = px - ix
    fy = py - iy
    # p = (i + f*0.5) / n, then f := smoothstep poly (:46-48)
    pu = _div(ix + fx * 0.5, n)
    pv = _div(iy + fy * 0.5, n)
    fx = fx * fx * (3.0 - 2.0 * fx)
    fy = fy * fy * (3.0 - 2.0 * fy)
    wo = 0.5 / n

    def s(du, dv):
        # tex_sample normalizes per TRUE axis size (textureSample)
        return _sample_bilinear_sep(img, (pu + du) * w - 0.5, (pv + dv) * h - 0.5)

    fxb = fx[None, :, None]
    fyb = fy[:, None, None]
    top = s(0.0, 0.0) * (1 - fxb) + s(wo, 0.0) * fxb
    bot = s(0.0, wo) * (1 - fxb) + s(wo, wo) * fxb
    return top * (1 - fyb) + bot * fyb


def _resize_bicubic(img, out_h: int, out_w: int):
    """``texture_bicubic`` (shaders/present.wgsl:58-92): cubic B-spline
    reconstruction via four amplitude-weighted bilinear samples."""
    h, w = img.shape[:2]

    def w0(a):
        return (1.0 / 6.0) * (a * (a * (-a + 3.0) - 3.0) + 1.0)

    def w1(a):
        return (1.0 / 6.0) * (a * a * (3.0 * a - 6.0) + 4.0)

    def w2(a):
        return (1.0 / 6.0) * (a * (a * (-3.0 * a + 3.0) + 3.0) + 1.0)

    def w3(a):
        return (1.0 / 6.0) * (a * a * a)

    def g0(a):
        return w0(a) + w1(a)

    def g1(a):
        return w2(a) + w3(a)

    def h0(a):
        return -1.0 + w1(a) / (w0(a) + w1(a))

    def h1(a):
        return 1.0 + w3(a) / (w2(a) + w3(a))

    u, v = _out_uv(out_h, out_w, img.device)
    uvx = u * w + 0.5
    uvy = v * h + 0.5
    ix = torch.floor(uvx)
    iy = torch.floor(uvy)
    fx = uvx - ix
    fy = uvy - iy

    x0 = (ix + h0(fx)) - 0.5  # texel-space coords of the two x taps
    x1 = (ix + h1(fx)) - 0.5
    y0 = (iy + h0(fy)) - 0.5
    y1 = (iy + h1(fy)) - 0.5
    g0x = g0(fx)[None, :, None]
    g1x = g1(fx)[None, :, None]
    g0y = g0(fy)[:, None, None]
    g1y = g1(fy)[:, None, None]
    return g0y * (
        g0x * _sample_bilinear_sep(img, x0, y0) + g1x * _sample_bilinear_sep(img, x1, y0)
    ) + g1y * (
        g0x * _sample_bilinear_sep(img, x0, y1) + g1x * _sample_bilinear_sep(img, x1, y1)
    )


FILTERS = {
    "linear": _resize_bilinear,
    "quadratic": _resize_quadratic,
    "bicubic": _resize_bicubic,
}


@torch.no_grad()
def present(hdr, out_height: int | None = None, out_width: int | None = None,
            tonemap: bool = True, filter: str = "linear"):
    """Tonemap the HDR backbuffer for display/capture.

    ``hdr``: (H, W, 4) linear. Returns (out_H, out_W, 4) in [0,1] sRGB-encoded
    on ``hdr``'s device. ``tonemap=False`` is the present shader's
    ``fs_main_raw`` passthrough (shaders/present.wgsl:121-124). ``filter``
    selects the reconstruction: "linear" (the shader's live path),
    "quadratic" or "bicubic" (the shader's otherwise dead upsamplers,
    present.wgsl:41-92). As in the JAX package, a filter other than
    "linear" resamples even at the same size.
    """
    if filter not in FILTERS:
        raise ValueError(f"filter must be one of {tuple(FILTERS)}, got {filter!r}")
    out_h = out_height or hdr.shape[0]
    out_w = out_width or hdr.shape[1]
    img = hdr.to(torch.float32)
    if (out_h, out_w) != tuple(img.shape[:2]) or filter != "linear":
        img = FILTERS[filter](img, out_h, out_w)
    if not tonemap:
        return img
    rgb = linear_to_srgb_present(aces_film(img[..., :3]))
    return torch.cat([rgb, img[..., 3:4]], dim=-1)


def to_uint8(img):
    """Quantize a [0,1] float image to uint8 (the Rgba8Unorm capture target,
    src/context.rs:339-359): round-to-nearest like the GPU's unorm store."""
    return torch.clamp(torch.round(img * 255.0), 0, 255).to(torch.uint8)

