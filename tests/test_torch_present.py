"""The present pass's filters in the port (vokselis_torch.ops.present):
"linear", "quadratic" and "bicubic" against the JAX package's ``present``
on the same numpy-seeded HDR images, upscaled, downscaled and at the same
size, with and without the tonemap, within 1e-5. Mirrors
tests/test_core.py:184-246: partition of unity and the WGSL
transliterations of present.wgsl:41-92, at the same tolerance (1e-5).
"""

import numpy as np
import pytest
import torch

from vokselis_torch.ops.present import FILTERS, present

TOL = 1e-5


def _bilinear(img, x, y):
    """One ClampToEdge bilinear lookup in texel space (numpy)."""
    h, w = img.shape[:2]
    x0, y0 = np.floor(x), np.floor(y)
    fx, fy = x - x0, y - y0
    x0, y0 = int(x0), int(y0)
    x0c, x1c = np.clip(x0, 0, w - 1), np.clip(x0 + 1, 0, w - 1)
    y0c, y1c = np.clip(y0, 0, h - 1), np.clip(y0 + 1, 0, h - 1)
    top = img[y0c, x0c] * (1 - fx) + img[y0c, x1c] * fx
    bot = img[y1c, x0c] * (1 - fx) + img[y1c, x1c] * fx
    return top * (1 - fy) + bot * fy


@pytest.mark.parametrize("filt", list(FILTERS))
@pytest.mark.parametrize("out_size", [(30, 44), (12, 20), (7, 9)])
@pytest.mark.parametrize("tonemap", [True, False])
def test_present_matches_jax(filt, out_size, tonemap):
    """Upscaled, at the same size (12x20: the resize still runs for a
    filter other than "linear", present.py:171) and downscaled."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from vokselis_tpu.ops.present import present as jax_present

    rng = np.random.default_rng(11)
    hdr = (rng.random((12, 20, 4)) * 3.0).astype(np.float32)
    oh, ow = out_size
    port = present(torch.from_numpy(hdr), out_height=oh, out_width=ow, tonemap=tonemap,
                   filter=filt)
    ref = np.asarray(jax_present(jnp.asarray(hdr), out_height=oh, out_width=ow,
                                 tonemap=tonemap, filter=filt))
    assert tuple(port.shape) == ref.shape == (oh, ow, 4)
    assert np.abs(port.numpy() - ref).max() < TOL


def test_same_size_filter_resamples():
    """At the same size the linear filter is the identity; the quadratic
    one (half-texel offset taps) is not."""
    img = torch.from_numpy(np.random.default_rng(3).random((8, 16, 4)).astype(np.float32))
    assert torch.equal(present(img, tonemap=False), img)
    assert not torch.equal(present(img, tonemap=False, filter="quadratic"), img)
    with pytest.raises(ValueError, match="filter"):
        present(img, filter="nearest")


def test_partition_of_unity():
    const = torch.full((12, 20, 4), 0.37)
    for filt in FILTERS:
        out = present(const, out_height=30, out_width=44, tonemap=False, filter=filt)
        assert float((out - 0.37).abs().max()) < TOL, filt


def test_quadratic_matches_wgsl_transliteration():
    """Non-square source pins the shader's textureDimensions(tex).x
    texel-size quirk (present.wgsl:42 uses .x for BOTH axes)."""
    img = np.random.default_rng(0).random((8, 16, 4)).astype(np.float32)
    oh, ow = 13, 23
    out = present(torch.from_numpy(img), out_height=oh, out_width=ow, tonemap=False,
                  filter="quadratic").numpy()
    h, w = img.shape[:2]
    n = float(w)  # .x quirk
    want = np.zeros((oh, ow, 4), np.float32)
    for j in range(oh):
        for i in range(ow):
            u, v = (i + 0.5) / ow, (j + 0.5) / oh
            px, py = u * n, v * n
            ix, iy = np.floor(px), np.floor(py)
            fx, fy = px - ix, py - iy
            pu, pv = (ix + fx * 0.5) / n, (iy + fy * 0.5) / n
            fx = fx * fx * (3 - 2 * fx)
            fy = fy * fy * (3 - 2 * fy)
            wo = 0.5 / n

            def s(du, dv):
                return _bilinear(img, (pu + du) * w - 0.5, (pv + dv) * h - 0.5)

            top = s(0, 0) * (1 - fx) + s(wo, 0) * fx
            bot = s(0, wo) * (1 - fx) + s(wo, wo) * fx
            want[j, i] = top * (1 - fy) + bot * fy
    assert np.abs(out - want).max() < TOL


def test_bicubic_matches_wgsl_transliteration():
    img = np.random.default_rng(1).random((9, 14, 4)).astype(np.float32)
    oh, ow = 19, 27
    out = present(torch.from_numpy(img), out_height=oh, out_width=ow, tonemap=False,
                  filter="bicubic").numpy()
    h, w = img.shape[:2]

    def w0(a):
        return (1 / 6) * (a * (a * (-a + 3) - 3) + 1)

    def w1(a):
        return (1 / 6) * (a * a * (3 * a - 6) + 4)

    def w2(a):
        return (1 / 6) * (a * (a * (-3 * a + 3) + 3) + 1)

    def w3(a):
        return (1 / 6) * (a * a * a)

    def g0(a):
        return w0(a) + w1(a)

    def g1(a):
        return w2(a) + w3(a)

    def h0(a):
        return -1.0 + w1(a) / (w0(a) + w1(a))

    def h1(a):
        return 1.0 + w3(a) / (w2(a) + w3(a))

    want = np.zeros((oh, ow, 4), np.float32)
    for j in range(oh):
        for i in range(ow):
            u, v = (i + 0.5) / ow, (j + 0.5) / oh
            uvx, uvy = u * w + 0.5, v * h + 0.5
            ix, iy = np.floor(uvx), np.floor(uvy)
            fx, fy = uvx - ix, uvy - iy
            want[j, i] = g0(fy) * (
                g0(fx) * _bilinear(img, ix + h0(fx) - 0.5, iy + h0(fy) - 0.5)
                + g1(fx) * _bilinear(img, ix + h1(fx) - 0.5, iy + h0(fy) - 0.5)
            ) + g1(fy) * (
                g0(fx) * _bilinear(img, ix + h0(fx) - 0.5, iy + h1(fy) - 0.5)
                + g1(fx) * _bilinear(img, ix + h1(fx) - 0.5, iy + h1(fy) - 0.5)
            )
    assert np.abs(out - want).max() < TOL


@pytest.mark.gpu
def test_filters_on_the_card_match_the_cpu():
    """On a CUDA card each filter gives the CPU's result within 1e-5 at
    sizes that are not powers of two (the coordinates' quotients are
    rounded once on both devices)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    hdr = torch.from_numpy((np.random.default_rng(12).random((90, 160, 4)) * 3.0)
                           .astype(np.float32))
    for filt in FILTERS:
        for oh, ow in ((90, 160), (144, 192), (61, 97)):
            card = present(hdr.cuda(), oh, ow, filter=filt).cpu()
            assert float((card - present(hdr, oh, ow, filter=filt)).abs().max()) < TOL
