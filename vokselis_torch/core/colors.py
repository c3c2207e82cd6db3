"""Color transforms shared by the render paths (plain float32 torch).

Reference sources:
- scalar ``linear_to_srgb`` branch form: shaders/raycast_naive.wgsl:63-68
- vectorized ceil-select form: shaders/present.wgsl:23-30 (note exponent
  0.41666, not 1/2.4 — replicated verbatim)
- ACES filmic tonemap: shaders/present.wgsl:32-35
- cosine palette / vertigo: shaders/raycast_naive.wgsl:70-81 (TAU = 6.28318,
  the truncated constant used by the shader)

``csrc/march_bonsai.cu`` repeats ``bonsai_transfer_soa`` and
``linear_to_srgb`` in CUDA, ``csrc/shear_resample.cu`` repeats
``bonsai_transfer_soa`` and ``bonsai_transfer_pow_lowdeg_soa`` (with the
``_PAL_*_LO`` coefficients), and ``csrc/fields.cuh`` repeats ``smoothstep``,
``mix`` and ``fract``; a change here must be made there too.
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


def fract(x):
    """WGSL fract: x - floor(x)."""
    return x - torch.floor(x)


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


# ---------------------------------------------------------------------------
# Polynomial transfers for the shear-warp composite (APPROXIMATE fast mode
# only; the exact kernel and the plain oracles keep the transcendental forms
# above). Copied digit for digit from vokselis_tpu/core/colors.py, where the
# JAX package replaced the palette cosines, ln(1-tv) and exp() with Horner
# polynomials for the TPU. Coefficients and their float32 validation come
# from tools/fit_transfer_poly.py:
#   palette r/g/b max err 3.2e-7 / 1.3e-6 / 7.0e-8,
#   alpha = 1-(1-tv)^irho end-to-end max err 4.4e-7 over the full
#   (samp, irho) domain, and EXACTLY 0 at tv = 0 (both factored forms
#   carry the zero: ln(1-tv) = tv*P(tv), 1-exp(y) = -y*Q(y)) so empty
#   samples stay perfectly transparent.
# ---------------------------------------------------------------------------

_TVMAX = 0.8174305033809168  # smoothstep(0.10, 1.2, 0.9): tv's full range
# real rays have irho <= sqrt(3); off-ray intermediate texels (extent
# padding, corner rays with their own dominant axis) can exceed it, so
# Q is fitted out to irho = 3 and y clamps there (alpha saturates
# within 0.6% beyond, on texels no real ray owns)
_YMIN = -5.101873125163693  # 3 * ln(1 - TVMAX): y's fitted range

_PAL_R = (2.3406275886372896e-06, -8.178023563232273e-06, -7.169197488110512e-05, 0.00021621925407089293, 0.0014433319447562099, -0.003630567342042923, -0.019702181220054626, 0.03964952751994133, 0.16730359196662903, -0.2525175213813782, -0.7610723376274109, 0.765809953212738, 1.3848620653152466, -0.6967412829399109, 0.08001303672790527)  # noqa: E501
_PAL_G = (6.774119538022205e-05, 0.00017599744023755193, -0.0012224658858031034, -0.0028367959894239902, 0.013864136300981045, 0.027970831841230392, -0.1138000339269638, -0.19436828792095184, 0.6569516658782959, 0.9181039929389954, -2.4818410873413086, -2.6976795196533203, 5.469216823577881, 4.246329307556152, -5.739269733428955, -2.6735997200012207, 1.806796908378601, 0.7805613875389099)  # noqa: E501
_PAL_B = (-1.2924492693855427e-06, -9.764691640157253e-06, 9.051700180862099e-05, 0.000533417914994061, -0.0036043107975274324, -0.015173014253377914, 0.0683177188038826, 0.17255795001983643, -0.38847577571868896, 0.17292727530002594)  # noqa: E501
_LN_P = (-0.005728758871555328, -0.007759550120681524, 0.006596320308744907, 0.00675453944131732, -0.013167641125619411, -0.017193958163261414, -0.013717273250222206, -0.025685228407382965, -0.049689874053001404, -0.0907517597079277, -0.17888523638248444, -0.4055885076522827, -1.2856327295303345)  # noqa: E501
_EXP_Q = (3.249415021855384e-05, 0.00014471162285190076, 0.000508370460011065, 0.0018546003848314285, 0.006139653269201517, 0.017848661169409752, 0.04536726698279381, 0.0993211641907692, 0.1839265376329422, 0.2834240198135376, 0.3614325225353241)  # noqa: E501


def _horner(coeffs, u):
    acc = torch.full_like(u, coeffs[0])
    for c in coeffs[1:]:
        acc = acc * u + c
    return acc


def bonsai_transfer_fast_soa(samp):
    """``bonsai_transfer_soa`` with the three vertigo cosines replaced by
    their Chebyshev polynomials (<= 1.4e-6 per channel — see the
    coefficient block above): sample -> (tv, r, g, b) with tv EXACT
    (smoothstep is already polynomial). For approximate render paths
    whose error contract is measured in 1e-3s (the shear-warp composite,
    the hybrid's re-march) — the flagship exact kernel and the plain
    oracles keep the transcendental form."""
    tv = smoothstep(0.10, 1.2, torch.clamp(samp, max=0.9))
    u = (2.0 / _TVMAX) * tv - 1.0
    return tv, _horner(_PAL_R, u), _horner(_PAL_G, u), _horner(_PAL_B, u)


def bonsai_transfer_pow_fast_soa(samp, irho):
    """Fast-mode transfer + palette + irho rate correction in one
    polynomial pass: sample -> (alpha_step, r, g, b) where
    alpha_step = 1 - (1 - tv)^irho. Semantics match
    ``bonsai_transfer_soa`` + the exp/log rate fold within <= 1.4e-6
    per sample (see the coefficient block above / fit_transfer_poly).

    Domain assumption: the _YMIN floor on
    y = irho * tv * ln(1-tv) caps the effective step-rate ratio at
    irho <= ~3 — texels whose own dominant axis diverges harder from the
    frame axis SATURATE (alpha -> 1) instead of staying exact. At the
    reference camera (fovy = pi/2, src/camera.rs:88-91) irho stays below
    ~1.8 (the fast path picks the dominant axis per frame, bounding the
    off-axis step-rate by sqrt(3) with margin), so the 72-pose sweep's
    <= 1e-3 gate holds; a wider-FOV camera would need the Q fit re-run
    over the wider y range (tools/fit_transfer_poly.py validates any
    refit to <= 1.4e-6).
    """
    tv, r, g, b = bonsai_transfer_fast_soa(samp)
    u = (2.0 / _TVMAX) * tv - 1.0
    y = torch.clamp(irho * (tv * _horner(_LN_P, u)), min=_YMIN)
    w = 1.0 - (2.0 / _YMIN) * y
    alpha = -(y * _horner(_EXP_Q, w))
    return alpha, r, g, b


# LOW-DEGREE palette set for the shear-warp composite only (the composite's
# default in the JAX package). Degrees from the tools/fit_transfer_poly.py
# degree scan (same fitter, f32-validated):
#   r deg 8: 1.43e-5   g deg 11: 1.21e-5   b deg 5: 1.74e-5
# Palette error does NOT accumulate along a ray (channels are convex
# combinations, sum of weights <= 1), so the per-sample bound is the
# per-pixel bound. The re-march / stats paths keep the 1e-6 set above.
_PAL_R_LO = (-0.01637626811861992, 0.032187458127737045, 0.16447384655475616, -0.2470930814743042, -0.7600758671760559, 0.7643266916275024, 1.384738564491272, -0.696631133556366, 0.08001549541950226)  # noqa: E501
_PAL_G_LO = (-0.07604426890611649, -0.12505008280277252, 0.6126497983932495, 0.8453051447868347, -2.4561009407043457, -2.66123104095459, 5.46185302734375, 4.237965106964111, -5.73836088180542, -2.6728928089141846, 1.8067647218704224, 0.7805516123771667)  # noqa: E501
_PAL_B_LO = (-0.003448813920840621, -0.014389974996447563, 0.0682404488325119, 0.17226645350456238, -0.38846614956855774, 0.17294341325759888)  # noqa: E501


def bonsai_transfer_pow_lowdeg_soa(samp, irho):
    """Composite-grade transfer: low-degree palette polynomials (<= 1.7e-5
    per channel, block above) + the EXACT rate fold
    ``alpha = 1 - exp(irho * log(1 - tv))`` through the exp/log functions,
    with no _YMIN clamp, so the irho <= 3 domain caveat of ``bonsai_transfer_pow_fast_soa``
    does not apply here (alpha saturates exactly for any irho). tv = 0
    stays exactly transparent: log(1) = 0 -> exp(0) = 1 -> alpha = 0.
    Matches shaders/raycast_naive.wgsl:104-114 semantics + the irho
    correction documented in ops.shear_warp."""
    tv = smoothstep(0.10, 1.2, torch.clamp(samp, max=0.9))
    u = (2.0 / _TVMAX) * tv - 1.0
    alpha = 1.0 - torch.exp(irho * torch.log(1.0 - tv))
    return (alpha, _horner(_PAL_R_LO, u), _horner(_PAL_G_LO, u),
            _horner(_PAL_B_LO, u))
