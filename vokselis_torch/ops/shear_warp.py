"""Shear-warp fast renderer — the ``renderer="fast"`` approximate bonsai mode
(the counterpart of ``vokselis_tpu/ops/shear_warp.py``).

The perspective view factorizes (Lacroute-Levoy shear-warp, adapted to the
reference's sampling scheme) into a per-slab homothety and one 2-D warp:

- slabs are taken along the view's dominant axis m, one sample per slab
  crossing at m = k + 0.5 — the reference's step rule dt = 1/(D * max|dir|)
  (raycast_naive.wgsl:97-99) — from packs pre-blended as 0.5*(slab k +
  slab k+1), the exact trilinear interpolant at that plane;
- for a pinhole camera the map between two parallel planes is a homothety,
  so slab k's footprint on a fixed intermediate grid is a separable
  scale/shift resample (K3, :func:`vokselis_torch.ops.cuda.shear_resample.
  resample_slabs`);
- the stack is composited front to back with two exact corrections (K4,
  ``composite``): the off-dominant-axis opacity rate (a ray takes
  irho = max|d|/|d_m| >= 1 exact-march steps per slab, and n equal steps of
  alpha tv telescope to 1-(1-tv)^n) and the per-pixel 0.95 stop; on the
  frame path both run in one kernel (``resample_composite``), each slab's
  samples resampled inside the composite loop, so the stack never reaches
  device memory;
- one bilinear lookup warps the composited intermediate to the screen (K6,
  :func:`vokselis_torch.ops.cuda.warp2d.warp_bilinear`).

Outside-the-box samples resample to zero, which the transfer maps to zero
(the reference's ray clipping). Rays whose ref-plane crossing falls outside
the intermediate's extent render black. The error against the exact frame
is what the JAX package measured and documents (PARITY_REPORT.md).

Every per-frame decision (the dominant axis, the marching sign, the frustum
clip's quantiles) stays on the device: the frame reads no device value on
the host. On CUDA tensors the three stages launch their kernels; on the CPU
their plain versions run.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from vokselis_torch.core import geometry
from vokselis_torch.core.colors import linear_to_srgb
from vokselis_torch.core.compiled import CompiledFrame
from vokselis_torch.ops.cuda import shear_resample, warp2d
from vokselis_torch.ops.cuda.march_bonsai import volume_tensor
from vokselis_torch.ops.reference import MAX_STEPS_BONSAI
from vokselis_torch.utils.grid import TILE

OCC_EPS = 0.1  # pack texels <= 0.1 are transfer-0: smoothstep(0.10, 1.2, .)
WIN_CAP = 48  # the JAX package's warp row-window cap (_win_rows)


def prepare_fast_volume(vol_u8, device):
    """Packs for the fast renderer, built with torch on ``device``.

    Returns ``(packs, (tab_u, tab_v))``:
    - ``packs``: (3, D-1, D, D) bf16, one half-shifted slab-major volume per
      dominant axis m (m=0: [x][z][y], m=1: [y][z][x], m=2: [z][y][x]), each
      pre-blended 0.5*(slab k + slab k+1) so a bilinear in-slab sample
      equals the exact trilinear interpolant at m = k + 0.5;
    - ``tab_u``/``tab_v``: (3, D-1, D//8) bool occupancy tables, per slab
      and 8-column group, of blend > OCC_EPS along u (reduced over v) and
      along v (reduced over u).

    The float32 volume is taken from a 256-entry table of ``level / 255``
    divided on the CPU, so every device computes the JAX package's values
    bit for bit."""
    vol = volume_tensor(vol_u8, device)
    d = vol.shape[0]
    if d % 8:
        raise ValueError(f"the fast renderer needs a volume side divisible by 8, got {d}")
    lut = (torch.arange(256, dtype=torch.float32) / 255.0).to(vol.device)
    vf = lut[vol.long()]
    base = (vf.permute(2, 0, 1), vf.permute(1, 0, 2), vf)
    ng = d // 8
    packs = torch.empty((3, d - 1, d, d), dtype=torch.bfloat16, device=vol.device)
    tab_u, tab_v = [], []
    for m in range(3):
        v = base[m]
        blend = 0.5 * (v[:-1] + v[1:])
        packs[m] = blend.to(torch.bfloat16)
        hot = blend > OCC_EPS  # (G, Dv, Du)
        tab_u.append(hot.any(dim=1).reshape(d - 1, ng, 8).any(dim=2))
        tab_v.append(hot.any(dim=2).reshape(d - 1, ng, 8).any(dim=2))
    return packs, (torch.stack(tab_u), torch.stack(tab_v))


def _window_counts(cum, pos_lo, pos_hi):
    """Occupied-group count for [pos_lo-1, pos_hi+1] windows against a
    per-slab prefix-summed group table ``cum`` (G, ng+1). Off-grid windows
    (including the -1e6 pad sentinel) clip to an empty span."""
    ng = cum.shape[1] - 1
    gl = torch.clamp(torch.floor((pos_lo - 1.0) / 8.0).long(), 0, ng)
    gh = torch.clamp(torch.floor((pos_hi + 1.0) / 8.0).long() + 1, 0, ng)
    gh = torch.maximum(gh, gl)
    return torch.gather(cum, 1, gh) - torch.gather(cum, 1, gl)


def _window_any(tab, pos_lo, pos_hi):
    """Does any occupied group of ``tab`` (G, ng) bool intersect the
    [pos_lo-1, pos_hi+1] window (both (G, nwin))? The same group arithmetic
    as :func:`_window_counts` (``> 0``), as a mask-reduce over the groups."""
    ng = tab.shape[1]
    gl = torch.clamp(torch.floor((pos_lo - 1.0) / 8.0), 0.0, float(ng))
    gh = torch.floor((pos_hi + 1.0) / 8.0)
    gidx = torch.arange(ng, dtype=torch.float32, device=tab.device)
    # group g participates when gl <= g <= gh (inclusive here; the counts'
    # exclusive bound is floor(..) + 1)
    m = (gidx[None, None, :] >= gl[:, :, None]) & (gidx[None, None, :] <= gh[:, :, None])
    return torch.any(m & tab[:, None, :], dim=2)


@dataclass
class FastGeometry:
    """One frame's shear-warp geometry, all on the device: what K3, K4 and
    K6 take, and what the warp needs to place each screen pixel."""

    m: torch.Tensor  # (1,) int32 dominant axis, the pack K3 resamples
    sgn: torch.Tensor  # (1,) int32 marching direction along the slab axis
    pos_u: torch.Tensor  # (gp, I) f32 slab sample columns (-1e6: padding)
    pos_v: torch.Tensor  # (gp, I) f32 slab sample rows
    occ_k: torch.Tensor  # (gp,) bool per-slab gate of K3
    occ_rb: torch.Tensor  # (gp, I//8) bool per-(slab, 8-row block) gate of K4
    irho: torch.Tensor  # (I, I) f32 exact-march steps per slab
    hit: torch.Tensor  # (H, W) bool box hit
    xr_u: torch.Tensor  # (H, W) f32 ref-plane crossing, u
    xr_v: torch.Tensor  # (H, W) f32 ref-plane crossing, v
    u_lo: torch.Tensor  # () f32 intermediate extent origin, u
    v_lo: torch.Tensor  # () f32 intermediate extent origin, v
    su: torch.Tensor  # () f32 intermediate texel size, u
    sv: torch.Tensor  # () f32 intermediate texel size, v


def _pick(m, vec):
    """World-axis components in the (m, v, u) frame: m=0 -> (0, 2, 1),
    m=1 -> (1, 2, 0), m=2 -> (2, 1, 0)."""
    vm = torch.where(m == 0, vec[0], torch.where(m == 1, vec[1], vec[2]))
    vv = torch.where(m == 2, vec[1], vec[2])
    vu = torch.where(m == 0, vec[1], vec[0])
    return vm, vv, vu


def fast_geometry(pack, camera_uniform, width: int, height: int,
                  intermediate: int) -> FastGeometry:
    """The per-frame geometry of ``_render_fast`` (vokselis_tpu/ops/
    shear_warp.py:168-379): dominant axis, ref-plane extent with the
    frustum clip, intermediate grid, per-slab sample positions, irho and
    the occupancy gates."""
    packs, (tab_u, tab_v) = pack
    _, dm1, d, _ = packs.shape
    fd = float(d)
    ii = intermediate
    if ii < 8 or ii % 8:
        raise ValueError(f"the intermediate must be a multiple of 8, got {ii}")
    dev = packs.device

    eye = camera_uniform.view_position[:3]
    _, dirs_s = geometry.rays_fragment_soa(camera_uniform, width, height)
    fwd = geometry.center_ray_dir(camera_uniform, width, height)
    m = torch.argmax(torch.abs(fwd))

    # eye and per-pixel slopes in the (m, v, u) frame, texel space
    # (X = p*D - 0.5, the exact kernel's texel convention)
    e_t = eye * fd - 0.5
    em, ev, eu = _pick(m, e_t)
    dmx, dvx, dux = _pick(m, dirs_s)
    sgn = torch.where(_pick(m, fwd)[0] >= 0, 1, -1).to(torch.int32).reshape(1)

    # slab planes at Z = k + 0.5; eye-inside poses get clamped divisors so
    # the frame stays finite (the factorization degrades there)
    z_ref = (fd - 1.0) / 2.0
    denom_raw = z_ref - em
    denom_ref = torch.where(torch.abs(denom_raw) < 1.0,
                            torch.where(denom_raw >= 0, 1.0, -1.0), denom_raw)

    # intermediate extent on the ref plane: the union over slabs of the
    # homothety preimages of [0, D-1]; s(k) is monotonic, so the first and
    # last sample planes suffice
    ks = torch.arange(2, dtype=torch.float32, device=dev) * (dm1 - 1.0) + 0.5

    def extent(e_axis):
        s = (ks - em) / denom_ref
        s = torch.where(torch.abs(s) < 1e-3, torch.where(s >= 0, 1e-3, -1e-3), s)
        lo = (0.0 - e_axis) / s + e_axis
        hi = (fd - 1.0 - e_axis) / s + e_axis
        both = torch.cat([lo, hi])
        return torch.min(both), torch.max(both)

    u_lo, u_hi = extent(eu)
    v_lo, v_hi = extent(ev)

    # frustum clip: intersect with the hit rays' ref-plane bounding box
    tf0, tf1 = geometry.intersect_box_soa(eye[0], eye[1], eye[2], *dirs_s, 0.0, 1.0)
    hitf = tf0 <= tf1
    safe_dmf = torch.where(torch.abs(dmx) < 1e-8, 1e-8, dmx)
    xr_u = eu + denom_ref * dux / safe_dmf
    xr_v = ev + denom_ref * dvx / safe_dmf

    def ray_bbox(xr, lo, hi):
        # robust [0.2%, 99.8%] quantile box over an (::8, ::8) subsample of
        # the hit rays: a hard min/max would chase the silhouette rays whose
        # crossings diverge (1/d_m)
        xs = xr[::8, ::8].reshape(-1)
        oks = (hitf[::8, ::8].reshape(-1)) & torch.isfinite(xs)
        n_ok = oks.sum()
        srt = torch.sort(torch.where(oks, xs, math.inf)).values
        nf = torch.clamp(n_ok.float(), min=1.0)
        n = srt.shape[0]
        tail = (0.002 * nf).long()
        mn = torch.take(srt, torch.clamp(tail, 0, n - 1))
        mx = torch.take(srt, torch.clamp(n_ok - 1 - tail, 0, n - 1))
        pad = 0.05 * (mx - mn) + 2.0
        good = (n_ok > 0) & torch.isfinite(mn) & torch.isfinite(mx)
        return (torch.where(good, torch.maximum(lo, mn - pad), lo),
                torch.where(good, torch.minimum(hi, mx + pad), hi))

    u_lo, u_hi = ray_bbox(xr_u, u_lo, u_hi)
    v_lo, v_hi = ray_bbox(xr_v, v_lo, v_hi)

    # half-texel pad so border bilinear taps are interior
    u_lo, u_hi = u_lo - 1.0, u_hi + 1.0
    v_lo, v_hi = v_lo - 1.0, v_hi + 1.0
    su = (u_hi - u_lo) / ii
    sv = (v_hi - v_lo) / ii
    cells = torch.arange(ii, dtype=torch.float32, device=dev) + 0.5
    grid_u = u_lo + cells * su
    grid_v = v_lo + cells * sv

    # exact-march steps per slab of each intermediate texel's ray: its
    # direction (z_ref - em, gv - ev, gu - eu) is separable per axis
    au = torch.abs(grid_u - eu) / torch.abs(denom_ref)
    av = torch.abs(grid_v - ev) / torch.abs(denom_ref)
    irho = torch.clamp(torch.maximum(av[:, None], au[None, :]), min=1.0)

    gp = (dm1 + 7) // 8 * 8
    s_k = (torch.arange(gp, dtype=torch.float32, device=dev) + 0.5 - em) / denom_ref
    pos_u = eu + s_k[:, None] * (grid_u[None, :] - eu)
    pos_v = ev + s_k[:, None] * (grid_v[None, :] - ev)
    # padding slabs k >= G: an off-grid sentinel, all-zero taps in K3
    valid = (torch.arange(gp, device=dev) < dm1)[:, None]
    pos_u = torch.where(valid, pos_u, -1e6)
    pos_v = torch.where(valid, pos_v, -1e6)

    # volume-side occupancy from the static group tables (pos_* are affine
    # per slab, so a block's window comes from its end points): per slab,
    # any hot window along u; per 8-row block, a hot window along v
    mi = m.reshape(1)

    def pad_tab(tab):
        t = tab.index_select(0, mi)[0]
        return torch.cat([t, t.new_zeros((gp - dm1, t.shape[1]))])

    ub = math.gcd(ii, 128)  # the JAX package's 128-column u blocks
    pu_e = pos_u.reshape(gp, ii // ub, ub)
    pv_e = pos_v.reshape(gp, ii // 8, 8)
    occ2_u = _window_any(pad_tab(tab_u),
                         torch.minimum(pu_e[:, :, 0], pu_e[:, :, -1]),
                         torch.maximum(pu_e[:, :, 0], pu_e[:, :, -1]))
    occ2_v = _window_any(pad_tab(tab_v),
                         torch.minimum(pv_e[:, :, 0], pv_e[:, :, -1]),
                         torch.maximum(pv_e[:, :, 0], pv_e[:, :, -1]))
    any_u = occ2_u.any(dim=1)
    occ_k = any_u & occ2_v.any(dim=1)
    # a row block needs slab k when its v window is hot and the slab has a
    # hot u window (the resample is full-width)
    occ_rb = occ2_v & any_u[:, None]

    return FastGeometry(
        m=m.to(torch.int32).reshape(1), sgn=sgn, pos_u=pos_u.contiguous(),
        pos_v=pos_v.contiguous(), occ_k=occ_k, occ_rb=occ_rb.contiguous(),
        irho=irho.contiguous(), hit=hitf, xr_u=xr_u, xr_v=xr_v, u_lo=u_lo,
        v_lo=v_lo, su=su, sv=sv)


def _render_fast(pack, camera_uniform, width: int, height: int,
                 intermediate: int, srgb: bool, return_aux=False,
                 plain: bool = False):
    """One fast frame: geometry, then the slab stage (K3 -> K4 fused in one
    kernel, :func:`shear_resample.resample_composite`) and K6 (K5 for
    "stats").
    Returns the (H, W, 4) f32 image (sRGB-encoded rgb when ``srgb``, alpha
    1), or with ``return_aux``:

    - ``True``: ``(img, bad, errd)`` as the JAX package's
      (shear_warp.py:610-639): ``bad`` (H, W) int8, bit 1 where a box-hit
      ray falls outside the warp extent (rendered black); bit 2 (window
      overflow) is never set, there is no window. ``errd`` (H, W) f32, the
      warped curvature channel where ok, else 0.
    - ``"stats"``: the hybrid's contract (shear_warp.py:541-573) in frame
      layout: the ok-masked linear r, g, b as a (3, H, W) f32 tensor and
      the (cdiv(H,32) * cdiv(W,32), 5) per-tile stats of
      :func:`vokselis_torch.ops.cuda.warp2d.warp_stats` (``srgb`` is
      ignored: the planes stay linear).

    The TPU-only ``"packed*"`` contracts raise ``NotImplementedError``.
    ``plain=True`` runs the stages' plain versions even on CUDA tensors:
    the reference that the card's checks hold the kernels to."""
    if isinstance(return_aux, str) and return_aux != "stats":
        raise NotImplementedError(
            f"return_aux={return_aux!r}: the packed (n_tiles*8, 128) contracts "
            "existed for the TPU's VMEM and its cost probes and are not ported "
            "(ROADMAP.md, deliberate removals); use \"stats\"")
    geo = fast_geometry(pack, camera_uniform, width, height, intermediate)
    sr = shear_resample
    slab_stage = sr.resample_composite_plain if plain else sr.resample_composite
    planes = slab_stage(pack[0], geo.m, geo.pos_u, geo.pos_v, geo.sgn, geo.irho, geo.occ_k,
                        geo.occ_rb)
    return _warp_to_screen(planes, geo, srgb, plain=plain, return_aux=return_aux)


def curvature(planes):
    """The intermediate's local curvature summed over r, g, b: per channel
    |2c - c(v-1) - c(v+1)| + |2c - c(u-1) - c(u+1)|, the neighbours taken
    with ``torch.roll`` (wrapping at the border, as ``jnp.roll`` in
    shear_warp.py:534-539). The warped curvature at a pixel bounds the
    bilinear warp's reconstruction error there; the hybrid ranks tiles by
    it."""
    def curv(c):
        d2v = torch.abs(2.0 * c - torch.roll(c, 1, 0) - torch.roll(c, -1, 0))
        d2u = torch.abs(2.0 * c - torch.roll(c, 1, 1) - torch.roll(c, -1, 1))
        return d2v + d2u

    return curv(planes[0]) + curv(planes[1]) + curv(planes[2])


def warp_coords(geo: FastGeometry, ii_v: int, ii_u: int):
    """Per-pixel intermediate coordinates of the screen warp: (av, bu, ok),
    each (H, W). ``ok`` excludes misses and rays whose ref-plane crossing
    lands outside the intermediate's extent (+4 texels; side-entry and
    near-slab-parallel rays, whose crossings diverge as 1/d_m); those are
    parked at +1e6 and render black."""
    bu = (geo.xr_u - geo.u_lo) / geo.su - 0.5
    av = (geo.xr_v - geo.v_lo) / geo.sv - 0.5
    pad_ext = 4.0
    in_ext = ((av > -pad_ext) & (av < ii_v - 1 + pad_ext)
              & (bu > -pad_ext) & (bu < ii_u - 1 + pad_ext))
    ok = geo.hit & torch.isfinite(av) & torch.isfinite(bu) & in_ext
    return torch.where(ok, av, 1e6), torch.where(ok, bu, 1e6), ok


def _warp_to_screen(planes, geo: FastGeometry, srgb: bool, plain: bool = False,
                    return_aux=False):
    """Final homography warp of the composited intermediate (the r, g, b
    planes of ``planes``) to the screen; K6 (K5 for ``return_aux="stats"``)
    masks the pixels that :func:`warp_coords` excludes. ``return_aux`` as
    in :func:`_render_fast`."""
    av, bu, ok = warp_coords(geo, *planes.shape[1:])
    if return_aux:
        chans = torch.cat([planes[:3], curvature(planes)[None]])
    else:
        chans = planes[:3]
    if return_aux == "stats":
        warp_st = warp2d.warp_stats_plain if plain else warp2d.warp_stats
        return warp_st(chans, av, bu, ok, geo.hit)
    warp = warp2d.warp_plain if plain else warp2d.warp_bilinear
    out = warp(chans, av, bu, ok)
    img = finish(out[:3], srgb)
    if return_aux:
        bad = (geo.hit & ~ok).to(torch.int8)
        return img, bad, out[3]
    return img


def finish(rgb, srgb: bool):
    """(3, H, W) linear rgb planes -> the (H, W, 4) f32 image of the fast
    and hybrid frames (sRGB-encoded rgb when ``srgb``, alpha 1)."""
    out = rgb.permute(1, 2, 0)
    if srgb:
        out = linear_to_srgb(out)
    alpha = torch.ones(out.shape[:2] + (1,), dtype=torch.float32, device=out.device)
    return torch.cat([out, alpha], dim=-1)


def traced_degenerate(camera_uniform, d: int):
    """Device-side mirror of :func:`pose_hint`'s scalar degeneracy criteria:
    (a) the eye inside/near the slab range along the dominant axis (the
    s(k) homothety divisor crosses ~zero) and (b) nearest-slab scale
    collapse (s_near < 0.25 — close-up poses whose near slabs the
    intermediate under-resolves >= 4x). Returns a 0-d bool tensor without
    reading anything on the host. pose_hint's third criterion (median tile
    span, the magnification) needs the coarse ray grid and is not mirrored."""
    inv = camera_uniform.inv_proj
    n = geometry.mat4_apply(inv, 0.0, 0.0, 0.0)
    f = geometry.mat4_apply(inv, 0.0, 0.0, 1.0)
    fwd = torch.stack([f[i] / f[3] - n[i] / n[3] for i in range(3)])
    fd = float(d)
    e_t = camera_uniform.view_position[:3] * fd - 0.5
    em = torch.take(e_t, torch.argmax(torch.abs(fwd)))
    z_ref = (fd - 1.0) / 2.0
    denom_raw = z_ref - em
    degen_eye = torch.abs(denom_raw) <= (fd - 1.0) / 2.0 + 8.0
    den = torch.where(torch.abs(denom_raw) < 1.0,
                      torch.where(denom_raw >= 0, 1.0, -1.0), denom_raw)
    s_near = torch.minimum(torch.abs((0.5 - em) / den), torch.abs((fd - 1.5 - em) / den))
    return degen_eye | (s_near < 0.25)


def _win_rows(ii: int, height: int, width: int) -> int:
    """The JAX package's default warp row window (warp2d.py:_win_rows),
    the first of pose_hint's window buckets."""
    est = int(1.84 * TILE * ii / max(min(height, width), 1)) + 10
    return min(ii, min(WIN_CAP, ((est + 7) // 8) * 8))


_HINT_CACHE: dict = {}


def pose_hint(camera_uniform, width: int, height: int, intermediate: int,
              d: int, stride: int = 8):
    """Host-side pose classification: returns ``(warp_win, warp_wu,
    degenerate)`` as the JAX package's ``pose_hint`` computes them, from a
    coarse (stride-subsampled) float64 numpy replica of the frame geometry.

    ``degenerate`` is True when the shear-warp factorization degrades: the
    eye is inside/near the slab range along the dominant axis, the nearest
    slab's scale collapses (s_near < 0.25), or the intermediate is magnified
    >~2x onto the screen (median tile span < 12 texels). The hybrid renderer
    reads it. The window buckets size the TPU warp's VMEM windows; this
    port's warp has none and does not use them.

    Reads the uniform's host mirrors ``host_np`` when it carries them (a
    :meth:`Camera.uniform`), and otherwise its tensors on the device (three
    copies to the host), as the JAX package does (shear_warp.py:738-745);
    results are cached by the uniform's bytes."""
    host = getattr(camera_uniform, "host_np", None)
    if host is not None:
        vp_a, pv_a, ip_a = host
    else:
        vp_a, pv_a, ip_a = (t.detach().cpu().numpy() for t in (
            camera_uniform.view_position, camera_uniform.proj_view, camera_uniform.inv_proj))
    pv_a = np.asarray(pv_a, np.float64)
    key = (pv_a.tobytes(), bytes(np.asarray(vp_a, np.float64)),
           width, height, intermediate, d)
    cached = _HINT_CACHE.get(key)
    if cached is not None:
        return cached

    ii = intermediate
    fd = float(d)
    eye = np.asarray(vp_a, np.float64)[:3]
    inv = np.asarray(ip_a, np.float64)

    # coarse pixel grid (mirrors geometry.rays_fragment)
    px = np.arange(stride / 2.0, width, stride, dtype=np.float64)
    py = np.arange(stride / 2.0, height, stride, dtype=np.float64)
    ndc_x = 2.0 * (px + 0.5) / width - 1.0
    ndc_y = 1.0 - 2.0 * (py + 0.5) / height
    gx, gy = np.meshgrid(ndc_x, ndc_y)  # (ny, nx)

    def unproj(z):
        h = np.stack([gx, gy, np.full_like(gx, z), np.ones_like(gx)], 0)
        p = np.einsum("ij,jyx->iyx", inv, h)
        return p[:3] / p[3:4]

    dirs = unproj(1.0) - unproj(0.0)  # (3, ny, nx), unnormalized
    cy, cx = dirs.shape[1] // 2, dirs.shape[2] // 2
    fwd = dirs[:, cy, cx]
    m = int(np.argmax(np.abs(fwd)))
    ax = {0: (0, 2, 1), 1: (1, 2, 0), 2: (2, 1, 0)}[m]
    e_t = eye * fd - 0.5
    em, ev, eu = e_t[ax[0]], e_t[ax[1]], e_t[ax[2]]
    dm, dv, du = dirs[ax[0]], dirs[ax[1]], dirs[ax[2]]
    z_ref = (fd - 1.0) / 2.0
    denom_raw = z_ref - em
    # degenerate when the eye is inside/near the slab range along m ...
    degen = abs(denom_raw) <= (fd - 1.0) / 2.0 + 8.0
    den = denom_raw
    if abs(den) < 1.0:
        den = 1.0 if den >= 0 else -1.0
    # ... or when the nearest slab's homothety scale s(k) = (k - em)/den
    # collapses: the intermediate resolves it at ~s_near x its resolution
    s_near = min(abs((0.5 - em) / den), abs((fd - 1.5 - em) / den))
    degen = degen or s_near < 0.25

    ks = np.array([0.5, fd - 1.5])

    def extent(e_axis):
        s = (ks - em) / den
        s = np.where(np.abs(s) < 1e-3, np.where(s >= 0, 1e-3, -1e-3), s)
        both = np.concatenate(
            [(0.0 - e_axis) / s + e_axis, (fd - 1.0 - e_axis) / s + e_axis]
        )
        return both.min(), both.max()

    u_lo, u_hi = extent(eu)
    v_lo, v_hi = extent(ev)

    # box hit test (slab method on the unit cube)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_d = 1.0 / dirs
        t0 = (0.0 - eye[:, None, None]) * inv_d
        t1 = (1.0 - eye[:, None, None]) * inv_d
        tn = np.minimum(t0, t1).max(axis=0)
        tf = np.maximum(t0, t1).min(axis=0)
        hit = tn <= tf

        safe = np.where(np.abs(dm) < 1e-8, 1e-8, dm)
        xr_u = eu + den * du / safe
        xr_v = ev + den * dv / safe

    # robust frustum clip of the union extent (mirrors fast_geometry)
    def ray_bbox(xr, lo, hi):
        vals = xr[hit & np.isfinite(xr)]
        if vals.size == 0:
            return lo, hi
        mn, mx = np.quantile(vals, [0.002, 0.998])
        pad = 0.05 * (mx - mn) + 2.0
        return max(lo, mn - pad), min(hi, mx + pad)

    u_lo, u_hi = ray_bbox(xr_u, u_lo, u_hi)
    v_lo, v_hi = ray_bbox(xr_v, v_lo, v_hi)
    u_lo, u_hi = u_lo - 1.0, u_hi + 1.0
    v_lo, v_hi = v_lo - 1.0, v_hi + 1.0
    su = (u_hi - u_lo) / ii
    sv = (v_hi - v_lo) / ii

    with np.errstate(invalid="ignore"):
        bu = (xr_u - u_lo) / su - 0.5
        av = (xr_v - v_lo) / sv - 0.5
    ok = (hit & np.isfinite(av) & np.isfinite(bu)
          & (av > -4.0) & (av < ii + 3.0) & (bu > -4.0) & (bu < ii + 3.0))
    av = np.where(ok, av, np.nan)
    bu = np.where(ok, bu, np.nan)

    spt = TILE // stride  # samples per tile side
    ny, nx = av.shape
    ty, tx = ny // spt, nx // spt

    def tile_spans(c):
        t = c[: ty * spt, : tx * spt].reshape(ty, spt, tx, spt)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN tiles
            s = np.nanmax(t, axis=(1, 3)) - np.nanmin(t, axis=(1, 3))
        # a mostly-parked (silhouette) tile yields a degenerate near-zero
        # span: demand a mostly-interior tile for the statistics
        n_ok = np.isfinite(t).sum(axis=(1, 3))
        s = np.where(n_ok >= (spt * spt) * 3 // 4, s, np.nan)
        return s[np.isfinite(s)]

    vs, us = tile_spans(av), tile_spans(bu)
    scale = 32.0 / max(32 - stride, 1)  # coarse max-min undercovers
    if vs.size == 0:
        win, wu, med = 0, 128, np.inf
    else:
        v99 = float(np.quantile(vs, 0.995)) * scale + 6.0
        u99 = float(np.quantile(us, 0.995)) * scale + 6.0
        if v99 <= _win_rows(ii, height, width):
            win = 0
        elif v99 <= 64:
            win = 64
        elif v99 <= 96:
            win = 96
        else:
            win = 128
        wu = 128 if u99 <= 124 else 256
        med = float(np.median(vs)) * scale
    # magnification >~2x: intermediate under-resolved for the screen
    degen = bool(degen or med < 12.0)

    out = (win, wu, degen)
    if len(_HINT_CACHE) > 512:
        _HINT_CACHE.clear()
    _HINT_CACHE[key] = out
    return out


def _fast_frame(pack, compiled, camera_uniform, width, height, intermediate, srgb):
    """:func:`_render_fast` of ``pack`` through ``compiled``, one graph per
    ``(width, height, intermediate, srgb)``, the JAX package's static
    arguments of ``_render_fast`` less the TPU's warp windows."""
    def fn(u):
        return _render_fast(pack, u, width, height, intermediate, srgb)

    return compiled(("fast", width, height, intermediate, bool(srgb)), fn, (camera_uniform,),
                    reads=pack)


class FastBonsaiRenderer:
    """renderer="fast": whole-frame shear-warp approximation. Holds the
    half-shifted per-axis packs and occupancy tables on ``device``; call
    like :class:`vokselis_torch.ops.cuda.march_bonsai.BonsaiRenderer`.
    Degenerate poses (see :func:`pose_hint`) still render fast; the hybrid
    renderer is the one that routes them to the exact kernel. On a card a
    call replays the frame's CUDA graph (``compiled``); :func:`_render_fast`
    is the eager frame."""

    def __init__(self, vol_u8, device, intermediate: int = 512):
        self.device = torch.device(device)
        self.packs = prepare_fast_volume(vol_u8, self.device)
        self.intermediate = intermediate
        self.dims = int(self.packs[0].shape[2])
        self.compiled = CompiledFrame("FastBonsaiRenderer")

    def __call__(self, camera_uniform, width=1280, height=720, srgb=True,
                 max_steps: int = MAX_STEPS_BONSAI, intermediate=None):
        """Render one frame; ``max_steps`` is accepted for API parity with
        the exact renderer (a fast frame takes one sample per slab)."""
        return _fast_frame(self.packs, self.compiled, camera_uniform, width, height,
                           intermediate or self.intermediate, srgb)


def build_fast_renderer(vol_u8, device, intermediate: int = 512):
    """Functional (render, pack) pair matching
    :func:`vokselis_torch.ops.cuda.march_bonsai.build_renderer`'s
    signature; on a card render replays one CUDA graph per static key."""
    pack = prepare_fast_volume(vol_u8, device)
    compiled = CompiledFrame("build_fast_renderer")

    def render(pk, camera_uniform, width, height, max_steps=MAX_STEPS_BONSAI,
               srgb=True):
        return _fast_frame(pk, compiled, camera_uniform, width, height, intermediate, srgb)

    return render, pack
