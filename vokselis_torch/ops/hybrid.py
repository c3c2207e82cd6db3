"""Hybrid bonsai renderer (``renderer="hybrid"``): a fast shear-warp frame
plus an exact re-march of the tiles where its error concentrates (the
counterpart of ``vokselis_tpu/ops/hybrid.py``).

The fast frame's error sits on a small set of high-contrast 32x32 screen
tiles (silhouettes, volume edges, side-entry sample phase), so per frame:

1. the fast frame in linear color (:func:`vokselis_torch.ops.shear_warp.
   _render_fast`: K3 -> K4 fused) warped by K5, which also reduces the per-tile
   score statistics (:mod:`vokselis_torch.ops.cuda.warp2d`);
2. a score per tile (warped curvature x sRGB slope, a small luminance-edge
   term, and the extent-excluded pixels weighted by the dilated peak
   luminance) and the top ``budget`` tiles above ``thresh`` (torch);
3. the exact re-march of the selected tiles, or tile pairs, written in place
   over the fast frame (K2, :func:`vokselis_torch.ops.cuda.march_bonsai.
   render_bonsai_tiles_into`);
4. sRGB encoding.

The selection stays on the device: the budget is static, so K2 always runs
``budget`` units and parked picks do nothing. Degenerate poses (the
shear-warp factorization breaks, :func:`shear_warp.pose_hint`) escalate the
intermediate or fall back to the exact K1 frame, and dense volumes render
every frame with K1. On CUDA tensors the stages launch their kernels; on the
CPU their plain versions run.
"""

from __future__ import annotations

import numpy as np
import torch

from vokselis_torch.core.compiled import CompiledFrame
from vokselis_torch.ops.cuda.march_bonsai import (
    BonsaiRenderer,
    render_bonsai_tiles_into,
    render_bonsai_tiles_into_plain,
)
from vokselis_torch.ops.cuda.warp2d import (
    STAT_CURV,
    STAT_EDGE,
    STAT_EXT,
    STAT_OVF,
    STAT_PEAK,
)
from vokselis_torch.ops.reference import MAX_STEPS_BONSAI
from vokselis_torch.ops.shear_warp import (
    OCC_EPS,
    _render_fast,
    finish,
    pose_hint,
    prepare_fast_volume,
    traced_degenerate,
)
from vokselis_torch.utils.grid import TILE, cdiv

# tile-score threshold below which a tile is never re-marched (hybrid.py:66-67)
DEFAULT_THRESH = 1e-3
DEFAULT_BUDGET = 128

# volumes whose occupied-voxel fraction (density > OCC_EPS) exceeds this
# render every frame with the exact kernel (hybrid.py:69-79): the hybrid's
# error model assumes concentrated error, and on dense fog it is diffuse
# (the bonsai measures 0.054, the 50 %-occupancy fog 0.41)
DENSE_OCC_FRAC = 0.25

# escalation steps of the intermediate for poses degenerate at the base one
ESCALATION = (768, 1024)
# the window-row cap of the JAX renderer's re-march layouts (its win_cap),
# which its pair policy gates on
PAIR_WINDOW_CAP = 128


def _pair_window_demand(dims: int, width: int, height: int) -> int:
    """The JAX package's window-row demand of a fused tile pair
    (march_bonsai.py:1234-1240)."""
    est = (3 * dims * 2 * TILE) // max(min(width, height), 1) + 32
    return max(96, (est + 16 + 7) // 8 * 8)


def pick_tiles_per_step(dims: int, width: int, height: int, cap: int = 128) -> int:
    """The JAX package's integer policy for fusing two tiles per re-march
    unit (march_bonsai.py:1243-1257): 2 when a pair's slab footprint fits a
    <= 128-row window within ``cap``. It decides the selection granularity,
    which is what the reference's accuracy records were taken at (pairs at
    1024^2 with D=256, single tiles at 256^2)."""
    est = (3 * dims * 2 * TILE) // max(min(width, height), 1) + 32
    demand = min(128, _pair_window_demand(dims, width, height))
    return 2 if est <= 128 and demand <= min(cap, 128) else 1


def _pair_mode(dims: int, width: int, height: int, cap: int = PAIR_WINDOW_CAP) -> bool:
    """True when the re-march fuses horizontal tile pairs (hybrid.py:95-101):
    an even tile row and :func:`pick_tiles_per_step` == 2."""
    return cdiv(width, TILE) % 2 == 0 and pick_tiles_per_step(dims, width, height, cap) == 2


def select_units(scores, n_tiles: int, budget: int, thresh: float, pair: bool):
    """Re-march unit ids from the per-tile ``scores`` (n_tiles,) f32, on the
    device (hybrid.py:104-134), as (k,) int32 with a static k.

    Single tiles: the top ``budget`` tiles; a pick not above ``thresh``
    parks at the sentinel ``n_tiles``. Pairs (ids index pairs of
    raster-consecutive tiles): ranked by the sum of the two scores, gated on
    the larger one; ``budget`` counts tiles, so min(max(budget // 2, 1),
    n_tiles // 2) pairs; the sentinel is ``n_tiles // 2``."""
    if pair:
        n_units = n_tiles // 2
        budget_u = min(max(budget // 2, 1), n_units)
        pair_scores = scores.reshape(n_units, 2)
        _, ids = torch.topk(pair_scores.sum(dim=1), budget_u)
        gate = pair_scores.amax(dim=1)[ids]
        return torch.where(gate > thresh, ids, n_units).to(torch.int32)
    vals, ids = torch.topk(scores, min(budget, n_tiles))
    return torch.where(vals > thresh, ids, n_tiles).to(torch.int32)


def unit_pixel_mask(ids, tpu: int, width: int, height: int):
    """The (height, width) bool mask of the pixels that the re-march units
    ``ids`` ((k,) int tensor, units of ``tpu`` raster-consecutive tiles)
    cover, on the ids' device; parked ids cover nothing."""
    ny, nx = cdiv(height, TILE), cdiv(width, TILE)
    ids = ids.long()
    ids = ids[ids < ny * nx // tpu]
    tiles = (ids[:, None] * tpu + torch.arange(tpu, device=ids.device)).reshape(-1)
    mask = torch.zeros(ny * nx, dtype=torch.bool, device=ids.device)
    mask[tiles] = True
    mask = mask.reshape(ny, nx).repeat_interleave(TILE, 0).repeat_interleave(TILE, 1)
    return mask[:height, :width]


def _dilate3(t):
    """3x3 max filter over the (ny, nx) tile grid, zero-padded
    (hybrid.py:137-145)."""
    p = torch.nn.functional.pad(t, (1, 1, 1, 1))
    h, w = t.shape
    return torch.stack([p[i:i + h, j:j + w] for i in range(3) for j in range(3)]).amax(dim=0)


def score_tiles(stats, ny: int, nx: int):
    """Per-tile scores from K5's stats (hybrid.py:259-266): curvature x
    slope plus 0.03 x edge, per tile pixel, plus the extent-excluded
    (and window-overflowed, x4: a column K5 writes as 0) pixel share
    weighted by the 3x3-dilated peak luminance."""
    inv_px = 1.0 / (8 * 128)
    scores = (stats[:, STAT_CURV] + 0.03 * stats[:, STAT_EDGE]) * inv_px
    tile_peak = _dilate3(stats[:, STAT_PEAK].reshape(ny, nx))
    degr = (stats[:, STAT_EXT] + 4.0 * stats[:, STAT_OVF]) * inv_px
    return scores + (degr.reshape(ny, nx) * tile_peak).reshape(-1)


def _render_hybrid(packs, vol, camera_uniform, thresh, width: int, height: int,
                   intermediate: int, budget: int, srgb: bool,
                   max_steps: int = MAX_STEPS_BONSAI, pair: bool = False,
                   plain: bool = False):
    """One hybrid frame (hybrid.py:177-315). Returns ``(img, ids)``: the
    (H, W, 4) image and the selected unit ids (None at budget 0).
    ``plain=True`` runs every stage's plain version even on CUDA tensors."""
    rgb, stats = _render_fast(packs, camera_uniform, width, height, intermediate,
                              False, return_aux="stats", plain=plain)
    ids = None
    if budget > 0:
        ny, nx = cdiv(height, TILE), cdiv(width, TILE)
        ids = select_units(score_tiles(stats, ny, nx), ny * nx, budget, thresh, pair)
        march = render_bonsai_tiles_into_plain if plain else render_bonsai_tiles_into
        # the palette's polynomial form: <= 1.4e-6 per channel, far inside
        # the hybrid's 1e-3 contract (hybrid.py:305-309)
        march(vol, rgb, camera_uniform, ids, width, height, 2 if pair else 1,
              fast_transfer=True, max_steps=max_steps)
    return finish(rgb, srgb), ids


class HybridBonsaiRenderer:
    """renderer="hybrid": shear-warp frame + exact re-march of the worst
    tiles, on ``device``. Call like
    :class:`vokselis_torch.ops.cuda.march_bonsai.BonsaiRenderer`.
    ``exact`` is the K1 renderer of the same volume tensor, which renders
    degenerate poses and dense volumes. The route is chosen on the host;
    on a card each route replays a CUDA graph of its frame (``compiled``,
    which ``exact`` shares, so that all the renderer's graphs share one
    memory pool): :func:`_render_hybrid` for "hybrid" and "escalated",
    the exact frame for "exact" and "dense". :func:`_render_hybrid` is
    the eager frame."""

    def __init__(self, vol_u8, device, intermediate: int = 512,
                 budget: int = DEFAULT_BUDGET, thresh: float = DEFAULT_THRESH):
        self.device = torch.device(device)
        vol_np = (vol_u8.detach().cpu().numpy() if isinstance(vol_u8, torch.Tensor)
                  else np.asarray(vol_u8))
        self.packs = prepare_fast_volume(vol_np, self.device)
        self.compiled = CompiledFrame("HybridBonsaiRenderer")
        self.exact = BonsaiRenderer(vol_np, self.device, compiled=self.compiled)
        self.vol = self.exact.vol
        self.dims = int(self.vol.shape[0])
        self.intermediate = intermediate
        self.budget = budget
        self.thresh = thresh
        # u8 > OCC_EPS * 255 is exactly u8 / 255 > OCC_EPS (hybrid.py:340-344)
        self.occ_frac = float((vol_np > OCC_EPS * 255.0).mean())
        self.dense_fallback = self.occ_frac > DENSE_OCC_FRAC

    def route(self, camera_uniform, width: int = 1280, height: int = 720,
              budget: int | None = None, hint=None):
        """How a frame at this pose renders (hybrid.py:359-420): ``(mode,
        intermediate, budget)`` with mode "dense" or "exact" (the K1 frame;
        intermediate and budget None), "hybrid", or "escalated" (a pose
        degenerate at the base intermediate that is not at 768 or 1024,
        with 1.5x the budget). Classifies the pose on the host through
        :func:`pose_hint` unless ``hint=(_, _, degenerate)`` is given: from a
        :meth:`Camera.uniform`'s host mirrors without a device read."""
        if self.dense_fallback:
            return "dense", None, None
        degen = (hint if hint is not None else
                 pose_hint(camera_uniform, width, height, self.intermediate, self.dims))[2]
        ii, mode = self.intermediate, "hybrid"
        if degen and hint is None:
            for ii_up in (i for i in ESCALATION if i > ii):
                if not pose_hint(camera_uniform, width, height, ii_up, self.dims)[2]:
                    degen, ii, mode = False, ii_up, "escalated"
                    break
        if degen:
            return "exact", None, None
        b = self.budget if budget is None else budget
        if mode == "escalated":
            b = b + (b + 1) // 2
        return mode, ii, b

    def _call_traced(self, camera_uniform, width: int = 1280, height: int = 720,
                     max_steps: int = MAX_STEPS_BONSAI, srgb: bool = True,
                     budget: int | None = None, hint=None, route=None):
        """One frame along :meth:`route`, or along ``route`` when the
        caller has classified the pose already."""
        mode, ii, b = (self.route(camera_uniform, width, height, budget, hint)
                       if route is None else route)
        if mode in ("dense", "exact"):
            return self.exact(camera_uniform, width, height, max_steps, srgb)
        return self._hybrid_frame((self.packs, self.vol), camera_uniform, width, height, ii,
                                  b, srgb, max_steps, False)

    def _hybrid_frame(self, pk, camera_uniform, width, height, ii, budget, srgb, max_steps,
                      with_degraded):
        """:func:`_render_hybrid` of the pack ``pk`` through :attr:`compiled`:
        one graph per ``(width, height, intermediate, budget, srgb,
        max_steps)`` (the pair mode and the threshold follow from them and
        the renderer), which returns the image, and with ``with_degraded``
        also :func:`traced_degenerate`'s flag, computed in the graph."""
        packs, vol = pk
        pair = _pair_mode(self.dims, width, height)
        thresh = self.thresh

        def fn(u):
            img = _render_hybrid(packs, vol, u, thresh, width, height, ii, budget, srgb,
                                 max_steps, pair)[0]
            return (img, traced_degenerate(u, self.dims)) if with_degraded else img

        key = ("hybrid", width, height, ii, budget, bool(srgb), max_steps, pair, thresh,
               with_degraded)
        return self.compiled(key, fn, (camera_uniform,), reads=pk)

    def functional(self):
        """``(render, pack)`` for callers that render many frames without the
        host-side pose classification (the JAX package's builders "for jit
        pipelines where the camera is TRACED"): ``render(pack, camera_uniform,
        width, height, hint=None, max_steps=, srgb=, budget=None,
        with_degraded=True)`` -> ``(img, degraded)`` (``img`` with
        ``with_degraded=False``). It never escalates nor falls back:
        ``degraded`` (a 0-d bool tensor, :func:`traced_degenerate`) marks
        frames whose pose breaks the shear-warp factorization, whose pixels
        are outside the error contract. ``hint`` is accepted for API parity
        (the TPU's warp windows) and unused. On a card render replays one
        CUDA graph per static key, the flag computed in it; it never reads
        the device on the host. For a dense volume the render is the exact
        kernel (:attr:`exact`, which holds ``pack``'s volume tensor) and
        ``degraded`` is False."""
        pack = (self.packs, self.vol)

        if self.dense_fallback:
            def render_exact(pk, camera_uniform, width, height, hint=None,
                             max_steps=MAX_STEPS_BONSAI, srgb=True, budget=None,
                             with_degraded=True):
                img = self.exact(camera_uniform, width, height, max_steps, srgb)
                if with_degraded:
                    return img, torch.zeros((), dtype=torch.bool, device=img.device)
                return img

            return render_exact, pack

        def render(pk, camera_uniform, width, height, hint=None,
                   max_steps=MAX_STEPS_BONSAI, srgb=True, budget=None,
                   with_degraded=True):
            return self._hybrid_frame(pk, camera_uniform, width, height, self.intermediate,
                                      self.budget if budget is None else budget, srgb,
                                      max_steps, with_degraded)

        return render, pack

    def __call__(self, camera_uniform, width: int = 1280, height: int = 720,
                 max_steps: int = MAX_STEPS_BONSAI, srgb: bool = True,
                 budget: int | None = None, route=None):
        """One frame; ``route``: this pose's :meth:`route` at this frame,
        if the caller has it (the pose is then not classified again)."""
        return self._call_traced(camera_uniform, width, height, max_steps, srgb, budget,
                                 route=route)


def build_hybrid_renderer(vol_u8, device, intermediate: int = 512,
                          budget: int = DEFAULT_BUDGET, thresh: float = DEFAULT_THRESH):
    """Functional ``(render, pack)`` pair: ``render(pack, camera_uniform,
    width, height, max_steps=, srgb=, hint=None)`` -> ``(img, degraded)``,
    with no pose classification (see :meth:`HybridBonsaiRenderer.functional`):
    when ``degraded`` is True the frame is outside the error contract.
    Use :class:`HybridBonsaiRenderer` to escalate and fall back per pose."""
    r = HybridBonsaiRenderer(vol_u8, device, intermediate, budget, thresh)
    frender, pack = r.functional()

    def render(pk, camera_uniform, width, height, max_steps=MAX_STEPS_BONSAI,
               srgb=True, hint=None):
        return frender(pk, camera_uniform, width, height, hint=hint, max_steps=max_steps,
                       srgb=srgb)

    return render, pack
