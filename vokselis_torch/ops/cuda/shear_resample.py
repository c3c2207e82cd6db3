"""K3 (slab resample) and K4 (composite, with K4b as its exact-transfer
mode): the shear-warp fast renderer's slab stages as hand-written CUDA
kernels for Hopper, and the two fused into one kernel
(:func:`resample_composite`), the slab stage of the fast and hybrid frames.

The kernels (``vokselis_torch/csrc/shear_resample.cu``) replace the TPU
kernels ``vokselis_tpu/ops/pallas/shear_resample.py:_resample_kernel`` and
``:_composite_chunks_kernel``, and ``composite.py:_composite_kernel`` (the
exact-transfer composite). They are built with ``nvcc`` at first use on a
CUDA device (:mod:`vokselis_torch.ops.cuda.build`); importing builds nothing.

:func:`resample_slabs` and :func:`composite` launch their kernel for CUDA
tensors and take their plain versions, :func:`resample_slabs_plain` and
:func:`composite_plain`, only for tensors on the CPU. A failed build or
launch raises; there is no fallback. ``LAUNCHES_RESAMPLE`` and
``LAUNCHES_COMPOSITE`` count successful launches and nothing else.

The stack between the two stages is a plain (gp, Iv, Iu) bf16 array, slab k
at index k. The TPU's chunked (C, nrb, 8, 8, I) layout existed for its DMA
engine and is not kept.

:func:`resample_composite` (``LAUNCHES_RESAMPLE_COMPOSITE``) computes
``composite(resample_slabs(...))`` bit for bit without the stack; its plain
version :func:`resample_composite_plain` is that composition, and
:func:`slab_windows` is its shared-memory window rule in torch. K3 and K4
stay as the counterparts of the JAX package's ``resample_slabs`` and
``composite_chunks``; no frame launches them.
"""

from __future__ import annotations

import ctypes

import torch

from vokselis_torch.core.colors import bonsai_transfer_pow_lowdeg_soa, bonsai_transfer_soa
from vokselis_torch.ops.cuda.build import CSRC, NVCC_FLAGS, check_launch, load_library

SOURCE = CSRC / "shear_resample.cu"
TRANSFERS = ("lowdeg", "exact")

LAUNCHES_RESAMPLE = 0
LAUNCHES_COMPOSITE = 0
LAUNCHES_RESAMPLE_COMPOSITE = 0
# the fused kernel's tile: TILE_ROWS intermediate rows (one occupancy row
# block) x TILE_COLS columns; a slab window of up to WINDOW_CAPACITY bf16
# texels is staged in shared memory (shear_resample.cu RC_ROWS, RC_WIN_CAP)
TILE_ROWS = 8
TILE_COLS = 32
WINDOW_CAPACITY = 2048
# compiler output of this process's build (ptxas register / spill report)
BUILD_LOG = ""
_lib = None


def build() -> ctypes.CDLL:
    """Compile (once per source and flag set) and load the kernel library."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    lib, BUILD_LOG = load_library(SOURCE, NVCC_FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vk_resample_slabs.argtypes = [p, i, p, i, i, p, p, p, i, i, i, p, i, p]
    lib.vk_resample_slabs.restype = i
    lib.vk_composite.argtypes = [p, i, i, i, p, p, p, i, i, i, p, i, p]
    lib.vk_composite.restype = i
    lib.vk_resample_composite.argtypes = [p, i, p, i, i, p, p, i, i, i, p, p, p, p, i, i, i, p,
                                          p, i, p]
    lib.vk_resample_composite.restype = i
    _lib = lib
    return lib


def _check(name, t, device, dtype, shape=None, ndim=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_device(device):
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the shear-warp kernels run on cpu or cuda, not {device}")


def _check_resample(packs, m, pos_u, pos_v, occ):
    if not isinstance(packs, torch.Tensor):
        raise TypeError(f"packs must be a torch.Tensor, got {type(packs)}")
    dev = packs.device
    _check_device(dev)
    _check("packs", packs, dev, torch.bfloat16, ndim=4)
    if packs.shape[2] != packs.shape[3]:
        raise ValueError(f"packs must be (P, G, D, D), got {tuple(packs.shape)}")
    _check("m", m, dev, torch.int32, shape=(1,))
    _check("pos_u", pos_u, dev, torch.float32, ndim=2)
    _check("pos_v", pos_v, dev, torch.float32, ndim=2)
    if pos_v.shape[0] != pos_u.shape[0]:
        raise ValueError(f"pos_u {tuple(pos_u.shape)} and pos_v {tuple(pos_v.shape)} "
                         "need one row per slab")
    if occ is not None:
        _check("occ", occ, dev, torch.bool, shape=(pos_u.shape[0],))


@torch.no_grad()
def resample_slabs(packs, m, pos_u, pos_v, occ=None):
    """K3: resample every slab onto the intermediate grid.

    ``packs``: (P, G, D, D) bf16, slab-major volumes (one per dominant axis);
    ``m``: (1,) int32 on the same device, the pack to resample (clamped into
    [0, P-1]); ``pos_u``/``pos_v``: (gp, Iu)/(gp, Iv) f32 sample positions of
    slab k's texels in the pack's (u, v) texel space (rows k >= G are padding
    and resample to 0); ``occ``: optional (gp,) bool per-slab gate, cold
    slabs write zeros. Returns the (gp, Iv, Iu) bf16 stack. CUDA tensors
    launch the kernel; CPU tensors take :func:`resample_slabs_plain`."""
    global LAUNCHES_RESAMPLE
    _check_resample(packs, m, pos_u, pos_v, occ)
    if packs.device.type == "cpu":
        return resample_slabs_plain(packs, m, pos_u, pos_v, occ)
    lib = build()
    n_packs, g, d, _ = packs.shape
    gp, iu = pos_u.shape
    iv = pos_v.shape[1]
    out = torch.empty((gp, iv, iu), dtype=torch.bfloat16, device=packs.device)
    err = lib.vk_resample_slabs(
        packs.data_ptr(), n_packs, m.data_ptr(), g, d, pos_u.data_ptr(),
        pos_v.data_ptr(), None if occ is None else occ.data_ptr(), gp, iv, iu,
        out.data_ptr(), packs.device.index,
        torch.cuda.current_stream(packs.device).cuda_stream,
    )
    check_launch(lib, err, "resample_slabs")
    LAUNCHES_RESAMPLE += 1
    return out


def _taps(pos, d):
    """Bilinear taps of positions ``pos`` over cols [0, d-1], zero outside:
    (index of the first tap, clamped for the gather), (index of the second),
    first valid, second valid, fraction. The kernel's float-side tests."""
    p0 = torch.floor(pos)
    frac = pos - p0
    ok0 = (p0 >= 0.0) & (p0 <= d - 1.0)
    ok1 = (p0 >= -1.0) & (p0 <= d - 2.0)
    i0 = torch.where(ok0 | ok1, p0, 0.0).long()
    return i0.clamp(0, d - 1), (i0 + 1).clamp(0, d - 1), ok0, ok1, frac


@torch.no_grad()
def resample_slabs_plain(packs, m, pos_u, pos_v, occ=None):
    """Plain torch version of K3, the same float32 operations in the same
    order: per slab, the four taps (0 outside the slab), two lerps along u,
    one along v, rounded to bf16 once."""
    _check_resample(packs, m, pos_u, pos_v, occ)
    n_packs, g, d, _ = packs.shape
    gp, iu = pos_u.shape
    iv = pos_v.shape[1]
    volm = packs.index_select(0, m.clamp(0, n_packs - 1).long())[0]
    out = torch.zeros((gp, iv, iu), dtype=torch.bfloat16, device=packs.device)
    for k in range(min(g, gp)):
        v0, v1, v0ok, v1ok, fv = _taps(pos_v[k], d)
        u0, u1, u0ok, u1ok, fu = _taps(pos_u[k], d)
        row0 = volm[k].index_select(0, v0)
        row1 = volm[k].index_select(0, v1)

        def tap(row, cols, vok, uok):
            vals = row.index_select(1, cols).float()
            return torch.where(vok[:, None] & uok[None, :], vals, 0.0)

        a00, a01 = tap(row0, u0, v0ok, u0ok), tap(row0, u1, v0ok, u1ok)
        a10, a11 = tap(row1, u0, v1ok, u0ok), tap(row1, u1, v1ok, u1ok)
        top = a00 + (a01 - a00) * fu[None, :]
        bot = a10 + (a11 - a10) * fu[None, :]
        out[k] = (top + (bot - top) * fv[:, None]).to(torch.bfloat16)
    if occ is not None:
        out = torch.where(occ[:, None, None], out, 0.0)
    return out


def _check_gates(dev, g, iv, iu, sgn, irho, occ, transfer):
    """The composite's arguments beside its (g, iv, iu) samples."""
    _check("sgn", sgn, dev, torch.int32, shape=(1,))
    _check("irho", irho, dev, torch.float32, shape=(iv, iu))
    if occ is not None:
        _check("occ", occ, dev, torch.bool, ndim=2)
        if occ.shape[0] != g or occ.shape[1] < 1 or iv % occ.shape[1]:
            raise ValueError(f"occ must be (G, nrb) with nrb dividing Iv, got "
                             f"{tuple(occ.shape)} for {g} slabs of {iv} rows")
    if transfer not in TRANSFERS:
        raise ValueError(f"transfer must be one of {TRANSFERS}, got {transfer!r}")


def _check_composite(stack, sgn, irho, occ, transfer):
    if not isinstance(stack, torch.Tensor):
        raise TypeError(f"stack must be a torch.Tensor, got {type(stack)}")
    dev = stack.device
    _check_device(dev)
    _check("stack", stack, dev, torch.bfloat16, ndim=3)
    _check_gates(dev, *stack.shape, sgn, irho, occ, transfer)


@torch.no_grad()
def composite(stack, sgn, irho, occ=None, transfer: str = "lowdeg"):
    """K4: front-to-back composite of the resampled stack.

    ``stack``: (G, Iv, Iu) bf16; ``sgn``: (1,) int32 on the same device,
    > 0 marches ascending slab index, else descending; ``irho``: (Iv, Iu)
    f32 exact-march steps per slab (>= 1); ``occ``: optional (G, nrb) bool
    gate per (slab, block of Iv/nrb rows), cold pairs are skipped;
    ``transfer``: "lowdeg" (the composite's low-degree polynomial palette,
    K4) or "exact" (the transcendental palette of the TPU's
    ``composite_pallas``, K4b). Per texel the march stops at alpha 0.95.
    Returns the (4, Iv, Iu) f32 r, g, b, a planes. CUDA tensors launch the
    kernel; CPU tensors take :func:`composite_plain`."""
    global LAUNCHES_COMPOSITE
    _check_composite(stack, sgn, irho, occ, transfer)
    if stack.device.type == "cpu":
        return composite_plain(stack, sgn, irho, occ, transfer)
    lib = build()
    g, iv, iu = stack.shape
    nrb = 1 if occ is None else occ.shape[1]
    out = torch.empty((4, iv, iu), dtype=torch.float32, device=stack.device)
    err = lib.vk_composite(
        stack.data_ptr(), g, iv, iu, sgn.data_ptr(), irho.data_ptr(),
        None if occ is None else occ.data_ptr(), nrb, iv // nrb,
        int(transfer == "exact"), out.data_ptr(), stack.device.index,
        torch.cuda.current_stream(stack.device).cuda_stream,
    )
    check_launch(lib, err, "composite")
    LAUNCHES_COMPOSITE += 1
    return out


@torch.no_grad()
def composite_plain(stack, sgn, irho, occ=None, transfer: str = "lowdeg",
                    return_count: bool = False):
    """Plain torch version of K4, the kernel's float32 operations slab by
    slab over whole planes. A skipped slab (cold gate or alpha >= 0.95)
    adds an exact zero here where the kernel adds nothing. Reads ``sgn`` on
    the host. With ``return_count`` also returns the (Iv, Iu) int32 count
    of samples each texel composited (the stack reads the kernel makes)."""
    _check_composite(stack, sgn, irho, occ, transfer)
    g, iv, iu = stack.shape
    ascending = bool(sgn[0] > 0)
    rows = None if occ is None else occ.repeat_interleave(iv // occ.shape[1], dim=1)
    r, gch, b, a = (torch.zeros((iv, iu), dtype=torch.float32, device=stack.device)
                    for _ in range(4))
    count = torch.zeros((iv, iu), dtype=torch.int32, device=stack.device)
    for t in range(g):
        k = t if ascending else g - 1 - t
        s = stack[k].float()
        if transfer == "exact":
            tv, cr, cg, cb = bonsai_transfer_soa(s)
            alpha = 1.0 - torch.exp(irho * torch.log(1.0 - tv))
        else:
            alpha, cr, cg, cb = bonsai_transfer_pow_lowdeg_soa(s, irho)
        live = a < 0.95
        if rows is not None:
            live = live & rows[k][:, None]
        w = torch.where(live, (1.0 - a) * alpha, 0.0)
        r = r + w * cr
        gch = gch + w * cg
        b = b + w * cb
        a = a + w
        if return_count:
            count += live
    planes = torch.stack([r, gch, b, a])
    return (planes, count) if return_count else planes


# -- the fused slab stage: K3 -> K4 in one kernel -----------------------------

_OVER: dict = {}


def over_capacity(device) -> torch.Tensor:
    """The fused kernel's device counter on ``device``: (2,) int32, the tiles
    that had a slab window over ``WINDOW_CAPACITY`` (read from the pack in
    device memory instead) and the number of such (tile, slab) windows. It
    accumulates over every launch and is never zeroed on the frame path, so
    it means something only between an explicit ``zero_()`` and a read; the
    frame never reads it on the host."""
    device = torch.device(device)
    if device not in _OVER:
        _OVER[device] = torch.zeros(2, dtype=torch.int32, device=device)
    return _OVER[device]


def _check_resample_composite(packs, m, pos_u, pos_v, sgn, irho, occ_k, occ_rb, transfer):
    _check_resample(packs, m, pos_u, pos_v, occ_k)
    _check_gates(packs.device, pos_u.shape[0], pos_v.shape[1], pos_u.shape[1], sgn, irho,
                 occ_rb, transfer)


def _check_kernel_shapes(packs, pos_u, pos_v, occ_rb):
    """What the fused kernel takes beyond the plain version: whole 16-byte
    copies of the pack's rows and of the positions, tiles inside one
    occupancy row block."""
    d, iu, iv = packs.shape[2], pos_u.shape[1], pos_v.shape[1]
    nrb = 1 if occ_rb is None else occ_rb.shape[1]
    if d % 8 or iv % TILE_ROWS or (iv // nrb) % TILE_ROWS or iu % 4:
        raise ValueError(f"resample_composite on the card needs D % 8 == 0, Iv % 8 == 0, "
                         f"Iv/nrb % 8 == 0 and Iu % 4 == 0; got D {d}, Iv {iv}, nrb {nrb}, "
                         f"Iu {iu}")
    for name, t in (("packs", packs), ("pos_u", pos_u), ("pos_v", pos_v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


@torch.no_grad()
def resample_composite(packs, m, pos_u, pos_v, sgn, irho, occ_k=None, occ_rb=None,
                       transfer: str = "lowdeg"):
    """K3 -> K4 in one kernel: ``composite(resample_slabs(packs, m, pos_u,
    pos_v, occ_k), sgn, irho, occ_rb, transfer)`` without the (gp, Iv, Iu)
    stack between them (the counterpart of the JAX package's
    ``shear_resample.resample_composite``, vokselis_tpu/ops/pallas/
    shear_resample.py:402). Arguments as those two functions'; ``occ_rb``
    is the composite's (gp, nrb) gate. Returns the (4, Iv, Iu) f32 r, g, b,
    a planes. CUDA tensors launch the kernel; CPU tensors take
    :func:`resample_composite_plain`."""
    global LAUNCHES_RESAMPLE_COMPOSITE
    _check_resample_composite(packs, m, pos_u, pos_v, sgn, irho, occ_k, occ_rb, transfer)
    if packs.device.type == "cpu":
        return resample_composite_plain(packs, m, pos_u, pos_v, sgn, irho, occ_k, occ_rb,
                                        transfer)
    _check_kernel_shapes(packs, pos_u, pos_v, occ_rb)
    lib = build()
    n_packs, g, d, _ = packs.shape
    gp, iu = pos_u.shape
    iv = pos_v.shape[1]
    nrb = 1 if occ_rb is None else occ_rb.shape[1]
    out = torch.empty((4, iv, iu), dtype=torch.float32, device=packs.device)
    err = lib.vk_resample_composite(
        packs.data_ptr(), n_packs, m.data_ptr(), g, d, pos_u.data_ptr(), pos_v.data_ptr(),
        gp, iv, iu, sgn.data_ptr(), irho.data_ptr(),
        None if occ_k is None else occ_k.data_ptr(),
        None if occ_rb is None else occ_rb.data_ptr(), nrb, iv // nrb,
        int(transfer == "exact"), out.data_ptr(), over_capacity(packs.device).data_ptr(),
        packs.device.index, torch.cuda.current_stream(packs.device).cuda_stream,
    )
    check_launch(lib, err, "resample_composite")
    LAUNCHES_RESAMPLE_COMPOSITE += 1
    return out


@torch.no_grad()
def resample_composite_plain(packs, m, pos_u, pos_v, sgn, irho, occ_k=None, occ_rb=None,
                             transfer: str = "lowdeg", return_count: bool = False):
    """Plain torch version of the fused kernel: :func:`composite_plain` of
    :func:`resample_slabs_plain`, nothing more (``return_count`` as
    composite_plain's)."""
    _check_resample_composite(packs, m, pos_u, pos_v, sgn, irho, occ_k, occ_rb, transfer)
    stack = resample_slabs_plain(packs, m, pos_u, pos_v, occ_k)
    return composite_plain(stack, sgn, irho, occ_rb, transfer, return_count)


@torch.no_grad()
def slab_windows(pos_u, pos_v, d: int):
    """The fused kernel's window rule in torch: for each slab and tile of
    ``TILE_ROWS`` x ``TILE_COLS`` texels, the pack rows and columns its taps
    can reach, as (gp, Iv // 8, cdiv(Iu, TILE_COLS), 4) int64 (first row,
    last row, first column, last column; inclusive). Positions are affine
    per slab, so the tile's first and last row and column bound it; each
    end is floored (+1 for the high tap), clamped into [0, d-1] in float
    before the int cast (padding rows hold -1e6), and the columns widen to
    whole 8-texel groups. A window of more than ``WINDOW_CAPACITY`` texels
    is read from device memory. Tests and chip_smoke.py use this; the
    kernel computes its own."""
    gp, iu = pos_u.shape
    iv = pos_v.shape[1]
    if iv % TILE_ROWS:
        raise ValueError(f"Iv must be a multiple of {TILE_ROWS}, got {iv}")
    hi = float(d - 1)
    c0 = torch.arange(0, iu, TILE_COLS, device=pos_u.device)
    c1 = torch.clamp(c0 + TILE_COLS, max=iu) - 1
    r0 = torch.arange(0, iv, TILE_ROWS, device=pos_v.device)

    def span(a, b):
        lo = torch.floor(torch.fmin(a, b))
        top = torch.floor(torch.fmax(a, b)) + 1.0
        return (torch.fmin(torch.fmax(lo, torch.zeros_like(lo)), torch.full_like(lo, hi)).long(),
                torch.fmin(torch.fmax(top, torch.zeros_like(top)), torch.full_like(top, hi))
                .long())

    v0, v1 = span(pos_v[:, r0], pos_v[:, r0 + TILE_ROWS - 1])
    u0, u1 = span(pos_u[:, c0], pos_u[:, c1])
    u0, u1 = u0 // 8 * 8, u1 // 8 * 8 + 7
    nr, nc = r0.numel(), c0.numel()
    return torch.stack([v0[:, :, None].expand(gp, nr, nc), v1[:, :, None].expand(gp, nr, nc),
                        u0[:, None, :].expand(gp, nr, nc), u1[:, None, :].expand(gp, nr, nc)],
                       dim=-1)
