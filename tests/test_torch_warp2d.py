"""The screen warps K6 and K5 (vokselis_torch.ops.cuda.warp2d) at frames
whose sides are neither whole 32-pixel tiles nor multiples of 4 pixels, where
the kernels take partial tiles and their scalar path.

On the CPU the wrappers take their plain versions. These tests hold them
against the JAX package at such frames: K6's lookup against
``map_coordinates`` and K5's reduction against the XLA mirror
``warp2d.stats_from_packed`` (vokselis_tpu/ops/pallas/warp2d.py:601). They
also test the helpers of ``vokselis_torch.tools.warp_check`` that
``chip_smoke.py`` uses: the SASS load grouping, the frame inputs and the
count of tapped texels.

Tests marked ``gpu`` need a CUDA card and skip without one: they launch K6
and K5 at the same shapes, on the vector path and on the scalar path, and
hold them against their plain versions. On the card run ``python -m pytest
tests/test_torch_warp2d.py --noconftest -m gpu``.
"""

import numpy as np
import pytest
import torch

from vokselis_torch.core.camera import Camera
from vokselis_torch.ops import shear_warp
from vokselis_torch.ops.cuda import warp2d
from vokselis_torch.tools import warp_check
from vokselis_torch.volume.io import get_bonsai

FRAMES = [(36, 70), (33, 98)]  # (H, W): partial tiles, widths not multiples of 4
II = 48


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(h, w, n_ch=4, seed=17):
    """Intermediate channels, coordinates (some beyond the edges on both
    sides, where the lookup clamps) and the ok and box masks at (h, w)."""
    rng = np.random.default_rng(seed)
    chans = rng.random((n_ch, II, II), dtype=np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    av = 0.55 * yy + 0.1 * xx + 3.0 + 0.5 * rng.random((h, w), dtype=np.float32)
    bu = 0.45 * xx + 0.05 * yy + 1.5
    av[0, :5], bu[-1, -3:] = -2.5, II + 3.0
    ok = rng.random((h, w)) > 0.25
    box = ok | (rng.random((h, w)) > 0.5)
    return chans, av.astype(np.float32), bu.astype(np.float32), ok, box


@pytest.mark.parametrize("n_ch", [3, 4])
@pytest.mark.parametrize("h,w", FRAMES)
def test_warp_plain_matches_map_coordinates(h, w, n_ch):
    """K6's plain version at odd frames is the edge-clamped bilinear lookup:
    against map_coordinates(order=1, mode="nearest") in float32 at every
    ok pixel within 1e-6 (the two weight the taps in another order); the
    other pixels are 0."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.scipy.ndimage import map_coordinates

    chans, av, bu, ok, _ = _inputs(h, w, n_ch)
    got = warp2d.warp_bilinear(torch.from_numpy(chans), torch.from_numpy(av),
                               torch.from_numpy(bu), torch.from_numpy(ok)).numpy()
    want = np.stack([np.asarray(map_coordinates(jnp.asarray(c), [jnp.asarray(av),
                                                                 jnp.asarray(bu)],
                                                order=1, mode="nearest"))
                     for c in chans])
    assert got.shape == (n_ch, h, w)
    np.testing.assert_allclose(got[:, ok], want[:, ok], rtol=0, atol=1e-6)
    assert (got[:, ~ok] == 0).all()


def _pack(x, h, w):
    """The JAX package's packed tile layout of an (h, w) plane padded with
    zeros to whole tiles."""
    import jax.numpy as jnp
    from vokselis_tpu.ops.pallas.march_bonsai import _pack_tiles

    ph, pw = -(-h // 32) * 32, -(-w // 32) * 32
    return _pack_tiles(jnp.pad(jnp.asarray(x, jnp.float32), ((0, ph - h), (0, pw - w))),
                       ph, pw)


@pytest.mark.parametrize("h,w", FRAMES)
def test_tile_stats_match_jax_mirror(h, w):
    """K5's reduction at odd frames on the same warped planes as the JAX
    package's XLA mirror stats_from_packed, with the tolerances of
    test_torch_hybrid.py's whole-tile test: counts exact, sums within 1e-5
    relative (another summation order), the peak within 1e-6 (exp and log
    may differ by an ulp between the libraries); the stats wrapper on CPU
    tensors is this plain path."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from vokselis_tpu.ops.pallas import warp2d as jw2

    chans, av, bu, ok, box = _inputs(h, w)
    args = [torch.from_numpy(x) for x in (chans, av, bu, ok, box)]
    planes = warp2d.warp_plain(args[0], args[1], args[2], args[3])
    got = warp2d.tile_stats(planes[:3], planes[3], args[3], args[4]).numpy()
    okp = _pack(ok, h, w)
    want = np.asarray(jw2.stats_from_packed(
        [_pack(p.numpy(), h, w) for p in planes[:3]], _pack(planes[3].numpy(), h, w),
        jnp.zeros_like(okp), okp, _pack(box, h, w))).reshape(-1, 8, 128)[:, :5, 0]
    assert got.shape == want.shape == (-(-h // 32) * -(-w // 32), warp2d.N_STATS)
    np.testing.assert_array_equal(got[:, warp2d.STAT_EXT], want[:, warp2d.STAT_EXT])
    assert (got[:, warp2d.STAT_OVF] == 0).all()
    for col in (warp2d.STAT_CURV, warp2d.STAT_EDGE):
        np.testing.assert_allclose(got[:, col], want[:, col], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[:, warp2d.STAT_PEAK], want[:, warp2d.STAT_PEAK],
                               rtol=0, atol=1e-6)
    rgb, st = warp2d.warp_stats(*args)
    torch.testing.assert_close(rgb, planes[:3], rtol=0, atol=0)
    np.testing.assert_array_equal(st.numpy(), got)


SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_111warp_kernelILi3ELb1ELi4EEEvPKfiiS2_S2_PKhiiiPf
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                        /* 0x0 */
        /*0010*/                   LDG.E.CONSTANT R0, desc[UR4][R2.64] ;         /* 0x0 */
        /*0020*/                   LOP3.LUT P0, RZ, R0, 0xff, RZ, 0xc0, !PT ;    /* 0x0 */
        /*0030*/              @!P0 LDG.E.128.CONSTANT R4, desc[UR4][R8.64] ;     /* 0x0 */
        /*0040*/              @!P0 LDG.E.128.CONSTANT R12, desc[UR4][R10.64] ;   /* 0x0 */
        /*0050*/                   FMNMX R5, RZ, R5, !PT ;                       /* 0x0 */
        /*0060*/                   LDG.E.CONSTANT R20, desc[UR4][R18.64] ;       /* 0x0 */
        /*0070*/                   LDG.E.CONSTANT R21, desc[UR4][R18.64+0x4] ;   /* 0x0 */
        /*0080*/                   MOV R16, R30 ;                                /* 0x0 */
        /*0090*/                   FADD R22, R20, -R21 ;                         /* 0x0 */
        /*00a0*/                   STG.E.128 desc[UR4][R2.64], R20 ;             /* 0x0 */
        /*00b0*/                   EXIT ;                                        /* 0x0 */
		Function : _ZN12_GLOBAL__N_117warp_stats_kernelILb0ELi8EEEvPKf
        /*0000*/                   LDG.E.U8.CONSTANT R0, desc[UR4][R2.64] ;      /* 0x0 */
        /*0010*/                   LDG.E.U8.CONSTANT R1, desc[UR4][R2.64+0x1] ;  /* 0x0 */
        /*0020*/                   ISETP.NE.AND P0, PT, R1, RZ, PT ;             /* 0x0 */
        /*0030*/                   EXIT ;                                        /* 0x0 */
"""


def test_load_batches_groups_dependent_loads():
    """A group of global loads ends at the first instruction that reads a
    register one of them wrote: the mask load, the two float4 coordinate
    loads behind it, then two taps; a vector load's destination covers
    its registers, a predicated load counts, a store is not a load."""
    groups = warp_check.load_batches(SASS)
    assert groups == {
        "_ZN12_GLOBAL__N_111warp_kernelILi3ELb1ELi4EEEvPKfiiS2_S2_PKhiiiPf": [1, 2, 2],
        "_ZN12_GLOBAL__N_117warp_stats_kernelILb0ELi8EEEvPKf": [2],
    }


def test_warp_inputs_are_the_frame_path_inputs():
    """warp_check.warp_inputs (chip_smoke.py's K5 and K6 inputs) builds what
    the fast and hybrid frames hand the warps: the slab stage's planes, the
    coordinates and masks of warp_coords, and the r, g, b + curvature
    channels of _warp_to_screen; K5 of them is the "stats" frame."""
    packs = shear_warp.prepare_fast_volume(get_bonsai(32), "cpu")
    width, height, ii = 70, 36, 32
    inp = warp_check.warp_inputs(packs, width, height, ii)
    u = Camera.bonsai(width / height).uniform("cpu")
    geo = shear_warp.fast_geometry(packs, u, width, height, ii)
    av, bu, ok = shear_warp.warp_coords(geo, ii, ii)
    for name, want in (("av", av), ("bu", bu), ("ok", ok), ("box", geo.hit)):
        assert torch.equal(inp[name], want), name
    assert inp["planes"].shape == (4, ii, ii)
    assert torch.equal(inp["chans"][:3], inp["planes"][:3])
    assert torch.equal(inp["chans"][3], shear_warp.curvature(inp["planes"]))
    rgb, stats = warp2d.warp_stats(*warp_check.k5_args(inp))
    want_rgb, want_stats = shear_warp._render_fast(packs, u, width, height, ii, False,
                                                   return_aux="stats")
    assert torch.equal(rgb, want_rgb) and torch.equal(stats, want_stats)


@pytest.mark.parametrize("h,w", FRAMES)
def test_tapped_texels_counts_distinct_taps(h, w):
    """tapped_texels (the warps' bounds in chip_smoke.py) counts the
    distinct texels that the four edge-clamped taps of the ok pixels touch:
    a set built pixel by pixel in Python agrees, and with every pixel masked
    out nothing is tapped."""
    _, av, bu, ok, _ = _inputs(h, w)
    want = set()
    for a, b in zip(av[ok].tolist(), bu[ok].tolist()):
        a, b = min(max(a, 0.0), II - 1.0), min(max(b, 0.0), II - 1.0)
        v0, u0 = int(np.floor(a)), int(np.floor(b))
        for v in (v0, min(v0 + 1, II - 1)):
            for u in (u0, min(u0 + 1, II - 1)):
                want.add((v, u))
    args = (torch.from_numpy(av), torch.from_numpy(bu))
    assert warp_check.tapped_texels(*args, torch.from_numpy(ok), II, II) == len(want)
    assert 0 < len(want) < II * II
    assert warp_check.tapped_texels(*args, torch.zeros(h, w, dtype=torch.bool), II, II) == 0


def _misaligned(x):
    """A contiguous copy of ``x`` whose data starts 4 bytes past a 16-byte
    boundary, so the kernels take their scalar path."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", FRAMES + [(64, 96)])
def test_warp_kernels_match_plain_on_gpu(cuda_device, h, w):
    """K6 (1-4 channels, with and without a mask) and K5 against their
    plain versions on the card at odd frames and a whole-tile one, with
    aligned buffers (the vector path where the width allows it) and with
    buffers 4 bytes off alignment (the scalar path): K6 and K5's rgb,
    STAT_OVF, STAT_EXT and STAT_PEAK bitwise, STAT_CURV and STAT_EDGE
    within 1e-5 relative; each call counts one launch."""
    chans, av, bu, ok, box = (torch.from_numpy(x).to(cuda_device) for x in _inputs(h, w))
    for shift in (False, True):
        a, b = (_misaligned(av), _misaligned(bu)) if shift else (av, bu)
        before = (warp2d.LAUNCHES_WARP, warp2d.LAUNCHES_STATS)
        for n_ch in (1, 2, 3, 4):
            for mask in (ok, None):
                got = warp2d.warp_bilinear(chans[:n_ch], a, b, mask)
                want = warp2d.warp_plain(chans[:n_ch], a, b, mask)
                assert torch.equal(got, want), (n_ch, mask is None, shift)
        rgb, st = warp2d.warp_stats(chans, a, b, ok, box)
        err = warp_check.k5_error(rgb, st, *warp2d.warp_stats_plain(chans, a, b, ok, box))
        torch.cuda.synchronize()
        assert err["ok"], (shift, err)
        assert (warp2d.LAUNCHES_WARP, warp2d.LAUNCHES_STATS) == (before[0] + 8, before[1] + 1)
