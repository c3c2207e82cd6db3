"""The hybrid slice (vokselis_torch.ops.hybrid, with its kernels K5 in
ops.cuda.warp2d and K2/K1b in ops.cuda.march_bonsai, on top of the fast
frame of ops.shear_warp).

On the CPU every kernel wrapper takes its plain version. These tests hold
the plain versions against the JAX package: its Pallas kernels in interpret
mode (as tests/test_pallas.py and tests/test_fast.py run them), its XLA
mirror of the stats reduction (warp2d.stats_from_packed) on the same warped
planes, its tile selection and pair policy, and its whole hybrid frame on
the CPU, each with its tolerance and reason. Every input is made from a
numpy seed; camera uniforms are carried across from the JAX camera.

Tests marked ``gpu`` need a CUDA card and skip without one: they launch K5,
K2 and K1b and hold them against their plain versions on the same tensors.
On the card run ``python -m pytest tests/test_torch_*.py --noconftest -m gpu``.
"""

import importlib

import numpy as np
import pytest
import torch

from vokselis_torch.core.camera import Camera, CameraUniform
from vokselis_torch.engine.compiled import CompiledFrame
from vokselis_torch.engine.context import Context
from vokselis_torch.engine.loop import run
from vokselis_torch.engine.profiler import kernel_launches
from vokselis_torch.models import bonsai as bonsai_model
from vokselis_torch.ops import hybrid as hy
from vokselis_torch.ops import reference, shear_warp
from vokselis_torch.ops.cuda import march_bonsai as mb
from vokselis_torch.ops.cuda import shear_resample as sr
from vokselis_torch.ops.cuda import warp2d
from vokselis_torch.volume.io import dense_stress, get_bonsai

POSES = {
    "bench": dict(zoom=1.0, pitch=0.5, yaw=1.0, target=(0.5, 0.5, 0.5)),
    "tilt": dict(zoom=1.2, pitch=0.9, yaw=1.1, target=(0.5, 0.5, 0.5)),
    "axis": dict(zoom=1.0, pitch=0.1, yaw=0.0, target=(0.5, 0.5, 0.5)),
}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the plain versions run many small torch ops, and
    an OpenMP team per op oversubscribes the CPU under the suite's parallel
    workers (test_torch_fast.py:68-78)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_interp():
    """The JAX package's march_bonsai, warp2d and hybrid modules reloaded
    with every pallas_call in interpret mode (test_pallas.py:16-38), and
    reloaded back afterwards."""
    pytest.importorskip("jax")
    import jax.experimental.pallas as pl

    names = ("vokselis_tpu.ops.pallas.march_bonsai", "vokselis_tpu.ops.pallas.warp2d",
             "vokselis_tpu.ops.hybrid")
    orig = pl.pallas_call
    pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        mods = [importlib.reload(importlib.import_module(m)) for m in names]
        yield dict(zip(("mb", "w2", "hy"), mods))
    finally:
        pl.pallas_call = orig
        for m in names:
            importlib.reload(importlib.import_module(m))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _uniforms(pose, aspect=1.0):
    """The JAX camera's uniform and the same arrays carried across."""
    from vokselis_tpu.core.camera import Camera as JaxCamera

    ju = (JaxCamera.bonsai(aspect) if pose == "default"
          else JaxCamera(aspect=aspect, **POSES[pose])).uniform()
    u = CameraUniform.from_numpy(np.asarray(ju.view_position), np.asarray(ju.proj_view),
                                 np.asarray(ju.inv_proj), "cpu")
    return ju, u


# -- selection and pair policy -------------------------------------------------

@pytest.mark.parametrize("pair", [False, True], ids=["tiles", "pairs"])
@pytest.mark.parametrize("budget", [7, 1, 1000])
def test_select_units_matches_jax(pair, budget):
    """hybrid.select_units (test_fast.py:465): on distinct random scores,
    with an odd, a unit and an oversize budget, the ids are the JAX
    package's exactly, in order, parked picks included."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from vokselis_tpu.ops.hybrid import select_units as jax_select

    rng = np.random.default_rng(21)
    n_tiles = 48
    scores = rng.random(n_tiles).astype(np.float32) * 1e-2  # distinct, as are pair sums
    thresh = float(np.sort(scores)[-6])  # five tiles above the threshold
    got = hy.select_units(torch.from_numpy(scores), n_tiles, budget, thresh, pair)
    want = np.asarray(jax_select(jnp.asarray(scores), n_tiles, budget, jnp.float32(thresh),
                                 pair))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    sentinel = n_tiles // 2 if pair else n_tiles
    if budget == 1000:
        assert (got.numpy() == sentinel).any()


def test_select_units_pair_semantics():
    """test_fast.py:465 on the port: pairs rank by the sum, gate on the
    larger member, and park at n_tiles // 2; single tiles are top-k."""
    scores = torch.tensor([0.9, 0.1, 0.5, 0.4, 0.04, 0.01, 0.6, 0.0])
    assert set(hy.select_units(scores, 8, 4, 0.05, True).tolist()) == {0, 1}
    ids = hy.select_units(scores, 8, 8, 0.05, True).tolist()
    assert 2 not in ids and 4 in ids
    assert set(hy.select_units(scores, 8, 3, 0.45, False).tolist()) == {0, 6, 2}


def test_pair_mode_matches_jax():
    """_pair_mode (hybrid.py:95-101, with march_bonsai.py:1234-1257's
    integer policy) decides as the JAX package's on a grid of volume sides,
    frames and caps: pairs at 1024^2 with D=256, single tiles at 256^2."""
    pytest.importorskip("jax")
    from vokselis_tpu.ops.hybrid import _pair_mode as jax_pair_mode
    from vokselis_tpu.ops.pallas.march_bonsai import pick_tiles_per_step as jax_pick

    seen = set()
    for d in (32, 64, 128, 256, 512):
        for w, h in ((64, 64), (96, 80), (256, 256), (512, 512), (640, 360),
                     (1024, 1024), (1280, 720), (2048, 2048)):
            for cap in (64, 96, 112, 128, 256):
                got = hy._pair_mode(d, w, h, cap)
                assert got == jax_pair_mode(d, w, h, cap), (d, w, h, cap)
                assert hy.pick_tiles_per_step(d, w, h, cap) == jax_pick(d, w, h, cap)
                seen.add(got)
    assert seen == {False, True}
    assert hy._pair_mode(256, 1024, 1024, 128) and not hy._pair_mode(256, 256, 256, 128)


def test_dilate3_and_score_match_jax():
    """_dilate3 and the scoring formula (hybrid.py:259-266) on one stats
    table: the dilation exactly, the scores within float32 rounding."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from vokselis_tpu.ops.hybrid import _dilate3 as jax_dilate3

    rng = np.random.default_rng(3)
    ny, nx = 5, 7
    st = rng.random((ny * nx, warp2d.N_STATS)).astype(np.float32)
    st[:, warp2d.STAT_OVF] = 0.0
    np.testing.assert_array_equal(
        hy._dilate3(torch.from_numpy(st[:, 4].reshape(ny, nx))).numpy(),
        np.asarray(jax_dilate3(jnp.asarray(st[:, 4].reshape(ny, nx)))))
    inv_px = 1.0 / (8 * 128)
    s = jnp.asarray(st)
    want = (s[:, 0] + 0.03 * s[:, 1]) * inv_px + (
        ((s[:, 3] + 4.0 * s[:, 2]) * inv_px).reshape(ny, nx)
        * jax_dilate3(s[:, 4].reshape(ny, nx))).reshape(-1)
    np.testing.assert_allclose(hy.score_tiles(torch.from_numpy(st), ny, nx).numpy(),
                               np.asarray(want), rtol=1e-6, atol=0)


# -- the "stats" contract and K5 -----------------------------------------------

def test_curvature_matches_jax_roll():
    """The curvature channel is the JAX roll form (shear_warp.py:534-539)
    bit for bit, wrapping at the intermediate's border."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    planes = rng.random((4, 24, 40)).astype(np.float32)

    def curv(c):
        d2v = jnp.abs(2.0 * c - jnp.roll(c, 1, 0) - jnp.roll(c, -1, 0))
        d2u = jnp.abs(2.0 * c - jnp.roll(c, 1, 1) - jnp.roll(c, -1, 1))
        return d2v + d2u

    want = curv(jnp.asarray(planes[0])) + curv(jnp.asarray(planes[1])) + curv(
        jnp.asarray(planes[2]))
    got = shear_warp.curvature(torch.from_numpy(planes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _stats_case(h, w, ii=64, seed=11):
    """test_fast.py:226-235's inputs, at (h, w)."""
    rng = np.random.default_rng(seed)
    chans = rng.random((4, ii, ii), dtype=np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    av = (0.55 * yy + 0.1 * xx + 3.0).astype(np.float32)
    bu = (0.6 * xx + 2.0).astype(np.float32)
    ok = rng.random((h, w)) > 0.2
    box = ok | (rng.random((h, w)) > 0.5)
    return chans, av, bu, ok, box


def _pack(x, h, w):
    """The JAX package's packed tile layout of an (h, w) plane padded with
    zeros to whole tiles."""
    import jax.numpy as jnp
    from vokselis_tpu.ops.pallas.march_bonsai import _pack_tiles

    ph, pw = -(-h // 32) * 32, -(-w // 32) * 32
    return _pack_tiles(jnp.pad(jnp.asarray(x, jnp.float32), ((0, ph - h), (0, pw - w))),
                       ph, pw)


def _jax_stats_rows(stats_packed):
    return np.asarray(stats_packed).reshape(-1, 8, 128)[:, :5, 0]


@pytest.mark.parametrize("h,w", [(64, 64), (80, 96)])
def test_tile_stats_match_jax_mirror(h, w):
    """K5's reduction on the same warped planes as the JAX package's XLA
    mirror stats_from_packed (warp2d.py:601), at a whole-tile frame and at
    80x96 (partial tiles: the padded pixels' 1e-6 luminance enters EDGE and
    PEAK on both sides). Counts exact; sums within 1e-5 relative (another
    summation order); the peak within 1e-6 (exp/log may differ by an ulp
    between the two libraries)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from vokselis_tpu.ops.pallas import warp2d as jw2

    chans, av, bu, ok, box = _stats_case(h, w)
    planes = warp2d.warp_plain(torch.from_numpy(chans), torch.from_numpy(av),
                               torch.from_numpy(bu), torch.from_numpy(ok))
    got = warp2d.tile_stats(planes[:3], planes[3], torch.from_numpy(ok),
                            torch.from_numpy(box)).numpy()
    okp = _pack(ok, h, w)
    want = _jax_stats_rows(jw2.stats_from_packed(
        [_pack(p.numpy(), h, w) for p in planes[:3]], _pack(planes[3].numpy(), h, w),
        jnp.zeros_like(okp), okp, _pack(box, h, w)))
    n_tiles = -(-h // 32) * -(-w // 32)
    assert got.shape == want.shape == (n_tiles, 5)
    np.testing.assert_array_equal(got[:, warp2d.STAT_EXT], want[:, warp2d.STAT_EXT])
    assert (got[:, warp2d.STAT_OVF] == 0).all()
    for col in (warp2d.STAT_CURV, warp2d.STAT_EDGE):
        np.testing.assert_allclose(got[:, col], want[:, col], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[:, warp2d.STAT_PEAK], want[:, warp2d.STAT_PEAK],
                               rtol=0, atol=1e-6)
    # the stats wrapper on CPU tensors is this plain path
    rgb, st = warp2d.warp_stats(torch.from_numpy(chans), torch.from_numpy(av),
                                torch.from_numpy(bu), torch.from_numpy(ok),
                                torch.from_numpy(box))
    torch.testing.assert_close(rgb, planes[:3], rtol=0, atol=0)
    np.testing.assert_array_equal(st.numpy(), got)


def test_warp_stats_plain_matches_jax_kernel(jax_interp):
    """K5's plain version against the TPU stats kernel in interpret mode, on
    test_fast.py:207's inputs and tolerances: the TPU holds the channels and
    its hat weights in bf16, so rgb within 2e-2 and the sums and the peak
    within 2 % of the largest value; counts exact and no overflow."""
    import jax.numpy as jnp

    w2j = jax_interp["w2"]
    h = w = 64
    chans, av, bu, ok, box = _stats_case(h, w)
    outs = w2j.warp_stats_packed(jnp.asarray(chans), _pack(av, h, w), _pack(bu, h, w),
                                 _pack(ok, h, w), _pack(box, h, w), h, w)
    from vokselis_tpu.ops.pallas.march_bonsai import _unpack_tiles

    want_rgb = np.stack([np.asarray(_unpack_tiles(o, h, w)) for o in outs[:3]])
    want = _jax_stats_rows(outs[3])
    chans_b = torch.from_numpy(chans).to(torch.bfloat16).float()  # the TPU's resident dtype
    rgb, got = warp2d.warp_stats(chans_b, torch.from_numpy(av), torch.from_numpy(bu),
                                 torch.from_numpy(ok), torch.from_numpy(box))
    assert np.abs(rgb.numpy() - want_rgb).max() < 2e-2
    got = got.numpy()
    np.testing.assert_array_equal(got[:, warp2d.STAT_EXT], want[:, warp2d.STAT_EXT])
    assert (got[:, warp2d.STAT_OVF] == 0).all() and (want[:, warp2d.STAT_OVF] == 0).all()
    for col in (warp2d.STAT_CURV, warp2d.STAT_EDGE, warp2d.STAT_PEAK):
        assert np.abs(got[:, col] - want[:, col]).max() <= 0.02 * max(
            1.0, np.abs(want[:, col]).max()), col


@pytest.mark.parametrize("pose", ["bench", "tilt"])
def test_render_fast_stats_contract(pose):
    """_render_fast(return_aux="stats") at 96x80 (partial tiles): its rgb is
    the plain fast frame's linear rgb, its stats are tile_stats of the
    warped planes, and every hit-but-not-ok pixel is counted in EXT."""
    r = shear_warp.FastBonsaiRenderer(get_bonsai(32), "cpu", intermediate=64)
    u = Camera(aspect=96 / 80, **POSES[pose]).uniform("cpu")
    rgb, stats = shear_warp._render_fast(r.packs, u, 96, 80, 64, False, return_aux="stats")
    lin = r(u, 96, 80, srgb=False)
    assert rgb.shape == (3, 80, 96) and stats.shape == (3 * 3, warp2d.N_STATS)
    torch.testing.assert_close(rgb.permute(1, 2, 0), lin[..., :3], rtol=0, atol=0)
    geo = shear_warp.fast_geometry(r.packs, u, 96, 80, 64)
    _, _, ok = shear_warp.warp_coords(geo, 64, 64)
    assert float(stats[:, warp2d.STAT_EXT].sum()) == float((geo.hit & ~ok).sum())
    assert float(stats[:, warp2d.STAT_CURV].max()) > 0.0
    assert float(stats[:, warp2d.STAT_PEAK].min()) >= 12.92e-6 * (1 - 1e-6)


def test_render_fast_aux_consistency():
    """test_fast.py:396 on the port: return_aux=True adds (bad, errd)
    without changing the frame; excluded pixels are black and flagged; the
    TPU-only packed contracts raise."""
    r = shear_warp.FastBonsaiRenderer(get_bonsai(32), "cpu", intermediate=64)
    u = Camera.bonsai(1.0).uniform("cpu")
    plain = shear_warp._render_fast(r.packs, u, 96, 96, 64, True)
    img, bad, errd = shear_warp._render_fast(r.packs, u, 96, 96, 64, True, return_aux=True)
    torch.testing.assert_close(img, plain, rtol=0, atol=0)
    assert errd.shape == (96, 96) and bool((errd >= 0).all())
    assert bad.dtype == torch.int8 and int(bad.max()) <= 1
    assert float(img[..., :3][bad == 1].abs().sum()) == 0.0  # excluded -> black
    for aux in ("packed", "packed-nocurv", "packed-noovf-nocurv"):
        with pytest.raises(NotImplementedError, match="deliberate removals"):
            shear_warp._render_fast(r.packs, u, 96, 96, 64, True, return_aux=aux)


# -- K2 and K1b ----------------------------------------------------------------

@pytest.fixture(scope="module")
def full_frames(jax_interp):
    """Full-frame linear rgb of get_bonsai(32) at the bench pose (64 steps),
    64x64 and 128x64, as (3, H, W): the port's exact frame (K1's plain
    version) and the JAX package's full march (its Pallas kernel in
    interpret mode), on one uniform."""
    from vokselis_tpu.core import geometry as jgeom

    jmb = jax_interp["mb"]
    vol = get_bonsai(32)
    ju, u = _uniforms("default")
    port, jax_full = {}, {}
    for w, h, win in ((64, 64, 64), (128, 64, 96)):
        (dims, band_rows, nb, bstride), pack = jmb.prepare_volume(vol, win)
        eye, dxyz = jgeom.rays_fragment_soa(ju, w, h)
        full, _ = jmb.render_bonsai_rays_pallas(pack, eye, dxyz, dims, 64, False, win,
                                                band_rows, nb, bstride)
        jax_full[(w, h)] = np.asarray(full)[..., :3].transpose(2, 0, 1)
        port[(w, h)] = mb.BonsaiRenderer(vol, "cpu")(u, w, h, max_steps=64, srgb=False)[
            ..., :3].permute(2, 0, 1).numpy()
    return vol, u, port, jax_full


def _hold_tile(got, tid, w, port, jax_full, tol):
    """Tile ``tid`` of a w-wide frame as re-marched (``got``, (3, 32, 32))
    against the port's full frame within ``tol`` (the same rays and
    operations: 0 unless the palette's polynomial form is on) and against
    the JAX package's full march within the exact kernel's contract (max
    < 1e-3, mean < 1e-5; the TPU kernel steps in the direct form, the port
    accumulates as the oracle does)."""
    assert np.abs(got - _tile(port, tid, w)).max() <= tol, tid
    err = np.abs(got - _tile(jax_full, tid, w))
    assert err.max() < 1e-3 and err.mean() < 1e-5, (tid, err.max(), err.mean())


def _tile(planes, tid, w):
    nx = w // 32
    ty, tx = divmod(tid, nx)
    return planes[:, ty * 32:(ty + 1) * 32, tx * 32:(tx + 1) * 32]


def test_tiles_compact_matches_full_march(full_frames):
    """K1b's plain version (test_pallas.py:397): the listed tiles, in list
    order, are the full frame's (see _hold_tile); a parked id is all
    zeros."""
    vol, u, port, jax_full = full_frames
    ids = torch.tensor([2, 1, 4], dtype=torch.int32)  # 4: parked
    out = mb.render_bonsai_tiles(torch.from_numpy(vol), u, ids, 64, 64, max_steps=64)
    assert out.shape == (3, 3 * 32, 32)
    for i, tid in enumerate((2, 1)):
        got = out[:, i * 32:(i + 1) * 32].numpy()
        _hold_tile(got, tid, 64, port[(64, 64)], jax_full[(64, 64)], 0.0)
    assert float(out[:, 64:].abs().max()) == 0.0


def test_tiles_into_merges_over_base(full_frames):
    """K2's plain version (test_pallas.py:431): the selected tiles are
    written in place and are the full frame's (exactly; within 5e-6 with the
    palette's polynomial form, test_pallas.py:486); the other tiles keep
    their base values bit for bit; the parked id changes nothing."""
    vol, u, port, jax_full = full_frames
    vol_t = torch.from_numpy(vol)
    ids = torch.tensor([2, 1, 4], dtype=torch.int32)
    for fast, tol in ((False, 0.0), (True, 5e-6)):
        base = torch.stack([torch.full((64, 64), 7.0 + c) for c in range(3)])
        out = mb.render_bonsai_tiles_into(vol_t, base, u, ids, 64, 64, fast_transfer=fast,
                                          max_steps=64)
        assert out is base
        for tid in (2, 1):
            _hold_tile(_tile(base.numpy(), tid, 64), tid, 64, port[(64, 64)],
                       jax_full[(64, 64)], tol)
        for tid in (0, 3):
            got = _tile(base.numpy(), tid, 64)
            assert all((got[c] == 7.0 + c).all() for c in range(3)), tid
    none = torch.stack([torch.full((64, 64), 7.0 + c) for c in range(3)])
    mb.render_bonsai_tiles_into(vol_t, none, u, torch.full((3,), 4, dtype=torch.int32), 64,
                                64)
    assert all(bool((none[c] == 7.0 + c).all()) for c in range(3))


def test_tiles_into_pairs_match_full_march(full_frames):
    """K2 over tile pairs (test_pallas.py:489): pair ids 2 and 1 march tiles
    2..5 of the 4x2 grid as the full frame (see _hold_tile); pairs 0 and 3
    keep their base."""
    vol, u, port, jax_full = full_frames
    ids = torch.tensor([2, 1, 4], dtype=torch.int32)  # pairs; 4 parked
    base = torch.stack([torch.full((64, 128), 7.0 + c) for c in range(3)])
    mb.render_bonsai_tiles_into(torch.from_numpy(vol), base, u, ids, 128, 64,
                                tiles_per_unit=2, max_steps=64)
    for tid in (2, 3, 4, 5):
        _hold_tile(_tile(base.numpy(), tid, 128), tid, 128, port[(128, 64)],
                   jax_full[(128, 64)], 0.0)
    for tid in (0, 1, 6, 7):
        assert (_tile(base.numpy(), tid, 128)[0] == 7.0).all(), tid


def test_tiles_partial_frame_match_exact_frame():
    """At 96x80 (partial tile row) K2 writes only the frame's pixels of the
    listed tiles, equal to the port's exact frame (the same compact rays as
    rays_fragment_soa, bit for bit), and K1b zeroes the padding."""
    vol = torch.from_numpy(get_bonsai(32))
    u = Camera(aspect=96 / 80, **POSES["tilt"]).uniform("cpu")
    exact = mb.BonsaiRenderer(vol, "cpu")(u, 96, 80, max_steps=64, srgb=False)
    ids = torch.tensor([7, 3, 9, 8], dtype=torch.int32)  # 9 tiles; 9 parked
    base = torch.zeros((3, 80, 96))
    mb.render_bonsai_tiles_into(vol, base, u, ids, 96, 80, max_steps=64)
    mask = torch.zeros((80, 96), dtype=torch.bool)
    for tid in (7, 3, 8):
        ty, tx = divmod(tid, 3)
        mask[ty * 32:(ty + 1) * 32, tx * 32:(tx + 1) * 32] = True
    ex = exact[..., :3].permute(2, 0, 1)
    torch.testing.assert_close(base[:, mask], ex[:, mask], rtol=0, atol=0)
    assert float(base[:, ~mask].abs().max()) == 0.0
    compact = mb.render_bonsai_tiles(vol, u, ids, 96, 80, max_steps=64)
    # tile 7 is in the last tile row: rows 80..95 of the padded grid are empty
    assert float(compact[:, 16:32].abs().max()) == 0.0
    assert float(compact[:, 96:].abs().max()) == 0.0  # the parked id


def _edge_units_case(device, size, tpu, fast=False, plain=False):
    """K2 (the wrapper on ``device``, or with ``plain`` its plain version)
    over the units of the last tile row and the last tile column of a frame
    whose sides are not multiples of 32, plus a parked id, writing into
    planes that lie between two guard bands of one buffer. Returns what the tests hold: the written planes, the exact frame
    (linear rgb), the listed units' pixel mask, the guard bands, the compact
    rays' pixel coordinates and K1b's compact planes."""
    w, h = size
    vol = mb.volume_tensor(get_bonsai(32), device)
    u = Camera(aspect=w / h, **POSES["tilt"]).uniform(device)
    exact = mb.BonsaiRenderer(vol, device)(u, w, h, max_steps=64, srgb=False)
    ty, tx = -(-h // 32), -(-w // 32)
    n_units, row_units = ty * tx // tpu, tx // tpu
    listed = sorted(set(range(n_units - row_units, n_units))
                    | {r * row_units + row_units - 1 for r in range(ty)})
    ids = torch.tensor(listed + [n_units], dtype=torch.int32, device=device)
    guard, n_px = 4 * w, 3 * h * w
    buf = torch.full((n_px + 2 * guard,), -7.0, device=device)
    base = buf[guard:guard + n_px].view(3, h, w)
    base.zero_()
    into = mb.render_bonsai_tiles_into_plain if plain else mb.render_bonsai_tiles_into
    into(vol, base, u, ids, w, h, tpu, fast, max_steps=64)
    mask = hy.unit_pixel_mask(ids, tpu, w, h)
    _, _, (iy, ix) = mb.tile_rays_compact(u, ids, w, h, tpu)
    compact = (mb.render_bonsai_tiles_plain if plain else mb.render_bonsai_tiles)(
        vol, u, ids, w, h, tpu, fast, max_steps=64)
    return {"base": base, "exact": exact[..., :3].permute(2, 0, 1), "mask": mask,
            "guards": (buf[:guard], buf[guard + n_px:]), "iy": iy, "ix": ix,
            "compact": compact, "n_listed": len(listed), "tpu": tpu}


EDGE_CASES = [((200, 113), 1), ((160, 90), 1), ((250, 113), 2)]


@pytest.mark.parametrize("size,tpu", [((200, 113), 1), ((250, 113), 2), ((64, 64), 2)],
                         ids=["200x113", "250x113-pairs", "64x64-pairs"])
def test_unit_pixel_mask_covers_listed_tiles(size, tpu):
    """unit_pixel_mask marks exactly the 32x32 tiles of the listed units,
    cut at the frame's edge; a parked id marks nothing."""
    w, h = size
    ty, tx = -(-h // 32), -(-w // 32)
    n_units = ty * tx // tpu
    listed = [0, n_units // 2, n_units - 1]
    mask = hy.unit_pixel_mask(torch.tensor(listed + [n_units], dtype=torch.int32), tpu, w, h)
    want = np.zeros((ty * 32, tx * 32), dtype=bool)
    for unit in listed:
        for tile in range(unit * tpu, (unit + 1) * tpu):
            r, c = divmod(tile, tx)
            want[r * 32:(r + 1) * 32, c * 32:(c + 1) * 32] = True
    np.testing.assert_array_equal(mask.numpy(), want[:h, :w])


@pytest.mark.parametrize("size,tpu", EDGE_CASES, ids=["200x113", "160x90", "250x113-pairs"])
def test_tiles_last_row_and_column_stay_inside_frame(size, tpu):
    """K2's plain version over the last tile row and column of frames whose
    width and height are not multiples of 32 (config 4's 1080 rows leave a
    partial last tile row): the listed units' pixels inside the frame equal
    the port's exact frame bitwise (the compact rays repeat
    rays_fragment_soa op for op), every other pixel keeps its value and
    nothing lands in the guard bands; the compact rays of pixels past the
    frame edge lie outside the frame, and K1b leaves them at 0."""
    w, h = size
    c = _edge_units_case("cpu", size, tpu)
    torch.testing.assert_close(c["base"][:, c["mask"]], c["exact"][:, c["mask"]], rtol=0,
                               atol=0)
    assert float(c["base"][:, ~c["mask"]].abs().max()) == 0.0
    assert all(bool((g == -7.0).all()) for g in c["guards"])
    outside = (c["iy"] >= h) | (c["ix"] >= w)
    assert bool(outside.any()) and bool((c["iy"][~outside] < h).all())
    parked = torch.zeros_like(outside)
    parked[c["n_listed"] * tpu * 32:] = True
    assert float(c["compact"][:, outside | parked].abs().max()) == 0.0
    inside = ~outside & ~parked
    np.testing.assert_array_equal(
        c["compact"][:, inside].numpy(),
        c["exact"][:, c["iy"][inside], c["ix"][inside]].numpy())


# -- the hybrid frame ----------------------------------------------------------

def test_hybrid_full_budget_matches_exact():
    """test_pallas.py:530: with every tile selected and thresh -1 the hybrid
    frame is the exact frame, within 3e-5 (the re-march's polynomial
    palette, <= 1.4e-6 per channel, through sRGB's 12.92 slope)."""
    vol = get_bonsai(32)
    u = Camera.bonsai(1.0).uniform("cpu")
    r = hy.HybridBonsaiRenderer(vol, "cpu", intermediate=128, budget=4, thresh=-1.0)
    img = r(u, 64, 64)
    exact = mb.BonsaiRenderer(vol, "cpu")(u, 64, 64)
    assert r.route(u, 64, 64) == ("hybrid", 128, 4)
    assert float((img[..., :3] - exact[..., :3]).abs().max()) < 3e-5
    assert r.last_overflow == 0


@pytest.fixture(scope="module")
def hybrid_pair(jax_interp):
    """The port's and the JAX package's hybrid renderers on get_bonsai(64)
    at I=128, budget 3 of the 9 tiles of a 96x96 frame."""
    vol = get_bonsai(64)
    return vol, hy.HybridBonsaiRenderer(vol, "cpu", intermediate=128, budget=3), \
        jax_interp["hy"].HybridBonsaiRenderer(vol, intermediate=128, budget=3)


def _jax_selected(jhy, r, ju, w, h):
    """The JAX hybrid's selected tile ids at this pose, from its own fast
    frame's stats (hybrid.py:212-298)."""
    import jax.numpy as jnp
    from vokselis_tpu.ops.shear_warp import _render_fast as jax_render_fast

    _, statsp = jax_render_fast(r.packs, ju, w, h, r.intermediate, False,
                                return_aux="stats")
    ny, nx = -(-h // 32), -(-w // 32)
    st = jnp.asarray(_jax_stats_rows(statsp))
    scores = (st[:, 0] + 0.03 * st[:, 1]) / 1024.0 + (
        ((st[:, 3] + 4.0 * st[:, 2]) / 1024.0).reshape(ny, nx)
        * jhy._dilate3(st[:, 4].reshape(ny, nx))).reshape(-1)
    return np.asarray(jhy.select_units(scores, ny * nx, r.budget, jnp.float32(r.thresh),
                                       False))


@pytest.mark.parametrize("pose", ["bench", "tilt", "axis"])
def test_hybrid_matches_jax(hybrid_pair, jax_interp, pose):
    """The hybrid frame against the JAX package's HybridBonsaiRenderer on the
    CPU, one uniform: within the fast frame's bounds (test_torch_fast.py:
    542-561: max <= 2e-2, mean <= 3e-4), since the un-re-marched pixels are
    fast-frame pixels and the fast frames differ by bf16 rounding. The
    selections may differ where scores nearly tie; at these poses at least
    2 of the 3 picks agree. Both hybrids stay within the fast mode's bounds
    against the exact oracle (mean < 0.01, p99 < 0.15) and closer to it
    than the fast frame."""
    import jax.numpy as jnp
    from vokselis_tpu.ops.reference import render_bonsai as jax_render_bonsai

    vol, port, jax_r = hybrid_pair
    ju, u = _uniforms(pose)
    w = h = 96
    assert port.route(u, w, h) == ("hybrid", 128, 3)
    img = port(u, w, h)
    ref = np.asarray(jax_r(ju, w, h))
    assert img.shape == (h, w, 4) and bool(torch.isfinite(img).all())
    err = np.abs(img.numpy() - ref)
    assert err.max() <= 2e-2, err.max()
    assert err.mean() <= 3e-4, err.mean()
    _, _, ids = hy._render_hybrid(port.packs, port.vol, u, port.thresh, w, h, 128, 3, True)
    jids = _jax_selected(jax_interp["hy"], jax_r, ju, w, h)
    overlap = len(set(ids.tolist()) & set(jids.tolist()))
    assert overlap >= 2, (ids.tolist(), jids.tolist())
    oracle = reference.render_bonsai(torch.from_numpy(vol), u, width=w, height=h).numpy()
    jax_oracle = np.asarray(jax_render_bonsai(jnp.asarray(vol), ju, width=w, height=h))
    fast = shear_warp.FastBonsaiRenderer(vol, "cpu", intermediate=128)(u, w, h).numpy()
    for frame, exact in ((img.numpy(), oracle), (ref, jax_oracle)):
        e = np.abs(frame - exact)
        assert e.mean() < 0.01 and np.quantile(e, 0.99) < 0.15, e.mean()
        assert e.mean() < np.abs(fast - oracle).mean()


def test_hybrid_escalation_ladder(monkeypatch):
    """test_fast.py:492 on the port: degenerate-at-512 poses retry at I=768
    then I=1024 with 1.5x the budget before falling back to the exact
    kernel; eye-in-range poses fall back; a pinned hint bypasses the
    ladder."""
    calls = {}

    def fake_render_hybrid(packs, vol, u, thresh, w, h, ii, budget, srgb, max_steps,
                           pair=False):
        calls["mode"] = ("hybrid", ii, budget)
        return "img", 0, None

    def fake_exact(*a, **k):
        calls["mode"] = ("exact",)
        return "img"

    hints = {}
    r = hy.HybridBonsaiRenderer.__new__(hy.HybridBonsaiRenderer)
    r.packs = r.vol = None
    r.dims, r.intermediate, r.budget, r.thresh = 32, 512, 8, 0.0
    r.dense_fallback = False
    r.compiled = CompiledFrame("routes")
    r.exact = fake_exact
    monkeypatch.setattr(hy, "_render_hybrid", fake_render_hybrid)
    monkeypatch.setattr(hy, "pose_hint", lambda u, w, h, ii, d: hints[ii])

    hints = {512: (64, 128, False), 768: (96, 128, False)}
    r._call_traced(None, 64, 64)
    assert calls["mode"] == ("hybrid", 512, 8)
    hints = {512: (128, 256, True), 768: (128, 256, False)}
    r._call_traced(None, 64, 64)
    assert calls["mode"] == ("hybrid", 768, 12)
    assert r.route(None, 64, 64) == ("escalated", 768, 12)
    hints = {512: (0, 128, True), 768: (0, 128, True), 1024: (128, 256, False)}
    r._call_traced(None, 64, 64)
    assert calls["mode"] == ("hybrid", 1024, 12)
    hints = {512: (0, 128, True), 768: (0, 128, True), 1024: (0, 128, True)}
    r._call_traced(None, 64, 64)
    assert calls["mode"] == ("exact",)
    assert r.route(None, 64, 64) == ("exact", None, None)
    hints = {}
    r._call_traced(None, 64, 64, hint=(96, 128, False))
    assert calls["mode"] == ("hybrid", 512, 8)
    # a base at the top of the ladder has no step left
    r.intermediate = 1024
    hints = {1024: (0, 128, True)}
    assert r.route(None, 64, 64) == ("exact", None, None)


def test_dense_volume_routes_to_exact(monkeypatch):
    """test_fast.py:566 on the port: a volume denser than DENSE_OCC_FRAC
    renders every frame with the exact kernel, through the method and the
    functional API; the bonsai stays hybrid."""
    calls = {}

    def fake_exact(*a, **k):
        calls["mode"] = "exact"
        return "img"

    def fake_render_hybrid(*a, **k):
        calls["mode"] = "hybrid"
        return "img", 0, None

    monkeypatch.setattr(hy, "_render_hybrid", fake_render_hybrid)
    dense = hy.HybridBonsaiRenderer(dense_stress(64), "cpu", budget=8)
    assert dense.dense_fallback and dense.occ_frac > hy.DENSE_OCC_FRAC
    dense.exact = fake_exact
    dense._call_traced(None, 64, 64)
    assert calls["mode"] == "exact" and dense.route(None, 64, 64)[0] == "dense"
    dense.exact = lambda *a, **k: torch.zeros((2, 2, 4))
    render, pack = dense.functional()
    out = render(pack, None, 64, 64, with_degraded=True)
    assert out[2].dtype == torch.bool and not bool(out[2])
    sparse = hy.HybridBonsaiRenderer(get_bonsai(64), "cpu", budget=8)
    assert not sparse.dense_fallback and sparse.occ_frac < 0.1
    sparse._call_traced(None, 64, 64, hint=(0, 128, False))
    assert calls["mode"] == "hybrid"


def test_degraded_flag_unmissable_in_public_apis(monkeypatch):
    """test_fast.py:604 on the port: build_hybrid_renderer returns (img,
    degraded) and functional() includes the flag by default; unpatched, the
    flag is traced_degenerate's at a zoom-0.6 close-up and at the bench
    pose."""
    real = hy._render_hybrid
    vol = get_bonsai(32)
    render, pack = hy.build_hybrid_renderer(vol, "cpu", intermediate=64, budget=2)
    bad = Camera(zoom=0.6, pitch=1.2, yaw=0.0, target=(0.5, 0.5, 0.5),
                 aspect=1.0).uniform("cpu")
    img, deg = render(pack, bad, 32, 32)
    assert img.shape == (32, 32, 4) and bool(deg)
    _, deg = render(pack, Camera.bonsai(1.0).uniform("cpu"), 32, 32)
    assert not bool(deg)

    sentinel = object()
    monkeypatch.setattr(hy, "_render_hybrid", lambda *a, **k: ("img", 7, None))
    monkeypatch.setattr(hy, "traced_degenerate", lambda u, d: sentinel)
    render, pack = hy.build_hybrid_renderer(vol, "cpu", budget=8)
    img, deg = render(pack, None, 64, 64)
    assert img == "img" and deg is sentinel
    r = hy.HybridBonsaiRenderer(vol, "cpu", budget=8)
    frender, fpack = r.functional()
    out = frender(fpack, None, 64, 64)
    assert len(out) == 3 and out[2] is sentinel
    assert len(frender(fpack, None, 64, 64, with_degraded=False)) == 2
    assert real is not hy._render_hybrid


def test_run_hybrid_demo_cpu(monkeypatch):
    """run(BonsaiDemo, renderer="hybrid") for 2 frames at 64x48 on the CPU
    (64^3 volume): no kernel launches, no library built, and a frame closer
    to the exact demo's than the fast mode's budget."""
    monkeypatch.setattr(bonsai_model, "get_bonsai", lambda: get_bonsai(64))

    class HybridDemo(bonsai_model.BonsaiDemo):
        @classmethod
        def init(cls, ctx):
            return bonsai_model.BonsaiDemo.init(ctx, renderer="hybrid")

    def ctx():
        return Context(64, 48, camera=bonsai_model.BonsaiDemo.default_camera(64 / 48),
                       backbuffer_resolution=(64, 48), device="cpu")

    counts = (mb.LAUNCHES, mb.LAUNCHES_TILES, sr.LAUNCHES_RESAMPLE, sr.LAUNCHES_COMPOSITE,
              sr.LAUNCHES_RESAMPLE_COMPOSITE, warp2d.LAUNCHES_STATS, warp2d.LAUNCHES_WARP)
    hyb = run(HybridDemo, frames=2, context=ctx(), quiet=True)
    exact = run(bonsai_model.BonsaiDemo, frames=2, context=ctx(), quiet=True)
    assert hyb.frame == 2
    assert counts == (mb.LAUNCHES, mb.LAUNCHES_TILES, sr.LAUNCHES_RESAMPLE,
                      sr.LAUNCHES_COMPOSITE, sr.LAUNCHES_RESAMPLE_COMPOSITE,
                      warp2d.LAUNCHES_STATS, warp2d.LAUNCHES_WARP)
    assert mb._lib is None and sr._lib is None and warp2d._lib is None
    img, ref = hyb.display_image, exact.display_image
    assert img.shape == (48, 64, 4) and bool(torch.isfinite(img).all())
    assert float((img[..., :3].amax(dim=-1) > 0.05).float().mean()) > 0.01
    assert float((img - ref).abs().mean()) < 1e-3


# -- wrapper checks ------------------------------------------------------------

def _good_stats():
    return dict(chans=torch.zeros((4, 16, 16)), av=torch.zeros((40, 36)),
                bu=torch.zeros((40, 36)), ok=torch.ones((40, 36), dtype=torch.bool),
                box=torch.ones((40, 36), dtype=torch.bool))


def _good_tiles():
    return dict(vol=torch.zeros((8, 8, 8), dtype=torch.uint8),
                base_rgb=torch.zeros((3, 40, 64)),
                camera_uniform=Camera.bonsai(1.0).uniform("cpu"),
                unit_ids=torch.tensor([0, 3], dtype=torch.int32), width=64, height=40)


BAD_INPUTS = {
    "stats_three_channels": (warp2d.warp_stats, _good_stats,
                             lambda k: k.update(chans=torch.zeros((3, 16, 16))), ValueError),
    "stats_no_box": (warp2d.warp_stats, _good_stats, lambda k: k.update(box=None), TypeError),
    "stats_ok_float": (warp2d.warp_stats, _good_stats,
                       lambda k: k.update(ok=k["ok"].float()), TypeError),
    "tiles_ids_int64": (mb.render_bonsai_tiles_into, _good_tiles,
                        lambda k: k.update(unit_ids=k["unit_ids"].long()), TypeError),
    "tiles_pairs_odd_row": (mb.render_bonsai_tiles_into, _good_tiles,
                            lambda k: k.update(width=96, base_rgb=torch.zeros((3, 40, 96)),
                                               tiles_per_unit=2), ValueError),
    "tiles_three_per_unit": (mb.render_bonsai_tiles_into, _good_tiles,
                             lambda k: k.update(tiles_per_unit=3), ValueError),
    "tiles_base_shape": (mb.render_bonsai_tiles_into, _good_tiles,
                         lambda k: k.update(base_rgb=torch.zeros((3, 64, 40))), ValueError),
    "tiles_base_f64": (mb.render_bonsai_tiles_into, _good_tiles,
                       lambda k: k.update(base_rgb=k["base_rgb"].double()), TypeError),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_wrappers_reject_bad_inputs(case):
    fn, good, mutate, exc = BAD_INPUTS[case]
    kw = good()
    mutate(kw)
    with pytest.raises(exc):
        fn(**kw)


# -- on the card ---------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("pose", ["bench", "tilt"])
def test_hybrid_kernels_match_plain_on_gpu(cuda_device, pose):
    """K5, K2 and K1b against their plain versions on the card at a 64^3
    bonsai's fast geometry, 160x120 (partial tiles) and 128x96 (pairs):
    K5's rgb, EXT and PEAK exact and CURV/EDGE within 1e-5 relative; K2 and
    K1b bitwise in both transfer modes; the other pixels keep their base."""
    vol = get_bonsai(64)
    pack = shear_warp.prepare_fast_volume(vol, cuda_device)
    vol_t = mb.volume_tensor(vol, cuda_device)
    before = (warp2d.LAUNCHES_STATS, mb.LAUNCHES_TILES, mb.LAUNCHES_TILES_COMPACT)
    changed = False
    for w, h, tpu in ((160, 120, 1), (128, 96, 2)):
        u = Camera(aspect=w / h, **POSES[pose]).uniform(cuda_device)
        geo = shear_warp.fast_geometry(pack, u, w, h, 128)
        planes = sr.composite(sr.resample_slabs(pack[0], geo.m, geo.pos_u, geo.pos_v,
                                                geo.occ_k), geo.sgn, geo.irho, geo.occ_rb)
        av, bu, ok = shear_warp.warp_coords(geo, 128, 128)
        chans = torch.cat([planes[:3], shear_warp.curvature(planes)[None]])
        rgb, st = warp2d.warp_stats(chans, av, bu, ok, geo.hit)
        rgb_p, st_p = warp2d.warp_stats_plain(chans, av, bu, ok, geo.hit)
        torch.cuda.synchronize()
        assert torch.equal(rgb, rgb_p)
        for col in (warp2d.STAT_OVF, warp2d.STAT_EXT, warp2d.STAT_PEAK):
            assert torch.equal(st[:, col], st_p[:, col]), col
        for col in (warp2d.STAT_CURV, warp2d.STAT_EDGE):
            torch.testing.assert_close(st[:, col], st_p[:, col], rtol=1e-5, atol=0)
        n_units = (w // 32) * (-(-h // 32)) // tpu
        ids = torch.tensor([n_units - 1, 0, n_units, 2], dtype=torch.int32,
                           device=cuda_device)
        for fast in (False, True):
            base = rgb.clone()
            base_p = rgb.clone()
            mb.render_bonsai_tiles_into(vol_t, base, u, ids, w, h, tpu, fast)
            mb.render_bonsai_tiles_into_plain(vol_t, base_p, u, ids, w, h, tpu, fast)
            assert torch.equal(base, base_p), (w, h, fast)
            comp = mb.render_bonsai_tiles(vol_t, u, ids, w, h, tpu, fast)
            comp_p = mb.render_bonsai_tiles_plain(vol_t, u, ids, w, h, tpu, fast)
            assert torch.equal(comp, comp_p), (w, h, fast)
            changed |= bool((base != rgb).any())
    assert changed  # some listed tile holds content
    torch.cuda.synchronize()
    after = (warp2d.LAUNCHES_STATS, mb.LAUNCHES_TILES, mb.LAUNCHES_TILES_COMPACT)
    assert after == (before[0] + 2, before[1] + 4, before[2] + 4)


@pytest.mark.gpu
@pytest.mark.parametrize("size,tpu", EDGE_CASES, ids=["200x113", "160x90", "250x113-pairs"])
def test_tiles_last_row_and_column_stay_inside_frame_on_gpu(cuda_device, size, tpu):
    """K2 and K1b on the card over the last tile row and column of frames
    of partial tiles, both palettes: bitwise their plain versions on the
    card, every other pixel and both guard bands untouched."""
    for fast in (False, True):
        c = _edge_units_case(cuda_device, size, tpu, fast)
        p = _edge_units_case(cuda_device, size, tpu, fast, plain=True)
        torch.cuda.synchronize()
        assert torch.equal(c["base"], p["base"]), (size, fast)
        assert torch.equal(c["compact"], p["compact"]), (size, fast)
        assert float(c["base"][:, ~c["mask"]].abs().max()) == 0.0
        assert all(bool((g == -7.0).all()) for g in c["guards"])


@pytest.mark.gpu
def test_hybrid_frame_launches_on_gpu(cuda_device):
    """One hybrid frame on the card launches the fused slab stage (K3 ->
    K4 in one kernel), K5 and K2 once each, and neither K3, K4, K6 nor K1:
    the eager frame through the wrappers, the renderer's frames (its
    graph's warm-up, then replays) on the device; it agrees with the plain
    hybrid path."""
    r = hy.HybridBonsaiRenderer(get_bonsai(64), cuda_device, intermediate=128, budget=8)
    u = Camera.bonsai(4 / 3).uniform(cuda_device)
    assert r.route(u, 160, 120)[0] == "hybrid"
    names = ("LAUNCHES", "LAUNCHES_TILES")
    before = [getattr(mb, n) for n in names] + [
        sr.LAUNCHES_RESAMPLE, sr.LAUNCHES_COMPOSITE, sr.LAUNCHES_RESAMPLE_COMPOSITE,
        warp2d.LAUNCHES_STATS, warp2d.LAUNCHES_WARP]
    eager, _, _ = hy._render_hybrid(r.packs, r.vol, u, r.thresh, 160, 120, 128, 8, True)
    torch.cuda.synchronize()
    after = [getattr(mb, n) for n in names] + [
        sr.LAUNCHES_RESAMPLE, sr.LAUNCHES_COMPOSITE, sr.LAUNCHES_RESAMPLE_COMPOSITE,
        warp2d.LAUNCHES_STATS, warp2d.LAUNCHES_WARP]
    assert [a - b for a, b in zip(after, before)] == [0, 1, 0, 0, 1, 1, 0]
    kernels = ["march_bonsai_kernel", "march_tiles_kernel", "resample_kernel",
               "composite_kernel", "resample_composite_kernel", "warp_stats_kernel",
               "warp_kernel"]
    img, counts = kernel_launches(lambda: [r(u, 160, 120) for _ in range(3)][-1], kernels)
    assert [counts[k] for k in kernels] == [0, 3, 0, 0, 3, 3, 0]
    assert torch.equal(img, eager)
    plain, _, _ = hy._render_hybrid(r.packs, r.vol, u, r.thresh, 160, 120, 128, 8, True,
                                    plain=True)
    assert img.shape == (120, 160, 4) and bool(torch.isfinite(img).all())
    assert float((img - plain).abs().max()) <= 2e-3
