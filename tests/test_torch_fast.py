"""The fast shear-warp slice (vokselis_torch.ops.shear_warp with its kernels
K3/K4 in ops.cuda.shear_resample and K6 in ops.cuda.warp2d).

On the CPU every kernel wrapper takes its plain version. These tests hold
the plain versions against the JAX package's Pallas kernels run in
interpret mode (as tests/test_pallas.py and tests/test_fast.py run them),
the polynomials and pack preparation against the JAX package's, and the
whole fast frame against the JAX package's renderer on its XLA branch
(vokselis_tpu/ops/shear_warp.py:387), each with its tolerance and reason.

Tests marked ``gpu`` need a CUDA card and skip without one: they build and
launch the kernels and hold them against their plain versions on the same
tensors. On the card run ``python -m pytest tests/test_torch_*.py
--noconftest -m gpu`` (the repo's conftest imports JAX).
"""

import importlib

import numpy as np
import pytest
import torch

from vokselis_torch.core import colors
from vokselis_torch.core.camera import Camera, CameraUniform
from vokselis_torch.engine.context import Context
from vokselis_torch.engine.loop import run
from vokselis_torch.engine.profiler import kernel_launches
from vokselis_torch.models import bonsai as bonsai_model
from vokselis_torch.ops import reference, shear_warp
from vokselis_torch.ops.cuda import shear_resample as sr
from vokselis_torch.ops.cuda import warp2d
from vokselis_torch.volume.io import get_bonsai

# test_fast.py:67-71 and the eye-inside pose of :178
POSES = {
    "bench": dict(zoom=1.0, pitch=0.5, yaw=1.0, target=(0.5, 0.5, 0.5)),
    "tilt": dict(zoom=1.2, pitch=0.9, yaw=1.1, target=(0.5, 0.5, 0.5)),
    "axis": dict(zoom=1.0, pitch=0.1, yaw=0.0, target=(0.5, 0.5, 0.5)),
    "eye_inside": dict(zoom=0.3, pitch=0.1, yaw=0.7, target=(0.5, 0.5, 0.5)),
}


def _jax_uniform(pose, aspect=1.0):
    """The JAX camera's uniform and the same arrays carried across to the
    port (a one-ulp difference in inv_proj moves far-plane rays ~3e-4)."""
    from vokselis_tpu.core.camera import Camera as JaxCamera

    ju = JaxCamera(aspect=aspect, **POSES[pose]).uniform()
    u = CameraUniform.from_numpy(np.asarray(ju.view_position), np.asarray(ju.proj_view),
                                 np.asarray(ju.inv_proj), "cpu")
    return ju, u


def _interpret(monkeypatch, *modules):
    """Run every pallas_call of ``modules`` in interpret mode (reloaded so
    they pick up the patch; test_pallas.py:16-38)."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", patched)
    return [importlib.reload(importlib.import_module(m)) for m in modules]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The plain versions loop over slabs with thousands of small torch ops.
    With the suite's parallel workers, an OpenMP team per op oversubscribes
    the CPU many times over and slows every file (on an 8-core CPU with two
    workers, the entry-point test beside this file took 296 s instead of
    45 s). One intra-op thread keeps this file to one core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# -- colors ------------------------------------------------------------------

POLYS = {
    "fast": lambda m, x, r: m.bonsai_transfer_fast_soa(x),
    "pow_fast": lambda m, x, r: m.bonsai_transfer_pow_fast_soa(x, r),
    "pow_lowdeg": lambda m, x, r: m.bonsai_transfer_pow_lowdeg_soa(x, r),
}


@pytest.mark.parametrize("name", sorted(POLYS))
def test_polynomial_transfers_match_jax(name):
    """Same coefficients, same float32 Horner steps: equal within 1e-6
    (exp/log may differ by an ulp between the two libraries)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from vokselis_tpu.core import colors as jcolors

    for coeffs in ("_PAL_R", "_PAL_G", "_PAL_B", "_LN_P", "_EXP_Q", "_PAL_R_LO",
                   "_PAL_G_LO", "_PAL_B_LO", "_TVMAX", "_YMIN"):
        assert getattr(colors, coeffs) == getattr(jcolors, coeffs), coeffs
    rng = np.random.default_rng(4)
    x = rng.uniform(-0.2, 1.5, 4096).astype(np.float32)
    x[:4] = [0.0, 0.1, 0.9, 1.0]
    irho = rng.uniform(1.0, 3.0, 4096).astype(np.float32)
    port = POLYS[name](colors, torch.from_numpy(x), torch.from_numpy(irho))
    ref = POLYS[name](jcolors, jnp.asarray(x), jnp.asarray(irho))
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=0, atol=1e-6)
    # an empty sample stays exactly transparent
    assert float(port[0][0]) == 0.0


@pytest.mark.parametrize("width,height", [(64, 36), (100, 70), (1024, 1024)])
def test_geometry_helpers_match_jax(width, height):
    """center_ray_dir (the dominant-axis pick's ray) is the JAX package's
    bit for bit on one uniform; packed_pixel_grid gives the same tile
    packing."""
    pytest.importorskip("jax")
    from vokselis_tpu.core import geometry as jgeom
    from vokselis_torch.core import geometry

    ju, u = _jax_uniform("tilt", aspect=width / height)
    np.testing.assert_array_equal(geometry.center_ray_dir(u, width, height).numpy(),
                                  np.asarray(jgeom.center_ray_dir(ju, width, height)))
    ix, iy = geometry.packed_pixel_grid(width, height, "cpu")
    jx, jy = jgeom.packed_pixel_grid(width, height)
    assert ix.dtype == iy.dtype == torch.int32
    np.testing.assert_array_equal(ix.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(iy.numpy(), np.asarray(jy))


# -- packs and occupancy -----------------------------------------------------

@pytest.mark.parametrize("volume", ["bonsai64", "random32"])
def test_prepare_fast_volume_matches_jax(volume):
    """The three half-shifted bf16 packs are the JAX package's bit for bit,
    and so are the occupancy group tables."""
    pytest.importorskip("jax")
    from vokselis_tpu.ops.shear_warp import prepare_fast_volume as jax_prepare

    rng = np.random.default_rng(5)
    vol = (get_bonsai(64) if volume == "bonsai64" else  # sparse: cold groups too
           np.where(rng.random((32,) * 3) < 0.002,
                    rng.integers(0, 256, (32,) * 3), 0).astype(np.uint8))
    packs, (tab_u, tab_v) = shear_warp.prepare_fast_volume(vol, "cpu")
    jpacks = jax_prepare(vol)
    d = vol.shape[0]
    assert packs.shape == (3, d - 1, d, d) and packs.dtype == torch.bfloat16
    for i in range(3):
        np.testing.assert_array_equal(packs[i].float().numpy(),
                                      np.asarray(jpacks[i], np.float32))
    assert tab_u.shape == tab_v.shape == (3, d - 1, d // 8)
    np.testing.assert_array_equal(tab_u.numpy(), np.asarray(jpacks[3][0]))
    np.testing.assert_array_equal(tab_v.numpy(), np.asarray(jpacks[3][1]))
    assert 0 < tab_u.float().mean() < 1  # both hot and cold groups


def test_window_any_matches_jax_and_window_counts():
    """test_fast.py:416 on the port: _window_any agrees with
    _window_counts > 0 and with the JAX package's, on interior,
    clipped-low/high, inverted-empty windows and the -1e6 pad sentinel."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from vokselis_tpu.ops.shear_warp import _window_any as jax_window_any

    rng = np.random.default_rng(7)
    g, ng, nwin = 24, 32, 16
    tab = rng.random((g, ng)) > 0.6
    lo = rng.uniform(-40.0, 8.0 * ng + 40.0, (g, nwin)).astype(np.float32)
    hi = lo + rng.uniform(0.0, 120.0, (g, nwin)).astype(np.float32)
    lo[0] = hi[0] = -1e6
    hi[1] = lo[1] - 50.0
    t_tab, t_lo, t_hi = torch.from_numpy(tab), torch.from_numpy(lo), torch.from_numpy(hi)
    cum = torch.nn.functional.pad(torch.cumsum(t_tab.long(), dim=1), (1, 0))
    got = shear_warp._window_any(t_tab, t_lo, t_hi).numpy()
    np.testing.assert_array_equal(got, (shear_warp._window_counts(cum, t_lo, t_hi) > 0).numpy())
    np.testing.assert_array_equal(got, np.asarray(jax_window_any(
        jnp.asarray(tab), jnp.asarray(lo), jnp.asarray(hi))))
    assert got.any() and not got.all()


# -- K3 resample and K4 composite ---------------------------------------------

# test_pallas.py:302 (banded, d > _WB) and :342 (sparse volume) geometries
RESAMPLE_CASES = {
    "banded": dict(d=128, g=61, ii=256, gp=64, em=-40.0, denom=80.0, sparse=False),
    "sparse": dict(d=32, g=31, ii=128, gp=32, em=-50.0, denom=70.0, sparse=True),
}


def _resample_inputs(case):
    c = RESAMPLE_CASES[case]
    rng = np.random.default_rng(3)
    vol = rng.random((c["g"], c["d"], c["d"])).astype(np.float32)
    if c["sparse"]:
        vol *= rng.random(vol.shape) > 0.7
    s_k = (np.arange(c["gp"]) + 0.5 - c["em"]) / c["denom"]
    grid = np.linspace(-5, c["d"] + 5, c["ii"])
    pos_u = c["em"] + s_k[:, None] * (grid[None, :] - c["em"])
    pos_v = c["em"] + s_k[:, None] * (grid[None, :] * 0.9 - c["em"])
    valid = (np.arange(c["gp"]) < c["g"])[:, None]
    pos_u = np.where(valid, pos_u, -1e6).astype(np.float32)
    pos_v = np.where(valid, pos_v, -1e6).astype(np.float32)
    irho = (1.0 + rng.random((c["ii"], c["ii"]))).astype(np.float32)
    volb = torch.from_numpy(vol).to(torch.bfloat16)
    return volb, pos_u, pos_v, irho


@pytest.fixture(scope="module")
def jax_resampled():
    """The JAX package's resample_slabs (interpret mode) per case, cached:
    (port inputs, the JAX chunked stack, the same as a (gp, I, I) stack)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from vokselis_tpu.ops.pallas import shear_resample as jsr

    out = {}
    for case in RESAMPLE_CASES:
        volb, pos_u, pos_v, irho = _resample_inputs(case)
        vol_j = jnp.asarray(volb.float().numpy(), jnp.bfloat16)
        res = jsr.resample_slabs(vol_j, jnp.asarray(pos_u), jnp.asarray(pos_v),
                                 interpret=True)
        c, nrb, _, _, ii = res.shape
        stack = np.asarray(res, np.float32).transpose(0, 2, 1, 3, 4).reshape(c * 8, ii, ii)
        out[case] = (volb, pos_u, pos_v, irho, res, stack)
    return out


@pytest.mark.parametrize("case", sorted(RESAMPLE_CASES))
def test_resample_plain_matches_jax_interpret(jax_resampled, case):
    """K3's plain version against the TPU kernel in interpret mode. The TPU
    rounds its hat weights and the first product to bf16, the port lerps in
    float32; both round the result to bf16. Bound: three bf16 ulps of a
    value <= 1 (1.2e-2) at any texel, 1e-3 on average."""
    volb, pos_u, pos_v, _, _, stack_j = jax_resampled[case]
    m = torch.zeros(1, dtype=torch.int32)
    got = sr.resample_slabs(volb[None].contiguous(), m, torch.from_numpy(pos_u),
                            torch.from_numpy(pos_v))
    assert got.shape == stack_j.shape and got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - stack_j)
    assert err.max() <= 1.2e-2, err.max()
    assert err.mean() <= 1e-3, err.mean()
    g = RESAMPLE_CASES[case]["g"]
    assert float(got[g:].float().abs().max()) == 0.0  # sentinel rows: exact zeros


def test_resample_gate_and_pack_pick():
    """Gated-off slabs and padding rows are exact zeros; m picks the pack
    (and is clamped into range, as the kernel clamps it)."""
    rng = np.random.default_rng(8)
    packs = torch.from_numpy(rng.random((3, 5, 16, 16)).astype(np.float32)).to(torch.bfloat16)
    pos = torch.from_numpy(rng.uniform(-2.0, 17.0, (8, 24)).astype(np.float32))
    occ = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1], dtype=torch.bool)
    for m in (0, 2, 7):
        out = sr.resample_slabs(packs, torch.tensor([m], dtype=torch.int32), pos, pos, occ)
        ref = sr.resample_slabs(packs[min(m, 2)][None].contiguous(),
                                torch.zeros(1, dtype=torch.int32), pos, pos)
        assert out.shape == (8, 24, 24)
        for k in range(8):
            if k < 5 and bool(occ[k]):
                torch.testing.assert_close(out[k], ref[k], rtol=0, atol=0)
            else:
                assert float(out[k].float().abs().max()) == 0.0


def test_resample_is_a_zero_padded_bilinear_sample():
    """K3's function (the hat-weight sum of the TPU kernel) in float64 as
    an einsum: the plain version is within one bf16 rounding of it."""
    rng = np.random.default_rng(9)
    d, g, iu, iv = 16, 4, 40, 24
    vol = torch.from_numpy(rng.random((g, d, d)).astype(np.float32)).to(torch.bfloat16)
    pos_u = rng.uniform(-1.5, d + 0.5, (g, iu)).astype(np.float32)
    pos_v = rng.uniform(-1.5, d + 0.5, (g, iv)).astype(np.float32)
    got = sr.resample_slabs(vol[None].contiguous(), torch.zeros(1, dtype=torch.int32),
                            torch.from_numpy(pos_u), torch.from_numpy(pos_v))
    cols = np.arange(d)
    wu = np.maximum(0, 1 - np.abs(pos_u[:, None, :].astype(np.float64) - cols[None, :, None]))
    wv = np.maximum(0, 1 - np.abs(pos_v[:, None, :].astype(np.float64) - cols[None, :, None]))
    want = np.einsum("kvi,kvd,kdu->kiu", wv, vol.double().numpy(), wu)
    assert got.shape == (g, iv, iu)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("case", sorted(RESAMPLE_CASES))
@pytest.mark.parametrize("sgn", [1, -1])
def test_composite_plain_matches_jax_chunks(jax_resampled, case, sgn):
    """K4's plain version against composite_chunks in interpret mode, on
    the JAX package's own resampled stack: max <= 1e-4 (test_pallas.py:394;
    exp/log and the polynomial steps may round differently by an ulp)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from vokselis_tpu.ops.pallas import shear_resample as jsr

    _, _, _, irho, res, stack_j = jax_resampled[case]
    want = jsr.composite_chunks(res, jnp.int32(sgn), jnp.asarray(irho), interpret=True)
    got = sr.composite(torch.from_numpy(stack_j).to(torch.bfloat16),
                       torch.tensor([sgn], dtype=torch.int32), torch.from_numpy(irho))
    assert got.shape == (4,) + stack_j.shape[1:] and got.dtype == torch.float32
    for p, w in zip(got, want):
        err = np.abs(p.numpy() - np.asarray(w))
        assert err.max() <= 1e-4, err.max()
    assert float(got[3].max()) > 0.95  # some texels reach the 0.95 stop


@pytest.mark.parametrize("sgn", [1, -1])
def test_composite_exact_matches_jax_composite_pallas(monkeypatch, sgn):
    """K4b: the exact-transfer mode against composite_pallas in interpret
    mode on test_fast.py:120-167's input (40 slabs, dense enough that some
    texels cross the 0.95 stop): max <= 1e-4 (test_fast.py:165)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    (comp,) = _interpret(monkeypatch, "vokselis_tpu.ops.pallas.composite")
    try:
        rng = np.random.default_rng(11)
        g, ih, iw = 40, 16, 128
        res = rng.random((g, ih, iw), dtype=np.float32) * 0.9
        irho = 1.0 + rng.random((ih, iw), dtype=np.float32) * 0.7
        want = comp.composite_pallas(jnp.asarray(res), jnp.int32(sgn), jnp.asarray(irho))
        got = sr.composite(torch.from_numpy(res).to(torch.bfloat16),
                           torch.tensor([sgn], dtype=torch.int32), torch.from_numpy(irho),
                           transfer="exact")
        for p, w in zip(got, want):
            err = np.abs(p.numpy() - np.asarray(w))
            assert err.max() <= 1e-4, err.max()
        assert float(got[3].max()) > 0.95
    finally:
        monkeypatch.undo()
        importlib.reload(comp)


def test_composite_gate_skips_only_transparent_slabs():
    """The occupancy gate is exact where the gated slabs' samples are
    <= OCC_EPS (transfer 0), and skips a hot slab when asked to."""
    rng = np.random.default_rng(12)
    g, iv, iu = 12, 16, 24
    stack = rng.random((g, iv, iu)).astype(np.float32) * 0.9
    stack[3] *= 0.1  # transparent slabs
    stack[7] *= 0.05
    stack = torch.from_numpy(stack).to(torch.bfloat16)
    irho = torch.from_numpy((1.0 + rng.random((iv, iu))).astype(np.float32))
    sgn = torch.tensor([1], dtype=torch.int32)
    occ = torch.ones((g, 2), dtype=torch.bool)
    occ[3] = occ[7] = False
    full = sr.composite(stack, sgn, irho)
    torch.testing.assert_close(sr.composite(stack, sgn, irho, occ), full, rtol=0, atol=0)
    occ[5, 1] = False  # a hot slab, lower half of the rows only
    gated = sr.composite(stack, sgn, irho, occ)
    torch.testing.assert_close(gated[:, :8], full[:, :8], rtol=0, atol=0)
    assert not torch.equal(gated[:, 8:], full[:, 8:])
    # the count of samples composited: every live, gated-in slab (where
    # only transparent slabs are gated out, the count can only drop)
    planes, count = sr.composite_plain(stack, sgn, irho, occ, return_count=True)
    torch.testing.assert_close(planes, gated, rtol=0, atol=0)
    _, count_all = sr.composite_plain(stack, sgn, irho, return_count=True)
    assert count.dtype == torch.int32 and count.shape == (iv, iu)
    assert 0 < int(count_all.min()) and int(count_all.max()) <= g
    assert bool((count[:8] <= count_all[:8]).all())
    assert not torch.equal(count[8:], count_all[8:])


# -- K6 warp -----------------------------------------------------------------

def _warp_case(name):
    """test_fast.py:34 / :93 / :185 inputs: (chans, av, bu, pixels to hold)."""
    if name == "rotated":
        rng = np.random.default_rng(7)
        chans = rng.random((3, 64, 64), dtype=np.float32)
        yy, xx = np.mgrid[0:32, 0:32].astype(np.float32)
        av, bu = 0.9 * yy + 0.3 * xx + 2.7, -0.2 * yy + 1.1 * xx + 5.1
        keep = np.ones(av.shape, bool)
    elif name == "silhouette":
        rng = np.random.default_rng(9)
        chans = rng.random((3, 128, 128), dtype=np.float32)
        yy, xx = np.mgrid[0:32, 0:32].astype(np.float32)
        av, bu = 0.4 * yy + 90.0, 0.4 * xx + 30.0
        av[0, 0] = bu[0, 0] = 1e6  # one parked miss pixel
        keep = np.ones(av.shape, bool)
        keep[0, 0] = False
    else:  # four channels
        rng = np.random.default_rng(3)
        chans = rng.random((4, 64, 64), dtype=np.float32)
        yy, xx = np.mgrid[0:32, 0:32].astype(np.float32)
        av, bu = 0.8 * yy + 0.2 * xx + 4.0, 0.1 * yy + 1.0 * xx + 8.0
        keep = np.ones(av.shape, bool)
    return chans, av.astype(np.float32), bu.astype(np.float32), keep


WARP_CASES = ["rotated", "silhouette", "four_channels"]


@pytest.mark.parametrize("case", WARP_CASES)
def test_warp_plain_matches_map_coordinates(case):
    """K6's plain version is the edge-clamped bilinear lookup: against
    scipy-style map_coordinates(order=1, mode="nearest") in float32 at every
    held pixel, within 1e-6 (the two weight the taps in another order)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.scipy.ndimage import map_coordinates

    chans, av, bu, keep = _warp_case(case)
    got = warp2d.warp_bilinear(torch.from_numpy(chans), torch.from_numpy(av),
                               torch.from_numpy(bu), torch.from_numpy(keep))
    want = np.stack([np.asarray(map_coordinates(jnp.asarray(c), [jnp.asarray(av),
                                                                 jnp.asarray(bu)],
                                                order=1, mode="nearest"))
                     for c in chans])
    got = got.numpy()
    assert got.shape == (chans.shape[0],) + av.shape
    np.testing.assert_allclose(got[:, keep], want[:, keep], rtol=0, atol=1e-6)
    assert (got[:, ~keep] == 0).all()  # parked pixels are masked, not edge taps


@pytest.mark.parametrize("kernel", ["mxu", "scan"])
@pytest.mark.parametrize("case", WARP_CASES)
def test_warp_plain_matches_jax_kernel(monkeypatch, kernel, case):
    """K6's plain version against the TPU warp kernels in interpret mode
    (both the MXU kernel and the row-scan fallback, test_fast.py:12-31).
    The TPU kernels hold the channels (and the MXU kernel its hat weights)
    in bf16: within 5e-3 (test_fast.py:55) at every held pixel."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    monkeypatch.setenv("VOK_WARP_MXU", "1" if kernel == "mxu" else "0")
    (w2,) = _interpret(monkeypatch, "vokselis_tpu.ops.pallas.warp2d")
    try:
        chans, av, bu, keep = _warp_case(case)
        want = np.asarray(w2.warp_bilinear_pallas(jnp.asarray(chans), jnp.asarray(av),
                                                  jnp.asarray(bu)))
        got = warp2d.warp_bilinear(torch.from_numpy(chans), torch.from_numpy(av),
                                   torch.from_numpy(bu)).numpy()
        err = np.abs(got - want)[:, keep]
        assert err.max() < 5e-3, err.max()
    finally:
        monkeypatch.undo()
        importlib.reload(w2)


def test_warp_overflow_plane_is_zero():
    """The footprint that overflows the TPU kernel's 16-row window
    (test_fast.py:271) is sampled exactly here and flags nothing."""
    rng = np.random.default_rng(3)
    chans = torch.from_numpy(rng.random((3, 128, 128), dtype=np.float32))
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32)
    av, bu = torch.from_numpy(2.0 * yy + 1.0), torch.from_numpy(xx + 1.0)
    planes, ovf = warp2d.warp_bilinear(chans, av, bu, with_overflow=True)
    assert ovf.shape == (32, 32) and float(ovf.abs().max()) == 0.0
    # integer coordinates: the lookup is the texel itself
    want = chans[:, 2 * yy.astype(np.int64) + 1, xx.astype(np.int64) + 1]
    torch.testing.assert_close(planes, want, rtol=0, atol=0)


# -- host-side pose classification -------------------------------------------

HINT_POSES = [(0.6, 0.5, 0.0), (1.0, 0.5, 1.0), (1.0, 0.5, 0.0), (1.6, 0.5, np.pi / 4),
              (0.6, 1.2, 0.0), (0.6, 1.2, np.pi / 4), (1.0, 1.2, 0.0)]


@pytest.mark.parametrize("zoom,pitch,yaw", HINT_POSES)
def test_pose_hint_matches_jax(zoom, pitch, yaw):
    """test_fast.py:365's poses: pose_hint returns the JAX package's
    (window, window, degenerate) on the same uniform, at I=512 and 768."""
    pytest.importorskip("jax")
    from vokselis_tpu.core.camera import Camera as JaxCamera
    from vokselis_tpu.ops.shear_warp import pose_hint as jax_pose_hint

    ju = JaxCamera(zoom=zoom, pitch=pitch, yaw=yaw, target=(0.5, 0.5, 0.5),
                   aspect=1.0).uniform()
    u = CameraUniform.from_numpy(np.asarray(ju.view_position), np.asarray(ju.proj_view),
                                 np.asarray(ju.inv_proj), "cpu")
    for ii in (512, 768):
        assert shear_warp.pose_hint(u, 1024, 1024, ii, 256) == \
            jax_pose_hint(ju, 1024, 1024, ii, 256)


def test_pose_hint_classification():
    """test_fast.py:365 and :443 on the port: close-ups and near-slab scale
    collapse are degenerate, the bench pose is not, diagonal yaws need
    wider windows than axis-aligned ones, and the device-side mirror agrees
    with the host classifier on the scalar criteria."""
    def uni(zoom, pitch, yaw):
        return Camera(zoom=zoom, pitch=pitch, yaw=yaw, target=(0.5, 0.5, 0.5),
                      aspect=1.0).uniform("cpu")

    def hint(zoom, pitch, yaw, ii=512):
        return shear_warp.pose_hint(uni(zoom, pitch, yaw), 1024, 1024, ii, 256)

    assert hint(0.6, 0.5, 0.0)[2] is True
    assert shear_warp.pose_hint(Camera.bonsai(1.0).uniform("cpu"), 1024, 1024, 512,
                                256)[2] is False
    ax, diag = hint(1.0, 0.5, 0.0), hint(1.6, 0.5, 2 * np.pi / 8)
    assert ax[2] is False
    assert diag[0] > ax[0] or diag[1] > ax[1]
    for yaw in (0.0, np.pi / 4):
        assert hint(0.6, 1.2, yaw)[2] is True
        assert hint(0.6, 1.2, yaw, ii=768)[2] is True
    assert hint(1.0, 1.2, 0.0)[2] is False
    bad, good = uni(0.6, 1.2, 0.0), Camera.bonsai(1.0).uniform("cpu")
    flag_bad, flag_good = (shear_warp.traced_degenerate(u, 256) for u in (bad, good))
    assert flag_bad.dtype == torch.bool and flag_bad.shape == ()
    assert bool(flag_bad) and not bool(flag_good)
    assert shear_warp.pose_hint(bad, 256, 256, 256, 256)[2]
    assert not shear_warp.pose_hint(good, 256, 256, 256, 256)[2]


def test_traced_degenerate_matches_jax():
    pytest.importorskip("jax")
    from vokselis_tpu.core.camera import Camera as JaxCamera
    from vokselis_tpu.ops.shear_warp import traced_degenerate as jax_degenerate

    for zoom, pitch, yaw in HINT_POSES + [(0.3, 0.1, 0.7)]:
        ju = JaxCamera(zoom=zoom, pitch=pitch, yaw=yaw, target=(0.5, 0.5, 0.5),
                       aspect=1.0).uniform()
        u = CameraUniform.from_numpy(np.asarray(ju.view_position), np.asarray(ju.proj_view),
                                     np.asarray(ju.inv_proj), "cpu")
        for d in (64, 256):
            assert bool(shear_warp.traced_degenerate(u, d)) == bool(jax_degenerate(ju, d))


# -- the slice end to end ----------------------------------------------------

@pytest.fixture(scope="module")
def fast_pair():
    """The port's and the JAX package's fast renderers on get_bonsai(64) at
    I=128 (test_fast.py:65-66)."""
    pytest.importorskip("jax")
    from vokselis_tpu.ops.shear_warp import FastBonsaiRenderer as JaxFast

    vol = get_bonsai(64)
    return vol, shear_warp.FastBonsaiRenderer(vol, "cpu", intermediate=128), \
        JaxFast(vol, intermediate=128)


@pytest.mark.parametrize("pose", ["bench", "tilt", "axis"])
def test_fast_renderer_matches_jax(fast_pair, pose):
    """The whole fast frame at 64x64 against the JAX package's on its XLA
    branch, on one uniform. The XLA branch keeps the resampled values in
    float32 from bf16 hat weights; the port rounds its stack to bf16 from
    float32 lerps: up to a few bf16 ulps of a sample at a pixel (max
    <= 2e-2 after sRGB), mean <= 3e-4. Both frames stay within the fast
    mode's budget against the exact oracle (test_fast.py:78-79)."""
    import jax.numpy as jnp
    from vokselis_tpu.ops.reference import render_bonsai as jax_render_bonsai

    vol, port, jax_fast = fast_pair
    ju, u = _jax_uniform(pose)
    img = port(u, width=64, height=64)
    assert img.shape == (64, 64, 4) and img.dtype == torch.float32
    img = img.numpy()
    ref = np.asarray(jax_fast(ju, width=64, height=64))
    assert np.isfinite(img).all()
    err = np.abs(img - ref)
    assert err.max() <= 2e-2, err.max()
    assert err.mean() <= 3e-4, err.mean()
    oracle = reference.render_bonsai(torch.from_numpy(vol), u, width=64, height=64).numpy()
    jax_oracle = np.asarray(jax_render_bonsai(jnp.asarray(vol), ju, width=64, height=64))
    for frame, exact in ((img, oracle), (ref, jax_oracle)):
        e = np.abs(frame - exact)
        assert e.mean() < 0.01, e.mean()
        assert np.quantile(e, 0.99) < 0.15
    assert (img[..., :3].max(axis=-1) > 0.05).mean() > 0.01  # the volume is in view


def test_fast_renderer_eye_inside_is_finite():
    """test_fast.py:170: with the eye inside the volume the factorization
    degrades, but the frame stays finite."""
    r = shear_warp.FastBonsaiRenderer(get_bonsai(32), "cpu", intermediate=64)
    cam = Camera(aspect=1.0, **POSES["eye_inside"])
    img = r(cam.uniform("cpu"), width=32, height=32)
    assert img.shape == (32, 32, 4) and bool(torch.isfinite(img).all())


def test_build_fast_renderer_api():
    """test_fast.py:82 on the port, plus: the CPU path launches nothing,
    the plain flag computes the same frame, the TPU-only packed aux
    contract raises, and the "stats" and True contracts keep the frame."""
    vol = get_bonsai(32)
    u = Camera.bonsai(1.0).uniform("cpu")
    render, pack = shear_warp.build_fast_renderer(vol, "cpu", intermediate=64)
    before = (sr.LAUNCHES_RESAMPLE, sr.LAUNCHES_COMPOSITE, sr.LAUNCHES_RESAMPLE_COMPOSITE,
              warp2d.LAUNCHES_WARP)
    img = render(pack, u, 32, 32)
    assert img.shape == (32, 32, 4) and bool(torch.isfinite(img).all())
    assert (sr.LAUNCHES_RESAMPLE, sr.LAUNCHES_COMPOSITE, sr.LAUNCHES_RESAMPLE_COMPOSITE,
            warp2d.LAUNCHES_WARP) == before
    assert sr._lib is None and warp2d._lib is None
    r = shear_warp.FastBonsaiRenderer(vol, "cpu", intermediate=64)
    torch.testing.assert_close(r(u, 32, 32), img, rtol=0, atol=0)
    plain = shear_warp._render_fast(pack, u, 32, 32, 64, True, plain=True)
    torch.testing.assert_close(plain, img, rtol=0, atol=0)
    lin = r(u, 32, 32, srgb=False)
    assert float(lin[..., :3].max()) < float(img[..., :3].max())
    with pytest.raises(NotImplementedError, match="deliberate removals"):
        shear_warp._render_fast(pack, u, 32, 32, 64, True, return_aux="packed")
    rgb, stats = shear_warp._render_fast(pack, u, 32, 32, 64, True, return_aux="stats")
    assert rgb.shape == (3, 32, 32) and stats.shape == (1, 5)
    torch.testing.assert_close(rgb.permute(1, 2, 0), lin[..., :3], rtol=0, atol=0)
    aux_img, bad, errd = shear_warp._render_fast(pack, u, 32, 32, 64, True, return_aux=True)
    torch.testing.assert_close(aux_img, img, rtol=0, atol=0)
    assert bad.shape == errd.shape == (32, 32)
    with pytest.raises(ValueError):
        r(u, 32, 32, intermediate=60)


def test_run_fast_demo_cpu(monkeypatch):
    """run(BonsaiDemo, renderer="fast") for 2 frames on the CPU (64^3
    volume to keep the plain resample short), against the exact demo's
    frame within the fast mode's budget."""
    monkeypatch.setattr(bonsai_model, "get_bonsai", lambda: get_bonsai(64))

    class FastDemo(bonsai_model.BonsaiDemo):
        @classmethod
        def init(cls, ctx):
            return bonsai_model.BonsaiDemo.init(ctx, renderer="fast")

    def ctx():
        return Context(64, 48, camera=bonsai_model.BonsaiDemo.default_camera(64 / 48),
                       backbuffer_resolution=(64, 48), device="cpu")

    fast = run(FastDemo, frames=2, context=ctx(), quiet=True)
    exact = run(bonsai_model.BonsaiDemo, frames=2, context=ctx(), quiet=True)
    assert fast.frame == 2
    img, ref = fast.display_image, exact.display_image
    assert img.shape == (48, 64, 4) and bool(torch.isfinite(img).all())
    assert float((img[..., :3].amax(dim=-1) > 0.05).float().mean()) > 0.01
    assert float((img - ref).abs().mean()) < 0.01
    assert type(bonsai_model.BonsaiDemo.init(ctx(), renderer="hybrid").renderer).__name__ \
        == "HybridBonsaiRenderer"
    with pytest.raises(ValueError):
        bonsai_model.BonsaiDemo.init(ctx(), renderer="slow")


# -- wrapper checks ----------------------------------------------------------

def _good_resample():
    return dict(packs=torch.zeros((3, 7, 8, 8), dtype=torch.bfloat16),
                m=torch.zeros(1, dtype=torch.int32), pos_u=torch.zeros((8, 16)),
                pos_v=torch.zeros((8, 16)), occ=torch.ones(8, dtype=torch.bool))


def _good_composite():
    return dict(stack=torch.zeros((8, 16, 16), dtype=torch.bfloat16),
                sgn=torch.ones(1, dtype=torch.int32), irho=torch.ones((16, 16)),
                occ=torch.ones((8, 2), dtype=torch.bool))


def _good_warp():
    return dict(chans=torch.zeros((3, 16, 16)), av=torch.zeros((4, 5)),
                bu=torch.zeros((4, 5)), hit=torch.ones((4, 5), dtype=torch.bool))


BAD_INPUTS = {
    "resample_packs_f32": (sr.resample_slabs, _good_resample,
                           lambda k: k.update(packs=k["packs"].float()), TypeError),
    "resample_packs_3d": (sr.resample_slabs, _good_resample,
                          lambda k: k.update(packs=k["packs"][0]), ValueError),
    "resample_m_int64": (sr.resample_slabs, _good_resample,
                         lambda k: k.update(m=k["m"].long()), TypeError),
    "resample_rows_differ": (sr.resample_slabs, _good_resample,
                             lambda k: k.update(pos_v=k["pos_v"][:4]), ValueError),
    "resample_occ_shape": (sr.resample_slabs, _good_resample,
                           lambda k: k.update(occ=k["occ"][:4]), ValueError),
    "resample_on_meta": (sr.resample_slabs, _good_resample,
                         lambda k: k.update({n: t.to("meta") for n, t in k.items()}),
                         ValueError),
    "composite_stack_f32": (sr.composite, _good_composite,
                            lambda k: k.update(stack=k["stack"].float()), TypeError),
    "composite_irho_shape": (sr.composite, _good_composite,
                             lambda k: k.update(irho=torch.ones((16, 8))), ValueError),
    "composite_occ_blocks": (sr.composite, _good_composite,
                             lambda k: k.update(occ=torch.ones((8, 3), dtype=torch.bool)),
                             ValueError),
    "composite_transfer": (sr.composite, _good_composite,
                           lambda k: k.update(transfer="cubic"), ValueError),
    "composite_not_contiguous": (sr.composite, _good_composite,
                                 lambda k: k.update(stack=k["stack"].transpose(1, 2)),
                                 ValueError),
    "warp_five_channels": (warp2d.warp_bilinear, _good_warp,
                           lambda k: k.update(chans=torch.zeros((5, 16, 16))), ValueError),
    "warp_hit_float": (warp2d.warp_bilinear, _good_warp,
                       lambda k: k.update(hit=k["hit"].float()), TypeError),
    "warp_coords_shape": (warp2d.warp_bilinear, _good_warp,
                          lambda k: k.update(bu=torch.zeros((5, 4))), ValueError),
    "warp_chans_numpy": (warp2d.warp_bilinear, _good_warp,
                         lambda k: k.update(chans=k["chans"].numpy()), TypeError),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_wrappers_reject_bad_inputs(case):
    fn, good, mutate, exc = BAD_INPUTS[case]
    kw = good()
    mutate(kw)
    with pytest.raises(exc):
        fn(**kw)


def test_cuda_device_without_cuda_raises():
    """No silent move to the CPU: asking for the card where there is none
    is an error."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        shear_warp.FastBonsaiRenderer(get_bonsai(32), "cuda")


# -- on the card -------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("pose", ["bench", "tilt", "eye_inside"])
def test_kernels_match_plain_on_gpu(cuda_device, pose):
    """K3, K4, K4b and K6 against their plain versions on the card, at the
    fast frame's geometry (64^3 bonsai, 160x120, I=128): K3 within one bf16
    ulp of the value, K4/K4b within 1e-4, K6 within 1e-6 (the kernels
    repeat the plain float32 operations in order, built with --fmad=false)."""
    pack = shear_warp.prepare_fast_volume(get_bonsai(64), cuda_device)
    u = Camera(aspect=4 / 3, **POSES[pose]).uniform(cuda_device)
    geo = shear_warp.fast_geometry(pack, u, 160, 120, 128)
    before = (sr.LAUNCHES_RESAMPLE, sr.LAUNCHES_COMPOSITE, warp2d.LAUNCHES_WARP)
    stack = sr.resample_slabs(pack[0], geo.m, geo.pos_u, geo.pos_v, geo.occ_k)
    stack_p = sr.resample_slabs_plain(pack[0], geo.m, geo.pos_u, geo.pos_v, geo.occ_k)
    torch.cuda.synchronize()
    _, exp = torch.frexp(stack_p.float())
    ulp = torch.where(stack_p == 0, 0.0, torch.ldexp(torch.ones_like(exp, dtype=torch.float32),
                                                       exp - 8))
    assert bool(((stack.float() - stack_p.float()).abs() <= ulp).all())
    for sgn in (geo.sgn, -geo.sgn):
        for transfer in sr.TRANSFERS:
            planes = sr.composite(stack, sgn, geo.irho, geo.occ_rb, transfer)
            planes_p = sr.composite_plain(stack, sgn, geo.irho, geo.occ_rb, transfer)
            assert float((planes - planes_p).abs().max()) <= 1e-4
    planes = sr.composite(stack, geo.sgn, geo.irho, geo.occ_rb)
    av = torch.rand((120, 160), device=cuda_device) * 140.0 - 6.0
    bu = torch.rand((120, 160), device=cuda_device) * 140.0 - 6.0
    hit = torch.rand((120, 160), device=cuda_device) > 0.3
    for n_ch in (3, 4):
        w = warp2d.warp_bilinear(planes[:n_ch], av, bu, hit)
        w_p = warp2d.warp_plain(planes[:n_ch], av, bu, hit)
        assert float((w - w_p).abs().max()) <= 1e-6
    torch.cuda.synchronize()
    after = (sr.LAUNCHES_RESAMPLE, sr.LAUNCHES_COMPOSITE, warp2d.LAUNCHES_WARP)
    assert after == (before[0] + 1, before[1] + 5, before[2] + 2)


@pytest.mark.gpu
def test_fast_frame_launches_on_gpu(cuda_device):
    """One fast frame on the card launches the fused slab stage (K3 -> K4
    in one kernel) and K6 once each, K3 and K4 never: the eager frame
    through the wrappers, the renderer's frames (its graph's warm-up, then
    replays) on the device; it agrees with the plain path on the card (a
    rejected call launches nothing)."""
    r = shear_warp.FastBonsaiRenderer(get_bonsai(64), cuda_device, intermediate=128)
    u = Camera.bonsai(4 / 3).uniform(cuda_device)
    before = (sr.LAUNCHES_RESAMPLE, sr.LAUNCHES_COMPOSITE, sr.LAUNCHES_RESAMPLE_COMPOSITE,
              warp2d.LAUNCHES_WARP)
    eager = shear_warp._render_fast(r.packs, u, 160, 120, 128, True)
    torch.cuda.synchronize()
    after = (sr.LAUNCHES_RESAMPLE, sr.LAUNCHES_COMPOSITE, sr.LAUNCHES_RESAMPLE_COMPOSITE,
             warp2d.LAUNCHES_WARP)
    assert tuple(a - b for a, b in zip(after, before)) == (0, 0, 1, 1)
    names = ["resample_kernel", "composite_kernel", "resample_composite_kernel", "warp_kernel"]
    img, counts = kernel_launches(lambda: [r(u, 160, 120) for _ in range(3)][-1], names)
    assert [counts[n] for n in names] == [0, 0, 3, 3] and torch.equal(img, eager)
    after = (sr.LAUNCHES_RESAMPLE, sr.LAUNCHES_COMPOSITE, sr.LAUNCHES_RESAMPLE_COMPOSITE,
             warp2d.LAUNCHES_WARP)
    plain = shear_warp._render_fast(r.packs, u, 160, 120, 128, True, plain=True)
    assert img.shape == (120, 160, 4) and bool(torch.isfinite(img).all())
    assert float((img - plain).abs().max()) <= 2e-3  # K4's 1e-4 through sRGB's slope
    with pytest.raises(TypeError):
        warp2d.warp_bilinear(torch.zeros((3, 8, 8), device=cuda_device),
                             torch.zeros((4, 4), device=cuda_device, dtype=torch.float64),
                             torch.zeros((4, 4), device=cuda_device))
    assert warp2d.LAUNCHES_WARP == after[3]
