"""The fused slab stage of the fast and hybrid frames:
``vokselis_torch.ops.cuda.shear_resample.resample_composite`` (K3 -> K4 in
one kernel) and its window rule ``slab_windows``.

On the CPU the wrapper takes its plain version, ``composite_plain`` of
``resample_slabs_plain``. These tests hold it against the JAX package's
``resample_composite`` in interpret mode, show that leaving out every slab
that either gate turns off is exact, mirror the kernel's tile walk (live
slabs in marching order, shared-memory windows, the tile's saturation exit)
bitwise against the plain version, and check that the windows cover every
tap. Tests marked ``gpu`` launch the kernel on the card: run them there
with ``python -m pytest tests/test_torch_*.py --noconftest -m gpu``.
"""

import numpy as np
import pytest
import torch

from test_torch_fast import RESAMPLE_CASES, _resample_inputs
from vokselis_torch.core.camera import Camera
from vokselis_torch.core.colors import bonsai_transfer_pow_lowdeg_soa, bonsai_transfer_soa
from vokselis_torch.ops import shear_warp
from vokselis_torch.ops.cuda import shear_resample as sr
from vokselis_torch.volume.io import get_bonsai

POSES = {
    "bench": dict(zoom=1.0, pitch=0.5, yaw=1.0),
    "tilt": dict(zoom=1.2, pitch=0.9, yaw=1.1),
    # the bench pose at the zoom clamp: the eye inside the volume
    "eye_inside": dict(zoom=0.3, pitch=0.5, yaw=1.0),
}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The plain versions and the tile mirror loop over thousands of small
    torch ops; one intra-op thread keeps the suite's parallel workers from
    oversubscribing the CPU (as in test_torch_fast.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _geometry(size, ii, pose, device="cpu", width=96, height=72):
    pack = shear_warp.prepare_fast_volume(get_bonsai(size), device)
    u = Camera(aspect=width / height, target=(0.5, 0.5, 0.5), **POSES[pose]).uniform(device)
    return pack, shear_warp.fast_geometry(pack, u, width, height, ii)


def _args(pack, geo):
    return (pack[0], geo.m, geo.pos_u, geo.pos_v, geo.sgn, geo.irho, geo.occ_k, geo.occ_rb)


# -- against the JAX package --------------------------------------------------

@pytest.mark.parametrize("case", sorted(RESAMPLE_CASES))
@pytest.mark.parametrize("sgn", [1, -1])
def test_resample_composite_matches_jax(case, sgn):
    """The fused stage against the JAX package's resample_composite
    (interpret mode). The composite holds test_composite_plain_matches_jax_
    chunks's 1e-4 when both composite the same samples: the port's fused
    planes against the JAX composite_chunks of the port's own resampled
    stack. End to end the two resamples round differently (the TPU's bf16
    hat weights and bf16 partial product: up to 3 bf16 ulps, 1.2e-2, at a
    texel; test_resample_plain_matches_jax_interpret), which the transfer
    and palette carry into the planes: measured 6.1e-2 max, 4.1e-3 mean
    over these cases; held at 0.1 and 1e-2."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from vokselis_tpu.ops.pallas import shear_resample as jsr

    volb, pos_u, pos_v, irho = _resample_inputs(case)
    m = torch.zeros(1, dtype=torch.int32)
    sg = torch.tensor([sgn], dtype=torch.int32)
    pu, pv, rho = torch.from_numpy(pos_u), torch.from_numpy(pos_v), torch.from_numpy(irho)
    got = sr.resample_composite(volb[None].contiguous(), m, pu, pv, sg, rho)
    ii = pos_u.shape[1]
    assert got.shape == (4, ii, ii) and got.dtype == torch.float32
    stack = sr.resample_slabs(volb[None].contiguous(), m, pu, pv)
    c = stack.shape[0] // 8
    res = stack.float().numpy().reshape(c, 8, ii // 8, 8, ii).transpose(0, 2, 1, 3, 4)
    same_samples = jsr.composite_chunks(jnp.asarray(res, jnp.bfloat16), jnp.int32(sgn),
                                        jnp.asarray(irho), interpret=True)
    end_to_end = jsr.resample_composite(jnp.asarray(volb.float().numpy(), jnp.bfloat16),
                                        jnp.asarray(pos_u), jnp.asarray(pos_v), jnp.int32(sgn),
                                        jnp.asarray(irho), interpret=True)
    for p, w, e in zip(got, same_samples, end_to_end):
        assert np.abs(p.numpy() - np.asarray(w)).max() <= 1e-4
        err = np.abs(p.numpy() - np.asarray(e))
        assert err.max() <= 0.1 and err.mean() <= 1e-2, (err.max(), err.mean())
    assert float(got[3].max()) > 0.95  # some texels reach the 0.95 stop


# -- the gates ----------------------------------------------------------------

@pytest.mark.parametrize("transfer", sr.TRANSFERS)
@pytest.mark.parametrize("sgn", [1, -1])
def test_skipping_either_gate_is_exact(transfer, sgn):
    """The kernel composites a slab only where both gates are on (and k <
    G). With occ_k and occ_rb disagreeing (slabs hot in one gate and cold in
    the other, hot slabs included), the K3 -> K4 pair's plain versions give
    the same bits as compositing only the slabs both gates keep."""
    rng = np.random.default_rng(21)
    g, gp, d, ii, nrb = 13, 16, 16, 32, 4
    packs = torch.from_numpy(rng.random((2, g, d, d)).astype(np.float32)).to(torch.bfloat16)
    pos = rng.uniform(-2.0, d + 1.0, (gp, ii)).astype(np.float32)
    pos[g:] = -1e6
    pos_u = torch.from_numpy(np.sort(pos, axis=1))
    pos_v = torch.from_numpy(np.sort(pos, axis=1)[:, ::-1].copy())
    irho = torch.from_numpy((1.0 + rng.random((ii, ii))).astype(np.float32))
    m = torch.tensor([1], dtype=torch.int32)
    sg = torch.tensor([sgn], dtype=torch.int32)
    occ_k = torch.from_numpy(rng.random(gp) > 0.3)
    occ_rb = torch.from_numpy(rng.random((gp, nrb)) > 0.3)
    assert bool((occ_k[:g, None] & ~occ_rb[:g]).any())
    assert bool((~occ_k[:g, None] & occ_rb[:g]).any())
    fused = sr.resample_composite(packs, m, pos_u, pos_v, sg, irho, occ_k, occ_rb, transfer)
    pair = sr.composite_plain(sr.resample_slabs_plain(packs, m, pos_u, pos_v, occ_k), sg, irho,
                              occ_rb, transfer)
    both = occ_rb & occ_k[:, None] & (torch.arange(gp) < g)[:, None]
    only_live = sr.composite_plain(sr.resample_slabs_plain(packs, m, pos_u, pos_v), sg, irho,
                                   both, transfer)
    assert torch.equal(fused, pair)
    assert torch.equal(only_live, pair)
    assert float(pair[3].max()) > 0.5


# -- the kernel's tile walk, mirrored -----------------------------------------

def _kernel_mirror(packs, m, pos_u, pos_v, sgn, irho, occ_k, occ_rb, transfer):
    """The fused kernel's walk on the CPU: per tile, the slabs both gates
    keep in marching order; each slab's taps read from its window (or from
    the pack when the window is over capacity; a valid tap outside a window
    that fits fails); the sample rounded to bf16; K4's update only for
    samples above 0.1 (a sample <= 0.1 adds an exact zero) at texels below
    alpha 0.95; the tile stops when none is. Returns the
    planes and the (tiles, windows) over capacity."""
    volm = packs[int(m.clamp(0, packs.shape[0] - 1))]
    g, d = volm.shape[0], volm.shape[1]
    gp, iu = pos_u.shape
    iv = pos_v.shape[1]
    rpb = iv // occ_rb.shape[1]
    wins = sr.slab_windows(pos_u, pos_v, d)
    tile_cols = sr.TILE_COLS
    order = range(gp) if int(sgn[0]) > 0 else range(gp - 1, -1, -1)
    out = torch.zeros((4, iv, iu))
    over_tiles = over_windows = 0
    for tr in range(iv // 8):
        rows = slice(tr * 8, tr * 8 + 8)
        for tc, c0 in enumerate(range(0, iu, tile_cols)):
            cols = slice(c0, min(c0 + tile_cols, iu))
            live = [k for k in order
                    if k < g and bool(occ_k[k]) and bool(occ_rb[k, tr * 8 // rpb])]
            n_over = 0
            for k in live:
                v0, v1, u0, u1 = wins[k, tr, tc].tolist()
                n_over += (v1 - v0 + 1) * (u1 - u0 + 1) > sr.WINDOW_CAPACITY
            over_tiles += n_over > 0
            over_windows += n_over
            rho = irho[rows, cols]
            r, gch, b, a = (torch.zeros_like(rho) for _ in range(4))
            for k in live:
                v0, v1, u0, u1 = wins[k, tr, tc].tolist()
                fits = (v1 - v0 + 1) * (u1 - u0 + 1) <= sr.WINDOW_CAPACITY
                src = volm[k, v0:v1 + 1, u0:u1 + 1] if fits else volm[k]
                ov, ou = (v0, u0) if fits else (0, 0)
                tv = sr._taps(pos_v[k, rows], d)
                tu = sr._taps(pos_u[k, cols], d)

                def tap(vi, vok, ui, uok):
                    ok = vok[:, None] & uok[None, :]
                    vv, uu = (tv[0] if vi == 0 else tv[1]), (tu[0] if ui == 0 else tu[1])
                    if fits:
                        inside = ((vv[:, None] - ov >= 0) & (vv[:, None] - ov < src.shape[0])
                                  & (uu[None, :] - ou >= 0) & (uu[None, :] - ou < src.shape[1]))
                        assert bool(inside[ok].all()), "a valid tap outside its window"
                    vals = src[(vv - ov).clamp(0, src.shape[0] - 1)][
                        :, (uu - ou).clamp(0, src.shape[1] - 1)].float()
                    return torch.where(ok, vals, 0.0)

                a00, a01 = tap(0, tv[2], 0, tu[2]), tap(0, tv[2], 1, tu[3])
                a10, a11 = tap(1, tv[3], 0, tu[2]), tap(1, tv[3], 1, tu[3])
                fu, fv = tu[4][None, :], tv[4][:, None]
                top = a00 + (a01 - a00) * fu
                bot = a10 + (a11 - a10) * fu
                s = (top + (bot - top) * fv).to(torch.bfloat16).float()
                if transfer == "exact":
                    tvv, cr, cg, cb = bonsai_transfer_soa(s)
                    alpha = 1.0 - torch.exp(rho * torch.log(1.0 - tvv))
                else:
                    alpha, cr, cg, cb = bonsai_transfer_pow_lowdeg_soa(s, rho)
                # only samples above 0.1 at texels below 0.95 are composited
                upd = (a < 0.95) & ~(s <= 0.1)
                w = (1.0 - a) * alpha
                r, gch = torch.where(upd, r + w * cr, r), torch.where(upd, gch + w * cg, gch)
                b, a = torch.where(upd, b + w * cb, b), torch.where(upd, a + w, a)
                if not bool((a < 0.95).any()):
                    break
            out[:, rows, cols] = torch.stack([r, gch, b, a])
    return out, (over_tiles, over_windows)


MIRROR_CASES = {
    "bench64/I64/lowdeg": (64, 64, "bench", "lowdeg"),
    "bench64/I64/exact": (64, 64, "bench", "exact"),
    "tilt64/I64/exact": (64, 64, "tilt", "exact"),
    "eye_inside64/I64/lowdeg": (64, 64, "eye_inside", "lowdeg"),
    # windows of ~40 rows x 32 columns at D=128: over the shared capacity
    "bench128/I32/lowdeg": (128, 32, "bench", "lowdeg"),
}


@pytest.mark.parametrize("case", sorted(MIRROR_CASES))
def test_kernel_walk_matches_plain(case):
    """The mirror of the kernel's walk is bitwise the plain version, with
    the flipped marching direction too; the D=128 case has tiles over
    capacity."""
    size, ii, pose, transfer = MIRROR_CASES[case]
    pack, geo = _geometry(size, ii, pose)
    for sgn in (geo.sgn, -geo.sgn):
        args = (pack[0], geo.m, geo.pos_u, geo.pos_v, sgn, geo.irho, geo.occ_k, geo.occ_rb,
                transfer)
        want = sr.resample_composite_plain(*args)
        got, (over_tiles, over_windows) = _kernel_mirror(*args)
        assert torch.equal(got, want)
        assert float(want[3].max()) > 0.5
        if case.startswith("bench128"):
            assert over_tiles > 0 and over_windows >= over_tiles


# -- windows ------------------------------------------------------------------

@pytest.mark.parametrize("pose", sorted(POSES))
@pytest.mark.parametrize("ii", [64, 128, 256])
def test_slab_windows_cover_every_tap(pose, ii):
    """Every valid tap of every texel of every tile lies in its slab's
    window, which stays inside [0, D-1] with 8-aligned columns; padding rows
    (-1e6) get a finite one-row window."""
    pack, geo = _geometry(64, ii, pose, width=160, height=120)
    tile_cols = sr.TILE_COLS
    d = pack[0].shape[2]
    gp, ii = geo.pos_u.shape
    g = pack[0].shape[1]
    wins = sr.slab_windows(geo.pos_u, geo.pos_v, d)
    nc = -(-ii // tile_cols)
    assert wins.shape == (gp, ii // 8, nc, 4) and wins.dtype == torch.int64
    assert int(wins.min()) >= 0 and int(wins.max()) <= d - 1
    assert bool((wins[..., 2] % 8 == 0).all()) and bool((wins[..., 3] % 8 == 7).all())
    assert bool((wins[..., 1] >= wins[..., 0]).all()) and bool((wins[..., 3] > wins[..., 2]).all())
    assert torch.equal(wins[g:, ..., :2], torch.zeros_like(wins[g:, ..., :2]))
    size = (wins[..., 1] - wins[..., 0] + 1) * (wins[..., 3] - wins[..., 2] + 1)
    assert bool((size[g:] == 8).all())
    rows = torch.arange(ii) // 8
    cols = torch.arange(ii) // tile_cols
    for k in range(g):
        v0, v1, v0ok, v1ok, _ = sr._taps(geo.pos_v[k], d)
        u0, u1, u0ok, u1ok, _ = sr._taps(geo.pos_u[k], d)
        w = wins[k][rows][:, cols]  # (I, I, 4) per texel
        for vi, vok in ((v0, v0ok), (v1, v1ok)):
            for ui, uok in ((u0, u0ok), (u1, u1ok)):
                ok = vok[:, None] & uok[None, :]
                inside = ((vi[:, None] >= w[..., 0]) & (vi[:, None] <= w[..., 1])
                          & (ui[None, :] >= w[..., 2]) & (ui[None, :] <= w[..., 3]))
                assert bool(inside[ok].all()), (k, pose)


BAD = {
    "irho_shape": (lambda a: a.update(irho=torch.ones((16, 8)))),
    "occ_rb_blocks": (lambda a: a.update(occ_rb=torch.ones((8, 3), dtype=torch.bool))),
    "occ_rb_slabs": (lambda a: a.update(occ_rb=torch.ones((7, 2), dtype=torch.bool))),
    "transfer": (lambda a: a.update(transfer="cubic")),
    "sgn_int64": (lambda a: a.update(sgn=torch.ones(1, dtype=torch.int64))),
    "occ_k_shape": (lambda a: a.update(occ_k=torch.ones(4, dtype=torch.bool))),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_resample_composite_rejects_bad_inputs(case):
    args = dict(packs=torch.zeros((3, 7, 8, 8), dtype=torch.bfloat16),
                m=torch.zeros(1, dtype=torch.int32), pos_u=torch.zeros((8, 16)),
                pos_v=torch.zeros((8, 16)), sgn=torch.ones(1, dtype=torch.int32),
                irho=torch.ones((16, 16)), occ_k=torch.ones(8, dtype=torch.bool),
                occ_rb=torch.ones((8, 2), dtype=torch.bool), transfer="lowdeg")
    sr.resample_composite(**args)
    BAD[case](args)
    with pytest.raises((TypeError, ValueError)):
        sr.resample_composite(**args)


# -- on the card ----------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("ii", [512, 1024])
@pytest.mark.parametrize("pose", ["bench", "eye_inside"])
def test_fused_kernel_matches_pair_on_gpu(cuda_device, ii, pose):
    """The fused kernel on the card, 256^3 bonsai at 1024^2: bitwise the K3
    -> K4 kernel pair and within K4's 1e-4 of the plain version, both
    marching directions and both transfers."""
    pack, geo = _geometry(256, ii, pose, cuda_device, 1024, 1024)
    stack = sr.resample_slabs(pack[0], geo.m, geo.pos_u, geo.pos_v, geo.occ_k)
    before = sr.LAUNCHES_RESAMPLE_COMPOSITE
    for sgn in (geo.sgn, -geo.sgn):
        for transfer in sr.TRANSFERS:
            args = (pack[0], geo.m, geo.pos_u, geo.pos_v, sgn, geo.irho, geo.occ_k,
                    geo.occ_rb, transfer)
            pair = sr.composite(stack, sgn, geo.irho, geo.occ_rb, transfer)
            plain = sr.resample_composite_plain(*args)
            fused = sr.resample_composite(*args)
            torch.cuda.synchronize()
            assert torch.equal(fused, pair), (sgn, transfer)
            assert float((fused - plain).abs().max()) <= 1e-4
    assert sr.LAUNCHES_RESAMPLE_COMPOSITE == before + 4


@pytest.mark.gpu
def test_fused_kernel_over_capacity_on_gpu(cuda_device):
    """Windows over the shared capacity read the pack in device memory:
    bitwise the pair still, and the device counter matches the window
    rule's count."""
    pack, geo = _geometry(128, 32, "bench", cuda_device)
    counter = sr.over_capacity(cuda_device)
    counter.zero_()
    args = _args(pack, geo)
    fused = sr.resample_composite(*args)
    pair = sr.composite(sr.resample_slabs(*args[:4], geo.occ_k), geo.sgn, geo.irho, geo.occ_rb)
    torch.cuda.synchronize()
    assert torch.equal(fused, pair)
    _, want = _kernel_mirror(*(t.cpu() for t in args), "lowdeg")
    assert tuple(counter.tolist()) == want and want[0] > 0
