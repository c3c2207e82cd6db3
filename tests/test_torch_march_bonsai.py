"""K1, the march kernel module (vokselis_torch.ops.cuda.march_bonsai).

On the CPU the wrapper takes the kernel's plain version; these tests hold
that path against the JAX package's Pallas kernel run in interpret mode
(as tests/test_pallas.py runs it), at the exact kernel's contract: max
< 1e-3, mean < 1e-5 (direct-form vs accumulated positions and ceil-derived
step counts move the alpha >= 0.95 exit by one step on rare pixels).

Tests marked ``gpu`` need a CUDA card and skip without one. They build and
launch the CUDA kernel and hold it against its plain version on the same
tensors, at the same contract. On the card, run them with
``python -m pytest tests/test_torch_*.py --noconftest -m gpu`` (the repo's
conftest imports JAX, which that machine lacks).
"""

import numpy as np
import pytest
import torch

from vokselis_torch.core import geometry
from vokselis_torch.core.camera import Camera, CameraUniform
from vokselis_torch.core.colors import bonsai_transfer_fast_soa, linear_to_srgb
from vokselis_torch.engine.profiler import kernel_launches
from vokselis_torch.ops import reference
from vokselis_torch.ops.cuda import march_bonsai as mb
from vokselis_torch.volume.io import get_bonsai
from vokselis_torch.volume.sample import sample_trilinear_r8, trilinear_weights

POSES = {
    "bench": dict(zoom=1.0, pitch=0.5, yaw=1.0, target=(0.5, 0.5, 0.5)),
    "eye_inside": dict(zoom=0.3, pitch=0.1, yaw=0.7, target=(0.5, 0.5, 0.5)),
    "diagonal": dict(zoom=1.3, pitch=0.2, yaw=2.2, target=(0.5, 0.5, 0.5)),
}


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX package's march_bonsai module with every pallas_call run in
    interpret mode (tests/test_pallas.py:16-38)."""
    pytest.importorskip("jax")
    import importlib

    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", patched)
    import vokselis_tpu.ops.pallas.march_bonsai as jmb

    importlib.reload(jmb)
    yield jmb
    importlib.reload(jmb)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rays(cam, w, h, device):
    return geometry.rays_fragment_soa(cam.uniform(device), w, h)


def _assert_parity(img, ref):
    img, ref = img.cpu().numpy(), np.asarray(ref)
    assert np.isfinite(img).all()
    err = np.abs(img - ref)
    assert err.max() < 1e-3, err.max()
    assert err.mean() < 1e-5, err.mean()


@pytest.mark.parametrize("volume", ["bonsai32", "border32"])
def test_cpu_renderer_matches_jax_pallas_interpret(pallas_interpret, volume):
    jmb = pallas_interpret
    vol = (get_bonsai(32) if volume == "bonsai32" else
           np.random.default_rng(5).integers(30, 220, (32, 32, 32), dtype=np.uint8))
    from vokselis_tpu.core.camera import Camera as JaxCamera

    ju = JaxCamera(aspect=1.0, **POSES["bench"]).uniform()
    u = CameraUniform.from_numpy(np.asarray(ju.view_position), np.asarray(ju.proj_view),
                                 np.asarray(ju.inv_proj), "cpu")
    before = mb.LAUNCHES
    img = mb.BonsaiRenderer(vol, "cpu")(u, 32, 32)
    ref = jmb.BonsaiRenderer(vol)(ju, width=32, height=32)
    assert img.shape == (32, 32, 4) and img.dtype == torch.float32
    _assert_parity(img, ref)
    # the CPU path is the plain version: no build, no launch
    assert mb.LAUNCHES == before
    assert mb._lib is None


def test_cpu_path_is_the_plain_version():
    vol = torch.from_numpy(get_bonsai(32))
    cam = Camera(aspect=1.0, **POSES["diagonal"])
    eye, dxyz = _rays(cam, 24, 16, "cpu")
    img = mb.render_bonsai_rays_cuda(vol, eye, dxyz, max_steps=64, srgb=False)
    ref = reference.render_bonsai_rays(vol, eye, torch.stack(dxyz, dim=-1),
                                       max_steps=64, srgb=False)
    torch.testing.assert_close(img, ref, rtol=0, atol=0)


def test_plain_march_counts_steps():
    """return_steps counts the samples each ray takes (the march kernel's
    work) without changing the image: 0 for misses, at most max_steps."""
    vol = torch.from_numpy(get_bonsai(32))
    eye, dxyz = _rays(Camera(aspect=1.0, **POSES["diagonal"]), 24, 16, "cpu")
    dirs = torch.stack(dxyz, dim=-1)
    img = reference.render_bonsai_rays(vol, eye, dirs, max_steps=64)
    img2, steps = reference.render_bonsai_rays(vol, eye, dirs, max_steps=64,
                                               return_steps=True)
    torch.testing.assert_close(img2, img, rtol=0, atol=0)
    t0, t1 = geometry.intersect_box_unit(eye.expand(16, 24, 3), dirs)
    hit = t0 <= t1
    assert steps.shape == (16, 24) and steps.dtype == torch.int32
    assert int(steps[~hit].abs().sum()) == 0
    assert int(steps[hit].min()) > 0 and int(steps.max()) <= 64


def test_build_renderer_api():
    vol = get_bonsai(32)
    u = Camera(aspect=1.0, **POSES["bench"]).uniform("cpu")
    render, pack = mb.build_renderer(vol, "cpu", with_overflow=True)
    assert pack.dtype == torch.uint8 and pack.shape == (32, 32, 32)
    img, ovf = render(pack, u, 32, 32)
    assert ovf == 0
    r = mb.BonsaiRenderer(vol, "cpu")
    torch.testing.assert_close(img, r(u, 32, 32, strict=True), rtol=0, atol=0)
    assert r.last_overflow == 0
    render_plain, _ = mb.build_renderer(vol, "cpu")
    torch.testing.assert_close(render_plain(pack, u, 32, 32), img, rtol=0, atol=0)


def _good_inputs():
    vol = torch.from_numpy(get_bonsai(32))
    eye, (dx, dy, dz) = _rays(Camera(aspect=1.0, **POSES["bench"]), 8, 8, "cpu")
    return dict(vol=vol, eye=eye, dx=dx, dy=dy, dz=dz)


BAD_INPUTS = {
    "vol_float32": (lambda k: k.update(vol=k["vol"].float()), TypeError),
    "vol_not_cubic": (lambda k: k.update(vol=k["vol"][:, :, :16].contiguous()), ValueError),
    "vol_not_contiguous": (lambda k: k.update(vol=k["vol"].transpose(0, 2)), ValueError),
    "rays_float64": (lambda k: k.update(dx=k["dx"].double()), TypeError),
    "rays_not_contiguous": (lambda k: k.update(dy=k["dy"].t()), ValueError),
    "rays_shape_mismatch": (lambda k: k.update(dz=k["dz"][:4].contiguous()), ValueError),
    "eye_wrong_shape": (lambda k: k.update(eye=torch.zeros(4)), TypeError),
    "eye_other_device": (lambda k: k.update(eye=k["eye"].to("meta")), ValueError),
    "all_on_meta": (lambda k: k.update({n: t.to("meta") for n, t in k.items()}), ValueError),
    "vol_numpy": (lambda k: k.update(vol=k["vol"].numpy()), TypeError),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_wrapper_rejects_bad_inputs(case):
    kw = _good_inputs()
    mutate, exc = BAD_INPUTS[case]
    mutate(kw)
    with pytest.raises(exc):
        mb.render_bonsai_rays_cuda(kw["vol"], kw["eye"], (kw["dx"], kw["dy"], kw["dz"]))


def test_wrapper_rejects_negative_max_steps():
    kw = _good_inputs()
    with pytest.raises(ValueError):
        mb.render_bonsai_rays_cuda(kw["vol"], kw["eye"], (kw["dx"], kw["dy"], kw["dz"]),
                                   max_steps=-1)


def test_renderer_rejects_bad_volume():
    with pytest.raises(ValueError):
        mb.BonsaiRenderer(np.zeros((8, 8, 4), np.uint8), "cpu")
    with pytest.raises(ValueError):
        mb.BonsaiRenderer(np.zeros((8, 8, 8), np.float32), "cpu")


def test_cuda_device_without_cuda_raises():
    """No silent move to the CPU: asking for the card where there is none is
    an error."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        mb.BonsaiRenderer(get_bonsai(32), "cuda")


def _border_volume(d=60, seed=7):
    """A random-border volume: every interior voxel random in [0, 25] (empty
    for the skip, yet not zero), a one-voxel shell random in [0, 160) on
    every face; d = 60 leaves the last occupancy cell partial."""
    rng = np.random.default_rng(seed)
    vol = rng.integers(0, 26, (d, d, d), dtype=np.uint8)
    shell = np.zeros((d, d, d), bool)
    shell[[0, -1]] = shell[:, [0, -1]] = shell[:, :, [0, -1]] = True
    vol[shell] = rng.integers(0, 160, int(shell.sum()), dtype=np.uint8)
    return vol


SKIP_VOLUMES = {"bonsai64": lambda: get_bonsai(64), "border60": _border_volume}


@torch.no_grad()
def _skip_march_plain(vol, occ, eye, dirs, fast_transfer=False):
    """The kernels' march with their empty-space skip, in plain torch:
    reference.render_bonsai_rays, except that a step whose lower taps lie in
    a cell of ``occ`` with no voxel above OCC_CUT takes no sample and
    composites nothing; it still advances its position and t. Returns
    ``(image, marched, skipped)``, the last two (H, W) int32 step counts."""
    height, width = dirs.shape[:2]
    npix = width * height
    d = dirs.reshape(npix, 3)
    eye_b = eye.expand(npix, 3)
    t0, t1 = geometry.intersect_box_unit(eye_b, d)
    hit = t0 <= t1
    t = torch.clamp(t0, min=0.0)
    dims = vol.shape[0]
    dt = torch.amin(1.0 / (float(dims) * torch.abs(d)), dim=-1)
    p = eye_b + t[:, None] * d
    rgb = torch.zeros((npix, 3), dtype=torch.float32)
    a = torch.zeros((npix,), dtype=torch.float32)
    marched = torch.zeros((npix,), dtype=torch.int32)
    skipped = torch.zeros_like(marched)
    occ_flat, cells = occ.reshape(-1).long(), occ.shape[0]
    sizes = torch.full((3,), float(dims), dtype=torch.float32)
    for _ in range(reference.MAX_STEPS_BONSAI):
        active = hit & (t < t1) & (a < 0.95)
        if not bool(active.any()):
            break
        lower = torch.clamp(trilinear_weights(p, sizes)[0], 0, dims - 1) // mb.OCC_CELL
        empty = occ_flat[(lower[:, 2] * cells + lower[:, 1]) * cells + lower[:, 0]] <= mb.OCC_CUT
        marched += active
        skipped += active & empty
        idx = torch.nonzero(active & ~empty).squeeze(1)
        r = sample_trilinear_r8(vol, p[idx])
        if fast_transfer:
            c_a, cr, cg, cb = bonsai_transfer_fast_soa(r)
            c_rgb = torch.stack([cr, cg, cb], dim=-1)
        else:
            c_rgb, c_a = reference._bonsai_transfer(r)
        a_i = a[idx]
        rgb[idx] = rgb[idx] + (1.0 - a_i)[:, None] * c_a[:, None] * c_rgb
        a[idx] = a_i + (1.0 - a_i) * c_a
        p = torch.where(active[:, None], p + d * dt[:, None], p)
        t = torch.where(active, t + dt, t)
    rgb = linear_to_srgb(torch.where(hit[:, None], rgb, 0.0))
    img = torch.cat([rgb, torch.ones((npix, 1), dtype=torch.float32)], dim=-1)
    return (img.reshape(height, width, 4), marched.reshape(height, width),
            skipped.reshape(height, width))


@pytest.mark.parametrize("volume", sorted(SKIP_VOLUMES))
def test_occupancy_table_matches_brute_force(volume):
    """Each cell's entry is the numpy max over voxels 8c .. min(8c + 8, D - 1)
    on every axis (one voxel of overlap toward +)."""
    vol = SKIP_VOLUMES[volume]()
    d = vol.shape[0]
    occ = mb.occupancy_table(torch.from_numpy(vol))
    cells = -(-d // 8)
    assert occ.dtype == torch.uint8 and occ.shape == (cells,) * 3 and occ.is_contiguous()
    want = np.empty((cells,) * 3, np.uint8)
    for z in range(cells):
        for y in range(cells):
            for x in range(cells):
                want[z, y, x] = vol[8 * z:min(8 * z + 9, d), 8 * y:min(8 * y + 9, d),
                                    8 * x:min(8 * x + 9, d)].max()
    np.testing.assert_array_equal(occ.numpy(), want)


@pytest.mark.parametrize("pose", sorted(POSES))
@pytest.mark.parametrize("volume", sorted(SKIP_VOLUMES))
def test_skip_march_is_bitwise_the_plain_march(volume, pose):
    """The kernels' empty-space skip is exact: the plain skip-aware march
    equals the unskipped plain march bit for bit at 64x36, in both palette
    modes, with the same step counts, and skips real work: every hit ray of
    the bonsai skips a step, and the random-border volume skips more than
    one step per hit ray on average (rays that cross only the shell's cells
    skip none)."""
    vol = torch.from_numpy(SKIP_VOLUMES[volume]())
    occ = mb.occupancy_table(vol)
    eye, dxyz = _rays(Camera(aspect=64 / 36, **POSES[pose]), 64, 36, "cpu")
    dirs = torch.stack(dxyz, dim=-1)
    t0, t1 = geometry.intersect_box_unit(eye.expand(36, 64, 3), dirs)
    hit = t0 <= t1
    for fast in (False, True):
        ref, steps = reference.render_bonsai_rays(vol, eye, dirs, return_steps=True,
                                                  fast_transfer=fast)
        img, marched, skipped = _skip_march_plain(vol, occ, eye, dirs, fast_transfer=fast)
        torch.testing.assert_close(img, ref, rtol=0, atol=0)
        assert torch.equal(marched, steps)
        assert float(img[..., :3].max()) > 0.1
    if volume == "bonsai64":
        assert int(skipped[hit].min()) >= 1
    assert int(skipped.sum()) >= int(hit.sum())
    assert int(skipped.sum()) < int(marched.sum())


def _edit_in_place(vol):
    vol[1, 2, 3] = 200


def _edit_through_a_view(vol):
    vol.view(-1)[5] = 200


CACHE_EDITS = {"in_place": _edit_in_place, "through_a_view": _edit_through_a_view,
               "new_tensor_same_size": None}


@pytest.mark.parametrize("case", sorted(CACHE_EDITS))
def test_volume_occupancy_follows_the_volume(case):
    """The wrappers' table cache: the same table while the volume is
    unchanged, a new and right one after an in-place write (directly or
    through a view) and for another volume of the same size, and no entry
    left once the volume is gone."""
    vol = torch.zeros((24, 24, 24), dtype=torch.uint8)
    occ = mb.volume_occupancy(vol)
    assert mb.volume_occupancy(vol) is occ and int(occ.max()) == 0
    edit = CACHE_EDITS[case]
    if edit is None:
        other = vol.clone()
        other[1, 2, 3] = 200
        assert mb.volume_occupancy(vol) is occ
        vol, other = other, None
    else:
        edit(vol)
    occ2 = mb.volume_occupancy(vol)
    assert occ2 is not occ and torch.equal(occ2, mb.occupancy_table(vol))
    assert int(occ2.max()) == 200
    key = id(vol)
    del vol, occ2
    assert key not in mb._occ_cache


@pytest.mark.gpu
@pytest.mark.parametrize("volume,pose", [
    ("bonsai256", "bench"), ("bonsai256", "eye_inside"), ("bonsai256", "diagonal"),
    ("border256", "bench"), ("border256", "diagonal"),
])
def test_kernel_matches_plain_on_gpu(cuda_device, volume, pose):
    vol_np = (get_bonsai() if volume == "bonsai256" else
              np.random.default_rng(5).integers(30, 220, (256,) * 3, dtype=np.uint8))
    vol = mb.volume_tensor(vol_np, cuda_device)
    eye, dxyz = _rays(Camera(aspect=4 / 3, **POSES[pose]), 256, 192, cuda_device)
    before = mb.LAUNCHES
    img = mb.render_bonsai_rays_cuda(vol, eye, dxyz)
    torch.cuda.synchronize()
    assert mb.LAUNCHES == before + 1
    ref = reference.render_bonsai_rays(vol, eye, torch.stack(dxyz, dim=-1))
    assert img.shape == (192, 256, 4) and img.device == vol.device
    _assert_parity(img, ref.cpu().numpy())
    assert float(img[..., 3].min()) == float(img[..., 3].max()) == 1.0
    lin = mb.render_bonsai_rays_cuda(vol, eye, dxyz, max_steps=100, srgb=False)
    lin_ref = reference.render_bonsai_rays(vol, eye, torch.stack(dxyz, dim=-1),
                                           max_steps=100, srgb=False)
    _assert_parity(lin, lin_ref.cpu().numpy())


@pytest.mark.gpu
def test_launch_counting_on_gpu(cuda_device):
    """The wrapper counts each launch it makes: a renderer's first call
    launches K1 for its graph's warm-up and once more into the graph it
    captures; a replay calls no wrapper, and its launch shows on the
    device."""
    r = mb.BonsaiRenderer(get_bonsai(64), cuda_device)
    u = Camera(aspect=1.0, **POSES["bench"]).uniform(cuda_device)
    mb.LAUNCHES = 0
    _, counts = kernel_launches(lambda: [r(u, 40, 24) for _ in range(3)],
                                ["march_bonsai_kernel"])
    assert mb.LAUNCHES == 2 and counts == {"march_bonsai_kernel": 3}
    render, pack = mb.build_renderer(get_bonsai(64), cuda_device, with_overflow=True)
    img, ovf = render(pack, u, 40, 24)
    torch.cuda.synchronize()
    assert mb.LAUNCHES == 4 and ovf == 0
    # a rejected call launches nothing
    eye, (dx, dy, dz) = _rays(Camera(aspect=1.0, **POSES["bench"]), 8, 8, cuda_device)
    with pytest.raises(TypeError):
        mb.render_bonsai_rays_cuda(pack, eye, (dx.double(), dy, dz))
    assert mb.LAUNCHES == 4
    torch.testing.assert_close(img, r(u, 40, 24), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("volume", sorted(SKIP_VOLUMES))
def test_skip_kernels_match_plain_on_gpu(cuda_device, volume):
    """K1, K2 and K1b with the skip against their plain versions, bit for
    bit, on the card; the table built there equals the CPU's."""
    vol_np = SKIP_VOLUMES[volume]()
    vol = mb.volume_tensor(vol_np, cuda_device)
    occ = mb.volume_occupancy(vol)
    assert torch.equal(occ.cpu(), mb.occupancy_table(torch.from_numpy(vol_np)))
    for pose in sorted(POSES):
        u = Camera(aspect=96 / 64, **POSES[pose]).uniform(cuda_device)
        eye, dxyz = geometry.rays_fragment_soa(u, 96, 64)
        img = mb.render_bonsai_rays_cuda(vol, eye, dxyz)
        ref = reference.render_bonsai_rays(vol, eye, torch.stack(dxyz, dim=-1))
        assert torch.equal(img, ref), float((img - ref).abs().max())
        ids = torch.tensor([0, 3, 5, 6], dtype=torch.int32, device=cuda_device)
        for fast in (False, True):
            base = torch.rand((3, 64, 96), generator=torch.Generator().manual_seed(1)).to(
                cuda_device)
            k2 = mb.render_bonsai_tiles_into(vol, base.clone(), u, ids, 96, 64,
                                             fast_transfer=fast)
            p2 = mb.render_bonsai_tiles_into_plain(vol, base.clone(), u, ids, 96, 64,
                                                   fast_transfer=fast)
            assert torch.equal(k2, p2)
            k1b = mb.render_bonsai_tiles(vol, u, ids, 96, 64, fast_transfer=fast)
            p1b = mb.render_bonsai_tiles_plain(vol, u, ids, 96, 64, fast_transfer=fast)
            assert torch.equal(k1b, p1b)
