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

import ctypes

import numpy as np
import pytest
import torch

from vokselis_torch.core import geometry
from vokselis_torch.core.camera import Camera, CameraUniform
from vokselis_torch.core.colors import bonsai_transfer_fast_soa, linear_to_srgb
from vokselis_torch.engine import profiler
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
    render, pack = mb.build_renderer(vol, "cpu")
    assert pack.dtype == torch.uint8 and pack.shape == (32, 32, 32)
    img = render(pack, u, 32, 32)
    r = mb.BonsaiRenderer(vol, "cpu")
    torch.testing.assert_close(img, r(u, 32, 32), rtol=0, atol=0)
    render_again, _ = mb.build_renderer(vol, "cpu")
    torch.testing.assert_close(render_again(pack, u, 32, 32), img, rtol=0, atol=0)


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
    """Each wrapper counts the launches it makes: a renderer's first call
    launches K1 through the frame wrapper (``LAUNCHES_FRAME``) for its
    graph's warm-up and once more into the graph it captures; a replay
    calls no wrapper, and launches the graph's one kernel node, K1 (read
    from the graph: a profiler session can lose its first device records,
    and K1 is a frame's first kernel). A launch over ray planes counts
    in ``LAUNCHES``."""
    r = mb.BonsaiRenderer(get_bonsai(64), cuda_device)
    u = Camera(aspect=1.0, **POSES["bench"]).uniform(cuda_device)
    mb.LAUNCHES = mb.LAUNCHES_FRAME = 0
    for _ in range(3):
        r(u, 40, 24)
    graph = r.compiled.graph(r.compiled.keys()[-1])
    assert (mb.LAUNCHES_FRAME, mb.LAUNCHES) == (2, 0) and r.compiled.captures == 1
    assert profiler.graph_kernels(graph, ["march_bonsai_kernel"]) == {"march_bonsai_kernel": 1}
    render, pack = mb.build_renderer(get_bonsai(64), cuda_device)
    img = render(pack, u, 40, 24)
    torch.cuda.synchronize()
    assert mb.LAUNCHES_FRAME == 4
    # a rejected call launches nothing
    eye, (dx, dy, dz) = _rays(Camera(aspect=1.0, **POSES["bench"]), 8, 8, cuda_device)
    with pytest.raises(TypeError):
        mb.render_bonsai_rays_cuda(pack, eye, (dx.double(), dy, dz))
    with pytest.raises(TypeError):
        mb.render_bonsai_frame_cuda(pack, CameraUniform(u.view_position, u.proj_view,
                                                        u.inv_proj.double()), 8, 8)
    assert (mb.LAUNCHES_FRAME, mb.LAUNCHES) == (4, 0)
    mb.render_bonsai_rays_cuda(pack, eye, (dx, dy, dz))
    mb.render_bonsai_frame_cuda(pack, u, 8, 8)
    assert (mb.LAUNCHES_FRAME, mb.LAUNCHES) == (5, 1)
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


# -- K1 making its own rays: the frame wrapper ------------------------------


def _frame_inputs():
    vol = torch.from_numpy(get_bonsai(32))
    return dict(vol=vol, u=Camera(aspect=1.0, **POSES["bench"]).uniform("cpu"), width=8,
                height=8, max_steps=32)


def _uniform(k, vp=None, inv=None):
    u = k["u"]
    k["u"] = CameraUniform(u.view_position if vp is None else vp, u.proj_view,
                           u.inv_proj if inv is None else inv)


def _batch_of(n):
    return lambda k: k.update(u=CameraUniform(torch.zeros(n, 4), torch.zeros(n, 4, 4),
                                              torch.zeros(n, 4, 4)))


BAD_FRAME_INPUTS = {
    "vol_float32": (lambda k: k.update(vol=k["vol"].float()), TypeError),
    "vol_numpy": (lambda k: k.update(vol=k["vol"].numpy()), TypeError),
    "inv_proj_float64": (lambda k: _uniform(k, inv=k["u"].inv_proj.double()), TypeError),
    "view_position_float64": (lambda k: _uniform(k, vp=k["u"].view_position.double()),
                              TypeError),
    "inv_proj_numpy": (lambda k: _uniform(k, inv=k["u"].inv_proj.numpy()), TypeError),
    "inv_proj_not_contiguous": (lambda k: _uniform(k, inv=k["u"].inv_proj.t()), ValueError),
    "inv_proj_3x4": (lambda k: _uniform(k, inv=k["u"].inv_proj[:3].contiguous()), ValueError),
    "view_position_xyz_only": (lambda k: _uniform(k, vp=k["u"].view_position[:3].contiguous()),
                               ValueError),
    "views_mismatch": (lambda k: _uniform(k, vp=torch.zeros(3, 4), inv=torch.zeros(2, 4, 4)),
                       ValueError),
    "batched_matrix_single_eye": (lambda k: _uniform(k, inv=torch.zeros(2, 4, 4)), ValueError),
    "no_views": (_batch_of(0), ValueError),
    "too_many_views": (_batch_of(mb.MAX_VIEWS + 1), ValueError),
    "uniform_other_device": (lambda k: _uniform(k, inv=k["u"].inv_proj.to("meta")), ValueError),
    "all_on_meta": (lambda k: k.update(vol=k["vol"].to("meta"), u=CameraUniform(
        *(t.to("meta") for t in k["u"].tensors()))), ValueError),
    "width_zero": (lambda k: k.update(width=0), ValueError),
    "height_float": (lambda k: k.update(height=8.0), ValueError),
    "max_steps_negative": (lambda k: k.update(max_steps=-1), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD_FRAME_INPUTS))
def test_frame_wrapper_rejects_bad_inputs(case, monkeypatch):
    """The frame wrapper refuses what K1 could not read as a uniform (dtype,
    shape, contiguity, device, the batch's 1 to MAX_VIEWS views, the frame's
    size, the step count) before it builds or launches anything."""
    def no_build():
        raise AssertionError("built before the inputs were checked")

    monkeypatch.setattr(mb, "build", no_build)
    kw = _frame_inputs()
    mutate, exc = BAD_FRAME_INPUTS[case]
    mutate(kw)
    before = mb.LAUNCHES_FRAME
    with pytest.raises(exc):
        mb.render_bonsai_frame_cuda(kw["vol"], kw["u"], kw["width"], kw["height"],
                                    max_steps=kw["max_steps"])
    assert mb.LAUNCHES_FRAME == before


def _frame_uniform(kind, aspect, device):
    if kind == "single":
        return Camera(aspect=aspect, **POSES["diagonal"]).uniform(device)
    return CameraUniform.stack(Camera(aspect=aspect, **POSES[p]).uniform(device)
                               for p in sorted(POSES))


@pytest.mark.parametrize("srgb", [True, False], ids=["srgb", "linear"])
@pytest.mark.parametrize("kind", ["single", "batch"])
def test_render_frame_on_the_cpu_is_the_plain_path(kind, srgb, monkeypatch):
    """On the CPU render_frame, the frame wrapper, is the plain frame,
    bitwise: geometry.rays_fragment_soa, then the plain march of each
    view; nothing is built or launched."""
    def no_build():
        raise AssertionError("the CPU path built a kernel")

    monkeypatch.setattr(mb, "build", no_build)
    vol = mb.volume_tensor(get_bonsai(32), "cpu")
    u = _frame_uniform(kind, 24 / 16, "cpu")
    eye, dxyz = geometry.rays_fragment_soa(u, 24, 16)
    want = mb.render_bonsai_rays_plain(vol, eye, dxyz, max_steps=64, srgb=srgb)
    before = (mb.LAUNCHES_FRAME, mb.LAUNCHES)
    got = mb.render_frame(vol, u, 24, 16, 64, srgb)
    assert torch.equal(got, want)
    assert torch.equal(mb.render_bonsai_frame_cuda(vol, u, 24, 16, 64, srgb), want)
    assert (mb.LAUNCHES_FRAME, mb.LAUNCHES) == before
    assert tuple(got.shape) == ((3,) if kind == "batch" else ()) + (16, 24, 4)
    assert float(got[..., :3].max()) > 0.1


def test_inline_rays_counter_absent_on_the_cpu():
    """``k1.inline_rays`` counts rays that K1 makes on a card: a CPU frame,
    through the renderer or the functional API, adds none."""
    u = Camera(aspect=1.0, **POSES["bench"]).uniform("cpu")
    r = mb.BonsaiRenderer(get_bonsai(32), "cpu")
    render, pack = mb.build_renderer(get_bonsai(32), "cpu")
    with profiler.recording() as rec:
        r(u, 16, 12, 32)
        render(pack, u, 16, 12, 32)
    assert "k1.inline_rays" not in rec.counters


@pytest.mark.gpu
def test_inline_rays_counter_on_gpu(cuda_device):
    """On a card every exact frame call, captured or replayed, adds views x
    width x height to ``k1.inline_rays``."""
    r = mb.BonsaiRenderer(get_bonsai(64), cuda_device)
    u = Camera(aspect=1.0, **POSES["bench"]).uniform(cuda_device)
    batch = _frame_uniform("batch", 1.0, cuda_device)
    with profiler.recording() as rec:
        r(u, 40, 24)
        r(u, 40, 24)
        r(batch, 40, 24)
    assert rec.counters["k1.inline_rays"] == (2 + len(batch)) * 40 * 24


def _plane_frame(vol, u, w, h, max_steps, srgb):
    """The eager frame of the ray planes: rays_fragment_soa's torch ops, then
    K1 over the planes."""
    eye, dxyz = geometry.rays_fragment_soa(u, w, h)
    return mb.render_bonsai_rays_cuda(vol, eye, dxyz, max_steps=max_steps, srgb=srgb)


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(1024, 1024), (1280, 720), (97, 61)],
                         ids=["1024x1024", "1280x720", "97x61"])
def test_inline_frame_is_bitwise_the_plane_frame_on_gpu(cuda_device, size):
    """K1 making its own rays gives the eager plane path's frame bit for bit,
    at every pose, in sRGB and linear, at two step counts (partial 16x8
    blocks on both axes at 97x61)."""
    w, h = size
    vol = mb.volume_tensor(get_bonsai(), cuda_device)
    for pose in sorted(POSES):
        u = Camera(aspect=w / h, **POSES[pose]).uniform(cuda_device)
        for srgb in (True, False):
            for steps in (reference.MAX_STEPS_BONSAI, 100):
                want = _plane_frame(vol, u, w, h, steps, srgb)
                got = mb.render_bonsai_frame_cuda(vol, u, w, h, steps, srgb)
                assert tuple(got.shape) == (h, w, 4)
                assert torch.equal(got, want), (pose, srgb, steps,
                                                float((got - want).abs().max()))
                assert torch.equal(mb.render_frame(vol, u, w, h, steps, srgb), got)
        assert float(got[..., :3].max()) > 0.1


@pytest.mark.gpu
def test_inline_frame_batch_is_bitwise_on_gpu(cuda_device):
    """A batch of 8 orbit views at 512^2 in one launch of the frame wrapper
    is the eager plane path's batch bit for bit, and each view its own
    single-view frame."""
    from vokselis_torch.parallel import orbit_camera_batch

    vol = mb.volume_tensor(get_bonsai(), cuda_device)
    u = orbit_camera_batch(8, device=cuda_device)
    before = mb.LAUNCHES_FRAME
    got = mb.render_bonsai_frame_cuda(vol, u, 512, 512)
    assert mb.LAUNCHES_FRAME == before + 1 and tuple(got.shape) == (8, 512, 512, 4)
    assert torch.equal(got, _plane_frame(vol, u, 512, 512, reference.MAX_STEPS_BONSAI, True))
    for v in range(8):
        assert torch.equal(got[v], mb.render_bonsai_frame_cuda(vol, u[v], 512, 512)), v


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["single", "batch"])
def test_renderer_graph_holds_k1_alone_on_gpu(cuda_device, kind):
    """The renderer's captured frame is one kernel node, K1: no elementwise
    ray kernel is left in front of it."""
    r = mb.BonsaiRenderer(get_bonsai(64), cuda_device)
    u = _frame_uniform(kind, 64 / 48, cuda_device)
    first = r(u, 64, 48)
    graph = r.compiled.graph(r.compiled.keys()[-1])
    names = profiler._node_names(profiler._driver(), ctypes.c_void_p(graph.raw_cuda_graph()))
    assert len(names) == 1 and profiler.kernel_name_matches(names[0], "march_bonsai_kernel"), \
        names
    assert torch.equal(r(u, 64, 48), first)
