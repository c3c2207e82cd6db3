"""The exact bonsai path over a volume of any (D, H, W) shape
(vokselis_torch.ops.cuda.march_bonsai, models.bonsai, volume.io): K1's
plain twin against the benchmark's plain reference of the same march
(benchmark/reference/volume_march.py), the occupancy table per axis, the
renderers' steps from the shape, the Open SciVis loader, the demo's volume
argument, the set-up's span and counter, and fast, hybrid and the hybrid's
tile march (K2, K1b) refusing another shape than a cube.

Tests marked ``gpu`` need a CUDA card and skip without one: K1 at
non-cubic shapes against its plain version on the card, bit for bit, and
the cubic path's 256^3 frame and 512^3 view batch against theirs. On the
card, run them with ``python -m pytest tests/test_torch_scan.py --noconftest
-m gpu``.
"""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import volume_march
from vokselis_torch.core import geometry
from vokselis_torch.core.camera import Camera
from vokselis_torch.engine import profiler
from vokselis_torch.engine.context import Context
from vokselis_torch.models.bonsai import BonsaiDemo
from vokselis_torch.ops import hybrid, reference, shear_warp
from vokselis_torch.ops.cuda import march_bonsai as mb
from vokselis_torch.volume import io

# (D, H, W): no dim a multiple of 8; a flat slab; a tall column
SHAPES = [(12, 31, 21), (24, 16, 40), (40, 24, 9)]
POSES = {
    "close": dict(zoom=0.9, pitch=0.4, yaw=0.8, target=(0.5, 0.5, 0.5)),
    "eye_inside": dict(zoom=0.3, pitch=0.1, yaw=0.7, target=(0.5, 0.5, 0.5)),
    "diagonal": dict(zoom=1.3, pitch=-0.6, yaw=2.2, target=(0.5, 0.5, 0.5)),
}


def _volume(shape, seed):
    """Seeded random voxels in [30, 220), about half of them zeroed, so that
    the march both skips and samples."""
    rng = np.random.default_rng(seed)
    vol = rng.integers(30, 220, shape, dtype=np.uint8)
    vol[rng.random(shape) < 0.5] = 0
    return vol


def _rays(pose, width, height, device="cpu"):
    u = Camera(aspect=width / height, **POSES[pose]).uniform(device)
    return u, geometry.rays_fragment_soa(u, width, height)


@pytest.mark.parametrize("pose", sorted(POSES))
@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_the_twin_is_the_benchmarks_plain_march(shape, pose):
    """K1's plain twin, through the rays and the frame wrappers, is the
    benchmark's plain reference of the (D, H, W) march bit for bit, at the
    whole diagonal's steps and at a cut, in sRGB and linear."""
    vol = torch.from_numpy(_volume(shape, sum(shape)))
    u, (eye, dxyz) = _rays(pose, 40, 28)
    dirs = torch.stack(dxyz, dim=-1).reshape(-1, 3)
    for steps in (None, 9):
        n = volume_march.max_steps(shape) if steps is None else steps
        for srgb in (True, False):
            twin = mb.render_bonsai_rays_plain(vol, eye, dxyz, max_steps=steps, srgb=srgb)
            want = volume_march.march(vol, eye, dirs, n, srgb=srgb).reshape(28, 40, 4)
            assert torch.equal(twin, want), (steps, srgb, float((twin - want).abs().max()))
            assert torch.equal(mb.render_frame(vol, u, 40, 28, steps, srgb), twin)
    assert float(twin[..., :3].max()) > 0.1


def test_a_cut_or_a_cube_read_as_other_frames():
    """The twin's steps and sizes are the volume's own: the frame differs from
    one marched with the cube's dt of the first axis, from the volume with x
    and z swapped, and from a march cut short."""
    shape = (12, 31, 21)
    vol = torch.from_numpy(_volume(shape, 3))
    u, (eye, dxyz) = _rays("close", 40, 28)
    dirs = torch.stack(dxyz, dim=-1).reshape(-1, 3)
    twin = mb.render_bonsai_rays_plain(vol, eye, dxyz).reshape(-1, 4)
    from benchmark.reference import march

    cubic = march.march(vol, eye, dirs, volume_march.max_steps(shape))
    swapped = volume_march.march(vol.transpose(0, 2).contiguous(), eye, dirs,
                                 volume_march.max_steps(shape))
    cut = volume_march.march(vol, eye, dirs, 8)
    for other in (cubic, swapped, cut):
        assert float((other - twin).abs().max()) > 0.05


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_occupancy_table_per_axis_matches_brute_force(shape):
    """(ceil(D / 8), ceil(H / 8), ceil(W / 8)) cells, each the numpy max over
    voxels 8c .. min(8c + 8, N - 1) of each axis of N voxels."""
    vol = _volume(shape, 11)
    occ = mb.occupancy_table(torch.from_numpy(vol))
    cells = tuple(-(-n // 8) for n in shape)
    assert occ.dtype == torch.uint8 and tuple(occ.shape) == cells and occ.is_contiguous()
    want = np.empty(cells, np.uint8)
    for z in range(cells[0]):
        for y in range(cells[1]):
            for x in range(cells[2]):
                want[z, y, x] = vol[8 * z:min(8 * z + 9, shape[0]), 8 * y:min(8 * y + 9, shape[1]),
                                    8 * x:min(8 * x + 9, shape[2])].max()
    np.testing.assert_array_equal(occ.numpy(), want)


def test_default_steps_are_the_volumes_diagonal():
    """445 at 256^3 (the bonsai's graphs keep their keys), 1,775 for the
    kingsnake's 795 x 1024 x 1024; the renderers and the wrappers take the
    volume's own when given none, which a march longer than 445 steps
    shows."""
    assert reference.bonsai_max_steps((256, 256, 256)) == reference.MAX_STEPS_BONSAI == 445
    assert reference.bonsai_max_steps((795, 1024, 1024)) == 1775
    assert volume_march.max_steps((795, 1024, 1024)) == 1775
    small = np.zeros((5, 9, 7), np.uint8)
    assert mb.BonsaiRenderer(small, "cpu").max_steps == math.ceil(math.sqrt(3.0) * 9) + 1
    # a faint rod 600 voxels along x, seen end on: 445 steps end short of it
    vol = torch.full((2, 2, 600), 30, dtype=torch.uint8)
    eye = torch.tensor([-0.5, 0.5, 0.5])
    d = torch.nn.functional.normalize(torch.tensor([[1.0, 0.01, -0.02], [1.0, -0.03, 0.01]]),
                                      dim=-1)
    dxyz = tuple(d[:, i].reshape(1, 2).contiguous() for i in range(3))
    full = mb.render_bonsai_rays_plain(vol, eye, dxyz)
    assert torch.equal(full, mb.render_bonsai_rays_plain(vol, eye, dxyz, max_steps=1041))
    assert not torch.equal(full, mb.render_bonsai_rays_plain(vol, eye, dxyz, max_steps=445))
    r = mb.BonsaiRenderer(vol, "cpu")
    u = Camera(aspect=1.0, zoom=1.2, pitch=0.0, yaw=math.pi / 2, target=(0.5, 0.5, 0.5)
               ).uniform("cpu")
    assert r.max_steps == 1041
    img = r(u, 8, 8)
    assert torch.equal(img, r(u, 8, 8, 1041))
    render, pack = mb.build_renderer(vol, "cpu")
    assert torch.equal(render(pack, u, 8, 8), img)


def _write_raw(path, data):
    path.write_bytes(np.ascontiguousarray(data).tobytes())
    return path


def test_open_scivis_loader_reads_dims_from_the_name(tmp_path):
    data = np.arange(3 * 4 * 5, dtype=np.uint8).reshape(3, 4, 5)  # z 3, y 4, x 5
    path = _write_raw(tmp_path / "tiny_5x4x3_uint8.raw", data)
    got = io.load_open_scivis(str(path))
    assert got.dtype == np.uint8 and got.shape == (3, 4, 5)
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(io.load_open_scivis(path), data)


@pytest.mark.parametrize("name,size", [
    ("tiny_5x4x3_uint8.raw", 59),  # a byte short
    ("tiny_5x4x3_float32.raw", 239),  # a byte short of its float32 voxels
    ("tiny_5x4x3_float64.raw", 480),  # the right size for its type, but neither taken type
    ("tiny_5x4x3_uint16.raw", 120),
    ("tiny_uint8.raw", 60),  # no dims
    ("tiny_5x4x0_uint8.raw", 0),  # an empty axis
])
def test_open_scivis_loader_rejects(tmp_path, name, size):
    path = _write_raw(tmp_path / name, np.zeros(size, np.uint8))
    with pytest.raises(ValueError):
        io.load_open_scivis(str(path))


def test_the_demo_takes_a_scan(tmp_path):
    """``BonsaiDemo.init``'s volume: a path of an Open SciVis file or an
    array, marched by the exact renderer over its own shape."""
    data = _volume((12, 31, 21), 5)
    path = _write_raw(tmp_path / "scan_21x31x12_uint8.raw", data)
    ctx = Context(width=32, height=24, device="cpu")
    for volume in (str(path), data):
        demo = BonsaiDemo.init(ctx, volume=volume)
        assert tuple(demo.renderer.vol.shape) == (12, 31, 21)
        img = demo.renderer(ctx.camera_uniform, 32, 24)
        assert torch.equal(img, mb.render_frame(torch.from_numpy(data), ctx.camera_uniform,
                                                32, 24))
    with pytest.raises(ValueError, match="cubic"):
        BonsaiDemo.init(ctx, renderer="fast", volume=data)


def test_volume_setup_span_and_bytes_counter():
    vol = _volume((12, 31, 21), 1)
    with profiler.recording() as rec:
        mb.BonsaiRenderer(vol, "cpu")
        mb.BonsaiRenderer(np.zeros((8, 8, 8), np.uint8), "cpu")
    snap = rec.snapshot()
    assert snap["spans"]["volume.setup"]["n"] == 2
    assert snap["counters"]["volume.bytes"] == vol.size + 512
    with profiler.recording() as rec:
        pass
    mb.BonsaiRenderer(vol, "cpu")  # outside any recording: nothing kept
    assert rec.snapshot() == {"spans": {}, "counters": {}}


NOT_CUBIC = np.zeros((16, 16, 8), np.uint8)


@pytest.mark.parametrize("make", [
    lambda: shear_warp.prepare_fast_volume(NOT_CUBIC, "cpu"),
    lambda: shear_warp.FastBonsaiRenderer(NOT_CUBIC, "cpu"),
    lambda: shear_warp.build_fast_renderer(NOT_CUBIC, "cpu"),
    lambda: hybrid.HybridBonsaiRenderer(NOT_CUBIC, "cpu"),
    lambda: hybrid.build_hybrid_renderer(torch.from_numpy(NOT_CUBIC), "cpu"),
    lambda: mb.render_bonsai_tiles(torch.from_numpy(NOT_CUBIC), Camera(aspect=1.0).uniform("cpu"),
                                   torch.zeros(1, dtype=torch.int32), 32, 32),
], ids=["prepare_fast_volume", "FastBonsaiRenderer", "build_fast_renderer",
        "HybridBonsaiRenderer", "build_hybrid_renderer", "render_bonsai_tiles"])
def test_fast_hybrid_and_the_tiles_refuse_a_volume_that_is_not_a_cube(make):
    with pytest.raises(ValueError, match="cubic"):
        make()


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(97, 61), (1024, 1024)], ids=["97x61", "1024x1024"])
@pytest.mark.parametrize("shape", [(23, 29, 37), (40, 48, 64)], ids=["23x29x37", "40x48x64"])
def test_k1_at_non_cubic_shapes_is_its_twin_on_gpu(cuda_device, shape, size):
    """K1, over ray planes and making its own rays, and the renderer's
    replayed frame, bitwise the plain twin on the card at every pose."""
    w, h = size
    vol = mb.volume_tensor(_volume(shape, 7), cuda_device)
    r = mb.BonsaiRenderer(vol, cuda_device)
    for pose in sorted(POSES):
        u, (eye, dxyz) = _rays(pose, w, h, cuda_device)
        want = mb.render_bonsai_rays_plain(vol, eye, dxyz)
        assert torch.equal(mb.render_bonsai_rays_cuda(vol, eye, dxyz), want), pose
        got = mb.render_bonsai_frame_cuda(vol, u, w, h)
        assert torch.equal(got, want), (pose, float((got - want).abs().max()))
        for _ in range(2):  # the capture, then a replay
            assert torch.equal(r(u, w, h), want), pose
        assert float(got[..., :3].max()) > 0.1


@pytest.mark.gpu
def test_cubic_frame_and_512_batch_are_their_twins_on_gpu(cuda_device):
    """The cubic path: the 256^3 bonsai frame at 1024^2 (K1 making its rays
    and over ray planes) and a batch of 8 views at 512^2 of a 512^3 volume
    (the views cell's sizes), each one K1 launch making its rays, bitwise
    the plain twin."""
    from vokselis_torch.parallel import orbit_camera_batch
    from vokselis_torch.volume.io import get_bonsai

    vol = mb.volume_tensor(get_bonsai(), cuda_device)
    u, (eye, dxyz) = _rays("close", 1024, 1024, cuda_device)
    want = mb.render_bonsai_rays_plain(vol, eye, dxyz)
    assert torch.equal(mb.render_bonsai_frame_cuda(vol, u, 1024, 1024), want)
    assert torch.equal(mb.render_bonsai_rays_cuda(vol, eye, dxyz), want)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    dense = torch.randint(30, 220, (512,) * 3, generator=gen, device=cuda_device,
                          dtype=torch.uint8)
    dense[torch.rand((512,) * 3, generator=gen, device=cuda_device) < 0.97] = 0
    ub = orbit_camera_batch(8, device=cuda_device)
    before = mb.LAUNCHES_FRAME
    got = mb.render_bonsai_frame_cuda(dense, ub, 512, 512)
    assert mb.LAUNCHES_FRAME == before + 1
    eye_b, dxyz_b = geometry.rays_fragment_soa(ub, 512, 512)
    assert torch.equal(got, mb.render_bonsai_rays_plain(dense, eye_b, dxyz_b))
