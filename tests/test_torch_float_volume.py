"""The exact bonsai path over a float32 volume mapped by its data range
(vokselis_torch.ops.cuda.march_bonsai, models.bonsai, volume.io): K1's
plain twin against the benchmark's plain reference of the float march
(benchmark/reference/float_march.py), the occupancy table over float cells,
a constant volume, the Open SciVis loader's float32 files, the set-up's
span and counter, and fast, hybrid and the hybrid's tile march refusing a
float volume.

Tests marked ``gpu`` need a CUDA card and skip without one: K1's float
instantiation against its plain version on the card, bit for bit, and its
counting instantiation against the plain twin's counts. (The uint8
instantiations are held to their plain twin by the ``gpu`` tests of
tests/test_torch_scan.py and tests/test_torch_march_bonsai.py.) On the
card, run them with ``python -m pytest tests/test_torch_float_volume.py
--noconftest -m gpu``.
"""

import numpy as np
import pytest
import torch

from benchmark.reference import float_march, volume_march
from vokselis_torch.core import geometry
from vokselis_torch.core.camera import Camera
from vokselis_torch.engine import profiler
from vokselis_torch.engine.context import Context
from vokselis_torch.models.bonsai import BonsaiDemo
from vokselis_torch.ops import hybrid, reference, shear_warp
from vokselis_torch.ops.cuda import march_bonsai as mb
from vokselis_torch.volume import io
from vokselis_torch.volume.sample import sample_trilinear_r8

# (D, H, W): tests/test_torch_scan.py's three shapes, none a multiple of 8,
# and a cube
SHAPES = [(12, 31, 21), (24, 16, 40), (40, 24, 9), (20, 20, 20)]
POSES = {
    "close": dict(zoom=0.9, pitch=0.4, yaw=0.8, target=(0.5, 0.5, 0.5)),
    "eye_inside": dict(zoom=0.3, pitch=0.1, yaw=0.7, target=(0.5, 0.5, 0.5)),
    "diagonal": dict(zoom=1.3, pitch=-0.6, yaw=2.2, target=(0.5, 0.5, 0.5)),
}
LIGHT, HEAVY = 1.0, 3.0


def _field(shape, seed, full=0.5):
    """Seeded float32 voxels in [LIGHT, HEAVY] in a share ``full`` of the 8^3
    cells, the rest LIGHT, which maps to 0: cells both empty and full. The
    range is [LIGHT, HEAVY] exactly."""
    rng = np.random.default_rng(seed)
    vol = LIGHT + (HEAVY - LIGHT) * rng.random(shape)
    cells = [-(-n // 8) for n in shape]
    keep = rng.random(cells) < full
    mask = keep.repeat(8, 0).repeat(8, 1).repeat(8, 2)[:shape[0], :shape[1], :shape[2]]
    vol = np.where(mask, vol, LIGHT).astype(np.float32)
    vol.flat[0], vol.flat[-1] = LIGHT, HEAVY
    return vol


def _rays(pose, width, height, device="cpu"):
    u = Camera(aspect=width / height, **POSES[pose]).uniform(device)
    return u, geometry.rays_fragment_soa(u, width, height)


@pytest.mark.parametrize("pose", sorted(POSES))
@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_the_twin_is_the_benchmarks_float_march(shape, pose):
    """K1's plain twin over a float32 volume, through the rays and the frame
    wrappers, is the benchmark's plain float march bit for bit, at the
    whole diagonal's steps and at a cut, in sRGB and linear; the twin with
    the empty-cell runs (march_runs_plain) is too, every bare step in its
    run's empty cell."""
    vol = torch.from_numpy(_field(shape, sum(shape)))
    u, (eye, dxyz) = _rays(pose, 40, 28)
    dirs = torch.stack(dxyz, dim=-1)
    for steps in (None, 9):
        n = volume_march.max_steps(shape) if steps is None else steps
        for srgb in (True, False):
            twin = mb.render_bonsai_rays_plain(vol, eye, dxyz, max_steps=steps, srgb=srgb)
            want = float_march.march(vol, eye, dirs.reshape(-1, 3), n, srgb=srgb)
            want = want.reshape(28, 40, 4)
            assert torch.equal(twin, want), (steps, srgb, float((twin - want).abs().max()))
            assert torch.equal(mb.render_frame(vol, u, 40, 28, steps, srgb), twin)
    assert float(twin[..., :3].max()) > 0.1
    strays = []
    img, _, skipped, bare = mb.march_runs_plain(
        vol, eye, dirs, on_bare=lambda b, held: strays.append(int((b & ~held).sum())))
    assert torch.equal(img, mb.render_bonsai_rays_plain(vol, eye, dxyz))
    assert sum(strays) == 0 and int(bare.sum()) <= int(skipped.sum())


def test_the_float_march_is_not_the_uint8_march():
    """The field read through its mapping differs from the same field cut to
    bytes: the float path is not the uint8 path in disguise."""
    vol = torch.from_numpy(_field((24, 16, 40), 5))
    _, (eye, dxyz) = _rays("close", 40, 28)
    dirs = torch.stack(dxyz, dim=-1).reshape(-1, 3)
    steps = volume_march.max_steps(vol.shape)
    want = float_march.march(vol, eye, dirs, steps)
    cut = volume_march.march(float_march.quantised(vol), eye, dirs, steps)
    assert float((cut - want).abs().max()) > 1e-4


def _near_the_cut(n=24, seed=3):
    """An (n, n, n) field whose range is [LIGHT, HEAVY] (one voxel each), with
    about half the 8^3 cells mapped uniformly in [0, 25/255] (OCC_CUT's
    value, at or below which a cell is empty) and some of those constant at
    25/255, the rest in [0, 1]."""
    rng = np.random.default_rng(seed)
    cut = mb.OCC_CUT / 255.0
    cells = -(-n // 8)
    low = (rng.random((cells,) * 3) < 0.6).repeat(8, 0).repeat(8, 1).repeat(8, 2)[:n, :n, :n]
    flat = (rng.random((cells,) * 3) < 0.3).repeat(8, 0).repeat(8, 1).repeat(8, 2)[:n, :n, :n]
    mapped = np.where(low, np.where(flat, cut, cut * rng.random((n,) * 3)), rng.random((n,) * 3))
    vol = (LIGHT + (HEAVY - LIGHT) * mapped).astype(np.float32)
    vol[0, 0, 0], vol[-1, -1, -1] = LIGHT, HEAVY
    return vol


def test_a_float_cell_the_table_marks_empty_has_no_transfer():
    """Every sample whose lower taps lie in a cell the table marks empty
    (its cell max mapped by the range and rounded up, at or below OCC_CUT)
    maps below the transfer's edge, 0.1: its transfer is exactly 0."""
    vol = torch.from_numpy(_near_the_cut())
    lo, inv = mb.value_range(vol)
    assert (lo, inv) == (LIGHT, float(np.float32(1.0) / np.float32(HEAVY - LIGHT)))
    occ = mb.occupancy_table(vol)
    assert occ.dtype == torch.uint8 and occ.shape == (3, 3, 3)
    p = torch.rand((200_000, 3), generator=torch.Generator().manual_seed(1))
    size = torch.tensor(vol.shape[::-1], dtype=torch.float32)
    lower = torch.clamp(torch.floor(p * size - 0.5).long(), min=0)
    lower = torch.minimum(lower, size.long() - 1) // mb.OCC_CELL
    empty = occ[lower[:, 2], lower[:, 1], lower[:, 0]] <= mb.OCC_CUT
    assert 20_000 < int(empty.sum()) < 180_000
    s = sample_trilinear_r8(vol, p[empty], (lo, inv))
    assert float(s.max()) > 0.095  # the cells reach the cut
    _, c_a = reference._bonsai_transfer(s)
    assert bool((c_a == 0.0).all())


def test_a_voxel_just_above_the_cut_keeps_its_cell():
    """A cell whose largest voxel maps to 25.5/255 is not marked empty; one
    whose largest maps to 24.5/255 is; one of the light fluid alone maps to
    0."""
    vol = np.full((16, 16, 16), LIGHT, np.float32)
    vol[15, 15, 15] = HEAVY  # cell (1, 1, 1) alone
    vol[3, 3, 3] = LIGHT + (HEAVY - LIGHT) * 25.5 / 255.0  # cell (0, 0, 0) alone
    vol[3, 3, 12] = LIGHT + (HEAVY - LIGHT) * 24.5 / 255.0  # cell (0, 0, 1) alone
    occ = mb.occupancy_table(torch.from_numpy(vol))
    assert int(occ[0, 0, 0]) == 26 and int(occ[0, 0, 1]) == 25
    assert int(occ[1, 1, 1]) == 255 and int(occ[1, 0, 0]) == 0


def test_a_constant_volume_renders_blank():
    """inv = 0 where the range is empty: every tap maps to 0, the frame is
    black with alpha 1, as the reference's."""
    vol = torch.full((12, 31, 21), 2.5, dtype=torch.float32)
    assert mb.value_range(vol) == (2.5, 0.0)
    assert int(mb.occupancy_table(vol).max()) == 0
    u, (eye, dxyz) = _rays("close", 40, 28)
    img = mb.BonsaiRenderer(vol, "cpu")(u, 40, 28)
    assert bool((img[..., :3] == 0.0).all()) and bool((img[..., 3] == 1.0).all())
    want = float_march.march(vol, eye, torch.stack(dxyz, dim=-1).reshape(-1, 3),
                             volume_march.max_steps(vol.shape))
    assert torch.equal(img, want.reshape(28, 40, 4))


def test_a_volume_with_a_nan_is_refused():
    vol = torch.from_numpy(_field((12, 31, 21), 2))
    vol[5, 5, 5] = float("nan")
    with pytest.raises(ValueError, match="finite"):
        mb.BonsaiRenderer(vol, "cpu")


def test_the_renderer_keeps_the_callers_volume():
    """The float volume stays the caller's tensor, float32, unchanged."""
    vol = torch.from_numpy(_field((12, 31, 21), 4))
    before = vol.clone()
    r = mb.BonsaiRenderer(vol, "cpu")
    assert r.vol.dtype == torch.float32 and r.vol.data_ptr() == vol.data_ptr()
    r(Camera(aspect=1.0, **POSES["close"]).uniform("cpu"), 16, 16)
    assert torch.equal(vol, before)
    render, pack = mb.build_renderer(vol, "cpu")
    assert pack.data_ptr() == vol.data_ptr()


def test_open_scivis_loader_reads_float32(tmp_path):
    data = _field((3, 4, 5), 6)  # z 3, y 4, x 5
    path = tmp_path / "tiny_5x4x3_float32.raw"
    path.write_bytes(data.astype("<f4").tobytes())
    got = io.load_open_scivis(str(path))
    assert got.dtype == np.float32 and got.shape == (3, 4, 5)
    np.testing.assert_array_equal(got, data)
    for name, size in (("tiny_5x4x3_float32.raw", 4 * 60 + 4),  # a voxel too many
                       ("tiny_5x4x3_float16.raw", 120), ("tiny_5x4x3_int32.raw", 240)):
        bad = tmp_path / name
        bad.write_bytes(bytes(size))
        with pytest.raises(ValueError):
            io.load_open_scivis(str(bad))


def test_the_demo_takes_a_float_field(tmp_path):
    """``BonsaiDemo.init``'s volume: a float32 Open SciVis file or array,
    marched by the exact renderer; fast refuses it."""
    data = _field((12, 31, 21), 8)
    path = tmp_path / "field_21x31x12_float32.raw"
    path.write_bytes(data.tobytes())
    ctx = Context(width=32, height=24, device="cpu")
    for volume in (str(path), data):
        demo = BonsaiDemo.init(ctx, volume=volume)
        assert demo.renderer.vol.dtype == torch.float32
        img = demo.renderer(ctx.camera_uniform, 32, 24)
        assert torch.equal(img, mb.render_frame(torch.from_numpy(data), ctx.camera_uniform,
                                                32, 24))
    with pytest.raises(TypeError, match="uint8"):
        BonsaiDemo.init(ctx, renderer="fast", volume=data)


FLOAT_CUBE = _field((16, 16, 16), 9)


@pytest.mark.parametrize("make", [
    lambda: shear_warp.prepare_fast_volume(FLOAT_CUBE, "cpu"),
    lambda: shear_warp.FastBonsaiRenderer(FLOAT_CUBE, "cpu"),
    lambda: shear_warp.build_fast_renderer(FLOAT_CUBE, "cpu"),
    lambda: hybrid.HybridBonsaiRenderer(FLOAT_CUBE, "cpu"),
    lambda: hybrid.build_hybrid_renderer(torch.from_numpy(FLOAT_CUBE), "cpu"),
    lambda: mb.render_bonsai_tiles(torch.from_numpy(FLOAT_CUBE),
                                   Camera(aspect=1.0).uniform("cpu"),
                                   torch.zeros(1, dtype=torch.int32), 32, 32),
    lambda: mb.render_bonsai_rays_cuda(torch.from_numpy(FLOAT_CUBE), *_rays("close", 16, 16)[1]),
], ids=["prepare_fast_volume", "FastBonsaiRenderer", "build_fast_renderer",
        "HybridBonsaiRenderer", "build_hybrid_renderer", "render_bonsai_tiles",
        "render_bonsai_rays_cuda"])
def test_fast_hybrid_and_the_tiles_refuse_a_float_volume(make):
    with pytest.raises(TypeError, match="uint8"):
        make()


def test_volume_setup_counts_bytes_and_times_the_range():
    """``volume.bytes`` counts itemsize x voxels; a float volume's range read
    is the span ``volume.range``, which a uint8 volume has not."""
    vol = _field((12, 31, 21), 1)
    with profiler.recording() as rec:
        mb.BonsaiRenderer(vol, "cpu")
        mb.BonsaiRenderer(np.zeros((8, 8, 8), np.uint8), "cpu")
    snap = rec.snapshot()
    assert snap["spans"]["volume.setup"]["n"] == 2
    assert snap["spans"]["volume.range"]["n"] == 1
    assert snap["counters"]["volume.bytes"] == 4 * vol.size + 512
    with profiler.recording() as rec:
        mb.BonsaiRenderer(np.zeros((8, 8, 8), np.uint8), "cpu")
    assert "volume.range" not in rec.snapshot()["spans"]


def test_an_inference_volume_reads_its_range_once(monkeypatch):
    """A float volume made under ``torch.inference_mode`` (no version
    counter): its range is read once, in the set-up, and the frames after it,
    whose table is made again at every launch, read none (on a card a read
    inside the frame's graph capture would sync the host); the frames are
    the twin's."""
    with torch.inference_mode():
        vol = torch.from_numpy(_field((12, 31, 21), 13))
    assert vol.is_inference()
    reads = []
    value_range = mb.value_range
    monkeypatch.setattr(mb, "value_range", lambda v: reads.append(1) or value_range(v))
    r = mb.BonsaiRenderer(vol, "cpu")
    u, (eye, dxyz) = _rays("close", 40, 28)
    for _ in range(2):
        assert torch.equal(r(u, 40, 28), mb.render_bonsai_rays_plain(vol, eye, dxyz))
    assert torch.equal(mb.volume_occupancy(vol), mb.occupancy_table(vol.clone()))
    assert len(reads) == 2  # the set-up's, and the clone's own


def test_step_counts_over_a_float_volume_on_the_cpu():
    """step_counts over a float volume: the reference's steps, some of them
    bare."""
    vol = torch.from_numpy(_field((24, 16, 40), 12, full=0.15))
    u = Camera(aspect=48 / 32, **POSES["close"]).uniform("cpu")
    steps, bare = mb.step_counts(vol, u, 48, 32)
    eye, dxyz = geometry.rays_fragment_soa(u, 48, 32)
    _, want = reference.render_bonsai_rays(vol, eye, torch.stack(dxyz, dim=-1),
                                           return_steps=True, value_range=mb.value_range(vol))
    assert torch.equal(steps, want)
    assert 0 < int(bare.sum()) < int(steps.sum())


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(97, 61), (1024, 1024)], ids=["97x61", "1024x1024"])
@pytest.mark.parametrize("shape", [(23, 29, 37), (64, 64, 64)], ids=["23x29x37", "64x64x64"])
def test_float_k1_is_its_twin_on_gpu(cuda_device, shape, size):
    """K1's float instantiation, per axis and cubic, making its own rays,
    and the renderer's replayed frame, bitwise the plain twin on the card
    at every pose."""
    w, h = size
    vol = mb.volume_tensor(_field(shape, 7), cuda_device)
    r = mb.BonsaiRenderer(vol, cuda_device)
    for pose in sorted(POSES):
        u, (eye, dxyz) = _rays(pose, w, h, cuda_device)
        want = mb.render_bonsai_rays_plain(vol, eye, dxyz)
        got = mb.render_bonsai_frame_cuda(vol, u, w, h)
        assert torch.equal(got, want), (pose, float((got - want).abs().max()))
        for _ in range(2):  # the capture, then a replay
            assert torch.equal(r(u, w, h), want), pose
        assert float(got[..., :3].max()) > 0.1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_an_inference_float_volume_renders_on_gpu(cuda_device, dtype):
    """A float (or uint8) volume made under ``torch.inference_mode``, whose
    table is made anew at every launch, renders through the renderer's CUDA
    graph (whose capture allows no host sync), the capture and a replay
    bitwise the plain twin."""
    field = _field((23, 29, 37), 14)
    if dtype == "uint8":
        field = np.round((field - LIGHT) / (HEAVY - LIGHT) * 255.0).astype(np.uint8)
    with torch.inference_mode():
        vol = mb.volume_tensor(field, cuda_device)
    r = mb.BonsaiRenderer(vol, cuda_device)
    u, (eye, dxyz) = _rays("close", 97, 61, cuda_device)
    want = mb.render_bonsai_rays_plain(vol, eye, dxyz)
    for _ in range(2):
        assert torch.equal(r(u, 97, 61), want)
    assert float(want[..., :3].max()) > 0.1


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(23, 29, 37), (64, 64, 64)], ids=["23x29x37", "64x64x64"])
def test_float_step_counts_match_the_plain_twin_on_gpu(cuda_device, shape):
    """K1's float counting instantiation counts each pixel's steps and bare
    steps as the plain twin does on the CPU."""
    vol_np = _field(shape, 3, full=0.15)
    vol = mb.volume_tensor(vol_np, cuda_device)
    u = Camera(aspect=96 / 64, **POSES["close"]).uniform(cuda_device)
    steps, bare = mb.step_counts(vol, u, 96, 64)
    eye, dxyz = geometry.rays_fragment_soa(u, 96, 64)
    dirs = torch.stack(dxyz, dim=-1).cpu()
    _, sv, _, bv = mb.march_runs_plain(torch.from_numpy(vol_np), eye.cpu(), dirs)
    assert torch.equal(steps.cpu(), sv) and torch.equal(bare.cpu(), bv)
    assert 0 < int(bare.sum()) < int(steps.sum())
