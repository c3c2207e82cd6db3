"""The scan frame cell (``kingsnake-inspect``) on the CPU: planted faults
seen as not correct, the reference's (D, H, W) march against the cubic one
at a cube, K1's bytes over a volume of any shape, and the stand-in drawn
from the seed.

Like the shared tests these drive ``run.run_cell`` on the CPU at the
driver's ``TINY`` size, where the port's K1 takes its plain version."""

import pytest
import torch

from benchmark import run
from benchmark.drivers import scan_loop
from benchmark.reference import march, standin_kingsnake, volume_march
from benchmark.roofline import k1, k1_volume
from benchmark.traffic import drag_orbit

SPEC = run.load_spec()
CELL = "kingsnake-inspect"
SEED = 2**31 + 11


def _run():
    cell, cfg, mix = run.resolve(SPEC, CELL)
    cfg, mix = dict(cfg, **scan_loop.TINY), dict(mix, **drag_orbit.TINY)
    return run.run_cell(SPEC, cell, cfg, mix, SEED, 0.3, False, device="cpu")


def _plain(monkeypatch, march_fn):
    """Put ``march_fn(vol, eye, dxyz, max_steps, srgb)`` in the place of K1's
    plain twin, which the CPU frames run."""
    from vokselis_torch.ops.cuda import march_bonsai

    plain = march_bonsai.render_bonsai_rays_plain

    def patched(vol, eye, dxyz, max_steps=None, srgb=True):
        return march_fn(plain, vol, eye, dxyz, max_steps, srgb)

    monkeypatch.setattr(march_bonsai, "render_bonsai_rays_plain", patched)


def _cubic_dt(monkeypatch):
    """The step of a cube of the first axis, dt = 1 / (D max|d|)
    (``march.march``), in place of the step per axis."""
    def cubic(plain, vol, eye, dxyz, max_steps, srgb):
        dirs = torch.stack(dxyz, dim=-1)
        out = march.march(vol, eye, dirs.reshape(-1, 3), max_steps, srgb=srgb)
        return out.reshape(dirs.shape[:-1] + (4,))

    _plain(monkeypatch, cubic)


def _x_and_z_swapped(monkeypatch):
    """The renderer's volume with its x and z axes swapped."""
    from vokselis_torch.ops.cuda import march_bonsai

    make = march_bonsai.volume_tensor
    monkeypatch.setattr(march_bonsai, "volume_tensor",
                        lambda *a, **k: make(*a, **k).transpose(0, 2).contiguous())


def _cut_short(monkeypatch):
    """The march cut at the steps of a cube a quarter of the largest dim:
    445, the bonsai's, of the scan's 1,775 at 1024."""
    def cut(plain, vol, eye, dxyz, max_steps, srgb):
        steps = volume_march.max_steps((max(vol.shape) // 4,) * 3)
        return plain(vol, eye, dxyz, max_steps=min(max_steps, steps), srgb=srgb)

    _plain(monkeypatch, cut)


FAULTS = [_cubic_dt, _x_and_z_swapped, _cut_short]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    _, _, correct, failed, checks = _run()
    assert not correct and failed >= 1, checks


def _center_rays(n=48, dist=2.5):
    """``n`` rays from points around the box, aimed near its centre."""
    g = torch.Generator().manual_seed(4)
    a = torch.rand(n, generator=g) * 6.2832
    eye = torch.stack([0.5 + dist * torch.cos(a), 0.3 + torch.rand(n, generator=g),
                       0.5 + dist * torch.sin(a)], dim=-1)
    d = 0.5 + 0.2 * (torch.rand((n, 3), generator=g) - 0.5) - eye
    return eye, d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def test_at_a_cube_the_march_is_the_cubic_one():
    g = torch.Generator().manual_seed(5)
    vol = (torch.rand((24, 24, 24), generator=g) * 255).to(torch.uint8)
    vol[torch.rand((24, 24, 24), generator=g) < 0.6] = 0
    eye, dirs = _center_rays()
    steps = volume_march.max_steps(vol.shape)
    assert steps == march.max_steps(24)
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(volume_march.march(vol, eye, dirs, steps, dtype),
                           march.march(vol, eye, dirs, steps, dtype))
    assert torch.equal(volume_march.march(vol, eye, dirs, steps, srgb=False),
                       march.march(vol, eye, dirs, steps, srgb=False))
    touched = volume_march.touched_samples(vol, eye, dirs, steps)
    assert torch.equal(touched, march.touched_samples(vol, eye, dirs, steps))
    assert int(touched.sum()) > 0


def test_frame_bytes_at_a_cube_are_k1s():
    assert k1_volume.frame_bytes((256, 256, 256), 1024, 1024) == k1.frame_bytes(256, 1024, 1024)
    assert (k1_volume.frame_bytes((512,) * 3, 512, 512, 64)
            == k1.frame_bytes(512, 512, 512, 64))
    assert (k1_volume.frame_bytes((795, 1024, 1024), 1024, 1024)
            == 795 * 1024 * 1024 + 1024 * 1024 * 16 + k1.CAMERA_BYTES)


def test_the_standin_is_the_seeds():
    shape = tuple(scan_loop.TINY["shape"])
    a = standin_kingsnake.kingsnake(shape, SEED, "cpu")
    assert a.dtype == torch.uint8 and tuple(a.shape) == shape
    assert torch.equal(a, standin_kingsnake.kingsnake(shape, SEED, "cpu"))
    assert not torch.equal(a, standin_kingsnake.kingsnake(shape, SEED + 1, "cpu"))
    assert 0.1 < float((a > 0).float().mean()) < 0.9
    # the contents are above the march's skip cut, 25: no cell of them is skipped
    assert int(a[a > 0].min()) > 25
