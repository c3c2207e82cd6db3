"""The xor frame cell (``xor-orbit``) on the CPU: planted faults seen as not
correct, the reference's field march against the port's plain version at
the cell's grid, the reference's count of samples, and K7's roofline
counts repeated from shapes.

Like the shared tests these drive ``run.run_cell`` on the CPU at the
driver's ``TINY`` size, where the port's K7 takes its plain version."""

import math

import pytest
import torch

from benchmark import run
from benchmark.drivers import xor_loop
from benchmark.reference import camera, field
from benchmark.roofline import k7
from benchmark.traffic import drag_orbit

SPEC = run.load_spec()
CELL = "xor-orbit"
SEED = 2**31 + 11


def _run():
    cell, cfg, mix = run.resolve(SPEC, CELL)
    cfg, mix = dict(cfg, **xor_loop.TINY), dict(mix, **drag_orbit.TINY)
    return run.run_cell(SPEC, cell, cfg, mix, SEED, 0.3, False, device="cpu")


def _stale_frame(monkeypatch):
    from vokselis_torch.models import xor

    first = {}
    render = xor.FieldPipeline.render

    def stale(self, *args, **kwargs):
        return first.setdefault("img", render(self, *args, **kwargs))

    monkeypatch.setattr(xor.FieldPipeline, "render", stale)


def _altered_pixel(monkeypatch):
    from vokselis_torch.ops.cuda import march_field

    plain = march_field._march_plain

    def altered(*args, **kwargs):
        out = plain(*args, **kwargs)
        h, w = out.shape[:2]
        out[h // 2, w // 2, 0] += 0.25
        return out

    monkeypatch.setattr(march_field, "_march_plain", altered)


def _other_time(monkeypatch):
    from vokselis_torch.models import xor

    init = xor.XorDemo.__init__

    def shifted(self, device, gen_time, *args, **kwargs):
        init(self, device, gen_time + 1.0, *args, **kwargs)

    monkeypatch.setattr(xor.XorDemo, "__init__", shifted)


FAULTS = [_stale_frame, _altered_pixel, _other_time]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    _, _, correct, failed, checks = _run()
    assert not correct and failed >= 1, checks


def test_the_field_time_is_the_seeds():
    t = field.field_time(SEED)
    assert t == field.field_time(SEED) and 0.0 <= t < 2.0 * math.pi
    assert len({field.field_time(s) for s in range(20)}) == 20
    # the time shift the fault plants moves sin t, which the field reads
    assert abs(math.sin(t + 1.0) - math.sin(t)) > 0.1


def _pose_rays(width, height, dims, zoom=2.4):
    inv = camera.Pose(0.7, 0.3, zoom, target=(0.0, 0.0, 0.0),
                      aspect=width / height).matrices()[1]
    return inv, field.rays(torch.from_numpy(inv), width, height, dims)


@pytest.mark.parametrize("grad", ["fd", "analytic"])
def test_the_reference_is_the_plain_march_at_the_cells_grid(grad):
    """At the configuration's 256^3 grid, both normal forms: the reference
    and the port's plain K7 read the same bits."""
    from vokselis_torch.core.camera import Camera
    from vokselis_torch.ops.cuda.march_field import render_field_plain

    w, h, dims = 24, 14, 256
    inv, rays = _pose_rays(w, h, dims, zoom=1.2)
    u = Camera(zoom=1.2, pitch=0.3, yaw=0.7, target=(0.0, 0.0, 0.0), aspect=w / h).uniform("cpu")
    assert torch.equal(u.inv_proj, torch.from_numpy(inv))
    t = field.field_time(SEED)
    prog = render_field_plain(u, torch.tensor(t), w, h, dims=dims, grad=grad)
    ref = field.march(rays, t, dims, 348, grad).reshape(h, w, 4)
    assert torch.equal(prog, ref)


def test_samples_count_nothing_off_the_ball_and_repeat():
    _, rays = _pose_rays(32, 18, 256)
    t = field.field_time(SEED)
    n = field.samples(rays, t, 256, 348)
    miss = rays[6] >= rays[7]  # t0 >= t1: the ray misses the ball
    assert miss.any() and (~miss).any()
    assert int(n[miss].sum()) == 0 and int(n[~miss].sum()) > 0
    # no more samples than the span holds
    assert bool((n <= torch.ceil((rays[7] - rays[6]).clamp(min=0.0) / rays[8]) + 1).all())
    assert torch.equal(n, field.samples(rays, t, 256, 348))
    # a later time is another field: another count
    assert not torch.equal(n, field.samples(rays, t + 1.0, 256, 348))


def test_roofline_counts_repeat_from_shapes():
    assert k7.OPS_PER_SAMPLE == 531 and k7.ops(10) == 5310
    assert k7.frame_bytes(1280, 720) == 1280 * 720 * 16 + 64 + 4
    assert k7.frame_bytes(48, 32) == 48 * 32 * 16 + 68
