"""The reference against the port's plain versions at a tiny size on the CPU,
the control and the planted faults seen as not correct, and the roofline
counts repeated from shapes.

These drive the rest of a run (``run.run_cell``: the driver's set-up,
window and sample, the reference, the comparison against the configuration's
limits) without the harness's look for a card, on the CPU, where every
kernel of the port takes its plain version. Each cell's sizes come from its
own driver and traffic modules: a driver's ``TINY`` and ``CONTROL_SIZE``
override its configuration, its ``control_answers()`` names what the control
recomputes, and a traffic module's ``TINY`` overrides its mix."""

import importlib
import math

import pytest
import torch

from benchmark import run
from benchmark.reference import march
from benchmark.roofline import k1, k8

SPEC = run.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def _module(kind, name):
    return importlib.import_module(f"benchmark.{kind}.{name}")


def _data(kind, name, attr):
    """``attr`` of ``benchmark/<kind>/<name>.py``; a module without it fails
    the test by name."""
    module = _module(kind, name)
    if not hasattr(module, attr):
        pytest.fail(f"benchmark/{kind}/{name}.py defines no {attr}")
    return getattr(module, attr)


def _cell(name):
    cell, cfg, mix = run.resolve(SPEC, name)
    return (cell, dict(cfg, **_data("drivers", cfg["entry"], "TINY")),
            dict(mix, **_data("traffic", mix["kind"], "TINY")))


def _run(name, seed=2**31 + 11):
    cell, cfg, mix = _cell(name)
    return run.run_cell(SPEC, cell, cfg, mix, seed, 0.3, False, device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_agrees_with_the_reference(cell):
    rec, metrics, correct, failed, checks = _run(cell)
    assert correct and failed == 0, checks
    assert rec["checked"] >= 1 and rec["attempted"] >= rec["checked"]
    assert all(c["value"] == 0 for c in checks.values()), checks
    assert "setup_s" in metrics


def _control_readings(cell, seed):
    """The control's numbers against the float32 reference, on the CPU, at
    the driver's ``CONTROL_SIZE``, for its ``control_answers()``."""
    from benchmark.calibrate import readings

    _, cfg, mix = run.resolve(SPEC, cell)
    entry = cfg["entry"]
    cfg = dict(cfg, **_data("drivers", entry, "CONTROL_SIZE"))
    driver = _module("drivers", entry).make(cfg, mix, seed, "cpu")
    missing = f"benchmark/drivers/{entry}.py gives no control_answers()"
    if not hasattr(driver, "control_answers"):
        pytest.fail(missing)
    try:
        driver.answers = driver.control_answers()
    except NotImplementedError:
        pytest.fail(missing)
    ref = driver.reference(torch.float32)
    return readings(driver, driver.reference(torch.bfloat16), ref), cfg["limits"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The reference in bfloat16, put in the program's place, fails a limit."""
    ctrl, limits = _control_readings(cell, 8)
    assert any(v > limits[k] for k, v in ctrl.items()), (ctrl, limits)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(cell):
    """On the card, at the cell's own size and load, on three seeds: the
    program within every limit, the control beyond one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.calibrate import calibrate

    limits = run.resolve(SPEC, cell)[1]["limits"]
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        got = calibrate(cell, seed, 2.0)
        assert all(v <= limits[k] for k, v in got["program"].items()), got
        assert any(v > limits[k] for k, v in got["control"].items()), got


def _stale_frame(monkeypatch):
    from vokselis_torch.ops.cuda import march_bonsai

    first = {}
    call = march_bonsai.BonsaiRenderer.__call__

    def stale(self, *args, **kwargs):
        return first.setdefault("img", call(self, *args, **kwargs))

    monkeypatch.setattr(march_bonsai.BonsaiRenderer, "__call__", stale)


def _altered_pixel(monkeypatch):
    from vokselis_torch.ops.cuda import march_bonsai

    plain = march_bonsai.render_bonsai_rays_plain

    def altered(*args, **kwargs):
        out = plain(*args, **kwargs)
        h, w = out.shape[-3:-1]
        out[..., h // 2, w // 2, 0] += 0.25
        return out

    monkeypatch.setattr(march_bonsai, "render_bonsai_rays_plain", altered)


def _stale_volume(monkeypatch):
    from vokselis_torch.models import views

    first = {}
    make = views.generate_density_u8
    monkeypatch.setattr(views, "generate_density_u8",
                        lambda *a, **k: first.setdefault("vol", make(*a, **k)))


def _half_the_views(monkeypatch):
    from vokselis_torch.models import views

    step = views.ViewsBatch.step

    def half(self, t):
        vol, imgs = step(self, t)
        imgs[imgs.shape[0] // 2:] = 0.0
        return vol, imgs

    monkeypatch.setattr(views.ViewsBatch, "step", half)


FAULTS = [("bonsai-orbit", _stale_frame), ("bonsai-inspect", _altered_pixel),
          ("views512-b64", _stale_volume), ("views512-b64", _half_the_views),
          ("views512-b64", _altered_pixel)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    _, _, correct, failed, checks = _run(cell)
    assert not correct and failed >= 1, checks


def _center_rays(n=64, dist=3.0):
    """``n`` rays from points on a circle around the box, aimed at its centre."""
    a = torch.arange(n, dtype=torch.float32) * (2.0 * math.pi / n)
    eye = torch.stack([0.5 + dist * torch.cos(a), torch.full_like(a, 0.6),
                       0.5 + dist * torch.sin(a)], dim=-1)
    d = torch.tensor([0.5, 0.5, 0.5]) - eye
    return eye, d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def test_touched_samples_count_only_what_the_volume_holds():
    eye, dirs = _center_rays()
    steps = march.max_steps(16)
    empty = torch.zeros((16, 16, 16), dtype=torch.uint8)
    assert int(march.touched_samples(empty, eye, dirs, steps).sum()) == 0
    # a full volume saturates every ray in two samples: tv(1) = 0.817, then 0.966
    full = torch.full((16, 16, 16), 255, dtype=torch.uint8)
    assert march.touched_samples(full, eye, dirs, steps).tolist() == [2] * 64
    vol = (torch.rand((16, 16, 16), generator=torch.Generator().manual_seed(3)) > 0.9)
    vol = (vol * 40).to(torch.uint8)
    a, b = (march.touched_samples(vol, eye, dirs, steps) for _ in range(2))
    assert torch.equal(a, b) and 0 < int(a.sum())


def test_roofline_counts_repeat_from_shapes():
    assert k1.OPS_PER_SAMPLE == 86 and k1.ops(10) == 860
    assert k1.frame_bytes(256, 1024, 1024) == 256 ** 3 + 1024 * 1024 * 16 + 144
    assert k1.frame_bytes(512, 512, 512, 64) == 512 ** 3 + 64 * (512 * 512 * 16 + 144)
    assert k8.volume_bytes(512) == 512 ** 3 + 4
    a, b = k8.ops(512, 0.3 * 12345), k8.ops(512, 0.3 * 12345)
    assert a == b and 512 ** 3 * k8.OPS_VOXEL < a < 512 ** 3 * (k8.OPS_VOXEL + 2)
