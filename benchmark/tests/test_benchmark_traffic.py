"""The traffic generators: deterministic per seed, in range, and the close
inspection's eye outside the volume's box at every frame."""

import math

import numpy as np
import pytest

from benchmark.reference import camera
from benchmark.run import load_spec, resolve
from benchmark.traffic import batch_steps, drag_orbit

SPEC = load_spec()
ORBIT_CELLS = [w["name"] for w in SPEC["workloads"]
               if resolve(SPEC, w["name"])[2]["kind"] == "drag_orbit"]
BIG_SEED = 2**31 + 977


def _mix(cell):
    return resolve(SPEC, cell)[2]


def _poses(mix, seed, frames):
    path = drag_orbit.make(mix, seed)
    pose = camera.Pose(*path.start())
    last, out = None, []
    for f in range(frames):
        for ev in path.events(f):
            last = pose.apply(ev, last)
        out.append((pose.yaw, pose.pitch, pose.zoom, pose.eye()))
    return out


@pytest.mark.parametrize("cell", ORBIT_CELLS)
def test_drag_orbit_is_deterministic_per_seed(cell):
    mix = _mix(cell)
    a, b = drag_orbit.make(mix, BIG_SEED), drag_orbit.make(mix, BIG_SEED)
    assert a.start() == b.start()
    assert all(a.events(f) == b.events(f) for f in range(0, 3000, 7))
    assert drag_orbit.make(mix, BIG_SEED + 1).start() != a.start()


@pytest.mark.parametrize("cell", ORBIT_CELLS)
def test_drag_orbit_stays_in_range(cell):
    mix = _mix(cell)
    poses = _poses(mix, 12345, 2 * mix["zoom_period"])
    yaws = [p[0] for p in poses]
    # a full yaw turn takes 2 pi / (dx 0.0025) frames
    assert yaws[1] - yaws[0] == pytest.approx(-mix["dx_px"] * camera.ROTATE_SPEED)
    assert max(abs(p[1]) for p in poses) <= mix["pitch_amplitude"] + 1e-9
    zooms = [p[2] for p in poses]
    assert mix["zoom_lo"] - 1e-9 <= min(zooms) and max(zooms) <= mix["zoom_hi"] + 1e-9
    # the loop's events follow the path's sines up to rounding
    path = drag_orbit.make(mix, 12345)
    for f in (1, 500, 2 * mix["zoom_period"] - 1):
        assert poses[f][1] == pytest.approx(path.pitch(f), abs=1e-9)
        assert poses[f][2] == pytest.approx(path.zoom(f), abs=1e-9)


@pytest.mark.parametrize("seed", [1, 99, BIG_SEED])
def test_close_inspection_keeps_the_eye_outside_the_box(seed):
    mix = _mix("bonsai-inspect")
    assert mix["zoom_lo"] > math.sqrt(3.0) / 2.0
    for _, _, zoom, eye in _poses(mix, seed, mix["zoom_period"] + mix["pitch_period"]):
        assert zoom > math.sqrt(3.0) / 2.0
        assert not np.all((eye >= 0.0) & (eye <= 1.0)), eye


def test_batch_steps_are_deterministic_and_in_range():
    mix = _mix("views512-b64")
    a, b = batch_steps.make(mix, BIG_SEED), batch_steps.make(mix, BIG_SEED)
    assert a.b0 == b.b0 and 0 <= a.b0 < mix["b0_max"]
    assert [a.step(k) for k in range(5)] == list(range(a.b0, a.b0 + 5))
    assert len({batch_steps.make(mix, s).b0 for s in range(20)}) > 1
