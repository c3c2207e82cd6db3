"""The float field frame cell (``miranda-inspect``) on the CPU: the stand-in
drawn from the seed in the shares its configuration states, the driver end
to end, the field cut to uint8 seen as not correct, K1's bytes over a float
field, and the reader of the range span.

Like the shared tests these drive ``run.run_cell`` on the CPU at the
driver's ``TINY`` size, where the port's K1 takes its plain version. The
test marked ``gpu`` reads the uint8 control at the cell's own size on the
card."""

import pytest
import torch

from benchmark import run
from benchmark.calibrate import readings
from benchmark.drivers import float_scan_loop
from benchmark.reference import (camera, float_march, march, present, standin_miranda,
                                 volume_march)
from benchmark.roofline import k1, k1_float
from benchmark.traffic import drag_orbit

SPEC = run.load_spec()
CELL = "miranda-inspect"
SEED = 2**31 + 11
# the shares the configuration's ``assumed`` states for the stand-in
SHARES = {"light": (0.30, 0.40), "heavy": (0.30, 0.40), "mixed": (0.25, 0.35)}


def _cell(size):
    cell, cfg, mix = run.resolve(SPEC, CELL)
    return cell, dict(cfg, **size), mix


class _Quantised(float_scan_loop.FloatScanLoop):
    """The control that the cell's limit must refuse besides the bfloat16
    one: the float32 reference over the field cut to the bytes a uint8
    volume holds (``float_march.quantised``, read as u8 / 255 by
    ``volume_march``), the shortcut of handing the field to the uint8
    path."""

    def reference_images(self, frames, dtype):
        eye, dirs = self._rays(frames)
        hdr = volume_march.march(float_march.quantised(self.volume()), eye, dirs,
                                 volume_march.max_steps(self.shape), dtype)
        return present.present(hdr).reshape(len(frames), self.height, self.width, 4)


def _quantised_control(driver, cfg, mix, seed):
    """The quantised reference of ``driver``'s sampled frames."""
    control = _Quantised(cfg, mix, seed, driver.device)
    control.answers = driver.answers
    return control.reference(torch.float32)


def test_the_standin_is_the_seeds():
    shape = (64, 64, 64)
    a = standin_miranda.miranda(shape, SEED, "cpu")
    assert a.dtype == torch.float32 and tuple(a.shape) == shape
    assert torch.equal(a, standin_miranda.miranda(shape, SEED, "cpu"))
    assert not torch.equal(a, standin_miranda.miranda(shape, SEED + 1, "cpu"))
    assert float(a.min()) == standin_miranda.LIGHT and float(a.max()) == standin_miranda.HEAVY
    for seed in (SEED, 5, 2**33 + 7):
        shares = standin_miranda.shares(standin_miranda.miranda(shape, seed, "cpu"))
        for part, (lo, hi) in SHARES.items():
            assert lo < shares[part] < hi, (seed, shares)


def test_the_standin_has_the_heavy_fluid_above():
    """y up: the top layer of voxels is mostly heavy, the bottom one mostly
    light; the shares recorded in the configuration are SHARES'."""
    vol = standin_miranda.miranda((32, 48, 40), SEED, "cpu")
    assert float((vol[:, -1] == standin_miranda.HEAVY).float().mean()) > 0.9
    assert float((vol[:, 0] == standin_miranda.LIGHT).float().mean()) > 0.9
    _, cfg, _ = run.resolve(SPEC, CELL)
    assert any("light 0.30-0.40, heavy 0.30-0.40, mixed 0.25-0.35" in a for a in cfg["assumed"])


def test_the_driver_runs_end_to_end_at_tiny():
    cell, cfg, mix = _cell(float_scan_loop.TINY)
    mix = dict(mix, **drag_orbit.TINY)
    rec, metrics, correct, failed, checks = run.run_cell(SPEC, cell, cfg, mix, SEED, 0.3, False,
                                                         device="cpu")
    assert correct and failed == 0 and checks["frame_max_err"]["value"] == 0.0, checks
    assert rec["checked"] >= 1 and "setup_s" in metrics and "frame_ms" in metrics


def test_the_field_cut_to_uint8_is_not_correct():
    """The float32 reference over the field quantised to uint8, round(255 *
    mapped) read as u8 / 255, in the program's place, fails the limit at
    the driver's CONTROL_SIZE: the shortcut of handing the field to the
    uint8 path is not this cell's answer."""
    _, cfg, mix = _cell(float_scan_loop.CONTROL_SIZE)
    driver = float_scan_loop.make(cfg, mix, 8, "cpu")
    driver.answers = driver.control_answers()
    ref = driver.reference(torch.float32)
    got = readings(driver, _quantised_control(driver, cfg, mix, 8), ref)
    assert got["frame_max_err"] > cfg["limits"]["frame_max_err"], got


def _view(yaw, pitch, zoom, width, height):
    pose = camera.Pose(yaw, pitch, zoom, target=(0.5, 0.5, 0.5), aspect=width / height)
    vp, inv = pose.matrices()
    return march.rays(torch.from_numpy(vp), torch.from_numpy(inv), width, height)


def test_k1_float_bytes_count_the_voxels_the_samples_tap():
    """Per frame at most every voxel once, 4 bytes each; a view of the heavy
    fluid's face alone (from above: the eye at target - zoom (.., sin pitch,
    ..)) taps far fewer; the samples counted are
    touched_samples'."""
    shape = (40, 48, 36)
    vol = standin_miranda.miranda(shape, SEED, "cpu")
    steps = volume_march.max_steps(shape)
    w, h = 40, 32
    views = {"side": _view(0.7, 0.1, 0.9, w, h), "above": _view(0.3, -1.5, 1.2, w, h)}
    eye = torch.cat([e.expand(d.shape) for e, d in views.values()])
    dirs = torch.cat([d for _, d in views.values()])
    samples, voxels = float_march.frame_work(vol, eye, dirs, steps, w * h)
    assert samples == float_march.touched_samples(vol, eye, dirs, steps).reshape(2, -1).sum(
        dim=1).tolist()
    side, above = voxels
    assert 0 < above < side <= vol.numel()
    assert 20 * above < vol.numel()
    frame = w * h * 16 + k1.CAMERA_BYTES
    assert k1_float.frame_bytes(side, w, h) == 4 * side + frame <= 4 * vol.numel() + frame
    assert k1_float.OPS_PER_SAMPLE == k1.OPS_PER_SAMPLE + 8 and k1_float.ops(10) == 940


def test_the_range_reader():
    from benchmark.run import reader

    read = reader("volume_range_ms")
    assert read({}) is None
    assert read({"program": {"spans": {"volume.setup": {"total_s": 1.0}}}}) is None
    assert read({"program": {"spans": {"volume.range": {"total_s": 0.002}}}}) == 2.0


@pytest.mark.gpu
def test_the_field_cut_to_uint8_is_not_correct_at_the_cells_size():
    """On the card, at the cell's own size and load: the program within the
    limit, the float32 reference over the field cut to uint8 beyond it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time

    _, cfg, mix = _cell({})
    limit = cfg["limits"]["frame_max_err"]
    seed = 2**31 + 404
    driver = float_scan_loop.make(cfg, mix, seed, "cuda")
    driver.measure(2.0, False, time.perf_counter())
    driver.release()
    ref = driver.reference(torch.float32)
    program = readings(driver, driver.program_outputs(), ref)
    quantised = readings(driver, _quantised_control(driver, cfg, mix, seed), ref)
    print(f"program {program} quantised control {quantised} limit {limit}")
    assert program["frame_max_err"] <= limit < quantised["frame_max_err"]
