"""A configuration, a cell, a traffic mix and a metric are found by name:
adding one takes new files and BENCHMARK.json entries, no edit of the
harness."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

from benchmark.run import ROOT, cell_metrics, load_spec, read_metrics, resolve


def test_new_files_are_found_without_an_edit(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    cfg = json.loads((bench / "configs" / "bonsai256-exact-1024.json").read_text())
    cfg["width"] = cfg["height"] = 512
    (bench / "configs" / "bonsai256-exact-512.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "overview-orbit.json").read_text())
    mix["zoom_lo"], mix["zoom_hi"] = 3.0, 4.0
    (bench / "traffic" / "far-orbit.json").write_text(json.dumps(mix))
    (bench / "metrics" / "frames_done.py").write_text(
        "def read(rec):\n    return len(rec['stamps']) - 1\n")
    spec = load_spec(tmp_path)
    spec["configs"].append({"name": "bonsai256-exact-512", "source": "https://example.org",
                            "file": "benchmark/configs/bonsai256-exact-512.json",
                            "reduced": [], "why": "a smaller window"})
    spec["workloads"].append({"name": "bonsai-far", "config": "bonsai256-exact-512",
                              "traffic": "far-orbit", "chips": 1, "why": "a far orbit"})
    spec["per_layer"].append({"name": "frames_done", "unit": "frames", "better": "higher",
                              "source": "host_clock", "layer": "frame loop",
                              "moves": "frame_ms", "workloads": ["bonsai-far"]})
    spec["end_to_end"][0]["workloads"].append("bonsai-far")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    spec = load_spec(tmp_path)
    cell, cfg, mix = resolve(spec, "bonsai-far", tmp_path)
    assert (cfg["width"], mix["zoom_lo"]) == (512, 3.0)
    assert "frames_done" in [m["name"] for m in cell_metrics(spec, "bonsai-far", True)]
    rec = {"unit": "frame", "stamps": [0.0, 0.5, 1.0, 1.5], "setup_s": 2.0}
    assert read_metrics(spec, "bonsai-far", True, rec, tmp_path) == {
        "frames_done": {"value": 3, "unit": "frames"}}
    e2e = read_metrics(spec, "bonsai-far", False, rec, tmp_path)
    assert e2e["frame_ms"]["value"] == 500.0 and e2e["setup_s"]["value"] == 2.0


# a driver that only adds a file: the bonsai loop about another point, at
# its own CPU test size
LOW_TARGET_DRIVER = '''"""The bonsai frame loop about a point below the box's centre."""

from benchmark.drivers.frame_loop import CONTROL_SIZE, BonsaiLoop  # noqa: F401

TINY = {"width": 40, "height": 24, "dims": 32}


class LowTargetLoop(BonsaiLoop):
    target = (0.5, 0.45, 0.5)


def make(cfg, mix, seed, device="cuda"):
    return LowTargetLoop(cfg, mix, seed, device)
'''


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_of_a_new_driver_runs_the_shared_tests(tmp_path):
    """A cell whose configuration names a new driver passes the shared
    reference, spec and traffic tests with new files and BENCHMARK.json
    entries alone."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    bench, cell = tmp_path / "benchmark", "bonsai-low-orbit"
    (bench / "drivers" / "low_target_loop.py").write_text(LOW_TARGET_DRIVER)
    cfg = json.loads((bench / "configs" / "bonsai256-exact-1024.json").read_text())
    cfg["entry"] = "low_target_loop"
    (bench / "configs" / "bonsai256-low-target.json").write_text(json.dumps(cfg))
    spec = load_spec(tmp_path)
    spec["configs"].append({"name": "bonsai256-low-target", "source": "https://example.org",
                            "file": "benchmark/configs/bonsai256-low-target.json",
                            "reduced": [], "why": "the orbit about a lower point"})
    spec["workloads"].append({"name": cell, "config": "bonsai256-low-target",
                              "traffic": "overview-orbit", "chips": 1, "why": "a lower orbit"})
    for m in spec["end_to_end"] + spec["per_layer"]:  # the metrics of the frame cells
        if "bonsai-orbit" in m.get("workloads", []):
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    # the copy's benchmark first on the path, the repository's port after it
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1",
               PYTHONPATH=os.pathsep.join([str(tmp_path), str(ROOT)]))
    tests = [f"benchmark/tests/test_benchmark_{t}.py" for t in ("reference", "spec", "traffic")]
    out = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                          "-k", cell, "-m", "not gpu", *tests], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    # the program and the control against the reference, the cell's files, and
    # its traffic twice
    assert re.search(r"\b5 passed\b", out.stdout), out.stdout[-2000:]

    after = _digests(tmp_path)
    assert set(after) - set(before) == {"benchmark/drivers/low_target_loop.py",
                                        "benchmark/configs/bonsai256-low-target.json"}
    changed = {k for k in before if after.get(k) != before[k]}
    assert changed == {"BENCHMARK.json"}


def test_a_metric_without_a_workloads_list_goes_with_what_it_moves():
    spec = load_spec()
    spec["per_layer"].append({"name": "loop_share", "unit": "%", "better": "lower",
                              "source": "host_clock", "layer": "frame loop",
                              "moves": "setup_s"})
    for cell in spec["workloads"]:  # setup_s is every cell's
        assert "loop_share" in [m["name"] for m in cell_metrics(spec, cell["name"], True)]
    spec["per_layer"][-1]["moves"] = "mrays_per_s"
    names = {c["name"]: [m["name"] for m in cell_metrics(spec, c["name"], True)]
             for c in spec["workloads"]}
    assert "loop_share" in names["views512-b64"] and "loop_share" not in names["bonsai-orbit"]


def test_a_reader_that_finds_nothing_leaves_its_metric_out():
    spec = load_spec()
    rec = {"unit": "batch", "stamps": [0.0, 1.0], "setup_s": 1.0, "rays_per_unit": 2e6}
    # a batch record has no profile: every per-layer reader returns nothing
    assert read_metrics(spec, "views512-b64", True, rec) == {}
    assert read_metrics(spec, "views512-b64", False, rec)["mrays_per_s"]["value"] == 2.0


class _Event:
    def __init__(self, name, device, start, end):
        from torch.autograd import DeviceType

        self.name = name
        self.device_type = DeviceType.CUDA if device else DeviceType.CPU
        self.time_range = type("R", (), {"start": start, "end": end})()


def test_profile_window_reads_device_time_and_idle_gaps():
    from benchmark.reduce import kernel, profile_window

    events = [_Event("bench.window", False, 100.0, 200.0),
              _Event("bench.window", True, 100.0, 200.0),  # the device's mirror of the span
              _Event("demo.render", False, 100.0, 130.0),
              _Event("demo.render", True, 110.0, 160.0),
              _Event("(anonymous namespace)::march_bonsai_kernel(unsigned char const*)", True,
                     120.0, 150.0),
              _Event("Memcpy DtoD (Device -> Device)", True, 140.0, 170.0),
              _Event("march_bonsai_kernel", True, 190.0, 260.0),  # cut at the window's end
              _Event("ctx.render", False, 175.0, 185.0)]
    prof = profile_window(events)
    assert abs(prof["window_s"] - 100e-6) < 1e-12
    assert abs(prof["busy_s"] - 60e-6) < 1e-12  # 120-170 and 190-200
    assert kernel(prof, "march_bonsai_kernel")[1] == 2
    assert abs(kernel(prof, "march_bonsai_kernel")[0] - 40e-6) < 1e-12
    gaps = prof["gaps"]  # 100-120 (demo.render), 170-190 (ctx.render 10, loop 10)
    assert abs(gaps["demo.render"] - 20e-6) < 1e-12 and abs(gaps["ctx.render"] - 10e-6) < 1e-12
    assert abs(gaps["loop"] - 10e-6) < 1e-12
    assert profile_window(events[2:]) is None
