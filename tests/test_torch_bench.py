"""The port's benchmark harness (vokselis_torch/bench.py) against bench.py,
and the compiled field frame (march_field.FieldRenderer) it times configs 1
and 2 through.

bench.py's own functions are the reference: its ``main`` with its ``bench_*``
functions stubbed by fixed numbers (and ``jax.default_backend`` reading
"tpu", so that it takes its TPU branch) prints the JSON line that the
port's ``flagship_line``, and the port's ``main`` on the same stubs, must
give, apart from the metric's name; its ``slope_time`` and the port's take
the same seconds from one fake clock; its ``_load_oppoint`` gives the
port's ``load_oppoint``; the JAX package's ``pose_hint`` decides config 4's
gate as the port's does. Each ``bench_*`` function then runs on the CPU at a
small size (a 64^3 volume, 64^2 frames, I=64; ``slope_time`` with one
repeat) through the plain versions. The compiled field frame is
``render_field`` bitwise on the CPU and within test_torch_march_field.py's
bounds of the JAX package's ``render_field_pallas`` in interpret mode.

Tests marked ``gpu`` need a CUDA card and skip without one: the compiled
field frame's replays bitwise its eager frame, and ``main()`` printing one
JSON line. On the card: ``python -m pytest tests/test_torch_bench.py
--noconftest -m gpu``.
"""

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vokselis_torch import bench as port_bench
from vokselis_torch.core.camera import Camera, CameraUniform
from vokselis_torch.ops.cuda import march_field as mf
from vokselis_torch.ops.cuda.march_bonsai import BonsaiRenderer
from vokselis_torch.ops.hybrid import HybridBonsaiRenderer
from vokselis_torch.ops.shear_warp import pose_hint
from vokselis_torch.parallel.sharding import orbit_cameras
from vokselis_torch.volume.io import get_bonsai

ROOT = Path(__file__).resolve().parent.parent
SIZE = 64
# (field, shading, quantize) of bench.py's configs 1 and 2 (bench.py:441-448)
FIELD_CASES = {"trig-emission": ("trig", "emission", False), "noise-xor": ("noise", "xor", True)}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread (test_torch_hybrid.py:42-50)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def jax_bench():
    """The repository's bench.py, loaded from its file."""
    pytest.importorskip("jax")
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def one_repeat(monkeypatch):
    """The port's slope_time with one repeat, for the small CPU runs."""
    orig = port_bench.slope_time
    monkeypatch.setattr(port_bench, "slope_time",
                        lambda build, n_hi=5, repeats=5: orig(build, n_hi, 1))


@pytest.fixture(scope="module")
def vol64():
    return get_bonsai(SIZE)


# -- the JSON line -------------------------------------------------------------------------

MRAYS, SEC = 812.3456789, 0.00129087654
FAST = (1498.76543, 0.000699876)
MEAN_ERR = 2.3456789012e-7
CASES = {
    "hybrid-headlines": (dict(herr=5.43210987e-4), []),
    "hybrid-over-contract": (dict(herr=1.7654321e-3), []),
    "skip-err": (dict(herr=5.43210987e-4), ["--skip-err"]),
}


def _hyb(herr):
    return (520.9876543, 0.00201234567, herr, 64)


def _stub(module, monkeypatch, hyb):
    monkeypatch.setattr(module, "bench_bonsai", lambda **kw: (MRAYS, SEC))
    monkeypatch.setattr(module, "bench_bonsai_fast", lambda **kw: FAST)
    monkeypatch.setattr(module, "bench_bonsai_hybrid", lambda **kw: hyb)
    monkeypatch.setattr(module, "measure_flagship_err", lambda **kw: MEAN_ERR)


def _bench_py_line(jax_bench, monkeypatch, capsys, hyb, argv):
    import jax

    _stub(jax_bench, monkeypatch, hyb)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    capsys.readouterr()
    jax_bench.main()
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    return json.loads(out[0])


def _without_metric(line):
    return {k: v for k, v in line.items() if k != "metric"}


@pytest.mark.parametrize("case", list(CASES))
def test_flagship_line_matches_bench_main(case, jax_bench, monkeypatch, capsys):
    """flagship_line on bench.py's numbers gives bench.py's line: the same
    keys, values and rounding, the hybrid headlining only within 1e-3."""
    kw, argv = CASES[case]
    hyb = _hyb(kw["herr"])
    want = _bench_py_line(jax_bench, monkeypatch, capsys, hyb, argv)
    got = port_bench.flagship_line({"bonsai_1024": (MRAYS, SEC)}, hyb,
                                   None if "--skip-err" in argv else MEAN_ERR)
    assert list(got) == list(want)
    assert _without_metric(got) == _without_metric(want)
    headline = "hybrid" in got["metric"]
    assert headline == (kw["herr"] <= 1e-3) == ("exact_mrays" in got)
    assert "CUDA, sm_90a" in got["metric"]


@pytest.mark.parametrize("case", list(CASES))
def test_port_main_prints_bench_main_line(case, jax_bench, monkeypatch, capsys):
    """The port's main on the same stubs prints one stdout line, bench.py's
    line apart from the metric's name, and names the card first on
    stderr."""
    kw, argv = CASES[case]
    hyb = _hyb(kw["herr"])
    want = _bench_py_line(jax_bench, monkeypatch, capsys, hyb, argv)
    _stub(port_bench, monkeypatch, hyb)
    monkeypatch.setattr(port_bench.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(port_bench, "card_line", lambda device: "STUB CARD 700.00 W")
    assert port_bench.main(argv) == 0
    captured = capsys.readouterr()
    out = captured.out.strip().splitlines()
    assert len(out) == 1
    assert _without_metric(json.loads(out[0])) == _without_metric(want)
    assert captured.err.splitlines()[0] == "device: STUB CARD 700.00 W"


def test_cpu_oracle_runs_config_3_only(monkeypatch, capsys):
    """--cpu-oracle: the oracle's config-3 row on the CPU and no other,
    mean_err 0.0 (bench.py:469-470), the metric naming the oracle."""
    calls = []
    monkeypatch.setattr(port_bench, "bench_bonsai",
                        lambda **kw: calls.append(kw) or (MRAYS, SEC))
    for name in ("bench_bonsai_fast", "bench_bonsai_hybrid", "measure_flagship_err",
                 "bench_field", "bench_bonsai_orbit", "bench_views_512"):
        monkeypatch.setattr(port_bench, name, lambda **kw: pytest.fail("ran another row"))
    assert port_bench.main(["--cpu-oracle", "--all"]) == 0
    line = json.loads(capsys.readouterr().out)
    assert calls == [dict(use_oracle=True, device=torch.device("cpu"))]
    assert line["mean_err"] == 0.0 and line["value"] == round(MRAYS, 2)
    assert "oracle on the CPU" in line["metric"]


def test_bench_refuses_without_cuda():
    """python -m vokselis_torch.bench without a card exits non-zero, names
    the missing card and prints nothing on stdout."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "vokselis_torch.bench"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA card" in proc.stderr


# -- timing and the operating point --------------------------------------------------------

class FakeClock:
    """A clock that only frames advance: frame n of a run costs c_k + n d,
    c_k the k-th of a fixed sequence of overheads."""

    def __init__(self, overheads, delta):
        self.now, self.k = 1000.0, 0
        self.overheads, self.delta = overheads, delta

    def run(self, n):
        def frames():
            self.now += self.overheads[self.k % len(self.overheads)] + n * self.delta
            self.k += 1
            return 0.0
        return frames


def test_slope_time_matches_bench(jax_bench, monkeypatch):
    """Both slope_times warm each callable twice, take 5 slopes and return
    their median, on the same clock."""
    overheads = list(np.random.default_rng(3).uniform(0.0, 0.004, size=14))
    got = {}
    for name, mod, attr in (("jax", jax_bench, "time"), ("port", port_bench, "perf_counter")):
        clock = FakeClock(overheads, 0.00123)
        monkeypatch.setattr(mod, "time", SimpleNamespace(**{attr: lambda c=clock: c.now}))
        got[name] = mod.slope_time(clock.run)
        assert clock.k == 14
    assert got["port"] == got["jax"]
    assert got["port"] != 0.00123  # the overheads vary: the median matters


def test_load_oppoint_matches_bench(jax_bench):
    op = port_bench.load_oppoint()
    assert op == jax_bench._load_oppoint()
    assert op["budget"] == 64 and op["ii"] == 1024


@pytest.mark.parametrize("text", [None, "{not json", "[1, 2]", '{"operating_point": [1]}'])
def test_load_oppoint_missing_or_invalid(text, tmp_path, monkeypatch):
    """No file, or one that is not a JSON object with an object inside: {}."""
    if text is not None:
        (tmp_path / "OPPOINT.json").write_text(text)
    monkeypatch.setattr(port_bench, "ROOT", tmp_path)
    assert port_bench.load_oppoint() == {}


def test_orbit_gate_matches_jax():
    """Config 4's gate (bench.py:281-286): at 1920x1080, I=1024, the 256^3
    bonsai, the poses JAX's pose_hint marks degenerate are the port's, 1, 3,
    5 and 7: exact only."""
    pytest.importorskip("jax")
    from vokselis_tpu.core.camera import Camera as JaxCamera
    from vokselis_tpu.ops.shear_warp import pose_hint as jax_pose_hint

    w, h, ii = 1920, 1080, 1024
    want = [i for i in range(8)
            if jax_pose_hint(JaxCamera(zoom=1.0, pitch=0.5, yaw=2.0 * math.pi * i / 8,
                                       target=(0.5, 0.5, 0.5), aspect=w / h).uniform(),
                             w, h, ii, 256)[2]]
    poses = [c.uniform("cpu") for c in orbit_cameras(8, aspect=w / h)]
    assert port_bench.degenerate_poses(poses, w, h, ii, 256) == want == [1, 3, 5, 7]


# -- each bench_* function on the CPU at a small size --------------------------------------

def _positive(mrays, sec):
    assert math.isfinite(mrays) and math.isfinite(sec) and mrays > 0 and sec > 0


@pytest.mark.parametrize("oracle", [False, True], ids=["kernel-route", "oracle"])
def test_bench_bonsai_on_cpu(oracle, one_repeat, vol64):
    _positive(*port_bench.bench_bonsai(SIZE, SIZE, use_oracle=oracle, vol=vol64, device="cpu"))


def test_bench_bonsai_dense_volume_on_cpu(one_repeat):
    """The dense-stress row's call: bench_bonsai on another volume."""
    from vokselis_torch.volume.io import dense_stress

    _positive(*port_bench.bench_bonsai(SIZE, SIZE, vol=dense_stress(32), device="cpu"))


def test_bench_field_on_cpu(one_repeat):
    """Config 1's row (the trig field); the noise field's plain march takes
    ~0.4 s a frame here, and its compiled frame is held below."""
    _positive(*port_bench.bench_field(SIZE, SIZE, field="trig", shading="emission",
                                      quantize=False, device="cpu"))


def test_bench_bonsai_fast_on_cpu(one_repeat, vol64):
    _positive(*port_bench.bench_bonsai_fast(SIZE, SIZE, intermediate=SIZE, vol=vol64,
                                            device="cpu"))


def test_bench_bonsai_hybrid_on_cpu(one_repeat, vol64, monkeypatch):
    """The operating point from VOK_HYBRID_BUDGET / VOK_HYBRID_II over
    OPPOINT.json's; the returned error is the mean |hybrid - exact| over rgb
    at the bench pose, computed here directly."""
    monkeypatch.setenv("VOK_HYBRID_BUDGET", "2")
    monkeypatch.setenv("VOK_HYBRID_II", str(SIZE))
    mrays, sec, err, budget = port_bench.bench_bonsai_hybrid(SIZE, SIZE, vol=vol64,
                                                             device="cpu")
    _positive(mrays, sec)
    assert budget == 2
    u0 = Camera.bonsai(1.0).uniform("cpu")
    hyb = HybridBonsaiRenderer(vol64, "cpu", intermediate=SIZE, budget=2)
    img = hyb._call_traced(u0, SIZE, SIZE, hint=pose_hint(u0, SIZE, SIZE, SIZE, SIZE))
    exact = BonsaiRenderer(vol64, "cpu")(u0, SIZE, SIZE)
    assert err == float((img[..., :3] - exact[..., :3]).abs().mean()) > 0.0


@pytest.mark.parametrize("n_poses", [8, 4])
def test_bench_bonsai_orbit_on_cpu(n_poses, one_repeat, monkeypatch, capsys):
    """Config 4 at 64x36 on the 32^3 bonsai, I=32 (OPPOINT.json's budget 4,
    doubled): the 8-pose orbit has degenerate poses (1, 3, 5, 7) and times
    the exact frame only, saying so; the 4 axis-aligned poses pass the gate
    and the hybrid is timed, its worst pose within 1e-3."""
    monkeypatch.setattr(port_bench, "load_oppoint", lambda: {"ii": 32, "budget": 4})
    mrays, sec, hyb = port_bench.bench_bonsai_orbit(SIZE, 36, n_poses=n_poses,
                                                    vol=get_bonsai(32), device="cpu")
    _positive(mrays, sec)
    if n_poses == 8:
        assert hyb is None
        assert "degenerate orbit pose — exact only" in capsys.readouterr().err
    else:
        hm, hs, err, budget = hyb
        _positive(hm, hs)
        assert budget == 8 and err <= 1e-3


def test_bench_views_on_cpu(one_repeat):
    _positive(*port_bench.bench_views_512(n_views=2, view_res=32, device="cpu"))


def test_measure_flagship_err_on_cpu(vol64):
    """The plain route against the oracle: the same march, within the exact
    contract's 1e-5 mean."""
    err = port_bench.measure_flagship_err(SIZE, SIZE, vol=vol64, device="cpu")
    assert math.isfinite(err) and 0.0 <= err <= 1e-5


# -- the compiled field frame --------------------------------------------------------------

@pytest.fixture
def jax_march_field():
    """The JAX package's march_field module with every pallas_call in
    interpret mode (test_pallas.py:16-38), reloaded back afterwards."""
    pytest.importorskip("jax")
    import jax.experimental.pallas as pl

    name = "vokselis_tpu.ops.pallas.march_field"
    orig = pl.pallas_call
    pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        yield importlib.reload(importlib.import_module(name))
    finally:
        pl.pallas_call = orig
        importlib.reload(importlib.import_module(name))


@pytest.mark.parametrize("case", list(FIELD_CASES))
def test_field_renderer_is_render_field_and_matches_jax(case, jax_march_field):
    """FieldRenderer on the CPU is render_field bitwise at t = 0 and 1.7, one
    key for both times; the frame is within test_torch_march_field.py:95-119's
    bounds (mean 1e-5, 99th percentile 1e-3) of render_field_pallas in
    interpret mode on the same uniform."""
    field, shading, quantize = FIELD_CASES[case]
    from vokselis_tpu.core.camera import Camera as JaxCamera

    ju = JaxCamera.xor(1.0).uniform()
    u = CameraUniform.from_numpy(np.asarray(ju.view_position), np.asarray(ju.proj_view),
                                 np.asarray(ju.inv_proj), "cpu")
    r = mf.FieldRenderer("cpu")
    kw = dict(field=field, shading=shading, quantize=quantize, grad="analytic")
    frames = [r(u, t, SIZE, SIZE, **kw) for t in (0.0, 1.7)]
    for t, img in zip((0.0, 1.7), frames):
        assert torch.equal(img, mf.render_field(u, t, SIZE, SIZE, **kw))
    assert r.compiled.captures == 1
    ref = np.asarray(jax_march_field.render_field_pallas(ju, 1.7, SIZE, SIZE, tile_h=16,
                                                         tile_w=128, **kw))
    d = np.abs(frames[1].numpy() - ref)
    assert d.mean() <= 1e-5 and np.quantile(d, 0.99) <= 1e-3, (d.mean(), np.quantile(d, 0.99))


def test_field_renderer_keys(monkeypatch):
    """The key is JAX's static arguments less tile_w and interpret: a new pose
    or time reuses it; a new width, field, tile_h or grad (VOK_XOR_GRAD when
    unset) makes one. A uniform on another device type raises."""
    r = mf.FieldRenderer("cpu")
    kw = dict(max_steps=4)
    u1, u2 = (Camera(zoom=3.0, pitch=-0.5, yaw=y, target=(0.0, 0.0, 0.0),
                     aspect=1.0).uniform("cpu") for y in (1.0, 2.0))
    r(u1, 0.0, 16, 16, **kw)
    r(u2, 1.0, 16, 16, **kw)
    assert r.compiled.captures == 1
    r(u1, 0.0, 24, 16, **kw)
    r(u1, 0.0, 16, 16, field="trig", shading="emission", quantize=False, **kw)
    r(u1, 0.0, 16, 16, tile_h=16, **kw)
    monkeypatch.setenv("VOK_XOR_GRAD", "fd")
    r(u1, 0.0, 16, 16, **kw)
    r(u1, 0.0, 16, 16, grad="fd", **kw)
    assert r.compiled.captures == 5
    assert {k[0][-1] for k in r.compiled.keys()} == {"analytic", "fd"}
    with pytest.raises(ValueError, match="FieldRenderer"):
        mf.FieldRenderer("cuda")(u1, 0.0, 16, 16)


# -- on the card -------------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("case", list(FIELD_CASES))
def test_field_renderer_replays_are_eager_on_gpu(case, cuda_device):
    """On the card every replay (three poses x t = 0, 1.7) is bitwise
    render_field's eager frame, from one capture."""
    field, shading, quantize = FIELD_CASES[case]
    r = mf.FieldRenderer(cuda_device)
    kw = dict(field=field, shading=shading, quantize=quantize)
    poses = [Camera(zoom=3.0, pitch=-0.5, yaw=y, target=(0.0, 0.0, 0.0),
                    aspect=1.0).uniform(cuda_device) for y in (1.0, 2.0, 4.0)]
    r(poses[0], 0.0, 512, 512, **kw)
    for u in poses:
        for t in (0.0, 1.7):
            assert torch.equal(r(u, t, 512, 512, **kw), mf.render_field(u, t, 512, 512, **kw))
    assert r.compiled.captures == 1


@pytest.mark.gpu
def test_main_prints_one_line_on_gpu(cuda_device, capsys):
    """main() with its default rows prints exactly one JSON line with
    bench.py's keys for the branch it takes."""
    assert port_bench.main([]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["mean_err"] <= 1e-3
    assert all(math.isfinite(v) and v > 0 for k, v in line.items() if k.endswith("_ms"))
