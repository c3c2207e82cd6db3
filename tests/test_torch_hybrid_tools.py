"""The port's hybrid measuring tools (vokselis_torch/tools/:
hybrid_operating_point, fit_budget_slope, residual_decay,
fast_error_report, dense_stress_probe, kernel_bench, contact_sheet) against
the JAX package's tools/ counterparts, on the CPU at small sizes (a 64^3
bonsai, 128^2 frames, I in {64, 128}, budgets {0, 4, 8}, one timing repeat
of a 2-frame slope): each tool's ``main(["--device", "cpu", ...])`` end to
end with its outputs under ``tmp_path``; the operating point's JSON keys
against the committed OPPOINT.json; the choice rule and the fit on
hand-built ladders and on OPPOINT.json's; ``fit_budget_slope``'s lines
against the JAX tool's, run on the same checkpoint; the decay dumps as
tools/score_lab.py reads them and the actual curve's picks as the hybrid's
own ``select_units``; the fast-error rows against the JAX package's
``_render_fast`` (XLA branch) and oracle; the recorded probe errors against
direct calls, and the hybrid's 1e-3 contract in both packages; and that no
tool runs on the CPU unless asked.

Tests marked ``gpu`` need a CUDA card and skip without one: the operating
point's bench-pose error at (1024, 64) bitwise the bench's, and the decay
tool's frames from K5 / K6 against their plain versions. On the card:
``python -m pytest tests/test_torch_hybrid_tools.py --noconftest -m gpu``.
"""

import contextlib
import importlib.util
import io
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vokselis_torch import bench as port_bench
from vokselis_torch.core.camera import CameraUniform
from vokselis_torch.media.png import read_png
from vokselis_torch.ops import hybrid as hy
from vokselis_torch.ops.cuda.march_bonsai import build_renderer
from vokselis_torch.ops.shear_warp import _render_fast, prepare_fast_volume
from vokselis_torch.tools import (
    contact_sheet,
    dense_stress_probe,
    fast_error_report,
    fit_budget_slope,
    hybrid_operating_point as hop,
    kernel_bench,
    residual_decay,
)
from vokselis_torch.tools.common import mean_rgb_err
from vokselis_torch.volume.io import get_bonsai

ROOT = Path(__file__).resolve().parent.parent
SIZE, DIMS, II = 128, 64, 128
BUDGETS = (0, 4, 8)
CONTRACT = 1e-3
# the fast frames of the two packages differ by bf16 rounding of the JAX
# XLA branch's resample weights (test_torch_fast.py: ~5e-5 mean): the
# poses' mean errors against each package's own exact frame agree to this
FAST_MEAN_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread (the plain versions run many small torch ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def short_slope():
    """The port's slope_time with a 2-frame slope and one repeat, and one
    repeat of each ladder budget: the small CPU runs' timing."""
    orig = port_bench.slope_time
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_bench, "slope_time", lambda build, n_hi=5, repeats=5: orig(build, 2, 1))
        mp.setenv("VOK_OPPOINT_REPEATS", "1")
        yield


def run_main(main, argv):
    """``main(argv)``'s exit code and stdout."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def oppoint(tmp_path_factory):
    """hybrid_operating_point's main on the CPU: (result, stdout, out_dir)."""
    out_dir = tmp_path_factory.mktemp("oppoint")
    with short_slope():
        rc, out = run_main(hop.main, [
            "--device", "cpu", "--size", str(SIZE), "--dims", str(DIMS), "--ii", str(II),
            "--budgets", ",".join(map(str, BUDGETS)), "--out", str(out_dir / "op.json"),
            "--out-dir", str(out_dir)])
    assert rc == 0
    with open(out_dir / "op.json") as f:
        return json.load(f), out, out_dir


@pytest.fixture(scope="module")
def committed():
    with open(ROOT / "OPPOINT.json") as f:
        return json.load(f)


# -- hybrid_operating_point ------------------------------------------------------------------

def test_operating_point_main_cpu(oppoint):
    """The ladder at budgets 0, 4, 8: a record each, checkpointed, every ms
    finite and > 0, every probe pose's error finite; the fit over the
    budgets > 0; the last stdout line the written JSON; the copy under the
    output directory; the device named."""
    res, out, out_dir = oppoint
    assert json.loads(out.strip().splitlines()[-1]) == res
    assert res["card"] == "cpu (no card)"
    assert [r["budget"] for r in res["ladder"]] == list(BUDGETS)
    for r in res["ladder"]:
        assert r["ii"] == II and math.isfinite(r["ms"]) and r["ms"] > 0
        assert list(r["errs"]) == list(hop.probe_poses())
        assert all(math.isfinite(e) for e in r["errs"].values())
    # a re-march budget removes error where the fast frame has it
    assert max(res["ladder"][2]["errs"].values()) < max(res["ladder"][0]["errs"].values())
    assert res["fit"]["n_fit_points"] == 2 and res["fit"]["pure_fast_ms"] == res["ladder"][0]["ms"]
    assert res["drift_sentinel"]["budget"] == 0
    with open(out_dir / f"hybrid_oppoint_{II}.jsonl") as f:
        assert [json.loads(x) for x in f] == res["ladder"]
    with open(out_dir / f"oppoint_{II}.json") as f:
        assert json.load(f) == res


def test_operating_point_resumes(oppoint, tmp_path):
    """A rerun on the same checkpoint measures nothing again: every budget
    cached, the same ladder, no drift sentinel (nothing was timed)."""
    res, _, out_dir = oppoint
    ckpt = out_dir / f"hybrid_oppoint_{II}.jsonl"
    lines = ckpt.read_text()
    rc, out = run_main(hop.main, [
        "--device", "cpu", "--size", str(SIZE), "--dims", str(DIMS), "--ii", str(II),
        "--budgets", ",".join(map(str, BUDGETS)), "--out", str(tmp_path / "op.json"),
        "--out-dir", str(out_dir)])
    again = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and f"resuming: {len(BUDGETS)} budgets" in out
    assert again["ladder"] == res["ladder"] and again["drift_sentinel"] is None
    assert again["fit"] == res["fit"] and ckpt.read_text() == lines


def test_operating_point_keys_match_committed(oppoint, committed):
    """The JSON's keys are the JAX tool's (tools/hybrid_operating_point.py:
    202-210): the committed OPPOINT.json's and ``drift_sentinel``, which the
    JAX tool writes but the committed file, corrected by hand, lacks; the
    port adds ``card``. A ladder record's keys are the committed ladder's
    (:139-148); the chosen point is a ladder record with ``conjunction``."""
    res, _, _ = oppoint
    assert list(res) == ["operating_point", "fit", "drift_sentinel", "ladder", "note", "card"]
    assert set(res) == set(committed) | {"drift_sentinel", "card"}
    assert list(res["ladder"][0]) == list(committed["ladder"][0])
    assert list(res["fit"]) == list(committed["fit"])
    assert set(committed["operating_point"]) >= set(committed["ladder"][0]) - {"wall_s"}
    if res["operating_point"] is not None:
        assert list(res["operating_point"]) == list(res["ladder"][0]) + ["conjunction"]


def _rec(budget, mrays, err):
    return {"budget": budget, "ii": 1024, "ms": round(1048.576 / mrays, 3), "mrays": mrays,
            "errs": {"bench": err, "z1.0-axis": err / 2}}


@pytest.mark.parametrize("case", ["conjunction", "no_conjunction", "none_clears"])
def test_choose_operating_point_rules(case):
    """The JAX rule (tools/hybrid_operating_point.py:170-186) on hand-built
    ladders: the largest budget in the conjunction (errors <= 8e-4 at >= 500
    Mrays/s); without one, the fastest budget > 0 within 1e-3 (budget 0,
    the pure fast frame, never); no budget within 1e-3: None."""
    ladders = {
        "conjunction": ([_rec(0, 900.0, 2e-3), _rec(16, 700.0, 7e-4), _rec(32, 600.0, 5e-4),
                         _rec(64, 450.0, 3e-4)], 32, True),
        "no_conjunction": ([_rec(0, 900.0, 9e-4), _rec(16, 480.0, 9e-4), _rec(32, 460.0, 5e-4),
                            _rec(64, 300.0, 2e-4)], 16, False),
        "none_clears": ([_rec(0, 900.0, 3e-3), _rec(16, 700.0, 2e-3)], None, False),
    }
    ladder, want, want_conj = ladders[case]
    chosen, conj = hop.choose_operating_point(ladder)
    assert conj is want_conj
    if want is None:
        assert chosen is None and hop.note_of(chosen, conj).startswith("NO budget")
    else:
        assert chosen == dict(next(r for r in ladder if r["budget"] == want),
                              conjunction=want_conj)


def test_choose_on_committed_ladder(committed):
    """On the committed TPU ladder the JAX rule picks budget 32 (the fastest
    within 1e-3 on its probe poses; no 500-Mrays/s conjunction there).
    OPPOINT.json's 64 is the hand correction after the 72-pose sweep failed
    8 poses at 32, which its note records: the rule does not give it."""
    chosen, conj = hop.choose_operating_point(committed["ladder"])
    assert chosen["budget"] == 32 and conj is False and chosen["conjunction"] is False
    assert hop.note_of(chosen, conj) == committed["note"]
    assert committed["operating_point"]["budget"] == 64
    assert "corrected from budget 32" in committed["operating_point"]["note"]


def test_fit_ladder_on_committed_ladder(committed):
    """fit_ladder over the committed ladder's 18 repeats of budgets > 0 is
    np.polyfit's (intercept 5.043 ms, slope 0.05201 ms/tile, rms residual
    0.294). The committed ``fit`` (4.848, 0.06263, 15 points) came from
    another ladder than the one committed beside it, so it is not matched."""
    fit = hop.fit_ladder(committed["ladder"])
    pts = [(r["budget"], m) for r in committed["ladder"] if r["budget"] > 0
           for m in r["ms_reps"]]
    b, ms = np.array(pts, np.float64).T
    slope, intercept = np.polyfit(b, ms, 1)
    assert len(pts) == 18 and fit["n_fit_points"] == 18
    assert fit["intercept_ms"] == round(intercept, 3) == 5.043
    assert fit["slope_ms_per_tile"] == round(slope, 5) == 0.05201
    assert fit["fit_rms_resid_ms"] == 0.294
    assert fit["pure_fast_ms"] == 4.92
    assert (committed["fit"]["intercept_ms"], committed["fit"]["n_fit_points"]) == (4.848, 15)


# -- fit_budget_slope ------------------------------------------------------------------------

# tools/fit_budget_slope.py reads the fixed path /tmp/hybrid_oppoint_<ii>.jsonl:
# the subprocess runs it with that one path mapped to the test's copy
_JAX_FIT = """
import builtins, os, runpy, sys
want, path = sys.argv[1], sys.argv[2]
_open, _exists = builtins.open, os.path.exists
builtins.open = lambda p, *a, **k: _open(path if p == want else p, *a, **k)
os.path.exists = lambda p: _exists(path if p == want else p)
sys.argv = [sys.argv[3]] + sys.argv[4:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def test_fit_budget_slope_matches_jax_tool(oppoint):
    """The port's fit of the fixture's checkpoint prints the JAX tool's
    lines, run on the same checkpoint with the fast frame's ms it takes by
    default here (the budget-0 ms): the per-budget fit, the intercept, the
    scoring tax, µs per tile and the budget at 500 Mrays/s."""
    res, _, out_dir = oppoint
    rc, port_out = run_main(fit_budget_slope.main, ["--ii", str(II), "--out-dir", str(out_dir)])
    assert rc == 0
    fast_ms = res["ladder"][0]["ms"]
    jax_ii = 90001  # an intermediate no real ladder has: the mapped path is unique to this test
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_FIT, f"/tmp/hybrid_oppoint_{jax_ii}.jsonl",
         str(out_dir / f"hybrid_oppoint_{II}.jsonl"), str(ROOT / "tools" / "fit_budget_slope.py"),
         str(jax_ii), str(fast_ms)], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    want = proc.stdout.replace(f"I={jax_ii}:", f"I={II}:")
    assert port_out == want
    b = np.array(BUDGETS, float)
    ms = np.array([r["ms"] for r in res["ladder"]])
    slope, intercept = np.polyfit(b, ms, 1)
    assert f"intercept          = {intercept:.3f} ms" in port_out
    assert f"slope (re-march)   = {slope * 1000:.2f} us/tile" in port_out


def test_fit_budget_slope_needs_a_checkpoint(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoints"):
        fit_budget_slope.main(["--ii", "64", "--out-dir", str(tmp_path)])


# -- residual_decay --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decay(tmp_path_factory):
    """residual_decay's main on the CPU: (records, out_dir)."""
    out_dir = tmp_path_factory.mktemp("decay")
    rc, out = run_main(residual_decay.main, [
        "--device", "cpu", "--size", str(SIZE), "--dims", str(DIMS), "--ii", str(II),
        "--budgets", ",".join(map(str, BUDGETS)), "--out-dir", str(out_dir)])
    assert rc == 0 and f"residual_decay_{II}.json" in out
    with open(out_dir / f"residual_decay_{II}.json") as f:
        return json.load(f), out_dir


def _score_lab():
    spec = importlib.util.spec_from_file_location("score_lab", ROOT / "tools" / "score_lab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_residual_decay_dumps_read_by_score_lab(decay):
    """Each pose's dump holds the keys, dtypes and shapes tools/score_lab.py
    reads (:55, :118-119), and its schemes and budget search run on it."""
    recs, out_dir = decay
    lab = _score_lab()
    n_tiles = (SIZE // 32) ** 2
    shapes = {"per_tile_err": ((n_tiles,), np.float32), "errd": ((SIZE, SIZE), np.float32),
              "bad": ((SIZE, SIZE), np.uint8), "rgb": ((SIZE, SIZE, 3), np.float32),
              "fast_srgb": ((SIZE, SIZE, 3), np.float32), "err_px": ((SIZE, SIZE), np.float32)}
    assert list(recs) == list(residual_decay.decay_poses())
    for pose, rec in recs.items():
        d = np.load(out_dir / f"decay_raw_{pose}_{II}.npz")
        assert sorted(d.files) == sorted(shapes)
        for k, (shape, dtype) in shapes.items():
            assert d[k].shape == shape and d[k].dtype == dtype, k
        assert np.isclose(d["per_tile_err"].mean(), rec["total_fast_err"], rtol=0, atol=1e-9)
        schemes = lab.schemes(d)
        assert all(s.shape == (n_tiles,) and np.isfinite(s).all() for s in schemes.values())
        order = np.argsort(d["per_tile_err"])[::-1]
        half = lab.budget_for(order, d["per_tile_err"], rec["total_fast_err"] / 2, n_tiles)
        assert half is not None and 1 <= half <= n_tiles


@pytest.mark.parametrize("pose", ["bench", "z1.6-diag"])
def test_residual_decay_actual_picks_are_the_hybrids(decay, pose):
    """The actual curve's picks at each budget are the single-tile picks of
    the hybrid's own select_units(score_tiles(stats), ..., pair=False) on
    the pose's "stats" frame, rendered here; each curve point is the total
    less the picked tiles' error, the oracle's <= the actual's, and both
    the total at budget 0."""
    recs, out_dir = decay
    vol = get_bonsai(DIMS)
    u = residual_decay.decay_poses()[pose].uniform("cpu")
    packs = prepare_fast_volume(vol, "cpu")
    render, pack = build_renderer(vol, "cpu")
    rec, _, picks = residual_decay.decay_pose(packs, render, pack, u, SIZE, II, BUDGETS)
    assert rec == recs[pose]
    _, stats = _render_fast(packs, u, SIZE, SIZE, II, False, return_aux="stats")
    ny = nx = SIZE // 32
    scores = hy.score_tiles(stats, ny, nx)
    pte = np.load(out_dir / f"decay_raw_{pose}_{II}.npz")["per_tile_err"]
    total = pte.mean()
    for b, point in zip(BUDGETS, rec["curve"]):
        ids = hy.select_units(scores, ny * nx, b, hy.DEFAULT_THRESH, pair=False)
        assert picks[b].tolist() == sorted(ids[ids < ny * nx].tolist())
        assert np.isclose(point["actual"], total - pte[picks[b]].sum() / (ny * nx),
                          rtol=0, atol=2e-9)
        assert point["oracle"] <= point["actual"]
    assert rec["curve"][0]["oracle"] == rec["curve"][0]["actual"] == rec["total_fast_err"]
    assert len(picks[8]) >= len(picks[4]) > 0 and set(picks[4]) <= set(picks[8])


# -- fast_error_report -----------------------------------------------------------------------

def test_fast_error_report_main_cpu():
    """Both tables, headed by the device: 2 intermediates x 4 poses of
    errors, then a time per intermediate."""
    with short_slope():
        rc, out = run_main(fast_error_report.main, [
            "--device", "cpu", "--size", str(SIZE), "--dims", str(DIMS), "--ii", "64,128"])
    lines = out.splitlines()
    assert rc == 0 and lines[0] == f"# fast-mode error/speed report @ {SIZE}x{SIZE}, cpu (no card)"
    err_rows = [ln for ln in lines if re.match(r"\| (64|128) \| [a-z0-9]+ \| ", ln)]
    time_rows = [ln for ln in lines if re.match(r"\| (64|128) \| [0-9.]+ \| [0-9]+ \|$", ln)]
    assert len(err_rows) == 8 and len(time_rows) == 2


def test_fast_error_rows_match_jax():
    """The rows' errors against the JAX package's: its _render_fast XLA
    branch (vokselis_tpu/ops/shear_warp.py:387) against its oracle
    ops/reference.render_bonsai, on the same uniforms carried across, at
    each pose and I in {64, 128}: the means within FAST_MEAN_TOL (bf16
    rounding of the two fast frames), the max and p99 finite and ordered."""
    import jax.numpy as jnp
    from vokselis_tpu.core.camera import Camera as JaxCamera
    from vokselis_tpu.ops.reference import render_bonsai as jax_render_bonsai
    from vokselis_tpu.ops.shear_warp import _render_fast as jax_render_fast
    from vokselis_tpu.ops.shear_warp import prepare_fast_volume as jax_prepare

    vol = get_bonsai(DIMS)
    rows = fast_error_report.error_rows("cpu", SIZE, (64, 128), vol)
    jpacks = jax_prepare(vol)
    jposes = {"default": JaxCamera.bonsai(1.0),
              "tilt": JaxCamera(zoom=1.2, pitch=0.9, yaw=1.1, target=(0.5, 0.5, 0.5), aspect=1.0),
              "low": JaxCamera(zoom=1.0, pitch=0.05, yaw=2.5, target=(0.5, 0.5, 0.5), aspect=1.0),
              "orbit135": JaxCamera(zoom=1.0, pitch=0.5, yaw=3 * math.pi / 4,
                                    target=(0.5, 0.5, 0.5), aspect=1.0)}
    exact = {k: np.asarray(jax_render_bonsai(jnp.asarray(vol), c.uniform(), width=SIZE,
                                             height=SIZE)) for k, c in jposes.items()}
    for ii, name, mean, p99, mx in rows:
        ju = jposes[name].uniform()
        fast = np.asarray(jax_render_fast(jpacks, ju, SIZE, SIZE, ii, True))
        err = np.abs(fast - exact[name])
        assert abs(mean - err.mean()) <= FAST_MEAN_TOL, (ii, name, mean, err.mean())
        assert math.isfinite(p99) and mean <= p99 <= mx


# -- dense_stress_probe, kernel_bench, contact_sheet -----------------------------------------

def test_dense_stress_probe_main_cpu(tmp_path):
    """One pose on the dense volume: the fast frame's error finite and
    positive, the hybrid's 0 (a volume this dense renders with the exact
    kernel), the three frames timed; the JSON written and printed."""
    with short_slope():
        rc, out = run_main(dense_stress_probe.main, [
            "--device", "cpu", "--size", str(SIZE), "--dims", str(DIMS), "--ii", str(II),
            "--poses", "bench", "--out-dir", str(tmp_path)])
    res = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and json.loads((tmp_path / "dense_stress.json").read_text()) == res
    assert list(res) == ["budget", "bench_fast_err", "bench_hybrid_err", "exact_ms",
                         "fast_ms", "hybrid_ms"]
    assert 0 < res["bench_fast_err"] < 1 and res["bench_hybrid_err"] == 0.0
    assert all(math.isfinite(res[k]) and res[k] > 0 for k in ("exact_ms", "fast_ms", "hybrid_ms"))


def test_kernel_bench_main_cpu():
    with short_slope():
        rc, out = run_main(kernel_bench.main, ["64", "48", "--device", "cpu", "--dims", str(DIMS)])
    assert rc == 0 and re.fullmatch(r"64x48: [0-9.]+ ms/frame = [0-9.]+ Mrays/s",
                                    out.splitlines()[-1])


def test_contact_sheet_main_cpu(tmp_path):
    """16 frames, 8 yaws x 2 pitches, written as one PNG."""
    path = tmp_path / "sheet.png"
    rc, out = run_main(contact_sheet.main, [str(path), "--device", "cpu", "--size", "32",
                                            "--dims", str(DIMS)])
    img = read_png(str(path))
    assert rc == 0 and out.count(" done") == 16
    assert img.shape[:2] == (64, 256) and img.dtype == np.uint8 and img.max() > 0


TOOLS = {"hybrid_operating_point": hop, "residual_decay": residual_decay,
         "fast_error_report": fast_error_report, "dense_stress_probe": dense_stress_probe,
         "kernel_bench": kernel_bench, "contact_sheet": contact_sheet}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tools_refuse_the_cpu_unless_asked(name, monkeypatch, capsys, tmp_path):
    """Without a card, each tool that measures a device exits nonzero with a
    message unless --device cpu is given: none falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        TOOLS[name].main([])
    assert e.value.code != 0 and "--device cpu" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


def test_tools_import_nothing_of_jax_nor_tools():
    """The tools import with JAX, the root bench.py and tools/ made
    unimportable, and pull in nothing of the JAX package."""
    code = (
        "import sys\n"
        "for m in ('jax', 'bench', 'tools'): sys.modules[m] = None\n"
        "import vokselis_torch.tools.hybrid_operating_point, "
        "vokselis_torch.tools.fit_budget_slope, "
        "vokselis_torch.tools.residual_decay, vokselis_torch.tools.fast_error_report, "
        "vokselis_torch.tools.dense_stress_probe, vokselis_torch.tools.kernel_bench, "
        "vokselis_torch.tools.contact_sheet, vokselis_torch.tools.make_goldens\n"
        "bad = [m for m in sys.modules if m.startswith(('vokselis_tpu', 'jax', 'bench', 'tools'))"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_tools_never_write_the_jax_record(tmp_path):
    with pytest.raises(SystemExit):
        hop.main(["--device", "cpu", "--out", str(tmp_path / "OPPOINT.json")])


# -- the slice as a whole --------------------------------------------------------------------

@pytest.mark.parametrize("pose", ["z1.0-axis", "z1.6-diag"])
def test_recorded_errors_are_direct_calls(oppoint, pose):
    """The probe errors the ladder records at budget 8 are exactly the mean
    |hybrid - exact| over rgb of the port's _call_traced frame and exact
    frame, called here."""
    res, _, _ = oppoint
    vol = get_bonsai(DIMS)
    u = hop.probe_poses()[pose].uniform("cpu")
    h = hy.HybridBonsaiRenderer(vol, "cpu", intermediate=II, budget=8)._call_traced(
        u, SIZE, SIZE)
    render, pack = build_renderer(vol, "cpu")
    want = round(mean_rgb_err(h, render(pack, u, SIZE, SIZE)), 9)
    assert res["ladder"][2]["errs"][pose] == want


def test_hybrid_contract_in_both_packages():
    """The hybrid's contract, mean |hybrid - exact| <= 1e-3, at two probe
    poses in each package against its own exact frame (not pick for pick:
    the packages' selections may differ where scores nearly tie). At 128^2,
    budget 8, the bench pose is over it (1.47e-3 on a 64^3 volume), so this
    runs at the CPU sweep's setting: the 256^3 bonsai at 256^2, I=256,
    budget 32 (tools/cpu_minisweep.py; the port's sweep there: worst
    4.297e-4). The JAX hybrid runs its Pallas kernels in interpret mode,
    its exact frame is its oracle."""
    import importlib

    import jax.experimental.pallas as pl
    import jax.numpy as jnp
    from vokselis_tpu.core.camera import Camera as JaxCamera
    from vokselis_tpu.ops.reference import render_bonsai as jax_render_bonsai

    vol = get_bonsai()
    size, ii, budget = 256, 256, 32
    names = ("vokselis_tpu.ops.pallas.march_bonsai", "vokselis_tpu.ops.pallas.warp2d",
             "vokselis_tpu.ops.hybrid")
    orig = pl.pallas_call
    pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        jhy = [importlib.reload(importlib.import_module(m)) for m in names][2]
        jax_r = jhy.HybridBonsaiRenderer(vol, intermediate=ii, budget=budget)
        port_r = hy.HybridBonsaiRenderer(vol, "cpu", intermediate=ii, budget=budget)
        render, pack = build_renderer(vol, "cpu")
        for pose in ("bench", "z1.6-diag"):
            cam = hop.probe_poses()[pose]
            jcam = (JaxCamera.bonsai(1.0) if pose == "bench" else
                    JaxCamera(zoom=cam.zoom, pitch=cam.pitch, yaw=cam.yaw,
                              target=(0.5, 0.5, 0.5), aspect=1.0))
            ju = jcam.uniform()
            u = CameraUniform.from_numpy(np.asarray(ju.view_position), np.asarray(ju.proj_view),
                                         np.asarray(ju.inv_proj), "cpu")
            assert port_r.route(u, size, size) == ("hybrid", ii, budget)
            h = port_r._call_traced(u, size, size)
            port_err = mean_rgb_err(h, render(pack, u, size, size))
            jh, _ = jax_r._call_traced(ju, size, size)
            je = np.asarray(jax_render_bonsai(jnp.asarray(vol), ju, width=size, height=size))
            jax_err = float(np.abs(np.asarray(jh)[..., :3] - je[..., :3]).mean())
            assert port_err <= CONTRACT and jax_err <= CONTRACT, (pose, port_err, jax_err)
    finally:
        pl.pallas_call = orig
        for m in names:
            importlib.reload(importlib.import_module(m))


# -- on the card -----------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_operating_point_bench_error_is_the_bench_on_gpu(cuda_device, tmp_path):
    """At 1024^2, I=1024, budgets {0, 64}: the bench pose's error at 64 is
    bitwise the one vokselis_torch.bench reports at the same point (the same
    frames on the same card)."""
    with short_slope():
        res = hop.run(cuda_device, 1024, [0, 64], out_dir=str(tmp_path),
                      log=lambda *a: None)
        _m, _s, err, budget = port_bench.bench_bonsai_hybrid(intermediate=1024, budget=64,
                                                             device=cuda_device)
    assert budget == 64 and res["ladder"][1]["errs"]["bench"] == round(err, 9)
    assert all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in res["ladder"])


@pytest.mark.gpu
@pytest.mark.parametrize("pose", ["bench", "z1.6-diag"])
def test_residual_decay_frames_match_plain_on_gpu(cuda_device, pose):
    """The decay tool's two fast frames at 1024^2, I=512: the aux frame (K6)
    bitwise its plain version (image, bad, errd); the "stats" frame (K5):
    the planes and the EXT/OVF/PEAK columns bitwise, CURV/EDGE within
    warp_check.STATS_RTOL relative (K5 sums them in another order than
    torch.sum)."""
    from vokselis_torch.tools.warp_check import k5_error

    packs = prepare_fast_volume(get_bonsai(), cuda_device)
    u = residual_decay.decay_poses()[pose].uniform(cuda_device)
    got = _render_fast(packs, u, 1024, 1024, 512, False, return_aux=True)
    want = _render_fast(packs, u, 1024, 1024, 512, False, return_aux=True, plain=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    planes, stats = _render_fast(packs, u, 1024, 1024, 512, False, return_aux="stats")
    planes_p, stats_p = _render_fast(packs, u, 1024, 1024, 512, False, return_aux="stats",
                                     plain=True)
    err = k5_error(planes, stats, planes_p, stats_p)
    assert err["ok"], err
