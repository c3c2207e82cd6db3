"""The port's parity report (vokselis_torch.tools.parity_report) on the CPU:
its comparison code on the plain versions at a tiny size, written into
``tmp_path``. On the card the same rows compare the CUDA kernels with the
port's torch oracles; here every wrapper takes its plain version, so the
exact rows measure the plain versions against the oracles. The tool refuses
to run without CUDA, and never writes PARITY_REPORT.md, the JAX package's
record.
"""

import hashlib
import os

import pytest
import torch

from vokselis_torch.tools import parity_report as pr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = pr.Sizes(bonsai=32, frame=48, orbit=(72, 41), poses=2, field=32, density=32, view=32,
                fast_ii=64, hybrid_ii=64, budget=4)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the plain versions run many small torch ops, and
    an OpenMP team per op oversubscribes the CPU under the suite's parallel
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_compare_row():
    """A row's numbers: mean, max and share over 1e-3 of |got - want| over
    rgb (alpha ignored) or rgba."""
    want = torch.zeros(2, 2, 4)
    got = want.clone()
    got[0, 0, 0] = 4e-3
    got[..., 3] = 1.0  # alpha, outside an rgb row
    row = pr.compare("r", got, want, 1e-3)
    assert row["channels"] == "rgb" and row["max"] == pytest.approx(4e-3)
    assert row["mean"] == pytest.approx(4e-3 / 12) and row["over"] == pytest.approx(1 / 12)
    assert pr.compare("r", got, want, 1e-3, channels=4)["max"] == 1.0


def test_report_on_cpu_plain_versions(tmp_path):
    """Every config's rows at a tiny size, in the report file: configs 1 and
    2 (both normals), 3 and 3 on the dense volume, 4 exact and hybrid at
    every pose, 5 at one view, and fast; every row but fast's (an
    approximation, at I=64 here) within the error budget; the card line
    names the CPU; PARITY_REPORT.md is untouched."""
    record = os.path.join(ROOT, "PARITY_REPORT.md")
    before = _digest(record)
    out = tmp_path / "PARITY_REPORT_TORCH.md"
    rows = pr.report(str(out), device="cpu", sizes=TINY, log=None)
    names = [r["name"] for r in rows]
    counts = {k: sum(n.startswith(k) for n in names)
              for k in ("config 1", "config 2", "config 3", "config 4", "config 5", "fast")}
    assert counts == {"config 1": 1, "config 2": 2, "config 3": 2, "config 4": 2 * TINY.poses,
                      "config 5": 1, "fast": 1}
    assert any("dense_stress" in n for n in names)
    for row in rows:
        assert row["mean"] <= row["max"] and 0.0 <= row["over"] <= 1.0
        if not row["name"].startswith("fast"):
            assert row["mean"] <= row["limit"] == pr.BUDGET, row
    text = out.read_text()
    assert "Device: cpu (no card)" in text
    for name in names:
        assert f"| {name} |" in text
    assert _digest(record) == before


def test_report_refuses_without_cuda(tmp_path, monkeypatch):
    """Asked for the card where there is none, the report raises before it
    writes anything, and so does the command line."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "report.md"
    with pytest.raises(RuntimeError, match="CUDA"):
        pr.report(str(out), device="cuda", sizes=TINY, log=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        pr.main(["--out", str(out)])
    assert not out.exists()


def test_report_never_writes_the_jax_record(tmp_path):
    """PARITY_REPORT.md, wherever it lies, is refused as the output."""
    with pytest.raises(ValueError, match="PARITY_REPORT.md"):
        pr.report(str(tmp_path / "PARITY_REPORT.md"), device="cpu", sizes=TINY, log=None)
    assert not (tmp_path / "PARITY_REPORT.md").exists()
    assert os.path.basename(pr.DEFAULT_OUT) == "PARITY_REPORT_TORCH.md"
