"""What the benchmark runs loads neither JAX nor the JAX package; the
reference and the roofline counts load nothing of the program; and without a
card the benchmark prints no result."""

import ast
import json
import shutil
import subprocess
import sys

from benchmark.run import FORBIDDEN, NO_CARD, ROOT, load_spec

BENCH = ROOT / "benchmark"


def _imports(path):
    """The top-level names of the modules ``path`` imports (the part before
    the first dot, whole)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & set(FORBIDDEN), path


def test_the_reference_and_the_counts_import_nothing_of_the_program():
    for sub in ("reference", "roofline", "traffic"):
        for path in (BENCH / sub).rglob("*.py"):
            assert "vokselis_torch" not in _imports(path), path


# the port's modules a run reaches, which the drivers import only when they run
PORT_MODULES = ("vokselis_torch.engine.loop", "vokselis_torch.engine.context",
                "vokselis_torch.models.bonsai", "vokselis_torch.models.views",
                "vokselis_torch.ops.cuda.march_bonsai", "vokselis_torch.ops.cuda.genvol")


def test_a_run_loads_no_forbidden_module():
    drivers = sorted(f"benchmark.drivers.{p.stem}" for p in (BENCH / "drivers").glob("*.py")
                     if p.stem != "__init__")
    entries = {json.loads((ROOT / c["file"]).read_text())["entry"] for c in load_spec()["configs"]}
    assert {f"benchmark.drivers.{e}" for e in entries} <= set(drivers)
    modules = ["benchmark.calibrate", "benchmark.loop", *drivers, *PORT_MODULES]
    code = ("import importlib, sys\n"
            "import benchmark.run as r\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "print(r.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    monkeypatch.setitem(sys.modules, "vokselis_tpu_extra", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax.numpy"]


def _run(root, cell="bonsai-orbit"):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                           str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          cwd=root, capture_output=True, text=True, timeout=120)


def test_without_a_card_there_is_no_result_and_no_cpu_fallback():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA card")
    out = _run(ROOT)
    assert out.returncode == NO_CARD and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    for cell in (w["name"] for w in load_spec()["workloads"]):
        out = _run(tmp_path, cell)
        assert out.returncode != 0 and out.stdout == ""


def test_the_command_is_what_the_spec_says():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert spec["command"][1] == "benchmark/run.py"
    assert (ROOT / spec["command"][1]).is_file()
