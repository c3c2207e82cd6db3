"""The port's layers import one way: models -> engine and parallel -> ops ->
core -> utils. The compiled frames (``core/compiled``) and the program's
spans (``utils/spans``) sit beneath the kernels, so importing a kernel, a
renderer or a sharded step loads nothing of the engine (its context, loop,
recorder and watcher). Each module is imported in a fresh interpreter;
the uniforms also send one record, which counts its upload."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("module, use", [
    ("core.uniforms", "send([0.0], 'cpu')"),
    ("ops.cuda.march_bonsai", None),
    ("ops.cuda.march_field", None),
    ("ops.shear_warp", None),
    ("ops.hybrid", None),
    ("parallel.sharding", None),
])
def test_lower_layers_import_no_engine(module, use):
    code = (f"import sys, vokselis_torch.{module}\n"
            + (f"vokselis_torch.{module}.{use}\n" if use else "")
            + "print(sorted(m for m in sys.modules if m.startswith('vokselis_torch.engine')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_engine_profiler_names_the_spans():
    """The engine's profiler still names the spans, counters and recording
    that callers above it read."""
    from vokselis_torch.engine import profiler
    from vokselis_torch.utils import spans

    assert (profiler.span, profiler.count, profiler.recording) == (
        spans.span, spans.count, spans.recording)
