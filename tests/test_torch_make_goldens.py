"""The port of tools/make_goldens.py (vokselis_torch.tools.make_goldens), on
the CPU: its four PNGs reproduce the committed goldens (made by the JAX tool
from the JAX oracles) within tests/test_golden.py:30-31's tolerances, each
is bit for bit the frame that test_torch_oracle.py and test_torch_demos.py
build from the port's oracles, and it refuses to write tests/goldens/.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vokselis_torch.core.camera import Camera
from vokselis_torch.media.png import read_png
from vokselis_torch.ops import raster, reference
from vokselis_torch.ops.present import present, to_uint8
from vokselis_torch.tools import make_goldens as mg
from vokselis_torch.volume.io import get_bonsai

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
W, H = 160, 90


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The tool's main run once into a fresh directory, on one intra-op
    thread (the oracles run many small torch ops)."""
    out = tmp_path_factory.mktemp("goldens_out")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert mg.main(["--out-dir", str(out)]) == 0
    finally:
        torch.set_num_threads(n)
    return out


def _oracle_frame(name):
    """The frame as test_torch_oracle.py::test_bonsai_golden and
    test_torch_demos.py's golden tests build it."""
    if name == "bonsai.png":
        cam = Camera(zoom=1.0, pitch=0.5, yaw=1.0, target=(0.5, 0.5, 0.5), aspect=W / H)
        hdr = reference.render_bonsai(torch.from_numpy(get_bonsai()), cam.uniform("cpu"),
                                      width=W, height=H)
    elif name == "trig.png":
        cam = Camera.default(aspect=W / H)
        hdr = raster.rasterize_triangle(
            cam.uniform("cpu").proj_view, (-0.5, -0.5, 0.0), (0.5, -0.5, 0.0),
            (0.0, 0.5, 0.0), (0.25, 0.0, 1.0, 1.0), W, H)
    else:
        cam = Camera(zoom=3.0, pitch=-0.5, yaw=1.0, target=(0.0, 0.0, 0.0), aspect=W / H)
        fn = reference.render_compute_inline if name == "xor.png" else reference.render_field
        hdr = fn(cam.uniform("cpu"), time=0.0, width=W, height=H)
    return to_uint8(present(hdr)).numpy()


def test_writes_the_four_goldens_within_tolerance(written):
    """Four PNGs, each within tests/test_golden.py:30-31's tolerances of the
    committed golden (mean < 1 level, < 1 % of components off by > 8)."""
    assert sorted(os.listdir(written)) == sorted(mg.NAMES)
    for name in mg.NAMES:
        cur = read_png(str(written / name)).astype(np.int32)
        gold = read_png(os.path.join(GOLDENS, name)).astype(np.int32)
        assert cur.shape == gold.shape == (H, W, 4), name
        err = np.abs(cur - gold)
        assert err.mean() < 1.0, (name, err.mean())
        assert (err > 8).mean() < 0.01, (name, (err > 8).mean())


@pytest.mark.parametrize("name", mg.NAMES)
def test_png_is_the_oracle_frame(written, name):
    """Each PNG decodes to exactly the frame the port's golden tests build."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = _oracle_frame(name)
    finally:
        torch.set_num_threads(n)
    np.testing.assert_array_equal(read_png(str(written / name)), want)


def test_refuses_the_committed_goldens(tmp_path, capsys):
    """--out-dir tests/goldens (this checkout's, or any directory ending in
    tests/goldens) exits non-zero before rendering and writes nothing."""
    before = {n: os.path.getmtime(os.path.join(GOLDENS, n)) for n in os.listdir(GOLDENS)}
    other = tmp_path / "tests" / "goldens"
    for out in (GOLDENS, os.path.join(ROOT, "tests", ".", "goldens"), str(other)):
        with pytest.raises(SystemExit) as e:
            mg.main(["--out-dir", out])
        assert e.value.code != 0
        assert "committed goldens" in capsys.readouterr().err
    assert {n: os.path.getmtime(os.path.join(GOLDENS, n)) for n in os.listdir(GOLDENS)} == before
    assert not (tmp_path / "tests").exists()
    assert not mg.is_repo_goldens(str(tmp_path / "goldens"))


def test_imports_nothing_of_jax():
    """The tool imports with JAX and the root tools/ made unimportable, pulls
    in nothing of the JAX package, and says in its --help that it runs on
    the CPU."""
    code = (
        "import sys\n"
        "for m in ('jax', 'tools'): sys.modules[m] = None\n"
        "import vokselis_torch.tools.make_goldens\n"
        "bad = [m for m in sys.modules if m.startswith(('vokselis_tpu', 'jax', 'tools'))"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    out = subprocess.run([sys.executable, "-m", "vokselis_torch.tools.make_goldens", "--help"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "Runs on the CPU" in " ".join(out.stdout.split())
