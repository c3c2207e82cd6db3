"""examples/interactive_torch.py, the port's terminal viewer, end to end on
the CPU: without a tty it runs the scripted orbit (the JAX viewer's
behaviour when stdin is not a terminal), with JAX made unimportable, and
exits 0. The trig demo keeps the run short (its 1280x720 backbuffer is
rasterized, not marched)."""

import os
import subprocess
import sys

import numpy as np

from vokselis_torch.media.png import read_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "examples", "interactive_torch.py")


def test_interactive_without_a_tty(tmp_path):
    out = tmp_path / "last.png"
    code = (
        "import runpy, sys; sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'examples')!r})\n"
        f"sys.argv = ['interactive_torch.py', '--cpu', '--demo', 'trig', '--frames', '2',"
        f" '--width', '48', '--height', '32', '--out', {str(out)!r}]\n"
        f"runpy.run_path({EXAMPLE!r}, run_name='__main__')\n"
        "bad = [m for m in sys.modules if m.startswith(('vokselis_tpu', 'jax'))"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, stdin=subprocess.DEVNULL,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "falling back to a scripted orbit" in proc.stdout
    img = read_png(str(out))
    assert img.shape == (32, 48, 4)
    assert np.unique(img[..., :3].reshape(-1, 3), axis=0).shape[0] > 1  # a triangle on black


def test_ansi_preview_and_keys(tmp_path):
    """The half-block painter and the key decoder, on a pipe."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import interactive_torch as it

    img = np.zeros((4, 6, 4), np.uint8)
    img[0, :, 0] = 255  # a red top row
    art = it.ansi_preview(img, cols=6)
    assert art.count("\n") == 1 and art.count("▀") == 12
    assert "\x1b[38;2;255;0;0m" in art
    r, w = os.pipe()
    os.write(w, b"q\x1b[Ah+")
    assert it.read_keys(r, timeout=1.0) == ["q", "up", "h", "+"]
    os.close(r)
    os.close(w)
