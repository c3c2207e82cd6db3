"""The port's multi-device benchmark (vokselis_torch/tools/multichip_bench.py)
against the JAX package's tools/multichip_bench.py, on the CPU.

``--cpu --devices 2 --json`` spawns a gloo world of two processes (through
``torch.multiprocessing.spawn`` and ``file://`` stores) and must give the
rows that JAX's ``run()`` gives at 2 devices on conftest's 8-device CPU
mesh: the same modes, device counts, views and keys (the times differ).
Both ``_time_call``s take the same seconds from one fake clock, on a card
(the median slope) and on the CPU (the fastest call). Without a card, or
with more devices asked than the machine has cards, the card's path
raises.
"""

import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vokselis_torch.tools import multichip_bench as port_mcb

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread (test_torch_hybrid.py:42-50)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_mcb():
    """tools/multichip_bench.py, loaded from its file."""
    jax = pytest.importorskip("jax")
    if jax.device_count() < 8:
        pytest.skip("needs 8 (virtual) JAX devices")
    spec = importlib.util.spec_from_file_location("jax_multichip_bench",
                                                  ROOT / "tools" / "multichip_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_rows(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _shape(rows):
    return [(r["mode"], r["chips"], r.get("views"), sorted(r)) for r in rows]


def test_rows_match_jax_run(jax_mcb, monkeypatch, capsys):
    """Rows A (views_weak_scaling at 1 and 2 devices, 2 views each) and B
    (frame_row_sharded at 1 and 2) with JAX's keys, every time finite and
    positive, the first row's efficiency and speedup 1."""
    monkeypatch.setattr(sys, "argv", ["multichip_bench", "--devices", "2", "--json"])
    capsys.readouterr()
    jax_mcb.run()
    want = _json_rows(capsys.readouterr().out)
    got = port_mcb.run(["--cpu", "--devices", "2", "--json"])
    out = capsys.readouterr()
    assert _json_rows(out.out) == got
    a, b = sorted(want[0]), sorted(want[2])
    assert _shape(got) == _shape(want) == [
        ("views_weak_scaling", 1, 2, a), ("views_weak_scaling", 2, 4, a),
        ("frame_row_sharded", 1, None, b), ("frame_row_sharded", 2, None, b)]
    for row in got:
        ms = row.get("ms_per_batch", row.get("ms_per_frame"))
        assert np.isfinite(ms) and ms > 0 and row["mrays_s"] >= 0
    assert got[0]["weak_efficiency"] == 1.0 and got[2]["speedup"] == 1.0
    assert out.err.splitlines()[0].startswith("device: cpu (no card), a gloo world of 2")


class FakeClock:
    """A clock that only calls advance: a call costs c_k + d, c_k the k-th of a
    fixed sequence of overheads."""

    def __init__(self, overheads, delta):
        self.now, self.k = 50.0, 0
        self.overheads, self.delta = overheads, delta

    def call(self):
        self.now += self.overheads[self.k % len(self.overheads)] + self.delta
        self.k += 1
        return np.zeros((1, 1), np.float32)


@pytest.mark.parametrize("on_card", [True, False], ids=["card", "cpu"])
def test_time_call_matches_jax(on_card, jax_mcb, monkeypatch):
    """Both _time_calls warm twice, then take the median slope between 1 and
    5 calls (a card, JAX's TPU) or the fastest single call (the CPU)."""
    import jax.numpy as jnp

    overheads = list(np.random.default_rng(5).uniform(0.0, 0.002, size=40))
    got = {}
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    for name, mod, attr in (("jax", jax_mcb, "time"), ("port", port_mcb, "perf_counter")):
        clock = FakeClock(overheads, 0.0031)
        monkeypatch.setattr(mod, "time", SimpleNamespace(**{attr: lambda c=clock: c.now}))

        def fn(c=clock):
            c.call()
            return jnp.zeros((1, 1))

        got[name] = mod._time_call(fn, on_card)
    assert got["port"] == got["jax"]


def test_card_path_needs_the_cards(monkeypatch):
    """Without --cpu: no card raises; more devices than cards raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port_mcb.run(["--json"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 devices asked, this machine has 1 card"):
        port_mcb.run(["--devices", "2"])


@pytest.mark.parametrize("on_card", [True, False], ids=["card", "cpu"])
def test_default_sizes_are_jax(on_card):
    """tools/multichip_bench.py:137-141's defaults: 512^2, 8 views a device,
    444 steps, the 256^3 bonsai on a card (its TPU); 48^2, 2, 16, 32^3 on the
    CPU. Flags override them."""
    want = (dict(width=512, height=512, views=8, max_steps=444, bonsai=256) if on_card
            else dict(width=48, height=48, views=2, max_steps=16, bonsai=32))
    assert port_mcb._sizes(port_mcb.parse_args([]), on_card) == want
    args = port_mcb.parse_args(["--width", "64", "--height", "32", "--views", "3",
                                "--max-steps", "9"])
    assert port_mcb._sizes(args, on_card) == dict(want, width=64, height=32, views=3,
                                                  max_steps=9)
