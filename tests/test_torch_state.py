"""Scene-state checkpoint/resume of the port (vokselis_torch.engine.state)
against the JAX package's (vokselis_tpu.engine.state), on the CPU.

Both packages run the same host-side camera and uniform code on the same
context operations, so the captured dicts must be equal (exactly: every
value is a Python float or int read from float32 / uint32 state); a file
saved by either package loads in the other; and restoring a snapshot
reproduces the frame bitwise.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from vokselis_torch.engine.context import Context
from vokselis_torch.engine.loop import run
from vokselis_torch.engine.state import capture_state, load_state, restore_state, save_state
from vokselis_torch.models import bonsai as bonsai_model
from vokselis_torch.models.bonsai import BonsaiDemo
from vokselis_torch.volume.io import get_bonsai

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "examples"))

from common import orbit_events  # noqa: E402


def _drive(ctx):
    """The same context operations for both packages."""
    assert ctx.input.update_key("up", True)
    assert ctx.input.update_key("/", True)
    ctx.input.update_mouse_pos(10, 20, 64, 64)
    ctx.input.update_mouse_button(True)
    ctx.camera.add_yaw(0.5)
    ctx.camera.add_zoom(-0.25)
    ctx.update(time=1.5, time_delta=1 / 30)
    ctx.resize(100, 50)
    ctx.camera.add_pitch(0.2)
    ctx.update(time=2.25)


@pytest.fixture
def jax_context():
    pytest.importorskip("jax")
    from vokselis_tpu.engine.context import Context as JaxContext

    return JaxContext


def test_capture_matches_jax(jax_context):
    from vokselis_tpu.engine.state import capture_state as jax_capture

    ctx, jctx = Context(64, 64, device="cpu"), jax_context(64, 64)
    _drive(ctx)
    _drive(jctx)
    state = capture_state(ctx)
    assert state == jax_capture(jctx)
    assert state["frame"] == 2 and state["window"] == [100, 50]
    assert json.loads(json.dumps(state)) == state


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_state_file_loads_in_the_other_package(tmp_path, jax_context, saver):
    """A file saved by one package restores the other's context to the
    same state: the same capture, the same camera uniform."""
    from vokselis_tpu.engine.state import capture_state as jax_capture
    from vokselis_tpu.engine.state import load_state as jax_load
    from vokselis_tpu.engine.state import save_state as jax_save

    path = str(tmp_path / "state.json")
    src = Context(64, 64, device="cpu") if saver == "port" else jax_context(64, 64)
    _drive(src)
    (save_state if saver == "port" else jax_save)(src, path)
    ctx, jctx = Context(32, 32, device="cpu"), jax_context(32, 32)
    load_state(ctx, path)
    jax_load(jctx, path)
    saved = json.loads((tmp_path / "state.json").read_text())
    assert capture_state(ctx) == jax_capture(jctx) == saved
    assert not ctx.camera.updated
    np.testing.assert_array_equal(ctx.camera_uniform.inv_proj.numpy(),
                                  np.asarray(jctx.camera_uniform.inv_proj))
    np.testing.assert_array_equal(ctx.global_uniform.pos.numpy(),
                                  np.asarray(jctx.global_uniform.pos))


def test_restore_reproduces_the_frame(tmp_path, monkeypatch):
    """Save after 2 orbit frames, orbit 2 more, restore: the next frame is
    bitwise the saved one (the exact march's plain version on the CPU)."""
    monkeypatch.setattr(bonsai_model, "get_bonsai", lambda: get_bonsai(32))
    monkeypatch.chdir(tmp_path)
    ctx = Context(48, 32, camera=BonsaiDemo.default_camera(1.5),
                  backbuffer_resolution=(48, 32), device="cpu")
    ctx = run(BonsaiDemo, frames=2, events=orbit_events(2, 48, 32), context=ctx, quiet=True)
    saved = ctx.display_image.clone()
    save_state(ctx, "state.json")
    ctx = run(BonsaiDemo, frames=2, events=orbit_events(2, 48, 32), context=ctx, quiet=True)
    assert not torch.equal(ctx.display_image, saved)
    load_state(ctx, "state.json")
    assert ctx.frame == 2
    ctx = run(BonsaiDemo, frames=1, context=ctx, quiet=True)
    assert torch.equal(ctx.display_image, saved)
    restore_state(ctx, capture_state(ctx))
    assert capture_state(ctx)["frame"] == 3
