"""The frame's uniforms as one record (vokselis_torch.core.uniforms: ``send``,
the global uniform's host mirror; ``CameraUniform.from_block``).

Over a scripted event stream (held arrow keys, drags, the mouse button, the
wheel and a resize) every frame's global and camera uniforms are bitwise
those of the per-field path that the record replaced (kept below as
``per_field_update``: one upload a field, ``pos`` nudged by a device add),
and on the CPU those of the JAX package's ``Context`` on the same events.
Each frame's uniforms are held to the end of the run and compared then, so a
later frame overwriting an earlier one's block would show.

Tests marked ``gpu`` need a CUDA card and skip without one: the per-field
comparison on the card, and the records there (frames with
``torch.cuda.set_sync_debug_mode("error")`` on, uniforms held from early
frames unchanged, frames sent behind a long kernel without waiting for
it). On the card run
``python -m pytest tests/test_torch_uniforms.py --noconftest -m gpu``.
"""

import numpy as np
import pytest
import torch

from vokselis_torch.core.camera import Camera, CameraUniform
from vokselis_torch.core.uniforms import GLOBAL_LAYOUT, GlobalUniform
from vokselis_torch.engine import profiler
from vokselis_torch.engine.context import Context
from vokselis_torch.engine.demo import Demo
from vokselis_torch.engine.input import MOVE_STEP, Input
from vokselis_torch.engine.loop import run

W, H = 32, 24
BACKBUFFER = (8, 8)
FIELDS = [f[0] for f in GLOBAL_LAYOUT]
U32 = {f[0] for f in GLOBAL_LAYOUT if f[3]}


def _events():
    """A scripted stream, one list of events a frame: held arrow keys and
    the z pair (some at once, cancelling), drags, the mouse button, the
    wheel, a resize, and frames in which the camera stays clean."""
    key = lambda k, p: {"type": "key", "key": k, "pressed": p}  # noqa: E731
    move = lambda x, y, d: {"type": "mouse_move", "x": x, "y": y, "dragging": d}  # noqa: E731
    script = [
        [move(10.0, 12.0, False)],
        [key("up", True)],
        [key("right", True), move(14.0, 12.0, True)],
        [move(19.0, 9.0, True), {"type": "mouse_button", "pressed": True}],
        [key("/", True), move(23.0, 7.5, True)],
        [key("left", True)],
        [{"type": "wheel", "delta": 120.0}],
        [key("up", False), key("rshift", True)],
        [],
        [{"type": "mouse_button", "pressed": False}, move(11.0, 20.0, False)],
        [{"type": "resize", "width": 40, "height": 18}],
        [key("down", True), move(15.0, 3.0, True)],
        [{"type": "wheel", "delta": -360.0}, key("/", False)],
        [],
        [key("right", False), move(2.0, 30.0, True)],
    ]
    script += [[move(2.0 + 3 * i, 30.0 - i, True)] if i % 3 else [] for i in range(16)]
    return script


def _stream(script):
    for frame in script:
        yield from frame
        yield None


def _times(frame):
    """Deterministic time and time delta of a frame (the loop's are the
    host clock's)."""
    return 0.37 + 0.0173 * frame, 1.0 / 60.0 + 1e-4 * frame


def per_field_upload(x, device, dtype=torch.float32):
    """One host value as its own tensor on ``device``."""
    return torch.tensor(np.asarray(x), dtype=dtype).to(device)


def per_field_camera(camera, device):
    vp, pv, inv = camera.host_uniform()
    return tuple(per_field_upload(np.asarray(x, np.float32), device) for x in (vp, pv, inv))


def per_field_update(prev, ctx, frame, dirty, time, time_delta):
    """``Context.update`` with one upload a field: the frame's globals, the
    held keys' step added to ``pos`` on the device, and the camera's three
    arrays when it is dirty. ``prev`` and the result are ``(globals,
    camera)``: a dict of the global uniform's tensors and a tuple of the
    camera's."""
    dev = ctx.device
    g, cam = prev
    inp = ctx.input
    dx = (MOVE_STEP if inp.right_pressed else 0.0) - (MOVE_STEP if inp.left_pressed else 0.0)
    dy = (MOVE_STEP if inp.up_pressed else 0.0) - (MOVE_STEP if inp.down_pressed else 0.0)
    dz = ((MOVE_STEP if inp.slash_pressed else 0.0)
          - (MOVE_STEP if inp.right_shift_pressed else 0.0))
    g = dict(g,
             time=per_field_upload(time, dev),
             time_delta=per_field_upload(time_delta, dev),
             frame=per_field_upload(int(frame), dev, torch.uint32),
             resolution=per_field_upload((float(ctx.render_backbuffer.width),
                                          float(ctx.render_backbuffer.height)), dev))
    g["pos"] = g["pos"] + per_field_upload([dx, dy, dz], dev)
    g["mouse"] = per_field_upload(inp.mouse, dev)
    g["mouse_pressed"] = per_field_upload(1 if inp.left_mouse_pressed else 0, dev, torch.uint32)
    if dirty:
        cam = per_field_camera(ctx.camera, dev)
    return g, cam


def per_field_start(ctx):
    dev = ctx.device
    g = {"pos": per_field_upload([0.0, 0.0, 0.0], dev)}
    return g, per_field_camera(ctx.camera, dev)


class _Idle(Demo):
    @classmethod
    def init(cls, ctx):
        return cls()


def _bits(t):
    """A tensor's bytes on the host, with its dtype and shape."""
    t = t.detach().cpu()
    return t.dtype, tuple(t.shape), t.reshape(-1).view(torch.uint8).numpy().tobytes()


def _record(ctx_cls, device):
    """Run the script on a ``ctx_cls`` context; returns its frames as
    ``(global uniform, camera uniform, per-field globals, per-field
    camera, camera host arrays)``, held until the run ends."""

    class Checked(ctx_cls):
        def update(self, time_delta=None, time=None):
            frame, dirty = self.frame, self.camera.updated
            time, time_delta = _times(frame)
            super().update(time_delta=time_delta, time=time)
            self.plain = per_field_update(self.plain, self, frame, dirty, time, time_delta)
            if dirty:
                self.host = self.camera.host_uniform()
            self.seen.append((self.global_uniform, self.camera_uniform, *self.plain, self.host))

    cam = Camera(zoom=1.7, pitch=0.3, yaw=2.2, target=(0.5, 0.5, 0.5), aspect=W / H)
    ctx = Checked(W, H, camera=cam, backbuffer_resolution=BACKBUFFER, device=device)
    ctx.plain, ctx.seen, ctx.host = per_field_start(ctx), [], cam.host_uniform()
    script = _events()
    run(_Idle, frames=len(script), events=_stream(script), context=ctx, quiet=True)
    assert len(ctx.seen) == len(script)
    return ctx.seen


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_frame_uniforms_are_the_per_field_path(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seen = _record(Context, torch.device(device))
    if device == "cuda":
        torch.cuda.synchronize()
    clean = 0
    for i, (g, cu, pg, pcam, host) in enumerate(seen):
        for name in FIELDS:
            t = getattr(g, name)
            assert t.device.type == device, (i, name)
            assert t.dtype == (torch.uint32 if name in U32 else torch.float32), (i, name)
            assert _bits(t) == _bits(pg[name]), (i, name)
            assert _bits(torch.from_numpy(g.host(name).copy())) == _bits(
                pg[name].cpu().reshape(-1).view(torch.float32)), (i, name)
        for t, p, h in zip(cu.tensors(), pcam, host):
            assert _bits(t) == _bits(p) == _bits(torch.from_numpy(h)), i
        clean += i > 0 and cu is seen[i - 1][1]
    assert clean >= 5  # frames without a camera change keep the last dirty frame's uniform
    assert int(seen[-1][0].frame) == len(seen) - 1
    assert seen[-1][0].pos.tolist() != [0.0, 0.0, 0.0]


def test_frame_uniforms_match_jax():
    """The port's frames against the JAX package's Context on the same
    events (test_torch_engine.py's one-frame comparison, every frame)."""
    pytest.importorskip("jax")
    from vokselis_tpu.core.camera import Camera as JaxCamera
    from vokselis_tpu.engine.context import Context as JaxContext
    from vokselis_tpu.engine.demo import Demo as JaxDemo
    from vokselis_tpu.engine.loop import run as jax_run

    class JaxIdle(JaxDemo):
        @classmethod
        def init(cls, ctx):
            return cls()

    class Timed(JaxContext):
        def update(self, time_delta=None, time=None):
            time, time_delta = _times(self.frame)
            super().update(time_delta=time_delta, time=time)
            self.seen.append((self.global_uniform, self.camera_uniform))

    jcam = JaxCamera(zoom=1.7, pitch=0.3, yaw=2.2, target=(0.5, 0.5, 0.5), aspect=W / H)
    jctx = Timed(W, H, camera=jcam, backbuffer_resolution=BACKBUFFER)
    jctx.seen = []
    script = _events()
    jax_run(JaxIdle, frames=len(script), events=_stream(script), context=jctx, quiet=True)
    seen = _record(Context, torch.device("cpu"))
    assert len(seen) == len(jctx.seen) == len(script)
    for i, ((g, cu, *_), (jg, jcu)) in enumerate(zip(seen, jctx.seen)):
        for name in FIELDS:
            want = np.asarray(getattr(jg, name))
            got = getattr(g, name).numpy()
            assert got.dtype == want.dtype and got.shape == want.shape, (i, name)
            assert got.tobytes() == want.tobytes(), (i, name)
        for name in ("view_position", "proj_view", "inv_proj"):
            assert getattr(cu, name).numpy().tobytes() == np.asarray(
                getattr(jcu, name)).tobytes(), (i, name)


def test_one_record_each():
    """``default``, ``with_`` and ``from_numpy`` send one record each, of
    host values; ``position_fields`` nudges ``pos`` by a float32 add on the
    mirror."""
    dev = torch.device("cpu")
    with profiler.recording() as rec:
        g = GlobalUniform.default(dev)
        g = g.with_(time=1.25, frame=7, mouse=(0.5, -0.25))
        u = CameraUniform.from_numpy(np.zeros((5, 4)), np.ones((5, 4, 4)),
                                     np.full((5, 4, 4), 2.0), dev)
    assert rec.snapshot()["counters"] == {"uploads": 3,
                                          "upload_bytes": 4 * (11 + 11 + 5 * 36)}
    assert float(g.time) == 1.25 and int(g.frame) == 7 and g.mouse.tolist() == [0.5, -0.25]
    assert g.resolution.tolist() == [1920.0, 780.0] and float(g.time_delta) == np.float32(1 / 60)
    assert g.host("time").tolist() == [1.25] and g.host("frame").view(np.uint32).tolist() == [7]
    assert u.view_position.shape == (5, 4) and u.inv_proj.shape == (5, 4, 4)
    assert float(u.inv_proj.sum()) == 160.0 and float(u.proj_view.sum()) == 80.0

    back = g.with_(pos=[0.5, 0.5, 0.5])
    assert back.host("pos").tolist() == [0.5, 0.5, 0.5] and float(back.time) == 1.25
    moved = back.with_(**Input(up_pressed=True, left_mouse_pressed=True).position_fields(back))
    assert moved.pos.tolist() == (
        np.float32([0.5, 0.5, 0.5]) + np.float32([0.0, MOVE_STEP, 0.0])).tolist()
    assert int(moved.mouse_pressed) == 1 and back.pos.tolist() == [0.5, 0.5, 0.5]


@pytest.mark.gpu
def test_records_on_gpu(cuda_device):
    """Frames with ``set_sync_debug_mode("error")``: no hidden sync, and
    every frame's uniforms still hold their own values at the end; frames
    sent while a long kernel is queued ahead do not wait for it; a batch of
    views is one record too."""
    cam = Camera(zoom=1.7, pitch=0.3, yaw=2.2, target=(0.5, 0.5, 0.5), aspect=W / H)
    ctx = Context(W, H, camera=cam, backbuffer_resolution=BACKBUFFER, device=cuda_device)
    held = []

    def frames(n):
        for _ in range(n):
            f = ctx.frame
            ctx.input.update_key("up", f % 3 == 0)
            ctx.input.update_mouse_pos(f, 2 * f, W, H)
            if f % 2:
                ctx.camera.add_yaw(0.01 * f)
            ctx.update(*_times(f)[::-1])
            g, u = ctx.global_uniform, ctx.camera_uniform
            held.append((g, u, g.mirror.copy(), tuple(h.copy() for h in u.host_np)))

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        frames(24)
        with profiler.recording() as rec:
            torch.cuda._sleep(200_000_000)  # ~0.1 s on the card: the copies queue behind it
            slept = torch.cuda.Event()
            slept.record()
            frames(9)
            assert not slept.query()  # the frames were sent without waiting for it
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert rec.snapshot()["counters"]["uploads"] == 9
    torch.cuda.synchronize()
    for i, (g, u, mirror, host) in enumerate(held):
        words = torch.cat([getattr(g, name).reshape(-1).view(torch.float32) for name in FIELDS])
        assert words.cpu().numpy().tobytes() == mirror.tobytes(), i
        for t, h in zip(u.tensors(), host):
            assert t.cpu().numpy().tobytes() == h.tobytes(), i
    assert len({held[i][0].time.data_ptr() for i in range(len(held))}) == len(held)

    rng = np.random.default_rng(5)
    arrays = [rng.random((64, 4)), rng.random((64, 4, 4)).astype(np.float32),
              rng.random((64, 4, 4))]
    with profiler.recording() as rec:
        batch = CameraUniform.from_numpy(*arrays, cuda_device)
    assert rec.snapshot()["counters"] == {"uploads": 1, "upload_bytes": 64 * 36 * 4}
    for t, a in zip(batch.tensors(), arrays):
        assert torch.equal(t.cpu(), torch.from_numpy(np.asarray(a, np.float32)))
