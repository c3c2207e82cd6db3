"""Application harness: the frame loop (mirrors run(), src/lib.rs:45-208).

There is no window system on a render host, so the winit event loop becomes
a headless/scripted loop: events come from an optional iterable (or stdin in
interactive terminals via examples), and frames are driven either for a fixed
count or until an 'exit' event. Semantics kept from the reference:

- mouse drag -> camera yaw/pitch at rotate_speed 0.0025 (lib.rs:65,169-174)
- wheel -> zoom at zoom_speed 0.002 (lib.rs:66,160-168)
- F11 -> screenshot (lib.rs:125-130); F12 -> toggle video recording
  (lib.rs:132-140); Esc -> exit (lib.rs:88-97)
- resize stops an active recording (lib.rs:109-113)
- per frame: FrameCounter::record, demo.update, demo.render, present,
  capture when recording (lib.rs:75-79,178-200)

Event dicts:
  {'type': 'key', 'key': 'f11'|'f12'|'esc'|'f1'|..., 'pressed': True}
  {'type': 'mouse_move', 'x': px, 'y': px, 'dragging': bool}
  {'type': 'wheel', 'delta': float}
  {'type': 'mouse_button', 'pressed': bool}
  {'type': 'resize', 'width': int, 'height': int}
"""

from __future__ import annotations

from typing import Iterable

from vokselis_torch.core.camera import Camera
from vokselis_torch.engine.context import Context, renderer_info
from vokselis_torch.engine.profiler import FrameCounter, span
from vokselis_torch.media.recorder import Recorder


def print_help(ctx: Context):
    """Startup help banner (print_help, src/lib.rs:210-234)."""
    print(renderer_info(ctx.device))
    print(
        "\n"
        "Controls:\n"
        "  drag        - orbit camera (yaw/pitch)\n"
        "  wheel       - zoom\n"
        "  arrows//    - nudge uniform position\n"
        "  F11         - screenshot\n"
        "  F12         - record video (needs ffmpeg)\n"
        "  Esc         - exit\n"
    )


def run(
    demo_cls,
    width: int = 1280,
    height: int = 720,
    camera: Camera | None = None,
    frames: int | None = None,
    events: Iterable[dict] | None = None,
    context: Context | None = None,
    quiet: bool = False,
    watch: bool = False,
    device=None,
):
    """Run a demo headlessly. Returns the final Context (its
    ``display_image`` is the last presented frame). Without ``context``, one
    is made on ``device``. ``watch=True`` starts the Context's source
    watcher: edits to registered kernel and field sources rebuild and swap
    mid-run (the reference's shader reload loop). The watcher stops when
    the run ends."""
    if context is None and device is None:
        raise ValueError("run() needs a context or a device")
    ctx = context or Context(width=width, height=height, camera=camera,
                             watch=watch, device=device)
    if watch:
        ctx.watcher.start()
    recorder = Recorder()
    frame_counter = FrameCounter(ctx.config.report_every)
    if not quiet:
        print_help(ctx)
    demo = demo_cls.init(ctx)

    event_iter = iter(events) if events is not None else iter(())
    exit_requested = False
    frame_idx = 0
    last_mouse = None

    while not exit_requested and (frames is None or frame_idx < frames):
        # -- event dispatch (lib.rs:80-177) --------------------------------
        try:
            while True:
                ev = next(event_iter)
                if ev is None:
                    break  # frame boundary marker in scripted streams
                kind = ev.get("type")
                if kind == "key":
                    key = ev.get("key", "").lower()
                    pressed = ev.get("pressed", True)
                    if key == "esc" and pressed:
                        exit_requested = True
                    elif key == "f11" and pressed:
                        ctx.render()
                        recorder.screenshot(ctx.capture_frame())
                    elif key == "f12" and pressed:
                        if recorder.is_recording:
                            recorder.finish()
                        else:
                            recorder.start(ctx.dims)
                    elif not ctx.input.update_key(key, pressed):
                        demo.update_input(ev)
                elif kind == "mouse_move":
                    x, y = ev["x"], ev["y"]
                    if ev.get("dragging") and last_mouse is not None:
                        dx = x - last_mouse[0]
                        dy = y - last_mouse[1]
                        # lib.rs:171-172: yaw negated, pitch NOT negated
                        ctx.camera.add_yaw(-dx * ctx.config.rotate_speed)
                        ctx.camera.add_pitch(dy * ctx.config.rotate_speed)
                    last_mouse = (x, y)
                    ctx.input.update_mouse_pos(x, y, ctx.width, ctx.height)
                elif kind == "wheel":
                    ctx.camera.add_zoom(-ev["delta"] * ctx.config.zoom_speed)
                elif kind == "mouse_button":
                    ctx.input.update_mouse_button(ev["pressed"])
                elif kind == "resize":
                    if recorder.is_recording:
                        recorder.finish()  # lib.rs:109-113
                    ctx.resize(ev["width"], ev["height"])
                    demo.resize(ctx, ev["width"], ev["height"])
        except StopIteration:
            pass

        # -- frame (lib.rs:75-79, 178-200) ---------------------------------
        with span("loop.frame", id=frame_idx):
            frame_counter.record()
            ctx.update(time_delta=frame_counter.time_delta())
            demo.update(ctx)
            demo.render(ctx)
            ctx.render()
            if recorder.is_recording:
                recorder.record(ctx.capture_frame())
        frame_idx += 1

    recorder.close()
    ctx.watcher.stop()
    return ctx
