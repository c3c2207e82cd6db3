#!/usr/bin/env python
"""Live terminal viewer on the PyTorch + CUDA port (vokselis_torch) — the
winit-window analog for a headless render host, as examples/interactive.py
is for the JAX package.

The reference opens a winit window and runs an interactive event loop
(src/lib.rs:75-208). Here every frame is painted into the terminal as
24-bit ANSI half-blocks and keys map to the reference's controls
(src/lib.rs:80-177):

  h/j/k/l or arrow keys   orbit the camera (mouse-drag analog)
  + / -                   zoom (wheel analog)
  s                       screenshot            (F11)
  v                       toggle video capture  (F12)
  q or Esc                exit

Needs a tty for key input; when stdin is not a tty it runs the scripted
orbit for ``--frames`` frames instead, without the preview, so it can be
smoke-tested without a terminal (``--out`` writes the last frame). Renders
on the CUDA card; ``--cpu`` takes the kernels' plain torch versions on the
CPU.

  python examples/interactive_torch.py [--demo bonsai|trig|xor] [--renderer ...]
"""

from __future__ import annotations

import os
import select
import sys

from common import make_parser, orbit_events

_ARROWS = {"[A": "up", "[B": "down", "[C": "right", "[D": "left",
           "OA": "up", "OB": "down", "OC": "right", "OD": "left"}


def read_keys(fd, timeout=0.05):
    """Drain pending keypresses -> list of names ('up', 'q', 'esc', ...)."""
    ready, _, _ = select.select([fd], [], [], timeout)
    if not ready:
        return []
    data = os.read(fd, 256).decode("latin-1")
    keys = []
    i = 0
    while i < len(data):
        c = data[i]
        if c == "\x1b":
            tail = data[i + 1 : i + 3]
            if tail in _ARROWS:
                keys.append(_ARROWS[tail])
                i += 3
                continue
            keys.append("esc")
            i += 1
            continue
        keys.append(c)
        i += 1
    return keys


def ansi_preview(img_u8, cols=100):
    """(H, W, >=3) uint8 -> 24-bit half-block string (2 pixels per cell)."""
    import numpy as np

    h, w = img_u8.shape[:2]
    cols = min(cols, w)
    rows = max(2, int(round(cols * h / w * 0.5)) * 2)
    ys = np.linspace(0, h - 1, rows).astype(int)
    xs = np.linspace(0, w - 1, cols).astype(int)
    sub = img_u8[ys][:, xs, :3].astype(int)
    lines = []
    for y in range(0, rows - 1, 2):
        cells = []
        for x in range(cols):
            tr, tg, tb = sub[y, x]
            br, bg, bb = sub[y + 1, x]
            cells.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                         f"\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


def live_events(ctx, fd, preview_cols=100):
    """Interactive event generator for engine.loop.run: one frame per
    ``None``; previews the previous frame before reading keys."""
    from vokselis_torch.ops.present import to_uint8

    x, y = ctx.width / 2.0, ctx.height / 2.0
    step = 24.0
    first = True
    yield {"type": "mouse_button", "pressed": True}
    while True:
        if ctx.display_image is not None:
            frame = to_uint8(ctx.display_image).cpu().numpy()
            art = ansi_preview(frame, preview_cols)
            if first:
                sys.stdout.write("\x1b[2J")  # clear once
                first = False
            sys.stdout.write(f"\x1b[H{art}\n"
                             "\x1b[0m[hjkl/arrows] orbit  [+/-] zoom  "
                             "[s]hot [v]ideo [q]uit\x1b[K\n")
            sys.stdout.flush()
        for key in read_keys(fd):
            if key in ("q", "esc", "\x03"):
                yield {"type": "key", "key": "esc", "pressed": True}
            elif key == "s":
                yield {"type": "key", "key": "f11", "pressed": True}
            elif key == "v":
                yield {"type": "key", "key": "f12", "pressed": True}
            elif key in ("+", "="):
                yield {"type": "wheel", "delta": -60.0}
            elif key == "-":
                yield {"type": "wheel", "delta": 60.0}
            elif key in ("h", "left", "l", "right", "j", "down", "k", "up"):
                dx = {"h": -1, "left": -1, "l": 1, "right": 1}.get(key, 0)
                dy = {"j": 1, "down": 1, "k": -1, "up": -1}.get(key, 0)
                x += dx * step
                y += dy * step
                yield {"type": "mouse_move", "x": x, "y": y, "dragging": True}
        yield None  # frame boundary


def main():
    parser = make_parser("interactive")
    parser.add_argument("--demo", default="bonsai",
                        choices=("bonsai", "trig", "xor"))
    parser.add_argument("--renderer", default="exact",
                        choices=("exact", "fast", "hybrid"),
                        help="bonsai renderer variant")
    parser.add_argument("--preview-cols", type=int, default=100)
    args = parser.parse_args()

    from vokselis_torch.engine.context import Context
    from vokselis_torch.engine.loop import run

    if args.demo == "bonsai":
        from vokselis_torch.models.bonsai import BonsaiDemo as base
        renderer = args.renderer

        class demo_cls(base):  # noqa: N801 - init-arg shim for run()
            @classmethod
            def init(cls, ctx):
                return base.init(ctx, renderer=renderer)
    elif args.demo == "trig":
        from vokselis_torch.models.trig import TrigDemo as demo_cls
    else:
        from vokselis_torch.models.xor import XorDemo as demo_cls

    camera = demo_cls.default_camera(args.width / args.height)
    ctx = Context(width=args.width, height=args.height, camera=camera,
                  watch=args.watch, device="cpu" if args.cpu else "cuda")

    interactive = sys.stdin.isatty()
    if interactive:
        import termios
        import tty

        fd = sys.stdin.fileno()
        saved = termios.tcgetattr(fd)
        tty.setcbreak(fd)
        events = live_events(ctx, fd, args.preview_cols)
        frames = None  # until Esc/q
    else:
        print("stdin is not a tty - falling back to a scripted orbit")
        events = orbit_events(args.frames, args.width, args.height)
        frames = args.frames

    try:
        ctx = run(demo_cls, width=args.width, height=args.height, camera=camera,
                  frames=frames, events=events, context=ctx, quiet=interactive)
    finally:
        if interactive:
            termios.tcsetattr(fd, termios.TCSADRAIN, saved)
            sys.stdout.write("\x1b[0m\n")
    if args.out:
        from vokselis_torch.media.png import write_png
        from vokselis_torch.ops.present import to_uint8

        write_png(args.out, to_uint8(ctx.display_image).cpu().numpy())
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
