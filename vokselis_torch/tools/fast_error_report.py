"""The fast (shear-warp) renderer's error against the exact frame and its
speed, across intermediates and poses (the port of
``tools/fast_error_report.py``, whose TPU tables are PARITY_REPORT.md:54-68).

    python -m vokselis_torch.tools.fast_error_report [--size 1024] [--ii 256,512]

Prints two markdown tables, headed by the card's name and power limit: per
intermediate I and pose, the mean, p99 and max of |fast - exact| over rgba
(the fast frame eagerly through ``_render_fast(pack, u, W, H, I, True)``,
the exact frame K1's); then per I the fast frame's ms and Mrays/s at the
bench pose, slope-timed over replays of ``build_fast_renderer``'s graph.
Runs on the card; ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import datetime
import math

import numpy as np
import torch

from vokselis_torch.core.camera import Camera
from vokselis_torch.ops.cuda.march_bonsai import build_renderer
from vokselis_torch.ops.shear_warp import _render_fast, build_fast_renderer, prepare_fast_volume
from vokselis_torch.tools.common import add_device_arg, card_of, device_of, frame_ms
from vokselis_torch.volume.io import get_bonsai

SIZE = 1024
IIS = (256, 512)


def report_poses() -> dict:
    """The four poses of tools/fast_error_report.py:38-46."""
    c = dict(target=(0.5, 0.5, 0.5), aspect=1.0)
    return {
        "default": Camera.bonsai(1.0),
        "tilt": Camera(zoom=1.2, pitch=0.9, yaw=1.1, **c),
        "low": Camera(zoom=1.0, pitch=0.05, yaw=2.5, **c),
        "orbit135": Camera(zoom=1.0, pitch=0.5, yaw=3 * math.pi / 4, **c),
    }


def error_rows(device, size: int = SIZE, iis=IIS, vol=None):
    """``(I, pose, mean, p99, max)`` of |fast - exact| over rgba, for each I
    and pose."""
    device = torch.device(device)
    vol = get_bonsai() if vol is None else vol
    pack = prepare_fast_volume(vol, device)
    render, rpack = build_renderer(vol, device)
    rows = []
    for ii in iis:
        for name, cam in report_poses().items():
            u = cam.uniform(device)
            err = (_render_fast(pack, u, size, size, ii, True)
                   - render(rpack, u, size, size)).abs()
            rows.append((ii, name, float(err.mean()),
                         float(np.quantile(err.cpu().numpy(), 0.99)), float(err.max())))
    return rows


def timing_rows(device, size: int = SIZE, iis=IIS, vol=None):
    """``(I, ms per frame, Mrays/s)`` of the fast frame at the bench pose."""
    device = torch.device(device)
    vol = get_bonsai() if vol is None else vol
    u0 = report_poses()["default"].uniform(device)
    rows = []
    for ii in iis:
        render, pack = build_fast_renderer(vol, device, intermediate=ii)
        ms = frame_ms(lambda: render(pack, u0, size, size), device)
        rows.append((ii, ms, size * size / (ms / 1e3) / 1e6))
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_arg(parser)
    parser.add_argument("--size", type=int, default=SIZE, help="frame side, pixels")
    parser.add_argument("--ii", default=",".join(map(str, IIS)),
                        help="intermediates I, comma-separated")
    parser.add_argument("--dims", type=int, default=256, help="the bonsai volume's side")
    args = parser.parse_args(argv)
    device = device_of(parser, args)
    size, iis, vol = args.size, [int(i) for i in args.ii.split(",")], get_bonsai(args.dims)
    print(f"# fast-mode error/speed report @ {size}x{size}, {card_of(device)}")
    print("| I | pose | mean err | p99 err | max err |")
    print("|---|---|---|---|---|")
    for ii, name, mean, p99, mx in error_rows(device, size, iis, vol):
        print(f"| {ii} | {name} | {mean:.5f} | {p99:.4f} | {mx:.3f} |", flush=True)
    print("\n| I | ms/frame | Mrays/s |")
    print("|---|---|---|")
    for ii, ms, mrays in timing_rows(device, size, iis, vol):
        print(f"| {ii} | {ms:.3f} | {mrays:.0f} |", flush=True)
    print(f"\nGenerated {datetime.date.today()} by vokselis_torch/tools/fast_error_report.py.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
