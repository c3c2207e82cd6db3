"""Only the flagship exact frame (the 256^3 bonsai through K1), for kernel
A/B runs without the bench's other rows (the port of
``tools/kernel_bench.py``): :func:`vokselis_torch.bench.bench_bonsai`.

    python -m vokselis_torch.tools.kernel_bench [width height]

Prints ``<width>x<height>: <ms> ms/frame = <Mrays/s> Mrays/s``, the frame
slope-timed over replays of ``build_renderer``'s graph. Runs on the card;
``--device cpu`` times the plain march on the CPU.
"""

from __future__ import annotations

import argparse

from vokselis_torch.bench import bench_bonsai
from vokselis_torch.tools.common import add_device_arg, card_of, device_of
from vokselis_torch.volume.io import get_bonsai


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("width", type=int, nargs="?", default=1024)
    parser.add_argument("height", type=int, nargs="?", default=1024)
    add_device_arg(parser)
    parser.add_argument("--dims", type=int, default=256, help="the bonsai volume's side")
    args = parser.parse_args(argv)
    device = device_of(parser, args)
    print(f"device: {card_of(device)}", flush=True)
    mrays, sec = bench_bonsai(width=args.width, height=args.height, vol=get_bonsai(args.dims),
                              device=device)
    print(f"{args.width}x{args.height}: {sec * 1000:.2f} ms/frame = {mrays:.1f} Mrays/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
