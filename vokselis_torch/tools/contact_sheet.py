"""A bonsai contact sheet through the exact renderer (K1): 8 yaws x 2
pitches, which covers every (dominant axis, sign) ray class (the port of
``tools/contact_sheet.py``).

    python -m vokselis_torch.tools.contact_sheet [out.png] [--size 256]

Each cell is a ``--size``-square frame at zoom 1.2, presented and tonemapped
to 8 bits; the sheet is written as a PNG (default ``contact_sheet.png`` in
the working directory; a visual check, not committed). Runs on the card;
``--device cpu`` runs the plain march.
"""

from __future__ import annotations

import argparse
import math

import numpy as np

from vokselis_torch.core.camera import Camera
from vokselis_torch.media.png import write_png
from vokselis_torch.ops.cuda.march_bonsai import BonsaiRenderer
from vokselis_torch.ops.present import present, to_uint8
from vokselis_torch.tools.common import add_device_arg, card_of, device_of
from vokselis_torch.volume.io import get_bonsai

PITCHES = (0.5, -0.35)
N_YAW = 8


def sheet(device, size: int = 256, vol=None, log=print) -> np.ndarray:
    """The (2 size, 8 size, C) uint8 sheet: a row per pitch, a column per
    yaw."""
    r = BonsaiRenderer(get_bonsai() if vol is None else vol, device)
    rows = []
    for pitch in PITCHES:
        row = []
        for i in range(N_YAW):
            cam = Camera(zoom=1.2, pitch=pitch, yaw=2 * math.pi * i / N_YAW,
                         target=(0.5, 0.5, 0.5), aspect=1.0)
            img = r(cam.uniform(device), width=size, height=size)
            row.append(to_uint8(present(img)).cpu().numpy())
            log(f"pose pitch={pitch} yaw {i}/{N_YAW} done")
        rows.append(np.concatenate(row, axis=1))
    return np.concatenate(rows, axis=0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out", nargs="?", default="contact_sheet.png", help="the PNG to write")
    add_device_arg(parser)
    parser.add_argument("--size", type=int, default=256, help="a cell's side, pixels")
    parser.add_argument("--dims", type=int, default=256, help="the bonsai volume's side")
    args = parser.parse_args(argv)
    device = device_of(parser, args)
    print(f"device: {card_of(device)}", flush=True)
    img = sheet(device, args.size, get_bonsai(args.dims), log=lambda s: print(s, flush=True))
    write_png(args.out, img)
    print(f"wrote {args.out} {img.shape}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
