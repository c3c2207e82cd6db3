"""Render the four 160x90 golden frames of tests/test_golden.py with the
port's oracles (the port of ``tools/make_goldens.py``).

    python -m vokselis_torch.tools.make_goldens [--out-dir DIR]

The scene is the JAX tool's, fixed (``tools/make_goldens.py:36-40``): the
bonsai at zoom 1, pitch 0.5, yaw 1 through ``reference.render_bonsai``; the
xor field at zoom 3, pitch -0.5, yaw 1, time 0 through
``reference.render_compute_inline``; the trig field through
``reference.render_field`` at the same camera; and the trig demo's triangle
at time 0.25's colour (0.25, 0, 1, 1) through ``raster.rasterize_triangle``.
Each frame goes through ``present`` and ``to_uint8`` and is written with
``media.png.write_png`` as bonsai.png, xor.png, trig_field.png and trig.png.

It runs on the CPU, as the JAX tool does (the oracles are plain torch; about
20 s, most of it the bonsai march). Files go under ``--out-dir`` (default
``$TMPDIR/vokselis_torch/goldens``). The committed goldens in tests/goldens/
were made by the JAX tool and are the reference: this tool refuses to write
there.
"""

from __future__ import annotations

import argparse
import os

import torch

from vokselis_torch.core.camera import Camera
from vokselis_torch.media.png import write_png
from vokselis_torch.ops import raster, reference
from vokselis_torch.ops.present import present, to_uint8
from vokselis_torch.tools.common import DEFAULT_OUT_DIR
from vokselis_torch.volume.io import get_bonsai

# tools/make_goldens.py:36-40; changing any of these invalidates the goldens
BONSAI_CAM = dict(zoom=1.0, pitch=0.5, yaw=1.0, target=(0.5, 0.5, 0.5))
XOR_CAM = dict(zoom=3.0, pitch=-0.5, yaw=1.0, target=(0.0, 0.0, 0.0))
TIME = 0.0
SIZE = (160, 90)  # (width, height)
TRIANGLE = ((-0.5, -0.5, 0.0), (0.5, -0.5, 0.0), (0.0, 0.5, 0.0))
TRIANGLE_COLOR = (0.25, 0.0, 1.0, 1.0)  # the trig demo's colour at time 0.25
NAMES = ("bonsai.png", "xor.png", "trig_field.png", "trig.png")
# the committed goldens, never written over
REPO_GOLDENS = os.path.join(os.path.dirname(__file__), "..", "..", "tests", "goldens")


def frames() -> dict:
    """The four golden frames as (90, 160, 4) uint8 arrays, by file name."""
    w, h = SIZE
    cam = Camera(aspect=w / h, **BONSAI_CAM)
    hdr = {"bonsai.png": reference.render_bonsai(torch.from_numpy(get_bonsai()),
                                                  cam.uniform("cpu"), width=w, height=h)}
    camx = Camera(aspect=w / h, **XOR_CAM).uniform("cpu")
    hdr["xor.png"] = reference.render_compute_inline(camx, time=TIME, width=w, height=h)
    hdr["trig_field.png"] = reference.render_field(camx, time=TIME, width=w, height=h)
    cam0 = Camera.default(aspect=w / h)
    hdr["trig.png"] = raster.rasterize_triangle(cam0.uniform("cpu").proj_view, *TRIANGLE,
                                                TRIANGLE_COLOR, w, h)
    return {name: to_uint8(present(hdr[name])).numpy() for name in NAMES}


def is_repo_goldens(path: str) -> bool:
    """Whether ``path`` is the committed goldens' directory: this checkout's
    tests/goldens, or any directory ending in tests/goldens."""
    real = os.path.realpath(path)
    parent, name = os.path.split(real)
    return (real == os.path.realpath(REPO_GOLDENS)
            or (name == "goldens" and os.path.basename(parent) == "tests"))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Render tests/test_golden.py's four 160x90 golden frames with the port's "
                    "oracles. Runs on the CPU, as the JAX tool does.")
    parser.add_argument("--out-dir", default=os.path.join(DEFAULT_OUT_DIR, "goldens"),
                        help="where the four PNGs go (default $TMPDIR/vokselis_torch/goldens); "
                             "tests/goldens/ holds the reference's goldens and is refused")
    args = parser.parse_args(argv)
    if is_repo_goldens(args.out_dir):
        parser.error(f"{args.out_dir} holds the committed goldens, made by the JAX tool; "
                     "write them elsewhere")
    imgs = frames()
    os.makedirs(args.out_dir, exist_ok=True)
    for name, img in imgs.items():
        write_png(os.path.join(args.out_dir, name), img)
    print(f"goldens written to {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
