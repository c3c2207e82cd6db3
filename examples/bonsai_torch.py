#!/usr/bin/env python
"""Bonsai demo on the PyTorch + CUDA port (vokselis_torch): raymarch the
256^3 CT volume with the hand-written march kernel, or render it with the
shear-warp kernels (``--fast``) or the hybrid renderer (``--hybrid``: the
fast frame with its worst tiles re-marched exactly). ``--volume`` marches
another volume, an Open SciVis Datasets ``.raw`` file whose name gives its
dims and type (e.g. ``kingsnake_1024x1024x795_uint8.raw``, or a float32
field such as ``miranda_1024x1024x1024_float32.raw``, mapped by its data
range), with the exact renderer: it takes any (D, H, W) uint8 or float32
volume, fast and hybrid only uint8 cubes.

Same command line as examples/bonsai.py. Runs on the CUDA card; ``--cpu``
runs the kernels' plain torch versions on the CPU instead.
"""

from common import make_parser, orbit_events


def main():
    parser = make_parser("bonsai")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument(
        "--fast", action="store_true",
        help="shear-warp renderer (approximate, intermediate I=512)",
    )
    mode.add_argument(
        "--hybrid", action="store_true",
        help="hybrid renderer (shear-warp frame, worst tiles re-marched exactly)",
    )
    parser.add_argument(
        "--volume", default=None,
        help="an Open SciVis uint8 or float32 .raw file to march with the exact renderer, "
             "its dims and type read from its name (<name>_<x>x<y>x<z>_<uint8|float32>.raw)",
    )
    args = parser.parse_args()
    if args.volume and (args.fast or args.hybrid):
        parser.error("--volume takes the exact renderer only")
    from vokselis_torch.engine.loop import run
    from vokselis_torch.models.bonsai import BonsaiDemo

    demo_cls = BonsaiDemo
    renderer = "fast" if args.fast else "hybrid" if args.hybrid else "exact"
    if renderer != "exact" or args.volume:
        class demo_cls(BonsaiDemo):  # noqa: N801 - init-arg shim for run()
            @classmethod
            def init(cls, ctx):
                return BonsaiDemo.init(ctx, renderer=renderer, volume=args.volume)

    camera = BonsaiDemo.default_camera(args.width / args.height)
    events = orbit_events(args.frames, args.width, args.height) if args.orbit else None
    ctx = run(
        demo_cls,
        width=args.width,
        height=args.height,
        camera=camera,
        frames=args.frames,
        events=events,
        watch=args.watch,
        device="cpu" if args.cpu else "cuda",
    )
    if args.out:
        from vokselis_torch.media.png import write_png
        from vokselis_torch.ops.present import to_uint8

        write_png(args.out, to_uint8(ctx.display_image).cpu().numpy())
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
