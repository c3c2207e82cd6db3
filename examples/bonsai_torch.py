#!/usr/bin/env python
"""Bonsai demo on the PyTorch + CUDA port (vokselis_torch): raymarch the
256^3 CT volume with the hand-written march kernel, or render it with the
shear-warp kernels (``--fast``) or the hybrid renderer (``--hybrid``: the
fast frame with its worst tiles re-marched exactly).

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
    args = parser.parse_args()
    from vokselis_torch.engine.loop import run
    from vokselis_torch.models.bonsai import BonsaiDemo

    demo_cls = BonsaiDemo
    renderer = "fast" if args.fast else "hybrid" if args.hybrid else None
    if renderer:
        class demo_cls(BonsaiDemo):  # noqa: N801 - init-arg shim for run()
            @classmethod
            def init(cls, ctx):
                return BonsaiDemo.init(ctx, renderer=renderer)

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
