#!/usr/bin/env python
"""Xor demo on the PyTorch + CUDA port (vokselis_torch): compute raymarch of
the procedural fbm volume with the hand-written field march kernel.

Same command line as examples/xor.py (pass --tile to start in Tile mode, the
F1 toggle). Runs on the CUDA card; ``--cpu`` runs the kernel's plain torch
version on the CPU instead. ``VOK_XOR_GRAD=fd`` takes the reference's
one-sided-difference normals instead of the analytic gradient.
"""

from common import make_parser, orbit_events


def main():
    parser = make_parser("xor")
    parser.add_argument("--tile", action="store_true", help="start in Tile mode")
    args = parser.parse_args()
    from vokselis_torch.engine.loop import run
    from vokselis_torch.models.xor import XorDemo

    camera = XorDemo.default_camera(args.width / args.height)

    def events():
        if args.tile:
            yield {"type": "key", "key": "f1", "pressed": True}
        if args.orbit:
            yield from orbit_events(args.frames, args.width, args.height)

    ctx = run(
        XorDemo,
        width=args.width,
        height=args.height,
        camera=camera,
        frames=args.frames,
        events=events(),
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
