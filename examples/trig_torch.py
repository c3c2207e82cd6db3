#!/usr/bin/env python
"""Trig demo on the PyTorch port (vokselis_torch): camera-transformed
triangle, rasterized in plain torch.

Same command line as examples/trig.py. Runs on the CUDA card; ``--cpu`` runs
on the CPU instead.
"""

from common import make_parser, orbit_events


def main():
    args = make_parser("trig").parse_args()
    from vokselis_torch.engine.loop import run
    from vokselis_torch.models.trig import TrigDemo

    events = orbit_events(args.frames, args.width, args.height) if args.orbit else None
    ctx = run(
        TrigDemo,
        width=args.width,
        height=args.height,
        camera=None,  # default pose, like run::<BasicTrig>(.., None)
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
