"""The hybrid renderer's pose sweep: per-pose mean |hybrid - exact| over rgb
on the 72-pose grid, zoom {0.6, 1.0, 1.6} x pitch {0.5, -0.35, 1.2} x 8 yaws,
aspect 1, target (0.5, 0.5, 0.5), against the port's own exact frame (the
march kernel K1, or its plain version on the CPU). The port of
``tools/cpu_minisweep.py`` (256^2, I=256, budget 32 on the CPU) and
``tools/hybrid_sweep.py`` (1024^2, I=1024, budget 64 on the card); the
hybrid's contract is every pose's mean <= 1e-3.

    python -m vokselis_torch.tools.hybrid_sweep --device cuda --size 1024 --ii 1024 --budget 64
    python -m vokselis_torch.tools.hybrid_sweep --device cpu --size 256 --ii 256 --budget 32

Prints one line per pose (mean, max, and how it rendered: hybrid, escalated
to a larger intermediate, or the exact kernel), then the worst pose, the
mean of the means, the count over 1e-3 and the routes' counts.
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from vokselis_torch.core.camera import Camera
from vokselis_torch.ops.cuda.march_bonsai import BonsaiRenderer
from vokselis_torch.ops.hybrid import HybridBonsaiRenderer
from vokselis_torch.tools.common import add_device_arg, device_of
from vokselis_torch.volume.io import get_bonsai

ZOOMS = (0.6, 1.0, 1.6)
PITCHES = (0.5, -0.35, 1.2)
N_YAW = 8
CONTRACT = 1e-3


def poses(n_yaw: int = N_YAW):
    """The grid's (key, Camera) pairs, in tools/cpu_minisweep.py's order."""
    for zoom in ZOOMS:
        for pitch in PITCHES:
            for i in range(n_yaw):
                yield f"{zoom}/{pitch}/{i}", Camera(
                    zoom=zoom, pitch=pitch, yaw=2 * math.pi * i / n_yaw,
                    target=(0.5, 0.5, 0.5), aspect=1.0)


def sweep(device, size: int, intermediate: int, budget: int, vol=None,
          n_yaw: int = N_YAW, log=print):
    """Run the sweep; returns (records, summary). Each record: pose key,
    mean and max |hybrid - exact| over rgb, route ("hybrid", "escalated",
    "exact" or "dense") and seconds."""
    vol = get_bonsai() if vol is None else vol
    hyb = HybridBonsaiRenderer(vol, device, intermediate=intermediate, budget=budget)
    exact = BonsaiRenderer(vol, device)
    records = []
    for key, cam in poses(n_yaw):
        u = cam.uniform(device)
        t0 = time.perf_counter()
        route = hyb.route(u, size, size)[0]
        d = (hyb(u, size, size)[..., :3] - exact(u, size, size)[..., :3]).abs()
        rec = {"pose": key, "mean": float(d.mean()), "max": float(d.max()),
               "route": route, "sec": time.perf_counter() - t0}
        records.append(rec)
        if log:
            flag = " <-- over" if rec["mean"] > CONTRACT else ""
            log(f"pose {key}: mean {rec['mean']:.3e} max {rec['max']:.4f} "
                f"route {route}{flag}")
    means = [r["mean"] for r in records]
    summary = {"poses": len(records), "worst": max(means),
               "mean_of_means": sum(means) / len(means),
               "over": sum(m > CONTRACT for m in means),
               "routes": {k: sum(r["route"] == k for r in records)
                          for k in ("hybrid", "escalated", "exact", "dense")},
               "size": size, "intermediate": intermediate, "budget": budget,
               "device": str(torch.device(device))}
    return records, summary


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_arg(parser)
    parser.add_argument("--size", type=int, default=1024, help="frame side, pixels")
    parser.add_argument("--ii", type=int, default=1024, help="intermediate I")
    parser.add_argument("--budget", type=int, default=64, help="re-march budget, tiles")
    args = parser.parse_args(argv)
    device_of(parser, args)
    t0 = time.perf_counter()
    _, s = sweep(args.device, args.size, args.ii, args.budget)
    print(f"sweep ({s['poses']} poses, {args.size}^2, I={args.ii}, budget "
          f"{args.budget}, {s['device']}): worst {s['worst']:.3e}, mean-of-means "
          f"{s['mean_of_means']:.3e}, over {CONTRACT:g}: {s['over']}, routes "
          f"{s['routes']} [{time.perf_counter() - t0:.0f} s]")
    return 1 if s["over"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
