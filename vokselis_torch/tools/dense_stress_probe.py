"""The fast and hybrid renderers on the dense-occupancy stress volume (the
port of ``tools/dense_stress_probe.py``): the 50 %-occupancy fog
(``volume/io.dense_stress``) leaves the occupancy gates nothing to skip and
marches rays deep. Does the hybrid's model of concentrated error hold there,
and what does each mode cost?

    python -m vokselis_torch.tools.dense_stress_probe [--budget 64] [--out-dir DIR]

Per pose: mean |mode - exact| over rgb, the exact K1 frame the ground truth
(the hybrid renders a volume this dense with K1: its error is 0 by
construction, ``HybridBonsaiRenderer.dense_fallback``). Then the exact, fast
(``--ii``, default 512) and hybrid frames slope-timed at the bench pose over their graphs'
replays. Writes ``<out-dir>/dense_stress.json`` and prints it. Runs on the
card; ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import json
import math
import os

import torch

from vokselis_torch.core.camera import Camera
from vokselis_torch.ops.cuda.march_bonsai import build_renderer
from vokselis_torch.ops.hybrid import HybridBonsaiRenderer
from vokselis_torch.ops.shear_warp import FastBonsaiRenderer, build_fast_renderer, pose_hint
from vokselis_torch.tools.common import (
    DEFAULT_OUT_DIR,
    add_device_arg,
    card_of,
    device_of,
    frame_ms,
    mean_rgb_err,
)
from vokselis_torch.volume.io import dense_stress

SIZE = 1024
FAST_II = 512  # the fast renderer's and the hybrid's default intermediate


def dense_poses() -> dict:
    """The three poses of tools/dense_stress_probe.py:42-48."""
    c = dict(target=(0.5, 0.5, 0.5), aspect=1.0)
    return {
        "bench": Camera.bonsai(1.0),
        "z1.0-axis": Camera(zoom=1.0, pitch=0.0, yaw=0.0, **c),
        "z1.6-diag": Camera(zoom=1.6, pitch=0.5, yaw=math.pi / 4, **c),
    }


def run(device, budget: int = 64, size: int = SIZE, dims: int = 256, poses=None,
        ii: int = FAST_II, log=print) -> dict:
    """The probe's record: ``budget``, ``<pose>_fast_err`` and
    ``<pose>_hybrid_err`` per pose, and ``exact_ms``, ``fast_ms`` and
    ``hybrid_ms`` at the bench pose (when it is among ``poses``)."""
    device = torch.device(device)
    all_poses = dense_poses()
    poses = list(all_poses) if poses is None else poses
    vol = dense_stress(dims)
    render, pack = build_renderer(vol, device)
    exact = {k: render(pack, all_poses[k].uniform(device), size, size) for k in poses}
    log("exact frames done")

    fast = FastBonsaiRenderer(vol, device, intermediate=ii)
    hyb = HybridBonsaiRenderer(vol, device, intermediate=ii, budget=budget)
    out = {"budget": budget}
    for name in poses:
        u = all_poses[name].uniform(device)
        ef = mean_rgb_err(fast(u, size, size), exact[name])
        eh = mean_rgb_err(hyb._call_traced(u, size, size), exact[name])
        out[f"{name}_fast_err"] = ef
        out[f"{name}_hybrid_err"] = eh
        log(f"{name}: fast {ef:.3e}  hybrid {eh:.3e}")
    if "bench" not in poses:
        return out

    u0 = all_poses["bench"].uniform(device)
    out["exact_ms"] = frame_ms(lambda: render(pack, u0, size, size), device)
    log(f"exact {out['exact_ms']:.3f} ms")
    frender_fast, fpack_fast = build_fast_renderer(vol, device, intermediate=ii)
    out["fast_ms"] = frame_ms(lambda: frender_fast(fpack_fast, u0, size, size), device)
    log(f"fast {out['fast_ms']:.3f} ms")
    frender, fpack = hyb.functional()
    hint = pose_hint(u0, size, size, hyb.intermediate, hyb.dims)
    out["hybrid_ms"] = frame_ms(lambda: frender(fpack, u0, size, size, hint=hint), device)
    log(f"hybrid {out['hybrid_ms']:.3f} ms")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_arg(parser)
    parser.add_argument("--budget", type=int, default=64, help="the hybrid's budget, tiles")
    parser.add_argument("--poses", default=",".join(dense_poses()),
                        help="poses, comma-separated, of " + ", ".join(dense_poses()))
    parser.add_argument("--ii", type=int, default=FAST_II,
                        help="the fast and hybrid frames' intermediate I")
    parser.add_argument("--size", type=int, default=SIZE, help="frame side, pixels")
    parser.add_argument("--dims", type=int, default=256, help="the volume's side")
    parser.add_argument("--out-dir", default=DEFAULT_OUT_DIR, help="where the JSON goes")
    args = parser.parse_args(argv)
    device = device_of(parser, args)
    poses = args.poses.split(",")
    if set(poses) - set(dense_poses()):
        parser.error(f"--poses of {list(dense_poses())}")
    print(f"device: {card_of(device)}", flush=True)
    out = run(device, args.budget, args.size, args.dims, poses, args.ii,
              log=lambda *a: print(*a, flush=True))
    print(json.dumps(out), flush=True)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "dense_stress.json"), "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
