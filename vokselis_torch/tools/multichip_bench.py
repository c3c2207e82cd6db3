"""Multi-device benchmark of the port: one command, two measurements (the
counterpart of ``tools/multichip_bench.py``).

  A. view-sharded weak scaling (config 5's batched orbit views as data
     parallelism over the mesh's 'views' dimension): a fixed number of views
     per device, a growing device count; ms per batch, Mrays/s and the weak
     efficiency against the 1-device row;
  B. row-sharded single-frame latency: ONE frame's rows split over the
     devices, an all-gather assembling it; ms per frame and the speedup
     against 1 device.

    python -m vokselis_torch.tools.multichip_bench [--devices N] [--views V]
        [--width W] [--height H] [--max-steps S] [--json] [--cpu]

On the card the world is an NCCL group with one process per card
(``--devices``, by default every card of the machine; more than it has
raises) at 512^2, 8 views per card, 444 steps, the 256^3 bonsai, each time
the slope between 1 and 5 calls. ``--cpu`` runs a gloo group of ``--devices``
processes (default 8) on the CPU at 48^2, 2 views per process, 16 steps,
the 32^3 bonsai, each time the fastest of 3 calls. The world of each row is
a process group of its size over the first processes (ranks 0 .. c-1); the
rows time the compiled steps of ``vokselis_torch.parallel.sharding``, as the
JAX tool times its jitted ones: each process builds its renderer pairs once,
so on a card each row's first call captures its step, NCCL collectives
inside, into one CUDA graph (one capture per key, which the row checks), and
the timed calls replay it; on the CPU every call runs the eager step.
The processes start through ``torch.multiprocessing.spawn`` and meet
through ``file://`` stores in a temporary directory. A line per row goes to
stdout, and with ``--json`` one JSON object per row after them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vokselis_torch.core.camera import Camera
from vokselis_torch.parallel import sharding
from vokselis_torch.volume.io import get_bonsai

CHIPS = (1, 2, 4, 8, 16, 32)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="world size (default: every card; 8 processes with --cpu)")
    ap.add_argument("--views", type=int, default=None,
                    help="views per device for the weak-scaling row (default: 8 on a card, "
                         "2 on the CPU)")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON line per measurement")
    ap.add_argument("--cpu", action="store_true",
                    help="a gloo world of processes on the CPU instead of the cards")
    return ap.parse_args(argv)


def _time_call(fn, on_card: bool, n_hi: int = 5, repeats: int = 3) -> float:
    """Seconds per call of ``fn``: on a card the median over ``repeats`` of the
    slope between 1 and ``n_hi`` back-to-back calls, each run ending by
    waiting for the card; on the CPU the fastest of ``repeats`` calls."""
    def once(n):
        t = time.perf_counter()
        for _ in range(n):
            fn()
        if on_card:
            torch.cuda.synchronize()
        return time.perf_counter() - t

    once(1)
    once(1)  # warm: builds, tables, the caching allocator's blocks
    if not on_card:
        return min(once(1) for _ in range(repeats))
    slopes = []
    for _ in range(repeats):
        t1 = once(1)
        tn = once(n_hi)
        slopes.append(max((tn - t1) / (n_hi - 1), 1e-9))
    return float(np.median(slopes))


def _time_row(steps, fn, on_card: bool) -> float:
    """:func:`_time_call` of a row's compiled step ``fn``, whose cache is
    ``steps``: the row holds one key (one capture on a card)."""
    before = steps.captures
    sec = _time_call(fn, on_card)
    if steps.captures != before + 1:
        raise RuntimeError(f"multichip_bench: {steps.name} captured {steps.captures - before} "
                           f"times in one row, not once")
    return sec


def _sizes(args, on_card: bool) -> dict:
    return {"width": args.width or (512 if on_card else 48),
            "height": args.height or (512 if on_card else 48),
            "views": args.views or (8 if on_card else 2),
            "max_steps": args.max_steps or (444 if on_card else 16),
            "bonsai": 256 if on_card else 32}


def _rank_main(rank: int, cfg: dict, tmp: str):
    """One process: for each row's world c it belongs to (rank < c), join that
    group, time rows A and B on it, leave it. Rank 0 writes the seconds."""
    on_card = cfg["on_card"]
    if on_card:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    w, h, steps = cfg["width"], cfg["height"], cfg["max_steps"]
    vol = get_bonsai(cfg["bonsai"])
    render, pack = sharding.build_default_renderer(vol, dev)
    ray_renderer = sharding.build_ray_renderer(vol, dev)
    cam = Camera.bonsai(1.0).uniform(dev)
    secs = {"A": {}, "B": {}}
    for c in cfg["chips"]:
        if rank >= c:
            continue
        dist.init_process_group("nccl" if on_card else "gloo",
                                init_method=f"file://{tmp}/store{c}", world_size=c, rank=rank)
        try:
            mesh = sharding.make_mesh(views=c, tiles=1, device=dev)
            cams = sharding.orbit_camera_batch(c * cfg["views"], device=dev)
            secs["A"][c] = _time_row(
                sharding.VIEWS_STEPS,
                lambda: sharding.render_views_sharded(mesh, render, pack, cams, w, h,
                                                      max_steps=steps), on_card)
            if h % c == 0:
                mesh = sharding.make_mesh(views=1, tiles=c, device=dev)
                secs["B"][c] = _time_row(
                    sharding.TILED_STEPS,
                    lambda: sharding.render_frame_tiled(mesh, vol, cam, w, h, max_steps=steps,
                                                        renderer=ray_renderer), on_card)
        finally:
            # NCCL keeps a communicator until the graphs of its collectives are gone
            sharding.clear_steps()
            dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(tmp, "secs.json"), "w") as f:
            json.dump(secs, f)


def _world(args) -> tuple:
    """(world size, on a card, the first stderr line)."""
    if args.cpu:
        world = 8 if args.devices is None else args.devices
        return world, False, (f"device: cpu (no card), a gloo world of {world} processes; each "
                              f"row runs its compiled step eagerly (off the card nothing is "
                              f"captured)")
    if not torch.cuda.is_available():
        raise RuntimeError("multichip_bench: no CUDA card (torch.cuda.is_available() is False); "
                           "--cpu runs a gloo world on the CPU")
    from vokselis_torch.tools.parity_report import card_line

    cards = torch.cuda.device_count()
    world = cards if args.devices is None else args.devices
    if world > cards:
        raise RuntimeError(f"multichip_bench: {world} devices asked, this machine has {cards} "
                           f"card(s)")
    return world, True, (f"device: {card_line(torch.device('cuda', 0))}; NCCL, one process per "
                         f"card: this machine has {cards} card(s), so worlds above {cards} "
                         f"are not measured here; each row times its compiled step's "
                         f"replays (one CUDA graph, its collectives inside)")


def run(argv=None) -> list:
    """Measure rows A and B; returns them as the JSON objects it prints."""
    args = parse_args(argv)
    world, on_card, header = _world(args)
    cfg = _sizes(args, on_card)
    chips = [c for c in CHIPS if c <= world]
    if world not in chips:
        chips.append(world)
    cfg.update(on_card=on_card, chips=chips)
    print(f"{header}; backend={'nccl' if on_card else 'gloo'} devices={world} "
          f"frame={cfg['width']}x{cfg['height']} views/chip={cfg['views']} "
          f"max_steps={cfg['max_steps']}", file=sys.stderr, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(cfg, tmp), nprocs=world, join=True)
        with open(os.path.join(tmp, "secs.json")) as f:
            secs = {k: {int(c): s for c, s in v.items()} for k, v in json.load(f).items()}

    w, h, per = cfg["width"], cfg["height"], cfg["views"]
    results = []
    base_ms = None
    for c in chips:
        sec = secs["A"][c]
        ms = sec * 1e3
        eff = 1.0 if base_ms is None else base_ms / ms
        base_ms = ms if base_ms is None else base_ms
        row = {"mode": "views_weak_scaling", "chips": c, "views": c * per,
               "ms_per_batch": round(ms, 2), "mrays_s": round(c * per * w * h / sec / 1e6, 1),
               "weak_efficiency": round(eff, 3)}
        results.append(row)
        print(f"A chips={c:2d} views={c * per:3d}: {ms:8.3f} ms/batch  "
              f"{row['mrays_s']:8.1f} Mrays/s  eff={eff:.2f}", flush=True)
    base_ms = None
    for c in [c for c in chips if h % c == 0]:
        sec = secs["B"][c]
        ms = sec * 1e3
        speedup = 1.0 if base_ms is None else base_ms / ms
        base_ms = ms if base_ms is None else base_ms
        row = {"mode": "frame_row_sharded", "chips": c, "ms_per_frame": round(ms, 2),
               "mrays_s": round(w * h / sec / 1e6, 1), "speedup": round(speedup, 2)}
        results.append(row)
        print(f"B chips={c:2d} frame {w}x{h}: {ms:8.3f} ms {row['mrays_s']:8.1f} Mrays/s  "
              f"speedup={speedup:.2f}", flush=True)
    if args.json:
        for row in results:
            print(json.dumps(row), flush=True)
    return results


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    # the spawned processes find _rank_main under the package's module name
    from vokselis_torch.tools import multichip_bench

    sys.exit(multichip_bench.main())
