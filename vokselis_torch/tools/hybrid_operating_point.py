"""The hybrid's operating point on this card: for each re-march budget, the
mean |hybrid - exact| over rgb at six probe poses and the slope-timed frame
at the bench pose, then the linear cost fit and the choice of the JAX
package's rule (the port of ``tools/hybrid_operating_point.py``).

    python -m vokselis_torch.tools.hybrid_operating_point [--ii 512] [--budgets 0,16,...]
    python -m vokselis_torch.tools.hybrid_operating_point --device cpu --size 128 --dims 64 \\
        --ii 128 --budgets 0,4,8 --out /tmp/op.json

The rule (the conjunction of the north star, BASELINE.json): the largest
budget whose probe errors are all <= 8e-4 (a margin under the 1e-3
contract) at >= 500 Mrays/s; failing that, the fastest budget > 0 whose
probe errors are all <= 1e-3. The fit ms = a + b * budget runs over every
repeat of the budgets > 0 (budget 0 times the fast frame through the hybrid
path, with no scoring: the fit's floor, not its intercept).

Each budget is a new :class:`HybridBonsaiRenderer`: its errors come from the
routed frame (``_call_traced``) against the exact K1 frame
(``build_renderer``), its time from
``VOK_OPPOINT_REPEATS`` (default 3) independent :func:`slope_time` runs of
``functional()``'s replays at the bench pose. After the ladder the first
measured budget is timed again (the drift sentinel: the gap bounds the
card's drift within the run).

Each budget's record is appended to ``<out-dir>/hybrid_oppoint_<ii>.jsonl``
as it is measured, and a rerun resumes from it. The result (the JAX tool's
keys and ``card``, ``nvidia-smi``'s name and power limit) is written to
``--out`` (default ``OPPOINT_TORCH.json`` at the repository's root) and to
``<out-dir>/oppoint_<ii>.json``, and printed as the last line. It never
writes ``OPPOINT.json``, the JAX package's record that the port's bench
reads. Runs on the card; ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from pathlib import Path

import numpy as np
import torch

from vokselis_torch.core.camera import Camera
from vokselis_torch.ops.cuda.march_bonsai import build_renderer
from vokselis_torch.ops.hybrid import HybridBonsaiRenderer
from vokselis_torch.ops.shear_warp import pose_hint
from vokselis_torch.tools.common import (
    DEFAULT_OUT_DIR,
    add_device_arg,
    card_of,
    device_of,
    frame_ms,
    mean_rgb_err,
)
from vokselis_torch.volume.io import get_bonsai

ROOT = Path(__file__).resolve().parents[2]
DEFAULT_OUT = ROOT / "OPPOINT_TORCH.json"
SIZE = 1024
ERR_MARGIN = 8e-4  # margin under the 1e-3 budget for sweep-wide safety
ERR_TARGET = 1e-3  # the north-star error budget itself
MRAYS_TARGET = 500.0
DEFAULT_BUDGETS = (0, 16, 32, 48, 64, 96, 128)


def probe_poses() -> dict:
    """The six probe poses (tools/hybrid_operating_point.py:61-80): the bench
    pose, three of the round-3 error probes, and the tilted diagonal and the
    steep pitch the 72-pose sweep failed at budget 32 when only the first
    four were probed."""
    c = dict(target=(0.5, 0.5, 0.5), aspect=1.0)
    return {
        "bench": Camera.bonsai(1.0),
        "z1.0-axis": Camera(zoom=1.0, pitch=0.0, yaw=0.0, **c),
        "z1.6-diag": Camera(zoom=1.6, pitch=0.5, yaw=math.pi / 4, **c),
        "z1.0-tilt": Camera(zoom=1.0, pitch=-0.35, yaw=0.0, **c),
        "z1.0-dtilt": Camera(zoom=1.0, pitch=-0.35, yaw=7 * math.pi / 4, **c),
        "z1.0-steep": Camera(zoom=1.0, pitch=1.2, yaw=0.0, **c),
    }


def n_repeats() -> int:
    return int(os.environ.get("VOK_OPPOINT_REPEATS", "3"))


def replay_frame(hyb: HybridBonsaiRenderer, u0, size: int):
    """The timed frame: one call of ``hyb.functional()``'s render at the
    pose ``u0`` (on a card a replay of its graph), with no host-side pose
    classification."""
    frender, fpack = hyb.functional()
    hint = pose_hint(u0, size, size, hyb.intermediate, hyb.dims)
    return lambda: frender(fpack, u0, size, size, hint=hint)


def measure_budget(vol, device, ii: int, budget: int, size: int, exact: dict, poses: dict,
                   repeats: int):
    """One ladder record (tools/hybrid_operating_point.py:139-148) and the
    bench pose's timed frame."""
    t0 = time.time()
    hyb = HybridBonsaiRenderer(vol, device, intermediate=ii, budget=budget)
    errs = {}
    for name, cam in poses.items():
        h = hyb._call_traced(cam.uniform(device), size, size)
        errs[name] = mean_rgb_err(h, exact[name])
    frame = replay_frame(hyb, poses["bench"].uniform(device), size)
    reps = [frame_ms(frame, device) for _ in range(repeats)]
    ms_mean = float(np.mean(reps))
    rec = {"budget": budget, "ii": ii, "ms": round(ms_mean, 3),
           "ms_reps": [round(r, 3) for r in reps],
           "ms_spread": round(float(np.max(reps) - np.min(reps)), 3),
           "mrays": round(size * size / (ms_mean / 1000) / 1e6, 1),
           "errs": {k: round(v, 9) for k, v in errs.items()},
           "wall_s": round(time.time() - t0, 1)}
    return rec, frame


def fit_ladder(results) -> dict:
    """The cost model ms = intercept + slope * budget, fitted over every
    repeat of the budgets > 0 (tools/hybrid_operating_point.py:156-168),
    with the rms residual, the point count and the budget-0 frame's ms."""
    fitr = [r for r in results if r["budget"] > 0]
    bs = np.array([float(r["budget"]) for r in fitr for _ in r.get("ms_reps", [r["ms"]])],
                  np.float64)
    ms = np.array([m for r in fitr for m in r.get("ms_reps", [r["ms"]])], np.float64)
    if len(fitr) >= 2:
        slope, intercept = np.polyfit(bs, ms, 1).tolist()
        resid = float(np.sqrt(np.mean((ms - (intercept + slope * bs)) ** 2)))
    else:
        slope, intercept = 0.0, float(ms[0]) if len(ms) else 0.0
        resid = 0.0
    return {"intercept_ms": round(intercept, 3),
            "slope_ms_per_tile": round(slope, 5),
            "fit_rms_resid_ms": round(resid, 3),
            "n_fit_points": int(len(ms)),
            "pure_fast_ms": next((r["ms"] for r in results if r["budget"] == 0), None)}


def choose_operating_point(results):
    """``(chosen, conjunction)`` by the JAX package's rule
    (tools/hybrid_operating_point.py:170-186): the largest budget whose
    errors are all <= 8e-4 at >= 500 Mrays/s (the conjunction); else the
    fastest budget > 0 whose errors are all <= 1e-3; ``chosen`` is that
    record with ``conjunction`` added, or None when no budget clears."""
    conj = [r for r in results
            if max(r["errs"].values()) <= ERR_MARGIN and r["mrays"] >= MRAYS_TARGET]
    if conj:
        chosen, is_conj = max(conj, key=lambda r: r["budget"]), True
    else:
        ok = [r for r in results
              if r["budget"] > 0 and max(r["errs"].values()) <= ERR_TARGET]
        chosen = max(ok, key=lambda r: r["mrays"]) if ok else None
        is_conj = False
    return (None if chosen is None else dict(chosen, conjunction=is_conj)), is_conj


def note_of(chosen, is_conj: bool) -> str:
    if is_conj:
        return "conjunction satisfied"
    if chosen is not None:
        return ("no 500-Mrays/s conjunction on this chip; operating point = fastest "
                "error-clearing budget")
    return "NO budget meets the error target at this ii"


def run(device, ii: int, budgets, size: int = SIZE, vol=None, out_dir=DEFAULT_OUT_DIR,
        repeats: int | None = None, log=print) -> dict:
    """The ladder, the fit, the choice and the drift sentinel; returns the
    result that :func:`main` writes (without ``card``)."""
    device = torch.device(device)
    repeats = n_repeats() if repeats is None else repeats
    vol = get_bonsai() if vol is None else vol
    poses = probe_poses()
    render, pack = build_renderer(vol, device)
    exact = {k: render(pack, c.uniform(device), size, size) for k, c in poses.items()}

    os.makedirs(out_dir, exist_ok=True)
    ckpt_path = os.path.join(out_dir, f"hybrid_oppoint_{ii}.jsonl")
    done = {}
    if os.path.exists(ckpt_path):
        with open(ckpt_path) as f:
            for line in f:
                rec = json.loads(line)
                done[rec["budget"]] = rec
        log(f"resuming: {len(done)} budgets from {ckpt_path}")

    results = []
    first = None  # (record, timed frame) of the first budget measured in this run
    with open(ckpt_path, "a") as ckpt:
        for budget in budgets:
            if budget in done:
                results.append(done[budget])
                log(f"budget={budget}: cached {done[budget]}")
                continue
            rec, frame = measure_budget(vol, device, ii, budget, size, exact, poses, repeats)
            results.append(rec)
            ckpt.write(json.dumps(rec) + "\n")
            ckpt.flush()
            if first is None:
                first = (rec, frame)
            log(rec)

    fit = fit_ladder(results)
    chosen, is_conj = choose_operating_point(results)
    drift = None
    if first is not None:
        end_reps = [frame_ms(first[1], device) for _ in range(repeats)]
        drift = {"budget": first[0]["budget"], "start_ms": first[0]["ms"],
                 "end_ms": round(float(np.mean(end_reps)), 3),
                 "end_reps": [round(r, 3) for r in end_reps]}
        log(f"drift sentinel: {drift}")
    return {"operating_point": chosen, "fit": fit, "drift_sentinel": drift,
            "ladder": results, "note": note_of(chosen, is_conj)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_arg(parser)
    parser.add_argument("--ii", type=int, default=512, help="the hybrid's intermediate I")
    parser.add_argument("--budgets", default=",".join(map(str, DEFAULT_BUDGETS)),
                        help="re-march budgets (tiles), comma-separated")
    parser.add_argument("--size", type=int, default=SIZE, help="frame side, pixels")
    parser.add_argument("--dims", type=int, default=256, help="the bonsai volume's side")
    parser.add_argument("--out", default=str(DEFAULT_OUT), help="the result's JSON file")
    parser.add_argument("--out-dir", default=DEFAULT_OUT_DIR,
                        help="checkpoints and a copy of the result")
    args = parser.parse_args(argv)
    device = device_of(parser, args)
    if os.path.basename(args.out) == "OPPOINT.json":
        parser.error("OPPOINT.json is the JAX package's record; write another file")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_of(device)
    print(f"device: {card}", flush=True)
    out = run(device, args.ii, [int(b) for b in args.budgets.split(",")], args.size,
              get_bonsai(args.dims), args.out_dir)
    out["card"] = card
    with open(os.path.join(args.out_dir, f"oppoint_{args.ii}.json"), "w") as f:
        json.dump(out, f)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
