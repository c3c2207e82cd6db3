"""Split the hybrid frame's cost, from the operating-point checkpoints, into
(the port of ``tools/fit_budget_slope.py``)

    ms(budget) ~= intercept + slope * budget

- intercept - fast_ms = the scoring and merge tax on top of the fast frame;
- slope               = the exact re-march's price per tile (K2), in µs.

    python -m vokselis_torch.tools.fit_budget_slope [--ii 512] [--fast-ms MS] [--out-dir DIR]

Reads ``<out-dir>/hybrid_oppoint_<ii>.jsonl``, which
:mod:`vokselis_torch.tools.hybrid_operating_point` writes (the last record of
a budget wins), and fits the per-budget means, budget 0 included. The fast
frame's time is ``--fast-ms``, by default the ladder's budget-0 ``ms`` (the
fast frame through the hybrid path, timed on the same card). Numpy only: it
measures nothing and runs on no device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from vokselis_torch.tools.common import DEFAULT_OUT_DIR


def load_checkpoint(path: str) -> list:
    """The checkpoint's records by budget, the last write of each winning."""
    recs = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            recs[r["budget"]] = r
    return sorted(recs.values(), key=lambda r: r["budget"])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ii", type=int, default=512, help="the ladder's intermediate I")
    parser.add_argument("--fast-ms", type=float, default=None,
                        help="the fast frame's ms (default: the ladder's budget-0 ms)")
    parser.add_argument("--out-dir", default=DEFAULT_OUT_DIR,
                        help="where hybrid_operating_point wrote its checkpoints")
    args = parser.parse_args(argv)
    ii = args.ii
    path = os.path.join(args.out_dir, f"hybrid_oppoint_{ii}.jsonl")
    if not os.path.exists(path):
        sys.exit(f"no checkpoints at {path} — run vokselis_torch.tools.hybrid_operating_point")
    recs = load_checkpoint(path)
    if len(recs) < 2:
        sys.exit(f"need >=2 budgets to fit, have {len(recs)}")
    fast_ms = args.fast_ms
    if fast_ms is None:
        fast_ms = next((r["ms"] for r in recs if r["budget"] == 0), None)
        if fast_ms is None:
            sys.exit("the ladder has no budget-0 record: give --fast-ms")

    b = np.array([r["budget"] for r in recs], float)
    ms = np.array([r["ms"] for r in recs], float)
    slope, intercept = np.polyfit(b, ms, 1)

    print(f"I={ii}: {len(recs)} budgets {[int(x) for x in b]}")
    for r in recs:
        fit = intercept + slope * r["budget"]
        print(f"  budget={r['budget']:4d}: {r['ms']:7.3f} ms "
              f"({r['mrays']:6.1f} Mrays/s)  fit {fit:6.3f}  "
              f"resid {r['ms'] - fit:+6.3f}")
    print(f"\nintercept          = {intercept:.3f} ms")
    print(f"  - fast frame     = {fast_ms:.3f} ms")
    print(f"  = scoring/merge  = {intercept - fast_ms:.3f} ms")
    print(f"slope (re-march)   = {slope * 1000:.2f} us/tile")
    tgt = 1024 * 1024 / 500e6 * 1e3
    print(f"budget at 500 Mrays/s ({tgt:.3f} ms): "
          f"{(tgt - intercept) / slope:.0f} tiles")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
