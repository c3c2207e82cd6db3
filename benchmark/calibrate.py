"""Read the two ends of each limit ``correct`` compares, on the card.

    python benchmark/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 2

For each seed, in one process, runs the cell's driver for a short window at
the cell's own size and load, then recomputes its sampled answers with the
float32 reference and with the control (the reference in bfloat16, put in
the program's place) and prints, for each number compared, the program's
reading (a sound run: the lower end) and the control's (the upper end), one
JSON line a seed. A limit is set between the largest lower and the
smallest upper reading. The benchmark's own runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def readings(driver, outputs, against) -> dict:
    """The largest of each number compared over the sampled answers."""
    worst = {}
    for out, ref in zip(outputs, against):
        for k, v in driver.compare(out, ref).items():
            worst[k] = max(worst.get(k, v), v)
    return worst


def calibrate(cell: str, seed: int, seconds: float, device="cuda") -> dict:
    import torch

    from benchmark.run import load_spec, resolve

    _, cfg, mix = resolve(load_spec(), cell)
    driver = importlib.import_module(f"benchmark.drivers.{cfg['entry']}").make(
        cfg, mix, seed, device)
    rec = driver.measure(seconds, False, time.perf_counter())
    driver.release()
    outputs = driver.program_outputs()
    ref = driver.reference(torch.float32)
    ctrl = driver.reference(torch.bfloat16)
    return {"seed": seed, "checked": len(outputs), "attempted": rec["attempted"],
            "program": readings(driver, outputs, ref), "control": readings(driver, ctrl, ref)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(calibrate(args.workload, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the repository's root, not this script's directory
    sys.exit(main())
