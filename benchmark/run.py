"""Run one cell of ``BENCHMARK.json`` on this machine's CUDA card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell names its configuration and its
traffic; the configuration's ``entry`` names the driver
(``benchmark/drivers/<entry>.py``), which sets up the program, warms up
every shape the cell's traffic uses, measures for ``--seconds`` and keeps a
sample of what the timed path produced. Once the window has closed the
plain reference (``benchmark/reference/``) recomputes that sample and the
run is ``correct`` when every number compared is within its limit (the
configuration's ``limits``). The metrics are read by one reader each,
``benchmark/metrics/<name>.py``: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer ones. The last line of standard
output is one JSON object; the numbers compared, each beside its limit,
are the last lines of standard error.

Without a CUDA card (or with fewer cards than the cell asks for), or with
JAX or the JAX package loaded in this process, it prints no result and
exits non-zero; it never falls back to the CPU.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

FORBIDDEN = ("jax", "jaxlib", "flax", "vokselis_tpu")
OK, NO_CARD, FORBIDDEN_LOADED, BAD_CELL = 0, 2, 3, 4


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(spec: dict, name: str, root: Path = ROOT):
    """The cell ``name`` of ``spec`` with its configuration and traffic mix,
    each read from its own file."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg = json.loads((root / configs[cell["config"]]["file"]).read_text())
    mix = json.loads((root / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, cfg, mix


def cell_metrics(spec: dict, cell_name: str, trace: bool) -> list:
    """The metrics a run of ``cell_name`` reports: with ``trace`` the
    per-layer ones, else the end-to-end ones. A metric with a ``workloads``
    list is the listed cells'; an end-to-end metric without one is every
    cell's; a per-layer metric without one goes with the end-to-end metric
    it moves."""
    e2e = {m["name"]: m for m in spec["end_to_end"]}

    def applies(m):
        if "workloads" in m:
            return cell_name in m["workloads"]
        return "moves" not in m or applies(e2e[m["moves"]])

    return [m for m in spec["per_layer" if trace else "end_to_end"] if applies(m)]


def reader(name: str, root: Path = ROOT):
    """The ``read(record)`` function of ``benchmark/metrics/<name>.py``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(spec: dict, cell_name: str, trace: bool, rec: dict, root: Path = ROOT) -> dict:
    """Every metric of the cell that its reader finds something to read for."""
    out = {}
    for m in cell_metrics(spec, cell_name, trace):
        value = reader(m["name"], root)(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    """The modules loaded in this process whose top-level name is JAX's,
    jaxlib's, flax's or the JAX package's (compared whole)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def judge(driver, outputs, reference, limits: dict):
    """``(correct, failed, checks)``: each number compared, the largest over
    the sampled answers, beside its limit; an answer fails when any of its
    numbers exceeds its limit, and a number without a limit fails."""
    worst, failed = {}, 0
    for out, ref in zip(outputs, reference):
        readings = driver.compare(out, ref)
        failed += any(limits.get(k) is None or v > limits[k] for k, v in readings.items())
        for k, v in readings.items():
            worst[k] = max(worst.get(k, v), v)
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in worst.items()}
    correct = bool(outputs) and failed == 0
    return correct, failed, checks


def run_cell(spec: dict, cell: dict, cfg: dict, mix: dict, seed: int, seconds: float,
             trace: bool, device="cuda", t_start: float = T_START):
    """Run the cell on ``device`` and judge it: its driver measures, the
    metrics are read, the program's state is freed, and the reference
    recomputes the sampled answers. Returns ``(record, metrics, correct,
    failed, checks)``."""
    import torch

    driver = importlib.import_module(f"benchmark.drivers.{cfg['entry']}").make(
        cfg, mix, seed, device)
    rec = driver.measure(seconds, trace, t_start)
    metrics = read_metrics(spec, cell["name"], trace, rec)
    driver.release()
    t_ref = time.perf_counter()
    outputs = driver.program_outputs()
    reference = driver.reference(torch.float32)
    correct, failed, checks = judge(driver, outputs, reference, cfg["limits"])
    rec["checked"], rec["reference_s"] = len(outputs), time.perf_counter() - t_ref
    return rec, metrics, correct, failed, checks


def window_line(rec: dict) -> str:
    """The window's units and its ms per unit in each quarter of it: a drift
    or a stall inside the window shows here."""
    stamps, n = rec["stamps"], len(rec["stamps"]) - 1
    cuts = [round(n * q / 4) for q in range(5)]
    quarters = [1e3 * (stamps[b] - stamps[a]) / (b - a) for a, b in zip(cuts, cuts[1:]) if b > a]
    return (f"window: {n} {rec['unit']}s in {stamps[-1] - stamps[0]:.3f} s; ms per "
            f"{rec['unit']} by quarter: {', '.join(f'{q:.4f}' for q in quarters)}")


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def device_info(rec: dict, trace: bool) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": rec["memory_peak_bytes"], "power_limit_w": power_limit_w()}
    prof = rec.get("profile")
    if trace and prof is not None:
        info["busy_s"], info["window_s"] = prof["busy_s"], prof["window_s"]
    return info


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = load_spec()
    try:
        cell, cfg, mix = resolve(spec, args.workload)
    except (KeyError, OSError) as e:
        print(f"bad workload: {e}", file=sys.stderr)
        return BAD_CELL

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result",
              file=sys.stderr)
        return NO_CARD
    torch.set_num_threads(2)
    trace = bool(args.trace)
    rec, metrics, correct, failed, checks = run_cell(spec, cell, cfg, mix, args.seed,
                                                     args.seconds, trace)
    device = device_info(rec, trace)

    bad = forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {', '.join(bad)}: no result",
              file=sys.stderr)
        return FORBIDDEN_LOADED
    result = {"correct": correct, "attempted": rec["attempted"], "failed": failed,
              "metrics": metrics, "device": device}
    prof = rec.get("profile")
    if trace and prof is not None:
        from benchmark.reduce import top

        result["breakdown"] = {"device_ops": top(prof["ops"]), "idle_gaps": top(prof["gaps"])}
    result["checks"] = checks
    print(window_line(rec), file=sys.stderr)
    print(f"reference: {rec['checked']} sampled {rec['unit']}(s) of {rec['attempted']} "
          f"checked in {rec['reference_s']:.3f} s", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return OK


if __name__ == "__main__":
    # this script's directory is no package root: the repository's is
    sys.path[0] = str(ROOT)
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
