"""Render every configuration of the port with its CUDA kernels and with the
port's torch oracles (``vokselis_torch/ops/reference.py``) and report the
per-pixel error (the counterpart of ``tools/parity_report.py``). Writes
``PARITY_REPORT_TORCH.md`` at the repository root, headed by the card's name
and power limit; ``PARITY_REPORT.md`` is the JAX package's record and is
never written.

    python3 -m vokselis_torch.tools.parity_report [--out PATH]

Needs a CUDA card and refuses to run without one. Exits 1 when a row's mean
error is over its limit. The rows: config 1 (the trig field, 512^2), config 2
(the xor field, 512^2, both normals), config 3 (the 256^3 bonsai, 1024^2,
bench pose) and the same frame on the dense-stress volume, config 4 (the
1920x1080 orbit, every pose, exact and hybrid at I=1024 / budget 128),
config 5 at one view (K8's 512^3 volume at t = 0 and view 0 at 512^2, against
the plain volume's oracle march), and the fast renderer at I=512 (1024^2,
bench pose).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time
from dataclasses import dataclass

import torch

from vokselis_torch.core.camera import Camera
from vokselis_torch.models.orbit import BonsaiOrbit, orbit_poses
from vokselis_torch.models.views import full_diagonal
from vokselis_torch.ops import reference
from vokselis_torch.ops.cuda import genvol
from vokselis_torch.ops.cuda.march_bonsai import BonsaiRenderer
from vokselis_torch.ops.cuda.march_field import render_field
from vokselis_torch.ops.shear_warp import FastBonsaiRenderer
from vokselis_torch.parallel.sharding import orbit_camera_batch
from vokselis_torch.volume.io import dense_stress, get_bonsai

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(ROOT, "PARITY_REPORT_TORCH.md")
BUDGET = 1e-3  # mean per-pixel error (BASELINE.json), the hybrid's contract too
FAST_I512 = 1.25 * 0.00211  # PARITY_REPORT.md:60-63, I=512 default pose (rgba), 1.25x


@dataclass(frozen=True)
class Sizes:
    """The report's shapes: the bonsai volume's side, the config-3 frame,
    the config-4 frame and pose count, the field frame, config 5's volume
    and view, the fast and hybrid intermediates and the hybrid's budget."""

    bonsai: int = 256
    frame: int = 1024
    orbit: tuple = (1920, 1080)
    poses: int = 8
    field: int = 512
    density: int = 512
    view: int = 512
    fast_ii: int = 512
    hybrid_ii: int = 1024
    budget: int = 128


def smi_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``'s
    first line: the card's name and power limit."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def card_line(device) -> str:
    """The card as ``nvidia-smi`` names it, with its power limit."""
    if device.type != "cuda":
        return f"{device} (no card)"
    return f"{torch.cuda.get_device_name(device)} (nvidia-smi: {smi_line()})"


def compare(name, got, want, limit: float, channels: int = 3) -> dict:
    """One row: mean, max and the share over 1e-3 of |got - want| over the
    first ``channels`` channels, against the mean's ``limit``."""
    err = (got[..., :channels] - want[..., :channels]).abs()
    return {"name": name, "channels": "rgb" if channels == 3 else "rgba",
            "mean": float(err.mean()), "max": float(err.max()),
            "over": float((err > 1e-3).float().mean()), "limit": limit}


def rows(device, sizes: Sizes = Sizes()):
    """Yield the report's rows, each computed with the kernels (the plain
    versions on the CPU) beside its oracle."""
    s = sizes
    xor_u = Camera.xor(1.0).uniform(device)
    trig = render_field(xor_u, 0.0, s.field, s.field, field="trig", shading="emission",
                        quantize=False)
    yield compare(f"config 1: trig field @{s.field}^2 (K7, emission)", trig,
                  reference.render_field(xor_u, 0.0, width=s.field, height=s.field), BUDGET)
    oracle = reference.render_compute_inline(xor_u, 0.0, width=s.field, height=s.field)
    for grad in ("fd", "analytic"):
        yield compare(f"config 2: xor fbm @{s.field}^2 (K7, {grad} normals)",
                      render_field(xor_u, 0.0, s.field, s.field, grad=grad), oracle, BUDGET)
    del trig, oracle

    bench = Camera.bonsai(1.0).uniform(device)
    bonsai = get_bonsai(s.bonsai)
    for name, vol in (("bonsai", bonsai), ("dense_stress", dense_stress(s.bonsai))):
        img = BonsaiRenderer(vol, device)(bench, s.frame, s.frame)
        vol_t = torch.from_numpy(vol).to(device)
        yield compare(f"config 3: {name} {s.bonsai}^3 @{s.frame}^2, bench pose (K1)", img,
                      reference.render_bonsai(vol_t, bench, s.frame, s.frame), BUDGET)
    del img, vol_t

    w, h = s.orbit
    orbit = BonsaiOrbit(bonsai, device, w, h, s.hybrid_ii, s.budget,
                        poses=orbit_poses(s.poses, w, h, device=device))
    frames = orbit()
    for i, (u, (mode, _, _)) in enumerate(zip(orbit.poses, frames.routes)):
        want = reference.render_bonsai(orbit.exact.vol, u, w, h)
        yield compare(f"config 4: orbit pose {i}/{s.poses} @{w}x{h} exact (K1)",
                      frames.exact[i], want, BUDGET)
        yield compare(f"config 4: orbit pose {i}/{s.poses} @{w}x{h} hybrid I={s.hybrid_ii} "
                      f"budget {s.budget} (route {mode})", frames.hybrid[i], want, BUDGET)
    del orbit, frames, want

    steps = full_diagonal(s.density)
    view = orbit_camera_batch(1, device=device)[0]
    vol5 = genvol.generate_density_u8(0.0, s.density, device)
    img = BonsaiRenderer(vol5, device)(view, s.view, s.view, steps)
    del vol5
    vol5_plain = genvol.generate_density_u8_plain(0.0, s.density, device)
    yield compare(f"config 5: K8 {s.density}^3 at t = 0 + view 0 @{s.view}^2 (K1, {steps} "
                  "steps) vs the plain volume's oracle", img,
                  reference.render_bonsai(vol5_plain, view, s.view, s.view, steps), BUDGET)
    del img, vol5_plain

    fast = FastBonsaiRenderer(bonsai, device, intermediate=s.fast_ii)(bench, s.frame, s.frame)
    yield compare(f"fast I={s.fast_ii} @{s.frame}^2, bench pose (K34 + K6; "
                  "an approximation, PARITY_REPORT.md's table)", fast,
                  reference.render_bonsai(torch.from_numpy(bonsai).to(device), bench, s.frame,
                                          s.frame), FAST_I512, channels=4)


def report(out: str = DEFAULT_OUT, device="cuda", sizes: Sizes = Sizes(), log=print):
    """Compute every row on ``device`` and write the report to ``out``.
    Returns the rows. A CUDA ``device`` without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the parity report runs the CUDA kernels: no CUDA card here")
    if os.path.basename(out) == "PARITY_REPORT.md":
        raise ValueError("PARITY_REPORT.md is the JAX package's record; write another file")
    lines = [
        "# PARITY REPORT (PyTorch + CUDA port) — kernels vs torch oracles",
        "",
        f"Device: {card_line(device)}. Each row: |kernel frame - oracle frame| over the "
        "channels named, its mean against the limit beside it.",
        "",
        "| config | over | mean err | max err | frac > 1e-3 | mean limit |",
        "|---|---|---|---|---|---|",
    ]
    found = []
    for row in rows(device, sizes):
        found.append(row)
        lines.append(f"| {row['name']} | {row['channels']} | {row['mean']:.3e} | "
                     f"{row['max']:.3e} | {row['over']:.3%} | {row['limit']:.3g}"
                     f"{'' if row['mean'] <= row['limit'] else ' OVER'} |")
        if log:
            log(lines[-1])
    lines += [
        "",
        "Limits: the error budget of BASELINE.json, mean per-pixel error <= 1e-3 (the "
        "hybrid's contract too), and for the fast renderer, an approximation, 1.25x "
        "PARITY_REPORT.md's I=512 default-pose mean (over rgba). A config-4 pose whose "
        "route is \"exact\" is one the shear-warp factorization breaks at: the hybrid "
        "renders it with K1.",
        "",
        f"Generated by vokselis_torch/tools/parity_report.py, {time.strftime('%Y-%m-%d %H:%M')}.",
    ]
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    if log:
        log(f"wrote {out}")
    return found


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=DEFAULT_OUT, help="the report's path")
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    found = report(args.out)
    return 1 if any(r["mean"] > r["limit"] for r in found) else 0


if __name__ == "__main__":
    raise SystemExit(main())
