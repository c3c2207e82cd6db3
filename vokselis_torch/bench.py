"""Benchmark harness of the port: prints ONE JSON line with the flagship
metric (the counterpart of ``bench.py``, function by function).

    python -m vokselis_torch.bench [--all] [--cpu-oracle] [--skip-err]

Flagship: the 256^3 bonsai raymarched at 1024x1024 (BASELINE.json config 3)
through the exact march K1, reported as Mrays/sec/chip; ``vs_baseline`` is
the value over 500, the north-star target. The north star is a conjunction,
at least 500 Mrays/s AND at most 1e-3 mean error: the hybrid renderer (the
fast frame plus an exact re-march of the worst tiles) headlines the line
when its measured error against the exact frame is within 1e-3, and the
exact frame otherwise (:func:`flagship_line`).

Every frame is timed by :func:`slope_time`, the slope between a 1-frame and
an n-frame run, median of 5 repeats; a frame is one call of the port's
compiled entry (a CUDA graph replay, ``core/compiled.py``).

It measures the card. Without CUDA it exits 1 and says so, unless
``--cpu-oracle`` asks for the plain oracle (``ops/reference.render_bonsai``)
on the CPU: then only the config-3 row runs and ``mean_err`` is 0.0.
``--skip-err`` skips the oracle frame behind ``mean_err``. ``--all`` adds
the rest of BASELINE.json's table on stderr: the fast frame at I=512, the
dense-stress frame, the trig and xor fields at 512^2, the config-4 1080p
orbit (its hybrid only where bench.py's gate lets it) and config 5's 64-view
batch over a 512^3 volume regenerated each batch. The hybrid's operating
point is ``OPPOINT.json``'s, overridden by ``VOK_HYBRID_BUDGET`` and
``VOK_HYBRID_II``; config 4's budget by ``VOK_ORBIT_BUDGET``.

stdout gets the JSON line and nothing else; everything else goes to stderr.
Kernels are built from the repository's sources at first use.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from vokselis_torch.core.camera import Camera
from vokselis_torch.models.orbit import CONTRACT, BonsaiOrbit
from vokselis_torch.models.views import ViewsBatch
from vokselis_torch.ops import reference
from vokselis_torch.ops.cuda.march_bonsai import build_renderer, volume_tensor
from vokselis_torch.ops.cuda.march_field import FieldRenderer
from vokselis_torch.ops.hybrid import HybridBonsaiRenderer
from vokselis_torch.ops.shear_warp import build_fast_renderer, pose_hint
from vokselis_torch.parallel.sharding import orbit_cameras
from vokselis_torch.tools.parity_report import card_line
from vokselis_torch.volume.io import dense_stress, get_bonsai

ROOT = Path(__file__).resolve().parent.parent
BASELINE_MRAYS = 500.0  # the speed half of the north star; CONTRACT, 1e-3, its error half


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_oppoint() -> dict:
    """The hybrid's measured operating point (budget / intermediate), the
    ``operating_point`` of the repository's ``OPPOINT.json``; {} when the
    file is missing or not valid."""
    try:
        with open(ROOT / "OPPOINT.json") as f:
            op = json.load(f).get("operating_point") or {}
        return op if isinstance(op, dict) else {}
    except (OSError, ValueError, AttributeError):
        return {}


def _frames(render, n: int, device):
    """A callable that runs ``render(i)`` for frames i = 0 .. n-1, then waits
    for the card (the counterpart of bench.py's ``np.asarray(f())``)."""
    device = torch.device(device)

    def run():
        for i in range(n):
            render(i)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    return run


def slope_time(build_frames_fn, n_hi: int = 5, repeats: int = 5) -> float:
    """Seconds per frame: the slope between the 1-frame and the ``n_hi``-frame
    callables of ``build_frames_fn(n)`` (each run twice to warm it: the
    first call of a compiled entry captures its graph), measured
    ``repeats`` times on the wall clock, the median taken. Each callable
    ends by waiting for the card (:func:`_frames`).

    bench.py varies its camera by a loop-carried ``acc * 1e-20`` so that XLA
    cannot hoist a loop-invariant frame out of its loop; here frames are
    graph replays in stream order, which nothing hoists or folds, so the
    uniform is the same each frame. The slopes go to stderr."""
    f1 = build_frames_fn(1)
    fn = build_frames_fn(n_hi)
    f1()
    fn()
    f1()
    fn()
    slopes = []
    for _ in range(repeats):
        t = time.perf_counter()
        f1()
        t1 = time.perf_counter() - t
        t = time.perf_counter()
        fn()
        tn = time.perf_counter() - t
        slopes.append(max((tn - t1) / (n_hi - 1), 1e-9))
    _log("slope_time: slopes " + " ".join(f"{s * 1e3:.4f}" for s in slopes) + " ms")
    return float(np.median(slopes))


def bench_bonsai(width=1024, height=1024, use_oracle=False, vol=None, device="cuda"):
    """Config 3: the exact frame through ``build_renderer`` (K1), or with
    ``use_oracle`` the plain oracle ``reference.render_bonsai``. Returns
    (Mrays/s, seconds per frame)."""
    device = torch.device(device)
    u0 = Camera.bonsai(1.0).uniform(device)
    vol = get_bonsai() if vol is None else vol
    if use_oracle:
        pack = volume_tensor(vol, device)

        def render(pk, u, w, h):
            return reference.render_bonsai(pk, u, w, h)
    else:
        render, pack = build_renderer(vol, device)

    sec = slope_time(lambda n: _frames(lambda i: render(pack, u0, width, height), n, device))
    return width * height / sec / 1e6, sec


def bench_field(width=512, height=512, field="noise", shading="xor", quantize=True,
                device="cuda"):
    """Configs 1 and 2: the field frame (K7) through :class:`FieldRenderer` at
    ``Camera.xor(1.0)`` and t = 0. Returns (Mrays/s, seconds per frame)."""
    u0 = Camera.xor(1.0).uniform(device)
    r = FieldRenderer(device)

    def frame(i):
        return r(u0, 0.0, width, height, field=field, shading=shading, quantize=quantize)

    sec = slope_time(lambda n: _frames(frame, n, device))
    return width * height / sec / 1e6, sec


def bench_bonsai_fast(width=1024, height=1024, intermediate=256, vol=None, device="cuda"):
    """renderer="fast" (shear-warp: K34 + K6) through ``build_fast_renderer``.
    Reported on stderr only: the flagship stays the exact or the hybrid
    frame; the fast frame's error is PARITY_REPORT.md's table."""
    u0 = Camera.bonsai(1.0).uniform(device)
    render, pack = build_fast_renderer(get_bonsai() if vol is None else vol, device,
                                       intermediate=intermediate)
    sec = slope_time(lambda n: _frames(lambda i: render(pack, u0, width, height), n, device))
    return width * height / sec / 1e6, sec


def bench_bonsai_hybrid(width=1024, height=1024, intermediate=None, budget=None, vol=None,
                        device="cuda"):
    """renderer="hybrid" (fast frame + exact re-march of the worst tiles: K34,
    K5, K2), the north-star mode, at OPPOINT.json's operating point unless
    given. Returns (Mrays/s, seconds per frame, mean |hybrid - exact| over
    rgb at the bench pose, budget): the error of the routed frame
    (``_call_traced``) against the exact K1 frame; the timing through
    ``functional()``."""
    op = load_oppoint()
    if budget is None:
        budget = int(os.environ.get("VOK_HYBRID_BUDGET", op.get("budget", 128)))
    if intermediate is None:
        intermediate = int(os.environ.get("VOK_HYBRID_II", op.get("ii", 512)))
    u0 = Camera.bonsai(1.0).uniform(device)
    hyb = HybridBonsaiRenderer(get_bonsai() if vol is None else vol, device,
                               intermediate=intermediate, budget=budget)
    hint = pose_hint(u0, width, height, intermediate, hyb.dims)
    exact = hyb.exact(u0, width, height)
    img = hyb._call_traced(u0, width, height, hint=hint)
    err = float((img[..., :3] - exact[..., :3]).abs().mean())
    frender, fpack = hyb.functional()

    def frame(i):
        return frender(fpack, u0, width, height, hint=hint)

    sec = slope_time(lambda n: _frames(frame, n, device))
    return width * height / sec / 1e6, sec, err, budget


def degenerate_poses(poses, width: int, height: int, intermediate: int, dims: int) -> list:
    """The indices of the uniforms ``poses`` that ``pose_hint`` marks
    degenerate at ``intermediate``: bench.py's config-4 gate times the
    hybrid only when this is empty."""
    return [i for i, u in enumerate(poses)
            if pose_hint(u, width, height, intermediate, dims)[2]]


def bench_bonsai_orbit(width=1920, height=1080, n_poses=8, vol=None, device="cuda"):
    """Config 4: the bonsai on an orbiting camera (``models/orbit``), frame i
    at pose i mod n. Times the exact frame (K1); then, with bench.py's gate,
    the hybrid at OPPOINT.json's intermediate and twice its budget
    (``VOK_ORBIT_BUDGET``): only when no pose is degenerate and every
    pose's mean |hybrid - exact| over rgb is within 1e-3. Returns (Mrays/s,
    seconds per frame, hybrid_stats): hybrid_stats is None or (Mrays/s,
    seconds, worst pose's error, budget)."""
    op = load_oppoint()
    budget = int(os.environ.get("VOK_ORBIT_BUDGET", 2 * int(op.get("budget", 64))))
    ii = int(op.get("ii", 512))
    poses = [c.uniform(device) for c in orbit_cameras(n_poses, aspect=width / height)]
    orbit = BonsaiOrbit(get_bonsai() if vol is None else vol, device, width, height,
                        intermediate=ii, budget=budget, poses=poses)

    def exact(i):
        return orbit.exact(poses[i % n_poses], width, height)

    sec = slope_time(lambda n: _frames(exact, n, device))
    mrays = width * height / sec / 1e6
    if degenerate_poses(poses, width, height, ii, orbit.hybrid.dims):
        _log("config 4 hybrid: degenerate orbit pose — exact only")
        return mrays, sec, None
    err_max = orbit().max_error
    if err_max > CONTRACT:
        _log(f"config 4 hybrid: max orbit-pose err {err_max:.2e} > 1e-3 — exact only")
        return mrays, sec, None
    frender, fpack = orbit.hybrid.functional()

    def hybrid(i):
        return frender(fpack, poses[i % n_poses], width, height)

    hsec = slope_time(lambda n: _frames(hybrid, n, device))
    return mrays, sec, (width * height / hsec / 1e6, hsec, err_max, budget)


def bench_views_512(n_views=64, view_res=512, device="cuda"):
    """Config 5: a time-varying view_res^3 volume rendered from ``n_views``
    orbit views at view_res^2 per batch (``models/views.ViewsBatch``). Each
    timed batch b regenerates the density (K8 at t = 0.3 b) and rebuilds its
    occupancy table before the views render (one K1 launch). Returns
    (Mrays/s, seconds per batch) over n_views x view_res^2 rays a batch."""
    batch = ViewsBatch(n_views, view_res, dims=view_res, device=device)
    sec_batch = slope_time(lambda n: _frames(batch, n, device), n_hi=2)
    return n_views * view_res * view_res / sec_batch / 1e6, sec_batch


def measure_flagship_err(width=1024, height=1024, vol=None, device="cuda"):
    """Mean per-pixel |rgb| error of the flagship K1 frame against the plain
    oracle ``reference.render_bonsai`` at the bench pose, both on
    ``device``."""
    u0 = Camera.bonsai(1.0).uniform(device)
    render, pack = build_renderer(get_bonsai() if vol is None else vol, device)
    img = render(pack, u0, width, height)[..., :3]
    ref = reference.render_bonsai(pack, u0, width, height)[..., :3]
    return float((img - ref).abs().mean())


def flagship_line(results: dict, hyb_stats, mean_err) -> dict:
    """The JSON line (bench.py:476-504): the hybrid headlines only when its
    measured error (``hyb_stats[2]``) is within 1e-3, else the exact frame
    ``results["bonsai_1024"]`` with the hybrid's numbers beside it.
    ``hyb_stats``: None or (Mrays/s, seconds, error, budget); ``mean_err``:
    the exact frame's error against the oracle, or None."""
    mrays, sec = results["bonsai_1024"]
    if hyb_stats is not None and hyb_stats[2] <= CONTRACT:
        hm, hs, herr, hbud = hyb_stats
        return {
            "metric": "Mrays/sec/chip (bonsai 256^3 @ 1024^2, hybrid shear-warp + exact tile "
                      "re-march (CUDA, sm_90a))",
            "value": round(hm, 2),
            "unit": "Mrays/s",
            "vs_baseline": round(hm / BASELINE_MRAYS, 4),
            "p50_ms": round(hs * 1000.0, 3),
            "mean_err": round(herr, 9),
            "hybrid_budget": hbud,
            "exact_mrays": round(mrays, 2),
            "exact_p50_ms": round(sec * 1000.0, 3),
            "exact_mean_err": None if mean_err is None else round(mean_err, 9),
        }
    line = {
        "metric": "Mrays/sec/chip (bonsai 256^3 @ 1024^2, exact march (CUDA, sm_90a))",
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / BASELINE_MRAYS, 4),
        "p50_ms": round(sec * 1000.0, 3),
        "mean_err": None if mean_err is None else round(mean_err, 9),
    }
    if hyb_stats is not None:
        hm, hs, herr, hbud = hyb_stats
        line["hybrid_mrays"] = round(hm, 1)
        line["hybrid_p50_ms"] = round(hs * 1000.0, 3)
        line["hybrid_mean_err"] = round(herr, 9)
        line["hybrid_budget"] = hbud
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--all", action="store_true", help="run every config")
    ap.add_argument("--cpu-oracle", action="store_true",
                    help="time the plain oracle on the CPU (config 3 only)")
    ap.add_argument("--skip-err", action="store_true",
                    help="skip the oracle frame behind mean_err")
    args = ap.parse_args(argv)

    if not args.cpu_oracle and not torch.cuda.is_available():
        _log("vokselis_torch.bench: no CUDA card (torch.cuda.is_available() is False); it "
             "measures the card. --cpu-oracle times the plain oracle on the CPU instead.")
        return 1
    device = torch.device("cpu") if args.cpu_oracle else torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _log(f"device: {card_line(device)}")

    results = {}
    t0 = time.perf_counter()
    mrays, sec = bench_bonsai(use_oracle=args.cpu_oracle, device=device)
    results["bonsai_1024"] = (mrays, sec)
    _log(f"config 3 bonsai 256^3 @1024^2: {sec * 1000:.3f} ms/frame = {mrays:.1f} Mrays/s  "
         f"[{time.perf_counter() - t0:.0f}s elapsed]")

    hyb_stats = None
    if not args.cpu_oracle:
        for ii in (256, 512) if args.all else (256,):
            m, s = bench_bonsai_fast(intermediate=ii, device=device)
            results[f"bonsai_1024_fast_i{ii}"] = (m, s)
            _log(f"renderer='fast' (shear-warp, I={ii}): {s * 1000:.3f} ms/frame = {m:.0f} "
                 "Mrays/s (approximate — see PARITY_REPORT.md)")
        hyb_stats = bench_bonsai_hybrid(device=device)
        hm, hs, herr, hbud = hyb_stats
        _log(f"renderer='hybrid' (north-star mode, budget={hbud}): {hs * 1000:.3f} ms/frame = "
             f"{hm:.0f} Mrays/s at mean err {herr:.2e} vs exact")

    if args.all and not args.cpu_oracle:
        m, s = bench_bonsai(vol=dense_stress(), device=device)
        results["bonsai_1024_dense"] = (m, s)
        _log(f"config 3 DENSE stress (50% occupancy) @1024^2: {s * 1000:.3f} ms/frame = "
             f"{m:.1f} Mrays/s")
        for name, kw in (
            ("trig_512", dict(width=512, height=512, field="trig", shading="emission",
                              quantize=False)),
            ("xor_512", dict(width=512, height=512)),
        ):
            m, s = bench_field(device=device, **kw)
            results[name] = (m, s)
            _log(f"{name}: {s * 1000:.3f} ms/frame = {m:.1f} Mrays/s")
        m, s, orb_hyb = bench_bonsai_orbit(device=device)
        results["bonsai_1080p_orbit"] = (m, s)
        _log(f"config 4 bonsai orbit @1080p: {s * 1000:.3f} ms/frame = {m:.1f} Mrays/s")
        if orb_hyb is not None:
            hm4, hs4, herr4, hbud4 = orb_hyb
            results["bonsai_1080p_orbit_hybrid"] = (hm4, hs4)
            _log(f"config 4 orbit @1080p HYBRID (budget={hbud4}): {hs4 * 1000:.3f} ms/frame = "
                 f"{hm4:.1f} Mrays/s, max orbit-pose err {herr4:.2e}")
        m, s = bench_views_512(device=device)
        results["views512"] = (m, s)
        _log(f"config 5 512^3 64 views @512^2: {s * 1000:.3f} ms/batch = {m:.1f} Mrays/s")

    if args.skip_err:
        mean_err = None
    elif args.cpu_oracle:
        mean_err = 0.0  # the oracle is the measured path
    else:
        mean_err = measure_flagship_err(device=device)
        _log(f"flagship mean_err vs oracle at the bench pose: {mean_err:.3e}")
    line = flagship_line(results, hyb_stats, mean_err)
    if args.cpu_oracle:
        line["metric"] = "Mrays/sec/chip (bonsai 256^3 @ 1024^2, plain torch oracle on the CPU)"
    rows = {k: {"mrays": m, "ms": s * 1e3} for k, (m, s) in results.items()}
    if hyb_stats is not None:
        rows["hybrid"] = {"mrays": hyb_stats[0], "ms": hyb_stats[1] * 1e3,
                          "mean_err": hyb_stats[2]}
    _log("rows: " + json.dumps(rows))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
