#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (vokselis_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py [--png frame.png]

Phases, each reported on its own lines:
  1. device: the card, as nvidia-smi names it, with its power limit;
  2. build: compile the march kernel (K1) from vokselis_torch/csrc with nvcc;
  3. K1 against its plain torch version on the card, at 1024x1024 on the
     256^3 bonsai (bench, eye-inside and diagonal poses) and on a random
     256^3 volume with full borders: finite, max |d| < 1e-3 and
     mean |d| < 1e-5 on rgb;
  4. the main path: engine.loop.run(BonsaiDemo) for 8 frames at 1024x1024
     on "cuda", which must launch K1 once per frame and end in a finite,
     non-background frame that agrees with the plain version;
  5. timing with CUDA events: median ms/frame of K1 and of its plain version
     at the bench pose, and of the frame's other stages.

The last lines are the card's name and power limit, a JSON line describing
each kernel, and ``{"ok": true, "device": {...}}``. Any failed check or
exception exits nonzero before those lines. Needs no JAX and no network.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RES = 1024  # the flagship frame: 256^3 bonsai at 1024^2 (bench.py:65)
MAX_TOL, MEAN_TOL = 1e-3, 1e-5  # the exact kernel's parity contract
TIMED_FRAMES = 20
WARMUP = 3
MAIN_FRAMES = 8


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def median_ms(fn, n: int, torch) -> float:
    """Median CUDA-event time of ``fn`` over ``n`` calls, after a warm-up."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def rgb_err(a, b):
    d = (a[..., :3] - b[..., :3]).abs()
    return float(d.max()), float(d.mean())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--png", default=None,
                        help="also write the main path's final frame here")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from common import orbit_events
    from vokselis_torch.core import geometry
    from vokselis_torch.core.camera import Camera
    from vokselis_torch.engine.context import Context
    from vokselis_torch.engine.loop import run
    from vokselis_torch.media.png import write_png
    from vokselis_torch.models.bonsai import BonsaiDemo
    from vokselis_torch.ops import reference
    from vokselis_torch.ops.cuda import march_bonsai as mb
    from vokselis_torch.ops.present import present, to_uint8
    from vokselis_torch.volume.io import get_bonsai

    import numpy as np

    # -- phase 1: device --------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {card} | {kind} | count {torch.cuda.device_count()} "
          f"| capability {torch.cuda.get_device_capability(0)} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda}", flush=True)
    dev = torch.device("cuda", 0)

    # -- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    mb.build()
    build_s = time.perf_counter() - t0
    print(f"phase 2 build: K1 {os.path.relpath(mb.SOURCE, ROOT)} -> "
          f"{os.path.relpath(mb.BUILD_DIR, ROOT)} in {build_s:.2f} s", flush=True)
    for line in mb.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print(f"phase 2 ptxas: {line.strip()}")

    # -- phase 3: K1 against its plain version ----------------------------
    vol_bonsai = mb.volume_tensor(get_bonsai(), dev)
    vol_border = mb.volume_tensor(
        np.random.default_rng(5).integers(30, 220, (256,) * 3, dtype=np.uint8), dev
    )
    bench = Camera.bonsai(1.0)
    inside = Camera(zoom=0.3, pitch=0.1, yaw=0.7, target=(0.5, 0.5, 0.5), aspect=1.0)
    diagonal = Camera(zoom=1.3, pitch=0.2, yaw=2.2, target=(0.5, 0.5, 0.5), aspect=1.0)
    cases = [
        ("bonsai256/bench", vol_bonsai, bench),
        ("bonsai256/eye-inside", vol_bonsai, inside),
        ("bonsai256/diagonal", vol_bonsai, diagonal),
        ("border256/bench", vol_border, bench),
        ("border256/diagonal", vol_border, diagonal),
    ]
    worst = 0.0
    for name, vol, cam in cases:
        eye, dxyz = geometry.rays_fragment_soa(cam.uniform(dev), RES, RES)
        before = mb.LAUNCHES
        img_k = mb.render_bonsai_rays_cuda(vol, eye, dxyz)
        torch.cuda.synchronize()
        check(mb.LAUNCHES == before + 1, f"{name}: LAUNCHES did not advance")
        img_p = reference.render_bonsai_rays(vol, eye, torch.stack(dxyz, dim=-1))
        check(tuple(img_k.shape) == (RES, RES, 4), f"{name}: shape {tuple(img_k.shape)}")
        check(bool(torch.isfinite(img_k).all()), f"{name}: non-finite pixels")
        mx, mean = rgb_err(img_k, img_p)
        same = float((img_k == img_p).all(dim=-1).float().mean())
        print(f"phase 3 K1 vs plain {name} {RES}x{RES}: max {mx:.3e} mean "
              f"{mean:.3e} (tol {MAX_TOL:g} / {MEAN_TOL:g}), bitwise-equal "
              f"pixels {same:.6f}", flush=True)
        check(mx < MAX_TOL and mean < MEAN_TOL, f"{name}: K1 disagrees with plain")
        worst = max(worst, mx)

    # -- phase 4: the main path -------------------------------------------
    ctx = Context(RES, RES, camera=BonsaiDemo.default_camera(1.0),
                  backbuffer_resolution=(RES, RES), device="cuda")
    mb.LAUNCHES = 0
    t0 = time.perf_counter()
    ctx = run(BonsaiDemo, frames=MAIN_FRAMES, events=orbit_events(MAIN_FRAMES, RES, RES),
              context=ctx, quiet=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = mb.LAUNCHES
    check(launches == MAIN_FRAMES, f"main path launched K1 {launches} times, "
          f"not {MAIN_FRAMES}")
    img = ctx.display_image
    check(tuple(img.shape) == (RES, RES, 4), f"display shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "display image has non-finite pixels")
    lit = float((img[..., :3].amax(dim=-1) > 1.0 / 255.0).float().mean())
    check(lit > 0.01, f"display image is background ({lit:.4%} lit pixels)")
    eye, dxyz = geometry.rays_fragment_soa(ctx.camera_uniform, RES, RES)
    hdr_ref = reference.render_bonsai_rays(vol_bonsai, eye, torch.stack(dxyz, dim=-1))
    mx, mean = rgb_err(ctx.render_backbuffer.texture, hdr_ref)
    check(mx < MAX_TOL and mean < MEAN_TOL, "final frame disagrees with plain")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bonsai_torch.png")
        write_png(path, to_uint8(img).cpu().numpy())
        png_bytes = os.path.getsize(path)
    if args.png:
        write_png(args.png, to_uint8(img).cpu().numpy())
    print(f"phase 4 main path: run(BonsaiDemo) {MAIN_FRAMES} frames {RES}x{RES} "
          f"in {run_s:.2f} s, K1 launches {launches}, lit pixels {lit:.4f}, final "
          f"frame vs plain max {mx:.3e} mean {mean:.3e}, png {png_bytes} bytes",
          flush=True)

    # -- phase 5: timing --------------------------------------------------
    uni = bench.uniform(dev)
    eye, dxyz = geometry.rays_fragment_soa(uni, RES, RES)
    dirs = torch.stack(dxyz, dim=-1)
    k_ms = median_ms(lambda: mb.render_bonsai_rays_cuda(vol_bonsai, eye, dxyz),
                     5 * TIMED_FRAMES, torch)
    p_ms = median_ms(lambda: reference.render_bonsai_rays(vol_bonsai, eye, dirs),
                     TIMED_FRAMES, torch)
    k2_ms = median_ms(lambda: mb.render_bonsai_rays_cuda(vol_bonsai, eye, dxyz),
                      5 * TIMED_FRAMES, torch)
    rays_ms = median_ms(lambda: geometry.rays_fragment_soa(uni, RES, RES),
                        5 * TIMED_FRAMES, torch)
    hdr = mb.render_bonsai_rays_cuda(vol_bonsai, eye, dxyz)
    present_ms = median_ms(lambda: present(hdr), 5 * TIMED_FRAMES, torch)
    demo = BonsaiDemo.init(ctx)

    def frame():
        ctx.update()
        demo.render(ctx)
        ctx.render()

    frame_ms = median_ms(frame, 5 * TIMED_FRAMES, torch)
    mrays = RES * RES / 1e6
    print(f"phase 5 timing ({card}; median of {5 * TIMED_FRAMES} / {TIMED_FRAMES} "
          f"frames after {WARMUP} warm-up, CUDA events, bench pose, 256^3 "
          f"{RES}x{RES}):", flush=True)
    print(f"phase 5 K1 kernel: {k_ms:.4f} ms/frame ({mrays / k_ms * 1e3:.1f} Mrays/s); "
          f"again after the plain runs: {k2_ms:.4f} ms/frame")
    print(f"phase 5 K1 plain torch: {p_ms:.4f} ms/frame "
          f"({mrays / p_ms * 1e3:.2f} Mrays/s)")
    print(f"phase 5 other stages: rays_fragment_soa {rays_ms:.4f} ms, "
          f"present {present_ms:.4f} ms")
    print(f"phase 5 whole frame (Context.update + BonsaiDemo.render + present): "
          f"{frame_ms:.4f} ms/frame ({mrays / frame_ms * 1e3:.1f} Mrays/s)")

    kernels = [{
        "name": "march_bonsai",
        "route": "cuda",
        "source": "vokselis_torch/csrc/march_bonsai.cu",
        "replaces": "vokselis_tpu/ops/pallas/march_bonsai.py:131",
        "launches": launches,
        "max_abs_err": worst,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
