#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (vokselis_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py [--png frame.png]

Phases, each reported on its own lines:
  1. device: the card, as nvidia-smi names it, with its power limit;
  2. build: compile every kernel from vokselis_torch/csrc with nvcc, one
     nvcc per source, all started together: K1 (march_bonsai.cu), K3 + K4
     (shear_resample.cu) and K6 (warp2d.cu); ptxas registers and spills;
  3. K1 against its plain torch version on the card, at 1024x1024 on the
     256^3 bonsai (bench, eye-inside and diagonal poses) and on a random
     256^3 volume with full borders: finite, max |d| < 1e-3 and
     mean |d| < 1e-5 on rgb;
  3b. K3, K4 (low-degree transfer), K4b (K4's exact-transfer mode) and K6
     against their plain versions on the card, at the bench pose's fast
     geometry (256^3, 1024^2, I=512; K3 + K4 also at I=1024), both marching
     directions: K3 within one bf16 ulp of the value and mean <= 1e-6, K4
     and K4b max <= 1e-4, K6 max <= 1e-6;
  4. the exact main path: engine.loop.run(BonsaiDemo) for 8 frames at
     1024x1024 on "cuda", which must launch K1 once per frame (and no fast
     kernel) and end in a finite, non-background frame that agrees with the
     plain version;
  4b. the fast main path: run(BonsaiDemo with renderer="fast") for 8 frames
     at 1024x1024, which must launch K3, K4 and K6 once per frame (and not
     K1) and end in a finite, non-background frame that agrees with the
     plain fast path on the card;
  4c. the fast frame (I=512) against the port's exact K1 frame at four
     poses: mean |d| over rgba within 1.25x of the JAX package's measured
     fast-mode error (PARITY_REPORT.md:60-63);
  5. timing with CUDA events: median ms of each kernel and of its plain
     version at the bench pose, the frames' other stages, whole exact and
     fast frames, and one PyTorch call computing each of K3's and K6's
     functions (grid_sample) as a yardstick.

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
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
RES = 1024  # the flagship frame: 256^3 bonsai at 1024^2 (bench.py:65)
MAX_TOL, MEAN_TOL = 1e-3, 1e-5  # the exact kernel's parity contract
TIMED_FRAMES = 20
WARMUP = 3
MAIN_FRAMES = 8
II = 512  # FastBonsaiRenderer's default intermediate
II_HYBRID = 1024  # the hybrid's operating point (OPPOINT.json)
K4_TOL = 1e-4  # tests/test_pallas.py:394, tests/test_fast.py:165
K6_TOL = 1e-6
# K4's 1e-4 through sRGB's steepest slope (12.92): the fast frame vs plain
FAST_FRAME_TOL = 2e-3
# PARITY_REPORT.md:60-63, I=512 fast frame vs the exact kernel at 1024^2
# (mean, p99 over rgba), held here within 1.25x on the mean
FAST_ERR = {"default": (0.00211, 0.0535), "tilt": (0.00152, 0.0472),
            "low": (0.00164, 0.0407), "orbit135": (0.00288, 0.0749)}
FAST_ERR_SLACK = 1.25

# H100 SXM peaks (NVIDIA's data sheet, dense, 700 W): bytes/s and float32 flop/s
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
# float32 operations per unit of work, counted from the CUDA sources (adds,
# subtracts, multiplies, min/max, floor; each cosf/expf/logf as one):
OPS_K1_STEP = 86  # march_bonsai.cu: 41 trilinear + 27 transfer + 11 composite + 7 advance
OPS_K3_TEXEL = 13  # shear_resample.cu: 2 floors, 2 fractions, 3 lerps
OPS_K4_SAMPLE = 73  # low-degree: 9 smoothstep, 2 + 48 palette, 5 alpha, 9 composite
OPS_K6_PIXEL = 8  # warp2d.cu: 4 clamps, 2 floors, 2 fractions ...
OPS_K6_CHANNEL = 9  # ... and 3 lerps per channel


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


def bound_ms(n_bytes: float, n_ops: float):
    """Least time for the work: the larger of bytes over the memory rate and
    operations over the float32 peak; returns (ms, which bound)."""
    t_bytes, t_ops = n_bytes / HBM_BPS, n_ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def host_syncs(fn, torch) -> int:
    """Synchronizing operations ``fn`` makes, as PyTorch's sync debug mode
    reports them (a ``.item()``, a blocking copy: the host waits for the
    card)."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def device_share(fn, frames: int, torch):
    """torch.profiler over ``frames`` calls of ``fn``: (device kernels and
    copies per call, device busy ms per call, idle share of the device span),
    the busy time being the union of the device events' intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    busy, cur_lo, cur_hi = 0.0, spans[0][0], spans[0][1]
    for lo, hi in spans[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    span = max(hi for _, hi in spans) - spans[0][0]
    return len(spans) / frames, busy / frames / 1e3, 1.0 - busy / span


def rgb_err(a, b):
    d = (a[..., :3] - b[..., :3]).abs()
    return float(d.max()), float(d.mean())


def bf16_ulp(x, torch):
    """One bf16 ulp of each value of ``x`` (0 where x is 0)."""
    _, exp = torch.frexp(x.float())
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                                                exp - 8))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--png", default=None,
                        help="also write the exact main path's final frame here")
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
    from vokselis_torch.ops import reference, shear_warp
    from vokselis_torch.ops.cuda import build as kbuild
    from vokselis_torch.ops.cuda import march_bonsai as mb
    from vokselis_torch.ops.cuda import shear_resample as sr
    from vokselis_torch.ops.cuda import warp2d as w2
    from vokselis_torch.ops.present import present, to_uint8
    from vokselis_torch.volume.io import get_bonsai

    import numpy as np

    def reset_launches():
        mb.LAUNCHES = sr.LAUNCHES_RESAMPLE = sr.LAUNCHES_COMPOSITE = w2.LAUNCHES_WARP = 0

    def launches():
        return {"K1": mb.LAUNCHES, "K3": sr.LAUNCHES_RESAMPLE,
                "K4": sr.LAUNCHES_COMPOSITE, "K6": w2.LAUNCHES_WARP}

    # -- phase 1: device --------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {card} | {kind} | count {torch.cuda.device_count()} "
          f"| capability {torch.cuda.get_device_capability(0)} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda}", flush=True)
    dev = torch.device("cuda", 0)

    # -- phase 2: build (one nvcc per source, all started together) -------
    modules = {"K1": mb, "K3+K4": sr, "K6": w2}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:
        for fut in [pool.submit(m.build) for m in modules.values()]:
            fut.result()
    build_s = time.perf_counter() - t0
    sources = ", ".join(f"{k} {os.path.relpath(m.SOURCE, ROOT)}" for k, m in modules.items())
    print(f"phase 2 build: {sources} -> {os.path.relpath(kbuild.BUILD_DIR, ROOT)} in "
          f"{build_s:.2f} s", flush=True)
    for name, m in modules.items():
        for line in m.BUILD_LOG.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"phase 2 ptxas {name}: {line.strip()}")

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
    worst = {"K1": 0.0, "K3": 0.0, "K4": 0.0, "K6": 0.0}
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
        worst["K1"] = max(worst["K1"], mx)

    # -- phase 3b: K3, K4, K4b, K6 against their plain versions -----------
    fast_r = shear_warp.FastBonsaiRenderer(vol_bonsai, dev, intermediate=II)
    packs = fast_r.packs
    bench_u = bench.uniform(dev)
    for ii in (II, II_HYBRID):
        geo = shear_warp.fast_geometry(packs, bench_u, RES, RES, ii)
        stack = sr.resample_slabs(packs[0], geo.m, geo.pos_u, geo.pos_v, geo.occ_k)
        stack_p = sr.resample_slabs_plain(packs[0], geo.m, geo.pos_u, geo.pos_v, geo.occ_k)
        torch.cuda.synchronize()
        d3 = (stack.float() - stack_p.float()).abs()
        over = int((d3 > bf16_ulp(stack_p, torch)).sum())
        mx, mean = float(d3.max()), float(d3.mean())
        same = float((stack == stack_p).float().mean())
        print(f"phase 3b K3 vs plain bench I={ii} stack {tuple(stack.shape)}: max "
              f"{mx:.3e} mean {mean:.3e} (tol 1 bf16 ulp / 1e-06), texels over 1 ulp "
              f"{over}, bitwise-equal {same:.6f}, hot slabs "
              f"{int(geo.occ_k.sum())}/{geo.occ_k.numel()}", flush=True)
        check(over == 0 and mean <= 1e-6, f"K3 disagrees with plain at I={ii}")
        worst["K3"] = max(worst["K3"], mx)
        for sgn in (geo.sgn, -geo.sgn):
            for transfer in sr.TRANSFERS:
                planes = sr.composite(stack, sgn, geo.irho, geo.occ_rb, transfer)
                planes_p = sr.composite_plain(stack, sgn, geo.irho, geo.occ_rb, transfer)
                d4 = (planes - planes_p).abs()
                mx = float(d4.max())
                n_over = int((d4 > K4_TOL).any(dim=0).sum())
                same = float((planes == planes_p).all(dim=0).float().mean())
                name = "K4" if transfer == "lowdeg" else "K4b"
                print(f"phase 3b {name} vs plain bench I={ii} sgn {int(sgn[0]):+d}: max "
                      f"{mx:.3e} mean {float(d4.mean()):.3e} (tol {K4_TOL:g}), texels "
                      f"over tol {n_over}, bitwise-equal {same:.6f}", flush=True)
                check(mx <= K4_TOL, f"{name} disagrees with plain at I={ii}, sgn {int(sgn[0])}")
                worst["K4"] = max(worst["K4"], mx)
        if ii == II:
            planes = sr.composite(stack, geo.sgn, geo.irho, geo.occ_rb)
            av, bu, ok = shear_warp.warp_coords(geo, ii, ii)
            for n_ch in (3, 4):
                w = w2.warp_bilinear(planes[:n_ch], av, bu, ok)
                w_p = w2.warp_plain(planes[:n_ch], av, bu, ok)
                d6 = (w - w_p).abs()
                mx = float(d6.max())
                same = float((w == w_p).float().mean())
                print(f"phase 3b K6 vs plain bench I={ii} {n_ch} channels {RES}x{RES}: "
                      f"max {mx:.3e} (tol {K6_TOL:g}), bitwise-equal {same:.6f}, hit "
                      f"pixels {float(ok.float().mean()):.4f}", flush=True)
                check(mx <= K6_TOL, f"K6 disagrees with plain ({n_ch} channels)")
                worst["K6"] = max(worst["K6"], mx)
            # this run's data-dependent work, for the bounds of phase 5
            geo_b, stack_b, planes_b, ok_b = geo, stack, planes, ok
            _, k4_count = sr.composite_plain(stack, geo.sgn, geo.irho, geo.occ_rb,
                                             return_count=True)
        del stack, stack_p

    # -- phase 4: the exact main path -------------------------------------
    ctx = Context(RES, RES, camera=BonsaiDemo.default_camera(1.0),
                  backbuffer_resolution=(RES, RES), device="cuda")
    reset_launches()
    t0 = time.perf_counter()
    ctx = run(BonsaiDemo, frames=MAIN_FRAMES, events=orbit_events(MAIN_FRAMES, RES, RES),
              context=ctx, quiet=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    exact_launches = launches()
    check(exact_launches == {"K1": MAIN_FRAMES, "K3": 0, "K4": 0, "K6": 0},
          f"exact main path launched {exact_launches}, not K1 x {MAIN_FRAMES} only")
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
          f"in {run_s:.2f} s, K1 launches {exact_launches['K1']}, lit pixels {lit:.4f}, "
          f"final frame vs plain max {mx:.3e} mean {mean:.3e}, png {png_bytes} bytes",
          flush=True)

    # -- phase 4b: the fast main path -------------------------------------
    class FastDemo(BonsaiDemo):
        @classmethod
        def init(cls, ctx):
            return BonsaiDemo.init(ctx, renderer="fast")

    fctx = Context(RES, RES, camera=BonsaiDemo.default_camera(1.0),
                   backbuffer_resolution=(RES, RES), device="cuda")
    reset_launches()
    t0 = time.perf_counter()
    fctx = run(FastDemo, frames=MAIN_FRAMES, events=orbit_events(MAIN_FRAMES, RES, RES),
               context=fctx, quiet=True)
    torch.cuda.synchronize()
    frun_s = time.perf_counter() - t0
    fast_launches = launches()
    check(fast_launches == {"K1": 0, "K3": MAIN_FRAMES, "K4": MAIN_FRAMES, "K6": MAIN_FRAMES},
          f"fast main path launched {fast_launches}, not K3/K4/K6 x {MAIN_FRAMES} only")
    img = fctx.display_image
    check(tuple(img.shape) == (RES, RES, 4), f"fast display shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "fast display image has non-finite pixels")
    flit = float((img[..., :3].amax(dim=-1) > 1.0 / 255.0).float().mean())
    check(flit > 0.01, f"fast display image is background ({flit:.4%} lit pixels)")
    hdr_plain = shear_warp._render_fast(fast_r.packs, fctx.camera_uniform, RES, RES, II,
                                        True, plain=True)
    fmx, fmean = rgb_err(fctx.render_backbuffer.texture, hdr_plain)
    check(fmx <= FAST_FRAME_TOL and fmean <= MEAN_TOL,
          f"final fast frame disagrees with the plain fast path (max {fmx:.3e})")
    print(f"phase 4b fast main path: run(BonsaiDemo, renderer=\"fast\") {MAIN_FRAMES} "
          f"frames {RES}x{RES} I={II} in {frun_s:.2f} s, launches {fast_launches}, lit "
          f"pixels {flit:.4f}, final frame vs plain fast path max {fmx:.3e} mean "
          f"{fmean:.3e} (tol {FAST_FRAME_TOL:g} / {MEAN_TOL:g})", flush=True)

    # -- phase 4c: the fast frame against the exact frame -------------------
    poses = {
        "default": Camera.bonsai(1.0),
        "tilt": Camera(zoom=1.2, pitch=0.9, yaw=1.1, target=(0.5, 0.5, 0.5), aspect=1.0),
        "low": Camera(zoom=1.0, pitch=0.05, yaw=2.5, target=(0.5, 0.5, 0.5), aspect=1.0),
        "orbit135": Camera(zoom=1.0, pitch=0.5, yaw=3 * np.pi / 4,
                           target=(0.5, 0.5, 0.5), aspect=1.0),
    }
    exact_r = mb.BonsaiRenderer(vol_bonsai, dev)
    misses = []
    for name, cam in poses.items():
        u = cam.uniform(dev)
        err = (fast_r(u, RES, RES) - exact_r(u, RES, RES)).abs()
        mean = float(err.mean())
        p99 = float(torch.quantile(err.reshape(-1), 0.99))
        want_mean, want_p99 = FAST_ERR[name]
        print(f"phase 4c fast I={II} vs exact K1 {name} {RES}x{RES}: mean {mean:.5f} "
              f"(table {want_mean:.5f}, limit {FAST_ERR_SLACK * want_mean:.5f}), p99 "
              f"{p99:.4f} (table {want_p99:.4f}), max {float(err.max()):.3f}", flush=True)
        if mean > FAST_ERR_SLACK * want_mean:
            misses.append(name)
    check(not misses, f"fast frame beyond 1.25x the table's mean error at {misses}")

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
          f"{frame_ms:.4f} ms/frame ({mrays / frame_ms * 1e3:.1f} Mrays/s)", flush=True)

    # the fast path's stages at the bench pose, I=512 (phase 3b's geometry)
    geo = geo_b
    n = 5 * TIMED_FRAMES
    geo_ms = median_ms(lambda: shear_warp.fast_geometry(packs, uni, RES, RES, II), n, torch)
    k3_ms = median_ms(lambda: sr.resample_slabs(packs[0], geo.m, geo.pos_u, geo.pos_v,
                                                geo.occ_k), n, torch)
    k4_ms = median_ms(lambda: sr.composite(stack_b, geo.sgn, geo.irho, geo.occ_rb), n, torch)
    k4b_ms = median_ms(lambda: sr.composite(stack_b, geo.sgn, geo.irho, geo.occ_rb,
                                            "exact"), n, torch)
    av, bu, ok = shear_warp.warp_coords(geo, II, II)
    chans = planes_b[:3]
    k6_ms = median_ms(lambda: w2.warp_bilinear(chans, av, bu, ok), n, torch)
    coords_ms = median_ms(lambda: shear_warp.warp_coords(geo, II, II), n, torch)
    k3p_ms = median_ms(lambda: sr.resample_slabs_plain(packs[0], geo.m, geo.pos_u,
                                                       geo.pos_v, geo.occ_k),
                       TIMED_FRAMES, torch)
    k4p_ms = median_ms(lambda: sr.composite_plain(stack_b, geo.sgn, geo.irho, geo.occ_rb),
                       TIMED_FRAMES, torch)
    k6p_ms = median_ms(lambda: w2.warp_plain(chans, av, bu, ok), n, torch)
    # yardsticks the port never calls: grid_sample (bilinear, zeros padding,
    # align_corners=True) over the same float32 slabs / channels at the same
    # coordinates
    gp = geo.pos_u.shape[0]
    slabs = torch.zeros((gp, 1) + tuple(packs[0].shape[2:]), dtype=torch.float32, device=dev)
    slabs[: packs[0].shape[1], 0] = packs[0].index_select(0, geo.m.long())[0].float()
    d = packs[0].shape[2]
    gu = (geo.pos_u / (d - 1) * 2 - 1)[:, None, :].expand(gp, II, II)
    gv = (geo.pos_v / (d - 1) * 2 - 1)[:, :, None].expand(gp, II, II)
    grid3 = torch.stack([gu, gv], dim=-1).contiguous()
    gs = torch.nn.functional.grid_sample
    lib3_ms = median_ms(lambda: gs(slabs, grid3, mode="bilinear", padding_mode="zeros",
                                   align_corners=True), n, torch)
    grid6 = torch.stack([bu / (II - 1) * 2 - 1, av / (II - 1) * 2 - 1], dim=-1)[None]
    lib6_ms = median_ms(lambda: gs(chans[None], grid6, mode="bilinear", padding_mode="zeros",
                                   align_corners=True), n, torch)
    del slabs, grid3
    fast_demo = FastDemo.init(fctx)

    def fast_frame():
        fctx.update()
        fast_demo.render(fctx)
        fctx.render()

    fframe_ms = median_ms(fast_frame, n, torch)
    fplain_ms = median_ms(lambda: shear_warp._render_fast(packs, uni, RES, RES, II, True,
                                                          plain=True), TIMED_FRAMES, torch)
    print(f"phase 5 fast path ({card}; bench pose, 256^3 {RES}x{RES}, I={II}; medians "
          f"of {n} / {TIMED_FRAMES} plain):", flush=True)
    print(f"phase 5 fast stages: geometry (torch) {geo_ms:.4f} ms, K3 resample "
          f"{k3_ms:.4f} ms, K4 composite {k4_ms:.4f} ms (K4b exact transfer "
          f"{k4b_ms:.4f} ms), warp coords (torch) {coords_ms:.4f} ms, K6 warp "
          f"{k6_ms:.4f} ms")
    print(f"phase 5 fast plain torch: K3 {k3p_ms:.4f} ms, K4 {k4p_ms:.4f} ms, K6 "
          f"{k6p_ms:.4f} ms, whole plain fast frame {fplain_ms:.4f} ms")
    print(f"phase 5 yardsticks (grid_sample, f32): K3's function {lib3_ms:.4f} ms, "
          f"K6's function {lib6_ms:.4f} ms")
    print(f"phase 5 whole fast frame (Context.update + BonsaiDemo.render + present): "
          f"{fframe_ms:.4f} ms/frame ({mrays / fframe_ms * 1e3:.1f} Mrays/s)", flush=True)
    for name, fn in (("exact", frame), ("fast", fast_frame)):
        syncs = host_syncs(fn, torch)
        share = device_share(fn, 10, torch)
        trace = ("no device events in the trace" if share is None else
                 f"{share[0]:.1f} device kernels/copies per frame, device busy "
                 f"{share[1]:.4f} ms per frame, device idle share {share[2]:.3f}")
        print(f"phase 5 {name} frame profile (10 frames, torch.profiler on): host syncs "
              f"per frame {syncs}, {trace}", flush=True)

    # bounds from this run's inputs and data-dependent work
    _, steps = reference.render_bonsai_rays(vol_bonsai, eye, dirs, return_steps=True)
    k1_steps = int(steps.sum())
    k1_bound = bound_ms(vol_bonsai.numel() + 3 * RES * RES * 4 + 12 + RES * RES * 16,
                        k1_steps * OPS_K1_STEP)
    hot = int(geo.occ_k.sum())
    k3_bound = bound_ms(hot * d * d * 2 + 2 * gp * II * 4 + gp + 4 + gp * II * II * 2,
                        hot * II * II * OPS_K3_TEXEL)
    k4_samples = int(k4_count.sum())
    k4_bound = bound_ms(k4_samples * 2 + II * II * 4 + geo.occ_rb.numel() + 8
                        + 4 * II * II * 4, k4_samples * OPS_K4_SAMPLE)
    n_hit = int(ok_b.sum())
    k6_bound = bound_ms(3 * II * II * 4 + RES * RES + n_hit * 8 + 3 * RES * RES * 4,
                        n_hit * (OPS_K6_PIXEL + 3 * OPS_K6_CHANNEL))
    print(f"phase 5 work: K1 {k1_steps} samples ({k1_steps / (RES * RES):.1f} per ray); "
          f"K3 {hot} hot slabs of {gp}; K4 {k4_samples} samples composited "
          f"({k4_samples / (II * II):.1f} per texel); K6 {n_hit} hit pixels")
    print(f"phase 5 bounds (ms, H100 SXM 3.35 TB/s, 67 TFLOP/s f32): K1 {k1_bound[0]:.4f} "
          f"({k1_bound[1]}), K3 {k3_bound[0]:.4f} ({k3_bound[1]}), K4 {k4_bound[0]:.4f} "
          f"({k4_bound[1]}), K6 {k6_bound[0]:.4f} ({k6_bound[1]})", flush=True)

    def entry(name, source, replaces, n_launches, err, ms, plain_ms, bound, lib_ms):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n_launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib_ms}

    kernels = [
        entry("march_bonsai", "vokselis_torch/csrc/march_bonsai.cu",
              "vokselis_tpu/ops/pallas/march_bonsai.py:131", exact_launches["K1"],
              worst["K1"], k_ms, p_ms, k1_bound, None),
        entry("resample_slabs", "vokselis_torch/csrc/shear_resample.cu",
              "vokselis_tpu/ops/pallas/shear_resample.py:117", fast_launches["K3"],
              worst["K3"], k3_ms, k3p_ms, k3_bound, lib3_ms),
        entry("composite", "vokselis_torch/csrc/shear_resample.cu",
              "vokselis_tpu/ops/pallas/shear_resample.py:236", fast_launches["K4"],
              worst["K4"], k4_ms, k4p_ms, k4_bound, None),
        entry("warp_bilinear", "vokselis_torch/csrc/warp2d.cu",
              "vokselis_tpu/ops/pallas/warp2d.py:218", fast_launches["K6"],
              worst["K6"], k6_ms, k6p_ms, k6_bound, lib6_ms),
    ]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
