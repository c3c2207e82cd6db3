#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (vokselis_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py [--png frame.png] [--hot-reload-repeats N]

Phases, each reported on its own lines:
  1. device: the card, as nvidia-smi names it, with its power limit;
  2. build: compile every kernel from vokselis_torch/csrc with nvcc, one
     nvcc per source, all started together: K1 + K2 (march_bonsai.cu), K3 +
     K4 + K34, their fusion (shear_resample.cu), K6 + K5 (warp2d.cu), K7
     (march_field.cu) and K9 + K8 (genvol.cu), and beside them the native
     I/O library (g++, native/vokselis_native.cpp); ptxas registers and spills;
     K9 and K8 must have no stack frame and no local-memory access in their
     SASS (cuobjdump), nor K34's low-degree instantiation; K6's and K5's
     global loads in SASS order, grouped by the first use of a loaded value
     (vokselis_torch/tools/warp_check.load_batches);
  3. K1 (with its empty-space skip over the volume's occupancy table)
     against its plain torch version on the card, at 1024x1024 on the
     256^3 bonsai (bench, eye-inside and diagonal poses) and on a random
     256^3 volume with full borders: finite, max |d| < 1e-3 and
     mean |d| < 1e-5 on rgb (expected bitwise); the dense-stress frame
     (bench.py:433-440: config 3 on volume.io.dense_stress, ~50 % of the
     voxels above 0) through the exact entry point BonsaiRenderer, one K1
     launch, bitwise; a batch of views through K1 in one launch (the
     view on the grid's z): 8 orbit views at 512^2 and 3 at 1001x563
     (partial 16x8 blocks on both axes) of the 256^3 bonsai, each view
     bitwise equal to a single-view launch on its uniform and to the
     plain version;
  3b. K3, K4 (low-degree transfer), K4b (K4's exact-transfer mode) and K6
     against their plain versions on the card, at the bench pose's fast
     geometry (256^3, 1024^2, I=512; K3 + K4 also at I=1024), both marching
     directions: K3 bitwise (it rounds as the TPU kernel does), K4
     and K4b max <= 1e-4, K6 bitwise (max <= 1e-6) at 1024^2, 1920x1080
     (config 4's frame, partial tiles) and 1001x563 (width and pixel count
     not multiples of 4), each at I=512 and I=1024 with 3 and 4 channels
     (warp_check.warp_inputs); K34 (K3 -> K4 in one kernel, the
     frames' slab stage) at I=512 and I=1024, the bench and eye-inside
     poses, and at I=64 (tiles whose windows exceed the shared capacity),
     both directions and transfers: bitwise equal to the K3 -> K4 kernel
     pair and to its plain version, its device count of windows
     over capacity equal to the window rule's;
  3c. K5 (the stats warp) against its plain version at phase 3b's frames
     and intermediates: rgb bitwise, STAT_OVF/EXT/PEAK exact,
     STAT_CURV/EDGE within 1e-5 relative; K2 (the tile re-march) and K1b (its
     compact mode) at 1024^2 and at config 4's 1920x1080 (a partial last
     tile row) over single tiles and tile pairs with parked ids and the last
     tile row's first and last units, both transfer modes: bitwise, every
     other pixel unchanged, and the guard bands around the frame's planes
     unwritten; then a real pose for the partial last tile row: the first
     pose of the hybrid's 72-pose grid (tools/cpu_minisweep.py:67-69) at
     1920x1080, I=1024, budget 128, whose selection holds a unit there,
     K2 at it bitwise its plain version in both transfer modes (or, where
     no pose of the grid selects one, that printed);
  3d. K7 (the field march) against its plain version at 512^2, Camera.xor:
     the xor demo's fbm field with analytic and fd normals, the trig field
     with emission and the bitwise xor field, at t = 0 and 1.7, sphere clip
     on and off (expected bitwise; held at test_pallas.py's 5e-3 / 1e-5);
     K7 and K8 with a hash table cut short must trap (a process of its own
     each, which exits 3 after the synchronization raised); K9 (the xor
     volumes) at 256^3, t = 0 and 1.25, and K8 (the u8 density) at 512^3
     and 100^3, t = 0, 1.25 and +-pi/2 (sin t = +-1), equal (test_pallas.py's
     K9 tolerances printed beside);
  (the renderers, present and the demos' frames replay CUDA graphs, one per
  static key (vokselis_torch/core/compiled.py): a replay calls no kernel
  wrapper, so phases 3-4m require each path kernel's wrapper, and no other,
  to have counted launches (the graph's warm-up and capture), and phase 4n
  runs each of those paths again under a torch.profiler trace, which counts
  the kernels by their __global__ names, once per frame as before; 4i and
  4j count theirs in traces too. No profiler runs before phase 5's timings:
  the host's launches run slower after a profiler session)
  4. the exact main path: engine.loop.run(BonsaiDemo) for 8 frames at
     1024x1024 on "cuda", which must launch K1 once per frame (and no fast
     kernel) and end in a finite, non-background frame that agrees with the
     plain version;
  4b. the fast main path: run(BonsaiDemo with renderer="fast") for 8 frames
     at 1024x1024, which must launch K34 and K6 once per frame (and not
     K1, K3 or K4) and end in a finite, non-background frame that agrees with the
     plain fast path on the card;
  4c. the fast frame (I=256 and I=512) against the port's exact K1 frame
     at four poses: mean |d| over rgba within 1.25x of the JAX package's
     measured fast-mode error at that intermediate (PARITY_REPORT.md:56-63);
  4d. the hybrid main path: run(BonsaiDemo with renderer="hybrid", I=512,
     budget 128) for 8 frames at 1024x1024 at the bench pose, which the pose
     classification renders hybrid: K34, K5 and K2 once per frame, K3, K4,
     K6 and K1 never; its last frame against the plain hybrid path (selected ids
     that differ, max on the tiles both selected);
  4e. the hybrid at the reference's operating point (I=1024, budget 64)
     against the port's K1 frame: the bench pose and the 72-pose sweep
     (vokselis_torch/tools/hybrid_sweep.py), every pose's mean |d| over rgb
     <= 1e-3, the hybrid's contract; then the steep class (zoom 1, pitch
     1.2, 8 yaws) at budgets 64 and 128: each yaw's mean against K1 and its
     tiles above the hybrid's threshold beside the units selected (printed);
  4l. config 4 (run after 4e): vokselis_torch/models/orbit.BonsaiOrbit, the
     8-pose orbit at 1920x1080 (bench.py:229-309), exact (K1) and hybrid
     (I=1024, budget 2 x 64) at every pose: K34, K5 and K2 once per
     hybrid-routed pose, K1 once per pose (a pose the shear-warp
     factorization breaks at routes to K1, and its exact frame is its hybrid
     frame), every pose's mean |hybrid - exact| over rgb <= 1e-3 with the
     worst pose printed; K1's frames at pose 0 and at the first degenerate
     pose bitwise its plain version; the degenerate poses forced through the
     hybrid frame, printed, not held; each hybrid pose's units in the
     partial last tile row, printed; the worst hybrid pose against the plain
     hybrid path (phase 4d's check);
  4f. the xor main path: run(XorDemo) for 8 frames at 1280x720 (the demo's
     backbuffer) and at 512^2, which must launch K7 once per frame and no
     other kernel and end in a finite, lit frame equal to the plain version;
     K7 with fd normals against the port's oracle render_compute_inline at
     512^2 (mean <= 1e-5), with analytic normals (mean <= 1e-3, the
     contract), the trig field against render_field; the texture path
     (K9's volumes through render_compute_tex) against the inline oracle;
     run(TrigDemo), which launches no kernel;
  4g. config 5 at reduced depth through vokselis_torch/models/views.
     ViewsBatch: 2 batches, each K8 at 512^3 (t = 0.3 b) and 8 orbit views
     at 512^2 through one K1 launch with 888 steps (the first builds the
     volume's occupancy table); one view against K1's plain version;
  4m. one full config-5 batch (ViewsBatch(): K8 at 512^3 and 64 views at
     512^2): K8 once, K1 once (one ray pass over the batched uniform); the
     volume equal to K8's plain version, all 64 views bitwise equal to 64
     single-view K1 launches, the last view bitwise K1's plain version;
  4n. compiled frames: the main paths of phases 3-4m again under a device
     trace, each kernel once per frame; the exact frame at 1024^2 and
     1920x1080, the fast frame at I=256 and I=512, the hybrid at I=512 / budget 128 (and its
     escalated route at I=768), at I=1024 / budget 64 (and its functional
     builder's degraded flag), the xor frame at 1280x720 (3 poses x 2
     times), the compiled field frame (march_field.FieldRenderer, which
     bench_field times) at 512^2 around Camera.xor(1.0) for the trig field
     with emission and the noise field with xor shading (3 poses x 2
     times each, one key each), the trig raster at 512^2 (with
     Context.update), present with
     its three filters, config 4's orbit (a second pass) and config-5
     batches 1 and 2: one capture per static key; every replay, at 3 poses
     of which the fast frame's dominant axis and marching sign change,
     bitwise equal to the eager frame on the same uniform and time; 0 host
     syncs per replay, per route and per Context.update; the replays'
     kernels from the device trace (K1 once in an exact frame, K34 + K6 in
     a fast one, K34 + K5 + K2 in a hybrid one, K7 in xor, K8 + K1 in a
     config-5 batch); each renderer's graph pool (MiB);
  (phases 4h-4k and 4n run after phase 5, in the order 4h, 4n, 4i, 4j, 4k,
  then phase 6, so that phase 5 times the frames in the process state of
  the earlier phases)
  4h. multi-device (vokselis_torch.parallel.sharding) over an NCCL process
     group of world size 1 (one card), the (views 1, tiles 1) mesh:
     render_views_sharded of 64 orbit views at 512^2 (config 5's views)
     gathered, render_frame_tiled at 1024^2 (bench pose) and
     multi_view_step; every view bitwise equal to the single-device
     batched render and to single-view K1 calls on the same uniforms, the
     frame to a K1 call. The compiled steps (one CUDA graph per
     key, NCCL collectives inside): render_views_sharded gathered and not,
     multi_view_step with a stable renderer (3 batches of views each),
     render_frame_tiled with a stable ray renderer (3 poses at 1024^2) and
     ViewsBatch(mesh=...) at config 5's full width (batches 1, 2, 0): one
     capture per key, each replay bitwise its eager step and the
     single-device result (ViewsBatch without a mesh), no host sync, and
     in one replay's device trace K1 (and K8) once and every device copy of
     the eager step, NCCL's all-gather among them, as a graph node; the
     graph pools. A second group (no backend named) gives an equal mesh on
     new groups: each entry's first call captures again and the first
     group's keys are gone. The sharded batch's and frame's times, replayed
     and eager, beside the single-device ones (the batch also beside the
     views one by one, the frame beside its parts);
  4i. hot reload of K7: XorDemo at 512^2 on a copy of march_field.cu and its
     headers in a temporary directory, Context(watch=True), the watcher
     driven by poll_once: an edited shading constant rebuilds (nvcc) into a
     new library, drops the frame's graph and changes the replayed frame; a
     syntax error returns nvcc's diagnostics and the next frame is bitwise
     the last good one; the restored source gives the unedited K7 frame
     bitwise; rebuild seconds. K7 once a frame: three frames capture (K7 in
     the warm-up, from the trace); the kept frame replays, its K7 counted
     from the replayed graph's own kernel nodes (read through the CUDA
     driver), which its trace must match unless CUPTI returned the trace
     with no device record at all (--hot-reload-repeats N runs the sequence
     N times in a row);
  4j. scene state: save after 2 exact frames at 1024^2, orbit 2 more,
     restore, and the next frame (a replay) is bitwise the saved one; profiler.trace
     around one exact frame names K1's kernel; present(filter="quadratic"
     and "bicubic") on the card against the CPU, upscaled and at the same
     size, within 1e-5;
  4k. native I/O: the native PNG of the frame byte-equal to the Python
     encoder's and decoding to it, a NativeRecorder screenshot, and
     examples/interactive_torch.py for 3 frames on the card without a tty
     (exit 0);
  5. timing with CUDA events. Each kernel's device_ms: a CUDA graph of 50
     launches replayed between two events, over 50 (the host's wrapper
     code is not in it); its call_ms (also the JSON line's ms): one wrapper
     call between two events, median of 100 (what a host-bound frame pays). Both for every kernel
     (K1, K1b, K2, K3, K4, K4b, K34, K5, K6, K7 in its three modes, K8, K9) and
     for the grid_sample yardsticks of K3's and K6's functions (and of
     K5's warp alone: K5's statistics have no library counterpart); plain
     versions, the frames' other stages, whole exact, fast and hybrid
     frames (the hybrid's stages at I=512/budget 128 and I=1024/budget 64;
     K5's device time and bound at both intermediates, and its gather alone:
     K6 on K5's inputs with 4 and with 3 channels; K5's and K6's bounds read
     only the intermediate texels that their pixels' taps touch),
     the bounds (K1's and K2's count a skipped step's work, not a sampled
     one's) and the ranking by device ms - bound. K1's and K2's share of
     marched steps skipped (skip_counts) at the bench pose and for a
     config-5 view, and the occupancy tables' build times; K34 at I=512
     and I=1024, both transfers, beside the K3 -> K4 pair on the same
     inputs, with its bound (the pack texels its composited samples tap)
     and mean window; each demo frame (exact, fast, hybrid, xor, trig),
     config 4's exact and hybrid frames and the config-5 batch eager and
     replayed in the same interleaved rounds, with the replayed frames'
     host syncs (and the eager ones'), device busy ms and idle share; K6's and its
     grid_sample's replays (min / median / max); the peak device memory of
     a fast frame (I=512) and a hybrid call (I=1024), with K34 and with the
     pair in its place;
     K7 at 512^2 with its lane efficiency (sum of steps over the sum of 32 x
     each warp's longest ray) and the hash table's build time, K9 at 256^3,
     K8 at 512^3 (each octave's table window per brick, and the device
     times of other bricks, each equal to the default's), the whole xor
     demo frame at 1280x720 with its host syncs, idle share and lane
     efficiency, the trig demo frame and the trig field frame, one full
     config-5 batch of 64 views (ViewsBatch), in interleaved rounds with
     the per-view loop it replaced (the yardstick, kept only here), its
     device time from a CUDA graph of the batch step (which must capture,
     so the step makes no host sync), its host syncs, its batched ray pass and
     batched K1 alone, its peak device memory, and one view's K1 device time;
     the dense-stress frame's K1 device time, entry-point frame, skip share
     and bound; config 4's exact and hybrid frames at 1920x1080, the poses
     in turn, and K1's device time there.
  6. the port's bench entry points, each in a process of its own with its
     own time limit: python -m vokselis_torch.bench (bench.py's flagship
     invocation: the exact frame, fast at I=256, the hybrid at OPPOINT.json's
     operating point and the flagship's error against the oracle), whose one
     stdout line must carry exactly the keys of bench.py's branch that
     applies, the hybrid headlining only within 1e-3, mean_err (and
     exact_mean_err) <= 1e-3 and every *_ms finite and above 0, printed
     beside phase 5's replayed exact and hybrid frames; python -m
     vokselis_torch.tools.multichip_bench --json at world 1 (NCCL, one
     card), rows A and B with the JAX tool's keys. Then the hybrid's
     measuring tools, side by side, each in a process of its own with its
     own time limit, at reduced settings that keep the widths (1024^2,
     I=1024): hybrid_operating_point (budgets 0, 64, 128, one repeat: the
     JAX tool's keys and the card's, every ms finite and > 0, the bench
     pose's error at 64 equal to the bench line's hybrid mean_err), and in
     this process one traced replay of its timed frame per budget (K2 0
     times at budget 0, once above: from the graph's kernel nodes, the
     trace matching unless empty); residual_decay at two poses (the oracle
     curve <= the actual one at every budget, both the total at 0);
     fast_error_report at I=256 (its means within 1.25x of
     PARITY_REPORT.md:56-59); dense_stress_probe at the bench pose (every
     error finite); contact_sheet at 256^2 a cell (16 K1 frames, the PNG
     written and 2 x 8 cells).

The last lines are the card's name and power limit, a JSON line describing
each kernel, and ``{"ok": true, "device": {...}}``. Any failed check or
exception exits nonzero before those lines. Needs no JAX and no network.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import re
import shutil
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
GRAPH_LAUNCHES = 50  # launches per CUDA graph for a kernel's device time
MAIN_FRAMES = 8
II = 512  # FastBonsaiRenderer's default intermediate
II_HYBRID = 1024  # the hybrid's operating point (OPPOINT.json)
K4_TOL = 1e-4  # tests/test_pallas.py:394, tests/test_fast.py:165
K6_TOL = 1e-6
HYBRID_CONTRACT = 1e-3  # per-pose mean |hybrid - exact| over rgb (ROADMAP north star)
BUDGET_OP = 64  # the hybrid's operating point with II_HYBRID (OPPOINT.json)
STEEP_BUDGETS = (64, 128)  # phase 4e's steep-class line
# K4's 1e-4 through sRGB's steepest slope (12.92): the fast frame vs plain
FAST_FRAME_TOL = 2e-3
# PARITY_REPORT.md:56-63, the fast frame at I=256 and I=512 vs the exact
# kernel at 1024^2 (mean, p99 over rgba), held here within 1.25x on the mean
FAST_ERR = {
    256: {"default": (0.00344, 0.0918), "tilt": (0.00200, 0.0587),
          "low": (0.00261, 0.0660), "orbit135": (0.00466, 0.1374)},
    512: {"default": (0.00211, 0.0535), "tilt": (0.00152, 0.0472),
          "low": (0.00164, 0.0407), "orbit135": (0.00288, 0.0749)},
}
FAST_ERR_SLACK = 1.25

# H100 SXM peaks (NVIDIA's data sheet, dense, 700 W): bytes/s and float32 flop/s
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
# float32 operations per unit of work, counted from the CUDA sources (adds,
# subtracts, multiplies, min/max, floor; each cosf/expf/logf as one):
OPS_K1_STEP = 86  # march_bonsai.cu: 41 trilinear + 27 transfer + 11 composite + 7 advance
# a step K1 or K2 skips (march_bonsai.cu march_ray): 6 texel position + 3
# floors for the lower taps, whose cell decides the skip, + 7 advance (the
# cell index is integer work, uncounted as the tap addresses are)
OPS_SKIP_STEP = 16
# shear_resample.cu: a resampled sample's 6 multiplies and 3 adds (the bf16
# roundings are conversions, uncounted); a position's two hat weights, a
# floor, c0 + 1, two differences, two 1 - |.| and two clamps, which the
# function needs once per slab and row (pos_v) or column (pos_u)
OPS_K3_SAMPLE = 9
OPS_HAT_POS = 8
OPS_K4_SAMPLE = 73  # low-degree: 9 smoothstep, 2 + 48 palette, 5 alpha, 9 composite
OPS_K4B_SAMPLE = 41  # exact: 9 smoothstep, 3 x 6 palette (one cosf), 5 alpha, 9 composite
# the fused kernel: K3's resample for every sample K4 reads, K4's (K4b's)
# shading for those above 0.1 (the others add an exact zero)
OPS_SHADE = {"lowdeg": OPS_K4_SAMPLE, "exact": OPS_K4B_SAMPLE}
OPS_K6_PIXEL = 8  # warp2d.cu: 4 clamps, 2 floors, 2 fractions ...
OPS_K6_CHANNEL = 9  # ... and 3 lerps per channel
# K2 with the polynomial palette: 41 trilinear + 9 smoothstep + 2 + 80 Horner
# palette + 11 composite + 7 advance
OPS_K2_STEP = 150
OPS_K5_PIXEL = 20  # warp2d.cu: lum 4, log/exp 3, slope 3, sRGB lum 2, curv 2, edge 5, peak 1
# march_field.cu / fields.cuh, per sample (each sinf, floorf, sqrtf and
# division as one): position 6 + quantize 21 + alpha 10 + composite 15 +
# advance 1 = 53 (32 unquantized); xor_shade 46; the fused noise field with
# analytic normals 432 (24 hash sines), with the hash-shared one-sided
# difference 841 (60 sines); the trig field 28
OPS_K7_SAMPLE = {"xor analytic": 53 + 46 + 432, "xor fd": 53 + 46 + 841, "trig": 32 + 28}
# the volume kernels' function evaluated voxel by voxel: coordinates 6 + fused
# field and normal 841 + |n| 6 + val/2 1 (K9); coordinates 6 + fbm alpha 282 +
# quantize 4 (K8)
OPS_K9_VOXEL = 854
OPS_K8_VOXEL = 292
# the volume kernels' function at its least work, the bounds' count (that of
# the voxel-by-voxel evaluation above is printed beside). Per voxel only what
# differs from voxel to voxel: each octave's z mix (3), amplitude and sum
# (K8 14; K9 56 over its four points), each point's radius from the per-axis
# squares (two adds and sqrt 3), smoothstep 8 and alpha 1, then K8's
# quantization 4 (30), or K9's three differences, normalize 11, |n| 6 and
# val/2 1 (125). The rest is shared (lattice_ops): per axis coordinate its
# centre 2, lattice 2, square 1, three octaves' floor, fraction and smooth
# 18 and two scalings (25; K9's offset ones 26 with the - eps); per lattice
# point and octave its hash fract(sin(n) * 43758.5453) 4; the trilinear mix
# axis by axis, 3 a mix: x mixes per x and lattice row and plane, y mixes
# per voxel column and plane
OPS_K8_VOXEL_MIN = 30
OPS_K9_VOXEL_MIN = 125
OPS_AXIS = 25
OPS_HASH = 4
OPS_MIX = 3
XOR_RES = (1280, 720)  # the xor demo's backbuffer (HdrBackBuffer default)
# each kernel's __global__ function, as a device trace names it: a replayed
# CUDA graph calls no wrapper, so the paths' launches are counted from traces
KERNEL_NAMES = {"K1": "march_bonsai_kernel", "K2": "march_tiles_kernel",
                "K3": "resample_kernel", "K4": "composite_kernel",
                "K34": "resample_composite_kernel", "K6": "warp_kernel",
                "K5": "warp_stats_kernel", "K7": "march_field_kernel",
                "K9": "genvol_kernel", "K8": "gendensity_kernel"}
# phase 4n's poses: hybrid at I=512 and I=1024 at 1024^2 and 1920x1080, the
# fast frame's (m, sgn) (0, +1), (2, -1), (1, +1); the escalated ones are
# degenerate at I=512 but not at I=768 at 1024^2
COMPILED_POSES = {"bench": dict(zoom=1.0, pitch=0.5, yaw=1.0),
                  "yaw3": dict(zoom=1.0, pitch=0.5, yaw=3.0),
                  "top": dict(zoom=1.0, pitch=1.2, yaw=0.3)}
ESCALATED_POSES = [dict(zoom=1.0, pitch=-0.35, yaw=2 * math.pi * i / 8) for i in (1, 3, 5)]
FIELD_RES = 512  # configs 1 and 2 (bench.py:442-444)
K7_MAX, K7_MEAN = 5e-3, 1e-5  # test_pallas.py:41-58, K7 vs plain if not bitwise
VIEW_RES, VIEWS, VIEWS_SMOKE, VOL5 = 512, 64, 8, 512  # config 5 (bench.py:312-371)
# phase 4h's timing rounds: a 64-view batch takes ~20-30 ms batched and
# ~70-125 ms view by view, a 1024^2 frame ~1.5
MESH_BATCH_ROUNDS, MESH_FRAME_ROUNDS = 25, 60
# phase 6: the bench line's keys in each of bench.py's branches (bench.py:476-504;
# the default rows time the hybrid, so the exact branch carries its numbers),
# multichip_bench's rows at world 1, and each tool's time limit
BENCH_KEYS_HYBRID = ["metric", "value", "unit", "vs_baseline", "p50_ms", "mean_err",
                     "hybrid_budget", "exact_mrays", "exact_p50_ms", "exact_mean_err"]
BENCH_KEYS_EXACT = ["metric", "value", "unit", "vs_baseline", "p50_ms", "mean_err",
                    "hybrid_mrays", "hybrid_p50_ms", "hybrid_mean_err", "hybrid_budget"]
MULTICHIP_ROWS = [
    ("views_weak_scaling", 1,
     ["mode", "chips", "views", "ms_per_batch", "mrays_s", "weak_efficiency"]),
    ("frame_row_sharded", 1, ["mode", "chips", "ms_per_frame", "mrays_s", "speedup"])]
BENCH_TIMEOUT_S, MULTICHIP_TIMEOUT_S = 180, 120
# the hybrid tools' JSON (tools/hybrid_operating_point.py:202-210, and the
# card's nvidia-smi line), the tools' time limit and their reduced settings
OPPOINT_KEYS = ["operating_point", "fit", "drift_sentinel", "ladder", "note", "card"]
TOOLS_TIMEOUT_S = 240
TOOL_BUDGETS = (0, 64, 128)
DECAY_POSES, DECAY_BUDGETS = ("bench", "z1.6-diag"), (0, 16, 64, 128)
# phase 5's config-5 rounds (the batch against the per-view loop) and the
# batch steps in its CUDA graph
C5_ROUNDS, C5_GRAPH_STEPS = 9, 5


# K7 or K8 (argv[2]) with a hash table that misses most of octave 0's lattice
# arguments: the kernel must trap and the stream's synchronization raise (exit 3)
TRAP_CHECK = """
import sys
import torch
sys.path.insert(0, sys.argv[1])
from vokselis_torch.core.camera import Camera
from vokselis_torch.ops.cuda import genvol, hash_table as ht, march_field as mf
dev = torch.device("cuda", 0)
(lo, _), *rest = ht.HASH_RANGES
bad = ht.build_hash_table(dev, ((lo, lo + 300), *rest))
if sys.argv[2] == "K7":
    rays = mf.field_rays(Camera.xor(1.0).uniform(dev), 64, 64)
    mf.launch(mf.time_vector(0.0, dev), rays, "noise", "xor", 256, True, 348, "analytic", 8,
              table=bad)
else:
    genvol.launch_density(torch.zeros((), device=dev), 512, table=bad)
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", str(e).strip().splitlines()[0])
    sys.exit(3)
print("no error")
"""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def median_ms(fn, n: int, torch, warmup: int = WARMUP) -> float:
    """Median CUDA-event time of ``fn`` over ``n`` calls, after a warm-up."""
    for _ in range(warmup):
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


def interleaved_ms(fns: dict, n: int, torch, warmup: int = 1) -> dict:
    """Median CUDA-event time of each of ``fns``' calls over ``n`` rounds, the
    functions called in turn within a round, so that a drift of the host's
    speed during the loop reaches each alike."""
    for _ in range(warmup):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for _ in range(n):
        for k, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end))
    return {k: sorted(t)[len(t) // 2] for k, t in times.items()}


def device_ms(fn, torch, n: int = GRAPH_LAUNCHES, reps: int = 5, spread: bool = False):
    """The device time of one call of ``fn``: ``n`` calls captured in one
    CUDA graph, replayed between two CUDA events, divided by ``n`` (median
    of ``reps`` replays after one warm replay; with ``spread``, the replays'
    (min, median, max)). The host's wrapper code runs only while the graph
    is captured, so a kernel and a library call are timed alike, without
    the host's share; L2 is warm."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    times.sort()
    mid = times[len(times) // 2]
    return (times[0], mid, times[-1]) if spread else mid


def lane_efficiency(steps, torch) -> float:
    """K7's SIMT lane efficiency from per-pixel step counts (H, W): the sum
    of steps over the sum, over warps (32 consecutive pixels of a row, as
    K7's 32-wide blocks lay them out), of 32 x the warp's longest ray."""
    s = torch.nn.functional.pad(steps.float(), (0, (-steps.shape[1]) % 32))
    s = s.reshape(steps.shape[0], -1, 32)
    return float(s.sum() / (32.0 * s.amax(dim=-1)).sum())


def skip_counts(vol, eye, dirs, steps, torch):
    """K1's and K2's work on the rays ``dirs`` (H, W, 3) from ``eye``, given
    the plain march's per-ray step counts ``steps``: (steps marched, steps
    skipped). Each ray's positions are accumulated as the march accumulates
    them, and a step skips where the cell of its lower taps holds no voxel
    above OCC_CUT in the volume's occupancy table (march_bonsai.cu
    march_ray's test)."""
    from vokselis_torch.core import geometry
    from vokselis_torch.ops.cuda import march_bonsai as mb
    from vokselis_torch.volume.sample import trilinear_weights

    dims = vol.shape[0]
    occ = mb.occupancy_table(vol).reshape(-1).long()
    cells = -(-dims // mb.OCC_CELL)
    d = dirs.reshape(-1, 3)
    n = steps.reshape(-1)
    eye_b = eye.expand_as(d)
    t0, _ = geometry.intersect_box_unit(eye_b, d)
    dt = torch.amin(1.0 / (float(dims) * torch.abs(d)), dim=-1)
    p = eye_b + torch.clamp(t0, min=0.0)[:, None] * d
    sizes = torch.full((3,), float(dims), dtype=torch.float32, device=d.device)
    skipped = torch.zeros((), dtype=torch.int64, device=d.device)
    for k in range(int(n.max())):
        active = n > k
        lower = torch.clamp(trilinear_weights(p, sizes)[0], 0, dims - 1) // mb.OCC_CELL
        empty = occ[(lower[:, 2] * cells + lower[:, 1]) * cells + lower[:, 0]] <= mb.OCC_CUT
        skipped += (active & empty).sum()
        p = torch.where(active[:, None], p + d * dt[:, None], p)
    return int(n.sum()), int(skipped)


def lattice_ops(dims: int, sin_t: float, offsets: bool, torch) -> int:
    """The operations of the volume kernels' function at dims^3 that voxels
    share, at their least (K9 with ``offsets``: its one-sided offset points'
    too): each axis coordinate's terms once, each octave's hashes once per
    lattice point its voxels reach, and the trilinear mix taken axis by
    axis: x mixes once per x, lattice row and lattice plane, y mixes once
    per voxel column and plane, over the rows and planes the whole grid
    reaches. The z mixes are per voxel (OPS_K8_VOXEL_MIN, OPS_K9_VOXEL_MIN)."""
    from vokselis_torch.ops.cuda import genvol

    c = (torch.arange(dims, dtype=torch.float32) - dims / 2.0) * genvol._inv(dims)
    s = torch.tensor(sin_t, dtype=torch.float32)

    def cells(v):
        """Each octave's lattice cells of the coordinates v: floors and
        floors + 1."""
        out = []
        for scale in (2.01, 2.02, None):
            p = set(torch.floor(v).long().tolist())
            out.append(p | {q + 1 for q in p})
            if scale is not None:
                v = v * scale
        return out

    def axes(c):
        return [cells((c + 1.0) * 32.0), cells((c + s * 0.1) * 32.0), cells((c + 21.0) * 32.0)]

    (xs, ys, zs), ops = axes(c), 3 * dims * OPS_AXIS
    if offsets:
        (xes, yes, zes), ops = axes(c - 1e-4), ops + 3 * dims * (OPS_AXIS + 1)
    for o in range(3):
        x, y, z = xs[o], ys[o], zs[o]
        if not offsets:
            ops += (OPS_HASH * len(x) * len(y) * len(z) + OPS_MIX * dims * len(y) * len(z)
                    + OPS_MIX * dims * dims * len(z))
            continue
        xe, ye, ze = xes[o], yes[o], zes[o]
        zv = z | ze  # the value column's planes, its z-offset point's included
        ops += OPS_HASH * (len(x | xe) * len(y) * len(z) + len(x) * len(ye - y) * len(z)
                           + len(x) * len(y) * len(ze - z))
        # x mixes at each x's fraction (the value and its y- and z-offset
        # points) and at its offset's (the x-offset point)
        ops += OPS_MIX * dims * (len(y) * len(zv) + len(ye - y) * len(z) + len(y) * len(z))
        # y mixes of the value's column and of the x- and y-offset columns
        ops += OPS_MIX * dims * dims * (len(zv) + 2 * len(z))
    return ops


def bound_ms(n_bytes: float, n_ops: float):
    """Least time for the work: the larger of bytes over the memory rate and
    operations over the float32 peak; returns (ms, which bound, bytes ms,
    operations ms)."""
    t_bytes, t_ops = n_bytes / HBM_BPS, n_ops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            t_bytes * 1e3, t_ops * 1e3)


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


def shaded_samples(stack, sgn, irho, occ_rb, transfer, torch):
    """Of the samples K4 composites (marching order, row-block gate, alpha
    below 0.95), those above 0.1: the ones the fused kernel shades. Alpha
    follows composite_plain's update, which a sample <= 0.1 leaves as it is."""
    from vokselis_torch.core.colors import bonsai_transfer_pow_lowdeg_soa, bonsai_transfer_soa

    g, iv, _ = stack.shape
    rows = occ_rb.repeat_interleave(iv // occ_rb.shape[1], dim=1)
    a = torch.zeros(stack.shape[1:], dtype=torch.float32, device=stack.device)
    count = torch.zeros((), dtype=torch.int64, device=stack.device)
    for t in range(g):
        k = t if int(sgn[0]) > 0 else g - 1 - t
        s = stack[k].float()
        live = (a < 0.95) & rows[k][:, None]
        count += (live & (s > 0.1)).sum()
        if transfer == "exact":
            tv = bonsai_transfer_soa(s)[0]
            alpha = 1.0 - torch.exp(irho * torch.log(1.0 - tv))
        else:
            alpha = bonsai_transfer_pow_lowdeg_soa(s, irho)[0]
        a = a + torch.where(live, (1.0 - a) * alpha, 0.0)
    return int(count)


def tapped_texels(pack, geo, count, torch):
    """What the fused kernel must read for the samples it composites:
    (distinct pack texels (slab, v, u) their valid taps touch, samples
    resampled, slabs with such a sample). At a texel, composite_plain's live
    samples are the first ``count`` slabs in marching order that its row
    block's gate keeps (alpha only grows, so once it reaches 0.95 no later
    slab is live); of those, the slabs occ_k keeps (k < G) are resampled, the
    others add an exact zero with no taps."""
    from vokselis_torch.ops.cuda import shear_resample as sr

    g, d = pack.shape[1], pack.shape[2]
    gp, iv = geo.pos_v.shape
    nrb = geo.occ_rb.shape[1]
    block = torch.arange(iv, device=pack.device) // (iv // nrb)
    seen = torch.zeros(nrb, dtype=torch.int32, device=pack.device)  # gated slabs so far
    resampled = torch.zeros((), dtype=torch.int64, device=pack.device)
    texels = torch.zeros((), dtype=torch.int64, device=pack.device)
    slabs = torch.zeros((), dtype=torch.int64, device=pack.device)
    hit = torch.zeros(d * d, dtype=torch.bool, device=pack.device)
    occ_k = geo.occ_k.tolist()
    for k in (range(gp) if int(geo.sgn[0]) > 0 else range(gp - 1, -1, -1)):
        if k < g and occ_k[k]:
            live = geo.occ_rb[k][block][:, None] & (seen[block][:, None] < count)
            v0, v1, v0ok, v1ok, _ = sr._taps(geo.pos_v[k], d)
            u0, u1, u0ok, u1ok, _ = sr._taps(geo.pos_u[k], d)
            hit.zero_()
            for vi, vok in ((v0, v0ok), (v1, v1ok)):
                for ui, uok in ((u0, u0ok), (u1, u1ok)):
                    ok = live & vok[:, None] & uok[None, :]
                    hit[(vi[:, None] * d + ui[None, :])[ok]] = True
            n_live = live.sum()
            resampled += n_live
            texels += hit.sum()
            slabs += n_live > 0
        seen += geo.occ_rb[k].int()
    return int(texels), int(resampled), int(slabs)


def rgb_err(a, b):
    d = (a[..., :3] - b[..., :3]).abs()
    return float(d.max()), float(d.mean())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--png", default=None,
                        help="also write the exact main path's final frame here")
    parser.add_argument("--hot-reload-repeats", type=int, default=1,
                        help="run phase 4i's sequence this many times in a row, each held "
                             "to K7 once a frame")
    args = parser.parse_args()
    reload_repeats = args.hot_reload_repeats  # later phases rebind args
    t_start = time.perf_counter()

    # torch.profiler's own setting for a program with CUDA graphs
    # (torch/profiler/profiler.py): CUPTI stays up between the traces (its
    # teardown and lazy re-initialization lose kernel records around graphs)
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    os.environ.setdefault("DISABLE_CUPTI_LAZY_REINIT", "1")
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
    from vokselis_torch.core.camera import Camera, CameraUniform
    from vokselis_torch import native
    from vokselis_torch.engine import profiler
    from vokselis_torch.engine.context import Context, Presenter
    from vokselis_torch.engine.loop import run
    from vokselis_torch.engine.state import load_state, save_state
    from vokselis_torch.media.png import read_png, write_png
    from vokselis_torch.models import orbit as orbit_model
    from vokselis_torch.models.bonsai import BonsaiDemo
    from vokselis_torch.models.trig import TrigDemo
    from vokselis_torch.models.trig import trig_frame as trig_eager_frame
    from vokselis_torch.models.views import ViewsBatch
    from vokselis_torch.models.xor import FieldPipeline, XorDemo
    from vokselis_torch.ops import hybrid as hy
    from vokselis_torch.ops import reference, shear_warp
    from vokselis_torch.ops.cuda import build as kbuild
    from vokselis_torch.ops.cuda import genvol
    from vokselis_torch.ops.cuda import march_field as mf
    from vokselis_torch.ops.cuda import march_bonsai as mb
    from vokselis_torch.ops.cuda import shear_resample as sr
    from vokselis_torch.ops.cuda import warp2d as w2
    from vokselis_torch.ops.present import present, to_uint8
    from vokselis_torch.ops.reference import MAX_STEPS_BONSAI
    from vokselis_torch.parallel import sharding
    from vokselis_torch.tools import hybrid_operating_point, hybrid_sweep
    from vokselis_torch.tools import warp_check
    from vokselis_torch.utils.grid import cdiv
    from vokselis_torch.volume.io import dense_stress, get_bonsai

    import numpy as np

    def reset_launches():
        mb.LAUNCHES = mb.LAUNCHES_FRAME = 0
        sr.LAUNCHES_RESAMPLE = sr.LAUNCHES_COMPOSITE = w2.LAUNCHES_WARP = 0
        sr.LAUNCHES_RESAMPLE_COMPOSITE = 0
        mb.LAUNCHES_TILES = w2.LAUNCHES_STATS = 0
        mf.LAUNCHES_FIELD = genvol.LAUNCHES_GENVOL = genvol.LAUNCHES_DENSITY = 0

    def launches():
        # K1 counts in two wrappers: over ray planes and making its own rays
        return {"K1": mb.LAUNCHES + mb.LAUNCHES_FRAME, "K3": sr.LAUNCHES_RESAMPLE,
                "K4": sr.LAUNCHES_COMPOSITE, "K34": sr.LAUNCHES_RESAMPLE_COMPOSITE,
                "K6": w2.LAUNCHES_WARP,
                "K5": w2.LAUNCHES_STATS, "K2": mb.LAUNCHES_TILES,
                "K7": mf.LAUNCHES_FIELD, "K9": genvol.LAUNCHES_GENVOL,
                "K8": genvol.LAUNCHES_DENSITY}

    def only(**counts):
        """The launch counts of a path that launches just these kernels."""
        return {k: counts.get(k, 0) for k in launches()}

    def traced(fn):
        """``fn()``'s result and the kernels it ran on the card, counted by
        name in a torch.profiler trace (replayed graphs' included)."""
        out, counts = profiler.kernel_launches(fn, list(KERNEL_NAMES.values()))
        return out, {k: counts[v] for k, v in KERNEL_NAMES.items()}

    def traced_replays(fn):
        """:func:`traced` for a ``fn`` that only replays captured graphs (it
        calls no wrapper and captures nothing), traced again, at most three
        times, when CUPTI hands back a trace with no device record at all
        (phase 4i's lost K7 record; phase 4h's graph_work)."""
        for _ in range(3):
            out, events = profiler.device_events(fn)
            if events:
                break
        counts = profiler.count_kernels(events, list(KERNEL_NAMES.values()))
        return out, {k: counts[v] for k, v in KERNEL_NAMES.items()}

    def replayed(fn, compiled, name):
        """``fn()``, which replays the most recently used graph of the
        CompiledFrame ``compiled`` once: its result, the kernels of that
        replay counted from the graph's own kernel nodes (read through the
        CUDA driver), and whether its trace came back with no device record
        at all. A trace that holds records must count the same kernels."""
        captures = compiled.captures
        out, events = profiler.device_events(fn)
        check(compiled.captures == captures, f"{name} captured a graph, not replayed one")
        nodes = profiler.graph_kernels(compiled.graph(compiled.keys()[-1]),
                                       list(KERNEL_NAMES.values()))
        nodes = {k: nodes[v] for k, v in KERNEL_NAMES.items()}
        on_trace = profiler.count_kernels(events, list(KERNEL_NAMES.values()))
        on_trace = {k: on_trace[v] for k, v in KERNEL_NAMES.items()}
        check(not events or on_trace == nodes,
              f"{name}: its trace counted {on_trace}, its graph's kernel nodes {nodes}")
        return out, nodes, not events

    def wrapped(counts):
        """The kernels whose wrapper counted a launch (a compiled frame's
        first call: its warm-up and its capture; a replay calls none)."""
        return sorted(k for k, v in counts.items() if v)

    def wrapper_check(name, counts, *kernels):
        """A path's run: each of its kernels' wrappers counted launches (a
        compiled frame's warm-up and capture), no other kernel's. Phase 4n
        counts the kernels on the device, once per frame, in a trace of the
        path run again (after phase 5, whose timings a profiler session
        before them would slow)."""
        check(wrapped(counts) == sorted(kernels),
              f"{name}: the wrappers of {wrapped(counts)} counted launches, not {sorted(kernels)}")

    def path_check(name, on_device, counts, **want):
        """A path's kernels: once per frame on the device as ``want`` says,
        none other, and each one's wrapper counted."""
        check(on_device == only(**want) and wrapped(counts) == sorted(want),
              f"{name} launched {on_device} on the device (wrappers {counts}), not "
              f"{only(**want)}")

    def synced(fn):
        """``fn()``'s result and the host syncs it made."""
        out = []
        return out, host_syncs(lambda: out.append(fn()), torch)

    def bitwise(a, b):
        """Bitwise equal tensors, or tuples of them."""
        if isinstance(a, tuple):
            return all(bitwise(x, y) for x, y in zip(a, b))
        return torch.equal(a, b)

    # -- phase 1: device --------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {card} | {kind} | count {torch.cuda.device_count()} "
          f"| capability {torch.cuda.get_device_capability(0)} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda}", flush=True)
    dev = torch.device("cuda", 0)

    # -- phase 2: build (one nvcc per source, all started together) -------
    modules = {"K1+K2": mb, "K3+K4+K34": sr, "K6+K5": w2, "K7": mf, "K9+K8": genvol}
    t0 = time.perf_counter()

    def build_native():
        """The native I/O library (g++), built beside the kernels so that
        no later phase's timing pays for it; its seconds for phase 4k."""
        native.get_lib()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(modules) + 1) as pool:
        native_fut = pool.submit(build_native)
        for fut in [pool.submit(m.build) for m in modules.values()]:
            fut.result()
        native_s = native_fut.result()
    build_s = time.perf_counter() - t0
    sources = ", ".join(f"{k} {os.path.relpath(m.SOURCE, ROOT)}" for k, m in modules.items())
    print(f"phase 2 build: {sources} -> {os.path.relpath(kbuild.BUILD_DIR, ROOT)} in "
          f"{build_s:.2f} s", flush=True)
    for name, m in modules.items():
        for line in m.BUILD_LOG.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"phase 2 ptxas {name}: {line.strip()}")
    # K9 and K8 read their hashes from the table and call no sinf, whose slow
    # reduction of large arguments takes a local-memory stack frame
    # reduction of large arguments takes a local-memory stack frame. The
    # library's SASS is the evidence; ptxas's report only when this process
    # built it
    frames = [int(b) for b in re.findall(r"(\d+) bytes stack frame", genvol.BUILD_LOG)]
    cuobjdump = os.path.join(os.path.dirname(kbuild.nvcc()), "cuobjdump")
    check(os.path.isfile(cuobjdump), f"no {cuobjdump} to read K9's and K8's SASS")
    sass = subprocess.run([cuobjdump, "-sass", genvol.build()._name], capture_output=True,
                          text=True, check=True).stdout
    entries = sorted(set(re.findall(r"Function : \S*?(gen(?:vol|density)_kernel)", sass)))
    local = len(re.findall(r"\b(?:LDL|STL)\b", sass))
    print(f"phase 2 K9+K8: kernels {entries} in the SASS, local-memory loads and stores "
          f"{local}; ptxas stack frames "
          + (f"{frames} bytes" if frames else "not reported (the library was built before)"),
          flush=True)
    check(len(entries) == 2, f"K9's and K8's kernels not both in the SASS ({entries})")
    check(local == 0 and not any(frames), "K9 or K8 uses local memory (a sinf reduction?)")
    # the fused kernel (K34) per instantiation: <exact transfer>.
    # The frame's low-degree ones must touch no local memory; the exact ones
    # carry cosf's stack frame for arguments beyond 105615, which the
    # transfer's (|x| <= 13.2) never reach
    sass = subprocess.run([cuobjdump, "-sass", sr.build()._name], capture_output=True,
                          text=True, check=True).stdout
    k34_local = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split()[0]
        if "resample_composite_kernel" in name:
            exact = re.search(r"ILb([01])E", name).group(1)
            k34_local["exact" if exact == "1" else "lowdeg"] = len(
                re.findall(r"\b(?:LDL|STL)\b", part))
    print(f"phase 2 K34 (resample_composite_kernel) local-memory loads and stores per "
          f"instantiation in the SASS: {k34_local}", flush=True)
    check(len(k34_local) == 2, f"K34 instantiations {k34_local}")
    check(k34_local["lowdeg"] == 0, "the frame's K34 instantiation uses local memory")
    # K6's and K5's global loads in program order, grouped by the first use
    # of a loaded value: the taps of a thread's pixels should form one group
    sass = subprocess.run([cuobjdump, "-sass", w2.build()._name], capture_output=True,
                          text=True, check=True).stdout
    for name, groups in warp_check.load_batches(sass).items():
        m = re.search(r"(warp_\w*kernel)I(.*?)EEEv", name)
        print(f"phase 2 K6+K5 SASS {f'{m.group(1)}<{m.group(2)}>' if m else name}: global "
              f"loads in groups {groups}", flush=True)

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
    worst = {"K1": 0.0, "K3": 0.0, "K4": 0.0, "K34": 0.0, "K6": 0.0, "K5": 0.0, "K2": 0.0,
             "K7": 0.0, "K9": 0.0, "K8": 0.0}
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

    # the dense-stress frame (bench.py:433-440): config 3 through the exact
    # entry point on the ~50 %-occupied fog volume, whose rays march deep
    dense_r = mb.BonsaiRenderer(dense_stress(), dev)
    bench_u = bench.uniform(dev)
    reset_launches()
    img_k = dense_r(bench_u, RES, RES)
    dense_launches = launches()
    wrapper_check("the dense frame", dense_launches, "K1")
    eye, dxyz = geometry.rays_fragment_soa(bench_u, RES, RES)
    img_p = reference.render_bonsai_rays(dense_r.vol, eye, torch.stack(dxyz, dim=-1))
    mx, mean = rgb_err(img_k, img_p)
    dense_equal = torch.equal(img_k, img_p)
    dense_lit = float((img_k[..., :3].amax(dim=-1) > 1.0 / 255.0).float().mean())
    print(f"phase 3 K1 vs plain dense_stress256/bench {RES}x{RES} ({card}; BonsaiRenderer; voxels "
          f"above 0 {float((dense_r.vol > 0).float().mean()):.4f}): bitwise equal {dense_equal}, "
          f"max {mx:.3e} mean {mean:.3e}, lit pixels {dense_lit:.4f}, launches {dense_launches}",
          flush=True)
    check(dense_equal and bool(torch.isfinite(img_k).all()) and dense_lit > 0.01,
          "the dense frame disagrees with K1's plain version or shows nothing")
    worst["K1"] = max(worst["K1"], mx)
    del img_k, img_p

    # a batch of views in one K1 launch (the view on the grid's z): each view
    # bitwise a single-view launch on its own uniform and the plain version;
    # 1001x563 leaves partial 16x8 blocks on both axes
    for n_b, (bw, bh) in ((VIEWS_SMOKE, (VIEW_RES, VIEW_RES)), (3, (1001, 563))):
        ub = sharding.orbit_camera_batch(n_b, aspect=bw / bh, device=dev)
        eye_b, dxyz_b = geometry.rays_fragment_soa(ub, bw, bh)
        before = mb.LAUNCHES
        img_b = mb.render_bonsai_rays_cuda(vol_bonsai, eye_b, dxyz_b)
        torch.cuda.synchronize()
        batch_launches = mb.LAUNCHES - before
        singles_equal = sum(bool(torch.equal(img_b[v], mb.render_bonsai_rays_cuda(
            vol_bonsai, *geometry.rays_fragment_soa(ub[v], bw, bh)))) for v in range(n_b))
        plain_b = mb.render_bonsai_rays_plain(vol_bonsai, eye_b, dxyz_b)
        mx, mean = rgb_err(img_b, plain_b)
        plain_equal = torch.equal(img_b, plain_b)
        print(f"phase 3 K1 batched {n_b} orbit views {bw}x{bh} of bonsai256 ({card}): "
              f"{tuple(img_b.shape)} in {batch_launches} launch(es); views bitwise equal to a "
              f"single-view launch {singles_equal}/{n_b}; bitwise equal to the plain version "
              f"{plain_equal} (max {mx:.3e} mean {mean:.3e})", flush=True)
        check(batch_launches == 1 and singles_equal == n_b and plain_equal,
              f"batched K1 ({n_b} views {bw}x{bh}) is not one launch equal to its single views "
              "and the plain version")
        worst["K1"] = max(worst["K1"], mx)
    del ub, eye_b, dxyz_b, img_b, plain_b

    # -- phase 3b: K3, K4, K4b, K34, K6 against their plain versions -------
    fast_r = shear_warp.FastBonsaiRenderer(vol_bonsai, dev, intermediate=II)
    packs = fast_r.packs
    bench_u = bench.uniform(dev)
    win_stats = {}

    def window_stats(geo):
        """K34's windows by the rule (sr.slab_windows) over the tile-slab
        pairs it composites (both gates on, k < G): mean texels, tiles with a
        window over capacity, windows over capacity."""
        g, d = packs[0].shape[1], packs[0].shape[2]
        wins = sr.slab_windows(geo.pos_u, geo.pos_v, d)
        size = (wins[..., 1] - wins[..., 0] + 1) * (wins[..., 3] - wins[..., 2] + 1)
        kept = geo.occ_k[:, None] & geo.occ_rb & (
            torch.arange(geo.pos_u.shape[0], device=dev) < g)[:, None]
        live = kept[:, :, None].expand_as(size)
        over = live & (size > sr.WINDOW_CAPACITY)
        mean = float(size[live].float().mean()) if bool(live.any()) else 0.0
        return mean, int(over.any(dim=0).sum()), int(over.sum())

    def fused_checks(label, geo, ii):
        """K34 against the K3 -> K4 kernel pair (bitwise) and its plain
        version (K4's tolerance), both marching directions and transfers;
        its device count of windows over capacity against the rule's.
        Returns window_stats(geo)."""
        stack = sr.resample_slabs(packs[0], geo.m, geo.pos_u, geo.pos_v, geo.occ_k)
        over = sr.over_capacity(dev)
        over.zero_()
        runs = 0
        for sgn in (geo.sgn, -geo.sgn):
            for transfer in sr.TRANSFERS:
                args = (packs[0], geo.m, geo.pos_u, geo.pos_v, sgn, geo.irho, geo.occ_k,
                        geo.occ_rb, transfer)
                before = sr.LAUNCHES_RESAMPLE_COMPOSITE
                fused = sr.resample_composite(*args)
                pair = sr.composite(stack, sgn, geo.irho, geo.occ_rb, transfer)
                plain = sr.resample_composite_plain(*args)
                torch.cuda.synchronize()
                check(sr.LAUNCHES_RESAMPLE_COMPOSITE == before + 1, "K34 did not count a launch")
                runs += 1
                equal = torch.equal(fused, pair)
                d34 = (fused - plain).abs()
                mx = float(d34.max())
                print(f"phase 3b K34 vs the K3 -> K4 pair and plain {label} I={ii} sgn "
                      f"{int(sgn[0]):+d} {transfer}: bitwise equal to the pair {equal}; vs plain "
                      f"max {mx:.3e} mean {float(d34.mean()):.3e} (held bitwise), "
                      f"bitwise-equal texels "
                      f"{float((fused == plain).all(dim=0).float().mean()):.6f}", flush=True)
                check(equal and mx == 0.0, f"K34 disagrees at {label} I={ii} sgn "
                      f"{int(sgn[0])} {transfer}")
                worst["K34"] = max(worst["K34"], mx)
        stats = window_stats(geo)
        got = over.tolist()
        print(f"phase 3b K34 windows {label} I={ii} (tile 8x{sr.TILE_COLS}, capacity "
              f"{sr.WINDOW_CAPACITY} texels): mean {stats[0]:.1f} texels over the tile-slab "
              f"pairs composited; over capacity by the rule {stats[1]} tiles, {stats[2]} "
              f"windows; device counter {got} after {runs} launches", flush=True)
        check(got == [runs * stats[1], runs * stats[2]],
              f"K34's over-capacity counter {got} disagrees with the rule {stats[1:]} x {runs}")
        return stats
    for ii in (II, II_HYBRID):
        geo = shear_warp.fast_geometry(packs, bench_u, RES, RES, ii)
        stack = sr.resample_slabs(packs[0], geo.m, geo.pos_u, geo.pos_v, geo.occ_k)
        stack_p = sr.resample_slabs_plain(packs[0], geo.m, geo.pos_u, geo.pos_v, geo.occ_k)
        torch.cuda.synchronize()
        d3 = (stack.float() - stack_p.float()).abs()
        mx, mean = float(d3.max()), float(d3.mean())
        same = float((stack == stack_p).float().mean())
        print(f"phase 3b K3 vs plain bench I={ii} stack {tuple(stack.shape)}: max "
              f"{mx:.3e} mean {mean:.3e} (held bitwise), bitwise-equal {same:.6f}, hot slabs "
              f"{int(geo.occ_k.sum())}/{geo.occ_k.numel()}", flush=True)
        check(mx == 0.0, f"K3 disagrees with plain at I={ii}")
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
        win_stats[("bench", ii)] = fused_checks("bench", geo, ii)
        if ii == II:
            planes = sr.composite(stack, geo.sgn, geo.irho, geo.occ_rb)
            av, bu, ok = shear_warp.warp_coords(geo, ii, ii)
            # this run's data-dependent work, for the bounds of phase 5
            geo_b, stack_b, planes_b, ok_b = geo, stack, planes, ok
            _, k4_count = sr.composite_plain(stack, geo.sgn, geo.irho, geo.occ_rb,
                                             return_count=True)
            _, k4b_count = sr.composite_plain(stack, geo.sgn, geo.irho, geo.occ_rb, "exact",
                                              return_count=True)
        del stack, stack_p
    # K6 at the bench pose's fast geometry (the frames' inputs: K34's planes,
    # warp_coords) for 1024^2, config 4's 1920x1080 (partial 32-pixel tiles)
    # and 1001x563 (width and pixel count not multiples of 4: the kernel's
    # scalar path), each at I=512 and I=1024, with 3 and 4 channels
    for width, height in warp_check.FRAMES:
        for ii in (II, II_HYBRID):
            inp = warp_check.warp_inputs(packs, width, height, ii)
            av, bu, ok = inp["av"], inp["bu"], inp["ok"]
            for n_ch in (3, 4):
                chans = inp["planes"][:n_ch]
                err = warp_check.k6_error(w2.warp_bilinear(chans, av, bu, ok),
                                          w2.warp_plain(chans, av, bu, ok))
                print(f"phase 3b K6 vs plain bench I={ii} {n_ch} channels {width}x{height}: "
                      f"max {err['max']:.3e} (tol {K6_TOL:g}), bitwise-equal "
                      f"{err['bitwise']:.6f}, hit pixels {float(ok.float().mean()):.4f}",
                      flush=True)
                check(err["max"] <= K6_TOL and err["equal"],
                      f"K6 disagrees with plain ({n_ch} channels, {width}x{height}, I={ii})")
                worst["K6"] = max(worst["K6"], err["max"])
            del inp, av, bu, ok
    # the bench pose at the zoom clamp (eye inside the volume, clamped
    # divisor), and an intermediate so coarse that its tiles' windows exceed
    # the shared capacity
    eye_in = Camera(zoom=0.3, pitch=0.5, yaw=1.0, target=(0.5, 0.5, 0.5), aspect=1.0)
    for ii in (II, II_HYBRID):
        geo = shear_warp.fast_geometry(packs, eye_in.uniform(dev), RES, RES, ii)
        win_stats[("eye-inside", ii)] = fused_checks("eye-inside", geo, ii)
    geo = shear_warp.fast_geometry(packs, bench_u, RES, RES, 64)
    win_stats[("bench", 64)] = fused_checks("bench (over capacity)", geo, 64)
    check(win_stats[("bench", 64)][1] > 0, "the over-capacity input has no tile over capacity")

    # -- phase 3c: K5 and K2 (with K1b) against their plain versions -------
    # K5 at phase 3b's frames and intermediates; the bench frame at I=512 and
    # config 4's frame at I=1024 also feed K2's checks
    ny = nx = RES // 32
    k2_inputs = {}
    for width, height in warp_check.FRAMES:
        for ii in (II, II_HYBRID):
            k5_in = warp_check.k5_args(warp_check.warp_inputs(packs, width, height, ii))
            rgb5, st5 = w2.warp_stats(*k5_in)
            rgb5_p, st5_p = w2.warp_stats_plain(*k5_in)
            torch.cuda.synchronize()
            err = warp_check.k5_error(rgb5, st5, rgb5_p, st5_p)
            print(f"phase 3c K5 vs plain bench I={ii} {width}x{height}: rgb max "
                  f"{err['rgb_max']:.3e} (bitwise-equal {err['rgb_bitwise']:.6f}), OVF/EXT/PEAK "
                  f"equal {err['ovf_ext_peak_equal']}, CURV/EDGE max rel "
                  f"{err['curv_edge_rel']:.3e} (tol {warp_check.STATS_RTOL:g}, tiles over "
                  f"{err['tiles_over']}), EXT total {float(st5[:, w2.STAT_EXT].sum()):.0f}",
                  flush=True)
            check(err["ok"], f"K5 disagrees with plain at {width}x{height}, I={ii}")
            worst["K5"] = max(worst["K5"], err["rgb_max"], float((st5 - st5_p).abs().max()))
            if (width, height, ii) in ((RES, RES, II), (orbit_model.WIDTH, orbit_model.HEIGHT,
                                                        II_HYBRID)):
                k2_inputs[(width, height)] = (rgb5, st5)
            del k5_in, rgb5, rgb5_p

    def k2_checks(width, height):
        """K2 (both palettes) and K1b (the polynomial one) against their
        plain versions over the units picked from the frame's K5 scores, four
        parked ids and the last tile row's first and last units, single
        tiles and pairs: bitwise, every other pixel unchanged, and nothing
        written outside the frame (the frame's planes lie between two guard
        bands of the same buffer)."""
        base, stats = k2_inputs[(width, height)]
        uni_f = Camera.bonsai(width / height).uniform(dev)
        ty, tx = cdiv(height, 32), cdiv(width, 32)
        scores = hy.score_tiles(stats, ty, tx)
        n_px, guard, fill = 3 * height * width, 32 * width, -7.0
        for tpu in (1, 2):
            pick = hy.select_units(scores, ty * tx, hy.DEFAULT_BUDGET, hy.DEFAULT_THRESH,
                                   pair=tpu == 2)
            n_units = ty * tx // tpu
            edge = torch.tensor([n_units - tx // tpu, n_units - 1], dtype=torch.int32,
                                device=dev)
            parked = torch.full((4,), n_units, dtype=torch.int32, device=dev)
            ids = torch.cat([pick[:8], parked, pick[8:], edge])
            listed = sorted(set(ids.tolist()) - {n_units})
            mask = hy.unit_pixel_mask(ids, tpu, width, height)
            for fast in (False, True):
                buf = torch.full((n_px + 2 * guard,), fill, dtype=torch.float32, device=dev)
                base_k = buf[guard:guard + n_px].view(3, height, width)
                base_k.copy_(base)
                base_p = base.clone()
                mb.render_bonsai_tiles_into(vol_bonsai, base_k, uni_f, ids, width, height, tpu,
                                            fast)
                mb.render_bonsai_tiles_into_plain(vol_bonsai, base_p, uni_f, ids, width,
                                                  height, tpu, fast)
                torch.cuda.synchronize()
                d2 = float((base_k - base_p).abs().max())
                kept = torch.equal(base_k[:, ~mask], base[:, ~mask])
                guarded = bool((buf[:guard] == fill).all() and (buf[guard + n_px:] == fill).all())
                changed = float((base_k != base).any(dim=0).float().sum())
                line = (f"phase 3c K2 vs plain bench {width}x{height} ({card}) "
                        f"{'pairs' if tpu == 2 else 'tiles'} ({len(listed)} units + "
                        f"{int((ids == n_units).sum())} parked, last tile row's units "
                        f"{edge.tolist()}), {'polynomial' if fast else 'cosine'} palette: max "
                        f"{d2:.3e}, other pixels unchanged {kept}, guard bands unwritten "
                        f"{guarded}, pixels changed {changed:.0f}")
                if fast:
                    comp = mb.render_bonsai_tiles(vol_bonsai, uni_f, ids, width, height, tpu,
                                                  fast)
                    comp_p = mb.render_bonsai_tiles_plain(vol_bonsai, uni_f, ids, width,
                                                          height, tpu, fast)
                    d1b = float((comp - comp_p).abs().max())
                    line += f"; K1b compact max {d1b:.3e}"
                    check(d1b == 0.0, f"K1b disagrees with plain (tpu {tpu}, {width}x{height})")
                print(line, flush=True)
                check(d2 == 0.0 and kept and guarded,
                      f"K2 disagrees with plain (tpu {tpu}, fast {fast}, {width}x{height})")
                worst["K2"] = max(worst["K2"], d2)

    k2_frames = [(RES, RES), (orbit_model.WIDTH, orbit_model.HEIGHT)]
    check(sorted(k2_inputs) == sorted(k2_frames),
          f"K2's checks expected K5's outputs at {k2_frames}, have {sorted(k2_inputs)}")
    for width, height in k2_frames:
        k2_checks(width, height)
    del k2_inputs

    # K2 on the partial last tile row (1080 = 33 x 32 + 24) at a real pose:
    # the first pose of the hybrid's 72-pose grid (tools/cpu_minisweep.py:67-69)
    # at config 4's frame, I=1024, budget 128, whose selection holds a unit
    # there, the pose's own fast frame and selection held against K2's plain
    # version; the degenerate poses (K1's route) select nothing
    kw_, kh_ = orbit_model.WIDTH, orbit_model.HEIGHT
    kty, ktx = cdiv(kh_, 32), cdiv(kw_, 32)
    k_dims = int(vol_bonsai.shape[0])
    k_pair = hy._pair_mode(k_dims, kw_, kh_)
    k_tpu = 2 if k_pair else 1
    k_units = kty * ktx // k_tpu
    t0 = time.perf_counter()
    searched, found = [], None
    for zoom, pitch, i in itertools.product((0.6, 1.0, 1.6), (0.5, -0.35, 1.2), range(8)):
        u = Camera(zoom=zoom, pitch=pitch, yaw=2 * math.pi * i / 8, target=(0.5, 0.5, 0.5),
                   aspect=kw_ / kh_).uniform(dev)
        if shear_warp.pose_hint(u, kw_, kh_, II_HYBRID, k_dims)[2]:
            continue
        rgb_s, stats_s = shear_warp._render_fast(packs, u, kw_, kh_, II_HYBRID, False,
                                                 return_aux="stats")
        ids_s = hy.select_units(hy.score_tiles(stats_s, kty, ktx), kty * ktx,
                                hy.DEFAULT_BUDGET, hy.DEFAULT_THRESH, k_pair)
        last = sorted(x for x in set(ids_s.tolist()) - {k_units} if x * k_tpu // ktx == kty - 1)
        searched.append(f"{zoom}/{pitch}/{i}")
        if last:
            found = (f"{zoom}/{pitch}/{i}", u, rgb_s, ids_s, last)
            break
    search_s = time.perf_counter() - t0
    if found is None:
        print(f"phase 3c K2 partial last tile row at a real pose ({card}): none of the "
              f"{len(searched)} non-degenerate poses of the 72-pose grid at {kw_}x{kh_}, "
              f"I={II_HYBRID}, budget {hy.DEFAULT_BUDGET} selects a unit in the last tile row "
              f"(row {kty - 1}, {kh_ - 32 * (kty - 1)} pixel rows); the forced edge units above "
              f"stand alone ({search_s:.1f} s)", flush=True)
    else:
        name_s, u, rgb_s, ids_s, last = found
        mask = hy.unit_pixel_mask(ids_s, k_tpu, kw_, kh_)
        for fast in (False, True):
            base_k, base_p = rgb_s.clone(), rgb_s.clone()
            mb.render_bonsai_tiles_into(vol_bonsai, base_k, u, ids_s, kw_, kh_, k_tpu, fast)
            mb.render_bonsai_tiles_into_plain(vol_bonsai, base_p, u, ids_s, kw_, kh_, k_tpu,
                                              fast)
            torch.cuda.synchronize()
            d2 = float((base_k - base_p).abs().max())
            kept = torch.equal(base_k[:, ~mask], rgb_s[:, ~mask])
            row_changed = int((base_k != rgb_s)[:, 32 * (kty - 1):].any(dim=0).sum())
            print(f"phase 3c K2 partial last tile row at a real pose ({card}): pose "
                  f"zoom/pitch/yaw-index {name_s} (after {len(searched)} non-degenerate poses "
                  f"of the 72-pose grid, {search_s:.1f} s) at {kw_}x{kh_}, I={II_HYBRID}, "
                  f"budget {hy.DEFAULT_BUDGET}, {'pairs' if k_pair else 'tiles'}: "
                  f"{len(set(ids_s.tolist()) - {k_units})} units selected, in the last tile row "
                  f"(row {kty - 1}, {kh_ - 32 * (kty - 1)} pixel rows) {last}; "
                  f"{'polynomial' if fast else 'cosine'} palette: max {d2:.3e} vs plain, other "
                  f"pixels unchanged {kept}, pixels changed in the last tile row {row_changed}",
                  flush=True)
            check(d2 == 0.0 and kept, f"K2 disagrees with plain at pose {name_s} (fast {fast})")
            worst["K2"] = max(worst["K2"], d2)
        del base_k, base_p, rgb_s, mask

    # -- phase 3d: K7, K9 and K8 against their plain versions --------------
    xor_u = Camera.xor(1.0).uniform(dev)
    k7_cases = {"xor analytic": ("noise", "xor", True, "analytic"),
                "xor fd": ("noise", "xor", True, "fd"),
                "trig": ("trig", "emission", False, "fd"),
                "xor field": ("xor", "xor", True, "fd")}
    for name, (field, shading, quantize, grad) in k7_cases.items():
        for t in (0.0, 1.7):
            for clip in (True, False):
                kw = dict(field=field, shading=shading, quantize=quantize, sphere_clip=clip,
                          grad=grad)
                before = mf.LAUNCHES_FIELD
                img_k = mf.render_field(xor_u, t, FIELD_RES, FIELD_RES, **kw)
                torch.cuda.synchronize()
                check(mf.LAUNCHES_FIELD == before + 1, f"K7 {name}: LAUNCHES_FIELD did not advance")
                img_p = mf.render_field_plain(xor_u, t, FIELD_RES, FIELD_RES, **kw)
                d7 = (img_k - img_p).abs()
                mx, mean = float(d7.max()), float(d7.mean())
                same = float((img_k == img_p).all(dim=-1).float().mean())
                finite = bool(torch.isfinite(img_k).all())
                print(f"phase 3d K7 vs plain {name} t={t} clip {'on' if clip else 'off'} "
                      f"{FIELD_RES}x{FIELD_RES}: max {mx:.3e} mean {mean:.3e} (tol {K7_MAX:g} / "
                      f"{K7_MEAN:g}), bitwise-equal pixels {same:.6f}, finite {finite}",
                      flush=True)
                check(finite and mx <= K7_MAX and mean <= K7_MEAN,
                      f"K7 {name} t={t} clip {clip} disagrees with plain")
                worst["K7"] = max(worst["K7"], mx)
    del img_k, img_p, d7
    # a lattice argument outside the hash table traps K7 and K8; the context
    # is lost then, so each check runs in a process of its own
    for kernel in ("K7", "K8"):
        trap = subprocess.run([sys.executable, "-c", TRAP_CHECK, ROOT, kernel],
                              capture_output=True, text=True, timeout=300)
        said = (trap.stdout.strip().splitlines() or ["(no output)"])[-1]
        print(f"phase 3d {kernel} with octave 0's table cut to 301 entries: exit "
              f"{trap.returncode}, {said}", flush=True)
        check(trap.returncode == 3, f"{kernel} read outside its hash table without an error:\n"
              f"{trap.stdout}{trap.stderr}")
    for t in (0.0, 1.25):
        dens, nrm = genvol.generate_xor_volumes(t, 256, dev)
        dens_p, nrm_p = genvol.generate_xor_volumes_plain(t, 256, dev)
        torch.cuda.synchronize()
        dd, dn = (dens - dens_p).abs(), (nrm - nrm_p).abs()
        over = float((dn > 1e-2).float().mean())
        equal = torch.equal(dens, dens_p) and torch.equal(nrm, nrm_p)
        print(f"phase 3d K9 vs plain t={t} 256^3: equal {equal}, density max "
              f"{float(dd.max()):.3e} mean {float(dd.mean()):.3e} (test_pallas.py:80-90's "
              f"tol 2e-3 / 1e-5), normals over 1e-2 {over:.2e} (tol 0.01), bitwise-equal "
              f"density {float((dens == dens_p).float().mean()):.6f} normals "
              f"{float((nrm == nrm_p).float().mean()):.6f}", flush=True)
        check(equal, f"K9 disagrees with plain at t={t}")
        worst["K9"] = max(worst["K9"], float(dd.max()), float(dn.max()))
        del dens, nrm, dens_p, nrm_p, dd, dn
    # sin t = 0, 0.95, 1, -1; 100 is a multiple of neither brick
    for t in (0.0, 1.25, math.pi / 2, -math.pi / 2):
        for dims in (VOL5, 100):
            vol_k = genvol.generate_density_u8(t, dims, dev)
            vol_p = genvol.generate_density_u8_plain(t, dims, dev)
            diff = int((vol_k.int() - vol_p.int()).abs().max())
            print(f"phase 3d K8 vs plain t={t:.6f} {dims}^3: equal {torch.equal(vol_k, vol_p)}, "
                  f"max level difference {diff}, bitwise-equal voxels "
                  f"{float((vol_k == vol_p).float().mean()):.6f}, mean level "
                  f"{float(vol_k.float().mean()):.3f}", flush=True)
            check(torch.equal(vol_k, vol_p), f"K8 disagrees with plain at t={t}, {dims}^3")
            worst["K8"] = max(worst["K8"], float(diff))
            del vol_k, vol_p

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
    wrapper_check("the exact main path", exact_launches, "K1")
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
          f"in {run_s:.2f} s, K1 wrapper's launches {exact_launches['K1']} (the graph's "
          f"warm-up and capture; the replays call none), lit pixels {lit:.4f}, "
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
    wrapper_check("the fast main path", fast_launches, "K34", "K6")
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
          f"frames {RES}x{RES} I={II} in {frun_s:.2f} s, wrappers' launches {fast_launches}, lit "
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
    for ii, fast_ii in ((256, shear_warp.FastBonsaiRenderer(vol_bonsai, dev, intermediate=256)),
                        (II, fast_r)):
        for name, cam in poses.items():
            u = cam.uniform(dev)
            err = (fast_ii(u, RES, RES) - exact_r(u, RES, RES)).abs()
            mean = float(err.mean())
            p99 = float(torch.quantile(err.reshape(-1), 0.99))
            want_mean, want_p99 = FAST_ERR[ii][name]
            print(f"phase 4c fast I={ii} vs exact K1 {name} {RES}x{RES}: mean {mean:.5f} "
                  f"(table {want_mean:.5f}, limit {FAST_ERR_SLACK * want_mean:.5f}), p99 "
                  f"{p99:.4f} (table {want_p99:.4f}), max {float(err.max()):.3f}", flush=True)
            if mean > FAST_ERR_SLACK * want_mean:
                misses.append(f"I={ii} {name}")
    check(not misses, f"fast frame beyond 1.25x the table's mean error at {misses}")

    # -- phase 4d: the hybrid main path -----------------------------------
    class HybridDemo(BonsaiDemo):
        @classmethod
        def init(cls, ctx):
            return BonsaiDemo.init(ctx, renderer="hybrid")

    hctx = Context(RES, RES, camera=BonsaiDemo.default_camera(1.0),
                   backbuffer_resolution=(RES, RES), device="cuda")
    hyb_r = hy.HybridBonsaiRenderer(vol_bonsai, dev)  # the demo's: I=512, budget 128
    bench_route = hyb_r.route(bench_u, RES, RES)
    check(bench_route == ("hybrid", II, hy.DEFAULT_BUDGET),
          f"the bench pose routes to {bench_route}")
    reset_launches()
    t0 = time.perf_counter()
    hctx = run(HybridDemo, frames=MAIN_FRAMES, context=hctx, quiet=True)
    torch.cuda.synchronize()
    hrun_s = time.perf_counter() - t0
    hyb_launches = launches()
    wrapper_check("the hybrid main path", hyb_launches, "K34", "K5", "K2")
    img = hctx.display_image
    check(bool(torch.isfinite(img).all()), "hybrid display image has non-finite pixels")
    hlit = float((img[..., :3].amax(dim=-1) > 1.0 / 255.0).float().mean())
    check(hlit > 0.01, f"hybrid display image is background ({hlit:.4%} lit pixels)")
    u_last = hctx.camera_uniform
    mode, ii_last, b_last = hyb_r.route(u_last, RES, RES)
    print(f"phase 4d hybrid main path: run(BonsaiDemo, renderer=\"hybrid\") {MAIN_FRAMES} "
          f"frames {RES}x{RES} in {hrun_s:.2f} s, wrappers' launches {hyb_launches}, route at "
          f"the "
          f"bench pose {bench_route}, lit pixels {hlit:.4f}", flush=True)
    pair = hy._pair_mode(hyb_r.dims, RES, RES)
    img_k, ids_k = hy._render_hybrid(hyb_r.packs, hyb_r.vol, u_last, hyb_r.thresh, RES,
                                     RES, ii_last, b_last, True, pair=pair)
    img_p, ids_p = hy._render_hybrid(hyb_r.packs, hyb_r.vol, u_last, hyb_r.thresh, RES,
                                     RES, ii_last, b_last, True, pair=pair, plain=True)
    tpu = 2 if pair else 1
    sentinel = ny * nx // tpu
    sel_k, sel_p = set(ids_k.tolist()) - {sentinel}, set(ids_p.tolist()) - {sentinel}
    both = hy.unit_pixel_mask(torch.tensor(sorted(sel_k & sel_p), dtype=torch.int32,
                                           device=dev), tpu, RES, RES)
    dh = (img_k - img_p)[..., :3].abs()
    both_max = float(dh[both].max()) if bool(both.any()) else 0.0
    same_as_demo = torch.equal(hctx.render_backbuffer.texture, img_k)
    print(f"phase 4d last frame vs plain hybrid path: {len(sel_k)} units selected "
          f"({'pairs' if pair else 'tiles'}), ids that differ {len(sel_k ^ sel_p)} "
          f"(kernel-only {len(sel_k - sel_p)}), max on tiles both selected {both_max:.3e}, "
          f"whole-frame max {float(dh.max()):.3e} mean {float(dh.mean()):.3e}; demo frame "
          f"equals the kernel path {same_as_demo}", flush=True)
    check(both_max == 0.0 and same_as_demo, "hybrid frame disagrees with the plain path")
    del img_k, img_p

    # -- phase 4e: the hybrid's contract at I=1024, budget 64 ---------------
    hyb_op = hy.HybridBonsaiRenderer(vol_bonsai, dev, intermediate=II_HYBRID, budget=BUDGET_OP)
    dhy = (hyb_op(bench_u, RES, RES) - exact_r(bench_u, RES, RES))[..., :3].abs()
    print(f"phase 4e hybrid I={II_HYBRID} budget {BUDGET_OP} vs exact K1 bench {RES}x{RES}: "
          f"route {hyb_op.route(bench_u, RES, RES)}, mean {float(dhy.mean()):.4e} (contract "
          f"{HYBRID_CONTRACT:g}), max {float(dhy.max()):.4f}", flush=True)
    check(float(dhy.mean()) <= HYBRID_CONTRACT, "hybrid beyond its contract at the bench pose")
    del hyb_op
    t0 = time.perf_counter()
    sweep_recs, sweep = hybrid_sweep.sweep(dev, RES, II_HYBRID, BUDGET_OP, vol=vol_bonsai,
                                           log=lambda s: print(f"phase 4e {s}"))
    print(f"phase 4e sweep ({sweep['poses']} poses, {RES}^2, I={II_HYBRID}, budget "
          f"{BUDGET_OP}): worst {sweep['worst']:.4e} (an earlier H100 run: 9.0676e-4), "
          f"mean-of-means "
          f"{sweep['mean_of_means']:.4e}, over {HYBRID_CONTRACT:g}: {sweep['over']}, routes "
          f"{sweep['routes']}, {time.perf_counter() - t0:.1f} s", flush=True)
    check(sweep["over"] == 0, f"{sweep['over']} sweep poses beyond the hybrid's contract: "
          f"{[r['pose'] for r in sweep_recs if r['mean'] > HYBRID_CONTRACT]}")
    # the steep class (zoom 1, pitch 1.2), whose error floor the sweep sets:
    # per yaw the mean against K1 and the tiles scoring above the threshold
    # beside the units the budget selects (a pair unit is two tiles)
    steep = [cam for key, cam in hybrid_sweep.poses() if key.startswith("1.0/1.2/")]
    steep_u = [cam.uniform(dev) for cam in steep]
    steep_exact = [exact_r(u, RES, RES) for u in steep_u]
    ny_s = nx_s = cdiv(RES, 32)
    for budget in STEEP_BUDGETS:
        hyb_s = hy.HybridBonsaiRenderer(vol_bonsai, dev, intermediate=II_HYBRID, budget=budget)
        pair = hy._pair_mode(hyb_s.dims, RES, RES)
        means, above, units = [], [], []
        for u, ex in zip(steep_u, steep_exact):
            mode, ii_s, b_s = hyb_s.route(u, RES, RES)
            means.append(float((hyb_s(u, RES, RES) - ex)[..., :3].abs().mean()))
            if mode in ("hybrid", "escalated"):
                _, st = shear_warp._render_fast(hyb_s.packs, u, RES, RES, ii_s, False,
                                                return_aux="stats")
                scores = hy.score_tiles(st, ny_s, nx_s)
                ids = hy.select_units(scores, ny_s * nx_s, b_s, hyb_s.thresh, pair)
                above.append(int((scores > hyb_s.thresh).sum()))
                units.append(int((ids < ny_s * nx_s // (2 if pair else 1)).sum()))
            else:
                above.append(None)
                units.append(None)
        print(f"phase 4e steep z1.0 pitch 1.2, 8 yaws, {RES}^2, I={II_HYBRID}, budget {budget} "
              f"({'pairs' if pair else 'tiles'}; {card}): mean vs exact K1 "
              f"[{', '.join(f'{m:.4e}' for m in means)}], worst {max(means):.4e}; tiles above "
              f"{hy.DEFAULT_THRESH:g} {above} vs units selected {units}", flush=True)
        check(all(math.isfinite(m) for m in means), "a steep frame's error is not finite")
        del hyb_s
    del steep_exact

    # -- phase 4l: config 4, the 1080p orbit (models/orbit.py) --------------
    # exact and hybrid (I=1024, budget 2 x 64) at every pose of bench.py's
    # orbit; a pose the shear-warp factorization breaks at renders with K1
    ow, oh, n_orbit = orbit_model.WIDTH, orbit_model.HEIGHT, orbit_model.N_POSES
    t_phase = time.perf_counter()
    orb = orbit_model.BonsaiOrbit(vol_bonsai, dev)
    reset_launches()
    t0 = time.perf_counter()
    orbit_frames = orb()
    torch.cuda.synchronize()
    orbit_s = time.perf_counter() - t0
    orbit_launches = launches()
    orbit_routes = orbit_frames.routes
    hyb_idx = [i for i, r in enumerate(orbit_routes) if r[0] == "hybrid"]
    n_hyb = len(hyb_idx)
    check(n_hyb > 0, f"no orbit pose renders hybrid: {orbit_routes}")
    wrapper_check(f"config 4 ({n_hyb} hybrid poses of {n_orbit})", orbit_launches, "K1", "K34",
                  "K5", "K2")
    for frame in orbit_frames.exact + orbit_frames.hybrid:
        check(tuple(frame.shape) == (oh, ow, 4) and bool(torch.isfinite(frame).all()),
              "a config-4 frame is not finite or has the wrong shape")
    orbit_errs = orbit_frames.errors.tolist()
    orbit_lit = min(float((f[..., :3].amax(dim=-1) > 1.0 / 255.0).float().mean())
                    for f in orbit_frames.exact)
    check(orbit_lit > 0.01, f"a config-4 exact frame shows nothing ({orbit_lit:.4f} lit)")
    for i, (route, err) in enumerate(zip(orbit_routes, orbit_errs)):
        dmax = float((orbit_frames.hybrid[i] - orbit_frames.exact[i])[..., :3].abs().max())
        print(f"phase 4l config 4 pose {i}/{n_orbit} {ow}x{oh} ({card}): route {route}, hybrid "
              f"vs exact K1 mean {err:.4e} (contract {HYBRID_CONTRACT:g}) max {dmax:.4f}",
              flush=True)
    worst_pose = max(range(n_orbit), key=lambda i: orbit_errs[i])
    worst_hyb = max(hyb_idx, key=lambda i: orbit_errs[i])
    # K1 at config 4's frame against its plain version: pose 0's exact frame
    # and the first degenerate pose's, which is also that pose's hybrid frame
    for i in [0] + orbit_frames.degenerate[:1]:
        eye, dxyz = geometry.rays_fragment_soa(orb.poses[i], ow, oh)
        img_p = reference.render_bonsai_rays(orb.exact.vol, eye, torch.stack(dxyz, dim=-1))
        img_k = orbit_frames.exact[i]
        same = torch.equal(img_k, img_p)
        mx, mean = rgb_err(img_k, img_p)
        print(f"phase 4l K1 vs plain config 4 pose {i} (route {orbit_routes[i][0]}) {ow}x{oh} "
              f"({card}): bitwise equal {same}, max {mx:.3e} mean {mean:.3e}; the pose's "
              f"hybrid frame is this frame {orbit_frames.hybrid[i] is img_k}", flush=True)
        check(same, f"K1 disagrees with its plain version at config 4's pose {i}")
        worst["K1"] = max(worst["K1"], mx)
    del img_p, img_k, eye, dxyz
    # the poses that route to K1, forced through the hybrid frame anyway
    # (HybridBonsaiRenderer.functional: no routing); outside the contract,
    # printed, not held
    frender, fpack = orb.hybrid.functional()
    forced = {}
    for i in orbit_frames.degenerate:
        img_f, deg = frender(fpack, orb.poses[i], ow, oh)
        forced[i] = (float((img_f - orbit_frames.exact[i])[..., :3].abs().mean()), bool(deg))
    # every hybrid pose's units in the partial last tile row, and the worst
    # hybrid pose's frame against the plain hybrid path, as phase 4d
    pair4 = hy._pair_mode(orb.hybrid.dims, ow, oh)
    tpu4 = 2 if pair4 else 1
    ty4, tx4 = cdiv(oh, 32), cdiv(ow, 32)
    sentinel4 = ty4 * tx4 // tpu4

    def hybrid_path(i, plain=False):
        return hy._render_hybrid(orb.hybrid.packs, orb.hybrid.vol, orb.poses[i],
                                 orb.hybrid.thresh, ow, oh, orbit_model.INTERMEDIATE,
                                 orbit_model.BUDGET, True, pair=pair4, plain=plain)

    last_row = {}
    for i in hyb_idx:
        img_i, ids_i = hybrid_path(i)
        sel = set(ids_i.tolist()) - {sentinel4}
        last_row[i] = sum(u * tpu4 // tx4 == ty4 - 1 for u in sel)
        if i == worst_hyb:
            img_k, sel_k = img_i, sel
    del img_i
    img_p, ids_p = hybrid_path(worst_hyb, plain=True)
    sel_p = set(ids_p.tolist()) - {sentinel4}
    both = hy.unit_pixel_mask(torch.tensor(sorted(sel_k & sel_p), dtype=torch.int32,
                                           device=dev), tpu4, ow, oh)
    dh = (img_k - img_p)[..., :3].abs()
    both_max = float(dh[both].max()) if bool(both.any()) else 0.0
    same_as_entry = torch.equal(orbit_frames.hybrid[worst_hyb], img_k)
    print(f"phase 4l config 4 ({card}; BonsaiOrbit, {n_orbit} poses {ow}x{oh}, I="
          f"{orbit_model.INTERMEDIATE}, budget {orbit_model.BUDGET}, "
          f"{'pairs' if pair4 else 'tiles'}): {n_hyb} poses hybrid, degenerate "
          f"{orbit_frames.degenerate} (K1), exact + hybrid in {orbit_s:.2f} s, launches "
          f"{orbit_launches}; worst pose {worst_pose} mean {orbit_errs[worst_pose]:.4e}, worst "
          f"hybrid-routed pose {worst_hyb} mean {orbit_errs[worst_hyb]:.4e} (contract "
          f"{HYBRID_CONTRACT:g}); bench.py's gate (no degenerate pose) "
          f"{orbit_frames.bench_gate}; degenerate poses forced through the hybrid frame, "
          f"mean vs exact (degraded flag): "
          + ", ".join(f"{i}: {e:.4e} ({d})" for i, (e, d) in forced.items())
          + f"; units in the last tile row (of {ty4}) per hybrid pose {last_row}; pose "
          f"{worst_hyb} vs the plain hybrid path: {len(sel_k)} units selected, ids that differ "
          f"{len(sel_k ^ sel_p)}, max on units both selected {both_max:.3e}, whole-frame max "
          f"{float(dh.max()):.3e}, entry point's frame equals the kernel path {same_as_entry}; "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    check(max(orbit_errs) <= HYBRID_CONTRACT,
          f"config-4 poses beyond the hybrid's contract: {orbit_errs}")
    check(both_max == 0.0 and same_as_entry,
          "the 1080p hybrid frame disagrees with the plain hybrid path")
    del orbit_frames, img_k, img_p, dh, both

    # -- phase 4f: the xor main path, the field oracles, the trig demo ------
    clear = torch.tensor([0.023, 0.02, 0.02], device=dev)
    xor_runs = {}
    for w, h in (XOR_RES, (FIELD_RES, FIELD_RES)):
        xctx = Context(w, h, camera=XorDemo.default_camera(w / h), backbuffer_resolution=(w, h),
                       device="cuda")
        reset_launches()
        t0 = time.perf_counter()
        xctx = run(XorDemo, frames=MAIN_FRAMES, events=orbit_events(MAIN_FRAMES, w, h),
                   context=xctx, quiet=True)
        torch.cuda.synchronize()
        xrun_s = time.perf_counter() - t0
        xl = launches()
        wrapper_check(f"the xor main path {w}x{h}", xl, "K7")
        hdr = xctx.render_backbuffer.texture
        check(tuple(hdr.shape) == (h, w, 4) and bool(torch.isfinite(xctx.display_image).all()),
              "xor frame is not finite or has the wrong shape")
        lit = float(((hdr[..., :3] - clear).abs().amax(dim=-1) > 1e-3).float().mean())
        check(lit > 0.01, f"xor frame shows no field ({lit:.4%} lit pixels)")
        hdr_p, xsteps = mf.render_field_plain(xctx.camera_uniform, 0.0, w, h,
                                              return_steps=True)
        d7 = (hdr - hdr_p).abs()
        same = float((hdr == hdr_p).all(dim=-1).float().mean())
        print(f"phase 4f xor main path: run(XorDemo) {MAIN_FRAMES} frames {w}x{h} (grad "
              f"{mf.default_grad()}) in {xrun_s:.2f} s, wrappers' launches {xl}, lit pixels "
              f"{lit:.4f}, "
              f"final frame vs plain max {float(d7.max()):.3e} mean {float(d7.mean()):.3e}, "
              f"bitwise-equal pixels {same:.6f}", flush=True)
        check(float(d7.max()) <= K7_MAX and float(d7.mean()) <= K7_MEAN,
              "xor frame disagrees with the plain version")
        worst["K7"] = max(worst["K7"], float(d7.max()))
        xor_runs[(w, h)] = (xctx, xl, lane_efficiency(xsteps, torch))
    oracle = reference.render_compute_inline(xor_u, 0.0, width=FIELD_RES, height=FIELD_RES)
    for grad, tol in (("fd", MEAN_TOL), ("analytic", HYBRID_CONTRACT)):
        img7 = mf.render_field(xor_u, 0.0, FIELD_RES, FIELD_RES, grad=grad)
        mx, mean = rgb_err(img7, oracle)
        print(f"phase 4f K7 {grad} vs the port's render_compute_inline Camera.xor(1.0) "
              f"{FIELD_RES}x{FIELD_RES}: mean {mean:.4e} (limit {tol:g}), max {mx:.3e}",
              flush=True)
        check(mean <= tol, f"K7 {grad} beyond {tol:g} of the oracle")
    img7 = mf.render_field(xor_u, 0.0, FIELD_RES, FIELD_RES, field="trig", shading="emission",
                           quantize=False)
    mx, mean = rgb_err(img7, reference.render_field(xor_u, 0.0, width=FIELD_RES,
                                                    height=FIELD_RES))
    print(f"phase 4f K7 trig vs render_field {FIELD_RES}x{FIELD_RES}: max {mx:.3e} mean "
          f"{mean:.3e} (tol 1e-4 / 1e-6, test_pallas.py:76-77)", flush=True)
    check(mx <= 1e-4 and mean <= 1e-6, "K7 trig disagrees with render_field")
    # the texture path: K9's volumes through render_compute_tex
    reset_launches()
    dens, nrm = genvol.generate_xor_volumes(0.0, 256, dev)
    tex = reference.render_compute_tex(dens, nrm, xor_u, width=FIELD_RES, height=FIELD_RES)
    torch.cuda.synchronize()
    tex_launches = launches()
    check(tex_launches == only(K9=1), f"texture path launched {tex_launches}, not K9 once")
    dt_ = (tex - oracle).abs()
    near = float((dt_ < 1e-5).float().mean())
    print(f"phase 4f texture path: K9 256^3 + render_compute_tex {FIELD_RES}x{FIELD_RES} vs "
          f"render_compute_inline: max {float(dt_.max()):.3e} mean {float(dt_.mean()):.3e}, "
          f"within 1e-5 {near:.4f} (tol 5e-3 / 5e-6 / 0.97, test_render_oracle.py:70-84)",
          flush=True)
    check(float(dt_.max()) < 5e-3 and float(dt_.mean()) < 5e-6 and near > 0.97,
          "the texture path disagrees with the inline oracle")
    del dens, nrm, tex, oracle, dt_
    tctx = Context(*XOR_RES, device="cuda")
    reset_launches()
    tctx = run(TrigDemo, frames=MAIN_FRAMES, events=orbit_events(MAIN_FRAMES, *XOR_RES),
               context=tctx, quiet=True)
    torch.cuda.synchronize()
    tl = launches()
    tri = float((tctx.render_backbuffer.texture[..., 2] == 1.0).float().mean())
    print(f"phase 4f trig demo: run(TrigDemo) {MAIN_FRAMES} frames {XOR_RES[0]}x{XOR_RES[1]}, "
          f"launches {tl}, triangle pixels {tri:.4f}", flush=True)
    check(tl == only() and 0.0 < tri < 1.0 and bool(torch.isfinite(tctx.display_image).all()),
          "the trig demo launched a kernel or drew no triangle")

    # -- phase 4g: config 5 at reduced depth (models/views.py) ---------------
    # the orbit of VIEWS_SMOKE views is every (VIEWS // VIEWS_SMOKE)-th view of
    # config 5's orbit of VIEWS
    batch8 = ViewsBatch(n_views=VIEWS_SMOKE, view_res=VIEW_RES, dims=VOL5, device=dev)
    max_steps5 = batch8.max_steps  # 888: the full diagonal
    reset_launches()
    t0 = time.perf_counter()
    for b in range(2):
        vol5, imgs5 = batch8(b)
    torch.cuda.synchronize()
    c5_s = time.perf_counter() - t0
    c5_launches = launches()
    wrapper_check("config 5 (2 batches)", c5_launches, "K8", "K1")
    c5_lit = min(float((im[..., :3].amax(dim=-1) > 1.0 / 255.0).float().mean()) for im in imgs5)
    check(bool(torch.isfinite(imgs5).all()) and c5_lit > 0.01,
          f"a config-5 view is not finite or shows nothing (least lit {c5_lit:.4f})")
    eye, dxyz = geometry.rays_fragment_soa(batch8.cams[1], VIEW_RES, VIEW_RES)
    img5_p = reference.render_bonsai_rays(vol5, eye, torch.stack(dxyz, dim=-1),
                                          max_steps=max_steps5)
    mx, mean = rgb_err(imgs5[1], img5_p)
    print(f"phase 4g config 5 ({card}; ViewsBatch, 2 batches: K8 {VOL5}^3 at t = 0.3 b, "
          f"{VIEWS_SMOKE} of {VIEWS} orbit views {VIEW_RES}^2 through one K1 launch, "
          f"{max_steps5} steps) "
          f"in {c5_s:.2f} s, launches {c5_launches}, least lit view {c5_lit:.4f}; view 1 vs K1 "
          f"plain max {mx:.3e} mean {mean:.3e} (tol {MAX_TOL:g} / {MEAN_TOL:g}), bitwise-equal "
          f"pixels {float((imgs5[1] == img5_p).all(dim=-1).float().mean()):.6f}", flush=True)
    check(mx < MAX_TOL and mean < MEAN_TOL, "config-5 view disagrees with K1's plain version")
    del imgs5, img5_p, batch8

    # -- phase 4m: one full config-5 batch (K8 512^3 + 64 views 512^2) --------
    batch64 = ViewsBatch(n_views=VIEWS, view_res=VIEW_RES, dims=VOL5, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    vol5f, imgs5 = batch64(0)
    torch.cuda.synchronize()
    c5f_s = time.perf_counter() - t0
    c5f_launches = launches()
    wrapper_check("the full config-5 batch", c5f_launches, "K8", "K1")
    check(tuple(imgs5.shape) == (VIEWS, VIEW_RES, VIEW_RES, 4), f"views {tuple(imgs5.shape)}")
    c5f_lit = min(float((im[..., :3].amax(dim=-1) > 1.0 / 255.0).float().mean()) for im in imgs5)
    check(bool(torch.isfinite(imgs5).all()) and c5f_lit > 0.01,
          f"a full-batch view is not finite or shows nothing (least lit {c5f_lit:.4f})")
    check(torch.equal(vol5f, genvol.generate_density_u8_plain(0.0, VOL5, dev)),
          "the full batch's volume differs from K8's plain version")
    # every view against a single-view K1 launch on its own uniform
    singles5 = 0
    for v in range(VIEWS):
        eye, dxyz = geometry.rays_fragment_soa(batch64.cams[v], VIEW_RES, VIEW_RES)
        singles5 += bool(torch.equal(imgs5[v], mb.render_bonsai_rays_cuda(
            vol5f, eye, dxyz, max_steps=max_steps5)))
    img5_p = reference.render_bonsai_rays(vol5f, eye, torch.stack(dxyz, dim=-1),
                                          max_steps=max_steps5)
    equal5 = torch.equal(imgs5[VIEWS - 1], img5_p)
    print(f"phase 4m config 5 full batch ({card}; ViewsBatch(): K8 {VOL5}^3 at t = 0, {VIEWS} "
          f"orbit views {VIEW_RES}^2 through one K1 launch, {max_steps5} steps) in {c5f_s:.2f} s "
          f"(first call), launches {c5f_launches}, least lit view {c5f_lit:.4f}; volume equal "
          f"to K8's plain version; views bitwise equal to single-view K1 launches "
          f"{singles5}/{VIEWS}; view {VIEWS - 1} bitwise equal to K1's plain version {equal5}",
          flush=True)
    check(singles5 == VIEWS and equal5,
          "a full-batch view disagrees with its single-view K1 launch or K1's plain version")
    del vol5f, imgs5, img5_p

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
    k1_dev = device_ms(lambda: mb.render_bonsai_rays_cuda(vol_bonsai, eye, dxyz), torch)
    occ_ms = (device_ms(lambda: mb.occupancy_table(vol_bonsai), torch),
              median_ms(lambda: mb.occupancy_table(vol_bonsai), 5 * TIMED_FRAMES, torch))
    _, steps = reference.render_bonsai_rays(vol_bonsai, eye, dirs, return_steps=True)
    k1_steps, k1_skipped = skip_counts(vol_bonsai, eye, dirs, steps, torch)
    k1_skip = k1_skipped / k1_steps
    rays_ms = median_ms(lambda: geometry.rays_fragment_soa(uni, RES, RES),
                        5 * TIMED_FRAMES, torch)
    hdr = mb.render_bonsai_rays_cuda(vol_bonsai, eye, dxyz)
    present_ms = median_ms(lambda: present(hdr), 5 * TIMED_FRAMES, torch)
    demo = BonsaiDemo.init(ctx)

    def frame():
        ctx.update()
        demo.render(ctx)
        ctx.render()

    def eager_frame(c, render):
        """A demo frame as the port ran it before its frames were compiled:
        Context.update, the eager render function of the context's uniform
        into the backbuffer, the eager present."""
        def fn():
            c.update()
            c.render_backbuffer.store(render(c.camera_uniform))
            c.display_image = present(c.render_backbuffer.texture, out_height=c.height,
                                      out_width=c.width)
        return fn

    # each frame's eager call and its replay, in the same interleaved rounds
    frames_ms = {}

    def eager_and_replay(name, eager, replay, rounds):
        frames_ms[name] = interleaved_ms({"eager": eager, "replay": replay}, rounds, torch,
                                         warmup=WARMUP)
        return frames_ms[name]["replay"]

    frame_ms = eager_and_replay("exact", eager_frame(
        ctx, lambda u: mb.render_frame(demo.renderer.vol, u, RES, RES)), frame, 5 * TIMED_FRAMES)
    mrays = RES * RES / 1e6
    print(f"phase 5 timing ({card}; median of {5 * TIMED_FRAMES} / {TIMED_FRAMES} "
          f"frames after {WARMUP} warm-up, CUDA events, bench pose, 256^3 "
          f"{RES}x{RES}):", flush=True)
    print(f"phase 5 K1 kernel: device {k1_dev:.4f} ms ({mrays / k1_dev * 1e3:.1f} Mrays/s; "
          f"CUDA graph of {GRAPH_LAUNCHES} launches); one wrapper call {k_ms:.4f} ms, again "
          f"after the plain runs {k2_ms:.4f} ms; marched steps skipped "
          f"{k1_skip:.4f}; occupancy table (256^3 -> 32^3) device {occ_ms[0]:.4f} ms, one call "
          f"{occ_ms[1]:.4f} ms")
    print(f"phase 5 K1 plain torch: {p_ms:.4f} ms/frame "
          f"({mrays / p_ms * 1e3:.2f} Mrays/s)")
    update_ms = median_ms(ctx.update, 5 * TIMED_FRAMES, torch)
    frames_ms["Context.update"] = {"eager": update_ms}
    print(f"phase 5 other stages: rays_fragment_soa {rays_ms:.4f} ms, "
          f"present {present_ms:.4f} ms, Context.update {update_ms:.4f} ms")
    print(f"phase 5 whole frame (Context.update + BonsaiDemo.render + present, replayed): "
          f"{frame_ms:.4f} ms/frame ({mrays / frame_ms * 1e3:.1f} Mrays/s); eager "
          f"{frames_ms['exact']['eager']:.4f} ms in the same rounds", flush=True)

    # the dense-stress frame (phase 3's): K1 alone, the entry point's frame
    # (rays + K1), the share of K1's steps skipped and its bound
    n_dense = 5 * TIMED_FRAMES
    dense_dev = device_ms(lambda: mb.render_bonsai_rays_cuda(dense_r.vol, eye, dxyz), torch)
    dense_ms = median_ms(lambda: dense_r(uni, RES, RES), n_dense, torch)
    _, dense_px = reference.render_bonsai_rays(dense_r.vol, eye, dirs, return_steps=True)
    dense_steps, dense_skipped = skip_counts(dense_r.vol, eye, dirs, dense_px, torch)
    dense_bound = bound_ms(dense_r.vol.numel() + 3 * RES * RES * 4 + 12 + RES * RES * 16,
                           (dense_steps - dense_skipped) * OPS_K1_STEP
                           + dense_skipped * OPS_SKIP_STEP)
    print(f"phase 5 dense frame ({card}; dense_stress 256^3, bench pose, {RES}x{RES}): K1 "
          f"device {dense_dev:.4f} ms (the bonsai's {k1_dev:.4f}), one frame (BonsaiRenderer: "
          f"rays + K1, median of {n_dense}) {dense_ms:.4f} ms; marched steps skipped "
          f"{dense_skipped / dense_steps:.4f} of {dense_steps} ({dense_steps / (RES * RES):.1f} "
          f"per ray; the bonsai's {k1_skip:.4f}); bound {dense_bound[0]:.4f} ms "
          f"({dense_bound[1]}), {dense_dev / dense_bound[0]:.1f}x its bound", flush=True)

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
    k4bp_ms = median_ms(lambda: sr.composite_plain(stack_b, geo.sgn, geo.irho, geo.occ_rb,
                                                   "exact"), TIMED_FRAMES, torch)
    k6p_ms = median_ms(lambda: w2.warp_plain(chans, av, bu, ok), n, torch)
    # the intermediate's texels that the hit pixels' taps touch (K6's bound)
    k6_texels = warp_check.tapped_texels(av, bu, ok, II, II)
    # yardsticks the port never calls: grid_sample (bilinear,
    # align_corners=True) over the same float32 slabs / channels at the same
    # coordinates; zeros padding for K3 (its taps outside the volume are 0),
    # border for K6 (its lookup clamps to the edge, as K5's yardstick does)
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
    lib6_ms = median_ms(lambda: gs(chans[None], grid6, mode="bilinear", padding_mode="border",
                                   align_corners=True), n, torch)
    dev_ms = {
        "K3": device_ms(lambda: sr.resample_slabs(packs[0], geo.m, geo.pos_u, geo.pos_v,
                                                  geo.occ_k), torch),
        "K4": device_ms(lambda: sr.composite(stack_b, geo.sgn, geo.irho, geo.occ_rb), torch),
        "K4b": device_ms(lambda: sr.composite(stack_b, geo.sgn, geo.irho, geo.occ_rb,
                                              "exact"), torch),
        "grid_sample K3": device_ms(lambda: gs(slabs, grid3, mode="bilinear",
                                               padding_mode="zeros", align_corners=True), torch),
    }
    # K6 against grid_sample: each replay's device time, both from this call
    k6_spread = device_ms(lambda: w2.warp_bilinear(chans, av, bu, ok), torch, spread=True)
    gs6_spread = device_ms(lambda: gs(chans[None], grid6, mode="bilinear",
                                      padding_mode="border", align_corners=True), torch,
                           spread=True)
    dev_ms["K6"], dev_ms["grid_sample K6"] = k6_spread[1], gs6_spread[1]
    del slabs, grid3

    # K34, the frames' slab stage, beside the K3 + K4 pair on the same inputs
    # (bench pose, I=512 and I=1024, both transfers); its bound from this
    # run's work: the pack texels its composited samples tap, those slabs'
    # positions, irho, the gates, the planes written; resampled samples x
    # K3's operations + shaded samples x K4's (K4b's)
    k34, pair34 = {}, {}
    for ii in (II, II_HYBRID):
        g_ii = geo if ii == II else shear_warp.fast_geometry(packs, uni, RES, RES, ii)
        st_ii = sr.resample_slabs(packs[0], g_ii.m, g_ii.pos_u, g_ii.pos_v, g_ii.occ_k)
        gp_ii = g_ii.pos_u.shape[0]
        k3_ii = device_ms(lambda: sr.resample_slabs(packs[0], g_ii.m, g_ii.pos_u, g_ii.pos_v,
                                                    g_ii.occ_k), torch)
        for transfer in sr.TRANSFERS:
            args = (packs[0], g_ii.m, g_ii.pos_u, g_ii.pos_v, g_ii.sgn, g_ii.irho, g_ii.occ_k,
                    g_ii.occ_rb, transfer)
            _, count = sr.composite_plain(st_ii, g_ii.sgn, g_ii.irho, g_ii.occ_rb, transfer,
                                          return_count=True)
            texels, samples, live_slabs = tapped_texels(packs[0], g_ii, count, torch)
            shaded = shaded_samples(st_ii, g_ii.sgn, g_ii.irho, g_ii.occ_rb, transfer, torch)
            bound = bound_ms(texels * 2 + live_slabs * 2 * ii * 4 + ii * ii * 4
                             + gp_ii + g_ii.occ_rb.numel() + 8 + 4 * ii * ii * 4,
                             samples * OPS_K3_SAMPLE + live_slabs * 2 * ii * OPS_HAT_POS
                             + shaded * OPS_SHADE[transfer])
            k34[(ii, transfer)] = {
                "device": device_ms(lambda: sr.resample_composite(*args), torch),
                "call": median_ms(lambda: sr.resample_composite(*args), n, torch),
                "texels": texels, "samples": samples, "shaded": shaded,
                "live slabs": live_slabs, "bound": bound,
            }
            k4_ii = device_ms(lambda: sr.composite(st_ii, g_ii.sgn, g_ii.irho, g_ii.occ_rb,
                                                   transfer), torch)

            def pair_call():
                return sr.composite(sr.resample_slabs(packs[0], g_ii.m, g_ii.pos_u, g_ii.pos_v,
                                                      g_ii.occ_k), g_ii.sgn, g_ii.irho,
                                    g_ii.occ_rb, transfer)

            pair34[(ii, transfer)] = {"K3 device": k3_ii, "K4 device": k4_ii,
                                      "pair device": device_ms(pair_call, torch),
                                      "pair call": median_ms(pair_call, n, torch)}
        del st_ii
    k34p_ms = median_ms(lambda: sr.resample_composite_plain(
        packs[0], geo.m, geo.pos_u, geo.pos_v, geo.sgn, geo.irho, geo.occ_k, geo.occ_rb),
        5, torch, warmup=1)
    for (ii, transfer), row in k34.items():
        pr = pair34[(ii, transfer)]
        b = row["bound"]
        print(f"phase 5 K34 ({card}; bench pose, I={ii}, {transfer}): device "
              f"{row['device']:.4f} ms (tile 8x{sr.TILE_COLS}), one call {row['call']:.4f} ms; "
              f"the K3 -> K4 pair on the same inputs: device "
              f"{pr['pair device']:.4f} ms (K3 {pr['K3 device']:.4f} + K4 {pr['K4 device']:.4f}), "
              f"one call {pr['pair call']:.4f} ms; bound {b[0]:.4f} ms ({b[1]}; bytes "
              f"{b[2]:.4f} ms: {row['texels']} pack texels tapped in {row['live slabs']} "
              f"slabs; operations {b[3]:.4f} ms: {row['samples']} resampled x "
              f"{OPS_K3_SAMPLE} + {row['live slabs']} x {2 * ii} positions x {OPS_HAT_POS} + "
              f"{row['shaded']} above 0.1 x {OPS_SHADE[transfer]}), "
              f"{row['device'] / b[0]:.1f}x its bound; mean window "
              f"{win_stats[('bench', ii)][0]:.1f} texels", flush=True)
    print(f"phase 5 K34 plain torch (I={II}, lowdeg): {k34p_ms:.4f} ms; K6 vs grid_sample K6, "
          f"device ms min / median / max of {5} replays: K6 "
          + " / ".join(f"{t:.4f}" for t in k6_spread) + ", grid_sample "
          + " / ".join(f"{t:.4f}" for t in gs6_spread), flush=True)

    # peak device memory of one fast frame (I=512) and one hybrid call
    # (I=1024, budget 64), with K34 and with the K3 -> K4 pair in its place
    def peak_mib(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2 ** 20

    def pair_stage(pk, m, pos_u, pos_v, sgn, irho, occ_k=None, occ_rb=None, transfer="lowdeg"):
        return sr.composite(sr.resample_slabs(pk, m, pos_u, pos_v, occ_k), sgn, irho, occ_rb,
                            transfer)

    hyb_peak_r = hy.HybridBonsaiRenderer(vol_bonsai, dev, intermediate=II_HYBRID,
                                         budget=BUDGET_OP)
    peaks = {}
    for stage in ("K34", "pair", "K34 again"):
        fused_fn = sr.resample_composite
        if stage == "pair":
            sr.resample_composite = pair_stage
        try:
            peaks[stage] = (
                peak_mib(lambda: shear_warp._render_fast(packs, uni, RES, RES, II, True)),
                peak_mib(lambda: hy._render_hybrid(
                    hyb_peak_r.packs, hyb_peak_r.vol, uni, hyb_peak_r.thresh, RES, RES,
                    II_HYBRID, BUDGET_OP, True, pair=pair)))
        finally:
            sr.resample_composite = fused_fn
    del hyb_peak_r
    gp = geo.pos_u.shape[0]
    print(f"phase 5 peak device memory above the resident tensors (MiB; fast frame I={II} / "
          f"hybrid call I={II_HYBRID}, budget {BUDGET_OP}): "
          + ", ".join(f"{k} {v[0]:.1f} / {v[1]:.1f}" for k, v in peaks.items())
          + f"; the pair's stack {gp * II * II * 2 / 2 ** 20:.1f} / "
          f"{gp * II_HYBRID * II_HYBRID * 2 / 2 ** 20:.1f}", flush=True)
    fast_demo = FastDemo.init(fctx)

    def fast_frame():
        fctx.update()
        fast_demo.render(fctx)
        fctx.render()

    fframe_ms = eager_and_replay("fast", eager_frame(
        fctx, lambda u: shear_warp._render_fast(fast_demo.renderer.packs, u, RES, RES, II,
                                                True)), fast_frame, n)
    fplain_ms = median_ms(lambda: shear_warp._render_fast(packs, uni, RES, RES, II, True,
                                                          plain=True), TIMED_FRAMES, torch)
    print(f"phase 5 fast path ({card}; bench pose, 256^3 {RES}x{RES}, I={II}; medians "
          f"of {n} / {TIMED_FRAMES} plain):", flush=True)
    print(f"phase 5 fast stages (one call): geometry (torch) {geo_ms:.4f} ms, K3 resample "
          f"{k3_ms:.4f} ms, K4 composite {k4_ms:.4f} ms (K4b exact transfer "
          f"{k4b_ms:.4f} ms), warp coords (torch) {coords_ms:.4f} ms, K6 warp "
          f"{k6_ms:.4f} ms")
    print(f"phase 5 device times (CUDA graph of {GRAPH_LAUNCHES} launches): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in dev_ms.items()))
    print(f"phase 5 fast plain torch: K3 {k3p_ms:.4f} ms, K4 {k4p_ms:.4f} ms (K4b "
          f"{k4bp_ms:.4f} ms), K6 "
          f"{k6p_ms:.4f} ms, whole plain fast frame {fplain_ms:.4f} ms")
    print(f"phase 5 yardsticks (grid_sample, f32, one call): K3's function {lib3_ms:.4f} ms, "
          f"K6's function {lib6_ms:.4f} ms")
    print(f"phase 5 whole fast frame (Context.update + BonsaiDemo.render + present, "
          f"replayed): {fframe_ms:.4f} ms/frame ({mrays / fframe_ms * 1e3:.1f} Mrays/s); eager "
          f"{frames_ms['fast']['eager']:.4f} ms in the same rounds", flush=True)
    # the hybrid's stages at the bench pose: the demo's (I=512, budget 128)
    # and the operating point (I=1024, budget 64)
    pair = hy._pair_mode(256, RES, RES)
    tpu = 2 if pair else 1
    n_units = ny * nx // tpu

    def hybrid_stages(ii, budget):
        """Median ms of each stage of a hybrid frame at the bench pose, and
        K5's and K2's inputs."""
        r_ii = hy.HybridBonsaiRenderer(vol_bonsai, dev, intermediate=ii, budget=budget)
        check(r_ii.route(uni, RES, RES) == ("hybrid", ii, budget), "bench pose not hybrid")
        geo = shear_warp.fast_geometry(packs, uni, RES, RES, ii)
        k34_args = (packs[0], geo.m, geo.pos_u, geo.pos_v, geo.sgn, geo.irho, geo.occ_k,
                    geo.occ_rb)
        planes = sr.resample_composite(*k34_args)

        def coords_curv():
            av, bu, ok = shear_warp.warp_coords(geo, ii, ii)
            return torch.cat([planes[:3], shear_warp.curvature(planes)[None]]), av, bu, ok

        k5_args = coords_curv() + (geo.hit,)
        k5_ok[ii] = int(k5_args[3].sum())
        k5_texels[ii] = warp_check.tapped_texels(k5_args[1], k5_args[2], k5_args[3], ii, ii)
        rgb, stats = w2.warp_stats(*k5_args)

        def select():
            return hy.select_units(hy.score_tiles(stats, ny, nx), ny * nx, budget,
                                   hy.DEFAULT_THRESH, pair)

        ids = select()
        rays = mb.tile_rays_compact(uni, ids, RES, RES, tpu)
        base = rgb.clone()
        row = {
            "geometry (torch)": median_ms(
                lambda: shear_warp.fast_geometry(packs, uni, RES, RES, ii), n, torch),
            "K34": median_ms(lambda: sr.resample_composite(*k34_args), n, torch),
            "coords + curvature (torch)": median_ms(coords_curv, n, torch),
            "K5": median_ms(lambda: w2.warp_stats(*k5_args), n, torch),
            "scoring + selection (torch)": median_ms(select, n, torch),
            "compact rays (torch)": median_ms(
                lambda: mb.tile_rays_compact(uni, ids, RES, RES, tpu), n, torch),
            "K2": median_ms(lambda: mb._launch_tiles(vol_bonsai, rays, ids, RES, RES, tpu,
                                                     reference.MAX_STEPS_BONSAI, True, base,
                                                     False), n, torch),
            "sRGB + assembly (torch)": median_ms(lambda: shear_warp.finish(rgb, True), n,
                                                 torch),
            "whole hybrid frame (renderer call)": median_ms(lambda: r_ii(uni, RES, RES), n,
                                                            torch),
        }
        row["K5 device"] = device_ms(lambda: w2.warp_stats(*k5_args), torch)
        # K5's gather alone: K6 on its inputs over its four channels, and over
        # r, g, b only (K5 less its statistics, and less the curvature plane)
        for n_ch in (4, 3):
            row[f"K6 {n_ch}ch on K5 inputs device"] = device_ms(
                lambda: w2.warp_bilinear(k5_args[0][:n_ch], *k5_args[1:4]), torch)
        row["K2 device"] = device_ms(lambda: mb._launch_tiles(
            vol_bonsai, rays, ids, RES, RES, tpu, reference.MAX_STEPS_BONSAI, True, base, False),
            torch)
        n_sel = int((ids < n_units).sum())
        print(f"phase 5 hybrid stages ({card}; bench pose, 256^3 {RES}x{RES}, I={ii}, budget "
              f"{budget}, {n_sel} of {ids.numel()} {'pairs' if pair else 'tiles'} "
              f"selected; one call, medians of {n}; device: CUDA graph of {GRAPH_LAUNCHES}): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items()), flush=True)
        return row, k5_args, ids, rays, base, n_sel

    k5_ok, k5_texels = {}, {}
    hyb_rows = {II_HYBRID: hybrid_stages(II_HYBRID, BUDGET_OP)[0]}
    hyb_rows[II], k5_args, ids, rays, base, n_sel = hybrid_stages(II, hy.DEFAULT_BUDGET)
    # K5's and K2's plain versions, the yardstick, and this run's work, at
    # the demo's setting
    k5p_ms = median_ms(lambda: w2.warp_stats_plain(*k5_args), n, torch)
    hchans, hav, hbu, _, _ = k5_args
    grid5 = torch.stack([hbu / (II - 1) * 2 - 1, hav / (II - 1) * 2 - 1], dim=-1)[None]
    lib5_ms = median_ms(lambda: gs(hchans[None], grid5, mode="bilinear", padding_mode="border",
                                   align_corners=True), n, torch)
    lib5_dev = device_ms(lambda: gs(hchans[None], grid5, mode="bilinear", padding_mode="border",
                                    align_corners=True), torch)
    k2p_ms = median_ms(lambda: mb.render_bonsai_tiles_into_plain(
        vol_bonsai, base, uni, ids, RES, RES, tpu, True), TIMED_FRAMES, torch)
    # K1b, K2's compact mode (tests only), on the same units
    compact = torch.empty((3,) + tuple(rays[1][0].shape), dtype=torch.float32, device=dev)
    k1b_ms = median_ms(lambda: mb._launch_tiles(vol_bonsai, rays, ids, RES, RES, tpu,
                                                reference.MAX_STEPS_BONSAI, True, compact,
                                                True), n, torch)
    k1b_dev = device_ms(lambda: mb._launch_tiles(vol_bonsai, rays, ids, RES, RES, tpu,
                                                 reference.MAX_STEPS_BONSAI, True, compact,
                                                 True), torch)
    k1bp_ms = median_ms(lambda: mb.render_bonsai_tiles_plain(vol_bonsai, uni, ids, RES, RES,
                                                             tpu, True), TIMED_FRAMES, torch)
    k2_dirs = torch.stack(rays[1], dim=-1)
    _, k2_steps = reference.render_bonsai_rays(vol_bonsai, rays[0], k2_dirs, return_steps=True,
                                               fast_transfer=True)
    listed = (ids.repeat_interleave(tpu * 32) < n_units)[:, None]
    k2_steps, k2_skipped = skip_counts(vol_bonsai, rays[0], k2_dirs, k2_steps * listed, torch)
    k2_skip = k2_skipped / k2_steps
    k2_pixels = n_sel * tpu * 32 * 32
    del k5_args, hchans, grid5, base, rays, compact, k2_dirs
    hyb_demo = HybridDemo.init(hctx)

    def hyb_frame():
        hctx.update()
        hyb_demo.render(hctx)
        hctx.render()

    def hyb_eager(u):
        r = hyb_demo.renderer
        mode, ii, b = r.route(u, RES, RES)
        if mode in ("exact", "dense"):
            return mb.render_frame(r.vol, u, RES, RES)
        return hy._render_hybrid(r.packs, r.vol, u, r.thresh, RES, RES, ii, b, True,
                                 pair=pair)[0]

    hframe_ms = eager_and_replay("hybrid", eager_frame(hctx, hyb_eager), hyb_frame, n)
    print(f"phase 5 K5 plain torch {k5p_ms:.4f} ms, K2 plain torch {k2p_ms:.4f} ms; K5's "
          f"warp alone as grid_sample (4 channels, f32, none of K5's tile statistics, so no "
          f"library time of K5's function): device {lib5_dev:.4f} ms, one call {lib5_ms:.4f} "
          f"ms; K1b (compact mode, same units): device {k1b_dev:.4f} ms, one call "
          f"{k1b_ms:.4f} ms, plain {k1bp_ms:.4f} ms; K2's marched steps skipped {k2_skip:.4f}")
    print(f"phase 5 whole hybrid frame (Context.update + BonsaiDemo.render + present, I={II}, "
          f"budget {hy.DEFAULT_BUDGET}, replayed): {hframe_ms:.4f} ms/frame "
          f"({mrays / hframe_ms * 1e3:.1f} Mrays/s); eager {frames_ms['hybrid']['eager']:.4f} "
          f"ms in the same rounds", flush=True)

    def frame_profile(name, replay, eager):
        """The replayed frame's host syncs, device kernels and copies, busy
        ms and idle share (10 frames under torch.profiler), and the eager
        frame's host syncs, into ``frames_ms``."""
        syncs = host_syncs(replay, torch)
        share = device_share(replay, 10, torch)
        row = frames_ms[name]
        row.update(host_syncs=syncs, eager_host_syncs=host_syncs(eager, torch))
        if share is not None:
            row.update(device_events=share[0], device_busy_ms=share[1], idle_share=share[2])
        trace = ("no device events in the trace" if share is None else
                 f"{share[0]:.1f} device kernels/copies per frame, device busy "
                 f"{share[1]:.4f} ms per frame, device idle share {share[2]:.3f}")
        print(f"phase 5 {name} frame profile (replayed; 10 frames, torch.profiler on): host "
              f"syncs per frame {syncs} (eager {row['eager_host_syncs']}), {trace}",
              flush=True)
        return syncs, trace

    # profiled at the end of phase 5: after a torch.profiler session the
    # host's launches run slower, which would reach the timings after it
    profiles = [
        ("exact", frame, eager_frame(ctx, lambda u: mb.render_frame(demo.renderer.vol, u,
                                                                    RES, RES))),
        ("fast", fast_frame, eager_frame(fctx, lambda u: shear_warp._render_fast(
            fast_demo.renderer.packs, u, RES, RES, II, True))),
        ("hybrid", hyb_frame, eager_frame(hctx, hyb_eager))]

    # bounds from this run's inputs and data-dependent work
    # K1 and K2 count OPS_K1_STEP / OPS_K2_STEP a sampled step and
    # OPS_SKIP_STEP a skipped one: what this run's data needs
    k1_sampled = k1_steps - k1_skipped
    k1_bound = bound_ms(vol_bonsai.numel() + 3 * RES * RES * 4 + 12 + RES * RES * 16,
                        k1_sampled * OPS_K1_STEP + k1_skipped * OPS_SKIP_STEP)
    hot = int(geo.occ_k.sum())
    k3_bound = bound_ms(hot * d * d * 2 + 2 * gp * II * 4 + gp + 4 + gp * II * II * 2,
                        hot * (II * II * OPS_K3_SAMPLE + 2 * II * OPS_HAT_POS))
    k4_samples = int(k4_count.sum())
    k4_bound = bound_ms(k4_samples * 2 + II * II * 4 + geo.occ_rb.numel() + 8
                        + 4 * II * II * 4, k4_samples * OPS_K4_SAMPLE)
    n_hit = int(ok_b.sum())
    # the warps read the intermediate's texels that their pixels' taps touch
    k6_bound = bound_ms(3 * k6_texels * 4 + RES * RES + n_hit * 8 + 3 * RES * RES * 4,
                        n_hit * (OPS_K6_PIXEL + 3 * OPS_K6_CHANNEL))
    k4b_samples = int(k4b_count.sum())
    k4b_bound = bound_ms(k4b_samples * 2 + II * II * 4 + geo.occ_rb.numel() + 8
                         + 4 * II * II * 4, k4b_samples * OPS_K4B_SAMPLE)
    n_px = RES * RES
    # av/bu are read only at ok pixels, box only where ok is 0; at I=512 (the
    # demo) and I=1024 (the operating point)
    k5_bounds = {ii: bound_ms(4 * k5_texels[ii] * 4 + n_px * (1 + 12) + (n_px - n_ok)
                              + n_ok * 8 + ny * nx * 20,
                              n_ok * (OPS_K6_PIXEL + 4 * OPS_K6_CHANNEL) + n_px * OPS_K5_PIXEL)
                 for ii, n_ok in k5_ok.items()}
    k5_bound = k5_bounds[II]
    k2_sampled = k2_steps - k2_skipped
    k2_bound = bound_ms(vol_bonsai.numel() + k2_pixels * (12 + 12) + 12 + 4 * ids.numel(),
                        k2_sampled * OPS_K2_STEP + k2_skipped * OPS_SKIP_STEP)
    print(f"phase 5 work: K1 {k1_steps} steps marched ({k1_steps / (RES * RES):.1f} per ray), "
          f"{k1_sampled} of them sampled, {k1_skipped} skipped; "
          f"K3 {hot} hot slabs of {gp}; K4 {k4_samples} samples composited "
          f"({k4_samples / (II * II):.1f} per texel); K6 {n_hit} hit pixels tapping {k6_texels} "
          f"texels ({k6_texels / (II * II):.4f} of the plane); K5 {k5_ok[II]} ok pixels of "
          f"{n_px} tapping {k5_texels[II]} texels ({k5_texels[II] / (II * II):.4f}; I=1024: "
          f"{k5_ok[II_HYBRID]} ok, {k5_texels[II_HYBRID]} texels, "
          f"{k5_texels[II_HYBRID] / II_HYBRID ** 2:.4f}); K2 {k2_steps} steps over "
          f"{k2_pixels} pixels, {k2_sampled} sampled, "
          f"{k2_skipped} skipped")
    print(f"phase 5 bounds (ms, H100 SXM 3.35 TB/s, 67 TFLOP/s f32): K1 {k1_bound[0]:.4f} "
          f"({k1_bound[1]}), K3 {k3_bound[0]:.4f} ({k3_bound[1]}), K4 {k4_bound[0]:.4f} "
          f"({k4_bound[1]}), K4b {k4b_bound[0]:.4f} ({k4b_bound[1]}), K6 {k6_bound[0]:.4f} "
          f"({k6_bound[1]}), K5 {k5_bound[0]:.4f} ({k5_bound[1]}), K2 {k2_bound[0]:.4f} "
          f"({k2_bound[1]})", flush=True)
    print(f"phase 5 K5 ({card}; bench pose, {RES}x{RES}; device: CUDA graph of "
          f"{GRAPH_LAUNCHES}): " + ", ".join(
              f"I={ii} device {hyb_rows[ii]['K5 device']:.4f} ms, one call "
              f"{hyb_rows[ii]['K5']:.4f} ms, bound {k5_bounds[ii][0]:.4f} ms "
              f"({k5_bounds[ii][1]}), {hyb_rows[ii]['K5 device'] / k5_bounds[ii][0]:.2f}x its "
              f"bound; its gather alone (K6 on its inputs) 4 channels "
              f"{hyb_rows[ii]['K6 4ch on K5 inputs device']:.4f} ms, 3 channels "
              f"{hyb_rows[ii]['K6 3ch on K5 inputs device']:.4f} ms"
              for ii in (II, II_HYBRID)), flush=True)

    # K7, K9 and K8 alone (rays and time precomputed), their plain versions,
    # this run's work, the xor demo frame and one full config-5 batch
    t_dev = torch.zeros((), dtype=torch.float32, device=dev)
    tvec = mf.time_vector(t_dev, dev)
    k7_ms, k7_dev, k7p_ms, k7_samples, k7_bound, k7_lanes = {}, {}, {}, {}, {}, {}
    hash_ms = (device_ms(lambda: mf.build_hash_table(dev), torch),
               median_ms(lambda: mf.build_hash_table(dev), n, torch))
    for name in ("xor analytic", "xor fd", "trig"):
        field, shading, quantize, grad = k7_cases[name]
        rays = mf.field_rays(xor_u, FIELD_RES, FIELD_RES, field, 256, quantize, True)

        def k7_call():
            return mf.launch(tvec, rays, field, shading, 256, quantize,
                             reference.MAX_STEPS_COMPUTE, grad, mf.DEFAULT_TILE_H)

        k7_ms[name] = median_ms(k7_call, n, torch)
        k7_dev[name] = device_ms(k7_call, torch)
        kw = dict(field=field, shading=shading, quantize=quantize, grad=grad)
        k7p_ms[name] = median_ms(lambda: mf.render_field_plain(xor_u, t_dev, FIELD_RES,
                                                               FIELD_RES, **kw), 5, torch,
                                 warmup=1)
        _, steps = mf.render_field_plain(xor_u, t_dev, FIELD_RES, FIELD_RES, return_steps=True,
                                         **kw)
        k7_samples[name] = int(steps.sum())
        k7_lanes[name] = lane_efficiency(steps, torch)
        k7_bound[name] = bound_ms(FIELD_RES * FIELD_RES * (9 * 4 + 16) + 8,
                                  k7_samples[name] * OPS_K7_SAMPLE[name])
    k9_ms = median_ms(lambda: genvol.generate_xor_volumes(t_dev, 256), TIMED_FRAMES, torch)
    k9p_ms = median_ms(lambda: genvol.generate_xor_volumes_plain(t_dev, 256), 5, torch, warmup=1)
    k8_ms = median_ms(lambda: genvol.generate_density_u8(t_dev, VOL5), TIMED_FRAMES, torch)
    k8p_ms = median_ms(lambda: genvol.generate_density_u8_plain(t_dev, VOL5), 3, torch, warmup=1)
    # the volume wrappers' device time includes their sin(t) (two tiny torch kernels)
    k9_dev = device_ms(lambda: genvol.generate_xor_volumes(t_dev, 256), torch, reps=3)
    k8_dev = device_ms(lambda: genvol.generate_density_u8(t_dev, VOL5), torch, reps=3)
    k9_shared = lattice_ops(256, 0.0, True, torch)
    k8_shared = lattice_ops(VOL5, 0.0, False, torch)
    k9_bound = bound_ms(256 ** 3 * 32 + 4, 256 ** 3 * OPS_K9_VOXEL_MIN + k9_shared)
    k8_bound = bound_ms(VOL5 ** 3 + 4, VOL5 ** 3 * OPS_K8_VOXEL_MIN + k8_shared)
    k9_voxelwise = bound_ms(256 ** 3 * 32 + 4, 256 ** 3 * OPS_K9_VOXEL)
    k8_voxelwise = bound_ms(VOL5 ** 3 + 4, VOL5 ** 3 * OPS_K8_VOXEL)
    # each octave's table window per brick at this run's sin t (the
    # kernels' rule, genvol.brick_windows) against its capacity
    windows = {}
    for name, dims, brick, offsets in (("K9", 256, genvol.K9_BRICK, True),
                                       ("K8", VOL5, genvol.K8_BRICK, False)):
        w = genvol.brick_windows(dims, 0.0, brick, offsets)
        size = (w[..., 1] - w[..., 0] + 1).reshape(-1, 3).float()
        windows[name] = "; ".join(
            f"octave {o} mean {float(size[:, o].mean()):.1f} max {int(size[:, o].max())} "
            f"of {cap} floats" for o, cap in enumerate(genvol.window_capacity(dims, brick,
                                                                              offsets)))
    print(f"phase 5 field kernels ({card}; {FIELD_RES}^2 Camera.xor(1.0), t = 0, sphere clip; "
          f"device: CUDA graph of {GRAPH_LAUNCHES}; one call: median of {n}; plain: 5): "
          + ", ".join(f"K7 {k} device {k7_dev[k]:.4f} ms, one call {k7_ms[k]:.4f} ms (plain "
                      f"{k7p_ms[k]:.2f}, {k7_samples[k]} samples, lane efficiency "
                      f"{k7_lanes[k]:.4f}, bound {k7_bound[k][0]:.4f} {k7_bound[k][1]})"
                      for k in k7_ms)
          + f"; hash table build ({mf.hash_table(dev).values.numel()} floats) device "
            f"{hash_ms[0]:.4f} ms, one call {hash_ms[1]:.4f} ms", flush=True)
    print(f"phase 5 volume kernels ({card}; device: CUDA graph of {GRAPH_LAUNCHES}): K9 256^3 "
          f"device {k9_dev:.4f} ms, one call {k9_ms:.4f} ms (plain {k9p_ms:.2f}, bound "
          f"{k9_bound[0]:.4f} {k9_bound[1]}: {k9_shared} shared operations; voxel by voxel "
          f"{k9_voxelwise[0]:.4f} {k9_voxelwise[1]}), K8 {VOL5}^3 device {k8_dev:.4f} ms, one "
          f"call {k8_ms:.4f} ms (plain {k8p_ms:.2f}, bound {k8_bound[0]:.4f} {k8_bound[1]}: "
          f"{k8_shared} shared operations; voxel by voxel {k8_voxelwise[0]:.4f} "
          f"{k8_voxelwise[1]})", flush=True)
    for name, brick in (("K9", genvol.K9_BRICK), ("K8", genvol.K8_BRICK)):
        print(f"phase 5 {name} windows (brick {brick}, sin t = 0): {windows[name]}", flush=True)
    xctx = xor_runs[XOR_RES][0]
    xor_demo = XorDemo.init(xctx)

    def xor_frame():
        xctx.update()
        xor_demo.render(xctx)
        xctx.render()

    xw, xh = XOR_RES
    xrays = mf.field_rays(xctx.camera_uniform, xw, xh)
    xgrad = mf.default_grad()
    xor_eager = eager_frame(xctx, lambda u: mf.render_field(u, xor_demo.gen_time, xw, xh))
    xor_stages = {
        "rays + clip (torch)": median_ms(lambda: mf.field_rays(xctx.camera_uniform, xw, xh), n,
                                         torch),
        "K7": median_ms(lambda: mf.launch(tvec, xrays, "noise", "xor", 256, True,
                                          reference.MAX_STEPS_COMPUTE, xgrad, mf.DEFAULT_TILE_H),
                        n, torch),
        "K7 device": device_ms(lambda: mf.launch(tvec, xrays, "noise", "xor", 256, True,
                                                 reference.MAX_STEPS_COMPUTE, xgrad,
                                                 mf.DEFAULT_TILE_H), torch),
        "present": median_ms(lambda: present(xctx.render_backbuffer.texture,
                                             out_height=xh, out_width=xw), n, torch),
        "whole frame (update + render + present, replayed)": eager_and_replay(
            "xor", xor_eager, xor_frame, n),
    }
    xor_stages["whole frame eager (same rounds)"] = frames_ms["xor"]["eager"]
    profiles.append(("xor", xor_frame, xor_eager))
    print(f"phase 5 xor demo frame ({card}; {xw}x{xh}, grad {xgrad}, K7 lane efficiency "
          f"{xor_runs[XOR_RES][2]:.4f}, medians of {n}): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in xor_stages.items()), flush=True)
    trig_demo = TrigDemo.init(tctx)

    def trig_frame():
        tctx.update()
        trig_demo.render(tctx)
        tctx.render()

    trig_eager = eager_frame(tctx, lambda u: trig_eager_frame(
        u.proj_view, tctx.global_uniform.time, tctx.global_uniform.mouse_pressed, xw, xh))
    trig_ms = eager_and_replay("trig", trig_eager, trig_frame, n)
    trig_syncs = host_syncs(trig_frame, torch)
    profiles.append(("trig", trig_frame, trig_eager))
    trig_field_ms = median_ms(lambda: mf.render_field(xor_u, t_dev, FIELD_RES, FIELD_RES,
                                                      field="trig", shading="emission",
                                                      quantize=False), n, torch)
    print(f"phase 5 trig ({card}; medians of {n}): trig demo frame {xw}x{xh} (update + "
          f"rasterize + present, replayed) {trig_ms:.4f} ms (eager "
          f"{frames_ms['trig']['eager']:.4f} ms), host syncs per frame {trig_syncs}; trig "
          f"field frame {FIELD_RES}^2 (render_field: rays + clip + K7) {trig_field_ms:.4f} ms",
          flush=True)
    eye5, dxyz5 = geometry.rays_fragment_soa(batch64.cams[0], VIEW_RES, VIEW_RES)
    occ5_ms = (device_ms(lambda: mb.occupancy_table(vol5), torch),
               median_ms(lambda: mb.occupancy_table(vol5), n, torch))
    dirs5 = torch.stack(dxyz5, dim=-1)
    _, c5_steps = reference.render_bonsai_rays(vol5, eye5, dirs5, max_steps=max_steps5,
                                               return_steps=True)
    c5_marched, c5_skipped = skip_counts(vol5, eye5, dirs5, c5_steps, torch)
    c5_view_ms = median_ms(lambda: mb.render_bonsai_rays_cuda(vol5, eye5, dxyz5,
                                                              max_steps=max_steps5), n, torch)
    c5_view_dev = device_ms(lambda: mb.render_bonsai_rays_cuda(vol5, eye5, dxyz5,
                                                               max_steps=max_steps5), torch)
    c5_rays_ms = median_ms(lambda: geometry.rays_fragment_soa(batch64.cams[0], VIEW_RES,
                                                              VIEW_RES), n, torch)

    def c5_per_view_loop():
        """The batch step as the port ran it before views were batched, kept
        here only as the yardstick: K8's volume, then each view's rays and
        its own K1 launch in turn."""
        vol = genvol.generate_density_u8(0.0, VOL5, dev)
        render, pack = sharding.build_default_renderer(vol, dev)
        return vol, torch.stack([render(pack, c, VIEW_RES, VIEW_RES, max_steps5)
                                 for c in batch64.cams])

    def c5_eager():
        return batch64.step(torch.full((), 0.0, dtype=torch.float32, device=dev))

    c5_pair = interleaved_ms({"batch": lambda: batch64(0), "batch eager": c5_eager,
                              "per-view loop": c5_per_view_loop}, C5_ROUNDS, torch)
    c5_ms = c5_pair["batch"]
    frames_ms["config 5 batch"] = {"eager": c5_pair["batch eager"], "replay": c5_ms}
    # the batch step captured in a CUDA graph (K8, the occupancy table, the
    # batched rays and K1): the capture fails if the step syncs with the host
    c5_dev = device_ms(lambda: batch64(0), torch, n=C5_GRAPH_STEPS, reps=3)
    c5_syncs = host_syncs(lambda: batch64(0), torch)
    eye64, dxyz64 = geometry.rays_fragment_soa(batch64.cams, VIEW_RES, VIEW_RES)
    c5_batch_rays = (device_ms(lambda: geometry.rays_fragment_soa(batch64.cams, VIEW_RES,
                                                                  VIEW_RES), torch, n=10, reps=3),
                     median_ms(lambda: geometry.rays_fragment_soa(batch64.cams, VIEW_RES,
                                                                  VIEW_RES), n, torch))
    c5_batch_k1 = device_ms(lambda: mb.render_bonsai_rays_cuda(vol5, eye64, dxyz64,
                                                               max_steps=max_steps5),
                            torch, n=10, reps=3)
    del eye64, dxyz64
    c5_peak = {}
    for name, step in (("batch", c5_eager), ("per-view loop", c5_per_view_loop)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out5 = step()
        torch.cuda.synchronize()
        c5_peak[name] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        del out5
    print(f"phase 5 config 5 ({card}): one batch (K8 {VOL5}^3 + {VIEWS} views {VIEW_RES}^2, "
          f"{max_steps5} steps; ViewsBatch()(0): one ray pass, one K1 launch), medians of "
          f"{C5_ROUNDS} interleaved rounds: batch (replayed) {c5_ms:.4f} ms, eager "
          f"{c5_pair['batch eager']:.4f} ms, "
          f"({VIEWS * VIEW_RES ** 2 / c5_ms / 1e3:.1f} Mrays/s) vs the per-view loop "
          f"{c5_pair['per-view loop']:.4f} ms ({c5_pair['per-view loop'] / c5_ms:.3f}x); the "
          f"batch step on the device (a CUDA graph of {C5_GRAPH_STEPS} steps) {c5_dev:.4f} ms, "
          f"host syncs {c5_syncs}; batched rays device {c5_batch_rays[0]:.4f} ms, one call "
          f"{c5_batch_rays[1]:.4f} ms; batched K1 device {c5_batch_k1:.4f} ms; peak device "
          f"memory above the resident tensors: eager batch {c5_peak['batch']:.1f} MiB, per-view "
          f"loop "
          f"{c5_peak['per-view loop']:.1f} MiB; K1 one view: device {c5_view_dev:.4f} ms, one "
          f"call {c5_view_ms:.4f} ms; its rays {c5_rays_ms:.4f} ms; its marched steps skipped "
          f"{c5_skipped / c5_marched:.4f} of {c5_marched}; occupancy table ({VOL5}^3) device "
          f"{occ5_ms[0]:.4f} ms, one call {occ5_ms[1]:.4f} ms; K8 device {k8_dev:.4f} ms",
          flush=True)

    # config 4 at 1080p (phase 4l's renderers): the exact and the hybrid
    # frame, the poses in turn; K1 alone at pose 0
    def cycled(render, poses):
        it = itertools.cycle(poses)
        return lambda: render(next(it), ow, oh)

    def hybrid_eager4(u, w, h):
        route = orb.hybrid.route(u, w, h)
        if route[0] in ("exact", "dense"):
            return mb.render_frame(orb.exact.vol, u, w, h)
        return hy._render_hybrid(orb.hybrid.packs, orb.hybrid.vol, u, orb.hybrid.thresh, w, h,
                                 route[1], route[2], True, pair=pair4)[0]

    hyb_poses = [orb.poses[i] for i in hyb_idx]
    orbit_ms = interleaved_ms({
        "exact": cycled(orb.exact, orb.poses),
        "exact eager": cycled(lambda u, w, h: mb.render_frame(orb.exact.vol, u, w, h),
                              orb.poses)}, 5 * n_orbit, torch, warmup=n_orbit)
    orbit_ms.update(interleaved_ms({
        "hybrid (hybrid-routed poses)": cycled(orb.hybrid, hyb_poses),
        "hybrid eager (hybrid-routed poses)": cycled(hybrid_eager4, hyb_poses)},
        5 * len(hyb_poses), torch, warmup=len(hyb_poses)))
    orbit_ms["hybrid renderer (every pose)"] = median_ms(cycled(orb.hybrid, orb.poses),
                                                         5 * n_orbit, torch)
    frames_ms["config 4 exact"] = {"eager": orbit_ms["exact eager"],
                                   "replay": orbit_ms["exact"]}
    frames_ms["config 4 hybrid pose"] = {"eager": orbit_ms["hybrid eager (hybrid-routed poses)"],
                                         "replay": orbit_ms["hybrid (hybrid-routed poses)"]}
    eye4, dxyz4 = geometry.rays_fragment_soa(orb.poses[0], ow, oh)
    orbit_k1_dev = device_ms(lambda: mb.render_bonsai_rays_cuda(orb.exact.vol, eye4, dxyz4),
                             torch)
    print(f"phase 5 config 4 ({card}; {ow}x{oh}, {n_orbit} orbit poses in turn, medians of 5 "
          f"rounds, one call each): " + ", ".join(f"{k} frame {v:.4f} ms"
                                                  for k, v in orbit_ms.items())
          + f"; K1 at pose 0 device {orbit_k1_dev:.4f} ms "
          f"({ow * oh / orbit_k1_dev / 1e3:.1f} Mrays/s)", flush=True)
    del eye4, dxyz4
    for name, fn, fn_eager in profiles:
        frame_profile(name, fn, fn_eager)
    print(f"phase 5 frames json {json.dumps(frames_ms)}", flush=True)

    # PERF.md's ranking on device times: slower than a same-function library
    # call first, then launches per frame (one each here) x (device - bound);
    # K3 and K4 left the frames for K34
    k34_main = k34[(II, "lowdeg")]
    per_frame = {"K1": (k1_dev, k1_bound[0]), "K2": (hyb_rows[II]["K2 device"], k2_bound[0]),
                 "K34": (k34_main["device"], k34_main["bound"][0]),
                 "K5": (hyb_rows[II]["K5 device"], k5_bound[0]), "K6": (dev_ms["K6"], k6_bound[0]),
                 "K7": (k7_dev["xor analytic"], k7_bound["xor analytic"][0])}
    order = sorted(per_frame, key=lambda k: per_frame[k][1] - per_frame[k][0])
    print("phase 5 ranking (device ms - bound ms per frame, largest first): " + ", ".join(
        f"{k} {per_frame[k][0] - per_frame[k][1]:.4f} ({per_frame[k][0] / per_frame[k][1]:.1f}x "
        f"its bound)" for k in order))
    print(f"phase 5 against grid_sample (device ms, same coordinates, f32): K6 "
          f"{dev_ms['K6']:.4f} vs {dev_ms['grid_sample K6']:.4f} "
          f"({dev_ms['K6'] / dev_ms['grid_sample K6']:.2f}x), K3 {dev_ms['K3']:.4f} vs "
          f"{dev_ms['grid_sample K3']:.4f} ({dev_ms['K3'] / dev_ms['grid_sample K3']:.2f}x)",
          flush=True)

    # -- phases 4h-4k: this slice's paths, run after phase 5 so that phase 5
    # times the frames in the same process state as before they existed
    # (an NCCL group, a device trace, more contexts and processes) ---------

    # -- phase 4h: multi-device at full width (NCCL, world size 1) ----------
    # the machine has one card: a process group of one rank, the (1, 1)
    # mesh; the code is the one that runs at any world size (gloo on the CPU
    # in tests/test_torch_parallel.py). The sharded entries are compiled
    # steps: their first call with a key (warm-up + capture) counts K1 twice
    # in the wrappers, multi_view_step with its default renderer runs the
    # eager step (K1 once)
    import torch.distributed as dist

    def pool_mib(compiled):
        pool = tuple(compiled.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool) / 2 ** 20

    from collections import Counter

    def device_events(fn):
        """``fn()``'s device events in a torch.profiler trace, by name."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return Counter(e.name for e in prof.events() if e.device_type == DeviceType.CUDA)

    def graph_work(eager, replay, own):
        """One eager step's and one replay's device work: the path kernels in
        each, the eager step's NCCL collectives (their "nccl:" ranges on the
        device) and device copies, and the replay's device copies less its
        ``own`` (the inputs' copies into the graph and the outputs' copies
        out): what is left are the graph's copy nodes (at world 1 NCCL's
        all-gather is one cudaMemcpyAsync, captured as a node). CUPTI now
        and then hands back a trace with no device record at all (as
        traced_replays): a replay, which calls no wrapper and captures
        nothing, is then traced again, at most three times."""
        ev_e = device_events(eager)
        for _ in range(3):
            ev_r = device_events(replay)
            if ev_r:
                break

        def kernels(ev):
            return {k: sum(n for name, n in ev.items() if re.search(rf"(?<!\w){v}(?!\w)", name))
                    for k, v in KERNEL_NAMES.items()}

        def copies(ev):  # device-to-device: an upload from the host is no graph node
            return sum(n for name, n in ev.items() if "memcpy" in name.lower()
                       and not re.search(r"htod|dtoh", name.lower()))

        return {"kernels": kernels(ev_r), "eager_kernels": kernels(ev_e),
                "collectives": sorted(n for n in ev_e.elements() if n.startswith("nccl:")),
                "eager_copies": copies(ev_e), "graph_copies": copies(ev_r) - own,
                "replay_events": dict(Counter(k[:48] for k in ev_r.elements()))}

    def orbit_batch(offset):
        """Config 5's orbit of VIEWS views, turned by ``offset`` in yaw."""
        return CameraUniform.stack(
            Camera(zoom=1.0, pitch=0.5, yaw=2.0 * math.pi * i / VIEWS + offset,
                   target=(0.5, 0.5, 0.5), aspect=1.0).uniform(dev) for i in range(VIEWS))

    sharded_rows = {}

    def hold_sharded(name, compiled, keys, calls, work, collectives, **kernels):
        """``calls``: (replay, eager, single-device) triples, each key
        captured already. Every replay bitwise its eager step and the
        single-device result, free of host syncs; ``keys`` captures; one
        replay's trace runs ``kernels`` once and the eager step's copies,
        NCCL's among them, as graph nodes; the eager step's collectives are
        ``collectives``."""
        got = [synced(replay) for replay, _, _ in calls]
        eager_eq = sum(bitwise(g[0][0], eager()) for g, (_, eager, _) in zip(got, calls))
        single_eq = sum(bitwise(g[0][0], single()) for g, (_, _, single) in zip(got, calls))
        syncs = [g[1] for g in got]
        del got
        row = {"replays": len(calls), "bitwise_eager": eager_eq, "bitwise_single": single_eq,
               "host_syncs": max(syncs), "captures": compiled.captures, "keys": keys,
               "pool_mib": pool_mib(compiled), **work}
        sharded_rows[name] = row
        print(f"phase 4h replays {name} ({card}): captures {compiled.captures} for {keys} "
              f"keys; {len(calls)} replays bitwise the eager step {eager_eq}/{len(calls)} and "
              f"the single-device result {single_eq}/{len(calls)}, host syncs per replay "
              f"{syncs}; one replay on the device {work['kernels']}, graph copy nodes "
              f"{work['graph_copies']} (the replay's device events {work['replay_events']}); "
              f"the eager step's collectives {work['collectives']}, device copies "
              f"{work['eager_copies']}; graph pool {row['pool_mib']:.1f} MiB", flush=True)
        check(eager_eq == single_eq == len(calls) and max(syncs) == 0
              and compiled.captures == keys and work["kernels"] == only(**kernels)
              and work["eager_kernels"] == only(**kernels)
              and work["graph_copies"] == work["eager_copies"]
              and work["collectives"] == collectives,
              f"compiled sharded step {name}: {row}")

    t_phase = time.perf_counter()
    torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1,
                                rank=0)
        try:
            mesh = sharding.make_mesh(1, 1, device=dev)
            check(sharding.mesh_device(mesh) == dev, f"mesh device {sharding.mesh_device(mesh)}")
            render, pack = sharding.build_default_renderer(vol_bonsai, dev)
            cams = sharding.orbit_camera_batch(VIEWS, device=dev)
            ray_renderer = sharding.build_ray_renderer(vol_bonsai, dev)
            bench_u = bench.uniform(dev)
            reset_launches()
            t0 = time.perf_counter()
            views_img = sharding.render_views_sharded(mesh, render, pack, cams, VIEW_RES,
                                                      VIEW_RES, max_steps=MAX_STEPS_BONSAI,
                                                      gather=True)
            tiled_img = sharding.render_frame_tiled(
                mesh, None, bench_u, RES, RES, max_steps=MAX_STEPS_BONSAI,
                renderer=ray_renderer)
            step_img = sharding.multi_view_step(mesh, vol_bonsai, VIEWS, VIEW_RES, VIEW_RES,
                                                max_steps=MAX_STEPS_BONSAI, gather=True)
            torch.cuda.synchronize()
            path_s = time.perf_counter() - t0
            mesh_launches = launches()
            check(mesh_launches == only(K1=5),
                  f"multi-device path launched {mesh_launches}, not K1 x 5 (views and frame: "
                  f"warm-up + capture each; the default renderer's step eagerly)")
            # the views against the single-device batched render and single-view
            # K1 calls on the same uniforms; the frame against a K1 call
            batched = render(pack, cams, VIEW_RES, VIEW_RES, MAX_STEPS_BONSAI)
            singles = [render(pack, c, VIEW_RES, VIEW_RES, MAX_STEPS_BONSAI) for c in cams]
            eye, dxyz = geometry.rays_fragment_soa(bench_u, RES, RES)
            frame_k1 = mb.render_bonsai_rays_cuda(vol_bonsai, eye, dxyz)
            check(tuple(views_img.shape) == (VIEWS, VIEW_RES, VIEW_RES, 4),
                  f"gathered views {tuple(views_img.shape)}")
            check(torch.equal(views_img, batched),
                  "the sharded views differ from the single-device batched render")
            views_equal = sum(bool(torch.equal(views_img[i], singles[i])) for i in range(VIEWS))
            check(views_equal == VIEWS, f"only {views_equal}/{VIEWS} sharded views equal K1's")
            check(torch.equal(step_img, views_img), "multi_view_step differs from the views")
            check(torch.equal(tiled_img, frame_k1), "row-sharded frame differs from K1's")
            v_lit = min(float((im[..., :3].amax(dim=-1) > 1.0 / 255.0).float().mean())
                        for im in views_img)
            check(bool(torch.isfinite(views_img).all()) and v_lit > 0.01,
                  f"a sharded view is not finite or shows nothing (least lit {v_lit:.4f})")
            del singles, step_img

            # the replays: each entry's graph (the first calls above captured
            # the gathered views' and the frame's; the local views' and the
            # mesh's config-5 batch capture here) at three inputs
            batches = [cams, orbit_batch(0.05), orbit_batch(0.1)]
            sharding.render_views_sharded(mesh, render, pack, cams, VIEW_RES, VIEW_RES,
                                          max_steps=MAX_STEPS_BONSAI)
            t0 = time.perf_counter()
            batch_mesh = ViewsBatch(n_views=VIEWS, view_res=VIEW_RES, dims=VOL5, mesh=mesh)
            batch_mesh(0)
            torch.cuda.synchronize()
            batch_mesh_s = time.perf_counter() - t0

            def views_calls(gather):
                return [(lambda b=b: sharding.render_views_sharded(
                             mesh, render, pack, b, VIEW_RES, VIEW_RES,
                             max_steps=MAX_STEPS_BONSAI, gather=gather),
                         lambda b=b: sharding.views_sharded_step(
                             mesh, render, pack, b, VIEW_RES, VIEW_RES,
                             max_steps=MAX_STEPS_BONSAI, gather=gather),
                         lambda b=b: render(pack, b, VIEW_RES, VIEW_RES, MAX_STEPS_BONSAI))
                        for b in batches]

            for gather in (True, False):
                calls = views_calls(gather)
                hold_sharded(f"render_views_sharded gather={gather} ({VIEWS} views "
                             f"{VIEW_RES}^2)", sharding.VIEWS_STEPS, 2, calls,
                             graph_work(calls[0][1], calls[0][0], 3 + 1),
                             ["nccl:_all_gather_base"] if gather else [], K1=1)
            calls = [(lambda: sharding.multi_view_step(
                          mesh, None, VIEWS, VIEW_RES, VIEW_RES, max_steps=MAX_STEPS_BONSAI,
                          gather=True, renderer=(render, pack)),
                      lambda: sharding.views_sharded_step(
                          mesh, render, pack, cams, VIEW_RES, VIEW_RES,
                          max_steps=MAX_STEPS_BONSAI, gather=True),
                      lambda: batched)] * 3
            hold_sharded(f"multi_view_step, a stable renderer ({VIEWS} views {VIEW_RES}^2; the "
                         f"gathered views' key)", sharding.VIEWS_STEPS, 2, calls,
                         graph_work(calls[0][1], calls[0][0], 3 + 1), ["nccl:_all_gather_base"],
                         K1=1)
            tiled_poses = [Camera(target=(0.5, 0.5, 0.5), aspect=1.0, **kw).uniform(dev)
                           for kw in COMPILED_POSES.values()]
            calls = [(lambda u=u: sharding.render_frame_tiled(
                          mesh, None, u, RES, RES, max_steps=MAX_STEPS_BONSAI,
                          renderer=ray_renderer),
                      lambda u=u: sharding.frame_tiled_step(
                          mesh, *ray_renderer, u, RES, RES, MAX_STEPS_BONSAI),
                      lambda u=u: mb.render_bonsai_rays_cuda(
                          vol_bonsai, *geometry.rays_fragment_soa(u, RES, RES)))
                     for u in tiled_poses]
            hold_sharded(f"render_frame_tiled, a stable renderer ({RES}^2, 3 poses)",
                         sharding.TILED_STEPS, 1, calls,
                         graph_work(calls[0][1], calls[0][0], 3 + 1), ["nccl:_all_gather_base"],
                         K1=1)

            def t5(b):
                return torch.full((), 0.3 * b, dtype=torch.float32, device=dev)

            calls = [(lambda b=b: batch_mesh(b), lambda b=b: batch_mesh.step(t5(b)),
                      lambda b=b: batch64(b)) for b in (1, 2, 0)]
            hold_sharded(f"ViewsBatch(mesh=...) (K8 {VOL5}^3 + {VIEWS} views {VIEW_RES}^2, "
                         f"{batch_mesh.max_steps} steps, batches 1, 2, 0; the first call "
                         f"{batch_mesh_s:.2f} s)", batch_mesh.compiled, 1, calls,
                         graph_work(calls[0][1], calls[0][0], 1 + 2), [], K8=1, K1=1)
            del calls

            # times, each a median of CUDA-event walls over rounds that call the
            # compared functions in turn: the sharded batch (replayed, and its
            # eager step) against the single-device batch and the same views
            # one by one; the row-sharded frame (replayed, and its eager step)
            # against one K1 frame with its rays, and its parts (rays, the
            # band's march, the all-gather)
            pair_ms = interleaved_ms({
                "sharded": lambda: sharding.render_views_sharded(
                    mesh, render, pack, cams, VIEW_RES, VIEW_RES, max_steps=MAX_STEPS_BONSAI,
                    gather=True),
                "sharded_eager": lambda: sharding.views_sharded_step(
                    mesh, render, pack, cams, VIEW_RES, VIEW_RES, max_steps=MAX_STEPS_BONSAI,
                    gather=True),
                "single": lambda: render(pack, cams, VIEW_RES, VIEW_RES, MAX_STEPS_BONSAI),
                "loop": lambda: [render(pack, c, VIEW_RES, VIEW_RES, MAX_STEPS_BONSAI)
                                 for c in cams],
            }, MESH_BATCH_ROUNDS, torch)
            group = mesh.get_group("tiles")
            frame_ms = interleaved_ms({
                "tiled": lambda: sharding.render_frame_tiled(
                    mesh, None, bench_u, RES, RES, max_steps=MAX_STEPS_BONSAI,
                    renderer=ray_renderer),
                "tiled_eager": lambda: sharding.frame_tiled_step(
                    mesh, *ray_renderer, bench_u, RES, RES, MAX_STEPS_BONSAI),
                "single": lambda: mb.render_bonsai_rays_cuda(
                    vol_bonsai, *geometry.rays_fragment_soa(bench_u, RES, RES)),
                "rays": lambda: geometry.rays_fragment_soa(bench_u, RES, RES),
                "march": lambda: ray_renderer[0](ray_renderer[1], eye, dxyz,
                                                 max_steps=MAX_STEPS_BONSAI),
                "all_gather": lambda: sharding._all_gather(frame_k1, group),
            }, MESH_FRAME_ROUNDS, torch)
            # the rounds replayed the keys held
            check(sharding.VIEWS_STEPS.captures == 2 and sharding.TILED_STEPS.captures == 1,
                  f"phase 4h's timing rounds: captures {sharding.VIEWS_STEPS.captures} (views), "
                  f"{sharding.TILED_STEPS.captures} (frame), not 2 and 1")
            first_groups = sharding.mesh_groups(mesh)
            default_group_ok = None
        finally:
            dist.destroy_process_group()
        # a group made with no backend named (its get_backend() is
        # "undefined"; it carries NCCL on a machine with a card) gives a mesh
        # on the card too; the first group's graphs are never replayed on it:
        # each entry's first call captures again (the new mesh compares
        # equal to the old one, the keys hold the groups) and the old keys go
        dist.init_process_group(init_method=f"file://{tmp}/store_default", world_size=1,
                                rank=0)
        try:
            dmesh = sharding.make_mesh(1, 1, device=dev)
            check(sharding.mesh_device(dmesh) == dev,
                  f"default-backend mesh on {sharding.mesh_device(dmesh)}")
            frames = (sharding.VIEWS_STEPS, sharding.TILED_STEPS, batch_mesh.compiled)
            before = [f.captures for f in frames]
            regroup = []
            for _ in range(2):  # the first call captures, the second replays
                regroup.append((
                    sharding.render_frame_tiled(dmesh, None, bench_u, RES, RES,
                                                max_steps=MAX_STEPS_BONSAI,
                                                renderer=ray_renderer),
                    sharding.render_views_sharded(dmesh, render, pack, cams, VIEW_RES,
                                                  VIEW_RES, max_steps=MAX_STEPS_BONSAI,
                                                  gather=True),
                    sharding.multi_view_step(dmesh, None, VIEWS, VIEW_RES, VIEW_RES,
                                             max_steps=MAX_STEPS_BONSAI, gather=True,
                                             renderer=(render, pack)),
                    batch_mesh(0)))  # made on the first mesh: its groups resolve anew
            new_groups = sharding.mesh_groups(dmesh)
            recaptures = [f.captures - b for f, b in zip(frames, before)]
            key_groups = ([k[0][0] for k in sharding.VIEWS_STEPS.keys()]
                          + [k[0][0] for k in sharding.TILED_STEPS.keys()]
                          + [k[0][-1] for k in batch_mesh.compiled.keys()])
            want5 = batch64(0)
            regroup_ok = all(
                torch.equal(f, frame_k1) and torch.equal(v, batched) and torch.equal(s_, batched)
                and bitwise(b5, want5) for f, v, s_, b5 in regroup)
            check(dmesh == mesh and new_groups != first_groups,
                  "the default-backend mesh should equal the first one on new groups")
            check(recaptures == [1, 1, 1] and all(g == new_groups for g in key_groups)
                  and len(key_groups) == 3,
                  f"after a new group: captures {recaptures}, keys' groups {len(key_groups)} "
                  f"(new: {[g == new_groups for g in key_groups]})")
            check(regroup_ok, "the new group's frames differ from the first group's")
            default_group_ok = dist.get_backend()
            del regroup, want5
        finally:
            sharding.clear_steps()
            dist.destroy_process_group()
    del views_img, batched, batch_mesh, frames
    shard_ms, single_ms, loop_ms = pair_ms["sharded"], pair_ms["single"], pair_ms["loop"]
    tiled_ms, one_frame_ms = frame_ms["tiled"], frame_ms["single"]
    parts = {k: frame_ms[k] for k in ("rays", "march", "all_gather")}
    mesh_times = {"views_sharded_ms": shard_ms, "views_sharded_eager_ms": pair_ms["sharded_eager"],
                  "views_single_ms": single_ms, "views_loop_ms": loop_ms,
                  "frame_tiled_ms": tiled_ms, "frame_tiled_eager_ms": frame_ms["tiled_eager"],
                  "frame_single_ms": one_frame_ms, "frame_parts_ms": parts}
    print(f"phase 4h multi-device ({card}; NCCL world 1, mesh (views 1, tiles 1)): "
          f"render_views_sharded {VIEWS} orbit views {VIEW_RES}^2 gathered, render_frame_tiled "
          f"{RES}^2 bench pose, multi_view_step {VIEWS} views in {path_s:.2f} s (first calls: "
          f"two captures and one eager step), launches "
          f"{mesh_launches}; the views bitwise equal to the single-device batched render and "
          f"to single-view K1 calls, the step to the views, the frame to a K1 call, "
          f"least lit view {v_lit:.4f}; a default-backend group "
          f"(get_backend() {default_group_ok!r}) meshes on {dev}, equal to the first mesh, and "
          f"each entry captures again on its groups (captures {recaptures}), its frames the "
          f"first group's; "
          f"medians of {MESH_BATCH_ROUNDS} interleaved rounds: sharded batch replayed "
          f"{shard_ms:.3f} ms, eager {pair_ms['sharded_eager']:.3f} ms, "
          f"vs the single-device batch {single_ms:.3f} ms ({shard_ms / single_ms:.3f}x) and "
          f"{VIEWS} views one by one {loop_ms:.3f} ms; "
          f"of {MESH_FRAME_ROUNDS}: row-sharded frame replayed {tiled_ms:.4f} ms, eager "
          f"{frame_ms['tiled_eager']:.4f} ms, vs one K1 frame with "
          f"its rays {one_frame_ms:.4f} ms ({tiled_ms / one_frame_ms:.3f}x); its parts rays "
          f"{parts['rays']:.4f}, march {parts['march']:.4f}, all_gather {parts['all_gather']:.4f} "
          f"ms (sum {sum(parts.values()):.4f}); phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    print(f"phase 4h json {json.dumps({'times_ms': mesh_times, 'replays': sharded_rows})}",
          flush=True)

    # -- phase 4n: compiled frames (core/compiled.py) -----------------------
    # every entry's first call captures one CUDA graph per static key, later
    # calls replay it: each replay (3 poses, the fast frame's m and sgn
    # changing between them, 2 times for xor) bitwise against the eager frame
    # on the same inputs, its host syncs, its kernels from a device trace;
    # captures per key and each renderer's graph pool
    t_phase = time.perf_counter()
    # the main paths of phases 3-4m, run again from fresh contexts and
    # renderers under a device trace: each kernel once per frame (the first
    # frame is a graph's warm-up, the others replays)
    def demo_run(demo_cls, w, h, events=True):
        """The demo's main path from a fresh context at its default pose."""
        def fn():
            c = Context(w, h, camera=demo_cls.default_camera(w / h), backbuffer_resolution=(w, h),
                        device="cuda")
            return run(demo_cls, frames=MAIN_FRAMES, context=c, quiet=True,
                       events=orbit_events(MAIN_FRAMES, w, h) if events else None)
        return fn

    def batches(n_views, n):
        b = ViewsBatch(n_views=n_views, view_res=VIEW_RES, dims=VOL5, device=dev)
        return lambda: [b(i) for i in range(n)]

    path_runs = {
        "dense": (lambda: mb.BonsaiRenderer(dense_r.vol, dev)(bench_u, RES, RES), dict(K1=1)),
        "exact": (demo_run(BonsaiDemo, RES, RES), dict(K1=MAIN_FRAMES)),
        "fast": (demo_run(FastDemo, RES, RES), dict(K34=MAIN_FRAMES, K6=MAIN_FRAMES)),
        "hybrid": (demo_run(HybridDemo, RES, RES, events=False),
                   dict(K34=MAIN_FRAMES, K5=MAIN_FRAMES, K2=MAIN_FRAMES)),
        "config 4": (lambda: orbit_model.BonsaiOrbit(vol_bonsai, dev)(),
                     dict(K1=n_orbit, K34=n_hyb, K5=n_hyb, K2=n_hyb)),
        "xor": (demo_run(XorDemo, *XOR_RES), dict(K7=MAIN_FRAMES)),
        f"xor {FIELD_RES}^2": (demo_run(XorDemo, FIELD_RES, FIELD_RES), dict(K7=MAIN_FRAMES)),
        "trig": (demo_run(TrigDemo, *XOR_RES), {}),
        "config 5 (2 batches of 8 views)": (batches(VIEWS_SMOKE, 2), dict(K8=2, K1=2)),
        "config 5 (one full batch)": (batches(VIEWS, 1), dict(K8=1, K1=1)),
    }
    path_traced = {}
    for name, (fn, want) in path_runs.items():
        reset_launches()
        _, path_traced[name] = traced(fn)
        path_check(f"the {name} path", path_traced[name], launches(), **want)
    print(f"phase 4n main paths again, traced ({card}): launches on the device per path "
          + "; ".join(f"{k} {({n: c for n, c in v.items() if c})}" for k, v in path_traced.items())
          + f" ({MAIN_FRAMES} frames a demo path, {n_orbit} poses of config 4 with {n_hyb} "
          f"hybrid-routed)", flush=True)
    del path_runs

    def poses_at(w, h, kws=COMPILED_POSES.values(), target=(0.5, 0.5, 0.5)):
        return [Camera(target=target, aspect=w / h, **kw).uniform(dev) for kw in kws]

    compiled_rows = {}

    def hold(name, compiled, keys, calls, **kernels):
        """``calls``: (replay, eager) pairs, each key captured already. Every
        replay bitwise its eager frame and free of host syncs; the replays'
        kernels from the trace, each of ``kernels`` once a call; ``keys``
        captures."""
        want = [eager() for _, eager in calls]
        got = [synced(replay) for replay, _ in calls]
        equal = sum(bitwise(g[0][0], w) for g, w in zip(got, want))
        syncs = [g[1] for g in got]
        del got, want
        _, on_device = traced_replays(lambda: [replay() for replay, _ in calls])
        row = {"replays": len(calls), "bitwise": equal, "host_syncs": max(syncs),
               "captures": compiled.captures, "keys": keys, "device_launches": on_device,
               "pool_mib": pool_mib(compiled)}
        compiled_rows[name] = row
        print(f"phase 4n {name} ({card}): {keys} keys, captures {compiled.captures}; "
              f"{len(calls)} replays, bitwise the eager frame {equal}/{len(calls)}, host syncs "
              f"per replay {syncs}; launches on the device {on_device}; graph pool "
              f"{row['pool_mib']:.1f} MiB", flush=True)
        check(equal == len(calls) and max(syncs) == 0 and compiled.captures == keys
              and on_device == only(**{k: v * len(calls) for k, v in kernels.items()}),
              f"compiled {name}: {row}")

    # the exact frame at 1024^2 and 1920x1080
    er = mb.BonsaiRenderer(vol_bonsai, dev)
    calls = []
    for w, h in ((RES, RES), (ow, oh)):
        ps = poses_at(w, h)
        er(ps[0], w, h)
        calls += [(lambda u=u, w=w, h=h: er(u, w, h),
                   lambda u=u, w=w, h=h: mb.render_frame(er.vol, u, w, h)) for u in ps]
    hold("exact 1024^2 + 1920x1080", er.compiled, 2, calls, K1=1)
    # the fast frame at I=256 and I=512
    fr = shear_warp.FastBonsaiRenderer(vol_bonsai, dev, intermediate=II)
    ps = poses_at(RES, RES)
    msg = {(int(g.m[0]), int(g.sgn[0])) for g in (shear_warp.fast_geometry(fr.packs, u, RES,
                                                                           RES, II) for u in ps)}
    check(len(msg) == len(ps), f"phase 4n's poses share the fast frame's (m, sgn): {msg}")
    calls = []
    for ii in (256, II):
        fr(ps[0], RES, RES, intermediate=ii)
        calls += [(lambda u=u, ii=ii: fr(u, RES, RES, intermediate=ii),
                   lambda u=u, ii=ii: shear_warp._render_fast(fr.packs, u, RES, RES, ii, True))
                  for u in ps]
    hold(f"fast I=256 + I={II} (m, sgn {sorted(msg)})", fr.compiled, 2, calls, K34=1, K6=1)
    # the hybrid at I=512 / budget 128 (with the escalated route) and at
    # I=1024 / budget 64 (with the functional builder's flag); the route
    # reads the uniforms' host mirrors
    pair = hy._pair_mode(256, RES, RES)
    hr = hy.HybridBonsaiRenderer(vol_bonsai, dev)
    hr_op = hy.HybridBonsaiRenderer(vol_bonsai, dev, intermediate=II_HYBRID, budget=BUDGET_OP)
    esc = poses_at(RES, RES, ESCALATED_POSES)
    routes = {}
    for r, us in ((hr, ps + esc), (hr_op, ps)):
        for u in us:
            shear_warp._HINT_CACHE.clear()
            (route,), n_sync = synced(lambda u=u: r.route(u, RES, RES))
            routes.setdefault(r.intermediate, set()).add(route)
            check(n_sync == 0, f"the hybrid's route made {n_sync} host syncs")
    check(routes == {II: {("hybrid", II, hy.DEFAULT_BUDGET), ("escalated", 768, 192)},
                     II_HYBRID: {("hybrid", II_HYBRID, BUDGET_OP)}},
          f"phase 4n's hybrid routes {routes}")

    def eager_hybrid(r, u, ii, budget):
        return hy._render_hybrid(r.packs, r.vol, u, r.thresh, RES, RES, ii, budget, True,
                                 pair=pair)[0]

    hr(ps[0], RES, RES)
    hr(esc[0], RES, RES)
    calls = [(lambda u=u: hr(u, RES, RES), lambda u=u: eager_hybrid(hr, u, II, 128))
             for u in ps]
    calls += [(lambda u=u: hr(u, RES, RES), lambda u=u: eager_hybrid(hr, u, 768, 192))
              for u in esc]
    hold(f"hybrid I={II} budget 128 + escalated I=768 budget 192", hr.compiled, 2, calls, K34=1,
         K5=1, K2=1)
    frender, fpack = hr_op.functional()
    hr_op(ps[0], RES, RES)
    frender(fpack, ps[0], RES, RES)
    calls = [(lambda u=u: hr_op(u, RES, RES),
              lambda u=u: eager_hybrid(hr_op, u, II_HYBRID, BUDGET_OP)) for u in ps]
    calls += [(lambda u=u: frender(fpack, u, RES, RES),
               lambda u=u: (eager_hybrid(hr_op, u, II_HYBRID, BUDGET_OP),
                            shear_warp.traced_degenerate(u, 256))) for u in ps]
    hold(f"hybrid I={II_HYBRID} budget {BUDGET_OP} + functional", hr_op.compiled, 2, calls,
         K34=1, K5=1, K2=1)
    # the xor frame at 1280x720, 3 poses x 2 times (0-d tensors, as the demo's)
    xw, xh = XOR_RES
    pipe = FieldPipeline(dev)
    xps = poses_at(xw, xh, [dict(zoom=3.0, pitch=-0.5, yaw=y) for y in (1.0, 2.0, 4.0)],
                   target=(0.0, 0.0, 0.0))
    times = [torch.full((), t, dtype=torch.float32, device=dev) for t in (0.0, 1.7)]
    pipe.render(xps[0], times[0], xw, xh)
    calls = [(lambda u=u, t=t: pipe.render(u, t, xw, xh),
              lambda u=u, t=t: mf.render_field(u, t, xw, xh)) for u in xps for t in times]
    hold(f"xor {xw}x{xh} (3 poses x 2 times)", pipe.compiled, 1, calls, K7=1)
    # the compiled field frame (FieldRenderer: render_field_pallas's jit, which
    # bench_field times) at 512^2 around Camera.xor(1.0): the trig field with
    # emission (quantize off) and the noise field with xor shading (analytic
    # normals), 3 poses x t = 0, 1.7 each, one key each
    field_r = mf.FieldRenderer(dev)
    fps = poses_at(FIELD_RES, FIELD_RES, [dict(zoom=3.0, pitch=-0.5, yaw=y)
                                          for y in (1.0, 2.0, 4.0)], target=(0.0, 0.0, 0.0))
    calls = []
    for kw in (dict(field="trig", shading="emission", quantize=False),
               dict(field="noise", shading="xor", grad="analytic")):
        field_r(fps[0], 0.0, FIELD_RES, FIELD_RES, **kw)
        calls += [(lambda u=u, t=t, kw=kw: field_r(u, t, FIELD_RES, FIELD_RES, **kw),
                   lambda u=u, t=t, kw=kw: mf.render_field(u, t, FIELD_RES, FIELD_RES, **kw))
                  for u in fps for t in (0.0, 1.7)]
    hold(f"field frame {FIELD_RES}^2 (trig emission + noise xor, 3 poses x 2 times)",
         field_r.compiled, 2, calls, K7=1)
    # the trig raster at 512^2 and Context.update
    tctx2 = Context(FIELD_RES, FIELD_RES, backbuffer_resolution=(FIELD_RES, FIELD_RES),
                    device="cuda")
    tdemo = TrigDemo.init(tctx2)
    tps = poses_at(FIELD_RES, FIELD_RES, [dict(zoom=1.0 + 0.2 * i, pitch=0.5, yaw=1.0 + i)
                                          for i in range(3)], target=(0.0, 0.0, 0.0))

    def trig_state(u, t):
        tctx2.camera_uniform = u
        tctx2.update(time=t)

    def trig_replay(u, t):
        trig_state(u, t)
        tdemo.render(tctx2)
        return tctx2.render_backbuffer.texture

    def trig_eager(u, t):
        trig_state(u, t)
        g = tctx2.global_uniform
        return trig_eager_frame(u.proj_view, g.time, g.mouse_pressed, FIELD_RES, FIELD_RES)

    trig_replay(tps[0], 0.25)
    calls = [(lambda u=u, t=t: trig_replay(u, t), lambda u=u, t=t: trig_eager(u, t))
             for u, t in zip(tps, (0.25, 1.5, 2.75))]
    hold(f"trig {FIELD_RES}^2 (with Context.update)", tdemo.compiled, 1, calls)
    _, update_syncs = synced(lambda: tctx2.update(time=3.0))
    tctx2.camera.add_yaw(0.1)
    _, update_cam_syncs = synced(lambda: tctx2.update(time=3.5))
    print(f"phase 4n Context.update ({card}): host syncs {update_syncs}, with a camera change "
          f"{update_cam_syncs}", flush=True)
    check(update_syncs == 0 and update_cam_syncs == 0, "Context.update syncs with the host")
    # present with its three filters (the exact frames above as HDR input)
    pr = Presenter()
    hdrs = [mb.render_frame(vol_bonsai, u, RES, RES) for u in ps]
    calls = []
    for oh_, ow_, filt in ((RES, RES, "linear"), (1440, 1920, "linear"),
                           (1440, 1920, "quadratic"), (1440, 1920, "bicubic")):
        pr(hdrs[0], oh_, ow_, filter=filt)
        calls += [(lambda x=x, oh_=oh_, ow_=ow_, filt=filt: pr(x, oh_, ow_, filter=filt),
                   lambda x=x, oh_=oh_, ow_=ow_, filt=filt: present(x, oh_, ow_, filter=filt))
                  for x in hdrs]
    hold("present (linear 1024^2, linear / quadratic / bicubic 1440x1920)", pr.compiled, 4,
         calls)
    # config 4's orbit (phase 4l's renderers, captured there): a second pass
    orbit_eager = []
    for i, u in enumerate(orb.poses):
        img_e = mb.render_frame(orb.exact.vol, u, ow, oh)
        hyb_e = (img_e if i not in hyb_idx else hy._render_hybrid(
            orb.hybrid.packs, orb.hybrid.vol, u, orb.hybrid.thresh, ow, oh,
            orbit_model.INTERMEDIATE, orbit_model.BUDGET, True, pair=pair4)[0])
        orbit_eager.append((img_e, hyb_e))
    (frames4,), orbit_syncs = synced(orb)
    orbit_equal = sum(torch.equal(f, e[0]) + torch.equal(g, e[1]) for f, g, e in
                      zip(frames4.exact, frames4.hybrid, orbit_eager))
    _, orbit_replayed = traced(orb)
    del frames4, orbit_eager
    compiled_rows["config 4"] = {"replays": 2 * n_orbit, "bitwise": orbit_equal,
                                 "host_syncs": orbit_syncs,
                                 "captures": orb.hybrid.compiled.captures, "keys": 3,
                                 "device_launches": orbit_replayed,
                                 "pool_mib": pool_mib(orb.hybrid.compiled)}
    print(f"phase 4n config 4 ({card}; BonsaiOrbit's second pass, {n_orbit} poses {ow}x{oh}): "
          f"captures {orb.hybrid.compiled.captures} (exact, hybrid, and phase 4l's functional "
          f"frames of the degenerate poses); frames bitwise the eager "
          f"ones {orbit_equal}/{2 * n_orbit}; host syncs per pass {orbit_syncs}; launches on "
          f"the device {orbit_replayed}; graph pool "
          f"{compiled_rows['config 4']['pool_mib']:.1f} MiB", flush=True)
    check(orbit_equal == 2 * n_orbit and orbit_syncs == 0 and orb.hybrid.compiled.captures == 3
          and orbit_replayed == only(K1=n_orbit, K34=n_hyb, K5=n_hyb, K2=n_hyb),
          f"compiled config 4: {compiled_rows['config 4']}")
    # config 5: batches 1 and 2 replay phase 4m's graph
    calls = [(lambda b=b: batch64(b),
              lambda b=b: batch64.step(torch.full((), 0.3 * b, dtype=torch.float32,
                                                  device=dev))) for b in (1, 2)]
    hold(f"config 5 batch step ({VIEWS} views {VIEW_RES}^2 + K8 {VOL5}^3)", batch64.compiled,
         1, calls, K8=1, K1=1)
    del er, fr, hr, hr_op, pipe, field_r, tdemo, tctx2, pr, hdrs, calls, frender, fpack
    print(f"phase 4n json {json.dumps(compiled_rows)}", flush=True)
    print(f"phase 4n compiled frames: phase {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- phase 4i: hot reload of K7 on the card ------------------------------
    # a copy of march_field.cu and its headers; the repository's csrc is never
    # edited. The watcher is driven with poll_once (its thread is stopped so
    # that it cannot take an edit first). Three of the four frames capture
    # their library's graph (K7 runs once, in the warm-up), the fourth (kept,
    # after a failed build) replays the last good one: its K7 is counted
    # from that graph's own kernel nodes, read through the CUDA driver, and
    # its trace must agree unless the trace came back with no device record
    # at all (CUPTI has returned such a session for this replay, never for a
    # capture; --hot-reload-repeats counts them); the frame, bitwise
    # the changed one, which the graph's output buffer never held before,
    # proves that the replay ran
    def hot_reload():
        """Phase 4i's sequence once: ``(the builds' CompileResults, the
        kernels on the device per frame, the wrappers' counts, the frames
        whose trace held no device record, the watched files)``."""
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "march_field.cu")
            shutil.copy(mf.SOURCE, src)
            for header in kbuild.included_headers(mf.SOURCE):
                shutil.copy(header, tmp)
            original = open(src).read()

            def edit(text):
                with open(src, "w") as f:
                    f.write(text)
                st = os.stat(src)
                os.utime(src, (st.st_atime, st.st_mtime + 2))

            rctx = Context(FIELD_RES, FIELD_RES, camera=XorDemo.default_camera(1.0),
                           backbuffer_resolution=(FIELD_RES, FIELD_RES), watch=True,
                           device="cuda")
            check(rctx.watcher._thread is not None and rctx.watcher._thread.is_alive(),
                  "Context(watch=True) runs no watcher thread")
            demo = XorDemo.init(rctx, source=src)
            rctx.watcher.stop()
            watched = sorted(os.path.basename(p) for p in rctx.watcher.registry)
            per_frame, unrecorded = {}, []

            def xor_frame(name):
                if name == "kept":  # the last good library's graph, replayed
                    _, on_device, empty = replayed(lambda: demo.render(rctx),
                                                   demo.pipeline.compiled, "the kept frame")
                else:
                    _, events = profiler.device_events(lambda: demo.render(rctx))
                    counts = profiler.count_kernels(events, list(KERNEL_NAMES.values()))
                    on_device = {k: counts[v] for k, v in KERNEL_NAMES.items()}
                    empty = not events
                if empty:
                    unrecorded.append(name)
                per_frame[name] = on_device
                return rctx.render_backbuffer.texture.clone()

            reset_launches()
            base, lib0 = xor_frame("base"), demo.pipeline.lib
            edited = original.replace("const float v = val * 0.5f;",
                                      "const float v = val * 0.75f;")
            check(edited != original, "the shading constant to edit is not in march_field.cu")
            # a comment unique to this run: its library is never one an earlier run
            # built, so the rebuild's seconds are nvcc's
            edited += f"// hot-reload edit {os.getpid()} {time.time_ns()}\n"
            edit(edited)
            (res_edit,) = rctx.watcher.poll_once()
            check(res_edit.ok and demo.pipeline.lib is res_edit.compiled
                  and res_edit.compiled._name != lib0._name,
                  f"the edit did not load a new library: {res_edit.error[-500:]}")
            changed = xor_frame("changed")
            check(not torch.equal(changed, base), "the edited constant did not change the frame")
            edit(edited + "\nthis is not C++ ][\n")
            (res_bad,) = rctx.watcher.poll_once()
            check(not res_bad.ok and "error" in res_bad.error
                  and demo.pipeline.lib is res_edit.compiled,
                  "a syntax error did not return nvcc's diagnostics")
            kept = xor_frame("kept")
            check(torch.equal(kept, changed),
                  "after a failed build the frame is not the last good one")
            edit(original)
            (res_back,) = rctx.watcher.poll_once()
            restored = xor_frame("restored")
            torch.cuda.synchronize()
            wrappers = launches()
            check(res_back.ok and torch.equal(restored, base),
                  "the restored source's frame differs")
            unedited = mf.render_field(rctx.camera_uniform, demo.gen_time, FIELD_RES, FIELD_RES)
            check(torch.equal(restored, unedited),
                  "the restored frame is not the unedited K7 frame")
        return (res_edit, res_bad, res_back), per_frame, wrappers, unrecorded, watched

    t_phase = time.perf_counter()
    empty_traces = []
    for rep in range(reload_repeats):
        (res_edit, res_bad, res_back), by_frame, reload_launches, unrecorded, watched = \
            hot_reload()
        reload_traced = {k: sum(f[k] for f in by_frame.values()) for k in KERNEL_NAMES}
        k7_frames = {name: f["K7"] for name, f in by_frame.items()}
        check(list(k7_frames.values()) == [1, 1, 1, 1],
              f"the hot reload path (repetition {rep}) launched K7 {k7_frames} times on the "
              f"device, not once a frame")
        path_check(f"the hot reload path (repetition {rep})", reload_traced, reload_launches,
                   K7=4)
        empty_traces += [(rep, name) for name in unrecorded]
    if reload_repeats > 1:
        print(f"phase 4i repetitions ({card}): {reload_repeats} in a row, K7 4 times "
              f"in each (once a frame); traces with no device record (repetition, frame): "
              f"{empty_traces}", flush=True)
    diag = next((ln.strip() for ln in res_bad.error.splitlines() if "error" in ln), "")
    print(f"phase 4i hot reload ({card}; XorDemo {FIELD_RES}^2 on a copy of march_field.cu, "
          f"watching {watched}): edit rebuild {res_edit.seconds:.2f} s -> "
          f"{os.path.basename(res_edit.compiled._name)}, frame changed; syntax error "
          f"{res_bad.seconds:.2f} s, diagnostics \"{diag[:160]}\", frame kept bitwise (a "
          f"replay); restore {res_back.seconds:.2f} s (its library built before), frame bitwise "
          f"the unedited K7 frame (each library's frames a graph of its own); K7 on the device "
          f"per frame {k7_frames} (the replay's from its graph's kernel nodes), traces with no "
          f"device record {unrecorded}; launches on the device {reload_traced} (wrappers "
          f"{reload_launches}); phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    reload_s = {"edit": res_edit.seconds, "syntax_error": res_bad.seconds,
                "restore": res_back.seconds}

    # -- phase 4j: state, trace, present filters ------------------------------
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        sctx = Context(RES, RES, camera=BonsaiDemo.default_camera(1.0),
                       backbuffer_resolution=(RES, RES), device="cuda")
        reset_launches()
        state_traced = only()

        def run_traced(**kw):
            out, on_device = traced(lambda: run(BonsaiDemo, context=sctx, quiet=True, **kw))
            for k, v in on_device.items():
                state_traced[k] += v
            return out

        sctx = run_traced(frames=2, events=orbit_events(2, RES, RES))
        saved = sctx.display_image.clone()
        save_state(sctx, os.path.join(tmp, "state.json"))
        sctx = run_traced(frames=2, events=orbit_events(2, RES, RES))
        moved = not torch.equal(sctx.display_image, saved)
        load_state(sctx, os.path.join(tmp, "state.json"))
        sctx = run_traced(frames=1)
        state_launches = launches()
        check(moved and torch.equal(sctx.display_image, saved),
              "the restored state does not reproduce the saved frame bitwise")
        path_check("the state path", state_traced, state_launches, K1=5)
        sdemo = BonsaiDemo.init(sctx)
        with profiler.trace(os.path.join(tmp, "trace")) as prof:
            sdemo.render(sctx)
            sctx.render()
            torch.cuda.synchronize()
        with open(prof.trace_path) as f:
            trace_text = f.read()
        check("march_bonsai_kernel" in trace_text,
              "the device trace does not name K1's kernel (march_bonsai_kernel)")
        trace_kib = len(trace_text) / 1024.0
    hdr = sctx.render_backbuffer.texture
    hdr_cpu = hdr.cpu()
    filt_err = {}
    for filt in ("quadratic", "bicubic"):
        for oh, ow in ((RES, RES), (1440, 1920)):
            d = (present(hdr, oh, ow, filter=filt).cpu()
                 - present(hdr_cpu, oh, ow, filter=filt)).abs().max()
            filt_err[f"{filt} {oh}x{ow}"] = float(d)
    check(max(filt_err.values()) <= 1e-5, f"present filters on the card vs the CPU: {filt_err}")
    print(f"phase 4j state/trace/present ({card}): save after 2 exact frames {RES}^2, 2 more "
          f"orbit frames, restore: next frame bitwise the saved one through the graph path "
          f"(launches on the device {state_traced}, wrappers {state_launches}); profiler.trace "
          f"of one exact frame names march_bonsai_kernel "
          f"({trace_kib:.0f} KiB Chrome trace); present(filter=) on the card vs the CPU, max "
          f"|d| {filt_err} (limit 1e-5); phase {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- phase 4k: native I/O and the terminal viewer -------------------------
    t_phase = time.perf_counter()
    frame_u8 = to_uint8(sctx.display_image).cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        write_png(os.path.join(tmp, "n.png"), frame_u8, backend="native")
        write_png(os.path.join(tmp, "p.png"), frame_u8, backend="python")
        with open(os.path.join(tmp, "n.png"), "rb") as f:
            png_native = f.read()
        with open(os.path.join(tmp, "p.png"), "rb") as f:
            png_python = f.read()
        check(png_native == png_python, "the native PNG's bytes differ from the Python encoder's")
        check(np.array_equal(read_png(os.path.join(tmp, "n.png")), frame_u8),
              "the native PNG does not decode to the frame")
        rec = native.NativeRecorder()
        rec.screenshot(os.path.join(tmp, "shot.png"), frame_u8)
        rec.close()
        check(np.array_equal(read_png(os.path.join(tmp, "shot.png")), frame_u8),
              "NativeRecorder's screenshot does not decode to the frame")
        t0 = time.perf_counter()
        viewer = subprocess.run(
            [sys.executable, os.path.join(ROOT, "examples", "interactive_torch.py"),
             "--frames", "3"], cwd=tmp, stdin=subprocess.DEVNULL, capture_output=True,
            text=True, timeout=300)
        viewer_s = time.perf_counter() - t0
    check(viewer.returncode == 0 and "scripted orbit" in viewer.stdout,
          f"interactive_torch.py exited {viewer.returncode}: {viewer.stderr[-2000:]}")
    print(f"phase 4k native I/O ({card}): libvokselis_native built (or loaded) in phase 2 in "
          f"{native_s:.2f} s "
          f"({os.path.relpath(native.library_path(), ROOT)}); native PNG of the {RES}^2 frame "
          f"({len(png_native)} bytes) byte-equal to the Python encoder's and decodes to the "
          f"frame; NativeRecorder screenshot decodes to the frame; interactive_torch.py "
          f"--frames 3 without a tty on the card: exit 0 in {viewer_s:.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del sctx, saved, hdr, hdr_cpu

    # -- phase 6: the port's bench entry points, each in a process of its own:
    # vokselis_torch.bench (bench.py's flagship invocation and its default
    # rows) and vokselis_torch.tools.multichip_bench at world 1. A non-zero
    # exit, a timeout or a line that does not parse fails the run ---------
    t_phase = time.perf_counter()

    def tool(args, timeout, env=None):
        """``python -m args`` from the checkout's root (``env`` added to the
        environment): its stdout lines, its stderr printed under this
        phase."""
        proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
                              text=True, timeout=timeout, env={**os.environ, **(env or {})})
        for line in proc.stderr.splitlines():
            print(f"phase 6 {args[0]} stderr: {line}", flush=True)
        check(proc.returncode == 0, f"python -m {' '.join(args)} exited {proc.returncode}")
        return proc.stdout.splitlines()

    t0 = time.perf_counter()
    out = tool(["vokselis_torch.bench"], BENCH_TIMEOUT_S)
    bench_s = time.perf_counter() - t0
    check(len(out) == 1, f"vokselis_torch.bench printed {len(out)} stdout lines, not one")
    line = json.loads(out[0])
    # bench.py:476-504: the hybrid headlines only when its error is within 1e-3;
    # the default rows always time the hybrid, so the exact branch carries it
    if "exact_mrays" in line:
        check(list(line) == BENCH_KEYS_HYBRID and line["mean_err"] <= HYBRID_CONTRACT
              and line["exact_mean_err"] <= HYBRID_CONTRACT, f"the bench line {line}")
    else:
        check(list(line) == BENCH_KEYS_EXACT and line["hybrid_mean_err"] > HYBRID_CONTRACT
              and line["mean_err"] <= HYBRID_CONTRACT, f"the bench line {line}")
    bench_ms = {k: v for k, v in line.items() if k.endswith("_ms")}
    check(all(math.isfinite(v) and v > 0 for v in bench_ms.values()),
          f"the bench line's times {bench_ms}")
    t0 = time.perf_counter()
    out = tool(["vokselis_torch.tools.multichip_bench", "--json"], MULTICHIP_TIMEOUT_S)
    multichip_s = time.perf_counter() - t0
    rows = [json.loads(x) for x in out if x.startswith("{")]
    check([(r["mode"], r["chips"], list(r)) for r in rows] == MULTICHIP_ROWS
          and all(math.isfinite(r["mrays_s"]) and r["mrays_s"] > 0 for r in rows)
          and rows[0]["weak_efficiency"] == 1.0 and rows[1]["speedup"] == 1.0,
          f"multichip_bench's world-1 rows {rows}")
    print(f"phase 6 bench ({card}): python -m vokselis_torch.bench exit 0 in {bench_s:.1f} s, "
          f"line {json.dumps(line)}; beside phase 5 (replayed, one call between CUDA events, "
          f"median): exact demo frame (update + render + present) "
          f"{frames_ms['exact']['replay']:.4f} ms, hybrid renderer call I={II_HYBRID} budget "
          f"{BUDGET_OP} {hyb_rows[II_HYBRID]['whole hybrid frame (renderer call)']:.4f} ms, K1 "
          f"device {k1_dev:.4f} ms", flush=True)
    print(f"phase 6 multichip_bench ({card}; NCCL world 1): exit 0 in {multichip_s:.1f} s, rows "
          f"{json.dumps(rows)}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)

    # the hybrid's measuring tools, side by side, each in a process of its own
    t0 = time.perf_counter()
    tools_dir = tempfile.mkdtemp(prefix="vokselis-tools-")
    tool_runs = {
        "hybrid_operating_point": (
            ["--ii", str(II_HYBRID), "--budgets", ",".join(map(str, TOOL_BUDGETS)),
             "--out", os.path.join(tools_dir, "oppoint.json"), "--out-dir", tools_dir],
            {"VOK_OPPOINT_REPEATS": "1"}),
        "residual_decay": (
            ["--ii", str(II_HYBRID), "--poses", ",".join(DECAY_POSES), "--budgets",
             ",".join(map(str, DECAY_BUDGETS)), "--out-dir", tools_dir], None),
        "fast_error_report": (["--ii", "256"], None),
        "dense_stress_probe": (["--poses", "bench", "--out-dir", tools_dir], None),
        "contact_sheet": ([os.path.join(tools_dir, "sheet.png")], None),
    }
    with ThreadPoolExecutor(len(tool_runs)) as pool:
        futures = {k: pool.submit(tool, [f"vokselis_torch.tools.{k}", *a], TOOLS_TIMEOUT_S, e)
                   for k, (a, e) in tool_runs.items()}
        tool_out = {k: f.result() for k, f in futures.items()}
    tools_s = time.perf_counter() - t0
    with open(os.path.join(tools_dir, "oppoint.json")) as f:
        op = json.load(f)
    check(json.loads(tool_out["hybrid_operating_point"][-1]) == op,
          "hybrid_operating_point's last line is not its JSON")
    ladder = {r["budget"]: r for r in op["ladder"]}
    op_ms = [m for r in op["ladder"] for m in [r["ms"], *r["ms_reps"]]]
    op_ms += [op["drift_sentinel"]["end_ms"]]
    bench_hyb_err = line["mean_err"] if "exact_mrays" in line else line["hybrid_mean_err"]
    check(list(op) == OPPOINT_KEYS and sorted(ladder) == sorted(TOOL_BUDGETS)
          and all(math.isfinite(m) and m > 0 for m in op_ms)
          and line["hybrid_budget"] == 64
          and ladder[64]["errs"]["bench"] == bench_hyb_err,
          f"hybrid_operating_point: keys {list(op)}, ladder {op['ladder']}, the bench's "
          f"hybrid error {bench_hyb_err} at budget {line['hybrid_budget']}")
    # its timed frame, replayed once a budget here under a trace: K2 as the budget says
    bench_u1 = Camera.bonsai(1.0).uniform(dev)
    op_launches, op_unrecorded = {}, []
    for b in TOOL_BUDGETS:
        hyb_b = hy.HybridBonsaiRenderer(vol_bonsai, dev, intermediate=II_HYBRID, budget=b)
        frame_b = hybrid_operating_point.replay_frame(hyb_b, bench_u1, RES)
        frame_b()  # the capture
        _, op_launches[b], empty = replayed(frame_b, hyb_b.compiled, f"the budget-{b} frame")
        if empty:
            op_unrecorded.append(b)
        del hyb_b, frame_b
    check(all(op_launches[b] == only(K34=1, K5=1, K2=int(b > 0)) for b in TOOL_BUDGETS),
          f"the ladder's replayed frames launched {op_launches}")
    with open(os.path.join(tools_dir, f"residual_decay_{II_HYBRID}.json")) as f:
        decay = json.load(f)
    check(list(decay) == list(DECAY_POSES) and all(
        [p["budget"] for p in r["curve"]] == list(DECAY_BUDGETS)
        and all(p["oracle"] <= p["actual"] for p in r["curve"])
        and r["curve"][0]["oracle"] == r["curve"][0]["actual"] == r["total_fast_err"]
        for r in decay.values()), f"residual_decay's curves {decay}")
    fast_rows = [ln.split("|")[1:-1] for ln in tool_out["fast_error_report"]
                 if ln.startswith("| 256 | ") and ln.count("|") == 6]
    fast_means = {r[1].strip(): float(r[2]) for r in fast_rows}
    check(sorted(fast_means) == sorted(FAST_ERR[256]) and all(
        fast_means[k] <= FAST_ERR_SLACK * FAST_ERR[256][k][0] for k in fast_means),
        f"fast_error_report's I=256 means {fast_means} against 1.25x {FAST_ERR[256]}")
    with open(os.path.join(tools_dir, "dense_stress.json")) as f:
        dense_tool = json.load(f)
    check(all(math.isfinite(dense_tool[k]) for k in dense_tool if k.endswith("_err"))
          and all(math.isfinite(dense_tool[k]) and dense_tool[k] > 0
                  for k in ("exact_ms", "fast_ms", "hybrid_ms")),
          f"dense_stress_probe {dense_tool}")
    sheet = read_png(os.path.join(tools_dir, "sheet.png"))
    check(sum(" done" in ln for ln in tool_out["contact_sheet"]) == 16
          and sheet.shape[:2] == (2 * 256, 8 * 256) and sheet.max() > 0,
          f"contact_sheet: {sheet.shape}")
    shutil.rmtree(tools_dir)
    print(f"phase 6 hybrid tools ({card}; side by side in {tools_s:.1f} s, processes of their "
          f"own): hybrid_operating_point I={II_HYBRID} budgets {list(TOOL_BUDGETS)}, one repeat: "
          f"ms {[ladder[b]['ms'] for b in TOOL_BUDGETS]}, bench-pose error at 64 "
          f"{ladder[64]['errs']['bench']} (the bench line's {bench_hyb_err}), fit "
          f"{op['fit']}, choice {(op['operating_point'] or {}).get('budget')} ({op['note']}); "
          f"its frames replayed here: K2 {[op_launches[b]['K2'] for b in TOOL_BUDGETS]} (graph "
          f"nodes; traces with no device record at budgets {op_unrecorded}); "
          f"residual_decay {json.dumps(decay)}; fast_error_report I=256 means {fast_means}; "
          f"dense_stress_probe {json.dumps(dense_tool)}; contact_sheet {sheet.shape}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    def entry(name, source, replaces, n_launches, err, dev, call, plain_ms, bound, lib=None):
        """One kernel's line: ``launches`` its wrapper's count on the main
        path (a compiled frame's warm-up and capture), ``device_launches``
        the path's launches on the device (every frame, replays included);
        ``ms`` and ``call_ms`` are one wrapper call's time, ``device_ms`` the
        kernel's own; ``lib`` the (device, call) times of one PyTorch call
        computing the same function, where there is one. ``n_launches``:
        (wrapper's count, device's count)."""
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n_launches[0], "device_launches": n_launches[1],
                "max_abs_err": err, "ms": call, "device_ms": dev,
                "call_ms": call, "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": None if lib is None else lib[0],
                "library_call_ms": None if lib is None else lib[1]}

    k7_modes = {k: {"device_ms": k7_dev[k], "call_ms": k7_ms[k], "plain_ms": k7p_ms[k],
                    "bound_ms": k7_bound[k][0], "samples": k7_samples[k],
                    "lane_efficiency": k7_lanes[k]} for k in k7_dev}
    kernels = [
        dict(entry("march_bonsai", "vokselis_torch/csrc/march_bonsai.cu",
                   "vokselis_tpu/ops/pallas/march_bonsai.py:131",
                   (exact_launches["K1"], path_traced["exact"]["K1"]),
                   worst["K1"], k1_dev, k_ms, p_ms, k1_bound),
             launches_multi_device=mesh_launches["K1"], multi_device=mesh_times,
             launches_config4=path_traced["config 4"]["K1"], config4_ms=orbit_ms,
             config4_device_ms=orbit_k1_dev,
             launches_config5=path_traced["config 5 (one full batch)"]["K1"],
             config5={"batch_ms": c5_ms, "per_view_loop_ms": c5_pair["per-view loop"],
                      "batch_device_ms": c5_dev, "batch_host_syncs": c5_syncs,
                      "batch_rays_device_ms": c5_batch_rays[0],
                      "batch_rays_call_ms": c5_batch_rays[1], "batch_k1_device_ms": c5_batch_k1,
                      "peak_mib": c5_peak, "view_device_ms": c5_view_dev,
                      "view_call_ms": c5_view_ms},
             launches_dense=path_traced["dense"]["K1"],
             dense={"device_ms": dense_dev, "frame_ms": dense_ms,
                    "skip_share": dense_skipped / dense_steps, "bound_ms": dense_bound[0],
                    "bound_by": dense_bound[1]}),
        entry("resample_slabs", "vokselis_torch/csrc/shear_resample.cu",
              "vokselis_tpu/ops/pallas/shear_resample.py:117",
              (fast_launches["K3"], path_traced["fast"]["K3"]),
              worst["K3"], dev_ms["K3"], k3_ms, k3p_ms, k3_bound,
              (dev_ms["grid_sample K3"], lib3_ms)),
        entry("composite", "vokselis_torch/csrc/shear_resample.cu",
              "vokselis_tpu/ops/pallas/shear_resample.py:236",
              (fast_launches["K4"], path_traced["fast"]["K4"]),
              worst["K4"], dev_ms["K4"], k4_ms, k4p_ms, k4_bound),
        dict(entry("resample_composite", "vokselis_torch/csrc/shear_resample.cu",
                   "vokselis_tpu/ops/pallas/shear_resample.py:402",
                   (fast_launches["K34"], path_traced["fast"]["K34"]),
                   worst["K34"], k34_main["device"], k34_main["call"], k34p_ms,
                   k34_main["bound"]),
             launches_config4=path_traced["config 4"]["K34"],
             modes={f"I={ii} {t}": {"device_ms": r["device"], "call_ms": r["call"],
                                    "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                                    "texels": r["texels"], "samples": r["samples"],
                                    "shaded": r["shaded"],
                                    "pair_device_ms": pair34[(ii, t)]["pair device"],
                                    "pair_call_ms": pair34[(ii, t)]["pair call"]}
                    for (ii, t), r in k34.items()}),
        entry("warp_bilinear", "vokselis_torch/csrc/warp2d.cu",
              "vokselis_tpu/ops/pallas/warp2d.py:218",
              (fast_launches["K6"], path_traced["fast"]["K6"]),
              worst["K6"], dev_ms["K6"], k6_ms, k6p_ms, k6_bound,
              (dev_ms["grid_sample K6"], lib6_ms)),
        dict(entry("march_tiles", "vokselis_torch/csrc/march_bonsai.cu",
                   "vokselis_tpu/ops/pallas/march_bonsai.py:1021",
                   (hyb_launches["K2"], path_traced["hybrid"]["K2"]),
                   worst["K2"], hyb_rows[II]["K2 device"], hyb_rows[II]["K2"], k2p_ms,
                   k2_bound), launches_config4=path_traced["config 4"]["K2"]),
        # grid_sample computes K5's warp but none of its tile statistics: no library time
        dict(entry("warp_stats", "vokselis_torch/csrc/warp2d.cu",
                   "vokselis_tpu/ops/pallas/warp2d.py:470",
                   (hyb_launches["K5"], path_traced["hybrid"]["K5"]),
                   worst["K5"], hyb_rows[II]["K5 device"], hyb_rows[II]["K5"], k5p_ms,
                   k5_bound),
             launches_config4=path_traced["config 4"]["K5"],
             modes={f"I={ii}": {"device_ms": hyb_rows[ii]["K5 device"],
                                "call_ms": hyb_rows[ii]["K5"], "bound_ms": k5_bounds[ii][0],
                                "bound_by": k5_bounds[ii][1], "ok_pixels": k5_ok[ii],
                                "texels_tapped": k5_texels[ii]}
                    for ii in (II, II_HYBRID)}),
        dict(entry("march_field", "vokselis_torch/csrc/march_field.cu",
                   "vokselis_tpu/ops/pallas/march_field.py:61",
                   (xor_runs[XOR_RES][1]["K7"], path_traced["xor"]["K7"]),
                   worst["K7"], k7_dev["xor analytic"], k7_ms["xor analytic"],
                   k7p_ms["xor analytic"], k7_bound["xor analytic"]), modes=k7_modes,
             launches_hot_reload=reload_traced["K7"], rebuild_s=reload_s),
        entry("genvol", "vokselis_torch/csrc/genvol.cu", "vokselis_tpu/ops/pallas/genvol.py:27",
              (tex_launches["K9"], tex_launches["K9"]), worst["K9"], k9_dev, k9_ms, k9p_ms,
              k9_bound),
        dict(entry("gendensity", "vokselis_torch/csrc/genvol.cu",
                   "vokselis_tpu/ops/pallas/genvol.py:86",
                   (c5_launches["K8"], path_traced["config 5 (2 batches of 8 views)"]["K8"]),
                   worst["K8"],
                   k8_dev, k8_ms, k8p_ms, k8_bound),
             launches_config5=path_traced["config 5 (one full batch)"]["K8"]),
    ]
    print(f"chip_smoke total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
