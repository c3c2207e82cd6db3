"""Driver of the batch cells: config 5's ``ViewsBatch`` step in a closed loop.

``vokselis_torch.models.views.ViewsBatch(n_views, view_res, dims)`` is
called for batch steps b0, b0 + 1, ... (b0 from the traffic's generator),
one batch in flight: the driver waits for each batch to finish and stamps
the host clock. The first ``warmup_batches`` are set-up (the first captures
the step's graph). A traced run then profiles :data:`PROFILED_BATCHES`
batches with ``torch.profiler``.

``correct`` compares one batch of the window, drawn from the seed, with the
reference: the regenerated volume voxel for voxel, and every view.
"""

from __future__ import annotations

import gc
import importlib
import math
import random
import time

import torch

from benchmark import reduce
from benchmark.reference import camera, density, march
from benchmark.roofline import bound_s, k1, k8

SAMPLED_BATCHES = 1
PROFILED_BATCHES = 3
PROFILER_SETTLE_BATCHES = 2
K1_NAME, K8_NAME = "march_bonsai_kernel", "gendensity_kernel"
TINY = {"n_views": 4, "view_res": 16, "dims": 32}  # the CPU tests' size
CONTROL_SIZE = TINY  # the control's volume misses voxels at this size already


class ViewsBatchLoop:
    def __init__(self, cfg: dict, mix: dict, seed: int, device="cuda"):
        self.cfg, self.seed = cfg, seed
        self.device = torch.device(device)
        self.steps = importlib.import_module(f"benchmark.traffic.{mix['kind']}").make(mix, seed)
        self.n_views, self.res, self.dims = cfg["n_views"], cfg["view_res"], cfg["dims"]
        self.answers = []  # (b, volume, views) sampled from the window

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def time_of(self, b: int) -> float:
        return self.cfg["time_per_batch"] * b

    def measure(self, seconds: float, trace: bool, t_start: float) -> dict:
        from vokselis_torch.models.views import ViewsBatch

        traced = trace and self.device.type == "cuda"
        vb = ViewsBatch(self.n_views, self.res, self.dims, device=self.device)
        rng = random.Random(self.seed)
        k = 0
        for k in range(self.steps.warmup):
            vb(self.steps.step(k))
            self._sync()
        stamps = [time.perf_counter()]
        while stamps[-1] - stamps[0] < seconds:
            k += 1
            b = self.steps.step(k)
            vol, views = vb(b)
            self._sync()
            stamps.append(time.perf_counter())
            i = len(stamps) - 2
            j = i if i < SAMPLED_BATCHES else rng.randrange(i + 1)
            if j < SAMPLED_BATCHES:
                if j < len(self.answers):
                    self.answers[j] = (b, vol, views)
                else:
                    self.answers.append((b, vol, views))
            del vol, views
        rec = {"setup_s": stamps[0] - t_start, "stamps": stamps, "unit": "batch",
               "attempted": len(stamps) - 1,
               "rays_per_unit": self.n_views * self.res * self.res,
               "memory_peak_bytes": (torch.cuda.max_memory_allocated(self.device)
                                     if self.device.type == "cuda" else 0)}
        if traced:
            from torch.profiler import ProfilerActivity, profile, record_function

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
            for _ in range(PROFILER_SETTLE_BATCHES):
                k += 1
                vb(self.steps.step(k))
                self._sync()
            profiled = []
            with record_function(reduce.WINDOW_SPAN):
                for _ in range(PROFILED_BATCHES):
                    k += 1
                    profiled.append(self.steps.step(k))
                    with record_function("batch.step"):
                        vb(profiled[-1])
                    with record_function("client.wait"):
                        self._sync()
            prof.stop()
            summary = reduce.profile_window(prof.events())
            rec["profile"] = summary
            if summary is not None:
                rec["profile_units"] = PROFILED_BATCHES
                rec["kernels"] = {"K1": reduce.kernel(summary, K1_NAME),
                                  "K8": reduce.kernel(summary, K8_NAME)}
                del vb
                self.release()
                rec["bounds"] = self._bounds(profiled)
        return rec

    def _cams(self):
        """Each view's (view_position, inv_proj) on the device: yaw 2 pi i / n,
        zoom 1, pitch 0.5 about the box centre, aspect 1."""
        out = []
        for i in range(self.n_views):
            vp, inv = camera.Pose(2.0 * math.pi * i / self.n_views, 0.5, 1.0).matrices()
            out.append((torch.from_numpy(vp).to(self.device), torch.from_numpy(inv).to(self.device)))
        return out

    def _rays(self):
        eyes, dirs = [], []
        for vp, inv in self._cams():
            e, d = march.rays(vp, inv, self.res, self.res)
            eyes.append(e.expand(d.shape))
            dirs.append(d)
        return torch.cat(eyes), torch.cat(dirs)

    def _bounds(self, steps) -> dict:
        """Seconds: the K1 and K8 bounds summed over the batch ``steps``."""
        eye, dirs = self._rays()
        k1_s = k8_s = 0.0
        for b in steps:
            vol = density.density_u8(self.time_of(b), self.dims, self.device)
            n = int(march.touched_samples(vol, eye, dirs, march.max_steps(self.dims)).sum())
            k1_s += bound_s(k1.frame_bytes(self.dims, self.res, self.res, self.n_views), k1.ops(n))
            k8_s += bound_s(k8.volume_bytes(self.dims), k8.ops(self.dims, self.time_of(b)))
        return {"K1": k1_s, "K8": k8_s}

    def release(self):
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, dtype=torch.float32) -> list:
        """The reference's (volume, views) of each sampled batch."""
        out = []
        eye, dirs = self._rays()
        for b, _, _ in self.answers:
            vol = density.density_u8(self.time_of(b), self.dims, self.device, dtype)
            views = march.march(vol, eye, dirs, march.max_steps(self.dims), dtype)
            out.append((vol, views.reshape(self.n_views, self.res, self.res, 4)))
        return out

    def program_outputs(self) -> list:
        return [(vol, views) for _, vol, views in self.answers]

    def control_answers(self) -> list:
        """Answers (their outputs None) whose reference the control test
        recomputes in bfloat16 and float32 at :data:`CONTROL_SIZE`."""
        return [(self.steps.step(k), None, None) for k in (0, 7)]

    @staticmethod
    def compare(output, against) -> dict:
        """The numbers ``correct`` compares for one batch: the voxels of its
        volume that differ, and the largest absolute difference of any
        channel of any of its views."""
        (vol, views), (rvol, rviews) = output, against
        return {"volume_mismatch": int((vol != rvol).sum()),
                "views_max_err": float((views - rviews).abs().max())}


def make(cfg: dict, mix: dict, seed: int, device="cuda") -> ViewsBatchLoop:
    return ViewsBatchLoop(cfg, mix, seed, device)
