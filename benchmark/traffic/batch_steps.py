"""Batch steps in a closed loop: batch k of a run is step b0 + k of the
program's time-varying batch, one batch in flight. b0 is drawn from the
seed below ``b0_max``; the first ``warmup_batches`` are set-up."""

from __future__ import annotations

import numpy as np

TINY = {"warmup_batches": 1}  # the CPU tests' overrides of a mix


class BatchSteps:
    def __init__(self, mix: dict, seed: int):
        self.b0 = int(np.random.default_rng([seed, 2]).integers(0, mix["b0_max"]))
        self.warmup = int(mix["warmup_batches"])

    def step(self, k: int) -> int:
        return self.b0 + k


def make(mix: dict, seed: int) -> BatchSteps:
    return BatchSteps(mix, seed)
