"""Dispatch-grid math (mirrors dispatch_optimal, src/utils/mod.rs:15-18).

Reappears here as CUDA launch-grid helpers (SURVEY.md H15).
"""

from __future__ import annotations

# the screen tile side of the JAX package's kernels (march_bonsai.TILE): the
# hybrid scores, selects and re-marches 32x32 tiles, and pose_hint measures
# the warp's span over them
TILE = 32


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def dispatch_optimal(length: int, subgroup_size: int) -> int:
    """Workgroup count for ``length`` items at ``subgroup_size`` per group
    (src/utils/mod.rs:15-18)."""
    return cdiv(length, subgroup_size)


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m`` (tile alignment)."""
    return cdiv(x, m) * m
