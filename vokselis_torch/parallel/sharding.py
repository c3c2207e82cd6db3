"""Batched multi-view cameras (the part of the JAX package's
``parallel/sharding.py`` that config 5 needs).

The JAX package stacks the views' uniforms into one pytree with a leading
batch axis for ``shard_map``; the port renders its views one by one on one
card, so it keeps one :class:`CameraUniform` per view. The device mesh over
views and tiles is not ported yet (ROADMAP.md queue 1, item 10).
"""

from __future__ import annotations

import math

from vokselis_torch.core.camera import Camera, CameraUniform


def orbit_camera_batch(n_views: int, target=(0.5, 0.5, 0.5), zoom=1.0, pitch=0.5,
                       aspect=1.0, *, device) -> list[CameraUniform]:
    """N cameras orbiting the target in yaw — BASELINE config 5's batched
    views (and config 4's orbiting camera, sampled at n frames): the
    uniform of view i at yaw 2 pi i / n, on ``device``."""
    return [Camera(zoom=zoom, pitch=pitch, yaw=2.0 * math.pi * i / n_views, target=target,
                   aspect=aspect).uniform(device)
            for i in range(n_views)]
