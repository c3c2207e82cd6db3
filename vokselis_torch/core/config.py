"""Typed configuration — lifts the reference's hardcoded constants.

The reference has no config system (SURVEY.md §5): all tunables are literals
scattered through the code. This module centralizes them, keyed by the source
location they came from.
"""

from __future__ import annotations

from dataclasses import dataclass, field


# src/context/hdr_backbuffer.rs:10-11 — fixed offscreen resolution
DEFAULT_RESOLUTION = (1280, 720)

# src/lib.rs:65-66
ROTATE_SPEED = 0.0025
ZOOM_SPEED = 0.002

# examples/xor/main.rs:12
TILE_SIZE = 256

# src/lib.rs:33-35
SHADER_FOLDER = "shaders"
SCREENSHOTS_FOLDER = "screenshots"
VIDEO_FOLDER = "recordings"


@dataclass(frozen=True)
class RenderConfig:
    """Static (compile-time) knobs for a render pipeline.

    Dynamic per-frame state lives in
    :class:`~vokselis_torch.core.uniforms.GlobalUniform` and
    :class:`~vokselis_torch.core.camera.CameraUniform` instead.
    """

    width: int = DEFAULT_RESOLUTION[0]
    height: int = DEFAULT_RESOLUTION[1]
    # dt_scale, shaders/raycast_naive.wgsl:98 / raycast_compute.wgsl:66
    dt_scale: float = 1.0
    # early-exit opacity, raycast_naive.wgsl:115 / raycast_compute.wgsl:92
    opacity_threshold: float = 0.95
    # march step caps (worst case along the box diagonal; see ops.reference)
    max_steps: int | None = None  # None -> derived from volume dims
    # accumulate in f32; volumes may be stored uint8/bf16
    dtype: str = "float32"
    # ray-tile shape of the JAX package's fused kernels (rows, cols)
    tile_h: int = 8
    tile_w: int = 256

    @property
    def resolution(self):
        return (self.width, self.height)

    @property
    def aspect(self) -> float:
        return self.width / self.height


@dataclass(frozen=True)
class EngineConfig:
    """Engine/runtime knobs (harness-level; SURVEY.md H1/H2)."""

    render: RenderConfig = field(default_factory=RenderConfig)
    rotate_speed: float = ROTATE_SPEED
    zoom_speed: float = ZOOM_SPEED
    screenshots_folder: str = SCREENSHOTS_FOLDER
    video_folder: str = VIDEO_FOLDER
    # frames between frame-time prints (src/utils/frame_counter.rs:23)
    report_every: int = 100
