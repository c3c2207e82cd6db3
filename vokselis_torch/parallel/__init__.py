"""Multi-device rendering over torch.distributed: a (views, tiles) device
mesh, view-sharded batches and row-sharded frames."""

from vokselis_torch.parallel.sharding import (
    build_default_renderer,
    build_ray_renderer,
    make_mesh,
    multi_view_step,
    orbit_camera_batch,
    render_frame_tiled,
    render_views_sharded,
)

__all__ = [
    "make_mesh",
    "orbit_camera_batch",
    "render_views_sharded",
    "render_frame_tiled",
    "multi_view_step",
    "build_default_renderer",
    "build_ray_renderer",
]
