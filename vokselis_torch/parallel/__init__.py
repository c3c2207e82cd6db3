"""Multi-view rendering helpers. Only the orbiting camera batch of config 5
is ported; the views x tiles device mesh waits for ROADMAP.md queue 1,
item 10."""

from vokselis_torch.parallel.sharding import orbit_camera_batch

__all__ = ["orbit_camera_batch"]
