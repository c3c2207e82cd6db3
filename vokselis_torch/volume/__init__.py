"""Voxel volumes: .raw IO and wgpu-exact samplers."""

from vokselis_torch.volume.io import get_bonsai, load_raw, synthetic_bonsai
from vokselis_torch.volume.sample import (
    sample_nearest,
    sample_trilinear_r8,
    trilinear_weights,
)

__all__ = [
    "load_raw",
    "synthetic_bonsai",
    "get_bonsai",
    "sample_trilinear_r8",
    "sample_nearest",
    "trilinear_weights",
]
