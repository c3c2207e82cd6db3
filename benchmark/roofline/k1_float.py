"""K1 over a (D, H, W) float32 field mapped by its data range: its work per
frame, counted from the reference (:mod:`benchmark.reference.float_march`).

Bytes: 4 x the distinct voxels among the 8 taps of the reference's counted
samples of the frame (``float_march.frame_work``), and per view the (H, W,
4) float32 frame written once and the camera read once. Not the whole
volume read once, as :mod:`.k1_volume` counts a uint8 scan: a 1024^3 field
is 4.29 GB, 1.28 ms a frame at the HBM rate, while up close the rays that
stop at an opaque face and the skipped empty fluid read a small part of it.

Operations: the counted samples (those whose mapped taps are not all zero)
times OPS_PER_SAMPLE, counted once from ``float_march``'s code as
:mod:`.k1` counts its 86: the trilinear sample 49 (texel position 6,
floors 3, fractions 3, the taps' mapping (v - lo) * inv 16, seven lerps
21), the transfer 9, the palette 18, compositing 11, the advance 7.
"""

from benchmark.roofline.k1 import CAMERA_BYTES

VOXEL_BYTES = 4
OPS_PER_SAMPLE = 49 + 9 + 18 + 11 + 7


def frame_bytes(distinct_voxels: int, width: int, height: int, views: int = 1) -> int:
    return VOXEL_BYTES * distinct_voxels + views * (width * height * 16 + CAMERA_BYTES)


def ops(touched_samples: int) -> int:
    return touched_samples * OPS_PER_SAMPLE
