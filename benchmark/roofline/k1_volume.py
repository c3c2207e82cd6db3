"""K1 over a (D, H, W) volume: its work per frame, as :mod:`.k1` counts it.

Bytes: the volume, D * H * W uint8, read once, and per view the (H, W, 4)
float32 frame written once and the camera read once. Operations:
``k1.ops`` of the samples :func:`benchmark.reference.volume_march.touched_samples`
counts (the samples whose trilinear footprint touches a non-zero voxel).
"""

from benchmark.roofline.k1 import CAMERA_BYTES


def frame_bytes(shape, width: int, height: int, views: int = 1) -> int:
    d, h, w = shape
    return d * h * w + views * (width * height * 16 + CAMERA_BYTES)
