"""K1, the exact march (``march_bonsai_kernel``): its work per frame.

Bytes: the (D, D, D) uint8 volume read once, the (H, W, 4) float32 frame
written once and the camera (a 4-vector and two 4x4 float32 matrices) read
once, per view. The ray planes the kernel reads today are not counted: a
kernel that made its own rays would need none, and the bound reads the same
work whatever implements it.

Operations: the samples the reference march takes whose trilinear footprint
touches a non-zero voxel (``reference.march.touched_samples``), before each
ray leaves the box or saturates, times OPS_PER_SAMPLE, counted once from the
reference's code (adds, subtracts, multiplies, min/max, floor, compares
of clamps, each cos as one): the trilinear sample 41 (texel position 6,
floors 3, fractions 3, dequantisation 8, seven lerps 21), the transfer 9
and the palette 18 (three channels of 6), compositing 11, the advance 7.
A sample whose taps are all zero adds an exact zero and is not counted.
"""

OPS_PER_SAMPLE = 41 + 9 + 18 + 11 + 7
CAMERA_BYTES = 4 * (4 + 16 + 16)


def frame_bytes(dims: int, width: int, height: int, views: int = 1) -> int:
    return dims ** 3 + views * (width * height * 16 + CAMERA_BYTES)


def ops(touched_samples: int) -> int:
    return touched_samples * OPS_PER_SAMPLE
