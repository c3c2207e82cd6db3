"""K7, the field march (``march_field_kernel``): its work per frame.

Bytes: the (H, W, 4) float32 frame written once, the camera (inv_proj, the
one matrix the compute path's rays need) and the field's time read once.
The hash table and the ray planes the kernel reads today are not counted:
they belong to this implementation (a kernel that made its own rays and
hashes would need neither), and the bound reads the same work whatever
implements it.

Operations: the samples the reference march takes inside the field's ball
(``reference.field.samples``: alpha is exactly zero beyond it, so a sample
there composites nothing), before each ray leaves its span or saturates,
times OPS_PER_SAMPLE, counted once from the field's and the march's
formulas (adds, subtracts, multiplies, min/max, floor, sqrt, division,
each sine as one), with the normal at its closed form, the least work that
yields the configured analytic normals:

- the sample, 53: its position 6, the texel's centre 21 (three axes of
  (p + 1) D/2, floor, clamp, the centre's offset and scale), alpha's cube
  and smoothstep 10, the composite 15 (three channels and alpha, with the
  clear colour's term), the advance 1;
- the shading, 46: Lambert 2, the tinted light's dot product, its mask's
  dot product and smoothstep and the tint 22, the bottom fill and its mix
  into three channels 16, val / 2 and the three products 6 (less what the
  channels share);
- the field and its gradient, 432: the lattice 7; in each of the three
  octaves the floors, fractions and smooth weights 18 and their derivatives
  9, the lattice index 4, eight hashes fract(sin(n) 43758.5453123) at 4
  with their corner offsets 7, the value's seven mixes, amplitude and sum
  23, the gradient's mixes and weights 29, the next octave's scaling 4; the
  radius 6, the window and its derivative 16, alpha 1, the radial term 3,
  the three components 12 and their normalisation 10.
"""

OPS_PER_SAMPLE = 53 + 46 + 432
CAMERA_BYTES = 4 * 16
TIME_BYTES = 4


def frame_bytes(width: int, height: int) -> int:
    return width * height * 16 + CAMERA_BYTES + TIME_BYTES


def ops(samples: int) -> int:
    return samples * OPS_PER_SAMPLE
