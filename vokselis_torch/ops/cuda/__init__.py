"""Hand-written Hopper kernels, the counterparts of ``vokselis_tpu.ops.pallas``.

Each module builds its kernel from ``vokselis_torch/csrc`` at first use on a
CUDA device (never at import), counts its launches, and takes its plain
torch version for CPU tensors.
"""
