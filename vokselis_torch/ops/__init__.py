"""Render ops: the plain-torch oracle renderer, the hand-written CUDA kernels
(:mod:`vokselis_torch.ops.cuda`, built at first use on a CUDA device) and
the present pass."""

from vokselis_torch.ops.present import present, to_uint8
from vokselis_torch.ops.reference import MAX_STEPS_BONSAI, render_bonsai

__all__ = ["render_bonsai", "present", "to_uint8", "MAX_STEPS_BONSAI"]
