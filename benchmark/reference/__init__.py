"""Plain-torch reference of what the timed paths produce.

A frozen copy of the semantics the benchmark holds ``vokselis_torch`` to:
the seeded bonsai stand-in (:mod:`.standin`), the orbit camera and the
frame loop's event-to-pose mapping (:mod:`.camera`), ray generation and the
exact front-to-back march (:mod:`.march`), the present pass
(:mod:`.present`) and config 5's procedural density (:mod:`.density`). It
imports nothing of the program and takes nothing the program made: it works
the volume, the poses and the frames out again from the seed and the event
stream. Every function takes ``dtype``, the precision of its per-sample
arithmetic: float32 is the reference, bfloat16 the control that
``correct`` must reject.
"""

import torch


def strict_float32() -> None:
    """No TF32 anywhere: a float32 product stays float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
