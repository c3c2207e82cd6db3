"""Engine: device context, demo protocol, frame loop, frame-time counter."""

from vokselis_torch.engine.context import Context, HdrBackBuffer, renderer_info
from vokselis_torch.engine.demo import Demo
from vokselis_torch.engine.input import Input
from vokselis_torch.engine.loop import print_help, run
from vokselis_torch.engine.profiler import FrameCounter

__all__ = [
    "Context",
    "HdrBackBuffer",
    "renderer_info",
    "Demo",
    "run",
    "print_help",
    "FrameCounter",
    "Input",
]
