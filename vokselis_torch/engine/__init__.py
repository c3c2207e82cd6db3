"""Engine: device context, demo protocol, frame loop, hot reload, kernel
compiler, scene state, frame and pass timers, device traces."""

from vokselis_torch.engine.compiler import CompileResult, KernelCompiler
from vokselis_torch.engine.context import Context, HdrBackBuffer, renderer_info
from vokselis_torch.engine.demo import Demo
from vokselis_torch.engine.input import Input
from vokselis_torch.engine.loop import print_help, run
from vokselis_torch.engine.profiler import FrameCounter, PassTimer
from vokselis_torch.engine.reload import ReloadablePipeline, Watcher

__all__ = [
    "Context",
    "HdrBackBuffer",
    "renderer_info",
    "Demo",
    "run",
    "print_help",
    "Watcher",
    "ReloadablePipeline",
    "KernelCompiler",
    "CompileResult",
    "FrameCounter",
    "PassTimer",
    "Input",
]
