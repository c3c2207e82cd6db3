"""Kernel compiler with diagnostics (the reference's ShaderCompiler analog).

The reference compiles WGSL -> naga IR -> validate -> SPIR-V and returns rich
errors instead of crashing the render loop (src/utils/shader_compiler.rs:
10-46, 98-160). The port keeps the contract "compile returns diagnostics,
don't crash the loop" for its two kinds of kernel:

- a CUDA source (``.cu``): compiling is :func:`vokselis_torch.ops.cuda.
  build.load_library` (nvcc for ``sm_90a`` into a library whose name hashes
  the source, its headers and the flags), ``compiled`` is the loaded
  library and ``error`` is nvcc's output;
- a Python callable: ``create_kernel(fn, example_args)`` runs ``fn`` once
  on the example arguments (on a CUDA device, up to the stream's end, so an
  asynchronous fault lands here too), ``compiled`` is ``fn`` and ``error``
  the traceback.
"""

from __future__ import annotations

import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import torch

from vokselis_torch.ops.cuda.build import NVCC_FLAGS, load_library


@dataclass
class CompileResult:
    """Outcome of a kernel compilation."""

    ok: bool
    compiled: Any = None  # the loaded library, or the checked callable
    error: str = ""  # diagnostics on failure (nvcc's output or a traceback)
    seconds: float = 0.0

    def __bool__(self):
        return self.ok


def _is_source(kernel) -> bool:
    return isinstance(kernel, (str, Path)) and Path(kernel).suffix == ".cu"


class KernelCompiler:
    """Compiles kernels and reports diagnostics.

    ``create_kernel`` mirrors ShaderCompiler::create_shader_module
    (shader_compiler.rs:21-31): it returns a :class:`CompileResult` rather
    than raising."""

    def __init__(self):
        self._cache: dict = {}

    def create_kernel(self, kernel: Callable | str | Path, example_args: tuple = (),
                      flags=NVCC_FLAGS) -> CompileResult:
        """``kernel``: the path of a ``.cu`` source (built with ``flags``;
        ``example_args`` unused) or a callable run once on
        ``example_args``."""
        t0 = time.perf_counter()
        try:
            if _is_source(kernel):
                compiled, _ = load_library(Path(kernel), flags)
            else:
                out = kernel(*example_args)
                for t in out if isinstance(out, (tuple, list)) else (out,):
                    if isinstance(t, torch.Tensor) and t.is_cuda:
                        torch.cuda.synchronize(t.device)
                compiled = kernel
            return CompileResult(True, compiled, "", time.perf_counter() - t0)
        except Exception as e:
            # a build failure's message is nvcc's output; a callable's, its traceback
            error = str(e) if _is_source(kernel) else traceback.format_exc()
            return CompileResult(False, None, error, time.perf_counter() - t0)

    def create_kernel_cached(self, key, kernel, example_args=(), **kw) -> CompileResult:
        if key not in self._cache or not self._cache[key].ok:
            self._cache[key] = self.create_kernel(kernel, example_args, **kw)
        return self._cache[key]
