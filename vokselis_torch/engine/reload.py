"""Hot reload: watch kernel and scene sources, rebuild, swap in place.

Rebuilds the reference's shader watcher (src/watcher.rs): a background thread
watches registered source files (stat-polling — no inotify dependency) and on
change rebuilds on the watcher thread; on success the new kernel is swapped
into every registered pipeline and the terminal blinks green
(src/watcher.rs:78-90); on failure the diagnostics go to stderr and the old
kernel keeps rendering (src/watcher.rs:92-101) — a bad edit never kills the
app. The registry is a path -> [entries] multimap like ContiniousHashMap
(src/watcher.rs:27, src/utils/mod.rs:48-89).

Two kinds of source are watched:

- a Python module (:meth:`Watcher.register`): on change it is re-imported
  and ``pipeline.reload(module)`` rebinds what the pipeline takes from it
  (the plain versions' field functions, for one);
- a CUDA source (:meth:`Watcher.register_kernel`) together with the local
  headers it includes: on change the watcher rebuilds it through its
  :class:`KernelCompiler` (nvcc) and calls ``pipeline.reload(library)``
  with the newly loaded library. The library's file name hashes the source
  and its headers, so each good edit loads a new library; ctypes cannot
  unload one, so the old one stays loaded, unused. A failed build prints
  nvcc's diagnostics and leaves the pipeline on its last good library:
  it never falls back to a plain version.

Reloads rebind a pipeline's attribute; a frame in flight on another thread
keeps the object it read.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Protocol, runtime_checkable

from vokselis_torch.engine.compiler import CompileResult, KernelCompiler
from vokselis_torch.ops.cuda.build import NVCC_FLAGS, included_headers
from vokselis_torch.utils.misc import ContinuousDict, green_blink


@runtime_checkable
class ReloadablePipeline(Protocol):
    """Anything with a ``reload(module_or_library)`` method
    (src/watcher.rs:21-23)."""

    def reload(self, module) -> None: ...


class FnPipeline:
    """Simplest reloadable: holds a callable rebuilt from a module attr."""

    def __init__(self, module, attr: str):
        self.attr = attr
        self.fn = getattr(module, attr)

    def reload(self, module):
        self.fn = getattr(module, self.attr)

    def __call__(self, *a, **kw):
        return self.fn(*a, **kw)


def _stamp(path: str):
    st = os.stat(path)
    return st.st_mtime_ns, st.st_size


class Watcher:
    """Stat-polling source watcher with a reload registry. ``compiler``
    rebuilds the CUDA sources (a fresh :class:`KernelCompiler` by
    default; the Context passes its ``shader_compiler``)."""

    def __init__(self, poll_interval: float = 0.5, autostart: bool = True,
                 compiler: KernelCompiler | None = None):
        # path -> [("module", module name, pipeline) | ("kernel", source, flags, pipeline)]
        self.registry = ContinuousDict()
        self.compiler = compiler or KernelCompiler()
        self._stamps: dict = {}
        self._lock = threading.Lock()  # guards the registry
        self._poll_lock = threading.RLock()  # one poll at a time (thread or caller)
        self._stop = threading.Event()
        self.poll_interval = poll_interval
        self._thread = None
        if autostart:
            self.start()

    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="source-watcher", daemon=True
            )
            self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _watch(self, path: str, entry):
        with self._poll_lock, self._lock:
            self.registry.push_value(path, entry)
            self._stamps.setdefault(path, _stamp(path))

    def register(self, module, pipeline):
        """Watch ``module``'s source file; on change, re-import it and call
        ``pipeline.reload(module)``. Returns the pipeline (mirrors
        Watcher::register, src/watcher.rs:45-54)."""
        self._watch(os.path.abspath(module.__file__), ("module", module.__name__, pipeline))
        return pipeline

    def register_kernel(self, source, pipeline, flags=NVCC_FLAGS):
        """Watch the CUDA ``source`` and the local headers it includes; on a
        change to any of them, rebuild it with ``flags`` and call
        ``pipeline.reload(library)``. Returns the pipeline."""
        source = str(Path(source).resolve())
        entry = ("kernel", source, tuple(flags), pipeline)
        for path in (source, *map(str, included_headers(Path(source)))):
            self._watch(path, entry)
        return pipeline

    # --- watcher thread (src/watcher.rs:57-110) --------------------------
    def _loop(self):
        while not self._stop.wait(self.poll_interval):
            self.poll_once()

    def poll_once(self) -> list[CompileResult]:
        """One poll cycle (also callable synchronously). Returns the result
        of every reload it ran; a source edited together with its header
        rebuilds once."""
        with self._poll_lock:
            with self._lock:
                items = [(p, list(v)) for p, v in self.registry.items()]
            todo = []
            for path, entries in items:
                try:
                    stamp = _stamp(path)
                except OSError:
                    continue
                if stamp == self._stamps.get(path):
                    continue
                self._stamps[path] = stamp
                todo += [(path, e) for e in entries if all(e is not t for _, t in todo)]
            return [self._reload(path, entry) for path, entry in todo]

    @staticmethod
    def _reload_module(module_name, path):
        try:
            return importlib.reload(sys.modules[module_name])
        except (ModuleNotFoundError, ImportError):
            # modules loaded from an explicit path (outside sys.path)
            spec = importlib.util.spec_from_file_location(module_name, path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            sys.modules[module_name] = module
            return module

    def _reload(self, path, entry) -> CompileResult:
        kind, pipeline = entry[0], entry[-1]
        if kind == "kernel":
            res = self.compiler.create_kernel(entry[1], flags=entry[2])
            what = os.path.basename(entry[1])
        else:
            t0 = time.perf_counter()
            try:
                module = self._reload_module(entry[1], path)
                res = CompileResult(True, module, "", time.perf_counter() - t0)
            except Exception:
                res = CompileResult(False, None, traceback.format_exc(),
                                    time.perf_counter() - t0)
            what = os.path.basename(path)
        if res.ok:
            try:
                pipeline.reload(res.compiled)
            except Exception:
                res = CompileResult(False, None, traceback.format_exc(), res.seconds)
        if res.ok:
            green_blink()
            print(f"reloaded {what} in {res.seconds:.2f} s")
        else:
            # keep the old pipeline live (src/watcher.rs:92-101)
            print(f"reload of {what} failed; keeping the previous kernel:\n{res.error}",
                  file=sys.stderr)
        return res
