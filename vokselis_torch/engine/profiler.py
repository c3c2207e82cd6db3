"""Frame-time and pass-time profiling.

- :class:`FrameCounter` mirrors src/utils/frame_counter.rs:3-40 — accumulates
  frame time and prints the average every 100 frames; ``time_delta()`` feeds
  the global uniform like context.rs:227.
- :class:`PassTimer` is the analog of the xor demo's GPU timestamp-query pair
  (examples/xor/main.rs:120-131, 164-187): on a CUDA device it brackets a
  pass with CUDA events and reads them only when it reports, every N frames,
  so timing adds one host sync every N frames (the span
  ``pass_timer.report``, the counter ``host_syncs``) and none to the others;
  on the CPU it takes the wall clock.
  It prints 'Time on raycast shader'-style reports plus a derived Mrays/s.
  (The JAX package calibrated a host dispatch floor instead; events time the
  device itself.)
- :func:`trace` captures a device trace around a block (the JAX package's
  ``jax.profiler.trace``): ``torch.profiler`` with CPU and, where there is
  a card, CUDA activities, written as a Chrome trace.
- :func:`kernel_launches` counts the kernels a call ran on the card by
  name, from such a trace: a replayed CUDA graph calls no launch wrapper,
  so its kernels are counted here. A new session can lose its first few
  device records (up to ten seen on an H100, in a process that traced
  before), so :func:`device_events` spends them on small kernels of its own
  before the call and keeps only the records that follow.
- :func:`graph_kernels` counts the kernel nodes of a captured CUDA graph by
  name, read through the CUDA driver: what each replay of it launches,
  whatever a trace recorded. CUPTI has returned a session with no device
  record at all (not even its uncaptured copies) around a graph replay.
- :func:`span` and :func:`count` mark the program's own layers (the frame
  loop, the uniforms' uploads, each compiled frame's copies and replay):
  :func:`recording` keeps them in memory, on the host's clock, and under a
  ``torch.profiler`` session each span is also a range of the trace, beside
  the device's kernels. With neither, a span is one shared no-op object.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import re
import statistics
import tempfile
import time
from array import array
from threading import get_ident

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast


class FrameCounter:
    def __init__(self, report_every: int = 100):
        self.frame_count = 0
        self.accum_time = 0.0
        self.last_frame_time = time.perf_counter()
        self.report_every = report_every
        self.last_avg_ms = 0.0

    def record(self) -> float:
        """Mark a frame boundary; returns dt seconds. Prints the average
        every ``report_every`` frames (frame_counter.rs:18-28)."""
        now = time.perf_counter()
        dt = now - self.last_frame_time
        self.last_frame_time = now
        self.accum_time += dt
        self.frame_count += 1
        if self.frame_count % self.report_every == 0:
            self.last_avg_ms = self.accum_time / self.report_every * 1000.0
            print(f"Avg frame time {self.last_avg_ms:.2f}ms")
            self.accum_time = 0.0
        return dt

    def time_delta(self) -> float:
        """Average seconds per frame over the current window
        (frame_counter.rs:14-16)."""
        if self.frame_count % self.report_every == 0:
            return self.last_avg_ms / 1000.0 if self.last_avg_ms else 1.0 / 60.0
        n = self.frame_count % self.report_every
        return self.accum_time / max(n, 1)


class PassTimer:
    """Times a named pass on ``device``; prints every ``report_every``
    frames. ``last_ms`` holds the last report's mean ms per pass."""

    def __init__(self, name: str = "raycast shader", report_every: int = 100,
                 device="cpu"):
        self.name = name
        self.report_every = report_every
        self.device = torch.device(device)
        self.count = 0
        self.rays = 0
        self.last_ms = 0.0
        self._accum = 0.0  # seconds (CPU)
        self._events = []  # (start, end) pairs since the last report (CUDA)

    @contextlib.contextmanager
    def measure(self, n_rays: int = 0):
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._events.append((start, end))
        else:
            t0 = time.perf_counter()
            yield
            self._accum += time.perf_counter() - t0
        self.rays += n_rays
        self.count += 1
        if self.count % self.report_every == 0:
            with span("pass_timer.report"):
                self._report()

    def _report(self):
        if self._events:
            self._events[-1][1].synchronize()
            count("host_syncs")  # the frame path's one wait on the device
            ms = sum(s.elapsed_time(e) for s, e in self._events)
        else:
            ms = self._accum * 1000.0
        self.last_ms = ms / self.report_every
        msg = f"Time on {self.name}: {self.last_ms:.3f}ms"
        if self.rays and ms > 0.0:
            msg += f" ({self.rays / (ms * 1e3):.1f} Mrays/s)"
        print(msg)
        self._accum = 0.0
        self._events = []
        self.rays = 0


class _Off:
    """The shared span of a call that nothing records (its own class:
    ``contextlib.nullcontext.__exit__`` takes varargs, and a frame enters a
    dozen spans)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


NOOP = _Off()
_active = None  # the Recording that recording() has open, if any


class _Stats:
    """One span key's occurrences in a recording: each one's duration (ns)
    and frame or batch (-1 for none), and their total self time (ns)."""

    __slots__ = ("parent", "durations", "ids", "self_ns")

    def __init__(self, parent):
        self.parent = parent
        self.durations, self.ids = array("q"), array("q")
        self.self_ns = 0


class Recording:
    """The spans and counters of one :func:`recording`, kept on the thread
    that opened it. ``snapshot()`` sums them up; ``by_id(key)`` splits a
    span's time by frame or batch."""

    def __init__(self):
        self.thread = get_ident()
        self.stack = []  # the open spans, innermost last
        self.spans = {}  # key -> _Stats
        self.counters = {}

    def snapshot(self) -> dict:
        """``{"spans": {key: {"n", "total_s", "self_s", "p95_s", "parent"}},
        "counters": {name: value}}``: a key is a span's ``name`` or
        ``name/tag``; ``parent`` the key of the span it first opened in (None
        at the top); ``p95_s`` the 95th percentile of its occurrences
        (``statistics.quantiles``, n=100, inclusive: the exclusive method
        reaches past the longest occurrence when they are few)."""
        spans = {}
        for key, s in self.spans.items():
            d = s.durations
            p95 = statistics.quantiles(d, n=100, method="inclusive")[94] if len(d) > 1 else d[0]
            spans[key] = {"n": len(d), "total_s": sum(d) * 1e-9, "self_s": s.self_ns * 1e-9,
                          "p95_s": p95 * 1e-9, "parent": s.parent}
        return {"spans": spans, "counters": dict(self.counters)}

    def by_id(self, key) -> dict:
        """``{id: seconds}``: the occurrences of span ``key`` summed by the
        frame or batch they belong to (occurrences without one left out)."""
        out = {}
        s = self.spans.get(key)
        if s is not None:
            for i, d in zip(s.ids, s.durations):
                if i >= 0:
                    out[i] = out.get(i, 0.0) + d * 1e-9
        return out


class _Span:
    """A span that a recording keeps (and, under a profiler, a range too)."""

    __slots__ = ("rec", "key", "id", "t0", "inner", "range")

    def __init__(self, rec, key, id):
        self.rec, self.key, self.id = rec, key, id

    def __enter__(self):
        stack = self.rec.stack
        if self.id is None:
            self.id = stack[-1].id if stack else -1
        stack.append(self)
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = _RecordFunctionFast(self.key)
            self.range.__enter__()
        self.inner = 0
        self.t0 = time.perf_counter_ns()

    def __exit__(self, exc_type, exc, tb):
        duration = time.perf_counter_ns() - self.t0
        if self.range is not None:
            self.range.__exit__(exc_type, exc, tb)
        rec = self.rec
        stack = rec.stack
        stack.pop()
        parent = stack[-1] if stack else None
        if parent is not None:
            parent.inner += duration
        s = rec.spans.get(self.key)
        if s is None:
            s = rec.spans[self.key] = _Stats(parent.key if parent is not None else None)
        s.durations.append(duration)
        s.ids.append(self.id)
        s.self_ns += duration - self.inner


def span(name: str, tag: str | None = None, id: int | None = None):
    """A context manager around one piece of the program's work, keyed
    ``name`` or ``name/tag``; ``id`` is the frame or batch it belongs to,
    which the spans inside it inherit. While :func:`recording` is active, a
    span on the thread that opened it is kept (its parent, the enclosing
    span; its start and end; its self time, less what its children cover);
    while a ``torch.profiler`` session is open, it is also a range named by
    its key, on the host's timeline only (no ``record_function``: that one
    is mirrored on the device's timeline). Otherwise it is :data:`NOOP`."""
    rec = _active
    if rec is None or rec.thread != get_ident():
        if not _autograd_profiler._is_profiler_enabled:
            return NOOP
        return _RecordFunctionFast(name if tag is None else f"{name}/{tag}")
    return _Span(rec, name if tag is None else f"{name}/{tag}", id)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the active :func:`recording`
    (counts made on its thread); nothing when none is active."""
    rec = _active
    if rec is not None and rec.thread == get_ident():
        rec.counters[name] = rec.counters.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Keep every :func:`span` and :func:`count` of this thread while the
    block runs; yields the :class:`Recording`. One at a time."""
    global _active
    if _active is not None:
        raise RuntimeError("a recording is already active")
    rec = _active = Recording()
    try:
        yield rec
    finally:
        _active = None


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Capture a ``torch.profiler`` trace around a block and write it to
    ``logdir`` (default ``vokselis-trace`` in the temporary directory) as a
    Chrome trace, ``trace_<pid>_<ns>.json``, the program's spans
    (:func:`span`) among its host ranges; yields the profiler, whose
    ``trace_path`` names the file once the block ends."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "vokselis-trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.trace_path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)
    print(f"profiler trace written to {prof.trace_path}")


# device_events' settling: kernels run before the call, then a pause longer
# than the skew seen between device and host timestamps (~0.1 ms)
SETTLE_KERNELS = 32
SETTLE_PAUSE_S = 0.002
_TRACED = "profiler.traced"


def device_events(fn):
    """Run ``fn()`` under ``torch.profiler`` (CPU and, with a card, CUDA
    activities; the card synchronized before the trace ends) and return
    ``(fn's result, [the names of the trace's device events])``: kernels,
    those of replayed CUDA graphs included, and copies. With a card the
    session first runs :data:`SETTLE_KERNELS` small kernels, which take the
    records a new session may lose, and pauses; only device events that
    start after the pause, inside a range around ``fn()``, are returned."""
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        if cuda:
            x = torch.zeros((), device="cuda")
            for _ in range(SETTLE_KERNELS):
                x.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(SETTLE_PAUSE_S)
        with torch.profiler.record_function(_TRACED):
            out = fn()
            if cuda:
                torch.cuda.synchronize()
    events = prof.events()
    t0 = min(e.time_range.start for e in events
             if e.name == _TRACED and e.device_type == torch.autograd.DeviceType.CPU)
    return out, [e.name for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA and e.name != _TRACED
                 and e.time_range.start >= t0]


def count_kernels(event_names, names) -> dict:
    """``{name: events}``: how many of ``event_names`` (a trace's demangled
    device event names) are each ``__global__`` function of ``names``."""
    pattern = re.compile(r"(?<!\w)(" + "|".join(map(re.escape, names)) + r")(?!\w)")
    counts = dict.fromkeys(names, 0)
    for e in event_names:
        m = pattern.search(e)
        if m:
            counts[m.group(1)] += 1
    return counts


def kernel_launches(fn, names):
    """Run ``fn()`` under ``torch.profiler`` and count the device kernels
    whose name is one of ``names`` (``__global__`` function names), those
    of replayed CUDA graphs included. Returns ``(fn's result, {name:
    launches})``; without a card every count is 0."""
    out, events = device_events(fn)
    return out, count_kernels(events, names)


class _KernelNodeParams(ctypes.Structure):
    """The driver's CUDA_KERNEL_NODE_PARAMS_v2."""

    _fields_ = [("func", ctypes.c_void_p)] + [
        (f, ctypes.c_uint) for f in ("grid_x", "grid_y", "grid_z", "block_x", "block_y",
                                     "block_z", "shared_mem")] + [
        ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
        ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


_CU_GRAPH_NODE_TYPE_KERNEL = 0
_CU_GRAPH_NODE_TYPE_GRAPH = 6


def _driver():
    cu = ctypes.CDLL("libcuda.so.1")
    for f in ("cuGraphGetNodes", "cuGraphNodeGetType", "cuGraphKernelNodeGetParams_v2",
              "cuFuncGetName", "cuKernelGetName", "cuGraphChildGraphNodeGetGraph"):
        getattr(cu, f).restype = ctypes.c_int
    return cu


def _check(res: int, what: str) -> None:
    if res != 0:
        raise RuntimeError(f"{what} failed: CUresult {res}")


def _node_names(cu, graph) -> list:
    """The function names of ``graph``'s kernel nodes (a ``CUgraph``), child
    graphs' included, as the driver gives them (mangled)."""
    n = ctypes.c_size_t(0)
    _check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names = []
    for node in nodes:
        kind = ctypes.c_int()
        _check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
               "cuGraphNodeGetType")
        if kind.value == _CU_GRAPH_NODE_TYPE_GRAPH:
            child = ctypes.c_void_p()
            _check(cu.cuGraphChildGraphNodeGetGraph(ctypes.c_void_p(node), ctypes.byref(child)),
                   "cuGraphChildGraphNodeGetGraph")
            names += _node_names(cu, child)
        if kind.value != _CU_GRAPH_NODE_TYPE_KERNEL:
            continue
        p = _KernelNodeParams()
        _check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(p)),
               "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if p.func:
            _check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func)), "cuFuncGetName")
        else:
            _check(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(p.kern)),
                   "cuKernelGetName")
        names.append(name.value.decode())
    return names


def kernel_name_matches(name: str, kernel: str) -> bool:
    """Whether the function name ``name`` (plain, or mangled as the driver
    gives it) is the ``__global__`` function ``kernel``: the name itself, or
    an Itanium source name, the identifier after its length (``18march_field_
    kernel`` in ``_ZN12_GLOBAL__N_118march_field_kernelE...``, where the
    length's digits follow another name's)."""
    if name == kernel:
        return True
    for m in re.finditer(r"\d+", name):
        digits, end = m.group(), m.end()
        if any(name[end:end + int(digits[i:])] == kernel for i in range(len(digits))):
            return True
    return False


def graph_kernels(graph, names):
    """Count the kernel nodes of the captured ``torch.cuda.CUDAGraph``
    ``graph`` (made with ``keep_graph=True``) whose function is one of
    ``names``: the kernels each replay launches, read from the graph itself
    through the CUDA driver (``cuGraphGetNodes``, ``cuGraphKernelNodeGetParams``,
    ``cuFuncGetName``). Returns ``{name: nodes}``."""
    counts = dict.fromkeys(names, 0)
    for node in _node_names(_driver(), ctypes.c_void_p(graph.raw_cuda_graph())):
        for k in names:
            if kernel_name_matches(node, k):
                counts[k] += 1
    return counts
