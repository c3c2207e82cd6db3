"""The program's own spans and counters, beneath every layer that marks
them: the frame loop, the uniforms' uploads, each compiled frame's copies
and replay, the kernels' ray counts.

:func:`span` marks a piece of the program's work and :func:`count` adds to
a named counter. :func:`recording` keeps them in memory, on the host's
clock, and under a ``torch.profiler`` session each span is also a range of
the trace, beside the device's kernels. With neither, a span is one shared
no-op object, :data:`NOOP`.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from array import array
from threading import get_ident

import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast


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
