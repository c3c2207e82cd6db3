"""Compiled frames: the counterpart of ``jax.jit``'s trace cache.

The JAX package runs each render entry (the exact, fast, hybrid and field
frames, present, the trig raster) as one ``jax.jit`` program with static
arguments: traced once for each value of them, then dispatched as one call.
In the port each entry is an eager function of torch ops and kernel
launches, which the module functions keep (``march_bonsai.render_frame``,
``shear_warp._render_fast``, ``hybrid._render_hybrid``, ...). A
:class:`CompiledFrame` holds, for each static key of an entry, one
``torch.cuda.CUDAGraph`` of that function:

- the first call with a key runs the function once on a side stream (the
  warm-up, which also does the lazy work: nvcc builds, the occupancy and
  hash tables, the caching allocator's blocks) and returns that frame; then
  it captures the function on static copies of the inputs, under
  ``torch.cuda.set_sync_debug_mode("error")``. A capture that fails raises,
  naming the entry and the key: nothing falls back to the eager function;
- a later call with the key copies its dynamic inputs (a camera uniform's
  tensors, a time) into the graph's static inputs, replays the graph, and
  returns a fresh copy of its outputs, so that a frame a caller keeps is
  never overwritten by the next replay.

The key is the caller's static key plus each input's shape and dtype: a new
uniform or a new time replays, a new width or a batch of another size
captures. A graph bakes in the addresses of the tensors it reads beyond its
inputs (a volume, packs, tables): the caller names them, the graph keeps
their :func:`stamp`, and a key captured under another stamp (another volume,
or one written in place) is captured again. Every graph of one CompiledFrame shares one memory pool.
A CompiledFrame made with ``maxsize`` holds at most that many keys, as
``functools.lru_cache(maxsize=...)`` around a ``jax.jit`` does: a new key
evicts the least recently used one, and its graph with it.

On any device but a card a call runs the eager function and records the
key only: that is the device the caller asked for. A call made while a graph
is being captured also runs the eager function, so that the outer graph
records it, as a jitted function called inside another one is inlined.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from vokselis_torch.core.camera import CameraUniform
from vokselis_torch.engine.profiler import span

# Python numbers among the inputs become 0-d tensors of this dtype in a graph
SCALAR_DTYPE = torch.float32


def _tensors(x):
    """The tensors of ``x``: a tensor, a :class:`CameraUniform` (its three),
    or a tuple or list of these (nested); anything else has none."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, CameraUniform):
        yield from x.tensors()
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)


def stamp(reads) -> tuple:
    """The identity of the tensors of ``reads`` (see :func:`_tensors`), which
    a graph reads beyond its inputs: each one's storage address and version
    counter (which every in-place write advances; an inference tensor has
    none)."""
    return tuple((t.data_ptr(), None if t.is_inference() else t._version)
                 for t in _tensors(reads))


def _signature(x):
    if isinstance(x, (torch.Tensor, CameraUniform)):
        return tuple((tuple(t.shape), t.dtype) for t in _tensors(x))
    if isinstance(x, (int, float)):
        return "scalar"
    return type(x).__name__


def _static(x, device):
    """A graph's static input for the input ``x``: a copy of a tensor or a
    uniform's tensors (without host mirrors), a 0-d tensor for a number."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, CameraUniform):
        return CameraUniform(*(t.clone() for t in x.tensors()))
    if isinstance(x, (int, float)):
        return torch.full((), x, dtype=SCALAR_DTYPE, device=device)
    raise TypeError(f"a compiled frame's inputs on a card are tensors, camera uniforms or "
                    f"numbers, got {type(x)}")


def _copy_into(static, x):
    if isinstance(x, (int, float)):
        static.fill_(x)
        return
    for s, t in zip(_tensors(static), _tensors(x)):
        if t.device != s.device:
            raise ValueError(f"an input is on {t.device}, the graph on {s.device}")
        s.copy_(t, non_blocking=True)


def _outputs(out, fn):
    """Apply ``fn`` to each tensor of ``out`` (a tensor or a tuple of them)."""
    if isinstance(out, tuple):
        return tuple(fn(t) for t in out)
    return fn(out)


class _Entry:
    """One key's graph, its static inputs and outputs, and the stamp of what
    it reads beyond its inputs."""

    __slots__ = ("graph", "inputs", "outputs", "stamp")

    def __init__(self, graph, inputs, outputs, stamp_):
        self.graph, self.inputs, self.outputs, self.stamp = graph, inputs, outputs, stamp_

    def replay(self, inputs, name):
        with span("compiled.copy_in", name):
            for static, x in zip(self.inputs, inputs):
                _copy_into(static, x)
        with span("compiled.replay", name):
            self.graph.replay()
        with span("compiled.copy_out", name):
            return _outputs(self.outputs, torch.Tensor.clone)


class CompiledFrame:
    """The trace cache of one renderer's entries (see the module's text).
    ``name`` names the renderer in errors; ``captures`` counts the graphs
    captured on a card, and off the card the keys recorded; ``pool`` is the
    graphs' shared memory pool, made at the first capture; ``maxsize``, if
    given, bounds the keys held (the least recently used goes first)."""

    def __init__(self, name: str, maxsize: int | None = None):
        self.name = name
        self.maxsize = maxsize
        self.pool = None
        self.captures = 0
        self._entries: OrderedDict = OrderedDict()

    def keys(self) -> list:
        """The keys held: ``(static key, input signatures)``."""
        return list(self._entries)

    def graph(self, full):
        """The ``torch.cuda.CUDAGraph`` of the key ``full`` (one of
        :meth:`keys`; the last is the most recently used), captured with
        ``keep_graph=True``."""
        return self._entries[full].graph

    def clear(self) -> None:
        """Drop every graph (after a kernel library is swapped: a graph keeps
        the old kernel's function)."""
        self._entries.clear()

    def drop(self, stale) -> None:
        """Drop the graph of every key whose static key ``stale`` accepts."""
        for full in [full for full in self._entries if stale(full[0])]:
            del self._entries[full]

    def _keep(self, full, entry) -> None:
        """Hold ``entry`` as the newest key, evicting the least recently used
        beyond ``maxsize``."""
        self._entries[full] = entry
        self._entries.move_to_end(full)
        self.captures += 1
        while self.maxsize is not None and len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)

    @torch.no_grad()
    def __call__(self, key: tuple, fn, inputs: tuple, reads=(), id: int | None = None):
        """``fn(*inputs)``, replayed on a card from the graph of ``key``.
        ``inputs``: tensors and camera uniforms on one device, and Python
        numbers (0-d float32 static inputs in the graph); a call whose
        inputs hold no tensor runs ``fn`` off the card. ``fn`` returns a
        tensor or a tuple of tensors and reads nothing that changes from
        call to call but its inputs and ``reads`` (tensors, or tuples of
        them, whose :func:`stamp` the graph keeps). On a card the call is
        the span ``compiled.call/<name>`` (:func:`engine.profiler.span`,
        of the frame or batch ``id``), holding ``compiled.copy_in``,
        ``compiled.replay`` and ``compiled.copy_out`` or, for a new key,
        ``compiled.capture``."""
        full = (key, tuple(_signature(x) for x in inputs))
        devices = {t.device for t in _tensors(inputs)}
        if len(devices) > 1:
            raise ValueError(f"{self.name}: the inputs of {key} are on "
                             f"{sorted(map(str, devices))}")
        on_card = bool(devices) and next(iter(devices)).type == "cuda"
        if not on_card:
            out = fn(*inputs)
            if full in self._entries:
                self._entries.move_to_end(full)
            else:
                self._keep(full, None)
            return out
        if torch.cuda.is_current_stream_capturing():
            return fn(*inputs)
        with span("compiled.call", self.name, id):
            entry, now = self._entries.get(full), stamp(reads)
            if entry is not None and entry.stamp == now:
                self._entries.move_to_end(full)
                return entry.replay(inputs, self.name)
            return self._capture(full, fn, inputs, now, next(iter(devices)))

    def _capture(self, full, fn, inputs, stamp_, dev):
        with span("compiled.capture", self.name), torch.cuda.device(dev):
            current = torch.cuda.current_stream()
            static = tuple(_static(x, dev) for x in inputs)
            side = torch.cuda.Stream()
            side.wait_stream(current)
            with torch.cuda.stream(side):
                out = fn(*inputs)
            current.wait_stream(side)
            _outputs(out, lambda t: t.record_stream(current))
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            # the graph itself is kept beside its executable: the kernels a
            # replay launches can be read from it (profiler.graph_kernels)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            try:
                with torch.cuda.graph(graph, pool=self.pool):
                    mode = torch.cuda.get_sync_debug_mode()
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        outputs = fn(*static)
                    finally:
                        torch.cuda.set_sync_debug_mode(mode)
                graph.instantiate()
            except Exception as e:
                raise RuntimeError(f"{self.name}: capturing the frame of key {full} into a "
                                   f"CUDA graph failed: {e}") from e
        self._keep(full, _Entry(graph, static, outputs, stamp_))
        return out
