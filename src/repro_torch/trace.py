"""The port's tracer: host spans at the layer boundaries of a served request,
device spans around CUDA-graph replays, and the module of each node of a
captured graph. Off by default.

:func:`enable` and :func:`disable` switch one process-wide flag. Off, every
entry point returns the one shared :data:`NULL` context, which reads no
clock, records no event and allocates nothing. On:

* :func:`span` records a :class:`Span` (name, id, parent id, request id,
  host start and end in ``time.perf_counter_ns()``, attributes) into an
  in-memory list, :func:`records`; nothing is written to a file. Spans nest
  by a stack (serving runs on one thread); a span without a ``request_id``
  takes its parent's. While a ``torch.profiler`` records, each span is also
  a ``record_function`` range, so it lies on the profiler's clock beside
  the device's operations; a span with a ``key`` adds it to the range's
  name (``graph.replay[decode,1,1024,128]``).
* :func:`device_span` records a pair of timing CUDA events on the current
  stream, resolved only when read (:func:`device_spans`), so the hot path
  never waits for the device. Each is placed on the host clock by the
  newest anchor before it: an event recorded while the device was idle, at
  :func:`enable` after a synchronize and again at :func:`anchor`.
* :func:`scope` marks a module of the model (``attention``, ``ffn``,
  ``mamba2``, ``shared_block``, ``logits``). Inside a capture
  (:func:`capture`) it reads only the node that the capturing stream's next
  node will follow, through libcuda; at its end the capture walks
  the graph's chain of nodes back from its last and maps each scope to the
  range of the graph's operations (kernel, memcpy and memset nodes) it
  recorded. One stream records a chain, so a replay runs the nodes in that
  order; a graph that is not one chain gets no map. Outside a capture a
  scope is a ``record_function`` range while a profiler records.

:func:`scope_times` puts one launch's device operations down to those
ranges, and the device's waits between them apart; :func:`self_ms` gives a
span's time less its children's. The records grow for as long as the
tracer is on: a caller turns it on before it builds the engine, so that
the captures record their scope maps, and :func:`clear` empties them.
"""
from __future__ import annotations

import ctypes
import time
from typing import Optional

import torch

_on = False
_records: list["Span"] = []
_stack: list["Span"] = []
_devices: list["_DeviceSpan"] = []
_anchors: list[tuple[torch.cuda.Event, int]] = []  # (event, host ns when recorded)
_capture: Optional["_Capture"] = None

# CUgraphNodeType of the nodes a replay runs as device operations: kernel,
# memcpy, memset
_OP_NODES = (0, 1, 2)
_CAPTURE_ACTIVE = 1  # CU_STREAM_CAPTURE_STATUS_ACTIVE
_libcuda_handle: Optional[ctypes.CDLL] = None


class _Null:
    """What every entry point returns while the tracer is off."""

    scopes = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


NULL = _Null()


def enable() -> None:
    """Turn the tracer on; on a machine with a card, synchronize and record
    the first anchor."""
    global _on
    _on = True
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        _record_anchor()


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def clear() -> None:
    """Drop every record, device span and anchor."""
    _records.clear()
    _stack.clear()
    _devices.clear()
    _anchors.clear()


def records() -> list["Span"]:
    """The host spans recorded so far, in the order they opened."""
    return _records


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


def _label(name: str, key) -> str:
    return name if key is None else f"{name}[{label(key)}]"


def label(key: tuple) -> str:
    """A graph key as it appears in a profiler range's name."""
    return ",".join(str(k) for k in key)


class Span:
    """One host span; ``t1`` is None while it is open."""

    __slots__ = ("name", "id", "parent", "request_id", "t0", "t1", "attrs", "_range")

    def __init__(self, name: str, attrs: dict) -> None:
        self.name = name
        self.attrs = attrs
        self.t1: Optional[int] = None
        self._range = None

    def __enter__(self) -> "Span":
        parent = _stack[-1] if _stack else None
        self.id = len(_records)
        self.parent = parent.id if parent is not None else None
        self.request_id = self.attrs.pop(
            "request_id", parent.request_id if parent is not None else None)
        _records.append(self)
        _stack.append(self)
        if _profiling():
            self._range = torch.autograd.profiler.record_function(
                _label(self.name, self.attrs.get("key")))
            self._range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _stack.pop()
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) * 1e-6


def span(name: str, **attrs):
    """A host span named ``name`` (a context manager; ``set(**attrs)`` adds
    attributes while it is open). ``request_id`` sets the request of it and
    of its children; ``key`` names a graph."""
    if not _on:
        return NULL
    return Span(name, attrs)


class _DeviceSpan:
    __slots__ = ("name", "span", "anchor", "e0", "e1")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "_DeviceSpan":
        self.span = _stack[-1].id if _stack else None
        self.anchor = len(_anchors) - 1
        self.e0 = torch.cuda.Event(enable_timing=True)
        self.e0.record()
        return self

    def __exit__(self, *exc) -> bool:
        self.e1 = torch.cuda.Event(enable_timing=True)
        self.e1.record()
        _devices.append(self)
        return False


def device_span(name: str):
    """Timing events before and after the block on the current stream
    (never inside a capture); the span that encloses it is its parent."""
    if not _on:
        return NULL
    return _DeviceSpan(name)


def _record_anchor() -> None:
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    _anchors.append((e, time.perf_counter_ns()))


def anchor(device: torch.device) -> None:
    """Record a new anchor on ``device``, where the host has just waited for
    the device to finish (a request's read-back)."""
    if _on and device.type == "cuda":
        _record_anchor()


def device_spans() -> list[tuple[str, Optional[int], Optional[int], float]]:
    """Every device span as (name, parent span id, start on the host clock
    in ns or None without an anchor, ms). Waits for the device."""
    if _devices:
        torch.cuda.synchronize()
    out = []
    for d in _devices:
        start = None
        if d.anchor >= 0:
            a, t = _anchors[d.anchor]
            start = t + round(a.elapsed_time(d.e0) * 1e6)
        out.append((d.name, d.span, start, d.e0.elapsed_time(d.e1)))
    return out


# ---------------------------------------------------------------------------
# the module of each node of a captured graph
# ---------------------------------------------------------------------------


def _libcuda() -> ctypes.CDLL:
    """libcuda, CUDA's own library, bound at first use (never at import: the
    CPU tests import every module on machines without it)."""
    global _libcuda_handle
    if _libcuda_handle is None:
        lib = ctypes.CDLL("libcuda.so.1")
        p, size = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
        lib.cuStreamGetCaptureInfo_v2.argtypes = [
            p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(p), ctypes.POINTER(ctypes.POINTER(p)), size]
        lib.cuGraphGetNodes.argtypes = [p, p, size]
        lib.cuGraphNodeGetDependencies.argtypes = [p, p, size]
        lib.cuGraphNodeGetType.argtypes = [p, ctypes.POINTER(ctypes.c_int)]
        for fn in (lib.cuStreamGetCaptureInfo_v2, lib.cuGraphGetNodes,
                   lib.cuGraphNodeGetDependencies, lib.cuGraphNodeGetType):
            fn.restype = ctypes.c_int
        _libcuda_handle = lib
    return _libcuda_handle


def _check(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUresult {err}")


class _Capture:
    """The scope marks of one capture, each (scope, the node captured last
    before it, the node captured last in it; None before the first), and
    once the capture's block has ended without an error, ``scopes``: None
    where the graph is not one chain of nodes."""

    def __init__(self) -> None:
        self.marks: list[tuple[str, Optional[int], Optional[int]]] = []
        self.scopes: Optional[list[tuple[str, int, int]]] = None
        self.graph = ctypes.c_void_p()
        self.chain = True
        self.open: Optional[str] = None  # the scope open now

    def _info(self) -> tuple[int, list]:
        status, cid = ctypes.c_int(), ctypes.c_uint64()
        deps, n = ctypes.POINTER(ctypes.c_void_p)(), ctypes.c_size_t()
        _check("cuStreamGetCaptureInfo", _libcuda().cuStreamGetCaptureInfo_v2(
            self.stream, ctypes.byref(status), ctypes.byref(cid), ctypes.byref(self.graph),
            ctypes.byref(deps), ctypes.byref(n)))
        return status.value, [deps[i] for i in range(n.value)]

    def __enter__(self) -> "_Capture":
        global _capture
        self.stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if self._info()[0] != _CAPTURE_ACTIVE:
            raise RuntimeError("trace.capture() outside a stream capture")
        _capture = self
        return self

    def frontier(self) -> Optional[int]:
        """The node the stream's next one will follow (None at the start)."""
        deps = self._info()[1]
        if len(deps) > 1:
            self.chain = False
        return deps[0] if deps else None

    def _order(self) -> Optional[list[int]]:
        """The graph's nodes from first to last, walked back from the
        frontier; None where a node has more than one dependency or the
        walk misses a node."""
        order, node = [], self.frontier()
        deps, n = (ctypes.c_void_p * 2)(), ctypes.c_size_t()
        while node is not None:
            order.append(node)
            n.value = 2
            _check("cuGraphNodeGetDependencies", _libcuda().cuGraphNodeGetDependencies(
                node, deps, ctypes.byref(n)))
            if n.value > 1:
                return None
            node = deps[0] if n.value else None
        total = ctypes.c_size_t(0)
        _check("cuGraphGetNodes", _libcuda().cuGraphGetNodes(self.graph, None,
                                                            ctypes.byref(total)))
        return order[::-1] if len(order) == total.value and self.chain else None

    def __exit__(self, exc_type, *exc) -> bool:
        global _capture
        _capture = None
        order = self._order() if exc_type is None else None
        if order is not None:
            t = ctypes.c_int()
            types = []
            for node in order:
                _check("cuGraphNodeGetType", _libcuda().cuGraphNodeGetType(node, ctypes.byref(t)))
                types.append(t.value)
            self.scopes = op_ranges(chain_marks(self.marks, order), types)
        return False


def chain_marks(marks: list[tuple[str, Optional[int], Optional[int]]],
                order: list[int]) -> list[tuple[str, int, int]]:
    """Marks by node (the node before the scope, its last node) as node
    counts along ``order``, the chain of the graph's nodes."""
    at = {node: i + 1 for i, node in enumerate(order)}
    return [(name, at[a] if a is not None else 0, at[b] if b is not None else 0)
            for name, a, b in marks]


def capture():
    """Around the body of a CUDA-graph capture, inside the capture: the
    object it yields holds the graph's scope map in ``scopes`` once the
    block has ended (None while the tracer is off)."""
    if not _on:
        return NULL
    return _Capture()


class _Scope:
    __slots__ = ("name", "start", "_range")

    def __init__(self, name: str) -> None:
        self.name = name
        self._range = None

    def __enter__(self) -> "_Scope":
        if _capture is not None:
            if _capture.open is not None:
                raise RuntimeError(f"scope {self.name!r} opened inside scope "
                                   f"{_capture.open!r}: scopes do not nest")
            _capture.open = self.name
            self.start = _capture.frontier()
        elif _profiling():
            self._range = torch.autograd.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if _capture is not None:
            _capture.open = None
            _capture.marks.append((self.name, self.start, _capture.frontier()))
        elif self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


def scope(name: str):
    """Mark the nodes (in a capture) or the eager operations (under a
    profiler) of one module of the model. Scopes do not nest: inside a
    capture, a scope opened in another raises."""
    if not _on:
        return NULL
    return _Scope(name)


def op_ranges(marks: list[tuple[str, int, int]],
              node_types: list[int]) -> list[tuple[str, int, int]]:
    """A graph's scope map: (scope, first operation, end) over its
    operations in capture order, from ``marks`` in node counts and each
    node's type; what no scope marked is ``other``."""
    before = [0]
    for t in node_types:
        before.append(before[-1] + (t in _OP_NODES))
    out: list[tuple[str, int, int]] = []
    at = 0
    for name, a, b in marks:
        a, b = before[a], before[b]
        if a > at:
            out.append(("other", at, a))
        if b > a:
            out.append((name, a, b))
        at = max(at, b)
    if before[-1] > at:
        out.append(("other", at, before[-1]))
    return out


GAPS = "gaps"  # scope_times' key for the device waiting between a graph's nodes


def scope_times(scope_map: list[tuple[str, int, int]],
                launch_ops: list[tuple]) -> Optional[dict[str, float]]:
    """Device seconds by scope of one graph launch: ``launch_ops`` are its
    device operations as (name, start us, duration us), ordered by start,
    the ``i``-th the ``i``-th of ``scope_map``. A scope holds its
    operations' own time; the time from one operation's end to the next
    one's start, where the device waited for the graph's next node, is
    under :data:`GAPS`; so the values sum to the launch's span on the
    device. None where the launch ran another number of operations than
    the map holds."""
    n = scope_map[-1][2] if scope_map else 0
    if len(launch_ops) != n or n == 0:
        return None
    out: dict[str, float] = {GAPS: 0.0}
    end = launch_ops[0][1]
    for name, a, b in scope_map:
        busy = 0.0
        for _, s, d in launch_ops[a:b]:
            out[GAPS] += max(0.0, s - end) * 1e-6
            busy += max(0.0, s + d - max(s, end))
            end = max(end, s + d)
        out[name] = out.get(name, 0.0) + busy * 1e-6
    return out


def self_ms(spans: list[Span], name: str) -> dict[int, float]:
    """{span id: ms} of each closed span named ``name``, less the time of
    its direct children."""
    children: dict[int, float] = {}
    for s in spans:
        if s.parent is not None and s.t1 is not None:
            children[s.parent] = children.get(s.parent, 0.0) + s.ms
    return {s.id: s.ms - children.get(s.id, 0.0)
            for s in spans if s.name == name and s.t1 is not None}
