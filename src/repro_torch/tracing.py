"""Spans inside the port's serving path, on the profiler's clock.

A span marks one stage of the work (a ``serve`` call, one layer, the
staging of its input, its GEMM, ...).  It records only while a
``torch.profiler`` records, on whichever thread it opens; otherwise
:func:`span` returns one shared no-op context and costs a function call
and a flag read.  There is no
setting: profile a ``serve`` call, or run the benchmark with
``--trace 1``, and the spans are there.

A span that records:

* opens ``torch.profiler.record_function(name)``, so it shows in the
  profiler's trace as a ``user_annotation`` range on the same clock as
  the runtime calls and device operations it encloses (on every thread
  the profiler records: by default the thread that started it);
* notes its name (every name starts with ``repro_torch.``), its id, the
  call id of its root span (the outermost open span of its thread, a
  ``serve`` call), its parent, its thread, its attributes (a layer's
  index and name, the ``bytes`` it wrote), and its host start and end
  (``time.perf_counter_ns``);
* on a CUDA device, records a timing event on the device's current
  stream at entry and exit.  The elapsed time is read in
  :func:`snapshot`, after the call's own synchronising copy, so a span
  adds no synchronisation to a call; events read are used again.  A root
  span names the device and reads its current stream; the spans inside
  take both from their parent.

The log keeps at most :data:`CAPACITY` spans in memory; later spans
still open their profiler range but are counted as dropped.
:func:`snapshot` reads the log without clearing it; :func:`clear`
empties it.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, Iterable, List, Optional

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 65_536
PREFIX = "repro_torch."
ROOT = "repro_torch.serve"
# Chrome-trace categories of the operations on the device, and of the
# runtime calls on the host that launch them
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


class _Noop:
    """The span returned while nothing records: enters, sets and exits
    without a trace."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NOOP = _Noop()


class _Span:
    __slots__ = ("log", "name", "id", "call", "parent", "thread", "device",
                 "stream", "attrs", "start_ns", "end_ns", "events",
                 "device_ms", "_range")

    def __init__(self, log: "SpanLog", name: str,
                 device: Optional[torch.device], attrs: dict):
        if not name.startswith(PREFIX):
            raise ValueError(f"span name {name!r} does not start with "
                             f"{PREFIX!r}")
        self.log, self.name, self.device, self.attrs = log, name, device, attrs
        self.start_ns = self.end_ns = self.stream = None
        self.events = self.device_ms = None

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span (``bytes``)."""
        self.attrs.update(attrs)

    def __enter__(self):
        log = self.log
        stack = log._open()
        parent = stack[-1] if stack else None
        self.id = next(log._ids)
        self.parent = parent.id if parent else None
        self.call = parent.call if parent else self.id
        self.thread = threading.get_ident()
        if self.device is None and parent is not None:
            self.device, self.stream = parent.device, parent.stream
        elif self.device is not None and self.device.type == "cuda":
            self.stream = torch.cuda.current_stream(self.device)
        log._append(self)
        stack.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        if self.stream is not None:
            self.events = (log._event(), log._event())
            self.events[0].record(self.stream)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(self.stream)
        self._range.__exit__(*exc)
        self._range = None
        stack = self.log._open()
        if stack and stack[-1] is self:
            stack.pop()
        return False

    def record(self) -> dict:
        if self.events is not None and self.end_ns is not None:
            start, end = self.events
            end.synchronize()
            self.device_ms = start.elapsed_time(end)
            self.log._free.extend(self.events)
            self.events = None
        return {"name": self.name, "id": self.id, "call": self.call,
                "parent": self.parent, "thread": self.thread,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "device_ms": self.device_ms, "attrs": dict(self.attrs)}


class SpanLog:
    """The spans of a process: a bounded list in start order, and a stack
    of open spans for each thread."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self._spans: List[_Span] = []
        self._dropped = 0
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._free: List[torch.cuda.Event] = []     # events read, for reuse

    def _open(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _event(self) -> "torch.cuda.Event":
        try:
            return self._free.pop()
        except IndexError:
            return torch.cuda.Event(enable_timing=True)

    def _append(self, s: _Span) -> None:
        with self._lock:
            if len(self._spans) < self.capacity:
                self._spans.append(s)
            else:
                self._dropped += 1

    def span(self, name: str, /, *, device: Optional[torch.device] = None,
             **attrs):
        """A context for one stage of the work, recorded while a profiler
        records (see the module's docstring); ``device`` is a root span's.
        The context's ``set(**attrs)`` adds attributes known only inside."""
        # the profiler's own flag, set from its start to its stop on every
        # thread: torch._C._autograd._profiler_enabled() is thread-local,
        # and reads False on a serving worker's thread and on every thread
        # where the profiler records all threads
        if not _profiler._is_profiler_enabled:
            return NOOP
        return _Span(self, name, device, attrs)

    def snapshot(self) -> Dict[str, object]:
        """Every span logged, in start order, each a dict: ``name``,
        ``id``, ``call``, ``parent``, ``thread``, ``start_ns``, ``end_ns``
        (None while open), ``device_ms`` (None off a CUDA device or while
        open) and ``attrs``; and how many spans were ``dropped``.  Waits
        for a span's closing event where the device has not reached it."""
        with self._lock:
            spans, dropped = list(self._spans), self._dropped
        return {"spans": [s.record() for s in spans], "dropped": dropped,
                "capacity": self.capacity}

    def clear(self) -> None:
        with self._lock:
            self._spans, self._dropped = [], 0


_LOG = SpanLog()
span = _LOG.span


def snapshot() -> Dict[str, object]:
    """The process's span log (:meth:`SpanLog.snapshot`)."""
    return _LOG.snapshot()


def clear() -> None:
    """Empty the process's span log."""
    _LOG.clear()


def attribute(events: Iterable[dict]) -> List[dict]:
    """Each device operation of an exported Chrome trace (its
    ``traceEvents``) put down to the span that launched it: the runtime
    call with its correlation id, then the innermost ``repro_torch.``
    annotation open on that call's thread at that time.  Returns one dict
    an operation, in start order: ``name``, ``ts`` and ``dur`` (µs on the
    profiler's clock), ``span`` (that annotation's name, or None),
    ``span_ts`` (its start on the host, which tells its instances apart)
    and ``in_serve`` (whether the launch lies inside a :data:`ROOT`
    span)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks: Dict[object, list] = {}
    launches: Dict[object, tuple] = {}
    for e in xs:
        cat, ts = e.get("cat"), float(e["ts"])
        if cat == "user_annotation" and e["name"].startswith(PREFIX):
            marks.setdefault(e.get("tid"), []).append(
                (ts, ts + float(e["dur"]), e["name"]))
        elif cat in RUNTIME_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), ts)
    out = []
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        tid, ts = launches.get(e.get("args", {}).get("correlation"),
                               (None, None))
        around = [m for m in marks.get(tid, ())
                  if ts is not None and m[0] <= ts <= m[1]]
        inner = max(around, key=lambda m: (m[0], -m[1]), default=None)
        out.append({"name": e["name"], "ts": float(e["ts"]),
                    "dur": float(e["dur"]),
                    "span": inner[2] if inner else None,
                    "span_ts": inner[0] if inner else None,
                    "in_serve": any(m[2] == ROOT for m in around)})
    return sorted(out, key=lambda o: o["ts"])
