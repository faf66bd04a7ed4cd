"""Thread-safe span tracer with Chrome/Perfetto trace-event export.

One module-level tracer serves the whole process: instrumentation sites
call ``span("replay.scan", rows=K)`` unconditionally, and the call is a
near-zero-cost no-op until someone calls `enable()` (a module attribute
load, a None check, and one small dict — no locks, no clock reads).  When
enabled, every span records wall time from a MONOTONIC clock
(`time.perf_counter` by default; inject a virtual clock for deterministic
tests), the recording thread (executor worker, streamer staging pool,
main), and its same-thread parent span, then lands in one shared event
buffer under a lock.

Export is the Chrome trace-event JSON format (``"X"`` complete events +
thread-name metadata), so a serve run's trace opens directly in
``ui.perfetto.dev`` or ``chrome://tracing`` — spans nest per thread by
timestamp containment, and cross-thread work (a scan on the executor
thread overlapping a window stage on the prefetch pool) shows as parallel
tracks.

Roofline hook: a span opened with a ``pred_s=<seconds>`` attribute (see
`repro_torch.roofline.replay`) closes with ``measured_s`` and
``roofline_ratio`` (measured / predicted) computed into its args, so
every replay span in the exported trace carries predicted-vs-measured
cost.  A span times HOST work: on the card, one that closes before its
kernels finish reads dispatch time, not device time.

See `repro_torch.obs` for the span/metric naming contract.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Tracer", "Span", "NOOP_SPAN", "span", "enable", "disable",
           "enabled", "get_tracer"]

_active: Optional["Tracer"] = None


def enabled() -> bool:
    """True when a tracer is installed (use to gate attr computation that
    would otherwise run on the disabled hot path)."""
    return _active is not None


def get_tracer() -> Optional["Tracer"]:
    return _active


def enable(tracer: Optional["Tracer"] = None) -> "Tracer":
    """Install (and return) the process tracer.  ``enable()`` with no
    argument reuses the current tracer or creates a fresh one."""
    global _active
    _active = tracer if tracer is not None else (_active or Tracer())
    return _active


def disable() -> Optional["Tracer"]:
    """Uninstall the tracer (spans become no-ops again); returns it so the
    caller can still export what was recorded."""
    global _active
    t, _active = _active, None
    return t


class _NoopSpan:
    """Shared do-nothing span handed out while tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()


def span(name: str, **attrs):
    """``with span("replay.scan", rows=K): ...`` — the one instrumentation
    entry point.  Disabled: returns the shared no-op span immediately."""
    t = _active
    if t is None:
        return NOOP_SPAN
    return Span(t, name, attrs)


class Span:
    """One live span (context manager).  `set(**attrs)` adds args mid-span
    (e.g. a result size known only after the work ran)."""

    __slots__ = ("tracer", "name", "args", "t0")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.t0 = 0.0

    def set(self, **attrs) -> "Span":
        self.args.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self.tracer._stack().append(self.name)
        self.t0 = self.tracer.clock()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self.tracer
        t1 = tr.clock()
        stack = tr._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        args = self.args
        pred = args.get("pred_s")
        if pred:
            dur = max(t1 - self.t0, 0.0)
            args["measured_s"] = dur
            args["roofline_ratio"] = dur / float(pred)
        if stack:
            args.setdefault("parent", stack[-1])
        tr._record(self.name, self.t0, t1, args)
        return False


def _jsonable(v):
    """Chrome-export fallback for non-JSON arg values (numpy scalars,
    dtypes, exceptions, ...)."""
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class Tracer:
    """Event buffer + clock.  Thread-safe: spans may open and close on any
    thread; each thread keeps its own nesting stack (`threading.local`)
    and all completed spans serialize into one buffer under a lock."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 max_events: int = 1_000_000):
        self.clock = clock
        self.max_events = int(max_events)
        self.dropped = 0
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._tls = threading.local()
        self._tids: Dict[int, int] = {}
        self._tid_names: Dict[int, str] = {}
        self._t0 = clock()  # trace epoch: ts are relative microseconds

    # -- per-thread nesting ------------------------------------------------

    def _stack(self) -> List[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    # -- recording ---------------------------------------------------------

    def _record(self, name: str, t0: float, t1: float,
                args: Dict[str, Any]) -> None:
        ident = threading.get_ident()
        thread_name = threading.current_thread().name
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            tid = self._tids.get(ident)
            if tid is None:
                tid = self._tids[ident] = len(self._tids)
                self._tid_names[tid] = thread_name
            self._events.append({
                "name": name, "ph": "X", "pid": 0, "tid": tid,
                "ts": (t0 - self._t0) * 1e6,
                "dur": max(t1 - t0, 0.0) * 1e6,
                "args": args,
            })

    # -- introspection / export --------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._events]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def to_chrome(self) -> Dict[str, Any]:
        """The trace as a Chrome trace-event JSON document (a dict ready
        for `json.dump`): thread-name metadata first, then every completed
        span as a ``"X"`` complete event in completion order."""
        with self._lock:
            meta = [{"name": "thread_name", "ph": "M", "pid": 0,
                     "tid": tid, "args": {"name": nm}}
                    for tid, nm in sorted(self._tid_names.items())]
            return {"traceEvents": meta + [dict(e) for e in self._events],
                    "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, default=_jsonable)
        return path
