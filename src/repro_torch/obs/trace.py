"""Span tracer + event log — the timing half of the observability layer.

Two instruments with different always-on contracts:

* ``SpanTracer`` (singleton ``TRACER``) records *spans* — named,
  categorized wall-clock intervals — and instant markers, exportable as
  Chrome trace-event JSON (``export_chrome_trace``) loadable in
  Perfetto or chrome://tracing.  It is **off by default**, and the
  disabled path is allocation-free: ``TRACER.span(...)`` is only ever
  called behind an ``if TRACER.enabled`` guard at hot call sites (the
  serving loop), with the shared ``NOOP_SPAN`` singleton taken on the
  else branch — no argument dict, no context-manager object, nothing
  for the GC.  The idiom::

      with (TRACER.span("serve.execute", "serving", {...})
            if TRACER.enabled else NOOP_SPAN):
          ...

  costs one attribute read and one branch when tracing is off.

* ``EventLog`` (singleton ``EVENTS``) is **always on**: a small bounded
  ring of operator-relevant events (watchdog timeouts, plan-cache
  evictions, arbiter rebalances, calibration drift trips) that would
  otherwise be invisible.  Events mirror into the tracer as instant
  markers when it is enabled, so a trace shows them on the timeline.

Thread safety: both instruments take a lock per record; spans carry the
recording thread's id so multi-threaded traces lay out per-thread in
Perfetto.  Buffers are bounded (drops are counted, never silent).
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

# Bounded buffers: a serving process must not grow without limit just
# because someone left tracing on.
TRACE_BUFFER_MAX = 100_000
EVENT_LOG_MAX = 1024

_PID = 1    # one process; Chrome's pid slot is a display group here


class _NoopSpan:
    """The shared disabled-path context manager: enter/exit do nothing,
    and the single module-level instance (``NOOP_SPAN``) means the
    disabled hot path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class _Span:
    """One live span: records a Chrome 'X' (complete) event on exit."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str,
                 args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = time.perf_counter_ns()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._tracer._record({
            "name": self.name,
            "cat": self.cat or "default",
            "ph": "X",
            "ts": self._t0 / 1e3,           # Chrome wants microseconds
            "dur": (t1 - self._t0) / 1e3,
            "pid": _PID,
            "tid": threading.get_ident(),
            **({"args": self.args} if self.args else {}),
        })
        return False


class SpanTracer:
    """Span recorder; see module docstring.  Use the ``TRACER``
    singleton — one process, one timeline."""

    def __init__(self, max_events: int = TRACE_BUFFER_MAX):
        self.enabled = False
        self.max_events = max_events
        self.dropped = 0
        self._events: List[dict] = []
        self._lock = threading.Lock()

    # -- control ------------------------------------------------------------
    def enable(self) -> "SpanTracer":
        self.enabled = True
        return self

    def disable(self) -> "SpanTracer":
        self.enabled = False
        return self

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    # -- recording ----------------------------------------------------------
    def span(self, name: str, cat: str = "",
             args: Optional[dict] = None):
        """A context manager timing one span.  Hot call sites must guard
        with ``if TRACER.enabled`` and take ``NOOP_SPAN`` otherwise (the
        allocation-free contract); calling this while disabled still
        returns ``NOOP_SPAN`` so un-guarded cold sites stay correct."""
        if not self.enabled:
            return NOOP_SPAN
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "",
                args: Optional[dict] = None) -> None:
        """A zero-duration marker (Chrome 'i' event)."""
        if not self.enabled:
            return
        self._record({
            "name": name,
            "cat": cat or "default",
            "ph": "i",
            "s": "t",                       # thread-scoped marker
            "ts": time.perf_counter_ns() / 1e3,
            "pid": _PID,
            "tid": threading.get_ident(),
            **({"args": args} if args else {}),
        })

    def _record(self, event: dict) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(event)

    # -- export -------------------------------------------------------------
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def export_chrome_trace(self, indent: Optional[int] = None) -> str:
        """The buffered spans as Chrome trace-event JSON (the
        ``traceEvents`` array-of-objects form Perfetto and
        chrome://tracing both load)."""
        return json.dumps({
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }, indent=indent)

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled, "events": len(self._events),
                    "dropped": self.dropped, "capacity": self.max_events}


TRACER = SpanTracer()


class EventLog:
    """Always-on bounded ring of operator events; see module docstring."""

    def __init__(self, max_events: int = EVENT_LOG_MAX):
        self.max_events = max_events
        self.total = 0
        self._events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    def log(self, kind: str, **fields) -> None:
        """Record one event.  ``kind`` is a dotted taxonomy name
        (``"watchdog.timeout"``, ``"plan_cache.evict"``); fields are
        free-form JSON-able payload.  Mirrors into the tracer as an
        instant marker when tracing is on."""
        event = {"kind": kind, "t": time.time(), **fields}
        with self._lock:
            self.total += 1
            self._events.append(event)
            if len(self._events) > self.max_events:
                del self._events[:len(self._events) - self.max_events]
        if TRACER.enabled:
            TRACER.instant(kind, "events", fields or None)

    def recent(self, n: int = 50, kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            events = list(self._events)
        if kind is not None:
            events = [e for e in events if e["kind"] == kind]
        return events[-n:]

    def counts(self) -> Dict[str, int]:
        """Events per kind currently in the ring (bounded window)."""
        out: Dict[str, int] = {}
        with self._lock:
            for e in self._events:
                out[e["kind"]] = out.get(e["kind"], 0) + 1
        return out

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.total = 0


EVENTS = EventLog()


def log_event(kind: str, **fields) -> None:
    """Module-level shorthand for ``EVENTS.log`` — what the planner,
    watchdog, arbiter and drift monitor call."""
    EVENTS.log(kind, **fields)
