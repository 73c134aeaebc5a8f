"""Request tracing for a serving replica (stdlib only).

Own copy of the part of ``elastic_gpu_scheduler_tpu/tracing`` that a
serving replica runs, with the reference's span names, ``traceparent``
format, ``TPU_TRACE_SAMPLE`` knob and ``/traces`` JSON shapes, so the
reference's router and trace assembler read a port replica as they read a
JAX one:

- **Spans.**  A thread-safe ring of finished spans with W3C trace and
  span ids, wall and monotonic stamps and attributes.  Old traces evict
  first in, first out, except spans of **pinned** traces (a live SSE
  stream pins its own): those park in a bounded store of their own until
  unpinned; an overflow there is counted in
  ``tpu_metrics_dropped_samples_total{reason="trace_pin_cap"}``.
- **Propagation.**  ``traceparent`` (``00-<trace>-<span>-<flags>``) on
  the HTTP request joins the client's trace; the request's span context
  rides on the engine's ``Request`` so the engine thread drops its
  ``engine.queued`` / ``engine.admitted`` points into the same trace.
- **Sampling.**  ``TPU_TRACE_SAMPLE`` (or ``Tracer.configure``): 1.0
  traces everything (the default), 0 < p < 1 samples per trace, 0
  disables; an unsampled span is the shared no-op span.

The scheduler's pod-scoped traces and decision audit are control-plane
code and stay in the reference.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from typing import Optional

__all__ = [
    "Span",
    "SpanContext",
    "Tracer",
    "TRACER",
    "TRACEPARENT_HEADER",
    "format_traceparent",
    "parse_traceparent",
    "traces_response",
]

TRACEPARENT_HEADER = "traceparent"


def _gen_trace_id() -> str:
    return os.urandom(16).hex()


def _gen_span_id() -> str:
    return os.urandom(8).hex()


class SpanContext:
    """Immutable (trace_id, span_id, sampled) triple: what propagates."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    def traceparent(self) -> str:
        return format_traceparent(self)


def format_traceparent(ctx) -> str:
    """W3C traceparent: version 00, 16-byte trace id, 8-byte span id,
    flags (01 = sampled)."""
    if not ctx:
        return ""
    flags = "01" if getattr(ctx, "sampled", True) else "00"
    return f"00-{ctx.trace_id}-{ctx.span_id}-{flags}"


_HEX = frozenset("0123456789abcdef")


def _is_hex(s: str, n: int) -> bool:
    # per character: int(x, 16) accepts underscores and signs, which would
    # pass malformed ids on downstream
    return len(s) == n and all(c in _HEX for c in s)


def parse_traceparent(value: str) -> Optional[SpanContext]:
    """``00-<32 hex>-<16 hex>-<2 hex>`` → SpanContext, or None for any
    malformed value (a bad header never fails the request carrying it)."""
    if not value or not isinstance(value, str):
        return None
    parts = value.strip().lower().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if not (_is_hex(version, 2) and _is_hex(trace_id, 32) and _is_hex(span_id, 16)
            and _is_hex(flags, 2)):
        return None
    if version == "ff":  # forbidden by the W3C spec
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id, span_id, sampled=bool(int(flags, 16) & 1))


class _NoopSpan:
    """The shared span of the unsampled path: every method a constant
    return, falsy, usable as a context manager."""

    __slots__ = ()

    trace_id = ""
    span_id = ""
    name = ""

    def __bool__(self) -> bool:
        return False

    def set_attr(self, key, value) -> "_NoopSpan":
        return self

    def event(self, name, **attrs) -> "_NoopSpan":
        return self

    def context(self) -> Optional[SpanContext]:
        return None

    def traceparent(self) -> str:
        return ""

    def end(self, status: str = "ok") -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class Span:
    """One timed operation.  The thread that opened it mutates it;
    ``event`` appends atomically, so other threads may annotate."""

    __slots__ = (
        "tracer", "trace_id", "span_id", "parent_id", "name",
        "t_wall", "t0", "duration", "attrs", "events", "status",
        "_on_stack",
    )

    def __init__(self, tracer, trace_id, parent_id, name, attrs=None):
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = _gen_span_id()
        self.parent_id = parent_id
        self.name = name
        self.t_wall = time.time()
        self.t0 = time.perf_counter()
        self.duration: Optional[float] = None  # None while open
        self.attrs: dict = dict(attrs) if attrs else {}
        self.events: list = []
        self.status = "ok"
        self._on_stack = False

    def __bool__(self) -> bool:
        return True

    def set_attr(self, key, value) -> "Span":
        self.attrs[key] = value
        return self

    def event(self, name, **attrs) -> "Span":
        self.events.append({"name": name, "t": time.perf_counter() - self.t0, **attrs})
        return self

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def traceparent(self) -> str:
        return format_traceparent(self.context())

    def end(self, status: Optional[str] = None) -> None:
        if self.duration is not None:
            return  # a second end keeps the first timing
        self.duration = time.perf_counter() - self.t0
        if status is not None:
            self.status = status
        self.tracer._finish(self)

    def __enter__(self) -> "Span":
        self.tracer._push(self)
        self._on_stack = True
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._on_stack:
            self.tracer._pop(self)
            self._on_stack = False
        if exc_type is not None:
            self.set_attr("error", f"{exc_type.__name__}: {exc}")
            self.end(status="error")
        else:
            self.end()
        return False

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_unix": round(self.t_wall, 6),
            "duration_ms": (round(self.duration * 1000, 3)
                            if self.duration is not None else None),
            "status": self.status,
            "attrs": self.attrs,
            "events": [{**e, "t": round(e["t"] * 1000, 3)} for e in self.events],
        }


class Tracer:
    """Ring-buffer tracer: finished spans in a ``deque(maxlen=capacity)``
    under one small lock, the active-span stack thread-local."""

    def __init__(self, capacity: int = 4096, sample: Optional[float] = None,
                 pinned_capacity: int = 4096):
        if sample is None:
            try:
                sample = float(os.environ.get("TPU_TRACE_SAMPLE", "1"))
            except ValueError:
                sample = 1.0
        self.sample = max(0.0, min(1.0, sample))
        self.capacity = capacity
        self.pinned_capacity = pinned_capacity
        self._spans: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.dropped = 0  # spans evicted from the ring
        # pinned traces: trace_id → pin count.  Their finished spans park
        # in _pinned_spans, bounded by pinned_capacity over all traces; an
        # overflow evicts the oldest parked span and is counted
        self._pinned: dict[str, int] = {}
        self._pinned_spans: dict[str, list] = {}
        self._pin_ring: deque = deque()  # trace ids in park order
        self._pin_count = 0
        self.dropped_pinned = 0

    # -- config --------------------------------------------------------------

    def configure(self, sample: float) -> None:
        """Set the sampling rate (0 disables; ``--trace-sample``)."""
        self.sample = max(0.0, min(1.0, sample))

    def reset(self) -> None:
        """Drop all state (tests)."""
        with self._lock:
            self._spans.clear()
            self.dropped = 0
            self._pinned.clear()
            self._pinned_spans.clear()
            self._pin_ring.clear()
            self._pin_count = 0
            self.dropped_pinned = 0

    # -- span lifecycle ------------------------------------------------------

    def _sampled(self) -> bool:
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        return int.from_bytes(os.urandom(2), "big") / 65536.0 < self.sample

    def span(self, name: str, parent=None, **attrs):
        """Open a span.  ``parent``: a Span, SpanContext, traceparent
        string, or None (the thread's current span, else a new trace).
        NOOP_SPAN when tracing is off or the trace is not sampled."""
        if self.sample <= 0.0:
            return NOOP_SPAN
        ctx = self._resolve_parent(parent)
        if ctx is None:
            # a new root: the head-sampling decision
            if self.sample < 1.0 and not self._sampled():
                return NOOP_SPAN
            return Span(self, _gen_trace_id(), "", name, attrs)
        if not ctx.sampled:
            return NOOP_SPAN
        return Span(self, ctx.trace_id, ctx.span_id, name, attrs)

    def point(self, name: str, parent=None, **attrs):
        """A zero-duration finished span: a marker another thread can drop
        into a trace without owning an open span."""
        sp = self.span(name, parent=parent, **attrs)
        sp.end()
        return sp

    def _resolve_parent(self, parent) -> Optional[SpanContext]:
        if parent is None:
            cur = self.current()
            return cur.context() if cur is not None else None
        if isinstance(parent, Span):
            return parent.context()
        if isinstance(parent, SpanContext):
            return parent
        if isinstance(parent, str):
            return parse_traceparent(parent)
        if isinstance(parent, _NoopSpan):
            # a child of an unsampled span stays unsampled
            return SpanContext("0" * 32, "0" * 16, sampled=False)
        return None

    def _finish(self, span: Span) -> None:
        overflowed = 0
        with self._lock:
            if span.trace_id in self._pinned:
                self._pinned_spans.setdefault(span.trace_id, []).append(span)
                self._pin_ring.append(span.trace_id)
                self._pin_count += 1
                while self._pin_count > self.pinned_capacity:
                    tid = self._pin_ring.popleft()
                    lst = self._pinned_spans.get(tid)
                    if not lst:
                        continue  # a stale token of an unpinned trace
                    lst.pop(0)
                    if not lst:
                        self._pinned_spans.pop(tid, None)
                    self._pin_count -= 1
                    self.dropped_pinned += 1
                    overflowed += 1
            else:
                if len(self._spans) == self._spans.maxlen:
                    self.dropped += 1
                self._spans.append(span)
        if overflowed:
            from ..metrics import METRICS_DROPPED

            METRICS_DROPPED.inc("trace_pin_cap", value=float(overflowed))

    # -- trace pinning -------------------------------------------------------

    def pin(self, trace_id: str) -> None:
        """Keep ``trace_id``'s finished spans from FIFO eviction until
        :meth:`unpin` (pins nest)."""
        if not trace_id:
            return
        with self._lock:
            self._pinned[trace_id] = self._pinned.get(trace_id, 0) + 1

    def unpin(self, trace_id: str) -> None:
        """Release one pin; at zero the trace's parked spans rejoin the
        ring."""
        if not trace_id:
            return
        with self._lock:
            n = self._pinned.get(trace_id, 0) - 1
            if n > 0:
                self._pinned[trace_id] = n
                return
            self._pinned.pop(trace_id, None)
            released = self._pinned_spans.pop(trace_id, None)
            if released:
                self._pin_count -= len(released)
                # purge the trace's ring tokens now: a stale token would
                # grow the ring for ever, and evict a span of a later pin
                # of the same trace id
                self._pin_ring = deque(t for t in self._pin_ring if t != trace_id)
                for sp in released:
                    if len(self._spans) == self._spans.maxlen:
                        self.dropped += 1
                    self._spans.append(sp)

    # thread-local active-span stack (context-manager protocol only)

    def _push(self, span: Span) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append(span)

    def _pop(self, span: Span) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack and stack[-1] is span:
            stack.pop()
        elif stack is not None:
            try:
                stack.remove(span)
            except ValueError:
                pass

    def current(self) -> Optional[Span]:
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    # -- export --------------------------------------------------------------

    def finished(self) -> list:
        with self._lock:
            out = list(self._spans)
            for lst in self._pinned_spans.values():
                out.extend(lst)
            return out

    def traces(self, limit: int = 50) -> list:
        """Most-recent-first trace summaries assembled from the ring."""
        by_trace: "OrderedDict[str, list]" = OrderedDict()
        for sp in self.finished():
            by_trace.setdefault(sp.trace_id, []).append(sp)
        out = []
        for trace_id, group in by_trace.items():
            group.sort(key=lambda s: s.t_wall)
            root = next((s for s in group if not s.parent_id), group[0])
            t_end = max((s.t_wall + (s.duration or 0.0)) for s in group)
            out.append({
                "trace_id": trace_id,
                "name": root.name,
                "start_unix": round(group[0].t_wall, 6),
                "duration_ms": round((t_end - group[0].t_wall) * 1000, 3),
                "spans": len(group),
                "open": any(s.duration is None for s in group),
                "status": ("error" if any(s.status == "error" for s in group)
                           else root.status),
            })
        out.sort(key=lambda t: -t["start_unix"])
        return out[:limit]

    def trace(self, trace_id: str) -> list:
        """Every span of one trace, start-ordered, as dicts."""
        spans = [sp for sp in self.finished() if sp.trace_id == trace_id]
        spans.sort(key=lambda s: s.t_wall)
        return [sp.to_dict() for sp in spans]

    def chrome_trace(self, trace_id: Optional[str] = None) -> dict:
        """Chrome trace-event JSON (Perfetto): spans as complete ("X")
        events on one lane per trace, span events as instant markers."""
        spans = self.finished()
        if trace_id is not None:
            spans = [sp for sp in spans if sp.trace_id == trace_id]
        lanes: dict[str, int] = {}
        events = []
        for sp in sorted(spans, key=lambda s: s.t_wall):
            tid = lanes.setdefault(sp.trace_id, len(lanes) + 1)
            ts_us = sp.t_wall * 1e6
            dur_us = (sp.duration or 0.0) * 1e6
            events.append({
                "name": sp.name, "ph": "X", "ts": round(ts_us, 1),
                "dur": round(max(dur_us, 1.0), 1), "pid": 1, "tid": tid,
                "args": {**sp.attrs, "trace_id": sp.trace_id, "span_id": sp.span_id,
                         "status": sp.status},
            })
            for ev in sp.events:
                events.append({
                    "name": f"{sp.name}.{ev['name']}", "ph": "i",
                    "ts": round(ts_us + ev["t"] * 1e6, 1), "pid": 1, "tid": tid, "s": "t",
                    "args": {k: v for k, v in ev.items() if k not in ("name", "t")},
                })
        for trace_id_, tid in lanes.items():
            events.append({"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                           "args": {"name": f"trace {trace_id_[:8]}"}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def status(self) -> dict:
        with self._lock:
            return {
                "sample": self.sample,
                "finished_spans": len(self._spans),
                "capacity": self.capacity,
                # a replica opens no pod-scoped trace (the scheduler does)
                "open_pod_traces": 0,
                "dropped_spans": self.dropped,
                "pinned_traces": len(self._pinned),
                "pinned_spans": self._pin_count,
                "pinned_capacity": self.pinned_capacity,
                "dropped_pinned_spans": self.dropped_pinned,
            }


# the process-global tracer the engine and the HTTP front end share
TRACER = Tracer()


def traces_response(params: dict, tracer: Optional[Tracer] = None) -> dict:
    """The ``GET /traces`` response (query params: ``trace`` for one
    trace's spans, ``format=chrome`` for Perfetto, ``limit`` for the
    summary list)."""
    tracer = tracer if tracer is not None else TRACER
    trace_id = params.get("trace", "")
    if params.get("format") == "chrome":
        return tracer.chrome_trace(trace_id or None)
    if trace_id:
        return {"trace_id": trace_id, "spans": tracer.trace(trace_id)}
    try:
        limit = int(params.get("limit", "50"))
    except (TypeError, ValueError):
        limit = 50
    return {"tracer": tracer.status(), "traces": tracer.traces(limit)}
