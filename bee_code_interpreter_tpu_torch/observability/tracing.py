"""Request-scoped traces on contextvars: the part of
``bee_code_interpreter_tpu/observability/tracing.py`` that the serving and
device monitors need.

A :class:`Trace` is one request's spans; :class:`TraceStore` retains
finished traces (the most recent ones plus a reserved slice of the slowest);
:func:`activate_trace` makes a hand-managed trace the ambient one, so a
histogram observation (its exemplar) or a compile event made inside lands in
that trace. The serving monitor's per-request traces live across many
batcher steps, far outside any one call stack, and are activated around
admission and around the metric observations that belong to them.

The edge-side tracer, the ``traceparent`` header codec and the outbound
headers of the JAX module are not copied: the port serves no HTTP edge.
The ambient trace lives in ``contextvars``, so a span started under one
request is invisible to every other, across threads and asyncio tasks.
"""

from __future__ import annotations

import heapq
import secrets
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field

_current_trace: ContextVar["Trace | None"] = ContextVar(
    "bci_torch_trace", default=None
)
_current_span: ContextVar["Span | None"] = ContextVar(
    "bci_torch_span", default=None
)


def _new_trace_id() -> str:
    return uuid.uuid4().hex  # 32 lowercase hex chars, W3C trace-id shaped


def _new_span_id() -> str:
    return secrets.token_hex(8)  # 16 lowercase hex chars


@dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: str | None
    name: str
    start_unix: float
    start_mono: float
    duration_s: float | None = None
    status: str = "ok"
    attributes: dict[str, str] = field(default_factory=dict)

    @property
    def duration_ms(self) -> float | None:
        return None if self.duration_s is None else self.duration_s * 1000.0

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_unix": self.start_unix,
            "duration_ms": self.duration_ms,
            "status": self.status,
            "attributes": dict(self.attributes),
        }


class Trace:
    """One request's spans, rooted at a span named ``name``."""

    def __init__(
        self,
        name: str,
        trace_id: str | None = None,
        parent_span_id: str | None = None,
        request_id: str | None = None,
    ) -> None:
        self.trace_id = trace_id or _new_trace_id()
        self.request_id = request_id
        self.spans: list[Span] = []
        self.root = self.start_span(name, parent_id=parent_span_id)

    def start_span(
        self, name: str, parent_id: str | None, attributes: dict | None = None
    ) -> Span:
        s = Span(
            trace_id=self.trace_id,
            span_id=_new_span_id(),
            parent_id=parent_id,
            name=name,
            start_unix=time.time(),
            start_mono=time.monotonic(),
            attributes={k: str(v) for k, v in (attributes or {}).items()},
        )
        self.spans.append(s)
        return s

    def end_span(self, s: Span, status: str = "ok", error: str | None = None) -> None:
        if s.duration_s is not None:
            return  # already ended (an error path raced the normal path)
        s.duration_s = time.monotonic() - s.start_mono
        s.status = status
        if error is not None:
            s.attributes["error"] = error

    @property
    def name(self) -> str:
        return self.root.name

    @property
    def status(self) -> str:
        return self.root.status

    @property
    def duration_s(self) -> float:
        if self.root.duration_s is not None:
            return self.root.duration_s
        return time.monotonic() - self.root.start_mono

    def stage_ms(self) -> dict[str, float]:
        """Stage name -> total milliseconds across the trace's finished
        child spans (repeated stages sum)."""
        out: dict[str, float] = {}
        for s in self.spans:
            if s is self.root or s.duration_s is None:
                continue
            out[s.name] = out.get(s.name, 0.0) + s.duration_s * 1000.0
        return out

    def summary(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "request_id": self.request_id,
            "start_unix": self.root.start_unix,
            "duration_ms": self.duration_s * 1000.0,
            "status": self.status,
            "n_spans": len(self.spans),
        }

    def to_dict(self) -> dict:
        return {
            **self.summary(),
            "stage_ms": self.stage_ms(),
            "spans": [s.to_dict() for s in self.spans],
        }


class TraceStore:
    """Bounded retention for finished traces: a FIFO ring of the most recent
    ones plus a reserved slice that always keeps the slowest-N seen (the
    outliers are the requests an operator goes looking for)."""

    def __init__(self, max_traces: int = 256, slowest_keep: int = 32) -> None:
        slowest_keep = max(0, min(slowest_keep, max_traces - 1))
        self._recent: deque[Trace] = deque(maxlen=max(1, max_traces - slowest_keep))
        self._slowest_keep = slowest_keep
        # min-heap of (duration_s, seq, trace): the fastest of the kept-slow
        # set sits at the top and is the one displaced by a slower arrival
        self._slowest: list[tuple[float, int, Trace]] = []
        self._seq = 0
        self._lock = threading.Lock()

    def add(self, trace: Trace) -> None:
        with self._lock:
            self._recent.append(trace)
            if self._slowest_keep:
                self._seq += 1
                entry = (trace.duration_s, self._seq, trace)
                if len(self._slowest) < self._slowest_keep:
                    heapq.heappush(self._slowest, entry)
                elif entry[0] > self._slowest[0][0]:
                    heapq.heapreplace(self._slowest, entry)

    def get(self, trace_id: str) -> Trace | None:
        with self._lock:
            for t in self._recent:
                if t.trace_id == trace_id:
                    return t
            for _, _, t in self._slowest:
                if t.trace_id == trace_id:
                    return t
        return None

    def traces(self) -> list[Trace]:
        """All retained traces (recent and slowest, deduplicated), newest
        first."""
        with self._lock:
            seen: dict[str, Trace] = {}
            for t in list(self._recent) + [t for _, _, t in self._slowest]:
                seen.setdefault(t.trace_id, t)
        return sorted(
            seen.values(), key=lambda t: t.root.start_unix, reverse=True
        )

    def __len__(self) -> int:
        return len(self.traces())


@contextmanager
def activate_trace(trace: Trace, span: Span | None = None):
    """Make a hand-managed trace the ambient one for the duration (its root
    span, or ``span``)."""
    trace_token = _current_trace.set(trace)
    span_token = _current_span.set(span or trace.root)
    try:
        yield trace
    finally:
        _current_span.reset(span_token)
        _current_trace.reset(trace_token)


def current_trace() -> Trace | None:
    return _current_trace.get()


def current_span() -> Span | None:
    return _current_span.get()


def current_ids() -> tuple[str, str]:
    """(trace_id, span_id) of the ambient span, or ("-", "-"); never
    raises."""
    s = _current_span.get()
    if s is None:
        return "-", "-"
    return s.trace_id, s.span_id
