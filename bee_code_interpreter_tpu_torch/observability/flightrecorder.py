"""Flight recorder: one wide event per request or incident, the port's copy
of ``bee_code_interpreter_tpu/observability/flightrecorder.py``.

The serving monitor records one ``kind="serving"`` event per finished
request (and one per reject, requeue or admission failure); the device
monitor one ``kind="compile"`` event per first call of a program at a new
signature. Events land in a bounded in-memory ring, are fanned out to live
followers (asyncio queues) and to sinks, and are queried newest first with
the same filters as the JAX recorder.

Delivery is drop-not-block: the ring evicts the oldest event, and a follower
whose queue is full loses the event (``bci_events_dropped_total{reason=
"follower"}``). The JAX recorder's size-rotated ndjson segment files, its
background flusher and its trace sink (``record_trace``, fed by the edge's
tracer) are left out: the port runs no service edge and writes no files.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from collections import deque

logger = logging.getLogger(__name__)


def register_stream_metrics(metrics):
    """The streaming metrics both service edges record: time-to-first-chunk
    and chunks delivered, labeled by transport. Registry name-dedup makes
    this safe to call more than once."""
    from bee_code_interpreter_tpu_torch.utils.metrics import (
        TOKEN_LATENCY_BUCKETS,
    )

    ttfb = metrics.histogram(
        "bci_stream_ttfb_seconds",
        "Streaming executions: start to first output chunk, by transport",
        buckets=TOKEN_LATENCY_BUCKETS,
    )
    chunks = metrics.counter(
        "bci_stream_chunks_total",
        "Streaming output chunks delivered to clients, by transport",
    )
    return ttfb, chunks


def event_matches(
    event: dict,
    *,
    kind: str | None = None,
    outcome: str | None = None,
    session: str | None = None,
    tenant: str | None = None,
    min_duration_ms: float | None = None,
    since: float | None = None,
) -> bool:
    """The one filter predicate for wide events: the ring query and a live
    tail accept identical events for identical filters."""
    if kind is not None and event.get("kind") != kind:
        return False
    if outcome is not None and event.get("outcome") != outcome:
        return False
    if session is not None and event.get("session") != session:
        return False
    if tenant is not None and event.get("tenant") != tenant:
        return False
    if min_duration_ms is not None:
        duration = event.get("duration_ms")
        if duration is None or duration < min_duration_ms:
            return False
    if since is not None and event.get("ts", 0.0) <= since:
        return False
    return True


class FlightRecorder:
    """Bounded wide-event ring with live followers and sinks.

    ``record()`` is the one ingest point: O(1), a ring append plus a
    non-blocking fan-out, never I/O.
    """

    def __init__(
        self,
        *,
        max_events: int = 512,
        follower_queue_max: int = 256,
        metrics=None,
    ) -> None:
        self._ring: deque[dict] = deque(maxlen=max(1, max_events))
        self._follower_queue_max = follower_queue_max
        self._seq = 0
        self._followers: set[asyncio.Queue] = set()
        self._sinks: list = []
        # the ring is appended from the recording thread; readers may be
        # other threads: guard the ring walk, not the hot append
        self._lock = threading.Lock()
        self._emitted_total = None
        self._dropped_total = None
        if metrics is not None:
            self._emitted_total = metrics.counter(
                "bci_events_emitted_total",
                "Wide events recorded by the flight recorder, by kind",
            )
            self._dropped_total = metrics.counter(
                "bci_events_dropped_total",
                "Wide events dropped instead of blocking (slow SSE follower, "
                "full disk-write queue), by reason",
            )

    def record(self, event: dict) -> None:
        """Ingest one wide event (cheap, non-blocking, no I/O). Missing
        ``ts``/``kind`` are filled; ``seq`` is stamped here, a total order
        a ``since`` query can resume from."""
        self._seq += 1
        event.setdefault("kind", "event")
        event.setdefault("ts", time.time())
        event["seq"] = self._seq
        with self._lock:
            self._ring.append(event)
        if self._emitted_total is not None:
            self._emitted_total.inc(kind=event["kind"])
        for queue in list(self._followers):
            try:
                queue.put_nowait(event)
            except asyncio.QueueFull:
                if self._dropped_total is not None:
                    self._dropped_total.inc(reason="follower")
        for sink in self._sinks:
            # a broken sink must never fail the request that emitted this
            try:
                sink(event)
            except Exception:
                logger.exception("wide-event sink %r failed", sink)

    def add_sink(self, sink) -> None:
        """Register a callable invoked with each recorded event; sinks must
        be cheap and non-blocking."""
        self._sinks.append(sink)

    def events(
        self,
        *,
        kind: str | None = None,
        outcome: str | None = None,
        session: str | None = None,
        tenant: str | None = None,
        min_duration_ms: float | None = None,
        since: float | None = None,
        limit: int | None = None,
    ) -> list[dict]:
        """Filtered view of the ring, newest first. ``since`` is a unix
        timestamp lower bound (strictly after); ``min_duration_ms`` keeps
        events whose ``duration_ms`` is known and at least the bound."""
        if limit is not None and limit <= 0:
            return []
        with self._lock:
            snapshot = list(self._ring)
        out: list[dict] = []
        for event in reversed(snapshot):
            if not event_matches(
                event,
                kind=kind,
                outcome=outcome,
                session=session,
                tenant=tenant,
                min_duration_ms=min_duration_ms,
                since=since,
            ):
                continue
            out.append(event)
            if limit is not None and len(out) >= limit:
                break
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def subscribe(self) -> asyncio.Queue:
        """A live tail: events recorded from now on land in the returned
        queue; a slow consumer loses events (accounted) rather than backing
        up the recorder."""
        queue: asyncio.Queue = asyncio.Queue(maxsize=self._follower_queue_max)
        self._followers.add(queue)
        return queue

    def unsubscribe(self, queue: asyncio.Queue) -> None:
        self._followers.discard(queue)

    def snapshot(self) -> dict:
        """Recorder state, in the JAX recorder's shape (no segment files:
        ``pending_write`` 0, ``segment_dir`` None)."""
        return {
            "retained": len(self),
            "emitted": self._seq,
            "followers": len(self._followers),
            "pending_write": 0,
            "segment_dir": None,
            "segments": [],
        }
