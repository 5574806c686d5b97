"""Per-request lifecycle traces and step telemetry of the serving engine:
the port's copy of ``bee_code_interpreter_tpu/observability/serving_trace.py``.

:class:`ServingMonitor` is the per-request and per-step layer over the
batcher and engine of ``models/``:

- **A lifecycle trace per request**: a span tree (``queued`` -> ``prefill``
  [/ ``prefill_chunk`` windows] -> ``decode``) on its own
  :class:`~.tracing.Trace`, landed in a shared ``TraceStore``.
- **One ``kind="serving"`` wide event per finished request** in the flight
  recorder, with the same trace id as the trace and as the exemplar of
  ``bci_serving_ttft_seconds`` (the batcher observes TTFT under the
  request's activated trace).
- **A bounded ring of step records**: occupancy, free/parked/held pages,
  prefill and decode token counts, speculative accepts and rejects, page
  churn and the step's wall time.
- **KV-cache telemetry** through the batcher's ``kv_telemetry()``.

The monitor is duck-typed from the batcher and engine side: they call the
``on_*`` hooks when one is attached and pay one ``None`` check otherwise, so
``models/`` never imports this package. Hooks may fire from a worker thread
(a profiler capture steps the engine there); record state is lock-guarded,
and flight-recorder delivery hops to the recorder's loop when the caller is
not on it. The code is the JAX module's, but for its imports and the
port's ``Trace`` constructor, which takes no tracer.
"""

from __future__ import annotations

import asyncio
import threading
import time
from collections import deque
from contextlib import contextmanager

from bee_code_interpreter_tpu_torch.observability.tracing import (
    Trace,
    activate_trace,
)

# finish reason -> wide-event outcome. Client-visible completions (eos /
# stop / length / constraint) are "ok"; the rest name their failure mode so
# `GET /v1/events?outcome=...` and the OTLP-logs severity mapping can
# separate normal retirement from trouble.
_FINISH_OUTCOME = {
    "eos": "ok",
    "stop": "ok",
    "length": "ok",
    "constraint": "ok",
    "error": "error",
    "cancelled": "cancelled",
    "preempted": "preempted",
}


class _RequestRecord:
    """Mutable per-request state while a generation request is live."""

    __slots__ = (
        "req", "trace", "prefill_span", "decode_span", "t_submit",
        "submit_unix", "prompt_tokens", "max_new_tokens", "pages",
        "prefix_pages", "adapter", "speculative", "interleaved",
        "prefill_chunks", "prefill_tokens", "spec_accepted",
        "spec_rejected", "queued_ms", "requeues", "ttft_ms",
        "output_tokens", "finish", "outcome", "duration_ms", "error",
    )

    def __init__(self, req: int, trace: Trace, t_submit: float) -> None:
        self.req = req
        self.trace = trace
        self.prefill_span = None
        self.decode_span = None
        self.t_submit = t_submit
        self.submit_unix = trace.root.start_unix
        self.prompt_tokens = 0
        self.max_new_tokens = 0
        self.pages = 0
        self.prefix_pages = 0
        self.adapter = None
        self.speculative = False
        self.interleaved = False
        self.prefill_chunks = 0
        self.prefill_tokens = 0
        self.spec_accepted = 0
        self.spec_rejected = 0
        self.queued_ms = None
        self.requeues = 0
        self.ttft_ms = None
        self.output_tokens = 0
        self.finish = None
        self.outcome = None
        self.duration_ms = None
        self.error = None

    def to_dict(self, active: bool) -> dict:
        return {
            "request_id": self.req,
            "trace_id": self.trace.trace_id,
            "ts": self.submit_unix,
            "active": active,
            "prompt_tokens": self.prompt_tokens,
            "max_new_tokens": self.max_new_tokens,
            "output_tokens": self.output_tokens,
            "pages": self.pages,
            "prefix_hit_pages": self.prefix_pages,
            "adapter": self.adapter,
            "speculative": self.speculative,
            "interleaved": self.interleaved,
            "prefill_chunks": self.prefill_chunks,
            "spec_accepted": self.spec_accepted,
            "spec_rejected": self.spec_rejected,
            "queued_ms": self.queued_ms,
            "requeues": self.requeues,
            "ttft_ms": self.ttft_ms,
            "finish": self.finish,
            "outcome": self.outcome,
            "duration_ms": (
                self.duration_ms
                if self.duration_ms is not None
                else (time.monotonic() - self.t_submit) * 1000.0
            ),
            "error": self.error,
        }


class ServingMonitor:
    """Per-request lifecycle tracing + step/KV-cache telemetry for the
    serving engine. Constructed by the composition root next to the flight
    recorder (metrics register immediately; gauges read 0 until an engine
    attaches); :meth:`attach` binds a ``models.engine.Engine`` or bare
    ``ContinuousBatcher`` and injects the monitor into its hooks.
    """

    def __init__(
        self,
        *,
        metrics=None,
        store=None,  # tracing.TraceStore shared with the edges
        recorder=None,  # flightrecorder.FlightRecorder
        max_steps: int = 512,
        max_requests: int = 256,
    ) -> None:
        self._store = store
        self._recorder = recorder
        self._lock = threading.Lock()
        self._live: dict[int, _RequestRecord] = {}
        self._done: deque[_RequestRecord] = deque(maxlen=max(1, max_requests))
        self._steps: deque[dict] = deque(maxlen=max(1, max_steps))
        self._step_seq = 0
        self._tickets: dict[int, tuple[float, int]] = {}  # ticket -> (t, requeues)
        # queue wait staged by on_ticket_admitting for the on_submit fired
        # inside the engine's synchronous batcher.submit call (one slot:
        # admissions cannot interleave)
        self._pending_admission: tuple[float, int] | None = None
        self._engine = None
        self._batcher = None
        self._loop: asyncio.AbstractEventLoop | None = None
        # lifetime totals (survive record-ring eviction)
        self._spec_accepted_total = 0
        self._spec_rejected_total = 0
        self._finished_total = 0
        self._rejected_total = 0
        self._requeued_total = 0
        self._preempted_total = 0
        self._requests_total = None
        self._request_seconds = None
        self._preemptions_total = None
        self._spec_tokens_total = None
        if metrics is not None:
            self._requests_total = metrics.counter(
                "bci_serving_requests_total",
                "Serving requests finished, by done reason",
            )
            self._request_seconds = metrics.histogram(
                "bci_serving_request_seconds",
                "Serving request wall time, queue wait included",
            )
            self._preemptions_total = metrics.counter(
                "bci_serving_preemptions_total",
                "Mid-prefill admissions evicted back to the queue",
            )
            self._spec_tokens_total = metrics.counter(
                "bci_serving_spec_tokens_total",
                "Speculative draft tokens verified, by result",
            )
            metrics.gauge(
                "bci_serving_spec_accept_ratio",
                "Draft tokens accepted / proposed (0 with no speculative "
                "traffic yet)",
                self.spec_accept_ratio,
            )
            metrics.gauge(
                "bci_serving_prefix_hit_ratio",
                "Prefix-cache lookups that reused at least one page (0-1)",
                self.prefix_hit_ratio,
            )
            metrics.gauge(
                "bci_serving_page_fragmentation",
                "Internal fragmentation of allocated KV pages: 1 - "
                "used/allocated slots over active rows",
                self.page_fragmentation,
            )

    # ------------------------------------------------------------ wiring

    def attach(self, target) -> None:
        """Bind a ``models.engine.Engine`` (or a bare ``ContinuousBatcher``)
        and inject this monitor into its hooks. Call BEFORE submitting —
        requests already in flight are not traced retroactively."""
        batcher = getattr(target, "batcher", target)
        self._engine = target if batcher is not target else None
        self._batcher = batcher
        batcher.set_monitor(self)
        if self._engine is not None:
            self._engine.set_monitor(self)
        try:
            self._loop = asyncio.get_running_loop()
        except RuntimeError:
            pass

    @property
    def available(self) -> bool:
        """True once an engine/batcher is attached — the ``POST /v1/profile
        target=serving`` gate (501 when nothing is attached)."""
        return self._batcher is not None

    def step(self) -> None:
        """One engine (or batcher) step — the stepper surface
        :class:`~.profiling.ServingProfiler` captures through."""
        if self._engine is not None:
            self._engine.step()
        elif self._batcher is not None:
            self._batcher.step()
        else:
            raise RuntimeError("no serving engine attached")

    # ----------------------------------------------------- gauge callbacks

    def spec_accept_ratio(self) -> float:
        proposed = self._spec_accepted_total + self._spec_rejected_total
        return self._spec_accepted_total / proposed if proposed else 0.0

    def prefix_hit_ratio(self) -> float:
        if self._batcher is None:
            return 0.0
        stats = self._batcher.prefix_stats
        lookups = stats.get("lookups", 0)
        return stats.get("hits", 0) / lookups if lookups else 0.0

    def page_fragmentation(self) -> float:
        if self._batcher is None:
            return 0.0
        return float(self._batcher.kv_telemetry()["fragmentation"])

    # ------------------------------------------------------ batcher hooks

    def on_submit(
        self,
        req: int,
        *,
        prompt_tokens: int,
        max_new_tokens: int,
        pages: int,
        prefix_pages: int,
        adapter: int | None,
        speculative: bool,
        interleaved: bool,
    ) -> None:
        trace = Trace("serving.request", request_id=f"serving-{req}")
        rec = _RequestRecord(req, trace, time.monotonic())
        rec.prompt_tokens = prompt_tokens
        rec.max_new_tokens = max_new_tokens
        rec.pages = pages
        rec.prefix_pages = prefix_pages
        rec.adapter = adapter
        rec.speculative = speculative
        rec.interleaved = interleaved
        with self._lock:
            pending = self._pending_admission
            self._pending_admission = None
            if pending is not None:
                # the request's wall clock starts at ENGINE intake:
                # backdate the root and hang the queued span off it BEFORE
                # anything else happens, so duration_ms and TTFT are the
                # user-perceived numbers on BOTH admission paths (the
                # blocking path fixes TTFT inside this very submit call)
                t_queued, requeues = pending
                wait_s = max(0.0, rec.t_submit - t_queued)
                trace.root.start_mono -= wait_s
                trace.root.start_unix -= wait_s
                rec.submit_unix = trace.root.start_unix
                rec.t_submit -= wait_s
                rec.requeues = requeues
                rec.queued_ms = wait_s * 1000.0
                s = trace.start_span(
                    "queued", parent_id=trace.root.span_id
                )
                s.start_mono -= wait_s
                s.start_unix -= wait_s
                if requeues:
                    s.attributes["requeues"] = str(requeues)
                trace.end_span(s)
            rec.prefill_span = trace.start_span(
                "prefill", parent_id=trace.root.span_id
            )
            self._live[req] = rec

    def on_prefill_window(
        self, req: int, *, tokens: int, duration_s: float
    ) -> None:
        with self._lock:
            rec = self._live.get(req)
            if rec is None:
                return
            rec.prefill_chunks += 1
            rec.prefill_tokens += tokens
            parent = rec.prefill_span or rec.trace.root
            s = rec.trace.start_span("prefill_chunk", parent_id=parent.span_id)
            # backdate: the window already ran (the batcher timed it)
            s.start_mono -= duration_s
            s.start_unix -= duration_s
            s.attributes["tokens"] = str(tokens)
            rec.trace.end_span(s)

    def on_first_token(self, req: int) -> None:
        with self._lock:
            rec = self._live.get(req)
            if rec is None:
                return
            rec.ttft_ms = (time.monotonic() - rec.t_submit) * 1000.0
            if rec.prefill_span is not None:
                rec.prefill_span.attributes["chunks"] = str(
                    rec.prefill_chunks or 1
                )
                rec.trace.end_span(rec.prefill_span)
            rec.decode_span = rec.trace.start_span(
                "decode", parent_id=rec.trace.root.span_id
            )

    def on_commit(self, req: int, *, accepted: int, rejected: int) -> None:
        with self._lock:
            self._spec_accepted_total += accepted
            self._spec_rejected_total += rejected
            rec = self._live.get(req)
            if rec is not None:
                rec.spec_accepted += accepted
                rec.spec_rejected += rejected
        if self._spec_tokens_total is not None:
            if accepted:
                self._spec_tokens_total.inc(accepted, result="accepted")
            if rejected:
                self._spec_tokens_total.inc(rejected, result="rejected")

    def on_done(
        self, req: int, reason: str, *, tokens: int, error: str | None = None
    ) -> None:
        with self._lock:
            rec = self._live.pop(req, None)
            if rec is None:
                return
            rec.finish = reason
            rec.outcome = _FINISH_OUTCOME.get(reason, reason)
            rec.output_tokens = tokens
            rec.error = error
            status = "error" if rec.outcome == "error" else "ok"
            if rec.prefill_span is not None and rec.prefill_span.duration_s is None:
                # never produced a first token (error/cancel mid-prefill)
                rec.trace.end_span(rec.prefill_span, status=status)
            if rec.decode_span is not None:
                rec.decode_span.attributes["tokens"] = str(tokens)
                rec.trace.end_span(rec.decode_span)
            rec.trace.end_span(rec.trace.root, status=status, error=error)
            rec.duration_ms = rec.trace.root.duration_s * 1000.0
            self._done.append(rec)
            self._finished_total += 1
            if reason == "preempted":
                self._preempted_total += 1
        if self._requests_total is not None:
            self._requests_total.inc(outcome=reason)
        if self._request_seconds is not None:
            # observed under the request's own trace so the exemplar on the
            # duration histogram jumps straight to /v1/traces/{id}
            with activate_trace(rec.trace):
                self._request_seconds.observe(rec.trace.root.duration_s)
        if self._store is not None:
            self._store.add(rec.trace)
        self._emit(self._wide_event(rec))

    def on_preempt(self, req: int) -> None:
        if self._preemptions_total is not None:
            self._preemptions_total.inc()
        self.on_done(req, "preempted", tokens=0)

    def on_step(self, record: dict) -> None:
        with self._lock:
            self._step_seq += 1
            record["seq"] = self._step_seq
            record["ts"] = time.time()
            if self._engine is not None:
                record["queue_depth"] = self._engine.pending
            self._steps.append(record)

    # ------------------------------------------------------- engine hooks

    def on_ticket_queued(self, ticket: int) -> None:
        with self._lock:
            prior = self._tickets.get(ticket)
            self._tickets[ticket] = (
                time.monotonic(), prior[1] if prior else 0
            )

    def on_ticket_requeued(self, ticket: int) -> None:
        with self._lock:
            # a CapacityError mid-admission bounces AFTER on_ticket_admitting
            # staged the wait: recover the original clock from the slot so
            # the eventual queued span spans the WHOLE wait
            entry = self._tickets.get(ticket) or self._pending_admission
            self._pending_admission = None
            t, n = entry if entry is not None else (time.monotonic(), 0)
            self._tickets[ticket] = (t, n + 1)
            self._requeued_total += 1
        self._emit(
            {
                "kind": "serving",
                "name": "serving.requeue",
                "outcome": "requeued",
                "ticket": ticket,
            }
        )

    def on_ticket_admitting(self, ticket: int) -> None:
        """The engine is about to hand this ticket to the batcher: stage
        its queue wait so the ``on_submit`` fired INSIDE that synchronous
        call can start the request's clock at engine intake — TTFT and
        duration_ms include queue wait on both admission paths (blocking
        submit fixes TTFT before the call returns, so backdating after it
        would be too late)."""
        with self._lock:
            self._pending_admission = self._tickets.pop(ticket, None)

    def on_ticket_rejected(self, reason: str) -> None:
        with self._lock:
            self._rejected_total += 1
        self._emit(
            {
                "kind": "serving",
                "name": "serving.reject",
                "outcome": "rejected",
                "reason": reason,
            }
        )

    def on_ticket_failed(self, ticket: int, error: str) -> None:
        with self._lock:
            self._tickets.pop(ticket, None)
            self._pending_admission = None
        self._emit(
            {
                "kind": "serving",
                "name": "serving.admit_error",
                "outcome": "error",
                "ticket": ticket,
                "error": error,
            }
        )

    def on_ticket_cancelled(self, ticket: int) -> None:
        with self._lock:
            self._tickets.pop(ticket, None)

    # ------------------------------------------------------------ queries

    @contextmanager
    def exemplar_context(self, req: int):
        """Ambient-trace context for a live request, so a histogram
        observation made inside it (the batcher's TTFT) records this
        request's trace id as its exemplar."""
        with self._lock:
            rec = self._live.get(req)
        if rec is None:
            yield None
            return
        with activate_trace(rec.trace):
            yield rec.trace

    def snapshot(self, steps: int = 32) -> dict:
        """The ``GET /v1/serving`` body: engine/batcher aggregates, KV-cache
        telemetry, lifetime totals, and the last ``steps`` step records."""
        with self._lock:
            live = [r.to_dict(active=True) for r in self._live.values()]
            recorded = len(self._done)
            recent_steps = (
                list(self._steps)[-steps:] if steps > 0 else []
            )
            totals = {
                "finished": self._finished_total,
                "rejected": self._rejected_total,
                "requeued": self._requeued_total,
                "preempted": self._preempted_total,
                "spec_accepted": self._spec_accepted_total,
                "spec_rejected": self._spec_rejected_total,
            }
        body: dict = {
            "attached": self.available,
            "totals": {
                **totals,
                "spec_accept_ratio": self.spec_accept_ratio(),
                "prefix_hit_ratio": self.prefix_hit_ratio(),
            },
            "requests": {"active": live, "recorded": recorded},
            "steps": {
                "recorded": self._step_seq,
                "retained": len(self._steps),
                "last": recent_steps,
            },
        }
        if self._batcher is not None:
            body["batcher"] = self._batcher.stats
            body["kv_cache"] = self._batcher.kv_telemetry()
        if self._engine is not None:
            body["queue_depth"] = self._engine.pending
        return body

    def requests(
        self,
        *,
        outcome: str | None = None,
        finish: str | None = None,
        adapter: int | None = None,
        active: bool | None = None,
        min_duration_ms: float | None = None,
        limit: int | None = None,
    ) -> list[dict]:
        """Filtered per-request records, newest first (live requests before
        finished ones) — the ``GET /v1/serving/requests`` body."""
        if limit is not None and limit <= 0:
            return []  # same limit semantics as FlightRecorder.events
        with self._lock:
            rows = [r.to_dict(active=True) for r in self._live.values()]
            rows += [r.to_dict(active=False) for r in reversed(self._done)]
        out: list[dict] = []
        for row in rows:
            if outcome is not None and row["outcome"] != outcome:
                continue
            if finish is not None and row["finish"] != finish:
                continue
            if adapter is not None and row["adapter"] != adapter:
                continue
            if active is not None and row["active"] != active:
                continue
            if min_duration_ms is not None and (
                row["duration_ms"] is None
                or row["duration_ms"] < min_duration_ms
            ):
                continue
            out.append(row)
            if limit is not None and len(out) >= limit:
                break
        return out

    # ------------------------------------------------------------ private

    def _wide_event(self, rec: _RequestRecord) -> dict:
        serving = {
            "prompt_tokens": rec.prompt_tokens,
            "output_tokens": rec.output_tokens,
            "max_new_tokens": rec.max_new_tokens,
            "pages": rec.pages,
            "prefix_hit_pages": rec.prefix_pages,
            "adapter": rec.adapter,
            "speculative": rec.speculative,
            "interleaved": rec.interleaved,
            "spec_accepted": rec.spec_accepted,
            "spec_rejected": rec.spec_rejected,
            "requeues": rec.requeues,
            "ttft_ms": rec.ttft_ms,
            "finish": rec.finish,
        }
        event: dict = {
            "kind": "serving",
            "ts": rec.submit_unix,
            "name": "serving.request",
            "trace_id": rec.trace.trace_id,
            "request_id": rec.trace.request_id,
            "outcome": rec.outcome,
            "duration_ms": rec.duration_ms,
            "timings_ms": rec.trace.stage_ms(),
            "serving": serving,
        }
        if rec.error is not None:
            event["error"] = rec.error
        return event

    def arm_loop(self, loop: asyncio.AbstractEventLoop | None = None) -> None:
        """Bind the loop wide events are delivered on when a hook fires
        off-loop. ``attach()`` arms it opportunistically and ``_emit``
        refreshes it whenever it runs on-loop, but a monitor attached
        BEFORE the loop exists (sync composition) needs this explicit call
        — ``ApplicationContext.start_observability`` makes it."""
        self._loop = (
            loop if loop is not None else asyncio.get_running_loop()
        )

    def _emit(self, event: dict) -> None:
        if self._recorder is None:
            return
        try:
            # remember the loop whenever one is running here, so hooks
            # that later fire off-loop know where to deliver
            self._loop = asyncio.get_running_loop()
        except RuntimeError:
            # off-loop caller (profiler capture thread, bench): hand the
            # event to the recorder's loop — its follower queues are
            # asyncio objects a foreign thread must not poke directly
            loop = self._loop
            if loop is not None and loop.is_running():
                loop.call_soon_threadsafe(self._recorder.record, event)
                return
            # no loop was ever armed: nothing async can be following the
            # recorder either (subscribing requires that loop), so the
            # direct call only touches the ring
        self._recorder.record(event)
