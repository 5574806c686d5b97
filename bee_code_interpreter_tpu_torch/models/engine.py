"""Serving engine: a request queue in front of the continuous batcher.

The counterpart of ``bee_code_interpreter_tpu/models/engine.py``, host-side
only. ``submit`` always accepts (up to an optional queue bound) and returns a
ticket; admission into the batcher happens inside ``step`` the moment a row
and enough pages are free, in (priority desc, arrival) order with deliberate
head-of-line blocking; pages a prefix-cache hit would reuse count as
available. ``new_tokens`` is the streaming read; ``cancel`` works on queued
and admitted tickets; ``preempt`` sends an interleaved admission that has
not produced a token back to the head of its priority class. A request's
``adapter`` rides with it to admission and to the prefix credit;
``state_dict`` / ``load_state_dict`` snapshot the batcher and the queue.

``metrics`` (a ``utils.metrics.Registry``) and a lifecycle monitor (a
``ServingMonitor``, given here or inherited from the batcher, usually
through ``monitor.attach``) instrument what happens before a request reaches
a batch row: queue depth and wait, capacity bounce-backs, rejections, with
the JAX engine's metric names and hook order.
"""

from __future__ import annotations

import copy
import heapq
import time
from dataclasses import dataclass

import numpy as np

from bee_code_interpreter_tpu_torch.models.serving import (
    CapacityError,
    ContinuousBatcher,
    SamplingParams,
)


@dataclass
class _Queued:
    prompt: object
    max_new_tokens: int
    sampling: SamplingParams | None
    prefill_chunk: int | None
    adapter: int | None
    pages_needed: int
    interleave_admission: int | None = None
    priority: int = 0  # kept so a preempted ticket requeues in its class


def stream_holdback(sampling: SamplingParams | None) -> int:
    """How many of a live request's last tokens ``new_tokens`` holds back:
    (max stop length - 1), so a stop sequence completing later never trims
    a token already streamed."""
    stops = sampling.stop_sequences if sampling is not None else ()
    return max((len(s) for s in stops), default=1) - 1


def stream_chunk(tokens: list[int], done: bool, cursor: int,
                 holdback: int) -> tuple[list[int], int]:
    """``new_tokens``' rule: the tokens from ``cursor`` on, less the last
    ``holdback`` while the request is live, and the new cursor."""
    limit = len(tokens) if done else max(0, len(tokens) - holdback)
    if limit <= cursor:
        return [], cursor
    return list(tokens[cursor:limit]), limit


class Engine:
    """Queue + admission loop over a ``ContinuousBatcher``.

    ``max_queue`` bounds accepted-but-not-admitted requests (None =
    unbounded); ``submit`` raises RuntimeError at the bound.
    """

    def __init__(self, batcher: ContinuousBatcher,
                 max_queue: int | None = None, metrics=None,
                 monitor=None) -> None:
        self.batcher = batcher
        self.max_queue = max_queue
        # the lifecycle monitor: the engine owns the queued / requeued /
        # rejected part of a request's story, the batcher the rest; the
        # batcher's is inherited so one attach() wires the whole stack
        self._monitor = monitor if monitor is not None else getattr(
            batcher, "_monitor", None
        )
        self._metrics = metrics
        self._ticket_submit_t: dict[int, float] = {}
        if metrics is not None:
            self._queue_wait_seconds = metrics.histogram(
                "bci_serving_queue_wait_seconds",
                "Ticket wait from engine submit to batcher admission",
            )
            self._requeues_total = metrics.counter(
                "bci_serving_requeues_total",
                "Admissions bounced back to the queue by a capacity race",
            )
            self._rejected_total = metrics.counter(
                "bci_serving_queue_rejected_total",
                "Submissions rejected at the queue bound",
            )
            metrics.gauge(
                "bci_serving_queue_depth",
                "Accepted-but-not-admitted tickets",
                lambda: len(self._queued),
            )
        # heap entries: (-priority, arrival seq, ticket, request);
        # cancellation of a queued ticket is lazy — the ticket leaves
        # self._queued and its entry is skipped when it surfaces
        self._heap: list[tuple[int, int, int, _Queued]] = []
        self._next_seq = 0
        self._next_ticket = 0
        # ticket -> batcher request id (admitted), 'queued', 'cancelled',
        # or ('error', msg) for an admission-time failure
        self._state: dict[int, object] = {}
        self._queued: set[int] = set()
        self._stream_cursor: dict[int, int] = {}
        self._holdback: dict[int, int] = {}
        # admitted interleaved tickets -> their request, for preempt; a
        # preempted ticket requeues ahead of its class (decreasing seq)
        self._preemptable: dict[int, _Queued] = {}
        self._front_seq = 0

    # ----------------------------------------------------- snapshot/resume
    def state_dict(self) -> dict:
        """The batcher's snapshot (``ContinuousBatcher.state_dict``) plus
        the queue: tickets not yet admitted resume queued, in their
        (priority, arrival) order. Pickles unless a request carries a
        callable ``allowed_tokens``."""
        return {
            "batcher": self.batcher.state_dict(),
            "heap": copy.deepcopy(self._heap),
            "state": copy.deepcopy(self._state),
            "queued": set(self._queued),
            "stream_cursor": dict(self._stream_cursor),
            "holdback": dict(self._holdback),
            "next_seq": self._next_seq,
            "next_ticket": self._next_ticket,
            "preemptable": copy.deepcopy(self._preemptable),
            "front_seq": self._front_seq,
        }

    def load_state_dict(self, state: dict) -> None:
        """Adopt a snapshot taken by ``state_dict``. ``max_queue`` is this
        engine's policy, not serving state, and stays."""
        self.batcher.load_state_dict(state["batcher"])
        self._heap = copy.deepcopy(state["heap"])
        heapq.heapify(self._heap)
        self._state = copy.deepcopy(state["state"])
        self._queued = set(state["queued"])
        self._stream_cursor = dict(state["stream_cursor"])
        self._holdback = dict(state["holdback"])
        self._next_seq = state["next_seq"]
        self._next_ticket = state["next_ticket"]
        self._preemptable = copy.deepcopy(state["preemptable"])
        self._front_seq = state["front_seq"]

    # ------------------------------------------------------------- intake
    def submit(
        self,
        prompt,
        max_new_tokens: int,
        sampling: SamplingParams | None = None,
        prefill_chunk: int | None = None,
        adapter: int | None = None,
        priority: int = 0,
        interleave_admission: int | None = None,
    ) -> int:
        """Accept a request and return a ticket. Everything
        capacity-independent fails here, through the batcher's own
        ``validate_request`` (``prefill_chunk`` >= 1 included)."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        pages_needed = self.batcher.validate_request(
            prompt, max_new_tokens, sampling=sampling, adapter=adapter,
            interleave_admission=interleave_admission,
            prefill_chunk=prefill_chunk,
        )
        if self.max_queue is not None and len(self._queued) >= self.max_queue:
            if self._metrics is not None:
                self._rejected_total.inc()
            if self._monitor is not None:
                self._monitor.on_ticket_rejected("queue_full")
            raise RuntimeError(f"queue full ({self.max_queue})")
        req = _Queued(prompt, max_new_tokens, sampling, prefill_chunk,
                      adapter, pages_needed, interleave_admission, priority)
        ticket = self._next_ticket
        self._next_ticket += 1
        seq = self._next_seq
        self._next_seq += 1
        heapq.heappush(self._heap, (-priority, seq, ticket, req))
        self._state[ticket] = "queued"
        self._queued.add(ticket)
        self._stream_cursor[ticket] = 0
        self._holdback[ticket] = stream_holdback(sampling)
        if self._metrics is not None:
            self._ticket_submit_t[ticket] = time.monotonic()
        if self._monitor is not None:
            self._monitor.on_ticket_queued(ticket)
        return ticket

    def set_monitor(self, monitor) -> None:
        """Attach a lifecycle monitor (``ServingMonitor.attach`` calls
        this)."""
        self._monitor = monitor

    # -------------------------------------------------------------- admit
    def _admit_ready(self) -> None:
        while self._heap:
            neg_prio, seq, ticket, req = self._heap[0]
            if ticket not in self._queued:  # cancelled while queued
                heapq.heappop(self._heap)
                continue
            if not self.batcher.has_free_row():
                return
            # page backpressure, strictly FCFS within a priority: the head
            # waits for its pages; smaller requests behind it do not jump.
            # Pages a prefix hit would reuse need no fresh allocation, and
            # parked pages can be evicted for it.
            available = (
                len(self.batcher.free_pages) + len(self.batcher.evictable)
            )
            fresh_needed = req.pages_needed - self.batcher.prefix_credit(
                req.prompt, req.adapter
            )
            if fresh_needed > available:
                return
            heapq.heappop(self._heap)
            self._queued.discard(ticket)
            if self._monitor is not None:
                # before the submit: the monitor stages this ticket's queue
                # wait, so the request born inside the call starts its clock
                # at engine intake (a blocking admission fixes TTFT before
                # submit returns)
                self._monitor.on_ticket_admitting(ticket)
            try:
                rid = self.batcher.submit(
                    req.prompt, req.max_new_tokens, sampling=req.sampling,
                    prefill_chunk=req.prefill_chunk, adapter=req.adapter,
                    interleave_admission=req.interleave_admission,
                )
            except CapacityError:
                heapq.heappush(self._heap, (neg_prio, seq, ticket, req))
                self._queued.add(ticket)
                if self._metrics is not None:
                    self._requeues_total.inc()
                if self._monitor is not None:
                    self._monitor.on_ticket_requeued(ticket)
                return
            except Exception as e:
                # validate_request ran at intake, so this "cannot happen";
                # if it does, fail the ticket instead of wedging the queue.
                # Not under a mesh: a rank cannot fail a request alone while
                # the other ranks wait in that request's collectives (its
                # next request's exchanges would pair with theirs), so the
                # rank fails, and the launcher stops the others.
                if self.batcher.mesh is not None:
                    raise
                self._state[ticket] = ("error", repr(e))
                self._ticket_submit_t.pop(ticket, None)
                if self._monitor is not None:
                    self._monitor.on_ticket_failed(ticket, repr(e))
                continue
            self._state[ticket] = rid
            if req.interleave_admission is not None:
                self._preemptable[ticket] = req
            if self._metrics is not None:
                t0 = self._ticket_submit_t.pop(ticket, None)
                if t0 is not None:
                    self._queue_wait_seconds.observe(time.monotonic() - t0)

    # --------------------------------------------------------------- step
    def step(self) -> None:
        """Admit whatever fits, then advance the batch one round."""
        self._admit_ready()
        self.batcher.step()
        self._admit_ready()  # rows/pages freed by retirements this step

    def run_to_completion(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if not self._queued and not self.batcher.busy:
                return
            self.step()
        raise RuntimeError("run_to_completion exceeded max_steps")

    @property
    def pending(self) -> int:
        """Accepted-but-not-admitted request count (queue depth)."""
        return len(self._queued)

    @property
    def outstanding(self) -> int:
        """Queued tickets plus occupied rows: the load a replica router
        reads (O(1), where ``stats`` iterates every ticket)."""
        return (self.pending + int(self.batcher.active.sum())
                + len(self.batcher.prefill_state))

    @property
    def busy(self) -> bool:
        """Whether the batcher is decoding or admitting a row."""
        return self.batcher.busy

    @property
    def stats(self) -> dict:
        st = {**self.batcher.stats, "queued": len(self._queued)}
        st["requests_submitted"] = len(self._state)
        st["requests_finished"] = sum(
            1 for t in self._state if self.is_done(t)
        )
        return st

    # ------------------------------------------------------------ results
    def _rid(self, ticket: int):
        if ticket not in self._state:
            raise KeyError(f"unknown ticket {ticket}")
        return self._state[ticket]

    def is_done(self, ticket: int) -> bool:
        rid = self._rid(ticket)
        if rid == "queued":
            return False
        if rid == "cancelled" or isinstance(rid, tuple):
            return True
        return self.batcher.is_done(rid)

    def result(self, ticket: int) -> list[int]:
        rid = self._rid(ticket)
        if rid == "queued":
            raise RuntimeError(f"ticket {ticket} still queued")
        if rid == "cancelled" or isinstance(rid, tuple):
            return []
        return self.batcher.result(rid)

    def result_logprobs(self, ticket: int) -> list[float]:
        rid = self._rid(ticket)
        if rid == "queued":
            raise RuntimeError(f"ticket {ticket} still queued")
        if rid == "cancelled" or isinstance(rid, tuple):
            return []
        return self.batcher.result_logprobs(rid)

    def finish_reason(self, ticket: int) -> str:
        rid = self._rid(ticket)
        if rid == "queued":
            raise RuntimeError(f"ticket {ticket} still queued")
        if rid == "cancelled":
            return "cancelled"
        if isinstance(rid, tuple):
            return "error"
        return self.batcher.finish_reason(rid)

    def ticket_error(self, ticket: int) -> str | None:
        rid = self._rid(ticket)
        if isinstance(rid, tuple):
            return rid[1]
        if rid in ("queued", "cancelled"):
            return None
        return self.batcher.request_error(rid)

    def partial_result(self, ticket: int) -> list[int]:
        """Tokens generated so far; safe at any time (empty while queued,
        cancelled before admission, failed or released)."""
        rid = self._rid(ticket)
        if rid in ("queued", "cancelled") or isinstance(rid, tuple):
            return []
        return list(self.batcher.results.get(rid, ()))

    def new_tokens(self, ticket: int) -> list[int]:
        """Streaming read: tokens appended since the last call, holding
        back the last (max stop length - 1) while the request is live; the
        concatenation of every chunk equals ``result``."""
        tokens = self.partial_result(ticket)
        if not tokens:
            return []
        chunk, self._stream_cursor[ticket] = stream_chunk(
            tokens, self.is_done(ticket), self._stream_cursor[ticket],
            self._holdback[ticket])
        return chunk

    def preempt(self, ticket: int) -> bool:
        """Evict an admitted ticket whose interleaved prefill has not
        produced a token back to the head of its priority class (it earned
        its pages once). The batcher frees its pages and forgets the old
        request id; admitting it again recomputes the prefill, exactly.
        False for queued, finished, decoding or blocking-admitted tickets;
        an unknown ticket raises KeyError."""
        rid = self._rid(ticket)
        if not isinstance(rid, int):
            return False
        req = self._preemptable.pop(ticket, None)
        if req is None or not self.batcher.preempt(rid):
            return False
        self._front_seq -= 1
        heapq.heappush(self._heap,
                       (-req.priority, self._front_seq, ticket, req))
        self._queued.add(ticket)
        self._state[ticket] = "queued"
        self._stream_cursor[ticket] = 0
        if self._metrics is not None:
            # the queue wait is measured again from the preemption, as the
            # monitor's fresh queued clock below
            self._ticket_submit_t[ticket] = time.monotonic()
        if self._monitor is not None:
            self._monitor.on_ticket_queued(ticket)
        return True

    def cancel(self, ticket: int) -> None:
        """Cancel queued (never touches the device) or admitted (pages
        freed mid-decode) work; racing completion is a no-op."""
        rid = self._rid(ticket)
        if rid == "queued":
            self._queued.discard(ticket)  # heap entry skipped lazily
            self._state[ticket] = "cancelled"
            self._stream_cursor.pop(ticket, None)
            self._holdback.pop(ticket, None)
            self._ticket_submit_t.pop(ticket, None)
            if self._monitor is not None:
                self._monitor.on_ticket_cancelled(ticket)
            return
        if rid != "cancelled" and not isinstance(rid, tuple):
            self.batcher.cancel(rid)

    def release(self, ticket: int) -> None:
        rid = self._rid(ticket)
        if rid == "queued":
            raise RuntimeError(f"ticket {ticket} still queued")
        if rid != "cancelled" and not isinstance(rid, tuple):
            self.batcher.release(rid)
        self._stream_cursor.pop(ticket, None)
        self._holdback.pop(ticket, None)
        self._preemptable.pop(ticket, None)
