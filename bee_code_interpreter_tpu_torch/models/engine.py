"""Serving engine: a request queue in front of the continuous batcher.

The counterpart of ``bee_code_interpreter_tpu/models/engine.py``, host-side
only. ``submit`` always accepts (up to an optional queue bound) and returns a
ticket; admission into the batcher happens inside ``step`` the moment a row
and enough pages are free, in (priority desc, arrival) order with deliberate
head-of-line blocking. ``new_tokens`` is the streaming read; ``cancel`` works
on queued and admitted tickets.

Not ported yet (``NotImplementedError``): the ``metrics``/``monitor`` hooks,
``prefill_chunk``/``adapter``/``interleave_admission`` on ``submit``,
``preempt`` (it needs interleaved admission) and ``state_dict``.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

from bee_code_interpreter_tpu_torch.models.serving import (
    CapacityError,
    ContinuousBatcher,
    SamplingParams,
    not_ported,
)


@dataclass
class _Queued:
    prompt: object
    max_new_tokens: int
    sampling: SamplingParams | None
    pages_needed: int


class Engine:
    """Queue + admission loop over a ``ContinuousBatcher``.

    ``max_queue`` bounds accepted-but-not-admitted requests (None =
    unbounded); ``submit`` raises RuntimeError at the bound.
    """

    def __init__(self, batcher: ContinuousBatcher,
                 max_queue: int | None = None, metrics=None,
                 monitor=None) -> None:
        if metrics is not None:
            raise not_ported("the metrics hook")
        if monitor is not None:
            raise not_ported("the monitor hook")
        self.batcher = batcher
        self.max_queue = max_queue
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

    def state_dict(self) -> dict:
        raise not_ported("serving snapshots (state_dict)")

    def load_state_dict(self, state: dict) -> None:
        raise not_ported("serving snapshots (load_state_dict)")

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
        ``validate_request``."""
        if prefill_chunk is not None:
            raise not_ported("chunked admission (prefill_chunk)")
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        pages_needed = self.batcher.validate_request(
            prompt, max_new_tokens, sampling=sampling, adapter=adapter,
            interleave_admission=interleave_admission,
        )
        if self.max_queue is not None and len(self._queued) >= self.max_queue:
            raise RuntimeError(f"queue full ({self.max_queue})")
        req = _Queued(prompt, max_new_tokens, sampling, pages_needed)
        ticket = self._next_ticket
        self._next_ticket += 1
        seq = self._next_seq
        self._next_seq += 1
        heapq.heappush(self._heap, (-priority, seq, ticket, req))
        self._state[ticket] = "queued"
        self._queued.add(ticket)
        self._stream_cursor[ticket] = 0
        # streaming holdback: while the request is live, the last
        # (max stop length - 1) tokens stay unstreamed, so a stop sequence
        # completing later never trims a token already emitted
        stops = sampling.stop_sequences if sampling is not None else ()
        self._holdback[ticket] = max((len(s) for s in stops), default=1) - 1
        return ticket

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
            # waits for its pages; smaller requests behind it do not jump
            if req.pages_needed > len(self.batcher.free_pages):
                return
            heapq.heappop(self._heap)
            self._queued.discard(ticket)
            try:
                rid = self.batcher.submit(
                    req.prompt, req.max_new_tokens, sampling=req.sampling,
                )
            except CapacityError:
                heapq.heappush(self._heap, (neg_prio, seq, ticket, req))
                self._queued.add(ticket)
                return
            except Exception as e:
                # validate_request ran at intake, so this "cannot happen";
                # if it does, fail the ticket instead of wedging the queue
                self._state[ticket] = ("error", repr(e))
                continue
            self._state[ticket] = rid

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
        limit = (
            len(tokens) if self.is_done(ticket)
            else max(0, len(tokens) - self._holdback[ticket])
        )
        cursor = self._stream_cursor[ticket]
        if limit <= cursor:
            return []
        self._stream_cursor[ticket] = limit
        return list(tokens[cursor:limit])

    def preempt(self, ticket: int) -> bool:
        raise not_ported("preemption (it needs interleaved admission)")

    def cancel(self, ticket: int) -> None:
        """Cancel queued (never touches the device) or admitted (pages
        freed mid-decode) work; racing completion is a no-op."""
        rid = self._rid(ticket)
        if rid == "queued":
            self._queued.discard(ticket)  # heap entry skipped lazily
            self._state[ticket] = "cancelled"
            self._stream_cursor.pop(ticket, None)
            self._holdback.pop(ticket, None)
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
