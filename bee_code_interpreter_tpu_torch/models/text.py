"""Text-level serving: tokenizer-in, stop STRINGS, UTF-8-safe streaming.

A copy of ``bee_code_interpreter_tpu/models/text.py`` over the PyTorch
``Engine``; it is host-only and speaks the tokenizer protocol.

``Engine``/``ContinuousBatcher`` speak token ids; real serving APIs speak
text. The gap is not just encode/decode at the edges — two contracts only
exist at the text level:

- **Stop strings.** A stop like ``"\\n\\n"`` can arrive split across any
  token boundary (or inside one token that also carries wanted text), so
  it CANNOT be compiled to token-id stop sequences. The text engine scans
  the decoded completion after every step and, on a match, truncates the
  text at the stop and cancels the underlying request (the current step's
  overshoot tokens are simply never shown — the user-visible contract is
  the text, not the token count).
- **Streaming without torn characters.** Detokenizers are not prefix-
  stable (merges, byte-level BPE continuation, multi-token unicode), so
  streamed text is computed by decoding the FULL token list and diffing
  against what was already emitted — plus a holdback of
  ``max(len(stop)) - 1`` characters so a stop string completing later can
  never claw back emitted text. The concatenated stream always equals
  ``text()``.

The tokenizer is a PROTOCOL, not a dependency: anything with
``encode(str) -> list[int]`` and ``decode(list[int]) -> str`` works — a
HuggingFace tokenizer does (pass ``add_special_tokens=False`` semantics
yourself if needed), and the tests use a trivial hermetic one. The
reference has no serving stack at all (SURVEY §2).
"""

from __future__ import annotations

from bee_code_interpreter_tpu_torch.models.engine import Engine
from bee_code_interpreter_tpu_torch.models.serving import SamplingParams


class TextEngine:
    """Text requests over an ``Engine``: ``submit(text)`` → ticket,
    ``step()``/``run_to_completion()`` to advance, ``text(ticket)`` for
    the finished completion and ``new_text(ticket)`` for streaming."""

    def __init__(self, engine: Engine, tokenizer) -> None:
        for method in ("encode", "decode"):
            if not callable(getattr(tokenizer, method, None)):
                raise TypeError(
                    f"tokenizer must implement {method}(); got "
                    f"{type(tokenizer).__name__}"
                )
        self.engine = engine
        self.tokenizer = tokenizer
        self._stops: dict[int, tuple[str, ...]] = {}
        self._holdback: dict[int, int] = {}
        self._emitted: dict[int, str] = {}  # text already streamed
        self._final: dict[int, str | None] = {}  # fixed text (None = live)
        self._reason: dict[int, str] = {}
        self._live: set[int] = set()
        # memo: ticket -> (token count, decoded text). _scan and new_text
        # both need the decode every step; without the memo each request
        # pays O(len^2) tokenizer work over its lifetime.
        self._decode_memo: dict[int, tuple[int, str]] = {}

    # ------------------------------------------------------------- intake
    def submit(
        self,
        text: str,
        max_new_tokens: int,
        stop: tuple[str, ...] = (),
        sampling: SamplingParams | None = None,
        **engine_kwargs,
    ) -> int:
        stop = tuple(stop)
        if any(not s for s in stop):
            raise ValueError("stop strings must be non-empty")
        prompt = self.tokenizer.encode(text)
        ticket = self.engine.submit(
            prompt, max_new_tokens, sampling=sampling, **engine_kwargs
        )
        self._stops[ticket] = stop
        self._holdback[ticket] = max((len(s) for s in stop), default=1) - 1
        self._emitted[ticket] = ""
        self._final[ticket] = None
        self._live.add(ticket)
        return ticket

    # --------------------------------------------------------------- step
    def _decoded(self, ticket: int) -> str:
        tokens = self.engine.partial_result(ticket)
        if not tokens:
            return ""
        memo = self._decode_memo.get(ticket)
        if memo is not None and memo[0] == len(tokens):
            return memo[1]
        text = self.tokenizer.decode(tokens)
        self._decode_memo[ticket] = (len(tokens), text)
        return text

    @staticmethod
    def _stable(text: str) -> str:
        """Drop the UNSTABLE decode tail: byte-level BPE emits U+FFFD for
        an incomplete multi-byte character until its continuation tokens
        arrive — those trailing chars are held back from streaming (and
        flushed at completion, when the decode is final)."""
        return text.rstrip("\ufffd")

    def _scan(self, ticket: int) -> None:
        """Post-step stop-string scan for one live text request: the
        EARLIEST stop match wins; a match cancels the underlying request
        (freeing its pages) and fixes the text at the truncation."""
        if self._final[ticket] is not None:
            return
        decoded = self._decoded(ticket)
        best: int | None = None
        for s in self._stops[ticket]:
            at = decoded.find(s)
            if at != -1 and (best is None or at < best):
                best = at
        if best is not None:
            self._final[ticket] = decoded[:best]
            # recorded NOW: deriving it later by re-decoding would flip to
            # 'cancelled' once the underlying request is released
            self._reason[ticket] = "stop"
            self._live.discard(ticket)
            if not self.engine.is_done(ticket):
                self.engine.cancel(ticket)
        elif self.engine.is_done(ticket):
            self._final[ticket] = decoded
            self._reason[ticket] = self.engine.finish_reason(ticket)
            self._live.discard(ticket)

    def step(self) -> None:
        self.engine.step()
        for ticket in list(self._live):
            self._scan(ticket)

    def run_to_completion(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if not self._live:
                return
            self.step()
        raise RuntimeError("run_to_completion exceeded max_steps")

    # ------------------------------------------------------------ results
    def is_done(self, ticket: int) -> bool:
        # keyed on _reason, which release() retains: the done-flag must
        # survive release (the engine/batcher layers uphold the same
        # contract) or a poller on a released ticket spins forever
        return ticket in self._reason

    def release(self, ticket: int) -> None:
        """Drop this ticket's text state AND the underlying request's —
        the long-running-server hygiene the engine/batcher layers already
        require. ``finish_reason`` stays observable (a string per
        ticket); ``text`` does not."""
        if ticket in self._final and self._final[ticket] is None:
            raise RuntimeError(f"ticket {ticket} still generating")
        self.engine.release(ticket)
        for d in (self._stops, self._holdback, self._emitted, self._final,
                  self._decode_memo):
            d.pop(ticket, None)
        self._live.discard(ticket)

    def text(self, ticket: int) -> str:
        if ticket not in self._final:
            if ticket in self._reason:
                raise KeyError(f"ticket {ticket} released")
            raise KeyError(f"unknown ticket {ticket}")
        final = self._final[ticket]
        if final is None:
            raise RuntimeError(f"ticket {ticket} still generating")
        return final

    def finish_reason(self, ticket: int) -> str:
        """'stop' when a stop string matched (even though the underlying
        request was cancelled to free its pages); otherwise the engine's
        reason — recorded at the moment the text was fixed, so it
        survives releasing the underlying request."""
        if ticket not in self._reason:
            if ticket in self._final:
                raise RuntimeError(f"ticket {ticket} still generating")
            raise KeyError(f"unknown ticket {ticket}")
        return self._reason[ticket]

    def new_text(self, ticket: int) -> str:
        """Streaming read: decoded text appended since the last call,
        holding back ``max(len(stop)) - 1`` characters while live so a
        later stop match can never claw back emitted text. The
        concatenation of every chunk equals ``text()``."""
        if ticket not in self._final:
            if ticket in self._reason:
                raise KeyError(f"ticket {ticket} released")
            raise KeyError(f"unknown ticket {ticket}")
        emitted = self._emitted[ticket]
        final = self._final[ticket]
        if final is not None:
            if not final.startswith(emitted):
                return ""  # decode tail shifted under the stream (see below)
            self._emitted[ticket] = final
            return final[len(emitted):]
        # stop holdback: a stop completing later must START within the
        # last (len(stop)-1) chars of the text that existed when it
        # completes, and every emission stopped at least that far back
        # (scans run every step, so any earlier-starting match would
        # already have fixed the text). _stable additionally holds back a
        # byte-level-BPE U+FFFD tail until its continuation arrives.
        # Emission is PREFIX-VERIFIED: if the decode mutated text the
        # stream already carries (a tokenizer unstable beyond its tail),
        # nothing more is emitted and text() remains the contract.
        visible = self._stable(self._decoded(ticket))
        limit = max(0, len(visible) - self._holdback[ticket])
        if limit <= len(emitted) or not visible.startswith(emitted):
            return ""
        chunk = visible[len(emitted): limit]
        self._emitted[ticket] = visible[:limit]
        return chunk
