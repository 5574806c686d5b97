"""Continuous batching over the paged KV cache, in PyTorch.

The counterpart of ``bee_code_interpreter_tpu/models/serving.py``: requests
of different lengths share one decode batch and one page pool. ``submit``
prefills a prompt into freshly allocated pages (one ``forward`` over the
prompt padded to whole pages, then ``seed_prefill``) and samples its first
token; every ``step`` advances all active rows by one token through one
``decode_step_paged`` over all ``max_batch`` rows (idle rows point at the
scratch page and are ignored); a finished row frees its pages at once.

The host keeps the integer bookkeeping (free-page stack, block tables,
cursors) in numpy and samples per request from a seeded numpy Generator, as
the JAX batcher does, so a request's output never depends on its batch-mates.
Where JAX compiles "device programs", the port makes plain torch calls, and
it updates the pool in place where JAX donates it.

Ported: the blocking one-shot admission, the plain decode step, stops, eos,
cancel, results and logprobs. Refused with ``NotImplementedError`` until a
later slice ports them (ROADMAP Queue 1): speculative decoding
(``draft_params``), ``prefix_cache``, LoRA ``adapters``, ``mesh``,
``metrics``/``monitor`` hooks, ``prefill_chunk`` and ``interleave_admission``
on ``submit``, int8 KV pools, ``preempt`` and ``state_dict``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from bee_code_interpreter_tpu_torch.device import resolve_device
from bee_code_interpreter_tpu_torch.models import transformer
from bee_code_interpreter_tpu_torch.models.transformer import TransformerConfig
from bee_code_interpreter_tpu_torch.ops.paged_kv_cache import (
    alloc_paged_cache,
    pool_telemetry,
    seed_prefill,
)

# physical page 0 is the scratch page: idle rows' block tables point at it,
# so their (masked, ignored) reads and writes never touch a live request's
# pages; the allocator never hands it out.
_SCRATCH_PAGE = 0


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP Queue 1)"
    )


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding knobs, the JAX package's semantics: greedy at
    temperature 0, otherwise categorical over temperature-scaled logits
    with top-k then top-p filtering, drawn from a per-request seeded
    generator. ``stop_sequences`` are token-id sequences, trimmed from the
    result; ``logprobs`` records log P(token) under the raw logits;
    ``logit_bias`` adds to raw logits; ``allowed_tokens`` is a callable
    (tokens generated so far -> permitted ids, or None)."""

    temperature: float = 0.0
    top_k: int | None = None
    top_p: float | None = None
    seed: int = 0
    stop_sequences: tuple[tuple[int, ...], ...] = ()
    logprobs: bool = False
    logit_bias: tuple[tuple[int, float], ...] = ()
    allowed_tokens: object = None  # Callable[[list[int]], Iterable[int] | None]

    def __post_init__(self) -> None:
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}"
            )
        object.__setattr__(
            self, "stop_sequences",
            tuple(tuple(int(t) for t in s) for s in self.stop_sequences),
        )
        if any(len(s) == 0 for s in self.stop_sequences):
            raise ValueError("stop sequences must be non-empty")
        bias = self.logit_bias
        if isinstance(bias, dict):
            bias = tuple(sorted(bias.items()))
        object.__setattr__(
            self, "logit_bias",
            tuple((int(t), float(b)) for t, b in bias),
        )
        if self.allowed_tokens is not None and not callable(
            self.allowed_tokens
        ):
            raise ValueError("allowed_tokens must be callable or None")

    @property
    def steered(self) -> bool:
        """True when selection needs the full logits row on host (bias or
        constraint active) even for a greedy request."""
        return bool(self.logit_bias) or self.allowed_tokens is not None


def logprob_of(logits: np.ndarray, token: int) -> float:
    """log P(token) under the raw logits row (stable log-softmax in f64)."""
    lg = logits.astype(np.float64)
    m = lg.max()
    return float(lg[token] - m - np.log(np.exp(lg - m).sum()))


def filtered_probs_host(
    logits: np.ndarray, params: SamplingParams
) -> np.ndarray:
    """Temperature, top-k (keeps >= kth) and top-p (stable descending
    order, top token always kept), then softmax, for one row."""
    lg = logits.astype(np.float64) / params.temperature
    if params.top_k is not None:
        kth = np.partition(lg, -params.top_k)[-params.top_k]
        lg = np.where(lg < kth, -np.inf, lg)
    if params.top_p is not None:
        order = np.argsort(-lg, kind="stable")
        probs = np.exp(lg[order] - lg[order[0]])
        probs /= probs.sum()
        keep = np.cumsum(probs) - probs < params.top_p  # smallest set > p
        keep[0] = True
        lg[order[~keep]] = -np.inf
    probs = np.exp(lg - lg.max())
    return probs / probs.sum()


def sample_host(
    logits: np.ndarray, params: SamplingParams, rng: np.random.Generator
) -> int:
    """One host-side draw for a single row."""
    if params.temperature <= 0.0:
        return int(np.argmax(logits))
    probs = filtered_probs_host(logits, params)
    return int(rng.choice(logits.shape[0], p=probs))


class ConstraintExhausted(Exception):
    """The ``allowed_tokens`` constraint permits no continuation: normal
    control flow, the request retires with finish reason 'constraint'."""


class CapacityError(RuntimeError):
    """``submit`` found no free row or not enough free pages right now:
    transient backpressure, retryable after a ``step``."""


def choose_host(
    logits: np.ndarray,  # [V] f32, the raw model logits for this row
    params: SamplingParams,
    rng: np.random.Generator,
    generated: list[int],
) -> int:
    """Full per-row selection: ``logit_bias`` and ``allowed_tokens`` on a
    copy of the raw row, then greedy argmax or the ``sample_host`` draw."""
    if params.steered:
        logits = logits.astype(np.float64, copy=True)
        for token, bias in params.logit_bias:
            logits[token] += bias
        if params.allowed_tokens is not None:
            allowed = params.allowed_tokens(list(generated))
            if allowed is not None:
                idx = np.fromiter(
                    (int(t) for t in allowed), dtype=np.int64
                )
                if idx.size == 0:
                    raise ConstraintExhausted(
                        "allowed_tokens permits no continuation"
                    )
                if (idx < 0).any() or (idx >= logits.shape[0]).any():
                    raise ValueError(
                        "allowed_tokens returned out-of-vocab token ids"
                    )
                mask = np.full(logits.shape, -np.inf)
                mask[idx] = 0.0
                logits = logits + mask
    return sample_host(logits, params, rng)


class ContinuousBatcher:
    """Admit -> step -> collect loop over ``decode_step_paged``.

    ``max_batch`` bounds concurrent requests; ``n_pages``/``page_size``
    size the shared pool; ``max_pages_per_seq`` is the block-table width,
    so it bounds prompt + generation at ``max_pages_per_seq * page_size``.
    ``device`` defaults to CUDA (raises without it); ``params`` must
    already live there.
    """

    def __init__(
        self,
        params,
        config: TransformerConfig,
        *,
        max_batch: int = 8,
        n_pages: int = 64,
        page_size: int = 16,
        max_pages_per_seq: int = 8,
        eos_id: int | None = None,
        draft_params=None,
        draft_config: TransformerConfig | None = None,
        prefix_cache: bool = False,
        adapters: list | None = None,
        mesh=None,
        metrics=None,
        monitor=None,
        device: torch.device | str | None = None,
    ) -> None:
        for name, value in (
            ("speculative decoding (draft_params)", draft_params),
            ("speculative decoding (draft_config)", draft_config),
            ("LoRA serving (adapters)", adapters),
            ("tensor-parallel serving (mesh)", mesh),
            ("the metrics hook", metrics),
            ("the monitor hook", monitor),
        ):
            if value is not None:
                raise not_ported(name)
        if prefix_cache:
            raise not_ported("the prefix cache")
        if config.kv_cache_dtype == "int8":
            raise not_ported("the int8 KV pool")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(
                f"params live on {params['embed'].device}, the batcher "
                f"runs on {self.device}"
            )
        self.params = params
        self.config = config
        self.page_size = page_size
        self.eos_id = eos_id
        self.max_len = max_pages_per_seq * page_size
        self.cache = alloc_paged_cache(config, n_pages, page_size, self.device)
        self.block_table = np.full(
            (max_batch, max_pages_per_seq), _SCRATCH_PAGE, dtype=np.int32
        )
        self.pos = np.zeros(max_batch, dtype=np.int32)
        self.active = np.zeros(max_batch, dtype=bool)
        self.current = np.zeros((max_batch, 1), dtype=np.int32)
        self.budget = np.zeros(max_batch, dtype=np.int32)
        # rows are recycled; request ids are forever
        self.row_request = np.full(max_batch, -1, dtype=np.int64)
        self.results: dict[int, list[int]] = {}
        self.results_logprobs: dict[int, list[float]] = {}
        self.done: dict[int, bool] = {}
        # request -> eos | stop | length | constraint | error | cancelled
        self.finish: dict[int, str] = {}
        self.errors: dict[int, str] = {}  # request -> repr of callable error
        self.row_sampling: list[SamplingParams | None] = [None] * max_batch
        self.row_rng: list[np.random.Generator | None] = [None] * max_batch
        self._next_request_id = 0
        self.n_tokens_generated = 0
        self.free_pages = list(range(n_pages - 1, _SCRATCH_PAGE, -1))
        self.page_ref = np.zeros(n_pages, dtype=np.int32)

    def kv_telemetry(self) -> dict:
        """Page accounting and slot-level fragmentation of the pool."""
        return pool_telemetry(
            block_table=self.block_table,
            pos=self.pos,
            active=self.active,
            page_ref=self.page_ref,
            page_size=self.page_size,
            free_pages=len(self.free_pages),
            parked_pages=0,
            scratch_page=_SCRATCH_PAGE,
        )

    def state_dict(self) -> dict:
        raise not_ported("serving snapshots (state_dict)")

    def load_state_dict(self, state: dict) -> None:
        raise not_ported("serving snapshots (load_state_dict)")

    # ------------------------------------------------------------- admission
    def has_free_row(self) -> bool:
        return bool((~self.active).any())

    @property
    def busy(self) -> bool:
        """Rows decoding: the loop-until condition of ``run_to_completion``."""
        return bool(self.active.any())

    def validate_request(
        self,
        prompt,
        max_new_tokens: int,
        sampling: SamplingParams | None = None,
        adapter: int | None = None,
        interleave_admission: int | None = None,
    ) -> int:
        """Capacity-independent request validation; returns the page count
        the request needs. Anything that passes can fail admission only
        transiently (``CapacityError``)."""
        if adapter is not None:
            raise not_ported("LoRA serving (adapter)")
        if interleave_admission is not None:
            raise not_ported("interleaved admission")
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        L = int(prompt.shape[0])
        if L < 1:
            raise ValueError("prompt must be non-empty")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = L + max_new_tokens
        if total > self.max_len:
            raise ValueError(
                f"prompt+generation ({total}) exceeds the block table's "
                f"budget ({self.max_len})"
            )
        n_need = -(-total // self.page_size)  # ceil
        usable = self.page_ref.shape[0] - 1  # minus the scratch page
        if n_need > usable:
            raise ValueError(
                f"request needs {n_need} pages but the pool only has "
                f"{usable} (a permanent misfit, not backpressure)"
            )
        return n_need

    def submit(
        self,
        prompt,
        max_new_tokens: int,
        sampling: SamplingParams | None = None,
        prefill_chunk: int | None = None,
        adapter: int | None = None,
        interleave_admission: int | None = None,
    ) -> int:
        """Prefill ``prompt`` into freshly allocated pages, sample its first
        token and return a request id (stable across row recycling).
        Raises ``CapacityError`` if no row or not enough pages are free."""
        if prefill_chunk is not None:
            raise not_ported("chunked admission (prefill_chunk)")
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        n_need = self.validate_request(
            prompt, max_new_tokens, sampling=sampling, adapter=adapter,
            interleave_admission=interleave_admission,
        )
        L = int(prompt.shape[0])
        free_rows = np.flatnonzero(~self.active)
        if free_rows.size == 0:
            raise CapacityError("no free batch row (step() until one frees)")
        if n_need > len(self.free_pages):
            raise CapacityError(
                f"page pool exhausted ({n_need} needed, "
                f"{len(self.free_pages)} free)"
            )
        row = int(free_rows[0])
        pages = [self._alloc_page() for _ in range(n_need)]
        req = self._next_request_id
        self._next_request_id += 1
        self.block_table[row, :] = _SCRATCH_PAGE
        self.block_table[row, :n_need] = pages
        try:
            last_row = self._full_admit(prompt, pages, L)
        except BaseException:
            # a failed admission must not leak its pages: the row never
            # activated, so nothing else would return them
            self.block_table[row, :] = _SCRATCH_PAGE
            for page in reversed(pages):
                self._release_page(page)
            raise
        return self._activate_row(row, last_row, pages, L, sampling,
                                  max_new_tokens, req)

    def _activate_row(self, row, last_row, pages, L, sampling,
                      max_new_tokens, req) -> int:
        """Admission epilogue: sample the first token, activate the row.
        First-token failures release the pages and propagate (the caller
        never received the id), except an exhausted constraint, which
        completes the request with an empty output."""
        sampling = sampling or SamplingParams()
        try:
            rng = np.random.default_rng(sampling.seed)
            first = choose_host(last_row, sampling, rng, [])
        except ConstraintExhausted:
            self.block_table[row, :] = _SCRATCH_PAGE
            for page in reversed(pages):
                self._release_page(page)
            self.results[req] = []
            if sampling.logprobs:
                self.results_logprobs[req] = []
            self.done[req] = True
            self.finish[req] = "constraint"
            return req
        except BaseException:
            self.block_table[row, :] = _SCRATCH_PAGE
            for page in reversed(pages):
                self._release_page(page)
            raise
        self.pos[row] = L
        self.current[row, 0] = first
        self.budget[row] = max_new_tokens
        self.row_request[row] = req
        self.row_sampling[row] = sampling
        self.row_rng[row] = rng
        self.results[req] = [first]
        self.n_tokens_generated += 1
        if sampling.logprobs:
            self.results_logprobs[req] = [logprob_of(last_row, first)]
        self.done[req] = False
        self.active[row] = True
        self._retire_if_done(row)
        return req

    def _full_admit(self, prompt, pages, L) -> np.ndarray:
        """One-shot prefill of the prompt padded to whole pages (pad tokens
        are causally invisible to rows < L, so logits[L-1] and K/V[:L] are
        exact), then ``seed_prefill`` of K/V[:L] into the row's pages.
        Returns the last prompt token's logits row."""
        n_prompt_pages = -(-L // self.page_size)
        padded = np.zeros(n_prompt_pages * self.page_size, dtype=np.int64)
        padded[:L] = prompt
        tokens = torch.as_tensor(padded[None, :], device=self.device)
        logits, (k_pre, v_pre) = transformer.forward(
            self.params, tokens, self.config, return_kv=True
        )
        pages_t = torch.as_tensor(pages[:n_prompt_pages], device=self.device)
        seed_prefill(self.cache, pages_t,
                     k_pre[:, 0, :, :L, :], v_pre[:, 0, :, :L, :])
        return logits[0, L - 1, :].cpu().numpy()

    def _alloc_page(self) -> int:
        page = self.free_pages.pop()
        self.page_ref[page] = 1
        return page

    def _release_page(self, page: int) -> None:
        self.page_ref[page] -= 1
        if self.page_ref[page] == 0:
            self.free_pages.append(page)

    # ----------------------------------------------------------------- step
    def step(self) -> None:
        """Advance every active row by one token."""
        if not self.active.any():
            return
        dev = self.device
        logits, self.cache = transformer.decode_step_paged(
            self.params,
            torch.as_tensor(self.current, device=dev),
            torch.as_tensor(self.pos, device=dev),
            self.cache,
            torch.as_tensor(self.block_table, device=dev),
            self.config,
        )
        active_rows = np.flatnonzero(self.active)
        # the all-greedy case reduces on the device and moves B ints; the
        # full [max_batch, V] logits cross to the host only when some row
        # samples, records logprobs or is steered
        need_rows = any(
            self.row_sampling[row].temperature > 0.0
            or self.row_sampling[row].logprobs
            or self.row_sampling[row].steered
            for row in active_rows
        )
        need_greedy = any(
            self.row_sampling[row].temperature <= 0.0
            and not self.row_sampling[row].steered
            for row in active_rows
        )
        greedy = (
            torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
            if need_greedy else None
        )
        lg = logits[:, -1, :].cpu().numpy() if need_rows else None
        for row in active_rows:
            sp = self.row_sampling[row]
            req_row = int(self.row_request[row])
            if sp.temperature > 0.0 or sp.steered:
                try:
                    nxt = choose_host(
                        lg[row], sp, self.row_rng[row], self.results[req_row]
                    )
                except ConstraintExhausted:
                    self._retire(int(row), "constraint")
                    continue
                except Exception as e:
                    # a buggy user callable must not wedge the whole batch:
                    # the row retires with the error recorded
                    self.errors[req_row] = repr(e)
                    self._retire(int(row), "error")
                    continue
            else:
                nxt = int(greedy[row])
            self.pos[row] += 1
            self.current[row, 0] = nxt
            self.results[req_row].append(nxt)
            self.n_tokens_generated += 1
            if sp.logprobs:
                self.results_logprobs[req_row].append(
                    logprob_of(lg[row], nxt)
                )
            self._retire_if_done(int(row))

    def _done_reason(self, row: int, out: list[int]) -> tuple[str, int] | None:
        """(finish_reason, tokens_to_trim) once a row's output is complete:
        eos (kept in the output), then a stop sequence (trimmed), then the
        length budget."""
        if self.eos_id is not None and out and out[-1] == self.eos_id:
            return "eos", 0
        sp = self.row_sampling[row]
        if sp is not None:
            for s in sp.stop_sequences:
                if len(out) >= len(s) and tuple(out[-len(s):]) == s:
                    return "stop", len(s)
        if len(out) >= self.budget[row]:
            return "length", 0
        return None

    def _retire_if_done(self, row: int) -> None:
        verdict = self._done_reason(
            row, self.results[int(self.row_request[row])]
        )
        if verdict is not None:
            self._retire(row, *verdict)

    def _retire(self, row: int, reason: str, trim: int = 0) -> None:
        """Trim, record the finish reason, free the row and its pages."""
        req = int(self.row_request[row])
        out = self.results[req]
        if trim:
            del out[len(out) - trim:]
            lp = self.results_logprobs.get(req)
            if lp is not None:
                del lp[len(lp) - trim:]
        self.finish[req] = reason
        self.active[row] = False
        self.done[req] = True
        self.row_request[row] = -1
        self.row_sampling[row] = None
        self.row_rng[row] = None
        used = set(self.block_table[row].tolist()) - {_SCRATCH_PAGE}
        for page in sorted(used, reverse=True):
            self._release_page(page)
        self.block_table[row, :] = _SCRATCH_PAGE
        # pos stays for inspection; scratch-page writes are masked

    # -------------------------------------------------------------- results
    @property
    def stats(self) -> dict:
        return {
            "active_rows": int(self.active.sum()),
            "max_batch": int(self.active.shape[0]),
            "free_pages": len(self.free_pages),
            "held_pages": int((self.page_ref > 0).sum()),
            "requests_submitted": self._next_request_id,
            "requests_finished": sum(1 for v in self.done.values() if v),
            "tokens_generated": self.n_tokens_generated,
        }

    def is_done(self, request_id: int) -> bool:
        return self.done.get(request_id, False)

    def result(self, request_id: int) -> list[int]:
        """Generated tokens for a finished request (first token included),
        held until ``release``."""
        if request_id not in self.results:
            if self.done.get(request_id):
                raise KeyError(f"request {request_id} was released")
            raise KeyError(f"unknown request {request_id}")
        if not self.done[request_id]:
            raise RuntimeError(f"request {request_id} still decoding")
        return list(self.results[request_id])

    def result_logprobs(self, request_id: int) -> list[float]:
        if request_id not in self.done:
            raise KeyError(f"unknown request {request_id}")
        if request_id not in self.results_logprobs:
            if self.done[request_id] and request_id not in self.results:
                raise KeyError(f"request {request_id} was released")
            raise KeyError(
                f"request {request_id} did not record logprobs "
                "(submit with SamplingParams(logprobs=True))"
            )
        if not self.done[request_id]:
            raise RuntimeError(f"request {request_id} still decoding")
        return list(self.results_logprobs[request_id])

    def request_error(self, request_id: int) -> str | None:
        return self.errors.get(request_id)

    def finish_reason(self, request_id: int) -> str:
        """'eos' | 'stop' | 'length' | 'constraint' | 'error' | 'cancelled';
        survives ``release``."""
        if request_id not in self.finish:
            if self.done.get(request_id) is False:
                raise RuntimeError(f"request {request_id} still decoding")
            raise KeyError(f"unknown request {request_id}")
        return self.finish[request_id]

    def cancel(self, request_id: int) -> None:
        """Abort a decoding request: row and pages free at once, tokens so
        far stay readable. Cancelling a finished request is a no-op; an id
        never issued raises KeyError."""
        for row in np.flatnonzero(self.active):
            if int(self.row_request[row]) == request_id:
                self._retire(int(row), "cancelled")
                return
        if request_id not in self.done:
            raise KeyError(f"unknown request {request_id}")

    def preempt(self, request_id: int) -> bool:
        raise not_ported("preemption (it needs interleaved admission)")

    def release(self, request_id: int) -> None:
        """Drop a finished request's stored result; done-flag and finish
        reason are kept."""
        if request_id in self.done and not self.done[request_id]:
            raise RuntimeError(f"request {request_id} still decoding")
        self.results.pop(request_id, None)
        self.results_logprobs.pop(request_id, None)

    def run_to_completion(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.busy:
                return
            self.step()
        raise RuntimeError("run_to_completion exceeded max_steps")
