"""Continuous batching over the paged KV cache, in PyTorch.

The counterpart of ``bee_code_interpreter_tpu/models/serving.py``: requests
of different lengths share one decode batch and one page pool (bf16, or
int8 with per-row scales). ``submit`` prefills a prompt into its pages and
samples its first token: one ``forward`` over the prompt padded to whole
pages then ``seed_prefill`` (one-shot), ``prefill_chunked`` then
``seed_from_contiguous`` (``prefill_chunk``), page-aligned
``decode_window_paged`` windows after a prefix-cache hit, or one window per
``step`` (``interleave_admission``). Every ``step`` advances all active
rows by one token through one ``decode_step_paged`` over all ``max_batch``
rows (idle rows point at the scratch page and are ignored); a finished row
frees its pages at once, and full prompt pages may stay indexed for later
requests (``prefix_cache``).

The host keeps the integer bookkeeping (free-page stack, block tables,
cursors, refcounts, the prefix index and its LRU) in numpy and samples per
request from a seeded numpy Generator, as the JAX batcher does, so a
request's output never depends on its batch-mates. Where JAX compiles
"device programs", the port makes plain torch calls, and it updates the
pool in place where JAX donates it.

Ported: every admission path above, the plain decode step, stops, eos,
cancel, preempt, results and logprobs; multi-LoRA serving (``adapters``:
per-row adapters in one decode pass, adapter admissions through the
windows); speculative serving (``draft_params``: a draft's own pool over
the same pages, greedy draft-verify and rejection sampling); serving
snapshots (``state_dict`` / ``load_state_dict``); the observability hooks
(``metrics``: a ``utils.metrics.Registry`` for the TTFT, inter-token and
step histograms and the capacity gauges; ``set_monitor``: a
``ServingMonitor``'s lifecycle and step hooks; ``set_device_monitor``: a
``DeviceMonitor``'s first-call and step hooks), wired where the JAX batcher
wires them.

Serving under a mesh (``mesh``, a ``parallel.make_mesh`` mesh over tp, sp
and ep axes) is SPMD: one process per device, where JAX's one controller
drives them all under GSPMD. Every rank builds the same
``ContinuousBatcher(params, config, mesh=mesh)``, calls ``submit`` /
``step`` / ``cancel`` / ``state_dict`` / ``load_state_dict`` in the same
order with the same arguments, and the caller reads rank 0's results; every
rank's are the same, since each samples on its host from the same logits
with the same seeded generators. A rank holds its shard of the weights
(``transformer.shard_params``: Megatron over tp, experts over ep) and a
page pool of its ``kv_heads / tp`` heads, its own allocation, replicated
over sp and ep; the model functions make the collectives
(``transformer``'s module docstring). An sp axis is the long-context
admission path: a one-shot admission (and the draft's) runs the padded
prompt sequence-parallel, each rank ``L/sp`` of it, then gathers the K/V
over sp into its pool and takes the last prompt token's logits from the
rank that holds it (``transformer.gather_prefill``). Every other program
(decode steps, admission windows, chunked admission) ignores sp, as JAX's
do: each sp rank runs the same step. The host loop is unchanged, so the
int8 pool, adapters, speculative decoding with a draft and prefix-cached,
chunked and interleaved admission ride along. ``state_dict`` gathers the
pool shards (a snapshot is topology-free) and ``load_state_dict`` takes
this rank's heads of a snapshot from any topology. Data-parallel axes
inside one batcher are not ported (replicas are ``models/replicated.py``)
and raise ``NotImplementedError``. Token streams equal the same batcher's
solo decode, bit for bit, within a mesh; across meshes the partial sums
add in another order, so, as JAX says, equality there is pinned by the
environment, not guaranteed.

Mixture-of-Experts configs serve as in JAX. Under capacity routing the
tokens of one forward compete for expert slots, so a request routes
against its batch-mates (free rows included) and its admission's padding:
outputs are deterministic for a given pool state but not equal to solo
decoding, and the prefix cache and speculative mode, whose guarantees are
exactness claims, require ``config.moe_exact`` (dense, or dropless
per-token routing).
"""

from __future__ import annotations

import copy
import hashlib
import time
from collections import OrderedDict, deque
from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np
import torch

from bee_code_interpreter_tpu_torch.device import resolve_device
from bee_code_interpreter_tpu_torch.models import transformer
from bee_code_interpreter_tpu_torch.models.lora import stack_lora_bank
from bee_code_interpreter_tpu_torch.models.transformer import TransformerConfig
from bee_code_interpreter_tpu_torch.ops.paged_kv_cache import (
    alloc_paged_cache,
    pool_telemetry,
    seed_from_contiguous,
    seed_prefill,
)
from bee_code_interpreter_tpu_torch.parallel.mesh import (
    all_gather_cat,
    axis_index,
    group_size,
    mesh_shape_key,
    serving_groups,
)
from bee_code_interpreter_tpu_torch.utils.jitwatch import TrackedJit

# physical page 0 is the scratch page: idle rows' block tables point at it,
# so their (masked, ignored) reads and writes never touch a live request's
# pages; the allocator never hands it out.
_SCRATCH_PAGE = 0


def _program(name: str, **bound):
    """``transformer.<name>`` with ``bound`` keywords, the function looked
    up at each call as a direct call would look it up."""
    def call(*args, **kwargs):
        return getattr(transformer, name)(*args, **bound, **kwargs)
    return call


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


def rejection_sample_commit(
    proposals,  # gamma draft proposals, x_g ~ q_dists[g]
    q_dists,  # gamma FILTERED draft distributions [V]
    p_fn,  # g -> FILTERED target distribution [V], g in [0, gamma]
    rng: np.random.Generator,
) -> tuple[list[int], int]:
    """Leviathan et al. rejection sampling for one verify window: accept
    proposal x with probability min(1, p(x)/q(x)); the first rejection
    resamples from normalize(max(p - q, 0)); a fully-accepted window draws
    its bonus token from the last target distribution. Returns (committed
    tokens, accepted proposal count). ``p_fn`` is called lazily, and the
    strict ``<`` keeps a token outside the target's support from
    committing. The JAX function line for line (host numpy), so the same
    generator state gives the same draws."""
    commit: list[int] = []
    n = 0
    for g, x in enumerate(proposals):
        p_dist, q_dist = p_fn(g), q_dists[g]
        x = int(x)
        if q_dist[x] > 0 and rng.random() < min(
            1.0, float(p_dist[x] / q_dist[x])
        ):
            commit.append(x)
            n += 1
            continue
        resid = np.maximum(p_dist - q_dist, 0.0)
        total = float(resid.sum())
        if total <= 0.0:  # p == q pointwise: resample from p directly
            resid, total = p_dist, float(p_dist.sum())
        commit.append(int(rng.choice(resid.shape[0], p=resid / total)))
        return commit, n
    p_last = p_fn(len(proposals))
    commit.append(int(rng.choice(p_last.shape[0], p=p_last)))
    return commit, n


class ContinuousBatcher:
    """Admit -> step -> collect loop over ``decode_step_paged``.

    ``max_batch`` bounds concurrent requests; ``n_pages``/``page_size``
    size the shared pool (bf16, or int8 with ``kv_cache_dtype="int8"``);
    ``max_pages_per_seq`` is the block-table width, so it bounds prompt +
    generation at ``max_pages_per_seq * page_size``. ``prefix_cache``
    shares full prompt pages between requests by the chain hash of their
    tokens (refcounts, and an LRU of parked pages evicted under pool
    pressure). ``device`` defaults to CUDA (raises without it); ``params``
    must already live there.

    ``mesh`` turns on serving over tp, sp and ep (the module docstring):
    the device defaults to the mesh's device type (this rank's card, or
    the CPU for a ``device_type="cpu"`` mesh), ``params`` (and
    ``draft_params``) are the full weights, anywhere, of which this rank
    keeps its shard, ``kv_heads`` (the draft's too) must divide by tp,
    ``page_size`` by sp, and under Ulysses both head counts by sp.

    ``adapters`` (LoRA trees of ``models/lora.py`` on the attention
    projections) are stacked into one bank; ``submit(adapter=i)`` serves a
    request under adapter i, rows under different adapters decoding in one
    pass with the delta applied unmerged (scaled by ``lora_scale``).
    Adapter admissions prefill through the page-aligned windows, and the
    prefix cache keys pages by (adapter, tokens).

    ``draft_params`` / ``draft_config`` make the batcher speculative: each
    step the draft proposes ``gamma`` tokens per row from its own pool
    (the same pages and tables), the target scores each row's window in
    one ``decode_window_paged`` and each row commits its own accepted
    prefix plus one token: the target's argmax for greedy rows, rejection
    sampling for sampled ones. Greedy rows equal plain greedy decoding.

    ``metrics`` (a ``utils.metrics.Registry``) and ``monitor`` (a duck-typed
    ``observability.ServingMonitor``, usually attached later through
    ``monitor.attach``) are the JAX batcher's instrumentation: the same
    metric names, step records and lifecycle hooks at the same points. With
    neither, nor a device monitor, a step is one ``None`` check away from
    the bare step, and no hook adds a device sync: gauges and step records
    read the host's numpy bookkeeping.
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
        gamma: int = 4,
        prefix_cache: bool = False,
        adapters: list | None = None,
        lora_scale: float = 1.0,
        mesh=None,
        metrics=None,
        monitor=None,
        device: torch.device | str | None = None,
    ) -> None:
        self.mesh = mesh
        groups = serving_groups(mesh)
        self._tp_group, self._sp_group = groups.tp, groups.sp
        tp, sp = groups.size("tp"), groups.size("sp")
        if mesh is not None:
            if config.kv_heads % tp:
                raise ValueError(
                    f"kv_heads {config.kv_heads} not divisible by tp={tp}"
                )
            if sp > 1 and page_size % sp:
                # padded admission widths are page multiples, and the sp
                # forward cuts the sequence sp ways
                raise ValueError(
                    f"page_size {page_size} not divisible by sp={sp} "
                    "(sp admission chunks the padded prompt)"
                )
            if sp > 1 and config.sp_attention == "ulysses":
                # refuse at construction a config no submit could admit
                for name, heads in (
                    ("n_heads", config.n_heads),
                    ("kv_heads", config.kv_heads),
                ):
                    if heads % sp:
                        raise ValueError(
                            f"{name} {heads} not divisible by sp={sp} "
                            "(ulysses sp admission shards heads)"
                        )
            if draft_config is not None and draft_config.kv_heads % tp:
                raise ValueError(
                    f"draft kv_heads {draft_config.kv_heads} not divisible "
                    f"by tp={tp}"
                )
            if device is None:
                device = mesh.device_type
        self.device = resolve_device(device)
        if mesh is not None:
            params = transformer.shard_params(params, config, mesh,
                                              self.device)
            if draft_params is not None and draft_config is not None:
                draft_params = transformer.shard_params(
                    draft_params, draft_config, mesh, self.device)
        elif params["embed"].device != self.device:
            raise ValueError(
                f"params live on {params['embed'].device}, the batcher "
                f"runs on {self.device}"
            )
        self.params = params
        self.config = config
        self.page_size = page_size
        self.eos_id = eos_id
        self.max_len = max_pages_per_seq * page_size
        self.draft_params = draft_params
        self.draft_config = draft_config
        self.gamma = gamma
        if prefix_cache and not config.moe_exact:
            # capacity routing couples the tokens of one forward: a
            # suffix-only prefill routes W tokens where the full prefill
            # routes L, so shared-prefix K/V would stop being the K/V an
            # unshared admission computes
            raise NotImplementedError(
                "prefix_cache requires a moe_exact config — dense, or MoE "
                "with moe_dropless + moe_group_size=1 (capacity routing "
                "pools differ between suffix-only and full prefill)"
            )
        self.prefix_cache_enabled = prefix_cache
        self.lora_scale = float(lora_scale)
        # only the stacked bank is kept, on the batcher's device
        self.n_adapters = len(adapters) if adapters else 0
        if adapters:
            bank = stack_lora_bank(list(adapters))
            unknown = set(bank) - {"wq", "wk", "wv", "wo"}
            if unknown:
                raise ValueError(
                    f"serving adapters target {sorted(unknown)}; the decode "
                    "path supports attention projections (wq/wk/wv/wo) only"
                )
            self.lora_bank = {
                t: {k: x.to(self.device) for k, x in ab.items()}
                for t, ab in bank.items()
            }
        else:
            self.lora_bank = None
        self.row_adapter = np.zeros(max_batch, dtype=np.int32)
        if (draft_params is None) != (draft_config is None):
            raise ValueError(
                "speculative mode needs BOTH draft_params and draft_config"
            )
        if draft_config is not None:
            if draft_config.vocab_size != config.vocab_size:
                raise ValueError("target and draft must share a vocabulary")
            if not config.moe_exact:
                # the verify window routes B·(γ+1) tokens where plain
                # decode routes B, so capacity routing can drop others
                raise NotImplementedError(
                    "speculative serving requires a moe_exact target — "
                    "dense, or MoE with moe_dropless + moe_group_size=1"
                )
            if gamma < 1:
                raise ValueError(f"gamma must be >= 1, got {gamma}")
            if draft_params["embed"].device != self.device:
                raise ValueError(
                    f"draft params live on {draft_params['embed'].device}, "
                    f"the batcher runs on {self.device}"
                )
        # under tp each rank's pool holds its kv_heads / tp heads (axis 2),
        # its own allocation
        self.cache = alloc_paged_cache(config, n_pages, page_size, self.device,
                                       kv_heads=config.kv_heads // tp)
        # the draft's own pool, addressed by the same block tables and pages
        self.draft_cache = (
            alloc_paged_cache(draft_config, n_pages, page_size, self.device,
                              kv_heads=draft_config.kv_heads // tp)
            if draft_config is not None else None
        )
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
        # Prefix cache (host bookkeeping only): a page holding a full page of
        # prompt K/V is keyed by the chain hash of the tokens up to its end
        # and shared through refcounts; a cached page at refcount 0 parks in
        # the LRU instead of the free list and is evicted only under
        # pressure. Only pages wholly inside [0, L) are shared: the decode
        # cursor starts at L, so nothing writes them again.
        self.page_ref = np.zeros(n_pages, dtype=np.int32)
        self.prefix_index: dict[bytes, int] = {}
        self.page_hash: dict[int, bytes] = {}
        self.evictable: OrderedDict[int, None] = OrderedDict()
        self.prefix_stats = {
            "lookups": 0, "hits": 0, "pages_reused": 0, "evictions": 0,
        }
        # row -> interleaved admission in progress: the row is occupied but
        # not active until its last window ran
        self.prefill_state: dict[int, dict] = {}
        # the programs of the JAX batcher under its names, tracked so that an
        # attached device monitor sees the first call at each signature (the
        # monitor resolves per call: one None check while unmonitored). The
        # verify pass is a window over the target pool, one program with the
        # suffix-admission windows, as in JAX.
        self._device_monitor = None
        self._mesh_key = mesh_shape_key(mesh)  # "1" on one card
        # under a mesh every program makes its collectives over the tp and
        # ep groups; the one-shot prefills run sequence-parallel over sp too
        mesh_kw = {} if mesh is None else {"tp_group": groups.tp,
                                           "ep_group": groups.ep}
        sp_kw = {} if groups.sp is None else {"sp_group": groups.sp}
        self._decode = self._track(
            _program("decode_step_paged", config=config, **mesh_kw),
            "decode_step_paged",
        )
        self._prefill = self._track(
            _program("forward", config=config, return_kv=True, **mesh_kw,
                     **sp_kw),
            "prefill_forward",
        )
        self._prefill_chunked = self._track(
            _program("prefill_chunked", config=config, **mesh_kw),
            "prefill_chunked",
        )
        self._window = self._track(
            _program("decode_window_paged", config=config, **mesh_kw),
            "decode_window_paged",
        )
        self._verify = self._window
        if draft_config is not None:
            self._draft_decode = self._track(
                _program("decode_step_paged", config=draft_config, **mesh_kw),
                "draft_decode_step_paged",
            )
            self._draft_prefill = self._track(
                _program("forward", config=draft_config, return_kv=True,
                         **mesh_kw, **sp_kw),
                "draft_prefill_forward",
            )
            self._draft_window = self._track(
                _program("decode_window_paged", config=draft_config,
                         **mesh_kw),
                "draft_decode_window_paged",
            )
        # Instrumentation (JAX serving.py:622-716). ``metrics`` is a
        # utils.metrics Registry; None keeps the step loop metrics-free.
        # ``monitor`` is a duck-typed ServingMonitor, usually injected
        # through monitor.attach -> set_monitor.
        self._metrics = metrics
        self._monitor = monitor
        # Lifetime telemetry that the monitor's step records difference: page
        # churn (held pages = allocated - released), prompt tokens prefilled,
        # speculative proposals accepted / rejected. Not serving state (not
        # in _HOST_STATE): a restored batcher counts from its own zero.
        self._pages_allocated = 0
        self._pages_released = 0
        self._prefill_tokens = 0
        self._spec_accepted = 0
        self._spec_rejected = 0
        self._t_submit: float | None = None  # the TTFT anchor (metrics only)
        if metrics is not None:
            from bee_code_interpreter_tpu_torch.utils.metrics import (
                TOKEN_LATENCY_BUCKETS,
            )

            self._ttft_seconds = metrics.histogram(
                "bci_serving_ttft_seconds",
                "Time from submit to a request's first generated token",
                buckets=TOKEN_LATENCY_BUCKETS,
            )
            self._inter_token_seconds = metrics.histogram(
                "bci_serving_inter_token_seconds",
                "Per-row latency between consecutive generated tokens",
                buckets=TOKEN_LATENCY_BUCKETS,
            )
            self._step_seconds = metrics.histogram(
                "bci_serving_step_seconds",
                "Wall time of one batcher step",
                buckets=TOKEN_LATENCY_BUCKETS,
            )
            self._tokens_total = metrics.counter(
                "bci_serving_tokens_total",
                "Tokens generated across all requests",
            )
            metrics.gauge(
                "bci_serving_active_rows",
                "Batch rows currently decoding",
                lambda: int(self.active.sum()),
            )
            metrics.gauge(
                "bci_serving_batch_occupancy",
                "Fraction of batch rows decoding (0-1)",
                lambda: float(self.active.sum()) / float(self.active.shape[0]),
            )
            metrics.gauge(
                "bci_serving_free_pages",
                "KV-cache pages on the free list",
                lambda: len(self.free_pages),
            )
            metrics.gauge(
                "bci_serving_tokens_per_second",
                "Decode throughput over the recent step window",
                self._tokens_per_second,
            )
            self._tokens_counted = 0
            # (monotonic time, cumulative tokens) samples; the rate gauge
            # reads their spread, so a scrape pays a subtraction
            self._rate_samples: deque[tuple[float, int]] = deque(maxlen=512)

    # the throughput gauge's window: older samples are dropped when it is
    # read, and a gauge whose newest sample is older reads 0 (an idle server
    # must not report its last burst's rate forever)
    _RATE_WINDOW_S = 30.0

    def _tokens_per_second(self) -> float:
        s = self._rate_samples
        if len(s) < 2:
            return 0.0
        now = time.monotonic()
        if now - s[-1][0] > self._RATE_WINDOW_S:
            return 0.0
        while len(s) > 2 and now - s[0][0] > self._RATE_WINDOW_S:
            s.popleft()
        (t0, n0), (t1, n1) = s[0], s[-1]
        return (n1 - n0) / (t1 - t0) if t1 > t0 else 0.0

    def _sync_token_counter(self) -> None:
        """Advance the token counter to the lifetime total, whichever path
        (step, admission, interleaved activation) produced the tokens."""
        delta = self.n_tokens_generated - self._tokens_counted
        if delta > 0:
            self._tokens_total.inc(delta)
            self._tokens_counted = self.n_tokens_generated

    def set_monitor(self, monitor) -> None:
        """Attach (or detach, with None) a lifecycle monitor
        (``ServingMonitor.attach`` calls this). Requests already in flight
        are not traced retroactively."""
        self._monitor = monitor

    def _track(self, fn, name: str) -> TrackedJit:
        """Wrap a program so an attached device monitor sees its first call
        at each signature."""
        return TrackedJit(fn, name, lambda: self._device_monitor)

    def set_device_monitor(self, monitor) -> None:
        """Attach (or detach, with None) a first-call and step telemetry
        monitor (``DeviceMonitor.attach`` calls this). Signatures called
        before attachment are not reported."""
        self._device_monitor = monitor

    def kv_telemetry(self) -> dict:
        """Page accounting, slot-level fragmentation of the pool, the
        prefix cache's counters and the lifetime page churn."""
        out = pool_telemetry(
            block_table=self.block_table,
            pos=self.pos,
            active=self.active,
            page_ref=self.page_ref,
            page_size=self.page_size,
            free_pages=len(self.free_pages),
            parked_pages=len(self.evictable),
            scratch_page=_SCRATCH_PAGE,
        )
        lookups = self.prefix_stats["lookups"]
        hits = self.prefix_stats["hits"]
        out["prefix"] = {
            **self.prefix_stats,
            "misses": lookups - hits,
            "hit_ratio": hits / lookups if lookups else 0.0,
            "indexed_pages": len(self.prefix_index),
            "enabled": self.prefix_cache_enabled,
        }
        out["pages_allocated_total"] = self._pages_allocated
        out["pages_released_total"] = self._pages_released
        return out

    # ----------------------------------------------------- snapshot/resume
    _HOST_STATE = (
        "block_table", "pos", "active", "current", "budget", "row_request",
        "row_adapter", "page_ref", "results", "results_logprobs", "done",
        "finish", "errors", "row_sampling", "row_rng", "_next_request_id",
        "n_tokens_generated", "free_pages", "prefix_index", "page_hash",
        "prefix_stats", "prefill_state",
    )

    def _geometry(self) -> dict:
        """The compatibility contract between a snapshot and the batcher
        restoring it: everything that changes what in-flight rows mean,
        behaviour (eos_id, gamma, lora_scale, the prefix cache) as well as
        shapes."""
        return {
            "config": self.config,
            "draft_config": self.draft_config,
            "n_pages": int(self.page_ref.shape[0]),
            "page_size": self.page_size,
            "max_batch": int(self.active.shape[0]),
            "max_pages_per_seq": int(self.block_table.shape[1]),
            "n_adapters": self.n_adapters,
            "eos_id": self.eos_id,
            "gamma": self.gamma,
            "lora_scale": self.lora_scale,
            "prefix_cache": self.prefix_cache_enabled,
        }

    def state_dict(self) -> dict:
        """Everything needed to resume serving mid-decode on a fresh
        batcher built with the same geometry (``load_state_dict`` checks).
        The pools come back as owned CPU tensors (numpy has no bf16), the
        host bookkeeping as deep copies; the dict pickles unless a live
        request carries a callable ``allowed_tokens``. Under a mesh every
        rank must call it: the pools' head shards are all-gathered, so the
        snapshot holds every head and restores on any topology."""
        def snap(pool):
            return {k: all_gather_cat(x, self._tp_group, dim=2).to(
                        "cpu", copy=True)
                    for k, x in pool.items()}

        device = {"cache": snap(self.cache)}
        if self.draft_config is not None:
            device["draft_cache"] = snap(self.draft_cache)
        host = {
            name: copy.deepcopy(getattr(self, name))
            for name in self._HOST_STATE
        }
        host["evictable"] = list(self.evictable)  # LRU order, oldest first
        return {"device": device, "host": host, "meta": self._geometry()}

    def load_state_dict(self, state: dict) -> None:
        """Adopt a snapshot taken by ``state_dict``: decoding continues
        where it stopped, with the same tokens and logprobs. The pools are
        copied into this batcher's own tensors, which keep their storage;
        under a mesh each rank copies its own heads of the snapshot's."""
        meta = state["meta"]
        mine = self._geometry()
        if set(meta) != set(mine):
            raise ValueError(
                "snapshot geometry keys differ from this build's "
                f"({sorted(set(meta) ^ set(mine))}) — version skew"
            )
        for key, want in meta.items():
            if mine[key] != want:
                raise ValueError(
                    f"snapshot geometry mismatch on {key!r}: snapshot has "
                    f"{want}, this batcher has {mine[key]}"
                )
        for k, x in state["device"]["cache"].items():
            self.cache[k].copy_(self._my_heads(x))
        if self.draft_config is not None:
            for k, x in state["device"]["draft_cache"].items():
                self.draft_cache[k].copy_(self._my_heads(x))
        for name in self._HOST_STATE:
            setattr(self, name, copy.deepcopy(state["host"][name]))
        self.evictable = OrderedDict(
            (page, None) for page in state["host"]["evictable"]
        )
        # Metrics are per process, not serving state: realign the token
        # counter's cursor so the restored total does not replay into it,
        # clear the throughput window, and drop the TTFT anchors (monotonic
        # times of the snapshotting process's clock).
        self._t_submit = None
        for rec in self.prefill_state.values():
            rec.pop("t_submit", None)
        if self._metrics is not None:
            self._tokens_counted = self.n_tokens_generated
            self._rate_samples.clear()
        # the telemetry counters are per process, but the adopted refcounts
        # change what "held" means: realign so allocated - released keeps
        # equalling the pool's ref > 0 count from here on
        self._pages_allocated = self._pages_released + int(
            (self.page_ref > 0).sum()
        )

    def _my_heads(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's K/V heads (axis 2) of a whole-pool leaf; all of them
        without tensor parallelism."""
        if self._tp_group is None:
            return x
        n = x.shape[2] // group_size(self._tp_group)
        return x.narrow(2, axis_index(self.mesh, "tp") * n, n)

    # ------------------------------------------------------------- admission
    def _occupied(self) -> np.ndarray:
        """Rows decoding or still admitting (interleaved)."""
        occupied = self.active.copy()
        occupied[list(self.prefill_state)] = True
        return occupied

    def has_free_row(self) -> bool:
        return not self._occupied().all()

    @property
    def busy(self) -> bool:
        """Rows decoding or admissions still interleaving: the loop-until
        condition of ``run_to_completion``."""
        return bool(self.active.any()) or bool(self.prefill_state)

    def validate_request(
        self,
        prompt,
        max_new_tokens: int,
        sampling: SamplingParams | None = None,
        adapter: int | None = None,
        interleave_admission: int | None = None,
        prefill_chunk: int | None = None,
    ) -> int:
        """Capacity-independent request validation; returns the page count
        the request needs. Anything that passes can fail admission only
        transiently (``CapacityError``). Unlike the JAX batcher, which
        ignores ``prefill_chunk`` when ``interleave_admission`` is set,
        the two together are refused."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        L = int(prompt.shape[0])
        if L < 1:
            raise ValueError("prompt must be non-empty")
        if interleave_admission is not None and (
            interleave_admission < self.page_size
            or interleave_admission % self.page_size
        ):
            raise ValueError(
                f"interleave_admission must be a positive multiple of "
                f"page_size ({self.page_size}), got {interleave_admission}"
            )
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError(f"chunk must be >= 1, got {prefill_chunk}")
            if interleave_admission is not None:
                raise ValueError(
                    "prefill_chunk and interleave_admission exclude each "
                    "other: the interleaved windows are the chunks"
                )
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if adapter is not None:
            if self.lora_bank is None:
                raise ValueError(
                    "no adapters configured (pass adapters= at construction)"
                )
            if not 0 <= adapter < self.n_adapters:
                raise ValueError(
                    f"adapter {adapter} out of range "
                    f"(have {self.n_adapters})"
                )
        speculative = self.draft_params is not None
        if speculative and sampling is not None and sampling.steered:
            raise ValueError(
                "speculative serving cannot apply logit_bias/allowed_tokens "
                "(draft-verify commits the target's unsteered argmax tokens)"
            )
        # a speculative round writes draft and verify K/V past the budget
        # before truncation, into pages the row must own: an active row's
        # cursor is at most L + budget - 2, its deepest write cursor + gamma
        overshoot = self.gamma - 1 if speculative else 0
        total = L + max_new_tokens + overshoot
        if total > self.max_len:
            raise ValueError(
                f"prompt+generation ({total}, incl. speculative overshoot "
                f"{overshoot}) exceeds the block table's budget "
                f"({self.max_len})"
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
        """Prefill ``prompt`` into its pages, sample its first token and
        return a request id (stable across row recycling). Raises
        ``CapacityError`` if no row or not enough pages are free.

        A prefix-cache hit runs only the suffix through the model, in
        page-aligned windows over the row's own table. ``prefill_chunk``
        admits through ``prefill_chunked`` (activation memory bounded by
        the chunk; on a hit it bounds the window width instead).
        ``interleave_admission`` (a multiple of page_size) defers the
        prefill: submit allocates the row and pages and runs no model, and
        each ``step`` first runs one window of that width, so the other
        rows keep decoding while a long prompt admits."""
        t_submit = time.monotonic()  # the TTFT anchor (metrics only)
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        n_need = self.validate_request(
            prompt, max_new_tokens, sampling=sampling, adapter=adapter,
            interleave_admission=interleave_admission,
            prefill_chunk=prefill_chunk,
        )
        L = int(prompt.shape[0])
        # internal index: 0 is the all-zeros base adapter of the bank
        adapter_internal = 0 if adapter is None else adapter + 1
        speculative = self.draft_params is not None
        free_rows = np.flatnonzero(~self._occupied())
        if free_rows.size == 0:
            raise CapacityError("no free batch row (step() until one frees)")
        # match before allocating: matched pages are refs, not allocations,
        # capped so at least one suffix token is left to give logits
        hashes: list[bytes] = []
        shared: list[int] = []
        if self.prefix_cache_enabled:
            self.prefix_stats["lookups"] += 1
            hashes, shared = self._prefix_match(prompt, adapter_internal)
        matched = len(shared)
        # take refs on shared pages before counting what is available, so
        # that a parked match counts neither as free nor as evictable
        for page in shared:
            if self.page_ref[page] == 0:
                self._pages_allocated += 1  # a parked page is held again
            self.page_ref[page] += 1
            self.evictable.pop(page, None)
        available = len(self.free_pages) + len(self.evictable)
        if n_need - matched > available:
            for page in reversed(shared):
                self._release_page(page)
            raise CapacityError(
                f"page pool exhausted ({n_need - matched} needed, "
                f"{available} free)"
            )
        if matched:
            self.prefix_stats["hits"] += 1
            self.prefix_stats["pages_reused"] += matched
        row = int(free_rows[0])
        pages = shared + [self._alloc_page() for _ in range(n_need - matched)]
        # the request id is born once the row and pages are secured: the
        # lifecycle monitor needs it before any prefill runs
        req = self._next_request_id
        self._next_request_id += 1
        if self._monitor is not None:
            self._monitor.on_submit(
                req,
                prompt_tokens=L,
                max_new_tokens=max_new_tokens,
                pages=n_need,
                prefix_pages=matched,
                adapter=adapter,
                speculative=speculative,
                interleaved=interleave_admission is not None,
            )
        # admission runs under the request's trace (monitor attached): the
        # first call of a program at a new prefill shape lands as an
        # ``xla.compile`` span in this request's span tree
        admit_ctx = (
            self._monitor.exemplar_context(req)
            if self._monitor is not None
            else nullcontext()
        )
        with admit_ctx:
            try:
                if interleave_admission is not None:
                    # no model runs now; the global table keeps the row on
                    # the scratch page until activation, the windows carry
                    # their own
                    record = self._prefill_record(
                        prompt, pages, hashes, matched, interleave_admission,
                        sampling, max_new_tokens, req, adapter_internal,
                        t_submit,
                    )
                    if speculative:
                        self._zero_draft_pages(pages[matched:])
                else:
                    self.block_table[row, :] = _SCRATCH_PAGE
                    self.block_table[row, :n_need] = pages
                    if matched or adapter_internal > 0:
                        # window admissions: prefix hits, and every adapter
                        # admission (matched == 0 makes the whole prompt the
                        # suffix); the windows are lora- and
                        # quantization-aware. Only the fresh draft pages are
                        # zeroed: matched ones hold draft K/V other rows may
                        # be sharing.
                        if speculative:
                            self._zero_draft_pages(pages[matched:])
                        last_row = self._suffix_admit(
                            row, prompt, matched, speculative, prefill_chunk,
                            adapter_internal,
                        )
                    else:
                        last_row = self._full_admit(prompt, pages, L,
                                                    speculative, prefill_chunk)
            except BaseException as e:
                # a failed admission must not leak its pages or its row: the
                # row never activated, so nothing else would return them
                # (the JAX batcher leaks them when its interleaved branch
                # fails)
                self._drop_row_pages(row, pages)
                if self._monitor is not None:
                    self._monitor.on_done(req, "error", tokens=0,
                                          error=repr(e))
                raise
            if interleave_admission is not None:
                self.prefill_state[row] = record
                self.results[req] = []
                self.done[req] = False
                return req
            self._prefill_tokens += L - matched * self.page_size
            self._t_submit = t_submit
            return self._activate_row(row, last_row, pages, hashes, L,
                                      sampling, max_new_tokens, req,
                                      adapter_internal, propagate=True)

    def _prefill_record(self, prompt, pages, hashes, matched, width,
                        sampling, max_new_tokens, req, adapter_internal,
                        t_submit) -> dict:
        """The state of an interleaved admission: the suffix after any
        prefix hit, padded to whole pages, the row's own table and the TTFT
        anchor."""
        start = matched * self.page_size
        bt_row = np.full((1, self.block_table.shape[1]), _SCRATCH_PAGE,
                         dtype=np.int32)
        bt_row[0, :len(pages)] = pages
        return {
            "req": req, "pages": pages, "hashes": hashes,
            "suffix": self._padded_suffix(prompt, start), "pos": start,
            "start": start, "L": int(prompt.shape[0]), "bt_row": bt_row,
            "width": width, "sampling": sampling,
            "max_new_tokens": max_new_tokens, "last_row": None,
            "adapter_internal": adapter_internal,
            "speculative": self.draft_params is not None,
            "t_submit": t_submit,
        }

    def _padded_suffix(self, prompt, start: int) -> np.ndarray:
        """The prompt from ``start`` on, zero-padded to whole pages."""
        n = int(prompt.shape[0]) - start
        suffix = np.zeros(-(-n // self.page_size) * self.page_size,
                          dtype=np.int32)
        suffix[:n] = prompt[start:]
        return suffix

    def _activate_row(self, row, last_row, pages, hashes, L, sampling,
                      max_new_tokens, req, adapter_internal=0,
                      propagate=False) -> int:
        """Admission epilogue of the blocking and interleaved paths:
        sample the first token, register the prompt's full pages in the
        prefix index, activate the row. First-token failures release the
        pages; ``propagate`` re-raises them (blocking submit: the caller
        never received the id), else they are recorded on the request. An
        exhausted constraint completes the request with an empty output."""
        sampling = sampling or SamplingParams()
        try:
            rng = np.random.default_rng(sampling.seed)
            first = choose_host(last_row, sampling, rng, [])
        except ConstraintExhausted:
            self._drop_row_pages(row, pages)
            self.results[req] = []
            if sampling.logprobs:
                self.results_logprobs[req] = []
            self.done[req] = True
            self.finish[req] = "constraint"
            if self._monitor is not None:
                self._monitor.on_done(req, "constraint", tokens=0)
            return req
        except BaseException as e:
            self._drop_row_pages(row, pages)
            if self._monitor is not None:
                self._monitor.on_done(req, "error", tokens=0, error=repr(e))
            if propagate:
                raise
            self.done[req] = True
            self.finish[req] = "error"
            if sampling.logprobs:
                self.results_logprobs[req] = []
            self.errors[req] = repr(e)
            return req
        if self.prefix_cache_enabled:
            self._register_prefix(pages, hashes, L)
        self.pos[row] = L
        self.current[row, 0] = first
        self.budget[row] = max_new_tokens
        self.row_adapter[row] = adapter_internal
        self.row_request[row] = req
        self.row_sampling[row] = sampling
        self.row_rng[row] = rng
        self.results[req] = [first]
        self.n_tokens_generated += 1
        if self._monitor is not None:
            # the first token exists: the prefill span closes, TTFT is fixed
            # and the decode span opens, before the metric below (whose
            # exemplar context needs the live record)
            self._monitor.on_first_token(req)
        if self._metrics is not None:
            if self._t_submit is not None:
                # under the request's trace, so the exemplar of
                # bci_serving_ttft_seconds names the trace id of its wide
                # event
                ctx = (
                    self._monitor.exemplar_context(req)
                    if self._monitor is not None
                    else nullcontext()
                )
                with ctx:
                    self._ttft_seconds.observe(
                        time.monotonic() - self._t_submit
                    )
                self._t_submit = None
            self._sync_token_counter()
        if sampling.logprobs:
            self.results_logprobs[req] = [logprob_of(last_row, first)]
        self.done[req] = False
        self.active[row] = True
        self._retire_if_done(row)
        return req

    def _drop_row_pages(self, row, pages) -> None:
        self.block_table[row, :] = _SCRATCH_PAGE
        for page in reversed(pages):
            self._release_page(page)

    def _register_prefix(self, pages, hashes, L) -> None:
        """Index every page wholly inside [0, L): nothing writes them for
        the rest of the request. A matched page registers again as a no-op;
        when two in-flight admissions computed the same page, the later
        one wins and the displaced page loses its cache identity (and is
        freed if it was parked)."""
        for j in range(L // self.page_size):
            page = int(pages[j])
            prev = self.prefix_index.get(hashes[j])
            if prev == page:
                continue
            if prev is not None:
                self.page_hash.pop(prev, None)
                if prev in self.evictable:
                    del self.evictable[prev]
                    self.free_pages.append(prev)
            self.prefix_index[hashes[j]] = page
            self.page_hash[page] = hashes[j]

    def _advance_prefills(self) -> None:
        """One window of every interleaved admission, at the top of
        ``step``: windows over the record's own table (the global table
        keeps the row on the scratch page until activation)."""
        for row in sorted(self.prefill_state):
            rec = self.prefill_state[row]
            done_tokens = rec["pos"] - rec["start"]
            win = rec["suffix"][done_tokens:done_tokens + rec["width"]]
            t_win = time.monotonic()
            # under the request's trace (monitor attached): the first call
            # at a new window width is this request's
            win_ctx = (
                self._monitor.exemplar_context(rec["req"])
                if self._monitor is not None
                else nullcontext()
            )
            with win_ctx:
                last = self._admit_window(
                    win, rec["pos"], rec["bt_row"], rec["L"],
                    rec["adapter_internal"], rec["speculative"],
                )
            if last is not None:
                rec["last_row"] = last
            rec["pos"] += int(win.shape[0])
            self._prefill_tokens += int(win.shape[0])
            if self._monitor is not None:
                self._monitor.on_prefill_window(
                    rec["req"],
                    tokens=int(win.shape[0]),
                    duration_s=time.monotonic() - t_win,
                )
            if done_tokens + rec["width"] >= len(rec["suffix"]):
                del self.prefill_state[row]
                n_need = len(rec["pages"])
                self.block_table[row, :] = _SCRATCH_PAGE
                self.block_table[row, :n_need] = rec["pages"]
                self._t_submit = rec.get("t_submit")
                self._activate_row(
                    row, rec["last_row"], rec["pages"], rec["hashes"],
                    rec["L"], rec["sampling"], rec["max_new_tokens"],
                    rec["req"], rec["adapter_internal"],
                )

    def _admit_window(self, win, pos, bt_row, L, adapter_internal=0,
                      speculative=False) -> np.ndarray | None:
        """One admission window: ``decode_window_paged`` over one row's
        table, under the row's adapter; in speculative mode the draft pool
        replays it, so both pools stay in step. Returns the last prompt
        token's logits row when it lies in this window."""
        dev = self.device
        win_t = torch.as_tensor(win[None, :], device=dev)
        pos_t = torch.as_tensor([pos], dtype=torch.int32, device=dev)
        bt_t = torch.as_tensor(bt_row, device=dev)
        logits, self.cache = self._window(
            self.params, win_t, pos_t, self.cache, bt_t,
            **self._lora_kwargs(np.array([adapter_internal])),
        )
        if speculative:
            _, self.draft_cache = self._draft_window(
                self.draft_params, win_t, pos_t, self.draft_cache, bt_t,
            )
        idx = L - 1 - pos  # the last real token's index in this window
        if 0 <= idx < win.shape[0]:
            return logits[0, idx].cpu().numpy()
        return None

    # ------------------------------------------------- admission sub-paths
    def _full_admit(self, prompt, pages, L, speculative,
                    prefill_chunk) -> np.ndarray:
        """Whole-prompt base admission (no prefix hit, no adapter) into the
        row's pages; returns the last prompt token's logits row. One-shot:
        one ``forward`` over the prompt padded to whole pages (pad tokens
        are causally invisible to rows < L, so logits[L-1] and K/V[:L] are
        exact), then ``seed_prefill``; under sp the forward runs each rank's
        block of the padded prompt and ``gather_prefill`` gives the whole
        K/V and the last token's row. Chunked: ``prefill_chunked`` builds
        the contiguous cache in the pool's layout over the prompt pages and
        ``seed_from_contiguous`` copies it verbatim (int8 rows are not
        quantized twice).

        In speculative mode the row's draft pages are zeroed first (a
        recycled page holds an earlier request's K/V, and a fully accepted
        round lets the draft read one slot it never wrote: zeros make that
        read independent of the pool's history; the target only reads slots
        it wrote), then the draft prefills the padded prompt one-shot into
        its pool at the same pages."""
        n_prompt_pages = -(-L // self.page_size)
        pages_t = torch.as_tensor(pages[:n_prompt_pages], device=self.device)
        padded = np.zeros(n_prompt_pages * self.page_size, dtype=np.int64)
        padded[:L] = prompt
        tokens = torch.as_tensor(padded[None, :], device=self.device)
        if speculative:
            self._zero_draft_pages(pages)
        if prefill_chunk is not None:
            last_logits, contig = self._prefill_chunked(
                self.params, torch.as_tensor(prompt[None, :], device=self.device),
                total_len=n_prompt_pages * self.page_size, chunk=prefill_chunk,
            )
            seed_from_contiguous(self.cache, pages_t,
                                 {name: x[:, 0] for name, x in contig.items()})
            last_row = last_logits[0].cpu().numpy()
        else:
            last, (k_pre, v_pre) = transformer.gather_prefill(
                *self._prefill(self.params, tokens), L - 1, self._sp_group)
            seed_prefill(self.cache, pages_t,
                         k_pre[:, 0, :, :L, :], v_pre[:, 0, :, :L, :])
            last_row = last[0].cpu().numpy()
        if speculative:
            _, (dk, dv) = transformer.gather_prefill(
                *self._draft_prefill(self.draft_params, tokens), L - 1,
                self._sp_group)
            seed_prefill(self.draft_cache, pages_t,
                         dk[:, 0, :, :L, :], dv[:, 0, :, :L, :])
        return last_row

    def _suffix_admit(self, row, prompt, matched, speculative, prefill_chunk,
                      adapter_internal=0) -> np.ndarray:
        """Window admission, for prefix hits (only the suffix after the
        ``matched`` shared pages runs) and for every adapter admission
        (``matched`` == 0: the whole prompt is the suffix): the suffix,
        padded to whole pages, through consecutive page-aligned
        ``decode_window_paged`` windows over the row's table, attending to
        any shared prefix through it. ``prefill_chunk`` bounds the window
        width. Pad tokens of the last window write K/V past L into the
        row's own pages, behind the cursor: invisible until the decode
        overwrites them. Returns the last prompt token's logits row."""
        ps = self.page_size
        start = matched * ps
        width = ps * (max(1, prefill_chunk // ps) if prefill_chunk is not None
                      else self.block_table.shape[1])
        suffix = self._padded_suffix(prompt, start)
        bt_row = self.block_table[row:row + 1]
        last_row = None
        for off in range(0, len(suffix), width):
            last = self._admit_window(
                suffix[off:off + width], start + off, bt_row,
                int(prompt.shape[0]), adapter_internal, speculative,
            )
            if last is not None:
                last_row = last
        return last_row

    def _zero_draft_pages(self, pages) -> None:
        """Zero the draft pool's ``pages`` in place, every layer and leaf."""
        if not pages:
            return
        idx = torch.as_tensor(list(pages), dtype=torch.long, device=self.device)
        for x in self.draft_cache.values():
            x.index_fill_(1, idx, 0)

    # ------------------------------------------------------------ multi-LoRA
    def _lora_kwargs(self, adapter_rows: np.ndarray) -> dict:
        """The bank arguments of the paged decode and window calls when
        adapters are configured; none (the untouched base path) otherwise."""
        if self.lora_bank is None:
            return {}
        return {
            "lora_bank": self.lora_bank,
            "adapter_idx": torch.as_tensor(adapter_rows, dtype=torch.int32,
                                           device=self.device),
            "lora_scale": self.lora_scale,
        }

    # -------------------------------------------------- prefix-cache pages
    def _prefix_match(
        self, prompt: np.ndarray, adapter_internal: int
    ) -> tuple[list[bytes], list[int]]:
        """(chain hashes, prefix pages matched right now), the match capped
        at (L-1)//ps pages so at least one suffix token remains."""
        hashes = self._chain_hashes(prompt, adapter_internal)
        shared: list[int] = []
        limit = min(len(hashes), (int(prompt.shape[0]) - 1) // self.page_size)
        for i in range(limit):
            page = self.prefix_index.get(hashes[i])
            if page is None:
                break
            shared.append(page)
        return hashes, shared

    def prefix_credit(self, prompt, adapter: int | None = None) -> int:
        """Full prompt pages a submission would reuse from the prefix index
        right now (0 with the cache off): the engine subtracts them from a
        request's page need."""
        if not self.prefix_cache_enabled:
            return 0
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        adapter_internal = 0 if adapter is None else adapter + 1
        return len(self._prefix_match(prompt, adapter_internal)[1])

    def _chain_hashes(self, prompt: np.ndarray,
                      adapter_internal: int = 0) -> list[bytes]:
        """The chain hash after each full page: ``hashes[i]`` commits to
        tokens [0, (i+1)*page_size), salted with the internal adapter index
        (0 the base model): K/V under different adapters are different
        values and never share pages. The keys are the JAX batcher's."""
        h = hashlib.blake2b(digest_size=16)
        h.update(int(adapter_internal).to_bytes(8, "little"))
        out: list[bytes] = []
        ps = self.page_size
        for i in range(len(prompt) // ps):
            h.update(prompt[i * ps:(i + 1) * ps].astype(np.int32).tobytes())
            out.append(h.digest())
        return out

    def _alloc_page(self) -> int:
        """One fresh page: the free list first, then the LRU's oldest
        parked prefix page (its index entry dies with it). Callers check
        capacity first."""
        if self.free_pages:
            page = self.free_pages.pop()
        else:
            page, _ = self.evictable.popitem(last=False)
            h = self.page_hash.pop(page, None)
            if h is not None and self.prefix_index.get(h) == page:
                del self.prefix_index[h]
            self.prefix_stats["evictions"] += 1
        self.page_ref[page] = 1
        self._pages_allocated += 1
        return page

    def _release_page(self, page: int) -> None:
        """Drop one reference; at 0 an indexed prefix page parks in the LRU
        (its K/V kept for later hits), any other page is freed."""
        self.page_ref[page] -= 1
        if self.page_ref[page] > 0:
            return
        self._pages_released += 1
        h = self.page_hash.get(page)
        if h is not None and self.prefix_index.get(h) == page:
            self.evictable[page] = None  # the MRU end
        else:
            self.page_hash.pop(page, None)
            self.free_pages.append(page)

    # ----------------------------------------------------------------- step
    def step(self) -> None:
        """Advance every active row by one token (or, speculative, by its
        own accepted length plus one); interleaved admissions first run one
        window each, so their prefill and the batch's decode share the step
        cadence.

        With a metrics registry, each step also observes its wall time, the
        per-row inter-token latency (the step's time scaled by the tokens
        each row committed) and the throughput window; with a lifecycle
        monitor, it lands one step record (JAX serving.py:1641-1661); with a
        device monitor, its time under the mesh shape key. The time runs
        around the whole step, whose decode ends in the host read of its
        tokens, so on the card it includes the step's device work."""
        if (
            self._metrics is None
            and self._monitor is None
            and self._device_monitor is None
        ):
            self._step_inner()
            return
        rows_before = int(np.count_nonzero(self.active))
        prefilling_before = len(self.prefill_state)
        tokens_before = self.n_tokens_generated
        prefill_before = self._prefill_tokens
        spec_acc_before = self._spec_accepted
        spec_rej_before = self._spec_rejected
        alloc_before = self._pages_allocated
        released_before = self._pages_released
        t0 = time.monotonic()
        self._step_inner()
        t1 = time.monotonic()
        produced = self.n_tokens_generated - tokens_before
        if self._metrics is not None:
            self._step_seconds.observe(t1 - t0)
            if produced:
                if rows_before:
                    self._inter_token_seconds.observe(
                        (t1 - t0) * rows_before / produced
                    )
                self._rate_samples.append((t1, self.n_tokens_generated))
            self._sync_token_counter()
        if self._device_monitor is not None:
            self._device_monitor.record_step(
                (t1 - t0) * 1000.0, shape=self._mesh_key
            )
        if self._monitor is not None:
            # occupancy is not a field: active_rows / max_batch is the
            # reader's to derive
            self._monitor.on_step(
                {
                    "duration_ms": (t1 - t0) * 1000.0,
                    "mesh": self._mesh_key,
                    "active_rows": rows_before,
                    "active_rows_after": int(np.count_nonzero(self.active)),
                    "prefilling_rows": prefilling_before,
                    "max_batch": int(self.active.shape[0]),
                    "decode_tokens": produced,
                    "prefill_tokens": self._prefill_tokens - prefill_before,
                    "spec_accepted": self._spec_accepted - spec_acc_before,
                    "spec_rejected": self._spec_rejected - spec_rej_before,
                    "pages_allocated": self._pages_allocated - alloc_before,
                    "pages_released": self._pages_released - released_before,
                    "free_pages": len(self.free_pages),
                    "parked_pages": len(self.evictable),
                    # allocated - released is the held count (a release is
                    # counted when a page's refcount reaches 0)
                    "held_pages": self._pages_allocated - self._pages_released,
                }
            )

    def _step_inner(self) -> None:
        if self.prefill_state:
            self._advance_prefills()
        if not self.active.any():
            return
        if self.draft_params is not None:
            self._step_speculative()
            return
        dev = self.device
        logits, self.cache = self._decode(
            self.params,
            torch.as_tensor(self.current, device=dev),
            torch.as_tensor(self.pos, device=dev),
            self.cache,
            torch.as_tensor(self.block_table, device=dev),
            **self._lora_kwargs(self.row_adapter),
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

    def _draft_step(self, tok, p, bt):
        """One draft decode step over the draft pool: f32 logits [B, V]."""
        lg, self.draft_cache = self._draft_decode(
            self.draft_params, tok, p, self.draft_cache, bt
        )
        return lg[:, -1, :]

    def _step_speculative(self) -> None:
        """One draft-propose / target-verify / per-row-commit round: the
        draft runs ``gamma`` paged decode steps over the whole batch, the
        target scores every row's (current + drafts) window in one
        ``decode_window_paged``, and each row commits its own accepted
        prefix plus the target's token, with no lockstep across rows.
        Rejected positions stay in both pools behind each row's cursor,
        invisible until overwritten. Once any active row samples, the whole
        round goes through ``_step_speculative_sampled``.

        As in the JAX batcher, a fully accepted round never appends the
        last draft token to the draft pool, so later draft steps read the
        zeros of that slot: draft quality, not correctness."""
        active_rows = np.flatnonzero(self.active)
        if any(
            self.row_sampling[row].temperature > 0.0 for row in active_rows
        ):
            self._step_speculative_sampled(active_rows)
            return
        dev = self.device
        bt = torch.as_tensor(self.block_table, device=dev)
        pos_dev = torch.as_tensor(self.pos, device=dev)
        cur = torch.as_tensor(self.current, device=dev)
        drafts = []
        tok, p = cur, pos_dev
        for _ in range(self.gamma):
            lg = self._draft_step(tok, p, bt)
            tok = torch.argmax(lg, dim=-1, keepdim=True).to(torch.int32)
            drafts.append(tok)
            p = p + 1
        drafts_dev = torch.cat(drafts, dim=1)  # [B, gamma]
        window = torch.cat([cur, drafts_dev], dim=1)  # [B, gamma + 1]
        t_logits, self.cache = self._verify(
            self.params, window, pos_dev, self.cache, bt,
            **self._lora_kwargs(self.row_adapter),
        )
        t_pred = torch.argmax(t_logits, dim=-1).to(torch.int32).cpu().numpy()
        drafts_np = drafts_dev.cpu().numpy()
        # the verify logits cross to the host only when a row records
        # logprobs (commit[j]'s distribution is t_logits[row, j])
        t_np = (
            t_logits.cpu().numpy()
            if any(self.row_sampling[row].logprobs for row in active_rows)
            else None
        )
        for row in active_rows:
            match = drafts_np[row] == t_pred[row, :self.gamma]
            n = int(np.argmin(match)) if not match.all() else self.gamma
            commit = [*drafts_np[row, :n].tolist(), int(t_pred[row, n])]
            self._commit_row(row, commit, n, t_np)

    def _commit_row(self, row, commit, n, t_np) -> None:
        """Land one speculative round's tokens for a row: per-token stop
        checks, logprobs off the verify logits, the cursor advanced by the
        accepted count plus one, retirement. Shared by the greedy and the
        sampled round."""
        sp = self.row_sampling[row]
        req = int(self.row_request[row])
        self._spec_accepted += n
        self._spec_rejected += self.gamma - n
        if self._monitor is not None:
            self._monitor.on_commit(req, accepted=n, rejected=self.gamma - n)
        out = self.results[req]
        lp = self.results_logprobs.get(req) if sp.logprobs else None
        for j, tok_committed in enumerate(commit):
            out.append(int(tok_committed))
            self.n_tokens_generated += 1
            if lp is not None:
                lp.append(logprob_of(t_np[row, j], int(tok_committed)))
            if self._done_reason(row, out) is not None:
                break  # later commits would pass the stop: dropped
        self.pos[row] += n + 1
        self.current[row, 0] = int(commit[-1])
        self._retire_if_done(row)

    def _step_speculative_sampled(self, active_rows) -> None:
        """A speculative round with sampled rows: rejection sampling
        (``rejection_sample_commit``) on each sampled row's filtered target
        and draft distributions, each proposal drawn host-side from the
        row's own generator; greedy rows keep the argmax draft-verify. The
        committed stream is distributed as plain sampled decoding from the
        target, and the same seeds give the same tokens."""
        dev = self.device
        bt = torch.as_tensor(self.block_table, device=dev)
        pos_dev = torch.as_tensor(self.pos, device=dev)
        cur = torch.as_tensor(self.current, device=dev)
        B = self.current.shape[0]
        gamma = self.gamma
        drafts_np = np.zeros((B, gamma), dtype=np.int32)
        q_dists: dict[int, list] = {int(r): [] for r in active_rows}
        tok, p = cur, pos_dev
        for g in range(gamma):
            lg_np = self._draft_step(tok, p, bt).cpu().numpy()
            # greedy and idle rows propose the host argmax
            drafts_np[:, g] = lg_np.argmax(-1).astype(np.int32)
            for row in active_rows:
                sp = self.row_sampling[row]
                if sp.temperature > 0.0:
                    q = filtered_probs_host(lg_np[row], sp)
                    drafts_np[row, g] = int(
                        self.row_rng[row].choice(q.shape[0], p=q)
                    )
                    q_dists[int(row)].append(q)
                else:
                    q_dists[int(row)].append(None)
            tok = torch.as_tensor(drafts_np[:, g:g + 1], device=dev)
            p = p + 1
        window = torch.cat([cur, torch.as_tensor(drafts_np, device=dev)], dim=1)
        t_logits, self.cache = self._verify(
            self.params, window, pos_dev, self.cache, bt,
            **self._lora_kwargs(self.row_adapter),
        )
        t_np = t_logits.cpu().numpy()  # [B, gamma + 1, V]
        for row in active_rows:
            sp = self.row_sampling[row]
            if sp.temperature <= 0.0:
                preds = t_np[row].argmax(-1).astype(np.int32)
                match = drafts_np[row] == preds[:gamma]
                n = int(np.argmin(match)) if not match.all() else gamma
                commit = [*drafts_np[row, :n].tolist(), int(preds[n])]
            else:
                commit, n = rejection_sample_commit(
                    drafts_np[row].tolist(),
                    q_dists[int(row)],
                    lambda g, row=row, sp=sp: filtered_probs_host(
                        t_np[row, g], sp
                    ),
                    self.row_rng[row],
                )
            self._commit_row(row, commit, n, t_np)

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
        self.row_adapter[row] = 0
        used = set(self.block_table[row].tolist()) - {_SCRATCH_PAGE}
        for page in sorted(used, reverse=True):
            self._release_page(page)
        self.block_table[row, :] = _SCRATCH_PAGE
        # pos stays for inspection; scratch-page writes are masked
        if self._monitor is not None:
            self._monitor.on_done(
                req, reason, tokens=len(out), error=self.errors.get(req)
            )

    # -------------------------------------------------------------- results
    @property
    def stats(self) -> dict:
        """Operator counters (JAX serving.py:1969): occupancy, page
        accounting, lifetime totals and the prefix cache's counters; host
        bookkeeping only, cheap on every scrape (``ServingMonitor.snapshot``
        reads it)."""
        return {
            "active_rows": int(self.active.sum()),
            "prefilling_rows": len(self.prefill_state),
            "max_batch": int(self.active.shape[0]),
            "free_pages": len(self.free_pages),
            "parked_pages": len(self.evictable),
            "held_pages": int((self.page_ref > 0).sum()),
            "requests_submitted": self._next_request_id,
            "requests_finished": sum(1 for v in self.done.values() if v),
            "tokens_generated": self.n_tokens_generated,
            "prefix_cache": dict(self.prefix_stats),
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
        """Abort a decoding or still-admitting request: row and pages free
        at once, tokens so far stay readable. Cancelling a finished request
        is a no-op; an id never issued raises KeyError."""
        for row in np.flatnonzero(self.active):
            if int(self.row_request[row]) == request_id:
                self._retire(int(row), "cancelled")
                return
        rec = self._drop_prefill(request_id)
        if rec is not None:
            self.done[request_id] = True
            self.finish[request_id] = "cancelled"
            if rec["sampling"] is not None and rec["sampling"].logprobs:
                self.results_logprobs[request_id] = []
            if self._monitor is not None:
                self._monitor.on_done(request_id, "cancelled", tokens=0)
            return
        if request_id not in self.done:
            raise KeyError(f"unknown request {request_id}")

    def preempt(self, request_id: int) -> bool:
        """Evict a request whose interleaved admission is still prefilling:
        its pages free at once and the request is erased as if never
        submitted (the caller submits the prompt again and the prefill is
        recomputed, exactly, as nothing was emitted). False once the
        request decodes, finished, or is unknown: ``cancel`` stops those."""
        if self._drop_prefill(request_id) is None:
            return False
        self.results.pop(request_id, None)
        self.done.pop(request_id, None)
        if self._monitor is not None:
            self._monitor.on_preempt(request_id)
        return True

    def _drop_prefill(self, request_id: int) -> dict | None:
        """End a request's interleaved admission and release its pages
        (shared ones drop their ref); its record, or None if it has none."""
        for row, rec in list(self.prefill_state.items()):
            if rec["req"] == request_id:
                del self.prefill_state[row]
                for page in reversed(rec["pages"]):
                    self._release_page(page)
                return rec
        return None

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
