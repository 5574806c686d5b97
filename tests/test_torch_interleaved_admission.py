"""Interleaved and chunked admission, cancel and preemption in the port's
batcher and engine against the JAX package's (tiny config, 2 KV heads,
f32): the same requests give the same token streams and the same host
bookkeeping (block tables, cursors, refcounts, the free list), exactly.
Checklists: the JAX package's tests/test_interleaved_admission.py and
tests/test_engine.py.

Two places where the port departs from the JAX batcher on purpose (ROADMAP
Queue 3): a failure inside the interleaved branch of ``submit`` returns the
pages and the row (JAX leaks them), and ``prefill_chunk`` together with
``interleave_admission`` is refused (JAX drops the chunk silently)."""

import numpy as np
import pytest

from bee_code_interpreter_tpu.models import engine as jax_engine
from bee_code_interpreter_tpu.models import serving as jax_serving
from bee_code_interpreter_tpu_torch.models import engine as torch_engine
from bee_code_interpreter_tpu_torch.models import serving as torch_serving

from tests.torch_parity import batcher_pair, host_state, tiny_configs, tiny_params

GEOMETRY = dict(max_batch=2, n_pages=32, page_size=4, max_pages_per_seq=8)
LONG = [int(x) for x in np.random.default_rng(7).integers(0, 200, 21)]
SHORT = [5, 3, 7, 2]


@pytest.fixture(scope="module", params=["bf16", "int8"])
def models(request):
    jcfg, tcfg = tiny_configs(kv_cache_dtype=request.param)
    return (jcfg, tcfg, *tiny_params(jcfg, tcfg))


@pytest.fixture(scope="module")
def models_bf16():
    jcfg, tcfg = tiny_configs()
    return (jcfg, tcfg, *tiny_params(jcfg, tcfg))


def run_both(models, script, **kw):
    """``script(batcher, serving_module, engine_module)`` on both batchers;
    returns (JAX, port) of (its return value, host state)."""
    out = []
    for b, mods in zip(batcher_pair(models, **{**GEOMETRY, **kw}),
                       ((jax_serving, jax_engine),
                        (torch_serving, torch_engine))):
        out.append((script(b, *mods), host_state(b)))
    return out


def solo(models, prompt, n, **kw):
    """The port's blocking admission of one request, alone."""
    _, b = batcher_pair(models, **GEOMETRY)
    r = b.submit(prompt, n, **kw)
    b.run_to_completion()
    return b.result(r)


def test_interleaved_matches_blocking_and_jax(models):
    def script(b, mod, _):
        r = b.submit(LONG, 5, interleave_admission=8)
        submitted = (list(b.results[r]), b.stats["prefilling_rows"],
                     host_state(b))
        b.run_to_completion()
        return submitted, b.result(r), b.finish_reason(r)

    (want, jstate), (got, tstate) = run_both(models, script)
    assert got == want and tstate == jstate
    assert got[0][:2] == ([], 1)  # no model ran at submit
    assert got[1] == solo(models, LONG, 5) and got[2] == "length"


def test_interleaved_sampled_with_logprobs_matches_jax(models_bf16):
    def script(b, mod, _):
        sp = mod.SamplingParams(temperature=0.7, top_k=30, seed=11,
                                logprobs=True)
        r = b.submit(LONG, 5, sampling=sp, interleave_admission=4)
        b.run_to_completion()
        return b.result(r), b.result_logprobs(r)

    (want, jstate), (got, tstate) = run_both(models_bf16, script)
    assert got[0] == want[0] and tstate == jstate
    np.testing.assert_allclose(got[1], want[1], atol=1e-4)


def test_other_rows_keep_decoding_during_admission(models_bf16):
    """Every step that runs a window also gives the decoding row exactly
    one token, in both batchers."""
    def script(b, mod, _):
        r_short = b.submit(SHORT, 8)
        r_long = b.submit(LONG, 4, interleave_admission=4)  # 6 windows
        produced = []
        while b.prefill_state:
            before = len(b.results[r_short])
            b.step()
            produced.append(len(b.results[r_short]) - before)
        b.run_to_completion()
        return produced, b.result(r_short), b.result(r_long)

    (want, jstate), (got, tstate) = run_both(models_bf16, script)
    assert got == want and tstate == jstate
    assert got[0] == [1] * 6
    assert got[1] == solo(models_bf16, SHORT, 8)
    assert got[2] == solo(models_bf16, LONG, 4)


def test_interleaved_registers_prefix_pages_like_jax(models):
    def script(b, mod, _):
        r1 = b.submit(LONG, 4, interleave_admission=4)
        b.run_to_completion()
        r2 = b.submit(LONG, 4)  # the repeat hits the windows' pages
        b.run_to_completion()
        r3 = b.submit(LONG, 4, interleave_admission=8)  # a hit, interleaved
        b.run_to_completion()
        return [b.result(r) for r in (r1, r2, r3)]

    (want, jstate), (got, tstate) = run_both(models, script, prefix_cache=True)
    assert got == want and tstate == jstate
    assert tstate["prefix_stats"]["hits"] == 2
    assert got[0] == got[1] == got[2]


def test_cancel_mid_prefill_matches_jax(models_bf16):
    def script(b, mod, _):
        r = b.submit(LONG, 4, interleave_admission=4)
        b.step()  # one window in
        b.cancel(r)
        after = host_state(b)
        b.run_to_completion()
        r2 = b.submit(LONG, 4)  # the freed row and pages admit again
        b.run_to_completion()
        return (b.finish_reason(r), b.result(r), after, b.result(r2))

    (want, jstate), (got, tstate) = run_both(models_bf16, script,
                                             prefix_cache=True)
    assert got == want and tstate == jstate
    assert got[:2] == ("cancelled", [])
    assert got[2]["stats"]["held_pages"] == 0 and not got[2]["prefilling"]


def test_preempt_mid_prefill_matches_jax(models_bf16):
    """Batcher: a preempted admission frees its pages and is forgotten.
    Engine: the ticket goes back to the head of its priority class, ahead
    of an older queued ticket of its class, and finishes as if never
    preempted."""
    def script(b, mod, eng_mod):
        free0 = len(b.free_pages)
        r = b.submit(LONG, 4, interleave_admission=4)
        b.step()
        gone = b.preempt(r)
        freed = len(b.free_pages) == free0 and not b.prefill_state
        unknown = (b.preempt(r), r in b.done, r in b.results)
        eng = eng_mod.Engine(b)
        t_short = eng.submit(SHORT, 6)
        eng.step()  # t_short decoding on one row
        t_long = eng.submit(LONG, 4, interleave_admission=8)
        eng.step()  # admitted, first window ran
        t_wait = eng.submit(SHORT, 3)  # queued behind: no free row
        pre = (eng.preempt(t_long), eng.preempt(t_long), eng.preempt(t_short))
        order = [ticket for _, _, ticket, _ in sorted(eng._heap)]
        eng.run_to_completion()
        return (gone, freed, unknown, pre, order,
                [eng.result(t) for t in (t_short, t_long, t_wait)])

    (want, jstate), (got, tstate) = run_both(models_bf16, script)
    assert got == want and tstate == jstate
    assert got[:4] == (True, True, (False, False, False), (True, False, False))
    assert got[4][0] == 1  # the preempted ticket is at the head
    assert got[5][1] == solo(models_bf16, LONG, 4)


def test_width_validated_and_row_occupancy(models_bf16):
    _, b = batcher_pair(models_bf16, **GEOMETRY)
    for width in (0, 3, 6):
        with pytest.raises(ValueError, match="multiple of page_size"):
            b.submit(LONG, 4, interleave_admission=width)
    with pytest.raises(ValueError, match="multiple of page_size"):
        torch_engine.Engine(b).submit(LONG, 4, interleave_admission=6)
    b.submit(LONG, 4, interleave_admission=4)
    b.submit(SHORT, 4)
    assert not b.has_free_row() and b.busy
    with pytest.raises(torch_serving.CapacityError):
        b.submit(SHORT, 4)
    b.run_to_completion()
    assert b.has_free_row() and not b.busy


def test_bad_seed_fails_at_activation_and_releases_pages_like_jax(models_bf16):
    """A seed numpy refuses fails at activation, after the last window: the
    request finishes with 'error' and every page comes back."""
    def script(b, mod, _):
        r = b.submit(LONG, 4, sampling=mod.SamplingParams(seed=-1),
                     interleave_admission=8)
        b.run_to_completion()
        return b.finish_reason(r), b.result(r), b.stats["held_pages"]

    (want, jstate), (got, tstate) = run_both(models_bf16, script)
    assert got == want and tstate == jstate
    assert got == ("error", [], 0)


CHUNK_PROMPTS = [LONG, SHORT, LONG[:13]]


@pytest.mark.parametrize("chunk", [4, 5, 64])
def test_chunked_admission_batcher_and_engine_match_jax(models, chunk):
    """``prefill_chunk`` (prefill_chunked + seed_from_contiguous, bf16 or
    int8 pools, remainder chunks included) through the batcher and the
    engine, against the JAX package's and against one-shot admission."""
    def script(b, mod, eng_mod):
        eng = eng_mod.Engine(b)
        tickets = [eng.submit(p, 5, prefill_chunk=chunk)
                   for p in CHUNK_PROMPTS]
        eng.run_to_completion()
        return [eng.result(t) for t in tickets]

    (want, jstate), (got, tstate) = run_both(models, script)
    assert got == want and tstate == jstate
    if models[1].kv_cache_dtype == "bf16":
        assert got == [solo(models, p, 5) for p in CHUNK_PROMPTS]
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        torch_engine.Engine(batcher_pair(models, **GEOMETRY)[1]).submit(
            LONG, 4, prefill_chunk=0)


def test_failed_interleaved_submit_returns_pages_and_row(models_bf16,
                                                         monkeypatch):
    """A fault inside the interleaved branch of ``submit`` (injected in the
    record it builds) returns every page, prefix refs included, and leaves
    the row free. The JAX batcher leaks both (ROADMAP Queue 3)."""
    _, b = batcher_pair(models_bf16, prefix_cache=True, **GEOMETRY)
    r = b.submit(LONG, 4)
    b.run_to_completion()
    b.release(r)
    before = host_state(b)

    def fault(*args, **kwargs):
        raise RuntimeError("injected")

    monkeypatch.setattr(b, "_prefill_record", fault)
    with pytest.raises(RuntimeError, match="injected"):
        b.submit(LONG, 4, interleave_admission=8)  # a hit: refs were taken
    after = host_state(b)
    for key in ("page_ref", "free_pages", "evictable", "block_table",
                "prefilling"):
        assert after[key] == before[key], key
    assert after["kv_telemetry"]["pages_held"] == 0
    assert b.has_free_row() and not b.busy
    monkeypatch.undo()
    r2 = b.submit(LONG, 4, interleave_admission=8)
    b.run_to_completion()
    assert b.result(r2) == solo(models_bf16, LONG, 4)


def test_prefill_chunk_with_interleave_is_refused(models_bf16):
    """The JAX batcher and engine accept both options and drop the chunk;
    the port refuses the pair, at the batcher and at the engine's intake,
    before it takes a row or a page (ROADMAP Queue 3)."""
    jb, tb = batcher_pair(models_bf16, **GEOMETRY)
    jax_engine.Engine(jb).submit(LONG, 4, prefill_chunk=4,
                                 interleave_admission=8)
    jb.submit(LONG, 4, prefill_chunk=4, interleave_admission=8)
    before = host_state(tb)
    for submit in (tb.submit, torch_engine.Engine(tb).submit):
        with pytest.raises(ValueError, match="exclude each other"):
            submit(LONG, 4, prefill_chunk=4, interleave_admission=8)
    assert host_state(tb) == before and tb._next_request_id == 0


def test_random_schedule_matches_jax_in_lockstep(models_bf16):
    """Seeded fuzz: random submits (prompts over shared prefixes, one-shot,
    chunked or interleaved, priorities, seeded sampling), steps, cancels and
    preempts, applied to both engines in lockstep over a pool small enough
    to evict; after every operation the host state must be equal."""
    rng = np.random.default_rng(20261016)
    prefixes = [rng.integers(0, 200, 8).tolist() for _ in range(2)]
    geometry = dict(max_batch=3, n_pages=14, page_size=4, max_pages_per_seq=6)
    jb, tb = batcher_pair(models_bf16, prefix_cache=True, **geometry)
    engines = (jax_engine.Engine(jb, max_queue=6),
               torch_engine.Engine(tb, max_queue=6))
    mods = (jax_serving, torch_serving)
    preempted = 0
    for op_i in range(100):
        op = rng.choice(["submit", "submit", "step", "step", "cancel",
                         "preempt"])
        if op == "submit":
            prompt = (prefixes[int(rng.integers(2))][:int(rng.integers(0, 9))]
                      + rng.integers(0, 200, int(rng.integers(1, 9))).tolist())
            kw = [{}, {"prefill_chunk": 4}, {"interleave_admission": 4},
                  {"interleave_admission": 8}][int(rng.integers(4))]
            seed = int(rng.integers(1e6)) if rng.random() < 0.3 else None
            n, prio = int(rng.integers(1, 6)), int(rng.integers(0, 2))
            outcome = []
            for eng, mod in zip(engines, mods):
                sp = (None if seed is None else
                      mod.SamplingParams(temperature=0.8, top_k=20, seed=seed))
                try:
                    outcome.append(eng.submit(prompt, n, sampling=sp,
                                              priority=prio, **kw))
                except RuntimeError:
                    outcome.append("full")
            assert outcome[0] == outcome[1], op_i
        elif op in ("cancel", "preempt") and engines[0]._state:
            # preempt what is still admitting when anything is
            pool = (sorted(engines[0]._preemptable) if op == "preempt" else [])
            ticket = int(rng.choice(pool or sorted(engines[0]._state)))
            got = [getattr(eng, op)(ticket) for eng in engines]
            assert got[0] == got[1], op_i
            preempted += op == "preempt" and got[0]
        else:
            for eng in engines:
                eng.step()
        assert host_state(tb) == host_state(jb), op_i
        assert engines[1]._state == engines[0]._state, op_i
    for eng in engines:
        eng.run_to_completion()
    results = [{t: (eng.finish_reason(t), eng.result(t)) for t in eng._state}
               for eng in engines]
    assert results[1] == results[0]
    assert host_state(tb) == host_state(jb)
    assert tb.stats["held_pages"] == 0
    # what the schedule exercised
    assert {r for r, _ in results[1].values()} >= {"length", "cancelled"}
    assert preempted >= 1
    assert tb.prefix_stats["hits"] >= 3 and tb.prefix_stats["evictions"] >= 1
