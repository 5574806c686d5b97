"""The port's prefix cache against the JAX batcher's (tiny config, 2 KV
heads, f32; bf16-layout and int8 pools): the same request sequence through
both batchers, and both engines, must give identical token streams and
identical host bookkeeping, exactly: the prefix index (blake2b chain hashes
over int32 page bytes), page identities, refcounts, the free list, the
LRU's order, the prefix counters and ``kv_telemetry()``. Checklist: the
JAX package's tests/test_prefix_cache.py.

Greedy and seeded streams agree token for token because the logits agree
to ~1e-5 and these prompts have no near-tie at any generated position
(``tests/test_torch_serving.py`` checks the margin on its prompts)."""

import numpy as np
import pytest

from bee_code_interpreter_tpu.models import engine as jax_engine
from bee_code_interpreter_tpu.models import serving as jax_serving
from bee_code_interpreter_tpu_torch.models import engine as torch_engine
from bee_code_interpreter_tpu_torch.models import serving as torch_serving

from tests.torch_parity import batcher_pair, host_state, tiny_configs, tiny_params

PS = 4
GEOMETRY = dict(max_batch=3, n_pages=40, page_size=PS, max_pages_per_seq=8)
PROMPT = [5, 3, 7, 2, 9, 4, 1, 8, 6, 2]  # 2 full pages + 2
OTHER = PROMPT[:8] + [9, 9, 3, 1]  # the same 2 pages, another tail


@pytest.fixture(scope="module", params=["bf16", "int8"])
def models(request):
    jcfg, tcfg = tiny_configs(kv_cache_dtype=request.param)
    return (jcfg, tcfg, *tiny_params(jcfg, tcfg))


def run_both(models, script, **kw):
    """``script(batcher, serving_module)`` on both batchers; returns
    (JAX, port) of (its return value, host state)."""
    out = []
    for b, mod in zip(batcher_pair(models, **{**GEOMETRY, **kw}),
                      (jax_serving, torch_serving)):
        out.append((script(b, mod), host_state(b)))
    return out


def run_one(b, prompt, n=5, **kw):
    r = b.submit(prompt, n, **kw)
    b.run_to_completion()
    return b.result(r)


def test_repeat_and_diverging_prompts_match_jax(models):
    def script(b, mod):
        outs = [run_one(b, PROMPT), run_one(b, PROMPT), run_one(b, OTHER)]
        b.release(0)
        return outs

    (want, jstate), (got, tstate) = run_both(models, script, prefix_cache=True)
    assert got == want and tstate == jstate
    assert got[0] == got[1]
    assert tstate["prefix_stats"] == {
        "lookups": 3, "hits": 2, "pages_reused": 4, "evictions": 0}
    # the cache changes no output
    (plain, _), _ = run_both(models, script)
    assert got == plain


def test_shared_pages_survive_sibling_retirement_match_jax(models):
    def script(b, mod):
        run_one(b, PROMPT, 2)  # fill the index
        r_long = b.submit(PROMPT, 12)  # hit: shares the 2 prefix pages
        r_short = b.submit(PROMPT, 2)  # hit: shares them too
        mid = host_state(b)
        b.run_to_completion()  # the short one retires many steps early
        return b.result(r_long), b.result(r_short), mid

    (want, jstate), (got, tstate) = run_both(models, script, prefix_cache=True)
    assert got == want and tstate == jstate
    assert got[2]["kv_telemetry"]["pages_shared"] == 2
    assert sum(tstate["page_ref"]) == 0 and len(tstate["evictable"]) > 0


def test_eviction_under_pool_pressure_matches_jax(models):
    """A pool small enough that parked pages must be evicted: the same
    victims, in the same LRU order, and the index loses exactly them."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, 9).tolist() for _ in range(6)]

    def script(b, mod):
        outs = [run_one(b, p, 3) for p in prompts]
        outs.append(run_one(b, PROMPT, 3))
        return outs

    (want, jstate), (got, tstate) = run_both(
        models, script, prefix_cache=True, n_pages=12, max_pages_per_seq=4)
    assert got == want and tstate == jstate
    assert tstate["prefix_stats"]["evictions"] > 0
    assert len(tstate["prefix_index"]) == len(tstate["page_hash"])
    assert set(tstate["prefix_index"].values()).isdisjoint(tstate["free_pages"])


def test_exhaustion_with_parked_pages_raises_cleanly_like_jax(models):
    """A capacity failure after the prefix refs were taken drops them
    again: both batchers raise CapacityError and keep identical state."""
    def script(b, mod):
        run_one(b, PROMPT, 2)
        hog = b.submit(list(range(100, 128)), 4)  # 8 pages, held
        b.step()
        with pytest.raises(mod.CapacityError):
            b.submit(PROMPT, 20)  # a hit, but 6 fresh pages do not fit
        state = host_state(b)
        b.cancel(hog)
        return state, run_one(b, PROMPT, 2)

    (want, jstate), (got, tstate) = run_both(
        models, script, prefix_cache=True, n_pages=12)
    assert got == want and tstate == jstate


@pytest.mark.parametrize("chunk", [4, 8])
def test_chunked_suffix_admission_matches_jax(models, chunk):
    """A hit with ``prefill_chunk``: the suffix windows are chunk-wide."""
    long = PROMPT + [3, 1, 4, 1, 5, 9, 2, 6, 5]

    def script(b, mod):
        first = run_one(b, long, 4)
        return first, run_one(b, long + [7], 4, prefill_chunk=chunk)

    (want, jstate), (got, tstate) = run_both(models, script, prefix_cache=True)
    assert got == want and tstate == jstate
    assert tstate["prefix_stats"]["pages_reused"] == 4


def test_page_aligned_and_short_prompts_match_jax(models):
    """A prompt of whole pages keeps one suffix token (the match stops a
    page short); a prompt shorter than a page never shares."""
    aligned = PROMPT[:8]

    def script(b, mod):
        return [run_one(b, aligned, 3), run_one(b, aligned, 3),
                run_one(b, [4, 2], 3), run_one(b, [4, 2], 3)]

    (want, jstate), (got, tstate) = run_both(models, script, prefix_cache=True)
    assert got == want and tstate == jstate
    assert tstate["prefix_stats"]["pages_reused"] == 1


def test_sampled_requests_hit_deterministically_like_jax(models):
    """Host-side seeded sampling with logprobs over a hit: the same draws
    as JAX's (numpy generators on both sides)."""
    def script(b, mod):
        sp = mod.SamplingParams(temperature=0.8, top_k=20, seed=3,
                                logprobs=True)
        out = []
        for _ in range(2):
            r = b.submit(PROMPT, 6, sampling=sp)
            b.run_to_completion()
            out.append((b.result(r), b.result_logprobs(r)))
        return out

    (want, jstate), (got, tstate) = run_both(models, script, prefix_cache=True)
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose([lp for _, lp in got], [lp for _, lp in want],
                               atol=1e-4)
    assert got[0][0] == got[1][0] and tstate == jstate


def test_page_accounting_conserves_the_pool(models):
    _, b = batcher_pair(models, prefix_cache=True, **GEOMETRY)
    for prompt in (PROMPT, PROMPT, OTHER, PROMPT[:5]):
        r = b.submit(prompt, 4)
        t = b.kv_telemetry()
        assert (t["pages_free"] + t["pages_parked"] + t["pages_held"]
                == t["pages_total"])
        assert t["pages_held"] == (t["pages_allocated_total"]
                                   - t["pages_released_total"])
        b.run_to_completion()
        b.release(r)
    t = b.kv_telemetry()
    assert t["pages_held"] == 0
    assert t["pages_free"] + t["pages_parked"] == GEOMETRY["n_pages"] - 1
    assert t["prefix"]["indexed_pages"] == t["pages_parked"]


def test_engine_prefix_credit_backpressure_matches_jax(models):
    """The engine counts the pages a hit would share as available: while a
    request holds a prompt's pages, a second one with the same prefix needs
    7 pages with 3 free, and admits at once through its credit of 6, in
    both engines, with the same streams and state."""
    long = PROMPT + list(range(30, 44))  # 24 tokens: 6 full pages

    def script(b, mod):
        eng = (jax_engine if mod is jax_serving else torch_engine).Engine(b)
        t0 = eng.submit(long, 8)  # 8 pages, its 6 prompt pages indexed
        eng.step()
        hog = eng.submit(list(range(100, 124)), 8)  # 8 pages: 3 stay free
        eng.step()
        credit = b.prefix_credit(long + [1])
        t1 = eng.submit(long + [1], 3)  # 7 pages, 6 of them shared
        eng.step()
        admitted = eng._state[t1] != "queued"
        eng.run_to_completion()
        return ([eng.result(t) for t in (t0, hog, t1)], credit, admitted,
                eng.stats)

    (want, jstate), (got, tstate) = run_both(
        models, script, prefix_cache=True, n_pages=20, max_pages_per_seq=8)
    assert got == want and tstate == jstate
    assert got[1] == 6 and got[2] is True
