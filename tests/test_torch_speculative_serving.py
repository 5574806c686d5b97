"""The port's speculative serving with greedy rows against the JAX
batcher's, on the same weights (tiny f32 target with 2 KV heads; drafts of
1 layer, or 1 layer at d 32): streams, rounds and host bookkeeping equal,
each row equal to the target's greedy decode, draft pages zeroed at
admission, the same validation errors, and eos and stops ending a round.
Checklist: the JAX package's tests/test_serving.py:323-499 and
test_serving_stops.py:140 and :291."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from bee_code_interpreter_tpu.models import serving as jax_serving
from bee_code_interpreter_tpu_torch.models import serving as torch_serving
from bee_code_interpreter_tpu_torch.models import transformer as torch_t

from tests.torch_parity import host_state, tiny_configs, tiny_params

PROMPT = [5, 3, 7, 2, 9, 4, 1, 8]
GEOMETRY = dict(max_batch=2, n_pages=32, page_size=4, max_pages_per_seq=8)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = tiny_configs()
    return (jcfg, tcfg, *tiny_params(jcfg, tcfg))


def draft_models(seed=42, **shape):
    """A draft in both frameworks: 1 layer, optionally narrower."""
    jcfg, tcfg = tiny_configs(n_layers=1, **shape)
    return (jcfg, tcfg, *tiny_params(jcfg, tcfg, seed=seed))


@pytest.fixture(scope="module")
def narrow_draft():
    return draft_models(42, d_model=32, n_heads=2, d_ff=64)


# ---------------------------------------------- the batcher, greedy rows

def spec_pair(models, draft, **kw):
    jcfg, tcfg, jparams, tparams = models
    djcfg, dtcfg, djp, dtp = draft
    kw = {**GEOMETRY, **kw}
    return (
        jax_serving.ContinuousBatcher(jparams, jcfg, draft_params=djp,
                                      draft_config=djcfg, **kw),
        torch_serving.ContinuousBatcher(tparams, tcfg, draft_params=dtp,
                                        draft_config=dtcfg, device="cpu", **kw),
    )


def solo(models, prompt, n):
    _, tcfg, _, tparams = models
    out = torch_t.Transformer(tcfg).generate_cached(
        tparams, torch.tensor([list(prompt)]), max_new_tokens=n)
    return out[0, len(prompt):].tolist()


def test_speculative_serving_matches_jax_and_solo(models, narrow_draft):
    """Staggered requests, an unrelated draft, per-row accept lengths."""
    prompts = [np.random.default_rng(60 + i).integers(0, 256, L).tolist()
               for i, L in enumerate([3, 7, 5])]
    outs = []
    for b in spec_pair(models, narrow_draft, max_pages_per_seq=6, gamma=3):
        r0 = b.submit(prompts[0], 6)
        r1 = b.submit(prompts[1], 6)
        b.step()
        mid = host_state(b)
        with pytest.raises(RuntimeError, match="no free batch row"):
            b.submit(prompts[2], 6)
        b.run_to_completion()
        r2 = b.submit(prompts[2], 6)
        b.run_to_completion()
        outs.append(([b.result(r) for r in (r0, r1, r2)], mid, host_state(b),
                     b.pos.tolist()))
    assert outs[1] == outs[0]
    assert outs[1][0] == [solo(models, p, 6) for p in prompts]


def test_perfect_draft_takes_the_same_few_rounds(models):
    outs = []
    for b in spec_pair(models, models, max_batch=1, max_pages_per_seq=4,
                       n_pages=16, gamma=3):
        r = b.submit([8, 2, 5, 9], 8)
        rounds = 0
        while not b.is_done(r):
            b.step()
            rounds += 1
        outs.append((b.result(r), rounds))
    assert outs[1] == outs[0]
    # 7 tokens after the first in rounds of up to 4: 2 when every proposal
    # is kept; the draft pool's unwritten slot after a full accept (see
    # _step_speculative) costs this prompt 2 more, against 7 plain steps
    assert outs[1][0] == solo(models, [8, 2, 5, 9], 8) and outs[1][1] <= 4


def test_int8_target_pool_matches_jax(narrow_draft):
    jcfg, tcfg = tiny_configs(kv_cache_dtype="int8")
    models = (jcfg, tcfg, *tiny_params(jcfg, tcfg))
    outs = []
    for b in spec_pair(models, narrow_draft, max_batch=1, n_pages=16,
                       max_pages_per_seq=4, gamma=3):
        r = b.submit([7, 1, 6, 3, 9], 6)
        b.run_to_completion()
        outs.append(b.result(r))
    assert outs[1] == outs[0] == solo(models, [7, 1, 6, 3, 9], 6)


def test_rounds_independent_of_pool_history(models, narrow_draft):
    """Draft pages are zeroed at admission: a request's rounds do not
    depend on what an earlier request left in the recycled pages."""
    def run(b):
        r = b.submit([6, 2, 9, 1], 6)
        n = 0
        while not b.is_done(r):
            b.step()
            n += 1
        return b.result(r), n

    kw = dict(max_batch=1, n_pages=16, max_pages_per_seq=4, gamma=3)
    outs = []
    for fresh, dirty in zip(spec_pair(models, narrow_draft, **kw),
                            spec_pair(models, narrow_draft, **kw)):
        dirty.submit([8, 8, 8, 8, 8, 8, 8], 6)
        dirty.run_to_completion()
        outs.append((run(fresh), run(dirty)))
    assert outs[1] == outs[0]
    assert outs[1][0] == outs[1][1]


def test_admission_zeroes_the_row_draft_pages_only(models, narrow_draft):
    """A speculative admission zeroes the row's pages in the draft pool,
    in place, and nothing of the target pool (JAX serving.py:1388-1403)."""
    _, b = spec_pair(models, narrow_draft, max_batch=1, gamma=3)
    for pool in (b.cache, b.draft_cache):
        for x in pool.values():
            x.fill_(1)
    ptrs = {k: x.data_ptr() for k, x in b.draft_cache.items()}
    b.submit([6, 2, 9, 1, 4], 3)  # 3 pages: 5 + 3 tokens + 2 overshoot
    pages = [int(p) for p in b.block_table[0] if p]
    last = pages[-1]  # past the prompt: prefill writes none of it
    assert len(pages) == 3
    for k, x in b.draft_cache.items():
        assert x.data_ptr() == ptrs[k]
        others = np.setdiff1d(np.arange(x.shape[1]), pages)
        assert (x[:, others] == 1).all() and (x[:, last] == 0).all()
    for x in b.cache.values():
        assert (x[:, last] == 1).all()


def test_validations_match_jax(models, narrow_draft):
    jcfg, tcfg, jparams, tparams = models
    djcfg, dtcfg, djp, dtp = narrow_draft
    msgs = []
    for mod, params, cfg, dp, dc, kw in (
        (jax_serving, jparams, jcfg, djp, djcfg, {}),
        (torch_serving, tparams, tcfg, dtp, dtcfg, {"device": "cpu"}),
    ):
        batcher = mod.ContinuousBatcher
        for bad, match in (
            (dict(draft_params=dp,
                  draft_config=dataclasses.replace(dc, vocab_size=17)),
             "share a vocabulary"),
            (dict(draft_params=dp), "BOTH draft_params"),
            (dict(draft_params=dp, draft_config=dc, gamma=0), "gamma"),
        ):
            with pytest.raises(ValueError, match=match) as err:
                batcher(params, cfg, **bad, **kw)
            msgs.append(str(err.value))
        b = batcher(params, cfg, max_batch=1, n_pages=16, page_size=4,
                    max_pages_per_seq=4, draft_params=dp, draft_config=dc,
                    **kw)
        for sp in (mod.SamplingParams(logit_bias={1: 5.0}),
                   mod.SamplingParams(allowed_tokens=lambda g: [1])):
            with pytest.raises(ValueError, match="unsteered argmax") as err:
                b.submit([1, 2], 3, sampling=sp)
            msgs.append(str(err.value))
        with pytest.raises(ValueError, match="overshoot") as err:
            b.validate_request([1] * 10, 4)  # 10 + 4 + 3 > 16
        msgs.append(str(err.value))
    assert msgs[:6] == msgs[6:]


def test_eos_and_stops_end_rounds_like_jax(models, narrow_draft):
    """eos inside a round drops the round's later tokens; a stop sequence
    trims, and logprobs follow the plain path's (test_serving_stops.py:140)."""
    want = solo(models, [4, 9, 2], 8)
    stop_at = next(i for i in range(1, len(want)) if want[i] not in want[:i])
    outs = []
    for b in spec_pair(models, narrow_draft, max_batch=1, n_pages=16,
                       max_pages_per_seq=6, eos_id=want[stop_at], gamma=3):
        r = b.submit([4, 9, 2], 8)
        b.run_to_completion()
        outs.append((b.result(r), b.finish_reason(r)))
    assert outs[1] == outs[0] == (want[:stop_at + 1], "eos")

    greedy = solo(models, PROMPT, 8)
    stop = (greedy[4], greedy[5])
    outs = []
    for i, b in enumerate(spec_pair(models, deep_draft_of(models), gamma=3)):
        mod = (jax_serving, torch_serving)[i]
        sp = mod.SamplingParams(stop_sequences=(stop,), logprobs=True)
        r = b.submit(PROMPT, 8, sampling=sp)
        b.run_to_completion()
        outs.append((b.result(r), b.finish_reason(r), b.result_logprobs(r)))
    assert outs[1][:2] == outs[0][:2] == (greedy[:4], "stop")
    np.testing.assert_allclose(outs[1][2], outs[0][2], atol=1e-4)
    # the plain batcher reports the same logprobs (test_serving_stops.py:140)
    _, tcfg, _, tparams = models
    plain = torch_serving.ContinuousBatcher(tparams, tcfg, device="cpu",
                                            **GEOMETRY)
    r = plain.submit(PROMPT, 8, sampling=torch_serving.SamplingParams(
        stop_sequences=(stop,), logprobs=True))
    plain.run_to_completion()
    np.testing.assert_allclose(plain.result_logprobs(r), outs[1][2], atol=1e-4)


def deep_draft_of(models):
    """The target's first layer as the draft: a close draft accepts often."""
    jcfg, tcfg, jparams, tparams = models
    djcfg = dataclasses.replace(jcfg, n_layers=1)
    dtcfg = dataclasses.replace(tcfg, n_layers=1)
    jp = {**jparams, "layers": jax.tree.map(lambda x: x[:1], jparams["layers"])}
    tp = {**tparams, "layers": tparams["layers"][:1]}
    return djcfg, dtcfg, jp, tp
