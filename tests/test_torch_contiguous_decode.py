"""The port's contiguous cached decode and sampling against the JAX
package's on the same weights (tiny config, 2 KV heads, f32):
``decode_window``/``decode_step`` over bf16-layout and int8 caches,
``prefill_chunked``, ``generate``/``generate_cached`` token for token (eos
freezing, ``prefill_chunk``, int8), and ``filter_logits``' mask exactly.

Tolerances: logits 1e-4 and the plain cache 1e-5 (f32 on both sides; XLA
and PyTorch sum in different orders). An int8 cache quantizes values that
differ by those orders, so a value may round to the neighbouring step:
int8 entries within 1 of JAX's, scales to 1e-5. Sampled decoding cannot
be compared across frameworks (``jax.random`` against ``torch.Generator``);
it is held to determinism under a fixed generator and to drawing only from
``filter_logits``' support."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bee_code_interpreter_tpu.models import transformer as jax_t
from bee_code_interpreter_tpu_torch.models import transformer as torch_t
from bee_code_interpreter_tpu_torch.weights import cache_from_jax

from tests.torch_parity import tiny_configs, tiny_params, to_np

LOGIT_TOL = 1e-4
KV_TOL = 1e-5
PROMPTS = np.asarray([[5, 3, 7, 2, 9, 4, 1], [9, 2, 6, 5, 3, 5, 8]],
                     dtype=np.int32)


@pytest.fixture(scope="module", params=["bf16", "int8"])
def models(request):
    jcfg, tcfg = tiny_configs(kv_cache_dtype=request.param)
    jparams, tparams = tiny_params(jcfg, tcfg)
    return jcfg, tcfg, jparams, tparams


def assert_cache_close(got: dict, want: dict):
    assert set(got) == set(want)
    for name, x in got.items():
        w = np.asarray(want[name])
        if w.dtype == np.int8:
            assert x.dtype == torch.int8
            diff = np.abs(to_np(x).astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1
        else:
            np.testing.assert_allclose(to_np(x), w, atol=KV_TOL, rtol=KV_TOL)


def test_alloc_and_init_decode_cache_match_jax(models):
    jcfg, tcfg, jparams, tparams = models
    want = jax_t.alloc_decode_cache(jcfg, 2, 12)
    got = torch_t.alloc_decode_cache(tcfg, 2, 12, "cpu")
    assert {n: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for n, x in got.items()} == {
        n: (x.shape, str(x.dtype)) for n, x in want.items()}
    _, (jk, jv) = jax_t.forward(jparams, jnp.asarray(PROMPTS), jcfg,
                                return_kv=True)
    _, (tk, tv) = torch_t.forward(tparams, torch.from_numpy(PROMPTS), tcfg,
                                  return_kv=True)
    assert_cache_close(torch_t.init_decode_cache(tcfg, 2, 12, tk, tv),
                       jax_t.init_decode_cache(jcfg, 2, 12, jk, jv))


def test_decode_window_and_step_match_jax(models):
    """A window of 3 then a step, from the same seeded cache (the JAX
    prefill's, carried over by ``cache_from_jax``)."""
    jcfg, tcfg, jparams, tparams = models
    L, total = PROMPTS.shape[1], 16
    _, (jk, jv) = jax_t.forward(jparams, jnp.asarray(PROMPTS), jcfg,
                                return_kv=True)
    jcache = jax_t.init_decode_cache(jcfg, 2, total, jk, jv)
    tcache = cache_from_jax(jax.tree.map(np.asarray, jcache), "cpu")
    window = np.asarray([[11, 12, 13], [21, 22, 23]], dtype=np.int32)
    want, jcache = jax_t.decode_window(jparams, jnp.asarray(window), L,
                                       jcache, jcfg)
    got, out = torch_t.decode_window(tparams, torch.from_numpy(window), L,
                                     tcache, tcfg)
    assert out is tcache  # in place
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    assert_cache_close(tcache, jcache)
    token = np.asarray([[40], [41]], dtype=np.int32)
    want, jcache = jax_t.decode_step(jparams, jnp.asarray(token), L + 3,
                                     jcache, jcfg)
    got, _ = torch_t.decode_step(tparams, torch.from_numpy(token), L + 3,
                                 tcache, tcfg)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    assert_cache_close(tcache, jcache)


@pytest.mark.parametrize("L,chunk", [(12, 4), (13, 5), (7, 16), (9, 1)])
def test_prefill_chunked_equals_full_forward_and_jax(L, chunk):
    """Chunked prefill against the port's own full forward (last logits,
    and the cache's first L slots against the forward's K/V), and against
    JAX's ``prefill_chunked``, remainder chunk included."""
    jcfg, tcfg = tiny_configs()
    jparams, tparams = tiny_params(jcfg, tcfg)
    prompt = np.random.default_rng(L).integers(0, 256, (2, L)).astype(np.int32)
    total = L + 3
    last, cache = torch_t.prefill_chunked(
        tparams, torch.from_numpy(prompt), tcfg, total, chunk=chunk)
    logits, (k, v) = torch_t.forward(tparams, torch.from_numpy(prompt), tcfg,
                                     return_kv=True)
    np.testing.assert_allclose(to_np(last), to_np(logits[:, -1]),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_allclose(to_np(cache["k"][..., :L, :]), to_np(k),
                               atol=KV_TOL, rtol=KV_TOL)
    np.testing.assert_allclose(to_np(cache["v"][..., :L, :]), to_np(v),
                               atol=KV_TOL, rtol=KV_TOL)
    assert not cache["k"][..., L:, :].any()
    want_last, want_cache = jax_t.prefill_chunked(
        jparams, jnp.asarray(prompt), jcfg, total, chunk=chunk)
    np.testing.assert_allclose(to_np(last), np.asarray(want_last),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert_cache_close(cache, want_cache)


def test_prefill_chunked_validates_like_jax():
    _, tcfg = tiny_configs()
    _, tparams = tiny_params(*tiny_configs())
    prompt = torch.zeros(1, 6, dtype=torch.long)
    for args, match in (((prompt[:, :0], 4), "non-empty"),
                        ((prompt, 5), "total_len"), ((prompt, 8, 0), "chunk")):
        with pytest.raises(ValueError, match=match):
            torch_t.prefill_chunked(tparams, args[0], tcfg, *args[1:])


GENERATE_CASES = {
    "one_shot": {},
    "chunked": {"prefill_chunk": 3},
    "eos": {"eos_id": None},  # the greedy stream's second new token
    "eos_first": {"eos_id": None},  # row 0's first new token
}


@pytest.mark.parametrize("case", GENERATE_CASES)
def test_generate_cached_matches_generate_and_jax(models, case):
    """Greedy token for token: the port's ``generate_cached`` equals its
    uncached ``generate`` and JAX's ``generate_cached``, through one-shot
    and chunked prefill, eos freezing (an eos mid-stream, and an eos as the
    first new token) and both cache layouts."""
    jcfg, tcfg, jparams, tparams = models
    new = 6
    jmodel, tmodel = jax_t.Transformer(jcfg), torch_t.Transformer(tcfg)
    kw = dict(GENERATE_CASES[case])
    greedy = to_np(tmodel.generate_cached(tparams, torch.from_numpy(PROMPTS),
                                          new))
    L = PROMPTS.shape[1]
    if case == "eos":
        kw["eos_id"] = int(greedy[0, L + 1])
    elif case == "eos_first":
        kw["eos_id"] = int(greedy[0, L])
    got = to_np(tmodel.generate_cached(tparams, torch.from_numpy(PROMPTS),
                                       new, **kw))
    want = np.asarray(jmodel.generate_cached(jparams, jnp.asarray(PROMPTS),
                                             new, **kw))
    assert got.tolist() == want.tolist()
    assert got.shape == (2, L + new)
    if "eos_id" in kw:
        row = got[0, L:].tolist()
        first = row.index(kw["eos_id"])
        assert row[first:] == [kw["eos_id"]] * (new - first)
    else:
        # the plain layout is the uncached generate's; an int8 cache
        # quantizes K/V, so only the first token (from the exact prefill)
        # is held to the full-forward decode
        full = to_np(tmodel.generate(tparams, torch.from_numpy(PROMPTS), new))
        want_full = np.asarray(jmodel.generate(jparams, jnp.asarray(PROMPTS),
                                               new))
        assert full.tolist() == want_full.tolist()
        if tcfg.kv_cache_dtype == "bf16":
            assert got.tolist() == full.tolist()
        else:
            assert got[:, :L + 1].tolist() == full[:, :L + 1].tolist()


def filter_inputs():
    """Logits with ties: a shared top value, a tie at the k-th, and an
    -inf entry."""
    x = np.random.default_rng(3).standard_normal((4, 40)).astype(np.float32)
    x[0, [3, 9]] = 5.0
    x[1, [1, 2, 7]] = np.sort(x[1])[-5]
    x[2, 0] = -np.inf
    x[3] *= 8.0  # a sharp row: the top token holds most of the mass
    return x


@pytest.mark.parametrize("top_k", [None, 1, 5, 40])
@pytest.mark.parametrize("top_p", [None, -1.0, 0.0, 0.5, 0.9, 0.95])
def test_filter_logits_mask_equals_jax(top_k, top_p):
    """Exact masks. Not at top_p = 1: there the tail's mass before each
    token is 1 within f32 rounding, and XLA's and PyTorch's cumulative sums
    round it differently."""
    x = filter_inputs()
    want = np.asarray(jax_t.filter_logits(jnp.asarray(x), top_k, top_p))
    got = to_np(torch_t.filter_logits(torch.from_numpy(x), top_k, top_p))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[np.isfinite(got)], want[np.isfinite(want)])
    assert np.isfinite(got).any(axis=-1).all()  # the top token always stays


def test_sample_logits_greedy_and_validation():
    x = torch.from_numpy(filter_inputs())
    gen = torch.Generator().manual_seed(0)
    assert torch_t.sample_logits(x, gen).tolist() == x.argmax(-1, keepdim=True).tolist()
    # top_k = 1 is greedy at any temperature
    drawn = torch_t.sample_logits(x, gen, temperature=3.0, top_k=1)
    assert drawn[1:].tolist() == x[1:].argmax(-1, keepdim=True).tolist()
    assert drawn[0].item() in (3, 9)  # row 0's tie at the top
    for temperature in (0.0, 1.0):
        with pytest.raises(ValueError, match="top_k"):
            torch_t.sample_logits(x, gen, temperature=temperature, top_k=0)


def test_sampled_generate_cached_is_deterministic_and_in_support(
        models, monkeypatch):
    _, tcfg, _, tparams = models
    model = torch_t.Transformer(tcfg)
    kw = dict(temperature=0.8, top_k=5, top_p=0.9)
    draws = []
    sample = torch_t.sample_logits

    def recorded(logits, generator, *args):
        out = sample(logits, generator, *args)
        draws.append((logits.clone(), out))
        return out

    monkeypatch.setattr(torch_t, "sample_logits", recorded)

    def run(seed):
        return to_np(model.generate_cached(
            tparams, torch.from_numpy(PROMPTS), 8,
            generator=torch.Generator().manual_seed(seed), **kw))

    first = run(1)
    assert len(draws) == 8
    for logits, out in draws:
        support = torch.isfinite(torch_t.filter_logits(
            logits / kw["temperature"], kw["top_k"], kw["top_p"]))
        assert support.gather(-1, out).all()
    assert run(1).tolist() == first.tolist()
    assert any(run(seed).tolist() != first.tolist() for seed in (2, 3, 4))
    # the default generator is seed 0, so a call without one is repeatable
    monkeypatch.setattr(torch_t, "sample_logits", sample)
    assert (to_np(model.generate_cached(tparams, torch.from_numpy(PROMPTS), 8,
                                        **kw)).tolist()
            == to_np(model.generate_cached(tparams, torch.from_numpy(PROMPTS),
                                           8, **kw)).tolist())


def test_transformer_generate_keeps_prompt_and_shapes():
    jcfg, tcfg = tiny_configs()
    _, tparams = tiny_params(jcfg, tcfg)
    model = torch_t.Transformer(tcfg)
    out = model.generate_cached(tparams, PROMPTS[:1].tolist(), 1)
    assert out.shape == (1, PROMPTS.shape[1] + 1)
    assert out[0, :PROMPTS.shape[1]].tolist() == PROMPTS[0].tolist()
    assert out.dtype == torch.long
    with pytest.raises(ValueError):
        model.generate_cached(tparams, PROMPTS, 3, prefill_chunk=0)
    rope_cfg = dataclasses.replace(tcfg, rope_scaling=4.0)
    assert torch.equal(
        torch_t.Transformer(rope_cfg).generate(tparams, PROMPTS, 3),
        torch_t.Transformer(rope_cfg).generate_cached(tparams, PROMPTS, 3),
    )
