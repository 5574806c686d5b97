"""Serving a Mixture-of-Experts model: the port's batcher, engine, beam
search and speculative decoding against the JAX package's on the same
weights (tiny_moe: 4 experts, top-2; 2 KV heads; f32). Streams must agree
token for token and the host bookkeeping (``tests/torch_parity.py::
host_state``) exactly.

A capacity-routed config (factor 0.25: 8 slots an expert) serves with
drops: a request routes against its padded admission prompt and the free
rows of each decode step, so both batchers must feed routing the same
tokens for the same drops to happen. A ``moe_exact`` config (dropless,
one token a group) serves each request as its solo greedy decode, with
the prefix cache and beam search; prefix caching, speculative serving,
``speculative_generate`` and beam search refuse a capacity-routed target
with JAX's error type. Checklist: the MoE cases of the JAX package's
tests/test_serving.py, test_prefix_cache.py, test_speculative.py and
test_beam.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bee_code_interpreter_tpu.models import beam as jax_beam
from bee_code_interpreter_tpu.models import engine as jax_engine
from bee_code_interpreter_tpu.models import serving as jax_serving
from bee_code_interpreter_tpu.models import speculative as jax_spec
from bee_code_interpreter_tpu.models import text as jax_text
from bee_code_interpreter_tpu_torch.models import beam as torch_beam
from bee_code_interpreter_tpu_torch.models import engine as torch_engine
from bee_code_interpreter_tpu_torch.models import moe
from bee_code_interpreter_tpu_torch.models import serving as torch_serving
from bee_code_interpreter_tpu_torch.models import speculative as torch_spec
from bee_code_interpreter_tpu_torch.models import text as torch_text
from bee_code_interpreter_tpu_torch.models import transformer as torch_t

from tests.torch_parity import (
    batcher_pair,
    host_state,
    tiny_configs,
    tiny_params,
)

GEOMETRY = dict(max_batch=4, n_pages=40, page_size=4, max_pages_per_seq=8)
PROMPTS = [
    np.random.default_rng(i).integers(0, 256, L).tolist()
    for i, L in enumerate((13, 7, 22, 16))
]


def moe_models(**kw):
    jcfg, tcfg = tiny_configs(n_experts=4, **kw)
    return (jcfg, tcfg, *tiny_params(jcfg, tcfg))


@pytest.fixture(scope="module")
def capacity():
    return moe_models(moe_capacity_factor=0.25)


@pytest.fixture(scope="module")
def exact():
    models = moe_models(moe_dropless=True, moe_group_size=1)
    assert models[1].moe_exact and models[0].moe_exact
    return models


def count_drops(monkeypatch):
    """Counts the port's routed choices that fell past capacity."""
    dropped = [0]
    route = moe._route_group

    def counted(*args, **kwargs):
        r = route(*args, **kwargs)
        dropped[0] += int((~r.keep).sum())
        return r

    monkeypatch.setattr(moe, "_route_group", counted)
    return dropped


def staggered(b, mod, sampled=True):
    """Two requests, a step, two more (one seeded-sampled); run out."""
    sp = dict(temperature=0.9, top_k=20, seed=3) if sampled else {}
    reqs = [b.submit(PROMPTS[0], 6), b.submit(PROMPTS[1], 5)]
    b.step()
    reqs += [b.submit(PROMPTS[2], 6, sampling=mod.SamplingParams(**sp)),
             b.submit(PROMPTS[3], 4)]
    mid = host_state(b)
    b.run_to_completion()
    return [b.result(r) for r in reqs], mid


def test_capacity_routed_batcher_matches_jax(capacity, monkeypatch):
    dropped = count_drops(monkeypatch)
    out = []
    for b, mod in zip(batcher_pair(capacity, **GEOMETRY),
                      (jax_serving, torch_serving)):
        out.append((*staggered(b, mod), host_state(b)))
    assert dropped[0] > 0  # the prefills overflowed their experts
    assert out[1] == out[0]
    assert all(len(r) > 0 for r in out[1][0])


def test_capacity_routed_decode_drops_match_jax(capacity, monkeypatch):
    """A full decode batch of one repeated prompt: the rows' identical
    tokens compete for slots in every step, and the drops land on the same
    rows in both batchers."""
    geometry = dict(GEOMETRY, max_batch=12, n_pages=64)
    dropped = count_drops(monkeypatch)
    out = []
    for b in batcher_pair(capacity, **geometry):
        reqs = [b.submit(PROMPTS[1], 4) for _ in range(12)]
        b.run_to_completion()
        out.append(([b.result(r) for r in reqs], host_state(b)))
    assert dropped[0] > 0
    assert out[1] == out[0]


def test_capacity_routed_engine_and_text_engine_match_jax(capacity):
    class ByteTokenizer:
        def encode(self, text):
            return list(text.encode("utf-8"))

        def decode(self, tokens):
            return bytes(tokens).decode("utf-8", errors="replace")

    out = []
    for b, eng_mod, text_mod in zip(batcher_pair(capacity, **GEOMETRY),
                                    (jax_engine, torch_engine),
                                    (jax_text, torch_text)):
        eng = eng_mod.Engine(b)
        tickets = [eng.submit(p, 5) for p in PROMPTS]
        while eng.pending or b.busy:
            eng.step()
        te = text_mod.TextEngine(eng, ByteTokenizer())
        t = te.submit("mixture of experts", 6)
        te.run_to_completion()
        out.append(([eng.result(x) for x in tickets], te.text(t),
                    host_state(b)))
    assert out[1] == out[0]


def solo(models, prompt, n):
    """The port's solo greedy cached decode of one prompt."""
    _, tcfg, _, tparams = models
    got = torch_t.Transformer(tcfg).generate_cached(
        tparams, torch.tensor([prompt]), max_new_tokens=n)
    return got[0, len(prompt):].tolist()


def test_dropless_serving_matches_solo_decode(exact):
    """Each request equals its own solo greedy decode, whatever shares the
    batch (tests/test_serving.py's dropless case), and the JAX batcher."""
    out = []
    for b, mod in zip(batcher_pair(exact, **GEOMETRY),
                      (jax_serving, torch_serving)):
        out.append((*staggered(b, mod, sampled=False), host_state(b)))
    assert out[1] == out[0]
    lengths = (6, 5, 6, 4)
    assert out[1][0] == [solo(exact, p, n) for p, n in zip(PROMPTS, lengths)]


def test_dropless_prefix_cache_accepted_and_exact(exact):
    shared = PROMPTS[2][:8]
    p1, p2 = shared + [1, 2], shared + [3]
    out = []
    for b in batcher_pair(exact, **GEOMETRY, prefix_cache=True):
        r1 = b.submit(p1, 4)
        b.run_to_completion()
        r2 = b.submit(p2, 4)  # shares the two prefix pages of r1
        b.run_to_completion()
        out.append(([b.result(r1), b.result(r2)], host_state(b)))
    assert out[1] == out[0]
    assert out[1][1]["prefix_stats"]["hits"] >= 1
    assert out[1][0] == [solo(exact, p1, 4), solo(exact, p2, 4)]


def test_moe_exact_refusals_match_jax(capacity):
    """A capacity-routed target is refused by the prefix cache, speculative
    serving, ``speculative_generate`` and beam search, with JAX's error
    type and the substance of its message."""
    jcfg, tcfg, jparams, tparams = capacity
    jdraft, tdraft = tiny_configs(n_layers=1)
    jdp, tdp = tiny_params(jdraft, tdraft, seed=1)
    prompt = np.zeros((1, 4), np.int32)
    cases = [
        ("routing pools",
         lambda: jax_serving.ContinuousBatcher(jparams, jcfg, prefix_cache=True),
         lambda: torch_serving.ContinuousBatcher(tparams, tcfg, device="cpu",
                                                 prefix_cache=True)),
        ("moe_exact",
         lambda: jax_serving.ContinuousBatcher(jparams, jcfg, draft_params=jdp,
                                               draft_config=jdraft),
         lambda: torch_serving.ContinuousBatcher(tparams, tcfg, device="cpu",
                                                 draft_params=tdp,
                                                 draft_config=tdraft)),
        ("moe_exact",
         lambda: jax_spec.speculative_generate(jparams, jcfg, jdp, jdraft,
                                               jnp.asarray(prompt)),
         lambda: torch_spec.speculative_generate(tparams, tcfg, tdp, tdraft,
                                                 torch.from_numpy(prompt))),
        ("moe_exact",
         lambda: jax_beam.beam_search(jparams, jcfg, jnp.asarray(prompt)),
         lambda: torch_beam.beam_search(tparams, tcfg,
                                        torch.from_numpy(prompt))),
    ]
    for match, jax_call, port_call in cases:
        with pytest.raises(NotImplementedError, match=match):
            jax_call()
        with pytest.raises(NotImplementedError, match=match):
            port_call()


def test_dropless_beam_accepted_and_beam_one_equals_greedy(exact):
    jcfg, tcfg, jparams, tparams = exact
    prompt = np.asarray([PROMPTS[0][:5], PROMPTS[1][:5]], np.int32)
    want = torch_t.Transformer(tcfg).generate_cached(
        tparams, torch.from_numpy(prompt), max_new_tokens=5)
    got = torch_beam.beam_search(tparams, tcfg, torch.from_numpy(prompt),
                                 max_new_tokens=5, beam_size=1)
    assert torch.equal(got, want)
    seqs, scores = torch_beam.beam_search(
        tparams, tcfg, torch.from_numpy(prompt), max_new_tokens=3,
        beam_size=3, return_all=True)
    jseqs, jscores = jax_beam.beam_search(
        jparams, jcfg, jnp.asarray(prompt), max_new_tokens=3, beam_size=3,
        return_all=True)
    assert seqs.tolist() == np.asarray(jseqs).tolist()
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               atol=1e-4, rtol=1e-4)
    assert bool((scores[:, 1:] <= scores[:, :-1] + 1e-6).all())


def test_dropless_target_speculative_serving_matches_jax(exact):
    """A ``moe_exact`` MoE target with a dense draft: accepted, and every
    stream equals the plain batcher's and the JAX batcher's."""
    jdraft, tdraft = tiny_configs(n_layers=1)
    jdp, tdp = tiny_params(jdraft, tdraft, seed=1)
    jcfg, tcfg, jparams, tparams = exact
    spec = dict(GEOMETRY, gamma=3)
    out = []
    for b in (jax_serving.ContinuousBatcher(
                  jparams, jcfg, draft_params=jdp, draft_config=jdraft, **spec),
              torch_serving.ContinuousBatcher(
                  tparams, tcfg, draft_params=tdp, draft_config=tdraft,
                  device="cpu", **spec)):
        reqs = [b.submit(p, 5) for p in PROMPTS[:3]]
        b.run_to_completion()
        out.append(([b.result(r) for r in reqs], host_state(b)))
    assert out[1] == out[0]
    assert out[1][0] == [solo(exact, p, 5) for p in PROMPTS[:3]]


def test_speculative_generate_with_dropless_target_equals_greedy(exact):
    jcfg, tcfg, jparams, tparams = exact
    jdraft, tdraft = tiny_configs(n_layers=1)
    jdp, tdp = tiny_params(jdraft, tdraft, seed=1)
    prompt = np.asarray([PROMPTS[3][:6]], np.int32)
    want = torch_t.Transformer(tcfg).generate_cached(
        tparams, torch.from_numpy(prompt), max_new_tokens=6)
    got = torch_spec.speculative_generate(tparams, tcfg, tdp, tdraft,
                                          torch.from_numpy(prompt),
                                          max_new_tokens=6, gamma=3)
    jgot = jax_spec.speculative_generate(jparams, jcfg, jdp, jdraft,
                                         jnp.asarray(prompt),
                                         max_new_tokens=6, gamma=3)
    assert torch.equal(got, want)
    assert np.asarray(jgot).tolist() == want.tolist()
