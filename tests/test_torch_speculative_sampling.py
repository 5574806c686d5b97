"""The port's speculative serving with sampled rows against the JAX
batcher's, on the same weights (tiny f32 target with 2 KV heads, a 1-layer
draft): ``rejection_sample_commit`` equal on the same numpy seeds and true
to the target's law, and the batcher's sampled rows (rejection sampling)
giving JAX's tokens from the same seeds, logprobs within 1e-4. Checklist:
the JAX package's tests/test_speculative_sampling.py."""

from collections import Counter

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
def deep_draft():
    return draft_models(2)


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


# ----------------------------------------------- rejection sampling

def _norm(v):
    return v / v.sum()


def test_rejection_sample_commit_equals_jax_on_the_same_seeds():
    V, gamma = 12, 3
    master = np.random.default_rng(0)
    p_dists = [_norm(master.random(V) + 0.05) for _ in range(gamma + 1)]
    q_dists = [_norm(master.random(V) ** 2 + 0.01) for _ in range(gamma)]
    p_dists[2][5] = 0.0  # a proposal outside the target's support
    p_dists[2] = _norm(p_dists[2])
    for i in range(300):
        outs = []
        for fn in (jax_serving.rejection_sample_commit,
                   torch_serving.rejection_sample_commit):
            rng = np.random.default_rng(1000 + i)
            proposals = [int(rng.choice(V, p=q)) for q in q_dists]
            calls = []
            commit = fn(proposals, q_dists,
                        lambda g: calls.append(g) or p_dists[g], rng)
            outs.append((commit, calls, rng.random()))
        assert outs[1] == outs[0]


def test_rejection_kernel_token_law():
    """The distributional guarantee, at the algorithm level: the first
    committed token follows p0 and the second, given an accept, p1; the
    same tolerance rejects the draft's law."""
    V, gamma, n_trials = 12, 3, 20_000
    master = np.random.default_rng(0)
    p_dists = [_norm(master.random(V) + 0.05) for _ in range(gamma + 1)]
    q_dists = [_norm(master.random(V) ** 2 + 0.01) for _ in range(gamma)]
    first, second, accepted_any = Counter(), Counter(), 0
    for i in range(n_trials):
        rng = np.random.default_rng(1000 + i)
        proposals = [int(rng.choice(V, p=q)) for q in q_dists]
        commit, n = torch_serving.rejection_sample_commit(
            proposals, q_dists, lambda g: p_dists[g], rng)
        first[commit[0]] += 1
        if n >= 1:
            accepted_any += 1
            second[commit[1]] += 1
    emp0 = np.array([first[t] for t in range(V)]) / n_trials
    assert 0.5 * np.abs(emp0 - p_dists[0]).sum() < 0.02
    emp1 = np.array([second[t] for t in range(V)]) / max(accepted_any, 1)
    assert 0.5 * np.abs(emp1 - p_dists[1]).sum() < 0.03
    assert 0.5 * np.abs(emp0 - q_dists[0]).sum() > 0.05
    assert 0.2 < accepted_any / n_trials < 0.98


def test_identical_dists_always_accept():
    V, gamma = 8, 4
    master = np.random.default_rng(3)
    dists = [_norm(master.random(V) + 0.1) for _ in range(gamma + 1)]
    for i in range(200):
        rng = np.random.default_rng(i)
        proposals = [int(rng.choice(V, p=q)) for q in dists[:gamma]]
        commit, n = torch_serving.rejection_sample_commit(
            proposals, dists[:gamma], lambda g: dists[g], rng)
        assert n == gamma and commit[:gamma] == proposals
        assert len(commit) == gamma + 1


# ------------------------------------------------ the batcher, sampled rows

def run_sampled(b, mod, requests):
    reqs = [b.submit(p, n, sampling=mod.SamplingParams(**kw) if kw else None)
            for p, n, kw in requests]
    b.run_to_completion()
    return ([b.result(r) for r in reqs],
            [b.result_logprobs(r) if kw.get("logprobs") else None
             for (_, _, kw), r in zip(requests, reqs)],
            [b.finish_reason(r) for r in reqs], host_state(b))


def test_seeded_sampled_streams_match_jax(models, deep_draft):
    """A sampled row beside a greedy one: the same seeds draw the same
    proposals, accepts and resamples in both frameworks."""
    requests = [(PROMPT, 8, dict(temperature=0.9, top_k=20, seed=42,
                                 logprobs=True)),
                ([3, 1, 4, 1, 5], 6, {})]
    outs = [run_sampled(b, mod, requests) for b, mod in
            zip(spec_pair(models, deep_draft, gamma=3),
                (jax_serving, torch_serving))]
    assert outs[1][0] == outs[0][0] and outs[1][2:] == outs[0][2:]
    np.testing.assert_allclose(outs[1][1][0], outs[0][1][0], atol=1e-4)
    # the greedy batch-mate keeps the exact draft-verify stream
    assert outs[1][0][1] == solo(models, [3, 1, 4, 1, 5], 6)
    # the same seed again, alone: the same tokens
    _, b = spec_pair(models, deep_draft, gamma=3)
    again = run_sampled(b, torch_serving, requests[:1])
    assert again[0][0] == outs[1][0][0]


def test_top_k_one_sampling_is_greedy(models, deep_draft):
    _, b = spec_pair(models, deep_draft, gamma=3)
    got = run_sampled(b, torch_serving,
                      [(PROMPT, 6, dict(temperature=0.8, top_k=1, seed=11))])
    assert got[0][0] == solo(models, PROMPT, 6)


def test_sampled_stops_and_pages_match_jax(models, deep_draft):
    requests = [(PROMPT, 8, dict(temperature=1.0, seed=5, logprobs=True))]
    _, b = spec_pair(models, deep_draft, gamma=3)
    out = run_sampled(b, torch_serving, requests)[0][0]
    stop = (out[3], out[4])
    requests = [(PROMPT, 8, dict(temperature=1.0, seed=5, logprobs=True,
                                 stop_sequences=(stop,)))]
    requests += [([2, 7, 1], 5, dict(temperature=1.1, seed=s))
                 for s in range(3)]
    outs = []
    for b, mod in zip(spec_pair(models, deep_draft, gamma=3, max_batch=4),
                      (jax_serving, torch_serving)):
        free0 = len(b.free_pages)
        outs.append((run_sampled(b, mod, requests), len(b.free_pages) == free0))
    (jtok, jlp, jfin, jstate), _ = outs[0]
    (ttok, tlp, tfin, tstate), freed = outs[1]
    assert (ttok, tfin, tstate) == (jtok, jfin, jstate) and freed
    assert ttok[0] == out[:3] and tfin[0] == "stop" and len(tlp[0]) == 3
    np.testing.assert_allclose(tlp[0], jlp[0], atol=1e-4)
