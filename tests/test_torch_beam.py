"""The port's ``beam_search`` against the JAX package's, on the same
weights (tiny config, f32): beams and scores equal (tokens exactly, scores
within 1e-5), ``beam_size=1`` equal to greedy ``generate_cached``, beams
sorted best first, scores equal to the rescored sequence, and the same
validation errors. Checklist: the JAX package's tests/test_beam.py (its MoE
cases wait for MoE)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bee_code_interpreter_tpu.models.beam import beam_search as jax_beam
from bee_code_interpreter_tpu_torch.models import transformer as torch_t
from bee_code_interpreter_tpu_torch.models.beam import beam_search as torch_beam

from tests.torch_parity import tiny_configs, tiny_params


@pytest.fixture(scope="module", params=["bf16", "int8"])
def models(request):
    jcfg, tcfg = tiny_configs(kv_cache_dtype=request.param)
    return (jcfg, tcfg, *tiny_params(jcfg, tcfg))


def prompt(seed, B, L):
    return np.random.default_rng(seed).integers(0, 256, (B, L))


def test_beams_and_scores_match_jax(models):
    jcfg, tcfg, jparams, tparams = models
    p = prompt(2, 2, 5)
    jseqs, jscores = jax_beam(jparams, jcfg, jnp.asarray(p), max_new_tokens=6,
                              beam_size=4, return_all=True)
    tseqs, tscores = torch_beam(tparams, tcfg, torch.as_tensor(p),
                                max_new_tokens=6, beam_size=4, return_all=True)
    assert tseqs.tolist() == np.asarray(jseqs).tolist()
    np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores),
                               rtol=1e-5, atol=1e-5)
    best = torch_beam(tparams, tcfg, torch.as_tensor(p), max_new_tokens=6,
                      beam_size=4)
    assert torch.equal(best, tseqs[:, 0])


def test_beam_one_equals_greedy(models):
    jcfg, tcfg, jparams, tparams = models
    p = prompt(1, 2, 6)
    want = torch_t.Transformer(tcfg).generate_cached(
        tparams, torch.as_tensor(p), max_new_tokens=7)
    got = torch_beam(tparams, tcfg, torch.as_tensor(p), max_new_tokens=7,
                     beam_size=1)
    assert torch.equal(got, want)
    jgot = jax_beam(jparams, jcfg, jnp.asarray(p), max_new_tokens=7,
                    beam_size=1)
    assert got.tolist() == np.asarray(jgot).tolist()


def test_beams_sorted_and_deterministic(models):
    _, tcfg, _, tparams = models
    p = torch.as_tensor(prompt(2, 2, 5))
    seqs_a, scores_a = torch_beam(tparams, tcfg, p, max_new_tokens=6,
                                  beam_size=4, return_all=True)
    seqs_b, scores_b = torch_beam(tparams, tcfg, p, max_new_tokens=6,
                                  beam_size=4, return_all=True)
    assert torch.equal(seqs_a, seqs_b) and torch.equal(scores_a, scores_b)
    assert tuple(seqs_a.shape) == (2, 4, 11)
    assert (torch.diff(scores_a, dim=1) <= 1e-6).all()
    assert torch.equal(seqs_a[:, :, :5], p[:, None, :].expand(2, 4, 5))


def test_beam_score_matches_rescored_sequence():
    """On the bf16-layout cache (an int8 cache's decode logits are not the
    forward's)."""
    jcfg, tcfg = tiny_configs()
    _, tparams = tiny_params(jcfg, tcfg)
    p = torch.as_tensor(prompt(3, 1, 4))
    n_new = 5
    seqs, scores = torch_beam(tparams, tcfg, p, max_new_tokens=n_new,
                              beam_size=3, return_all=True)
    best = seqs[0, 0][None, :]
    lp = torch.log_softmax(torch_t.forward(tparams, best, tcfg), dim=-1)
    total = sum(lp[0, 3 + i, best[0, 4 + i]].item() for i in range(n_new))
    assert abs(scores[0, 0].item() - total) <= 1e-3


def test_validation_matches_jax(models):
    jcfg, tcfg, jparams, tparams = models
    msgs = []
    for fn, params, cfg in ((jax_beam, jparams, jcfg),
                            (torch_beam, tparams, tcfg)):
        for kw, match in ((dict(beam_size=0), "beam_size must be >= 1"),
                          (dict(max_new_tokens=0),
                           "max_new_tokens must be >= 1")):
            with pytest.raises(ValueError, match=match) as err:
                fn(params, cfg, np.zeros((1, 4), np.int32), **kw)
            msgs.append(str(err.value))
    assert msgs[:2] == msgs[2:]
