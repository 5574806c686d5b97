"""The port's ``speculative_generate`` against the JAX package's, on the
same weights (tiny f32 target with 2 KV heads; drafts of 1 layer, or 1
layer at d 32): token for token, and equal to the target's greedy
``generate_cached``, for a perfect and an unrelated draft, gammas 1, 2, 4,
a window past the end and an int8 target cache. Checklist: the JAX
package's tests/test_speculative.py (its MoE cases wait for MoE)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bee_code_interpreter_tpu.models.speculative import (
    speculative_generate as jax_speculative,
)
from bee_code_interpreter_tpu_torch.models import transformer as torch_t
from bee_code_interpreter_tpu_torch.models.speculative import (
    speculative_generate as torch_speculative,
)

from tests.torch_parity import tiny_configs, tiny_params

# the verify window and one-token decode agree to float error only: the
# prompts keep every greedy argmax this far ahead of the runner-up
MARGIN = 1e-3


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


def generate_both(models, draft, prompt, n, gamma):
    jcfg, tcfg, jparams, tparams = models
    djcfg, dtcfg, djp, dtp = draft
    want = jax_speculative(jparams, jcfg, djp, djcfg, jnp.asarray(prompt),
                           max_new_tokens=n, gamma=gamma)
    got = torch_speculative(tparams, tcfg, dtp, dtcfg, torch.as_tensor(prompt),
                            max_new_tokens=n, gamma=gamma)
    solo = torch_t.Transformer(tcfg).generate_cached(
        tparams, torch.as_tensor(prompt), max_new_tokens=n)
    logits = torch_t.forward(tparams, solo[:, :-1], tcfg)[:, prompt.shape[1] - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    assert (top2[..., 0] - top2[..., 1]).min().item() > MARGIN, "near-tie"
    return np.asarray(want).tolist(), got.tolist(), solo.tolist()


# ------------------------------------------------------ speculative_generate

def test_perfect_draft_matches_jax_and_greedy(models):
    prompt = np.random.default_rng(1).integers(0, 256, (2, 6))
    want, got, solo = generate_both(models, models, prompt, 9, 3)
    assert got == want == solo


@pytest.mark.parametrize("gamma", [1, 2, 4])
def test_unrelated_draft_still_exact(models, narrow_draft, gamma):
    prompt = np.random.default_rng(16).integers(0, 256, (2, 5))
    want, got, solo = generate_both(models, narrow_draft, prompt, 8, gamma)
    assert got == want == solo


def test_single_token_and_window_overrun(models):
    prompt = np.random.default_rng(3).integers(0, 256, (1, 4))
    want, got, solo = generate_both(models, models, prompt, 2, 5)
    assert got == want == solo
    want, got, solo = generate_both(models, models, prompt, 1, 3)
    assert got == want == solo


def test_int8_target_cache_exact(narrow_draft):
    jcfg, tcfg = tiny_configs(kv_cache_dtype="int8")
    models = (jcfg, tcfg, *tiny_params(jcfg, tcfg))
    prompt = np.random.default_rng(16).integers(0, 256, (2, 5))
    want, got, solo = generate_both(models, narrow_draft, prompt, 8, 3)
    assert got == want == solo


def test_generate_errors_match_jax(models):
    jcfg, tcfg, jparams, tparams = models
    djcfg, dtcfg = tiny_configs(vocab_size=128)
    msgs = []
    for fn, params, cfg, dcfg in ((jax_speculative, jparams, jcfg, djcfg),
                                  (torch_speculative, tparams, tcfg, dtcfg)):
        with pytest.raises(ValueError, match="share a vocabulary") as err:
            fn(params, cfg, params, dcfg, np.zeros((1, 4), np.int32))
        msgs.append(str(err.value))
        with pytest.raises(ValueError, match="max_new_tokens") as err:
            fn(params, cfg, params, cfg, np.zeros((1, 4), np.int32),
               max_new_tokens=0)
        msgs.append(str(err.value))
    assert msgs[:2] == msgs[2:]


@pytest.mark.parametrize("kv_cache_dtype", ["bf16", "int8"])
def test_decode_window_matches_sequential_steps(kv_cache_dtype):
    """The verify primitive: one W-token window gives the logits and the
    cache of W one-token steps (per-row int8 scales make a window append
    equal W single appends)."""
    _, tcfg = tiny_configs(kv_cache_dtype=kv_cache_dtype)
    _, tparams = tiny_params(*tiny_configs(kv_cache_dtype=kv_cache_dtype))
    tokens = torch.as_tensor(np.random.default_rng(4).integers(0, 256, (2, 12)))
    L_pre, W = 6, 4
    _, (k_pre, v_pre) = torch_t.forward(tparams, tokens[:, :L_pre], tcfg,
                                        return_kv=True)
    cache_a = torch_t.init_decode_cache(tcfg, 2, 16, k_pre, v_pre)
    cache_b = {k: x.clone() for k, x in cache_a.items()}
    win, cache_a = torch_t.decode_window(tparams, tokens[:, L_pre:L_pre + W],
                                         L_pre, cache_a, tcfg)
    for i in range(W):
        step, cache_b = torch_t.decode_step(
            tparams, tokens[:, L_pre + i:L_pre + i + 1], L_pre + i, cache_b, tcfg)
        torch.testing.assert_close(win[:, i], step[:, 0], rtol=1e-4, atol=1e-4)
    for k in cache_a:
        torch.testing.assert_close(cache_a[k].float(), cache_b[k].float(),
                                   rtol=1e-5, atol=1e-5)
