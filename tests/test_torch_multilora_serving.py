"""The port's multi-LoRA serving against the JAX batcher's, on the same
weights and adapters (tiny config, 2 KV heads, f32, ``lora_scale`` 2):
``decode_window_paged`` with a bank within 1e-5 of max |logit|, and both
batchers (and engines) token for token with equal host bookkeeping,
adapter-salted chain hashes included; adapter rows also equal the port's
solo decode of ``merge_lora``. Checklist: the JAX package's
tests/test_multilora_serving.py (its mesh case waits for the parallel
layer)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bee_code_interpreter_tpu.models import engine as jax_engine
from bee_code_interpreter_tpu.models import lora as jax_lora
from bee_code_interpreter_tpu.models import serving as jax_serving
from bee_code_interpreter_tpu.models import transformer as jax_t
from bee_code_interpreter_tpu.ops.paged_kv_cache import (
    alloc_paged_cache as jax_alloc,
)
from bee_code_interpreter_tpu_torch.models import engine as torch_engine
from bee_code_interpreter_tpu_torch.models import lora as torch_lora
from bee_code_interpreter_tpu_torch.models import serving as torch_serving
from bee_code_interpreter_tpu_torch.models import transformer as torch_t
from bee_code_interpreter_tpu_torch.ops.paged_kv_cache import (
    alloc_paged_cache as torch_alloc,
)

from tests.torch_parity import (
    batcher_pair,
    host_state,
    lora_to_torch,
    tiny_configs,
    tiny_params,
)

SCALE = 2.0
PROMPT = [5, 3, 7, 2, 9, 4, 1, 8]
GEOMETRY = dict(max_batch=3, n_pages=40, page_size=4, max_pages_per_seq=8)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = tiny_configs()
    return (jcfg, tcfg, *tiny_params(jcfg, tcfg))


def trained_adapter(jcfg, seed, targets=("wq", "wv")):
    lora = jax_lora.init_lora(jcfg, jax.random.PRNGKey(seed), rank=4,
                              targets=targets)
    return {t: {"A": ab["A"],
                "B": jax.random.normal(jax.random.PRNGKey(seed + 100),
                                       ab["B"].shape) * 0.25}
            for t, ab in lora.items()}


@pytest.fixture(scope="module")
def adapters(models):
    """(JAX adapters, the port's copies)."""
    jcfg = models[0]
    jad = [trained_adapter(jcfg, 1), trained_adapter(jcfg, 2)]
    return jad, [lora_to_torch(a) for a in jad]


def pair(models, adapters, **kw):
    """Both batchers, each with its own copy of the adapters."""
    jcfg, tcfg, jparams, tparams = models
    kw = {**GEOMETRY, **kw, "lora_scale": SCALE}
    return (jax_serving.ContinuousBatcher(jparams, jcfg, adapters=adapters[0],
                                          **kw),
            torch_serving.ContinuousBatcher(tparams, tcfg, adapters=adapters[1],
                                            device="cpu", **kw))


def solo(models, params, prompt, n):
    _, tcfg, _, _ = models
    out = torch_t.Transformer(tcfg).generate_cached(
        params, torch.tensor([prompt]), max_new_tokens=n)
    return out[0, len(prompt):].tolist()


def test_decode_window_paged_with_bank_matches_jax(models, adapters):
    """One window of 5 tokens per row, 3 rows under adapters (0, 2, 1) of
    the bank, over the same pool and tables."""
    jcfg, tcfg, jparams, tparams = models
    jad, tad = adapters
    jbank = jax_lora.stack_lora_bank(jad)
    tbank = torch_lora.stack_lora_bank(tad)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, (3, 5))
    pos = np.array([0, 3, 6], dtype=np.int32)
    table = (1 + np.arange(12, dtype=np.int32)).reshape(3, 4)
    idx = np.array([0, 2, 1], dtype=np.int32)
    want, _ = jax_t.decode_window_paged(
        jparams, jnp.asarray(tokens), jnp.asarray(pos),
        jax_alloc(jcfg, 13, 4), jnp.asarray(table), jcfg,
        lora_bank=jbank, adapter_idx=jnp.asarray(idx), lora_scale=SCALE)
    got, _ = torch_t.decode_window_paged(
        tparams, torch.as_tensor(tokens), torch.as_tensor(pos),
        torch_alloc(tcfg, 13, 4, "cpu"), torch.as_tensor(table), tcfg,
        lora_bank=tbank, adapter_idx=torch.as_tensor(idx), lora_scale=SCALE)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    # the bank's zero adapter is the base path
    base, _ = torch_t.decode_window_paged(
        tparams, torch.as_tensor(tokens[:1]), torch.as_tensor(pos[:1]),
        torch_alloc(tcfg, 13, 4, "cpu"), torch.as_tensor(table[:1]), tcfg)
    torch.testing.assert_close(got[:1], base, rtol=0, atol=1e-5)


def test_decode_path_errors_match_jax(models, adapters):
    jcfg, tcfg, jparams, tparams = models
    jad, tad = adapters
    msgs = []
    for mod, params, cfg, bank, zeros, tensor in (
        (jax_t, jparams, jcfg, {"w_gate": {}}, jnp.zeros, jnp.asarray),
        (torch_t, tparams, tcfg, {"w_gate": {}}, torch.zeros, torch.as_tensor),
    ):
        tok = tensor(np.zeros((1, 1), dtype=np.int32))
        pos = tensor(np.zeros(1, dtype=np.int32))
        table = tensor(np.zeros((1, 2), dtype=np.int32))
        pool = (jax_alloc(cfg, 3, 4) if mod is jax_t
                else torch_alloc(cfg, 3, 4, "cpu"))
        for kw, match in ((dict(lora_bank={"wq": {}}), "needs adapter_idx"),
                          (dict(lora_bank=bank, adapter_idx=pos),
                           "attention projections only")):
            with pytest.raises(ValueError, match=match) as err:
                mod.decode_step_paged(params, tok, pos, pool, table, cfg, **kw)
            msgs.append(str(err.value))
    assert msgs[:2] == msgs[2:]


def test_heterogeneous_adapters_decode_together_like_jax(models, adapters):
    n = 6
    outs = []
    for b in pair(models, adapters):
        reqs = [b.submit(PROMPT, n), b.submit(PROMPT, n, adapter=0),
                b.submit(PROMPT, n, adapter=1)]
        b.run_to_completion()
        outs.append(([b.result(r) for r in reqs], host_state(b),
                     b.row_adapter.tolist()))
    assert outs[1] == outs[0]
    got = outs[1][0]
    _, tad = adapters
    tparams = models[3]
    assert got[0] == solo(models, tparams, PROMPT, n)
    for i in (0, 1):
        merged = torch_lora.merge_lora(tparams, tad[i], SCALE)
        assert got[i + 1] == solo(models, merged, PROMPT, n)
    assert got[1] != got[0] or got[2] != got[0]  # the adapters act


def test_rows_recycle_across_adapters_like_jax(models, adapters):
    outs = []
    for b in pair(models, adapters, max_batch=1):
        got = []
        for adapter in (1, None, 1):
            r = b.submit(PROMPT, 4, adapter=adapter)
            got.append((b.row_adapter.tolist(), b.result(r) if b.is_done(r)
                        else None))
            b.run_to_completion()
            got.append(b.result(r))
        outs.append((got, host_state(b)))
    assert outs[1] == outs[0]
    assert outs[1][0][1] == outs[1][0][5]


def test_all_four_targets_and_chunked_admission_like_jax(models):
    jcfg = models[0]
    jad = [trained_adapter(jcfg, 5, targets=("wq", "wk", "wv", "wo"))]
    long_prompt = (PROMPT * 3)[:18]
    outs = []
    for b in pair(models, (jad, [lora_to_torch(a) for a in jad])):
        r = b.submit(PROMPT, 5, adapter=0)
        r2 = b.submit(long_prompt, 4, adapter=0, prefill_chunk=8)
        b.run_to_completion()
        outs.append((b.result(r), b.result(r2)))
    assert outs[1] == outs[0]
    merged = torch_lora.merge_lora(models[3], lora_to_torch(jad[0]), SCALE)
    assert outs[1] == (solo(models, merged, PROMPT, 5),
                       solo(models, merged, long_prompt, 4))


def test_prefix_cache_keys_by_adapter_like_jax(models, adapters):
    """The same prompt under different adapters never shares pages; the
    same (prompt, adapter) hits; the salted chain hashes equal JAX's."""
    outs = []
    for b, eng_mod in zip(pair(models, adapters, prefix_cache=True),
                          (jax_engine, torch_engine)):
        eng = eng_mod.Engine(b)
        got, credits = [], []
        for adapter in (0, 1, 0, 1, None):
            credits.append(b.prefix_credit(PROMPT, adapter))
            t = eng.submit(PROMPT, 4, adapter=adapter)
            eng.run_to_completion()
            got.append(eng.result(t))
        outs.append((got, credits, host_state(b),
                     b._chain_hashes(np.asarray(PROMPT, dtype=np.int32), 2)))
    assert outs[1] == outs[0]
    got, credits, state, _ = outs[1]
    assert got[0] == got[2] and got[1] == got[3]
    assert credits == [0, 0, 1, 1, 0]
    assert state["prefix_stats"]["hits"] == 2
    assert len(state["prefix_index"]) == 6  # 2 pages under each of 3 salts


def test_speculative_target_adapters_like_jax(models, adapters):
    """Draft-verify with per-row adapted target rows (the draft stays
    base): the adapter row equals solo decode of the merged model."""
    jcfg, tcfg, _, _ = models
    djcfg = dataclasses.replace(jcfg, n_layers=1)
    dtcfg = dataclasses.replace(tcfg, n_layers=1)
    djp, dtp = tiny_params(djcfg, dtcfg, seed=9)
    n = 6
    outs = []
    for spec in (
        jax_serving.ContinuousBatcher(
            models[2], jcfg, **{**GEOMETRY, "max_batch": 2},
            adapters=adapters[0], lora_scale=SCALE, draft_params=djp,
            draft_config=djcfg, gamma=3),
        torch_serving.ContinuousBatcher(
            models[3], tcfg, **{**GEOMETRY, "max_batch": 2},
            adapters=adapters[1], lora_scale=SCALE, draft_params=dtp,
            draft_config=dtcfg, gamma=3, device="cpu"),
    ):
        r0 = spec.submit(PROMPT, n, adapter=0)
        rb = spec.submit(PROMPT, n)
        spec.run_to_completion()
        outs.append((spec.result(r0), spec.result(rb), host_state(spec)))
    assert outs[1] == outs[0]
    merged = torch_lora.merge_lora(models[3], adapters[1][0], SCALE)
    assert outs[1][0] == solo(models, merged, PROMPT, n)
    assert outs[1][1] == solo(models, models[3], PROMPT, n)


def test_validation_errors_match_jax(models, adapters):
    msgs = []
    for b in pair(models, adapters):
        with pytest.raises(ValueError, match="out of range") as err:
            b.submit(PROMPT, 3, adapter=2)
        msgs.append(str(err.value))
    plain = batcher_pair(models, **GEOMETRY)
    for b in plain:
        with pytest.raises(ValueError, match="no adapters") as err:
            b.submit(PROMPT, 3, adapter=0)
        msgs.append(str(err.value))
    for b, zeros, kw in ((plain[0], jnp.zeros, {}),
                         (plain[1], torch.zeros, {"device": "cpu"})):
        with pytest.raises(ValueError, match="attention projections") as err:
            type(b)(b.params, b.config, adapters=[
                {"w_gate": {"A": zeros((2, 8, 2)), "B": zeros((2, 2, 8))}}
            ], **kw)
        msgs.append(str(err.value))
    assert msgs[0::2] == msgs[1::2]


def test_bf16_within_batcher_determinism():
    """At bf16 the unmerged-vs-merged rounding makes merged-solo equality a
    near-tie coin flip; what must hold is that the batcher is
    deterministic and that the adapter changes the output."""
    jcfg, tcfg = tiny_configs()
    jparams, _ = tiny_params(jcfg, tcfg)
    from bee_code_interpreter_tpu_torch.weights import params_from_jax

    bf16 = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), bf16,
                             device="cpu")
    tad = [lora_to_torch(trained_adapter(jcfg, 1))]

    def run():
        b = torch_serving.ContinuousBatcher(params, bf16, max_batch=2, n_pages=40, page_size=4,
                           max_pages_per_seq=8, adapters=tad,
                           lora_scale=SCALE, device="cpu")
        r_a = b.submit(PROMPT, 5, adapter=0)
        r_base = b.submit(PROMPT, 5)
        b.run_to_completion()
        return b.result(r_a), b.result(r_base)

    first, second = run(), run()
    assert first == second
    assert first[0] != first[1]

