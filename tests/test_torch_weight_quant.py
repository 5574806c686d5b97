"""The port's weight-only int8 (``ops/weight_quant.py`` and ``qeinsum``'s
quantized branch) against the JAX package's, on the same weights (tiny
config, 2 KV heads, f32 masters; bf16 weights for the bitwise check too):
``q`` and ``s`` bitwise equal, ``quantized_nbytes`` equal, logits within
1e-5 of max |logit|, and the batcher's greedy streams token for token.
Checklist: the JAX package's tests/test_weight_quant.py (its mesh case
waits for the parallel layer)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bee_code_interpreter_tpu.models import lora as jax_lora
from bee_code_interpreter_tpu.models import transformer as jax_t
from bee_code_interpreter_tpu.ops import weight_quant as jax_wq
from bee_code_interpreter_tpu_torch.models import lora as torch_lora
from bee_code_interpreter_tpu_torch.models import transformer as torch_t
from bee_code_interpreter_tpu_torch.ops import weight_quant as torch_wq
from bee_code_interpreter_tpu_torch.weights import params_from_jax

from tests.torch_parity import (
    batcher_pair,
    host_state,
    lora_to_torch,
    tiny_configs,
    tiny_params,
)

PROMPT = [5, 3, 7, 2, 9, 4, 1, 8]
GEOMETRY = dict(max_batch=2, n_pages=24, page_size=4, max_pages_per_seq=8)
LOGIT_TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = tiny_configs()
    jparams, tparams = tiny_params(jcfg, tcfg)
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def qmodels(models):
    """The quantized tiny model in both frameworks: JAX quantizes its
    masters, the port its own copy of them."""
    jcfg, tcfg, jparams, tparams = models
    return (jcfg, tcfg, jax_wq.quantize_weights(jparams),
            torch_wq.quantize_weights(tparams))


def bits(x) -> np.ndarray:
    x = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return x.view(np.uint8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q_and_s_are_bitwise_jax(models, dtype):
    jcfg, tcfg, jparams, _ = models
    jp = jax.tree.map(lambda x: x.astype(getattr(jnp, dtype)), jparams)
    tp = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                         device="cpu", dtype=getattr(torch, dtype))
    jq, tq = jax_wq.quantize_weights(jp), torch_wq.quantize_weights(tp)
    for name in jax_wq.DEFAULT_TARGETS[:-1]:
        for i, layer in enumerate(tq["layers"]):
            for part in ("q", "s"):
                assert np.array_equal(bits(jq["layers"][name][part][i]),
                                      bits(layer[name][part])), (name, i, part)
    for part in ("q", "s"):
        assert np.array_equal(bits(jq["lm_head"][part]),
                              bits(tq["lm_head"][part]))
    assert tq["layers"][0]["wq"]["q"].dtype == torch.int8
    assert tq["layers"][0]["wq"]["s"].dtype == torch.float32
    if dtype == "float32":  # the port's params are JAX's f32 masters
        assert (torch_wq.quantized_nbytes(tq) == jax_wq.quantized_nbytes(jq)
                and torch_wq.quantized_nbytes(tp)
                == jax_wq.quantized_nbytes(jp))


def test_quantize_weight_edge_values_match_jax():
    """Zero columns (scale 1), halves that round to even, and the clip."""
    w = np.array([[0.0, 1.0, -2.5, 3.0], [0.0, -0.5, 2.5, 1.5],
                  [0.0, 0.25, 127.0, -3.0]], dtype=np.float32)
    jq = jax_wq.quantize_weight(jnp.asarray(w))
    tq = torch_wq.quantize_weight(torch.from_numpy(w))
    for part in ("q", "s"):
        assert np.array_equal(bits(jq[part]), bits(tq[part]))
    assert tq["s"][0].item() == 1.0


def test_predicates_and_targets_match_jax(models, qmodels):
    _, _, jparams, tparams = models
    _, _, jq, tq = qmodels
    assert torch_wq.DEFAULT_TARGETS == jax_wq.DEFAULT_TARGETS
    assert not torch_wq.any_quantized(tparams)
    assert torch_wq.any_quantized(tq) == jax_wq.any_quantized(jq) is True
    for name, leaf in tq["layers"][0].items():
        assert torch_wq.is_quantized(leaf) == jax_wq.is_quantized(
            jq["layers"][name])
    assert not torch_wq.is_quantized(tq["embed"])
    only_wq = torch_wq.quantize_weights(tparams, targets=("wq",))
    assert torch_wq.is_quantized(only_wq["layers"][1]["wq"])
    assert not torch_wq.is_quantized(only_wq["lm_head"])
    assert only_wq["layers"][1]["wk"] is tparams["layers"][1]["wk"]  # shared


def test_qeinsum_epilogue_matches_jax_and_dequantized_oracle():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((32, 16)).astype(np.float32)
    x = rng.standard_normal((2, 4, 32)).astype(np.float32)
    jleaf = jax_wq.quantize_weight(jnp.asarray(w))
    tleaf = torch_wq.quantize_weight(torch.from_numpy(w))
    want = np.asarray(jax_t.qeinsum("bld,dk->blk", jnp.asarray(x), jleaf,
                                    jnp.float32))
    got = torch_t.qeinsum("bld,dk->blk", torch.from_numpy(x), tleaf,
                          torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    dequant = tleaf["q"].float() * tleaf["s"][None, :]
    oracle = torch.einsum("bld,dk->blk", torch.from_numpy(x), dequant)
    np.testing.assert_allclose(got, oracle.numpy(), rtol=1e-5, atol=1e-5)


def test_params_from_jax_carries_quantized_leaves(models, qmodels):
    jcfg, tcfg, _, _ = models
    _, _, jq, tq = qmodels
    carried = params_from_jax(jax.tree.map(np.asarray, jq), tcfg,
                              device="cpu", dtype=torch.bfloat16)
    for i, layer in enumerate(carried["layers"]):
        leaf = layer["w_down"]
        assert leaf["q"].dtype == torch.int8 and leaf["s"].dtype == torch.float32
        assert torch.equal(leaf["q"], tq["layers"][i]["w_down"]["q"])
        assert torch.equal(leaf["s"], tq["layers"][i]["w_down"]["s"])
    assert carried["embed"].dtype == torch.bfloat16


def test_quantized_forward_matches_jax_and_stays_close_to_fp(models, qmodels):
    jcfg, tcfg, jparams, tparams = models
    _, _, jq, tq = qmodels
    tokens = np.random.default_rng(2).integers(0, 256, (2, 12))
    want = np.asarray(jax_t.forward(jq, jnp.asarray(tokens), jcfg))
    got = torch_t.forward(tq, torch.as_tensor(tokens), tcfg).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= LOGIT_TOL * scale
    # quality, not exactness: near the fp logits, argmax mostly kept
    fp = torch_t.forward(tparams, torch.as_tensor(tokens), tcfg).numpy()
    assert np.abs(got - fp).max() < 0.25 * np.abs(fp).max()
    assert (got.argmax(-1) == fp.argmax(-1)).mean() >= 0.75


def test_quantized_serving_matches_jax_and_solo(qmodels):
    """generate_cached and both batchers on the same quantized weights: one
    token stream, and a batch-mate changes nothing."""
    jcfg, tcfg, jq, tq = qmodels
    solo = torch_t.Transformer(tcfg).generate_cached(
        tq, torch.tensor([PROMPT]), max_new_tokens=6)[0, len(PROMPT):].tolist()
    jsolo = np.asarray(jax_t.Transformer(jcfg).generate_cached(
        jq, jnp.asarray([PROMPT]), max_new_tokens=6)[0, len(PROMPT):]).tolist()
    assert solo == jsolo
    outs = []
    for b in batcher_pair((jcfg, tcfg, jq, tq), **GEOMETRY):
        r = b.submit(PROMPT, 6)
        r2 = b.submit([3, 1, 4, 1, 5], 4)
        b.run_to_completion()
        outs.append((b.result(r), b.result(r2)))
    assert outs[1] == outs[0]
    assert outs[1][0] == solo


def test_quantized_with_int8_pool_and_prefix_cache_match_jax(models):
    jcfg, tcfg = tiny_configs(kv_cache_dtype="int8")
    jp, tp = tiny_params(jcfg, tcfg, seed=3)
    quant = (jcfg, tcfg, jax_wq.quantize_weights(jp),
             torch_wq.quantize_weights(tp))
    runs = []
    for b in batcher_pair(quant, prefix_cache=True, **GEOMETRY):
        out = []
        for _ in range(2):
            r = b.submit(PROMPT, 5)
            b.run_to_completion()
            out.append(b.result(r))
        runs.append((out, host_state(b)))
    assert runs[1] == runs[0]
    out, state = runs[1]
    assert out[0] == out[1] and state["prefix_stats"]["hits"] == 1


def test_quantized_base_serves_adapters_like_jax(models, qmodels):
    """Multi-LoRA on an int8 base: the zero adapter is the quantized base
    exactly, a real adapter changes the output, both frameworks agree."""
    jcfg, tcfg, _, _ = models
    zero = jax_lora.init_lora(jcfg, jax.random.PRNGKey(5), rank=4)
    real = {t: {"A": ab["A"],
                "B": jax.random.normal(jax.random.PRNGKey(6), ab["B"].shape)
                * 0.3}
            for t, ab in zero.items()}
    jadapters = [zero, real]
    tadapters = [lora_to_torch(a) for a in jadapters]
    outs = []
    for b in batcher_pair(qmodels, **GEOMETRY):
        is_port = isinstance(b.params["embed"], torch.Tensor)
        b2 = type(b)(b.params, b.config, **GEOMETRY, lora_scale=2.0,
                     adapters=tadapters if is_port else jadapters,
                     **({"device": "cpu"} if is_port else {}))
        got = []
        for adapter in (0, 1, None):
            r = b2.submit(PROMPT, 5, adapter=adapter)
            b2.run_to_completion()
            got.append(b2.result(r))
        r = b.submit(PROMPT, 5)
        b.run_to_completion()
        outs.append((got, b.result(r)))
    assert outs[1] == outs[0]
    (zero_out, real_out, base_in_bank), base = outs[1]
    assert zero_out == base == base_in_bank
    assert real_out != base


def test_merge_refuses_quantized_base(models, qmodels):
    _, tcfg, _, _ = models
    lora = torch_lora.init_lora(tcfg, torch.Generator().manual_seed(5), rank=4)
    with pytest.raises(NotImplementedError, match="quantize AFTER merging"):
        torch_lora.merge_lora(qmodels[3], lora)
