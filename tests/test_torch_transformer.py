"""The port's decoder against the JAX package's on the same weights (tiny
config, 2 KV heads, f32): components, the prefill ``forward(return_kv=True)``
and the paged decode on both attention branches. Tolerance 1e-4 on logits,
1e-5 on K/V and the pool (f32 on both sides; XLA and PyTorch sum in
different orders)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bee_code_interpreter_tpu.models import transformer as jax_t
from bee_code_interpreter_tpu.ops.paged_kv_cache import (
    alloc_paged_cache as jax_alloc,
)
from bee_code_interpreter_tpu_torch.models import transformer as torch_t

from tests.torch_parity import tiny_configs, tiny_params, to_np

LOGIT_TOL = 1e-4
KV_TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = tiny_configs()
    jparams, tparams = tiny_params(jcfg, tcfg)
    return jcfg, tcfg, jparams, tparams


def test_rms_norm_and_rope_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 16), dtype=np.float32)
    scale = rng.standard_normal(16, dtype=np.float32)
    pos = rng.integers(0, 100, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        to_np(torch_t.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))),
        np.asarray(jax_t.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        atol=1e-6, rtol=1e-6,
    )
    for scaling in (1.0, 4.0):
        np.testing.assert_allclose(
            to_np(torch_t.rope(torch.from_numpy(x), torch.from_numpy(pos),
                               500000.0, scaling)),
            np.asarray(jax_t.rope(jnp.asarray(x), jnp.asarray(pos),
                                  500000.0, scaling)),
            atol=1e-5, rtol=1e-5,
        )


@pytest.mark.parametrize("window", [None, 5])
def test_forward_logits_and_kv_match_jax(setup, window):
    jcfg, tcfg, jparams, tparams = setup
    jcfg = dataclasses.replace(jcfg, sliding_window=window)
    tcfg = dataclasses.replace(tcfg, sliding_window=window)
    tokens = np.random.default_rng(1).integers(0, 256, (2, 13)).astype(np.int32)
    want_logits, (want_k, want_v) = jax_t.forward(
        jparams, jnp.asarray(tokens), jcfg, return_kv=True
    )
    logits, (k, v) = torch_t.forward(
        tparams, torch.from_numpy(tokens), tcfg, return_kv=True
    )
    assert logits.dtype == torch.float32 and tuple(k.shape) == want_k.shape
    np.testing.assert_allclose(to_np(logits), np.asarray(want_logits),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_allclose(to_np(k), np.asarray(want_k), atol=KV_TOL, rtol=KV_TOL)
    np.testing.assert_allclose(to_np(v), np.asarray(want_v), atol=KV_TOL, rtol=KV_TOL)


def decode_case(jcfg, seed=2):
    """A pool holding random K/V, permuted per-row block tables, per-row
    positions of different lengths."""
    rng = np.random.default_rng(seed)
    n_pages, ps, P, B = 14, 4, 3, 3
    shape = jax_alloc(jcfg, n_pages, ps)["k"].shape
    pool = {name: rng.standard_normal(shape, dtype=np.float32)
            for name in ("k", "v")}
    bt = (1 + rng.permutation(n_pages - 1)[: B * P]).reshape(B, P)
    pos = np.asarray([5, 10, 0], dtype=np.int32)
    return pool, bt.astype(np.int32), pos


@pytest.mark.parametrize("kernel", [False, True])
def test_decode_step_paged_matches_jax(setup, kernel):
    """Both attention branches: the einsum path and the paged decode kernel
    (its plain version here; the JAX side runs its Pallas kernel)."""
    jcfg, tcfg, jparams, tparams = setup
    jcfg = dataclasses.replace(jcfg, paged_attention_kernel=kernel)
    tcfg = dataclasses.replace(tcfg, paged_attention_kernel=kernel)
    pool, bt, pos = decode_case(jcfg)
    token = np.asarray([[7], [200], [3]], dtype=np.int32)
    want_logits, want_pool = jax_t.decode_step_paged(
        jparams, jnp.asarray(token), jnp.asarray(pos),
        {n: jnp.asarray(x) for n, x in pool.items()}, jnp.asarray(bt), jcfg,
    )
    mine = {n: torch.from_numpy(x.copy()) for n, x in pool.items()}
    logits, got_pool = torch_t.decode_step_paged(
        tparams, torch.from_numpy(token), torch.from_numpy(pos), mine,
        torch.from_numpy(bt), tcfg,
    )
    assert got_pool is mine  # updated in place
    np.testing.assert_allclose(to_np(logits), np.asarray(want_logits),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(to_np(got_pool[name]),
                                   np.asarray(want_pool[name]),
                                   atol=KV_TOL, rtol=KV_TOL)


@pytest.mark.parametrize("window", [None, 4])
def test_decode_window_paged_matches_jax(setup, window):
    """W = 3 tokens per row (the einsum path; a row's window straddles a
    page boundary), with and without a sliding window."""
    jcfg, tcfg, jparams, tparams = setup
    jcfg = dataclasses.replace(jcfg, sliding_window=window)
    tcfg = dataclasses.replace(tcfg, sliding_window=window)
    pool, bt, _ = decode_case(jcfg, seed=3)
    pos = np.asarray([3, 8, 0], dtype=np.int32)  # row 0 straddles pages
    tokens = np.random.default_rng(4).integers(0, 256, (3, 3)).astype(np.int32)
    want_logits, want_pool = jax_t.decode_window_paged(
        jparams, jnp.asarray(tokens), jnp.asarray(pos),
        {n: jnp.asarray(x) for n, x in pool.items()}, jnp.asarray(bt), jcfg,
    )
    logits, got_pool = torch_t.decode_window_paged(
        tparams, torch.from_numpy(tokens), torch.from_numpy(pos),
        {n: torch.from_numpy(x.copy()) for n, x in pool.items()},
        torch.from_numpy(bt), tcfg,
    )
    np.testing.assert_allclose(to_np(logits), np.asarray(want_logits),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(to_np(got_pool[name]),
                                   np.asarray(want_pool[name]),
                                   atol=KV_TOL, rtol=KV_TOL)


def test_init_params_distributions_and_dtype():
    _, tcfg = tiny_configs()
    gen = torch.Generator().manual_seed(0)
    params = torch_t.init_params(tcfg, gen, device="cpu", dtype=torch.bfloat16)
    layer = params["layers"][0]
    assert len(params["layers"]) == tcfg.n_layers
    assert all(w.dtype == torch.bfloat16 for w in layer.values())
    assert torch.equal(layer["ln1"], torch.ones(tcfg.d_model, dtype=torch.bfloat16))
    assert tuple(layer["wk"].shape) == (64, 2 * 16)
    # normal / sqrt(fan_in): the weight std is about 1/sqrt(d_in)
    std = params["embed"].float().std().item() * np.sqrt(tcfg.d_model)
    assert 0.9 < std < 1.1
    assert torch_t.n_params(params) == sum(
        np.prod(x.shape) for x in
        [params["embed"], params["ln_f"], params["lm_head"]]
        + [w for ly in params["layers"] for w in ly.values()]
    )


def test_unported_branches_raise(setup):
    _, tcfg, _, tparams = setup
    x = torch.zeros(1, 1, 64)
    with pytest.raises(NotImplementedError):
        torch_t.qeinsum("bld,dk->blk", x, {"q": None, "s": None}, torch.float32)
    with pytest.raises(NotImplementedError):
        torch_t._mlp_block(x, tparams["layers"][0],
                           dataclasses.replace(tcfg, n_experts=4))
    with pytest.raises(NotImplementedError):
        torch_t.decode_step_paged(tparams, None, None, None, None, tcfg,
                                  lora_bank={})
