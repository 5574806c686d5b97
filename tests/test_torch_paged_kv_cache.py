"""The port's paged KV cache against the JAX package's: append, read and
prefill seeding must give exactly the JAX arrays on identical inputs (they
move values, they compute nothing), and pool telemetry identical dicts. The
port writes the pool in place where JAX returns a new one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bee_code_interpreter_tpu.ops import paged_kv_cache as jax_pkv
from bee_code_interpreter_tpu_torch.ops import paged_kv_cache as pkv

from tests.torch_parity import tiny_configs

N_PAGES, PS, KVH, DH = 10, 4, 2, 16


def pool(seed):
    rng = np.random.default_rng(seed)
    shape = (N_PAGES, KVH, PS, DH)
    return {name: rng.standard_normal(shape, dtype=np.float32)
            for name in ("k", "v")}


def test_paged_append_equals_jax():
    rng = np.random.default_rng(1)
    layer = pool(0)
    B, W = 3, 3
    k_new = rng.standard_normal((B, W, KVH, DH), dtype=np.float32)
    v_new = rng.standard_normal((B, W, KVH, DH), dtype=np.float32)
    # distinct (page, slot)s, one row straddling a page boundary
    page_idx = np.asarray([[3, 3, 3], [7, 7, 5], [1, 1, 1]], dtype=np.int32)
    slot_idx = np.asarray([[0, 1, 2], [2, 3, 0], [1, 2, 3]], dtype=np.int32)
    want = jax_pkv.paged_append(
        {n: jnp.asarray(x) for n, x in layer.items()},
        jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(page_idx), jnp.asarray(slot_idx),
    )
    mine = {n: torch.from_numpy(x.copy()) for n, x in layer.items()}
    got = pkv.paged_append(
        mine, torch.from_numpy(k_new), torch.from_numpy(v_new),
        torch.from_numpy(page_idx), torch.from_numpy(slot_idx),
    )
    assert got is mine  # in place
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_read_equals_jax(dtype):
    layer = pool(2)
    bt = np.random.default_rng(3).permutation(N_PAGES)[:6].reshape(2, 3)
    bt = bt.astype(np.int32)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    wk, wv = jax_pkv.paged_read(
        {n: jnp.asarray(x) for n, x in layer.items()}, jnp.asarray(bt), jdtype
    )
    gk, gv = pkv.paged_read(
        {n: torch.from_numpy(x) for n, x in layer.items()},
        torch.from_numpy(bt), dtype,
    )
    assert gk.dtype == torch.float32 and gv.dtype == dtype
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(
        gv.float().numpy(), np.asarray(wv).astype(np.float32)
    )


@pytest.mark.parametrize("L", [5, 8])  # ragged last page, whole pages
def test_seed_prefill_equals_jax(L):
    rng = np.random.default_rng(L)
    n_layers = 2
    full = {name: rng.standard_normal((n_layers, N_PAGES, KVH, PS, DH),
                                      dtype=np.float32) for name in ("k", "v")}
    k_pre = rng.standard_normal((n_layers, KVH, L, DH), dtype=np.float32)
    v_pre = rng.standard_normal((n_layers, KVH, L, DH), dtype=np.float32)
    pages = np.asarray([6, 2], dtype=np.int32)
    want = jax_pkv.seed_prefill(
        {n: jnp.asarray(x) for n, x in full.items()}, jnp.asarray(pages),
        jnp.asarray(k_pre), jnp.asarray(v_pre),
    )
    got = pkv.seed_prefill(
        {n: torch.from_numpy(x.copy()) for n, x in full.items()},
        torch.from_numpy(pages), torch.from_numpy(k_pre),
        torch.from_numpy(v_pre),
    )
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    with pytest.raises(ValueError, match="exceeds"):
        pkv.seed_prefill(got, torch.from_numpy(pages[:1]),
                         torch.from_numpy(k_pre), torch.from_numpy(v_pre))


def test_pool_telemetry_identical_dicts():
    rng = np.random.default_rng(4)
    state = dict(
        block_table=np.asarray([[3, 4, 0], [0, 0, 0], [5, 0, 0]], np.int32),
        pos=np.asarray([9, 0, 2], np.int32),
        active=np.asarray([True, False, True]),
        page_ref=rng.integers(0, 3, size=N_PAGES).astype(np.int32),
        page_size=PS, free_pages=4, parked_pages=1,
    )
    assert pkv.pool_telemetry(**state) == jax_pkv.pool_telemetry(**state)
    idle = {**state, "active": np.zeros(3, dtype=bool)}
    assert pkv.pool_telemetry(**idle) == jax_pkv.pool_telemetry(**idle)


def test_alloc_matches_jax_layout_and_refuses_int8():
    """The bf16/f32 pool and the int8 pool (int8 values, f32 scale planes),
    which earlier slices refused, in the JAX package's layout."""
    for kv in ("bf16", "int8"):
        jcfg, tcfg = tiny_configs(kv_cache_dtype=kv)
        want = jax_pkv.alloc_paged_cache(jcfg, 5, 4)
        got = pkv.alloc_paged_cache(tcfg, 5, 4, "cpu")
        assert set(got) == set(want)
        for name, leaf in got.items():
            assert tuple(leaf.shape) == want[name].shape
            assert str(leaf.dtype).removeprefix("torch.") == str(want[name].dtype)
            assert not leaf.any()
