"""The port's int8 KV caches against the JAX package's on identical inputs:
``ops/kv_cache.py`` (quantize, dequantize, the contiguous append and read)
and the int8 layout of ``ops/paged_kv_cache.py`` (alloc, append, read,
seed_prefill, seed_from_contiguous). These move and round values in the
same f32 order of operations as JAX: int8 values must agree bitwise, and
scales and dequantized values to 1e-7 relative (they agree bitwise here)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bee_code_interpreter_tpu.ops import kv_cache as jax_kv
from bee_code_interpreter_tpu.ops import paged_kv_cache as jax_pkv
from bee_code_interpreter_tpu_torch.ops import kv_cache as kv
from bee_code_interpreter_tpu_torch.ops import paged_kv_cache as pkv

from tests.torch_parity import tiny_configs, to_np

SCALE_TOL = 1e-7
N_PAGES, PS, KVH, DH = 10, 4, 2, 16


def rows(seed, shape):
    """Random rows with a zero row and a row of exact rounding ties."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.0
    flat[1] = 0.0
    flat[1, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]  # scale 1: half to even
    return x


def assert_leaves_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for name, x in got.items():
        w = np.asarray(want[name])
        if name in ("k", "v") and w.dtype == np.int8:
            assert x.dtype == torch.int8
            np.testing.assert_array_equal(to_np(x), w)
        else:
            np.testing.assert_allclose(to_np(x.float()), w.astype(np.float32),
                                       rtol=SCALE_TOL, atol=0)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_and_dequantize_equal_jax(dtype):
    x = rows(0, (3, 5, 7, DH))
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x)
    if dtype == "bfloat16":
        tx = tx.to(torch.bfloat16)
    jq, js = jax_kv.quantize(jx)
    q, s = kv.quantize(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == js.shape == (3, 5, 7, 1)
    np.testing.assert_array_equal(to_np(q), np.asarray(jq))
    np.testing.assert_allclose(to_np(s), np.asarray(js), rtol=SCALE_TOL, atol=0)
    assert to_np(q)[0, 0, 1, :6].tolist() == [127, 0, 2, 2, 0, -2]
    assert not q[0, 0, 0].any() and s[0, 0, 0].item() == 0.0  # zero row
    for out in (torch.float32, torch.bfloat16):
        jout = jnp.float32 if out == torch.float32 else jnp.bfloat16
        want = np.asarray(jax_kv.dequantize(jq, js, jout).astype(jnp.float32))
        np.testing.assert_allclose(to_np(kv.dequantize(q, s, out).float()),
                                   want, rtol=SCALE_TOL, atol=0)


def contiguous_cache(kv_dtype, seed, shape=(2, 3, KVH, 12, DH)):
    """The same contiguous cache in both frameworks, as (JAX, port)."""
    if kv_dtype == "int8":
        q, s = jax_kv.quantize(jnp.asarray(rows(seed, shape)))
        leaves = {"k": q, "v": q, "k_s": s, "v_s": s}
    else:
        x = jnp.asarray(rows(seed, shape))
        leaves = {"k": x, "v": -x}
    return leaves, {n: torch.from_numpy(np.array(x)) for n, x in leaves.items()}


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_cache_append_and_read_equal_jax(kv_dtype):
    jc, tc = contiguous_cache(kv_dtype, 1)
    new = rows(2, (2, 3, KVH, 4, DH))
    k_new, v_new = new, new * 0.5
    # pos 10 runs past the 12 slots: dynamic_update_slice moves it to 8
    for pos in (0, 5, 10):
        jc = jax_kv.cache_append(jc, jnp.asarray(k_new), jnp.asarray(v_new), pos)
        got = kv.cache_append(tc, torch.from_numpy(k_new),
                              torch.from_numpy(v_new), pos)
        assert got is tc  # in place
        assert_leaves_equal(tc, jc)
    for out in (torch.float32, torch.bfloat16):
        jout = jnp.float32 if out == torch.float32 else jnp.bfloat16
        wk, wv = jax_kv.cache_read(jc, jout)
        gk, gv = kv.cache_read(tc, out)
        # the plain layout's V is the stored tensor, as in JAX
        assert gk.dtype == torch.float32
        assert gv.dtype == (out if kv_dtype == "int8" else tc["v"].dtype)
        np.testing.assert_allclose(to_np(gk), np.asarray(wk), rtol=SCALE_TOL, atol=0)
        np.testing.assert_allclose(to_np(gv.float()),
                                   np.asarray(wv.astype(jnp.float32)),
                                   rtol=SCALE_TOL, atol=0)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_window_append_is_bitwise_w_single_appends(kv_dtype):
    _, window = contiguous_cache(kv_dtype, 3)
    _, single = contiguous_cache(kv_dtype, 3)
    new = torch.from_numpy(rows(4, (2, 3, KVH, 5, DH)))
    kv.cache_append(window, new, -new, 2)
    for w in range(5):
        kv.cache_append(single, new[..., w:w + 1, :], -new[..., w:w + 1, :],
                        2 + w)
    for name in window:
        assert torch.equal(window[name], single[name])


def int8_pool(seed):
    """One layer's int8 pool views ``[n_pages, kvh, ps, ·]`` as (JAX,
    port), with non-zero contents."""
    q, s = jax_kv.quantize(jnp.asarray(rows(seed, (N_PAGES, KVH, PS, DH))))
    leaves = {"k": q, "v": -q, "k_s": s, "v_s": 2 * s}
    return leaves, {n: torch.from_numpy(np.array(x)) for n, x in leaves.items()}


def test_int8_alloc_matches_jax():
    jcfg, tcfg = tiny_configs(kv_cache_dtype="int8")
    want = jax_pkv.alloc_paged_cache(jcfg, N_PAGES, PS)
    got = pkv.alloc_paged_cache(tcfg, N_PAGES, PS, "cpu")
    assert_leaves_equal(got, want)
    assert tuple(got["k_s"].shape) == (2, N_PAGES, KVH, PS, 1)


def test_int8_paged_append_equals_jax():
    jl, tl = int8_pool(5)
    B, W = 3, 3
    new = rows(6, (B, W, KVH, DH))
    page_idx = np.asarray([[3, 3, 3], [7, 7, 5], [1, 1, 1]], dtype=np.int32)
    slot_idx = np.asarray([[0, 1, 2], [2, 3, 0], [1, 2, 3]], dtype=np.int32)
    want = jax_pkv.paged_append(jl, jnp.asarray(new), jnp.asarray(-new),
                                jnp.asarray(page_idx), jnp.asarray(slot_idx))
    got = pkv.paged_append(tl, torch.from_numpy(new), torch.from_numpy(-new),
                           torch.from_numpy(page_idx), torch.from_numpy(slot_idx))
    assert got is tl
    assert_leaves_equal(got, want)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_paged_append_drops_invalid_tokens(kv_dtype):
    """A token marked invalid (its position past the block table) leaves
    its (page, slot) as it was, as JAX's scatter drops it; the valid ones
    are written as without the mask."""
    if kv_dtype == "int8":
        _, tl = int8_pool(7)
    else:
        tl = {n: torch.from_numpy(rows(7 + i, (N_PAGES, KVH, PS, DH)))
              for i, n in enumerate(("k", "v"))}
    before = {n: x.clone() for n, x in tl.items()}
    plain = {n: x.clone() for n, x in tl.items()}
    new = torch.from_numpy(rows(8, (2, 2, KVH, DH)))
    page_idx = torch.tensor([[4, 4], [6, 6]])
    slot_idx = torch.tensor([[2, 3], [0, 1]])
    valid = torch.tensor([[True, False], [False, False]])
    pkv.paged_append(tl, new, -new, page_idx, slot_idx, valid=valid)
    pkv.paged_append(plain, new[:1, :1], -new[:1, :1], page_idx[:1, :1],
                     slot_idx[:1, :1])
    for name in tl:
        assert torch.equal(tl[name], plain[name])
        assert torch.equal(tl[name][6], before[name][6])
        assert torch.equal(tl[name][4, :, 3], before[name][4, :, 3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_paged_read_equals_jax(dtype):
    jl, tl = int8_pool(9)
    bt = np.random.default_rng(3).permutation(N_PAGES)[:6].reshape(2, 3)
    bt = bt.astype(np.int32)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    wk, wv = jax_pkv.paged_read(jl, jnp.asarray(bt), jdtype)
    gk, gv = pkv.paged_read(tl, torch.from_numpy(bt), dtype)
    assert gk.dtype == torch.float32 and gv.dtype == dtype
    np.testing.assert_allclose(to_np(gk), np.asarray(wk), rtol=SCALE_TOL, atol=0)
    np.testing.assert_allclose(to_np(gv.float()),
                               np.asarray(wv.astype(jnp.float32)),
                               rtol=SCALE_TOL, atol=0)


@pytest.mark.parametrize("L", [5, 8])  # ragged last page, whole pages
def test_int8_seed_prefill_equals_jax(L):
    jcfg, tcfg = tiny_configs(kv_cache_dtype="int8")
    jpool = jax_pkv.alloc_paged_cache(jcfg, N_PAGES, PS)
    tpool = pkv.alloc_paged_cache(tcfg, N_PAGES, PS, "cpu")
    k_pre = rows(L, (2, KVH, L, DH))
    v_pre = rows(L + 1, (2, KVH, L, DH))
    pages = np.asarray([6, 2], dtype=np.int32)
    want = jax_pkv.seed_prefill(jpool, jnp.asarray(pages), jnp.asarray(k_pre),
                                jnp.asarray(v_pre))
    got = pkv.seed_prefill(tpool, torch.from_numpy(pages),
                           torch.from_numpy(k_pre), torch.from_numpy(v_pre))
    assert_leaves_equal(got, want)
    # the pad tail past L quantized to exact zeros with scale 0
    if L % PS:
        tail = got["k_s"][:, 2, :, L % PS:]
        assert not tail.any() and not got["k"][:, 2, :, L % PS:].any()


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_seed_from_contiguous_equals_jax(kv_dtype):
    """A contiguous row copied into pages verbatim: int8 values and scales
    are not quantized again."""
    jcfg, tcfg = tiny_configs(
        kv_cache_dtype="int8" if kv_dtype == "int8" else "bf16"
    )
    jpool = jax_pkv.alloc_paged_cache(jcfg, N_PAGES, PS)
    tpool = pkv.alloc_paged_cache(tcfg, N_PAGES, PS, "cpu")
    x = rows(11, (2, KVH, 3 * PS, DH))
    if kv_dtype == "int8":
        q, s = jax_kv.quantize(jnp.asarray(x))
        row = {"k": q, "v": -q, "k_s": s, "v_s": s}
    else:
        row = {"k": jnp.asarray(x), "v": jnp.asarray(-x)}
    pages = np.asarray([5, 1, 8], dtype=np.int32)
    want = jax_pkv.seed_from_contiguous(jpool, jnp.asarray(pages), row)
    got = pkv.seed_from_contiguous(
        tpool, torch.from_numpy(pages),
        {n: torch.from_numpy(np.array(v)) for n, v in row.items()},
    )
    assert got is tpool
    assert_leaves_equal(got, want)
    with pytest.raises(ValueError, match="contiguous length"):
        pkv.seed_from_contiguous(tpool, torch.from_numpy(pages[:2]),
                                 {n: torch.from_numpy(np.array(v))
                                  for n, v in row.items()})
