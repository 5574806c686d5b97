"""The port's paged decode attention (plain version, what the CPU runs)
against the JAX package's Pallas paged-attention kernel, which runs in
interpret mode off-TPU: permuted block tables, -1 sentinels and poisoned
slots past each row's length, as tests/test_paged_attention.py does for the
JAX kernel. Tolerance 1e-5 (both f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_parity  # noqa: F401  (one PyTorch thread per worker)

from bee_code_interpreter_tpu.ops.paged_attention import (
    paged_decode_attention as jax_paged_decode,
)
from bee_code_interpreter_tpu_torch.ops import paged_attention as pa

TOL = 1e-5


def make_case(seed, B, nh, kvh, ps, P, n_pages, dh=128):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, nh, dh), dtype=np.float32)
    k_pages = rng.standard_normal((n_pages, kvh, ps, dh), dtype=np.float32)
    v_pages = rng.standard_normal((n_pages, kvh, ps, dh), dtype=np.float32)
    bt = rng.permutation(n_pages)[: B * P].reshape(B, P).astype(np.int32)
    lengths = rng.integers(1, P * ps + 1, size=B).astype(np.int32)
    return q, k_pages, v_pages, bt, lengths


def both(q, kp, vp, bt, lengths):
    want = jax_paged_decode(*(jnp.asarray(x) for x in (q, kp, vp, bt, lengths)))
    got = pa.paged_decode_attention(
        *(torch.from_numpy(x) for x in (q, kp, vp, bt, lengths))
    )
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("nh,kvh", [(8, 2), (4, 4), (16, 2), (24, 2)])
def test_plain_matches_jax_kernel_gqa_shapes(nh, kvh):
    got, want = both(*make_case(0, B=3, nh=nh, kvh=kvh, ps=16, P=4, n_pages=20))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_poisoned_slots_past_length_do_not_matter():
    q, kp, vp, bt, _ = make_case(2, B=2, nh=4, kvh=2, ps=8, P=4, n_pages=16)
    lengths = np.asarray([5, 19], dtype=np.int32)
    base, want = both(q, kp, vp, bt, lengths)
    np.testing.assert_allclose(base, want, atol=TOL, rtol=TOL)
    kp2, vp2 = kp.copy(), vp.copy()
    for b in range(2):
        for logical in range(int(lengths[b]), 4 * 8):
            page, slot = bt[b, logical // 8], logical % 8
            kp2[page, :, slot] = 1e4
            vp2[page, :, slot] = -1e4
    poisoned, _ = both(q, kp2, vp2, bt, lengths)
    np.testing.assert_allclose(poisoned, base, atol=TOL, rtol=TOL)


def test_sentinel_block_table_entries_are_harmless():
    q, kp, vp, bt, _ = make_case(7, B=2, nh=4, kvh=2, ps=8, P=4, n_pages=16)
    lengths = np.asarray([5, 9], dtype=np.int32)  # rows use 1 / 2 pages
    base, want = both(q, kp, vp, bt, lengths)
    bt_sent = bt.copy()
    bt_sent[0, 1:] = -1
    bt_sent[1, 2:] = -1
    got, want_sent = both(q, kp, vp, bt_sent, lengths)
    np.testing.assert_allclose(got, base, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, want_sent, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(base, want, atol=TOL, rtol=TOL)


def test_bf16_output_dtype():
    q, kp, vp, bt, lengths = make_case(1, B=2, nh=8, kvh=2, ps=8, P=3, n_pages=12)
    args = [torch.from_numpy(x) for x in (q, kp, vp)]
    args = [a.to(torch.bfloat16) for a in args]
    out = pa.paged_decode_attention(
        *args, torch.from_numpy(bt), torch.from_numpy(lengths)
    )
    ref = pa.paged_decode_attention_plain(
        *(a.float() for a in args), torch.from_numpy(bt),
        torch.from_numpy(lengths),
    )
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(),
                               atol=3e-2, rtol=3e-2)


def test_validation_and_no_third_path():
    with pytest.raises(ValueError, match="multiple"):
        pa.paged_decode_attention(
            torch.zeros(1, 3, 128), torch.zeros(4, 2, 8, 128),
            torch.zeros(4, 2, 8, 128), torch.zeros(1, 2, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32),
        )
    with pytest.raises(ValueError, match="CPU"):
        pa.paged_decode_attention(
            torch.zeros(1, 4, 128, device="meta"),
            torch.zeros(4, 2, 8, 128, device="meta"),
            torch.zeros(4, 2, 8, 128, device="meta"),
            torch.zeros(1, 2, dtype=torch.int32, device="meta"),
            torch.ones(1, dtype=torch.int32, device="meta"),
        )
