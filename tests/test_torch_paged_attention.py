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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_length_zero_row_gives_zero_not_nan(dtype):
    """A row whose visible length is 0 among normal rows: the JAX kernel
    returns 0 (acc / max(l, 1e-30)), and so must the port, not the NaN of a
    softmax over a row of -inf. Row 1's length 70 is past the table's
    P * ps = 64 slots."""
    q, kp, vp, bt, _ = make_case(3, B=2, nh=8, kvh=2, ps=16, P=4, n_pages=10)
    lengths = np.asarray([0, 70], dtype=np.int32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    want = np.asarray(jax_paged_decode(
        *(jnp.asarray(x, dtype=jdt) for x in (q, kp, vp)),
        jnp.asarray(bt), jnp.asarray(lengths),
    ).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = pa.paged_decode_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, kp, vp)),
        torch.from_numpy(bt), torch.from_numpy(lengths),
    ).float().numpy()
    assert np.all(want[0] == 0.0)
    assert np.all(got[0] == 0.0)
    tol = TOL if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got[1], want[1], atol=tol, rtol=tol)


# (lengths, pages_per_split, sentinel pages past each row's length): an
# empty split (the first row ends inside split 0), a length on a split
# boundary (32 = 2 splits of 2 pages of 8), length 1, lengths past P * ps,
# and -1 sentinels inside a split
SPLIT_CASES = {
    "empty_split": ([5, 40], 2, False),
    "split_boundary": ([32, 16], 2, False),
    "length_one": ([1, 1], 1, False),
    "past_capacity": ([33, 100], 3, False),
    "sentinel_pages": ([9, 20], 3, True),
    "one_split": ([17, 30], 4, False),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_merge_matches_jax_kernel(case):
    """The kernel's flash-decoding math in plain PyTorch: per-split partials
    (m, l, acc) merged in split order, against the JAX kernel (interpret
    mode) on the edge cases of a split. Tolerance 1e-5 (both f32)."""
    lens, pps, sentinel = SPLIT_CASES[case]
    q, kp, vp, bt, _ = make_case(11, B=2, nh=8, kvh=2, ps=8, P=4, n_pages=12)
    lengths = np.asarray(lens, dtype=np.int32)
    if sentinel:
        for b in range(2):
            bt[b, -(-lens[b] // 8):] = -1
    want = np.asarray(jax_paged_decode(
        *(jnp.asarray(x) for x in (q, kp, vp, bt, lengths))))
    t = [torch.from_numpy(x) for x in (q, kp, vp, bt, lengths)]
    m, l, acc = pa.paged_decode_partials_plain(*t, pages_per_split=pps)
    assert m.shape == (2, 2, -(-4 // pps), 4) and acc.shape[-1] == 128
    got = pa.merge_split_partials(m, l, acc).reshape(2, 8, 128).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, pa.paged_decode_attention(*t).numpy(),
                               atol=TOL, rtol=TOL)


def test_merge_of_empty_splits_is_zero_and_ignores_their_acc():
    """Splits with m = -inf weigh nothing, whatever their (unwritten) acc
    holds; a row whose splits are all empty merges to 0."""
    m = torch.tensor([[[[-float("inf")], [1.0]]], [[[-float("inf")], [-float("inf")]]]])
    l = torch.tensor([[[[0.0], [2.0]]], [[[0.0], [0.0]]]])
    acc = torch.full((2, 1, 2, 1, 4), float("nan"))
    acc[0, 0, 1, 0] = 4.0
    out = pa.merge_split_partials(m, l, acc)
    assert torch.equal(out[0, 0, 0], torch.full((4,), 2.0))
    assert torch.equal(out[1, 0, 0], torch.zeros(4))


def test_split_choice_reads_shapes_only():
    """One split once B * kvh blocks fill the card; enough splits for about
    two blocks per SM below that, none shorter than MIN_SPLIT_TOKENS (128)."""
    assert pa.split_pages(32, 8, 128, 16, sms=132) == 128  # 256 blocks
    pps = pa.split_pages(8, 8, 128, 16, sms=132)  # the serving decode
    assert 1 < -(-128 // pps) and 8 * 8 * -(-128 // pps) >= 2 * 132
    assert pa.split_pages(1, 8, 128, 16, sms=132) * 16 >= pa.MIN_SPLIT_TOKENS
    assert pa.split_pages(1, 8, 2, 16, sms=132) == 2  # 32 slots: one split
    # a 4096-slot table at B=1: 32 splits, past the merge kernel's 16 a pass
    assert -(-256 // pa.split_pages(1, 8, 256, 16, sms=132)) == 32


def test_pool_alignment_check():
    """What the kernel's bulk copies demand of a pool, checked by the
    wrapper: a dense tensor on a 16-byte boundary; anything else raises."""
    base = torch.zeros(4, 2, 8, 128, dtype=torch.bfloat16)
    pa.check_pool_alignment("k_pages", base)
    shifted = base.flatten()[1:1 + 3 * 2 * 8 * 128].view(3, 2, 8, 128)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte boundary"):
        pa.check_pool_alignment("k_pages", shifted)
    with pytest.raises(ValueError, match="contiguous"):
        pa.check_pool_alignment("v_pages", base.transpose(2, 3))


@pytest.mark.parametrize("dh", [16, 80, 256])
@pytest.mark.parametrize("rep", [1, 16, 48])
def test_plain_matches_jax_kernel_at_every_head_dim_and_group(dh, rep):
    """K2's plain version against JAX's Pallas kernel (interpret mode) at
    head dims other than 128 and groups past 8 query heads a KV head (JAX
    pads its group to the sublane tile, paged_attention.py:117): 48 is
    StarCoder's 48 heads over one KV head."""
    kvh = 1 if rep == 48 else 2
    got, want = both(*make_case(dh + rep, B=2, nh=rep * kvh, kvh=kvh, ps=8,
                                P=3, n_pages=10, dh=dh))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dh,rep,entry", [
    (128, 1, "bci_paged_decode"), (128, 8, "bci_paged_decode"),
    (128, 9, "bci_paged_decode_any"), (128, 48, "bci_paged_decode_any"),
    (16, 1, "bci_paged_decode_any"), (80, 8, "bci_paged_decode_any"),
    (256, 16, "bci_paged_decode_any"), (1, 1, "bci_paged_decode_any"),
])
def test_kernel_entry_by_head_dim_and_group(dh, rep, entry):
    """The wrapper's C entry point: the bulk-copy / tensor-core kernels at
    dh 128 with at most 8 query heads a KV head, the kernel for any shape
    otherwise; on the CPU the same inputs launch nothing."""
    assert pa.kernel_entry(dh, rep) == entry
    assert set(pa.PAGED_DECODE.signatures) == {"bci_paged_decode",
                                               "bci_paged_decode_any"}
    got, want = both(*make_case(dh, B=2, nh=rep, kvh=1, ps=8, P=2, n_pages=6,
                                dh=dh))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert pa.PAGED_DECODE.launches == 0


def test_head_dims_past_the_kernel_raise():
    for dh in (0, 257, 512):
        with pytest.raises(ValueError, match="1..256"):
            pa.kernel_entry(dh, 1)
