"""The port's flash-attention forward (plain version, what the CPU runs)
against the JAX package's Pallas flash forward in interpret mode: out and
lse to 1e-5 (both f32; only the summation order differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_parity  # noqa: F401  (one PyTorch thread per worker)

from bee_code_interpreter_tpu.ops.flash_attention import (
    flash_attention_with_lse as jax_flash_with_lse,
)
from bee_code_interpreter_tpu_torch.ops import flash_attention as fa

TOL = 1e-5


def make_qkv(seed, B, H, KVH, L, D=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, L, D), dtype=np.float32)
    k = rng.standard_normal((B, KVH, L, D), dtype=np.float32)
    v = rng.standard_normal((B, KVH, L, D), dtype=np.float32)
    return q, k, v


@pytest.mark.parametrize(
    "B,H,KVH,L,causal,window",
    [
        (2, 4, 4, 64, True, None),     # H/KVH = 1
        (1, 4, 2, 200, True, None),    # H/KVH = 2, L not a multiple of 128
        (2, 8, 2, 130, False, None),   # H/KVH = 4, full attention
        (1, 8, 2, 150, True, 33),      # sliding window
        (1, 4, 1, 96, True, 1),        # window of one: each row sees itself
    ],
)
def test_plain_forward_matches_jax_flash(B, H, KVH, L, causal, window):
    q, k, v = make_qkv(L, B, H, KVH, L)
    want_out, want_lse = jax_flash_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
        interpret=True, window=window,
    )
    got_out, got_lse = fa.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, window=window,
    )
    assert got_out.dtype == torch.float32 and got_lse.shape == (B, H, L)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=TOL, rtol=TOL)


def test_local_attention_is_the_forward_output_in_input_dtype():
    q, k, v = make_qkv(3, 1, 4, 2, 40)
    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out = fa.local_attention(qt, kt, vt, causal=True)
    ref, _ = fa.flash_attention_fwd_plain(qt, kt, vt, True)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, ref)


def test_validation():
    q, k, v = (torch.from_numpy(x) for x in make_qkv(0, 1, 4, 2, 8))
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention_with_lse(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match=">= 1"):
        fa.flash_attention_with_lse(q, k, v, window=0)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_with_lse(q, k[:, :1].repeat(1, 3, 1, 1),
                                    v[:, :1].repeat(1, 3, 1, 1))


@pytest.mark.parametrize("kernel", ["flash", "flash_bwd_dkdv", "flash_bwd_dq"])
def test_tma_operand_check(kernel):
    """What the TMA maps of K1, K3 and K4 demand, checked by the wrapper: a
    dense tensor on a 16-byte boundary; anything else raises."""
    base = torch.zeros(1, 4, 16, 128, dtype=torch.bfloat16)
    fa.check_tma_operand(kernel, "q", base)
    # one bf16 past an aligned start: contiguous, 2 bytes off the boundary
    shifted = base.flatten()[1:1 + 4 * 15 * 128].view(1, 4, 15, 128)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa.check_tma_operand(kernel, "q", shifted)
    with pytest.raises(ValueError, match="contiguous"):
        fa.check_tma_operand(kernel, "k", base.transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        fa.check_tma_operand(kernel, "v", base[..., ::2])


def test_cpu_dispatch_does_not_apply_the_tma_check():
    """CPU tensors still go to the plain versions, whatever their layout:
    the TMA demands belong to the kernels alone."""
    q, k, v = (torch.from_numpy(x) for x in make_qkv(5, 1, 4, 2, 24))
    qt = q.transpose(2, 3).contiguous().transpose(2, 3)  # same values, strided
    assert not qt.is_contiguous()
    out, lse = fa.flash_attention_with_lse(qt, k, v, True)
    ref_out, ref_lse = fa.flash_attention_fwd_plain(q, k, v, True)
    assert torch.allclose(out, ref_out) and torch.allclose(lse, ref_lse)


def test_no_third_path():
    """Tensors that are neither all-CUDA nor all-CPU raise: the plain
    version runs only because its inputs lie on the CPU."""
    q, k, v = (torch.from_numpy(x) for x in make_qkv(0, 1, 4, 2, 8))
    with pytest.raises(ValueError, match="CPU"):
        fa.flash_attention_with_lse(q.to("meta"), k.to("meta"), v.to("meta"))
