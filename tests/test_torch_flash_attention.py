"""The port's flash-attention forward (plain version, what the CPU runs)
against the JAX package's Pallas flash forward in interpret mode: out and
lse to 1e-5 (both f32; only the summation order differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_parity  # noqa: F401  (one PyTorch thread per worker)

from bee_code_interpreter_tpu.ops.flash_attention import (
    _flash_bwd_pallas,
    _flash_fwd,
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


# (dtype, head dim) -> the route, the instance's width and the width the
# wrappers hand it: the bf16 tensor-core instances (D = 64, 128 and 256)
# read a head dim that is a multiple of 8 in place and take any other
# zero-padded to their width; the CUDA-core kernel takes f32 at every head dim
ROUTES = [
    (torch.bfloat16, 1, "tensor_core", 64, 64),
    (torch.bfloat16, 16, "tensor_core", 64, 16),
    (torch.bfloat16, 20, "tensor_core", 64, 64),
    (torch.bfloat16, 64, "tensor_core", 64, 64),
    (torch.bfloat16, 72, "tensor_core", 128, 72),
    (torch.bfloat16, 80, "tensor_core", 128, 80),
    (torch.bfloat16, 100, "tensor_core", 128, 128),
    (torch.bfloat16, 128, "tensor_core", 128, 128),
    (torch.bfloat16, 129, "tensor_core", 256, 256),
    (torch.bfloat16, 200, "tensor_core", 256, 200),
    (torch.bfloat16, 256, "tensor_core", 256, 256),
    (torch.float32, 16, "simt", 16, 16),
    (torch.float32, 20, "simt", 20, 20),
    (torch.float32, 128, "simt", 128, 128),
    (torch.float32, 256, "simt", 256, 256),
]


@pytest.mark.parametrize("dtype,D,route,width,cols", ROUTES)
def test_kernel_head_dims_pick_their_entry_points(dtype, D, route, width,
                                                  cols):
    """K1, K3 and K4 each export one C entry point per tensor-core instance
    (bf16 at D = 64, 128 and 256) and one CUDA-core entry point (f32 at
    every head dim), all taking the head dim after the window; the wrappers
    route by dtype and ``q.shape[3]``, padding a bf16 head dim that is no
    multiple of 8 up to its instance's width. On the CPU the same inputs,
    forward and backward, launch nothing."""
    assert fa.KERNEL_HEAD_DIMS == (64, 128, 256)
    assert fa.MAX_HEAD_DIM == 256
    assert fa.kernel_route(dtype, D) == (route, width)
    assert fa.pad_width(dtype, D) == cols
    for kernel, base in ((fa.FLASH_FWD, "bci_flash_fwd"),
                         (fa.FLASH_BWD_DKDV, "bci_flash_bwd_dkdv"),
                         (fa.FLASH_BWD_DQ, "bci_flash_bwd_dq")):
        assert set(kernel.signatures) == {
            f"{base}_bf16", f"{base}_bf16_d64", f"{base}_bf16_d256",
            f"{base}_simt"}
        assert len({tuple(a) for a in kernel.signatures.values()}) == 1
        assert fa._entry(f"{base}_bf16", 128) == f"{base}_bf16"
        assert fa._entry(f"{base}_bf16", 64) == f"{base}_bf16_d64"
        assert fa._entry(f"{base}_bf16", 256) == f"{base}_bf16_d256"
    q, k, v = (torch.from_numpy(x).to(dtype).requires_grad_()
               for x in make_qkv(D, 1, 2, 1, 20, D=D))
    out, lse = fa.flash_attention_with_lse(q, k, v, True)
    (out.float().sum() + lse.sum()).backward()
    assert out.shape == q.shape and q.grad.shape == q.shape
    for kernel in (fa.FLASH_FWD, fa.FLASH_BWD_DKDV, fa.FLASH_BWD_DQ):
        assert kernel.launches == 0  # nothing launched on the CPU


@pytest.mark.parametrize("D", [0, 257, 512])
def test_head_dims_past_the_kernels_raise(D):
    """Only D outside 1..256 has no kernel: the route raises naming the
    limit, in both dtypes."""
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="1..256"):
            fa.kernel_route(dtype, D)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fa.kernel_route(torch.float16, 64)


@pytest.mark.parametrize("D", [16, 20, 80, 200])
def test_zero_padded_head_dim_is_exact(D):
    """The pad the wrappers apply before a tensor-core instance: Q, K and V
    with zero columns up to the instance's width and the true D ** -0.5 as
    the scale give the same out and lse, and the extra columns of out are
    zeros."""
    q, k, v = (torch.from_numpy(x) for x in make_qkv(D, 1, 4, 2, 50, D=D))
    width = fa.kernel_route(torch.bfloat16, D)[1]
    padded = [fa.pad_head_dim(t, width) for t in (q, k, v)]
    assert all(t.shape[-1] == width and t.is_contiguous() for t in padded)
    assert fa.pad_head_dim(padded[0], width) is padded[0]
    out, lse = fa.flash_attention_fwd_plain(*padded, True, D ** -0.5)
    want_out, want_lse = fa.flash_attention_fwd_plain(q, k, v, True)
    torch.testing.assert_close(out[..., :D], want_out, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lse, want_lse, atol=1e-6, rtol=1e-6)
    assert torch.equal(out[..., D:], torch.zeros_like(out[..., D:]))


# the head dims JAX's kernels take that the D = 64 / 128 instances alone do
# not: the tiny config's 16, a D that is no multiple of 8, Phi-2's 80, and
# Gemma-2B's 256
HEAD_DIMS = [16, 20, 32, 72, 80, 96, 256]


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_plain_forward_at_every_head_dim_matches_jax_flash(D):
    """K1's plain version against JAX's Pallas forward (interpret mode) at
    each head dim: causal, GQA, L ragged."""
    q, k, v = make_qkv(D + 1, 1, 4, 2, 70, D=D)
    want_out, want_lse = jax_flash_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, interpret=True)
    got_out, got_lse = fa.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), True)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_plain_backward_at_every_head_dim_matches_jax_pallas(D):
    """K3's and K4's plain versions against JAX's Pallas backward
    (``_flash_bwd_pallas``, interpret mode) at each head dim, on JAX's own
    out and lse: causal, GQA, L ragged, a non-zero g_lse."""
    B, H, KVH, L = 1, 4, 2, 70
    q, k, v = make_qkv(D + 2, B, H, KVH, L, D=D)
    rng = np.random.default_rng(D)
    do = rng.standard_normal((B, H, L, D), dtype=np.float32)
    g_lse = rng.standard_normal((B, H, L), dtype=np.float32)
    scale = D ** -0.5
    out, lse = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          True, scale, 128, 128, True, None)
    want = _flash_bwd_pallas(
        jnp.asarray(q.reshape(B * H, L, D)), jnp.asarray(k.reshape(B * KVH, L, D)),
        jnp.asarray(v.reshape(B * KVH, L, D)), out.reshape(B * H, L, D), lse,
        jnp.asarray(do.reshape(B * H, L, D)), True, scale, 128, 128, True, H,
        KVH, g_lse=jnp.asarray(g_lse.reshape(B * H, L)))
    delta = (do * np.asarray(out)).sum(-1) - g_lse
    args = [torch.from_numpy(x) for x in
            (q, k, v, do, np.array(lse).reshape(B, H, L), delta)]
    dk, dv = fa.flash_bwd_dkdv_plain(*args, True, scale)
    dq = fa.flash_bwd_dq_plain(*args, True, scale)
    for name, got, w, shape in (("dq", dq, want[0], (B, H, L, D)),
                                ("dk", dk, want[1], (B, KVH, L, D)),
                                ("dv", dv, want[2], (B, KVH, L, D))):
        w = np.asarray(w).reshape(shape)
        np.testing.assert_allclose(got.numpy(), w, rtol=TOL,
                                   atol=TOL * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("D", [64, 128])
def test_plain_forward_at_the_kernel_head_dims_matches_jax_flash(D):
    """The plain versions the kernels are held against, at both head dims
    (the ViT's 64, the decoder's 128), against JAX's Pallas flash kernel
    in interpret mode: non-causal, one head a group, L ragged."""
    q, k, v = make_qkv(D, 2, 4, 4, 37, D=D)
    want_out, want_lse = jax_flash_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), False,
        interpret=True)
    got_out, got_lse = fa.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), False)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=TOL, rtol=TOL)
