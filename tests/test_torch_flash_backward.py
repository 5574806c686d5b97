"""The port's flash-attention backward against the JAX package's, on the
same numpy-seeded inputs, all f32 with D = 32 on the CPU (the JAX side runs
its Pallas kernels in interpret mode; the port its plain versions, which is
what the kernel wrappers hand CPU tensors to). Tolerance 2e-4, the JAX
backward's own oracle tolerance (tests/test_flash_attention.py:96): both
sides sum the same f32 products in different orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_parity  # noqa: F401  (one PyTorch thread per worker)

from bee_code_interpreter_tpu.ops.flash_attention import (
    _flash_bwd_pallas,
    _flash_fwd,
    flash_attention as jax_flash,
    flash_attention_with_lse as jax_flash_with_lse,
)
from bee_code_interpreter_tpu_torch.ops import flash_attention as fa

TOL = 2e-4
D = 32


def inputs(seed, B, H, KVH, Lq, Lk):
    """q, k, v, dO and a cotangent for lse, as numpy f32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Lq, D), dtype=np.float32)
    k = rng.standard_normal((B, KVH, Lk, D), dtype=np.float32)
    v = rng.standard_normal((B, KVH, Lk, D), dtype=np.float32)
    do = rng.standard_normal((B, H, Lq, D), dtype=np.float32)
    g_lse = rng.standard_normal((B, H, Lq), dtype=np.float32)
    return q, k, v, do, g_lse


def close(got, want, name):
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL, err_msg=name
    )


@pytest.mark.parametrize(
    "B,H,KVH,Lq,Lk,causal,window,with_g_lse",
    [
        (1, 2, 2, 192, 192, True, None, False),    # MHA, L past one block
        (1, 2, 2, 192, 192, False, None, False),   # MHA, full attention
        (1, 8, 2, 160, 160, True, None, False),    # GQA, 4 heads per group
        (1, 2, 2, 100, 160, False, None, False),   # Lq != Lk
        (1, 4, 2, 150, 150, True, 33, False),      # sliding window
        (2, 4, 2, 128, 128, True, None, True),     # non-zero g_lse
    ],
)
def test_plain_backward_matches_jax_pallas_backward(
    B, H, KVH, Lq, Lk, causal, window, with_g_lse
):
    q, k, v, do, g_lse = inputs(Lq + Lk, B, H, KVH, Lq, Lk)
    scale = D ** -0.5
    out, lse = _flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
        128, 128, True, window,
    )
    g = jnp.asarray(g_lse.reshape(B * H, Lq)) if with_g_lse else None
    want_dq, want_dk, want_dv = _flash_bwd_pallas(
        jnp.asarray(q.reshape(B * H, Lq, D)),
        jnp.asarray(k.reshape(B * KVH, Lk, D)),
        jnp.asarray(v.reshape(B * KVH, Lk, D)),
        out.reshape(B * H, Lq, D), lse, jnp.asarray(do.reshape(B * H, Lq, D)),
        causal, scale, 128, 128, True, H, KVH, g_lse=g, window=window,
    )
    delta = (do * np.asarray(out)).sum(-1) - (g_lse if with_g_lse else 0.0)
    args = [torch.from_numpy(x) for x in
            (q, k, v, do, np.array(lse).reshape(B, H, Lq), delta)]
    dk, dv = fa.flash_bwd_dkdv_plain(*args, causal, scale, window)
    dq = fa.flash_bwd_dq_plain(*args, causal, scale, window)
    assert dk.shape == (B, KVH, Lk, D) and dq.shape == (B, H, Lq, D)
    close(dq, np.asarray(want_dq).reshape(B, H, Lq, D), "dq")
    close(dk, np.asarray(want_dk).reshape(B, KVH, Lk, D), "dk")
    close(dv, np.asarray(want_dv).reshape(B, KVH, Lk, D), "dv")


def torch_grads(loss_of, arrays):
    ts = [torch.from_numpy(x).requires_grad_() for x in arrays]
    return torch.autograd.grad(loss_of(*ts), ts)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 21)])
def test_function_grads_match_jax_grad_of_flash_attention(causal, window):
    q, k, v, do, _ = inputs(7, 1, 8, 2, 160, 160)
    want = jax.grad(
        lambda q, k, v: jnp.sum(jax_flash(
            q, k, v, causal, None, 128, 128, True, window) * do),
        argnums=(0, 1, 2),
    )(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    dt = torch.from_numpy(do)
    got = torch_grads(
        lambda q, k, v: (fa.flash_attention(q, k, v, causal, window=window)
                         * dt).sum(),
        (q, k, v),
    )
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        close(g, w, name)


def test_function_grads_through_lse_match_jax():
    """The ``sin(lse)**2`` loss of tests/test_flash_attention.py:239: the
    lse cotangent must shift delta exactly as the JAX VJP does."""
    q, k, v, _, _ = inputs(11, 1, 4, 2, 96, 96)

    def jax_loss(q, k, v):
        out, lse = jax_flash_with_lse(q, k, v, True, interpret=True)
        return (out ** 2).sum() + (jnp.sin(lse) ** 2).sum()

    def torch_loss(q, k, v):
        out, lse = fa.flash_attention_with_lse(q, k, v, True)
        return (out ** 2).sum() + (torch.sin(lse) ** 2).sum()

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = torch_grads(torch_loss, (q, k, v))
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        close(g, w, name)


@pytest.mark.parametrize("Lq,Lk,causal,window", [(70, 70, True, None),
                                                 (40, 90, False, None),
                                                 (70, 70, True, 9)])
def test_function_matches_autograd_through_dense_forward(Lq, Lk, causal,
                                                         window):
    """An oracle independent of both backward implementations: PyTorch's
    own autograd through the dense plain forward, on a loss of both
    outputs."""
    q, k, v, do, g_lse = inputs(3, 2, 4, 2, Lq, Lk)
    dt, gt = torch.from_numpy(do), torch.from_numpy(g_lse)

    def loss(attn):
        def f(q, k, v):
            out, lse = attn(q, k, v, causal, window=window)
            return (out * dt).sum() + (lse * gt).sum()
        return f

    got = torch_grads(loss(fa.flash_attention_with_lse), (q, k, v))
    want = torch_grads(loss(fa.flash_attention_fwd_plain), (q, k, v))
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        close(g, w.numpy(), name)


def test_no_graph_without_grad():
    """Serving's weights do not require grad: no graph, no saved tensors."""
    q, k, v, _, _ = inputs(0, 1, 4, 2, 16, 16)
    out = fa.local_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert out.grad_fn is None and not out.requires_grad
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    assert fa.local_attention(*ts).grad_fn is not None


def test_no_third_path():
    """Meta tensors, and tensors split between devices, raise; the kernel
    wrappers refuse CPU tensors rather than handing them to the plain
    versions."""
    q, k, v, do, _ = (torch.from_numpy(x) for x in inputs(0, 1, 4, 2, 8, 8))
    lse = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="CPU"):
        fa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="CPU"):
        fa.flash_attention(q, k.to("meta"), v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_bwd_dkdv_cuda(q, k, v, do, lse, lse)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_bwd_dq_cuda(q, k, v, do, lse, lse)
