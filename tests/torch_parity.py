"""Shared set-up for the PyTorch-port parity tests (tests/test_torch_*.py).

Both frameworks get the same inputs: weights come from the JAX package's
``init_params`` and cross into the port through ``params_from_jax``; every
other input is made with numpy from a seed. Everything runs on the CPU: JAX
as its own tests run it (Pallas kernels in interpret mode), the port through
the plain PyTorch versions of its kernels.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bee_code_interpreter_tpu.models import transformer as jax_t
from bee_code_interpreter_tpu_torch.models import transformer as torch_t
from bee_code_interpreter_tpu_torch.weights import params_from_jax

# The suite runs several pytest workers side by side, some of them timing
# tests; at these tiny sizes PyTorch's intra-op threads only take cores away
# from the other workers.
torch.set_num_threads(1)


def tiny_configs(**overrides):
    """The tiny decoder (2 layers, d 64, 4 heads over 2 KV heads) in f32,
    as (JAX config, port config)."""
    jcfg = dataclasses.replace(
        jax_t.TransformerConfig.tiny(), n_kv_heads=2, dtype=jnp.float32,
        **overrides,
    )
    tcfg = dataclasses.replace(
        torch_t.TransformerConfig.tiny(), n_kv_heads=2, dtype=torch.float32,
        **overrides,
    )
    return jcfg, tcfg


def tiny_params(jcfg, tcfg, seed: int = 0, requires_grad: bool = False):
    """(JAX params, port params on the CPU) holding the same weights;
    ``requires_grad`` makes the port's leaves trainable masters."""
    jparams = jax_t.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu",
        requires_grad=requires_grad,
    )
    return jparams, tparams


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
