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


def lora_to_torch(lora) -> dict:
    """A JAX LoRA tree (stacked ``A``/``B`` per target) as the port's: the
    same layout, as CPU tensors."""
    return {t: {k: torch.from_numpy(np.array(v)) for k, v in ab.items()}
            for t, ab in lora.items()}


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def batcher_pair(models, **kw):
    """The same ``ContinuousBatcher`` in both frameworks, as (JAX, port);
    ``models`` is (JAX config, port config, JAX params, port params)."""
    from bee_code_interpreter_tpu.models import serving as jax_serving
    from bee_code_interpreter_tpu_torch.models import serving as torch_serving

    jcfg, tcfg, jparams, tparams = models
    return (jax_serving.ContinuousBatcher(jparams, jcfg, **kw),
            torch_serving.ContinuousBatcher(tparams, tcfg, device="cpu", **kw))


def host_state(b) -> dict:
    """A batcher's host bookkeeping, which the port must hold exactly as
    the JAX batcher does: the prefix index, page identities, refcounts,
    the free list, the LRU's order, block tables, cursors, counters and
    telemetry."""
    return {
        "prefix_index": dict(b.prefix_index),
        "page_hash": dict(b.page_hash),
        "page_ref": b.page_ref.tolist(),
        "free_pages": list(b.free_pages),
        "evictable": list(b.evictable),
        "prefix_stats": dict(b.prefix_stats),
        "block_table": b.block_table.tolist(),
        "pos": b.pos.tolist(),
        "active": b.active.tolist(),
        "prefilling": sorted(b.prefill_state),
        "kv_telemetry": b.kv_telemetry(),
        "stats": b.stats,
    }
