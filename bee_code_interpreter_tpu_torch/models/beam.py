"""Beam search over the KV-cached decode path.

The counterpart of ``bee_code_interpreter_tpu/models/beam.py``. Beams ride
the batch dimension: after one prefill the contiguous cache is tiled to
``B·W`` rows, every step is one ``decode_step`` over all beams, and the
beams' caches are reordered by a gather on the cache's batch axis. Where
JAX runs one ``lax.scan``, the port runs the same steps as a host loop.
``beam_size=1`` is greedy decoding, token for token.

No EOS: beams are compared by total log-probability at a fixed length, so
a length penalty could only rescale every score by one constant.
"""

from __future__ import annotations

import torch

from bee_code_interpreter_tpu_torch.models.transformer import (
    TransformerConfig,
    decode_step,
    forward,
    init_decode_cache,
)


def beam_search(
    params,
    config: TransformerConfig,
    prompt: torch.Tensor,  # [B, L]
    max_new_tokens: int = 32,
    beam_size: int = 4,
    return_all: bool = False,
):
    """The highest-log-probability continuation under beam search. Returns
    ``[B, L + max_new_tokens]`` (the best beam), or with ``return_all``
    ``([B, W, L + max_new_tokens]`` sequences sorted best first, ``[B, W]``
    scores)."""
    c = config
    if not c.moe_exact:
        # capacity routing puts all B·W beam rows in one competing pool,
        # so a beam's tokens and score would depend on its siblings
        raise NotImplementedError(
            "beam_search requires a moe_exact config — dense, or MoE with "
            "moe_dropless + moe_group_size=1 (capacity routing pools "
            "couple sibling beams); use Transformer.generate_cached for "
            "capacity-routed MoE"
        )
    W = beam_size
    if W < 1:
        raise ValueError(f"beam_size must be >= 1, got {beam_size}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    prompt = torch.as_tensor(prompt, device=params["embed"].device)
    B, L = prompt.shape
    total = L + max_new_tokens
    dev = prompt.device

    logits, (k_pre, v_pre) = forward(params, prompt, c, return_kv=True)
    cache = init_decode_cache(c, B, total, k_pre, v_pre)
    del k_pre, v_pre
    # beams ride the batch axis: cache rows B -> B·W, beam-major per row
    cache = {k: x.repeat_interleave(W, dim=1) for k, x in cache.items()}

    # first expansion: the top W distinct first tokens of each row
    lp0 = torch.log_softmax(logits[:, L - 1, :], dim=-1)  # [B, V]
    scores, first = torch.topk(lp0, W, dim=-1)  # [B, W]
    seqs = torch.zeros(B, W, total, dtype=torch.long, device=dev)
    seqs[:, :, :L] = prompt[:, None, :]
    seqs[:, :, L] = first
    current = first.reshape(B * W, 1)
    V = c.vocab_size
    rows = torch.arange(B, device=dev)[:, None] * W

    for pos in range(L, total - 1):
        step_logits, cache = decode_step(params, current, pos, cache, c)
        lp = torch.log_softmax(step_logits[:, 0, :], dim=-1)  # [B·W, V]
        joint = scores[:, :, None] + lp.reshape(B, W, V)
        scores, flat = torch.topk(joint.reshape(B, W * V), W, dim=-1)
        beam_idx = flat // V  # [B, W] the parent beam
        token = flat % V
        # reorder histories and caches to the winning parents
        seqs = torch.take_along_dim(seqs, beam_idx[:, :, None], dim=1)
        seqs[:, :, pos + 1] = token
        parent = (rows + beam_idx).reshape(B * W)
        cache = {k: x.index_select(1, parent) for k, x in cache.items()}
        current = token.reshape(B * W, 1)

    order = torch.argsort(-scores, dim=1, stable=True)  # best first
    seqs = torch.take_along_dim(seqs, order[:, :, None], dim=1)
    scores = torch.take_along_dim(scores, order, dim=1)
    if return_all:
        return seqs, scores
    return seqs[:, 0]
