"""Speculative decoding (greedy draft-verify) for the transformer family.

The counterpart of ``bee_code_interpreter_tpu/models/speculative.py``. A
small draft model proposes ``gamma`` greedy tokens from its own contiguous
cache (``decode_step`` × γ), the target scores the whole window in one
cached ``decode_window`` and commits the longest prefix on which the draft
matched the target's greedy choice, plus the target's own next token. The
output equals the target's greedy decode token for token, for any draft
(up to rounding: the window's logits and one-token decode's agree only to
float error, so a near-tie argmax can land differently at bf16).

Where JAX runs one compiled ``lax.while_loop`` over a padded token buffer,
the port runs the same rounds as a host loop; the buffer keeps JAX's
padding of γ + 2, so a round's fixed-width write never runs off its end.
Rejected draft positions leave K/V in both caches behind the cursor, where
every read is masked by position until the real token overwrites them: no
rewind. The batch commits in lockstep: a round commits the least accepted
length over the rows.

The draft is any config sharing the vocabulary (typically fewer layers or
a narrower model).
"""

from __future__ import annotations

import torch

from bee_code_interpreter_tpu_torch.models.transformer import (
    TransformerConfig,
    decode_step,
    decode_window,
    forward,
    init_decode_cache,
)


def speculative_generate(
    target_params,
    target_config: TransformerConfig,
    draft_params,
    draft_config: TransformerConfig,
    prompt: torch.Tensor,  # [B, L]
    max_new_tokens: int = 32,
    gamma: int = 4,
) -> torch.Tensor:
    """Greedy decode of the target, accelerated by the draft. Returns
    ``[B, L + max_new_tokens]`` tokens, equal to ``Transformer(
    target_config).generate_cached(target_params, prompt,
    max_new_tokens)``. Both models' weights live on one device."""
    tc, dc = target_config, draft_config
    if tc.vocab_size != dc.vocab_size:
        raise ValueError("target and draft must share a vocabulary")
    if not tc.moe_exact:
        # the verify window routes B·(γ+1) tokens where plain decode routes
        # B, so capacity routing can drop different tokens; an MoE draft
        # is fine (drafts only propose)
        raise NotImplementedError(
            "speculative_generate requires a moe_exact target — dense, or "
            "MoE with moe_dropless + moe_group_size=1 (capacity routing "
            "pools differ between the verify window and plain decode); "
            "use Transformer.generate_cached for capacity-routed MoE "
            "targets"
        )
    prompt = torch.as_tensor(prompt, device=target_params["embed"].device)
    B, L = prompt.shape
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    buf = L + max_new_tokens + gamma + 2

    t_logits, (tk, tv) = forward(target_params, prompt, tc, return_kv=True)
    target_cache = init_decode_cache(tc, B, buf, tk, tv)
    _, (dk, dv) = forward(draft_params, prompt, dc, return_kv=True)
    draft_cache = init_decode_cache(dc, B, buf, dk, dv)
    del tk, tv, dk, dv

    tokens = torch.zeros(B, buf, dtype=torch.long, device=prompt.device)
    tokens[:, :L] = prompt
    tokens[:, L] = torch.argmax(t_logits[:, L - 1, :], dim=-1)
    last = L + max_new_tokens - 1  # buffer index of the final token
    idx = torch.arange(gamma + 1, device=prompt.device)[None, :]
    pos = L
    while pos < last:
        current = tokens[:, pos:pos + 1]
        # the draft proposes γ greedy tokens from (current, pos)
        drafts = []
        tok = current
        for g in range(gamma):
            lg, draft_cache = decode_step(draft_params, tok, pos + g,
                                          draft_cache, dc)
            tok = torch.argmax(lg[:, -1:, :], dim=-1)
            drafts.append(tok)
        drafts = torch.cat(drafts, dim=1)  # [B, γ]
        # the target verifies the whole window in one pass
        window = torch.cat([current, drafts], dim=1)  # [B, γ + 1]
        t_logits, target_cache = decode_window(target_params, window, pos,
                                               target_cache, tc)
        t_pred = torch.argmax(t_logits, dim=-1)  # [B, γ + 1]
        # the longest leading run where the draft equals the target's
        # greedy choice, the least over the batch
        lead = torch.cumprod((drafts == t_pred[:, :gamma]).long(), dim=1)
        n = int(lead.sum(dim=1).min())
        # commit drafts[:, :n] at pos + 1.. and the target's token at
        # pos + n + 1; the slots past n get it too, behind the cursor
        bonus = t_pred[:, n:n + 1]
        vals = torch.where(idx < n, torch.cat([drafts, bonus], dim=1), bonus)
        tokens[:, pos + 1:pos + gamma + 2] = vals
        pos += n + 1
    return tokens[:, :L + max_new_tokens]
