"""HF Llama-family checkpoints into the port: the counterpart of the JAX
package's ``models/hf_loader.py``.

``load_llama_params`` maps an HF ``LlamaForCausalLM`` (any object with a
``.state_dict()`` and a ``.config``) or a bare state dict of torch tensors
with its config onto the port's parameter dict and ``TransformerConfig``;
every path of the port (forward, cached and paged decode, serving,
training) then runs the real model. The mapping is exact: the decoder is
Llama (split-half RoPE as HF's ``rotate_half``, RMSNorm, SwiGLU, pre-norm
residuals, no biases), and HF's ``Linear.weight [out, in]`` only needs the
transpose to the port's ``[in, out]``, heads laid out alike on the out axis.

Each weight is moved to the target device in its checkpoint dtype, then
transposed and cast to the target dtype in one copy there: no f32 host copy
of the checkpoint is made (an 8B model would take 32 GB of host memory
for it). ``transformers`` is not imported: a config is any object with the
``LlamaConfig`` attributes.

Refused rather than approximated, as in JAX: an ``rms_norm_eps`` other than
1e-5 (the port's ``rms_norm`` fixes it), attention or MLP biases, an
activation other than SiLU, rope scaling other than linear, and a
``head_dim`` other than ``hidden_size // num_attention_heads``. Llama only:
the JAX package has no loader for other families.
"""

from __future__ import annotations

from typing import Any

import torch

from bee_code_interpreter_tpu_torch.device import resolve_device
from bee_code_interpreter_tpu_torch.models.transformer import (
    TransformerConfig,
    layer_shapes,
)

Params = dict[str, Any]

# port leaf -> HF name under model.layers.{i}; the matrices transpose
_LAYER_NAMES = {
    "ln1": "input_layernorm",
    "wq": "self_attn.q_proj",
    "wk": "self_attn.k_proj",
    "wv": "self_attn.v_proj",
    "wo": "self_attn.o_proj",
    "ln2": "post_attention_layernorm",
    "w_gate": "mlp.gate_proj",
    "w_up": "mlp.up_proj",
    "w_down": "mlp.down_proj",
}


def config_from_hf(hf_config, dtype: torch.dtype = torch.bfloat16
                   ) -> TransformerConfig:
    """The port's config for an HF ``LlamaConfig``; settings it cannot
    load exactly raise ``ValueError``."""
    eps = getattr(hf_config, "rms_norm_eps", 1e-5)
    if abs(eps - 1e-5) > 1e-12:
        raise ValueError(
            f"rms_norm_eps {eps} unsupported (our rms_norm fixes 1e-5, "
            "the Llama-2/3 value); refusing a silently mis-normed load"
        )
    if getattr(hf_config, "attention_bias", False):
        raise ValueError("attention_bias checkpoints are not supported")
    if getattr(hf_config, "mlp_bias", False):
        raise ValueError("mlp_bias checkpoints are not supported")
    act = getattr(hf_config, "hidden_act", "silu")
    if act not in ("silu", "swish"):
        raise ValueError(
            f"hidden_act {act!r} unsupported (our MLP is SwiGLU/silu); "
            "refusing a silently wrong load"
        )
    scaling = getattr(hf_config, "rope_scaling", None)
    rope_scaling = 1.0
    if scaling is not None:
        kind = scaling.get("rope_type", scaling.get("type"))
        if kind != "linear":
            raise ValueError(
                f"rope_scaling type {kind!r} unsupported (only linear "
                "position interpolation maps onto our rope scaling)"
            )
        rope_scaling = float(scaling["factor"])
    derived_head_dim = hf_config.hidden_size // hf_config.num_attention_heads
    explicit_head_dim = getattr(hf_config, "head_dim", None)
    if explicit_head_dim not in (None, derived_head_dim):
        raise ValueError(
            f"head_dim {explicit_head_dim} != hidden_size // "
            f"num_attention_heads ({derived_head_dim}); non-derived head "
            "dims unsupported — refusing a silently wrong load"
        )
    return TransformerConfig(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=hf_config.num_key_value_heads,
        d_ff=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        rope_theta=float(getattr(hf_config, "rope_theta", 10000.0)),
        rope_scaling=rope_scaling,
        dtype=dtype,
    )


def load_llama_params(
    model_or_state_dict,
    hf_config=None,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str | None = None,
) -> tuple[Params, TransformerConfig]:
    """``(params, config)`` for an HF ``LlamaForCausalLM`` or its state
    dict (then ``hf_config`` is required). The weights land on ``device``
    (default CUDA; raises without it) in ``dtype``, the config's compute
    dtype too: bf16 to serve, f32 masters to train. Tied word embeddings
    are honoured: without ``lm_head.weight`` the head is the embedding
    transposed."""
    if hf_config is None:
        hf_config = getattr(model_or_state_dict, "config", None)
        if hf_config is None:
            raise ValueError(
                "pass hf_config when loading from a bare state dict"
            )
    config = config_from_hf(hf_config, dtype=dtype)
    device = resolve_device(device)
    sd = (model_or_state_dict if isinstance(model_or_state_dict, dict)
          else model_or_state_dict.state_dict())

    def get(name: str) -> torch.Tensor:
        if name not in sd:
            raise KeyError(
                f"{name} missing from the state dict — not a Llama-family "
                f"checkpoint? (have e.g. {sorted(sd)[:4]})"
            )
        return sd[name].detach().to(device)  # the checkpoint's own dtype

    def as_is(name: str) -> torch.Tensor:
        src = get(name)
        return torch.empty(src.shape, dtype=dtype, device=device).copy_(src)

    def transposed(name: str) -> torch.Tensor:  # [out, in] -> [in, out]
        src = get(name)
        out = torch.empty(src.shape[::-1], dtype=dtype, device=device)
        return out.copy_(src.t())

    def layer(i: int) -> Params:
        p = f"model.layers.{i}"
        return {
            name: (as_is if len(shape) == 1 else transposed)(
                f"{p}.{_LAYER_NAMES[name]}.weight")
            for name, shape in layer_shapes(config).items()
        }

    params = {
        "embed": as_is("model.embed_tokens.weight"),  # [V, D] in both
        "layers": [layer(i) for i in range(config.n_layers)],
        "ln_f": as_is("model.norm.weight"),
        "lm_head": transposed("lm_head.weight" if "lm_head.weight" in sd
                              else "model.embed_tokens.weight"),
    }
    return params, config
