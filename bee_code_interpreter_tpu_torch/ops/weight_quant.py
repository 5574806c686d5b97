"""Weight-only int8 quantization for the decode family.

The counterpart of ``bee_code_interpreter_tpu/ops/weight_quant.py``: the
matmul weights become symmetric per-OUT-CHANNEL int8,

    W[in, out]  ->  {"q": int8 same shape, "s": f32 [out]}
    with  W ≈ q * s[None, :],  s = max|W| per out column / 127

and ``transformer.qeinsum`` evaluates ``y = (x @ q.to(dtype)) * s``, the
scale as a matmul epilogue (exact algebra for per-out scales). Activations
and the KV cache are untouched (w8a16).

Where XLA fuses the int8 -> compute-dtype convert into the dot, PyTorch
converts first: every ``qeinsum`` materialises a compute-dtype copy of the
one layer's weight it multiplies (never of all layers at once, since the
port keeps a dict per layer). At Llama-3-8B that moves >= 37.5 GB a decode
step (int8 read, bf16 write, bf16 read) where a fused w8a16 product would
move 7.5 GB; such a kernel is ROADMAP Queue 2 work.

What quantizes: the dense projections of every layer (seven, or the four
attention ones in an MoE layer) and the lm_head. What does not: the
embedding (a gather), the norms, an MoE layer's ``moe`` leaves (router and
expert weights: ``models/moe.py`` multiplies them as they are, as JAX
does), LoRA banks (rank-r deltas applied on the raw activations, so
multi-LoRA serving composes with a quantized base). Quantize after
``merge_lora`` if folding adapters. ``quantized_nbytes`` counts every leaf,
the MoE ones included.

The params are the port's layout (``layers`` a list of per-layer dicts);
quantizing a layer's ``[d_in, d_out]`` leaf gives the same ``q`` and ``s``,
bit for bit, as the JAX package gives for that layer's slice of its stacked
leaf: the same f32 operations in the same order, and ``torch.round`` rounds
half to even as ``jnp.round`` does.
"""

from __future__ import annotations

from typing import Any

import torch

Params = dict[str, Any]

DEFAULT_TARGETS = (
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head",
)


def is_quantized(leaf) -> bool:
    """The quantized-leaf predicate every consumer (``qeinsum``, the LoRA
    merge guard, the weight bridge) uses instead of checking the dict
    shape itself."""
    return isinstance(leaf, dict) and "q" in leaf and "s" in leaf


def any_quantized(params: Params) -> bool:
    return is_quantized(params.get("lm_head")) or any(
        is_quantized(leaf)
        for layer in params.get("layers", [])
        for leaf in layer.values()
    )


def quantize_weight(w: torch.Tensor) -> dict:
    """One weight ``[..., d_in, d_out]`` -> ``{"q": int8, "s": f32 [...,
    d_out]}`` (symmetric, per out column). The max and the divide by 127
    run in ``w``'s own dtype, as JAX runs them, before the scale is f32."""
    amax = torch.amax(torch.abs(w), dim=-2, keepdim=True)
    s = torch.where(amax > 0, amax / 127.0, 1.0).to(torch.float32)
    q = torch.clamp(torch.round(w.to(torch.float32) / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s.squeeze(-2)}


def quantize_weights(
    params: Params, targets: tuple[str, ...] = DEFAULT_TARGETS
) -> Params:
    """The params with every ``targets`` matmul weight quantized: a drop-in
    for forward, decode and serving. The other leaves are shared, not
    copied."""
    out = dict(params)
    out["layers"] = [
        {name: quantize_weight(leaf) if name in targets else leaf
         for name, leaf in layer.items()}
        for layer in params["layers"]
    ]
    if "lm_head" in targets and "lm_head" in params:
        out["lm_head"] = quantize_weight(params["lm_head"])
    return out


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _leaves(value)


def quantized_nbytes(params: Params) -> int:
    """Total bytes of every tensor leaf (quantized dicts included): the
    memory claim's receipt."""
    return sum(x.numel() * x.element_size() for x in _leaves(params))
