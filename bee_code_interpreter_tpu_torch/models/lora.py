"""LoRA (low-rank adaptation) for the transformer family, in PyTorch.

The counterpart of ``bee_code_interpreter_tpu/models/lora.py``. LoRA state
is a small dict of stacked per-layer factors for chosen projections,
``{target: {"A": [n_layers, d_in, r], "B": [n_layers, r, d_out]}}`` (the
JAX layout, so a JAX adapter crosses as its arrays), and ``merge_lora``
gives ordinary params with ``W + scale · A @ B`` folded into each target,
for the unchanged ``forward`` / decode paths.

``make_lora_train_step`` differentiates the loss through the merge with
respect to the LoRA factors only: the base gets no gradient and no
optimizer state. Under a mesh the base is the rank's shard and the factors
follow its specs (``lora_specs``, ``shard_lora``): ``A [d_in, r]`` takes
the base's ``d_in`` split and ``B [r, d_out]`` its ``d_out`` split, so the
rank's ``A @ B`` is the delta of exactly its block of the weight. ``B`` starts at zero, so the adapted model starts equal to
the base. ``stack_lora_bank`` stacks adapters into the multi-LoRA serving
bank of ``models/serving.py``.

The random ``A`` of ``init_lora`` comes from a ``torch.Generator``, so its
numbers differ from ``jax.random``'s; tests carry JAX's adapters across
instead.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import torch

from bee_code_interpreter_tpu_torch.models.transformer import (
    TransformerConfig,
    layer_shapes,
    loss_fn,
    param_specs,
)
from bee_code_interpreter_tpu_torch.ops.weight_quant import is_quantized
from bee_code_interpreter_tpu_torch.parallel.mesh import (
    ColumnSpec,
    copy_to_group,
    mesh_groups,
    reduce_gradients,
    shard_tensor,
)

Params = dict[str, Any]

DEFAULT_TARGETS = ("wq", "wv")  # the classic LoRA placement


def init_lora_from_layers(
    layers: list[dict],  # the per-layer dicts of a params tree
    generator: torch.Generator,
    rank: int = 8,
    targets: tuple[str, ...] = DEFAULT_TARGETS,
) -> Params:
    """LoRA state for the layers' ``[d_in, d_out]`` projections: per target
    a stacked ``A`` (gaussian / sqrt(d_in)) and ``B`` (zeros), f32, on the
    generator's device. Only shapes are read (meta tensors do)."""
    dims = {
        name: tuple(leaf.shape)
        for name, leaf in layers[0].items()
        if isinstance(leaf, torch.Tensor) and leaf.ndim == 2
    }
    unknown = set(targets) - set(dims)
    if unknown:
        raise ValueError(f"no LoRA target(s) {sorted(unknown)}; have {sorted(dims)}")
    n_layers, device = len(layers), generator.device
    state: Params = {}
    for t in targets:
        d_in, d_out = dims[t]
        a = torch.randn((n_layers, d_in, rank), generator=generator,
                        device=device, dtype=torch.float32)
        state[t] = {
            "A": a / math.sqrt(d_in),
            "B": torch.zeros((n_layers, rank, d_out), dtype=torch.float32,
                             device=device),
        }
    return state


def init_lora(
    config: TransformerConfig,
    generator: torch.Generator,
    rank: int = 8,
    targets: tuple[str, ...] = DEFAULT_TARGETS,
) -> Params:
    """``init_lora_from_layers`` on the config's layer shapes (meta tensors:
    nothing is materialised). The scale (alpha/rank) is an argument of
    ``merge_lora`` / ``make_lora_train_step``, not a leaf."""
    layer = {name: torch.empty(shape, device="meta")
             for name, shape in layer_shapes(config).items()
             if name != "moe"}  # the expert weights take no adapter
    return init_lora_from_layers([layer] * config.n_layers, generator,
                                 rank=rank, targets=targets)


def merge_lora(params: Params, lora: Params, scale: float = 1.0) -> Params:
    """Base params with ``W + scale · A @ B`` folded into each target, in
    the base leaf's dtype: an ordinary params tree for the unchanged
    forward / decode paths. Differentiable in the factors."""
    if any(is_quantized(layer.get(t)) for layer in params["layers"]
           for t in lora):
        # folding a rank-r delta into int8 would re-quantize the base on
        # every merge; the supported order is merge THEN quantize
        raise NotImplementedError(
            "merge_lora needs fp base weights (quantize AFTER merging)"
        )
    layers = [dict(layer) for layer in params["layers"]]
    for t, ab in lora.items():
        for i, layer in enumerate(layers):
            w = layer[t]
            delta = torch.einsum("ir,ro->io", ab["A"][i], ab["B"][i]) * scale
            layer[t] = (w + delta).to(w.dtype)
    return {**params, "layers": layers}


def lora_leaves(lora: Params) -> list[torch.Tensor]:
    """The factors in one fixed order (targets sorted, A then B)."""
    return [lora[t][k] for t in sorted(lora) for k in ("A", "B")]


def _lora_adamw(lora: Params, *, lr: float) -> torch.optim.AdamW:
    # optax.adamw(lr)'s defaults: b1 0.9, b2 0.999, eps 1e-8, weight decay
    # 1e-4 (PyTorch's own default decay is 1e-2); the algebra is the same,
    # see transformer._adamw. The factors become trainable here: the
    # optimizer state is what makes them the step's variables.
    leaves = [w.requires_grad_() for w in lora_leaves(lora)]
    return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def lora_specs(lora: Params, config: TransformerConfig, mesh) -> Params:
    """Each factor's spec under ``mesh`` (the stacked ``[n_layers, ...]``
    layout): ``A`` takes its base leaf's ``d_in`` split, ``B`` its
    ``d_out`` split (``transformer.param_specs``; where the base leaf's
    columns are a ``ColumnSpec``'s, ``B``'s are the same)."""
    base = param_specs(config, mesh)["layers"]

    def b_spec(spec):
        names = (None, None, spec[1])
        return spec.renamed(names) if isinstance(spec, ColumnSpec) else names

    return {t: {"A": (None, base[t][0], None), "B": b_spec(base[t])}
            for t in lora}


def shard_lora(lora: Params, config: TransformerConfig, mesh,
               device=None) -> Params:
    """This rank's shard of each factor (``lora_specs``), a tensor of its
    own on ``device`` (default: the mesh's device type)."""
    specs = lora_specs(lora, config, mesh)
    device = device if device is not None else mesh.device_type
    return {t: {k: shard_tensor(x, specs[t][k], mesh, device)
                for k, x in ab.items()} for t, ab in lora.items()}


def _merge_on_mesh(params: Params, lora: Params, scale: float,
                   config: TransformerConfig, mesh) -> Params:
    """``merge_lora`` of the rank's shards: each factor that is whole over
    tp while its base leaf is split over tp (``A`` of a column-parallel
    target, ``B`` of a row-parallel one) enters through ``copy_to_group``,
    so its gradient sums every tp rank's block of the weight."""
    tp = mesh_groups(mesh).tp
    base = param_specs(config, mesh)["layers"]
    entered = {}
    for t, ab in lora.items():
        spec = base[t]
        entered[t] = {
            "A": copy_to_group(ab["A"], tp) if spec[1] == "tp" else ab["A"],
            "B": copy_to_group(ab["B"], tp) if spec[0] == "tp" else ab["B"],
        }
    return merge_lora(params, entered, scale)


def make_lora_train_step(
    config: TransformerConfig,
    optimizer=None,
    mesh=None,
    scale: float = 1.0,
):
    """A step that updates only the LoRA factors; the base is frozen (no
    gradient is computed for it, no optimizer state). Returns ``(step,
    optimizer)``: ``optimizer(lora)`` gives the state (an AdamW over the
    factors, by default with ``optax.adamw(1e-3)``'s settings) and
    ``step(lora, opt_state, params, batch) -> (lora, opt_state, loss)``
    updates the factors in place. Under ``mesh`` (dp, fsdp, tp, sp, ep)
    ``params`` are the rank's shard, ``lora`` the rank's factors
    (``shard_lora``) and ``batch`` its block (``Transformer.batch_slice``:
    its rows, and under sp its positions); the loss is the global batch's
    and each factor's gradient is summed over the batch axes and sp where
    it is whole, as ``Transformer.make_train_step`` does."""
    groups = mesh_groups(mesh)  # a mesh is checked here, not at the step
    optimizer = optimizer or functools.partial(_lora_adamw, lr=1e-3)

    def step(lora, opt_state, params, batch):
        if opt_state is None:
            opt_state = optimizer(lora)
        leaves = lora_leaves(lora)
        if mesh is None:
            merged = merge_lora(params, lora, scale)
        else:
            merged = _merge_on_mesh(params, lora, scale, config, mesh)
        loss = loss_fn(merged, batch, config, mesh)
        # grads for the factors only: the engine skips the base's
        grads = torch.autograd.grad(loss, leaves)
        for w, g in zip(leaves, grads):
            w.grad = g
        if mesh is not None:
            specs = lora_specs(lora, config, mesh)
            reduce_gradients(
                [(lora[t][k], specs[t][k]) for t in sorted(lora)
                 for k in ("A", "B")], groups)
        opt_state.step()
        return lora, opt_state, loss.detach()

    return step, optimizer


def stack_lora_bank(adapters: list[Params]) -> Params:
    """Stack adapters into the multi-LoRA serving bank: per target ``A
    [n_layers, n_adapters+1, d_in, r]`` / ``B [n_layers, n_adapters+1, r,
    d_out]``, with index 0 an all-zeros base adapter (identity delta) and
    the adapters at 1..n in order. All adapters must share targets, rank
    and shapes. The bank is serving state: detached from any graph."""
    if not adapters:
        raise ValueError("need at least one adapter")
    targets = set(adapters[0])
    for a in adapters[1:]:
        if set(a) != targets:
            raise ValueError(
                f"adapters must share targets: {sorted(targets)} vs "
                f"{sorted(a)}"
            )
    bank: Params = {}
    for t in sorted(targets):
        for leaf in ("A", "B"):
            shapes = {tuple(a[t][leaf].shape) for a in adapters}
            if len(shapes) != 1:
                raise ValueError(
                    f"adapters disagree on {t}/{leaf} shape: {shapes}"
                )
        bank[t] = {
            leaf: torch.stack(
                [torch.zeros_like(adapters[0][t][leaf])]
                + [a[t][leaf] for a in adapters],
                dim=1,
            ).detach()
            for leaf in ("A", "B")
        }
    return bank


def lora_param_count(lora: Params) -> int:
    return sum(x.numel() for ab in lora.values() for x in ab.values())
