"""Llama-style decoder in PyTorch: the serving and training slices of the
JAX package's ``models/transformer.py``.

Ported: ``TransformerConfig``, ``rms_norm``, ``rope`` (split-half layout),
the plain-array ``qeinsum``, ``init_params``, ``forward`` (``return_kv=True``
gives the per-layer K/V, ``return_aux=True`` the summed MoE aux loss), the
contiguous cached decode (``alloc_decode_cache``, ``init_decode_cache``,
``decode_window``, ``decode_step``, ``prefill_chunked``; bf16 or int8
caches), the paged decode (``decode_window_paged`` / ``decode_step_paged``,
bf16 or int8 pools), sampling (``sample_logits``, ``filter_logits``),
``loss_fn`` and ``Transformer`` (``init``, ``apply``, ``make_optimizer``,
``make_train_step``, ``generate``, ``generate_cached``). Parameters are a
plain dict: ``embed [V, D]``, ``layers`` (a list of per-layer dicts, where
JAX stacks them on a leading axis for ``lax.scan``), ``ln_f``,
``lm_head [D, V]``; weights keep JAX's ``[d_in, d_out]`` layout. A
Mixture-of-Experts layer (``n_experts > 0``, ``models/moe.py``) holds a
``moe`` dict (``router``, ``we_gate``, ``we_up``, ``we_down``) in place of
``w_gate``/``w_up``/``w_down``. Caches and
pools keep JAX's stacked ``[n_layers, ...]`` leaves; the layer loop writes
through views of them, in place.

The JAX code keeps f32 master weights and casts them to ``config.dtype`` at
every einsum. Training does the same (``Transformer.init`` makes f32 masters
that require grad; ``qeinsum`` casts them). Serving casts once, when the
weights are made or loaded (``init_params``, ``weights.params_from_jax``), so
Llama-3-8B takes ~16 GB in bf16 instead of a 32 GB f32 master plus casts. The
values are the same.

Attention runs through the ops: prefill and training through the flash
attention ``autograd.Function`` (``ops/flash_attention.py``: forward kernel,
and the dK/dV and dQ kernels in the backward), single-token paged decode
through the paged decode kernel when ``paged_attention_kernel`` is set
(``ops/paged_attention.py``), all kernels on CUDA tensors and their plain
versions on CPU tensors. Windows, int8 pools and the contiguous cache take
the grouped einsums, as in JAX.

Tensor parallelism (``param_specs``, ``shard_params``, and the ``tp_group``
argument of ``forward``, ``decode_window`` / ``decode_step``,
``decode_window_paged`` / ``decode_step_paged`` and ``prefill_chunked``):
where JAX shards the params with ``NamedSharding`` and GSPMD inserts the
collectives, each rank here holds its Megatron shard (``shard_params``) and
the model functions make the collectives themselves, over the process group
of the mesh's tp axis. A rank runs ``n_heads / tp`` query heads and
``kv_heads / tp`` K/V heads (its caches and pools hold only those), so the
attention ops see the local head counts and nothing else changes in them.
Where tp does not divide ``kv_heads``, K/V are broadcast up to
``lcm(kv_heads, tp)`` heads, as JAX's ``_attention`` does: a rank's
``wk``/``wv`` hold the columns of the broadcast heads its query heads read
(``kv_columns``, their spec a ``ColumnSpec``), so its projection makes them
directly; in training each such column's gradient is summed over the ranks
that hold a copy of it (``reduce_gradients``). The row-parallel
``wo`` and ``w_down`` each end in one ``all_reduce`` of their partial sums,
the vocab-sharded embedding is a masked lookup of the rank's rows plus one
``all_reduce`` (exact: one rank holds each row), and the column-parallel
lm_head's local logits are ``all_gather``-ed into the full vocabulary
before they leave the function, so every rank returns the same logits.

Mixture-of-Experts layers shard their experts over ``ep`` and each expert's
``d_ff`` over ``tp`` (``ep_group``): routing is global, a rank runs its
experts on its shard, and the partial sum is reduced once, in f32, over tp
and ep. A LoRA bank under tp (``decode_window_paged``) stays whole on every
rank: a column-parallel target takes the rank's columns of ``B``, and
``wo`` the rank's rows of ``A``, whose delta joins the partial sum before
``wo``'s all-reduce (exact: the sum of ``(x_r A_r) B`` is ``(x A) B``).

Sequence parallelism (``sp_group`` of ``forward``: the long-context
admission path): every rank is given the whole ``[B, L]`` tokens, embeds
and runs its contiguous ``L/sp`` of them at their global positions, and
attends across the sp ranks by ring attention or Ulysses
(``config.sp_attention``, ``parallel/``), with the sliding window threaded
to both. Norms and MLPs stay token-local. The rank's logits and K/V are its
block of positions (``gather_prefill`` makes the whole prompt's K/V and one
position's logits of them); the logits are never gathered over sp, where
they would be ``[B, L, vocab]`` f32 on every rank. Decode ignores sp.

Training under a mesh (``loss_fn(mesh=...)``, ``Transformer.init`` and
``make_train_step``) runs over dp, fsdp, tp, sp and ep, and through the
pipeline over pp. The batch is sharded over dp then fsdp, and under sp its
positions too (``Transformer.batch_slice``: JAX's ``P(batch, "sp")``); the
weights by
``param_specs``, fsdp gathered one layer at a time (``gather_shards``,
whose backward reduce-scatters the weight's gradient). The collectives are
differentiable: Megatron's ``f`` (``copy_to_group``) where a tensor that is
the same on every tp rank enters a sharded product, its ``g``
(``all_reduce_partial``) after each row-parallel product; an MoE layer
adds ``f`` over tp and ep on its tokens and combine weights. The loss
stays sharded over the vocabulary (``_token_losses``: the logsumexp and
the target logit from all-reduces, never the ``[B, L, V]`` logits), each
rank's loss is its share of the global batch's, and after the backward
``reduce_gradients`` sums each gradient over the batch axes and sp, where
its leaf is whole. Under sp a rank runs its block of positions at their
global positions (rope offset by the block), attends across the sp ranks
through the differentiable ring or Ulysses, and holds the loss of its
positions; an MoE layer routes the whole sequence's tokens (its aux, the
same on every sp rank, enters the loss as a 1/sp share on each).

Generation over the batch axes (``Transformer.generate`` and
``generate_cached`` under dp or fsdp, JAX's batch-sharded ``forward`` in
its generators): each batch coordinate prefills and decodes its rows with a
cache of its rows, fsdp gathering a layer's weights at a time
(``decode_window`` / ``decode_step`` / ``prefill_chunked`` take the fsdp
group), and each step's last logits are gathered into the whole batch
before the next tokens are drawn, so every rank draws for the whole batch
from the same generator and returns the whole ``[B, L + new]`` tokens: the
tokens one device draws from the same logits.

The pipeline (``forward_pipelined``, JAX's :533): under a ``pp`` mesh a
rank holds its block of the layers (``init_params`` / ``shard_params``
keep only it) plus the replicated embedding, final norm and head, which
run outside the pipeline on every stage; the layers run through
``parallel/pipeline.py::spmd_pipeline`` over microbatches of the rank's
rows (the batch sharded over dp/fsdp), an MoE layer routing each
microbatch on its own. ``loss_fn(mesh=, n_microbatches=)`` and
``make_train_step(n_microbatches=)`` train through it.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from bee_code_interpreter_tpu_torch.device import resolve_device
from bee_code_interpreter_tpu_torch.models.moe import (
    init_moe_params,
    moe_mlp,
    moe_shapes,
)
from bee_code_interpreter_tpu_torch.ops.flash_attention import local_attention
from bee_code_interpreter_tpu_torch.ops.kv_cache import cache_append, cache_read
from bee_code_interpreter_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
)
from bee_code_interpreter_tpu_torch.ops.paged_kv_cache import (
    paged_append,
    paged_read,
)
from bee_code_interpreter_tpu_torch.ops.weight_quant import is_quantized
from bee_code_interpreter_tpu_torch.parallel.mesh import (
    ColumnSpec,
    all_gather_cat,
    all_reduce_partial,
    axis_size,
    batch_shard_of,
    batch_slice,
    broadcast_from,
    copy_to_group,
    gather_shards,
    group_rank,
    group_size,
    mesh_groups,
    reduce_gradients,
    shard_tensor,
    split_to_group,
)
from bee_code_interpreter_tpu_torch.parallel.pipeline import (
    spmd_pipeline,
    stage_block,
)
from bee_code_interpreter_tpu_torch.parallel.ring_attention import (
    ring_attention,
)
from bee_code_interpreter_tpu_torch.parallel.ulysses import ulysses_attention

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The JAX package's config, field for field; ``dtype`` is a torch
    dtype. Fields this slice does not serve are kept so configs read the
    same, and the code paths that would need them raise."""

    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int | None = None  # grouped-query attention; None = MHA
    d_ff: int | None = None  # None = SwiGLU default 8/3 * d_model rounded
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    dtype: torch.dtype = torch.bfloat16
    z_loss: float = 1e-4
    n_experts: int = 0  # > 0: every layer's MLP is an MoE (models/moe.py)
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2
    moe_group_size: int = 1024
    moe_dropless: bool = False
    rope_scaling: float = 1.0  # linear position interpolation
    sp_attention: str = "ring"
    kv_cache_dtype: str = "bf16"  # "int8": int8 K/V + per-row f32 scales
    sliding_window: int | None = None
    # single-token paged decode through the paged decode kernel
    paged_attention_kernel: bool = False

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def ff_dim(self) -> int:
        if self.d_ff is not None:
            return self.d_ff
        raw = int(8 * self.d_model / 3)
        return (raw + 255) // 256 * 256

    @property
    def moe_exact(self) -> bool:
        """True when a request's output does not depend on what shares its
        batch: dense configs, and MoE under dropless per-token routing
        (``moe_dropless`` and ``moe_group_size=1``: no choice is ever
        dropped, so no token competes for a slot). The exactness features
        (prefix cache, speculative decoding, beam search) require it."""
        return self.n_experts == 0 or (
            self.moe_dropless and self.moe_group_size == 1
        )

    @classmethod
    def tiny(cls) -> "TransformerConfig":
        """Test size."""
        return cls(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                   max_seq_len=128, d_ff=128)

    @classmethod
    def tiny_moe(cls) -> "TransformerConfig":
        """Test MoE size (4 experts, top-2 routing)."""
        return cls(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                   max_seq_len=128, d_ff=128, n_experts=4)

    @classmethod
    def llama3_8b(cls) -> "TransformerConfig":
        """The flagship config (Llama-3-8B shapes)."""
        return cls(vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, d_ff=14336, max_seq_len=8192)

    @classmethod
    def mixtral_8x7b(cls) -> "TransformerConfig":
        """The MoE config (Mixtral-8x7B shapes: 8 experts, top-2), with the
        JAX package's values (its ``rope_theta`` is the class default)."""
        return cls(vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, d_ff=14336, max_seq_len=8192,
                   n_experts=8, moe_top_k=2)


# ---------------------------------------------------------------- components


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    norm = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (norm * scale.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         scaling: float = 1.0) -> torch.Tensor:
    """Rotary embeddings over ``[B, H, L, D]`` with positions ``[B, L]``,
    split-half layout; ``scaling`` > 1 is linear position interpolation."""
    if scaling <= 0:
        raise ValueError(f"rope scaling must be > 0, got {scaling}")
    d = x.shape[-1]
    freqs = theta ** (
        -torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    )
    scaled = positions.float() / scaling
    angles = scaled[:, None, :, None] * freqs  # [B, 1, L, d/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.to(x.dtype)


def qeinsum(spec: str, x: torch.Tensor, leaf, dtype: torch.dtype):
    """Einsum against a weight leaf, a plain tensor or a weight-only-int8
    dict (``{"q", "s"}``, ``ops/weight_quant.py``), as the JAX ``qeinsum``:
    ``(x @ q) * s`` with the per-out-channel scale as the epilogue. Unlike
    XLA, PyTorch does not fuse the int8 -> ``dtype`` convert into the
    product, so each call makes a ``dtype`` copy of this one layer's
    weight (the port's leaves are per layer; a stacked leaf would make the
    copy n_layers times larger)."""
    if is_quantized(leaf):
        y = torch.einsum(spec, x, leaf["q"].to(dtype))
        return (y * leaf["s"]).to(dtype)
    return torch.einsum(spec, x, leaf.to(dtype))


# ------------------------------------------------------------------- weights


def init_params(
    config: TransformerConfig,
    generator: torch.Generator,
    device: torch.device | str | None = None,
    dtype: torch.dtype | None = None,
    requires_grad: bool = False,
    mesh=None,
) -> Params:
    """Random weights with the JAX ``init_params`` distributions
    (normal / sqrt(fan_in), ones for the norms), made straight in ``dtype``
    (default ``config.dtype``) on ``device`` (default CUDA; raises without
    it); ``requires_grad`` makes every leaf a trainable master. ``generator``
    must live on that device; the numbers differ from ``jax.random``'s, so
    tests that compare the two frameworks load JAX's weights through
    ``weights.params_from_jax`` instead. With ``mesh`` every leaf is drawn
    whole, as without one (every rank the same draws from the same
    generator), and only the rank's shard under ``param_specs`` is kept
    (``shard_params``' slice), so no rank holds the whole tree at once;
    under pp only the rank's block of layers is kept (each other layer is
    drawn and dropped)."""
    c = config
    device = resolve_device(device)
    dtype = dtype or c.dtype
    if generator.device.type != device.type:
        raise ValueError(
            f"generator is on {generator.device}, weights go to {device}"
        )
    specs = None if mesh is None else param_specs(c, mesh)

    def keep(w, spec):
        return w if specs is None else shard_tensor(w, spec, mesh, device)

    def dense(fan_in, *shape):
        w = torch.randn(shape, generator=generator, device=device, dtype=dtype)
        return w.div_(math.sqrt(fan_in))

    def ones(n):
        return torch.ones(n, device=device, dtype=dtype)

    def make(name, shape):
        spec = specs and specs["layers"][name]
        if name == "moe":
            moe = init_moe_params(generator, d, c.ff_dim, c.n_experts,
                                  device, dtype)
            return {k: keep(w, spec and spec[k]) for k, w in moe.items()}
        w = dense(shape[0], *shape) if len(shape) == 2 else ones(shape[0])
        return keep(w, spec)

    d = c.d_model
    mine = (range(c.n_layers) if mesh is None
            else stage_block(range(c.n_layers), mesh))
    layers = []
    for i in range(c.n_layers):  # every layer drawn, in order
        layer = {name: make(name, shape)
                 for name, shape in layer_shapes(c).items()}
        if i in mine:
            layers.append(layer)
        del layer
    params = {
        "embed": keep(dense(d, c.vocab_size, d), specs and specs["embed"]),
        "layers": layers,
        "ln_f": keep(ones(d), specs and specs["ln_f"]),
        "lm_head": keep(dense(d, d, c.vocab_size), specs and specs["lm_head"]),
    }
    for leaf in param_leaves(params):
        leaf.requires_grad_(requires_grad)
    return params


def layer_shapes(config: TransformerConfig) -> dict:
    """Each layer's leaves and their shapes, in ``init_params``' order:
    the norms ``[d]``, the projections ``[d_in, d_out]``, and the MLP's
    ``w_gate``/``w_up``/``w_down``, or for MoE configs a ``moe`` dict of
    ``models/moe.py::moe_shapes``."""
    c = config
    dh, kvh, d, f = c.head_dim, c.kv_heads, c.d_model, c.ff_dim
    shapes = {
        "ln1": (d,), "wq": (d, c.n_heads * dh), "wk": (d, kvh * dh),
        "wv": (d, kvh * dh), "wo": (c.n_heads * dh, d), "ln2": (d,),
    }
    if c.n_experts:
        shapes["moe"] = moe_shapes(d, f, c.n_experts)
    else:
        shapes.update(w_gate=(d, f), w_up=(d, f), w_down=(f, d))
    return shapes


def _layer_leaves(layer: Params) -> list[torch.Tensor]:
    return [w for leaf in layer.values()
            for w in (leaf.values() if isinstance(leaf, dict) else (leaf,))]


def param_leaves(params: Params) -> list[torch.Tensor]:
    """Every weight tensor in one fixed order (embed, each layer's leaves
    with a ``moe`` dict's in its own order, ln_f, lm_head): what the
    optimizer steps and its state is indexed by."""
    return ([params["embed"]]
            + [w for layer in params["layers"] for w in _layer_leaves(layer)]
            + [params["ln_f"], params["lm_head"]])


def n_params(params: Params) -> int:
    """Parameter count (the weight bytes a decode step streams / itemsize)."""
    return sum(w.numel() for w in param_leaves(params))


def param_specs(config: TransformerConfig, mesh) -> Params:
    """JAX's Megatron specs over whichever of (fsdp, tp, ep) the mesh has,
    as tuples of axis names (None: that dim whole): column-parallel
    ``wq``/``wk``/``wv``/``w_gate``/``w_up`` ``(fsdp, tp)``, row-parallel
    ``wo``/``w_down`` ``(tp, fsdp)``, the vocab-sharded ``embed``
    ``(tp, None)``, the column-parallel ``lm_head`` ``(None, tp)``, the
    norms replicated ``()``; a Mixture-of-Experts layer's ``moe`` dict has
    ``we_gate``/``we_up`` ``(ep, fsdp, tp)``, ``we_down`` ``(ep, tp,
    fsdp)`` and the router replicated. ``layers`` holds one layer's specs,
    for every layer (JAX's stacked specs add a leading None for the layer
    axis). Where tp does not divide ``kv_heads``, ``wk``/``wv`` take a
    ``ColumnSpec``: a rank holds the columns of ``kv_columns``, its K/V
    heads of the ``lcm(kv_heads, tp)`` broadcast."""
    specs = _specs(config, tuple(mesh.mesh_dim_names))
    tp = axis_size(mesh, "tp")
    if config.kv_heads % tp:
        cols = [kv_columns(config, tp, r) for r in range(tp)]
        for name in ("wk", "wv"):
            specs["layers"][name] = ColumnSpec(
                specs["layers"][name], "tp",
                config.kv_heads * config.head_dim, cols)
    return specs


def _specs(config: TransformerConfig, names: tuple[str, ...]) -> Params:
    tp = "tp" if "tp" in names else None
    fsdp = "fsdp" if "fsdp" in names else None
    ep = "ep" if "ep" in names else None
    col, row, rep = (fsdp, tp), (tp, fsdp), ()
    layer = {"ln1": rep, "ln2": rep, "wq": col, "wk": col, "wv": col,
             "wo": row}
    if config.n_experts:
        layer["moe"] = {"router": (None, None), "we_gate": (ep, fsdp, tp),
                        "we_up": (ep, fsdp, tp), "we_down": (ep, tp, fsdp)}
    else:
        layer.update(w_gate=col, w_up=col, w_down=row)
    return {"embed": (tp, None), "layers": layer, "ln_f": rep,
            "lm_head": (None, tp)}


def leaf_specs(params: Params, specs: Params) -> list[tuple]:
    """``(leaf, spec)`` of every weight of ``params`` under ``specs``
    (``param_specs``), in ``param_leaves``' order."""
    def layer_pairs(layer):
        for name, leaf in layer.items():
            spec = specs["layers"][name]
            if isinstance(leaf, dict):  # a Mixture-of-Experts layer's dict
                yield from ((leaf[k], spec[k]) for k in leaf)
            else:
                yield leaf, spec

    return ([(params["embed"], specs["embed"])]
            + [pair for layer in params["layers"] for pair in layer_pairs(layer)]
            + [(params["ln_f"], specs["ln_f"]),
               (params["lm_head"], specs["lm_head"])])


def _kv_heads_local(config: TransformerConfig, tp: int) -> int:
    """K/V heads a tp rank holds: ``kv_heads / tp``, or ``lcm(kv_heads,
    tp) / tp`` of the broadcast heads where tp does not divide them."""
    return math.lcm(config.kv_heads, tp) // tp


def kv_columns(config: TransformerConfig, tp: int, rank: int) -> torch.Tensor:
    """The ``wk``/``wv`` columns (and their LoRA ``B`` columns and int8
    scales) tp rank ``rank`` holds: its ``n / tp`` heads of the
    ``n = lcm(kv_heads, tp)`` broadcast heads, broadcast head ``g`` being
    K/V head ``g // (n / kv_heads)`` (JAX's ``jnp.repeat``: query head h
    keeps reading K/V head ``h // (n_heads / kv_heads)``). Where tp divides
    ``kv_heads`` this is the rank's contiguous column block."""
    n_local = _kv_heads_local(config, tp)
    rep = n_local * tp // config.kv_heads
    heads = (rank * n_local + torch.arange(n_local)) // rep
    dh = config.head_dim
    return (heads[:, None] * dh + torch.arange(dh)[None, :]).reshape(-1)


def shard_params(params: Params, config: TransformerConfig, mesh,
                 device: torch.device | str | None = None) -> Params:
    """This rank's shard of every leaf under ``param_specs``, each a
    contiguous tensor of its own on ``device`` (default: the mesh's device
    type, CUDA raising without it); ``params`` (full, anywhere) is only
    read. A weight-only-int8 leaf ``{q, s}`` shards as in JAX: ``q`` takes
    the weight's spec and ``s`` (one scale per out column) the spec without
    the contracted dim, so a column-parallel leaf's scales follow its
    columns and a row-parallel leaf's stay whole. Where tp does not divide
    ``kv_heads``, ``wk``/``wv`` (and their scales) take the columns of
    ``kv_columns`` (their ``ColumnSpec``) instead of an even column block:
    the rank's K/V heads of the ``lcm(kv_heads, tp)`` broadcast. Under pp
    only the rank's block of layers is kept
    (``parallel.pipeline.stage_block``)."""
    specs = param_specs(config, mesh)
    device = resolve_device(device if device is not None
                            else mesh.device_type)

    def place(x, spec):
        if is_quantized(x):
            scale = (spec.renamed(spec[1:]) if isinstance(spec, ColumnSpec)
                     else spec[1:])
            return {"q": shard_tensor(x["q"], spec, mesh, device),
                    "s": shard_tensor(x["s"], scale, mesh, device)}
        if isinstance(spec, dict):  # a Mixture-of-Experts layer's dict
            return {k: place(x[k], spec[k]) for k in spec}
        return shard_tensor(x, spec, mesh, device)

    return {
        "embed": place(params["embed"], specs["embed"]),
        "layers": [{name: place(leaf, specs["layers"][name])
                    for name, leaf in layer.items()}
                   for layer in stage_block(params["layers"], mesh)],
        "ln_f": place(params["ln_f"], specs["ln_f"]),
        "lm_head": place(params["lm_head"], specs["lm_head"]),
    }


# ------------------------------------------------------------------- forward


def _local_heads(config: TransformerConfig, tp_group) -> tuple[int, int]:
    """(query heads, K/V heads) of one rank: all of them without a group,
    ``1/tp`` of each under tensor parallelism (of the ``lcm(kv_heads,
    tp)`` broadcast K/V heads where tp does not divide ``kv_heads``)."""
    tp = group_size(tp_group)
    return config.n_heads // tp, _kv_heads_local(config, tp)


def _embed(params: Params, tokens: torch.Tensor, config: TransformerConfig,
           tp_group) -> torch.Tensor:
    """The embedding rows of ``tokens`` in the compute dtype. Under tensor
    parallelism a rank holds the vocabulary rows ``[rank * V/tp, (rank + 1)
    * V/tp)``: it looks up the tokens that fall there, zeroes the others,
    and the ``all_reduce`` adds the one non-zero row of each token to
    zeros, exactly."""
    table = params["embed"].to(config.dtype)
    if tp_group is None:
        return table[tokens.long()]
    rows = table.shape[0]
    local = tokens.long() - group_rank(tp_group) * rows
    mine = (local >= 0) & (local < rows)
    h = table[local.clamp(0, rows - 1)].masked_fill(~mine[..., None], 0)
    return all_reduce_partial(h, tp_group)


def _logits(h: torch.Tensor, params: Params, config: TransformerConfig,
            tp_group) -> torch.Tensor:
    """The final norm and the lm_head: f32 logits over the whole
    vocabulary (a rank's column shard all-gathered under tensor
    parallelism)."""
    h = copy_to_group(rms_norm(h, params["ln_f"]), tp_group)
    logits = qeinsum("bld,dv->blv", h, params["lm_head"], config.dtype)
    return all_gather_cat(logits.float(), tp_group, dim=-1)


def _mlp_block(y: torch.Tensor, layer: Params, config: TransformerConfig,
               tp_group=None, ep_group=None, sp_group=None, batch_group=None,
               valid_len: int | None = None):
    """The post-attention MLP, dense SwiGLU or MoE, shared by the forward
    and every decode path. Returns ``(mlp, aux)``: the layer's MoE
    load-balancing loss (an f32 scalar; under batch axes the rank's share),
    or 0.0 for dense configs (the decode paths drop it). Under tensor
    parallelism ``w_gate``/``w_up`` hold the rank's columns and ``w_down``
    its rows, and the partial sums are all-reduced; an MoE layer's rank
    runs its experts (``ep_group``) on its ``d_ff`` shard and its f32
    partial is reduced once over tp and ep. ``sp_group``: ``y`` is the
    rank's block of a sequence-parallel forward (MoE routes it as part of
    the whole sequence, its first ``valid_len`` positions); ``batch_group``:
    the rank's rows of a batch sharded over the batch axes."""
    c = config
    if c.n_experts:
        moe = layer["moe"]
        groups = tuple(g for g in (tp_group, ep_group) if g is not None)
        out, aux = moe_mlp(
            moe, y, n_experts=c.n_experts, top_k=c.moe_top_k,
            capacity_factor=c.moe_capacity_factor, dtype=c.dtype,
            group_size=c.moe_group_size, dropless=c.moe_dropless,
            expert_offset=group_rank(ep_group) * moe["we_gate"].shape[0],
            partial_group=groups or None, sp_group=sp_group,
            batch_group=batch_group, valid_len=valid_len,
        )
        if groups:
            out = all_reduce_partial(out, groups).to(c.dtype)
        return out, aux
    y = copy_to_group(y, tp_group)
    gate = qeinsum("bld,df->blf", y, layer["w_gate"], c.dtype)
    up = qeinsum("bld,df->blf", y, layer["w_up"], c.dtype)
    mlp = qeinsum("blf,fd->bld", F.silu(gate) * up, layer["w_down"], c.dtype)
    return all_reduce_partial(mlp, tp_group), 0.0


def _whole_over_fsdp(layer: Params, config: TransformerConfig,
                     fsdp_group) -> Params:
    """One layer's weights whole over fsdp: each leaf that ``param_specs``
    shards over fsdp all-gathered along that dim (``gather_shards``, whose
    backward sums the ranks' gradients and keeps the rank's block); an
    int8 leaf's ``q`` and its column scales alike."""
    if fsdp_group is None:
        return layer
    specs = _specs(config, ("fsdp",))["layers"]

    def whole(leaf, spec):
        if is_quantized(leaf):
            return {"q": whole(leaf["q"], spec), "s": whole(leaf["s"], spec[1:])}
        if isinstance(leaf, dict):
            return {k: whole(leaf[k], spec[k]) for k in leaf}
        if "fsdp" not in spec:
            return leaf
        return gather_shards(leaf, fsdp_group, spec.index("fsdp"))

    return {name: whole(leaf, specs[name]) for name, leaf in layer.items()}


def _attention(q, k, v, sp_attention: str = "ring", sp_group=None,
               causal: bool = True, window: int | None = None):
    """Attention of a layer (JAX's ``_attention``: causal by default,
    ``causal=False`` for the encoders, the ViT): the rank's own sequence
    through ``local_attention``, or across the sp ranks by ring attention
    or Ulysses per ``sp_attention``, the sliding window threaded to each."""
    if sp_attention not in ("ring", "ulysses"):
        raise ValueError(
            f"sp_attention must be 'ring' or 'ulysses', got {sp_attention!r}"
        )
    if sp_group is None:
        return local_attention(q, k, v, causal=causal, window=window)
    if sp_attention == "ulysses":
        return ulysses_attention(q, k, v, group=sp_group, causal=causal,
                                 window=window)
    return ring_attention(q, k, v, group=sp_group, causal=causal,
                          window=window)


def _layer_apply(h, layer, config: TransformerConfig, positions,
                 return_kv: bool = False, tp_group=None, sp_group=None,
                 ep_group=None, fsdp_group=None, batch_group=None,
                 valid_len: int | None = None):
    """One decoder layer (JAX's ``_layer_apply``; with ``tp_group``, the
    rank's heads and its shard of the projections; with ``sp_group``, the
    rank's block of the sequence at its global ``positions``; with
    ``fsdp_group``, the layer's fsdp shards gathered whole first). Returns
    ``(h, (k, v) | None, aux)``, K/V post-RoPE ``[B, kvh, L, dh]`` (the
    rank's heads under tensor parallelism, its positions under sp)."""
    c = config
    layer = _whole_over_fsdp(layer, c, fsdp_group)
    B, L = h.shape[0], h.shape[1]
    x = copy_to_group(rms_norm(h, layer["ln1"]), tp_group)
    dh = c.head_dim
    nh, kvh = _local_heads(c, tp_group)

    def proj(w, heads):
        out = qeinsum("bld,dk->blk", x, w, c.dtype)
        return out.reshape(B, L, heads, dh).transpose(1, 2)

    q = rope(proj(layer["wq"], nh), positions, c.rope_theta, c.rope_scaling)
    k = rope(proj(layer["wk"], kvh), positions, c.rope_theta, c.rope_scaling)
    v = proj(layer["wv"], kvh)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    attn = _attention(q, k, v, c.sp_attention, sp_group,
                      window=c.sliding_window)
    attn = attn.transpose(1, 2).reshape(B, L, nh * dh)
    o = qeinsum("blk,kd->bld", attn, layer["wo"], c.dtype)
    h = h + all_reduce_partial(o, tp_group)
    mlp, aux = _mlp_block(rms_norm(h, layer["ln2"]), layer, c, tp_group,
                          ep_group, sp_group, batch_group, valid_len)
    return h + mlp, ((k, v) if return_kv else None), aux


def _sequence_block(x: torch.Tensor, sp_group) -> torch.Tensor:
    """The rank's contiguous block of positions (dim 1) of ``x`` under sp:
    positions ``[r L/sp, (r+1) L/sp)``, JAX's sequence sharding."""
    sp = group_size(sp_group)
    if sp == 1:
        return x
    if x.shape[1] % sp:
        raise ValueError(
            f"sequence length {x.shape[1]} not divisible by sp={sp}")
    return split_to_group(x, sp_group, 1)


def _trunk(params: Params, tokens: torch.Tensor, config: TransformerConfig,
           return_kv: bool, tp_group, sp_group, ep_group, fsdp_group,
           batch_group, valid_len):
    """Every layer of ``forward``: ``(h, (K, V) | None, aux)``. Under sp
    ``tokens`` are the rank's block of positions."""
    c = config
    B, L = tokens.shape
    start = group_rank(sp_group) * L
    positions = (start + torch.arange(L, device=tokens.device)).expand(B, L)
    h = _embed(params, tokens, c, tp_group)
    ks, vs = [], []
    aux = 0.0
    for layer in params["layers"]:
        h, kv, layer_aux = _layer_apply(h, layer, c, positions, return_kv,
                                        tp_group, sp_group, ep_group,
                                        fsdp_group, batch_group, valid_len)
        aux = aux + layer_aux
        if return_kv:
            ks.append(kv[0])
            vs.append(kv[1])
    kv = (torch.stack(ks), torch.stack(vs)) if return_kv else None
    if not torch.is_tensor(aux):
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h, kv, aux


def forward(params: Params, tokens: torch.Tensor, config: TransformerConfig,
            return_kv: bool = False, return_aux: bool = False,
            tp_group=None, sp_group=None, ep_group=None, fsdp_group=None,
            batch_group=None, valid_len: int | None = None):
    """Logits ``[B, L, vocab]`` in f32; with ``return_kv`` also the
    per-layer K/V stacked ``[n_layers, B, kv_heads, L, head_dim]``; with
    ``return_aux`` also the MoE load-balancing loss summed over layers, an
    f32 scalar (0.0 for dense configs). With ``tp_group`` the params are
    this rank's shard (``shard_params``), the K/V its heads, and the logits
    the whole vocabulary on every rank. With ``sp_group`` (L divisible by
    sp) the rank runs positions ``[r L/sp, (r+1) L/sp)`` of ``tokens``
    (every rank passes all of them): the logits and K/V are that block's,
    ``[B, L/sp, ...]``; positions from ``valid_len`` on are padding, which
    MoE layers keep out of their routing. With ``fsdp_group`` the params
    hold their fsdp shards, gathered one layer at a time. With
    ``batch_group`` (the dp/fsdp groups) ``tokens`` are the rank's rows of
    a batch sharded over them: MoE routes them with the other ranks' rows
    where JAX's routing groups span ranks, and the aux is the rank's share
    (the shares sum to the aux of the whole batch)."""
    tokens = _sequence_block(tokens, sp_group)
    h, kv, aux = _trunk(params, tokens, config, return_kv, tp_group,
                        sp_group, ep_group, fsdp_group, batch_group,
                        valid_len)
    logits = _logits(h, params, config, tp_group)
    extras = []
    if return_kv:
        extras.append(kv)
    if return_aux:
        extras.append(aux)
    if extras:
        return (logits, *extras)
    return logits


def _pipelined_trunk(params: Params, tokens: torch.Tensor,
                     config: TransformerConfig, mesh, n_microbatches: int,
                     return_aux: bool):
    """The embedding and the rank's block of layers through the pipeline:
    ``(h, aux)`` of the rank's rows."""
    c = config
    if c.n_experts and not return_aux:
        # training MoE without the load-balancing term drives the experts
        # toward collapse (JAX :560-566)
        raise ValueError(
            "MoE configs require return_aux=True on forward_pipelined: the "
            "load-balancing aux loss must reach the objective"
        )
    B = tokens.shape[0]
    if B % n_microbatches != 0:
        raise ValueError(
            f"batch {B} not divisible into {n_microbatches} microbatches"
        )
    g = mesh_groups(mesh)
    inside = [a for a in ("tp", "sp", "ep") if g.size(a) > 1]
    if inside:
        raise NotImplementedError(
            f"forward_pipelined over {inside}: a stage runs whole layers (as "
            "JAX's, whose tp/sp inside stages would need a nested shard_map); "
            "use forward / loss_fn for those axes"
        )
    h = _embed(params, tokens, c, None)

    def stage(h, layer):
        # microbatches split the batch: every row's positions are 0..L-1
        pos = torch.arange(h.shape[1], device=h.device).expand(h.shape[:2])
        h, _, aux = _layer_apply(h, layer, c, pos, fsdp_group=g.fsdp)
        return h, aux

    batch_axes = tuple(a for a in ("dp", "fsdp") if g.size(a) > 1)
    return spmd_pipeline(stage, params["layers"], h, mesh=mesh,
                         n_microbatches=n_microbatches,
                         batch_axes=batch_axes, with_aux=True)


def forward_pipelined(params: Params, tokens: torch.Tensor,
                      config: TransformerConfig, mesh, n_microbatches: int,
                      return_aux: bool = False):
    """Pipeline-parallel forward (JAX's ``forward_pipelined``): the rank's
    block of layers (``shard_params`` / ``Transformer.init`` under the
    ``pp`` mesh) as its stage, microbatches (splits of the batch dim)
    streamed through ``spmd_pipeline``; the embedding, final norm and
    lm_head run outside the pipeline on every stage. ``tokens`` ``[B, L]``
    are the rank's rows of a batch sharded over dp/fsdp (``batch_slice``).
    Returns f32 logits ``[B, L, vocab]``, the same on every stage, and
    with ``return_aux`` the MoE aux averaged over the microbatches and the
    batch axes. MoE configs require ``return_aux`` (ValueError); routing
    pools are per microbatch, so logits equal ``forward``'s only drop-free.
    Differentiable: a loss that every stage computes from the logits
    counts once (``parallel/pipeline.py``)."""
    h, aux = _pipelined_trunk(params, tokens, config, mesh, n_microbatches,
                              return_aux)
    logits = _logits(h, params, config, None)
    return (logits, aux) if return_aux else logits


def gather_prefill(logits: torch.Tensor, kv, last: int, sp_group):
    """The whole prompt's prefill from a sequence-parallel
    ``forward(return_kv=True)``: the K/V blocks all-gathered over sp along
    the sequence (``[n_layers, B, kvh, L, dh]`` on every rank), and the
    logits at global position ``last`` (``[B, vocab]``), broadcast from the
    rank whose block holds it; nothing else of the logits moves. Without
    sp, the inputs as they are."""
    k, v = kv
    if sp_group is None:
        return logits[:, last, :], (k, v)
    L = logits.shape[1]
    owner = last // L
    row = broadcast_from(logits[:, last - owner * L, :].contiguous(), owner,
                         sp_group)
    return row, (all_gather_cat(k, sp_group, dim=3),
                 all_gather_cat(v, sp_group, dim=3))


# ------------------------------------------------------------ cached decode


def _grouped_attention(q, kf, vf, positions, config: TransformerConfig):
    """The decode einsums of both cache layouts: queries ``[B, nh, W, dh]``
    at ``positions [B, W]`` over K (f32) and V ``[B, kvh, S, dh]``; slot s
    is visible to a query at position p when s <= p (and within the
    sliding window). Returns ``[B, W, nh * dh]``."""
    c = config
    B, nh, W, dh = q.shape
    kvh, S = kf.shape[1], kf.shape[2]
    qg = q.reshape(B, kvh, nh // kvh, W, dh).float()
    scores = torch.einsum("bgrwd,bgsd->bgrws", qg, kf) / math.sqrt(dh)
    slots = torch.arange(S, device=q.device)[None, None, :]
    visible = slots <= positions[:, :, None]  # [B, W, S]
    if c.sliding_window is not None:
        visible &= slots > positions[:, :, None] - c.sliding_window
    scores = scores.masked_fill(~visible[:, None, None, :, :], float("-inf"))
    weights = torch.softmax(scores, dim=-1).to(c.dtype)
    attn = torch.einsum("bgrws,bgsd->bgrwd", weights, vf)
    return attn.permute(0, 3, 1, 2, 4).reshape(B, W, nh * dh)


def _decode_layers(params, tokens, positions, cache, config, attend,
                   lora_delta=None, tp_group=None, ep_group=None,
                   fsdp_group=None):
    """The layer loop both decode families share: ``attend(c_layer, q,
    k_new, v_new)`` writes the new K/V ``[B, kvh, W, dh]`` into one layer's
    cache views and returns the attention ``[B, W, nh * dh]``;
    ``lora_delta(li, x, name)``, when given, returns the adapter delta
    added to projection ``name`` of layer ``li`` (None for a projection
    without one). With ``tp_group``, nh and kvh are the rank's heads and
    ``wo``/``w_down`` end in an all-reduce (the ``wo`` delta joins the
    partial sum before it); ``ep_group`` shards the experts; with
    ``fsdp_group`` each layer's fsdp shards are gathered whole first (as
    training does, a layer at a time). Returns f32 logits ``[B, W,
    vocab]``."""
    c = config
    B, W = tokens.shape
    dh = c.head_dim
    nh, kvh = _local_heads(c, tp_group)
    h = _embed(params, tokens, c, tp_group)  # [B, W, D]
    for li, layer in enumerate(params["layers"]):
        layer = _whole_over_fsdp(layer, c, fsdp_group)
        c_layer = {name: x[li] for name, x in cache.items()}  # views

        def project(x_in, name, spec):
            out = qeinsum(spec, x_in, layer[name], c.dtype)
            delta = lora_delta(li, x_in, name) if lora_delta else None
            return out if delta is None else out + delta

        x = rms_norm(h, layer["ln1"])

        def proj(name, heads):
            out = project(x, name, "bld,dk->blk")
            return out.reshape(B, W, heads, dh).transpose(1, 2)

        q = rope(proj("wq", nh), positions, c.rope_theta, c.rope_scaling)
        k_new = rope(proj("wk", kvh), positions, c.rope_theta, c.rope_scaling)
        v_new = proj("wv", kvh)
        attn = attend(c_layer, q, k_new, v_new)
        h = h + all_reduce_partial(project(attn, "wo", "blk,kd->bld"),
                                   tp_group)
        h = h + _mlp_block(rms_norm(h, layer["ln2"]), layer, c, tp_group,
                           ep_group)[0]
    return _logits(h, params, c, tp_group)


def alloc_decode_cache(config: TransformerConfig, B: int, total_len: int,
                       device: torch.device | str | None = None,
                       kv_heads: int | None = None) -> dict:
    """Zeroed contiguous decode cache, k/v ``[n_layers, B, kvh, total_len,
    dh]`` in the compute dtype, or int8 with f32 scale leaves ``k_s``/``v_s``
    (last axis 1) for ``kv_cache_dtype="int8"``; ``kvh`` is ``kv_heads``
    (default ``config.kv_heads``; a tensor-parallel rank's share).
    ``device`` defaults to CUDA (raises without it)."""
    c = config
    device = resolve_device(device)
    shape = (c.n_layers, B, kv_heads or c.kv_heads, total_len, c.head_dim)
    if c.kv_cache_dtype == "int8":
        scales = shape[:-1] + (1,)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_s": torch.zeros(scales, dtype=torch.float32, device=device),
            "v_s": torch.zeros(scales, dtype=torch.float32, device=device),
        }
    return {"k": torch.zeros(shape, dtype=c.dtype, device=device),
            "v": torch.zeros(shape, dtype=c.dtype, device=device)}


def init_decode_cache(config: TransformerConfig, B: int, total_len: int,
                      k_pre: torch.Tensor, v_pre: torch.Tensor) -> dict:
    """The full-length decode cache seeded with the prefill K/V
    ``[n_layers, B, kvh, L, dh]`` through the append the decode uses (kvh:
    a tensor-parallel rank's share, as ``k_pre`` holds)."""
    cache = alloc_decode_cache(config, B, total_len, k_pre.device,
                               kv_heads=k_pre.shape[2])
    return cache_append(cache, k_pre, v_pre, 0)


def decode_step(params, token, pos, cache, config: TransformerConfig,
                tp_group=None, ep_group=None, fsdp_group=None):
    """One incremental decode step: ``decode_window`` with W = 1."""
    return decode_window(params, token, pos, cache, config, tp_group,
                         ep_group, fsdp_group)


def decode_window(
    params: Params,
    tokens: torch.Tensor,  # [B, W] — W consecutive tokens
    pos0: int,  # position of tokens[:, 0], the same for every row
    cache: dict,  # alloc_decode_cache layout (updated in place)
    config: TransformerConfig,
    tp_group=None,
    ep_group=None,
    fsdp_group=None,
):
    """Multi-token cached decode at positions ``pos0 .. pos0 + W - 1``
    against the contiguous cache, bf16 or int8. Returns ``(logits [B, W,
    vocab] f32, cache)``; the cache is written in place. With
    ``tp_group`` the cache holds the rank's K/V heads; with ``fsdp_group``
    the params hold their fsdp shards, gathered a layer at a time."""
    B, W = tokens.shape
    pos0 = int(pos0)
    positions = (pos0 + torch.arange(W, device=tokens.device)).expand(B, W)

    def attend(c_layer, q, k_new, v_new):
        cache_append(c_layer, k_new, v_new, pos0)
        kf, vf = cache_read(c_layer, config.dtype)
        return _grouped_attention(q, kf, vf, positions, config)

    return _decode_layers(params, tokens, positions, cache, config, attend,
                          tp_group=tp_group, ep_group=ep_group,
                          fsdp_group=fsdp_group), cache


def decode_step_paged(params, token, pos, cache, block_table,
                      config: TransformerConfig, lora_bank=None,
                      adapter_idx=None, lora_scale: float = 1.0,
                      tp_group=None, ep_group=None):
    """One decode step over the paged pool: ``decode_window_paged`` with
    W = 1, as in the JAX package."""
    return decode_window_paged(params, token, pos, cache, block_table, config,
                               lora_bank, adapter_idx, lora_scale, tp_group,
                               ep_group)


def decode_window_paged(
    params: Params,
    tokens: torch.Tensor,  # [B, W] — W consecutive tokens per row
    pos0: torch.Tensor,  # [B] — per-row position of tokens[:, 0]
    cache: dict,  # ops/paged_kv_cache.alloc_paged_cache pool (updated in place)
    block_table: torch.Tensor,  # [B, P] int32 logical block -> physical page
    config: TransformerConfig,
    lora_bank: dict | None = None,  # {target: {A: [n_layers, n_adapters, d, r], B: ...}}
    adapter_idx: torch.Tensor | None = None,  # [B] per-row adapter
    lora_scale: float = 1.0,
    tp_group=None,
    ep_group=None,
):
    """Multi-token decode over the paged pool (bf16 or int8) with per-row
    positions. Returns ``(logits [B, W, vocab] f32, cache)``; the pool is
    written in place (JAX donates it instead). A token whose position lies
    past the block table writes nothing, as JAX's scatter drops it.

    Attention is the JAX einsum path (``paged_read`` + grouped einsums), or
    the paged decode kernel under exactly the JAX gate:
    ``paged_attention_kernel and W == 1 and "k_s" not in c_layer and
    sliding_window is None`` (the bank does not enter it).

    ``lora_bank`` is multi-LoRA serving (``models/lora.py::stack_lora_bank``):
    row b adds ``x @ A[adapter_idx[b]] @ B[adapter_idx[b]] * lora_scale`` to
    each targeted attention projection, unmerged, so rows under different
    adapters share one pass over the base weights.

    With ``tp_group`` the pool holds the rank's K/V heads (axis 2 of each
    leaf), and the kernel runs over the rank's query heads. The bank stays
    whole on every rank: ``wq``/``wk``/``wv`` take the rank's columns of
    ``B`` (``x @ A`` is computed whole), ``wo`` the rank's rows of ``A``
    (its heads' activations), whose delta is added to the rank's partial
    ``o`` before the all-reduce ``wo`` makes anyway."""
    c = config
    B, W = tokens.shape
    dev = tokens.device
    lora_delta = None
    if lora_bank is not None:
        if adapter_idx is None:
            raise ValueError("lora_bank needs adapter_idx")
        unknown = set(lora_bank) - {"wq", "wk", "wv", "wo"}
        if unknown:
            raise ValueError(
                f"lora_bank targets {sorted(unknown)} unsupported in the "
                "decode path (attention projections only)"
            )
        idx = adapter_idx.to(dev).long()
        scale = torch.tensor(lora_scale, dtype=c.dtype, device=dev)
        shards = _lora_shards(c, tp_group, dev)

        def lora_delta(li, x_in, name):
            if name not in lora_bank:
                return None
            Ab = lora_bank[name]["A"][li][idx].to(c.dtype)  # [B, d, r]
            Bb = lora_bank[name]["B"][li][idx].to(c.dtype)  # [B, r, o]
            if name == "wo" and "wo" in shards:
                Ab = Ab.index_select(1, shards["wo"])
            elif name in shards:
                Bb = Bb.index_select(2, shards[name])
            return torch.einsum(
                "blr,bro->blo", torch.einsum("bld,bdr->blr", x_in, Ab), Bb
            ) * scale

    ps = cache["k"].shape[3]
    P = block_table.shape[1]
    positions = pos0.long()[:, None] + torch.arange(W, device=dev)[None, :]
    block = positions // ps
    page_idx = torch.gather(block_table.long(), 1, block.clamp(max=P - 1))
    slot_idx = positions % ps
    in_table = block < P
    use_kernel = (c.paged_attention_kernel and W == 1 and "k_s" not in cache
                  and c.sliding_window is None)
    if use_kernel:
        bt32 = block_table.to(torch.int32).contiguous()
        lengths = (positions[:, 0] + 1).to(torch.int32)

    def attend(c_layer, q, k_new, v_new):
        paged_append(c_layer, k_new.transpose(1, 2), v_new.transpose(1, 2),
                     page_idx, slot_idx, valid=in_table)
        if use_kernel:
            attn = paged_decode_attention(
                q[:, :, 0, :].contiguous(), c_layer["k"], c_layer["v"],
                bt32, lengths,
            )
            return attn.reshape(B, 1, -1).to(c.dtype)
        kf, vf = paged_read(c_layer, block_table, c.dtype)
        return _grouped_attention(q, kf, vf, positions, c)

    logits = _decode_layers(params, tokens, positions, cache, c, attend,
                            lora_delta, tp_group, ep_group)
    return logits, cache


def _lora_shards(config: TransformerConfig, tp_group, device) -> dict:
    """Under tensor parallelism, the index of the rank's share of each
    bank target: the ``B`` columns of ``wq`` and of ``wk``/``wv`` (those of
    ``kv_columns``), the ``A`` rows of ``wo``; empty without a group."""
    tp = group_size(tp_group)
    if tp == 1:
        return {}
    rank = group_rank(tp_group)
    n = config.n_heads // tp * config.head_dim
    heads = torch.arange(rank * n, (rank + 1) * n, device=device)
    kv = kv_columns(config, tp, rank).to(device)
    return {"wq": heads, "wo": heads, "wk": kv, "wv": kv}


def prefill_chunked(params: Params, prompt: torch.Tensor,
                    config: TransformerConfig, total_len: int,
                    chunk: int = 512, tp_group=None, ep_group=None,
                    fsdp_group=None):
    """The decode cache built by streaming the prompt ``[B, L]`` through
    ``decode_window`` in chunks of ``chunk`` tokens (activation memory
    bounded by the chunk), then a remainder chunk of ``L % chunk``.
    Returns ``(last-position logits [B, vocab], cache)``; with ``tp_group``
    the cache holds the rank's K/V heads; ``fsdp_group`` as in
    ``decode_window``."""
    B, L = prompt.shape
    if L == 0:
        raise ValueError("prompt must be non-empty (L >= 1)")
    if total_len < L:
        raise ValueError(
            f"total_len ({total_len}) must cover the prompt length ({L})"
        )
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    cache = alloc_decode_cache(config, B, total_len, prompt.device,
                               kv_heads=_local_heads(config, tp_group)[1])
    last_logits = None
    for start in range(0, L, chunk):
        logits, cache = decode_window(params, prompt[:, start:start + chunk],
                                      start, cache, config, tp_group,
                                      ep_group, fsdp_group)
        last_logits = logits[:, -1, :]
    return last_logits, cache


# ----------------------------------------------------------------- sampling


def sample_logits(logits: torch.Tensor, generator: torch.Generator | None,
                  temperature: float = 0.0, top_k: int | None = None,
                  top_p: float | None = None) -> torch.Tensor:
    """Next tokens ``[B, 1]`` (int64) from ``[B, V]`` logits: the exact
    argmax at ``temperature == 0``, else one draw from ``generator`` over
    the temperature-scaled logits after ``filter_logits``. JAX draws from a
    key instead, so sampled tokens differ between the two; the filters and
    the greedy path agree."""
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1, keepdim=True)
    x = filter_logits(logits / temperature, top_k, top_p)
    probs = torch.softmax(x, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)


def filter_logits(x: torch.Tensor, top_k: int | None = None,
                  top_p: float | None = None) -> torch.Tensor:
    """The sampling filters on ``[B, V]`` temperature-scaled logits, masked
    to -inf: top-k keeps every logit >= the k-th largest (ties included);
    then the nucleus keeps the shortest prefix of the stable descending
    order whose mass before each token is < ``top_p``, and always the top
    token."""
    if top_k is not None:
        kth = torch.topk(x, top_k, dim=-1).values[:, -1:]
        x = torch.where(x >= kth, x, float("-inf"))
    if top_p is not None:
        order = torch.argsort(-x, dim=-1, stable=True)
        probs = torch.softmax(torch.gather(x, -1, order), dim=-1)
        keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < top_p
        keep_sorted[:, 0] = True
        keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
        x = torch.where(keep, x, float("-inf"))
    return x


# ---------------------------------------------------------------- loss/train


def _token_losses(h: torch.Tensor, params: Params, targets: torch.Tensor,
                  config: TransformerConfig, tp_group) -> torch.Tensor:
    """Each position's ``nll + z_loss * logz**2`` ``[B, L]`` (f32) from the
    last hidden state. Under tensor parallelism the logits stay sharded
    over the vocabulary (``[B, L, V/tp]`` a rank, never gathered): the
    logsumexp from the max and the sum of exps all-reduced over tp, the
    target logit from the rank whose shard holds it, the z-loss from that
    logsumexp."""
    h = copy_to_group(rms_norm(h, params["ln_f"]), tp_group)
    logits = qeinsum("bld,dv->blv", h, params["lm_head"], config.dtype).float()
    targets = targets.long()
    if tp_group is None:
        logz = torch.logsumexp(logits, dim=-1)
        target_logit = torch.gather(logits, -1, targets[..., None])[..., 0]
    else:
        top = logits.detach().amax(dim=-1, keepdim=True)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=tp_group)
        sumexp = all_reduce_partial((logits - top).exp().sum(dim=-1), tp_group)
        logz = top[..., 0] + sumexp.log()
        rows = logits.shape[-1]
        local = targets - group_rank(tp_group) * rows
        mine = (local >= 0) & (local < rows)
        picked = torch.gather(logits, -1, local.clamp(0, rows - 1)[..., None])
        target_logit = all_reduce_partial(
            picked[..., 0].masked_fill(~mine, 0.0), tp_group)
    # z-loss keeps logits from drifting (stability at bf16)
    return logz - target_logit + config.z_loss * logz**2


def loss_fn(params: Params, batch: dict[str, torch.Tensor],
            config: TransformerConfig, mesh=None,
            n_microbatches: int | None = None) -> torch.Tensor:
    """Mean next-token NLL over f32 logits plus the z-loss
    ``z_loss * logz**2`` and the MoE aux term, as the JAX ``loss_fn``
    (tokens and targets ``[B, L]``). Under a ``mesh`` (dp, fsdp, tp, sp,
    ep) ``params`` are the rank's shard and ``batch`` its block of the
    global batch (``Transformer.batch_slice``: its rows, and under sp its
    positions): the value is the loss of the global batch, the same bits on
    every rank (the ranks' shares summed in f32), and its gradient is the
    rank's share of the global gradient, which ``reduce_gradients`` sums
    over the batch axes and sp. Under a ``pp`` mesh the layers run through
    the pipeline in ``n_microbatches`` (``forward_pipelined``), and the
    same value and gradients come out on every stage."""
    g = mesh_groups(mesh)
    batch_group = g.batch or None
    if g.pp is not None:
        if n_microbatches is None:
            raise ValueError("a pp mesh trains through the pipeline: pass "
                             "n_microbatches")
        h, aux = _pipelined_trunk(params, batch["tokens"], config, mesh,
                                  n_microbatches, True)
        losses = _token_losses(h, params, batch["targets"], config, None)
        n_shards = batch_shard_of(batch_group)[1]
        share = losses.sum() / (losses.numel() * n_shards)
        # the aux is already the global batch's on every rank
        return (all_reduce_partial(share, batch_group)
                + config.moe_aux_weight * aux)
    h, _, aux = _trunk(params, batch["tokens"], config, False, g.tp, g.sp,
                       g.ep, g.fsdp, batch_group, None)
    losses = _token_losses(h, params, batch["targets"], config, g.tp)
    shards = tuple(x for x in (*g.batch, g.sp) if x is not None)
    if not shards:
        return losses.mean() + config.moe_aux_weight * aux
    n_shards = batch_shard_of(shards)[1]
    share = losses.sum() / (losses.numel() * n_shards)
    # the aux is a share over the batch axes and whole on every sp rank
    aux = aux / g.size("sp")
    return all_reduce_partial(share + config.moe_aux_weight * aux, shards)


def _adamw(params: Params, *, lr: float) -> torch.optim.AdamW:
    # optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=0.1) and this are the
    # same algebra: optax adds wd * p to the Adam update before scaling by
    # -lr, PyTorch multiplies p by (1 - lr * wd) first and then takes the
    # Adam step; both give p - lr * (adam + wd * p). eps is optax's default.
    return torch.optim.AdamW(param_leaves(params), lr=lr, betas=(0.9, 0.95),
                             weight_decay=0.1, eps=1e-8)


class Transformer:
    """Config bundle with the training and generation entry points of the
    JAX ``Transformer``.

    Under a ``mesh`` (``parallel.make_mesh``) every rank calls the entry
    points alike, on its shard of the params. The inference entry points
    (``apply``, ``generate``, ``generate_cached``) run over dp, fsdp, tp,
    sp and ep: ``apply`` gives the rank's block of positions under sp, the
    generators the same whole ``[B, L + new]`` tokens on every rank (each
    batch coordinate prefills and decodes its rows, JAX's batch sharding;
    the prefill runs sequence-parallel, the decode steps ignore sp). Training (``init``, ``make_train_step``)
    runs over dp, fsdp, tp, sp and ep, and through the pipeline over pp:
    ``init`` draws the f32 masters and keeps the rank's shard
    (``param_specs``; under pp its block of layers), ``batch_slice`` gives
    the rank's rows of a global batch (under sp, its block of positions of
    them), and the step's loss is the global batch's on every rank;
    ``apply`` then takes the rank's rows too. Under pp the forward is
    ``forward_pipelined`` (``apply`` and the generators raise)."""

    def __init__(self, config: TransformerConfig, mesh=None) -> None:
        self.config = config
        self.mesh = mesh
        self.groups = mesh_groups(mesh)
        self.tp_group = self.groups.tp

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole batch under the batch axes (dp,
        then fsdp; ValueError when they do not divide it, where JAX's
        sharding raises too), the batch itself without them."""
        return batch_slice(x, self.mesh) if self.groups.batch else x

    def _whole_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' rows gathered back into the whole batch (dim 0, dp
        major: ``batch_shard_of``'s order), on every rank."""
        for g in reversed(self.groups.batch):
            x = all_gather_cat(x.contiguous(), g, dim=0)
        return x

    def _forward(self, params: Params, tokens: torch.Tensor,
                 return_kv: bool = False, valid_len: int | None = None):
        g = self.groups
        if g.pp is not None:
            raise NotImplementedError(
                "a rank of a pp mesh holds its block of layers: its forward "
                "is forward_pipelined"
            )
        return forward(params, tokens, self.config, return_kv=return_kv,
                       tp_group=g.tp, sp_group=g.sp, ep_group=g.ep,
                       fsdp_group=g.fsdp, batch_group=g.batch or None,
                       valid_len=valid_len)

    def _prefill(self, params: Params, tokens: torch.Tensor,
                 return_kv: bool, last: int | None = None):
        """The logits ``[B, vocab]`` at position ``last`` of ``tokens``
        (default the last), and with ``return_kv`` the K/V of every
        position: under sp the tokens are padded on the right to a multiple
        of sp (pad tokens are causally invisible to the real ones, and MoE
        layers keep them out of their routing pool, so a capacity-routed
        prompt routes as it does unsharded) and ``gather_prefill`` takes
        the row and the K/V. JAX refuses a prompt that does not divide over
        sp; the port pads it (ROADMAP Queue 3, an intended divergence)."""
        L = tokens.shape[1]
        last = L - 1 if last is None else last
        sp = self.groups.size("sp")
        if sp == 1:
            if return_kv:
                logits, kv = self._forward(params, tokens, True)
                return logits[:, last, :], kv
            return self._forward(params, tokens)[:, last, :], None
        padded = torch.nn.functional.pad(tokens, (0, -L % sp))
        logits, kv = self._forward(params, padded, True, valid_len=L)
        row, (k, v) = gather_prefill(logits, kv, last, self.groups.sp)
        return row, (k[..., :L, :], v[..., :L, :])

    def init(self, generator: torch.Generator,
             device: torch.device | str | None = None) -> Params:
        """f32 master weights that require grad, on ``device`` (default
        CUDA; raises without it); compute runs in ``config.dtype``. Under a
        mesh, the rank's shard of them (``init_params(mesh=...)``: every
        rank passes a generator of the same seed)."""
        if self.mesh is not None and device is None:
            device = self.mesh.device_type
        return init_params(self.config, generator, device,
                           dtype=torch.float32, requires_grad=True,
                           mesh=self.mesh)

    def apply(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return self._forward(params, tokens)

    def batch_slice(self, batch: dict[str, torch.Tensor]) -> dict:
        """This rank's block of a global batch: the rows (each value's dim
        0) over the batch axes, dp then fsdp, dp major, and under sp its
        contiguous block of positions (dim 1): the counterpart of JAX's
        ``batch_sharding()``, ``P(batch, "sp")``. The whole batch without a
        mesh."""
        if self.mesh is None:
            return dict(batch)
        return {name: _sequence_block(batch_slice(x, self.mesh),
                                      self.groups.sp)
                for name, x in batch.items()}

    def make_optimizer(self, learning_rate: float = 3e-4):
        """The JAX ``optax.adamw`` as a factory: called on the params it
        gives the optimizer state, a ``torch.optim.AdamW`` over every
        leaf (``param_leaves``; under a mesh the rank's shards, so the
        moments are sharded as the masters are)."""
        return functools.partial(_adamw, lr=learning_rate)

    def make_train_step(self, optimizer=None,
                        n_microbatches: int | None = None):
        """``train_step(params, opt_state, batch) -> (params, opt_state,
        loss)`` with the JAX signature. ``opt_state`` is ``optimizer(params)``
        (None makes it on the first step). The update is in place, where
        JAX donates params and state; the gradients stay on the leaves
        (``.grad``) until the next step. Under a mesh ``params`` are the
        rank's shard and ``batch`` its block (``batch_slice``); ``loss`` is
        the global batch's on every rank, and each gradient is summed over
        the batch axes and sp where its leaf is whole before the step
        (``reduce_gradients``), so a leaf replicated over an axis stays the
        same bits on every rank of it. Under a pp mesh the step runs the
        pipeline in ``n_microbatches`` (required there)."""
        if self.groups.pp is not None and n_microbatches is None:
            raise ValueError("a pp mesh trains through the pipeline: pass "
                             "n_microbatches")
        optimizer = optimizer or self.make_optimizer()
        config, mesh = self.config, self.mesh

        def train_step(params, opt_state, batch):
            if opt_state is None:
                opt_state = optimizer(params)
            opt_state.zero_grad(set_to_none=True)
            loss = loss_fn(params, batch, config, mesh, n_microbatches)
            loss.backward()
            if mesh is not None:
                reduce_gradients(
                    leaf_specs(params, param_specs(config, mesh)),
                    self.groups)
            opt_state.step()
            return params, opt_state, loss.detach()

        return train_step

    # ------------------------------------------------------------- generate

    def generate(self, params: Params, prompt: torch.Tensor,
                 max_new_tokens: int = 32) -> torch.Tensor:
        """Greedy decode without a cache: a full forward over the whole
        ``[B, L + max_new_tokens]`` buffer per new token (the simple
        correctness path). Returns the buffer, prompt included. Under batch
        axes each rank runs its rows and the argmax of every row is
        gathered, so every rank returns the whole buffer."""
        prompt = torch.as_tensor(prompt, device=params["embed"].device)
        B, L = prompt.shape
        tokens = torch.zeros(B, L + max_new_tokens, dtype=torch.long,
                             device=prompt.device)
        tokens[:, :L] = prompt
        for idx in range(L, L + max_new_tokens):
            row, _ = self._prefill(params, self._rows(tokens), False,
                                   last=idx - 1)
            tokens[:, idx] = self._whole_rows(torch.argmax(row, dim=-1))
        return tokens

    def generate_cached(
        self,
        params: Params,
        prompt: torch.Tensor,
        max_new_tokens: int = 32,
        *,
        temperature: float = 0.0,
        top_k: int | None = None,
        top_p: float | None = None,
        generator: torch.Generator | None = None,
        eos_id: int | None = None,
        prefill_chunk: int | None = None,
    ) -> torch.Tensor:
        """KV-cached decode: one prefill (``forward``, or ``prefill_chunked``
        with ``prefill_chunk``), then ``max_new_tokens - 1`` ``decode_step``
        calls; returns ``[B, L + max_new_tokens]`` tokens, prompt included.
        Greedy by default; ``temperature``/``top_k``/``top_p`` sample
        through ``sample_logits`` from ``generator`` (default: seed 0 on the
        prompt's device), so a fixed generator is deterministic. ``eos_id``
        freezes a row once it emits that token: every later position
        repeats it. The cache layout follows ``config.kv_cache_dtype``.
        Under a mesh every rank gets the same whole tokens: over the batch
        axes (dp, fsdp; fsdp gathers a layer's weights at a time, as
        training does) each rank prefills and decodes its rows with a cache
        of its rows, and each step's last logits are gathered into the
        whole batch before the draw, so every rank draws for the whole
        batch from the same generator seed and the tokens are the ones one
        device draws from the same logits."""
        c, g = self.config, self.groups
        prompt = torch.as_tensor(prompt, device=params["embed"].device)
        B, L = prompt.shape
        total = L + max_new_tokens
        if generator is None:
            generator = torch.Generator(device=prompt.device).manual_seed(0)
        rows = self._rows(prompt)
        if prefill_chunk is not None:
            last_logits, cache = prefill_chunked(
                params, rows, c, total, chunk=prefill_chunk, tp_group=g.tp,
                ep_group=g.ep, fsdp_group=g.fsdp)
        else:
            last_logits, (k_pre, v_pre) = self._prefill(params, rows, True)
            cache = init_decode_cache(c, rows.shape[0], total, k_pre, v_pre)
        current = sample_logits(self._whole_rows(last_logits), generator,
                                temperature, top_k, top_p)
        tokens = torch.zeros(B, total, dtype=torch.long, device=prompt.device)
        tokens[:, :L] = prompt
        tokens[:, L:L + 1] = current
        done = current == eos_id if eos_id is not None else None
        for pos in range(L, total - 1):
            step_logits, cache = decode_step(params, self._rows(current), pos,
                                             cache, c, g.tp, g.ep, g.fsdp)
            current = sample_logits(self._whole_rows(step_logits[:, -1, :]),
                                    generator, temperature, top_k, top_p)
            if eos_id is not None:
                current = torch.where(done, eos_id, current)
                done = done | (current == eos_id)
            tokens[:, pos + 1:pos + 2] = current
        return tokens
