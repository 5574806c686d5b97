"""Llama-style decoder in PyTorch: the serving and training slices of the
JAX package's ``models/transformer.py``.

Ported: ``TransformerConfig``, ``rms_norm``, ``rope`` (split-half layout),
the plain-array ``qeinsum``, ``init_params``, ``forward`` (``return_kv=True``
gives the per-layer K/V, ``return_aux=True`` the MoE aux loss), the paged
decode (``decode_window_paged`` / ``decode_step_paged``), ``loss_fn`` and
``Transformer`` (``init``, ``apply``, ``make_optimizer``,
``make_train_step``). Parameters are a plain dict: ``embed [V, D]``,
``layers`` (a list of per-layer dicts, where JAX stacks them on a leading
axis for ``lax.scan``), ``ln_f``, ``lm_head [D, V]``; weights keep JAX's
``[d_in, d_out]`` layout.

The JAX code keeps f32 master weights and casts them to ``config.dtype`` at
every einsum. Training does the same (``Transformer.init`` makes f32 masters
that require grad; ``qeinsum`` casts them). Serving casts once, when the
weights are made or loaded (``init_params``, ``weights.params_from_jax``), so
Llama-3-8B takes ~16 GB in bf16 instead of a 32 GB f32 master plus casts. The
values are the same.

Attention runs through the ops: prefill and training through the flash
attention ``autograd.Function`` (``ops/flash_attention.py``: forward kernel,
and the dK/dV and dQ kernels in the backward), decode through the paged
decode kernel when ``paged_attention_kernel`` is set
(``ops/paged_attention.py``), all kernels on CUDA tensors and their plain
versions on CPU tensors. Not ported yet and refused with
``NotImplementedError``: int8 weights, MoE, LoRA, meshes; ``generate`` and
``generate_cached`` wait for the contiguous decode family (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F

from bee_code_interpreter_tpu_torch.device import resolve_device
from bee_code_interpreter_tpu_torch.ops.flash_attention import local_attention
from bee_code_interpreter_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
)
from bee_code_interpreter_tpu_torch.ops.paged_kv_cache import (
    paged_append,
    paged_read,
)

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
    n_experts: int = 0  # MoE: not ported yet
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2
    moe_group_size: int = 1024
    moe_dropless: bool = False
    rope_scaling: float = 1.0  # linear position interpolation
    sp_attention: str = "ring"
    kv_cache_dtype: str = "bf16"  # "int8": not ported yet
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

    @classmethod
    def tiny(cls) -> "TransformerConfig":
        """Test size."""
        return cls(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                   max_seq_len=128, d_ff=128)

    @classmethod
    def llama3_8b(cls) -> "TransformerConfig":
        """The flagship config (Llama-3-8B shapes)."""
        return cls(vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, d_ff=14336, max_seq_len=8192)


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
    """Einsum against a weight leaf: the plain-array branch of the JAX
    ``qeinsum``. Weight-only-int8 leaves (``{"q", "s"}``) are not ported."""
    if isinstance(leaf, dict):
        raise NotImplementedError(
            "weight-only int8 leaves are not ported yet (ROADMAP Queue 1)"
        )
    return torch.einsum(spec, x, leaf.to(dtype))


# ------------------------------------------------------------------- weights


def init_params(
    config: TransformerConfig,
    generator: torch.Generator,
    device: torch.device | str | None = None,
    dtype: torch.dtype | None = None,
    requires_grad: bool = False,
) -> Params:
    """Random weights with the JAX ``init_params`` distributions
    (normal / sqrt(fan_in), ones for the norms), made straight in ``dtype``
    (default ``config.dtype``) on ``device`` (default CUDA; raises without
    it); ``requires_grad`` makes every leaf a trainable master. ``generator``
    must live on that device; the numbers differ from ``jax.random``'s, so
    tests that compare the two frameworks load JAX's weights through
    ``weights.params_from_jax`` instead."""
    c = config
    if c.n_experts:
        raise NotImplementedError("MoE is not ported yet (ROADMAP Queue 1)")
    device = resolve_device(device)
    dtype = dtype or c.dtype
    if generator.device.type != device.type:
        raise ValueError(
            f"generator is on {generator.device}, weights go to {device}"
        )

    def dense(fan_in, *shape):
        w = torch.randn(shape, generator=generator, device=device, dtype=dtype)
        return w.div_(math.sqrt(fan_in))

    def ones(n):
        return torch.ones(n, device=device, dtype=dtype)

    dh, kvh, d, f = c.head_dim, c.kv_heads, c.d_model, c.ff_dim
    layers = [
        {
            "ln1": ones(d),
            "wq": dense(d, d, c.n_heads * dh),
            "wk": dense(d, d, kvh * dh),
            "wv": dense(d, d, kvh * dh),
            "wo": dense(c.n_heads * dh, c.n_heads * dh, d),
            "ln2": ones(d),
            "w_gate": dense(d, d, f),
            "w_up": dense(d, d, f),
            "w_down": dense(f, f, d),
        }
        for _ in range(c.n_layers)
    ]
    params = {
        "embed": dense(d, c.vocab_size, d),
        "layers": layers,
        "ln_f": ones(d),
        "lm_head": dense(d, d, c.vocab_size),
    }
    for leaf in param_leaves(params):
        leaf.requires_grad_(requires_grad)
    return params


def param_leaves(params: Params) -> list[torch.Tensor]:
    """Every weight tensor in one fixed order (embed, each layer's leaves,
    ln_f, lm_head): what the optimizer steps and its state is indexed by."""
    return ([params["embed"]]
            + [w for layer in params["layers"] for w in layer.values()]
            + [params["ln_f"], params["lm_head"]])


def n_params(params: Params) -> int:
    """Parameter count (the weight bytes a decode step streams / itemsize)."""
    return sum(w.numel() for w in param_leaves(params))


# ------------------------------------------------------------------- forward


def _mlp_block(y: torch.Tensor, layer: Params, config: TransformerConfig):
    c = config
    if c.n_experts:
        raise NotImplementedError("MoE is not ported yet (ROADMAP Queue 1)")
    gate = qeinsum("bld,df->blf", y, layer["w_gate"], c.dtype)
    up = qeinsum("bld,df->blf", y, layer["w_up"], c.dtype)
    return qeinsum("blf,fd->bld", F.silu(gate) * up, layer["w_down"], c.dtype)


def _layer_apply(h, layer, config: TransformerConfig, positions,
                 return_kv: bool = False):
    """One decoder layer (the mesh-free JAX ``_layer_apply``). Returns
    ``(h, (k, v) | None)``, K/V post-RoPE ``[B, kvh, L, dh]``."""
    c = config
    B, L = h.shape[0], h.shape[1]
    x = rms_norm(h, layer["ln1"])
    dh, nh, kvh = c.head_dim, c.n_heads, c.kv_heads

    def proj(w, heads):
        out = qeinsum("bld,dk->blk", x, w, c.dtype)
        return out.reshape(B, L, heads, dh).transpose(1, 2)

    q = rope(proj(layer["wq"], nh), positions, c.rope_theta, c.rope_scaling)
    k = rope(proj(layer["wk"], kvh), positions, c.rope_theta, c.rope_scaling)
    v = proj(layer["wv"], kvh)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    attn = local_attention(q, k, v, causal=True, window=c.sliding_window)
    attn = attn.transpose(1, 2).reshape(B, L, nh * dh)
    h = h + qeinsum("blk,kd->bld", attn, layer["wo"], c.dtype)
    h = h + _mlp_block(rms_norm(h, layer["ln2"]), layer, c)
    return h, ((k, v) if return_kv else None)


def forward(params: Params, tokens: torch.Tensor, config: TransformerConfig,
            return_kv: bool = False, return_aux: bool = False):
    """Logits ``[B, L, vocab]`` in f32; with ``return_kv`` also the
    per-layer K/V stacked ``[n_layers, B, kv_heads, L, head_dim]``; with
    ``return_aux`` also the summed MoE load-balancing loss, an f32 0.0 for
    dense configs (MoE itself raises in ``_mlp_block``)."""
    c = config
    B, L = tokens.shape
    positions = torch.arange(L, device=tokens.device).expand(B, L)
    h = params["embed"].to(c.dtype)[tokens.long()]
    ks, vs = [], []
    for layer in params["layers"]:
        h, kv = _layer_apply(h, layer, c, positions, return_kv)
        if return_kv:
            ks.append(kv[0])
            vs.append(kv[1])
    h = rms_norm(h, params["ln_f"])
    logits = qeinsum("bld,dv->blv", h, params["lm_head"], c.dtype).float()
    extras = []
    if return_kv:
        extras.append((torch.stack(ks), torch.stack(vs)))
    if return_aux:
        extras.append(torch.zeros((), dtype=torch.float32, device=logits.device))
    if extras:
        return (logits, *extras)
    return logits


# ------------------------------------------------------------- paged decode


def decode_step_paged(params, token, pos, cache, block_table,
                      config: TransformerConfig, lora_bank=None):
    """One decode step over the paged pool: ``decode_window_paged`` with
    W = 1, as in the JAX package."""
    return decode_window_paged(params, token, pos, cache, block_table, config,
                               lora_bank)


def decode_window_paged(
    params: Params,
    tokens: torch.Tensor,  # [B, W] — W consecutive tokens per row
    pos0: torch.Tensor,  # [B] — per-row position of tokens[:, 0]
    cache: dict,  # ops/paged_kv_cache.alloc_paged_cache pool (updated in place)
    block_table: torch.Tensor,  # [B, P] int32 logical block -> physical page
    config: TransformerConfig,
    lora_bank=None,
):
    """Multi-token decode over the paged pool with per-row positions.
    Returns ``(logits [B, W, vocab] f32, cache)``; the pool is written in
    place (JAX donates it instead).

    Attention is the JAX einsum path (``paged_read`` + grouped einsums +
    ``visible`` mask), or the paged decode kernel under exactly the JAX
    gate: ``paged_attention_kernel and W == 1 and sliding_window is None``
    (the int8 pool that the gate also excludes is not ported)."""
    if lora_bank is not None:
        raise NotImplementedError("LoRA serving is not ported yet (ROADMAP Queue 1)")
    c = config
    B, W = tokens.shape
    dev = tokens.device
    ps = cache["k"].shape[3]
    P = block_table.shape[1]
    S = P * ps
    positions = pos0.long()[:, None] + torch.arange(W, device=dev)[None, :]
    page_idx = torch.gather(
        block_table.long(), 1, (positions // ps).clamp(max=P - 1)
    )
    slot_idx = positions % ps
    use_kernel = c.paged_attention_kernel and W == 1 and c.sliding_window is None
    if use_kernel:
        bt32 = block_table.to(torch.int32).contiguous()
        lengths = (positions[:, 0] + 1).to(torch.int32)
    dh, nh, kvh = c.head_dim, c.n_heads, c.kv_heads
    rep = nh // kvh

    h = params["embed"].to(c.dtype)[tokens.long()]  # [B, W, D]
    for li, layer in enumerate(params["layers"]):
        c_layer = {"k": cache["k"][li], "v": cache["v"][li]}
        x = rms_norm(h, layer["ln1"])

        def proj(w, heads):
            out = qeinsum("bld,dk->blk", x, w, c.dtype)
            return out.reshape(B, W, heads, dh).transpose(1, 2)

        q = rope(proj(layer["wq"], nh), positions, c.rope_theta, c.rope_scaling)
        k_new = rope(proj(layer["wk"], kvh), positions, c.rope_theta,
                     c.rope_scaling)
        v_new = proj(layer["wv"], kvh)
        paged_append(c_layer, k_new.transpose(1, 2), v_new.transpose(1, 2),
                     page_idx, slot_idx)
        if use_kernel:
            attn = paged_decode_attention(
                q[:, :, 0, :].contiguous(), c_layer["k"], c_layer["v"],
                bt32, lengths,
            ).reshape(B, 1, nh * dh).to(c.dtype)
        else:
            kf, vf = paged_read(c_layer, block_table, c.dtype)
            qg = q.reshape(B, kvh, rep, W, dh).float()
            scores = torch.einsum("bgrwd,bgsd->bgrws", qg, kf) / math.sqrt(dh)
            slots = torch.arange(S, device=dev)[None, None, :]
            visible = slots <= positions[:, :, None]  # [B, W, S]
            if c.sliding_window is not None:
                visible &= slots > positions[:, :, None] - c.sliding_window
            scores = scores.masked_fill(
                ~visible[:, None, None, :, :], float("-inf")
            )
            weights = torch.softmax(scores, dim=-1).to(c.dtype)
            attn = torch.einsum("bgrws,bgsd->bgrwd", weights, vf)
            attn = attn.permute(0, 3, 1, 2, 4).reshape(B, W, nh * dh)
        h = h + qeinsum("blk,kd->bld", attn, layer["wo"], c.dtype)
        h = h + _mlp_block(rms_norm(h, layer["ln2"]), layer, c)
    h = rms_norm(h, params["ln_f"])
    logits = qeinsum("bld,dv->blv", h, params["lm_head"], c.dtype)
    return logits.float(), cache


# ---------------------------------------------------------------- loss/train


def loss_fn(params: Params, batch: dict[str, torch.Tensor],
            config: TransformerConfig) -> torch.Tensor:
    """Mean next-token NLL over f32 logits plus the z-loss
    ``z_loss * logsumexp(logits)**2`` and the MoE aux term, as the JAX
    ``loss_fn`` (tokens and targets ``[B, L]``)."""
    logits, aux = forward(params, batch["tokens"], config, return_aux=True)
    logz = torch.logsumexp(logits, dim=-1)
    target_logit = torch.gather(
        logits, -1, batch["targets"].long()[..., None]
    )[..., 0]
    nll = logz - target_logit
    # z-loss keeps logits from drifting (stability at bf16)
    loss = nll + config.z_loss * logz**2
    return loss.mean() + config.moe_aux_weight * aux


def _adamw(params: Params, *, lr: float) -> torch.optim.AdamW:
    # optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=0.1) and this are the
    # same algebra: optax adds wd * p to the Adam update before scaling by
    # -lr, PyTorch multiplies p by (1 - lr * wd) first and then takes the
    # Adam step; both give p - lr * (adam + wd * p). eps is optax's default.
    return torch.optim.AdamW(param_leaves(params), lr=lr, betas=(0.9, 0.95),
                             weight_decay=0.1, eps=1e-8)


class Transformer:
    """Config bundle with the training entry points of the JAX
    ``Transformer`` (mesh-free; meshes are the parallel layer's slice)."""

    def __init__(self, config: TransformerConfig, mesh=None) -> None:
        if mesh is not None:
            raise NotImplementedError(
                "meshes are not ported yet (ROADMAP Queue 1 item 13)"
            )
        self.config = config

    def init(self, generator: torch.Generator,
             device: torch.device | str | None = None) -> Params:
        """f32 master weights that require grad, on ``device`` (default
        CUDA; raises without it); compute runs in ``config.dtype``."""
        return init_params(self.config, generator, device,
                           dtype=torch.float32, requires_grad=True)

    def apply(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return forward(params, tokens, self.config)

    def make_optimizer(self, learning_rate: float = 3e-4):
        """The JAX ``optax.adamw`` as a factory: called on the params it
        gives the optimizer state, a ``torch.optim.AdamW`` over every
        leaf (``param_leaves``)."""
        return functools.partial(_adamw, lr=learning_rate)

    def make_train_step(self, optimizer=None):
        """``train_step(params, opt_state, batch) -> (params, opt_state,
        loss)`` with the JAX signature. ``opt_state`` is ``optimizer(params)``
        (None makes it on the first step). The update is in place, where
        JAX donates params and state; the gradients stay on the leaves
        (``.grad``) until the next step."""
        optimizer = optimizer or self.make_optimizer()

        def train_step(params, opt_state, batch):
            if opt_state is None:
                opt_state = optimizer(params)
            opt_state.zero_grad(set_to_none=True)
            loss = loss_fn(params, batch, self.config)
            loss.backward()
            opt_state.step()
            return params, opt_state, loss.detach()

        return train_step
