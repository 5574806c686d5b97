"""Mixture-of-Experts MLP in PyTorch: the counterpart of the JAX package's
``models/moe.py``, computing the same function.

Routing is the JAX routing, rule for rule: softmax over f32 router logits,
the top ``top_k`` experts of each token (ties to the lower expert index,
as ``lax.top_k`` breaks them; bare ``torch.topk`` does not), the kept
gates renormalised with a 1e-9 floor, and GShard position-in-expert slots
handed out in token order with every top-1 choice before any top-2 choice.
A choice whose slot is past the expert's capacity is dropped: it
contributes exactly zero (the residual stream carries the token). The
load-balancing aux loss is ``E · Σ_e top1_fraction_e · mean_prob_e`` per
routing group, averaged over groups. Tokens route in groups of
``group_size`` (one global group when the count does not divide).

The expert products are not JAX's. There, static ``[groups, g, E, C]``
dispatch and combine tensors move tokens through dense einsums, a design
for the TPU's matrix unit and static shapes; under the dropless per-token
config (``moe_group_size=1``) that runs ``E · C`` slot rows a token for
``top_k`` useful ones. Here each shape takes what it needs:

- at most ``EVERY_EXPERT_MAX_TOKENS`` tokens (a decode step, a speculative
  verify window): every expert runs on every token and each result is
  weighted by its combine weight (zero for an expert not chosen or a
  dropped choice). The step streams every expert's weights anyway, so this
  moves no extra bytes, and it needs no host synchronisation;
- more tokens (prefills, admission windows, training): the kept
  (token, expert) pairs are sorted by expert, each expert's SwiGLU runs on
  its own rows only, and ``gate · out`` goes back to its (token, choice)
  place. One host read of the per-expert counts per call sizes the splits.

Both forms cast the combine weight to the compute dtype before the product
(JAX's ``combine.astype(dtype)``), multiply and sum in f32, and round once
to the compute dtype; a token's sum runs over its choices in a fixed
order, so either form is deterministic and they agree bitwise wherever the
expert products do. The expert products are plain ``torch`` matrix
products, as they are plain XLA products in JAX (no Pallas kernel).

Parameters keep the JAX layout: ``router [D, E]``, ``we_gate`` and
``we_up [E, D, F]``, ``we_down [E, F, D]``.

Under a mesh (``transformer.param_specs``: experts over ``ep``, each
expert's ``F`` over ``tp``, the router replicated) routing stays global and
the same on every rank, rule for rule; a rank runs only its ``E/ep``
experts (``expert_offset`` is the first), over its ``F/tp`` columns of
``we_gate``/``we_up`` and rows of ``we_down``, in either form, and returns
its f32 partial sum (``partial_group``), which the caller reduces once over
tp and ep. Under sequence parallelism (``sp_group``) a rank holds a block of
the sequence: the router logits are all-gathered over sp so that the
tokens route in the groups and slot order of the whole sequence, and each
rank keeps its own tokens' choices; a prompt padded to a multiple of sp
routes its real positions only (``valid_len``), so its groups and capacity
are the unpadded prompt's. In training under batch axes (``batch_group``)
a routing group that spans the ranks' rows routes from the router logits
gathered over them, so the capacity and the drops are JAX's. Training
under sp routes the same way (the gathered logits differentiable,
``gather_shards``): every sp rank computes the whole sequence's aux, and
the loss takes a 1/sp share of it on each (``transformer.loss_fn``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from bee_code_interpreter_tpu_torch.parallel.mesh import (
    batch_shard_of,
    copy_to_group,
    gather_shards,
    group_rank,
    group_size as n_ranks,
)

Params = dict

# the token count up to which every expert runs on every token (see above);
# a decode step at max_batch 8 and a gamma-4 verify window (40) fall under it
EVERY_EXPERT_MAX_TOKENS = 64


MOE_KEYS = ("router", "we_gate", "we_up", "we_down")


def moe_shapes(d_model: int, ff_dim: int,
               n_experts: int) -> dict[str, tuple[int, ...]]:
    """The MoE leaves (``MOE_KEYS``) and their shapes, in the order every
    consumer (``init_moe_params``, the optimizer's leaf list) walks them."""
    return {
        "router": (d_model, n_experts),
        "we_gate": (n_experts, d_model, ff_dim),
        "we_up": (n_experts, d_model, ff_dim),
        "we_down": (n_experts, ff_dim, d_model),
    }


def init_moe_params(generator: torch.Generator, d_model: int, ff_dim: int,
                    n_experts: int, device: torch.device | str,
                    dtype: torch.dtype = torch.float32) -> Params:
    """Router and per-expert SwiGLU weights, normal / sqrt(fan_in) as in
    JAX (the numbers differ from ``jax.random``'s; tests carry JAX's
    weights across with ``weights.params_from_jax``)."""
    out = {}
    for name, shape in moe_shapes(d_model, ff_dim, n_experts).items():
        w = torch.randn(shape, generator=generator, device=device, dtype=dtype)
        out[name] = w.div_(math.sqrt(shape[-2]))
    return out


def expert_capacity(
    n_tokens: int,
    n_experts: int,
    top_k: int,
    capacity_factor: float,
    dropless: bool = False,
) -> int:
    """Per-expert capacity slots of a routing group, rounded up to 8;
    ``dropless`` sizes it to the whole group, so no choice is ever
    dropped. The same Python arithmetic as JAX."""
    if dropless:
        return max(8, -(-n_tokens // 8) * 8)
    raw = capacity_factor * n_tokens * top_k / n_experts
    return max(8, int(math.ceil(raw / 8)) * 8)


class Routing(NamedTuple):
    """Each token's ``top_k`` choices, ``[..., g, k]``: the expert, its
    renormalised gate (f32), its position-in-expert slot and whether the
    slot is inside capacity; and the aux loss of each group ``[...]``."""

    expert: torch.Tensor
    gate: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    aux: torch.Tensor


def _route_group(
    logits: torch.Tensor,  # [..., g, E] f32: routing groups of g tokens
    *,
    n_experts: int,
    top_k: int,
    capacity: int,
) -> Routing:
    """GShard routing of each group, as JAX's ``_route_group`` (which takes
    ``xf`` and the router; here their product, the router logits): the
    dispatch set is ``{(token, expert, slot) : keep}`` and the combine
    weight of a kept choice its gate."""
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k order: descending, ties to the lower index
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = ranked[..., :top_k], order[..., :top_k]
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)

    # slot of choice j of token t in expert e: every earlier choice column
    # routed to e (all tokens), then the earlier tokens of column j
    onehot = F.one_hot(expert, n_experts)  # [..., g, k, E]
    per_column = onehot.sum(dim=-3)  # [..., k, E]
    before_column = torch.cumsum(per_column, dim=-2) - per_column
    before_token = torch.cumsum(onehot, dim=-3) - onehot
    position = before_token + before_column.unsqueeze(-3)
    slot = (position * onehot).sum(dim=-1)  # [..., g, k]
    keep = slot < capacity

    top1 = F.one_hot(expert[..., 0], n_experts).float()
    aux = n_experts * (top1.mean(dim=-2) * probs.mean(dim=-2)).sum(dim=-1)
    return Routing(expert, gate, slot, keep, aux)


def _swiglu(x: torch.Tensor, w_gate, w_up, w_down, dtype: torch.dtype):
    """One expert's (or, batched over a leading E, every expert's) MLP."""
    gate = torch.matmul(x, w_gate.to(dtype))
    up = torch.matmul(x, w_up.to(dtype))
    return torch.matmul(F.silu(gate) * up, w_down.to(dtype))


def _every_expert(params: Params, xf, expert, weight, dtype,
                  n_experts: int, offset: int = 0) -> torch.Tensor:
    """``[G, D]`` f32: every expert of ``params`` (the global experts
    ``offset ..``) on every token, weighted per token."""
    E = params["we_gate"].shape[0]
    G, D = xf.shape
    combine = torch.zeros(G, n_experts, dtype=torch.float32, device=xf.device)
    combine = combine.scatter(1, expert, weight)  # a token's experts differ
    combine = combine[:, offset:offset + E]
    y = _swiglu(xf.to(dtype).expand(E, G, D), params["we_gate"],
                params["we_up"], params["we_down"], dtype)  # [E, G, D]
    w = combine.to(dtype).float().t().unsqueeze(-1)  # [E, G, 1]
    return (w * y.float()).sum(dim=0)


def _routed_experts(params: Params, xf, expert, weight, keep,
                    dtype, offset: int = 0) -> torch.Tensor:
    """``[G, D]`` f32: each expert of ``params`` (the global experts
    ``offset ..``) on its kept tokens only."""
    E = params["we_gate"].shape[0]
    G, k = expert.shape
    mine = keep & (expert >= offset) & (expert < offset + E)
    # dropped choices, and other ranks' experts, sort last
    key = torch.where(mine, expert - offset, E).reshape(-1)
    order = torch.argsort(key, stable=True)  # [G·k] (token, choice) indices
    counts = torch.bincount(key, minlength=E + 1).tolist()  # host read
    n_kept = sum(counts[:E])
    if n_kept == 0:
        return torch.zeros(G, xf.shape[1], dtype=torch.float32,
                           device=xf.device)
    pairs = order[:n_kept]
    x_sorted = xf.to(dtype)[pairs // k]
    outs, start = [], 0
    for e in range(E):
        n = counts[e]
        if n:
            outs.append(_swiglu(x_sorted[start:start + n],
                                params["we_gate"][e], params["we_up"][e],
                                params["we_down"][e], dtype))
        start += n
    w = weight.reshape(-1)[pairs].to(dtype).float().unsqueeze(-1)
    contrib = w * torch.cat(outs).float()
    # every (token, choice) place is written at most once: no atomics
    placed = torch.zeros(G * k, xf.shape[1], dtype=torch.float32,
                         device=xf.device).index_copy(0, pairs, contrib)
    return placed.view(G, k, -1).sum(dim=1)


def moe_mlp(
    params: Params,
    x: torch.Tensor,  # [B, L, D]
    *,
    n_experts: int,
    top_k: int = 2,
    capacity_factor: float = 1.25,
    dtype: torch.dtype = torch.bfloat16,
    group_size: int = 1024,
    dropless: bool = False,
    expert_offset: int = 0,
    partial_group=None,
    sp_group=None,
    batch_group=None,
    valid_len: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(output [B, L, D] in dtype, aux f32 scalar)``.

    ``partial_group`` (tp, ep or a tuple of both): ``params`` holds experts
    ``expert_offset ..`` over this rank's ``F`` shard, and the output is the
    rank's f32 partial sum, for the caller to reduce over that group; under
    autograd the tokens and the combine weights enter the rank's products
    through ``copy_to_group`` (their gradients are partial on each rank).
    ``sp_group``: ``x`` is this rank's block of a sequence sharded over sp,
    of which the positions from ``valid_len`` on are padding, kept out of
    the routing pool (their output is zero); the aux is then the whole
    sequence's on every sp rank. ``batch_group`` (dp, fsdp or a
    tuple, in that order): ``x`` is this rank's block of rows of a batch
    sharded over it (``parallel.mesh.batch_shard_of``). JAX routes the flat
    global batch in groups of ``group_size``: a group that lies inside the
    rank is routed here, one that spans ranks from the router logits
    gathered over the batch axes (``gather_shards``). The aux is then the
    rank's share of JAX's mean over every group (the shares sum to it)."""
    B, L, D = x.shape
    sp = n_ranks(sp_group)
    shard, n_shards = (0, 1) if batch_group is None else batch_shard_of(
        batch_group)
    Ls = L * sp if valid_len is None else valid_len  # routed positions a row
    G = B * n_shards * Ls  # the routing pool: every token of the forward
    n_groups = max(1, G // group_size)
    if G % n_groups != 0:
        n_groups = 1
    g = G // n_groups
    C = expert_capacity(g, n_experts, top_k, capacity_factor, dropless)
    xf = x.reshape(B * L, D)
    local = torch.einsum("bld,de->ble", x.float(), params["router"].float())
    # under autograd the gather's backward sums every sp rank's gradient of
    # the whole sequence's logits and keeps the rank's block
    logits = gather_shards(local, sp_group, dim=1)[:, :Ls]  # [B, Ls, E]
    span = (B * Ls) % g != 0  # a routing group spans batch shards
    if span:
        logits = gather_shards(logits, batch_group, dim=0)
    r = _route_group(logits.reshape(-1, g, n_experts), n_experts=n_experts,
                     top_k=top_k, capacity=C)
    start = group_rank(sp_group) * L

    def mine(t):  # this rank's tokens' choices, [B*L, k]; pads: nothing
        t = t.reshape(-1, Ls, top_k)
        if span:
            t = t[shard * B:(shard + 1) * B]
        if Ls < L * sp:
            t = torch.cat([t, t.new_zeros(t.shape[0], L * sp - Ls, top_k)], 1)
        return t[:, start:start + L].reshape(B * L, top_k)

    expert, keep, gate = mine(r.expert), mine(r.keep), mine(r.gate)
    weight = gate * keep
    xf = copy_to_group(xf, partial_group)
    weight = copy_to_group(weight, partial_group)
    if B * L <= EVERY_EXPERT_MAX_TOKENS:
        out = _every_expert(params, xf, expert, weight, dtype, n_experts,
                            expert_offset)
    else:
        out = _routed_experts(params, xf, expert, weight, keep, dtype,
                              expert_offset)
    out = out.reshape(B, L, D)
    if n_shards == 1:
        aux = r.aux.mean()
    else:  # the rank's share of JAX's mean over every group
        aux = r.aux.sum() / n_groups / (n_shards if span else 1)
    return (out if partial_group is not None else out.to(dtype)), aux
