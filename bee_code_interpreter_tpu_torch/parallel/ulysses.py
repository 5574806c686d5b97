"""Ulysses sequence parallelism: the all-to-all head/sequence exchange,
the counterpart of ``bee_code_interpreter_tpu/parallel/ulysses.py``.

Where the ring (``parallel/ring_attention.py``) keeps the queries and
passes K/V blocks round the ``sp`` ranks, Ulysses re-shards once: a tiled
all-to-all (``parallel.mesh.all_to_all_tiled``, JAX's ``lax.all_to_all``)
turns the sequence-sharded ``[B, H, L/sp, D]`` activations into head-sharded
``[B, H/sp, L, D]``, each rank runs ordinary attention over the whole
sequence for its heads (the flash forward kernel, K1, on CUDA tensors), and
the inverse exchange restores the sequence sharding. sp must divide the
query heads; K/V heads that do not divide over sp are broadcast up to
``lcm(KVH, sp)`` first, which keeps the group-major query -> K/V pairing.

``models/transformer.py`` picks the ring or Ulysses by
``TransformerConfig.sp_attention``. Ulysses is differentiable: each
all-to-all's backward is the inverse exchange, the local attention is the
flash ``autograd.Function`` (K1 forward, K3/K4 backward at H/sp heads over
the whole sequence, their plain versions on the CPU), and a K/V head
broadcast up to the lcm gets the sum of its copies' gradients.
"""

from __future__ import annotations

import functools
import math

import torch

from bee_code_interpreter_tpu_torch.ops.flash_attention import (
    flash_attention,
    local_attention as _dispatch,
)
from bee_code_interpreter_tpu_torch.parallel.mesh import (
    all_to_all_tiled,
    gather_from_group,
    group_size,
    split_to_group,
    sp_group,
)
from bee_code_interpreter_tpu_torch.parallel.ring_attention import (
    reference_attention,
)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group=None,
    causal: bool = True,
    local_attention=None,
    window: int | None = None,
    use_flash: bool | None = None,
) -> torch.Tensor:
    """All-to-all sequence-parallel attention over ``group`` (the sp axis's
    process group). Per rank: q ``[B, H, L/sp, D]``, k/v ``[B, KVH, L/sp,
    D]``; returns ``[B, H, L/sp, D]``. ``local_attention(q, k, v)`` runs on
    the gathered ``[B, heads/sp, L, D]`` blocks; by default it is the port's
    ``local_attention`` (K1 on CUDA tensors, its plain version on the CPU),
    ``use_flash=True`` forces ``flash_attention`` and ``use_flash=False``
    ``reference_attention``. ``window`` needs no per-hop geometry: after the
    gather a rank holds whole sequences, where global positions are local
    ones."""
    if local_attention is None:
        if use_flash is None:
            local_attention = functools.partial(_dispatch, causal=causal,
                                                window=window)
        elif use_flash:
            local_attention = functools.partial(flash_attention,
                                                causal=causal, window=window)
        else:
            local_attention = functools.partial(reference_attention,
                                                causal=causal, window=window)
    elif window is not None or use_flash is not None:
        raise ValueError(
            "window/use_flash with a custom local_attention: fold them into "
            "the callable instead (the default dispatch handles them)"
        )
    sp = group_size(group)
    H, KVH = q.shape[1], k.shape[1]
    if H % sp:
        raise ValueError(f"sp={sp} must divide n_heads {H} for ulysses")
    if KVH % sp:
        # K/V heads do not scatter over sp: broadcast them up to lcm(KVH,
        # sp) only (both divide H, so the lcm does too and query head h
        # still reads K/V head h // (H / KVH))
        rep = math.lcm(KVH, sp) // KVH
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)

    # head-scatter / sequence-gather: [B, h, L/sp, D] -> [B, h/sp, L, D],
    # the sequence blocks in rank order, as the sequence sharding laid them
    def a2a(x):
        return all_to_all_tiled(x, group, split_dim=1, concat_dim=2)

    out = local_attention(a2a(q), a2a(k), a2a(v))
    # the inverse: sequence-scatter / head-gather
    return all_to_all_tiled(out, group, split_dim=2, concat_dim=1)


def ulysses_attention_sharded(
    mesh,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    axis_name: str = "sp",
    causal: bool = True,
    use_flash: bool | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Standalone entry: every rank passes the whole ``[B, H, L, D]`` q and
    ``[B, KVH, L, D]`` k/v, takes its block of L over ``axis_name``, runs
    the exchange, and gets the whole output back (gathered in rank order),
    as JAX's entry returns one global array. Differentiable as the ring's
    entry is: a loss every rank computes from the whole output counts
    once."""
    if axis_name != "sp":
        raise ValueError(f"Ulysses runs over the sp axis, got {axis_name!r}")
    group = sp_group(mesh)
    out = ulysses_attention(
        *(split_to_group(x, group, 2) for x in (q, k, v)),
        group=group, causal=causal, window=window, use_flash=use_flash,
    )
    return gather_from_group(out, group, 2)
