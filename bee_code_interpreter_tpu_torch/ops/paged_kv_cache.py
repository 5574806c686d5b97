"""Paged KV cache: block-table indirection over a shared page pool.

The counterpart of ``bee_code_interpreter_tpu/ops/paged_kv_cache.py``. The
pool is ``{"k", "v"}`` of ``[n_layers, n_pages, kvh, page_size, dh]``; a
sequence's logical block i lives in physical page ``block_table[i]`` for
every layer. Page 0 is the batcher's scratch page (models/serving.py).

Where JAX returns an updated pool (and the batcher donates the old buffer),
the port writes the pool IN PLACE: ``paged_append`` and ``seed_prefill``
mutate the tensors they are given and return the same dict, so a step never
copies the pool. Only bf16/f32 pools are in scope; the int8 layout
(``kv_cache_dtype="int8"``) raises ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch


def pool_telemetry(
    *,
    block_table: np.ndarray,  # [B, P] int32, scratch-page entries for holes
    pos: np.ndarray,  # [B] int32 decode cursors (tokens written per row)
    active: np.ndarray,  # [B] bool
    page_ref: np.ndarray,  # [n_pages] int32 refcounts
    page_size: int,
    free_pages: int,
    parked_pages: int,
    scratch_page: int = 0,
) -> dict:
    """Host-side page-pool telemetry, pure integer bookkeeping (a copy of
    the JAX package's numpy-only function). ``fragmentation`` is the
    slot-level internal fragmentation of the pages active rows hold:
    ``1 - used_slots / allocated_slots``."""
    n_pages = int(page_ref.shape[0])
    held = int((page_ref > 0).sum())
    shared = int((page_ref > 1).sum())
    slots_allocated = 0
    slots_used = 0
    for row in np.flatnonzero(active):
        row_pages = int((block_table[row] != scratch_page).sum())
        slots_allocated += row_pages * page_size
        slots_used += int(pos[row])
    fragmentation = (
        1.0 - slots_used / slots_allocated if slots_allocated else 0.0
    )
    return {
        "pages_total": n_pages - 1,  # the scratch page is never allocatable
        "pages_free": free_pages,
        "pages_parked": parked_pages,
        "pages_held": held,
        "pages_shared": shared,
        "page_size": page_size,
        "slots_allocated": slots_allocated,
        "slots_used": slots_used,
        "fragmentation": fragmentation,
    }


def _refuse_int8(config_or_layer) -> None:
    if getattr(config_or_layer, "kv_cache_dtype", "bf16") == "int8" or (
        isinstance(config_or_layer, dict) and "k_s" in config_or_layer
    ):
        raise NotImplementedError(
            "int8 KV pools are not ported yet (ROADMAP Queue 1)"
        )


def alloc_paged_cache(config, n_pages: int, page_size: int,
                      device: torch.device | str) -> dict:
    """Zeroed page pool in the compute dtype on ``device``:
    k/v ``[n_layers, n_pages, kvh, page_size, dh]``."""
    _refuse_int8(config)
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    shape = (config.n_layers, n_pages, config.kv_heads, page_size,
             config.head_dim)
    return {
        "k": torch.zeros(shape, dtype=config.dtype, device=device),
        "v": torch.zeros(shape, dtype=config.dtype, device=device),
    }


def paged_append(
    c_layer: dict,  # one layer's pool views: [n_pages, kvh, ps, dh]
    k_new: torch.Tensor,  # [B, W, kvh, dh]
    v_new: torch.Tensor,
    page_idx: torch.Tensor,  # [B, W] physical page per (row, token)
    slot_idx: torch.Tensor,  # [B, W] slot within the page
) -> dict:
    """Write W new tokens' K/V per row into their (page, slot)s, in place.
    Two (row, token)s on one (page, slot) is a scheduler bug, except on the
    scratch page, whose contents nothing reads."""
    _refuse_int8(c_layer)
    page_idx, slot_idx = page_idx.long(), slot_idx.long()
    k, v = c_layer["k"], c_layer["v"]
    k[page_idx, :, slot_idx, :] = k_new.to(k.dtype)
    v[page_idx, :, slot_idx, :] = v_new.to(v.dtype)
    return c_layer


def paged_read(
    c_layer: dict,  # [n_pages, kvh, ps, dh]
    block_table: torch.Tensor,  # [B, P] logical block -> physical page
    dtype: torch.dtype,  # V compute dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather each row's pages into the contiguous ``[B, kvh, P*ps, dh]``
    view: K in f32 (scores operand), V in ``dtype``."""
    _refuse_int8(c_layer)
    B, P = block_table.shape
    _, kvh, ps, dh = c_layer["k"].shape
    bt = block_table.long()

    def view(x, out_dtype):
        g = x[bt]  # [B, P, kvh, ps, dh]
        return g.permute(0, 2, 1, 3, 4).reshape(B, kvh, P * ps, dh).to(out_dtype)

    return view(c_layer["k"], torch.float32), view(c_layer["v"], dtype)


def seed_prefill(
    cache: dict,  # full pool: [n_layers, n_pages, kvh, ps, dh]
    pages: torch.Tensor,  # [P] physical pages covering ceil(L / ps)
    k_pre: torch.Tensor,  # [n_layers, kvh, L, dh]: one sequence's prefill K
    v_pre: torch.Tensor,
) -> dict:
    """Write one sequence's prefill K/V into its pages, in place: one
    indexed write per pool leaf, the tail of the last page zero-filled."""
    _refuse_int8(cache)
    ps = cache["k"].shape[3]
    n_used = int(pages.shape[0])
    L = k_pre.shape[2]
    if L > n_used * ps:
        raise ValueError(f"prefill length {L} exceeds {n_used} pages of {ps}")
    pages = pages.long()
    for name, pre in (("k", k_pre), ("v", v_pre)):
        nl, kvh, _, dh = pre.shape
        padded = torch.nn.functional.pad(pre, (0, 0, 0, n_used * ps - L))
        vals = padded.reshape(nl, kvh, n_used, ps, dh).permute(0, 2, 1, 3, 4)
        cache[name][:, pages] = vals.to(cache[name].dtype)
    return cache
