"""Paged KV cache: block-table indirection over a shared page pool.

The counterpart of ``bee_code_interpreter_tpu/ops/paged_kv_cache.py``. The
pool is ``{"k", "v"}`` of ``[n_layers, n_pages, kvh, page_size, dh]``; a
sequence's logical block i lives in physical page ``block_table[i]`` for
every layer. Page 0 is the batcher's scratch page (models/serving.py).

Where JAX returns an updated pool (and the batcher donates the old buffer),
the port writes the pool IN PLACE: ``paged_append`` and ``seed_prefill``
mutate the tensors they are given and return the same dict, so a step never
copies the pool.

``kv_cache_dtype="int8"`` pools hold int8 values plus per-(token, head) f32
scale planes ``k_s``/``v_s`` of ``[n_layers, n_pages, kvh, page_size, 1]``:
the layout of the contiguous cache (``ops/kv_cache.py``), whose scale
leaves select the quantized strategy in append, read and seeding alike.
"""

from __future__ import annotations

import numpy as np
import torch

from bee_code_interpreter_tpu_torch.ops.kv_cache import dequantize, quantize


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


def alloc_paged_cache(config, n_pages: int, page_size: int,
                      device: torch.device | str,
                      kv_heads: int | None = None) -> dict:
    """Zeroed page pool on ``device``: k/v ``[n_layers, n_pages, kvh,
    page_size, dh]`` in the compute dtype, or int8 with f32 scale planes
    ``k_s``/``v_s`` (last axis 1) for ``kv_cache_dtype="int8"``; ``kvh`` is
    ``kv_heads`` (default ``config.kv_heads``; a tensor-parallel rank holds
    its share, each leaf its own allocation)."""
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    shape = (config.n_layers, n_pages, kv_heads or config.kv_heads, page_size,
             config.head_dim)
    if config.kv_cache_dtype == "int8":
        def zeros(sh, dt):
            return torch.zeros(sh, dtype=dt, device=device)

        return {"k": zeros(shape, torch.int8), "v": zeros(shape, torch.int8),
                "k_s": zeros(shape[:-1] + (1,), torch.float32),
                "v_s": zeros(shape[:-1] + (1,), torch.float32)}
    return {
        "k": torch.zeros(shape, dtype=config.dtype, device=device),
        "v": torch.zeros(shape, dtype=config.dtype, device=device),
    }


def paged_append(
    c_layer: dict,  # one layer's pool views: [n_pages, kvh, ps, ·]
    k_new: torch.Tensor,  # [B, W, kvh, dh]
    v_new: torch.Tensor,
    page_idx: torch.Tensor,  # [B, W] physical page per (row, token)
    slot_idx: torch.Tensor,  # [B, W] slot within the page
    valid: torch.Tensor | None = None,  # [B, W] bool; None = all
) -> dict:
    """Write W new tokens' K/V per row into their (page, slot)s, in place;
    int8 pools quantize each (token, head) row. A token whose ``valid`` is
    False writes back what its (page, slot) holds, so the pool is unchanged
    there: JAX's scatter drops a token whose position lies past the block
    table, and the caller marks those. Two (row, token)s on one (page, slot)
    is a scheduler bug (a dropped token included), except on the scratch
    page, whose contents nothing reads."""
    page_idx, slot_idx = page_idx.long(), slot_idx.long()
    if "k_s" in c_layer:
        (kq, ks), (vq, vs) = quantize(k_new), quantize(v_new)
        updates = {"k": kq, "v": vq, "k_s": ks, "v_s": vs}
    else:
        updates = {"k": k_new, "v": v_new}
    for name, new in updates.items():
        dst = c_layer[name]
        new = new.to(dst.dtype)
        if valid is not None:
            # a dropped token writes back what its slot already holds
            old = dst[page_idx, :, slot_idx, :]
            new = torch.where(valid[:, :, None, None], new, old)
        dst[page_idx, :, slot_idx, :] = new
    return c_layer


def paged_read(
    c_layer: dict,  # [n_pages, kvh, ps, ·]
    block_table: torch.Tensor,  # [B, P] logical block -> physical page
    dtype: torch.dtype,  # V compute dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather each row's pages into the contiguous ``[B, kvh, P*ps, dh]``
    view: K in f32 (scores operand), V in ``dtype``; int8 pools dequantize
    after the gather, their scales gathered alongside."""
    B, P = block_table.shape
    bt = block_table.long()

    def view(x, out_dtype=None):
        _, kvh, ps, last = x.shape
        g = x[bt].permute(0, 2, 1, 3, 4).reshape(B, kvh, P * ps, last)
        return g if out_dtype is None else g.to(out_dtype)

    if "k_s" in c_layer:
        return (dequantize(view(c_layer["k"]), view(c_layer["k_s"])),
                dequantize(view(c_layer["v"]), view(c_layer["v_s"]), dtype))
    return view(c_layer["k"], torch.float32), view(c_layer["v"], dtype)


def _page_view(x: torch.Tensor, n_pages: int, ps: int) -> torch.Tensor:
    """``[n_layers, kvh, n_pages * ps, last]`` -> ``[n_layers, n_pages, kvh,
    ps, last]``."""
    nl, kvh, _, last = x.shape
    return x.reshape(nl, kvh, n_pages, ps, last).permute(0, 2, 1, 3, 4)


def seed_prefill(
    cache: dict,  # full pool: [n_layers, n_pages, kvh, ps, ·]
    pages: torch.Tensor,  # [P] physical pages covering ceil(L / ps)
    k_pre: torch.Tensor,  # [n_layers, kvh, L, dh]: one sequence's prefill K
    v_pre: torch.Tensor,
) -> dict:
    """Write one sequence's prefill K/V into its pages, in place: one
    indexed write per pool leaf, the tail of the last page zero-filled.
    int8 pools quantize per (token, head) row, as ``paged_append`` does;
    the zero tail quantizes to scale-0 exact zeros."""
    ps = cache["k"].shape[3]
    n_used = int(pages.shape[0])
    L = k_pre.shape[2]
    if L > n_used * ps:
        raise ValueError(f"prefill length {L} exceeds {n_used} pages of {ps}")
    pages = pages.long()
    for name, pre in (("k", k_pre), ("v", v_pre)):
        padded = torch.nn.functional.pad(pre, (0, 0, 0, n_used * ps - L))
        vals = _page_view(padded, n_used, ps)
        if name + "_s" in cache:
            q, s = quantize(vals)
            cache[name][:, pages] = q
            cache[name + "_s"][:, pages] = s
        else:
            cache[name][:, pages] = vals.to(cache[name].dtype)
    return cache


def seed_from_contiguous(
    cache: dict,  # paged pool: [n_layers, n_pages, kvh, ps, ·]
    pages: torch.Tensor,  # [P] pages covering the contiguous row
    contig_row: dict,  # one row of a contiguous cache: [n_layers, kvh, P*ps, ·]
) -> dict:
    """Copy a contiguous-cache row, already in the pool's layout (bf16
    values, or int8 values and scales), into pages verbatim and in place:
    int8 rows are never quantized twice, so a chunked admission decodes
    exactly like the contiguous cache it came from."""
    P = int(pages.shape[0])
    ps = cache["k"].shape[3]
    pages = pages.long()
    for name, x in contig_row.items():
        total = x.shape[2]
        if total != P * ps:
            raise ValueError(f"contiguous length {total} != {P} pages of {ps}")
        cache[name][:, pages] = _page_view(x, P, ps).to(cache[name].dtype)
    return cache
