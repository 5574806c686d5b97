"""Paged decode attention: the hand-written Hopper kernel and its plain
PyTorch version.

The counterpart of ``bee_code_interpreter_tpu/ops/paged_attention.py``
(``paged_decode_attention``): one query token per row, ``q [B, nh, dh]``
against one layer's pools ``[n_pages, kvh, ps, dh]`` through the block table
``[B, P]``, with ``lengths [B]`` visible slots per row (pos + 1). GQA-native:
query head h reads KV head ``h // (nh // kvh)``.

CUDA tensors go to the kernel (``csrc/paged_decode.cu``: bf16 or f32 pools
on a 16-byte boundary, dh 128, at most 8 query heads per KV head; anything
else raises); CPU tensors to ``paged_decode_attention_plain``, the
gather-and-grouped-einsum math of the JAX package's oracle
(tests/test_paged_attention.py:29).

The kernel splits each row's sequence over several blocks (flash-decoding):
``split_pages`` chooses, on the host and from shapes alone, how many pages a
split covers; each split yields partials ``(m, l, acc)`` and a second launch
merges them. ``paged_decode_partials_plain`` and ``merge_split_partials``
are that split-and-merge math in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bee_code_interpreter_tpu_torch.ops.cuda_build import CudaKernel

# q, k_pages, v_pages, block_table, lengths, out, then the split scratch
# (m, l, acc); B, nh, kvh, n_pages, ps, P, pages_per_split; sm_scale; dtype;
# stream
PAGED_DECODE = CudaKernel(
    "paged_decode",
    {
        "bci_paged_decode": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    },
)
KERNEL_HEAD_DIM = 128
KERNEL_MAX_REP = 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# what the kernel's bulk copies and TMA maps take as a pool's base address
BULK_ALIGN_BYTES = 16
# a split is at least this many tokens: one fill of the kernel's ring (4
# warps x 2 stages x 16 tokens); shorter splits measured slower on an H100
MIN_SPLIT_TOKENS = 128
# splits are chosen so the grid holds about this many blocks per SM
BLOCKS_PER_SM = 2


def split_pages(B: int, kvh: int, P: int, ps: int, sms: int) -> int:
    """Pages of the block table each split of the kernel covers, from the
    shapes alone (``lengths`` lives on the device and is never read here).
    One split (all ``P`` pages) when ``B * kvh`` blocks fill the card;
    otherwise enough splits for about ``BLOCKS_PER_SM`` blocks per SM, none
    shorter than ``MIN_SPLIT_TOKENS``."""
    if B * kvh >= sms:
        return P
    want = -(-BLOCKS_PER_SM * sms // (B * kvh))
    most = max(1, P * ps // MIN_SPLIT_TOKENS)
    return -(-P // min(want, most))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_args(q, k_pages, v_pages, block_table, lengths) -> None:
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("q must be [B, nh, dh] and pools [n_pages, kvh, ps, dh]")
    B, nh, dh = q.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != dh:
        raise ValueError(
            f"pool shapes {tuple(k_pages.shape)}/{tuple(v_pages.shape)} do "
            f"not match q {tuple(q.shape)}"
        )
    if nh % k_pages.shape[1]:
        raise ValueError(
            f"n_heads {nh} not a multiple of kv_heads {k_pages.shape[1]}"
        )
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError(f"block_table must be [B={B}, P]")
    if lengths.shape != (B,):
        raise ValueError(f"lengths must be [B={B}]")


def paged_decode_attention_plain(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    block_table: torch.Tensor, lengths: torch.Tensor,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Gather each row's pages (entries clamped to the pool, as the kernel
    does), grouped einsums with f32 statistics, slots >= length masked."""
    _check_args(q, k_pages, v_pages, block_table, lengths)
    B, nh, dh = q.shape
    n_pages, kvh, ps, _ = k_pages.shape
    P = block_table.shape[1]
    rep = nh // kvh
    if sm_scale is None:
        sm_scale = dh ** -0.5
    bt = block_table.long().clamp(0, n_pages - 1)

    def view(pages):  # [B, kvh, P*ps, dh] in f32
        g = pages[bt]  # [B, P, kvh, ps, dh]
        return g.permute(0, 2, 1, 3, 4).reshape(B, kvh, P * ps, dh).float()

    qg = q.reshape(B, kvh, rep, dh).float()
    s = torch.einsum("bgrd,bgsd->bgrs", qg, view(k_pages)) * sm_scale
    slots = torch.arange(P * ps, device=q.device)
    visible = slots[None, :] < lengths.to(q.device).long()[:, None]  # [B, S]
    s = s.masked_fill(~visible[:, None, None, :], float("-inf"))
    # a row with no visible slot (length 0) has all its weights at 0, so
    # its output is 0 as in the kernels (acc / max(l, 1e-30)), not the NaN
    # of a softmax over -inf
    w = torch.softmax(s, dim=-1).masked_fill(
        ~visible.any(dim=-1)[:, None, None, None], 0.0)
    out = torch.einsum("bgrs,bgsd->bgrd", w, view(v_pages))
    return out.reshape(B, nh, dh).to(q.dtype)


def paged_decode_partials_plain(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    block_table: torch.Tensor, lengths: torch.Tensor, pages_per_split: int,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's per-split partials in f32: split ``i`` covers pages
    ``[i * pages_per_split, (i + 1) * pages_per_split)`` of each row. Returns
    ``m [B, kvh, S, rep]`` (the split's max score; -inf when it has no
    visible slot), ``l`` (the sum of ``exp(s - m)``, 0 when empty) and
    ``acc [B, kvh, S, rep, dh]`` (the sum of ``exp(s - m) v``)."""
    _check_args(q, k_pages, v_pages, block_table, lengths)
    B, nh, dh = q.shape
    n_pages, kvh, ps, _ = k_pages.shape
    P = block_table.shape[1]
    rep = nh // kvh
    if sm_scale is None:
        sm_scale = dh ** -0.5
    n_split = -(-P // pages_per_split)
    span = pages_per_split * ps  # slots per split
    bt = block_table.long().clamp(0, n_pages - 1)

    def view(pages):  # [B, kvh, S * span, dh], slots past P * ps are zeros
        g = pages[bt].permute(0, 2, 1, 3, 4).reshape(B, kvh, P * ps, dh).float()
        return torch.nn.functional.pad(g, (0, 0, 0, n_split * span - P * ps))

    qg = q.reshape(B, kvh, rep, dh).float()
    s = torch.einsum("bgrd,bgsd->bgrs", qg, view(k_pages)) * sm_scale
    slots = torch.arange(n_split * span, device=q.device)
    visible = (slots[None, :] < lengths.to(q.device).long()[:, None]) & (
        slots[None, :] < P * ps)
    s = s.masked_fill(~visible[:, None, None, :], float("-inf"))
    s = s.reshape(B, kvh, rep, n_split, span).transpose(2, 3)  # [B, kvh, S, rep, span]
    m = s.amax(dim=-1)
    p = torch.exp(s - torch.where(m == float("-inf"), 0.0, m)[..., None])
    l = p.sum(dim=-1)
    vs = view(v_pages).reshape(B, kvh, n_split, span, dh)
    acc = torch.einsum("bgirs,bgisd->bgird", p, vs)
    return m, l, acc


def merge_split_partials(m: torch.Tensor, l: torch.Tensor,
                         acc: torch.Tensor) -> torch.Tensor:
    """Combine per-split partials over the split axis (2) as the kernel's
    merge does: ``sum_i e^(m_i - M) acc_i / max(sum_i e^(m_i - M) l_i,
    1e-30)`` with ``M = max_i m_i``. An empty split (m = -inf) weighs 0 and
    its acc is not read; a row with every split empty gives 0. Returns
    ``[B, kvh, rep, dh]`` f32."""
    M = m.amax(dim=2, keepdim=True)
    empty = m == float("-inf")
    w = torch.where(empty, 0.0, torch.exp(m - torch.where(M == float("-inf"), 0.0, M)))
    num = (w[..., None] * torch.where(empty[..., None], 0.0, acc)).sum(dim=2)
    den = (w * l).sum(dim=2)
    return num / den.clamp_min(1e-30)[..., None]


def check_pool_alignment(name: str, t: torch.Tensor) -> None:
    """What the kernel's bulk copies and TMA maps demand of a pool: a dense
    tensor whose base lies on a 16-byte boundary (every page row then does
    too). Anything else raises; there is no fallback."""
    if not t.is_contiguous():
        raise ValueError(f"the paged decode kernel needs contiguous {name}")
    if t.data_ptr() % BULK_ALIGN_BYTES:
        raise ValueError(
            f"the paged decode kernel needs {name} on a {BULK_ALIGN_BYTES}-byte "
            f"boundary (bulk copy), got address {t.data_ptr():#x}"
        )


def _paged_decode_cuda(q, k_pages, v_pages, block_table, lengths, sm_scale):
    """The kernel, split as ``split_pages`` chooses for this card."""
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_table", block_table), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"the paged decode kernel needs contiguous {name}")
    if q.dtype not in _DTYPE_CODE or k_pages.dtype != q.dtype or (
        v_pages.dtype != q.dtype
    ):
        raise ValueError(
            "the paged decode kernel takes float32 or bfloat16 q and pools "
            f"of one dtype, got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}"
        )
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("block_table and lengths must be int32")
    B, nh, dh = q.shape
    n_pages, kvh, ps, _ = k_pages.shape
    P = block_table.shape[1]
    if dh != KERNEL_HEAD_DIM:
        raise ValueError(
            f"the paged decode kernel takes head dim {KERNEL_HEAD_DIM}, "
            f"got {dh}"
        )
    rep = nh // kvh
    if rep > KERNEL_MAX_REP:
        raise ValueError(
            f"the paged decode kernel takes at most {KERNEL_MAX_REP} query "
            f"heads per kv head, got {rep}"
        )
    check_pool_alignment("k_pages", k_pages)
    check_pool_alignment("v_pages", v_pages)
    pages_per_split = split_pages(B, kvh, P, ps, _sm_count(q.device))
    n_split = -(-P // pages_per_split)
    out = torch.empty_like(q)
    # f32 partials of each split in one scratch tensor: acc [B, kvh, n_split,
    # rep, dh], then m and l [B, kvh, n_split, rep]; one split writes the
    # output directly and needs none
    n_part = B * kvh * n_split * rep if n_split > 1 else 0
    scratch = torch.empty(n_part * (dh + 2), dtype=torch.float32, device=q.device)
    acc_part, m_part, l_part = scratch.split([n_part * dh, n_part, n_part])
    PAGED_DECODE.launch(
        "bci_paged_decode",
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
        B, nh, kvh, n_pages, ps, P, pages_per_split, float(sm_scale),
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out


def paged_decode_attention(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    block_table: torch.Tensor, lengths: torch.Tensor,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """``[B, nh, dh]`` single-token paged attention: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check_args(q, k_pages, v_pages, block_table, lengths)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        return _paged_decode_cuda(
            q, k_pages, v_pages, block_table, lengths, sm_scale
        )
    if any(t.device.type != "cpu"
           for t in (q, k_pages, v_pages, block_table, lengths)):
        raise ValueError(
            "expected all tensors on one CUDA device (kernel) or all on the "
            "CPU (plain version)"
        )
    return paged_decode_attention_plain(
        q, k_pages, v_pages, block_table, lengths, sm_scale
    )
