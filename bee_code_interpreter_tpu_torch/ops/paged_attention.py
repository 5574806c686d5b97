"""Paged decode attention: the hand-written Hopper kernel and its plain
PyTorch version.

The counterpart of ``bee_code_interpreter_tpu/ops/paged_attention.py``
(``paged_decode_attention``): one query token per row, ``q [B, nh, dh]``
against one layer's pools ``[n_pages, kvh, ps, dh]`` through the block table
``[B, P]``, with ``lengths [B]`` visible slots per row (pos + 1). GQA-native:
query head h reads KV head ``h // (nh // kvh)``.

CUDA tensors go to the kernel (``csrc/paged_decode.cu``: bf16 or f32 pools,
dh 128, at most 8 query heads per KV head; anything else raises); CPU tensors
to ``paged_decode_attention_plain``, the gather-and-grouped-einsum math of the
JAX package's oracle (tests/test_paged_attention.py:29).
"""

from __future__ import annotations

import ctypes

import torch

from bee_code_interpreter_tpu_torch.ops.cuda_build import CudaKernel

PAGED_DECODE = CudaKernel(
    "paged_decode",
    {
        "bci_paged_decode": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    },
)
KERNEL_HEAD_DIM = 128
KERNEL_MAX_REP = 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrs,bgsd->bgrd", w, view(v_pages))
    return out.reshape(B, nh, dh).to(q.dtype)


def _paged_decode_cuda(q, k_pages, v_pages, block_table, lengths, sm_scale):
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
    if dh != KERNEL_HEAD_DIM:
        raise ValueError(
            f"the paged decode kernel takes head dim {KERNEL_HEAD_DIM}, "
            f"got {dh}"
        )
    if nh // kvh > KERNEL_MAX_REP:
        raise ValueError(
            f"the paged decode kernel takes at most {KERNEL_MAX_REP} query "
            f"heads per kv head, got {nh // kvh}"
        )
    out = torch.empty_like(q)
    PAGED_DECODE.launch(
        "bci_paged_decode",
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, nh, kvh, n_pages, ps, block_table.shape[1], float(sm_scale),
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
