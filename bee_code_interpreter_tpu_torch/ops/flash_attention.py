"""Flash-attention forward: the hand-written Hopper kernel and its plain
PyTorch version.

The counterpart of ``bee_code_interpreter_tpu/ops/flash_attention.py``'s
forward (``flash_attention_with_lse``, ``local_attention``). Layouts are the
JAX package's: q ``[B, H, L, D]``, k/v ``[B, KVH, Lk, D]`` with ``H % KVH ==
0`` (query head h reads KV head ``h // (H // KVH)``), out in the input dtype,
lse ``[B, H, L]`` in f32.

Dispatch is on where the tensors live: CUDA tensors go to the kernel
(``csrc/flash_fwd.cu``, bf16 and head dim 128 only; anything else raises),
CPU tensors to ``flash_attention_fwd_plain``. There is no third path and no
fallback from one to the other. The backward kernels are not ported yet
(ROADMAP Queue 2), so this forward is not differentiable.
"""

from __future__ import annotations

import ctypes

import torch

from bee_code_interpreter_tpu_torch.ops.cuda_build import CudaKernel

FLASH_FWD = CudaKernel(
    "flash_fwd",
    {
        "bci_flash_fwd_bf16": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_void_p],
    },
)
KERNEL_HEAD_DIM = 128


def _check_args(q, k, v, causal: bool, window: int | None) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, L, D] / [B, KVH, Lk, D]")
    B, H, _, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(
            f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}"
        )
    if H % k.shape[1]:
        raise ValueError(f"n_heads {H} not a multiple of kv_heads {k.shape[1]}")
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True (sliding window)")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")


def flash_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True, sm_scale: float | None = None,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense attention with f32 statistics: ``(out, lse)``. What the CPU
    runs, and what the kernel is held against on the card."""
    _check_args(q, k, v, causal, window)
    H, L, D = q.shape[1], q.shape[2], q.shape[3]
    Lk = k.shape[2]
    if sm_scale is None:
        sm_scale = D ** -0.5
    rep = H // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * sm_scale
    row = torch.arange(L, device=q.device)[:, None]
    col = torch.arange(Lk, device=q.device)[None, :]
    visible = torch.ones(L, Lk, dtype=torch.bool, device=q.device)
    if causal:
        visible &= row >= col
    if window is not None:
        visible &= row - col < window
    scores = scores.masked_fill(~visible, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", weights, vf)
    return out.to(q.dtype), lse


def _flash_fwd_cuda(q, k, v, causal, sm_scale, window):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(
                f"the flash kernel takes bfloat16, got {name} {t.dtype}"
            )
        if not t.is_contiguous():
            raise ValueError(f"the flash kernel needs contiguous {name}")
    B, H, L, D = q.shape
    KVH, Lk = k.shape[1], k.shape[2]
    if D != KERNEL_HEAD_DIM:
        raise ValueError(
            f"the flash kernel takes head dim {KERNEL_HEAD_DIM}, got {D}"
        )
    if L < 1 or Lk < 1:
        raise ValueError("the flash kernel needs L >= 1 and Lk >= 1")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    FLASH_FWD.launch(
        "bci_flash_fwd_bf16",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, KVH, L, Lk, int(causal), window or 0,
        float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out, lse


def flash_attention_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True, sm_scale: float | None = None,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` like the JAX ``flash_attention_with_lse``: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    _check_args(q, k, v, causal, window)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        return _flash_fwd_cuda(q, k, v, causal, sm_scale, window)
    if q.device.type != "cpu" or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"tensors on {q.device}/{k.device}/{v.device}: expected all "
            "on one CUDA device (kernel) or all on the CPU (plain version)"
        )
    return flash_attention_fwd_plain(q, k, v, causal, sm_scale, window)


def local_attention(q, k, v, causal: bool = True, window: int | None = None):
    """Single-device attention output, the dispatch of the JAX
    ``local_attention`` (flash_attention.py:656) keyed on the tensors'
    device instead of the platform."""
    return flash_attention_with_lse(q, k, v, causal, window=window)[0]
