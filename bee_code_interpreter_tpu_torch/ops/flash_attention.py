"""Flash attention, forward and backward: the hand-written Hopper kernels
and their plain PyTorch versions, behind one ``torch.autograd.Function``.

The counterpart of ``bee_code_interpreter_tpu/ops/flash_attention.py``
(``flash_attention``, ``flash_attention_with_lse``, ``local_attention`` and
the ``custom_vjp`` pair at :504-641). Layouts are the JAX package's: q
``[B, H, L, D]``, k/v ``[B, KVH, Lk, D]`` with ``H % KVH == 0`` (query head h
reads KV head ``h // (H // KVH)``), out in the input dtype, lse ``[B, H, L]``
in f32; dk/dv come back compact ``[B, KVH, Lk, D]``.

Dispatch is on where the tensors live, in ``FlashAttention`` for both
directions: CUDA tensors go to the kernels (``csrc/flash_fwd.cu`` forward,
``csrc/flash_bwd_dkdv.cu`` and ``csrc/flash_bwd_dq.cu`` backward; bf16, head
dim 64 or 128 (one entry point of each kernel per head dim), and dense
tensors on a 16-byte boundary, which their TMA maps demand: anything else
raises), CPU tensors to the plain versions
(``flash_attention_fwd_plain``, ``flash_bwd_dkdv_plain``,
``flash_bwd_dq_plain``). There is no third path and no fallback from one to
the other. ``delta = rowsum(dO * O) - g_lse`` is a PyTorch reduction, as the
JAX code computes it outside its kernels (:431-437).
"""

from __future__ import annotations

import ctypes

import torch

from bee_code_interpreter_tpu_torch.ops.cuda_build import CudaKernel

# the head dims the kernels take, each its own instance of the kernel
# template (NB = D / 64 TMA boxes a tile) and C entry point
KERNEL_HEAD_DIMS = (64, 128)


def _entry(base: str, head_dim: int) -> str:
    """The C entry point of kernel ``base`` at ``head_dim``."""
    return base if head_dim == 128 else f"{base}_d{head_dim}"


def _signatures(base: str, argtypes: list) -> dict:
    return {_entry(base, d): argtypes for d in KERNEL_HEAD_DIMS}


FLASH_FWD = CudaKernel("flash_fwd", _signatures(
    "bci_flash_fwd_bf16",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]))
# q, k, v, dO, lse, delta, then the outputs (dk, dv / dq); B, H, KVH, Lq, Lk,
# causal, window; sm_scale; stream
FLASH_BWD_DKDV = CudaKernel("flash_bwd_dkdv", _signatures(
    "bci_flash_bwd_dkdv_bf16",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]))
FLASH_BWD_DQ = CudaKernel("flash_bwd_dq", _signatures(
    "bci_flash_bwd_dq_bf16",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]))
# what a TMA tensor map takes as its global base address
TMA_ALIGN_BYTES = 16


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


def _visible(L: int, Lk: int, causal: bool, window: int | None, device):
    """``[L, Lk]`` bool: the (query, key) pairs that attend."""
    row = torch.arange(L, device=device)[:, None]
    col = torch.arange(Lk, device=device)[None, :]
    visible = torch.ones(L, Lk, dtype=torch.bool, device=device)
    if causal:
        visible &= row >= col
    if window is not None:
        visible &= row - col < window
    return visible


def flash_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True, sm_scale: float | None = None,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense attention with f32 statistics: ``(out, lse)``. What the CPU
    runs, and what the forward kernel is held against on the card."""
    _check_args(q, k, v, causal, window)
    L, D = q.shape[2], q.shape[3]
    if sm_scale is None:
        sm_scale = D ** -0.5
    rep = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * sm_scale
    visible = _visible(L, k.shape[2], causal, window, q.device)
    scores = scores.masked_fill(~visible, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", weights, vf)
    return out.to(q.dtype), lse


def _bwd_p_ds(q, k, v, do, lse, delta, causal, sm_scale, window):
    """Dense f32 recompute of ``P = exp(S * scale - lse)``, forced to 0 on
    invalid pairs (``_bwd_p_block`` :271-288: ``exp`` of a masked score
    minus the lse is not reliably 0), and ``dS = P (dP - delta) scale``,
    both ``[B, H, L, Lk]`` with K/V broadcast over each group."""
    rep = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * sm_scale
    visible = _visible(q.shape[2], k.shape[2], causal, window, q.device)
    p = torch.where(visible, torch.exp(scores - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), vf)
    ds = p * (dp - delta[..., None]) * sm_scale
    return p, ds, kf


def flash_bwd_dkdv_plain(
    q, k, v, do, lse, delta, causal: bool = True,
    sm_scale: float | None = None, window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)`` in k/v's dtype, compact ``[B, KVH, Lk, D]``: the group's
    query heads summed (the JAX dK/dV kernel's sequential ``rep`` axis).
    ``lse`` and ``delta`` are ``[B, H, L]`` f32. The plain version of
    ``csrc/flash_bwd_dkdv.cu``."""
    _check_args(q, k, v, causal, window)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    B, KVH, Lk, D = k.shape
    p, ds, _ = _bwd_p_ds(q, k, v, do, lse, delta, causal, sm_scale, window)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dk = dk.reshape(B, KVH, -1, Lk, D).sum(dim=2)
    dv = dv.reshape(B, KVH, -1, Lk, D).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(
    q, k, v, do, lse, delta, causal: bool = True,
    sm_scale: float | None = None, window: int | None = None,
) -> torch.Tensor:
    """``dQ = dS K`` in q's dtype, ``[B, H, L, D]``. The plain version of
    ``csrc/flash_bwd_dq.cu``."""
    _check_args(q, k, v, causal, window)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    _, ds, kf = _bwd_p_ds(q, k, v, do, lse, delta, causal, sm_scale, window)
    return torch.einsum("bhqk,bhkd->bhqd", ds, kf).to(q.dtype)


def _check_kernel_args(kernel: str, **tensors) -> None:
    """What every kernel takes: tensors on q's CUDA device, contiguous;
    bf16 except the f32 statistics; a head dim of ``KERNEL_HEAD_DIMS``;
    L >= 1."""
    q = tensors["q"]
    if not q.is_cuda:
        raise ValueError(f"the {kernel} kernel takes CUDA tensors, got {q.device}")
    for name, t in tensors.items():
        want = torch.float32 if name in ("lse", "delta") else torch.bfloat16
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != want:
            raise ValueError(f"the {kernel} kernel takes {want} {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the {kernel} kernel needs contiguous {name}")
    if q.shape[3] not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"the {kernel} kernel takes head dims {KERNEL_HEAD_DIMS}, got "
            f"{q.shape[3]}"
        )
    if q.shape[2] < 1 or tensors["k"].shape[2] < 1:
        raise ValueError(f"the {kernel} kernel needs L >= 1 and Lk >= 1")


def check_tma_operand(kernel: str, name: str, t: torch.Tensor) -> None:
    """What a TMA tensor map over ``t`` demands: a dense row-major tensor
    (the map's strides are its shape's) starting on a 16-byte boundary. K1,
    K3 and K4 read and write their bf16 tiles through such maps; anything
    else raises, there is no fallback."""
    if not t.is_contiguous():
        raise ValueError(f"the {kernel} kernel needs contiguous {name} (TMA)")
    if t.data_ptr() % TMA_ALIGN_BYTES:
        raise ValueError(
            f"the {kernel} kernel needs {name} on a {TMA_ALIGN_BYTES}-byte "
            f"boundary (TMA), got address {t.data_ptr():#x}"
        )


def _flash_fwd_cuda(q, k, v, causal, sm_scale, window):
    _check_kernel_args("flash", q=q, k=k, v=v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_tma_operand("flash", name, t)
    B, H, L, _ = q.shape
    KVH, Lk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    FLASH_FWD.launch(
        _entry("bci_flash_fwd_bf16", q.shape[3]),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, KVH, L, Lk, int(causal), window or 0,
        float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out, lse


def _check_bwd_args(kernel, q, k, v, do, lse, delta, causal, sm_scale,
                    window) -> float:
    """What both backward kernels take; returns the softmax scale."""
    _check_args(q, k, v, causal, window)
    _check_kernel_args(kernel, q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    B, H, L = q.shape[:3]
    if lse.shape != (B, H, L) or delta.shape != (B, H, L):
        raise ValueError(
            f"lse {tuple(lse.shape)} / delta {tuple(delta.shape)}: expected "
            f"{(B, H, L)}"
        )
    if do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} does not match q {tuple(q.shape)}")
    return q.shape[-1] ** -0.5 if sm_scale is None else sm_scale


def flash_bwd_dkdv_cuda(q, k, v, do, lse, delta, causal: bool = True,
                        sm_scale: float | None = None,
                        window: int | None = None):
    """``(dK, dV)`` by the dK/dV kernel (K3), bf16, compact
    ``[B, KVH, Lk, D]``."""
    sm_scale = _check_bwd_args("flash_bwd_dkdv", q, k, v, do, lse, delta, causal,
                               sm_scale, window)
    for name, t in (("q", q), ("k", k), ("v", v), ("dO", do)):
        check_tma_operand("flash_bwd_dkdv", name, t)
    B, H, L, _ = q.shape
    KVH, Lk = k.shape[1], k.shape[2]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    FLASH_BWD_DKDV.launch(
        _entry("bci_flash_bwd_dkdv_bf16", q.shape[3]),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, KVH, L, Lk, int(causal), window or 0, float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    return dk, dv


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal: bool = True,
                      sm_scale: float | None = None,
                      window: int | None = None):
    """``dQ`` by the dQ kernel (K4), bf16, ``[B, H, L, D]``."""
    sm_scale = _check_bwd_args("flash_bwd_dq", q, k, v, do, lse, delta, causal,
                               sm_scale, window)
    for name, t in (("q", q), ("k", k), ("v", v), ("dO", do)):
        check_tma_operand("flash_bwd_dq", name, t)
    B, H, L, _ = q.shape
    KVH, Lk = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    FLASH_BWD_DQ.launch(
        _entry("bci_flash_bwd_dq_bf16", q.shape[3]),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        B, H, KVH, L, Lk, int(causal), window or 0, float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    return dq


def _on_cuda(*tensors) -> bool:
    """True for all-CUDA tensors on one device, False for all-CPU; anything
    else raises: the plain versions run only because their inputs lie on
    the CPU."""
    first = tensors[0].device
    if all(t.device == first for t in tensors):
        if first.type == "cuda":
            return True
        if first.type == "cpu":
            return False
    raise ValueError(
        f"tensors on {sorted({str(t.device) for t in tensors})}: expected all "
        "on one CUDA device (kernels) or all on the CPU (plain versions)"
    )


def flash_fwd(q, k, v, causal: bool, sm_scale: float,
              window: int | None = None):
    """``(out, lse)`` outside autograd: K1 on CUDA tensors, its plain
    version on CPU tensors (the forward of ``FlashAttention`` and of the
    ring's hops)."""
    if _on_cuda(q, k, v):
        return _flash_fwd_cuda(q, k, v, causal, sm_scale, window)
    return flash_attention_fwd_plain(q, k, v, causal, sm_scale, window)


def flash_bwd(q, k, v, do, lse, delta, causal: bool, sm_scale: float,
              window: int | None = None):
    """``(dQ, dK, dV)`` from the softmax statistics ``lse`` and ``delta``
    (``[B, H, L]`` f32): K3 and K4 on CUDA tensors, their plain versions on
    CPU tensors (the backward of ``FlashAttention`` and of the ring's
    hops, which pass the merged lse)."""
    args = (q, k, v, do, lse, delta, causal, sm_scale, window)
    if _on_cuda(q, k, v, do):
        dk, dv = flash_bwd_dkdv_cuda(*args)
        return flash_bwd_dq_cuda(*args), dk, dv
    dk, dv = flash_bwd_dkdv_plain(*args)
    return flash_bwd_dq_plain(*args), dk, dv


class FlashAttention(torch.autograd.Function):
    """``(out, lse)`` with its backward: the JAX ``custom_vjp`` pair of
    ``flash_attention_with_lse`` (:599-641). The forward saves the
    forward's own lse; the backward takes the cotangents of both outputs,
    folding ``g_lse`` into ``delta`` (``∂lse/∂S = P``, :416-420)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float,
                window: int | None):
        out, lse = flash_fwd(q, k, v, causal, sm_scale, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, sm_scale, window)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        g_out = g_out.contiguous()
        delta = (g_out.float() * out.float()).sum(dim=-1)
        if g_lse is not None:
            delta = delta - g_lse.float()
        dq, dk, dv = flash_bwd(q, k, v, g_out, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True, sm_scale: float | None = None,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` like the JAX ``flash_attention_with_lse``,
    differentiable through both outputs: the kernels for CUDA tensors, the
    plain versions for CPU tensors."""
    _check_args(q, k, v, causal, window)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, causal, float(sm_scale), window)


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: float | None = None, window: int | None = None):
    """The attention output alone, like the JAX ``flash_attention``."""
    return flash_attention_with_lse(q, k, v, causal, sm_scale, window)[0]


def local_attention(q, k, v, causal: bool = True, window: int | None = None):
    """Single-device attention output, the dispatch of the JAX
    ``local_attention`` (flash_attention.py:656) keyed on the tensors'
    device instead of the platform."""
    return flash_attention(q, k, v, causal, window=window)
