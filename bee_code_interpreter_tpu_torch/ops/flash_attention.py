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
``csrc/flash_bwd_dkdv.cu`` and ``csrc/flash_bwd_dq.cu`` backward), CPU
tensors to the plain versions
(``flash_attention_fwd_plain``, ``flash_bwd_dkdv_plain``,
``flash_bwd_dq_plain``). There is no third path and no fallback from one to
the other. ``delta = rowsum(dO * O) - g_lse`` is a PyTorch reduction, as the
JAX code computes it outside its kernels (:431-437).

On the card each kernel takes what JAX's takes, bf16 or f32 at every head
dim 1..256 (``kernel_route``): bf16 runs on the tensor-core instances (D =
64 and D = 128 on TMA and wgmma, D = 256 on mma.sync, ``csrc/flash_mma.cuh``;
one C entry point each), a head dim between them at the next instance's
width: read in place where it is a multiple of 8 (the instance's columns
past D are zeros: a TMA box past the map's D columns, or a tile row past
them), zero-padded by the wrapper otherwise (``pad_width``): exact either
way, since zero columns leave Q K^T unchanged and the extra columns of P V
are never stored, with ``sm_scale`` the true ``D ** -0.5``. f32 runs at
every head dim on the CUDA-core kernels of ``csrc/flash_simt.cuh``
(computed in f32, as JAX's kernels keep f32 inputs f32 in both products).
Above 256 the wrappers raise.
"""

from __future__ import annotations

import ctypes

import torch

from bee_code_interpreter_tpu_torch.ops.cuda_build import CudaKernel

# the head dims of the tensor-core (bf16) instances, each with its C entry
# point: the TMA/wgmma template at NB = D / 64 boxes a tile (64, 128) and the
# mma.sync kernel of csrc/flash_mma.cuh (256)
KERNEL_HEAD_DIMS = (64, 128, 256)
# the widest head dim any kernel takes
MAX_HEAD_DIM = 256
# the dtypes the kernels take
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _entry(base: str, head_dim: int) -> str:
    """The C entry point of kernel ``base`` at ``head_dim``."""
    return base if head_dim == 128 else f"{base}_d{head_dim}"


def kernel_route(dtype: torch.dtype, head_dim: int) -> tuple[str, int]:
    """Which kernel takes ``dtype`` inputs at ``head_dim`` on the card:
    ``("tensor_core", width)``, the bf16 instance of that width (the
    wrappers zero-pad Q, K, V and dO to it where it differs), or ``("simt",
    head_dim)``, the CUDA-core kernel (f32 at every head dim). Raises
    ValueError above ``MAX_HEAD_DIM`` and for a dtype other than bf16 or
    f32."""
    if dtype not in KERNEL_DTYPES:
        raise ValueError(
            f"the flash kernels take bfloat16 or float32, got {dtype}")
    if not 1 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(
            f"the flash kernels take head dims 1..{MAX_HEAD_DIM}, got "
            f"{head_dim}")
    if dtype == torch.bfloat16:
        return "tensor_core", next(d for d in KERNEL_HEAD_DIMS if d >= head_dim)
    return "simt", head_dim


def pad_width(dtype: torch.dtype, head_dim: int) -> int:
    """The head dim the wrappers hand the kernel: the tensor-core
    instance's width for a bf16 head dim no multiple of 8 (a TMA row stride
    and a 16-byte load need one), else ``head_dim`` itself."""
    route, width = kernel_route(dtype, head_dim)
    return width if route == "tensor_core" and head_dim % 8 else head_dim


def _signatures(base: str, argtypes: list) -> dict:
    out = {_entry(f"{base}_bf16", d): argtypes for d in KERNEL_HEAD_DIMS}
    out[f"{base}_simt"] = argtypes
    return out


# q, k, v, out, lse; B, H, KVH, Lq, Lk, causal, window, the head dim;
# sm_scale; stream
_TAIL = [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
FLASH_FWD = CudaKernel("flash_fwd", _signatures(
    "bci_flash_fwd", [ctypes.c_void_p] * 5 + _TAIL))
# q, k, v, dO, lse, delta, then the outputs (dk, dv / dq); then as above
FLASH_BWD_DKDV = CudaKernel("flash_bwd_dkdv", _signatures(
    "bci_flash_bwd_dkdv", [ctypes.c_void_p] * 8 + _TAIL))
FLASH_BWD_DQ = CudaKernel("flash_bwd_dq", _signatures(
    "bci_flash_bwd_dq", [ctypes.c_void_p] * 7 + _TAIL))
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
    """What every kernel takes: tensors on q's CUDA device, contiguous; q's
    dtype (bf16 or f32) except the f32 statistics; L >= 1. The head dim
    and dtype are ``kernel_route``'s to judge."""
    q = tensors["q"]
    if not q.is_cuda:
        raise ValueError(f"the {kernel} kernel takes CUDA tensors, got {q.device}")
    kernel_route(q.dtype, q.shape[3])
    for name, t in tensors.items():
        want = torch.float32 if name in ("lse", "delta") else q.dtype
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != want:
            raise ValueError(f"the {kernel} kernel takes {want} {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the {kernel} kernel needs contiguous {name}")
    if q.shape[2] < 1 or tensors["k"].shape[2] < 1:
        raise ValueError(f"the {kernel} kernel needs L >= 1 and Lk >= 1")


def check_tma_operand(kernel: str, name: str, t: torch.Tensor) -> None:
    """What a TMA tensor map over ``t`` demands: a dense row-major tensor
    (the map's strides are its shape's) starting on a 16-byte boundary. The
    tensor-core instances of K1, K3 and K4 read and write their bf16 tiles
    through such maps; anything else raises, there is no fallback."""
    if not t.is_contiguous():
        raise ValueError(f"the {kernel} kernel needs contiguous {name} (TMA)")
    if t.data_ptr() % TMA_ALIGN_BYTES:
        raise ValueError(
            f"the {kernel} kernel needs {name} on a {TMA_ALIGN_BYTES}-byte "
            f"boundary (TMA), got address {t.data_ptr():#x}"
        )


def pad_head_dim(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` with zero columns appended up to head dim ``width``: a new
    dense tensor (what the tensor-core instances take at a head dim they
    have no instance of), or ``t`` itself at that width."""
    if t.shape[-1] == width:
        return t
    return torch.nn.functional.pad(t, (0, width - t.shape[-1])).contiguous()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _flash_fwd_cuda(q, k, v, causal, sm_scale, window):
    _check_kernel_args("flash", q=q, k=k, v=v)
    B, H, L, D = q.shape
    KVH, Lk = k.shape[1], k.shape[2]
    sm_scale = D ** -0.5 if sm_scale is None else sm_scale
    route, width = kernel_route(q.dtype, D)
    cols = pad_width(q.dtype, D)
    q, k, v = (pad_head_dim(t, cols) for t in (q, k, v))
    if route == "tensor_core":
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_tma_operand("flash", name, t)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    entry = ("bci_flash_fwd_simt" if route == "simt"
             else _entry("bci_flash_fwd_bf16", width))
    FLASH_FWD.launch(
        entry, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, KVH, L, Lk, int(causal), window or 0, cols,
        float(sm_scale), _stream(q),
    )
    return (out if cols == D else out[..., :D].contiguous()), lse


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


def _bwd_width(kernel: str, q, k, v, do, lse, delta, causal, sm_scale,
               window):
    """Check the backward operands; return them at the width the kernels
    take (``pad_width``) and the scale of the true head dim."""
    sm_scale = _check_bwd_args(kernel, q, k, v, do, lse, delta, causal,
                               sm_scale, window)
    cols = pad_width(q.dtype, q.shape[-1])
    return [pad_head_dim(t, cols) for t in (q, k, v, do)], sm_scale


def _bwd_launch(kernel: CudaKernel, base: str, q, k, v, do, lse, delta,
                causal, sm_scale, window, outputs) -> None:
    """Launch ``base``'s entry point for the dtype and width of checked
    operands (``_bwd_width``'s), writing ``outputs``."""
    B, H, L, cols = q.shape
    route, width = kernel_route(q.dtype, cols)
    if route == "tensor_core":
        for name, t in (("q", q), ("k", k), ("v", v), ("dO", do)):
            check_tma_operand(kernel.name, name, t)
    entry = (f"{base}_simt" if route == "simt"
             else _entry(f"{base}_bf16", width))
    kernel.launch(entry, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  *(t.data_ptr() for t in outputs), B, H, k.shape[1], L,
                  k.shape[2], int(causal), window or 0, cols, float(sm_scale),
                  _stream(q))


def flash_bwd_dkdv_cuda(q, k, v, do, lse, delta, causal: bool = True,
                        sm_scale: float | None = None,
                        window: int | None = None):
    """``(dK, dV)`` by the dK/dV kernel (K3) in k/v's dtype, compact
    ``[B, KVH, Lk, D]``."""
    D = q.shape[-1]
    (q, k, v, do), sm_scale = _bwd_width("flash_bwd_dkdv", q, k, v, do, lse,
                                         delta, causal, sm_scale, window)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch(FLASH_BWD_DKDV, "bci_flash_bwd_dkdv", q, k, v, do, lse, delta,
                causal, sm_scale, window, (dk, dv))
    if k.shape[-1] != D:
        dk, dv = dk[..., :D].contiguous(), dv[..., :D].contiguous()
    return dk, dv


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal: bool = True,
                      sm_scale: float | None = None,
                      window: int | None = None):
    """``dQ`` by the dQ kernel (K4) in q's dtype, ``[B, H, L, D]``."""
    D = q.shape[-1]
    (q, k, v, do), sm_scale = _bwd_width("flash_bwd_dq", q, k, v, do, lse,
                                         delta, causal, sm_scale, window)
    dq = torch.empty_like(q)
    _bwd_launch(FLASH_BWD_DQ, "bci_flash_bwd_dq", q, k, v, do, lse, delta,
                causal, sm_scale, window, (dq,))
    return dq if q.shape[-1] == D else dq[..., :D].contiguous()


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
        D = q.shape[-1]
        # pad (where the width asks for it) once for both kernels
        (q, k, v, do), sm_scale = _bwd_width("flash_bwd", q, k, v, do, lse,
                                             delta, causal, sm_scale, window)
        args = (q, k, v, do, lse, delta, causal, sm_scale, window)
        dk, dv = flash_bwd_dkdv_cuda(*args)
        dq = flash_bwd_dq_cuda(*args)
        if q.shape[-1] != D:
            dq, dk, dv = (t[..., :D].contiguous() for t in (dq, dk, dv))
        return dq, dk, dv
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
