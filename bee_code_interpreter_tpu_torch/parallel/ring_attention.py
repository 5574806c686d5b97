"""Ring attention: exact attention over a sequence sharded across the ranks
of the ``sp`` axis, the counterpart of
``bee_code_interpreter_tpu/parallel/ring_attention.py``.

A sequence of length L lies L/sp per rank (rank r holds positions
``[r L/sp, (r+1) L/sp)``). The queries stay; the compact K/V blocks
(KVH heads, not H) go round the ring, one ``parallel.mesh.ring_shift`` a
hop (JAX's ``lax.ppermute``), so that after ``step`` hops rank r holds the
block of rank ``r - step``. Each rank accumulates its queries' attention
over the blocks it sees:

- ``use_flash`` (the default for CUDA tensors): each hop is one call of the
  flash forward kernel (``ops/flash_attention.py::flash_attention_with_lse``,
  K1), causal on the own block and non-causal on an earlier one, and the
  hops merge on their log-sum-exp from a -1e30 start;
- otherwise (the default for CPU tensors, as JAX's off-TPU default): the
  online-softmax einsum accumulation of ``_block_attend``.

Under ``causal`` a block later than the rank's own is skipped; under a
``window`` (global positions: a query at p sees keys in (p - window, p]) so
is a block wholly below the window, and a block the window boundary
straddles is masked in global offsets (the flash ring attends it through
``boundary_block``, a torch-level masked block that merges like a kernel
hop). The ring still makes its sp - 1 exchanges; the last hop's, whose
result nothing reads, is not sent.

Every rank of the group must call these functions alike (SPMD). The ring
is not differentiable here: ``torch.distributed``'s point-to-point calls
are not autograd-aware, so an input that requires grad under grad mode
raises ``NotImplementedError`` (the sp backward is ROADMAP Queue 1, item
1, slice 11b).
"""

from __future__ import annotations

import torch

from bee_code_interpreter_tpu_torch.ops.flash_attention import (
    flash_attention_with_lse,
)
from bee_code_interpreter_tpu_torch.parallel.mesh import (
    all_gather_cat,
    group_rank,
    group_size,
    ring_shift,
    shard_tensor,
    sp_group,
)

# the flash ring's running max starts here, not at -inf: (-inf) - (-inf)
# would NaN the rescale of a row no hop has reached yet
NEG = -1e30


def refuse_grad(what: str, *tensors) -> None:
    """The sequence-parallel exchanges are not autograd-aware: raise where
    a caller would differentiate through them."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} is not differentiable in the port yet: its exchanges "
            "are torch.distributed calls outside autograd (ROADMAP Queue 1, "
            "item 1, slice 11b: the backward of the ring and of Ulysses)"
        )


def _check_window(causal: bool, window: int | None) -> None:
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True (sliding window)")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")


def _block_attend(q, k, v, m, l, o, sm_scale, mask):
    """One online-softmax accumulation step against a K/V block.

    q, o: ``[B, G, R, Lq, D]``; k, v: ``[B, G, Lk, D]``; m, l: ``[B, G, R,
    Lq, 1]``, all f32 (G the K/V heads, R the query heads of each). mask:
    ``[Lq, Lk]`` additive (-inf) or None."""
    scores = torch.einsum("bgrqd,bgkd->bgrqk", q, k.float()) * sm_scale
    if mask is not None:
        scores = scores + mask
    new_m = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
    correction = torch.exp(m - new_m)
    p = torch.exp(scores - new_m)
    new_l = l * correction + p.sum(dim=-1, keepdim=True)
    new_o = o * correction + torch.einsum("bgrqk,bgkd->bgrqd", p, v.float())
    return new_m, new_l, new_o


def _offsets(Lq: int, Lk: int, device) -> torch.Tensor:
    """``[Lq, Lk]`` row - col."""
    return (torch.arange(Lq, device=device)[:, None]
            - torch.arange(Lk, device=device)[None, :])


def _skipped(causal, window, my_idx, k_idx, Lq) -> bool:
    """A future block, or one wholly below the window (its smallest global
    offset, (my - k) L - (L - 1), already >= window)."""
    if not causal:
        return False
    if k_idx > my_idx:
        return True
    return window is not None and (my_idx - k_idx) * Lq - (Lq - 1) >= window


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group=None,
    causal: bool = True,
    sm_scale: float | None = None,
    use_flash: bool | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Exact attention with K/V going round the ranks of ``group`` (the sp
    axis's process group; None is a ring of one).

    Per rank: q ``[B, H, L_local, D]``, k/v ``[B, KVH, L_local, D]`` with
    ``H % KVH == 0``, the rank's contiguous block of the sequence. Returns
    ``[B, H, L_local, D]`` in q's dtype. ``use_flash`` defaults to the
    tensors' device: the flash forward kernel per hop on CUDA, the einsum
    accumulation on the CPU. ``window`` (requires ``causal``) is a sliding
    window in global positions."""
    _check_window(causal, window)
    refuse_grad("ring_attention", q, k, v)
    if use_flash is None:
        use_flash = q.is_cuda
    if use_flash:
        return _ring_attention_flash(q, k, v, group=group, causal=causal,
                                     sm_scale=sm_scale, window=window)
    B, H, Lq, D = q.shape
    KVH, Lk = k.shape[1], k.shape[2]
    if H % KVH:
        raise ValueError(f"n_heads {H} not a multiple of kv_heads {KVH}")
    scale = sm_scale if sm_scale is not None else D ** -0.5
    n, my_idx = group_size(group), group_rank(group)

    qf = q.float().reshape(B, KVH, H // KVH, Lq, D)
    m = torch.full_like(qf[..., :1], float("-inf"))
    l = torch.zeros_like(qf[..., :1])
    o = torch.zeros_like(qf)
    offset = _offsets(Lq, Lk, q.device)
    own_mask = None
    if causal:
        visible = offset >= 0
        if window is not None:  # own block: local offsets are global ones
            visible &= offset < window
        own_mask = torch.zeros(Lq, Lk, device=q.device).masked_fill(
            ~visible, float("-inf"))

    k_blk, v_blk = k, v
    for step in range(n):
        k_idx = (my_idx - step) % n
        if not _skipped(causal, window, my_idx, k_idx, Lq):
            if causal and k_idx == my_idx:
                mask = own_mask
            elif window is not None:
                delta = (my_idx - k_idx) * Lq  # global row - col shift
                mask = torch.zeros(Lq, Lk, device=q.device).masked_fill(
                    ~(offset < window - delta), float("-inf"))
            else:
                mask = None
            m, l, o = _block_attend(qf, k_blk, v_blk, m, l, o, scale, mask)
        if step < n - 1:
            k_blk, v_blk = ring_shift((k_blk, v_blk), group)
    # every query sees its own block, so l > 0; the floor is JAX's guard
    out = o / torch.clamp(l, min=1e-30)
    return out.reshape(B, H, Lq, D).to(q.dtype)


def _ring_attention_flash(q, k, v, *, group, causal: bool,
                          sm_scale: float | None,
                          window: int | None = None) -> torch.Tensor:
    """Ring attention with the flash forward kernel (K1) per hop, hops
    merged on their log-sum-exp: running ``m = max lse``, ``s = sum
    e^(lse - m)``, ``o = sum out e^(lse - m)``, the result ``o / s``. Each
    hop's ``out`` is in q's dtype, as the kernel returns it; the merge runs
    in f32. The own block is causal (with the window), an earlier block
    wholly inside the window non-causal, a straddled block a
    ``boundary_block``."""
    B, H, Lq, D = q.shape
    KVH, Lk = k.shape[1], k.shape[2]
    n, my_idx = group_size(group), group_rank(group)
    scale = sm_scale if sm_scale is not None else D ** -0.5

    m = torch.full((B, H, Lq, 1), NEG, dtype=torch.float32, device=q.device)
    s = torch.zeros_like(m)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)

    def boundary_block(k_idx, k_blk, v_blk):
        """A masked softmax block (row - col < window - delta in global
        offsets) as (normalized out in q's dtype, lse): a fully masked row
        comes out with lse ~ -1e30 and merges with weight 0."""
        delta = (my_idx - k_idx) * Lq
        qf = q.float().reshape(B, KVH, H // KVH, Lq, D)
        scores = torch.einsum("bgrqd,bgkd->bgrqk", qf, k_blk.float()) * scale
        visible = _offsets(Lq, Lk, q.device) < window - delta
        scores = torch.where(visible, scores, torch.tensor(NEG, device=q.device))
        m_b = scores.amax(dim=-1, keepdim=True)
        p = torch.exp(scores - m_b)
        l_b = p.sum(dim=-1, keepdim=True)  # >= 1: some e^0 survives
        out = torch.einsum("bgrqk,bgkd->bgrqd", p, v_blk.float()) / l_b
        lse = (m_b + torch.log(l_b))[..., 0]
        return out.reshape(B, H, Lq, D).to(q.dtype), lse.reshape(B, H, Lq)

    k_blk, v_blk = k, v
    for step in range(n):
        k_idx = (my_idx - step) % n
        if not _skipped(causal, window, my_idx, k_idx, Lq):
            if causal and k_idx == my_idx:
                out_blk, lse_blk = flash_attention_with_lse(
                    q, k_blk, v_blk, True, sm_scale, window=window)
            elif window is None or (my_idx - k_idx) * Lq + Lq - 1 < window:
                # fully visible: even the largest offset is in the window
                out_blk, lse_blk = flash_attention_with_lse(
                    q, k_blk, v_blk, False, sm_scale)
            else:
                out_blk, lse_blk = boundary_block(k_idx, k_blk, v_blk)
            lse_blk = lse_blk[..., None]
            m_new = torch.maximum(m, lse_blk)
            scale_old = torch.exp(m - m_new)
            scale_blk = torch.exp(lse_blk - m_new)
            o = o * scale_old + out_blk.float() * scale_blk
            s = s * scale_old + scale_blk
            m = m_new
        if step < n - 1:
            k_blk, v_blk = ring_shift((k_blk, v_blk), group)
    return (o / torch.clamp(s, min=1e-30)).to(q.dtype)


def ring_attention_sharded(
    mesh,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    axis_name: str = "sp",
    causal: bool = True,
    sm_scale: float | None = None,
    use_flash: bool | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Standalone entry: every rank passes the whole ``[B, H, L, D]``
    q and ``[B, KVH, L, D]`` k/v, takes its block of L over ``axis_name``,
    runs the ring, and gets the whole output back (the blocks all-gathered
    in rank order), as JAX's entry returns one global array."""
    if axis_name != "sp":
        raise ValueError(f"the ring runs over the sp axis, got {axis_name!r}")
    group = sp_group(mesh)
    spec = (None, None, "sp", None)
    dev = q.device
    out = ring_attention(
        *(shard_tensor(x, spec, mesh, dev) for x in (q, k, v)),
        group=group, causal=causal, sm_scale=sm_scale, use_flash=use_flash,
        window=window,
    )
    return all_gather_cat(out, group, dim=2)


def reference_attention(q, k, v, *, causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    """Dense f32 attention for tests, in q's dtype: grouped-query K/V
    (``[B, KVH, L, D]``, KVH dividing q's heads) broadcast over each group;
    ``window`` masks keys more than window - 1 positions behind the query
    (requires causal)."""
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (
        q.shape[-1] ** -0.5)
    _check_window(causal, window)
    if causal:
        offset = _offsets(scores.shape[-2], scores.shape[-1], q.device)
        mask = offset >= 0
        if window is not None:
            mask &= offset < window
        scores = scores.masked_fill(~mask, float("-inf"))
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v.float()).to(q.dtype)
