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
  flash forward kernel (``ops/flash_attention.py::flash_fwd``, K1), causal on the own block and non-causal on an earlier one, and the
  hops merge on their log-sum-exp from a -1e30 start;
- otherwise (the default for CPU tensors, as JAX's off-TPU default): the
  online-softmax einsum accumulation of ``_block_attend``.

Under ``causal`` a block later than the rank's own is skipped; under a
``window`` (global positions: a query at p sees keys in (p - window, p]) so
is a block wholly below the window, and a block the window boundary
straddles is masked in global offsets (the flash ring attends it through
``_boundary_block``, a torch-level masked block that merges like a kernel
hop). The ring still makes its sp - 1 exchanges; the last hop's, whose
result nothing reads, is not sent.

Every rank of the group must call these functions alike (SPMD).

The ring is differentiable on both paths through one
``torch.autograd.Function`` that owns its backward. The forward keeps q,
k, v, the merged output and the merged log-sum-exp. The backward runs the
ring again on every rank, K/V going round with their dK/dV accumulators:
on each hop the forward attended it adds that block's share of the
gradient, taken against the merged statistics (``P = exp(S - lse)`` and
``delta = rowsum(dO * O)``, the per-hop VJP of JAX's transpose with the
lse cotangent folded into delta): the flash path calls the dK/dV and dQ
kernels (K3, K4; their plain versions on the CPU) directly, causal on the
own block and not on an earlier one, and a ``_boundary_block`` or an
einsum hop takes the same formula in torch. dQ accumulates on the rank;
the dK/dV accumulators, after the last hop, move once more to reach the
rank that owns their block. Every rank makes the same exchanges in the
same order whatever it attended: a ring built from a differentiable shift
would leave the exchanges of a rank whose shifted blocks never reach the
loss (rank 0 under ``causal``) out of its backward, and its neighbour
would wait for them forever.
"""

from __future__ import annotations

import torch

from bee_code_interpreter_tpu_torch.ops.flash_attention import (
    flash_bwd,
    flash_fwd,
)
from bee_code_interpreter_tpu_torch.parallel.mesh import (
    gather_from_group,
    group_rank,
    group_size,
    ring_shift,
    split_to_group,
    sp_group,
)

# the flash ring's running max starts here, not at -inf: (-inf) - (-inf)
# would NaN the rescale of a row no hop has reached yet
NEG = -1e30


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


def _hop_kind(causal, window, my_idx, k_idx, Lq) -> str | None:
    """How a rank attends the block of rank ``k_idx``: None (skipped),
    ``"own"`` (causal, with the window), ``"full"`` (every pair visible)
    or ``"boundary"`` (the window's edge straddles the block)."""
    if _skipped(causal, window, my_idx, k_idx, Lq):
        return None
    if causal and k_idx == my_idx:
        return "own"
    if window is None or (my_idx - k_idx) * Lq + Lq - 1 < window:
        return "full"
    return "boundary"


def _visible(kind, window, my_idx, k_idx, Lq, Lk, device):
    """``[Lq, Lk]`` bool of a hop's visible pairs in global offsets, None
    where every pair is visible."""
    if kind == "full":
        return None
    offset = _offsets(Lq, Lk, device)
    if kind == "own":  # local offsets are global ones
        visible = offset >= 0
        return visible if window is None else visible & (offset < window)
    return offset < window - (my_idx - k_idx) * Lq


def _grouped(x: torch.Tensor, kvh: int) -> torch.Tensor:
    """``[B, H, L, ...]`` as f32 ``[B, KVH, H / KVH, L, ...]``."""
    return x.float().reshape(x.shape[0], kvh, -1, *x.shape[2:])


def _boundary_block(q, k, v, visible, scale):
    """A masked softmax block as (normalized out in q's dtype, lse ``[B,
    H, Lq]``): a fully masked row comes out with lse ~ -1e30 and merges
    with weight 0."""
    B, H, Lq, D = q.shape
    scores = torch.einsum("bgrqd,bgkd->bgrqk", _grouped(q, k.shape[1]),
                          k.float()) * scale
    scores = torch.where(visible, scores, torch.tensor(NEG, device=q.device))
    m_b = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m_b)
    l_b = p.sum(dim=-1, keepdim=True)  # >= 1: some e^0 survives
    out = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float()) / l_b
    lse = (m_b + torch.log(l_b))[..., 0]
    return out.reshape(B, H, Lq, D).to(q.dtype), lse.reshape(B, H, Lq)


def _hop_grads(q, k, v, do, lse, delta, scale, visible):
    """One hop's share of ``(dQ, dK, dV)``, f32, against the merged ``lse``
    and ``delta`` (``[B, H, Lq]``): ``P = exp(S - lse)`` on the visible
    pairs, ``dS = P (dP - delta) scale``; dK/dV compact, summed over each
    K/V head's query heads. The torch formula of K3/K4's work, for the
    einsum hops and the boundary blocks."""
    B, H, Lq, D = q.shape
    KVH = k.shape[1]
    qg, dog = _grouped(q, KVH), _grouped(do, KVH)
    kf, vf = k.float(), v.float()
    scores = torch.einsum("bgrqd,bgkd->bgrqk", qg, kf) * scale
    p = torch.exp(scores - _grouped(lse, KVH)[..., None])
    if visible is not None:
        p = torch.where(visible, p, 0.0)
    dp = torch.einsum("bgrqd,bgkd->bgrqk", dog, vf)
    ds = p * (dp - _grouped(delta, KVH)[..., None]) * scale
    dq = torch.einsum("bgrqk,bgkd->bgrqd", ds, kf).reshape(B, H, Lq, D)
    dk = torch.einsum("bgrqk,bgrqd->bgkd", ds, qg)
    dv = torch.einsum("bgrqk,bgrqd->bgkd", p, dog)
    return dq, dk, dv


def _ring_einsum(q, k, v, group, causal, scale, window):
    """The einsum ring (JAX's off-TPU default): ``(out, lse)``."""
    B, H, Lq, D = q.shape
    KVH, Lk = k.shape[1], k.shape[2]
    n, my_idx = group_size(group), group_rank(group)
    qf = _grouped(q, KVH)
    m = torch.full_like(qf[..., :1], float("-inf"))
    l = torch.zeros_like(qf[..., :1])
    o = torch.zeros_like(qf)
    k_blk, v_blk = k, v
    for step in range(n):
        k_idx = (my_idx - step) % n
        kind = _hop_kind(causal, window, my_idx, k_idx, Lq)
        if kind is not None:
            visible = _visible(kind, window, my_idx, k_idx, Lq, Lk, q.device)
            mask = None if visible is None else torch.zeros(
                Lq, Lk, device=q.device).masked_fill(~visible, float("-inf"))
            m, l, o = _block_attend(qf, k_blk, v_blk, m, l, o, scale, mask)
        if step < n - 1:
            k_blk, v_blk = ring_shift((k_blk, v_blk), group)
    # every query sees its own block, so l > 0; the floor is JAX's guard
    l = torch.clamp(l, min=1e-30)
    out = (o / l).reshape(B, H, Lq, D).to(q.dtype)
    return out, (m + torch.log(l)).reshape(B, H, Lq)


def _ring_flash(q, k, v, group, causal, scale, window):
    """The flash ring: the flash forward kernel (K1) per hop, hops merged
    on their log-sum-exp: running ``m = max lse``, ``s = sum e^(lse - m)``,
    ``o = sum out e^(lse - m)``, the result ``o / s``. Each hop's ``out``
    is in q's dtype, as the kernel returns it; the merge runs in f32. The
    own block is causal (with the window), an earlier block wholly inside
    the window non-causal, a straddled block a ``_boundary_block``.
    Returns ``(out, lse)``."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    n, my_idx = group_size(group), group_rank(group)
    m = torch.full((B, H, Lq, 1), NEG, dtype=torch.float32, device=q.device)
    s = torch.zeros_like(m)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for step in range(n):
        k_idx = (my_idx - step) % n
        kind = _hop_kind(causal, window, my_idx, k_idx, Lq)
        if kind is not None:
            if kind == "boundary":
                out_blk, lse_blk = _boundary_block(q, k_blk, v_blk, _visible(
                    kind, window, my_idx, k_idx, Lq, Lk, q.device), scale)
            else:
                own = kind == "own"
                out_blk, lse_blk = flash_fwd(q, k_blk, v_blk, own, scale,
                                             window if own else None)
            lse_blk = lse_blk[..., None]
            m_new = torch.maximum(m, lse_blk)
            scale_old = torch.exp(m - m_new)
            scale_blk = torch.exp(lse_blk - m_new)
            o = o * scale_old + out_blk.float() * scale_blk
            s = s * scale_old + scale_blk
            m = m_new
        if step < n - 1:
            k_blk, v_blk = ring_shift((k_blk, v_blk), group)
    s = torch.clamp(s, min=1e-30)
    return (o / s).to(q.dtype), (m + torch.log(s))[..., 0]


class _Ring(torch.autograd.Function):
    """The ring's forward on either path, and its backward: the ring run
    again (see the module's docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale, window, use_flash):
        run = _ring_flash if use_flash else _ring_einsum
        out, lse = run(q, k, v, group, causal, scale, window)
        ctx.save_for_backward(q, k, v, out, lse.contiguous())
        ctx.args = (group, causal, scale, window, use_flash)
        return out

    @staticmethod
    def backward(ctx, g_out):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale, window, use_flash = ctx.args
        n, my_idx = group_size(group), group_rank(group)
        Lq, Lk = q.shape[2], k.shape[2]
        do = g_out.contiguous()
        delta = (do.float() * out.float()).sum(dim=-1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        k_blk, v_blk = k, v
        for step in range(n):
            k_idx = (my_idx - step) % n
            kind = _hop_kind(causal, window, my_idx, k_idx, Lq)
            if kind is not None:
                if use_flash and kind != "boundary":
                    own = kind == "own"
                    gq, gk, gv = flash_bwd(q, k_blk, v_blk, do, lse, delta,
                                           own, scale, window if own else None)
                else:
                    gq, gk, gv = _hop_grads(q, k_blk, v_blk, do, lse, delta,
                                            scale, _visible(
                                                kind, window, my_idx, k_idx,
                                                Lq, Lk, q.device))
                dq += gq.float()
                dk += gk.float()
                dv += gv.float()
            if step < n - 1:
                k_blk, v_blk, dk, dv = ring_shift((k_blk, v_blk, dk, dv),
                                                  group)
        # rank r holds block r + 1's accumulators: one more hop to its owner
        dk, dv = ring_shift((dk, dv), group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


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
    ``[B, H, L_local, D]`` in q's dtype, differentiable in q, k and v.
    ``use_flash`` defaults to the tensors' device: the flash kernels per
    hop on CUDA, the einsum accumulation on the CPU. ``window`` (requires
    ``causal``) is a sliding window in global positions."""
    _check_window(causal, window)
    if use_flash is None:
        use_flash = q.is_cuda
    D = q.shape[-1]
    if q.shape[1] % k.shape[1]:
        raise ValueError(
            f"n_heads {q.shape[1]} not a multiple of kv_heads {k.shape[1]}")
    scale = float(sm_scale if sm_scale is not None else D ** -0.5)
    return _Ring.apply(q, k, v, group, causal, scale, window, bool(use_flash))


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
    in rank order), as JAX's entry returns one global array.
    Differentiable: a loss every rank computes from the whole output
    counts once, and every rank gets the whole gradient of q, k and v
    (``split_to_group`` / ``gather_from_group``)."""
    if axis_name != "sp":
        raise ValueError(f"the ring runs over the sp axis, got {axis_name!r}")
    group = sp_group(mesh)
    out = ring_attention(
        *(split_to_group(x, group, 2) for x in (q, k, v)),
        group=group, causal=causal, sm_scale=sm_scale, use_flash=use_flash,
        window=window,
    )
    return gather_from_group(out, group, 2)


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
