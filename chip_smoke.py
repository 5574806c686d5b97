#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each printed as one JSON line, any failure exits non-zero:

1. card: name and power limit (nvidia-smi), CUDA version; TF32 off for the
   f32 references.
2. build: the four hand-written kernels from ``ops/csrc`` (all four on the
   TMA/wgmma/mma building blocks of ``csrc/hopper.cuh``) with nvcc for sm_90a,
   one nvcc per source in parallel, into ``ops/_build`` (seconds and ptxas
   register/spill lines printed).
3. serving kernels (K1 forward, K2 paged decode): each against its plain
   PyTorch version on the same bf16 inputs (the plain version in f32) at the
   paths' shapes, with its time, the plain version's, one library call's
   (SDPA with GQA for K1), the card's bound for the work and the rate. K1
   runs the serving prefill lengths (48 and 80: shorter than one tile and
   ragged; 1000: ragged key tiles), long batches, full attention with
   Lq != Lk and a sliding window. K2 runs seven cases (``K2_CASES``: the
   serving decode's lengths, one long row, one in a table of 32 splits, a
   wide batch, lengths on page and split boundaries and past the table, an
   f32 pool), each with the split the wrapper chose and each row held to a
   limit of its dtype; two K2 calls must give the same bits.
4. serving reference: the decoder cut to 2 layers at Llama-3-8B widths,
   prefill + paged decode teacher-forced, bf16 kernels on the card against
   the f32 plain path on the CPU on the same weights.
5. serving path: Llama-3-8B (full width and depth, random weights from a
   seed) served by Engine -> ContinuousBatcher: 12 requests with prompts of
   64-1024 tokens on 8 rows, 32 new tokens each, greedy and seeded sampled;
   the launch counts of K1 and K2 must match the admissions and decode
   steps; a second identical run must give identical tokens.
6. training kernels (K3 dK/dV, K4 dQ), as in 3, on K1's own out/lse, with
   SDPA's backward as the library call; two K3 calls and two K4 calls on the
   same inputs must give the same bits.
7. training reference: one training step of the decoder cut to 2 layers at
   Llama-3-8B widths (B=1, L=128, f32 masters), bf16 compute with K1/K3/K4
   on the card against the f32 plain path on the CPU: loss and every leaf's
   gradient.
8. training path: ``Transformer.make_train_step`` on Llama-3-8B widths cut to
   8 layers (f32 masters and AdamW state do not fit one card at 32), one
   fixed batch of 2 x 1024 tokens, 4 steps: falling loss, a finite non-zero
   gradient on every leaf after step 1, K1/K3/K4 each launched once per
   layer and step.

The last lines are the ``kernels`` JSON line, the nvidia-smi line, and
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and prints
no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))

from bee_code_interpreter_tpu_torch.models import transformer  # noqa: E402
from bee_code_interpreter_tpu_torch.models.engine import Engine  # noqa: E402
from bee_code_interpreter_tpu_torch.models.serving import (  # noqa: E402
    ContinuousBatcher,
    SamplingParams,
)
from bee_code_interpreter_tpu_torch.models.transformer import (  # noqa: E402
    TransformerConfig,
    init_params,
)
from bee_code_interpreter_tpu_torch.ops import (  # noqa: E402
    flash_attention as fa,
    paged_attention as pa,
)
from bee_code_interpreter_tpu_torch.ops.cuda_build import build_all  # noqa: E402
from bee_code_interpreter_tpu_torch.ops.paged_kv_cache import (  # noqa: E402
    alloc_paged_cache,
    seed_prefill,
)

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
# ~0.2 ms of device time ahead of each timed call: more than the host takes to
# enqueue a kernel wrapper (tens of microseconds)
SLEEP_CYCLES = 400_000
# bf16 kernel vs f32 plain version on the same bf16 inputs: the output is
# rounded to bf16 (~4e-3 at |x| ~ 1) and K1 rounds P to bf16 for P V
KERNEL_TOL = 2e-2
# K3/K4 vs their f32 plain versions on the same bf16 inputs: max |error| over
# max |gradient|. P and dS are rounded to bf16 for the tensor cores and the
# outputs are bf16; this script's flash_bwd phase on an H100 showed at most
# 3.7e-3 over its 7 shapes, so 1e-2 (tighter than the 2e-2 of the forward
# checks) keeps 2.7x headroom.
BWD_TOL = 1e-2
# K2 vs its f32 plain version, per row of each case: max |error| over the
# row's max |output|, so a long row's small outputs are held as tightly as a
# short row's. bf16 pools: the output is rounded to bf16 (<= 2^-9 of it) and
# P to bf16 for the tensor cores; f32 pools keep every step in f32. An
# earlier H100 run read 4.1e-3 (bf16) and 1.4e-6 (f32) as absolute errors.
K2_ROW_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
# bf16 decoder on the card vs the f32 plain path on the CPU, 2 layers at
# 8B widths: max |logit error| over max |logit|
REFERENCE_TOL = 5e-2
# one training step of that decoder, bf16 on the card vs f32 on the CPU:
# relative loss error, and per leaf ||g_card - g_cpu|| / ||g_cpu||. The
# first H100 run gave 1.7e-5 and at most 2.5e-2 (bf16 activations and
# weight casts); the limits keep 60x and 1.6x headroom.
TRAIN_LOSS_TOL = 1e-3
TRAIN_GRAD_TOL = 4e-2
# (B, Lq, Lk, causal, window): the largest prefill the serving path runs
K1_MAIN_CASE = (1, 1024, 1024, True, None)
# the training path: Llama-3-8B widths cut to 8 layers (2.80 B parameters,
# 44.7 GB of f32 masters, gradients and AdamW moments), batch 2 x 1024
TRAIN_LAYERS, TRAIN_B, TRAIN_L, TRAIN_STEPS = 8, 2, 1024, 4
# backward cases (B, Lq, Lk, causal, window, with g_lse) at H=32, KVH=8,
# D=128; the training path runs (2, 1024, 1024, True, None, False)
BWD_CASES = [
    (2, 128, 128, True, None, False),
    (2, 1000, 1000, True, None, False),
    (2, 1024, 1024, True, None, False),
    (2, 2048, 2048, True, None, False),
    (2, 300, 700, False, None, False),
    (2, 2048, 2048, True, 512, False),
    (2, 1000, 1000, True, None, True),
]
BWD_MAIN_CASE = (TRAIN_B, TRAIN_L, TRAIN_L, True, None, False)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Mean milliseconds of ``fn`` by CUDA events around each call, with
    the L2 cache flushed (a 256 MB write) between calls, outside the
    events: the main path finds K/V and Q cold. A device-side sleep after
    the flush keeps the card busy while the host enqueues the call, so the
    events time the kernels and not the host's launch path."""

    def __init__(self, device) -> None:
        self.flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=device)
        warm = torch.randn(8192, 8192, device=device, dtype=torch.bfloat16)
        for _ in range(100):  # ~0.2 s of tensor-core work: the clocks ramp up first
            warm @ warm
        torch.cuda.synchronize()

    def __call__(self, fn, reps: int, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(reps):
            self.flush_buf.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / reps


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ------------------------------------------------------------------ kernels


# forward cases (B, Lq, Lk, causal, window) at H=32, KVH=8, D=128: the
# serving path's prefills (L = the prompt padded to 16: shorter than one
# 128-row tile, ragged q-tiles and key tiles), long batches, full attention
# with Lq != Lk, and a sliding window
K1_CASES = [
    (1, 48, 48, True, None),
    (1, 80, 80, True, None),
    (1, 1000, 1000, True, None),
    *[(B, L, L, True, None) for B in (1, 4) for L in (128, 1024, 2048)],
    (1, 300, 700, False, None),
    (1, 2048, 2048, True, 512),
]


def check_flash(timer, dev) -> list[dict]:
    H, KVH, D = 32, 8, 128
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for B, L, Lk, causal, window in K1_CASES:
        q = torch.randn(B, H, L, D, generator=gen, device=dev, dtype=torch.bfloat16)
        k = torch.randn(B, KVH, Lk, D, generator=gen, device=dev, dtype=torch.bfloat16)
        v = torch.randn(B, KVH, Lk, D, generator=gen, device=dev, dtype=torch.bfloat16)
        out, lse = fa.flash_attention_with_lse(q, k, v, causal, window=window)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_fwd_plain(
            q.float(), k.float(), v.float(), causal, window=window
        )
        err = max((out.float() - ref_out).abs().max().item(),
                  (lse - ref_lse).abs().max().item())
        case = f"B={B} Lq={L} Lk={Lk} causal={causal} window={window}"
        check(err <= KERNEL_TOL, f"flash_fwd {case}: max abs err {err}")
        ms = timer(lambda: fa.flash_attention_with_lse(q, k, v, causal, window=window), 20)
        plain_ms = timer(lambda: fa.flash_attention_fwd_plain(
            q.float(), k.float(), v.float(), causal, window=window), 3, warmup=1)
        if window is None:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=causal, enable_gqa=True)
        else:
            i = torch.arange(L, device=dev)
            mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask, enable_gqa=True)
        library_ms = timer(lib, 20)
        flops = 4.0 * B * H * visible_pairs(L, Lk, causal, window) * D
        nbytes = 2.0 * (2 * q.numel() + 2 * k.numel()) + 4.0 * lse.numel()
        b_ms, b_by = bound(flops, nbytes)
        rows.append({
            "B": B, "L": L, "Lk": Lk, "causal": causal, "window": window,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "tflops": flops / ms / 1e9,
        })
        del q, k, v, out, lse, ref_out, ref_lse
    return rows


def visible_pairs(Lq: int, Lk: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs that attend: the work the kernels cannot skip."""
    if not causal:
        return Lq * Lk
    rows = torch.arange(Lq)
    hi = torch.clamp(rows + 1, max=Lk)
    lo = torch.zeros_like(rows) if window is None else torch.clamp(
        rows - window + 1, min=0)
    return int((hi - lo).clamp(min=0).sum())


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |error|, max |error| / max |want|)."""
    err = (got.float() - want).abs().max().item()
    return err, err / want.abs().max().item()


def check_flash_bwd(timer, dev) -> list[dict]:
    """K3 and K4 on K1's own out/lse and a random dO, against their plain
    versions in f32 and against SDPA's backward."""
    H, KVH, D = 32, 8, 128
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for B, Lq, Lk, causal, window, with_g_lse in BWD_CASES:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.bfloat16)

        q, k, v = randn(B, H, Lq, D), randn(B, KVH, Lk, D), randn(B, KVH, Lk, D)
        do = randn(B, H, Lq, D)
        out, lse = fa.flash_attention_with_lse(q, k, v, causal, window=window)
        delta = (do.float() * out.float()).sum(dim=-1)
        if with_g_lse:
            delta = delta - torch.randn(B, H, Lq, generator=gen, device=dev)
        args = (q, k, v, do, lse, delta, causal, None, window)
        dk, dv = fa.flash_bwd_dkdv_cuda(*args)
        dq = fa.flash_bwd_dq_cuda(*args)
        dk2, dv2 = fa.flash_bwd_dkdv_cuda(*args)
        dq2 = fa.flash_bwd_dq_cuda(*args)
        torch.cuda.synchronize()
        case = f"B={B} Lq={Lq} Lk={Lk} causal={causal} window={window}"
        # a fixed order of summation, no atomics: two calls give the same bits
        check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
              f"flash_bwd dk/dv {case}: two calls differ")
        check(torch.equal(dq, dq2), f"flash_bwd dq {case}: two calls differ")
        del dk2, dv2, dq2
        f32 = (q.float(), k.float(), v.float(), do.float(), *args[4:])
        want_dk, want_dv = fa.flash_bwd_dkdv_plain(*f32)
        want_dq = fa.flash_bwd_dq_plain(*f32)
        errs = {name: rel_err(got, want) for name, got, want in
                (("dk", dk, want_dk), ("dv", dv, want_dv), ("dq", dq, want_dq))}
        del want_dk, want_dv, want_dq, f32
        for name, (_, rel) in errs.items():
            check(rel <= BWD_TOL, f"flash_bwd {name} {case}: rel err {rel}")

        dkdv_ms = timer(lambda: fa.flash_bwd_dkdv_cuda(*args), 10)
        dq_ms = timer(lambda: fa.flash_bwd_dq_cuda(*args), 10)
        dkdv_plain_ms = timer(lambda: fa.flash_bwd_dkdv_plain(*args), 2, warmup=1)
        dq_plain_ms = timer(lambda: fa.flash_bwd_dq_plain(*args), 2, warmup=1)
        qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
        if window is None:
            ref = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal,
                                                 enable_gqa=True)
        else:
            i = torch.arange(Lq, device=dev)
            mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
            ref = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask,
                                                 enable_gqa=True)
        library_ms = timer(lambda: torch.autograd.grad(
            ref, (qr, kr, vr), do, retain_graph=True), 10)
        del ref, qr, kr, vr

        pairs = visible_pairs(Lq, Lk, causal, window)
        io = 2.0 * (2 * q.numel() + 2 * k.numel()) + 4.0 * 2 * lse.numel()
        dkdv_bound = bound(8.0 * B * H * pairs * D, io + 2.0 * 2 * k.numel())
        dq_bound = bound(6.0 * B * H * pairs * D, io + 2.0 * q.numel())
        rows.append({
            "B": B, "Lq": Lq, "Lk": Lk, "causal": causal, "window": window,
            "g_lse": with_g_lse, "pairs": pairs, "dkdv_deterministic": True,
            "dq_deterministic": True,
            "dkdv": {"max_abs_err": max(errs["dk"][0], errs["dv"][0]),
                     "rel_err": max(errs["dk"][1], errs["dv"][1]),
                     "ms": dkdv_ms, "plain_ms": dkdv_plain_ms,
                     "bound_ms": dkdv_bound[0], "bound_by": dkdv_bound[1],
                     "tflops": 8.0 * B * H * pairs * D / dkdv_ms / 1e9},
            "dq": {"max_abs_err": errs["dq"][0], "rel_err": errs["dq"][1],
                   "ms": dq_ms, "plain_ms": dq_plain_ms,
                   "bound_ms": dq_bound[0], "bound_by": dq_bound[1],
                   "tflops": 6.0 * B * H * pairs * D / dq_ms / 1e9},
            # SDPA's backward computes dQ, dK and dV together: the yardstick
            # for K3 + K4
            "library_ms": library_ms,
            "tflops_library": 14.0 * B * H * pairs * D / library_ms / 1e9,
        })
        del q, k, v, do, out, lse, delta, dk, dv, dq, args
    return rows


# paged decode cases at nh=32, kvh=8, dh=128, ps=16: name -> (lengths,
# dtype, P), P = 128 being the serving pool's table. The first is the case
# the kernels line reports; then the serving decode (prompts 64-1024 of
# main_path's seed plus 32 new tokens, at B=8), one long row, one longer row
# in a 4096-slot table (32 splits: the merge kernel folds 16 a pass, so this
# takes its rescale across passes), a wide batch of short rows (one split),
# lengths 1 and exact page and split multiples (416 = one split of 26 pages
# at B=8) and past the table's 2048 slots, and an f32 pool. Every table has
# -1 sentinels past its row's pages.
K2_CASES = {
    "b8_seed2": (np.random.default_rng(2).integers(1, 2049, size=8).tolist(), "bfloat16", 128),
    "serving_b8": ([int(n) + 32 for n in
                    np.random.default_rng(5).integers(64, 1025, size=12)[:8]], "bfloat16", 128),
    "b1_2048": ([2048], "bfloat16", 128),
    "b1_4000_p256": ([4000], "bfloat16", 256),
    "b32_short": ([64 + 7 * i for i in range(32)], "bfloat16", 128),
    "edges_b8": ([1, 16, 32, 415, 416, 832, 2048, 3000], "bfloat16", 128),
    "b8_seed2_f32": (np.random.default_rng(2).integers(1, 2049, size=8).tolist(), "float32", 128),
}
K2_MAIN_CASE = "b8_seed2"


def check_paged_decode(timer, dev) -> list[dict]:
    """K2 on every case against its plain version (f32 math on the same
    inputs), two calls' bits, its time, the plain version's, the byte bound
    and the split the wrapper chose."""
    nh, kvh, dh, ps = 32, 8, 128, 16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for name, (lengths, dtype, P) in K2_CASES.items():
        B = len(lengths)
        n_pages = 1 + B * P
        rng = np.random.default_rng(2)
        table = (1 + rng.permutation(B * P)).reshape(B, P).astype(np.int32)
        for b in range(B):  # -1 sentinels past each row's pages
            table[b, -(-int(lengths[b]) // ps):] = -1
        gen = torch.Generator(device=dev).manual_seed(3)
        dt = getattr(torch, dtype)
        q = torch.randn(B, nh, dh, generator=gen, device=dev).to(dt)
        kp = torch.randn(n_pages, kvh, ps, dh, generator=gen, device=dev).to(dt)
        vp = torch.randn(n_pages, kvh, ps, dh, generator=gen, device=dev).to(dt)
        bt = torch.as_tensor(table, device=dev)
        lens = torch.as_tensor(np.asarray(lengths, dtype=np.int32), device=dev)
        out = pa.paged_decode_attention(q, kp, vp, bt, lens)
        out2 = pa.paged_decode_attention(q, kp, vp, bt, lens)
        torch.cuda.synchronize()
        # a fixed order of the split merge: two calls give the same bits
        check(torch.equal(out, out2), f"paged_decode {name}: two calls differ")
        ref = pa.paged_decode_attention_plain(q.float(), kp.float(), vp.float(), bt, lens)
        err = (out.float() - ref).abs().max().item()
        check(err <= KERNEL_TOL, f"paged_decode {name}: max abs err {err}")
        row_err = ((out.float() - ref).abs().amax(dim=(1, 2))
                   / ref.abs().amax(dim=(1, 2)).clamp_min(1e-30)).max().item()
        check(row_err <= K2_ROW_TOL[dtype],
              f"paged_decode {name}: row err {row_err} over {K2_ROW_TOL[dtype]}")
        ms = timer(lambda: pa.paged_decode_attention(q, kp, vp, bt, lens), 50)
        plain_ms = timer(lambda: pa.paged_decode_attention_plain(q, kp, vp, bt, lens), 10)
        visible = int(np.minimum(lengths, P * ps).sum())
        nbytes = (2.0 * kvh * visible * dh * kp.element_size()
                  + 2 * q.numel() * q.element_size() + 4 * (bt.numel() + lens.numel()))
        flops = 4.0 * nh * visible * dh
        b_ms, b_by = bound(flops, nbytes)
        pps = pa.split_pages(B, kvh, P, ps, sms)
        rows.append({
            "case": name, "B": B, "nh": nh, "kvh": kvh, "ps": ps, "P": P,
            "dtype": dtype, "lengths": lengths, "pages_per_split": pps,
            "splits": -(-P // pps), "max_abs_err": err, "max_row_rel_err": row_err,
            "row_tolerance": K2_ROW_TOL[dtype], "deterministic": True,
            "ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms,
            "bound_by": b_by, "gb_per_s": nbytes / ms / 1e6,
        })
        del q, kp, vp, out, out2, ref
    return rows


# ---------------------------------------------------------------- reference


def teacher_forced_logits(params, cfg, device, prompts, feed) -> torch.Tensor:
    """Prefill each prompt as the batcher does (padded to whole pages,
    seeded into its pages), then decode ``feed`` [B, n] token by token.
    Returns [B, 1 + n, vocab] f32 logits (prefill last row, then steps)."""
    ps, P = 16, 8
    cache = alloc_paged_cache(cfg, 1 + len(prompts) * P, ps, device)
    table = np.zeros((len(prompts), P), dtype=np.int32)
    rows = []
    for b, prompt in enumerate(prompts):
        L = len(prompt)
        n_pp = -(-L // ps)
        table[b] = 1 + b * P + np.arange(P)
        padded = np.zeros(n_pp * ps, dtype=np.int64)
        padded[:L] = prompt
        logits, (k_pre, v_pre) = transformer.forward(
            params, torch.as_tensor(padded[None], device=device), cfg,
            return_kv=True,
        )
        seed_prefill(cache, torch.as_tensor(table[b, :n_pp], device=device),
                     k_pre[:, 0, :, :L], v_pre[:, 0, :, :L])
        rows.append(logits[0, L - 1])
    out = [torch.stack(rows)]
    pos = torch.as_tensor([len(p) for p in prompts], device=device)
    bt = torch.as_tensor(table, device=device)
    for s in range(feed.shape[1]):
        tok = torch.as_tensor(feed[:, s:s + 1], device=device)
        logits, cache = transformer.decode_step_paged(
            params, tok, pos + s, cache, bt, cfg
        )
        out.append(logits[:, 0])
    return torch.stack(out, dim=1).float().cpu()


def check_reference(params, cfg, dev) -> dict:
    small = dataclasses.replace(cfg, n_layers=2)
    cut = {**params, "layers": params["layers"][:2]}
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (40, 23)]
    feed = rng.integers(0, cfg.vocab_size, (2, 6))
    got = teacher_forced_logits(cut, small, dev, prompts, feed)
    cpu = {
        "embed": cut["embed"].float().cpu(), "ln_f": cut["ln_f"].float().cpu(),
        "lm_head": cut["lm_head"].float().cpu(),
        "layers": [{k: w.float().cpu() for k, w in layer.items()}
                   for layer in cut["layers"]],
    }
    f32 = dataclasses.replace(small, dtype=torch.float32)
    want = teacher_forced_logits(cpu, f32, torch.device("cpu"), prompts, feed)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    check(bool(torch.isfinite(got).all()), "reference: non-finite logits")
    check(rel <= REFERENCE_TOL, f"reference: relative logit error {rel}")
    return {"phase": "reference", "layers": 2, "rel_max_logit_err": rel,
            "argmax_agreement": agree, "tolerance": REFERENCE_TOL}


# ---------------------------------------------------------------- main path


def serve(params, cfg, requests) -> dict:
    """One Engine run over ``requests``; counts kernel launches and decode
    steps from zero."""
    batcher = ContinuousBatcher(params, cfg, max_batch=8, page_size=16,
                                max_pages_per_seq=128, n_pages=1 + 8 * 128)
    engine = Engine(batcher)
    steps = [0]
    decode = transformer.decode_step_paged

    def counted(*args, **kwargs):
        steps[0] += 1
        return decode(*args, **kwargs)

    fa.FLASH_FWD.launches = 0
    pa.PAGED_DECODE.launches = 0
    transformer.decode_step_paged = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tickets = [engine.submit(p, n, sampling=s) for p, n, s in requests]
        ttft: dict[int, float] = {}
        decode_only_ms = []
        while engine.pending or batcher.busy:
            k1, n_steps = fa.FLASH_FWD.launches, steps[0]
            t = time.perf_counter()
            engine.step()  # ends in a host read of the step's tokens
            dt = time.perf_counter() - t
            if fa.FLASH_FWD.launches == k1 and steps[0] > n_steps:
                decode_only_ms.append(dt * 1e3)
            now = time.perf_counter() - t0
            for tk in tickets:
                if tk not in ttft and engine.partial_result(tk):
                    ttft[tk] = now
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        transformer.decode_step_paged = decode
    return {
        "tokens": [engine.result(t) for t in tickets],
        "finish": [engine.finish_reason(t) for t in tickets],
        "k1_launches": fa.FLASH_FWD.launches,
        "k2_launches": pa.PAGED_DECODE.launches,
        "decode_steps": steps[0],
        "wall_s": wall,
        "ttft_s": [ttft[t] for t in tickets],
        "decode_only_step_ms": decode_only_ms,
    }


def main_path(params, cfg) -> tuple[dict, dict]:
    rng = np.random.default_rng(5)
    new_tokens = 32
    requests = []
    for i, L in enumerate(rng.integers(64, 1025, size=12)):
        prompt = rng.integers(0, cfg.vocab_size, int(L)).tolist()
        sampling = (SamplingParams() if i % 2 == 0 else
                    SamplingParams(temperature=0.8, top_k=50, seed=100 + i))
        requests.append((prompt, new_tokens, sampling))
    first = serve(params, cfg, requests)
    second = serve(params, cfg, requests)
    n_layers, n_req = cfg.n_layers, len(requests)
    check(all(f == "length" for f in first["finish"]),
          f"finish reasons {first['finish']}")
    check(all(len(t) == new_tokens and all(0 <= x < cfg.vocab_size for x in t)
              for t in first["tokens"]), "wrong result lengths or token ids")
    check(first["k1_launches"] == n_layers * n_req,
          f"flash_fwd launched {first['k1_launches']} times, expected "
          f"{n_layers} x {n_req} admissions")
    check(first["decode_steps"] > 0
          and first["k2_launches"] == n_layers * first["decode_steps"],
          f"paged_decode launched {first['k2_launches']} times over "
          f"{first['decode_steps']} decode steps")
    check(second["tokens"] == first["tokens"], "second run gave other tokens")
    generated = sum(len(t) for t in first["tokens"])
    n_params = transformer.n_params(params)
    report = {
        "phase": "main_path", "config": "llama3_8b", "dtype": "bfloat16",
        "layers": n_layers, "requests": n_req,
        "prompt_lens": [len(p) for p, _, _ in requests],
        "new_tokens": new_tokens, "max_batch": 8,
        "tokens_per_s": generated / first["wall_s"],
        "wall_s": first["wall_s"],
        "ttft_p50_ms": float(np.median(first["ttft_s"])) * 1e3,
        "decode_step_p50_ms": float(np.median(first["decode_only_step_ms"])),
        "decode_only_steps": len(first["decode_only_step_ms"]),
        "decode_steps": first["decode_steps"],
        "k1_launches": first["k1_launches"],
        "k2_launches": first["k2_launches"],
        "n_params": n_params,
        "weight_stream_bound_ms": 2.0 * n_params / HBM_BYTES_PER_S * 1e3,
        "second_run_identical": True,
        "second_run_tokens_per_s": generated / second["wall_s"],
    }
    return report, first


# ----------------------------------------------------------------- training


def token_batch(rng, cfg, B: int, L: int, device) -> dict:
    """Random tokens; the targets are the tokens shifted by one."""
    seq = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, L + 1)),
                          device=device)
    return {"tokens": seq[:, :-1], "targets": seq[:, 1:]}


def check_train_reference(dev) -> dict:
    """One training step's loss and every leaf's gradient: bf16 compute
    through K1/K3/K4 on the card against the f32 plain path on the CPU, on
    the same f32 master weights."""
    cfg = dataclasses.replace(TransformerConfig.llama3_8b(), n_layers=2)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(8),
                         dev, dtype=torch.float32, requires_grad=True)
    batch = token_batch(np.random.default_rng(9), cfg, 1, 128, dev)
    loss = transformer.loss_fn(params, batch, cfg)
    loss.backward()
    cpu = {
        name: w.detach().cpu().requires_grad_() for name, w in params.items()
        if name != "layers"
    }
    cpu["layers"] = [{name: w.detach().cpu().requires_grad_()
                      for name, w in layer.items()}
                     for layer in params["layers"]]
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    want = transformer.loss_fn(
        cpu, {name: x.cpu() for name, x in batch.items()}, f32)
    want.backward()
    loss_rel = abs(loss.item() - want.item()) / abs(want.item())
    grad_rel = []
    for got, ref in zip(transformer.param_leaves(params),
                        transformer.param_leaves(cpu)):
        diff = torch.linalg.vector_norm(got.grad.cpu() - ref.grad)
        grad_rel.append((diff / torch.linalg.vector_norm(ref.grad)).item())
    check(all(np.isfinite(grad_rel)), f"train reference: grad errors {grad_rel}")
    check(loss_rel <= TRAIN_LOSS_TOL, f"train reference: loss rel err {loss_rel}")
    check(max(grad_rel) <= TRAIN_GRAD_TOL,
          f"train reference: max grad rel err {max(grad_rel)}")
    return {"phase": "train_reference", "layers": 2, "B": 1, "L": 128,
            "loss_card": loss.item(), "loss_cpu": want.item(),
            "loss_rel_err": loss_rel, "max_grad_rel_err": max(grad_rel),
            "grad_rel_err_by_leaf": grad_rel,
            "tolerance": {"loss": TRAIN_LOSS_TOL, "grad": TRAIN_GRAD_TOL}}


def train_path(dev) -> dict:
    """The training main path: ``Transformer.make_train_step`` at
    Llama-3-8B widths, ``TRAIN_LAYERS`` deep, on one fixed batch; counts
    kernel launches from zero."""
    cfg = dataclasses.replace(TransformerConfig.llama3_8b(),
                              n_layers=TRAIN_LAYERS)
    model = transformer.Transformer(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(10), dev)
    step = model.make_train_step()
    batch = token_batch(np.random.default_rng(6), cfg, TRAIN_B, TRAIN_L, dev)
    leaves = transformer.param_leaves(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kernel in (fa.FLASH_FWD, fa.FLASH_BWD_DKDV, fa.FLASH_BWD_DQ):
        kernel.launches = 0
    opt_state, losses, step_ms, grad_norms = None, [], [], []
    for i in range(TRAIN_STEPS):
        t = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(loss.item())  # waits for the step
        step_ms.append((time.perf_counter() - t) * 1e3)
        if i == 0:  # the gradients of step 1 stay on the leaves until step 2
            grad_norms = [None if w.grad is None
                          else torch.linalg.vector_norm(w.grad).item()
                          for w in leaves]
    launches = {"flash_fwd": fa.FLASH_FWD.launches,
                "flash_bwd_dkdv": fa.FLASH_BWD_DKDV.launches,
                "flash_bwd_dq": fa.FLASH_BWD_DQ.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)), f"train: losses {losses}")
    check(losses[-1] < losses[0], f"train: loss did not fall: {losses}")
    bad = [i for i, n in enumerate(grad_norms)
           if n is None or not np.isfinite(n) or n <= 0]
    check(not bad, f"train: leaves {bad} (of param_leaves) without a finite "
          "non-zero gradient after step 1")
    want = TRAIN_LAYERS * TRAIN_STEPS
    check(all(n == want for n in launches.values()),
          f"train: launches {launches}, expected {want} each")
    n_params = transformer.n_params(params)
    n_matmul = n_params - params["embed"].numel()  # the embedding is a gather
    tokens = TRAIN_B * TRAIN_L
    pairs = visible_pairs(TRAIN_L, TRAIN_L, True, None)
    flops = (6.0 * n_matmul * tokens
             + 12.0 * TRAIN_LAYERS * TRAIN_B * cfg.n_heads * pairs * cfg.head_dim)
    p50 = float(np.median(step_ms[1:]))
    return {
        "phase": "train", "config": "llama3_8b", "layers": TRAIN_LAYERS,
        "dtype": "bfloat16 compute, float32 masters", "B": TRAIN_B,
        "L": TRAIN_L, "steps": TRAIN_STEPS, "n_params": n_params,
        "losses": losses, "step_ms": step_ms, "step_ms_p50_2_to_4": p50,
        "tokens_per_s": tokens / p50 * 1e3,
        "model_tflops": flops / p50 / 1e9,
        "peak_memory_gb": peak_gb, "launches": launches,
        "leaves_with_finite_nonzero_grad": len(grad_norms),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "card", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": False, "cudnn_allow_tf32": False})

    kernels = [fa.FLASH_FWD, fa.FLASH_BWD_DKDV, fa.FLASH_BWD_DQ, pa.PAGED_DECODE]
    t = time.perf_counter()
    build_all(kernels)
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "ptxas": [line.strip() for k in kernels
                    for line in k.build_log().splitlines()
                    if any(w in line for w in ("entry function", "registers",
                                               "spill"))]})

    # serving first (its kernels, reference and path), then training: the
    # serving path meets the card as it did before the training phases
    timer = Timer(dev)
    flash_rows = check_flash(timer, dev)
    emit({"phase": "flash_fwd", "tolerance": KERNEL_TOL, "cases": flash_rows})
    paged_rows = check_paged_decode(timer, dev)
    emit({"phase": "paged_decode", "tolerance": KERNEL_TOL, "cases": paged_rows})
    paged = next(r for r in paged_rows if r["case"] == K2_MAIN_CASE)
    del timer

    cfg = dataclasses.replace(TransformerConfig.llama3_8b(),
                              paged_attention_kernel=True)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    emit(check_reference(params, cfg, dev))
    report, first = main_path(params, cfg)
    emit(report)
    del params  # the training phases need the card's memory
    torch.cuda.empty_cache()

    timer = Timer(dev)
    bwd_rows = check_flash_bwd(timer, dev)
    emit({"phase": "flash_bwd", "tolerance": BWD_TOL, "H": 32, "KVH": 8,
          "D": 128, "cases": bwd_rows})
    del timer
    torch.cuda.empty_cache()
    emit(check_train_reference(dev))
    torch.cuda.empty_cache()
    train = train_path(dev)
    emit(train)

    main_k1 = next(r for r in flash_rows
                   if (r["B"], r["L"], r["Lk"], r["causal"], r["window"])
                   == K1_MAIN_CASE)
    main_bwd = next(r for r in bwd_rows
                    if (r["B"], r["Lq"], r["Lk"], r["causal"], r["window"],
                        r["g_lse"]) == BWD_MAIN_CASE)
    bwd_shape = (f"B={TRAIN_B} H=32 KVH=8 L={TRAIN_L} D=128 causal bf16, "
                 "lse/delta f32")

    def bwd_entry(name, key, replaces):
        row = main_bwd[key]
        return {
            "name": name, "route": "cuda",
            "source": f"bee_code_interpreter_tpu_torch/ops/csrc/{name}.cu",
            "replaces": replaces,
            "launches": train["launches"][name],
            "max_abs_err": max(r[key]["max_abs_err"] for r in bwd_rows),
            "max_rel_err": max(r[key]["rel_err"] for r in bwd_rows),
            "ms": row["ms"], "kernel_ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            # SDPA's whole backward (dQ, dK, dV): the yardstick for K3 + K4
            "library_ms": main_bwd["library_ms"],
            "shape": bwd_shape,
        }

    emit({"kernels": [
        {
            "name": "flash_fwd", "route": "cuda",
            "source": "bee_code_interpreter_tpu_torch/ops/csrc/flash_fwd.cu",
            "replaces": "bee_code_interpreter_tpu/ops/flash_attention.py:48",
            "launches": first["k1_launches"],
            "train_launches": train["launches"]["flash_fwd"],
            "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
            "ms": main_k1["ms"], "kernel_ms": main_k1["ms"],
            "plain_ms": main_k1["plain_ms"], "bound_ms": main_k1["bound_ms"],
            "bound_by": main_k1["bound_by"],
            "library_ms": main_k1["library_ms"],
            "shape": "B=1 H=32 KVH=8 L=1024 D=128 causal bf16",
        },
        bwd_entry("flash_bwd_dkdv", "dkdv",
                  "bee_code_interpreter_tpu/ops/flash_attention.py:291"),
        bwd_entry("flash_bwd_dq", "dq",
                  "bee_code_interpreter_tpu/ops/flash_attention.py:357"),
        {
            "name": "paged_decode", "route": "cuda",
            "source": "bee_code_interpreter_tpu_torch/ops/csrc/paged_decode.cu",
            "replaces": "bee_code_interpreter_tpu/ops/paged_attention.py:47",
            "launches": first["k2_launches"],
            "max_abs_err": max(r["max_abs_err"] for r in paged_rows),
            "ms": paged["ms"], "kernel_ms": paged["ms"],
            "plain_ms": paged["plain_ms"], "bound_ms": paged["bound_ms"],
            "bound_by": paged["bound_by"], "library_ms": None,
            "shape": "B=8 nh=32 kvh=8 dh=128 ps=16 P=128 bf16",
            "splits": paged["splits"],
            "cases_ms": {r["case"]: r["ms"] for r in paged_rows},
        },
    ]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
