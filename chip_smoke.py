#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each printed as one JSON line, any failure exits non-zero:

1. card: name and power limit (nvidia-smi), CUDA version; TF32 off for the
   f32 references.
2. build: both hand-written kernels from ``ops/csrc`` with nvcc for sm_90a,
   in parallel, into ``ops/_build`` (ptxas register/spill lines printed).
3. kernels: each kernel against its plain PyTorch version on the same bf16
   inputs (the plain version in f32) at the main path's shapes, with its
   time, the plain version's, one library call's (K1: SDPA with GQA) and
   the card's bound for the work.
4. reference: the decoder cut to 2 layers at Llama-3-8B widths, prefill +
   paged decode teacher-forced, bf16 kernels on the card against the f32
   plain path on the CPU on the same weights.
5. main path: Llama-3-8B (full width and depth, random weights from a seed)
   served by Engine -> ContinuousBatcher: 12 requests with prompts of
   64-1024 tokens on 8 rows, 32 new tokens each, greedy and seeded sampled;
   the launch counts of both kernels must match the admissions and decode
   steps; a second identical run must give identical tokens.

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
# bf16 kernel vs f32 plain version on the same bf16 inputs: the output is
# rounded to bf16 (~4e-3 at |x| ~ 1) and K1 rounds P to bf16 for P V
KERNEL_TOL = 2e-2
# bf16 decoder on the card vs the f32 plain path on the CPU, 2 layers at
# 8B widths: max |logit error| over max |logit|
REFERENCE_TOL = 5e-2
K1_MAIN_CASE = (1, 1024)  # (B, L): the largest prefill the main path runs


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
    events: the main path finds K/V and Q cold."""

    def __init__(self, device) -> None:
        self.flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, reps: int, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(reps):
            self.flush_buf.zero_()
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


def check_flash(timer, dev) -> list[dict]:
    H, KVH, D = 32, 8, 128
    cases = [(B, L, None) for B in (1, 4) for L in (128, 1024, 2048)]
    cases.append((1, 2048, 512))  # sliding window
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for B, L, window in cases:
        q = torch.randn(B, H, L, D, generator=gen, device=dev, dtype=torch.bfloat16)
        k = torch.randn(B, KVH, L, D, generator=gen, device=dev, dtype=torch.bfloat16)
        v = torch.randn(B, KVH, L, D, generator=gen, device=dev, dtype=torch.bfloat16)
        out, lse = fa.flash_attention_with_lse(q, k, v, True, window=window)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_fwd_plain(
            q.float(), k.float(), v.float(), True, window=window
        )
        err = max((out.float() - ref_out).abs().max().item(),
                  (lse - ref_lse).abs().max().item())
        check(err <= KERNEL_TOL,
              f"flash_fwd B={B} L={L} window={window}: max abs err {err}")
        ms = timer(lambda: fa.flash_attention_with_lse(q, k, v, True, window=window), 20)
        plain_ms = timer(lambda: fa.flash_attention_fwd_plain(
            q.float(), k.float(), v.float(), True, window=window), 3, warmup=1)
        if window is None:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=True, enable_gqa=True)
        else:
            i = torch.arange(L, device=dev)
            mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask, enable_gqa=True)
        library_ms = timer(lib, 20)
        rows_i = torch.arange(L)
        pairs = int(torch.minimum(rows_i + 1, torch.tensor(window or L)).sum())
        flops = 4.0 * B * H * pairs * D
        nbytes = 2.0 * (2 * q.numel() + 2 * k.numel()) + 4.0 * lse.numel()
        b_ms, b_by = bound(flops, nbytes)
        rows.append({
            "B": B, "L": L, "window": window, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
            "bound_by": b_by, "tflops": flops / ms / 1e9,
        })
        del q, k, v, out, lse, ref_out, ref_lse
    return rows


def check_paged_decode(timer, dev) -> dict:
    B, nh, kvh, dh, ps, P = 8, 32, 8, 128, 16, 128
    n_pages = 1 + B * P
    rng = np.random.default_rng(2)
    lengths = rng.integers(1, 2049, size=B).astype(np.int32)
    table = (1 + rng.permutation(B * P)).reshape(B, P).astype(np.int32)
    for b in range(B):  # -1 sentinels past each row's pages
        table[b, -(-int(lengths[b]) // ps):] = -1
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(B, nh, dh, generator=gen, device=dev, dtype=torch.bfloat16)
    kp = torch.randn(n_pages, kvh, ps, dh, generator=gen, device=dev, dtype=torch.bfloat16)
    vp = torch.randn(n_pages, kvh, ps, dh, generator=gen, device=dev, dtype=torch.bfloat16)
    bt = torch.as_tensor(table, device=dev)
    lens = torch.as_tensor(lengths, device=dev)
    out = pa.paged_decode_attention(q, kp, vp, bt, lens)
    torch.cuda.synchronize()
    ref = pa.paged_decode_attention_plain(q.float(), kp.float(), vp.float(), bt, lens)
    err = (out.float() - ref).abs().max().item()
    check(err <= KERNEL_TOL, f"paged_decode: max abs err {err}")
    ms = timer(lambda: pa.paged_decode_attention(q, kp, vp, bt, lens), 50)
    plain_ms = timer(lambda: pa.paged_decode_attention_plain(q, kp, vp, bt, lens), 10)
    visible = int(np.minimum(lengths, P * ps).sum())
    nbytes = (2.0 * kvh * visible * dh * 2 + 2 * q.numel() * 2
              + 4 * (bt.numel() + lens.numel()))
    flops = 4.0 * nh * visible * dh
    b_ms, b_by = bound(flops, nbytes)
    return {
        "B": B, "nh": nh, "kvh": kvh, "ps": ps, "P": P,
        "lengths": lengths.tolist(), "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms,
        "bound_by": b_by, "gb_per_s": nbytes / ms / 1e6,
    }


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

    kernels = [fa.FLASH_FWD, pa.PAGED_DECODE]
    t = time.perf_counter()
    build_all(kernels)
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "ptxas": [line.strip() for k in kernels
                    for line in k.build_log().splitlines()
                    if "registers" in line or "spill" in line]})

    timer = Timer(dev)
    flash_rows = check_flash(timer, dev)
    emit({"phase": "flash_fwd", "tolerance": KERNEL_TOL, "cases": flash_rows})
    paged = check_paged_decode(timer, dev)
    emit({"phase": "paged_decode", "tolerance": KERNEL_TOL, **paged})
    del timer

    cfg = dataclasses.replace(TransformerConfig.llama3_8b(),
                              paged_attention_kernel=True)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    emit(check_reference(params, cfg, dev))
    report, first = main_path(params, cfg)
    emit(report)

    main_k1 = next(r for r in flash_rows
                   if (r["B"], r["L"], r["window"]) == (*K1_MAIN_CASE, None))
    emit({"kernels": [
        {
            "name": "flash_fwd", "route": "cuda",
            "source": "bee_code_interpreter_tpu_torch/ops/csrc/flash_fwd.cu",
            "replaces": "bee_code_interpreter_tpu/ops/flash_attention.py:48",
            "launches": first["k1_launches"],
            "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
            "ms": main_k1["ms"], "kernel_ms": main_k1["ms"],
            "plain_ms": main_k1["plain_ms"], "bound_ms": main_k1["bound_ms"],
            "bound_by": main_k1["bound_by"],
            "library_ms": main_k1["library_ms"],
            "shape": "B=1 H=32 KVH=8 L=1024 D=128 causal bf16",
        },
        {
            "name": "paged_decode", "route": "cuda",
            "source": "bee_code_interpreter_tpu_torch/ops/csrc/paged_decode.cu",
            "replaces": "bee_code_interpreter_tpu/ops/paged_attention.py:47",
            "launches": first["k2_launches"],
            "max_abs_err": paged["max_abs_err"],
            "ms": paged["ms"], "kernel_ms": paged["ms"],
            "plain_ms": paged["plain_ms"], "bound_ms": paged["bound_ms"],
            "bound_by": paged["bound_by"], "library_ms": None,
            "shape": "B=8 nh=32 kvh=8 dh=128 ps=16 P=128 bf16",
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
