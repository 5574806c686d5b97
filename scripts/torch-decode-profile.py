#!/usr/bin/env python3
"""Where a decode step of the PyTorch port spends its time, on one GPU.

    python3 scripts/torch-decode-profile.py [--layers N] [--steps 8]
        [--kv-cache-dtype bf16|int8] [--window W] [--weight-int8] [--moe]

Serves Llama-3-8B widths, 32 layers (``--moe``: Mixtral-8x7B widths, 16 of
its 32 layers, capacity routing at the defaults; random bf16 weights from a
seed, paged decode kernel on) with 8 rows admitted at prompt lengths
64-1024, then profiles
``--steps`` decode steps with ``torch.profiler``; ``--kv-cache-dtype int8``
does so on an int8 page pool (einsum attention, no paged decode kernel);
``--weight-int8`` on weight-only int8 weights (``ops/weight_quant.py``:
each projection converts its int8 weight to bf16 before the product).
``--window W`` profiles admission windows instead: one prompt of
``(2 * steps + 2) * W`` tokens admitted with ``interleave_admission=W`` and
no row decoding, so each step runs one window of W tokens (the path of
prefix hits and interleaved admission). Prints one JSON line: wall
time per step, device time per step summed over kernels, the device idle
share (1 - device time / wall), and the device time per kernel name (top
15) from the traced steps, next to the nvidia-smi name and power limit. Needs CUDA; exits
non-zero without it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bee_code_interpreter_tpu_torch.models.serving import (  # noqa: E402
    ContinuousBatcher,
)
from bee_code_interpreter_tpu_torch.models.transformer import (  # noqa: E402
    TransformerConfig,
    init_params,
    n_params,
)
from bee_code_interpreter_tpu_torch.ops.weight_quant import (  # noqa: E402
    quantize_weights,
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=None,
                    help="default 32, or 16 with --moe")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--kv-cache-dtype", choices=("bf16", "int8"),
                    default="bf16")
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--weight-int8", action="store_true")
    ap.add_argument("--moe", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch-decode-profile: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    base = (TransformerConfig.mixtral_8x7b() if args.moe
            else TransformerConfig.llama3_8b())
    layers = args.layers or (16 if args.moe else 32)
    cfg = dataclasses.replace(base, n_layers=layers,
                              paged_attention_kernel=True,
                              kv_cache_dtype=args.kv_cache_dtype)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    # the bf16 weights' streaming bound (the int8 tree moves about half)
    bound_ms = 2.0 * n_params(params) / 3.35e12 * 1e3
    if args.weight_int8:
        params = quantize_weights(params)
    batcher = ContinuousBatcher(params, cfg, max_batch=8, page_size=16,
                                max_pages_per_seq=128, n_pages=1 + 8 * 128)
    rng = np.random.default_rng(5)
    if args.window:
        prompt = rng.integers(0, cfg.vocab_size, (2 * args.steps + 2) * args.window)
        batcher.submit(prompt.tolist(), 1, interleave_admission=args.window)
    else:
        for L in rng.integers(64, 1025, size=8):
            batcher.submit(rng.integers(0, cfg.vocab_size, int(L)).tolist(),
                           2 * args.steps + 4)
    for _ in range(2):  # warm up
        batcher.step()
    torch.cuda.synchronize()
    # wall time without the profiler (it slows the host), then the trace
    t0 = time.perf_counter()
    for _ in range(args.steps):
        batcher.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            batcher.step()
        torch.cuda.synchronize()
    # kernels and copies on the device, each with its own time range
    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    per_kernel: dict[str, float] = {}
    for evt in device_events:
        name = evt.name[:80]  # templated kernels share a long prefix
        per_kernel[name] = per_kernel.get(name, 0.0) + evt.time_range.elapsed_us()
    device_us = sum(per_kernel.values())
    wall_ms = wall / args.steps * 1e3
    device_ms = device_us / args.steps / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps({
        "nvidia_smi": smi, "config": "mixtral_8x7b" if args.moe else "llama3_8b",
        "layers": layers, "steps": args.steps,
        "kv_cache_dtype": args.kv_cache_dtype, "window": args.window,
        "weight_int8": args.weight_int8,
        "rows": int(batcher.active.sum()),
        "wall_ms_per_step": wall_ms,
        "bf16_weight_stream_bound_ms": bound_ms,
        "device_ms_per_step": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms if wall_ms else None,
        "kernels_ms_per_step": {name: us / args.steps / 1e3
                                for name, us in top},
        "device_events_per_step": len(device_events) / args.steps,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
