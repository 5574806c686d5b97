#!/usr/bin/env python3
"""Same-process A/B of the serving path's attention dispatch, on one GPU.

    python3 scripts/torch-serving-ab.py [--rounds 3]

On the serving path the training slice changed one thing: the flash forward
kernel is now reached through the autograd Function
(``ops/flash_attention.py`` ``FlashAttention``) instead of the bare kernel
wrapper. Serving's wall time is host-bound and varies from call to call, so
this loads Llama-3-8B once (random bf16 weights from a seed, all 32 layers)
and serves ``chip_smoke.py``'s 12 requests alternately through
``local_attention`` as it is ("function") and through the bare wrapper
``_flash_fwd_cuda`` ("bare"), ``--rounds`` times each, in one process,
the order flipping every round. It
also times the host cost of one call of each, enqueued without waiting, at
the shortest prefill (B=1, H=32, KVH=8, L=128). Prints one JSON line with
the nvidia-smi name and power limit. Needs CUDA; exits non-zero without it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from bee_code_interpreter_tpu_torch.models import transformer  # noqa: E402
from bee_code_interpreter_tpu_torch.ops import (  # noqa: E402
    flash_attention as fa,
    paged_attention as pa,
)
from bee_code_interpreter_tpu_torch.ops.cuda_build import build_all  # noqa: E402


def bare_attention(q, k, v, causal=True, window=None):
    """What the first slice called on CUDA tensors: the kernel wrapper
    alone, no autograd node."""
    return fa._flash_fwd_cuda(q, k, v, causal, q.shape[-1] ** -0.5, window)[0]


VARIANTS = {"function": fa.local_attention, "bare": bare_attention}


def host_us_per_call(fn, q, k, v, calls: int = 200) -> float:
    for _ in range(10):
        fn(q, k, v)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn(q, k, v)
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    return host / calls * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch-serving-ab: CUDA is not available", file=sys.stderr)
        return 2
    smi = chip_smoke.nvidia_smi()
    dev = torch.device("cuda", 0)
    build_all([fa.FLASH_FWD, pa.PAGED_DECODE])

    gen = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(1, 32, 128, 128, generator=gen, device=dev, dtype=torch.bfloat16)
    k = torch.randn(1, 8, 128, 128, generator=gen, device=dev, dtype=torch.bfloat16)
    v = torch.randn(1, 8, 128, 128, generator=gen, device=dev, dtype=torch.bfloat16)
    host_us = {name: host_us_per_call(fn, q, k, v)
               for name, fn in VARIANTS.items()}

    cfg = dataclasses.replace(transformer.TransformerConfig.llama3_8b(),
                              paged_attention_kernel=True)
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(5)
    requests = []
    for i, L in enumerate(rng.integers(64, 1025, size=12)):
        prompt = rng.integers(0, cfg.vocab_size, int(L)).tolist()
        sampling = (chip_smoke.SamplingParams() if i % 2 == 0 else
                    chip_smoke.SamplingParams(temperature=0.8, top_k=50,
                                              seed=100 + i))
        requests.append((prompt, 32, sampling))

    runs: dict[str, list[dict]] = {name: [] for name in VARIANTS}
    tokens = {}
    chip_smoke.serve(params, cfg, requests)  # warm up
    for i in range(args.rounds):  # the order flips each round
        for name, fn in list(VARIANTS.items())[::1 if i % 2 == 0 else -1]:
            transformer.local_attention = fn
            try:
                r = chip_smoke.serve(params, cfg, requests)
            finally:
                transformer.local_attention = fa.local_attention
            tokens.setdefault(name, r["tokens"])
            generated = sum(len(t) for t in r["tokens"])
            runs[name].append({
                "tokens_per_s": generated / r["wall_s"],
                "ttft_p50_ms": float(np.median(r["ttft_s"])) * 1e3,
                "decode_step_p50_ms": float(np.median(r["decode_only_step_ms"])),
            })
    chip_smoke.check(tokens["function"] == tokens["bare"],
                     "the two dispatches gave other tokens")
    print(json.dumps({
        "nvidia_smi": smi, "rounds": args.rounds,
        "host_us_per_call": host_us,
        "median": {name: {key: float(np.median([r[key] for r in rs]))
                          for key in rs[0]} for name, rs in runs.items()},
        "runs": runs, "identical_tokens": True,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
