#!/usr/bin/env python3
"""Time the tensor-parallel collectives of the port at Llama-3-8B's serving
shapes, tp=2.

    python3 scripts/torch-tp-collectives.py [--reps 50]

Two ranks are spawned (``parallel.spawn``) as ``chip_smoke.py`` spawns
them: one per card over NCCL with two cards or more, both on card 0 over
gloo with one. Each rank times, with a host clock around calls that end in
``torch.cuda.synchronize()`` (what the serving step pays, staging
included), the three collectives a tp step makes:

- ``all_reduce_partial`` of a decode step's row-parallel output, [8, 1,
  4096] bf16 (added in f32): 2 per layer, 64 a step, plus one for the
  embedding;
- ``all_gather_cat`` of the lm_head's local logits, [8, 1, 64128] f32, one
  a step;
- ``all_reduce_partial`` of a 1024-token admission's output, [1, 1024,
  4096] bf16, 64 per admission.

Prints one JSON line with the card's name and power limit, the transport,
each collective's mean ms over ``--reps`` calls after a warm-up, and the
collectives' share of a decode step (65 reduces + 1 gather). Exits
non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bee_code_interpreter_tpu_torch.parallel.mesh import (  # noqa: E402
    all_gather_cat,
    all_reduce_partial,
    make_mesh,
    spawn,
    tp_group,
)

SHAPES = {
    "decode_all_reduce": ((8, 1, 4096), torch.bfloat16, "reduce"),
    "logits_all_gather": ((8, 1, 64128), torch.float32, "gather"),
    "prefill_all_reduce": ((1, 1024, 4096), torch.bfloat16, "reduce"),
}


def rank_times(rank: int, reps: int) -> dict:
    group = tp_group(make_mesh({"tp": 2}, device_type="cuda"))
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for name, (shape, dtype, kind) in SHAPES.items():
        x = torch.randn(shape, device=dev).to(dtype)

        def call():
            if kind == "reduce":
                return all_reduce_partial(x.clone(), group)
            return all_gather_cat(x, group)

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            call()
            torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t) / reps * 1e3
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=50)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch-tp-collectives: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 2 else "gloo"
    ranks = spawn(rank_times, 2, device_type="cuda", backend=backend,
                  args=(args.reps,), timeout=600)
    ms = {name: max(r[name] for r in ranks) for name in SHAPES}
    print(json.dumps({
        "script": "torch-tp-collectives", "nvidia_smi": smi, "world": 2,
        "backend": backend, "cards": cards, "reps": args.reps,
        "ms": ms, "per_rank_ms": ranks,
        "decode_step_collectives_ms": 65 * ms["decode_all_reduce"]
        + ms["logits_all_gather"],
        "admission_1024_collectives_ms": 65 * ms["prefill_all_reduce"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
