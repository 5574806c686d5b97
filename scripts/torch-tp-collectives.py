#!/usr/bin/env python3
"""Time the tensor- and sequence-parallel exchanges of the port at
Llama-3-8B's serving shapes, two ranks.

    python3 scripts/torch-tp-collectives.py [--reps 50]

Two ranks are spawned (``parallel.spawn``) as ``chip_smoke.py`` spawns
them: one per card over NCCL with two cards or more, both on card 0 over
gloo with one. Each rank times, with a host clock around calls that end in
``torch.cuda.synchronize()`` (what the serving step pays, staging
included), the collectives a tp step makes:

- ``all_reduce_partial`` of a decode step's row-parallel output, [8, 1,
  4096] bf16 (added in f32): 2 per layer, 64 a step, plus one for the
  embedding;
- ``all_gather_cat`` of the lm_head's local logits, [8, 1, 64128] f32, one
  a step;
- ``all_reduce_partial`` of a 1024-token admission's output, [1, 1024,
  4096] bf16, 64 per admission;

and the exchanges of an sp=2 admission of an 8000-token prompt:

- ``ring_shift`` of one layer's K/V block, 2 x [1, 8, 4000, 128] bf16: one
  a layer on every rank (the ring's one hop);
- ``all_to_all_tiled`` of a Ulysses q block, [1, 32, 4096, 128] bf16 (k and
  v are a quarter of it; four a layer: q, k, v and the output back);
- ``all_gather_cat`` of the admission's K over sp, [32, 1, 8, 4000, 128]
  bf16 (the K/V gathered into the pool: two per admission);
- ``broadcast_from`` of the last prompt token's logits row, [1, 128256] f32
  (one per admission).

On gloo it also records whether gloo takes a CUDA tensor as it is in
``all_to_all_single`` and ``broadcast`` (the mesh helpers hand it CUDA
tensors there, and stage only point-to-point exchanges themselves).
Point-to-point is not probed: gloo's ``send`` hands the tensor's pointer
to its TCP transport as it is, and a device pointer there could take the
rank down with the group. Prints one JSON line with the card's name and power limit,
the transport, each exchange's mean ms over ``--reps`` calls after a
warm-up (the sp ones over ``--reps`` / 5), the collectives' share of a
decode step (65 reduces + 1 gather) and what gloo took. Exits non-zero
without CUDA.
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

import torch.distributed as dist  # noqa: E402

from bee_code_interpreter_tpu_torch.parallel.mesh import (  # noqa: E402
    all_gather_cat,
    all_reduce_partial,
    all_to_all_tiled,
    broadcast_from,
    make_mesh,
    ring_shift,
    spawn,
    tp_group,
)

SHAPES = {
    "decode_all_reduce": ((8, 1, 4096), torch.bfloat16, "reduce"),
    "logits_all_gather": ((8, 1, 64128), torch.float32, "gather"),
    "prefill_all_reduce": ((1, 1024, 4096), torch.bfloat16, "reduce"),
}
SP_SHAPES = {
    "ring_shift_kv": ((1, 8, 4000, 128), torch.bfloat16, "ring"),
    "ulysses_all_to_all_q": ((1, 32, 4096, 128), torch.bfloat16, "a2a"),
    "sp_gather_k": ((32, 1, 8, 4000, 128), torch.bfloat16, "gather"),
    "sp_broadcast_row": ((1, 128256), torch.float32, "broadcast"),
}


def gloo_takes(group, dev) -> dict:
    """Whether gloo takes a CUDA tensor as it is in an all-to-all and a
    broadcast: "accepted", or the error it raised."""
    x = torch.ones(4, device=dev)
    probes = {
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x, group=group),
        "broadcast": lambda: dist.broadcast(x.clone(), 0, group=group),
    }
    out = {}
    for name, probe in probes.items():
        try:
            probe()
            torch.cuda.synchronize()
            out[name] = "accepted"
        except Exception as e:  # noqa: BLE001 - the answer is the error
            out[name] = f"refused: {type(e).__name__}: {str(e)[:200]}"
        dist.barrier()
    return out


def rank_times(rank: int, reps: int) -> dict:
    group = tp_group(make_mesh({"tp": 2}, device_type="cuda"))
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for name, (shape, dtype, kind) in {**SHAPES, **SP_SHAPES}.items():
        x = torch.randn(shape, device=dev).to(dtype)
        n = reps if name in SHAPES else max(1, reps // 5)

        def call():
            if kind == "reduce":
                return all_reduce_partial(x.clone(), group)
            if kind == "ring":
                return ring_shift((x, x), group)
            if kind == "a2a":
                return all_to_all_tiled(x, group, 1, 2)
            if kind == "broadcast":
                return broadcast_from(x, 0, group)
            return all_gather_cat(x, group, dim=3 if x.dim() == 5 else -1)

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        for _ in range(n):
            call()
            torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t) / n * 1e3
    if dist.get_backend(group) == "gloo":
        out["gloo_takes_cuda_tensors"] = gloo_takes(group, dev)
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
    ms = {name: max(r[name] for r in ranks) for name in {**SHAPES,
                                                         **SP_SHAPES}}
    print(json.dumps({
        "script": "torch-tp-collectives", "nvidia_smi": smi, "world": 2,
        "backend": backend, "cards": cards, "reps": args.reps,
        "ms": ms, "per_rank_ms": [{k: v for k, v in r.items()
                                   if k != "gloo_takes_cuda_tensors"}
                                  for r in ranks],
        "decode_step_collectives_ms": 65 * ms["decode_all_reduce"]
        + ms["logits_all_gather"],
        "admission_1024_collectives_ms": 65 * ms["prefill_all_reduce"],
        # an sp=2 ring admission of 8000 tokens at 32 layers: 32 hops, the
        # K and V gathers, one row
        "sp_ring_admission_exchange_ms": 32 * ms["ring_shift_kv"]
        + 2 * ms["sp_gather_k"] + ms["sp_broadcast_row"],
        "gloo_takes_cuda_tensors": ranks[0].get("gloo_takes_cuda_tensors"),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
