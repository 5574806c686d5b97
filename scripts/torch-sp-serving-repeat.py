"""Repeat ``chip_smoke.py``'s serving_sp ring run, each time in fresh ranks.

Llama-3-8B at all 32 layers (seed-0 weights), mesh sp=2 on two ranks (one
per card over NCCL with two cards or more, else both on card 0 over gloo),
serving_sp's 4 prompts of 4096-8000 tokens, 32 new tokens each; run
``--repeats`` times, each in a spawn of its own under ``--timeout``
seconds. With ``--second-copy`` each rank also keeps the weights it built
its batcher from (36.4 GB a rank, where serving_sp keeps 20.4). A run that
passes its deadline fails its spawn, whose error carries each rank's
stacks. One JSON line per run: seconds, and per rank live and peak GB,
TTFT, K1 launches and the first tokens; or the error.

    python3 scripts/torch-sp-serving-repeat.py [--repeats 3] [--timeout 300]
        [--second-copy]
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as C  # noqa: E402


def ring_rank(rank: int, second_copy: bool) -> dict:
    mesh, dev = C.sp_rank_setup({"sp": C.SP})
    held = {}

    def make():
        params, cfg = C.llama_cut(dev, 32)
        if second_copy:
            held["params"] = params
        return C.ContinuousBatcher(params, cfg, mesh=mesh, **C.SP_GEOMETRY)

    batcher = C.build_in_turns(rank, C.SP, make)
    live = torch.cuda.memory_allocated(dev)
    run = C.run_batcher(batcher, C.sp_requests(batcher.config.vocab_size))
    return {"rank": rank, "live_gb": live / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "ttft_s": run["ttft_s"][0], "k1_launches": run["k1_launches"],
            "first_tokens": [t[:4] for t in run["tokens"]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--second-copy", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch-sp-serving-repeat: CUDA is not available", file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda")
    C.build_all([C.fa.FLASH_FWD, C.pa.PAGED_DECODE])
    how = C.transport()
    head = {"script": "torch-sp-serving-repeat", "nvidia_smi": C.nvidia_smi(),
            "backend": how["backend"], "cards": how["cards"],
            "second_copy": args.second_copy}
    failed = 0
    for i in range(args.repeats):
        t = time.perf_counter()
        rec = {**head, "repeat": i}
        try:
            rec["ranks"] = C.spawn(ring_rank, C.SP, device_type="cuda",
                                   backend=how["backend"],
                                   args=(args.second_copy,),
                                   timeout=args.timeout)
        except RuntimeError as e:
            rec["error"] = str(e)[:6000]
            failed += 1
        rec["seconds"] = time.perf_counter() - t
        print(json.dumps(rec), flush=True)
        gc.collect()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
