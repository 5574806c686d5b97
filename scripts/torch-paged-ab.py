#!/usr/bin/env python3
"""Time K2's two CUDA-core paths on the same inputs, on one GPU: the
dh-128 kernel of ``bci_paged_decode`` (f32 pools, or pages not a multiple
of 8 slots) against ``bci_paged_decode_any`` (the kernel for every head dim
and group size), alternating dh-128, any, any, dh-128.

    python3 scripts/torch-paged-ab.py

The wrapper picks one path by head dim and group (``kernel_entry``); this
script launches both C entries directly, at main_path's decode lengths
(B=8, 32 heads over 8 KV heads, dh 128, P=128), holds each against the plain
version, times each with CUDA events with the L2 cache flushed between calls
(``chip_smoke.Timer``), and prints one JSON line a case and the card's name
and power limit. Without CUDA it exits non-zero.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from bee_code_interpreter_tpu_torch.ops import paged_attention as pa  # noqa: E402
from bee_code_interpreter_tpu_torch.ops.cuda_build import build_all  # noqa: E402

ENTRIES = ("bci_paged_decode", "bci_paged_decode_any")
# name -> (dtype, page size, query heads, KV heads)
CASES = {
    "f32_ps16": (torch.float32, 16, 32, 8),
    "bf16_ps12": (torch.bfloat16, 12, 32, 8),
    "f32_ps16_rep1": (torch.float32, 16, 8, 8),
}


def launch(entry, q, kp, vp, bt, lens):
    """One call of C entry ``entry``, split as the wrapper splits it."""
    B, nh, dh = q.shape
    n_pages, kvh, ps, _ = kp.shape
    P, rep = bt.shape[1], nh // kvh
    pps = pa.entry_split(entry, B, nh, kvh, P, ps, pa._sm_count(q.device))
    n_split = -(-P // pps)
    out = torch.empty_like(q)
    n_part = B * kvh * n_split * rep if n_split > 1 else 0
    scratch = torch.empty(n_part * (dh + 2), dtype=torch.float32, device=q.device)
    acc, m, l = scratch.split([n_part * dh, n_part, n_part])
    pa.PAGED_DECODE.launch(
        entry, q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
        lens.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
        acc.data_ptr(), B, nh, kvh, n_pages, ps, P, pps,
        *(() if entry == ENTRIES[0] else (dh,)), float(dh ** -0.5),
        int(q.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch-paged-ab: CUDA is not available", file=sys.stderr)
        return 2
    build_all([pa.PAGED_DECODE])
    dev = torch.device("cuda")
    timer = cs.Timer(dev)
    lengths = np.asarray(cs.K2_CASES[cs.K2_MAIN_CASE][0], dtype=np.int32)
    B, dh = len(lengths), 128
    for name, (dtype, ps, nh, kvh) in CASES.items():
        P = -(-int(lengths.max()) // ps)
        gen = torch.Generator(device=dev).manual_seed(3)
        q = torch.randn(B, nh, dh, generator=gen, device=dev).to(dtype)
        kp = torch.randn(1 + B * P, kvh, ps, dh, generator=gen, device=dev).to(dtype)
        vp = torch.randn(1 + B * P, kvh, ps, dh, generator=gen, device=dev).to(dtype)
        table = 1 + np.random.default_rng(2).permutation(B * P).reshape(B, P)
        bt = torch.as_tensor(table.astype(np.int32), device=dev)
        lens = torch.as_tensor(lengths, device=dev)
        ref = pa.paged_decode_attention_plain(q.float(), kp.float(), vp.float(),
                                              bt, lens)
        err = {e: (launch(e, q, kp, vp, bt, lens).float() - ref).abs().max().item()
               for e in ENTRIES}
        cs.check(max(err.values()) <= cs.KERNEL_TOL, f"{name}: errors {err}")
        order = (ENTRIES[0], ENTRIES[1], ENTRIES[1], ENTRIES[0])
        ms = [(e, timer(lambda: launch(e, q, kp, vp, bt, lens), 50)) for e in order]
        print(json.dumps({"case": name, "max_abs_err": err, "ms_in_order": ms}),
              flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
