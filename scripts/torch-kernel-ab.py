#!/usr/bin/env python3
"""Time the four kernels of one or two trees of the port at the main paths'
shapes, on one GPU: the flash forward (K1), dK/dV (K3), dQ (K4) and paged
decode (K2).

    python3 scripts/torch-kernel-ab.py                 # this checkout
    python3 scripts/torch-kernel-ab.py --root DIR      # the port package under DIR
    python3 scripts/torch-kernel-ab.py --ab PARENT     # PARENT, this, this, PARENT

One run builds the tree's kernels (nvcc, into the tree's ``ops/_build``),
checks each against its plain version (2e-2 absolute for the forward and
the paged decode, 1e-2 of max |grad| for dK/dV and dQ; two backward or
decode calls must give the same bits), times each with CUDA events around
single calls with the L2 cache flushed between them (and a device-side
sleep, so the host's launch path is not timed), times SDPA's forward and
whole backward on the same inputs, and prints one JSON line with the card's
name and power limit and the ptxas register and spill lines of the four
sources. ``--ab`` runs the trees in that order, one process each, and prints
a summary: the change's time over the parent's, each the mean of its two
runs. A variant of one constant (a split length, say) is timed by editing
a copy of the package and passing it as ``--root``. Without CUDA it exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
H, KVH, D = 32, 8, 128
# (B, L), causal: the longest serving prefill, the training path, a long batch
K1_CASES = [(1, 1024), (2, 1024), (4, 2048)]
K3_CASES = [(2, 1024), (2, 2048)]  # (B, L), causal: the training path, and twice its length
FWD_TOL, BWD_TOL = 2e-2, 1e-2
BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
# paged decode at nh=32, kvh=8, dh=128, ps=16, P=128 (the serving pool):
# name -> (lengths, dtype). chip_smoke's case (seed 2), the serving decode
# (prompts 64-1024 of seed 5, plus 32 new tokens), one long row, a wide
# batch of short rows, and chip_smoke's case in f32
_SMOKE_LENGTHS = np.random.default_rng(2).integers(1, 2049, size=8).tolist()
K2_CASES = {
    "smoke_b8": (_SMOKE_LENGTHS, "bfloat16"),
    "serving_b8": ([int(x) + 32 for x in
                    np.random.default_rng(5).integers(64, 1025, size=12)[:8]], "bfloat16"),
    "b1_2048": ([2048], "bfloat16"),
    "b32_short": ([64 + 7 * i for i in range(32)], "bfloat16"),
    "smoke_b8_f32": (_SMOKE_LENGTHS, "float32"),
}


def causal_pairs(L: int) -> int:
    return L * (L + 1) // 2


def one_tree(root: Path) -> dict:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("torch-kernel-ab: CUDA is not available")
    sys.path.insert(0, str(root))
    from bee_code_interpreter_tpu_torch.ops import flash_attention as fa
    from bee_code_interpreter_tpu_torch.ops import paged_attention as pa
    from bee_code_interpreter_tpu_torch.ops.cuda_build import build_all

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.perf_counter()
    kernels = [fa.FLASH_FWD, fa.FLASH_BWD_DKDV, fa.FLASH_BWD_DQ, pa.PAGED_DECODE]
    build_all(kernels)
    build_s = time.perf_counter() - t
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    warm = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16)
    for _ in range(100):  # ~0.2 s of tensor-core work: the clocks ramp up first
        warm @ warm
    del warm

    def timed(fn, reps=20, warmup=3) -> float:
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(400_000)  # the host enqueues fn while the card waits
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / reps

    gen = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)

    k1 = []
    for B, L in K1_CASES:
        q, k, v = randn(B, H, L, D), randn(B, KVH, L, D), randn(B, KVH, L, D)
        out, lse = fa.flash_attention_with_lse(q, k, v, True)
        ref_out, ref_lse = fa.flash_attention_fwd_plain(q.float(), k.float(), v.float(), True)
        err = max((out.float() - ref_out).abs().max().item(),
                  (lse - ref_lse).abs().max().item())
        del ref_out, ref_lse
        ms = timed(lambda: fa.flash_attention_with_lse(q, k, v, True))
        sdpa = timed(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                            enable_gqa=True))
        flops = 4.0 * B * H * causal_pairs(L) * D
        k1.append({"B": B, "L": L, "max_abs_err": err, "ok": err <= FWD_TOL, "ms": ms,
                   "sdpa_ms": sdpa, "tflops": flops / ms / 1e9,
                   "bound_ms": flops / BF16_FLOPS_PER_S * 1e3})
    k3, k4 = [], []
    for B, L in K3_CASES:
        q, k, v, do = randn(B, H, L, D), randn(B, KVH, L, D), randn(B, KVH, L, D), randn(B, H, L, D)
        out, lse = fa.flash_attention_with_lse(q, k, v, True)
        delta = (do.float() * out.float()).sum(dim=-1)
        args = (q, k, v, do, lse, delta, True, None, None)
        dk, dv = fa.flash_bwd_dkdv_cuda(*args)
        dk2, dv2 = fa.flash_bwd_dkdv_cuda(*args)
        want_dk, want_dv = fa.flash_bwd_dkdv_plain(q.float(), k.float(), v.float(),
                                                   do.float(), *args[4:])
        rel = max(((dk.float() - want_dk).abs().max() / want_dk.abs().max()).item(),
                  ((dv.float() - want_dv).abs().max() / want_dv.abs().max()).item())
        del want_dk, want_dv
        ms = timed(lambda: fa.flash_bwd_dkdv_cuda(*args))
        qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
        ref = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True, enable_gqa=True)
        sdpa = timed(lambda: torch.autograd.grad(ref, (qr, kr, vr), do, retain_graph=True))
        flops = 8.0 * B * H * causal_pairs(L) * D
        k3.append({"B": B, "L": L, "rel_err": rel, "ok": rel <= BWD_TOL,
                   "deterministic": bool(torch.equal(dk, dk2) and torch.equal(dv, dv2)),
                   "ms": ms, "sdpa_bwd_ms": sdpa, "tflops": flops / ms / 1e9,
                   "bound_ms": flops / BF16_FLOPS_PER_S * 1e3})
        dq = fa.flash_bwd_dq_cuda(*args)
        dq2 = fa.flash_bwd_dq_cuda(*args)
        want_dq = fa.flash_bwd_dq_plain(q.float(), k.float(), v.float(), do.float(),
                                        *args[4:])
        rel = ((dq.float() - want_dq).abs().max() / want_dq.abs().max()).item()
        del want_dq
        ms = timed(lambda: fa.flash_bwd_dq_cuda(*args))
        flops = 6.0 * B * H * causal_pairs(L) * D
        k4.append({"B": B, "L": L, "rel_err": rel, "ok": rel <= BWD_TOL,
                   "deterministic": bool(torch.equal(dq, dq2)),
                   "ms": ms, "sdpa_bwd_ms": sdpa, "tflops": flops / ms / 1e9,
                   "bound_ms": flops / BF16_FLOPS_PER_S * 1e3})
        del ref, qr, kr, vr
    k2 = [paged_case(torch, pa, timed, dev, gen, name, *case)
          for name, case in K2_CASES.items()]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    ptxas = [line.strip() for kern in kernels
             for line in kern.build_log().splitlines()
             if any(w in line for w in ("entry function", "registers", "spill",
                                        "warning", "error"))]
    return {"root": str(root), "card": smi, "build_s": build_s, "ptxas": ptxas,
            "k1": k1, "k3": k3, "k4": k4, "k2": k2,
            "ok": all(r["ok"] for r in k1 + k3 + k4 + k2)
            and all(r["deterministic"] for r in k3 + k4 + k2)}


def paged_case(torch, pa, timed, dev, gen, name, lengths, dtype) -> dict:
    """K2 on one case: error against the f32 plain version, two calls' bits,
    time, the byte bound and, on a tree that has it, the split choice."""
    B, nh, kvh, dh, ps, P = len(lengths), 32, 8, 128, 16, 128
    n_pages = 1 + B * P
    rng = np.random.default_rng(3)
    table = (1 + rng.permutation(B * P)).reshape(B, P).astype(np.int32)
    for b in range(B):  # -1 sentinels past each row's pages
        table[b, -(-int(lengths[b]) // ps):] = -1
    dt = getattr(torch, dtype)
    q = torch.randn(B, nh, dh, generator=gen, device=dev).to(dt)
    kp = torch.randn(n_pages, kvh, ps, dh, generator=gen, device=dev).to(dt)
    vp = torch.randn(n_pages, kvh, ps, dh, generator=gen, device=dev).to(dt)
    bt = torch.as_tensor(table, device=dev)
    lens = torch.as_tensor(np.asarray(lengths, dtype=np.int32), device=dev)
    out = pa.paged_decode_attention(q, kp, vp, bt, lens)
    out2 = pa.paged_decode_attention(q, kp, vp, bt, lens)
    ref = pa.paged_decode_attention_plain(q.float(), kp.float(), vp.float(), bt, lens)
    err = (out.float() - ref).abs().max().item()
    ms = timed(lambda: pa.paged_decode_attention(q, kp, vp, bt, lens), reps=50)
    visible = int(np.minimum(lengths, P * ps).sum())
    nbytes = (2.0 * kvh * visible * dh * kp.element_size()
              + 2 * q.numel() * q.element_size() + 4 * (bt.numel() + lens.numel()))
    row = {"case": name, "B": B, "dtype": dtype, "max_len": max(lengths),
           "max_abs_err": err, "ok": err <= FWD_TOL,
           "deterministic": bool(torch.equal(out, out2)), "ms": ms,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "gb_per_s": nbytes / ms / 1e6}
    if hasattr(pa, "split_pages"):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        pps = pa.split_pages(B, kvh, P, ps, sms)
        row["pages_per_split"], row["splits"] = pps, -(-P // pps)
    return row


def ab(parent: Path) -> int:
    order = [("parent", parent), ("change", HERE), ("change", HERE), ("parent", parent)]
    runs = []
    for label, root in order:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--root", str(root)], capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-2000:])
        if proc.returncode:
            print(json.dumps({"run": label, "rc": proc.returncode}), flush=True)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["run"] = label
        runs.append(res)
        print(json.dumps(res), flush=True)

    def mean(label, kernel, i, key="ms"):
        vals = [r[kernel][i][key] for r in runs if r["run"] == label]
        return sum(vals) / len(vals)

    summary = {}
    labels = {"k1": [f"B={B} L={L}" for B, L in K1_CASES],
              "k3": [f"B={B} L={L}" for B, L in K3_CASES],
              "k4": [f"B={B} L={L}" for B, L in K3_CASES],
              "k2": list(K2_CASES)}
    for kernel, names in labels.items():
        for i, name in enumerate(names):
            p, c = mean("parent", kernel, i), mean("change", kernel, i)
            summary[f"{kernel} {name}"] = {"parent_ms": p, "change_ms": c,
                                           "change_over_parent": c / p}
    print(json.dumps({"ab": summary, "card": runs[0]["card"]}), flush=True)
    return 0 if all(r["ok"] for r in runs if r["run"] == "change") else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--ab", type=Path, metavar="PARENT")
    args = ap.parse_args()
    if args.ab is not None:
        return ab(args.ab.resolve())
    res = one_tree(args.root.resolve())
    print(json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
