#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time, on one GPU.

    python3 scripts/torch-train-profile.py [--model llama|vit|resnet]
        [--layers 8] [--steps 3]

``--model llama`` (the default) trains Llama-3-8B widths cut to
``--layers`` (f32 masters from a seed, bf16 compute,
``Transformer.make_train_step`` with its default AdamW) on one fixed batch
of 2 x 1024 tokens; ``--model vit`` trains ViT-B/16 whole (``ViT``, AdamW)
on 128 seeded noise images of 224², ``--model resnet`` ResNet-50 whole
(``ResNet``, SGD with momentum) on 64. Then it profiles ``--steps`` steps
with ``torch.profiler``. Prints one JSON line: wall time per step, device
busy time per step (the union of the kernels' and copies' ranges), the
device idle share (1 - busy / wall), the device time per step by group
(the three flash kernels, convolutions, GEMMs, the optimizer's
multi-tensor kernels, reductions, casts and copies, the rest) and by
kernel name (top 15), next to the nvidia-smi name and power limit. Needs
CUDA; exits non-zero without it.
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

from bee_code_interpreter_tpu_torch.models.transformer import (  # noqa: E402
    Transformer,
    TransformerConfig,
)
from bee_code_interpreter_tpu_torch.models.vision import (  # noqa: E402
    ResNet,
    ResNetConfig,
)
from bee_code_interpreter_tpu_torch.models.vit import ViT, ViTConfig  # noqa: E402

# kernel-name substrings -> group, first match wins
GROUPS = (
    ("flash_fwd (K1)", ("flash_fwd_kernel",)),
    ("flash_bwd_dkdv (K3)", ("flash_bwd_dkdv_kernel",)),
    ("flash_bwd_dq (K4)", ("flash_bwd_dq_kernel",)),
    ("optimizer (multi-tensor)", ("multi_tensor_apply",)),
    ("conv (cuDNN)", ("fprop", "dgrad", "wgrad", "conv")),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    ("reductions", ("reduce_kernel",)),
    ("casts and copies", ("copy_kernel", "bfloat16_copy", "Memcpy")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(key in name for key in keys):
            return group
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("llama", "vit", "resnet"),
                    default="llama")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch-train-profile: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(10)
    if args.model == "llama":
        cfg = dataclasses.replace(TransformerConfig.llama3_8b(),
                                  n_layers=args.layers)
        model = Transformer(cfg)
        seq = torch.as_tensor(
            np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 1025)),
            device="cuda",
        )
        batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
        per_step = {"tokens_per_step": 2 * 1024, "layers": args.layers}
    else:
        model, B = ((ViT(ViTConfig.vit_b16()), 128) if args.model == "vit"
                    else (ResNet(ResNetConfig.resnet50()), 64))
        batch = {"images": torch.randn(B, 224, 224, 3, generator=gen,
                                       device="cuda"),
                 "labels": torch.randint(0, 1000, (B,), generator=gen,
                                         device="cuda")}
        per_step = {"images_per_step": B}
    params = model.init(gen)
    step = model.make_train_step()
    opt_state = None
    for _ in range(2):  # warm up; the first step allocates the AdamW state
        params, opt_state, loss = step(params, opt_state, batch)
    torch.cuda.synchronize()
    # wall time without the profiler (it slows the host), then the trace
    t0 = time.perf_counter()
    for _ in range(args.steps):
        params, opt_state, loss = step(params, opt_state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            params, opt_state, loss = step(params, opt_state, batch)
        torch.cuda.synchronize()
    # kernels and copies on the device; the optimizer's record_function
    # range is mirrored onto the device timeline as a user annotation that
    # spans its kernels, so it is left out
    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)
                     and not e.name.startswith("Optimizer.")]
    per_kernel: dict[str, float] = {}
    per_group: dict[str, float] = {}
    for evt in device_events:
        us = evt.time_range.elapsed_us()
        name = evt.name[:80]  # templated kernels share a long prefix
        per_kernel[name] = per_kernel.get(name, 0.0) + us
        group = group_of(evt.name)
        per_group[group] = per_group.get(group, 0.0) + us
    # busy time is the union of the events' ranges (streams may overlap)
    busy_us, reach = 0.0, float("-inf")
    for evt in sorted(device_events, key=lambda e: e.time_range.start):
        start, end = evt.time_range.start, evt.time_range.end
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    device_ms = busy_us / args.steps / 1e3
    wall_ms = wall / args.steps * 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps({
        "nvidia_smi": smi, "model": args.model, **per_step,
        "steps": args.steps, "loss": loss.item(),
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms if wall_ms else None,
        "groups_ms_per_step": {g: us / args.steps / 1e3 for g, us in
                               sorted(per_group.items(), key=lambda kv: -kv[1])},
        "kernels_ms_per_step": {name: us / args.steps / 1e3
                                for name, us in top},
        "device_events_per_step": len(device_events) / args.steps,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
