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
   limit of its dtype; two K2 calls must give the same bits. Then K1 and
   K2 again at a tp=2 rank's heads (H=16, KVH=4: the main and serving
   cases), the shapes ``serving_tp`` runs; then K1 at the sequence-parallel
   shapes (``flash_fwd_sp``: a ring rank's own block, L=4096 causal, an
   earlier hop, 4096 x 4096 non-causal, a windowed own block, window 1024,
   and a Ulysses rank's H=16, KVH=4 over L=8192), out and lse both held.
4. serving reference: the decoder cut to 2 layers at Llama-3-8B widths,
   prefill + paged decode teacher-forced, bf16 kernels on the card against
   the f32 plain path on the CPU on the same weights.
5. serving path: Llama-3-8B (full width and depth, random weights from a
   seed) served by Engine -> ContinuousBatcher: 12 requests with prompts of
   64-1024 tokens on 8 rows, 32 new tokens each, greedy and seeded sampled;
   the launch counts of K1 and K2 must match the admissions and decode
   steps; a second identical run must give identical tokens.
6. serving observability, on the same weights: ``serving_bench``
   (``run_serving_bench`` of the port: 8 requests of 128-130 tokens, 64 new
   tokens each, greedy, 8 rows, pages of 16, a warm-up pass per arm then 3
   alternating rounds of the instrumented arm (registry, ServingMonitor,
   DeviceMonitor) against the bare one: the arms token-identical, K1 once
   per layer and admission and K2 once per layer and decode step over every
   pass, the memory row from ``torch.cuda.memory_stats`` with live bytes at
   least the weights and one pool and the limit ``mem_get_info``'s total;
   prints the bench's dict, the step histogram's count, the first calls by
   trigger with their times and the HBM gauges; ``overhead_ok`` printed, not
   enforced) and ``serving_profile`` (a ``ServingProfiler`` over a monitored
   engine in main_path's geometry: 4 decode steps at 8 rows captured with
   CUDA activity; the Chrome trace must hold K2's split and merge kernels
   once per layer and captured step).
7. admission and KV caches, on the same weights, each with its own launch
   counts: ``admission_prefix`` (8 requests sharing a 512-token system
   prompt, prefix cache on: 7 hits reusing 224 pages, K1 only for the miss,
   consistent page totals, each hit's first-token logits against a one-shot
   admission); ``admission_chunked`` (4 prompts of 1024 tokens with
   ``prefill_chunk=256``: no K1, logits against a one-shot admission, two
   runs identical); ``admission_interleaved`` (5 rows decoding while prompts
   of 1024 tokens admit in windows of 128; one of them preempted after two
   windows and finished later: no decoding row misses a step, the
   preemption returns every page); ``serving_int8`` (phase 5's traffic on
   an int8 pool: K2 never launched, the pool 0.516x the bf16 one);
   ``contiguous_decode`` (``Transformer.generate_cached`` at B=2, L=512,
   one-shot, chunked and int8, each step's logits against one
   teacher-forced forward; K1 only for the one-shot prefills; on the first
   ``BREADTH_CUT_LAYERS`` = 8 layers, as are ``serving_speculative`` and
   ``serving_snapshot`` below, to keep the run's time).
   Then the model breadth of serving, on the same weights:
   ``serving_weight_int8`` (phase 5's traffic on ``quantize_weights``: K1
   and K2 as in phase 5, the tree's bytes from its shapes, first-token
   logits against the bf16 model's, two runs identical);
   ``serving_lora`` (8 requests over 4 rank-16 adapters and the base
   model: K1 only for the base rows, K2 every step, adapter rows against
   a forward on ``merge_lora``, two runs identical);
   ``serving_speculative`` (gamma 4: the target as its own draft, a draft
   with Llama-3.2-3B's shapes, and two seeded sampled requests twice; each
   greedy commit is the argmax of its verify logits; K1 for target and
   draft at each admission, K2 only for draft steps);
   ``serving_snapshot`` (phase 5's traffic, a pickled snapshot after 8
   steps resumed on a fresh engine: tokens and logprobs bitwise, the pool's
   storage kept); ``beam_search`` (B=1, L=256, beam 4, 16 tokens; beam 1
   equals ``generate_cached``) and ``speculative_generate`` (the same
   prompt, gamma 4, 32 tokens).
8. Mixture-of-Experts serving, the Llama weights freed first, at
   ``TransformerConfig.mixtral_8x7b()`` widths (vocab 32000, d 4096, 32/8
   heads, d_ff 14336, 8 experts, top-2; random weights from a seed):
   ``moe_reference`` (2 layers, bf16 on the card against the f32 plain path
   on the CPU: teacher-forced logits at the positions whose routing agreed,
   the routing agreement, the aux loss); ``serving_moe`` (cut to 16 of 32
   layers: the whole model, 93.4 GB in bf16, does not fit one card; phase
   5's traffic and batcher with capacity routing at factor 1.25, groups of
   1024: K1 once per layer and admission, K2 once per layer and decode
   step, against the 14.0 ms weight bound); ``serving_moe_exact`` (the same
   weights under dropless per-token routing: 4 greedy requests batched and
   each alone, token agreement reported; a shared-prefix pair with a prefix
   hit; a probe of one prompt alone and beside another, which tells a
   routing change from a GEMM's reduction order).
   Then tensor-parallel and replicated serving, no other weights resident,
   at ``llama3_8b()`` widths with the seed-0 weights of phase 5. The
   transport is printed (``world``, ``backend``, ``cards``): with two cards
   or more, tp=2 runs one rank per card over NCCL and the replicas on
   cards 0 and 1; with one card, both ranks on card 0 over gloo (CUDA
   tensors staged through host memory) and both replicas on card 0. The
   ranks are spawned processes (``parallel.spawn``) that load the kernels
   this process built and report their own launch counts; a rank that fails
   fails the run. ``tp_reference`` (2 layers, tp=2: each rank's shard shapes
   those of ``param_specs``, its prefill logits and 4 teacher-forced paged
   decode steps against the unsharded bf16 path and the f32 CPU path, ranks
   bitwise equal, K1/K2 counts per rank); ``serving_tp`` (32 layers, tp=2,
   phase 5's 12 requests and geometry, the ranks building their batchers in
   turn: per rank K1 = 32 x admissions and K2 = 32 x decode steps at the
   rank-local heads, every rank's streams and first-token logits identical,
   two runs identical, first-token logits within PATH_LOGIT_TOL of phase
   5's; tokens/s, decode step p50, TTFT p50, each rank's live, weight and
   pool bytes, the greedy agreement with phase 5); ``serving_replicated``
   (``ReplicatedEngine.build(n_replicas=2)`` over phase 5's traffic: every
   stream equal to phase 5's, K1/K2 over both replicas, the split of the
   requests). Then, on the same transport, sequence-parallel serving and
   the tensor-parallel breadth, each held against the single-device
   batcher on the same weights and traffic, run here before its ranks
   spawn and freed before they do: ``sp_attention`` (sp=2,
   ``ring_attention_sharded`` and ``ulysses_attention_sharded`` on one
   layer's [1, 32, 8192, 128] q, K/V at 8 heads, against single-device
   flash_attention, the ring within SP_ATTN_ROW_TOL per row and Ulysses
   bitwise; each timed, with its K1 and exchange time apart);
   ``serving_sp`` (Llama-3-8B, all 32 layers, mesh
   sp=2, ring: 4 prompts of 4096-8000 tokens, 32 new tokens each, half
   greedy; per rank K1 = 32 x (rank + 1) x admissions, K2 = 32 x decode
   steps; TTFT of each admission, decode step p50, live GB per rank, the
   exchanges' ms per admission, ranks bitwise equal, first-token logits
   within PATH_LOGIT_TOL of the single-device run's);
   ``serving_sp_ulysses`` and ``serving_sp_tp`` (the same traffic on the
   first BREADTH_CUT_LAYERS, Ulysses at sp=2 and the ring at sp=2 x tp=2 on
   four ranks); ``serving_lora_tp`` (``serving_lora``'s adapters and
   traffic at tp=2 on the cut, each row against a single-device forward on
   the merged params); ``serving_moe_tp`` and ``serving_moe_ep``
   (``main_path``'s traffic on Mixtral widths cut to BREADTH_CUT_LAYERS,
   tp=2 and ep=2), each with ``moe_block_mesh``: one MoE block
   (``_mlp_block``) on a decode step's 8 tokens (every-expert form) and on
   a 1024-token prompt (routed form, capacity drops included) against one
   card on the same input and weights, within MOE_BLOCK_ROW_TOL per token
   under tp and bitwise under ep. ep's streams and first-token logits must
   equal one card's; under tp at most MOE_TP_FIRST_OVER_MAX requests may
   lie beyond PATH_LOGIT_TOL, since capacity routing turns a bf16 near-tie
   into moved slots and dropped tokens. K1 at the shapes these paths
   launch is checked in 3 (``flash_fwd_sp``). Then ``serving_replicated_tp``:
   ``ReplicatedEngine.build(meshes=...)`` as 2 replicas x tp=2 on four
   ranks (one a card over NCCL with four cards; all on card 0 over gloo
   with one), main_path's traffic on its weights cut to BREADTH_CUT_LAYERS
   through rank 0's front end while the other ranks follow: each request's
   first-token logits within PATH_LOGIT_TOL of the single-device batcher's
   on the same cut (their argmax and the greedy agreement printed), each
   rank's K1 = 8 x its replica's admissions and K2 = 8 x its decode steps,
   the ranks of a replica bitwise equal, and ``replica_of`` printed beside
   an in-process pair of single-device replicas'; tokens/s, TTFT p50,
   decode step p50, live GB a rank and the front end's exchange ms a round.
9. training kernels (K3 dK/dV, K4 dQ), as in 3, on K1's own out/lse, with
   SDPA's backward as the library call; two K3 calls and two K4 calls on the
   same inputs must give the same bits; again at a tp=2 rank's heads (H=16,
   KVH=4, B=2, L=1024: ``flash_bwd_rank_local``, train_tp's shape), and at
   the sp backward's per-hop shapes (``flash_bwd_sp``: a ring rank's own
   block, L=4096 causal, and an earlier hop, 4096 x 4096 non-causal, at
   H=32 KVH=8; a Ulysses rank's H=16 KVH=4 over L=8192). Then
   ``flash_d64``: K1, and K3/K4 on K1's own out and lse, at head dim 64
   (their D = 64 instances) on ``D64_CASES``: ViT-B/16's attention (B=128,
   H=KVH=12, L=196, non-causal), a ragged causal case (1, 1000) and a GQA
   case (300 x 700, non-causal), each held as above, timed beside its
   bound, its plain version and SDPA, with every instance's registers and
   spills from ptxas. Then the head dims and dtypes JAX's kernels take
   beyond those: ``flash_head_dims`` (K1, K3, K4 in bf16 at D = 16, 32,
   72, 80, 96 (read in place by the D = 64 / 128 instances), 20 (zero-padded
   to 64, the pad's time reported), 200 and 256 (the mma.sync instance,
   Gemma-2B's 8 heads over 1 KV head), and in f32 at D = 16, 64, 128 (the
   CUDA-core kernels); a causal L = 1024 case and a ragged non-causal one each; bf16
   within KERNEL_TOL / K1_ROW_TOL / BWD_TOL, f32 within F32_KERNEL_TOL of
   the largest output), ``paged_head_dims`` (K2 at dh 16, 80, 256 with 1,
   8, 16, 48 query heads per KV head, bf16 and f32), ``tiny_card``
   (``TransformerConfig.tiny()``, head dim 16, served through
   ContinuousBatcher -> Engine and one train step, in f32 and in bf16 on
   the same host-drawn weights: the f32 greedy tokens equal the CPU's, the
   f32 loss within F32_KERNEL_TOL of the CPU's, every kernel launched once
   per layer) and ``wide_head`` (Gemma-2B's published widths, GEMMA_2B,
   18 layers, 3.03 B parameters in bf16: main_path's 12 requests, tokens/s,
   TTFT and decode-step p50 against the 1.81 ms weight bound, first-token
   logits within PATH_LOGIT_TOL of a forward through K1's plain version;
   then one train step of its first BREADTH_CUT_LAYERS layers, K1/K3/K4 once
   per layer).
10. training reference: one training step of the decoder cut to 2 layers at
   Llama-3-8B widths (B=1, L=128, f32 masters), bf16 compute with K1/K3/K4
   on the card against the f32 plain path on the CPU: loss and every leaf's
   gradient; then ``lora_train``, two ``make_lora_train_step`` steps of a
   rank-16 adapter on the same cut: loss and the factors' gradients against
   the CPU's from the same factors, the base unchanged bit for bit.
11. training path: ``Transformer.make_train_step`` on Llama-3-8B widths cut
   to 8 layers (f32 masters and AdamW state do not fit one card at 32), one
   fixed batch of 2 x 1024 tokens, 4 steps: falling loss, a finite non-zero
   gradient on every leaf after step 1, K1/K3/K4 each launched once per
   layer and step. Then ``train_moe``: the same at Mixtral widths cut to 2
   layers (3.16 B parameters, 50.6 GB of masters, gradients and moments),
   loss and aux per step, after a 1-layer L=128 check of the first step's
   loss, aux and router gradient norm against the f32 CPU path. Between
   them, training under a mesh on two ranks (the transport of the tp
   phases): ``train_tp_rounding_control`` (train_path's run on one card
   with tp=2's roundings: each row-parallel product as two bf16 partials
   added in f32, each column-parallel one as two column blocks), ``train_tp``
   (train_path at tp=2: 8 layers, the same seed-10 masters and batch, 4
   steps), ``train_mesh`` (one step each at dp=2 and fsdp=2, Llama-3-8B
   widths cut to 2 layers, and ep=2, Mixtral widths cut to 2 layers) and
   ``train_tp_kv`` (Gemma-2B's widths cut to 2 layers at tp=2 over its one
   KV head, each rank a copy: 4 steps, each loss within TRAIN_TP_KV_LOSS_TOL
   of one card's 4 steps, as is its own rounding control's,
   ``train_tp_kv_rounding_control``, run before the spawn). In
   each, the ranks first take turns computing one card's loss and gradient
   on the whole batch from the same masters; the mesh run's first loss is
   held within TRAIN_LOSS_TOL of it and each leaf's first gradient (after
   the batch-axis sums) within TRAIN_GRAD_TOL on the rank's block; after
   the last step every leaf a mesh axis replicates hashes alike on every
   rank; K1/K3/K4 once per layer and step on each rank. train_tp's losses
   and the control's within TRAIN_TP_LOSS_TOL of train_path's at each of
   the 4 steps (AdamW turns tp's rounding into a drift the control shows
   on one card). Step ms,
   tokens/s, the collectives' ms a step and the peak GB a rank. Then, in
   the same spawn: ``sp_attention_grad`` (sp=2 on SP_ATTN_SHAPE: the ring
   causal, the ring with a 1024 window and Ulysses, forward and backward
   on each rank's block, dq/dk/dv within BWD_TOL of one card's
   ``FlashAttention`` backward on the whole sequence; K3/K4 per rank r: r +
   1 under the causal ring, 1 with the window (the earlier hop a boundary
   block), 1 under Ulysses; the backward's ms and its exchanges' ms);
   ``train_sp`` (Llama-3-8B widths cut to 2 layers, one row of 8192
   tokens, sp=2, the ring then Ulysses, 2 AdamW steps each against one
   card's 2 steps on the same masters and batch: every loss within
   TRAIN_LOSS_TOL, first gradients within TRAIN_GRAD_TOL, the replicas
   bitwise, K1/K3/K4 = layers x steps x hops per rank); ``train_pp`` (pp=2
   through ``forward_pipelined`` and the loss, the 4-layer cut, 2 layers a
   rank, 4 x 1024 tokens in 4 microbatches, 2 steps against one card's
   4-layer steps; each rank holds only its layers plus the embedding and
   head; K1/K3/K4 = 2 x 4 x 2 per rank; the schedule's bubble share and the
   stage-to-stage exchanges' ms a step). Then, in the same spawn:
   ``vision_mesh`` (ViT-B/16 at B=32, one AdamW step each at dp=2, tp=2
   and sp=2 by the ring; ResNet-50 one SGD step at dp=2, in f32 (bf16's
   batch-dependent rounding moves some of its random-init gradients by a
   relative 0.3); the MNIST MLP 30
   steps at dp=2; each first loss within TRAIN_LOSS_TOL and each leaf's
   first gradient within TRAIN_GRAD_TOL of one card's on the same masters
   and batch; the ViT's K1/K3/K4 12 per rank, 24 under the ring),
   ``generate_dp`` (Llama-3-8B, all 32 layers, bf16, greedy
   ``generate_cached`` of 4 prompts of 128 tokens, 16 new, at dp=2: the
   ranks' tokens alike and each rank's rows bitwise one card's run of
   them; K1 once per layer; the agreement with one card's whole-batch run
   reported), ``generate_fsdp`` (its first 2 layers at fsdp=2, 4 new
   tokens, the same checks) and ``checkpoint_pp`` (the f32 masters of 2
   layers under pp=2 saved sharded, restored onto pp=2 and whole onto no
   mesh, bitwise).
12. ``hf_load``: an HF-named Llama state dict (Llama-3-8B widths, 2 layers)
   built on the card from ``init_params``, loaded by ``load_llama_params``:
   every leaf and the logits bitwise equal to the source's.
13. the vision family on one card: ``vit_reference`` (ViT-B/16
   widths cut to 2 layers, B=8: logits, loss and every first gradient,
   bf16 through K1/K3/K4 at head dim 64 on the card against the f32 plain
   path on the CPU), ``vit`` (ViT-B/16 whole, 224², B=128: ``apply`` with
   K1 12 times, then 4 AdamW steps on one fixed batch of seeded noise
   images with K1, K3 and K4 12 times a step; the losses fall; images/s,
   step ms p50, model TFLOP/s, peak GB), ``resnet_reference`` (ResNet-50's
   first stage, B=2: bf16 logits and loss, and f32 gradients, against the
   CPU) and ``resnet`` (ResNet-50
   whole, B=64, 4 SGD steps at lr 0.01 (JAX's default 0.1 diverges here),
   no kernel of the port: cuDNN's convs).
14. the top-level entry points and the sandbox runtime: ``entry`` (the port's
   ``entry()`` on the card: 8 layers at d_model 1024, 16 heads over 8 KV
   heads, bf16, tokens [2, 512]; one warm-up call, then the p50 of 5; the
   logits [2, 512, 32000] and finite, K1 once per layer and call, and K1
   held against its plain version at this shape, B=2 H=16 KVH=8 L=512
   D=64 causal), ``entry_reference`` (its weights cut to 2 layers on
   seeded tokens, bf16 on the card against the f32 plain path on the CPU,
   within REFERENCE_TOL), ``reroute`` (five sandbox interpreters started
   as the service starts them, PYTHONPATH the port's shim directory alone:
   a cold one runs the shim test's payload as its first touch, a
   CudaArray on cuda, a small product stays ndarray;
   ``examples/benchmark-numpy.py`` unchanged gives kind=CudaArray, and
   kind=ndarray with BCI_XLA_REROUTE=0, both self-timed; a warm one
   imports ``bci_cuda_warm`` first, times the same first touch, then holds
   f32 4096 x 4096 and f64 2048 x 2048 products within rtol 1e-4 / 1e-10
   of host numpy, host and rerouted times; torch code lands on cuda
   through the shim, and BCI_PROFILE_DIR leaves a Chrome trace with CUDA
   kernel events; a payload that falls back to host numpy fails the run)
   and ``dryrun_multichip`` (``python3 -m
   bee_code_interpreter_tpu_torch.entry 8``: eight gloo ranks on the CPU,
   as JAX's dry run runs on virtual CPU devices; every validation line
   present).

The last lines are the ``kernels`` JSON line (with each serving kernel's
launches by phase), the nvidia-smi line, and ``{"ok": true, "device":
{...}}``. Without CUDA it exits non-zero and prints
no result.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))

from bee_code_interpreter_tpu_torch import entry as port_entry  # noqa: E402
from bee_code_interpreter_tpu_torch.models import moe  # noqa: E402
from bee_code_interpreter_tpu_torch.models import transformer  # noqa: E402
from bee_code_interpreter_tpu_torch.models import vision, vit  # noqa: E402
from bee_code_interpreter_tpu_torch.models.beam import beam_search  # noqa: E402
from bee_code_interpreter_tpu_torch.models.engine import Engine  # noqa: E402
from bee_code_interpreter_tpu_torch.models.hf_loader import (  # noqa: E402
    load_llama_params,
)
from bee_code_interpreter_tpu_torch.models.replicated import (  # noqa: E402
    ReplicatedEngine,
)
from bee_code_interpreter_tpu_torch.models.mnist import MnistMlp  # noqa: E402
from bee_code_interpreter_tpu_torch.models.lora import (  # noqa: E402
    init_lora,
    lora_leaves,
    make_lora_train_step,
    merge_lora,
)
from bee_code_interpreter_tpu_torch.models.serving import (  # noqa: E402
    ContinuousBatcher,
    SamplingParams,
)
from bee_code_interpreter_tpu_torch.models.serving_bench import (  # noqa: E402
    run_serving_bench,
)
from bee_code_interpreter_tpu_torch.models.speculative import (  # noqa: E402
    speculative_generate,
)
from bee_code_interpreter_tpu_torch.models.transformer import (  # noqa: E402
    TransformerConfig,
    init_params,
    param_specs,
    shard_params,
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
from bee_code_interpreter_tpu_torch.ops.weight_quant import (  # noqa: E402
    DEFAULT_TARGETS,
    quantize_weights,
    quantized_nbytes,
)
from bee_code_interpreter_tpu_torch.observability import (  # noqa: E402
    DeviceMonitor,
    FlightRecorder,
    ServingMonitor,
    ServingProfiler,
    TraceStore,
)
from bee_code_interpreter_tpu_torch.parallel.mesh import (  # noqa: E402
    all_to_all_tiled,
    axis_index,
    axis_sizes,
    batch_slice,
    group_size,
    local_shape,
    make_mesh,
    mesh_shape_key,
    replica_mesh,
    ring_shift,
    serving_groups,
    spawn,
    tp_group,
)
from bee_code_interpreter_tpu_torch.utils.checkpoint import (  # noqa: E402
    TrainCheckpointer,
    abstract_like,
)
from bee_code_interpreter_tpu_torch.utils.metrics import Registry  # noqa: E402

# the modules (the package exports their functions under the same names)
ring_mod = importlib.import_module(
    "bee_code_interpreter_tpu_torch.parallel.ring_attention")
ulysses_mod = importlib.import_module(
    "bee_code_interpreter_tpu_torch.parallel.ulysses")
mesh_mod = importlib.import_module(
    "bee_code_interpreter_tpu_torch.parallel.mesh")
pipeline_mod = importlib.import_module(
    "bee_code_interpreter_tpu_torch.parallel.pipeline")

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
# float32 outside the tensor cores: the f32 kernels' rate
F32_FLOPS_PER_S = 67e12
# ~0.2 ms of device time ahead of each timed call: more than the host takes to
# enqueue a kernel wrapper (tens of microseconds)
SLEEP_CYCLES = 400_000
# bf16 kernel vs f32 plain version on the same bf16 inputs: the output is
# rounded to bf16 (~4e-3 at |x| ~ 1) and K1 rounds P to bf16 for P V
KERNEL_TOL = 2e-2
# K1's output against its plain version, per row (one query of one head):
# max |error| over the row's max |output|, so long rows, whose outputs are
# ~sqrt(e / Lk) (0.018-0.026 at Lk = 4096-8192 with randn q, k, v), are
# held as tightly as short ones. The bf16 output rounding is at most 2^-8
# of the row's largest value and the bf16 P in P V adds ~2e-3: 1e-2. Its
# lse (f32) keeps the absolute KERNEL_TOL. An H100 run read 4.5e-3 to
# 6.5e-3 over every case of this script, and lse within 1.1e-5.
K1_ROW_TOL = 1e-2
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
# the f32 kernels (K1/K3/K4 on the CUDA cores, K2 at f32 pools) against
# their f32 plain versions: max |error| over max |output| (the same math in
# another order of f32 sums)
F32_KERNEL_TOL = 1e-4
# bf16 decoder on the card vs the f32 plain path on the CPU, 2 layers at
# 8B widths: max |logit error| over max |logit|
REFERENCE_TOL = 5e-2
# one training step of that decoder, bf16 on the card vs f32 on the CPU:
# relative loss error, and per leaf ||g_card - g_cpu|| / ||g_cpu||. The
# first H100 run gave 1.7e-5 and at most 2.5e-2 (bf16 activations and
# weight casts); the limits keep 60x and 1.6x headroom.
TRAIN_LOSS_TOL = 1e-3
TRAIN_GRAD_TOL = 4e-2
# train_tp's losses (train_path at tp=2, 4 steps) against train_path's, per
# step, relative; the tp-rounding control (train_path on one card with
# tp=2's bf16 partials, ``tp_split_qeinsum``) is held to the same limits.
# An H100 run read 1.8e-5, 1.2e-4, 3.1e-4, 1.07e-2 for the control and
# 1.8e-5, 1.1e-4, 2.4e-4, 9.8e-3 for train_tp (AdamW's early updates are
# ~lr x sign(g), so rounding flips near-zero gradients into whole steps):
# TRAIN_LOSS_TOL where both read under a third of it, else twice the
# control's reading.
TRAIN_TP_LOSS_TOL = (TRAIN_LOSS_TOL, TRAIN_LOSS_TOL, TRAIN_LOSS_TOL, 2e-2)
# admission and KV-cache phases on Llama-3-8B (32 layers, bf16): max |logit
# error| over max |logit| of one path against another. A prefix hit's
# suffix windows (einsum attention over the pool) and a chunked admission
# against a one-shot admission (K1); the contiguous decode, one-shot or
# chunked, and with an int8 cache, against one teacher-forced forward. The
# first H100 run read 0.0210 (hit), 0.0214 (chunked), 0.0196 / 0.0187
# (contiguous one-shot / chunked) and 0.0208 (int8 cache): 5e-2 keeps 2.3x
# to 2.7x headroom.
PATH_LOGIT_TOL = 5e-2
# weight-only int8 (per out channel) against bf16 weights, first-token
# logits of main_path's 12 requests at 32 layers: max |error| / max |logit|.
# The bound is the JAX package's own quality bound for the quantized model
# (tests/test_weight_quant.py: 0.25 of the largest logit).
WEIGHT_INT8_TOL = 0.25
# serving_lora: 4 adapters of rank 16 on wq/wk/wv/wo, alpha/rank 2, B drawn
# N(0, LORA_B_STD^2): each delta's output ~2 * sqrt(16) * 0.02 = 0.16 of a
# projection's unit-scale output, enough to move every logit
LORA_RANK, LORA_SCALE, LORA_B_STD = 16, 2.0, 0.02
SPEC_GAMMA = 4
# Llama-3.2-3B's published shapes (meta-llama/Llama-3.2-3B config.json:
# hidden 3072, 28 layers, 24 heads over 8 KV heads, head dim 128,
# intermediate 8192, vocab 128256), untied head, random weights
DRAFT_3B = dict(d_model=3072, n_layers=28, n_heads=24, n_kv_heads=8,
                d_ff=8192)
SNAPSHOT_AFTER_STEPS = 8
# the tensor-parallel phases added ~100 s to the run: contiguous_decode,
# serving_speculative (its Llama-3.2-3B-shaped draft cut in proportion, 28
# -> 7 layers) and serving_snapshot run on the first 8 of main_path's 32
# layers, so the whole command stays near its earlier time
BREADTH_CUT_LAYERS = 8
# serving_bench: run_serving_bench at Llama-3-8B, 8 requests of 128-130
# tokens (prompt i: 128 + i % 3 tokens, numpy seed i), 64 new tokens each,
# greedy, 8 rows, pages of 16; a warm-up pass per arm, then 3 alternating
# rounds of one pass per arm
BENCH = dict(n_requests=8, prompt_len=128, max_new_tokens=64, repeats=3,
             inner=1, max_batch=8, page_size=16)
# serving_profile: decode steps captured at 8 rows
PROFILE_STEPS = 4
# lora_train: Llama-3-8B widths cut to 2 layers, B=1, L=128, 2 steps
LORA_TRAIN_LAYERS, LORA_TRAIN_STEPS = 2, 2
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
# Mixtral-8x7B widths (TransformerConfig.mixtral_8x7b()). Serving is cut to
# 16 of 32 layers: the whole model is 46.70 B parameters, 93.4 GB in bf16,
# more than one 80 GB card; 16 layers are 23.48 B, 46.97 GB (a decode step's
# weight-streaming bound 14.0 ms). Training is cut to 2 layers: 3.16 B
# parameters, 50.6 GB of f32 masters, gradients and AdamW moments.
MOE_SERVE_LAYERS, MOE_TRAIN_LAYERS, MOE_REFERENCE_LAYERS = 16, 2, 2
MOE_EXACT_REQUESTS = 4
# tensor-parallel and replicated serving: tp=2 ranks (one per card with two
# cards or more, over NCCL; both on card 0 over gloo with one card) and two
# replicas; K1 and K2 then run at the rank-local head counts below
TP = 2
TP_HEADS = (32 // TP, 8 // TP)
# sequence-parallel serving (the long-context admission path): sp=2 ranks
# on the transport of the tp phases; 4 requests of 4096-8000 tokens (numpy
# seed 20), 32 new tokens each, even ones greedy, odd ones seeded sampled,
# in a geometry of 4 rows of up to 512 pages of 16 (8192 tokens) over 2049
# pages. The ring runs all 32 layers; Ulysses, sp=2 x tp=2 and the
# tensor-parallel LoRA and MoE phases run BREADTH_CUT_LAYERS to keep the
# run's time.
SP = 2
SP_GEOMETRY = dict(max_batch=4, page_size=16, max_pages_per_seq=512,
                   n_pages=2049)
SP_REQUESTS, SP_PROMPT_RANGE, SP_NEW_TOKENS = 4, (4096, 8000), 32
# K1 at the shapes the sp paths launch (H=32, KVH=8 a ring rank; H=16,
# KVH=4 a Ulysses rank over the gathered sequence): (B, Lq, Lk, causal,
# window)
K1_SP_CASES = [(1, 4096, 4096, True, None), (1, 4096, 4096, False, None),
               (1, 4096, 4096, True, 1024)]
K1_ULYSSES_CASES = [(1, 8192, 8192, True, None)]
# sp_attention: one layer's q/k/v of a 8192-token sequence, bf16, the whole
# of it on every rank, against single-device flash_attention on the whole
# sequence, per row (one query of one head) over the row's max |output|.
# The ring rounds each hop's output to bf16 (half an ulp of a hop's value,
# which may exceed the merged one) before the f32 merge and rounds the
# merged result, where one card rounds once: up to ~2 bf16 ulps of the
# row's largest value, 2 x 2^-7 = 1.6e-2. A plain-math model of the 2-hop
# merge at this shape read 2^-7 = 7.8e-3 and an H100 run 8.6e-3: 1.5e-2.
# Ulysses runs K1 on the same heads over the same sequence as one card, so
# it must be bitwise equal.
SP_ATTN_SHAPE = dict(B=1, H=32, KVH=8, L=8192, D=128)
SP_ATTN_ROW_TOL = 1.5e-2
# one MoE block (``_mlp_block``, Mixtral widths) under tp=2 or ep=2 against
# one card on the same input, per token over the token's max |output|:
# routing is the same by construction (the replicated router on the same
# input). tp rounds each half of an expert's down projection to bf16
# (half an ulp of a half's value, which may exceed the sum's) before the
# f32 sum, and the sum once more, where one card rounds once: up to ~2 bf16
# ulps of the token's largest value, 1.6e-2. An H100 run read 7.7e-3 (8
# tokens, the every-expert form) and 9.1e-3 (1024, routed): 1.5e-2. Under
# ep each expert is whole on one rank and a token's two choices add in f32
# as on one card: bitwise equal (as the same run read both forms).
MOE_BLOCK_ROW_TOL = 1.5e-2
# its inputs, (B, L): a decode step at 8 rows (the every-expert form) and a
# 1024-token prompt (the routed form, capacity drops included)
MOE_BLOCK_SHAPES = {"decode": (8, 1), "prefill": (1, 1024)}
# serving_moe_tp's requests whose first-token logits may lie beyond
# PATH_LOGIT_TOL of one card's: capacity routing moves a near-tied token to
# another expert on a bf16 rounding of the tp reduce, which then moves the
# GShard slots of every later token in its group and drops the prompt's
# last tokens. Two H100 calls read 4 of 12 (0.118-0.254), the same bits
# both times; the MoE block itself is held by MOE_BLOCK_ROW_TOL.
MOE_TP_FIRST_OVER_MAX = 4
# dp x tp serving replicas (serving_replicated_tp): 2 replicas of tp=2, four
# ranks (one a card over NCCL with four cards; all on card 0 over gloo with
# one), on main_path's weights cut to BREADTH_CUT_LAYERS and its traffic
REPLICAS = 2
# training under a mesh on two ranks (train_tp, train_mesh), the transport
# of the tp phases: train_tp is train_path at tp=2 (Llama-3-8B widths,
# TRAIN_LAYERS, batch 2 x 1024 of numpy seed 6, TRAIN_STEPS steps, the same
# seed-10 masters), held to train_path's losses; train_mesh is one step at
# each of dp=2 and fsdp=2 (Llama-3-8B widths, 2 layers) and ep=2 (Mixtral
# widths, 2 layers), each held to the single-card step on the same masters
# and batch. One step each: the dp gradient sum moves ~6 GB of f32 over
# gloo's host staging at these widths.
TRAIN_MESH_LAYERS, TRAIN_MESH_STEPS = 2, 1
TRAIN_MESH_CASES = {
    "dp": ({"dp": 2}, "llama3_8b"),
    "fsdp": ({"fsdp": 2}, "llama3_8b"),
    "ep": ({"ep": 2}, "mixtral_8x7b"),
}
# K3/K4 at a tp=2 rank's heads (H=16, KVH=4): train_tp's shape
BWD_TP_CASES = [BWD_MAIN_CASE]
# K3/K4 at the shapes of the sp backward's hops (sp=2 over 8192 tokens): a
# ring rank's own block (causal) and an earlier hop (non-causal) at H=32
# KVH=8, L_local 4096; a Ulysses rank's H=16 KVH=4 over the whole 8192
BWD_SP_CASES = [(1, 4096, 4096, True, None, False),
                (1, 4096, 4096, False, None, False)]
BWD_ULYSSES_CASES = [(1, 8192, 8192, True, None, False)]
# sp_attention_grad: the ring with a sliding window of 1024 (its earlier
# hop a boundary block: no K3/K4 there)
SP_GRAD_WINDOW = 1024
# train_sp: Llama-3-8B widths cut to 2 layers (1.50 B parameters: f32
# masters, gradients and AdamW moments 24 GB a rank, two ranks on one card),
# one row of 8192 tokens (numpy seed 8), sp=2, the ring then Ulysses, 2
# steps each, held to one card's 2 steps on the same masters and batch
TRAIN_SP_LAYERS, TRAIN_SP_L, TRAIN_SP_STEPS = 2, 8192, 2
# train_pp: pp=2 over Llama-3-8B widths cut to 4 layers (2 a stage: each
# rank 2 layers plus the replicated embedding and head, 1.50 B parameters),
# 4 x 1024 tokens (numpy seed 9) in 4 microbatches, 2 steps, held to one
# card's 4-layer steps on the same masters and batch
PP = 2
TRAIN_PP_LAYERS, TRAIN_PP_B, TRAIN_PP_L = 4, 4, 1024
TRAIN_PP_MICROBATCHES, TRAIN_PP_STEPS = 4, 2
# the MoE aux loss, bf16 on the card against f32 on the CPU: relative error
# (a top-1 flip moves it by ~E/tokens x a probability gap; bf16 rounding of
# the mean probabilities by ~1e-3)
MOE_AUX_TOL = 1e-2

# K1/K3/K4 at head dim 64 (``flash_d64``), ((H, KVH), (B, Lq, Lk, causal,
# window)): ViT-B/16's attention (B=128, H=KVH=12, L=196, non-causal: ragged
# tiles, one head a group), a ragged causal case at the same heads, and a
# GQA case, non-causal with Lq != Lk
D64_CASES = [((12, 12), (128, 196, 196, False, None)),
             ((12, 12), (1, 1000, 1000, True, None)),
             ((32, 8), (1, 300, 700, False, None))]
# the vision family (ViTConfig.vit_b16(), ResNetConfig.resnet50(), seeded
# noise images at 224², no dataset): the ViT whole at B=128, 4 AdamW steps;
# its reference cut to 2 layers at B=8 (bf16 card against f32 CPU); the
# ResNet whole at B=64, 4 SGD steps; its reference cut to the first stage
# at B=2
VIT_B, VIT_STEPS = 128, 4
VIT_REFERENCE_LAYERS, VIT_REFERENCE_B = 2, 8
RESNET_B, RESNET_STEPS = 64, 4
# the ResNet's SGD learning rate: JAX's default, optax.sgd(0.1, momentum=
# 0.9), diverges on ResNet-50 at random init on one fixed batch (an H100
# run of this phase at 0.1 saw the loss rise from the second step); the
# momentum is the default's
RESNET_LR = 0.01
RESNET_REFERENCE_STAGES, RESNET_REFERENCE_B = (3,), 2
# vision_mesh, in the training spawn: ViT-B/16 at B=32 one step at each of
# these meshes, ResNet-50 at B=16 one step at dp=2, the MNIST MLP
# (784-512-256-10, 256 rows) MNIST_STEPS steps at dp=2
VISION_MESH_B, VISION_MESH_RESNET_B, MNIST_STEPS = 32, 16, 30
VISION_MESH_VIT_CASES = {"dp2": ({"dp": 2}, "ring"), "tp2": ({"tp": 2}, "ring"),
                         "sp2": ({"sp": 2}, "ring")}
# generate_dp: Llama-3-8B (all 32 layers, bf16, the seed-0 weights) at dp=2,
# greedy generate_cached of 4 prompts of 128 tokens (numpy seed 21), 16 new
# tokens; generate_fsdp: its first 2 layers at fsdp=2, 4 new tokens (gloo
# stages the layer gathers at ~310 MB/s)
GENERATE_PROMPTS, GENERATE_PROMPT_LEN, GENERATE_NEW = 4, 128, 16
GENERATE_FSDP_LAYERS, GENERATE_FSDP_NEW = 2, 4
# checkpoint_pp: the f32 masters of 2 Llama-3-8B layers under pp=2
CHECKPOINT_PP_LAYERS = 2


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


def bound(flops: float, nbytes: float,
          flops_per_s: float = BF16_FLOPS_PER_S) -> tuple[float, str]:
    t_ops = flops / flops_per_s * 1e3
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


def flops_rate(dtype) -> float:
    """The card's peak for ``dtype`` products: the tensor cores' bf16 rate,
    the CUDA cores' f32 one."""
    return F32_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S


def sdpa_ms(timer, fn) -> float | None:
    """SDPA's time where it takes the shape (None where it raises): the
    yardstick only, never the port's path."""
    try:
        fn()
    except RuntimeError:
        return None
    return timer(fn, 20)


def pad_ms(timer, tensors, D: int, dtype) -> float | None:
    """The wrapper's zero-pad copy of ``tensors`` to the tensor-core
    instance's width, where the route pads (None where it does not)."""
    cols = fa.pad_width(dtype, D)
    if cols == D:
        return None
    return timer(lambda: [fa.pad_head_dim(t, cols) for t in tensors], 20)


def check_flash(timer, dev, heads=(32, 8), cases=K1_CASES,
                D: int = 128, dtype=torch.bfloat16) -> list[dict]:
    """K1 on ``cases`` at ``heads`` = (H, KVH), head dim ``D`` and
    ``dtype``: against its plain version (bf16: KERNEL_TOL and K1_ROW_TOL;
    f32: F32_KERNEL_TOL of the largest output), timed, with SDPA as the
    library call, the card's bound and, where the route pads, the pad's
    time."""
    H, KVH = heads
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for B, L, Lk, causal, window in cases:
        q = torch.randn(B, H, L, D, generator=gen, device=dev, dtype=dtype)
        k = torch.randn(B, KVH, Lk, D, generator=gen, device=dev, dtype=dtype)
        v = torch.randn(B, KVH, Lk, D, generator=gen, device=dev, dtype=dtype)
        out, lse = fa.flash_attention_with_lse(q, k, v, causal, window=window)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_fwd_plain(
            q.float(), k.float(), v.float(), causal, window=window
        )
        lse_err = (lse - ref_lse).abs().max().item()
        err = max((out.float() - ref_out).abs().max().item(), lse_err)
        row_err = row_rel_err(out, ref_out)
        case = (f"D={D} {dtype} B={B} Lq={L} Lk={Lk} causal={causal} "
                f"window={window}")
        if dtype == torch.float32:
            rel = err / max(ref_out.abs().max().item(), ref_lse.abs().max().item())
            check(rel <= F32_KERNEL_TOL, f"flash_fwd {case}: rel err {rel}")
        else:
            check(err <= KERNEL_TOL, f"flash_fwd {case}: max abs err {err}")
            check(row_err <= K1_ROW_TOL,
                  f"flash_fwd {case}: out row err {row_err} over {K1_ROW_TOL}")
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
        library_ms = sdpa_ms(timer, lib)
        flops = 4.0 * B * H * visible_pairs(L, Lk, causal, window) * D
        nbytes = (q.element_size() * (2 * q.numel() + 2 * k.numel())
                  + 4.0 * lse.numel())
        b_ms, b_by = bound(flops, nbytes, flops_rate(dtype))
        rows.append({
            "B": B, "H": H, "KVH": KVH, "D": D, "L": L, "Lk": Lk, "causal": causal,
            "window": window, "dtype": str(dtype).removeprefix("torch."),
            "route": fa.kernel_route(dtype, D)[0],
            "max_abs_err": err, "out_row_rel_err": row_err,
            "lse_abs_err": lse_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "pad_ms": pad_ms(timer, (q, k, v), D, dtype),
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


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max over rows (every index but the last) of the row's max |error|
    over its max |want|."""
    diff = (got.float() - want.float()).abs().amax(dim=-1)
    return (diff / want.float().abs().amax(dim=-1).clamp_min(1e-30)).max().item()


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |error|, max |error| / max |want|)."""
    err = (got.float() - want).abs().max().item()
    return err, err / want.abs().max().item()


def check_flash_bwd(timer, dev, heads=(32, 8), cases=BWD_CASES,
                    D: int = 128, dtype=torch.bfloat16) -> list[dict]:
    """K3 and K4 on K1's own out/lse and a random dO, against their plain
    versions in f32 (bf16: BWD_TOL, f32: F32_KERNEL_TOL of the largest
    gradient) and against SDPA's backward, at ``heads`` (H, KVH), head dim
    ``D`` and ``dtype``."""
    H, KVH = heads
    gen = torch.Generator(device=dev).manual_seed(7)
    tol = F32_KERNEL_TOL if dtype == torch.float32 else BWD_TOL
    rows = []
    for B, Lq, Lk, causal, window, with_g_lse in cases:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

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
        case = (f"D={D} {dtype} B={B} Lq={Lq} Lk={Lk} causal={causal} "
                f"window={window}")
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
            check(rel <= tol, f"flash_bwd {name} {case}: rel err {rel}")

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
        library_ms = sdpa_ms(timer, lambda: torch.autograd.grad(
            ref, (qr, kr, vr), do, retain_graph=True))
        del ref, qr, kr, vr

        pairs = visible_pairs(Lq, Lk, causal, window)
        es = q.element_size()
        io = es * (2 * q.numel() + 2 * k.numel()) + 4.0 * 2 * lse.numel()
        rate = flops_rate(dtype)
        dkdv_bound = bound(8.0 * B * H * pairs * D, io + es * 2 * k.numel(), rate)
        dq_bound = bound(6.0 * B * H * pairs * D, io + es * q.numel(), rate)
        rows.append({
            "B": B, "H": H, "KVH": KVH, "D": D, "Lq": Lq, "Lk": Lk, "causal": causal,
            "window": window, "dtype": str(dtype).removeprefix("torch."),
            "route": fa.kernel_route(dtype, D)[0],
            "pad_ms": pad_ms(timer, (q, k, v, do), D, dtype),
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
            "tflops_library": (None if library_ms is None
                               else 14.0 * B * H * pairs * D / library_ms / 1e9),
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
# K1 and K2 at a tp=2 rank's heads (TP_HEADS): the main and serving cases
K1_TP_CASES = [K1_MAIN_CASE, (1, 48, 48, True, None), (1, 80, 80, True, None),
               (1, 1000, 1000, True, None)]
K2_TP_CASES = {name: K2_CASES[name] for name in (K2_MAIN_CASE, "serving_b8")}


def check_paged_decode(timer, dev, heads=(32, 8),
                       cases=K2_CASES, dh: int = 128) -> list[dict]:
    """K2 on every case at ``heads`` = (nh, kvh) and head dim ``dh`` against
    its plain version (f32 math on the same inputs), two calls' bits, its
    time, the plain version's, the byte bound and the split the wrapper
    chose."""
    (nh, kvh), ps = heads, 16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for name, (lengths, dtype, P) in cases.items():
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
        b_ms, b_by = bound(flops, nbytes, flops_rate(dt))
        entry = pa.kernel_entry(dh, nh // kvh)
        pps = pa.entry_split(entry, B, nh, kvh, P, ps, sms)
        rows.append({
            "case": name, "B": B, "nh": nh, "kvh": kvh, "dh": dh, "ps": ps,
            "P": P, "entry": entry,
            "dtype": dtype, "lengths": lengths, "pages_per_split": pps,
            "splits": -(-P // pps), "max_abs_err": err, "max_row_rel_err": row_err,
            "row_tolerance": K2_ROW_TOL[dtype], "deterministic": True,
            "ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms,
            "bound_by": b_by, "gb_per_s": nbytes / ms / 1e6,
        })
        del q, kp, vp, out, out2, ref
    return rows


# ---------------------------------------------------------------- reference


def teacher_forced_logits(params, cfg, device, prompts, feed,
                          tp_group=None) -> torch.Tensor:
    """Prefill each prompt as the batcher does (padded to whole pages,
    seeded into its pages), then decode ``feed`` [B, n] token by token.
    Returns [B, 1 + n, vocab] f32 logits (prefill last row, then steps).
    With ``tp_group``, ``params`` is this rank's shard and the pool holds
    its K/V heads."""
    ps, P = 16, 8
    cache = alloc_paged_cache(cfg, 1 + len(prompts) * P, ps, device,
                              kv_heads=cfg.kv_heads // group_size(tp_group))
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
            return_kv=True, tp_group=tp_group,
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
            params, tok, pos + s, cache, bt, cfg, tp_group=tp_group
        )
        out.append(logits[:, 0])
    return torch.stack(out, dim=1).float().cpu()


def tree_to(tree, device, dtype, requires_grad: bool = False):
    """A parameter tree (dicts, lists, tensors) copied to ``device`` and
    ``dtype``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype, requires_grad)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device, dtype, requires_grad) for v in tree]
    return tree.detach().to(device, dtype).requires_grad_(requires_grad)


def cpu_f32(tree, requires_grad: bool = False):
    """A parameter tree (dicts, lists, tensors) as f32 CPU tensors."""
    return tree_to(tree, "cpu", torch.float32, requires_grad)


def check_reference(params, cfg, dev) -> dict:
    small = dataclasses.replace(cfg, n_layers=2)
    cut = {**params, "layers": params["layers"][:2]}
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (40, 23)]
    feed = rng.integers(0, cfg.vocab_size, (2, 6))
    got = teacher_forced_logits(cut, small, dev, prompts, feed)
    f32 = dataclasses.replace(small, dtype=torch.float32)
    want = teacher_forced_logits(cpu_f32(cut), f32, torch.device("cpu"),
                                 prompts, feed)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    check(bool(torch.isfinite(got).all()), "reference: non-finite logits")
    check(rel <= REFERENCE_TOL, f"reference: relative logit error {rel}")
    return {"phase": "reference", "layers": 2, "rel_max_logit_err": rel,
            "argmax_agreement": agree, "tolerance": REFERENCE_TOL}


# ---------------------------------------------------------------- main path


def count_decode_steps():
    """Counts ``decode_step_paged`` calls while installed: (counter, undo)."""
    steps = [0]
    decode = transformer.decode_step_paged

    def counted(*args, **kwargs):
        steps[0] += 1
        return decode(*args, **kwargs)

    transformer.decode_step_paged = counted
    return steps, lambda: setattr(transformer, "decode_step_paged", decode)


def capture_admissions(batcher) -> dict:
    """Wraps the batcher's blocking admission paths: request id -> (the
    first token's logits row, the admission's start and end on the host
    clock)."""
    seen = {}
    for name in ("_full_admit", "_suffix_admit"):
        admit = getattr(batcher, name)

        def wrapped(*args, admit=admit, **kwargs):
            rid = batcher._next_request_id - 1  # assigned before the prefill
            t = time.perf_counter()
            row = admit(*args, **kwargs)
            seen[rid] = (row, t, time.perf_counter())  # row is on the host
            return row

        setattr(batcher, name, wrapped)
    return seen


# main_path's batcher geometry: 8 rows, pages of 16, 128 pages a row
SERVE_GEOMETRY = dict(max_batch=8, page_size=16, max_pages_per_seq=128,
                      n_pages=1 + 8 * 128)


def serve(params, cfg, requests, setup=None, **batcher_kw) -> dict:
    """One Engine run over ``requests`` ((prompt, new tokens, sampling,
    submit kwargs) each, all submitted at t=0) on a fresh batcher in
    main_path's geometry: ``drive``."""
    batcher = ContinuousBatcher(params, cfg, **SERVE_GEOMETRY, **batcher_kw)
    return drive(batcher, requests, setup)


def drive(batcher, requests, setup=None) -> dict:
    """One Engine run over ``requests`` on ``batcher``; counts kernel
    launches and decode steps from zero. ``setup(batcher)``, when given,
    runs before the requests and its result comes back under
    ``"setup"``."""
    engine = Engine(batcher)
    admissions = capture_admissions(batcher)
    hooks = setup(batcher) if setup is not None else None
    fa.FLASH_FWD.launches = 0
    pa.PAGED_DECODE.launches = 0
    steps, undo = count_decode_steps()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tickets = [engine.submit(p, n, sampling=s, **kw)
                   for p, n, s, kw in requests]
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
        undo()
    rids = [engine._state[t] for t in tickets]
    return {
        "tokens": [engine.result(t) for t in tickets],
        "finish": [engine.finish_reason(t) for t in tickets],
        "k1_launches": fa.FLASH_FWD.launches,
        "k2_launches": pa.PAGED_DECODE.launches,
        "decode_steps": steps[0],
        "wall_s": wall,
        "ttft_s": [ttft[t] for t in tickets],
        "decode_only_step_ms": decode_only_ms,
        # per request: the first token's logits, the admission's start and
        # end on the host clock from t0 (the first token is sampled at once)
        "first_logits": [admissions[r][0] for r in rids],
        "admit_s": [(admissions[r][1] - t0, admissions[r][2] - t0)
                    for r in rids],
        "prefix_stats": dict(batcher.prefix_stats),
        "kv_telemetry": batcher.kv_telemetry(),
        "pool_bytes": sum(x.numel() * x.element_size()
                          for x in batcher.cache.values()),
        "logprobs": [engine.result_logprobs(t) if s is not None and s.logprobs
                     else None for t, (_, _, s, _) in zip(tickets, requests)],
        "setup": hooks,
    }


def main_requests(vocab_size: int, new_tokens: int = 32) -> list:
    """main_path's traffic: 12 prompts of 64-1024 tokens (numpy seed 5)
    under ``vocab_size``, ``new_tokens`` each, even ones greedy and odd
    ones seeded sampled."""
    rng = np.random.default_rng(5)
    requests = []
    for i, L in enumerate(rng.integers(64, 1025, size=12)):
        prompt = rng.integers(0, vocab_size, int(L)).tolist()
        sampling = (SamplingParams() if i % 2 == 0 else
                    SamplingParams(temperature=0.8, top_k=50, seed=100 + i))
        requests.append((prompt, new_tokens, sampling, {}))
    return requests


def main_path(params, cfg) -> tuple[dict, dict, list]:
    new_tokens = 32
    requests = main_requests(cfg.vocab_size, new_tokens)
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
        "prompt_lens": [len(p) for p, _, _, _ in requests],
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
        "pool_gb": first["pool_bytes"] / 1e9,
        # each one-shot admission's prefill, by prompt length
        "admit_ms_by_len": sorted(
            (len(p), (end - start) * 1e3)
            for (p, _, _, _), (start, end) in zip(requests, first["admit_s"])),
    }
    return report, first, requests


# ------------------------------------------------- admission and KV caches


def first_token_err(params, cfg, prompts, rows) -> float:
    """Max over ``prompts`` of max |logit error| / max |logit| of each
    request's first-token logits ``rows`` against a one-shot admission of
    the same prompt (one ``forward`` over it padded to whole pages, the
    path of a miss with the prefix cache off)."""
    worst = 0.0
    for prompt, row in zip(prompts, rows):
        L = len(prompt)
        padded = np.zeros(-(-L // 16) * 16, dtype=np.int64)
        padded[:L] = prompt
        want = transformer.forward(
            params, torch.as_tensor(padded[None], device=params["embed"].device),
            cfg)[0, L - 1].float().cpu()
        got = torch.as_tensor(row)
        worst = max(worst, ((got - want).abs().max() / want.abs().max()).item())
    return worst


def admission_prefix(params, cfg) -> dict:
    """8 requests sharing a 512-token system prompt (32 pages), then
    distinct suffixes, with the prefix cache on: one miss through K1, seven
    hits through page-aligned windows over the shared pages."""
    rng = np.random.default_rng(11)
    system = rng.integers(0, cfg.vocab_size, 512).tolist()
    prompts = [system + rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(32, 257, size=8)]
    run = serve(params, cfg, [(p, 32, SamplingParams(), {}) for p in prompts],
                prefix_cache=True)
    stats, tele = run["prefix_stats"], run["kv_telemetry"]
    n_layers = cfg.n_layers
    check(stats["hits"] == 7 and stats["pages_reused"] == 7 * 32,
          f"admission_prefix: prefix stats {stats}")
    check(run["k1_launches"] == n_layers,
          f"admission_prefix: flash_fwd launched {run['k1_launches']} times, "
          f"expected {n_layers} (one miss)")
    check(run["decode_steps"] > 0
          and run["k2_launches"] == n_layers * run["decode_steps"],
          f"admission_prefix: paged_decode launched {run['k2_launches']} "
          f"times over {run['decode_steps']} decode steps")
    check(tele["pages_held"] == (tele["pages_allocated_total"]
                                 - tele["pages_released_total"])
          and tele["pages_held"] == 0
          and tele["pages_free"] + tele["pages_parked"] == tele["pages_total"],
          f"admission_prefix: page totals {tele}")
    check(all(f == "length" for f in run["finish"]),
          f"admission_prefix: finish reasons {run['finish']}")
    err = first_token_err(params, cfg, prompts[1:], run["first_logits"][1:])
    check(err <= PATH_LOGIT_TOL,
          f"admission_prefix: hit logits vs one-shot, rel err {err}")
    admit_ms = [(end - start) * 1e3 for start, end in run["admit_s"]]
    ttft_ms = [end * 1e3 for _, end in run["admit_s"]]
    return {
        "phase": "admission_prefix", "requests": 8, "system_prompt": 512,
        "prompt_lens": [len(p) for p in prompts], "new_tokens": 32,
        "prefix_stats": stats, "k1_launches": run["k1_launches"],
        "k2_launches": run["k2_launches"],
        "decode_steps": run["decode_steps"],
        "pages": {k: tele[k] for k in ("pages_total", "pages_free",
                                       "pages_parked", "pages_held",
                                       "pages_allocated_total",
                                       "pages_released_total")},
        "hit_rel_logit_err": err, "tolerance": PATH_LOGIT_TOL,
        "miss_admit_ms": admit_ms[0],
        "hit_admit_ms_p50": float(np.median(admit_ms[1:])),
        "miss_ttft_ms": ttft_ms[0],
        "hit_ttft_ms_p50": float(np.median(ttft_ms[1:])),
        "tokens_per_s": sum(map(len, run["tokens"])) / run["wall_s"],
        "decode_step_p50_ms": float(np.median(run["decode_only_step_ms"])),
    }


def admission_chunked(params, cfg) -> dict:
    """4 requests of 1024-token prompts admitted by ``prefill_chunk=256``
    (prefill_chunked + seed_from_contiguous: no K1), twice."""
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, 1024).tolist() for _ in range(4)]
    requests = [(p, 32, SamplingParams(), {"prefill_chunk": 256})
                for p in prompts]
    first = serve(params, cfg, requests)
    second = serve(params, cfg, requests)
    n_layers = cfg.n_layers
    check(first["k1_launches"] == 0,
          f"admission_chunked: flash_fwd launched {first['k1_launches']} times")
    check(first["decode_steps"] > 0
          and first["k2_launches"] == n_layers * first["decode_steps"],
          f"admission_chunked: paged_decode launched {first['k2_launches']} "
          f"times over {first['decode_steps']} decode steps")
    check(second["tokens"] == first["tokens"],
          "admission_chunked: second run gave other tokens")
    check(all(f == "length" for f in first["finish"]),
          f"admission_chunked: finish reasons {first['finish']}")
    err = first_token_err(params, cfg, prompts, first["first_logits"])
    check(err <= PATH_LOGIT_TOL,
          f"admission_chunked: first-token logits vs one-shot, rel err {err}")
    return {
        "phase": "admission_chunked", "requests": 4, "prompt_len": 1024,
        "prefill_chunk": 256, "new_tokens": 32,
        "k1_launches": first["k1_launches"], "k2_launches": first["k2_launches"],
        "decode_steps": first["decode_steps"],
        "rel_logit_err": err, "tolerance": PATH_LOGIT_TOL,
        "second_run_identical": True,
        "admit_ms": [(end - start) * 1e3 for start, end in first["admit_s"]],
        "ttft_p50_ms": float(np.median(first["ttft_s"])) * 1e3,
        "tokens_per_s": sum(map(len, first["tokens"])) / first["wall_s"],
    }


def admission_interleaved(params, cfg) -> dict:
    """5 requests decoding on 8 rows while 2 prompts of 1024 tokens admit
    in windows of 128 (``interleave_admission``); a third such request
    takes the last row and is preempted after its second window, then
    admitted again from the head of the queue and finished."""
    rng = np.random.default_rng(13)
    batcher = ContinuousBatcher(params, cfg, max_batch=8, page_size=16,
                                max_pages_per_seq=128, n_pages=1 + 8 * 128)
    engine = Engine(batcher)
    fa.FLASH_FWD.launches = 0
    pa.PAGED_DECODE.launches = 0
    steps, undo = count_decode_steps()
    window_ms, decode_ms, stalls, window_steps = [], [], [], 0

    def step():
        nonlocal window_steps
        before = {t: len(engine.partial_result(t)) for t in tickets}
        windows = bool(batcher.prefill_state) or engine.pending
        k1, n_steps = fa.FLASH_FWD.launches, steps[0]
        t = time.perf_counter()
        engine.step()
        dt = (time.perf_counter() - t) * 1e3
        if batcher.stats["prefilling_rows"] or windows:
            window_steps += 1
            window_ms.append(dt)
            # a row decoding before the step gains exactly one token
            stalls.extend(t for t, n in before.items()
                          if n and not engine.is_done(t)
                          and len(engine.partial_result(t)) != n + 1)
        elif fa.FLASH_FWD.launches == k1 and steps[0] > n_steps:
            decode_ms.append(dt)

    try:
        tickets = [engine.submit(rng.integers(0, cfg.vocab_size, int(n)).tolist(),
                                 64) for n in rng.integers(64, 257, size=5)]
        step()  # the 5 admit (K1) and decode
        longs = [rng.integers(0, cfg.vocab_size, 1024).tolist() for _ in range(3)]
        tickets += [engine.submit(p, 32, interleave_admission=128)
                    for p in longs[:2]]
        step()  # both admit: first windows
        free_before = len(batcher.free_pages)
        tickets.append(engine.submit(longs[2], 32, interleave_admission=128))
        step()  # admitted: its first window
        step()  # its second window
        preempted = engine.preempt(tickets[-1])
        free_after = len(batcher.free_pages)
        while engine.pending or batcher.busy:
            step()
        torch.cuda.synchronize()
    finally:
        undo()
    finish = [engine.finish_reason(t) for t in tickets]
    check(preempted, "admission_interleaved: preempt returned False")
    check(free_after == free_before,
          f"admission_interleaved: {free_after} free pages after the "
          f"preemption, {free_before} before its submit")
    check(not stalls, f"admission_interleaved: tickets {stalls} stalled")
    check(all(f == "length" for f in finish),
          f"admission_interleaved: finish reasons {finish}")
    check(fa.FLASH_FWD.launches == 5 * cfg.n_layers,
          f"admission_interleaved: flash_fwd launched {fa.FLASH_FWD.launches} "
          "times, expected only by the 5 one-shot admissions")
    return {
        "phase": "admission_interleaved", "max_batch": 8, "decoding": 5,
        "interleaved": 3, "prompt_len": 1024, "width": 128,
        "preempted_after_windows": 2, "free_pages_restored": True,
        "no_stalls": True, "window_steps": window_steps,
        "k1_launches": fa.FLASH_FWD.launches,
        "k2_launches": pa.PAGED_DECODE.launches, "decode_steps": steps[0],
        "window_step_ms_p50": float(np.median(window_ms)),
        "decode_only_step_ms_p50": float(np.median(decode_ms)),
        "window_step_ms": window_ms,
    }


def serving_int8(params, cfg, requests, bf16) -> dict:
    """main_path's traffic on an int8 KV pool: K1 admits, the einsum path
    decodes (the JAX gate keeps K2 off int8 pools)."""
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    run = serve(params, cfg8, requests)
    n_layers, n_req = cfg.n_layers, len(requests)
    check(run["k2_launches"] == 0,
          f"serving_int8: paged_decode launched {run['k2_launches']} times")
    check(run["k1_launches"] == n_layers * n_req,
          f"serving_int8: flash_fwd launched {run['k1_launches']} times")
    check(all(f == "length" for f in run["finish"]),
          f"serving_int8: finish reasons {run['finish']}")
    ratio = run["pool_bytes"] / bf16["pool_bytes"]
    # 1 byte a value + 4 bytes of scale a head_dim-wide row, against 2 bytes
    # a value in bf16
    want = (1 + 4 / cfg.head_dim) / cfg.dtype.itemsize
    check(abs(ratio - want) < 1e-6, f"serving_int8: pool bytes ratio {ratio}")
    greedy = [i for i, (_, _, s, _) in enumerate(requests) if s.temperature == 0]
    same = [a == b for i in greedy
            for a, b in zip(run["tokens"][i], bf16["tokens"][i])]
    return {
        "phase": "serving_int8", "requests": n_req,
        "pool_gb": run["pool_bytes"] / 1e9,
        "bf16_pool_gb": bf16["pool_bytes"] / 1e9, "pool_ratio": ratio,
        "k1_launches": run["k1_launches"], "k2_launches": run["k2_launches"],
        "decode_steps": run["decode_steps"],
        "tokens_per_s": sum(map(len, run["tokens"])) / run["wall_s"],
        "ttft_p50_ms": float(np.median(run["ttft_s"])) * 1e3,
        "decode_step_p50_ms": float(np.median(run["decode_only_step_ms"])),
        "greedy_token_agreement_with_bf16": float(np.mean(same)),
    }


def contiguous_decode(params, cfg) -> dict:
    """``Transformer.generate_cached`` at B=2, L=512, 32 new greedy tokens:
    one-shot bf16, ``prefill_chunk=128``, and an int8 cache. Each way is
    also driven by hand, ``decode_step`` by step, and every step's logits
    are held against one teacher-forced ``forward`` over prompt + tokens."""
    dev = params["embed"].device
    B, L, new = 2, 512, 32
    prompt = torch.as_tensor(
        np.random.default_rng(14).integers(0, cfg.vocab_size, (B, L)), device=dev)
    out = {"phase": "contiguous_decode", "layers": cfg.n_layers, "B": B,
           "L": L, "new_tokens": new}
    one_shot = None
    for way, kv, chunk in (("one_shot", "bf16", None), ("chunked", "bf16", 128),
                           ("int8", "int8", None)):
        c = dataclasses.replace(cfg, kv_cache_dtype=kv)
        fa.FLASH_FWD.launches = 0
        tokens = transformer.Transformer(c).generate_cached(
            params, prompt, new, prefill_chunk=chunk)
        k1 = fa.FLASH_FWD.launches
        # by hand: the same prefill, then decode_step by step, each timed
        if chunk is None:
            logits, (k_pre, v_pre) = transformer.forward(params, prompt, c,
                                                         return_kv=True)
            cache = transformer.init_decode_cache(c, B, L + new, k_pre, v_pre)
            last = logits[:, -1]
            del logits, k_pre, v_pre
        else:
            last, cache = transformer.prefill_chunked(params, prompt, c,
                                                      L + new, chunk=chunk)
        rows, step_ms = [last.float()], []
        current = last.argmax(-1, keepdim=True)
        for pos in range(L, L + new - 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = transformer.decode_step(params, current, pos,
                                                    cache, c)
            current = logits[:, -1].argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            rows.append(logits[:, -1].float())
        del cache
        got = torch.stack(rows, dim=1)  # [B, new, V]
        check(torch.equal(tokens[:, L:], got.argmax(-1)),
              f"contiguous_decode {way}: generate_cached and decode_step differ")
        # one teacher-forced forward over the prompt and this way's tokens
        want = transformer.forward(params, tokens[:, :-1], cfg)[:, L - 1:]
        rel = ((got - want).abs().max() / want.abs().max()).item()
        check(bool(torch.isfinite(got).all()) and rel <= PATH_LOGIT_TOL,
              f"contiguous_decode {way}: rel logit err {rel}")
        want_k1 = cfg.n_layers if chunk is None else 0
        check(k1 == want_k1,
              f"contiguous_decode {way}: flash_fwd launched {k1} times, "
              f"expected {want_k1}")
        one_shot = tokens if one_shot is None else one_shot
        out[way] = {
            "k1_launches": k1, "rel_logit_err": rel,
            "tolerance": PATH_LOGIT_TOL,
            "decode_step_ms_p50": float(np.median(step_ms)),
            "greedy_agreement_with_one_shot": (
                (tokens[:, L:] == one_shot[:, L:]).float().mean().item()),
        }
        del got, want
    return out


# ------------------------------------------------ model breadth of serving


def greedy_rows(requests) -> list[int]:
    return [i for i, (_, _, s, _) in enumerate(requests)
            if s is None or s.temperature == 0]


def token_agreement(a, b, rows) -> float:
    return float(np.mean([x == y for i in rows for x, y in zip(a[i], b[i])]))


def serving_weight_int8(params, cfg, requests, bf16) -> dict:
    """main_path's traffic on weight-only int8 weights (a bf16 pool): K1
    admits, K2 decodes (the JAX gate does not look at the weights), every
    projection converts its int8 weight to bf16 before its product."""
    qparams = quantize_weights(params)
    want = weight_int8_bytes(cfg)
    got = quantized_nbytes(qparams)
    fp = quantized_nbytes(params)
    check(got == want, f"serving_weight_int8: {got} bytes, expected {want}")
    first = serve(qparams, cfg, requests)
    second = serve(qparams, cfg, requests)
    del qparams
    n_layers, n_req = cfg.n_layers, len(requests)
    check(first["k1_launches"] == n_layers * n_req,
          f"serving_weight_int8: flash_fwd launched {first['k1_launches']} times")
    check(first["decode_steps"] > 0
          and first["k2_launches"] == n_layers * first["decode_steps"],
          f"serving_weight_int8: paged_decode launched {first['k2_launches']} "
          f"times over {first['decode_steps']} decode steps")
    check(second["tokens"] == first["tokens"],
          "serving_weight_int8: second run gave other tokens")
    check(all(f == "length" for f in first["finish"]),
          f"serving_weight_int8: finish reasons {first['finish']}")
    err = max(rel_err(torch.as_tensor(a), torch.as_tensor(b).float())[1]
              for a, b in zip(first["first_logits"], bf16["first_logits"]))
    check(err <= WEIGHT_INT8_TOL,
          f"serving_weight_int8: first-token logits vs bf16, rel err {err}")
    return {
        "phase": "serving_weight_int8", "requests": n_req,
        "targets": list(DEFAULT_TARGETS),
        "weight_gb": got / 1e9, "bf16_weight_gb": fp / 1e9,
        "weight_ratio": got / fp,
        "k1_launches": first["k1_launches"], "k2_launches": first["k2_launches"],
        "decode_steps": first["decode_steps"], "second_run_identical": True,
        "first_token_rel_logit_err_vs_bf16": err, "tolerance": WEIGHT_INT8_TOL,
        "tokens_per_s": sum(map(len, first["tokens"])) / first["wall_s"],
        "ttft_p50_ms": float(np.median(first["ttft_s"])) * 1e3,
        "decode_step_p50_ms": float(np.median(first["decode_only_step_ms"])),
        "main_path": {
            "tokens_per_s": sum(map(len, bf16["tokens"])) / bf16["wall_s"],
            "ttft_p50_ms": float(np.median(bf16["ttft_s"])) * 1e3,
            "decode_step_p50_ms": float(np.median(bf16["decode_only_step_ms"])),
        },
        "greedy_token_agreement_with_main_path": token_agreement(
            first["tokens"], bf16["tokens"], greedy_rows(requests)),
    }


def weight_int8_bytes(cfg) -> int:
    """The bytes of the quantized Llama tree from its shapes: int8 values
    and one f32 scale per out column for every target, bf16 for the rest."""
    shapes = transformer.layer_shapes(cfg)
    total = 0
    for name, shape in [*shapes.items()] * cfg.n_layers + [
            ("embed", (cfg.vocab_size, cfg.d_model)), ("ln_f", (cfg.d_model,)),
            ("lm_head", (cfg.d_model, cfg.vocab_size))]:
        n = int(np.prod(shape))
        total += n + 4 * shape[-1] if name in DEFAULT_TARGETS else 2 * n
    return total


def lora_adapters(cfg, dev, n: int, rank: int, seed: int) -> list[dict]:
    """``n`` adapters on wq/wk/wv/wo from ``init_lora``, with B drawn from
    a seeded generator (init_lora's B = 0 would change nothing)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    adapters = []
    for _ in range(n):
        lora = init_lora(cfg, gen, rank=rank, targets=("wq", "wk", "wv", "wo"))
        for ab in lora.values():
            ab["B"] = torch.randn(ab["B"].shape, generator=gen,
                                  device=dev) * LORA_B_STD
        adapters.append(lora)
    return adapters


def serving_lora(params, cfg) -> dict:
    """8 requests of 64-512 tokens over 4 adapters and the base model,
    decoding together: adapter rows admit through windows (no K1), base
    rows one-shot (K1), and every decode step runs K2 with the bank."""
    dev = params["embed"].device
    adapters = lora_adapters(cfg, dev, 4, LORA_RANK, seed=15)
    rng = np.random.default_rng(16)
    which = [0, 1, 2, 3, None, 0, 1, None]
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 513, size=len(which))]
    requests = [(p, 32, SamplingParams(), {"adapter": a})
                for p, a in zip(prompts, which)]
    kw = dict(adapters=adapters, lora_scale=LORA_SCALE)
    first = serve(params, cfg, requests, **kw)
    second = serve(params, cfg, requests, **kw)
    n_layers = cfg.n_layers
    n_base = sum(a is None for a in which)
    check(first["k1_launches"] == n_layers * n_base,
          f"serving_lora: flash_fwd launched {first['k1_launches']} times, "
          f"expected {n_layers} x {n_base} base admissions")
    check(first["decode_steps"] > 0
          and first["k2_launches"] == n_layers * first["decode_steps"],
          f"serving_lora: paged_decode launched {first['k2_launches']} times "
          f"over {first['decode_steps']} decode steps")
    check(second["tokens"] == first["tokens"],
          "serving_lora: second run gave other tokens")
    check(all(f == "length" for f in first["finish"]),
          f"serving_lora: finish reasons {first['finish']}")
    errs = {}
    for i, lora in enumerate(adapters):
        rows = [j for j, a in enumerate(which) if a == i]
        merged = merge_lora(params, lora, LORA_SCALE)
        errs[i] = first_token_err(merged, cfg, [prompts[j] for j in rows],
                                  [first["first_logits"][j] for j in rows])
        del merged
    base_rows = [j for j, a in enumerate(which) if a is None]
    base_err = first_token_err(params, cfg, [prompts[j] for j in base_rows],
                               [first["first_logits"][j] for j in base_rows])
    worst = max(errs.values())
    check(worst <= PATH_LOGIT_TOL,
          f"serving_lora: adapter rows vs merged forward, rel err {errs}")
    check(base_err <= PATH_LOGIT_TOL,
          f"serving_lora: base rows vs one-shot forward, rel err {base_err}")
    # the adapters act: an adapter row's first token logits differ from
    # the base model's on the same prompt
    moved = first_token_err(params, cfg, [prompts[0]], [first["first_logits"][0]])
    check(moved > 1e-3, f"serving_lora: adapter 0 moved the logits by {moved}")
    return {
        "phase": "serving_lora", "requests": len(requests),
        "adapters": len(adapters), "rank": LORA_RANK, "lora_scale": LORA_SCALE,
        "b_std": LORA_B_STD, "targets": ["wq", "wk", "wv", "wo"],
        "row_adapters": which, "prompt_lens": [len(p) for p in prompts],
        "k1_launches": first["k1_launches"], "k2_launches": first["k2_launches"],
        "decode_steps": first["decode_steps"], "second_run_identical": True,
        "adapter_rel_logit_err_vs_merged": errs,
        "base_rel_logit_err_vs_one_shot": base_err,
        "adapter_row_vs_base_model_rel_diff": moved,
        "tolerance": PATH_LOGIT_TOL,
        "tokens_per_s": sum(map(len, first["tokens"])) / first["wall_s"],
        "ttft_p50_ms": float(np.median(first["ttft_s"])) * 1e3,
        "decode_step_p50_ms": float(np.median(first["decode_only_step_ms"])),
    }


def watch_speculation(gamma: int, window):
    """A ``serve`` setup that records each speculative round (batch-wide)
    and checks that every greedy row's committed tokens are the argmax of
    its verify logits, read off the verify window itself (``window`` is the
    unwrapped ``decode_window_paged``; the caller puts it back)."""
    def setup(batcher):
        seen = {"rounds": 0, "commits": 0, "accepted": 0, "checked": 0,
                "mismatches": 0}
        last = {}

        def verify(params, tokens, *args, **kwargs):
            logits, cache = window(params, tokens, *args, **kwargs)
            if tokens.shape == (batcher.current.shape[0], gamma + 1):
                last["pred"] = logits.argmax(-1).cpu().numpy()
            return logits, cache

        for name in ("_step_speculative", "_commit_row"):
            inner = getattr(batcher, name)

            def wrapped(*args, inner=inner, name=name, **kwargs):
                if name == "_step_speculative":
                    seen["rounds"] += 1
                else:
                    row, commit, n, _ = args
                    seen["commits"] += 1
                    seen["accepted"] += n
                    if batcher.row_sampling[row].temperature == 0:
                        seen["checked"] += 1
                        pred = last["pred"][row, :len(commit)].tolist()
                        seen["mismatches"] += pred != list(commit)
                return inner(*args, **kwargs)

            setattr(batcher, name, wrapped)
        transformer.decode_window_paged = verify
        return seen

    return setup


def speculate(params, cfg, requests, draft, dcfg, gamma) -> dict:
    window = transformer.decode_window_paged
    try:
        run = serve(params, cfg, requests, setup=watch_speculation(gamma, window),
                    draft_params=draft, draft_config=dcfg, gamma=gamma)
    finally:
        transformer.decode_window_paged = window
    run["spec"] = run["setup"]
    return run


def serving_speculative(params, cfg) -> dict:
    """Speculative serving at gamma 4: (a) the target as its own draft,
    greedy; (b) a draft with Llama-3.2-3B's published shapes, greedy; (c)
    two seeded sampled requests through rejection sampling, twice. Target
    K1 32 an admission, no target K2 (the verify is a window); draft K1 an
    admission, draft K2 every draft step."""
    dev = params["embed"].device
    gamma, n_layers = SPEC_GAMMA, cfg.n_layers
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 513, size=8)]
    greedy = [(p, 32, SamplingParams(), {}) for p in prompts]
    plain = serve(params, cfg, greedy)
    out = {"phase": "serving_speculative", "layers": n_layers,
           "gamma": gamma, "requests": 8,
           "prompt_lens": [len(p) for p in prompts], "new_tokens": 32,
           "plain": {"tokens_per_s": sum(map(len, plain["tokens"])) / plain["wall_s"],
                     "decode_steps": plain["decode_steps"]}}
    # the paged decode kernel on; the draft cut as deep as the target is
    dcfg3 = dataclasses.replace(cfg, **{
        **DRAFT_3B, "n_layers": DRAFT_3B["n_layers"] * cfg.n_layers // 32})
    draft3 = init_params(dcfg3, torch.Generator(device=dev).manual_seed(18), dev)
    cases = (("self_draft", params, cfg, greedy),
             ("llama3_2_3b_draft", draft3, dcfg3, greedy),
             ("sampled", params, cfg,
              [(prompts[i], 32, SamplingParams(temperature=0.8, top_k=50,
                                               seed=200 + i), {})
               for i in range(2)]))
    for name, draft, dcfg, reqs in cases:
        run = speculate(params, cfg, reqs, draft, dcfg, gamma)
        spec, d_layers, n_req = run["spec"], dcfg.n_layers, len(reqs)
        check(run["k1_launches"] == (n_layers + d_layers) * n_req,
              f"serving_speculative {name}: flash_fwd launched "
              f"{run['k1_launches']} times, expected ({n_layers} + {d_layers})"
              f" x {n_req} admissions")
        check(run["decode_steps"] == gamma * spec["rounds"]
              and run["k2_launches"] == d_layers * run["decode_steps"],
              f"serving_speculative {name}: paged_decode launched "
              f"{run['k2_launches']} times over {run['decode_steps']} draft "
              f"steps in {spec['rounds']} rounds")
        check(spec["mismatches"] == 0,
              f"serving_speculative {name}: {spec['mismatches']} of "
              f"{spec['checked']} commits are not the verify argmax")
        check(all(f == "length" for f in run["finish"])
              and all(len(t) == 32 for t in run["tokens"]),
              f"serving_speculative {name}: finish reasons {run['finish']}")
        entry = {
            "draft_layers": d_layers, "k1_launches": run["k1_launches"],
            "k2_launches": run["k2_launches"], "draft_steps": run["decode_steps"],
            "rounds": spec["rounds"], "row_commits": spec["commits"],
            "acceptance_rate": spec["accepted"] / (gamma * spec["commits"]),
            "tokens_per_row_commit": sum(map(len, run["tokens"])) / spec["commits"],
            "greedy_commits_checked": spec["checked"],
            "tokens_per_s": sum(map(len, run["tokens"])) / run["wall_s"],
            "ttft_p50_ms": float(np.median(run["ttft_s"])) * 1e3,
        }
        if name == "sampled":
            again = speculate(params, cfg, reqs, draft, dcfg, gamma)
            check(again["tokens"] == run["tokens"],
                  "serving_speculative sampled: second run gave other tokens")
            entry["second_run_identical"] = True
        else:
            entry["greedy_agreement_with_plain"] = token_agreement(
                run["tokens"], plain["tokens"], range(8))
        out[name] = entry
        out.setdefault("k1_launches", 0)
        out.setdefault("k2_launches", 0)
        out["k1_launches"] += run["k1_launches"]
        out["k2_launches"] += run["k2_launches"]
        del run
    del draft3
    out["draft_config"] = DRAFT_3B
    return out


def serving_snapshot(params, cfg, requests) -> dict:
    """main_path's traffic (its prompts and sampling, logprobs on): 8 engine
    steps, a pickled snapshot, then the run to its end; a fresh engine and
    batcher load the snapshot and run to the end too. Tokens and logprobs
    must be bitwise equal, and the load must keep the pool's storage."""
    requests = [(p, n, dataclasses.replace(s, logprobs=True), kw)
                for p, n, s, kw in requests]

    def make():
        return Engine(ContinuousBatcher(params, cfg, max_batch=8, page_size=16,
                                        max_pages_per_seq=128,
                                        n_pages=1 + 8 * 128))

    fa.FLASH_FWD.launches = 0
    pa.PAGED_DECODE.launches = 0
    engine = make()
    tickets = [engine.submit(p, n, sampling=s, **kw) for p, n, s, kw in requests]
    for _ in range(SNAPSHOT_AFTER_STEPS):
        engine.step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    blob = pickle.dumps(engine.state_dict())
    save_s = time.perf_counter() - t
    engine.run_to_completion()
    want = ([engine.result(tk) for tk in tickets],
            [engine.result_logprobs(tk) for tk in tickets])
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    fresh = make()
    ptrs = {k: x.data_ptr() for k, x in fresh.batcher.cache.items()}
    torch.cuda.synchronize()
    t = time.perf_counter()
    fresh.load_state_dict(pickle.loads(blob))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    check({k: x.data_ptr() for k, x in fresh.batcher.cache.items()} == ptrs,
          "serving_snapshot: load_state_dict moved the pool")
    fresh.run_to_completion()
    got = ([fresh.result(tk) for tk in tickets],
           [fresh.result_logprobs(tk) for tk in tickets])
    check(got[0] == want[0], "serving_snapshot: resumed tokens differ")
    check(got[1] == want[1], "serving_snapshot: resumed logprobs differ")
    check(all(fresh.finish_reason(tk) == "length" for tk in tickets),
          "serving_snapshot: finish reasons")
    return {
        "phase": "serving_snapshot", "layers": cfg.n_layers,
        "requests": len(requests),
        "snapshot_after_steps": SNAPSHOT_AFTER_STEPS,
        "tokens_bitwise_equal": True, "logprobs_bitwise_equal": True,
        "pool_storage_kept": True, "pickled_mb": len(blob) / 1e6,
        "state_dict_and_pickle_s": save_s, "unpickle_and_load_s": load_s,
        "k1_launches": fa.FLASH_FWD.launches,
        "k2_launches": pa.PAGED_DECODE.launches,
    }


def beam_phase(params, cfg) -> dict:
    """``beam_search`` at B=1, a 256-token prompt, beam 4, 16 new tokens,
    twice, and at beam 1 against ``generate_cached``'s greedy tokens."""
    dev = params["embed"].device
    prompt = torch.as_tensor(
        np.random.default_rng(19).integers(0, cfg.vocab_size, (1, 256)),
        device=dev)
    fa.FLASH_FWD.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    seqs, scores = beam_search(params, cfg, prompt, max_new_tokens=16,
                               beam_size=4, return_all=True)
    torch.cuda.synchronize()
    beam_s = time.perf_counter() - t
    k1 = fa.FLASH_FWD.launches
    check(k1 == cfg.n_layers, f"beam_search: flash_fwd launched {k1} times")
    seqs2, scores2 = beam_search(params, cfg, prompt, max_new_tokens=16,
                                 beam_size=4, return_all=True)
    check(torch.equal(seqs, seqs2) and torch.equal(scores, scores2),
          "beam_search: two runs differ")
    check(bool((torch.diff(scores, dim=1) <= 0).all()),
          f"beam_search: beams not sorted: {scores.tolist()}")
    check(bool(torch.equal(seqs[0, :, :256], prompt.expand(4, 256))),
          "beam_search: a beam lost the prompt")
    one = beam_search(params, cfg, prompt, max_new_tokens=16, beam_size=1)
    greedy = transformer.Transformer(cfg).generate_cached(params, prompt, 16)
    check(torch.equal(one, greedy),
          "beam_search: beam_size=1 differs from generate_cached greedy")
    return {"phase": "beam_search", "B": 1, "L": 256, "beam_size": 4,
            "new_tokens": 16, "k1_launches": k1, "scores": scores[0].tolist(),
            "two_runs_identical": True, "beam_one_equals_greedy": True,
            "best_beam_agreement_with_greedy": float(
                (seqs[0, 0, 256:] == greedy[0, 256:]).float().mean()),
            "seconds": beam_s}


def speculative_generate_phase(params, cfg) -> dict:
    """``speculative_generate`` on beam_search's prompt, the target as its
    own draft, gamma 4, 32 tokens, against ``generate_cached`` greedy."""
    dev = params["embed"].device
    prompt = torch.as_tensor(
        np.random.default_rng(19).integers(0, cfg.vocab_size, (1, 256)),
        device=dev)
    fa.FLASH_FWD.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = speculative_generate(params, cfg, params, cfg, prompt,
                               max_new_tokens=32, gamma=SPEC_GAMMA)
    torch.cuda.synchronize()
    spec_s = time.perf_counter() - t
    k1 = fa.FLASH_FWD.launches
    check(k1 == 2 * cfg.n_layers,
          f"speculative_generate: flash_fwd launched {k1} times, expected "
          f"{2 * cfg.n_layers} (target and draft prefill)")
    check(tuple(got.shape) == (1, 288) and torch.equal(got[:, :256], prompt),
          "speculative_generate: wrong output")
    t = time.perf_counter()
    greedy = transformer.Transformer(cfg).generate_cached(params, prompt, 32)
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t
    return {"phase": "speculative_generate", "B": 1, "L": 256, "gamma": SPEC_GAMMA,
            "new_tokens": 32, "k1_launches": k1,
            "greedy_agreement": float((got[0, 256:] == greedy[0, 256:])
                                      .float().mean()),
            "seconds": spec_s, "generate_cached_seconds": greedy_s}


# ------------------------------------------------------------ observability


def serving_bench(params, cfg) -> dict:
    """``run_serving_bench`` on main_path's weights (``BENCH``): the
    instrumented arm (registry, ServingMonitor, DeviceMonitor) against the
    bare one. The arms must decode the same tokens (the bench raises
    otherwise); K1 must run once per layer and admission and K2 once per
    layer and decode step, over both arms' passes; the HBM rows must be the
    allocator's (live bytes at least the weights and one pool) with the
    card's total as limit. ``overhead_ok`` is printed, not enforced."""
    dev = params["embed"].device
    instruments: dict = {}
    fa.FLASH_FWD.launches = 0
    pa.PAGED_DECODE.launches = 0
    steps, undo = count_decode_steps()
    t = time.perf_counter()
    try:
        out = run_serving_bench(config=cfg, params=params, device=dev,
                                instruments=instruments, **BENCH)
    finally:
        undo()
    seconds = time.perf_counter() - t
    k1, k2, n_steps = fa.FLASH_FWD.launches, pa.PAGED_DECODE.launches, steps[0]
    passes = 2 + 2 * BENCH["repeats"] * BENCH["inner"]  # warm-ups + rounds
    admissions = BENCH["n_requests"] * passes
    check(k1 == cfg.n_layers * admissions,
          f"serving_bench: flash_fwd launched {k1} times, expected "
          f"{cfg.n_layers} x {admissions} admissions")
    check(n_steps > 0 and k2 == cfg.n_layers * n_steps,
          f"serving_bench: paged_decode launched {k2} times over {n_steps} "
          "decode steps")
    registry = instruments["registry"]
    device = instruments["device_monitor"]
    rows = device.sample_memory()
    _, engine = instruments["engines"]
    pool_bytes = sum(x.numel() * x.element_size()
                     for x in engine.batcher.cache.values())
    param_bytes = sum(w.numel() * w.element_size()
                      for w in transformer.param_leaves(params))
    total = torch.cuda.mem_get_info(dev)[1]
    row = next(r for r in rows if r["device"] == f"gpu:{dev.index}")
    check(not row["estimated"] and row["platform"] == "gpu",
          f"serving_bench: memory row {row}")
    check(row["live_bytes"] >= param_bytes + pool_bytes,
          f"serving_bench: live {row['live_bytes']} B under the weights' "
          f"{param_bytes} B and the pool's {pool_bytes} B")
    check(row["limit_bytes"] == total,
          f"serving_bench: limit {row['limit_bytes']} != mem_get_info {total}")
    snap = device.snapshot()
    step_records = instruments["serving_monitor"].snapshot(steps=512)
    step_ms = [r["duration_ms"] for r in step_records["steps"]["last"]
               if r["decode_tokens"] and not r["prefill_tokens"]]
    hbm = registry.metrics["bci_device_hbm_bytes"]
    return {
        "phase": "serving_bench", **BENCH, "layers": cfg.n_layers,
        "result": out,
        "passes": passes, "admissions": admissions, "decode_steps": n_steps,
        "k1_launches": k1, "k2_launches": k2,
        "serving_step_seconds_count":
            registry.metrics["bci_serving_step_seconds"]._totals[()],
        "instrumented_step_p50_ms": float(np.median(step_ms)),
        "compile_total_by_trigger": snap["compile"]["by_trigger"],
        "first_calls": [(r["function"], r["trigger"], r["duration_ms"])
                        for r in snap["compile"]["recent"]],
        "hbm_gauges": {f"{dict(k)['device']}/{dict(k)['kind']}": fn()
                       for k, fn in hbm._fns.items()},
        "memory_row": row, "param_bytes": param_bytes,
        "pool_bytes": pool_bytes, "mem_get_info_total": total,
        "seconds": seconds,
    }


def serving_profile(params, cfg) -> dict:
    """A ``ServingProfiler`` over a monitored engine on main_path's weights
    and batcher geometry: 8 requests (``BENCH``'s prompts, 16 new tokens)
    admitted and decoding, then ``PROFILE_STEPS`` decode steps captured with
    CUDA activity. The
    Chrome trace must hold K2's split kernel (``paged_decode_mma_kernel``,
    or ``paged_decode_kernel`` off the tensor-core path) once per layer and
    captured step, and its merge (``paged_merge_kernel``) as often when the
    table is split."""
    registry = Registry()
    recorder = FlightRecorder(metrics=registry)
    monitor = ServingMonitor(metrics=registry, store=TraceStore(),
                             recorder=recorder)
    # main_path's geometry: a table of 128 pages, which K2 splits
    ps, pages, new = 16, 128, 16
    batcher = ContinuousBatcher(params, cfg, max_batch=8, page_size=ps,
                                max_pages_per_seq=pages,
                                n_pages=1 + 8 * pages, metrics=registry,
                                device=params["embed"].device)
    engine = Engine(batcher, metrics=registry)
    monitor.attach(engine)
    DeviceMonitor(metrics=registry, recorder=recorder).attach(engine)
    prompts = [np.random.default_rng(i).integers(
        0, cfg.vocab_size, BENCH["prompt_len"] + i % 3, dtype=np.int32)
        for i in range(8)]
    fa.FLASH_FWD.launches = 0
    pa.PAGED_DECODE.launches = 0
    tickets = [engine.submit(p, new) for p in prompts]
    engine.step()  # admits all 8 (K1) and decodes once
    engine.step()
    check(int(batcher.active.sum()) == 8, "serving_profile: rows not active")
    k2_before = pa.PAGED_DECODE.launches
    out = ServingProfiler(monitor).capture(PROFILE_STEPS)
    k2_captured = pa.PAGED_DECODE.launches - k2_before
    trace = json.loads(Path(out["trace_dir"], "trace.json").read_text())
    shutil.rmtree(out["trace_dir"], ignore_errors=True)
    kernels = [e["name"] for e in trace["traceEvents"]
               if e.get("cat") == "kernel"]

    def count(*names):
        return sum(1 for k in kernels if any(n in k for n in names))

    split = count("paged_decode_mma_kernel", "paged_decode_kernel")
    merge = count("paged_merge_kernel")
    want = cfg.n_layers * PROFILE_STEPS
    n_split = -(-pages // pa.split_pages(
        8, cfg.kv_heads, pages, ps,
        torch.cuda.get_device_properties(0).multi_processor_count))
    seen = sorted({k[:80] for k in kernels})
    check(split == want and k2_captured == want,
          f"serving_profile: {split} paged decode kernels in the trace and "
          f"{k2_captured} launches, expected {want}; kernels seen: "
          f"{seen[:40]}")
    check(merge == (want if n_split > 1 else 0),
          f"serving_profile: {merge} merge kernels, {n_split} splits")
    engine.run_to_completion()
    check(all(len(engine.result(t)) == new for t in tickets),
          "serving_profile: wrong result lengths")
    return {
        "phase": "serving_profile", "requests": 8, "new_tokens": new,
        "steps_captured": out["steps"], "capture_ms": out["duration_ms"],
        "files": out["files"], "kernel_events": len(kernels),
        "paged_decode_events": split, "paged_merge_events": merge,
        "splits": n_split, "expected_per_kernel": want,
        "k1_launches": fa.FLASH_FWD.launches,
        "k2_launches": pa.PAGED_DECODE.launches,
        "step_records": monitor.snapshot()["steps"]["recorded"],
    }


# ------------------------------------------------------- Mixture-of-Experts


def moe_config(n_layers: int, **kw) -> TransformerConfig:
    """``TransformerConfig.mixtral_8x7b()`` widths (vocab 32000, d 4096,
    32/8 heads, d_ff 14336, 8 experts, top-2) cut to ``n_layers``."""
    return dataclasses.replace(TransformerConfig.mixtral_8x7b(),
                               n_layers=n_layers, paged_attention_kernel=True,
                               **kw)


class AuxLog:
    """Records the aux loss of each pass over the layers
    (``transformer._trunk``: ``loss_fn`` makes one) while installed."""

    def __init__(self) -> None:
        self.values: list[float] = []
        self._trunk = transformer._trunk

        def logged(*args, **kwargs):
            out = self._trunk(*args, **kwargs)
            self.values.append(out[2].item())
            return out

        transformer._trunk = logged

    def close(self) -> None:
        transformer._trunk = self._trunk


class RoutingLog:
    """Records each ``moe._route_group`` call's experts ``[G, k]`` (sorted
    per token, so a set compares as a set) while installed."""

    def __init__(self) -> None:
        self.calls: list[torch.Tensor] = []
        self._route = moe._route_group

        def logged(*args, **kwargs):
            r = self._route(*args, **kwargs)
            self.calls.append(r.expert.reshape(-1, r.expert.shape[-1])
                              .sort(dim=-1).values.cpu())
            return r

        moe._route_group = logged

    def close(self) -> None:
        moe._route_group = self._route


def routing_agreement(a: list, b: list) -> tuple[float, list]:
    """Share of (token, layer) expert sets equal between two logs of the
    same calls, and the per-call [G] masks of tokens that flipped."""
    check(len(a) == len(b) and all(x.shape == y.shape for x, y in zip(a, b)),
          "routing logs of different calls")
    flips = [(x != y).any(dim=-1) for x, y in zip(a, b)]
    total = sum(f.numel() for f in flips)
    return 1.0 - sum(int(f.sum()) for f in flips) / total, flips


def moe_reference(dev) -> dict:
    """Mixtral widths cut to 2 layers, bf16 on the card (K1 prefills, K2
    decode steps) against the f32 plain path on the CPU on the same
    weights: teacher-forced logits of two prompts (padded to 112 and 32
    tokens: the routed and the every-expert form) and 6 decode steps, and
    the aux loss of a 256-token forward. A bf16 router can put a token
    whose 2nd and 3rd experts nearly tie on the other one; the logit error
    is held at the positions whose own routing agreed in every layer, and
    the routing agreement is reported and held above 0.9."""
    cfg = moe_config(MOE_REFERENCE_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(30))
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (100, 23)]
    feed = rng.integers(0, cfg.vocab_size, (2, 6))
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 256)))

    def run(tree, c, d):
        log = RoutingLog()
        try:
            got = teacher_forced_logits(tree, c, d, prompts, feed)
            aux = transformer.forward(tree, tokens.to(d), c,
                                      return_aux=True)[1].item()
        finally:
            log.close()
        return got, aux, log.calls

    fa.FLASH_FWD.launches = 0
    pa.PAGED_DECODE.launches = 0
    card, aux_card, calls_card = run(params, cfg, dev)
    launches = (fa.FLASH_FWD.launches, pa.PAGED_DECODE.launches)
    cpu, aux_cpu, calls_cpu = run(cpu_f32(params), dataclasses.replace(
        cfg, dtype=torch.float32), torch.device("cpu"))
    agree, flips = routing_agreement(calls_card, calls_cpu)
    # calls: each prompt's forward (a call a layer), then each decode step;
    # then the aux forward. A position flipped when its own token did.
    n_l = cfg.n_layers
    own = torch.zeros(card.shape[:2], dtype=torch.bool)
    for b, prompt in enumerate(prompts):
        for li in range(n_l):
            own[b, 0] |= flips[b * n_l + li][len(prompt) - 1]
    for s in range(feed.shape[1]):
        for li in range(n_l):
            own[:, 1 + s] |= flips[(len(prompts) + s) * n_l + li]
    err = (card - cpu).abs().amax(dim=-1) / cpu.abs().max()  # [B, positions]
    held = err[~own]
    rel = held.max().item() if held.numel() else float("nan")
    aux_rel = abs(aux_card - aux_cpu) / abs(aux_cpu)
    check(bool(torch.isfinite(card).all()), "moe_reference: non-finite logits")
    check(agree >= 0.9, f"moe_reference: routing agreement {agree}")
    check(rel <= REFERENCE_TOL, f"moe_reference: relative logit error {rel}")
    check(aux_rel <= MOE_AUX_TOL, f"moe_reference: aux rel err {aux_rel}")
    want_k1 = (len(prompts) + 1) * n_l
    check(launches == (want_k1, n_l * feed.shape[1]),
          f"moe_reference: K1/K2 launched {launches}")
    return {"phase": "moe_reference", "config": "mixtral_8x7b",
            "layers": n_l, "prompt_lens": [len(p) for p in prompts],
            "decode_steps": feed.shape[1],
            "rel_max_logit_err": rel,
            "rel_max_logit_err_all_positions": err.max().item(),
            "positions_with_own_routing_flip": int(own.sum()),
            "routing_agreement": agree,
            "argmax_agreement": (card.argmax(-1) == cpu.argmax(-1))
            .float().mean().item(),
            "aux_card": aux_card, "aux_cpu": aux_cpu, "aux_rel_err": aux_rel,
            "k1_launches": launches[0], "k2_launches": launches[1],
            "tolerance": {"logits": REFERENCE_TOL, "aux": MOE_AUX_TOL,
                          "routing_agreement": 0.9}}


def serve_report(name, cfg, run, requests, n_params) -> dict:
    generated = sum(len(t) for t in run["tokens"])
    return {
        "phase": name, "config": "mixtral_8x7b", "dtype": "bfloat16",
        "layers": cfg.n_layers, "layers_cut_from": 32,
        "n_params": n_params, "requests": len(requests),
        "prompt_lens": [len(p) for p, _, _, _ in requests],
        "tokens_per_s": generated / run["wall_s"], "wall_s": run["wall_s"],
        "ttft_p50_ms": float(np.median(run["ttft_s"])) * 1e3,
        "decode_step_p50_ms": (float(np.median(run["decode_only_step_ms"]))
                               if run["decode_only_step_ms"] else None),
        "decode_only_steps": len(run["decode_only_step_ms"]),
        "decode_steps": run["decode_steps"],
        "weight_stream_bound_ms": 2.0 * n_params / HBM_BYTES_PER_S * 1e3,
        "k1_launches": run["k1_launches"], "k2_launches": run["k2_launches"],
    }


def serving_moe(params, cfg) -> dict:
    """main_path's traffic and batcher settings on Mixtral widths cut to
    ``MOE_SERVE_LAYERS``, capacity routing at JAX's defaults (factor 1.25,
    groups of 1024): K1 once per layer and admission, K2 once per layer
    and decode step."""
    requests = main_requests(cfg.vocab_size)
    run = serve(params, cfg, requests)
    n_l = cfg.n_layers
    check(all(f == "length" for f in run["finish"]),
          f"serving_moe: finish reasons {run['finish']}")
    check(all(len(t) == 32 and all(0 <= x < cfg.vocab_size for x in t)
              for t in run["tokens"]), "serving_moe: wrong results")
    check(run["k1_launches"] == n_l * len(requests),
          f"serving_moe: flash_fwd launched {run['k1_launches']} times")
    check(run["decode_steps"] > 0
          and run["k2_launches"] == n_l * run["decode_steps"],
          f"serving_moe: paged_decode launched {run['k2_launches']} times "
          f"over {run['decode_steps']} decode steps")
    report = serve_report("serving_moe", cfg, run, requests,
                          transformer.n_params(params))
    report.update(capacity_factor=cfg.moe_capacity_factor,
                  group_size=cfg.moe_group_size, max_batch=8)
    return report


def batch_composition_probe(params, cfg) -> dict:
    """The same 256-token prompt alone and beside another in one forward
    (B=1 against B=2): max |logit change| over max |logit|, and the
    (token, layer) expert sets that changed. Dropless per-token routing
    sees no batch-mate, so a routing change can only follow a change of
    the token's own hidden state, i.e. of the GEMMs' reduction order."""
    dev = params["embed"].device
    rng = np.random.default_rng(33)
    pair = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 256)),
                           device=dev)
    logs = []
    for tokens in (pair[:1], pair):
        log = RoutingLog()
        try:
            logits = transformer.forward(params, tokens, cfg)[0].float()
        finally:
            log.close()
        logs.append((logits, [c[:256] for c in log.calls]))
    (solo, solo_calls), (batch, batch_calls) = logs
    agree, _ = routing_agreement(solo_calls, batch_calls)
    return {"logit_change": ((batch - solo).abs().max()
                             / solo.abs().max()).item(),
            "logits_bitwise_equal": bool(torch.equal(batch, solo)),
            "routing_agreement": agree}


def serving_moe_exact(params, cfg) -> dict:
    """The same weights under dropless per-token routing (``moe_exact``):
    4 greedy requests of main_path's traffic served batched and each alone,
    token agreement reported (exact on the TPU; cuBLAS may order a batched
    product's sums otherwise than a solo one's); a shared-prefix pair with
    the prefix cache on (a hit); and the batch-composition probe."""
    exact = dataclasses.replace(cfg, moe_dropless=True, moe_group_size=1)
    check(exact.moe_exact, "serving_moe_exact: config is not moe_exact")
    greedy = [r for r in main_requests(cfg.vocab_size) if r[2].temperature == 0]
    requests = greedy[:MOE_EXACT_REQUESTS]
    batched = serve(params, exact, requests)
    k1, k2 = batched["k1_launches"], batched["k2_launches"]
    solo = []
    for req in requests:
        run = serve(params, exact, [req])
        solo.append(run["tokens"][0])
        k1, k2 = k1 + run["k1_launches"], k2 + run["k2_launches"]
    pairs = [(a, b) for t, s in zip(batched["tokens"], solo)
             for a, b in zip(t, s)]
    agreement = sum(a == b for a, b in pairs) / len(pairs)
    rng = np.random.default_rng(32)
    shared = rng.integers(0, cfg.vocab_size, 512).tolist()
    tails = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (40, 72)]
    prefix_reqs = [(shared + t, 32, SamplingParams(), {}) for t in tails]
    cached = serve(params, exact, prefix_reqs, prefix_cache=True)
    k1, k2 = k1 + cached["k1_launches"], k2 + cached["k2_launches"]
    check(cached["prefix_stats"]["hits"] >= 1,
          f"serving_moe_exact: prefix stats {cached['prefix_stats']}")
    check(all(len(t) == 32 for t in batched["tokens"] + solo
              + cached["tokens"]), "serving_moe_exact: wrong result lengths")
    report = serve_report("serving_moe_exact", exact, batched, requests,
                          transformer.n_params(params))
    report.update(
        moe_dropless=True, group_size=1,
        batched_vs_solo_token_agreement=agreement,
        batched_vs_solo_streams_equal=[t == s for t, s in
                                       zip(batched["tokens"], solo)],
        prefix_stats=cached["prefix_stats"],
        batch_composition=batch_composition_probe(params, exact),
        k1_launches=k1, k2_launches=k2)
    return report


def train_moe(dev) -> dict:
    """``Transformer.make_train_step`` at Mixtral widths cut to
    ``MOE_TRAIN_LAYERS`` (f32 masters, bf16 compute, capacity routing), one
    fixed batch of 2 x 1024 tokens, 4 steps: loss and aux each step, a
    finite aux > 0, K1/K3/K4 once per layer and step. First, at a 1-layer
    L=128 cut, the first step's loss, aux and router gradient norm against
    the f32 plain path on the CPU."""
    ref = moe_train_reference(dev)
    cfg = moe_config(MOE_TRAIN_LAYERS)
    model = transformer.Transformer(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(34), dev)
    step = model.make_train_step()
    batch = token_batch(np.random.default_rng(6), cfg, TRAIN_B, TRAIN_L, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kernel in (fa.FLASH_FWD, fa.FLASH_BWD_DKDV, fa.FLASH_BWD_DQ):
        kernel.launches = 0
    opt_state, losses, step_ms = None, [], []
    aux_log = AuxLog()
    try:
        for _ in range(TRAIN_STEPS):
            t = time.perf_counter()
            params, opt_state, loss = step(params, opt_state, batch)
            losses.append(loss.item())  # waits for the step
            step_ms.append((time.perf_counter() - t) * 1e3)
    finally:
        aux_log.close()
    auxes = aux_log.values
    launches = {"flash_fwd": fa.FLASH_FWD.launches,
                "flash_bwd_dkdv": fa.FLASH_BWD_DKDV.launches,
                "flash_bwd_dq": fa.FLASH_BWD_DQ.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)), f"train_moe: losses {losses}")
    check(len(auxes) == TRAIN_STEPS and all(np.isfinite(a) and a > 0
                                            for a in auxes),
          f"train_moe: aux {auxes}")
    check(losses[-1] < losses[0], f"train_moe: loss did not fall: {losses}")
    want = MOE_TRAIN_LAYERS * TRAIN_STEPS
    check(all(n == want for n in launches.values()),
          f"train_moe: launches {launches}, expected {want} each")
    return {
        "phase": "train_moe", "config": "mixtral_8x7b",
        "layers": MOE_TRAIN_LAYERS, "layers_cut_from": 32,
        "dtype": "bfloat16 compute, float32 masters", "B": TRAIN_B,
        "L": TRAIN_L, "steps": TRAIN_STEPS,
        "n_params": transformer.n_params(params), "losses": losses,
        "aux": auxes, "step_ms": step_ms,
        "step_ms_p50_2_to_4": float(np.median(step_ms[1:])),
        "peak_memory_gb": peak_gb, "launches": launches, "reference": ref,
    }


def moe_train_reference(dev) -> dict:
    cfg = moe_config(1)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(35),
                         dev, dtype=torch.float32, requires_grad=True)
    batch = token_batch(np.random.default_rng(36), cfg, 1, 128, dev)
    out = []
    for tree, c, b in (
        (params, cfg, batch),
        (cpu_f32(params, requires_grad=True),
         dataclasses.replace(cfg, dtype=torch.float32),
         {k: x.cpu() for k, x in batch.items()}),
    ):
        aux_log, log = AuxLog(), RoutingLog()
        try:
            loss = transformer.loss_fn(tree, b, c)
        finally:
            aux_log.close()
            log.close()
        loss.backward()
        router = tree["layers"][0]["moe"]["router"].grad
        out.append((loss.item(), aux_log.values[0],
                    torch.linalg.vector_norm(router).item(), log.calls))
    (loss, aux, gnorm, calls), (loss_cpu, aux_cpu, gnorm_cpu, calls_cpu) = out
    agree, _ = routing_agreement(calls, calls_cpu)
    rel = {"loss": abs(loss - loss_cpu) / abs(loss_cpu),
           "aux": abs(aux - aux_cpu) / abs(aux_cpu),
           "router_grad_norm": abs(gnorm - gnorm_cpu) / gnorm_cpu}
    tol = {"loss": TRAIN_LOSS_TOL, "aux": MOE_AUX_TOL,
           "router_grad_norm": TRAIN_GRAD_TOL}
    check(all(rel[k] <= tol[k] for k in rel),
          f"train_moe reference: rel errors {rel}, limits {tol}")
    return {"layers": 1, "B": 1, "L": 128, "loss_card": loss,
            "loss_cpu": loss_cpu, "aux_card": aux, "aux_cpu": aux_cpu,
            "router_grad_norm_card": gnorm, "router_grad_norm_cpu": gnorm_cpu,
            "routing_agreement": agree, "rel_err": rel, "tolerance": tol}


# ------------------------------------------------------------------ HF loader


def hf_load(dev) -> dict:
    """An HF-named Llama state dict built on the card from ``init_params``
    (Llama-3-8B widths, 2 layers, bf16), loaded by ``load_llama_params``:
    every leaf equal to its source bitwise, and the logits too."""
    cfg = dataclasses.replace(TransformerConfig.llama3_8b(), n_layers=2)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(37))
    names = {"ln1": "input_layernorm", "wq": "self_attn.q_proj",
             "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
             "wo": "self_attn.o_proj", "ln2": "post_attention_layernorm",
             "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj"}
    sd = {"model.embed_tokens.weight": params["embed"],
          "model.norm.weight": params["ln_f"],
          "lm_head.weight": params["lm_head"].t().contiguous()}
    for i, layer in enumerate(params["layers"]):
        for name, w in layer.items():
            sd[f"model.layers.{i}.{names[name]}.weight"] = (
                w if w.dim() == 1 else w.t().contiguous())
    hf_config = types.SimpleNamespace(
        vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
        num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_heads,
        num_key_value_heads=cfg.n_kv_heads, intermediate_size=cfg.d_ff,
        max_position_embeddings=cfg.max_seq_len, rope_theta=cfg.rope_theta,
        rms_norm_eps=1e-5, hidden_act="silu")
    torch.cuda.synchronize()
    t = time.perf_counter()
    loaded, loaded_cfg = load_llama_params(sd, hf_config, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    check(loaded_cfg == cfg, f"hf_load: config {loaded_cfg}")
    pairs = list(zip(transformer.param_leaves(loaded),
                     transformer.param_leaves(params)))
    check(all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs),
          "hf_load: a loaded leaf differs from its source")
    tokens = torch.as_tensor(np.random.default_rng(38).integers(
        0, cfg.vocab_size, (1, 256)), device=dev)
    fa.FLASH_FWD.launches = 0
    want = transformer.forward(params, tokens, cfg)
    got = transformer.forward(loaded, tokens, loaded_cfg)
    check(torch.equal(got, want), "hf_load: logits differ")
    return {"phase": "hf_load", "config": "llama3_8b", "layers": 2,
            "leaves": len(pairs), "leaves_bitwise_equal": True,
            "logits_bitwise_equal": True,
            "gb": sum(a.numel() * a.element_size() for a, _ in pairs) / 1e9,
            "load_s": load_s, "k1_launches": fa.FLASH_FWD.launches}


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


def lora_train(dev) -> dict:
    """Two ``make_lora_train_step`` steps at Llama-3-8B widths cut to
    ``LORA_TRAIN_LAYERS`` (B=1, L=128, f32 masters, one rank-16 adapter on
    wq/wk/wv/wo with B drawn non-zero): before each step, the loss and the
    factors' gradients of the f32 plain path on the CPU from the same
    factors, against the step's own on the card (bf16 compute, K1/K3/K4).
    The base must not move, bit for bit."""
    cfg = dataclasses.replace(TransformerConfig.llama3_8b(),
                              n_layers=LORA_TRAIN_LAYERS)
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(20), dev,
                         dtype=torch.float32)
    (lora,) = lora_adapters(cfg, dev, 1, LORA_RANK, seed=21)
    base = [w.clone() for w in transformer.param_leaves(params)]
    cpu = {name: w.cpu() for name, w in params.items() if name != "layers"}
    cpu["layers"] = [{k: w.cpu() for k, w in layer.items()}
                     for layer in params["layers"]]
    batch = token_batch(np.random.default_rng(22), cfg, 1, 128, dev)
    cpu_batch = {name: x.cpu() for name, x in batch.items()}
    step, _ = make_lora_train_step(cfg, scale=LORA_SCALE)
    for kernel in (fa.FLASH_FWD, fa.FLASH_BWD_DKDV, fa.FLASH_BWD_DQ):
        kernel.launches = 0
    state, losses, loss_rel, grad_rel = None, [], [], []
    for _ in range(LORA_TRAIN_STEPS):
        ref = {t: {k: x.detach().cpu().requires_grad_() for k, x in ab.items()}
               for t, ab in lora.items()}
        want = transformer.loss_fn(merge_lora(cpu, ref, LORA_SCALE), cpu_batch,
                                   f32)
        want_grads = torch.autograd.grad(want, lora_leaves(ref))
        lora, state, loss = step(lora, state, params, batch)
        losses.append(loss.item())
        loss_rel.append(abs(loss.item() - want.item()) / abs(want.item()))
        for w, g in zip(lora_leaves(lora), want_grads):
            diff = torch.linalg.vector_norm(w.grad.cpu() - g)
            grad_rel.append((diff / torch.linalg.vector_norm(g)).item())
    launches = {"flash_fwd": fa.FLASH_FWD.launches,
                "flash_bwd_dkdv": fa.FLASH_BWD_DKDV.launches,
                "flash_bwd_dq": fa.FLASH_BWD_DQ.launches}
    check(all(np.isfinite(grad_rel)), f"lora_train: grad errors {grad_rel}")
    check(max(loss_rel) <= TRAIN_LOSS_TOL, f"lora_train: loss rel err {loss_rel}")
    check(max(grad_rel) <= TRAIN_GRAD_TOL,
          f"lora_train: max grad rel err {max(grad_rel)}")
    check(all(torch.equal(w, b) and w.grad is None for w, b in
              zip(transformer.param_leaves(params), base)),
          "lora_train: the base moved or got a gradient")
    want_launches = LORA_TRAIN_LAYERS * LORA_TRAIN_STEPS
    check(all(n == want_launches for n in launches.values()),
          f"lora_train: launches {launches}, expected {want_launches} each")
    return {"phase": "lora_train", "layers": LORA_TRAIN_LAYERS, "B": 1,
            "L": 128, "steps": LORA_TRAIN_STEPS, "rank": LORA_RANK,
            "targets": ["wq", "wk", "wv", "wo"], "losses": losses,
            "loss_rel_err": loss_rel, "max_grad_rel_err": max(grad_rel),
            "grad_rel_err_by_leaf_and_step": grad_rel,
            "base_unchanged": True, "launches": launches,
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

def tp_split_qeinsum(spec: str, x, leaf, dtype):
    """``transformer.qeinsum`` with the roundings of a tp=``TP`` mesh, on
    one card: a row-parallel product (``wo``, ``w_down``) as ``TP`` bf16
    partial products over blocks of its contraction, added in f32 and
    rounded once (``all_reduce_partial``); a column-parallel one (``wq``,
    ``wk``, ``wv``, ``w_gate``, ``w_up``, ``lm_head``) as ``TP`` column
    blocks, so that its input's gradient is the sum of ``TP`` rounded
    partials, as ``copy_to_group``'s backward adds them. The blocks are the
    ranks' shards of ``shard_params`` (heads, K/V heads, d_ff and
    vocabulary in order)."""
    if spec in ("blk,kd->bld", "blf,fd->bld"):
        n = leaf.shape[0] // TP
        parts = [PLAIN_QEINSUM(spec, x[..., r * n:(r + 1) * n],
                               leaf[r * n:(r + 1) * n], dtype).float()
                 for r in range(TP)]
        return sum(parts[1:], parts[0]).to(dtype)
    if spec in ("bld,dk->blk", "bld,df->blf", "bld,dv->blv"):
        n = leaf.shape[1] // TP
        return torch.cat([PLAIN_QEINSUM(spec, x, leaf[:, r * n:(r + 1) * n],
                                        dtype) for r in range(TP)], dim=-1)
    return PLAIN_QEINSUM(spec, x, leaf, dtype)


PLAIN_QEINSUM = transformer.qeinsum


def train_tp_rounding_control(dev) -> dict:
    """train_path's masters, batch and steps on one card with tp=2's
    roundings (``tp_split_qeinsum`` in place of ``qeinsum``): the drift
    that tp's rounding alone makes, the yardstick of ``train_tp``'s later
    losses. Also each leaf's first gradient against one card's plain
    products on the same masters (train_tp's is held the same way)."""
    cfg = dataclasses.replace(TransformerConfig.llama3_8b(),
                              n_layers=TRAIN_LAYERS)
    model = transformer.Transformer(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(10), dev)
    batch = token_batch(np.random.default_rng(6), cfg, TRAIN_B, TRAIN_L, dev)
    leaves = transformer.param_leaves(params)
    transformer.loss_fn(params, batch, cfg).backward()
    plain = [w.grad for w in leaves]  # kept on the card until step 1's
    step = model.make_train_step()
    state, losses, first = None, [], []
    transformer.qeinsum = tp_split_qeinsum
    try:
        for i in range(TRAIN_STEPS):
            params, state, loss = step(params, state, batch)
            losses.append(loss.item())
            if i == 0:  # the step's gradients stay on the leaves
                first = [(torch.linalg.vector_norm(w.grad - g)
                          / torch.linalg.vector_norm(g)).item()
                         for w, g in zip(leaves, plain)]
                del plain
    finally:
        transformer.qeinsum = PLAIN_QEINSUM
    return {"phase": "train_tp_rounding_control", "layers": TRAIN_LAYERS,
            "B": TRAIN_B, "L": TRAIN_L, "tp_emulated": TP, "losses": losses,
            "first_grad_max_rel_err": max(first),
            "first_grad_rel_err_by_leaf": first}


# ------------------------------------- tensor-parallel and replicated serving


def transport() -> dict:
    """How this machine runs tp=2 and two replicas: with two cards or more,
    one rank and one replica per card, the ranks over NCCL; with one card,
    both ranks on card 0 over gloo (which stages CUDA tensors through host
    memory: it proves the sharded math, the kernels at the rank-local heads
    and the head-sharded pool, not NCCL), both replicas on card 0."""
    cards = torch.cuda.device_count()
    two = cards >= 2
    return {"world": TP, "backend": "nccl" if two else "gloo",
            "cards": cards,
            "replica_devices": ["cuda:0", "cuda:1"] if two
            else ["cuda:0", "cuda:0"]}


def rank_setup():
    """A spawned rank's start: TF32 off as in the parent, and the tp mesh
    over the spawned group. Returns (mesh, this rank's card)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh({"tp": TP}, device_type="cuda")
    return mesh, torch.device("cuda", torch.cuda.current_device())


def shard_shapes_ok(shard, full, cfg, mesh) -> bool:
    """Every leaf of a rank's shard has the shape ``param_specs`` gives it."""
    specs = param_specs(cfg, mesh)
    rows = [(shard[n], full[n], specs[n]) for n in ("embed", "ln_f", "lm_head")]
    rows += [(ls[n], lf[n], specs["layers"][n])
             for ls, lf in zip(shard["layers"], full["layers"]) for n in lf]
    return all(tuple(s.shape) == local_shape(f.shape, spec, mesh)
               for s, f, spec in rows)


def tp_reference_rank(rank, cfg, prompts, feed) -> dict:
    """One rank of ``tp_reference``: the seed-0 weights built in full on
    the rank's card, sharded, and the teacher-forced logits over the
    rank's shard and head-sharded pool."""
    mesh, dev = rank_setup()
    full = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    shard = shard_params(full, cfg, mesh)
    shapes_ok = shard_shapes_ok(shard, full, cfg, mesh)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    fa.FLASH_FWD.launches = 0
    pa.PAGED_DECODE.launches = 0
    logits = teacher_forced_logits(shard, cfg, dev, prompts, feed,
                                   tp_group(mesh))
    return {"logits": logits, "shapes_ok": shapes_ok,
            "k1_launches": fa.FLASH_FWD.launches,
            "k2_launches": pa.PAGED_DECODE.launches}


def tp_reference(dev, how) -> dict:
    """The decoder cut to 2 layers at Llama-3-8B widths, tp=2: each rank's
    prefill logits and 4 teacher-forced paged decode steps (K1 and K2 at
    the rank-local heads) against the unsharded bf16 path on the card and
    the f32 plain path on the CPU, on the same seed-0 weights."""
    cfg = dataclasses.replace(TransformerConfig.llama3_8b(), n_layers=2,
                              paged_attention_kernel=True)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (40, 23)]
    feed = rng.integers(0, cfg.vocab_size, (2, 4))
    ranks = spawn(tp_reference_rank, TP, device_type="cuda",
                  backend=how["backend"], args=(cfg, prompts, feed),
                  timeout=600)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    bf16 = teacher_forced_logits(params, cfg, dev, prompts, feed)
    f32 = teacher_forced_logits(
        cpu_f32(params), dataclasses.replace(cfg, dtype=torch.float32),
        torch.device("cpu"), prompts, feed)
    del params
    got = ranks[0]["logits"]

    def rel(want):
        return ((got - want).abs().max() / want.abs().max()).item()

    rel_bf16, rel_f32 = rel(bf16), rel(f32)
    n_layers, steps = cfg.n_layers, feed.shape[1]
    for r, rec in enumerate(ranks):
        check(rec["shapes_ok"], f"tp_reference: rank {r} shard shapes "
              "differ from param_specs'")
        check(torch.equal(rec["logits"], got),
              f"tp_reference: rank {r}'s logits differ from rank 0's")
        check(rec["k1_launches"] == n_layers * len(prompts)
              and rec["k2_launches"] == n_layers * steps,
              f"tp_reference: rank {r} launched K1 {rec['k1_launches']}, "
              f"K2 {rec['k2_launches']} times")
    check(bool(torch.isfinite(got).all()), "tp_reference: non-finite logits")
    check(rel_bf16 <= PATH_LOGIT_TOL,
          f"tp_reference: {rel_bf16} against the unsharded bf16 path")
    check(rel_f32 <= REFERENCE_TOL,
          f"tp_reference: {rel_f32} against the f32 CPU path")
    return {"phase": "tp_reference", **{k: how[k] for k in
                                        ("world", "backend", "cards")},
            "layers": n_layers, "heads_per_rank": list(TP_HEADS),
            "decode_steps": steps,
            "rel_max_logit_err_vs_bf16": rel_bf16,
            "rel_max_logit_err_vs_f32_cpu": rel_f32,
            "bf16_tolerance": PATH_LOGIT_TOL, "f32_tolerance": REFERENCE_TOL,
            "argmax_agreement_vs_bf16":
                (got.argmax(-1) == bf16.argmax(-1)).float().mean().item(),
            "ranks_identical": True, "shard_shapes_match_specs": True,
            "k1_launches_per_rank": [r["k1_launches"] for r in ranks],
            "k2_launches_per_rank": [r["k2_launches"] for r in ranks]}


def serving_tp_rank(rank, cfg) -> dict:
    """One rank of ``serving_tp``: the ranks build their batchers in turn
    (the full weights on the card, this rank's shard kept, the rest freed,
    then a barrier), then serve main_path's traffic twice on the same
    batcher, every rank the same submits and steps."""
    mesh, dev = rank_setup()
    requests = main_requests(cfg.vocab_size)
    batcher = None
    for turn in range(TP):
        if turn == rank:
            full = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               dev)
            batcher = ContinuousBatcher(full, cfg, mesh=mesh, **SERVE_GEOMETRY)
            del full
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated(dev)
    runs = [drive(batcher, requests) for _ in range(2)]
    keep = ("tokens", "finish", "k1_launches", "k2_launches", "decode_steps",
            "wall_s", "ttft_s", "decode_only_step_ms")
    return {
        "mesh_key": batcher._mesh_key,
        "live_bytes": live,
        "weight_bytes": sum(x.numel() * x.element_size()
                            for x in transformer.param_leaves(batcher.params)),
        "pool_bytes": sum(x.numel() * x.element_size()
                          for x in batcher.cache.values()),
        "runs": [{k: run[k] for k in keep} for run in runs],
        "first_logits": np.stack(runs[0]["first_logits"]),
    }


def serving_tp(how, main_first, requests) -> dict:
    """main_path's 12 requests in main_path's geometry on Llama-3-8B at
    tp=2: on every rank K1 = 32 x admissions and K2 = 32 x decode steps at
    the rank-local heads, two runs identical, every rank's streams and
    first-token logits identical; the first-token logits within
    PATH_LOGIT_TOL of main_path's unsharded ones."""
    cfg = dataclasses.replace(TransformerConfig.llama3_8b(),
                              paged_attention_kernel=True)
    ranks = spawn(serving_tp_rank, TP, device_type="cuda",
                  backend=how["backend"], args=(cfg,), timeout=900)
    n_layers, n_req = cfg.n_layers, len(requests)
    lead = ranks[0]["runs"][0]
    for r, rec in enumerate(ranks):
        check(rec["mesh_key"] == f"tp={TP}", f"rank {r}: {rec['mesh_key']}")
        for run in rec["runs"]:
            check(all(f == "length" for f in run["finish"]),
                  f"serving_tp rank {r}: finish reasons {run['finish']}")
            check(run["k1_launches"] == n_layers * n_req,
                  f"serving_tp rank {r}: flash_fwd launched "
                  f"{run['k1_launches']} times, expected {n_layers} x {n_req}")
            check(run["decode_steps"] > 0
                  and run["k2_launches"] == n_layers * run["decode_steps"],
                  f"serving_tp rank {r}: paged_decode launched "
                  f"{run['k2_launches']} times over {run['decode_steps']} "
                  "decode steps")
        check(rec["runs"][1]["tokens"] == rec["runs"][0]["tokens"],
              f"serving_tp rank {r}: the second run gave other tokens")
        check(rec["runs"][0]["tokens"] == lead["tokens"],
              f"serving_tp: rank {r}'s streams differ from rank 0's")
        check(np.array_equal(rec["first_logits"], ranks[0]["first_logits"]),
              f"serving_tp: rank {r}'s first-token logits differ")
    want = np.stack(main_first["first_logits"])
    got = ranks[0]["first_logits"]
    first_err = max(float(np.abs(g - w).max() / np.abs(w).max())
                    for g, w in zip(got, want))
    check(first_err <= PATH_LOGIT_TOL,
          f"serving_tp: first-token logits {first_err} from main_path's")
    generated = sum(len(t) for t in lead["tokens"])
    return {
        "phase": "serving_tp", **{k: how[k] for k in ("world", "backend",
                                                      "cards")},
        "config": "llama3_8b", "layers": n_layers, "dtype": "bfloat16",
        "heads_per_rank": list(TP_HEADS), "requests": n_req,
        "mesh": ranks[0]["mesh_key"],
        "tokens_per_s": generated / lead["wall_s"], "wall_s": lead["wall_s"],
        "second_run_tokens_per_s": generated / ranks[0]["runs"][1]["wall_s"],
        "decode_step_p50_ms": float(np.median(lead["decode_only_step_ms"])),
        "ttft_p50_ms": float(np.median(lead["ttft_s"])) * 1e3,
        "decode_steps": lead["decode_steps"],
        "k1_launches_per_rank": [r["runs"][0]["k1_launches"] for r in ranks],
        "k2_launches_per_rank": [r["runs"][0]["k2_launches"] for r in ranks],
        "live_gb_per_rank": [r["live_bytes"] / 1e9 for r in ranks],
        "weight_gb_per_rank": [r["weight_bytes"] / 1e9 for r in ranks],
        "pool_gb_per_rank": [r["pool_bytes"] / 1e9 for r in ranks],
        "ranks_identical": True, "second_run_identical": True,
        "first_token_rel_err_vs_main_path": first_err,
        "first_token_tolerance": PATH_LOGIT_TOL,
        "greedy_agreement_with_main_path": token_agreement(
            lead["tokens"], main_first["tokens"], greedy_rows(requests)),
        # a greedy stream that leaves main_path's at one near-tied token
        # stays apart: the first tokens show whether the rows start alike
        "first_token_agreement_with_main_path": float(np.mean(
            [a[0] == b[0] for a, b in zip(lead["tokens"],
                                          main_first["tokens"])])),
        "first_token_argmax_agreement": float(np.mean(
            got.argmax(-1) == want.argmax(-1))),
        "streams_equal_main_path": lead["tokens"] == main_first["tokens"],
    }


def serving_replicated(params, cfg, requests, main_first, how) -> dict:
    """``ReplicatedEngine.build(n_replicas=2)`` over main_path's traffic,
    in main_path's geometry: every request's stream equal to main_path's
    (a decode step is the fixed [max_batch] shape and an admission one
    request a forward, whoever shares the replica), K1 = 32 x admissions
    and K2 = 32 x decode steps over both replicas, and the split of
    requests between them."""
    eng = ReplicatedEngine.build(params, cfg, 2,
                                 devices=how["replica_devices"],
                                 **SERVE_GEOMETRY)
    fa.FLASH_FWD.launches = 0
    pa.PAGED_DECODE.launches = 0
    steps, undo = count_decode_steps()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tickets = [eng.submit(p, n, sampling=s, **kw)
                   for p, n, s, kw in requests]
        ttft: dict[int, float] = {}
        while eng.pending or any(e.batcher.busy for e in eng.engines):
            eng.step()
            now = time.perf_counter() - t0
            for tk in tickets:
                if tk not in ttft and eng.partial_result(tk):
                    ttft[tk] = now
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        undo()
    tokens = [eng.result(t) for t in tickets]
    split = [eng.replica_of(t) for t in tickets]
    n_layers, n_req = cfg.n_layers, len(requests)
    check(fa.FLASH_FWD.launches == n_layers * n_req,
          f"serving_replicated: flash_fwd launched {fa.FLASH_FWD.launches} "
          f"times, expected {n_layers} x {n_req}")
    check(steps[0] > 0 and pa.PAGED_DECODE.launches == n_layers * steps[0],
          f"serving_replicated: paged_decode launched "
          f"{pa.PAGED_DECODE.launches} times over {steps[0]} decode steps")
    check(set(split) == {0, 1}, f"serving_replicated: split {split}")
    check(tokens == main_first["tokens"],
          "serving_replicated: streams differ from main_path's (agreement "
          f"{token_agreement(tokens, main_first['tokens'], range(n_req))})")
    generated = sum(len(t) for t in tokens)
    return {
        "phase": "serving_replicated", "replicas": 2,
        "devices": how["replica_devices"], "cards": how["cards"],
        "config": "llama3_8b", "requests": n_req,
        "requests_per_replica": [split.count(i) for i in range(2)],
        "replica_of": split,
        "tokens_per_s": generated / wall, "wall_s": wall,
        "ttft_p50_ms": float(np.median([ttft[t] for t in tickets])) * 1e3,
        "decode_steps": steps[0],
        "k1_launches": fa.FLASH_FWD.launches,
        "k2_launches": pa.PAGED_DECODE.launches,
        "streams_equal_main_path": True,
    }


# ------------------------------------------- sequence-parallel serving, and
# ------------------------------------ LoRA and MoE under a tensor-parallel mesh


def sp_requests(vocab_size: int) -> list:
    """serving_sp's traffic: SP_REQUESTS prompts of 4096-8000 tokens
    (numpy seed 20), SP_NEW_TOKENS each, even ones greedy and odd ones
    seeded sampled."""
    rng = np.random.default_rng(20)
    lo, hi = SP_PROMPT_RANGE
    requests = []
    for i, L in enumerate(rng.integers(lo, hi + 1, size=SP_REQUESTS)):
        prompt = rng.integers(0, vocab_size, int(L)).tolist()
        sampling = (SamplingParams() if i % 2 == 0 else
                    SamplingParams(temperature=0.8, top_k=50, seed=200 + i))
        requests.append((prompt, SP_NEW_TOKENS, sampling, {}))
    return requests


class ExchangeClock:
    """Host milliseconds, and calls, of the sequence-parallel exchanges
    while installed: the ring's ``ring_shift``, Ulysses' all-to-alls, and
    ``transformer.gather_prefill`` (the K/V gathered over sp into the pool
    and the last row's broadcast). Each call is timed between two
    ``torch.cuda.synchronize()``, so queued compute is not counted."""

    def __init__(self) -> None:
        self.ms = {"ring_shift": 0.0, "all_to_all": 0.0, "gather_prefill": 0.0}
        self.calls = dict.fromkeys(self.ms, 0)
        self._undo = []
        for module, attr, key in (
                (ring_mod, "ring_shift", "ring_shift"),
                (ulysses_mod, "all_to_all_tiled", "all_to_all"),
                (transformer, "gather_prefill", "gather_prefill")):
            fn = getattr(module, attr)
            setattr(module, attr, self._timed(fn, key))
            self._undo.append((module, attr, fn))

    def _timed(self, fn, key):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.ms[key] += (time.perf_counter() - t) * 1e3
            self.calls[key] += 1
            return out
        return timed

    def close(self) -> None:
        for module, attr, fn in self._undo:
            setattr(module, attr, fn)


def llama_cut(dev, n_layers: int):
    """main_path's seed-0 Llama-3-8B weights built on ``dev``, cut to the
    first ``n_layers`` (the draws of a 32-layer build, so every cut of them
    is the same model's first layers), and its config."""
    cfg = dataclasses.replace(TransformerConfig.llama3_8b(),
                              paged_attention_kernel=True)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    if n_layers < cfg.n_layers:
        params = {**params, "layers": params["layers"][:n_layers]}
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return params, cfg


def build_in_turns(rank: int, world: int, make):
    """``make()`` on one rank at a time, a barrier after each turn: a rank
    that builds the whole model to keep its shard frees it before the next
    one builds (the ranks may share one card)."""
    out = None
    for turn in range(world):
        if turn == rank:
            out = make()
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    torch.cuda.synchronize()
    return out


def sp_rank_setup(axes: dict):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(axes, device_type="cuda")
    return mesh, torch.device("cuda", torch.cuda.current_device())


def run_batcher(batcher, requests) -> dict:
    """``drive`` with the exchanges timed; what serving_sp keeps of it."""
    clock = ExchangeClock()
    try:
        run = drive(batcher, requests)
    finally:
        clock.close()
    keep = ("tokens", "finish", "k1_launches", "k2_launches", "decode_steps",
            "wall_s", "ttft_s", "decode_only_step_ms", "admit_s")
    out = {k: run[k] for k in keep}
    out["first_logits"] = np.stack(run["first_logits"])
    out["exchange_ms"], out["exchange_calls"] = clock.ms, clock.calls
    return out


def sp_attention_rank(rank: int, dev) -> dict:
    """One sp rank of ``sp_attention``: q/k/v of SP_ATTN_SHAPE from one
    seed (the same on every rank), ``ring_attention_sharded`` and
    ``ulysses_attention_sharded`` over sp against single-device
    ``flash_attention`` on the whole sequence; each timed (host clock
    around calls ending in a synchronize, after a warm-up), with the K1
    time of this rank's own work (CUDA events) and its exchanges alone."""
    mesh = make_mesh({"sp": SP}, device_type="cuda")
    group = serving_groups(mesh).sp
    c = SP_ATTN_SHAPE
    gen = torch.Generator(device=dev).manual_seed(41)
    q = torch.randn(c["B"], c["H"], c["L"], c["D"], generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn(c["B"], c["KVH"], c["L"], c["D"], generator=gen,
                        device=dev, dtype=torch.bfloat16) for _ in range(2))
    want = fa.flash_attention(q, k, v, True)
    scale = want.float().abs().max().item()
    me, Lr = axis_index(mesh, "sp"), c["L"] // SP
    blk = slice(me * Lr, (me + 1) * Lr)
    qr, kr, vr = (x[:, :, blk].contiguous() for x in (q, k, v))

    def host_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps * 1e3

    def event_ms(fn, reps=5):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    out = {}
    fa.FLASH_FWD.launches = 0
    ring = ring_mod.ring_attention_sharded(mesh, q, k, v)
    ring_k1 = fa.FLASH_FWD.launches
    fa.FLASH_FWD.launches = 0
    uly = ulysses_mod.ulysses_attention_sharded(mesh, q, k, v)
    uly_k1 = fa.FLASH_FWD.launches
    # this rank's K1 work in each: the ring's own block (causal) and, on
    # rank r, r earlier blocks (non-causal); Ulysses' H/sp heads over L
    q_h = q[:, :c["H"] // SP].contiguous()
    k_h, v_h = (x[:, :c["KVH"] // SP].contiguous() for x in (k, v))
    ring_k1_ms = event_ms(lambda: fa.flash_attention_with_lse(qr, kr, vr, True))
    ring_k1_ms += me * event_ms(
        lambda: fa.flash_attention_with_lse(qr, kr, vr, False))
    uly_k1_ms = event_ms(
        lambda: fa.flash_attention_with_lse(q_h, k_h, v_h, True))
    out["ring"] = {
        "rel_err": (ring.float() - want.float()).abs().max().item() / scale,
        "row_rel_err": row_rel_err(ring, want),
        "ms": host_ms(lambda: ring_mod.ring_attention_sharded(mesh, q, k, v)),
        "k1_ms": ring_k1_ms,
        "exchange_ms": host_ms(lambda: ring_shift((kr, vr), group)),
        "k1_launches": ring_k1,
    }
    out["ulysses"] = {
        "rel_err": (uly.float() - want.float()).abs().max().item() / scale,
        "row_rel_err": row_rel_err(uly, want),
        "ms": host_ms(lambda: ulysses_mod.ulysses_attention_sharded(
            mesh, q, k, v)),
        "k1_ms": uly_k1_ms,
        # q, k, v out and the output back: four all-to-alls
        "exchange_ms": host_ms(lambda: [all_to_all_tiled(x, group, 1, 2)
                                        for x in (qr, kr, vr)]
                               + [all_to_all_tiled(
                                   torch.empty_like(q_h), group, 2, 1)]),
        "k1_launches": uly_k1,
    }
    out["bitwise_ulysses_vs_single"] = bool(torch.equal(uly, want))
    return out


def sp_attention_grad_rank(dev) -> dict:
    """One sp rank of ``sp_attention_grad``: q/k/v and an output gradient
    of SP_ATTN_SHAPE from one seed (the same on every rank); the ring
    (causal, then with a SP_GRAD_WINDOW window) and Ulysses forward and
    backward on the rank's block of positions, each gradient held against
    one card's ``FlashAttention`` backward on the whole sequence, on the
    rank's rows (dq) and its K/V block (dk, dv). Per run: K1/K3/K4
    launches, the backward's host ms (the second of two calls) and the
    exchanges' ms inside it."""
    mesh = make_mesh({"sp": SP}, device_type="cuda")
    group = serving_groups(mesh).sp
    c = SP_ATTN_SHAPE
    gen = torch.Generator(device=dev).manual_seed(42)

    def randn(heads):
        return torch.randn(c["B"], heads, c["L"], c["D"], generator=gen,
                           device=dev, dtype=torch.bfloat16)

    q, k, v, do = randn(c["H"]), randn(c["KVH"]), randn(c["KVH"]), randn(c["H"])
    me, Lr = axis_index(mesh, "sp"), c["L"] // SP
    blk = slice(me * Lr, (me + 1) * Lr)
    out = {}
    for name, window in (("ring_causal", None), ("ring_window", SP_GRAD_WINDOW),
                         ("ulysses", None)):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        fa.flash_attention(*leaves, True, window=window).backward(do)
        want = [x.grad[:, :, blk] for x in leaves]
        del leaves

        def run():
            xs = [x[:, :, blk].contiguous().requires_grad_() for x in (q, k, v)]
            if name == "ulysses":
                o = ulysses_mod.ulysses_attention(*xs, group=group)
            else:
                o = ring_mod.ring_attention(*xs, group=group, window=window)
            torch.cuda.synchronize()
            dist.barrier()
            clock = CollectiveClock()
            t = time.perf_counter()
            try:
                o.backward(do[:, :, blk].contiguous())
                torch.cuda.synchronize()
            finally:
                clock.close()
            return [x.grad for x in xs], (time.perf_counter() - t) * 1e3, clock
        for kernel in (fa.FLASH_FWD, fa.FLASH_BWD_DKDV, fa.FLASH_BWD_DQ):
            kernel.launches = 0
        got, _, _ = run()
        launches = {"flash_fwd": fa.FLASH_FWD.launches,
                    "flash_bwd_dkdv": fa.FLASH_BWD_DKDV.launches,
                    "flash_bwd_dq": fa.FLASH_BWD_DQ.launches}
        _, ms, clock = run()
        errs = {g: rel_err(a, b.float())[1]
                for g, a, b in zip(("dq", "dk", "dv"), got, want)}
        out[name] = {
            "rel_err": errs,
            "row_rel_err": {g: row_rel_err(a, b) for g, a, b in
                            zip(("dq", "dk", "dv"), got, want)},
            "bitwise": all(torch.equal(a, b) for a, b in zip(got, want)),
            "launches": launches, "backward_ms": ms,
            "exchange_ms": clock.ms["ring_shift"] + clock.ms["all_to_all"],
        }
        del got, want
    return out


def serve_on(batcher, requests, dev) -> dict:
    """``run_batcher`` on a mesh batcher, with this rank's live bytes (its
    shard of the weights and its pool, before the traffic) and mesh key."""
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated(dev)
    out = run_batcher(batcher, requests)
    out.update(live_bytes=live, mesh_key=batcher._mesh_key)
    return out


def serving_sp_rank(rank: int) -> dict:
    """One rank of the sp=2 spawn: ``sp_attention``, then serving_sp's
    traffic on Llama-3-8B (all 32 layers, ring), then on its first
    BREADTH_CUT_LAYERS under Ulysses. Every rank builds the same seed-0
    weights on the card, in turns, and keeps only its batcher's copy (a
    rank of an sp-only mesh holds every weight)."""
    mesh, dev = sp_rank_setup({"sp": SP})
    out = {"sp_attention": sp_attention_rank(rank, dev)}
    gc.collect()
    torch.cuda.empty_cache()

    def make():
        params, cfg = llama_cut(dev, 32)
        return ContinuousBatcher(params, cfg, mesh=mesh, **SP_GEOMETRY)

    batcher = build_in_turns(rank, SP, make)
    requests = sp_requests(batcher.config.vocab_size)
    out["ring"] = serve_on(batcher, requests, dev)
    params, cfg = batcher.params, batcher.config
    del batcher
    gc.collect()
    torch.cuda.empty_cache()
    cut = {**params, "layers": params["layers"][:BREADTH_CUT_LAYERS]}
    del params
    batcher = ContinuousBatcher(
        cut, dataclasses.replace(cfg, n_layers=BREADTH_CUT_LAYERS,
                                 sp_attention="ulysses"),
        mesh=mesh, **SP_GEOMETRY)
    del cut
    gc.collect()
    torch.cuda.empty_cache()
    out["ulysses"] = serve_on(batcher, requests, dev)
    return out


def serving_sp_tp_rank(rank: int) -> dict:
    """One rank of sp=2 x tp=2 (four ranks): serving_sp's traffic on the
    first BREADTH_CUT_LAYERS, ring; each rank keeps its tp shard."""
    axes = {"sp": SP, "tp": TP}
    mesh, dev = sp_rank_setup(axes)
    requests = sp_requests(TransformerConfig.llama3_8b().vocab_size)

    def make():
        params, cfg = llama_cut(dev, BREADTH_CUT_LAYERS)
        return ContinuousBatcher(params, cfg, mesh=mesh, **SP_GEOMETRY)

    batcher = build_in_turns(rank, SP * TP, make)
    out = serve_on(batcher, requests, dev)
    out["sp_index"] = axis_index(mesh, "sp")
    return out


def moe_block_outputs(layer, cfg, dev, groups=None) -> dict:
    """``_mlp_block`` of one MoE layer on MOE_BLOCK_SHAPES' inputs (seed
    38, the same on every card), on one card or under ``groups``' tp and
    ep; CPU copies."""
    gen = torch.Generator(device=dev).manual_seed(38)
    out = {}
    for name, (B, L) in MOE_BLOCK_SHAPES.items():
        y = torch.randn(B, L, cfg.d_model, generator=gen, device=dev,
                        dtype=cfg.dtype)
        got, _ = transformer._mlp_block(
            y, layer, cfg, tp_group=groups and groups.tp,
            ep_group=groups and groups.ep)
        out[name] = got.cpu()
    return out


def tp_breadth_rank(rank: int) -> dict:
    """One rank of the tensor-parallel breadth spawn: serving_lora's
    traffic and adapters on Llama-3-8B's first BREADTH_CUT_LAYERS at tp=2,
    then main_path's traffic on Mixtral widths cut to BREADTH_CUT_LAYERS at
    tp=2 and at ep=2."""
    mesh, dev = sp_rank_setup({"tp": TP})
    out = {}

    def make_lora():
        params, cfg = llama_cut(dev, BREADTH_CUT_LAYERS)
        adapters = lora_adapters(cfg, dev, 4, LORA_RANK, seed=15)
        return ContinuousBatcher(params, cfg, mesh=mesh, adapters=adapters,
                                 lora_scale=LORA_SCALE, **SERVE_GEOMETRY)

    batcher = build_in_turns(rank, TP, make_lora)
    out["lora"] = serve_on(batcher, lora_requests(batcher.config), dev)
    del batcher
    gc.collect()
    torch.cuda.empty_cache()
    ep_mesh = make_mesh({"ep": TP}, device_type="cuda")
    for name, m in (("moe_tp", mesh), ("moe_ep", ep_mesh)):
        def make_moe(m=m):
            cfg = moe_config(BREADTH_CUT_LAYERS)
            params = init_params(
                cfg, torch.Generator(device=dev).manual_seed(36), dev)
            return ContinuousBatcher(params, cfg, mesh=m, **SERVE_GEOMETRY)

        batcher = build_in_turns(rank, TP, make_moe)
        out[name] = serve_on(batcher, main_requests(batcher.config.vocab_size),
                             dev)
        out[name]["block"] = moe_block_outputs(
            batcher.params["layers"][0], batcher.config, dev,
            serving_groups(m))
        del batcher
        gc.collect()
        torch.cuda.empty_cache()
    return out


def lora_requests(cfg) -> list:
    """serving_lora's 8 requests (numpy seed 16) over 4 adapters and the
    base, and the adapter of each."""
    rng = np.random.default_rng(16)
    which = [0, 1, 2, 3, None, 0, 1, None]
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 513, size=len(which))]
    return [(p, 32, SamplingParams(), {"adapter": a})
            for p, a in zip(prompts, which)]


def first_rows(params, cfg, requests, adapters=None) -> np.ndarray:
    """Each request's first-token logits from a one-shot forward on the
    card (the single-device reference of a mesh phase): on ``params``, or
    for an adapter row on ``merge_lora(params, adapters[i])``."""
    rows = []
    for prompt, _, _, kw in requests:
        a = kw.get("adapter")
        tree = params if a is None else merge_lora(params, adapters[a],
                                                   LORA_SCALE)
        tok = torch.as_tensor([prompt], device=params["embed"].device)
        rows.append(transformer.forward(tree, tok, cfg)[0, -1].float().cpu()
                    .numpy())
        del tree
    return np.stack(rows)


def mesh_report(name, ranks, key, ref, requests, n_layers, k1_want,
                how, over_max=0, exact=False) -> dict:
    """The checks every mesh serving phase makes, and its report: every
    request runs to its length; each rank's K1 launches as ``k1_want(rank)``
    predicts and K2 once per layer and decode step; every rank's streams
    and first-token logits bitwise equal to rank 0's; the first-token
    logits against ``ref`` (the single-device run's) within PATH_LOGIT_TOL
    for all but at most ``over_max`` requests; with ``exact``, streams and
    first-token logits equal to ``ref``'s."""
    runs = [r[key] for r in ranks]
    lead = runs[0]
    for r, run in enumerate(runs):
        check(all(f == "length" for f in run["finish"]),
              f"{name} rank {r}: finish reasons {run['finish']}")
        check(run["k1_launches"] == k1_want(r),
              f"{name} rank {r}: flash_fwd launched {run['k1_launches']} "
              f"times, predicted {k1_want(r)}")
        check(run["decode_steps"] > 0
              and run["k2_launches"] == n_layers * run["decode_steps"],
              f"{name} rank {r}: paged_decode launched {run['k2_launches']} "
              f"times over {run['decode_steps']} decode steps")
        check(run["tokens"] == lead["tokens"],
              f"{name}: rank {r}'s streams differ from rank 0's")
        check(np.array_equal(run["first_logits"], lead["first_logits"]),
              f"{name}: rank {r}'s first-token logits differ from rank 0's")
    got = lead["first_logits"]
    check(bool(np.isfinite(got).all()), f"{name}: non-finite logits")
    errs = [float(np.abs(g - w).max() / np.abs(w).max())
            for g, w in zip(got, ref["first_logits"])]
    over = sum(e > PATH_LOGIT_TOL for e in errs)
    check(over <= over_max,
          f"{name}: first-token logits {errs} from the single-device run's, "
          f"{over} over {PATH_LOGIT_TOL} where {over_max} may be")
    if exact:
        check(max(errs) == 0.0 and lead["tokens"] == ref["tokens"],
              f"{name}: streams or first-token logits {errs} differ from "
              "the single-device run's")
    n_admit = len(requests)
    generated = sum(len(t) for t in lead["tokens"])
    greedy = greedy_rows(requests)
    return {
        "phase": name, **{k: how[k] for k in ("backend", "cards")},
        "world": len(ranks), "mesh": lead["mesh_key"], "layers": n_layers,
        "requests": n_admit, "prompt_lens": [len(p) for p, _, _, _ in requests],
        "tokens_per_s": generated / lead["wall_s"], "wall_s": lead["wall_s"],
        "ttft_ms": [t * 1e3 for t in lead["ttft_s"]],
        "admit_ms": [(e - s) * 1e3 for s, e in lead["admit_s"]],
        "decode_step_p50_ms": (float(np.median(lead["decode_only_step_ms"]))
                               if lead["decode_only_step_ms"] else None),
        "decode_steps": lead["decode_steps"],
        "k1_launches_per_rank": [r["k1_launches"] for r in runs],
        "k2_launches_per_rank": [r["k2_launches"] for r in runs],
        "live_gb_per_rank": [run["live_bytes"] / 1e9 for run in runs],
        "exchange_ms_per_admission": {
            k: v / n_admit for k, v in lead["exchange_ms"].items()},
        "exchange_calls": lead["exchange_calls"],
        "ranks_identical": True,
        "first_token_rel_err_vs_single_device": errs,
        "first_token_tolerance": PATH_LOGIT_TOL,
        "first_token_over_tolerance": over, "first_token_over_max": over_max,
        "exact": exact,
        "first_token_argmax_agreement": float(np.mean(
            got.argmax(-1) == ref["first_logits"].argmax(-1))),
        "greedy_agreement_with_single_device": token_agreement(
            lead["tokens"], ref["tokens"], greedy),
        "streams_equal_single_device": lead["tokens"] == ref["tokens"],
    }


def single_device_run(params, cfg, requests, **batcher_kw) -> dict:
    """The single-device batcher on a mesh phase's traffic: its streams
    and first-token logits, the reference the ranks are held to."""
    run = drive(ContinuousBatcher(params, cfg, **batcher_kw), requests)
    return {"tokens": run["tokens"],
            "first_logits": np.stack(run["first_logits"]),
            "ttft_s": run["ttft_s"], "wall_s": run["wall_s"],
            "decode_only_step_ms": run["decode_only_step_ms"]}


def sequence_parallel_phases(dev, how) -> list[dict]:
    """``sp_attention``, ``serving_sp`` (ring, 32 layers), its Ulysses and
    sp=2 x tp=2 runs (BREADTH_CUT_LAYERS), each held against the
    single-device batcher on the same weights and traffic, run here before
    the ranks spawn and freed before they do."""
    params, cfg = llama_cut(dev, 32)
    requests = sp_requests(cfg.vocab_size)
    ref32 = single_device_run(params, cfg, requests, **SP_GEOMETRY)
    cut, cut_cfg = ({**params, "layers": params["layers"][:BREADTH_CUT_LAYERS]},
                    dataclasses.replace(cfg, n_layers=BREADTH_CUT_LAYERS))
    ref8 = single_device_run(cut, cut_cfg, requests, **SP_GEOMETRY)
    del params, cut
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = spawn(serving_sp_rank, SP, device_type="cuda",
                  backend=how["backend"], timeout=900)
    t_sp = time.perf_counter() - t
    attn = [r["sp_attention"] for r in ranks]
    for r, rec in enumerate(attn):
        check(rec["ring"]["row_rel_err"] <= SP_ATTN_ROW_TOL,
              f"sp_attention rank {r} ring: row err "
              f"{rec['ring']['row_rel_err']} over {SP_ATTN_ROW_TOL}")
        check(rec["bitwise_ulysses_vs_single"],
              f"sp_attention rank {r}: Ulysses differs from one card's "
              f"flash_attention (row err {rec['ulysses']['row_rel_err']})")
        check(rec["ring"]["k1_launches"] == r + 1,
              f"sp_attention rank {r}: ring launched K1 "
              f"{rec['ring']['k1_launches']} times, predicted {r + 1}")
        check(rec["ulysses"]["k1_launches"] == 1,
              f"sp_attention rank {r}: Ulysses launched K1 "
              f"{rec['ulysses']['k1_launches']} times, predicted 1")
    out = [{"phase": "sp_attention", **SP_ATTN_SHAPE, "dtype": "bfloat16",
            "sp": SP, "backend": how["backend"], "cards": how["cards"],
            "row_tolerance": SP_ATTN_ROW_TOL, "ulysses": "bitwise",
            "per_rank": attn}]
    n_req = len(requests)
    out.append(mesh_report(
        "serving_sp", ranks, "ring", ref32, requests, cfg.n_layers,
        lambda r: cfg.n_layers * (r + 1) * n_req, how))
    out.append(mesh_report(
        "serving_sp_ulysses", ranks, "ulysses", ref8, requests,
        BREADTH_CUT_LAYERS, lambda r: BREADTH_CUT_LAYERS * n_req, how))
    t = time.perf_counter()
    quad = spawn(serving_sp_tp_rank, SP * TP, device_type="cuda",
                 backend=how["backend"], timeout=900)
    t_quad = time.perf_counter() - t
    out.append(mesh_report(
        "serving_sp_tp", [{"run": q} for q in quad], "run", ref8, requests,
        BREADTH_CUT_LAYERS,
        lambda r: BREADTH_CUT_LAYERS * (quad[r]["sp_index"] + 1) * n_req, how))
    out[1]["spawn_s"], out[3]["spawn_s"] = t_sp, t_quad
    for rec in out[1:]:
        rec["single_device"] = {
            "ttft_ms": [x * 1e3 for x in (ref32 if rec["phase"] == "serving_sp"
                                          else ref8)["ttft_s"]],
            "decode_step_p50_ms": float(np.median(
                (ref32 if rec["phase"] == "serving_sp" else ref8)[
                    "decode_only_step_ms"]))}
    return out


def tp_breadth_phases(dev, how) -> list[dict]:
    """``serving_lora_tp`` (serving_lora's adapters and traffic at tp=2 on
    Llama-3-8B's first BREADTH_CUT_LAYERS: every row's first-token logits
    against a single-device forward on the merged params) and
    ``serving_moe_tp`` / ``serving_moe_ep`` (main_path's traffic on Mixtral
    widths cut to BREADTH_CUT_LAYERS at tp=2 and ep=2, against the
    single-device MoE batcher on the same cut, and one MoE block against
    one card's on the same input: ``moe_block_mesh``). Capacity routing
    breaks near-ties of a token's 2nd and 3rd expert by the partial sums'
    order (``moe_reference``), so under tp at most MOE_TP_FIRST_OVER_MAX
    requests' first-token errors may pass PATH_LOGIT_TOL; ep must equal
    one card."""
    params, cfg = llama_cut(dev, BREADTH_CUT_LAYERS)
    adapters = lora_adapters(cfg, dev, 4, LORA_RANK, seed=15)
    requests = lora_requests(cfg)
    lora_ref = {"first_logits": first_rows(params, cfg, requests, adapters)}
    lora_ref["tokens"] = single_device_run(
        params, cfg, requests, adapters=adapters, lora_scale=LORA_SCALE,
        **SERVE_GEOMETRY)["tokens"]
    del params, adapters
    mcfg = moe_config(BREADTH_CUT_LAYERS)
    mparams = init_params(mcfg, torch.Generator(device=dev).manual_seed(36))
    mreq = main_requests(mcfg.vocab_size)
    moe_ref = single_device_run(mparams, mcfg, mreq, **SERVE_GEOMETRY)
    block_ref = moe_block_outputs(mparams["layers"][0], mcfg, dev)
    del mparams
    gc.collect()
    torch.cuda.empty_cache()
    ranks = spawn(tp_breadth_rank, TP, device_type="cuda",
                  backend=how["backend"], timeout=900)
    n_l = BREADTH_CUT_LAYERS
    n_base = sum(kw.get("adapter") is None for _, _, _, kw in requests)
    lora = mesh_report("serving_lora_tp", ranks, "lora", lora_ref, requests,
                       n_l, lambda r: n_l * n_base, how)
    lora.update(adapters=4, rank=LORA_RANK, lora_scale=LORA_SCALE,
                reference="single-device forward on merge_lora per adapter")
    out = [lora]
    for name, key in (("serving_moe_tp", "moe_tp"), ("serving_moe_ep", "moe_ep")):
        ep, block = key == "moe_ep", {}
        for shape, want in block_ref.items():
            got = ranks[0][key]["block"][shape]
            for r, rank in enumerate(ranks):
                check(torch.equal(rank[key]["block"][shape], got),
                      f"moe_block_mesh {key} {shape}: rank {r} differs "
                      "from rank 0")
            err = row_rel_err(got, want)
            check(bool(torch.isfinite(got).all()) and err <= MOE_BLOCK_ROW_TOL,
                  f"moe_block_mesh {key} {shape}: row err {err} over "
                  f"{MOE_BLOCK_ROW_TOL}")
            bitwise = bool(torch.equal(got, want))
            check(bitwise or not ep,
                  f"moe_block_mesh {key} {shape}: differs from one card's")
            block[shape] = {"tokens": got.shape[0] * got.shape[1],
                            "row_rel_err": err, "bitwise": bitwise}
        rec = mesh_report(name, ranks, key, moe_ref, mreq, n_l,
                          lambda r: n_l * len(mreq), how,
                          over_max=0 if ep else MOE_TP_FIRST_OVER_MAX,
                          exact=ep)
        rec.update(config="mixtral_8x7b", layers_cut_from=32,
                   capacity_factor=mcfg.moe_capacity_factor,
                   moe_block_mesh=block,
                   moe_block_row_tolerance=MOE_BLOCK_ROW_TOL)
        out.append(rec)
    return out


# ------------------------------------------ dp x tp replicas; training on a mesh


def transport4() -> dict:
    """How this machine runs four ranks: one a card over NCCL with four
    cards or more, all on card 0 over gloo otherwise."""
    cards = torch.cuda.device_count()
    return {"world": REPLICAS * TP, "cards": cards,
            "backend": "nccl" if cards >= REPLICAS * TP else "gloo"}


def replicated_tp_rank(rank: int) -> dict:
    """One rank of ``serving_replicated_tp``: the 2 x 2 mesh, this rank's
    replica batcher built in turns (main_path's seed-0 weights cut to
    BREADTH_CUT_LAYERS, this rank's tp shard kept), then rank 0 serves
    main_path's traffic through the front end while the others follow.
    Every rank reports its own launches, decode steps, admissions' first
    logits (by replica-local ticket) and live bytes; rank 0 the streams,
    the routing, the clocks and the front end's exchange time."""
    mesh, dev = sp_rank_setup({"dp": REPLICAS, "tp": TP})
    sub = replica_mesh(mesh)

    def make():
        params, cfg = llama_cut(dev, BREADTH_CUT_LAYERS)
        return ContinuousBatcher(params, cfg, mesh=sub, **SERVE_GEOMETRY)

    batcher = build_in_turns(rank, REPLICAS * TP, make)
    live = torch.cuda.memory_allocated(dev)
    admissions = capture_admissions(batcher)
    eng = ReplicatedEngine.over_mesh(Engine(batcher), mesh)
    fa.FLASH_FWD.launches = 0
    pa.PAGED_DECODE.launches = 0
    steps, undo = count_decode_steps()
    out = {"replica": eng.rounds.replica, "leader": eng.rounds.is_leader,
           "live_bytes": live}
    try:
        if eng.is_front_end:
            requests = main_requests(batcher.config.vocab_size)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tickets = [eng.submit(p, n, sampling=s, **kw)
                       for p, n, s, kw in requests]
            ttft, decode_only_ms = {}, []
            while eng.pending or eng.busy:
                k1, n_steps = fa.FLASH_FWD.launches, steps[0]
                t = time.perf_counter()
                eng.step()
                dt = time.perf_counter() - t
                if fa.FLASH_FWD.launches == k1 and steps[0] > n_steps:
                    decode_only_ms.append(dt * 1e3)
                now = time.perf_counter() - t0
                for tk in tickets:
                    if tk not in ttft and eng.partial_result(tk):
                        ttft[tk] = now
            torch.cuda.synchronize()
            out.update(
                wall_s=time.perf_counter() - t0,
                tokens=[eng.result(t) for t in tickets],
                finish=[eng.finish_reason(t) for t in tickets],
                replica_of=[eng.replica_of(t) for t in tickets],
                where=[eng._where[t] for t in tickets],
                ttft_s=[ttft[t] for t in tickets],
                decode_only_step_ms=decode_only_ms,
                exchange_ms=list(eng.rounds.exchange_ms))
            eng.close()
        else:
            eng.follow()
    finally:
        undo()
    torch.cuda.synchronize()
    rids = {local: rid for local, rid in eng.rounds.engine._state.items()
            if isinstance(rid, int)}
    out.update(
        k1_launches=fa.FLASH_FWD.launches, k2_launches=pa.PAGED_DECODE.launches,
        decode_steps=steps[0], admissions=len(admissions),
        first_logits={local: admissions[rid][0] for local, rid in rids.items()})
    return out


def in_process_routing(params, cfg, requests) -> list[int]:
    """``replica_of`` of each request on an in-process ``ReplicatedEngine``
    of two single-device replicas on card 0, on the submit and step order
    of ``serving_replicated_tp``'s front end (all submitted at t=0, then
    steps)."""
    eng = ReplicatedEngine.build(params, cfg, REPLICAS,
                                 devices=["cuda:0"] * REPLICAS,
                                 **SERVE_GEOMETRY)
    tickets = [eng.submit(p, n, sampling=s, **kw) for p, n, s, kw in requests]
    eng.run_to_completion()
    return [eng.replica_of(t) for t in tickets]


def serving_replicated_tp(dev, how4) -> dict:
    """``ReplicatedEngine.build(meshes=...)`` as 2 replicas x tp=2 over four
    ranks, main_path's traffic on main_path's weights cut to
    BREADTH_CUT_LAYERS, against the single-device batcher on the same cut
    and traffic (each request's first-token logits within PATH_LOGIT_TOL,
    their argmax) and an in-process ReplicatedEngine of two single-device
    replicas (``replica_of`` of every request, printed beside the front
    end's: a stream that ends at another step changes the loads). Each
    rank launches K1 once per layer and admission of its replica and K2
    once per layer and decode step; ranks of one replica agree bitwise."""
    params, cfg = llama_cut(dev, BREADTH_CUT_LAYERS)
    requests = main_requests(cfg.vocab_size)
    ref = single_device_run(params, cfg, requests, **SERVE_GEOMETRY)
    routing = in_process_routing(params, cfg, requests)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = spawn(replicated_tp_rank, REPLICAS * TP, device_type="cuda",
                  backend=how4["backend"], timeout=900)
    spawn_s = time.perf_counter() - t
    front = ranks[0]
    n_l, n_req = BREADTH_CUT_LAYERS, len(requests)
    check(all(f == "length" for f in front["finish"]),
          f"serving_replicated_tp: finish reasons {front['finish']}")
    check(sum(r["admissions"] for r in ranks if r["leader"]) == n_req,
          "serving_replicated_tp: admissions "
          f"{[r['admissions'] for r in ranks]} do not add to {n_req}")
    for r, rec in enumerate(ranks):
        check(rec["k1_launches"] == n_l * rec["admissions"],
              f"serving_replicated_tp rank {r}: K1 {rec['k1_launches']}, "
              f"predicted {n_l} x {rec['admissions']} admissions")
        check(rec["decode_steps"] > 0
              and rec["k2_launches"] == n_l * rec["decode_steps"],
              f"serving_replicated_tp rank {r}: K2 {rec['k2_launches']} over "
              f"{rec['decode_steps']} decode steps")
        lead = next(x for x in ranks
                    if x["leader"] and x["replica"] == rec["replica"])
        check(rec["first_logits"].keys() == lead["first_logits"].keys()
              and all(np.array_equal(rec["first_logits"][k], v)
                      for k, v in lead["first_logits"].items()),
              f"serving_replicated_tp: rank {r}'s first-token logits differ "
              "from its replica's tp rank 0's")
    got = np.stack([
        next(x for x in ranks if x["leader"] and x["replica"] == i)[
            "first_logits"][local] for i, local in front["where"]])
    errs = [float(np.abs(g - w).max() / np.abs(w).max())
            for g, w in zip(got, ref["first_logits"])]
    check(bool(np.isfinite(got).all()), "serving_replicated_tp: non-finite")
    check(max(errs) <= PATH_LOGIT_TOL,
          f"serving_replicated_tp: first-token logits {errs} from the "
          f"single-device run's, over {PATH_LOGIT_TOL}")
    generated = sum(len(x) for x in front["tokens"])
    exchange = front["exchange_ms"]
    return {
        "phase": "serving_replicated_tp", **how4, "replicas": REPLICAS,
        "tp": TP, "mesh": f"dp={REPLICAS},tp={TP}", "config": "llama3_8b",
        "layers": n_l, "requests": n_req, "spawn_s": spawn_s,
        "tokens_per_s": generated / front["wall_s"], "wall_s": front["wall_s"],
        "ttft_p50_ms": float(np.median(front["ttft_s"])) * 1e3,
        "decode_step_p50_ms": (float(np.median(front["decode_only_step_ms"]))
                               if front["decode_only_step_ms"] else None),
        "exchange_ms_per_step_p50": float(np.median(exchange)),
        "exchange_ms_total": float(np.sum(exchange)), "rounds": len(exchange),
        "live_gb_per_rank": [r["live_bytes"] / 1e9 for r in ranks],
        "admissions_per_replica": [
            next(x for x in ranks if x["leader"] and x["replica"] == i)[
                "admissions"] for i in range(REPLICAS)],
        "decode_steps_per_rank": [r["decode_steps"] for r in ranks],
        "k1_launches_per_rank": [r["k1_launches"] for r in ranks],
        "k2_launches_per_rank": [r["k2_launches"] for r in ranks],
        "replica_of": front["replica_of"],
        "replica_of_in_process": routing,
        "replica_of_equal": front["replica_of"] == routing,
        "first_token_rel_err_vs_single_device": errs,
        "first_token_tolerance": PATH_LOGIT_TOL,
        "first_token_argmax_agreement": float(np.mean(
            got.argmax(-1) == ref["first_logits"].argmax(-1))),
        "greedy_agreement_with_single_device": token_agreement(
            front["tokens"], ref["tokens"], greedy_rows(requests)),
        "streams_equal_single_device": front["tokens"] == ref["tokens"],
        "single_device": {
            "ttft_p50_ms": float(np.median(ref["ttft_s"])) * 1e3,
            "decode_step_p50_ms": float(np.median(ref["decode_only_step_ms"])),
            "tokens_per_s": sum(len(x) for x in ref["tokens"]) / ref["wall_s"]},
    }


class CollectiveClock:
    """Host milliseconds of the mesh collectives while installed: the f32
    sums (``all_reduce_partial``, ``copy_to_group``'s backward, the
    gradient sums and, on gloo, the fsdp reduce-scatter), the gathers, the
    ring's hops (forward and backward), Ulysses' all-to-alls (both
    directions), the pipeline's stage-to-stage sends and receives and its
    output and input-gradient broadcasts; each timed between two
    ``torch.cuda.synchronize()`` (a receive's time includes its wait for
    the sender)."""

    HOOKS = ((mesh_mod, "_sum_f32", "sum"), (mesh_mod, "_gather", "gather"),
             (ring_mod, "ring_shift", "ring_shift"),
             (mesh_mod, "_all_to_all", "all_to_all"),
             (pipeline_mod, "send_to", "p2p"),
             (pipeline_mod, "recv_from", "p2p"),
             (pipeline_mod, "broadcast_from", "pp_broadcast"))

    def __init__(self) -> None:
        self.ms = {key: 0.0 for _, _, key in self.HOOKS}
        self._undo = []
        for module, attr, key in self.HOOKS:
            fn = getattr(module, attr)
            setattr(module, attr, self._timed(fn, key))
            self._undo.append((module, attr, fn))

    def _timed(self, fn, key):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.ms[key] += (time.perf_counter() - t) * 1e3
            return out
        return timed

    def close(self) -> None:
        for module, attr, fn in self._undo:
            setattr(module, attr, fn)


def train_cfg(name: str, n_layers: int) -> TransformerConfig:
    base = {"llama3_8b": TransformerConfig.llama3_8b,
            "mixtral_8x7b": TransformerConfig.mixtral_8x7b,
            "gemma_2b_widths": lambda: TransformerConfig(**GEMMA_2B)}[name]()
    return dataclasses.replace(base, n_layers=n_layers)


def train_steps(model, params, batch, n: int, after_first=None,
                **step_kw) -> dict:
    """``n`` steps of ``model.make_train_step(**step_kw)``: the losses, each
    step's wall ms, the collectives' ms, K1/K3/K4 launches and the peak
    bytes; ``after_first(params)`` reads the first step's gradients (they
    stay on the leaves until the next step)."""
    step = model.make_train_step(**step_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kernel in (fa.FLASH_FWD, fa.FLASH_BWD_DKDV, fa.FLASH_BWD_DQ):
        kernel.launches = 0
    clock = CollectiveClock()
    ms = dict.fromkeys(clock.ms, 0.0)
    state, losses, step_ms, first = None, [], [], None
    try:
        for i in range(n):
            t = time.perf_counter()
            params, state, loss = step(params, state, batch)
            losses.append(loss.item())  # waits for the step
            step_ms.append((time.perf_counter() - t) * 1e3)
            if i == 0 and after_first is not None:
                clock.close()  # the check's own reads are not the step's
                ms = {k: ms[k] + v for k, v in clock.ms.items()}
                first = after_first(params)
                clock = CollectiveClock()
    finally:
        clock.close()
    ms = {k: ms[k] + v for k, v in clock.ms.items()}
    return {"params": params, "losses": losses, "step_ms": step_ms,
            "collective_ms": ms, "first": first,
            "launches": {"flash_fwd": fa.FLASH_FWD.launches,
                         "flash_bwd_dkdv": fa.FLASH_BWD_DKDV.launches,
                         "flash_bwd_dq": fa.FLASH_BWD_DQ.launches},
            "peak_bytes": torch.cuda.max_memory_allocated()}


def replicated_spread(params, cfg, mesh) -> float:
    """The largest |difference| across the ranks of a leaf that ``mesh``
    replicates (every rank of an axis the leaf's spec does not name holds
    the same bits): 0.0 when every rank's bits hash alike, else the max
    of (max - min) over the ranks of the leaves that differ. Under pp the
    layers are each stage's own: only the embedding, ln_f and the head are
    replicas."""
    axes = set(axis_sizes(mesh))
    spread = 0.0
    pairs = transformer.leaf_specs(params, param_specs(cfg, mesh))
    if "pp" in axes:
        pairs = pairs[:1] + pairs[-2:]
        axes.discard("pp")
    for leaf, spec in pairs:
        if axes and axes <= {a for a in spec if a}:
            continue  # sharded over every axis: no replica
        bits = leaf.detach().contiguous().view(torch.int32).flatten()
        digest = torch.zeros(2, dtype=torch.int64, device=bits.device)
        for start in range(0, bits.numel(), 1 << 26):  # bounded temporaries
            chunk = bits[start:start + (1 << 26)].long()
            weights = (torch.arange(chunk.numel(), device=bits.device)
                       + start) % 65521 + 1
            digest += torch.stack([chunk.sum(), (chunk * weights).sum()])
        digests = [torch.empty_like(digest) for _ in range(dist.get_world_size())]
        dist.all_gather(digests, digest)
        if all(torch.equal(d, digests[0]) for d in digests):
            continue
        hi, lo = leaf.detach().clone(), leaf.detach().clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        spread = max(spread, (hi - lo).abs().max().item())
    return spread


def single_card_reference(cfg, seed, mesh, batch, dev) -> dict:
    """One card's loss and gradient on the masters of ``seed`` and the whole
    batch (``loss_fn`` and one backward, as a train step's first), and of
    each leaf's gradient the block this rank holds under ``mesh``, on the
    host; with the forward and backward's ms."""
    params = transformer.Transformer(cfg).init(
        torch.Generator(device=dev).manual_seed(seed), dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss = transformer.loss_fn(params, batch, cfg)
    loss.backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    return {"loss": loss.item(), "grad_blocks": grad_blocks(params, cfg, mesh),
            "ms": ms}


def grad_errors(params, cfg, mesh, blocks) -> list[float]:
    """Each leaf's ||g - g_one_card|| / ||g_one_card|| on this rank's block
    (the gradients after ``reduce_gradients``, before the update)."""
    errs = []
    for (w, _), want in zip(transformer.leaf_specs(
            params, param_specs(cfg, mesh)), blocks):
        diff = torch.linalg.vector_norm(w.grad.float().cpu() - want)
        errs.append((diff / torch.linalg.vector_norm(want)).item())
    return errs


def grad_blocks(params, cfg, mesh) -> list:
    """Each leaf's gradient, on the host, in the shard ``mesh`` gives this
    rank (``shard_params`` of the gradient tree: its blocks under the specs
    and, under pp, its stage's layers), in ``param_leaves``' order."""
    def grads(tree):
        if isinstance(tree, dict):
            return {k: grads(x) for k, x in tree.items()}
        if isinstance(tree, list):
            return [grads(x) for x in tree]
        return tree.grad
    return transformer.param_leaves(
        shard_params(grads(params), cfg, mesh, "cpu"))


def single_card_steps(cfg, seed, mesh, batch, dev, n_steps: int,
                      **step_kw) -> dict:
    """One card's ``n_steps`` train steps on the masters of ``seed`` and the
    whole batch: the losses, and of the first step's gradients the blocks
    this rank holds under ``mesh``, on the host."""
    model = transformer.Transformer(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    blocks = []
    run = train_steps(model, params, batch, n_steps,
                      lambda p: blocks.extend(grad_blocks(p, cfg, mesh)),
                      **step_kw)
    return {"losses": run["losses"], "grad_blocks": blocks,
            "step_ms": run["step_ms"], "peak_bytes": run["peak_bytes"]}


def train_sp_rank(rank: int, dev) -> dict:
    """One rank of ``train_sp``: one card's TRAIN_SP_STEPS steps (in turns),
    then the same steps at sp=2 with the ring and with Ulysses on the
    rank's block of positions."""
    cfg = train_cfg("llama3_8b", TRAIN_SP_LAYERS)
    mesh = make_mesh({"sp": SP}, device_type="cuda")
    whole = token_batch(np.random.default_rng(8), cfg, 1, TRAIN_SP_L, dev)
    ref = build_in_turns(rank, SP, lambda: single_card_steps(
        cfg, 60, mesh, whole, dev, TRAIN_SP_STEPS))
    out = {"single_card": {k: ref[k] for k in ("losses", "step_ms")}}
    for attn in ("ring", "ulysses"):
        c = dataclasses.replace(cfg, sp_attention=attn)
        model = transformer.Transformer(c, mesh)
        params = model.init(torch.Generator(device=dev).manual_seed(60), dev)
        batch = model.batch_slice(whole)
        run = train_steps(model, params, batch, TRAIN_SP_STEPS,
                          lambda p: grad_errors(p, c, mesh,
                                                ref["grad_blocks"]))
        run["spread"] = replicated_spread(run.pop("params"), c, mesh)
        run["positions"] = batch["tokens"].shape[1]
        run["mesh"] = mesh_shape_key(mesh)
        out[attn] = run
        del params, model, batch
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_pp_rank(rank: int, dev) -> dict:
    """One rank of ``train_pp``: one card's TRAIN_PP_STEPS steps of the
    4-layer cut (in turns), then the same steps through the pipeline at
    pp=2 on the rank's stage (2 layers, the embedding and the head)."""
    cfg = train_cfg("llama3_8b", TRAIN_PP_LAYERS)
    mesh = make_mesh({"pp": PP}, device_type="cuda")
    whole = token_batch(np.random.default_rng(9), cfg, TRAIN_PP_B,
                        TRAIN_PP_L, dev)
    ref = build_in_turns(rank, PP, lambda: single_card_steps(
        cfg, 70, mesh, whole, dev, TRAIN_PP_STEPS))
    model = transformer.Transformer(cfg, mesh)
    params = model.init(torch.Generator(device=dev).manual_seed(70), dev)
    held = {"layers": len(params["layers"]),
            "parameters": transformer.n_params(params)}
    run = train_steps(model, params, whole, TRAIN_PP_STEPS,
                      lambda p: grad_errors(p, cfg, mesh, ref["grad_blocks"]),
                      n_microbatches=TRAIN_PP_MICROBATCHES)
    run["spread"] = replicated_spread(run.pop("params"), cfg, mesh)
    run["mesh"] = mesh_shape_key(mesh)
    run["held"] = held
    run["single_card"] = {k: ref[k] for k in ("losses", "step_ms",
                                              "peak_bytes")}
    return run


def mesh_train_run(rank: int, dev, key: str, axes: dict, model_name: str,
                   n_layers: int, n_steps: int, seed: int) -> dict:
    """One case of the two-rank training spawn: the ranks first take turns
    computing one card's loss and gradient on the whole batch from the same
    seed (keeping their blocks of it on the host; for ``train_tp_kv`` one
    card's ``n_steps`` steps, each loss held later), then train under the
    mesh on their shard of those masters and their rows of the batch; the
    first step's gradients are held to the blocks."""
    cfg = train_cfg(model_name, n_layers)
    mesh = make_mesh(axes, device_type="cuda")
    whole = token_batch(np.random.default_rng(6), cfg, TRAIN_B, TRAIN_L, dev)
    if key == "train_tp_kv":
        ref = build_in_turns(rank, TP, lambda: single_card_steps(
            cfg, seed, mesh, whole, dev, n_steps))
        ref.update(loss=ref["losses"][0], ms=ref["step_ms"][0])
    else:
        ref = build_in_turns(rank, TP, lambda: single_card_reference(
            cfg, seed, mesh, whole, dev))
    model = transformer.Transformer(cfg, mesh)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    batch = model.batch_slice(whole)
    run = train_steps(model, params, batch, n_steps,
                      lambda p: grad_errors(p, cfg, mesh, ref["grad_blocks"]))
    run["spread"] = replicated_spread(run.pop("params"), cfg, mesh)
    run["rows"] = batch["tokens"].shape[0]
    run["mesh"] = mesh_shape_key(mesh)
    run["single_card"] = {"loss": ref["loss"], "fwd_bwd_ms": ref["ms"],
                          "losses": ref.get("losses")}
    return run


def train_tp_kv_rounding_control(dev) -> dict:
    """``train_tp_kv``'s masters, batch and steps on one card, with plain
    products and with tp=2's roundings (``tp_split_qeinsum``): the drift
    tp's rounding alone makes on this run's steep descent (a 256000-token
    vocabulary memorizes one batch within four steps), the yardstick of
    ``train_tp_kv``'s losses, as ``train_tp_rounding_control`` is
    ``train_tp``'s."""
    cfg = train_cfg("gemma_2b_widths", TRAIN_TP_KV_LAYERS)
    batch = token_batch(np.random.default_rng(6), cfg, TRAIN_B, TRAIN_L, dev)
    losses = {}
    for name, products in (("plain", PLAIN_QEINSUM),
                           ("tp_roundings", tp_split_qeinsum)):
        model = transformer.Transformer(cfg)
        params = model.init(
            torch.Generator(device=dev).manual_seed(TRAIN_TP_KV_SEED), dev)
        transformer.qeinsum = products
        try:
            losses[name] = train_steps(model, params, batch,
                                       TRAIN_TP_KV_STEPS)["losses"]
        finally:
            transformer.qeinsum = PLAIN_QEINSUM
        del params, model
        gc.collect()
        torch.cuda.empty_cache()
    drift = [abs(g - w) / abs(w)
             for g, w in zip(losses["tp_roundings"], losses["plain"])]
    return {"phase": "train_tp_kv_rounding_control",
            "layers": TRAIN_TP_KV_LAYERS, "B": TRAIN_B, "L": TRAIN_L,
            "tp_emulated": TP, "losses": losses["tp_roundings"],
            "plain_losses": losses["plain"], "rel_err_vs_plain": drift}


def train_mesh_rank(rank: int, directory: str) -> dict:
    """One rank of the two-rank training spawn: train_tp (train_path at
    tp=2), then each TRAIN_MESH_CASES step. For each, the ranks first take
    turns computing one card's loss and gradient on the whole batch from
    the same seed (keeping their blocks of it on the host), then train
    under the mesh on their shard of those masters and their rows of the
    batch; the first step's gradients are held to the blocks. Then the sp
    and pipeline phases, and ``vision_generate_rank``'s (``checkpoint_pp``
    writes into ``directory``)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    runs = [("train_tp", {"tp": TP}, "llama3_8b", TRAIN_LAYERS, TRAIN_STEPS,
             10)]
    runs += [(f"train_mesh_{name}", axes, model_name, TRAIN_MESH_LAYERS,
              TRAIN_MESH_STEPS, 50 + i)
             for i, (name, (axes, model_name)) in
             enumerate(TRAIN_MESH_CASES.items())]
    # tp=2 over one KV head: each rank trains a copy of it
    runs.append(("train_tp_kv", {"tp": TP}, "gemma_2b_widths",
                 TRAIN_TP_KV_LAYERS, TRAIN_TP_KV_STEPS, TRAIN_TP_KV_SEED))
    for key, axes, model_name, n_layers, n_steps, seed in runs:
        out[key] = mesh_train_run(rank, dev, key, axes, model_name, n_layers,
                                  n_steps, seed)
        gc.collect()
        torch.cuda.empty_cache()
    # the sp backward and the pipeline (PR 12's phases), on the same ranks
    for key, phase in (("sp_attention_grad", lambda: sp_attention_grad_rank(dev)),
                       ("train_sp", lambda: train_sp_rank(rank, dev)),
                       ("train_pp", lambda: train_pp_rank(rank, dev))):
        t = time.perf_counter()
        out[key] = phase()
        out[key]["seconds"] = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()
    out.update(vision_generate_rank(rank, directory))
    return out


def train_mesh_phases(dev, how, train, control, control_kv) -> list[dict]:
    """``train_tp`` and ``train_mesh``: two ranks (the transport of the tp
    phases) train under a mesh. Each case's first loss (the same masters
    and batch as one card's) within TRAIN_LOSS_TOL of one card's, and each
    leaf's first gradient within TRAIN_GRAD_TOL of one card's on the
    rank's block; the replicated leaves' spread across the ranks 0 after
    the last step; K1/K3/K4 once per layer and step on each rank. train_tp
    runs train_path's steps on train_path's masters and batch: each of its
    losses, and each of ``control``'s (train_tp_rounding_control), within
    TRAIN_TP_LOSS_TOL of train_path's at that step."""
    drift = [abs(g - w) / abs(w)
             for g, w in zip(control["losses"], train["losses"])]
    check(all(d <= tol for d, tol in zip(drift, TRAIN_TP_LOSS_TOL)),
          f"train_tp_rounding_control: losses {control['losses']} against "
          f"train_path's {train['losses']} (rel {drift}), over "
          f"{TRAIN_TP_LOSS_TOL}")
    t = time.perf_counter()
    directory = tempfile.mkdtemp(prefix="bci-checkpoint-pp-")
    try:
        ranks = spawn(train_mesh_rank, TP, device_type="cuda",
                      backend=how["backend"], args=(directory,), timeout=900)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    spawn_s = time.perf_counter() - t
    out = []
    cases = [("train_tp", {"tp": TP}, "llama3_8b", TRAIN_LAYERS,
              TRAIN_STEPS)]
    cases += [(f"train_mesh_{name}", axes, model_name, TRAIN_MESH_LAYERS,
               TRAIN_MESH_STEPS)
              for name, (axes, model_name) in TRAIN_MESH_CASES.items()]
    cases.append(("train_tp_kv", {"tp": TP}, "gemma_2b_widths",
                  TRAIN_TP_KV_LAYERS, TRAIN_TP_KV_STEPS))
    for key, axes, model_name, n_layers, n_steps in cases:
        runs = [r[key] for r in ranks]
        single = runs[0]["single_card"]["loss"]
        for r, run in enumerate(runs):
            first_rel = abs(run["losses"][0] - single) / abs(single)
            check(all(np.isfinite(run["losses"]))
                  and first_rel <= TRAIN_LOSS_TOL,
                  f"{key} rank {r}: first loss {run['losses'][0]} against "
                  f"one card's {single} (rel {first_rel})")
            check(run["losses"] == runs[0]["losses"],
                  f"{key}: rank {r}'s losses differ from rank 0's")
            check(max(run["first"]) <= TRAIN_GRAD_TOL,
                  f"{key} rank {r}: first gradients {run['first']} against "
                  f"one card's, over {TRAIN_GRAD_TOL}")
            check(run["spread"] == 0.0,
                  f"{key} rank {r}: replicated leaves differ across the ranks "
                  f"by {run['spread']}")
            want_k = n_layers * n_steps
            check(all(n == want_k for n in run["launches"].values()),
                  f"{key} rank {r}: launches {run['launches']}, predicted "
                  f"{want_k} each")
        lead = runs[0]
        p50 = float(np.median(lead["step_ms"][1:] or lead["step_ms"]))
        tokens = TRAIN_B * TRAIN_L
        rec = {
            "phase": key if key in ("train_tp", "train_tp_kv") else "train_mesh",
            "case": key, "mesh": lead["mesh"], "config": model_name,
            "layers": n_layers, "steps": n_steps, "backend": how["backend"],
            "cards": how["cards"], "B": TRAIN_B, "L": TRAIN_L,
            "losses": lead["losses"], "single_card_first_loss": single,
            "first_loss_rel_err": abs(lead["losses"][0] - single) / abs(single),
            "loss_tolerance": TRAIN_LOSS_TOL,
            "first_grad_max_rel_err": max(max(r["first"]) for r in runs),
            "grad_tolerance": TRAIN_GRAD_TOL,
            "step_ms": lead["step_ms"], "step_ms_p50": p50,
            "tokens_per_s": tokens / p50 * 1e3,
            "collective_ms_per_step": {k: v / n_steps for k, v in
                                       lead["collective_ms"].items()},
            "peak_gb_per_rank": [r["peak_bytes"] / 1e9 for r in runs],
            "rows_per_rank": [r["rows"] for r in runs],
            "replicated_leaf_max_abs_diff": max(r["spread"] for r in runs),
            "launches_per_rank": [r["launches"] for r in runs],
            "single_card_fwd_bwd_ms": lead["single_card"]["fwd_bwd_ms"],
            "spawn_s": spawn_s,
        }
        if key == "train_tp":
            rel = [abs(g - w) / abs(w)
                   for g, w in zip(lead["losses"], train["losses"])]
            check(all(d <= tol for d, tol in zip(rel, TRAIN_TP_LOSS_TOL)),
                  f"train_tp: losses {lead['losses']} against train_path's "
                  f"{train['losses']} (rel {rel}), over {TRAIN_TP_LOSS_TOL}")
            rec.update(
                train_path_losses=train["losses"],
                loss_rel_err_vs_train_path=rel,
                loss_tolerance_vs_train_path=list(TRAIN_TP_LOSS_TOL),
                control_losses=control["losses"],
                control_rel_err_vs_train_path=drift,
                control_first_grad_max_rel_err=control[
                    "first_grad_max_rel_err"],
                loss_rel_err_vs_control=[
                    abs(g - w) / abs(w)
                    for g, w in zip(lead["losses"], control["losses"])],
                train_path_step_ms_p50=train["step_ms_p50_2_to_4"],
                train_path_peak_gb=train["peak_memory_gb"])
        if key == "train_tp_kv":
            # each step's loss against one card's, and the rounding
            # control's, under the limits set from that control
            want = lead["single_card"]["losses"]
            rel = [abs(g - w) / abs(w) for g, w in zip(lead["losses"], want)]
            drift = control_kv["rel_err_vs_plain"]
            for what, errs in (("train_tp_kv", rel),
                               ("train_tp_kv_rounding_control", drift)):
                check(all(d <= tol for d, tol in zip(errs, TRAIN_TP_KV_LOSS_TOL)),
                      f"{what}: losses against one card's {want} (rel {errs}), "
                      f"over {TRAIN_TP_KV_LOSS_TOL}")
            rec.update(single_card_losses=want, loss_rel_err_vs_single_card=rel,
                       loss_tolerance_vs_single_card=list(TRAIN_TP_KV_LOSS_TOL),
                       control_losses=control_kv["losses"],
                       control_rel_err_vs_single_card=drift,
                       kv_heads=1, head_dim=GEMMA_2B["d_model"]
                       // GEMMA_2B["n_heads"])
        out.append(rec)
    out.append(sp_attention_grad_report([r["sp_attention_grad"] for r in ranks],
                                        how))
    out += train_sp_reports([r["train_sp"] for r in ranks], how)
    out.append(train_pp_report([r["train_pp"] for r in ranks], how))
    out += vision_generate_reports(ranks, how)
    return out


def sp_attention_grad_report(ranks, how) -> dict:
    """``sp_attention_grad``: each run's dq/dk/dv on every rank within
    BWD_TOL of one card's backward (max error over max gradient; per row
    it is reported, not held: a row whose gradient is small carries the
    bf16 roundings of both sides at its own scale), and its
    K3/K4 launches as the ring's geometry gives them: under ``causal`` rank
    r attends r + 1 hops; with the window the earlier hop is a boundary
    block (torch), so one each; Ulysses one each."""
    rec = {"phase": "sp_attention_grad", "shape": SP_ATTN_SHAPE, "sp": SP,
           "window": SP_GRAD_WINDOW, "tolerance": BWD_TOL,
           "backend": how["backend"], "cards": how["cards"],
           "seconds": ranks[0]["seconds"]}
    for name in ("ring_causal", "ring_window", "ulysses"):
        runs = [r[name] for r in ranks]
        for r, run in enumerate(runs):
            hops = r + 1 if name == "ring_causal" else 1
            check(max(run["rel_err"].values()) <= BWD_TOL,
                  f"sp_attention_grad {name} rank {r}: {run['rel_err']} "
                  f"against one card's backward, over {BWD_TOL}")
            for kernel in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
                check(run["launches"][kernel] == hops,
                      f"sp_attention_grad {name} rank {r}: launches "
                      f"{run['launches']}, predicted {hops} each")
        rec[name] = {
            "rel_err_per_rank": [run["rel_err"] for run in runs],
            "row_rel_err_per_rank": [run["row_rel_err"] for run in runs],
            "bitwise_vs_single_per_rank": [run["bitwise"] for run in runs],
            "backward_ms_per_rank": [run["backward_ms"] for run in runs],
            "exchange_ms_per_rank": [run["exchange_ms"] for run in runs],
            "launches_per_rank": [run["launches"] for run in runs],
        }
    return rec


def check_mesh_train(name, runs, ref_losses, want_launches) -> None:
    """A training run under a mesh against one card's steps: every loss
    within TRAIN_LOSS_TOL, the first gradients within TRAIN_GRAD_TOL, the
    ranks' losses alike, the replicated leaves alike, and K1/K3/K4 as
    predicted on each rank (``want_launches[r]``)."""
    for r, run in enumerate(runs):
        rel = [abs(g - w) / abs(w) for g, w in zip(run["losses"], ref_losses)]
        check(all(np.isfinite(run["losses"]))
              and len(rel) == len(ref_losses)
              and max(rel) <= TRAIN_LOSS_TOL,
              f"{name} rank {r}: losses {run['losses']} against one card's "
              f"{ref_losses} (rel {rel})")
        check(run["losses"] == runs[0]["losses"],
              f"{name}: rank {r}'s losses differ from rank 0's")
        check(max(run["first"]) <= TRAIN_GRAD_TOL,
              f"{name} rank {r}: first gradients {max(run['first'])} from "
              f"one card's, over {TRAIN_GRAD_TOL}")
        check(run["spread"] == 0.0,
              f"{name} rank {r}: replicated leaves differ by {run['spread']}")
        check(all(n == want_launches[r] for n in run["launches"].values()),
              f"{name} rank {r}: launches {run['launches']}, predicted "
              f"{want_launches[r]} each")


def mesh_train_record(phase, case, runs, ref, tokens, how) -> dict:
    lead = runs[0]
    p50 = float(np.median(lead["step_ms"][1:] or lead["step_ms"]))
    n = len(lead["step_ms"])
    return {
        "phase": phase, "case": case, "mesh": lead["mesh"],
        "config": "llama3_8b", "backend": how["backend"],
        "cards": how["cards"], "steps": n, "losses": lead["losses"],
        "single_card_losses": ref["losses"],
        "loss_rel_err": [abs(g - w) / abs(w)
                         for g, w in zip(lead["losses"], ref["losses"])],
        "loss_tolerance": TRAIN_LOSS_TOL,
        "first_grad_max_rel_err": max(max(r["first"]) for r in runs),
        "grad_tolerance": TRAIN_GRAD_TOL,
        "step_ms": lead["step_ms"], "step_ms_p50": p50,
        "tokens_per_s": tokens / p50 * 1e3,
        "single_card_step_ms": ref["step_ms"],
        "collective_ms_per_step": {k: v / n for k, v in
                                   lead["collective_ms"].items()},
        "collective_ms_per_step_per_rank": [
            {k: v / n for k, v in r["collective_ms"].items()} for r in runs],
        "peak_gb_per_rank": [r["peak_bytes"] / 1e9 for r in runs],
        "replicated_leaf_max_abs_diff": max(r["spread"] for r in runs),
        "launches_per_rank": [r["launches"] for r in runs],
    }


def train_sp_reports(ranks, how) -> list[dict]:
    """``train_sp``: the ring's and Ulysses' steps at sp=2 against one
    card's (``check_mesh_train``); per rank K1/K3/K4 = layers x steps x
    the hops it attends (the ring: rank + 1; Ulysses: 1)."""
    ref = ranks[0]["single_card"]
    for r, rank in enumerate(ranks):
        check(rank["single_card"]["losses"] == ref["losses"],
              f"train_sp: one card's losses differ on rank {r}")
    out = []
    for attn in ("ring", "ulysses"):
        runs = [r[attn] for r in ranks]
        per = TRAIN_SP_LAYERS * TRAIN_SP_STEPS
        want = [per * (r + 1 if attn == "ring" else 1)
                for r in range(len(runs))]
        check_mesh_train(f"train_sp {attn}", runs, ref["losses"], want)
        check(all(run["positions"] == TRAIN_SP_L // SP for run in runs),
              "train_sp: a rank does not hold its block of positions")
        rec = mesh_train_record("train_sp", f"train_sp_{attn}", runs, ref,
                                TRAIN_SP_L, how)
        rec.update(layers=TRAIN_SP_LAYERS, B=1, L=TRAIN_SP_L,
                   sp_attention=attn, seconds=ranks[0]["seconds"])
        out.append(rec)
    return out


def train_pp_report(runs, how) -> dict:
    """``train_pp``: the pipeline's steps against one card's 4-layer steps
    (``check_mesh_train``); each rank holds its 2 layers; per rank
    K1/K3/K4 = its layers x microbatches x steps (each stage runs its real
    microbatches only, no bubble tick); the schedule's bubble share and
    each rank's share of its steps spent in the stage-to-stage exchanges
    (waits included)."""
    ref = runs[0]["single_card"]
    per_stage = TRAIN_PP_LAYERS // PP
    want = per_stage * TRAIN_PP_MICROBATCHES * TRAIN_PP_STEPS
    check_mesh_train("train_pp", runs, ref["losses"], [want] * len(runs))
    for r, run in enumerate(runs):
        check(run["held"]["layers"] == per_stage,
              f"train_pp rank {r}: holds {run['held']['layers']} layers")
    rec = mesh_train_record("train_pp", "train_pp", runs, ref,
                            TRAIN_PP_B * TRAIN_PP_L, how)
    M, S = TRAIN_PP_MICROBATCHES, PP
    rec.update(
        layers=TRAIN_PP_LAYERS, layers_per_rank=[r["held"]["layers"]
                                                 for r in runs],
        parameters_per_rank=[r["held"]["parameters"] for r in runs],
        B=TRAIN_PP_B, L=TRAIN_PP_L, microbatches=M,
        schedule_bubble_share=(S - 1) / (M + S - 1),
        p2p_share_of_step_per_rank=[
            r["collective_ms"]["p2p"] / sum(r["step_ms"]) for r in runs],
        single_card_peak_gb=ref["peak_bytes"] / 1e9,
        seconds=runs[0]["seconds"])
    return rec


# ------------------------------------------------------------ the vision family


def ptxas_usage(kernels) -> dict:
    """Each kernel instance's registers and spill bytes from its build's
    ptxas lines: ``{source: {"d64" | "d128": {...}}}``; the template
    argument NB (head dim 64 NB) is in the mangled entry name."""
    out = {}
    for k in kernels:
        name = None
        for line in k.build_log().splitlines():
            if "entry function" in line:
                name = ("d64" if "ILi1E" in line else "d128" if "ILi2E" in line
                        else line.split("'")[1])
                out.setdefault(k.name, {})[name] = {}
            elif name is not None and "spill stores" in line:
                parts = line.split(",")
                out[k.name][name]["spill_stores"] = int(
                    parts[1].split()[0])
                out[k.name][name]["spill_loads"] = int(parts[2].split()[0])
            elif name is not None and "registers" in line:
                out[k.name][name]["registers"] = int(
                    line.split("Used")[1].split()[0])
    return out


def check_flash_d64(timer, dev) -> dict:
    """K1, and K3/K4 on K1's own out and lse, at head dim 64 on D64_CASES:
    each against its plain version (KERNEL_TOL / K1_ROW_TOL, BWD_TOL), timed
    beside its bound, its plain version and SDPA."""
    fwd, bwd = [], []
    for heads, case in D64_CASES:
        fwd += check_flash(timer, dev, heads, [case], D=64)
        bwd += check_flash_bwd(timer, dev, heads, [(*case, False)], D=64)
    return {"phase": "flash_d64", "D": 64, "tolerance": KERNEL_TOL,
            "row_tolerance": K1_ROW_TOL, "bwd_tolerance": BWD_TOL,
            "forward": fwd, "backward": bwd}


# flash_head_dims: K1, K3 and K4 at head dims and dtypes the D = 64 / 128
# bf16 instances alone do not take: bf16 at 16, 32, 72, 80 and 96 (read in
# place by the D = 64 / 128 instances), 20 (no multiple of 8: zero-padded to
# 64), 200 and 256 (the mma.sync instance), f32 at 16, 64 and 128 (the
# CUDA-core kernel); a causal L = 1024 case and a ragged non-causal one each,
# at H = 32 over KVH = 8, D > 128 at Gemma-2B's 8 heads over 1 KV head
FLASH_HEAD_DIMS = ([(D, torch.bfloat16) for D in (16, 20, 32, 72, 80, 96, 200,
                                                   256)]
                   + [(D, torch.float32) for D in (16, 64, 128)])
HEAD_DIM_CASES = [(1, 1024, 1024, True, None), (1, 300, 700, False, None)]
# paged_head_dims: K2 at head dims 16, 80 and 256 with 1, 8, 16 and 48 query
# heads per KV head (StarCoder's 48 over 1), over 2 KV heads, in bf16 and
# f32, on the lengths and table of K2_MAIN_CASE
PAGED_HEAD_DIMS = (16, 80, 256)
PAGED_REPS = (1, 8, 16, 48)
PAGED_KVH = 2
# tiny_card: TransformerConfig.tiny() (head dim 16, 4 heads, vocab 256,
# max_seq_len 128), 8 greedy prompts of 16-80 tokens (numpy seed 11), 16 new
# tokens each, on 4 rows with pages of 16; one train step of 2 x 64 tokens
TINY_GEOMETRY = dict(max_batch=4, page_size=16, max_pages_per_seq=8,
                     n_pages=1 + 4 * 8)
TINY_NEW_TOKENS, TINY_TRAIN_L = 16, 64
# wide_head: Gemma-2B's published widths (google/gemma-2b config.json:
# hidden 2048, 18 layers, 8 heads over 1 KV head of dim 256, intermediate
# 16384, vocab 256000, rope theta 10000) as a llama-style decoder of
# TransformerConfig's fields (no GeGLU, tied head or scaled embedding):
# 3.03 B parameters, 6.06 GB in bf16
GEMMA_2B = dict(vocab_size=256000, d_model=2048, n_layers=18, n_heads=8,
                n_kv_heads=1, d_ff=16384, max_seq_len=8192, rope_theta=10000.0)
# train_tp_kv: Gemma-2B widths cut to 2 layers at tp=2 (1 KV head: each rank
# a copy of it), 4 steps against one card's
TRAIN_TP_KV_LAYERS, TRAIN_TP_KV_STEPS, TRAIN_TP_KV_SEED = 2, 4, 80
# train_tp_kv's losses against one card's, per step, relative, set by
# TRAIN_TP_LOSS_TOL's rule from this configuration's own rounding control
# (train_tp_kv_rounding_control: one card with tp=2's bf16 roundings), which
# is held to the same limits: the loss falls from 12.95 to 0.28 in four
# steps (a 256000-token vocabulary memorizing one batch), so a rounding's
# relative weight grows as the loss shrinks. An NVIDIA H100 80GB HBM3 run at
# 700 W read the control at
# 2.9e-5, 2.5e-4, 3.9e-3, 1.4e-3 and train_tp_kv at 2.9e-5, 2.1e-4, 3.1e-3,
# 2.1e-4 (TRAIN_TP_LOSS_TOL's values, taken over first, failed it at step 3):
# TRAIN_LOSS_TOL where both read under a third of it, else twice the
# control's reading
TRAIN_TP_KV_LOSS_TOL = (TRAIN_LOSS_TOL, TRAIN_LOSS_TOL, 8e-3, 3e-3)


def check_flash_head_dims(timer, dev) -> dict:
    """K1, and K3/K4 on K1's own out and lse, at FLASH_HEAD_DIMS on
    HEAD_DIM_CASES, each against its plain version, timed beside its bound,
    its plain version, SDPA and the pad where the route pads."""
    fwd, bwd = [], []
    for D, dtype in FLASH_HEAD_DIMS:
        heads = (8, 1) if D > 128 else (32, 8)
        fwd += check_flash(timer, dev, heads, HEAD_DIM_CASES, D=D, dtype=dtype)
        bwd += check_flash_bwd(timer, dev, heads,
                               [(*c, False) for c in HEAD_DIM_CASES], D=D,
                               dtype=dtype)
    return {"phase": "flash_head_dims",
            "tolerance": {"bfloat16": KERNEL_TOL, "bfloat16_row": K1_ROW_TOL,
                          "bfloat16_bwd": BWD_TOL, "float32": F32_KERNEL_TOL},
            "forward": fwd, "backward": bwd}


def check_paged_head_dims(timer, dev) -> dict:
    """K2 at PAGED_HEAD_DIMS x PAGED_REPS in bf16 and f32, each against its
    plain version (``check_paged_decode``: KERNEL_TOL and K2_ROW_TOL)."""
    lengths, _, P = K2_CASES[K2_MAIN_CASE]
    rows = []
    for dh in PAGED_HEAD_DIMS:
        for rep in PAGED_REPS:
            for dtype in ("bfloat16", "float32"):
                rows += check_paged_decode(
                    timer, dev, (rep * PAGED_KVH, PAGED_KVH),
                    {f"dh{dh}_rep{rep}_{dtype}": (lengths, dtype, P)}, dh=dh)
    return {"phase": "paged_head_dims", "tolerance": KERNEL_TOL,
            "row_tolerance": K2_ROW_TOL, "cases": rows}


def tiny_card(dev) -> dict:
    """``TransformerConfig.tiny()`` (head dim 16) on the card: served
    through ContinuousBatcher -> Engine in f32 (K1 on the CUDA-core kernel,
    K2 at dh 16) and in bf16 (K1's D = 64 instance, Q/K/V zero-padded), on
    one set of f32 weights drawn on the host, and one train step in each
    (K3/K4 likewise). The f32 greedy tokens equal the port's own on the
    CPU, the f32 step's loss is within F32_KERNEL_TOL of the CPU's, every
    kernel launches once per layer and admission / decode step / step."""
    base = dataclasses.replace(TransformerConfig.tiny(),
                               paged_attention_kernel=True)
    rng = np.random.default_rng(11)
    requests = [(rng.integers(0, base.vocab_size, int(n)).tolist(),
                 TINY_NEW_TOKENS, SamplingParams(), {})
                for n in rng.integers(16, 81, size=8)]
    f32 = dataclasses.replace(base, dtype=torch.float32)
    host = init_params(f32, torch.Generator().manual_seed(12), "cpu")
    batch = token_batch(np.random.default_rng(13), base, 2, TINY_TRAIN_L, "cpu")
    cpu_run = drive(ContinuousBatcher(host, f32, **TINY_GEOMETRY, device="cpu"),
                    requests)
    cpu_loss = transformer.loss_fn(host, batch, f32).item()
    out = {"phase": "tiny_card", "head_dim": base.head_dim,
           "requests": len(requests), "new_tokens": TINY_NEW_TOKENS,
           "cpu_loss": cpu_loss, "tolerance": F32_KERNEL_TOL}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(base, dtype=dtype)
        run = drive(ContinuousBatcher(tree_to(host, dev, dtype), cfg,
                                      **TINY_GEOMETRY, device=dev), requests)
        name = str(dtype).removeprefix("torch.")
        check(all(f == "length" for f in run["finish"]),
              f"tiny_card {name}: finish reasons {run['finish']}")
        check(run["k1_launches"] == cfg.n_layers * len(requests)
              and run["decode_steps"] > 0
              and run["k2_launches"] == cfg.n_layers * run["decode_steps"],
              f"tiny_card {name}: K1 {run['k1_launches']}, K2 "
              f"{run['k2_launches']} over {run['decode_steps']} steps")
        model = transformer.Transformer(cfg)
        masters = tree_to(host, dev, torch.float32, requires_grad=True)
        step = train_steps(model, masters, {k: v.to(dev) for k, v in
                                            batch.items()}, 1)
        (loss,) = step["losses"]
        check(np.isfinite(loss), f"tiny_card {name}: train loss {loss}")
        check(all(n == cfg.n_layers for n in step["launches"].values()),
              f"tiny_card {name}: train launches {step['launches']}")
        rec = {"tokens_equal_cpu": run["tokens"] == cpu_run["tokens"],
               "token_agreement_with_cpu": float(np.mean(
                   [a == b for ta, tb in zip(run["tokens"], cpu_run["tokens"])
                    for a, b in zip(ta, tb)])),
               "k1_launches": run["k1_launches"],
               "k2_launches": run["k2_launches"],
               "decode_steps": run["decode_steps"],
               "train_loss": loss, "train_launches": step["launches"],
               "train_loss_rel_err_vs_cpu": abs(loss - cpu_loss) / abs(cpu_loss)}
        if dtype == torch.float32:
            check(rec["tokens_equal_cpu"],
                  "tiny_card float32: greedy tokens differ from the CPU's")
            check(rec["train_loss_rel_err_vs_cpu"] <= F32_KERNEL_TOL,
                  f"tiny_card float32: loss {loss} against the CPU's {cpu_loss}")
        out[name] = rec
        del masters, model
    out["k1_launches"] = out["float32"]["k1_launches"] + out["bfloat16"][
        "k1_launches"]
    out["k2_launches"] = out["float32"]["k2_launches"] + out["bfloat16"][
        "k2_launches"]
    return out


class plain_attention:
    """Within it, the decoder's attention (``transformer.local_attention``)
    runs K1's plain version: the reference path ``wide_head`` holds its
    served logits against."""

    def __enter__(self):
        self.saved = transformer.local_attention
        transformer.local_attention = (
            lambda q, k, v, causal=True, window=None:
            fa.flash_attention_fwd_plain(q, k, v, causal, window=window)[0])

    def __exit__(self, *exc):
        transformer.local_attention = self.saved


def wide_head(dev) -> dict:
    """A decoder at Gemma-2B's widths (GEMMA_2B: head dim 256, 8 heads over
    one KV head), random bf16 weights, at full depth: main_path's 12
    requests through ContinuousBatcher -> Engine (K1 on the CUDA-core
    kernel at D = 256, K2 at dh 256 with 8 query heads over the KV head);
    tokens/s, TTFT p50 and decode-step p50 beside the weight-streaming
    bound; each request's first-token logits within PATH_LOGIT_TOL of a
    forward through K1's plain version. Then one train step of the first
    BREADTH_CUT_LAYERS layers (f32 masters): K1/K3/K4 once per layer."""
    cfg = TransformerConfig(**GEMMA_2B, paged_attention_kernel=True)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(90))
    n_params = transformer.n_params(params)
    requests = main_requests(cfg.vocab_size)
    run = serve(params, cfg, requests)
    n_req = len(requests)
    check(all(f == "length" for f in run["finish"]),
          f"wide_head: finish reasons {run['finish']}")
    check(run["k1_launches"] == cfg.n_layers * n_req,
          f"wide_head: K1 {run['k1_launches']}, expected {cfg.n_layers} x "
          f"{n_req}")
    check(run["decode_steps"] > 0
          and run["k2_launches"] == cfg.n_layers * run["decode_steps"],
          f"wide_head: K2 {run['k2_launches']} over {run['decode_steps']} "
          "steps")
    with torch.no_grad(), plain_attention():
        err = first_token_err(params, cfg, [p for p, _, _, _ in requests],
                              run["first_logits"])
    check(err <= PATH_LOGIT_TOL,
          f"wide_head: first-token logits {err} from the plain path's")
    generated = sum(len(t) for t in run["tokens"])
    out = {"phase": "wide_head", "config": "gemma-2b widths", **GEMMA_2B,
           "head_dim": cfg.head_dim, "dtype": "bfloat16", "n_params": n_params,
           "weight_gb": 2.0 * n_params / 1e9, "requests": n_req,
           "tokens_per_s": generated / run["wall_s"], "wall_s": run["wall_s"],
           "ttft_p50_ms": float(np.median(run["ttft_s"])) * 1e3,
           "decode_step_p50_ms": float(np.median(run["decode_only_step_ms"])),
           "weight_stream_bound_ms": 2.0 * n_params / HBM_BYTES_PER_S * 1e3,
           "decode_steps": run["decode_steps"],
           "k1_launches": run["k1_launches"], "k2_launches": run["k2_launches"],
           "first_token_rel_err_vs_plain": err,
           "first_token_tolerance": PATH_LOGIT_TOL}
    del params, run
    gc.collect()
    torch.cuda.empty_cache()
    tcfg = dataclasses.replace(cfg, n_layers=BREADTH_CUT_LAYERS)
    model = transformer.Transformer(tcfg)
    masters = model.init(torch.Generator(device=dev).manual_seed(91), dev)
    batch = token_batch(np.random.default_rng(92), tcfg, TRAIN_B, TRAIN_L, dev)
    step = train_steps(model, masters, batch, 1)
    check(np.isfinite(step["losses"][0]),
          f"wide_head: train loss {step['losses']}")
    check(all(n == BREADTH_CUT_LAYERS for n in step["launches"].values()),
          f"wide_head: train launches {step['launches']}")
    out["train"] = {"layers": BREADTH_CUT_LAYERS, "B": TRAIN_B, "L": TRAIN_L,
                    "loss": step["losses"][0], "step_ms": step["step_ms"][0],
                    "peak_gb": step["peak_bytes"] / 1e9,
                    "launches": step["launches"]}
    del masters, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def reset_flash_counts() -> None:
    for kernel in (fa.FLASH_FWD, fa.FLASH_BWD_DKDV, fa.FLASH_BWD_DQ):
        kernel.launches = 0


def flash_counts() -> dict:
    return {"flash_fwd": fa.FLASH_FWD.launches,
            "flash_bwd_dkdv": fa.FLASH_BWD_DKDV.launches,
            "flash_bwd_dq": fa.FLASH_BWD_DQ.launches}


def image_batch(gen, B: int, size: int, classes: int, dev) -> dict:
    """Seeded noise images (NHWC) and labels, made on the card."""
    return {"images": torch.randn(B, size, size, 3, generator=gen, device=dev),
            "labels": torch.randint(0, classes, (B,), generator=gen,
                                    device=dev)}


def leaf_grad_errors(got_leaves, want_leaves) -> list[float]:
    """Each leaf's ||g - g_ref|| / ||g_ref|| (g_ref on the host)."""
    errs = []
    for got, ref in zip(got_leaves, want_leaves, strict=True):
        diff = torch.linalg.vector_norm(got.grad.float().cpu() - ref.grad)
        errs.append((diff / torch.linalg.vector_norm(ref.grad)).item())
    return errs


def named_leaves(tree, prefix="") -> list[tuple[str, torch.Tensor]]:
    """``(dotted path, leaf)`` of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in named_leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def vision_reference(name, module, cfg, params, batch, leaves,
                     hold_grads: bool = True) -> dict:
    """A vision model's logits, loss and first gradients: ``cfg.dtype``
    compute on the card (K1/K3/K4 for the ViT) against the f32 plain path
    on the CPU on the same f32 masters; logits within REFERENCE_TOL of the
    largest, the loss within TRAIN_LOSS_TOL, and with ``hold_grads`` each
    leaf's gradient within TRAIN_GRAD_TOL (every leaf's reported)."""
    for w in leaves(params):  # a gradient of this reference's own
        w.grad = None
    cpu = cpu_f32(params, requires_grad=True)
    cpu_batch = {k: x.cpu() for k, x in batch.items()}
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    with torch.no_grad():
        logits = module.forward(params, batch["images"], cfg).float().cpu()
        want_logits = module.forward(cpu, cpu_batch["images"], f32)
    logit_err = ((logits - want_logits).abs().max()
                 / want_logits.abs().max()).item()
    loss = module.loss_fn(params, batch, cfg)
    loss.backward()
    want = module.loss_fn(cpu, cpu_batch, f32)
    want.backward()
    loss_rel = abs(loss.item() - want.item()) / abs(want.item())
    paths = [path for path, _ in named_leaves(params)]
    grad_rel = dict(zip(paths, leaf_grad_errors(leaves(params), leaves(cpu)),
                        strict=True))
    worst = max(grad_rel, key=grad_rel.get)
    check(logit_err <= REFERENCE_TOL,
          f"{name}: logits {logit_err} from the CPU's, over {REFERENCE_TOL}")
    check(loss_rel <= TRAIN_LOSS_TOL, f"{name}: loss rel err {loss_rel}")
    check(all(np.isfinite(list(grad_rel.values())))
          and (not hold_grads or grad_rel[worst] <= TRAIN_GRAD_TOL),
          f"{name}: grad rel err {grad_rel[worst]} at {worst}")
    return {"dtype": str(cfg.dtype).removeprefix("torch."),
            "logit_rel_err": logit_err, "loss_card": loss.item(),
            "loss_cpu": want.item(), "loss_rel_err": loss_rel,
            "max_grad_rel_err": grad_rel[worst], "worst_leaf": worst,
            "grads_held": hold_grads, "grad_rel_err_by_leaf": grad_rel,
            "tolerance": {"logits": REFERENCE_TOL, "loss": TRAIN_LOSS_TOL,
                          "grad": TRAIN_GRAD_TOL}}


def vit_reference(dev) -> dict:
    """ViT-B/16 widths cut to VIT_REFERENCE_LAYERS layers, B =
    VIT_REFERENCE_B: ``vision_reference`` through K1/K3/K4 at head dim 64."""
    cfg = dataclasses.replace(vit.ViTConfig.vit_b16(),
                              n_layers=VIT_REFERENCE_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(81)
    params = vit.ViT(cfg).init(gen, dev)
    batch = image_batch(gen, VIT_REFERENCE_B, cfg.image_size, cfg.num_classes,
                        dev)
    reset_flash_counts()
    rec = vision_reference("vit_reference", vit, cfg, params, batch,
                           vit.param_leaves)
    return {"phase": "vit_reference", "layers": VIT_REFERENCE_LAYERS,
            "B": VIT_REFERENCE_B, "launches": flash_counts(), **rec}


def vit_flops_per_image(cfg) -> float:
    """A ViT forward's multiply-adds x 2 for one image: the patchify conv,
    each layer's four projections, QK^T and PV, the MLP, and the head."""
    T, d = cfg.n_patches, cfg.d_model
    per_layer = 2.0 * T * d * (4 * d + 2 * cfg.d_ff) + 4.0 * T * T * d
    return (2.0 * T * d * 3 * cfg.patch_size ** 2 + cfg.n_layers * per_layer
            + 2.0 * d * cfg.num_classes)


def vision_steps(name, model, params, batch, n_steps: int,
                 optimizer=None) -> dict:
    """``model.apply`` once, then ``n_steps`` train steps on one fixed
    batch: the logits' shape, the losses, each step's wall ms, the peak
    bytes and K1/K3/K4's launches in each."""
    reset_flash_counts()
    with torch.no_grad():
        logits = model.apply(params, batch["images"])
    torch.cuda.synchronize()
    check(bool(torch.isfinite(logits).all()), f"{name}: apply is not finite")
    apply_launches = flash_counts()
    step = model.make_train_step(optimizer)
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()
    state, losses, step_ms = None, [], []
    for _ in range(n_steps):
        t = time.perf_counter()
        params, state, loss = step(params, state, batch)
        losses.append(loss.item())  # waits for the step
        step_ms.append((time.perf_counter() - t) * 1e3)
    check(all(np.isfinite(losses)), f"{name}: losses {losses}")
    check(losses[-1] < losses[0], f"{name}: loss did not fall: {losses}")
    p50 = float(np.median(step_ms[1:]))
    B = batch["images"].shape[0]
    return {"logits_shape": list(logits.shape),
            "apply_launches": apply_launches, "launches": flash_counts(),
            "losses": losses, "step_ms": step_ms, "step_ms_p50_2_to_4": p50,
            "images_per_s": B / p50 * 1e3,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def vit_phase(dev) -> dict:
    """ViT-B/16 whole (12 layers, 224², B = VIT_B): ``apply`` (K1 once per
    layer), then VIT_STEPS AdamW steps (K1, K3, K4 once per layer and step)
    on one fixed batch of seeded images and labels; the losses fall."""
    cfg = vit.ViTConfig.vit_b16()
    model = vit.ViT(cfg)
    gen = torch.Generator(device=dev).manual_seed(80)
    params = model.init(gen, dev)
    batch = image_batch(gen, VIT_B, cfg.image_size, cfg.num_classes, dev)
    run = vision_steps("vit", model, params, batch, VIT_STEPS)
    check(run["logits_shape"] == [VIT_B, cfg.num_classes],
          f"vit: logits {run['logits_shape']}")
    check(run["apply_launches"]["flash_fwd"] == cfg.n_layers,
          f"vit: apply launched K1 {run['apply_launches']['flash_fwd']} times")
    want = cfg.n_layers * VIT_STEPS
    check(all(n == want for n in run["launches"].values()),
          f"vit: launches {run['launches']}, predicted {want} each")
    flops = 3.0 * vit_flops_per_image(cfg) * VIT_B
    return {"phase": "vit", "config": "vit_b16", "layers": cfg.n_layers,
            "B": VIT_B, "image_size": cfg.image_size, "steps": VIT_STEPS,
            "dtype": "bfloat16 compute, float32 masters",
            "n_params": vit.n_params(params),
            "model_tflops": flops / run["step_ms_p50_2_to_4"] / 1e9,
            "launches_by_step": {k: v // VIT_STEPS
                                 for k, v in run["launches"].items()},
            **run}


def resnet_reference(dev) -> dict:
    """ResNet-50 cut to its first stage (RESNET_REFERENCE_STAGES) at 224²,
    B = RESNET_REFERENCE_B: ``vision_reference`` twice against PyTorch's
    f32 CPU convs, cuDNN's convs in bf16 (logits and loss held, gradients
    reported) and in f32 (every gradient held too). At random init a
    GroupNorm ResNet's logits are large (a loss of ~40 at B = 64) and its
    softmax saturated, so a few bf16 roundings of the convs move some
    leaves' gradients by a relative 0.2-0.4 (an H100 read 0.21 here and
    0.33-0.37 at dp=2 against one card): the f32 run holds the port's
    convolutions, norms and pool to the CPU's where bf16 cannot."""
    cfg = dataclasses.replace(vision.ResNetConfig.resnet50(),
                              stage_sizes=RESNET_REFERENCE_STAGES)
    gen = torch.Generator(device=dev).manual_seed(83)
    params = vision.ResNet(cfg).init(gen, dev)
    batch = image_batch(gen, RESNET_REFERENCE_B, 224, cfg.num_classes, dev)
    bf16 = vision_reference("resnet_reference", vision, cfg, params, batch,
                            vision.param_leaves, hold_grads=False)
    f32 = vision_reference("resnet_reference f32", vision,
                           dataclasses.replace(cfg, dtype=torch.float32),
                           params, batch, vision.param_leaves)
    return {"phase": "resnet_reference", "stages": list(cfg.stage_sizes),
            "B": RESNET_REFERENCE_B, "bf16": bf16, "f32": f32}


def resnet_phase(dev) -> dict:
    """ResNet-50 whole (224², B = RESNET_B): ``apply``, then RESNET_STEPS
    SGD steps (RESNET_LR, momentum 0.9) on one fixed batch; the losses
    fall. cuDNN's convs: no kernel of the port runs."""
    cfg = vision.ResNetConfig.resnet50()
    model = vision.ResNet(cfg)
    gen = torch.Generator(device=dev).manual_seed(82)
    params = model.init(gen, dev)
    batch = image_batch(gen, RESNET_B, 224, cfg.num_classes, dev)
    run = vision_steps("resnet", model, params, batch, RESNET_STEPS,
                       model.make_optimizer(learning_rate=RESNET_LR))
    check(run["logits_shape"] == [RESNET_B, cfg.num_classes],
          f"resnet: logits {run['logits_shape']}")
    check(not any(run["launches"].values()),
          f"resnet: a flash kernel ran: {run['launches']}")
    return {"phase": "resnet", "config": "resnet50", "B": RESNET_B,
            "image_size": 224, "steps": RESNET_STEPS,
            "optimizer": f"SGD lr {RESNET_LR}, momentum 0.9",
            "dtype": "bfloat16 compute, float32 masters",
            "n_params": vision.n_params(params), **run}


# ------------------------ in the training spawn: vision meshes, generation


def grads_of(tree):
    """A parameter tree's gradients, in its layout."""
    if isinstance(tree, dict):
        return {k: grads_of(x) for k, x in tree.items()}
    if isinstance(tree, list):
        return [grads_of(x) for x in tree]
    return tree.grad


def vision_mesh_case(rank, name, axes, build, batch, n_steps, dev) -> dict:
    """One model under ``axes``: one card's loss and first gradients on the
    whole batch (the ranks in turns, each keeping its block), then
    ``n_steps`` steps under the mesh on the rank's shard and rows; the
    first loss and each leaf's first gradient on the rank's block against
    one card's. ``build(mesh)`` gives (model, params, leaves, blocks):
    the model and masters under ``mesh`` (None: one card) of one seed,
    ``leaves(params)`` in a fixed order, and ``blocks(grad_tree, mesh)``
    the rank's blocks of a whole gradient tree in that order."""
    mesh = make_mesh(axes, device_type="cuda")

    def single():
        model, params, leaves, blocks = build(None)
        loss = model.make_train_step()(params, None, batch)[2].item()
        return {"loss": loss, "blocks": [g.float().cpu() for g in blocks(
            grads_of(params), mesh)]}

    ref = build_in_turns(rank, world_of(axes), single)
    model, params, leaves, _ = build(mesh)
    rows = model.batch_slice(batch)
    step = model.make_train_step()
    reset_flash_counts()
    state, losses, step_ms, first = None, [], [], None
    for i in range(n_steps):
        t = time.perf_counter()
        params, state, loss = step(params, state, rows)
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t) * 1e3)
        if i == 0:
            first = [(torch.linalg.vector_norm(w.grad.float().cpu() - g)
                      / torch.linalg.vector_norm(g)).item()
                     for w, g in zip(leaves(params), ref["blocks"],
                                     strict=True)]
    out = {"case": name, "mesh": mesh_shape_key(mesh), "losses": losses,
           "single_card_loss": ref["loss"], "first": first,
           "step_ms": step_ms, "launches": flash_counts(),
           "rows": rows[next(iter(rows))].shape[0]}
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def world_of(axes: dict) -> int:
    return int(np.prod(list(axes.values())))


def vision_mesh_rank(rank: int, dev) -> dict:
    """``vision_mesh`` on this rank: ViT-B/16 one step at each of
    VISION_MESH_VIT_CASES (bf16), ResNet-50 one step at dp=2 (f32), the
    MNIST MLP MNIST_STEPS steps at dp=2, each against one card."""
    gen = torch.Generator(device=dev).manual_seed(84)
    out = {}
    base = vit.ViTConfig.vit_b16()
    vit_batch = image_batch(gen, VISION_MESH_B, base.image_size,
                            base.num_classes, dev)
    for name, (axes, attention) in VISION_MESH_VIT_CASES.items():
        cfg = dataclasses.replace(base, sp_attention=attention)

        def build(mesh, cfg=cfg):
            model = vit.ViT(cfg, mesh)
            params = model.init(torch.Generator(device=dev).manual_seed(85),
                                dev)
            return (model, params, vit.param_leaves,
                    lambda g, m: vit.param_leaves(vit.shard_params(
                        g, cfg, m, "cpu")))

        out[f"vit_{name}"] = vision_mesh_case(rank, f"vit_{name}", axes, build,
                                              vit_batch, 1, dev)
    # f32 compute: at random init bf16 moves some of its gradients by a
    # relative 0.3 between batch sizes (resnet_reference); f32 holds the
    # data-parallel algebra itself
    cfg = dataclasses.replace(vision.ResNetConfig.resnet50(),
                              dtype=torch.float32)

    def build_resnet(mesh):
        model = vision.ResNet(cfg, mesh)
        params = model.init(torch.Generator(device=dev).manual_seed(86), dev)
        return model, params, vision.param_leaves, lambda g, m: [
            x.detach() for x in vision.param_leaves(g)]

    resnet_batch = image_batch(gen, VISION_MESH_RESNET_B, 224,
                               cfg.num_classes, dev)
    out["resnet_dp2"] = vision_mesh_case(rank, "resnet_dp2", {"dp": 2},
                                         build_resnet, resnet_batch, 1, dev)

    def build_mnist(mesh):
        mlp = MnistMlp(mesh=mesh)
        params = mlp.init(torch.Generator(device=dev).manual_seed(87), dev)
        step = mlp.make_train_step(0.1)[0]
        model = types.SimpleNamespace(
            batch_slice=mlp.batch_slice, make_train_step=lambda: step)

        def leaves(p):
            return [w for layer in p for w in (layer["w"], layer["b"])]

        return model, params, leaves, lambda g, m: leaves(g)

    mnist_batch = {"image": torch.randn(256, 784, generator=gen, device=dev),
                   "label": torch.randint(0, 10, (256,), generator=gen,
                                          device=dev)}
    out["mnist_dp2"] = vision_mesh_case(rank, "mnist_dp2", {"dp": 2},
                                        build_mnist, mnist_batch, MNIST_STEPS,
                                        dev)
    return out


def generate_rank(rank: int, dev) -> dict:
    """``generate_dp`` and ``generate_fsdp`` on this rank. dp: Llama-3-8B
    (all layers, bf16, the seed-0 weights), greedy ``generate_cached`` of
    GENERATE_PROMPTS prompts at dp=2, then one card's run of the rank's own
    rows on the same weights (bitwise equal) and, on rank 0, of the whole
    batch (agreement reported). fsdp: the first GENERATE_FSDP_LAYERS
    layers at fsdp=2, GENERATE_FSDP_NEW tokens, against one card's run of
    the rank's rows on the whole weights."""
    cfg = TransformerConfig.llama3_8b()
    prompts = torch.as_tensor(np.random.default_rng(21).integers(
        0, cfg.vocab_size, (GENERATE_PROMPTS, GENERATE_PROMPT_LEN)),
        device=dev)
    out = {}
    mesh = make_mesh({"dp": 2}, device_type="cuda")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    reset_flash_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    tokens = transformer.Transformer(cfg, mesh).generate_cached(
        params, prompts, GENERATE_NEW)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches = flash_counts()["flash_fwd"]
    rows = batch_slice(prompts, mesh)
    own = transformer.Transformer(cfg).generate_cached(params, rows,
                                                       GENERATE_NEW)
    mine = batch_slice(tokens, mesh)
    rec = {"tokens": tokens.cpu().numpy(), "ms": ms, "k1_launches": launches,
           "rows": rows.shape[0],
           "own_rows_bitwise": bool(torch.equal(own, mine)),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if rank == 0:
        whole = transformer.Transformer(cfg).generate_cached(
            params, prompts, GENERATE_NEW)
        new = slice(GENERATE_PROMPT_LEN, None)
        rec["whole_batch_agreement"] = (
            (whole[:, new] == tokens[:, new]).float().mean().item())
    out["generate_dp"] = rec
    del params, own, mesh
    gc.collect()
    torch.cuda.empty_cache()

    cut = dataclasses.replace(cfg, n_layers=GENERATE_FSDP_LAYERS)
    mesh = make_mesh({"fsdp": 2}, device_type="cuda")
    sharded = init_params(cut, torch.Generator(device=dev).manual_seed(0), dev,
                          mesh=mesh)
    reset_flash_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    tokens = transformer.Transformer(cut, mesh).generate_cached(
        sharded, prompts, GENERATE_FSDP_NEW)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches = flash_counts()["flash_fwd"]
    del sharded
    whole = init_params(cut, torch.Generator(device=dev).manual_seed(0), dev)
    own = transformer.Transformer(cut).generate_cached(
        whole, batch_slice(prompts, mesh), GENERATE_FSDP_NEW)
    out["generate_fsdp"] = {
        "tokens": tokens.cpu().numpy(), "ms": ms, "k1_launches": launches,
        "own_rows_bitwise": bool(torch.equal(own, batch_slice(tokens, mesh)))}
    del whole, own
    gc.collect()
    torch.cuda.empty_cache()
    return out


def checkpoint_pp_rank(rank: int, dev, directory: str) -> dict:
    """``checkpoint_pp``: the f32 masters of a pp=2 mesh over the first
    CHECKPOINT_PP_LAYERS Llama-3-8B layers (each stage its layer, the
    embedding and the head) saved sharded, restored onto pp=2 and onto no
    mesh (the whole tree: every layer, from both stages' files), each
    leaf bitwise equal to what its stage saved."""
    cfg = train_cfg("llama3_8b", CHECKPOINT_PP_LAYERS)
    mesh = make_mesh({"pp": PP}, device_type="cuda")
    params = transformer.Transformer(cfg, mesh).init(
        torch.Generator(device=dev).manual_seed(88), dev)
    specs = {"params": param_specs(cfg, mesh)}
    t = time.perf_counter()
    with TrainCheckpointer(directory) as ckpt:
        ckpt.save(1, {"params": params}, mesh=mesh, specs=specs)
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        same = ckpt.restore(template=abstract_like({"params": params}, mesh,
                                                   specs))["params"]
        same_s = time.perf_counter() - t
        same_ok = all(torch.equal(a, b) for a, b in zip(
            transformer.param_leaves(params), transformer.param_leaves(same),
            strict=True))
        del same
        t = time.perf_counter()
        whole = ckpt.restore()["params"]
        whole_s = time.perf_counter() - t
    # the whole tree holds this stage's layers at their global indices
    per = CHECKPOINT_PP_LAYERS // PP
    mine = {**whole, "layers": whole["layers"][rank * per:(rank + 1) * per]}
    whole_ok = (len(whole["layers"]) == CHECKPOINT_PP_LAYERS and all(
        torch.equal(a.cpu(), b) for a, b in zip(
            transformer.param_leaves(params), transformer.param_leaves(mine),
            strict=True)))
    return {"same_bitwise": same_ok, "whole_bitwise": whole_ok,
            "whole_layers": len(whole["layers"]),
            "stage_layers": len(params["layers"]),
            "bytes_saved": sum(w.numel() * w.element_size()
                               for w in transformer.param_leaves(params)),
            "save_s": save_s, "restore_same_s": same_s,
            "restore_whole_s": whole_s}


def k1_only(n: int) -> dict:
    """Launch counts of a phase that runs the forward kernel alone."""
    return {"flash_fwd": n, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}


def vision_generate_reports(ranks, how) -> list[dict]:
    """The reports of ``vision_mesh``, ``generate_dp``, ``generate_fsdp``
    and ``checkpoint_pp``, with their checks."""
    out = []
    cases = [k for k in ranks[0]["vision_mesh"] if k != "seconds"]
    for name in cases:
        runs = [r["vision_mesh"][name] for r in ranks]
        axes = (VISION_MESH_VIT_CASES[name[4:]][0] if name.startswith("vit_")
                else {"dp": 2})
        for r, run in enumerate(runs):
            single = run["single_card_loss"]
            rel = abs(run["losses"][0] - single) / abs(single)
            check(all(np.isfinite(run["losses"])) and rel <= TRAIN_LOSS_TOL,
                  f"vision_mesh {name} rank {r}: first loss {run['losses'][0]}"
                  f" against one card's {single} (rel {rel})")
            check(run["losses"] == runs[0]["losses"],
                  f"vision_mesh {name}: rank {r}'s losses differ")
            check(max(run["first"]) <= TRAIN_GRAD_TOL,
                  f"vision_mesh {name} rank {r}: first gradients "
                  f"{max(run['first'])} from one card's")
            if name.startswith("vit_"):
                hops = 2 if "sp" in axes else 1  # the ring, non-causal
                want = vit.ViTConfig.vit_b16().n_layers * hops
                check(all(n == want for n in run["launches"].values()),
                      f"vision_mesh {name} rank {r}: launches "
                      f"{run['launches']}, predicted {want} each")
        if name == "mnist_dp2":
            losses = runs[0]["losses"]
            check(losses[-1] < 0.5 * losses[0],
                  f"vision_mesh mnist_dp2: {losses[::10]} did not halve")
        out.append({
            "phase": "vision_mesh", "case": name, "mesh": runs[0]["mesh"],
            "backend": how["backend"], "cards": how["cards"],
            "losses": runs[0]["losses"],
            "single_card_first_loss": runs[0]["single_card_loss"],
            "first_loss_rel_err": abs(runs[0]["losses"][0]
                                      - runs[0]["single_card_loss"])
            / abs(runs[0]["single_card_loss"]),
            "loss_tolerance": TRAIN_LOSS_TOL,
            "first_grad_max_rel_err": max(max(r["first"]) for r in runs),
            "grad_tolerance": TRAIN_GRAD_TOL,
            "step_ms": runs[0]["step_ms"],
            "rows_per_rank": [r["rows"] for r in runs],
            "launches_per_rank": [r["launches"] for r in runs]})
    dp = [r["generate"]["generate_dp"] for r in ranks]
    for r, rec in enumerate(dp):
        check(np.array_equal(rec["tokens"], dp[0]["tokens"]),
              f"generate_dp: rank {r}'s tokens differ from rank 0's")
        check(rec["own_rows_bitwise"],
              f"generate_dp rank {r}: its rows differ from one card's run of "
              "them")
        check(rec["k1_launches"] == TransformerConfig.llama3_8b().n_layers,
              f"generate_dp rank {r}: K1 {rec['k1_launches']}")
    out.append({"phase": "generate_dp", "case": "generate_dp", "mesh": "dp=2",
                "layers": TransformerConfig.llama3_8b().n_layers,
                "prompts": GENERATE_PROMPTS, "prompt_len": GENERATE_PROMPT_LEN,
                "new_tokens": GENERATE_NEW, "backend": how["backend"],
                "ms_per_rank": [x["ms"] for x in dp],
                "rows_per_rank": [x["rows"] for x in dp],
                "own_rows_bitwise": [x["own_rows_bitwise"] for x in dp],
                "whole_batch_agreement": dp[0]["whole_batch_agreement"],
                "k1_launches_per_rank": [x["k1_launches"] for x in dp],
                "launches_per_rank": [k1_only(x["k1_launches"]) for x in dp],
                "peak_gb_per_rank": [x["peak_gb"] for x in dp]})
    fs = [r["generate"]["generate_fsdp"] for r in ranks]
    for r, rec in enumerate(fs):
        check(np.array_equal(rec["tokens"], fs[0]["tokens"]),
              f"generate_fsdp: rank {r}'s tokens differ from rank 0's")
        check(rec["own_rows_bitwise"],
              f"generate_fsdp rank {r}: its rows differ from one card's run")
        check(rec["k1_launches"] == GENERATE_FSDP_LAYERS,
              f"generate_fsdp rank {r}: K1 {rec['k1_launches']}")
    out.append({"phase": "generate_fsdp", "case": "generate_fsdp",
                "mesh": "fsdp=2",
                "layers": GENERATE_FSDP_LAYERS,
                "new_tokens": GENERATE_FSDP_NEW, "backend": how["backend"],
                "ms_per_rank": [x["ms"] for x in fs],
                "own_rows_bitwise": [x["own_rows_bitwise"] for x in fs],
                "k1_launches_per_rank": [x["k1_launches"] for x in fs],
                "launches_per_rank": [k1_only(x["k1_launches"]) for x in fs]})
    ck = [r["checkpoint_pp"] for r in ranks]
    for r, rec in enumerate(ck):
        check(rec["same_bitwise"] and rec["whole_bitwise"]
              and rec["whole_layers"] == CHECKPOINT_PP_LAYERS,
              f"checkpoint_pp rank {r}: {rec}")
    out.append({"phase": "checkpoint_pp", "mesh": "pp=2",
                "layers": CHECKPOINT_PP_LAYERS, "per_rank": ck})
    return out


def vision_generate_rank(rank: int, directory: str) -> dict:
    """``vision_mesh``, ``generate_dp`` / ``generate_fsdp`` and
    ``checkpoint_pp`` on one rank of the training spawn."""
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for key, phase in (
            ("vision_mesh", lambda: vision_mesh_rank(rank, dev)),
            ("generate", lambda: generate_rank(rank, dev)),
            ("checkpoint_pp", lambda: checkpoint_pp_rank(rank, dev,
                                                         directory))):
        t = time.perf_counter()
        out[key] = phase()
        out[key]["seconds"] = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ------------------------------------------- the entry points and the sandbox

# entry: entry()'s forward (8 layers, d 1024, 16 heads over 8 KV heads, bf16,
# tokens [2, 512]) timed as one warm-up call, then the p50 of ENTRY_CALLS;
# K1 once per layer and call, at its head-dim-64 instance
ENTRY_CALLS = 5
ENTRY_K1_CASE = (2, 512, 512, True, None)
ENTRY_K1_HEADS = (16, 8)
# entry_reference: entry()'s weights cut to 2 layers on seeded tokens
ENTRY_REFERENCE_LAYERS = 2
# reroute: the f32 and f64 products held to host numpy, the tolerances of
# tests/test_xla_reroute.py:58 (f32) and of one f64 product against another
# summation order (f64); inputs uniform in [0, 1), so no entry cancels
REROUTE_F32_RTOL, REROUTE_F64_RTOL = 1e-4, 1e-10
REROUTE_F32_N, REROUTE_F64_N = 4096, 2048
REROUTE_TIMEOUT_S = 300
# dryrun_multichip: the dry run's n, and the lines it must print (n = 8
# reaches tp=8, sp=4 x tp=2 and the Ulysses check)
DRYRUN_N = 8
DRYRUN_LINES = (
    "dryrun_multichip OK: mesh={'dp': 1, 'sp': 2, 'tp': 4} devices=8 "
    "batch=2x64 ",
    "dryrun_multichip dense-alt OK: mesh={'fsdp': 8} batch=16x32 ",
    "dryrun_multichip dense-alt OK: mesh={'fsdp': 4, 'tp': 2} batch=8x32 ",
    "dryrun_multichip dense-alt OK: mesh={'tp': 8} batch=2x32 ",
    "dryrun_multichip dense-alt OK: mesh={'dp': 1, 'sp': 4, 'tp': 2} "
    "batch=2x128 ",
    "dryrun_multichip flagship-8B shapes OK: mesh={'dp': 1, 'sp': 2, "
    "'tp': 4} leaves=291 batch=1x2048",
    "dryrun_multichip MoE OK: mesh={'dp': 2, 'ep': 2, 'tp': 2} ",
    "dryrun_multichip pipeline OK: mesh={'dp': 2, 'pp': 4} ",
    "dryrun_multichip ulysses OK: mesh={'dp': 1, 'sp': 2, 'tp': 4} ",
    "dryrun_multichip vision OK: mesh={'dp': 8} ",
    "dryrun_multichip tp-serving OK: tp=2 tokens match solo",
    "dryrun_multichip dp x tp serving OK: 2 replicas x tp=2, replicas "
    "used=[0, 1]",
    "dryrun_multichip accelerator: ",
)
REPO_ROOT = Path(__file__).resolve().parent
SHIM_DIR = REPO_ROOT / "bee_code_interpreter_tpu_torch" / "runtime" / "shim"


def entry_phase(timer, dev) -> tuple[dict, dict]:
    """``entry()`` on the card: a warm-up call, then ENTRY_CALLS timed
    calls (host clock around each call and a synchronize); logits
    ``[2, 512, 32000]`` and finite, K1 once per layer and call. K1 held
    against its plain version at this shape. Returns the record and the
    params (for ``entry_reference``)."""
    fn, (params, tokens) = port_entry.entry()
    cfg = fn.keywords["config"]
    reset_flash_counts()
    t = time.perf_counter()
    logits = fn(params, tokens)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t) * 1e3
    times = []
    for _ in range(ENTRY_CALLS):
        t = time.perf_counter()
        logits = fn(params, tokens)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    launches = flash_counts()
    check(tuple(logits.shape) == (*port_entry.ENTRY_TOKENS, cfg.vocab_size),
          f"entry: logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "entry: non-finite logits")
    want = cfg.n_layers * (1 + ENTRY_CALLS)
    check(launches["flash_fwd"] == want,
          f"entry: K1 {launches['flash_fwd']} launches, want {want}")
    check(launches["flash_bwd_dkdv"] == launches["flash_bwd_dq"] == 0,
          f"entry: backward kernels launched {launches}")
    (k1,) = check_flash(timer, dev, ENTRY_K1_HEADS, [ENTRY_K1_CASE], D=64)
    n_params = transformer.n_params(params)
    return {"phase": "entry", "config": {
                "vocab_size": cfg.vocab_size, "d_model": cfg.d_model,
                "n_layers": cfg.n_layers, "n_heads": cfg.n_heads,
                "n_kv_heads": cfg.n_kv_heads, "dtype": str(cfg.dtype)},
            "tokens": list(tokens.shape), "n_params": n_params,
            "logits": list(logits.shape), "warmup_ms": warm_ms,
            "ms": times, "p50_ms": float(np.median(times)),
            "tokens_per_s": tokens.numel() / (np.median(times) / 1e3),
            "k1_launches": launches["flash_fwd"], "k1_per_call": cfg.n_layers,
            "k1": k1}, params


def entry_reference(params, dev) -> dict:
    """``entry()``'s weights cut to ENTRY_REFERENCE_LAYERS layers on seeded
    tokens ``[2, 512]``: bf16 on the card (K1) against the f32 plain path
    on the CPU, max |logit error| over max |logit| within REFERENCE_TOL."""
    cfg = dataclasses.replace(port_entry.ENTRY_CONFIG,
                              n_layers=ENTRY_REFERENCE_LAYERS)
    cut = {**params, "layers": params["layers"][:ENTRY_REFERENCE_LAYERS]}
    tokens = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab_size, port_entry.ENTRY_TOKENS))
    reset_flash_counts()
    got = transformer.forward(cut, tokens.to(dev), cfg).float().cpu()
    launches = flash_counts()["flash_fwd"]
    want = transformer.forward(cpu_f32(cut), tokens,
                               dataclasses.replace(cfg, dtype=torch.float32))
    rel = ((got - want).abs().max() / want.abs().max()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    check(bool(torch.isfinite(got).all()), "entry_reference: non-finite")
    check(rel <= REFERENCE_TOL, f"entry_reference: relative logit error {rel}")
    check(launches == ENTRY_REFERENCE_LAYERS,
          f"entry_reference: K1 {launches}")
    return {"phase": "entry_reference", "layers": ENTRY_REFERENCE_LAYERS,
            "rel_max_logit_err": rel, "argmax_agreement": agree,
            "tolerance": REFERENCE_TOL, "k1_launches": launches}


def sandbox(code: str | None = None, script: Path | None = None,
            env: dict | None = None, inspect_dir: str | None = None) -> dict:
    """One sandbox interpreter as the service starts it
    (``runtime/executor_core.py::_child_env``): a fresh ``python3`` in a
    temporary workspace, ``PYTHONPATH`` the port's shim directory alone
    (the shim finds the package four directories up), the request's env on
    top. The library path is passed on where this process has one. Returns
    stdout, stderr, wall seconds and, with ``inspect_dir``, the workspace
    files under it."""
    with tempfile.TemporaryDirectory(prefix="bci-sandbox-") as ws:
        child = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
                 "HOME": os.environ.get("HOME", ws), "LANG": "C.UTF-8",
                 "PYTHONUNBUFFERED": "1", "PYTHONPATH": str(SHIM_DIR)}
        if "LD_LIBRARY_PATH" in os.environ:
            child["LD_LIBRARY_PATH"] = os.environ["LD_LIBRARY_PATH"]
        child.update(env or {})
        argv = [sys.executable, str(script)] if script else [
            sys.executable, "-c", code]
        t = time.perf_counter()
        out = subprocess.run(argv, cwd=ws, env=child, capture_output=True,
                             text=True, timeout=REROUTE_TIMEOUT_S)
        seconds = time.perf_counter() - t
        check(out.returncode == 0,
              f"sandbox payload failed ({out.returncode}):\n{out.stderr}")
        files = {}
        if inspect_dir:
            root = Path(ws) / inspect_dir
            files = {p.name: p.read_text() for p in sorted(root.glob("*"))}
        return {"stdout": out.stdout, "stderr": out.stderr,
                "seconds": seconds, "files": files}


def last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


# what every rerouted payload reports after its work: the reroute's probe
# state and device (a fallback to host numpy reads False)
REROUTE_STATE = (
    "from bee_code_interpreter_tpu_torch.runtime import cuda_reroute as _r\n"
    "out.update(backend_ok=_r._backend_state, device=_r._device_name)\n"
    "print(json.dumps(out))\n"
)

# tests/test_shim.py:27-37's payload as the interpreter's first rerouted op
# (its first touch, timed from the op to the result), the same op again, the
# host-to-device copy of its 16 MB array alone, and a small product that
# must stay host numpy. WARM: the warm module's import, or nothing.
TOUCH_PAYLOAD = (
    "import json, time\n"
    "_t = time.perf_counter()\n"
    "WARM\n"
    "out = {'warm_import_ms': (time.perf_counter() - _t) * 1e3}\n"
    "import numpy as np\n"
    "def touch():\n"
    "    t = time.perf_counter()\n"
    "    x = np.random.rand(2_000_000)\n"
    "    s = np.sum(np.square(x))\n"
    "    v = float(s)\n"
    "    return (time.perf_counter() - t) * 1e3, x, s, v\n"
    "out['first_touch_ms'], x, s, v = touch()\n"
    "out['second_ms'] = touch()[0]\n"
    "out.update(kind=type(s).__name__, close=abs(v / len(x) - 1/3) < 0.01,\n"
    "           tensor_device=str(s.tensor.device))\n"
    "host = np.asarray(x)\n"
    "import torch\n"
    "from bee_code_interpreter_tpu_torch.runtime import cuda_reroute as _r\n"
    "t = time.perf_counter(); _r._to_device(host); torch.cuda.synchronize()\n"
    "out['h2d_copy_ms'] = (time.perf_counter() - t) * 1e3\n"
    "small = np.matmul(np.ones((3, 3)), np.ones((3, 3)))\n"
    "out['small'] = type(small).__name__\n"
)

# f32 and f64 products on uniform [0, 1) inputs: host numpy; from host
# arrays to a host result (np.dot moves both inputs over, np.asarray reads
# the product back); and with the inputs resident (a zeros on-ramp plus
# the array), the product and one synchronizing element read. Best of 2.
MATMUL_PAYLOAD = (
    "out['allow_tf32'] = torch.backends.cuda.matmul.allow_tf32\n"
    "def best(fn, reps=2):\n"
    "    times = []\n"
    "    for _ in range(reps):\n"
    "        t = time.perf_counter(); r = fn()\n"
    "        times.append((time.perf_counter() - t) * 1e3)\n"
    "    return r, min(times)\n"
    "for name, n, dt, rtol in (('f32', N32, np.float32, RTOL32),\n"
    "                          ('f64', N64, np.float64, RTOL64)):\n"
    "    rng = np.random.default_rng(0)\n"
    "    a = rng.random((n, n), dtype=dt)\n"
    "    b = rng.random((n, n), dtype=dt)\n"
    "    want, host_ms = best(lambda: a @ b)\n"
    "    got, e2e_ms = best(lambda: np.asarray(np.dot(a, b)))\n"
    "    da = np.zeros((n, n), dtype=dt) + a\n"
    "    db = np.zeros((n, n), dtype=dt) + b\n"
    "    prod = da @ db\n"
    "    _, resident_ms = best(lambda: float((da @ db)[0, 0]))\n"
    "    err = float(np.max(np.abs(got - want) / np.abs(want)))\n"
    "    out[name] = {'n': n, 'kind': type(prod).__name__,\n"
    "        'dtype': str(prod.dtype), 'host_ms': host_ms,\n"
    "        'rerouted_e2e_ms': e2e_ms, 'rerouted_resident_ms': resident_ms,\n"
    "        'max_rel_err': err, 'rtol': rtol,\n"
    "        'within': bool(np.allclose(got, want, rtol=rtol, atol=0))}\n"
)

TORCH_PAYLOAD = (
    "import json, torch\n"
    "x = torch.randn(4096, 4096)\n"
    "y = x @ x\n"
    "torch.cuda.synchronize()\n"
    "print(json.dumps({'x': str(x.device), 'y': str(y.device),\n"
    "                  'default': str(torch.get_default_device())}))\n"
)


def reroute_on_card(name: str, rec: dict) -> None:
    """A payload that should reach the card: the probe succeeded on CUDA
    (no watchdog fallback), the shim test's result was a CudaArray on cuda
    and right, and a small array stayed host numpy."""
    check(rec.get("backend_ok") is True and rec.get("device") == "cuda",
          f"reroute {name}: the reroute fell back to host numpy: {rec}")
    check(rec["kind"] == "CudaArray" and rec["close"]
          and rec["tensor_device"].startswith("cuda")
          and rec["small"] == "ndarray", f"reroute {name}: {rec}")


def reroute_phase() -> dict:
    """Five sandbox interpreters on the port's shim (``sandbox``): a cold
    one (the shim test's payload as its first touch, small arrays stay
    ndarray), ``examples/benchmark-numpy.py`` unchanged, rerouted and with
    ``BCI_XLA_REROUTE=0`` (the opt-out: kind=ndarray), a warm one (``import
    bci_cuda_warm`` first, then the same first touch, then the f32 and f64
    products against host numpy), and torch code landing on the card
    through the shim alone with ``BCI_PROFILE_DIR`` leaving a trace with
    CUDA kernel events."""
    out = {"phase": "reroute", "shim_dir": str(SHIM_DIR.relative_to(
        REPO_ROOT))}
    touch = {}
    for arm, warm, extra in (
            ("cold", "", ""),
            ("warm", "import bci_cuda_warm", MATMUL_PAYLOAD
             .replace("N32", str(REROUTE_F32_N))
             .replace("N64", str(REROUTE_F64_N))
             .replace("RTOL32", repr(REROUTE_F32_RTOL))
             .replace("RTOL64", repr(REROUTE_F64_RTOL)))):
        run = sandbox(TOUCH_PAYLOAD.replace("WARM", warm) + extra
                      + REROUTE_STATE)
        rec = last_json(run["stdout"])
        reroute_on_card(f"first_touch_{arm}", rec)
        touch[arm] = {k: v for k, v in rec.items() if k not in ("f32", "f64")}
        touch[arm]["interpreter_s"] = run["seconds"]
        if arm == "warm":
            check(rec["allow_tf32"] is False, "reroute matmul: TF32 is on")
            for name, dtype in (("f32", "float32"), ("f64", "float64")):
                check(rec[name]["kind"] == "CudaArray"
                      and rec[name]["dtype"] == dtype and rec[name]["within"],
                      f"reroute matmul {name}: {rec[name]}")
            out["matmul"] = {k: rec[k] for k in ("f32", "f64")}
    out["first_touch"] = touch

    bench = REPO_ROOT / "examples" / "benchmark-numpy.py"
    out["benchmark_numpy"] = {}
    for arm, env in (("rerouted", {}), ("host", {"BCI_XLA_REROUTE": "0"})):
        run = sandbox(script=bench, env=env)
        kind_line, result_line = run["stdout"].strip().splitlines()[-2:]
        kind = kind_line.removeprefix("kind=")
        want_kind = "CudaArray" if arm == "rerouted" else "ndarray"
        check(kind == want_kind, f"benchmark-numpy {arm}: kind={kind}")
        out["benchmark_numpy"][arm] = {
            "kind": kind, "self_timed_s": float(result_line.split()[-1][:-1]),
            "sum": float(result_line.split("=")[1].split()[0]),
            "interpreter_s": run["seconds"]}
    rerouted = out["benchmark_numpy"]["rerouted"]
    check(abs(rerouted["sum"] / out["benchmark_numpy"]["host"]["sum"] - 1)
          < 1e-3, f"benchmark-numpy: sums {out['benchmark_numpy']}")

    run = sandbox(TORCH_PAYLOAD, env={"BCI_PROFILE_DIR": "trace"},
                  inspect_dir="trace")
    rec = last_json(run["stdout"])
    check(rec["x"].startswith("cuda") and rec["y"].startswith("cuda"),
          f"reroute torch payload: {rec}")
    check(len(run["files"]) == 1, f"reroute profile: files {list(run['files'])}")
    (trace,) = run["files"].values()
    events = json.loads(trace)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    check(kernels, "reroute profile: no CUDA kernel event in the trace")
    out["torch_payload"] = {**rec, "trace_events": len(events),
                            "kernel_events": len(kernels),
                            "kernels": sorted({k[:60] for k in kernels})}
    return out


def dryrun_phase() -> dict:
    """``python3 -m bee_code_interpreter_tpu_torch.entry 8``: the dry run on
    eight gloo ranks on the CPU, as JAX's runs on virtual CPU devices;
    every validation line present, in order."""
    t = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "bee_code_interpreter_tpu_torch.entry",
         str(DRYRUN_N)], cwd=REPO_ROOT, capture_output=True, text=True,
        timeout=REROUTE_TIMEOUT_S)
    seconds = time.perf_counter() - t
    check(out.returncode == 0, f"dryrun_multichip failed:\n{out.stderr}")
    lines = [x for x in out.stdout.splitlines()
             if x.startswith("dryrun_multichip")]
    check(len(lines) == len(DRYRUN_LINES)
          and all(x.startswith(w) for x, w in zip(lines, DRYRUN_LINES)),
          "dryrun_multichip lines:\n" + "\n".join(lines))
    accel = json.loads(lines[-1].removeprefix("dryrun_multichip accelerator: "))
    return {"phase": "dryrun_multichip", "n": DRYRUN_N, "seconds": seconds,
            "lines": lines[:-1], "accelerator": accel}


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
    emit({"phase": "flash_fwd", "tolerance": KERNEL_TOL,
          "row_tolerance": K1_ROW_TOL, "cases": flash_rows})
    paged_rows = check_paged_decode(timer, dev)
    emit({"phase": "paged_decode", "tolerance": KERNEL_TOL, "cases": paged_rows})
    paged = next(r for r in paged_rows if r["case"] == K2_MAIN_CASE)
    # the same kernels at a tp=2 rank's heads (serving_tp's shapes)
    flash_tp_rows = check_flash(timer, dev, TP_HEADS, K1_TP_CASES)
    emit({"phase": "flash_fwd_rank_local", "heads": list(TP_HEADS),
          "tolerance": KERNEL_TOL, "row_tolerance": K1_ROW_TOL,
          "cases": flash_tp_rows})
    paged_tp_rows = check_paged_decode(timer, dev, TP_HEADS, K2_TP_CASES)
    emit({"phase": "paged_decode_rank_local", "heads": list(TP_HEADS),
          "tolerance": KERNEL_TOL, "cases": paged_tp_rows})
    # K1 at the sequence-parallel shapes: a ring rank's own block, an
    # earlier hop and a windowed own block; a Ulysses rank's heads over the
    # gathered sequence. out (per row) and lse (absolute) are both held.
    flash_sp_rows = (check_flash(timer, dev, (32, 8), K1_SP_CASES)
                     + check_flash(timer, dev, (16, 4), K1_ULYSSES_CASES))
    emit({"phase": "flash_fwd_sp", "tolerance": KERNEL_TOL,
          "row_tolerance": K1_ROW_TOL, "compared": ["out", "lse"],
          "cases": flash_sp_rows})
    del timer

    cfg = dataclasses.replace(TransformerConfig.llama3_8b(),
                              paged_attention_kernel=True)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    emit(check_reference(params, cfg, dev))
    report, first, requests = main_path(params, cfg)
    emit(report)
    k1_by_phase = {"main_path": first["k1_launches"]}
    k2_by_phase = {"main_path": first["k2_launches"]}

    def run_phase(name, phase) -> dict:
        t = time.perf_counter()
        result = phase()
        # the phase's batcher and its pool go before the next phase (the
        # admission wrappers of serve() hold it in a reference cycle)
        gc.collect()
        torch.cuda.empty_cache()
        result["seconds"] = time.perf_counter() - t
        emit(result)
        if name == "contiguous_decode":  # no paged decode in this phase
            k1_by_phase[name] = sum(result[w]["k1_launches"]
                                    for w in ("one_shot", "chunked", "int8"))
        elif "k1_launches" in result:
            k1_by_phase[name] = result["k1_launches"]
            # beam_search, speculative_generate and hf_load run no K2
            if "k2_launches" in result:
                k2_by_phase[name] = result["k2_launches"]
        return result

    cut_cfg = dataclasses.replace(cfg, n_layers=BREADTH_CUT_LAYERS)
    cut = {**params, "layers": params["layers"][:BREADTH_CUT_LAYERS]}
    for name, phase in (
        ("serving_bench", lambda: serving_bench(params, cfg)),
        ("serving_profile", lambda: serving_profile(params, cfg)),
        ("admission_prefix", lambda: admission_prefix(params, cfg)),
        ("admission_chunked", lambda: admission_chunked(params, cfg)),
        ("admission_interleaved", lambda: admission_interleaved(params, cfg)),
        ("serving_int8", lambda: serving_int8(params, cfg, requests, first)),
        ("contiguous_decode", lambda: contiguous_decode(cut, cut_cfg)),
        ("serving_weight_int8",
         lambda: serving_weight_int8(params, cfg, requests, first)),
        ("serving_lora", lambda: serving_lora(params, cfg)),
        ("serving_speculative", lambda: serving_speculative(cut, cut_cfg)),
        ("serving_snapshot", lambda: serving_snapshot(cut, cut_cfg, requests)),
        ("beam_search", lambda: beam_phase(params, cfg)),
        ("speculative_generate", lambda: speculative_generate_phase(params, cfg)),
    ):
        run_phase(name, phase)
    # the Llama weights go before the MoE phases and the training phases
    # (the breadth cut holds their first layers, the embedding and the head)
    del params, cut
    gc.collect()
    torch.cuda.empty_cache()

    run_phase("moe_reference", lambda: moe_reference(dev))
    moe_cfg = moe_config(MOE_SERVE_LAYERS)
    moe_params = init_params(moe_cfg,
                             torch.Generator(device=dev).manual_seed(36))
    run_phase("serving_moe", lambda: serving_moe(moe_params, moe_cfg))
    run_phase("serving_moe_exact",
              lambda: serving_moe_exact(moe_params, moe_cfg))
    del moe_params
    gc.collect()
    torch.cuda.empty_cache()

    # tensor-parallel and replicated serving, no other weights resident;
    # each rank counts its own launches (its process's counters)
    how = transport()
    emit({"phase": "transport", **how})
    tp_ref = run_phase("tp_reference", lambda: tp_reference(dev, how))
    tp_run = run_phase("serving_tp",
                       lambda: serving_tp(how, first, requests))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    run_phase("serving_replicated", lambda: serving_replicated(
        params, cfg, requests, first, how))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    mesh_runs = [tp_ref, tp_run]
    # sequence-parallel serving, then LoRA and MoE under tp/ep; each
    # function builds its own weights and frees them before its ranks spawn
    for phases in (sequence_parallel_phases, tp_breadth_phases):
        t = time.perf_counter()
        results = phases(dev, how)
        gc.collect()
        torch.cuda.empty_cache()
        for rec in results:
            rec["group_seconds"] = time.perf_counter() - t
            emit(rec)
        mesh_runs += [r for r in results if "k1_launches_per_rank" in r]
    # dp x tp replicas behind rank 0's front end (four ranks)
    how4 = transport4()
    mesh_runs.append(run_phase("serving_replicated_tp",
                               lambda: serving_replicated_tp(dev, how4)))
    k1_per_rank, k2_per_rank = {}, {}
    for rec in mesh_runs:
        name = rec["phase"]
        k1_by_phase[name] = rec["k1_launches_per_rank"][0]
        k2_by_phase[name] = rec["k2_launches_per_rank"][0]
        k1_per_rank[name] = rec["k1_launches_per_rank"]
        k2_per_rank[name] = rec["k2_launches_per_rank"]

    timer = Timer(dev)
    bwd_rows = check_flash_bwd(timer, dev)
    emit({"phase": "flash_bwd", "tolerance": BWD_TOL, "H": 32, "KVH": 8,
          "D": 128, "cases": bwd_rows})
    # the same kernels at a tp=2 rank's heads (train_tp's shape)
    bwd_tp_rows = check_flash_bwd(timer, dev, TP_HEADS, BWD_TP_CASES)
    emit({"phase": "flash_bwd_rank_local", "heads": list(TP_HEADS),
          "tolerance": BWD_TOL, "D": 128, "cases": bwd_tp_rows})
    # the same kernels at the sp backward's per-hop shapes: a ring rank's
    # own block and an earlier hop, and a Ulysses rank's heads
    bwd_sp_rows = (check_flash_bwd(timer, dev, (32, 8), BWD_SP_CASES)
                   + check_flash_bwd(timer, dev, (16, 4), BWD_ULYSSES_CASES))
    emit({"phase": "flash_bwd_sp", "tolerance": BWD_TOL, "D": 128,
          "cases": bwd_sp_rows})
    # K1, K3 and K4 at head dim 64 (the ViT's), with each instance's
    # registers and spills
    d64 = check_flash_d64(timer, dev)
    d64["ptxas"] = ptxas_usage([fa.FLASH_FWD, fa.FLASH_BWD_DKDV,
                                fa.FLASH_BWD_DQ])
    emit(d64)
    # K1/K3/K4 and K2 at the other head dims, dtypes and group sizes JAX's
    # kernels take (the CUDA-core kernels and the padded instances)
    t = time.perf_counter()
    head_dims = check_flash_head_dims(timer, dev)
    head_dims["ptxas"] = ptxas_usage([fa.FLASH_FWD, fa.FLASH_BWD_DKDV,
                                      fa.FLASH_BWD_DQ, pa.PAGED_DECODE])
    head_dims["seconds"] = time.perf_counter() - t
    emit(head_dims)
    t = time.perf_counter()
    paged_dims = check_paged_head_dims(timer, dev)
    paged_dims["seconds"] = time.perf_counter() - t
    emit(paged_dims)
    del timer
    torch.cuda.empty_cache()
    # the tiny config (head dim 16) in f32 and bf16, then Gemma-2B's widths
    # (head dim 256, one KV head), each served and trained on the card
    tiny = run_phase("tiny_card", lambda: tiny_card(dev))
    wide = run_phase("wide_head", lambda: wide_head(dev))
    emit(check_train_reference(dev))
    torch.cuda.empty_cache()
    t = time.perf_counter()
    lora = lora_train(dev)
    lora["seconds"] = time.perf_counter() - t
    emit(lora)
    gc.collect()
    torch.cuda.empty_cache()
    train = train_path(dev)
    emit(train)
    gc.collect()
    torch.cuda.empty_cache()
    control = run_phase("train_tp_rounding_control",
                        lambda: train_tp_rounding_control(dev))
    control_kv = run_phase("train_tp_kv_rounding_control",
                           lambda: train_tp_kv_rounding_control(dev))
    # training under a mesh, held to train_path's losses and to single-card
    # steps; each rank counts its own launches
    t = time.perf_counter()
    train_meshes = train_mesh_phases(dev, how, train, control, control_kv)
    gc.collect()
    torch.cuda.empty_cache()
    for rec in train_meshes:
        rec["group_seconds"] = time.perf_counter() - t
        emit(rec)
    train_m = run_phase("train_moe", lambda: train_moe(dev))
    run_phase("hf_load", lambda: hf_load(dev))
    # the vision family on one card: the ViT through K1/K3/K4 at head dim
    # 64, the ResNet on cuDNN's convs
    vit_ref = run_phase("vit_reference", lambda: vit_reference(dev))
    vit_run = run_phase("vit", lambda: vit_phase(dev))
    run_phase("resnet_reference", lambda: resnet_reference(dev))
    run_phase("resnet", lambda: resnet_phase(dev))
    # the top-level entry points and the sandbox runtime: entry()'s forward
    # (K1 at its head-dim-64 instance), its 2-layer reference, the numpy ->
    # CUDA reroute in sandbox interpreters, and the dry run on CPU ranks
    t = time.perf_counter()
    timer = Timer(dev)
    entry_run, entry_params = entry_phase(timer, dev)
    del timer
    entry_run["seconds"] = time.perf_counter() - t
    emit(entry_run)
    k1_by_phase["entry"] = entry_run["k1_launches"]
    run_phase("entry_reference", lambda: entry_reference(entry_params, dev))
    del entry_params
    gc.collect()
    torch.cuda.empty_cache()
    run_phase("reroute", reroute_phase)
    run_phase("dryrun_multichip", dryrun_phase)

    main_k1 = next(r for r in flash_rows
                   if (r["B"], r["L"], r["Lk"], r["causal"], r["window"])
                   == K1_MAIN_CASE)
    main_k1_tp = next(r for r in flash_tp_rows
                      if (r["B"], r["L"], r["Lk"], r["causal"], r["window"])
                      == K1_MAIN_CASE)
    paged_tp = next(r for r in paged_tp_rows if r["case"] == K2_MAIN_CASE)

    def rank_local(row, shape) -> dict:
        return {"shape": shape, "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                "max_abs_err": row["max_abs_err"]}

    main_bwd = next(r for r in bwd_rows
                    if (r["B"], r["Lq"], r["Lk"], r["causal"], r["window"],
                        r["g_lse"]) == BWD_MAIN_CASE)
    (bwd_tp,) = bwd_tp_rows
    bwd_shape = (f"B={TRAIN_B} H=32 KVH=8 L={TRAIN_L} D=128 causal bf16, "
                 "lse/delta f32")
    # each training phase under a mesh: rank 0's launches, and every rank's
    train_mesh_launches = {}
    for rec in train_meshes:
        if rec["phase"] == "checkpoint_pp":  # no kernel
            continue
        if rec["phase"] == "sp_attention_grad":
            for name in ("ring_causal", "ring_window", "ulysses"):
                train_mesh_launches[f"sp_attention_grad_{name}"] = rec[
                    name]["launches_per_rank"]
        else:
            train_mesh_launches[rec["case"]] = rec["launches_per_rank"]

    def train_launches(name) -> dict:
        return {case: per_rank[0][name]
                for case, per_rank in train_mesh_launches.items()}

    def d64_rows(name, key=None) -> list[dict]:
        """The head-dim-64 instance's rows (``flash_d64``), its registers
        and spills beside them."""
        regs = d64["ptxas"][name]["d64"]
        if key is None:
            return [{"shape": f"B={r['B']} H={r['H']} KVH={r['KVH']} "
                              f"Lq={r['L']} Lk={r['Lk']} causal={r['causal']} "
                              "D=64 bf16",
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "tflops": r["tflops"],
                     "max_abs_err": r["max_abs_err"], "ptxas": regs}
                    for r in d64["forward"]]
        return [{"shape": f"B={r['B']} H={r['H']} KVH={r['KVH']} "
                          f"Lq={r['Lq']} Lk={r['Lk']} causal={r['causal']} "
                          "D=64 bf16, lse/delta f32",
                 "ms": r[key]["ms"], "plain_ms": r[key]["plain_ms"],
                 "bound_ms": r[key]["bound_ms"],
                 "bound_by": r[key]["bound_by"],
                 # SDPA's whole backward (dQ, dK, dV)
                 "library_ms": r["library_ms"], "tflops": r[key]["tflops"],
                 "max_abs_err": r[key]["max_abs_err"],
                 "rel_err": r[key]["rel_err"], "ptxas": regs}
                for r in d64["backward"]]

    def head_dim_rows(name, key=None) -> list[dict]:
        """The rows of ``flash_head_dims``: each head dim and dtype with its
        route, time, bound, plain version, SDPA and pad."""
        if key is None:
            return [{"shape": f"B={r['B']} H={r['H']} KVH={r['KVH']} "
                              f"Lq={r['L']} Lk={r['Lk']} causal={r['causal']} "
                              f"D={r['D']} {r['dtype']}",
                     **{k: r[k] for k in ("route", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms", "pad_ms",
                                          "tflops", "max_abs_err")}}
                    for r in head_dims["forward"]]
        return [{"shape": f"B={r['B']} H={r['H']} KVH={r['KVH']} "
                          f"Lq={r['Lq']} Lk={r['Lk']} causal={r['causal']} "
                          f"D={r['D']} {r['dtype']}, lse/delta f32",
                 "route": r["route"], "pad_ms": r["pad_ms"],
                 "library_ms": r["library_ms"],
                 **{k: r[key][k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "tflops", "max_abs_err",
                                           "rel_err")}}
                for r in head_dims["backward"]]

    def bwd_entry(name, key, replaces):
        row = main_bwd[key]
        return {
            "name": name, "route": "cuda",
            "source": f"bee_code_interpreter_tpu_torch/ops/csrc/{name}.cu",
            "replaces": replaces,
            "launches": train["launches"][name],
            "launches_by_phase": {"train": train["launches"][name],
                                  "lora_train": lora["launches"][name],
                                  "train_moe": train_m["launches"][name],
                                  **train_launches(name),
                                  "vit_reference": vit_ref["launches"][name],
                                  "vit": vit_run["launches"][name],
                                  "tiny_card_train": {
                                      dt: tiny[dt]["train_launches"][name]
                                      for dt in ("float32", "bfloat16")},
                                  "wide_head_train": wide["train"][
                                      "launches"][name]},
            "d64_shapes": d64_rows(name, key),
            "head_dim_shapes": head_dim_rows(name, key),
            "launches_per_rank": {
                case: [r[name] for r in per_rank]
                for case, per_rank in train_mesh_launches.items()},
            "rank_local": {
                "shape": f"B={TRAIN_B} H={TP_HEADS[0]} KVH={TP_HEADS[1]} "
                         f"L={TRAIN_L} D=128 causal bf16, lse/delta f32",
                "ms": bwd_tp[key]["ms"], "plain_ms": bwd_tp[key]["plain_ms"],
                "bound_ms": bwd_tp[key]["bound_ms"],
                "bound_by": bwd_tp[key]["bound_by"],
                "library_ms": bwd_tp["library_ms"],
                "max_abs_err": bwd_tp[key]["max_abs_err"],
                "rel_err": bwd_tp[key]["rel_err"]},
            "sp_shapes": [{
                "shape": f"B={r['B']} H={r['H']} KVH={r['KVH']} "
                         f"Lq={r['Lq']} Lk={r['Lk']} causal={r['causal']} "
                         "D=128 bf16",
                "ms": r[key]["ms"], "plain_ms": r[key]["plain_ms"],
                "bound_ms": r[key]["bound_ms"],
                "bound_by": r[key]["bound_by"],
                "library_ms": r["library_ms"],
                "max_abs_err": r[key]["max_abs_err"],
                "rel_err": r[key]["rel_err"]} for r in bwd_sp_rows],
            "max_abs_err": max(r[key]["max_abs_err"]
                               for r in bwd_rows + bwd_tp_rows + bwd_sp_rows
                               + d64["backward"]),
            "max_rel_err": max(r[key]["rel_err"]
                               for r in bwd_rows + bwd_tp_rows + bwd_sp_rows
                               + d64["backward"]),
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
            "launches_by_phase": {**k1_by_phase,
                                  "lora_train": lora["launches"]["flash_fwd"],
                                  "train": train["launches"]["flash_fwd"],
                                  "train_moe": train_m["launches"]["flash_fwd"],
                                  **train_launches("flash_fwd"),
                                  "vit_reference": vit_ref["launches"][
                                      "flash_fwd"],
                                  "vit_apply": vit_run["apply_launches"][
                                      "flash_fwd"],
                                  "vit": vit_run["launches"]["flash_fwd"],
                                  "tiny_card_train": {
                                      dt: tiny[dt]["train_launches"][
                                          "flash_fwd"]
                                      for dt in ("float32", "bfloat16")},
                                  "wide_head_train": wide["train"][
                                      "launches"]["flash_fwd"]},
            "d64_shapes": d64_rows("flash_fwd"),
            "head_dim_shapes": head_dim_rows("flash_fwd"),
            "max_abs_err": max(r["max_abs_err"]
                               for r in flash_rows + flash_sp_rows
                               + d64["forward"] + [entry_run["k1"]]),
            "ms": main_k1["ms"], "kernel_ms": main_k1["ms"],
            "plain_ms": main_k1["plain_ms"], "bound_ms": main_k1["bound_ms"],
            "bound_by": main_k1["bound_by"],
            "library_ms": main_k1["library_ms"],
            "shape": "B=1 H=32 KVH=8 L=1024 D=128 causal bf16",
            "launches_per_rank": {
                **k1_per_rank,
                **{case: [r["flash_fwd"] for r in per_rank]
                   for case, per_rank in train_mesh_launches.items()}},
            "rank_local": rank_local(
                main_k1_tp, f"B=1 H={TP_HEADS[0]} KVH={TP_HEADS[1]} L=1024 "
                "D=128 causal bf16"),
            "sp_shapes": [rank_local(
                r, f"B={r['B']} H={r['H']} KVH={r['KVH']} Lq={r['L']} "
                f"Lk={r['Lk']} causal={r['causal']} window={r['window']} "
                "D=128 bf16") for r in flash_sp_rows],
            "entry_shape": {**rank_local(
                entry_run["k1"], "B=2 H=16 KVH=8 L=512 D=64 causal bf16"),
                "launches": entry_run["k1_launches"]},
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
            "launches_by_phase": k2_by_phase,
            "max_abs_err": max(r["max_abs_err"] for r in paged_rows),
            "head_dim_shapes": [
                {"shape": f"B={r['B']} nh={r['nh']} kvh={r['kvh']} "
                          f"dh={r['dh']} ps={r['ps']} P={r['P']} {r['dtype']}",
                 **{k: r[k] for k in ("entry", "ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms", "splits",
                                      "max_abs_err", "max_row_rel_err")}}
                for r in paged_dims["cases"]],
            "ms": paged["ms"], "kernel_ms": paged["ms"],
            "plain_ms": paged["plain_ms"], "bound_ms": paged["bound_ms"],
            "bound_by": paged["bound_by"], "library_ms": None,
            "shape": "B=8 nh=32 kvh=8 dh=128 ps=16 P=128 bf16",
            "splits": paged["splits"],
            "cases_ms": {r["case"]: r["ms"] for r in paged_rows},
            "launches_per_rank": k2_per_rank,
            "rank_local": {**rank_local(
                paged_tp, f"B=8 nh={TP_HEADS[0]} kvh={TP_HEADS[1]} dh=128 "
                "ps=16 P=128 bf16"), "splits": paged_tp["splits"]},
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
