"""Rank functions of the generation-over-the-batch-axes and pp-checkpoint
parity tests (tests/test_torch_generate_mesh.py).

``parallel.spawn`` starts each rank as a fresh process that imports this
module by name, so it imports no JAX: the JAX side runs in the test
process, and the weights and prompts cross as numpy arrays.
"""

from __future__ import annotations

import math

import torch

from bee_code_interpreter_tpu_torch.models import transformer as T
from bee_code_interpreter_tpu_torch.parallel import mesh as M
from bee_code_interpreter_tpu_torch.utils.checkpoint import (
    TrainCheckpointer,
    abstract_like,
)
from bee_code_interpreter_tpu_torch.weights import params_from_jax
from tests.torch_tp_worker import error_of, tiny_config, to_np

# several ranks share the CPU with the other test workers
torch.set_num_threads(1)

# case -> mesh axes; the world of each is the product of its sizes
GENERATE_CASES = {"dp2": {"dp": 2}, "fsdp2": {"fsdp": 2},
                  "dp2_tp2": {"dp": 2, "tp": 2}}
NEW_TOKENS = 6
SAMPLING = dict(temperature=1.0, top_k=20)
SAMPLE_SEED = 3


def generations(model, params, prompt) -> dict:
    """Every generation the tests hold: uncached and cached greedy, the
    chunked prefill, and seeded sampling."""
    return {
        "generate": model.generate(params, prompt, NEW_TOKENS),
        "cached": model.generate_cached(params, prompt, NEW_TOKENS),
        "chunked": model.generate_cached(params, prompt, NEW_TOKENS,
                                         prefill_chunk=3),
        "sampled": model.generate_cached(
            params, prompt, NEW_TOKENS,
            generator=torch.Generator().manual_seed(SAMPLE_SEED), **SAMPLING),
    }


def generate_cases(rank: int, world: int, inputs: dict) -> dict:
    """Every ``GENERATE_CASES`` case of ``world`` ranks on the tiny decoder
    (JAX's weights, sharded), and the refusal of a prompt whose rows do not
    divide over dp."""
    out = {}
    cfg = tiny_config()
    prompt = torch.as_tensor(inputs["prompt"]).long()
    for name, axes in GENERATE_CASES.items():
        if math.prod(axes.values()) != world:
            continue
        mesh = M.make_mesh(axes, device_type="cpu")
        params = params_from_jax(inputs["params"], cfg, mesh=mesh)
        with torch.no_grad():
            out[name] = to_np(generations(T.Transformer(cfg, mesh), params,
                                          prompt))
    if world == 2:
        mesh = M.make_mesh({"dp": 2}, device_type="cpu")
        params = params_from_jax(inputs["params"], cfg, mesh=mesh)
        model = T.Transformer(cfg, mesh)
        out["uneven"] = {
            fn: error_of(lambda fn=fn: getattr(model, fn)(
                params, prompt[:3], NEW_TOKENS))
            for fn in ("generate", "generate_cached")}
    return out


def checkpoint_pp(rank: int, inputs: dict, directory: str) -> dict:
    """pp=2 over the 4-layer tiny decoder: each stage's f32 masters and
    AdamW state after one step saved sharded; restored onto pp=2 (the rank's block),
    onto no mesh (the whole tree) and onto tp=2 (the other layout of the
    same two ranks: every layer, each rank its tp shard of that tree)."""
    cfg = tiny_config(n_layers=4)
    mesh = M.make_mesh({"pp": 2}, device_type="cpu")
    params = params_from_jax(inputs["params4"], cfg, mesh=mesh,
                             requires_grad=True)
    # one step through the pipeline, so the AdamW state holds moments
    seq = torch.randint(0, cfg.vocab_size, (4, 9),
                        generator=torch.Generator().manual_seed(5))
    params, opt, _ = T.Transformer(cfg, mesh).make_train_step(
        n_microbatches=2)(params, None, {"tokens": seq[:, :-1],
                                         "targets": seq[:, 1:]})
    specs = {"params": T.param_specs(cfg, mesh)}
    with TrainCheckpointer(directory) as ckpt:
        ckpt.save(3, {"params": params, "opt_state": opt.state_dict()},
                  mesh=mesh, specs=specs)
        same = ckpt.restore(template=abstract_like(
            {"params": params, "opt_state": opt.state_dict()}, mesh, specs))
        whole = ckpt.restore()
        mesh_tp = M.make_mesh({"tp": 2}, device_type="cpu")
        want_tp = T.shard_params(whole["params"], cfg, mesh_tp)
        onto_tp = ckpt.restore(template=abstract_like(
            {"params": want_tp}, mesh_tp,
            {"params": T.param_specs(cfg, mesh_tp)}))
    return {
        "stage_layers": len(params["layers"]),
        "saved": to_np(params),
        "same": to_np(same["params"]),
        "opt_tensors": len(_tensors(opt.state_dict())),
        "same_opt_equal": all(
            torch.equal(a, b) for a, b in zip(
                _tensors(opt.state_dict()), _tensors(same["opt_state"]),
                strict=True)),
        "same_requires_grad": all(
            w.requires_grad for w in T.param_leaves(same["params"])),
        "onto_tp": to_np(onto_tp["params"]),
        "onto_tp_want": to_np(want_tp),
        "whole": to_np(whole["params"]),
    }


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=str) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []
