"""Rank functions of the pipeline parity tests (tests/test_torch_pipeline.py,
tests/test_torch_pipeline_transformer.py).

Like the other workers, this module imports no JAX: ``parallel.spawn``
starts each rank as a fresh process that imports it by name, the inputs
cross as numpy arrays, and every rank returns plain records that the
tests hold against the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from bee_code_interpreter_tpu_torch.models import transformer as T
from bee_code_interpreter_tpu_torch.parallel import mesh as M
from bee_code_interpreter_tpu_torch.parallel.pipeline import (
    spmd_pipeline,
    stage_block,
)
from bee_code_interpreter_tpu_torch.weights import params_from_jax
from tests.torch_tp_worker import error_of, to_np

torch.set_num_threads(1)

# case name -> (mesh axes, microbatches, n_layers, d, batch rows, with_aux)
# of tests/test_pipeline.py (its {"dp": 2, "pp": 4} as {"dp": 2, "pp": 2})
PIPELINE_CASES = {
    "pp2_m2": ({"pp": 2}, 2, 8, 16, 4, False),
    "pp4_m4": ({"pp": 4}, 4, 8, 16, 8, False),
    "pp4_m8": ({"pp": 4}, 8, 8, 16, 16, False),
    "grad_pp4": ({"pp": 4}, 4, 4, 8, 8, False),
    "dp2_pp2": ({"dp": 2, "pp": 2}, 4, 4, 16, 16, False),
    "aux_pp4": ({"pp": 4}, 4, 8, 16, 8, True),
    "aux_dp2_pp2": ({"dp": 2, "pp": 2}, 2, 4, 16, 8, True),
}


def world_of(axes: dict) -> int:
    return int(np.prod(list(axes.values())))


def stage_fn(h, layer):
    return torch.relu(h @ layer["w"] + layer["b"])


def stage_fn_aux(h, layer):
    """The layer and an auxiliary loss term of its output."""
    h = stage_fn(h, layer)
    return h, (h ** 2).mean()


def torch_layers(layers_np: dict) -> list[dict]:
    """The stacked ``{"w": [n, d, d], "b": [n, d]}`` as one trainable dict
    per layer."""
    n = layers_np["w"].shape[0]
    return [{k: torch.from_numpy(np.array(v[i])).requires_grad_()
             for k, v in layers_np.items()} for i in range(n)]


def pipeline_case(axes, n_micro, layers_np, x_np, with_aux) -> dict:
    """One case: the rank's output rows, aux, and the gradients of its
    layers (summed over dp) and of its rows of x, for the loss
    ``(out ** 2).sum()`` (+ aux), the rank's rows' share of the global
    one."""
    mesh = M.make_mesh(axes, device_type="cpu")
    layers = stage_block(torch_layers(layers_np), mesh)
    x = M.batch_slice(torch.from_numpy(np.array(x_np)), mesh).clone()
    x.requires_grad_()
    batch_axes = ("dp",) if "dp" in axes else ()
    got = spmd_pipeline(stage_fn_aux if with_aux else stage_fn, layers, x,
                        mesh=mesh, n_microbatches=n_micro,
                        batch_axes=batch_axes, with_aux=with_aux)
    out, aux = got if with_aux else (got, None)
    loss = (out ** 2).sum() + (aux if with_aux else 0.0)
    loss.backward()
    dp = M.mesh_groups(mesh).dp
    for layer in layers:
        for w in layer.values():
            if dp is not None:
                dist.all_reduce(w.grad, group=dp)
    stage = M.axis_index(mesh, "pp")
    return {"out": to_np(out), "aux": None if aux is None else aux.item(),
            "x_grad": to_np(x.grad), "stage": stage,
            "dp_index": M.axis_index(mesh, "dp"),
            "layer_grads": [{k: to_np(w.grad) for k, w in layer.items()}
                            for layer in layers]}


def pipeline_cases(rank: int, world: int, inputs: dict) -> dict:
    """Every case of ``world`` ranks, and at four ranks the divisibility
    errors (6 layers over pp=4; 6 rows into 4 microbatches)."""
    out = {}
    for name, (axes, n_micro, _, _, _, with_aux) in PIPELINE_CASES.items():
        if world_of(axes) == world:
            out[name] = pipeline_case(axes, n_micro, inputs[name]["layers"],
                                      inputs[name]["x"], with_aux)
    if world == 4:
        mesh = M.make_mesh({"pp": 4}, device_type="cpu")
        layers = torch_layers(inputs["six_layers"])
        out["layers_error"] = error_of(lambda: spmd_pipeline(
            stage_fn, stage_block(layers, mesh), torch.zeros(8, 8),
            mesh=mesh, n_microbatches=4))
        out["microbatch_error"] = error_of(lambda: spmd_pipeline(
            stage_fn, stage_block(torch_layers(inputs["eight_layers"]), mesh),
            torch.zeros(6, 8), mesh=mesh, n_microbatches=4))
    return out


# ------------------------------------------------- the pipelined decoder


def tiny(**kw) -> T.TransformerConfig:
    """JAX's ``f32_tiny`` (tests/test_pipeline_transformer.py), the z-loss
    off: its training loss is the mean NLL (and the MoE aux term)."""
    return dataclasses.replace(T.TransformerConfig.tiny(),
                               dtype=torch.float32, z_loss=0.0, **kw)


def ample_moe() -> T.TransformerConfig:
    return dataclasses.replace(T.TransformerConfig.tiny_moe(),
                               dtype=torch.float32, z_loss=0.0,
                               moe_capacity_factor=8.0)


def _adamw(params, lr):
    # optax.adamw(lr)'s defaults: b1 0.9, b2 0.999, eps 1e-8, decay 1e-4
    return torch.optim.AdamW(T.param_leaves(params), lr=lr,
                             betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


# case name -> (mesh axes, config, microbatches, what): the cases of
# tests/test_pipeline_transformer.py, {"dp": 2, "pp": 4} as {"dp": 2,
# "pp": 2}
TRANSFORMER_CASES = {
    "forward": ({"pp": 2}, "tiny", 2, "forward"),
    "forward_dp": ({"dp": 2, "pp": 2}, "tiny4", 2, "forward"),
    "train_dp": ({"dp": 2, "pp": 2}, "tiny", 2, "train"),
    "moe_oracle": ({"pp": 2}, "moe", 2, "forward_aux"),
    "moe_drop_free_dp": ({"dp": 2, "pp": 2}, "moe", 2, "forward_aux"),
    "moe_requires_aux": ({"pp": 2}, "moe", 2, "refusal"),
    "moe_train": ({"pp": 2}, "moe", 2, "train"),
}
TRANSFORMER_CONFIGS = {"tiny": tiny, "tiny4": lambda: tiny(n_layers=4),
                       "moe": ample_moe}
TRAIN_STEPS = 4


def transformer_case(axes, cfg, n_micro, what, params_np, tokens_np) -> dict:
    mesh = M.make_mesh(axes, device_type="cpu")
    model = T.Transformer(cfg, mesh)
    if what == "refusal":
        params = params_from_jax(params_np, cfg, mesh=mesh)
        return {"error": error_of(lambda: T.forward_pipelined(
            params, torch.zeros(4, 16, dtype=torch.long), cfg, mesh,
            n_microbatches=n_micro))}
    tokens = M.batch_slice(torch.from_numpy(np.array(tokens_np)), mesh)
    rec = {"dp_index": M.axis_index(mesh, "dp"),
           "stage": M.axis_index(mesh, "pp")}
    if what == "train":
        params = params_from_jax(params_np, cfg, mesh=mesh,
                                 requires_grad=True)
        rec["layers_held"] = len(params["layers"])
        batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
        step = model.make_train_step(functools.partial(_adamw, lr=1e-2),
                                     n_microbatches=n_micro)
        state, losses = None, []
        for _ in range(TRAIN_STEPS):
            params, state, loss = step(params, state, batch)
            losses.append(loss.item())
        rec["losses"] = losses
        return rec
    params = params_from_jax(params_np, cfg, mesh=mesh)
    rec["layers_held"] = len(params["layers"])
    with torch.no_grad():
        got = T.forward_pipelined(params, tokens, cfg, mesh, n_micro,
                                  return_aux=what == "forward_aux")
    logits, aux = got if what == "forward_aux" else (got, None)
    rec.update(logits=to_np(logits), aux=None if aux is None else aux.item())
    return rec


def transformer_cases(rank: int, world: int, inputs: dict) -> dict:
    """Every case of ``world`` ranks, on the inputs named after it."""
    out = {}
    for name, (axes, which, n_micro, what) in TRANSFORMER_CASES.items():
        if world_of(axes) == world:
            out[name] = transformer_case(
                axes, TRANSFORMER_CONFIGS[which](), n_micro, what,
                inputs[name]["params"], inputs[name]["tokens"])
    return out
