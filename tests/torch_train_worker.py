"""Rank functions of the training-under-a-mesh parity tests
(tests/test_torch_train_mesh.py, tests/test_torch_checkpoint_mesh.py).

``parallel.spawn`` starts each rank as a fresh process that imports this
module by name, so it imports no JAX: the JAX side runs in the test
process, and the weights, batches and LoRA factors cross as numpy arrays.
Each rank runs every case of its world size in one spawn and returns its
losses, its mesh coordinates and its shards after each step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bee_code_interpreter_tpu_torch.models import transformer as T
from bee_code_interpreter_tpu_torch.models.lora import (
    make_lora_train_step,
    shard_lora,
)
from bee_code_interpreter_tpu_torch.parallel import mesh as M
from bee_code_interpreter_tpu_torch.utils.checkpoint import (
    TrainCheckpointer,
    abstract_like,
)
from bee_code_interpreter_tpu_torch.weights import params_from_jax
from tests.torch_tp_worker import error_of, to_np

# several ranks share the CPU with the other test workers
torch.set_num_threads(1)

STEPS = 4
# case name -> (mesh axes, config name); the world of each is the product
DENSE_CASES = {
    "dp2": {"dp": 2},
    "tp2": {"tp": 2},
    "dp2_tp2": {"dp": 2, "tp": 2},
    "fsdp2_tp2": {"fsdp": 2, "tp": 2},
}
MOE_CASES = {
    "moe_ep2_tp2": ({"ep": 2, "tp": 2}, "moe"),
    "moe_dp2_ep2": ({"dp": 2, "ep": 2}, "moe"),
    "moe_dp2_local": ({"dp": 2}, "moe_local"),
}
# tp not dividing kv_heads: case -> (mesh axes, config name); each config
# has weights of its own (``inputs[config name]``)
KV_CASES = {
    "tp4_kv2": ({"tp": 4}, "dense_tp4_kv2"),
    "tp2_kv1": ({"tp": 2}, "dense_tp2_kv1"),
}


def dense_config(**kw) -> T.TransformerConfig:
    """The tiny decoder in f32 over 2 K/V heads, ``z_loss=1e-2`` so the
    z-loss term shows (tests/test_torch_training.py's config)."""
    return dataclasses.replace(T.TransformerConfig.tiny(), dtype=torch.float32,
                               **{"n_kv_heads": 2, "z_loss": 1e-2, **kw})


def moe_config(group_size: int = 1024) -> T.TransformerConfig:
    """``tiny_moe`` in f32 over 2 K/V heads at capacity factor 0.5, so
    choices are dropped; the 128 tokens of a 4 x 32 batch route in one
    group (the default 1024) or in four of 32."""
    return dataclasses.replace(T.TransformerConfig.tiny_moe(),
                               dtype=torch.float32, n_kv_heads=2,
                               z_loss=1e-2, moe_capacity_factor=0.5,
                               moe_group_size=group_size)


CONFIGS = {"dense": dense_config, "moe": moe_config,
           "moe_local": lambda: moe_config(32),
           "dense_ulysses": lambda: dense_config(sp_attention="ulysses"),
           # 8 heads over 2 K/V heads at tp=4, 4 over 1 at tp=2: the K/V
           # heads broadcast to lcm(kv_heads, tp), a copy on each rank
           "dense_tp4_kv2": lambda: dense_config(n_heads=8, n_kv_heads=2),
           "dense_tp2_kv1": lambda: dense_config(n_kv_heads=1)}
# training under sp (tests/test_torch_train_sp.py): case -> (mesh axes,
# config name)
SP_CASES = {
    "sp2_ring": ({"sp": 2}, "dense"),
    "sp2_ulysses": ({"sp": 2}, "dense_ulysses"),
    "moe_sp2": ({"sp": 2}, "moe"),
    "dp2_sp2": ({"dp": 2, "sp": 2}, "dense"),
    "sp2_tp2": ({"sp": 2, "tp": 2}, "dense"),
    "moe_dp2_sp2": ({"dp": 2, "sp": 2}, "moe"),
}


def snapshot(tree):
    """``to_np`` of a tree as copies: the leaves train on in place."""
    if isinstance(tree, dict):
        return {k: snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [snapshot(v) for v in tree]
    return np.array(to_np(tree))


def world_of(axes: dict) -> int:
    return int(np.prod(list(axes.values())))


def coords(mesh) -> dict:
    return {a: M.axis_index(mesh, a) for a in M.axis_sizes(mesh)}


def train(cfg, mesh, params_np, batch_np) -> dict:
    """``STEPS`` steps of ``Transformer(cfg, mesh).make_train_step`` on the
    rank's rows of the batch: the losses and the rank's shards after each
    step."""
    model = T.Transformer(cfg, mesh)
    params = params_from_jax(params_np, cfg, mesh=mesh, requires_grad=True)
    batch = model.batch_slice({k: torch.as_tensor(v)
                               for k, v in batch_np.items()})
    step = model.make_train_step()
    state, losses, shards, grads = None, [], [], None
    for _ in range(STEPS):
        params, state, loss = step(params, state, batch)
        losses.append(loss.item())
        shards.append(snapshot(params))
        if grads is None:  # the first step's, summed over the batch axes
            grads = snapshot(grad_tree(params))
    return {"losses": losses, "shards": shards, "grads": grads,
            "coords": coords(mesh), "rows": batch["tokens"].shape[0],
            "positions": batch["tokens"].shape[1]}


def grad_tree(tree):
    """The gradients on a params tree's leaves, in its layout."""
    if isinstance(tree, dict):
        return {k: grad_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [grad_tree(v) for v in tree]
    return tree.grad


def lora_train(cfg, mesh, params_np, lora_np, batch_np, scale) -> dict:
    """``STEPS`` steps of ``make_lora_train_step(mesh=...)``: the losses
    and the rank's factors after each step."""
    params = params_from_jax(params_np, cfg, mesh=mesh)
    lora = shard_lora({t: {k: torch.from_numpy(np.array(x))
                           for k, x in ab.items()}
                       for t, ab in lora_np.items()}, cfg, mesh)
    batch = T.Transformer(cfg, mesh).batch_slice(
        {k: torch.as_tensor(v) for k, v in batch_np.items()})
    step, _ = make_lora_train_step(cfg, mesh=mesh, scale=scale)
    state, losses, shards, grads = None, [], [], None
    for _ in range(STEPS):
        lora, state, loss = step(lora, state, params, batch)
        losses.append(loss.item())
        shards.append(snapshot(lora))
        if grads is None:
            grads = snapshot(grad_tree(lora))
    return {"losses": losses, "shards": shards, "grads": grads,
            "coords": coords(mesh)}


def train_mesh_cases(rank: int, world: int, inputs: dict) -> dict:
    """Every case of ``world`` ranks: the dense and MoE train steps and the
    LoRA step at dp=2 x tp=2."""
    out = {}
    for name, axes in DENSE_CASES.items():
        if world_of(axes) == world:
            out[name] = train(dense_config(), M.make_mesh(axes, device_type="cpu"),
                              inputs["dense"], inputs["batch"])
    for name, (axes, which) in MOE_CASES.items():
        if world_of(axes) == world:
            out[name] = train(CONFIGS[which](),
                              M.make_mesh(axes, device_type="cpu"),
                              inputs["moe"], inputs["batch"])
    for name, (axes, which) in KV_CASES.items():
        if world_of(axes) == world:
            out[name] = train(CONFIGS[which](),
                              M.make_mesh(axes, device_type="cpu"),
                              inputs[which], inputs["batch"])
    if world == 4:
        mesh = M.make_mesh({"dp": 2, "tp": 2}, device_type="cpu")
        out["lora_dp2_tp2"] = lora_train(dense_config(), mesh, inputs["dense"],
                                         inputs["lora"], inputs["batch"],
                                         inputs["lora_scale"])
        # init under a mesh keeps the shard shard_params takes of the same
        # draws
        mesh = M.make_mesh({"fsdp": 2, "tp": 2}, device_type="cpu")
        cfg = dense_config()
        full = T.init_params(cfg, torch.Generator().manual_seed(3), "cpu",
                             dtype=torch.float32)
        got = T.Transformer(cfg, mesh).init(torch.Generator().manual_seed(3),
                                            "cpu")
        want = T.shard_params(full, cfg, mesh)
        out["init_is_shard"] = all(
            torch.equal(a, b) and a.requires_grad
            for a, b in zip(T.param_leaves(got), T.param_leaves(want)))
    return out


def train_sp_cases(rank: int, world: int, inputs: dict) -> dict:
    """Every ``SP_CASES`` case of ``world`` ranks, and at four ranks the
    LoRA step at sp=2 x tp=2."""
    out = {}
    for name, (axes, which) in SP_CASES.items():
        if world_of(axes) == world:
            key = "moe" if which.startswith("moe") else "dense"
            out[name] = train(CONFIGS[which](),
                              M.make_mesh(axes, device_type="cpu"),
                              inputs[key], inputs["batch"])
    if world == 4:
        mesh = M.make_mesh({"sp": 2, "tp": 2}, device_type="cpu")
        out["lora_sp2_tp2"] = lora_train(dense_config(), mesh, inputs["dense"],
                                         inputs["lora"], inputs["batch"],
                                         inputs["lora_scale"])
    return out


def checkpoint_two_ranks(rank: int, inputs: dict, directory: str) -> dict:
    """Two ranks: one train step at ``{"tp": 2}``, saved sharded as step 5
    (params, AdamW state and a step count); each rank's param shards and
    coordinates, from which the whole trained tree is put together."""
    cfg = dense_config(n_kv_heads=None)
    mesh = M.make_mesh({"tp": 2}, device_type="cpu")
    model = T.Transformer(cfg, mesh)
    params = params_from_jax(inputs["dense"], cfg, mesh=mesh,
                             requires_grad=True)
    batch = model.batch_slice({k: torch.as_tensor(v)
                               for k, v in inputs["batch"].items()})
    params, opt, _ = model.make_train_step()(params, None, batch)
    with TrainCheckpointer(directory) as ckpt:
        ckpt.save(5, {"params": params, "opt_state": opt.state_dict(),
                      "step": 5},
                  mesh=mesh, specs={"params": T.param_specs(cfg, mesh)})
    return {"shards": snapshot(params), "coords": coords(mesh)}


def whole_over_tp(shards: list, specs):
    """The whole tree from the ranks' shards over ``{"tp": len(shards)}``
    in rank order: each leaf concatenated along its spec's tp dim."""
    first = shards[0]
    if isinstance(first, dict):
        return {k: whole_over_tp([s[k] for s in shards],
                                 specs if k not in specs else specs[k])
                for k in first}
    if isinstance(first, list):
        return [whole_over_tp([s[i] for s in shards], specs)
                for i in range(len(first))]
    if "tp" not in specs:
        return torch.as_tensor(first)
    return torch.cat([torch.as_tensor(s) for s in shards],
                     dim=specs.index("tp"))


def checkpoint_cases(rank: int, inputs: dict, directory: str,
                     two: dict) -> dict:
    """Four ranks: params and AdamW state saved sharded under ``{"fsdp": 2,
    "tp": 2}``, restored onto ``{"fsdp": 1, "tp": 4}`` (each leaf against
    ``shard_params`` of the whole tree there) and onto the same mesh (the
    optimizer state, every leaf bitwise); the optimizer state refused
    onto the other mesh. ``two``: the step ``checkpoint_two_ranks`` saved
    on two ranks, restored onto ``{"fsdp": 2, "tp": 2}`` (its params
    against ``shard_params`` of the whole tree its ranks held; its
    optimizer state refused). The tiny decoder's 4 K/V heads divide over
    tp=4."""
    cfg = dense_config(n_kv_heads=None)
    full = params_from_jax(inputs["dense"], cfg, device="cpu")
    mesh_a = M.make_mesh({"fsdp": 2, "tp": 2}, device_type="cpu")
    mesh_b = M.make_mesh({"fsdp": 1, "tp": 4}, device_type="cpu")
    model = T.Transformer(cfg, mesh_a)
    params = params_from_jax(inputs["dense"], cfg, mesh=mesh_a,
                             requires_grad=True)
    batch = model.batch_slice({k: torch.as_tensor(v)
                               for k, v in inputs["batch"].items()})
    params, opt, _ = model.make_train_step()(params, None, batch)
    specs_a = T.param_specs(cfg, mesh_a)
    state = {"params": params, "opt_state": opt.state_dict(), "step": 17}
    out = {}
    with TrainCheckpointer(directory) as ckpt:
        ckpt.save(1, params, mesh=mesh_a, specs=specs_a)
        ckpt.save(17, state, mesh=mesh_a, specs={"params": specs_a})
        steps = ckpt.all_steps()
        target = params_from_jax(inputs["dense"], cfg, mesh=mesh_b,
                                 requires_grad=True)
        template = abstract_like(target, mesh_b, T.param_specs(cfg, mesh_b))
        restored = ckpt.restore(1, template=template)
        whole = ckpt.restore(1)
        again = ckpt.restore(template=abstract_like(
            state, mesh_a, {"params": specs_a}))
        specs_b = T.param_specs(cfg, mesh_b)
        out["other_mesh_refused"] = error_of(lambda: ckpt.restore(
            17, template=abstract_like({**state, "params": target}, mesh_b,
                                       {"params": specs_b})))
    fresh = params_from_jax(inputs["dense"], cfg, mesh=mesh_a,
                            requires_grad=True)
    with TrainCheckpointer(two["directory"]) as ckpt:
        from_two = ckpt.restore(5, template={"params": abstract_like(
            fresh, mesh_a, specs_a)})
        out["two_to_four_opt_refused"] = error_of(lambda: ckpt.restore(
            5, template=abstract_like({**state, "params": fresh}, mesh_a,
                                      {"params": specs_a})))
    # the specs over a tp axis alone (tp=2 divides the 4 K/V heads)
    trained_two = whole_over_tp(two["shards"], T._specs(cfg, ("tp",)))
    out["two_to_four_exact"] = all(
        torch.equal(a, b) and a.requires_grad
        for a, b in zip(T.param_leaves(from_two["params"]),
                        T.param_leaves(T.shard_params(trained_two, cfg,
                                                      mesh_a))))
    out["two_to_four_keys"] = sorted(from_two)
    # the trained params put together whole, then sharded over mesh_b
    trained_b = T.shard_params(whole, cfg, mesh_b)
    out["steps"] = steps
    out["cross_exact"] = all(
        torch.equal(a, b) for a, b in zip(T.param_leaves(restored),
                                          T.param_leaves(trained_b)))
    out["cross_shapes"] = [
        (tuple(a.shape), M.local_shape(w.shape, spec, mesh_b))
        for a, (w, spec) in zip(T.param_leaves(restored),
                                T.leaf_specs(whole, T.param_specs(cfg,
                                                                  mesh_b)))]
    out["cross_requires_grad"] = all(
        w.requires_grad for w in T.param_leaves(restored))
    out["whole_shapes"] = [tuple(w.shape) for w in T.param_leaves(whole)]
    out["full_shapes"] = [tuple(w.shape) for w in T.param_leaves(full)]
    out["same_mesh_exact"] = (
        again["step"] == 17
        and all(torch.equal(a, b) for a, b in zip(
            T.param_leaves(again["params"]), T.param_leaves(params)))
        and all(torch.equal(a["exp_avg"], b["exp_avg"])
                and torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
                and torch.equal(a["step"], b["step"])
                for a, b in zip(again["opt_state"]["state"].values(),
                                state["opt_state"]["state"].values())))
    out["coords_a"] = coords(mesh_a)
    out["coords_b"] = coords(mesh_b)
    out["whole"] = to_np(whole)
    out.update(checkpoint_kv_case(inputs, directory))
    return out


def checkpoint_kv_case(inputs: dict, directory: str) -> dict:
    """Four ranks: one train step at ``KV_CASES["tp4_kv2"]`` (8 heads over 2
    K/V heads, each rank a copy of one), saved sharded (params and step),
    restored onto ``{"dp": 2, "tp": 2}`` (a mesh whose tp divides
    kv_heads), onto no mesh (the whole tree: sharded back over tp=4 it is
    the ranks' trained params, bitwise) and onto the same mesh."""
    axes, which = KV_CASES["tp4_kv2"]
    cfg = CONFIGS[which]()
    mesh = M.make_mesh(axes, device_type="cpu")
    model = T.Transformer(cfg, mesh)
    params = params_from_jax(inputs[which], cfg, mesh=mesh, requires_grad=True)
    batch = model.batch_slice({k: torch.as_tensor(v)
                               for k, v in inputs["batch"].items()})
    params, _, _ = model.make_train_step()(params, None, batch)
    specs = T.param_specs(cfg, mesh)
    other = M.make_mesh({"dp": 2, "tp": 2}, device_type="cpu")
    with TrainCheckpointer(f"{directory}-kv") as ckpt:
        ckpt.save(3, {"params": params, "step": 3}, mesh=mesh,
                  specs={"params": specs})
        whole = ckpt.restore(3)
        target = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                               dtype=torch.float32, requires_grad=True,
                               mesh=other)
        onto_other = ckpt.restore(3, template={"params": abstract_like(
            target, other, T.param_specs(cfg, other))})
        again = ckpt.restore(3, template=abstract_like(
            {"params": params, "step": 3}, mesh, {"params": specs}))

    def same(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(
            T.param_leaves(a), T.param_leaves(b), strict=True))

    return {
        "kv_whole_shapes_ok": [tuple(w.shape) for w in T.param_leaves(
            whole["params"])] == [tuple(w.shape) for w in T.param_leaves(
                params_from_jax(inputs[which], cfg, device="cpu"))],
        "kv_roundtrip_exact": same(T.shard_params(whole["params"], cfg, mesh),
                                   params),
        "kv_other_mesh_exact": same(onto_other["params"], T.shard_params(
            whole["params"], cfg, other)),
        "kv_same_mesh_exact": again["step"] == 3 and same(again["params"],
                                                          params),
        "kv_trains": all(w.requires_grad for w in T.param_leaves(
            onto_other["params"])),
    }
