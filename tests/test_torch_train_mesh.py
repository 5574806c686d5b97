"""The port's training step under a mesh against the JAX package's
``make_train_step`` on the same mesh shapes (``tests/test_models.py:49-66``
``test_train_step_sharded``, ``tests/test_moe.py:116``
``test_moe_train_step_dp_ep_tp_sharded``, the first and third
``dryrun_multichip`` validations of ``__graft_entry__.py``).

The port's ranks are spawned with gloo on the CPU, once per world size (2
and 4), running ``tests/torch_train_worker.py``; JAX runs here on the
virtual devices of ``tests/conftest.py``, a mesh over the first 2 or 4 of
them. The 8-device shapes of the JAX tests get 4-rank analogues: ``{"dp":
8}`` -> ``{"dp": 2}``, ``{"dp": 2, "tp": 4}`` -> ``{"dp": 2, "tp": 2}`` and
``{"tp": 2}``, ``{"fsdp": 4, "tp": 2}`` -> ``{"fsdp": 2, "tp": 2}``, the MoE
``{"dp": 2, "ep": 2, "tp": 2}`` -> ``{"ep": 2, "tp": 2}`` and ``{"dp": 2,
"ep": 2}`` (one routing group of 128 tokens spanning the dp ranks) and
``{"dp": 2}`` with groups of 32 (each inside a rank). The meshes with
``sp`` are tests/test_torch_train_sp.py's, on the helpers here.

Every case runs four steps in f32 on the same weights and the same global
batch: each step's loss and every updated leaf (each rank's shard against
the same block of JAX's leaf) within ``TOL`` (1e-5,
tests/test_torch_training.py's), the first step's gradient of every leaf
(after the sums over the batch axes) within ``GRAD_TOL`` of
``jax.grad(loss_fn)`` on the mesh, and every leaf bitwise equal on the
ranks that hold the same block of it (a leaf replicated over an axis stays
the same bits on every rank of it). Four steps, not JAX's two: on the
card, tp=2's bf16 losses leave one card's from step 4 on (chip_smoke.py's
``train_tp_rounding_control`` shows the rounding alone does it), and the
f32 steps here show the port's algebra holding past the first two.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bee_code_interpreter_tpu.models import transformer as jax_t
from bee_code_interpreter_tpu.models.lora import init_lora as jax_init_lora
from bee_code_interpreter_tpu.models.lora import merge_lora as jax_merge_lora
from bee_code_interpreter_tpu.models.lora import (
    make_lora_train_step as jax_make_lora_train_step,
)
from bee_code_interpreter_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bee_code_interpreter_tpu_torch.parallel import mesh as M
from tests import torch_train_worker as W

TOL = 1e-5
# an expert weight after an AdamW step: within a tenth of the learning rate
# (tests/test_torch_moe.py's limit, and its reason): AdamW's first step
# moves a weight by ~lr times g / (|g| + 1e-8), so an expert row whose
# gradient is f32 noise (JAX's smallest here: 1.8e-9) moves by a fraction
# of lr that differs between the two frameworks' sums. Reading: 2.23e-5 at
# one element of 32768 (moe_dp2_local, layers.0.moe.we_gate, step 1); every
# other leaf and case within TOL.
EXPERT_TOL = 0.1 * 3e-4
# gradients: tests/test_torch_training.py's GRAD_TOL (1e-4 relative, and of
# the leaf's largest element absolute)
GRAD_TOL = 1e-4
STEPS = W.STEPS
LORA_SCALE = 2.0
LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w_gate", "w_up", "w_down")
MOE_LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2")
MOE_KEYS = ("router", "we_gate", "we_up", "we_down")


def jax_dense_config():
    return dataclasses.replace(jax_t.TransformerConfig.tiny(),
                               dtype=jnp.float32, n_kv_heads=2, z_loss=1e-2)


def jax_moe_config(group_size=1024):
    return dataclasses.replace(jax_t.TransformerConfig.tiny_moe(),
                               dtype=jnp.float32, n_kv_heads=2, z_loss=1e-2,
                               moe_capacity_factor=0.5,
                               moe_group_size=group_size)


JAX_CONFIGS = {"dense": jax_dense_config, "moe": jax_moe_config,
               "moe_local": lambda: jax_moe_config(32),
               "dense_ulysses": lambda: dataclasses.replace(
                   jax_dense_config(), sp_attention="ulysses"),
               "dense_tp4_kv2": lambda: dataclasses.replace(
                   jax_dense_config(), n_heads=8, n_kv_heads=2),
               "dense_tp2_kv1": lambda: dataclasses.replace(
                   jax_dense_config(), n_kv_heads=1)}
CASES = {**{name: (axes, "dense") for name, axes in W.DENSE_CASES.items()},
         **W.MOE_CASES, **W.KV_CASES}


@pytest.fixture(scope="module")
def inputs():
    dense = jax_t.init_params(jax_dense_config(), jax.random.PRNGKey(0))
    moe = jax_t.init_params(jax_moe_config(), jax.random.PRNGKey(1))
    seq = np.random.default_rng(6).integers(0, 256, (4, 33)).astype(np.int32)
    lora = jax_init_lora(jax_dense_config(), jax.random.PRNGKey(2), rank=4,
                         targets=("wq", "wv", "wo"))
    # B non-zero, so A gets a gradient from the first step on
    lora = {t: {"A": ab["A"], "B": 0.05 * jax.random.normal(
        jax.random.PRNGKey(3 + i), ab["B"].shape)}
        for i, (t, ab) in enumerate(sorted(lora.items()))}
    kv = {which: jax_t.init_params(JAX_CONFIGS[which](),
                                   jax.random.PRNGKey(10 + i))
          for i, (_, which) in enumerate(W.KV_CASES.values())}
    return {"jax_dense": dense, "jax_moe": moe, "jax_lora": lora,
            **{f"jax_{which}": p for which, p in kv.items()},
            **{which: jax.tree.map(np.asarray, p) for which, p in kv.items()},
            "dense": jax.tree.map(np.asarray, dense),
            "moe": jax.tree.map(np.asarray, moe),
            "lora": jax.tree.map(np.asarray, lora),
            "lora_scale": LORA_SCALE,
            "batch": {"tokens": seq[:, :-1], "targets": seq[:, 1:]}}


@pytest.fixture(scope="module")
def spawned(inputs):
    """World size -> every rank's records: one spawn per world size."""
    payload = {k: inputs[k] for k in ("dense", "moe", "lora", "lora_scale",
                                      "batch",
                                      *(w for _, w in W.KV_CASES.values()))}
    return {world: M.spawn(W.train_mesh_cases, world, device_type="cpu",
                           args=(world, payload), timeout=600)
            for world in (2, 4)}


def jax_mesh(axes):
    return jax_make_mesh(axes, devices=jax.devices()[:W.world_of(axes)])


def jax_steps(model, params, batch, step, opt_state):
    """``STEPS`` steps: each step's loss and params as numpy."""
    losses, trees = [], []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
        trees.append(jax.tree.map(np.asarray, params))
    return losses, trees


def jax_train(axes, which, inputs):
    """JAX's ``STEPS`` steps on the mesh, and its gradient at the first."""
    cfg = JAX_CONFIGS[which]()
    mesh = jax_mesh(axes)
    model = jax_t.Transformer(cfg, mesh)
    key = (which if f"jax_{which}" in inputs
           else "moe" if which.startswith("moe") else "dense")
    params = jax_t.shard_params(inputs[f"jax_{key}"], cfg, mesh)
    optimizer = model.make_optimizer()
    batch = jax.device_put({k: jnp.asarray(v)
                            for k, v in inputs["batch"].items()},
                           model.batch_sharding())
    grads = jax.tree.map(np.asarray, jax.jit(
        lambda p, b: jax.grad(jax_t.loss_fn)(p, b, cfg, mesh))(params, batch))
    return jax_steps(model, params, batch, model.make_train_step(optimizer),
                     optimizer.init(params)), grads, cfg


def block(full: np.ndarray, spec, axes: dict, coords: dict) -> np.ndarray:
    """The rank's block of a whole leaf under ``spec`` (``shard_tensor``'s
    layout)."""
    out = full
    for dim, axis in enumerate(spec):
        n = axes.get(axis, 1) if axis else 1
        if n > 1:
            size = out.shape[dim] // n
            out = np.take(out, range(coords[axis] * size,
                                     (coords[axis] + 1) * size), axis=dim)
    return out


def rank_block(full: np.ndarray, key, specs, axes: dict, coords: dict,
               cfg) -> np.ndarray:
    """The rank's block of a whole leaf: ``block`` under its spec, or, for
    ``wk``/``wv`` where tp does not divide ``kv_heads``, the columns of
    ``kv_columns`` (the rank's K/V heads of the lcm broadcast)."""
    from bee_code_interpreter_tpu_torch.models import transformer as T

    tp = axes.get("tp", 1)
    spec = spec_of(specs, key)
    if key in (("layers", "wk"), ("layers", "wv")) and cfg.n_kv_heads % tp:
        port_cfg = T.TransformerConfig(
            d_model=cfg.d_model, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads)
        cols = T.kv_columns(port_cfg, tp, coords["tp"]).numpy()
        return block(full, spec[:-1], axes, coords)[..., cols]
    return block(full, spec, axes, coords)


def port_leaves(tree, cfg):
    """(name, port shard, spec key) of every weight of a port tree."""
    for name in ("embed", "ln_f", "lm_head"):
        yield name, tree[name], name
    keys = MOE_LAYER_KEYS if cfg.n_experts else LAYER_KEYS
    for i, layer in enumerate(tree["layers"]):
        for name in keys:
            yield f"layers.{i}.{name}", layer[name], ("layers", name)
        if cfg.n_experts:
            for name in MOE_KEYS:
                yield (f"layers.{i}.moe.{name}", layer["moe"][name],
                       ("layers", "moe", name))


def jax_leaf(jtree, name):
    """The JAX leaf of a ``port_leaves`` name (JAX stacks the layers)."""
    parts = name.split(".")
    if parts[0] != "layers":
        return jtree[name]
    leaf = jtree["layers"]
    for key in parts[2:]:
        leaf = leaf[key]
    return leaf[int(parts[1])]


def spec_of(specs, key):
    if isinstance(key, str):
        return specs[key]
    for k in key:
        specs = specs[k]
    return specs


def port_specs(cfg, axes):
    """The port's ``param_specs`` over ``axes``, without a mesh (the same
    rule: tests/test_torch_parallel_mesh.py holds it to JAX's)."""
    from bee_code_interpreter_tpu_torch.models import transformer as T

    return T._specs(T.TransformerConfig(n_experts=cfg.n_experts),
                    tuple(axes))


def check_replicas(recs, step, cfg, axes):
    """Every leaf bitwise equal on the ranks that hold the same block."""
    specs = port_specs(cfg, axes)
    first = {}
    for r, rec in enumerate(recs):
        tree = rec["shards"][step]
        for name, shard, key in port_leaves(tree, cfg):
            spec = spec_of(specs, key)
            where = (name, tuple(rec["coords"].get(a) for a in spec if a))
            if where in first:
                np.testing.assert_array_equal(
                    shard, first[where],
                    err_msg=f"{name}: rank {r} differs from its replica")
            else:
                first[where] = shard


def assert_matches_jax(recs, case, axes, which, inputs):
    """Every rank's record of ``case`` against JAX's ``STEPS`` steps on the
    same mesh shape: losses, first gradients on the rank's block, updated
    leaves by block, replicas bitwise, one loss on every rank, falling."""
    (losses, trees), grads, cfg = jax_train(axes, which, inputs)
    specs = port_specs(cfg, axes)
    for r, rec in enumerate(recs):
        rec = rec[case]
        np.testing.assert_allclose(rec["losses"], losses, atol=TOL, rtol=TOL,
                                   err_msg=f"rank {r} losses")
        # the first step's gradient, summed over the batch axes, on the
        # rank's block (AdamW's update alone would not show a leaf's
        # gradient off by a constant factor)
        for name, got, key in port_leaves(rec["grads"], cfg):
            want = rank_block(np.asarray(jax_leaf(grads, name)), key, specs,
                              axes, rec["coords"], cfg)
            scale = max(np.abs(want).max(), 1e-6)
            np.testing.assert_allclose(
                got, want, atol=GRAD_TOL * scale, rtol=GRAD_TOL,
                err_msg=f"rank {r} gradient of {name}")
        for step in range(STEPS):
            for name, got, key in port_leaves(rec["shards"][step], cfg):
                want = jax_leaf(trees[step], name)
                expert = ".moe.we_" in name
                np.testing.assert_allclose(
                    got, rank_block(np.asarray(want), key, specs, axes,
                                    rec["coords"], cfg),
                    atol=EXPERT_TOL if expert else TOL,
                    rtol=0 if expert else TOL,
                    err_msg=f"rank {r} {name}, step {step + 1}")
    for step in range(STEPS):
        check_replicas([rec[case] for rec in recs], step, cfg, axes)
    # every rank reports the same loss, the global batch's
    assert len({tuple(rec[case]["losses"]) for rec in recs}) == 1
    assert losses[1] < losses[0]


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax_on_the_same_mesh(case, spawned, inputs):
    axes, which = CASES[case]
    assert_matches_jax(spawned[W.world_of(axes)], case, axes, which, inputs)


def test_each_rank_trains_on_its_rows(spawned):
    """The batch splits over dp then fsdp; tp and ep ranks share rows."""
    for case, (axes, _) in CASES.items():
        for rec in spawned[W.world_of(axes)]:
            n = axes.get("dp", 1) * axes.get("fsdp", 1)
            assert rec[case]["rows"] == 4 // n, case


def assert_lora_matches_jax(recs, case, axes, inputs):
    """Every rank's LoRA record of ``case`` against JAX's
    ``make_lora_train_step`` on the same mesh shape: losses, factors by
    block after each step, first gradients, replicas bitwise."""
    cfg = jax_dense_config()
    mesh = jax_mesh(axes)
    model = jax_t.Transformer(cfg, mesh)
    params = jax_t.shard_params(inputs["jax_dense"], cfg, mesh)
    step, optimizer = jax_make_lora_train_step(cfg, mesh=mesh,
                                               scale=LORA_SCALE)
    batch = jax.device_put({k: jnp.asarray(v)
                            for k, v in inputs["batch"].items()},
                           model.batch_sharding())
    lora = inputs["jax_lora"]
    grads = jax.tree.map(np.asarray, jax.jit(jax.grad(
        lambda factors: jax_t.loss_fn(
            jax_merge_lora(params, factors, LORA_SCALE), batch, cfg, mesh)
    ))(lora))
    state = optimizer.init(lora)
    losses, trees = [], []
    for _ in range(STEPS):
        lora, state, loss = step(lora, state, params, batch)
        losses.append(float(loss))
        trees.append(jax.tree.map(np.asarray, lora))
    base = port_specs(cfg, axes)["layers"]
    for r, rec in enumerate(recs):
        rec = rec[case]
        np.testing.assert_allclose(rec["losses"], losses, atol=TOL, rtol=TOL)
        for s in range(STEPS):
            for t, ab in trees[s].items():
                specs = {"A": (None, base[t][0], None),
                         "B": (None, None, base[t][1])}
                for k in ("A", "B"):
                    np.testing.assert_allclose(
                        rec["shards"][s][t][k],
                        block(ab[k], specs[k], axes, rec["coords"]),
                        atol=TOL, rtol=TOL,
                        err_msg=f"rank {r} {t}.{k}, step {s + 1}")
                    if s == 0:
                        want = block(grads[t][k], specs[k], axes,
                                     rec["coords"])
                        np.testing.assert_allclose(
                            rec["grads"][t][k], want, rtol=GRAD_TOL,
                            atol=GRAD_TOL * np.abs(want).max(),
                            err_msg=f"rank {r} gradient of {t}.{k}")
    # ranks holding the same block of a factor hold the same bits
    recs = [rec[case] for rec in recs]
    for t in trees[0]:
        for k, axis in (("A", base[t][0]), ("B", base[t][1])):
            held = {}
            for rec in recs:
                where = rec["coords"].get(axis) if axis else None
                got = rec["shards"][-1][t][k]
                if where in held:
                    np.testing.assert_array_equal(got, held[where])
                held[where] = got


def test_lora_train_step_matches_jax_at_dp2_tp2(spawned, inputs):
    assert_lora_matches_jax(spawned[4], "lora_dp2_tp2", {"dp": 2, "tp": 2},
                            inputs)


def test_init_under_a_mesh_keeps_the_rank_shard(spawned):
    assert all(rec["init_is_shard"] for rec in spawned[4])
