"""The port's parallel layer against the JAX package's: meshes, Megatron
shards and the tensor-parallel model functions.

The port is SPMD (one rank per device, ``torch.distributed``); its ranks
are spawned with gloo on the CPU (``parallel.spawn``), once per world size
for the whole file, and run every scenario of
``tests/torch_tp_worker.py::parallel_cases``. The JAX side runs here, on
the 8 virtual devices of ``tests/conftest.py``, with a tp mesh over the
first ``world`` of them. Checklist: the mesh cases of the JAX package's
tests/test_parallel.py (:16-40), ``shard_params`` against JAX's addressable
shards (bitwise, int8 ``{q, s}`` included), ``forward(return_kv)`` at tp=2
and tp=4 against JAX's tp ``forward`` (f32, 1e-5), and the paged and
contiguous decode paths and ``generate_cached`` under tp against JAX.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from bee_code_interpreter_tpu.models import transformer as jax_t
from bee_code_interpreter_tpu.ops.weight_quant import (
    quantize_weights as jax_quantize_weights,
)
from bee_code_interpreter_tpu.parallel import mesh as jax_mesh
from bee_code_interpreter_tpu_torch.parallel import mesh as M
from tests import torch_tp_worker as W

TOL = 1e-5
WORLDS = (2, 4)


def jax_config(**kw):
    """The tiny decoder in f32 with 4 KV heads (tp=4 divides them)."""
    return dataclasses.replace(jax_t.TransformerConfig.tiny(),
                               dtype=jnp.float32, n_kv_heads=4, **kw)


def tp_mesh(world: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:world]), ("tp",))


@pytest.fixture(scope="module")
def inputs():
    params = jax_t.init_params(jax_config(), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return {
        "jax_params": params,
        "params": jax.tree.map(np.asarray, params),
        "params_int8": jax.tree.map(np.asarray,
                                    jax_quantize_weights(params)),
        "tokens": rng.integers(0, 256, (2, 8)),
        "feed": rng.integers(0, 256, (2, 3)),
        # the four-rank cases of mesh_forward_cases
        "sp_tokens": rng.integers(0, 256, (2, 32)),
        "jax_h8": jax_t.init_params(h8_config(), jax.random.PRNGKey(2)),
        "jax_moe": jax_t.init_params(moe_config(), jax.random.PRNGKey(3)),
        "jax_kv2": jax_t.init_params(kv2_config(), jax.random.PRNGKey(4)),
    }


def h8_config():
    """8 query heads over 2 K/V heads: tp=4 does not divide the K/V heads."""
    return dataclasses.replace(jax_t.TransformerConfig.tiny(),
                               dtype=jnp.float32, n_heads=8, n_kv_heads=2)


def kv2_config(**kw):
    """The tiny decoder over 2 K/V heads, the serving tests' config."""
    return dataclasses.replace(jax_t.TransformerConfig.tiny(),
                               dtype=jnp.float32, n_kv_heads=2, **kw)


def moe_config():
    return kv2_config(n_experts=4)


@pytest.fixture(scope="module")
def spawned(inputs):
    """World size -> every rank's records: one spawn per world size."""
    payload = {k: v for k, v in inputs.items()
               if k not in ("jax_params", "jax_h8", "jax_moe", "jax_kv2")}
    payload.update(params_h8=jax.tree.map(np.asarray, inputs["jax_h8"]),
                   params_moe=jax.tree.map(np.asarray, inputs["jax_moe"]),
                   params_kv2=jax.tree.map(np.asarray, inputs["jax_kv2"]))
    return {world: M.spawn(W.parallel_cases, world, device_type="cpu",
                           args=(world, payload), timeout=300)
            for world in WORLDS}


@pytest.fixture(params=WORLDS, ids=lambda w: f"tp{w}")
def ranks(request, spawned):
    """(world, every rank's records)."""
    return request.param, spawned[request.param]


def jax_shard(x, world: int, rank: int) -> np.ndarray:
    """The shard of a JAX array that lives on device ``rank``."""
    device = jax.devices()[rank]
    (shard,) = [s for s in x.addressable_shards if s.device == device]
    return np.asarray(shard.data)


# ------------------------------------------------------------- the mesh


def test_ranks_join_one_group(ranks):
    world, recs = ranks
    for rec in recs:
        assert rec["initialized_again"] is True  # idempotent
        assert rec["world_size"] == world
        assert rec["local_device_count"] == 1


def test_make_mesh_key_and_descriptor_match_jax(ranks):
    world, recs = ranks
    want = jax_mesh.mesh_descriptor(tp_mesh(world))
    for rank, rec in enumerate(recs):
        assert rec["tp_key"] == jax_mesh.mesh_shape_key(tp_mesh(world))
        got = rec["tp_descriptor"]
        for key in ("axes", "shape", "n_devices", "platform"):
            assert got[key] == want[key], key
        # one rank per device: each process holds one, at its own place
        assert got["process_index"] == rank
        assert got["n_local_devices"] == 1
        assert got["coords"] == {"tp": rank}
    assert recs[0]["tp_descriptor"]["coords"] == want["coords"]


def test_make_mesh_grid_shapes(spawned):
    """JAX's test_make_mesh_shapes: a dp x tp grid, axis order kept (four
    ranks)."""
    recs = spawned[4]
    jmesh = jax_mesh.make_mesh({"dp": 2, "tp": 2})
    for rank, rec in enumerate(recs):
        assert rec["grid_key"] == jax_mesh.mesh_shape_key(jmesh) == "dp=2,tp=2"
        assert rec["grid_descriptor"]["axes"] == {"dp": 2, "tp": 2}
        assert rec["grid_descriptor"]["coords"] == {"dp": rank // 2,
                                                    "tp": rank % 2}
        assert rec["grid_batch_axes"] == jax_mesh.batch_axes(jmesh)
        # a mesh over the first two ranks: the others hold no device of it
        sub = rec["sub_descriptor"]
        assert sub["shape"] == "tp=2" and sub["n_devices"] == 2
        assert sub["n_local_devices"] == (1 if rank < 2 else 0)
        assert sub["coords"] == ({"tp": rank} if rank < 2 else {})


def test_make_mesh_too_big(ranks):
    world, recs = ranks
    with pytest.raises(ValueError, match=f"needs {8 * world} devices, have 8"):
        jax_mesh.make_mesh({"dp": 2 * world, "tp": 4})
    for rec in recs:
        kind, msg = rec["too_big"]
        assert kind == "ValueError"
        assert f"needs {8 * world} devices, have {world}" in msg
        kind, msg = rec["backend_mismatch"]
        assert kind == "ValueError" and "gloo" in msg


def test_auto_mesh_matches_jax(ranks):
    world, recs = ranks
    for sp, key in ((1, "auto"), (2, "auto_sp")):
        jmesh = jax_mesh.auto_mesh(world, sp=sp)
        want = (tuple(jmesh.axis_names), tuple(jmesh.devices.shape))
        for rec in recs:
            assert rec[key] == want


def test_batch_axes_match_jax(ranks):
    world, recs = ranks
    for rec in recs:
        assert rec["batch_axes"] == jax_mesh.batch_axes(tp_mesh(world))


def test_collectives_are_rank_major_and_exact(ranks):
    world, recs = ranks
    x = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
         for r in range(world)]
    for rec in recs:
        np.testing.assert_array_equal(rec["gather_last"],
                                      np.concatenate(x, axis=-1))
        np.testing.assert_array_equal(rec["gather_first"],
                                      np.concatenate(x, axis=0).astype(np.int8))
        # bf16 partials add in f32 and round once
        want = float(torch.tensor(sum(0.5 + r for r in range(world)),
                                  dtype=torch.bfloat16))
        np.testing.assert_array_equal(rec["reduce_bf16"], [want] * 3)


# --------------------------------------------------------------- shards


def test_param_specs_match_jax(ranks):
    world, recs = ranks
    jspecs = jax_t.param_specs(jax_config(), tp_mesh(world))
    for name in ("embed", "ln_f", "lm_head"):
        assert recs[0]["specs"][name] == tuple(jspecs[name])
    for name, spec in jspecs["layers"].items():
        # JAX's layer specs lead with the stacked layer axis
        assert tuple(spec)[0] is None
        assert recs[0]["specs"]["layers"][name] == tuple(spec)[1:]


def test_shards_equal_jax_addressable_shards(ranks, inputs):
    world, recs = ranks
    jcfg = jax_config()
    mesh = tp_mesh(world)
    for key, params in (("shard", inputs["jax_params"]),
                        ("shard_int8",
                         jax_quantize_weights(inputs["jax_params"]))):
        sharded = jax_t.shard_params(params, jcfg, mesh)
        for rank, rec in enumerate(recs):
            got = rec[key]
            for name in ("embed", "ln_f", "lm_head"):
                want = sharded[name]
                if isinstance(want, dict):
                    for part in ("q", "s"):
                        np.testing.assert_array_equal(
                            got[name][part], jax_shard(want[part], world, rank))
                else:
                    np.testing.assert_array_equal(
                        got[name], jax_shard(want, world, rank))
            for name, stacked in sharded["layers"].items():
                parts = ({"": stacked} if not isinstance(stacked, dict)
                         else stacked)
                for part, x in parts.items():
                    want = jax_shard(x, world, rank)
                    for li in range(jcfg.n_layers):
                        leaf = got["layers"][li][name]
                        leaf = leaf[part] if part else leaf
                        np.testing.assert_array_equal(leaf, want[li])


def test_shard_shapes_follow_the_specs(ranks):
    world, recs = ranks
    for rec in recs:
        assert rec["shard_shapes"] == rec["spec_shapes"]
        assert rec["shard_shapes"]["layers.wk"] == (64, 64 // world)
        assert rec["own_storage"]
        # params_from_jax feeds shard_params
        for name in ("embed", "lm_head"):
            np.testing.assert_array_equal(rec["shard_via_loader"][name],
                                          rec["shard"][name])


# ---------------------------------------------------------- tp functions


def test_tp_forward_matches_jax_tp_forward(ranks, inputs):
    world, recs = ranks
    jcfg = jax_config()
    logits, (k, v) = jax_t.forward(inputs["jax_params"],
                                   jnp.asarray(inputs["tokens"]), jcfg,
                                   mesh=tp_mesh(world), return_kv=True)
    kvh = jcfg.kv_heads // world
    for rank, rec in enumerate(recs):
        got = rec["forward"]
        np.testing.assert_allclose(got["logits"], np.asarray(logits),
                                   atol=TOL, rtol=TOL)
        heads = slice(rank * kvh, (rank + 1) * kvh)
        np.testing.assert_allclose(got["k"], np.asarray(k)[:, :, heads],
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got["v"], np.asarray(v)[:, :, heads],
                                   atol=TOL, rtol=TOL)
        # every rank returns the same (all-gathered) logits
        np.testing.assert_array_equal(got["logits"],
                                      recs[0]["forward"]["logits"])


def test_tp_forward_int8_weights_matches_jax(ranks, inputs):
    world, recs = ranks
    jcfg = jax_config()
    want = jax_t.forward(jax_quantize_weights(inputs["jax_params"]),
                         jnp.asarray(inputs["tokens"]), jcfg,
                         mesh=tp_mesh(world))
    for rec in recs:
        np.testing.assert_allclose(rec["forward_int8"], np.asarray(want),
                                   atol=TOL, rtol=TOL)


def test_tp_paged_decode_matches_jax(ranks, inputs):
    """Teacher-forced ``decode_step_paged`` steps over each rank's
    head-sharded pool give JAX's forward logits at those positions, with
    the einsums and through the kernel's wrapper (its plain version on
    the CPU) alike."""
    world, recs = ranks
    tokens, feed = inputs["tokens"], inputs["feed"]
    L = tokens.shape[1]
    full = jax_t.forward(inputs["jax_params"],
                         jnp.asarray(np.concatenate([tokens, feed], 1)),
                         jax_config())
    want = np.asarray(full)[:, L:L + feed.shape[1]]
    for rec in recs:
        np.testing.assert_allclose(rec["paged"], want, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(rec["paged_kernel_gate"], want,
                                   atol=TOL, rtol=TOL)


def test_tp_chunked_prefill_matches_jax(ranks, inputs):
    world, recs = ranks
    jcfg = jax_config()
    tokens = jnp.asarray(inputs["tokens"])
    last, cache = jax_t.prefill_chunked(inputs["jax_params"], tokens, jcfg,
                                        tokens.shape[1] + 4, chunk=3,
                                        mesh=tp_mesh(world))
    kvh = jcfg.kv_heads // world
    for rank, rec in enumerate(recs):
        np.testing.assert_allclose(rec["chunked"]["last"], np.asarray(last),
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(
            rec["chunked"]["k"],
            np.asarray(cache["k"])[:, :, rank * kvh:(rank + 1) * kvh],
            atol=TOL, rtol=TOL)


def test_tp_generate_cached_matches_jax(ranks, inputs):
    world, recs = ranks
    jcfg = jax_config()
    prompt = jnp.asarray(inputs["tokens"])
    model = jax_t.Transformer(jcfg, tp_mesh(world))
    want = {
        "generate_cached": model.generate_cached(
            inputs["jax_params"], prompt, max_new_tokens=5),
        "generate_cached_chunked": model.generate_cached(
            inputs["jax_params"], prompt, max_new_tokens=5, prefill_chunk=3),
        "generate_cached_int8_cache": jax_t.Transformer(
            dataclasses.replace(jcfg, kv_cache_dtype="int8"), tp_mesh(world)
        ).generate_cached(inputs["jax_params"], prompt, max_new_tokens=5),
        "generate": model.generate(inputs["jax_params"], prompt,
                                   max_new_tokens=3),
    }
    for rec in recs:
        for key, tokens in want.items():
            np.testing.assert_array_equal(rec[key], np.asarray(tokens),
                                          err_msg=key)


# ------------------------------------- K/V broadcast, sp and MoE (tp=4)

MESH_TOL = 2e-4


def test_forward_broadcasts_kv_heads_to_lcm_over_tp(spawned, inputs):
    """JAX's tests/test_models.py:222: n_heads=8 over kv_heads=2 at tp=4.
    K/V go to lcm(2, 4) = 4 heads, one a rank, group-major pairing kept:
    the sharded forward equals the unsharded one within 2e-4 (JAX's bound;
    the partial sums of wo and w_down add in another order), and each rank
    holds K/V head rank // 2."""
    cfg = h8_config()
    tokens = jnp.asarray(inputs["sp_tokens"])
    want, (k, _) = jax_t.forward(inputs["jax_h8"], tokens, cfg,
                                 return_kv=True)
    sharded = jax_t.forward(
        jax_t.shard_params(inputs["jax_h8"], cfg, tp_mesh(4)), tokens, cfg,
        tp_mesh(4))
    for rank, rec in enumerate(spawned[4]):
        got = rec["lcm"]
        assert tuple(got["wk_shape"]) == (64, cfg.head_dim)
        np.testing.assert_allclose(got["logits"], np.asarray(want),
                                   atol=MESH_TOL, rtol=MESH_TOL)
        np.testing.assert_allclose(got["logits"], np.asarray(sharded),
                                   atol=MESH_TOL, rtol=MESH_TOL)
        np.testing.assert_allclose(got["k"][:, :, 0],
                                   np.asarray(k)[:, :, rank // 2],
                                   atol=TOL, rtol=TOL)


SP_MESHES = {"sp=4": {"sp": 4}, "sp=2,tp=2": {"sp": 2, "tp": 2}}


@pytest.mark.parametrize("window", (None, 5))
@pytest.mark.parametrize("attn", ("ring", "ulysses"))
@pytest.mark.parametrize("key", tuple(SP_MESHES))
def test_sp_forward_matches_jax(spawned, inputs, key, attn, window):
    """Sequence-parallel forward (JAX's ``forward`` under an sp mesh):
    each rank's logits and K/V are its block of positions (and its tp
    heads) of JAX's, within 2e-4 (JAX's bound for its sp forward)."""
    cfg = kv2_config(sp_attention=attn, sliding_window=window)
    axes = SP_MESHES[key]
    devices = np.array(jax.devices()[:4]).reshape(tuple(axes.values()))
    mesh = Mesh(devices, tuple(axes))
    tokens = jnp.asarray(inputs["sp_tokens"])
    logits, (k, _) = jax_t.forward(
        jax_t.shard_params(inputs["jax_kv2"], cfg, mesh), tokens, cfg, mesh,
        return_kv=True)
    sp, tp = axes.get("sp", 1), axes.get("tp", 1)
    L, kvh = tokens.shape[1] // sp, cfg.kv_heads // tp
    for rank, rec in enumerate(spawned[4]):
        got = rec[f"sp {key} {attn} {window}"]
        s = rec[f"sp_index {key}"]
        t = rank % tp
        np.testing.assert_allclose(
            got["logits"], np.asarray(logits)[:, s * L:(s + 1) * L],
            atol=MESH_TOL, rtol=MESH_TOL)
        np.testing.assert_allclose(
            got["k"], np.asarray(k)[:, :, t * kvh:(t + 1) * kvh,
                                    s * L:(s + 1) * L],
            atol=MESH_TOL, rtol=MESH_TOL)


@pytest.mark.parametrize("key", tuple(SP_MESHES))
def test_sp_generate_matches_jax(spawned, inputs, key):
    """``Transformer.generate_cached`` and ``generate`` under an sp mesh: a
    13-token prompt, padded on the right to a multiple of sp for the
    sequence-parallel prefill, gives JAX's unsharded tokens on every
    rank."""
    cfg = kv2_config()
    prompt = jnp.asarray(inputs["sp_tokens"])[:, :13]
    model = jax_t.Transformer(cfg)
    want = {"cached": model.generate_cached(inputs["jax_kv2"], prompt,
                                            max_new_tokens=5),
            "plain": model.generate(inputs["jax_kv2"], prompt,
                                    max_new_tokens=3)}
    for rec in spawned[4]:
        for name, tokens in want.items():
            np.testing.assert_array_equal(rec[f"sp_generate {key}"][name],
                                          np.asarray(tokens), err_msg=name)


@pytest.mark.parametrize("name", tuple(W.SP_PADDING_CASES))
def test_sp_prompt_padding_stays_out_of_moe_routing(spawned, name):
    """ROADMAP Queue 3, fixed: ``generate_cached`` pads a 13-token
    prompt to a multiple of sp; the pads are kept out of the MoE routing
    pool, so the capacity-routed tiny_moe (f32, 2 K/V heads, capacity
    factor 0.5, port params from seed 0) gives the unsharded run's tokens
    on sp=4, where it gave others while the pads routed (row 1 of these
    prompts). The controls (L=12, nothing padded; the default capacity;
    sp=2) and the padding that stays, dense and ``moe_exact``, give the
    unsharded tokens too."""
    for rec in spawned[4]:
        got = rec[f"sp_padding {name}"]
        np.testing.assert_array_equal(got["mesh"], got["unsharded"])


def test_jax_refuses_the_prompt_the_port_pads(inputs):
    """The padding that stays is an intended divergence (ROADMAP Queue 3):
    JAX's sp mesh refuses a 13-token prompt (the sequence axis does not
    divide over sp=4), where the port pads it and gives the unsharded
    tokens (the dense and moe_exact cases above)."""
    mesh = jax_mesh.make_mesh({"sp": 4}, devices=jax.devices()[:4])
    prompt = jnp.asarray(inputs["sp_tokens"])[:, :13]
    with pytest.raises(ValueError):
        jax_t.Transformer(kv2_config(), mesh).generate_cached(
            inputs["jax_kv2"], prompt, max_new_tokens=2)


MOE_MESHES = ("ep=2,tp=2", "tp=4", "ep=4", "sp=4", "sp=2,ep=2")


@pytest.mark.parametrize("key", MOE_MESHES)
def test_moe_forward_over_tp_ep_sp_matches_jax(spawned, inputs, key):
    """Mixture-of-Experts layers under a mesh: experts over ep, each
    expert's d_ff over tp, the router replicated, routing global (under sp
    the router logits of the whole sequence). Logits within 2e-4 of JAX's
    unsharded forward (the expert partials add in another order), the aux
    loss equal to f32 ulps, and each rank's expert shard the shape
    JAX's specs give it."""
    cfg = moe_config()
    tokens = jnp.asarray(inputs["sp_tokens"])
    want, aux = jax_t.forward(inputs["jax_moe"], tokens, cfg,
                              return_aux=True)
    axes = dict(part.split("=") for part in key.split(","))
    ep, tp, sp = (int(axes.get(a, 1)) for a in ("ep", "tp", "sp"))
    E, D, F = cfg.n_experts, cfg.d_model, cfg.ff_dim
    L = tokens.shape[1] // sp
    for rec in spawned[4]:
        got = rec[f"moe {key}"]
        s = got["sp_index"]
        np.testing.assert_allclose(got["logits"],
                                   np.asarray(want)[:, s * L:(s + 1) * L],
                                   atol=MESH_TOL, rtol=MESH_TOL)
        np.testing.assert_allclose(got["aux"], np.asarray(aux), rtol=1e-6)
        assert got["loader_equal"]  # params_from_jax(mesh=...) carries MoE
        shapes = {n: tuple(x) for n, x in got["shapes"].items()}
        assert shapes == {"router": (D, E),
                                 "we_gate": (E // ep, D, F // tp),
                                 "we_up": (E // ep, D, F // tp),
                                 "we_down": (E // ep, F // tp, D)}


def test_moe_param_specs_match_jax():
    """JAX's expert specs (transformer.py:264-271) over an ep x tp mesh."""
    jspecs = jax_t.param_specs(moe_config(),
                               jax_mesh.make_mesh({"ep": 2, "tp": 2}))
    with W.single_rank_mesh({"ep": 1, "tp": 1}) as mesh:
        from bee_code_interpreter_tpu_torch.models import transformer as T

        specs = T.param_specs(W.tiny_config(n_experts=4), mesh)
    for name, spec in jspecs["layers"]["moe"].items():
        assert specs["layers"]["moe"][name] == tuple(spec)[1:], name
    assert "w_gate" not in specs["layers"]


# ------------------------------------------------------------- launcher


def test_spawn_fails_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        M.spawn(W.failing_rank, 2, device_type="cpu", timeout=120)


def test_spawn_timeout_carries_the_ranks_stacks():
    """A rank still running at the timeout has written its stacks half the
    timeout in; the error carries them, down to the frame it stands in."""
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)passed 20 s.*rank 0's "
                       "stacks.*in sleeping_rank"):
        M.spawn(W.sleeping_rank, 1, device_type="cpu", timeout=20)
    assert time.monotonic() - t < 60


def test_distributed_env_reads_both_launchers(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
                 "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
                 "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(name, raising=False)
    assert M.distributed_env() == (1, 0, None)
    assert M.initialize_distributed() is False  # one process: a no-op
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "3")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "coord:1234")
    assert M.distributed_env() == (4, 3, "coord:1234")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "head")
    assert M.distributed_env() == (2, 1, "head:29500")


def test_cuda_is_the_default_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device type is taken")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.make_mesh({"tp": 1})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.local_device_count()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.spawn(W.failing_rank, 2)
    assert not torch.distributed.is_initialized()


def test_single_rank_mesh_matches_jax_single_device_mesh():
    jmesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    with W.single_rank_mesh({"tp": 1}) as mesh:
        assert M.mesh_shape_key(mesh) == jax_mesh.mesh_shape_key(jmesh)
        assert M.mesh_descriptor(mesh) == jax_mesh.mesh_descriptor(jmesh)
        assert M.tp_group(mesh) is None  # tp=1: no collective to make
    assert not torch.distributed.is_initialized()
    assert M.mesh_shape_key(None) == jax_mesh.mesh_shape_key(None) == "1"
