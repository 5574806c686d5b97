"""Generation over the batch axes and the sharded checkpoint over pp,
against the JAX package and the port's own unsharded runs.

``Transformer.generate`` and ``generate_cached`` on the tiny f32 decoder
(JAX's weights) under ``{"dp": 2}``, ``{"fsdp": 2}`` and ``{"dp": 2, "tp":
2}`` (ranks spawned with gloo on the CPU, ``tests/torch_generate_worker.py``):
greedy tokens, uncached, cached and with a chunked prefill, equal JAX's
unsharded ``generate`` / ``generate_cached`` and the port's unsharded run,
exactly (JAX's tests/test_models.py pins greedy cached to uncached in f32
for the same reason: no argmax near-ties); seeded sampled tokens equal the
port's unsharded run with the same generator (each step's last logits are
gathered and every rank draws for the whole batch). A prompt whose rows do
not divide over dp raises ValueError in both frameworks. The checkpoint: a
pp=2 save of the 4-layer decoder's masters and AdamW state after a step
round-trips bit for bit onto pp=2, and the masters onto tp=2 and onto no
mesh.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bee_code_interpreter_tpu.models import transformer as jax_t
from bee_code_interpreter_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bee_code_interpreter_tpu_torch.models import transformer as T
from bee_code_interpreter_tpu_torch.parallel import mesh as M
from bee_code_interpreter_tpu_torch.weights import params_from_jax
from tests import torch_generate_worker as W
from tests.torch_tp_worker import tiny_config


def jax_config(**kw):
    return dataclasses.replace(jax_t.TransformerConfig.tiny(),
                               dtype=jnp.float32, n_kv_heads=2, **kw)


@pytest.fixture(scope="module")
def inputs():
    params = jax_t.init_params(jax_config(), jax.random.PRNGKey(0))
    params4 = jax_t.init_params(jax_config(n_layers=4), jax.random.PRNGKey(1))
    prompt = np.random.default_rng(4).integers(0, 256, (4, 7)).astype(np.int32)
    return {"jax_params": params, "params": jax.tree.map(np.asarray, params),
            "params4": jax.tree.map(np.asarray, params4), "prompt": prompt}


@pytest.fixture(scope="module")
def spawned(inputs):
    payload = {k: inputs[k] for k in ("params", "prompt")}
    return {world: M.spawn(W.generate_cases, world, device_type="cpu",
                           args=(world, payload), timeout=600)
            for world in (2, 4)}


@pytest.fixture(scope="module")
def unsharded(inputs):
    """The port's one-device runs of the same calls."""
    import torch

    cfg = tiny_config()
    params = params_from_jax(inputs["params"], cfg, device="cpu")
    with torch.no_grad():
        out = W.generations(T.Transformer(cfg), params,
                            torch.as_tensor(inputs["prompt"]).long())
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_greedy(inputs):
    model = jax_t.Transformer(jax_config())
    prompt = jnp.asarray(inputs["prompt"])
    return {"generate": np.asarray(model.generate(
                inputs["jax_params"], prompt, W.NEW_TOKENS)),
            "cached": np.asarray(model.generate_cached(
                inputs["jax_params"], prompt, W.NEW_TOKENS))}


def case_records(spawned, name):
    world = int(np.prod(list(W.GENERATE_CASES[name].values())))
    return [rec[name] for rec in spawned[world]]


def test_unsharded_greedy_matches_jax(unsharded, jax_greedy):
    np.testing.assert_array_equal(unsharded["generate"], jax_greedy["generate"])
    np.testing.assert_array_equal(unsharded["cached"], jax_greedy["cached"])
    np.testing.assert_array_equal(unsharded["chunked"], jax_greedy["cached"])


@pytest.mark.parametrize("case", list(W.GENERATE_CASES))
@pytest.mark.parametrize("kind", ["generate", "cached", "chunked"])
def test_greedy_over_the_batch_axes(spawned, unsharded, jax_greedy, case,
                                    kind):
    want = jax_greedy["generate" if kind == "generate" else "cached"]
    for r, rec in enumerate(case_records(spawned, case)):
        np.testing.assert_array_equal(rec[kind], want, err_msg=f"rank {r}")
        np.testing.assert_array_equal(rec[kind], unsharded[kind])


@pytest.mark.parametrize("case", list(W.GENERATE_CASES))
def test_sampled_over_the_batch_axes_equal_one_device(spawned, unsharded,
                                                      inputs, case):
    prompt = inputs["prompt"]
    for r, rec in enumerate(case_records(spawned, case)):
        got = rec["sampled"]
        assert got.shape == (4, 7 + W.NEW_TOKENS)
        np.testing.assert_array_equal(got[:, :7], prompt)
        np.testing.assert_array_equal(got, unsharded["sampled"],
                                      err_msg=f"rank {r}")
    # sampling is on: the draw differs from the greedy tokens somewhere
    assert not np.array_equal(unsharded["sampled"], unsharded["cached"])


def test_uneven_batch_is_refused_as_jax_refuses_it(spawned, inputs):
    """JAX's batch sharding raises ValueError on 3 rows over dp=2 (its
    shard_map / output sharding); the port's ``batch_slice`` does too."""
    mesh = jax_make_mesh({"dp": 2}, devices=jax.devices()[:2])
    model = jax_t.Transformer(jax_config(), mesh)
    params = jax_t.shard_params(inputs["jax_params"], jax_config(), mesh)
    prompt = jnp.asarray(inputs["prompt"][:3])
    for fn in ("generate", "generate_cached"):
        with pytest.raises(ValueError):
            getattr(model, fn)(params, prompt, W.NEW_TOKENS)
    for rec in spawned[2]:
        for fn in ("generate", "generate_cached"):
            kind, msg = rec["uneven"][fn]
            assert kind == "ValueError"
            assert "does not split over 2 batch shards" in msg


@pytest.fixture(scope="module")
def checkpointed(inputs, tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("ckpt_pp"))
    return M.spawn(W.checkpoint_pp, 2, device_type="cpu",
                   args=({"params4": inputs["params4"]}, directory),
                   timeout=300)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_pp_checkpoint_round_trips_onto_pp(checkpointed):
    for rec in checkpointed:
        assert rec["stage_layers"] == 2
        for a, b in zip(_leaves(rec["saved"]), _leaves(rec["same"]),
                        strict=True):
            np.testing.assert_array_equal(a, b)
        # a step count and two moments per leaf of the stage's 2 layers
        # (9 leaves each) and the replicated embed, ln_f and lm_head
        assert rec["opt_tensors"] == 3 * (2 * 9 + 3)
        assert rec["same_opt_equal"] and rec["same_requires_grad"]


def test_pp_checkpoint_restores_whole_and_onto_tp(checkpointed):
    """Every rank reads all 4 layers, in order, from both stages' files:
    stage 0's trained layers then stage 1's, and the replicated leaves; its
    tp shard of that tree onto tp=2."""
    stage0, stage1 = (rec["saved"] for rec in checkpointed)
    want = ([stage0["embed"]]
            + [x for layer in stage0["layers"] + stage1["layers"]
               for x in _leaves(layer)]
            + [stage0["ln_f"], stage0["lm_head"]])
    for rec in checkpointed:
        assert len(rec["whole"]["layers"]) == 4
        got = ([rec["whole"]["embed"]]
               + [x for layer in rec["whole"]["layers"]
                  for x in _leaves(layer)]
               + [rec["whole"]["ln_f"], rec["whole"]["lm_head"]])
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(_leaves(rec["onto_tp"]), _leaves(rec["onto_tp_want"]),
                        strict=True):
            np.testing.assert_array_equal(a, b)
