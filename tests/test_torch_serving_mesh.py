"""Serving under a mesh: the port's ``ContinuousBatcher(mesh=...)``
against the JAX package's.

Two ranks (gloo on the CPU, one spawn) each build the same batcher over
``make_mesh({"tp": 2}, device_type="cpu")`` and run every scenario of
``tests/torch_tp_worker.py::serving_cases``; four ranks (a second spawn)
run the sequence-parallel scenarios of
``tests/torch_sp_worker.py::serving_sp_cases``. The JAX batchers run here
over the same meshes of the 8 virtual devices. Checklist: every case of
the JAX package's tests/test_serving_mesh.py (:43 two requests, :63 the
int8 pool, :77 speculative, :93 prefix cache, :113 kv_heads, :125 the
snapshot across topologies, here in both directions, :153 ring admission
on sp=2 x tp=2, :172 the page_size refusal, :183 Ulysses), each held to
JAX's batcher on the same mesh and to unsharded solo decode token for
token, with the host bookkeeping equal to JAX's; under sp also prefix,
interleaved, speculative and chunked admission and the int8 pool;
multi-LoRA at tp=2 (JAX's
tests/test_multilora_serving.py:254) and Mixture-of-Experts batchers at
tp=2 and ep=2; a logprobs and a seeded sampled request; the step records
keyed by the mesh shape; every rank's streams the same; and the paths not
ported under a mesh refusing."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from bee_code_interpreter_tpu.models import lora as jax_lora
from bee_code_interpreter_tpu.models import serving as jax_serving
from bee_code_interpreter_tpu.models import transformer as jax_t
from bee_code_interpreter_tpu.observability.device import (
    DeviceMonitor as JaxDeviceMonitor,
)
from bee_code_interpreter_tpu.utils.metrics import Registry as JaxRegistry
from bee_code_interpreter_tpu_torch.models import transformer as torch_t
from bee_code_interpreter_tpu_torch.parallel import spawn
from bee_code_interpreter_tpu_torch.weights import params_from_jax
from tests import torch_sp_worker as SW
from tests import torch_tp_worker as W
from tests.torch_parity import host_state

PROMPT = W.PROMPT
LOGPROB_TOL = 1e-5


def cfg(**kw):
    return dataclasses.replace(jax_t.TransformerConfig.tiny(),
                               dtype=jnp.float32, n_kv_heads=2, **kw)


def tp_mesh() -> Mesh:
    return Mesh(np.array(jax.devices()[:2]), ("tp",))


LORA_SCALE = 2.0
MOE_PROMPTS = [np.random.default_rng(i).integers(0, 256, L).tolist()
               for i, L in enumerate((13, 7, 22, 16))]
RING_PROMPT = [int(x) for x in np.random.default_rng(0).integers(0, 200, 21)]
ULYSSES_PROMPT = [int(x) for x in
                  np.random.default_rng(3).integers(0, 200, 13)]


def moe_cfg(**kw):
    return cfg(n_experts=4, **kw)


def adapter(seed):
    """A rank-4 adapter on every attention projection, B drawn so that the
    delta moves the logits (JAX's trained_adapter)."""
    lora = jax_lora.init_lora(cfg(), jax.random.PRNGKey(seed), rank=4,
                              targets=("wq", "wk", "wv", "wo"))
    return {t: {"A": ab["A"],
                "B": jax.random.normal(jax.random.PRNGKey(seed + 100),
                                       ab["B"].shape) * 0.25}
            for t, ab in lora.items()}


@pytest.fixture(scope="module")
def weights():
    return {
        "params": jax_t.init_params(cfg(), jax.random.PRNGKey(0)),
        "draft_params": jax_t.init_params(cfg(n_layers=1),
                                          jax.random.PRNGKey(1)),
        "adapters": [adapter(1), adapter(2)],
        "moe_params": jax_t.init_params(moe_cfg(), jax.random.PRNGKey(5)),
    }


@pytest.fixture(scope="module")
def ranks(weights):
    """Both ranks' records of every tp scenario (one spawn)."""
    payload = {k: jax.tree.map(np.asarray, v) for k, v in weights.items()}
    payload.update(lora_scale=LORA_SCALE, moe_prompts=MOE_PROMPTS)
    return spawn(W.serving_cases, 2, device_type="cpu", args=(payload,),
                 timeout=300)


@pytest.fixture(scope="module")
def sp_ranks(weights):
    """Four ranks' records of the sequence-parallel scenarios (one
    spawn)."""
    payload = {k: jax.tree.map(np.asarray, weights[k])
               for k in ("params", "draft_params")}
    payload.update(ring_prompt=RING_PROMPT, ulysses_prompt=ULYSSES_PROMPT)
    return spawn(SW.serving_sp_cases, 4, device_type="cpu", args=(payload,),
                 timeout=300)


def jax_solo(params, config, prompt, n):
    out = jax_t.Transformer(config).generate_cached(
        params, jnp.asarray(prompt)[None, :], max_new_tokens=n)
    return np.asarray(out[0, len(prompt):]).tolist()


def torch_solo(params, config, prompt, n):
    """The port's unsharded solo decode."""
    tcfg = dataclasses.replace(
        torch_t.TransformerConfig.tiny(), dtype=torch.float32,
        n_kv_heads=config.n_kv_heads, kv_cache_dtype=config.kv_cache_dtype)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    out = torch_t.Transformer(tcfg).generate_cached(
        tparams, torch.as_tensor([prompt]), max_new_tokens=n)
    return out[0, len(prompt):].tolist()


def jax_batcher(params, config, mesh=None, **kw):
    return jax_serving.ContinuousBatcher(params, config,
                                         mesh=mesh or tp_mesh(), **kw)


def jax_mesh(axes: dict) -> Mesh:
    """A JAX mesh of ``axes`` over the first devices, the port's layout."""
    n = int(np.prod(list(axes.values())))
    return Mesh(np.array(jax.devices()[:n]).reshape(tuple(axes.values())),
                tuple(axes))


def check_case(ranks, name, results, jb, solos):
    """Rank 0's streams equal the JAX batcher's and the solo decodes (when
    given); its host state equals the JAX batcher's; every rank that ran
    the case equals rank 0."""
    got = ranks[0][name]
    assert got["results"] == results
    if solos is not None:
        assert got["results"] == solos
    assert got["host"] == host_state(jb)
    for rec in ranks[1:]:
        if name in rec:
            assert rec[name]["results"] == got["results"]
            assert rec[name]["host"] == got["host"]


def test_tp_batcher_matches_unsharded_solo_decode(ranks, weights):
    params, config = weights["params"], cfg()
    jb = jax_batcher(params, config, max_batch=2, n_pages=16, page_size=4,
                     max_pages_per_seq=4)
    r1, r2 = jb.submit(PROMPT, 6), jb.submit([1, 2, 3], 6)
    jb.run_to_completion()
    solos = [jax_solo(params, config, PROMPT, 6),
             jax_solo(params, config, [1, 2, 3], 6)]
    assert solos == [torch_solo(params, config, PROMPT, 6),
                     torch_solo(params, config, [1, 2, 3], 6)]
    check_case(ranks, "two_requests", [jb.result(r1), jb.result(r2)], jb,
               solos)
    # each rank holds its shard of every weight and of the pool
    for rec in ranks:
        got = rec["two_requests"]
        assert got["param_shapes"]["layers.wq"] == (64, 32)
        assert got["param_shapes"]["layers.wk"] == (64, 16)
        assert got["param_shapes"]["layers.w_down"] == (64, 64)
        assert got["param_shapes"]["embed"] == (128, 64)
        assert got["param_shapes"]["lm_head"] == (64, 128)
        assert got["param_shapes"]["ln_f"] == (64,)
        assert got["pool_shape"] == (2, 16, 1, 4, 16)


def test_tp_int8_pool_matches_unsharded_solo(ranks, weights):
    params, config = weights["params"], cfg(kv_cache_dtype="int8")
    jb = jax_batcher(params, config, max_batch=2, n_pages=16, page_size=4,
                     max_pages_per_seq=4)
    r = jb.submit(PROMPT, 5)
    jb.run_to_completion()
    solos = [jax_solo(params, config, PROMPT, 5)]
    assert solos == [torch_solo(params, config, PROMPT, 5)]
    check_case(ranks, "int8_pool", [jb.result(r)], jb, solos)
    for rec in ranks:  # the scale planes are head-sharded too
        shapes = rec["int8_pool"]["pool_shapes"]
        assert shapes["k"] == (2, 16, 1, 4, 16)
        assert shapes["k_s"] == shapes["v_s"] == (2, 16, 1, 4, 1)


def test_tp_speculative_matches_unsharded_solo(ranks, weights):
    params, config = weights["params"], cfg()
    jb = jax_batcher(params, config, max_batch=2, n_pages=32, page_size=4,
                     max_pages_per_seq=6, draft_params=weights["draft_params"],
                     draft_config=cfg(n_layers=1), gamma=3)
    r = jb.submit(PROMPT, 6)
    jb.run_to_completion()
    solos = [jax_solo(params, config, PROMPT, 6)]
    check_case(ranks, "speculative", [jb.result(r)], jb, solos)
    for rec in ranks:
        assert rec["speculative"]["draft_pool_shape"] == (1, 32, 1, 4, 16)
        assert rec["speculative"]["draft_shapes"]["layers.wv"] == (64, 16)


def test_tp_prefix_cache_matches_unsharded_solo(ranks, weights):
    params, config = weights["params"], cfg()
    p1, p2 = PROMPT + [1, 2], PROMPT + [3]
    jb = jax_batcher(params, config, max_batch=2, n_pages=32, page_size=4,
                     max_pages_per_seq=8, prefix_cache=True)
    r1 = jb.submit(p1, 4)
    jb.run_to_completion()
    r2 = jb.submit(p2, 4)
    jb.run_to_completion()
    solos = [jax_solo(params, config, p1, 4), jax_solo(params, config, p2, 4)]
    check_case(ranks, "prefix", [jb.result(r1), jb.result(r2)], jb, solos)
    assert ranks[0]["prefix"]["host"]["prefix_stats"]["hits"] >= 1


def test_tp_requires_divisible_kv_heads(ranks, weights):
    config = dataclasses.replace(jax_t.TransformerConfig.tiny(),
                                 dtype=jnp.float32, n_kv_heads=1)
    params = jax_t.init_params(config, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="kv_heads") as err:
        jax_batcher(params, config, max_batch=2, n_pages=16, page_size=4,
                    max_pages_per_seq=4)
    for rec in ranks:
        assert rec["kv_heads_error"] == ("ValueError", str(err.value))


def test_snapshot_restores_across_topologies(ranks, weights):
    """JAX's case (a single-device snapshot resumes on tp=2) and its
    reverse (a tp=2 snapshot, its pool shards gathered, resumes on one
    device): both equal solo decode and JAX's resumed batcher."""
    params, config = weights["params"], cfg()
    geometry = dict(max_batch=2, n_pages=16, page_size=4, max_pages_per_seq=4)
    solos = [jax_solo(params, config, PROMPT, 6)]
    a = jax_serving.ContinuousBatcher(params, config, **geometry)
    r = a.submit(PROMPT, 6)
    for _ in range(2):
        a.step()
    b = jax_batcher(params, config, **geometry)
    b.load_state_dict(a.state_dict())
    b.run_to_completion()
    check_case(ranks, "snapshot_to_tp", [b.result(r)], b, solos)
    check_case(ranks, "snapshot_from_tp", [b.result(r)], b, solos)
    for rec in ranks:
        assert rec["snapshot_to_tp"]["kept_storage"]
    # the gathered tp pool is the single-device pool, every head of it
    pools = ranks[0]["snapshot_pools"]
    for name in ("k", "v"):
        assert pools["tp"][name].shape == pools["one"][name].shape
        np.testing.assert_allclose(pools["tp"][name], pools["one"][name],
                                   atol=1e-5, rtol=1e-5)


def test_tp_logprobs_and_sampling_match_jax(ranks, weights):
    params, config = weights["params"], cfg()
    jb = jax_batcher(params, config, max_batch=2, n_pages=16, page_size=4,
                     max_pages_per_seq=4)
    r1 = jb.submit(PROMPT, 6, sampling=jax_serving.SamplingParams(
        logprobs=True))
    r2 = jb.submit([1, 2, 3], 6, sampling=jax_serving.SamplingParams(
        temperature=0.8, top_k=50, seed=7, logprobs=True))
    jb.run_to_completion()
    got = ranks[0]["sampling"]
    assert got["results"] == [jb.result(r1), jb.result(r2)]
    assert got["host"] == host_state(jb)
    for lp, want in zip(got["logprobs"],
                        (jb.result_logprobs(r1), jb.result_logprobs(r2))):
        np.testing.assert_allclose(lp, want, atol=LOGPROB_TOL,
                                   rtol=LOGPROB_TOL)
    # host sampling reads the same all-gathered logits on every rank
    assert ranks[1]["sampling"]["results"] == got["results"]
    assert ranks[1]["sampling"]["logprobs"] == got["logprobs"]


def test_every_rank_streams_the_same(ranks, sp_ranks):
    """Every rank of each spawn gives rank 0's streams: the 7 tp cases, the
    LoRA and 3 MoE cases; the 4 sp=2 x tp=2 cases on all four ranks of the
    sp spawn, its sp=2 Ulysses case on the two ranks of that mesh."""
    def streams(rec):
        return {name: case["results"] for name, case in rec.items()
                if isinstance(case, dict) and "results" in case}

    assert len(streams(ranks[0])) == 11
    assert streams(ranks[0]) == streams(ranks[1])
    assert len(streams(sp_ranks[0])) == 5
    assert streams(sp_ranks[1]) == streams(sp_ranks[0])
    for rec in sp_ranks[2:]:
        assert streams(rec) == {k: v for k, v in streams(sp_ranks[0]).items()
                                if k != "ulysses"}


def test_lora_under_tp_matches_merged_solo(ranks, weights):
    """JAX's test_multilora_serving.py:254 at tp=2, every attention
    projection targeted: each adapter row equals solo decode on its merged
    params, the base row solo decode on the base, and the streams and host
    state equal JAX's tp batcher's (its bank replicated under GSPMD; the
    port's whole on each rank, wo's delta added to the partial sum)."""
    params, config = weights["params"], cfg()
    jb = jax_batcher(params, config, max_batch=3, n_pages=40, page_size=4,
                     max_pages_per_seq=8, adapters=weights["adapters"],
                     lora_scale=LORA_SCALE)
    rs = [jb.submit(PROMPT, 5, adapter=0), jb.submit([9, 8, 7], 5),
          jb.submit([1, 2, 3, 4, 5], 5, adapter=1)]
    jb.run_to_completion()

    def merged(i):
        return jax_lora.merge_lora(params, weights["adapters"][i], LORA_SCALE)

    solos = [jax_solo(merged(0), config, PROMPT, 5),
             jax_solo(params, config, [9, 8, 7], 5),
             jax_solo(merged(1), config, [1, 2, 3, 4, 5], 5)]
    assert solos[0] != jax_solo(params, config, PROMPT, 5)  # the delta bites
    check_case(ranks, "lora_tp", [jb.result(r) for r in rs], jb, solos)


MOE_CASES = {
    "moe_exact_tp": ({"tp": 2}, dict(moe_dropless=True, moe_group_size=1)),
    "moe_exact_ep": ({"ep": 2}, dict(moe_dropless=True, moe_group_size=1)),
    "moe_capacity_tp": ({"tp": 2}, dict(moe_capacity_factor=0.25)),
}


@pytest.mark.parametrize("name", tuple(MOE_CASES))
def test_moe_batcher_under_tp_and_ep(ranks, weights, name):
    """Mixture-of-Experts serving under a mesh: the streams and host state
    equal JAX's batcher on the same mesh; under dropless per-token routing
    (``moe_exact``) each request also equals its unsharded solo decode.
    Capacity routing couples a request to its batch-mates and padding
    (``models/serving.py``), so it is held to JAX's batcher alone. Each
    rank holds E/ep experts over d_ff/tp."""
    axes, extra = MOE_CASES[name]
    config = moe_cfg(**extra)
    params = weights["moe_params"]
    jb = jax_batcher(params, config, mesh=jax_mesh(axes), max_batch=4,
                     n_pages=40, page_size=4, max_pages_per_seq=8)
    rs = [jb.submit(p, 6) for p in MOE_PROMPTS]
    jb.run_to_completion()
    solos = ([jax_solo(params, config, p, 6) for p in MOE_PROMPTS]
             if config.moe_exact else None)
    check_case(ranks, name, [jb.result(r) for r in rs], jb, solos)
    ep, tp = axes.get("ep", 1), axes.get("tp", 1)
    E, D, F = config.n_experts, config.d_model, config.ff_dim
    for rec in ranks:
        shapes = {k: tuple(v) for k, v in rec[name]["moe_shapes"].items()}
        assert shapes == {"router": (D, E), "we_gate": (E // ep, D, F // tp),
                          "we_up": (E // ep, D, F // tp),
                          "we_down": (E // ep, F // tp, D)}


SP_TP = {"sp": 2, "tp": 2}


def test_sp_ring_admission_matches_unsharded_solo(sp_ranks, weights):
    """JAX's test_serving_mesh.py:153: the one-shot prefill rings the
    attention across sp=2 (each rank half the padded prompt), the K/V are
    gathered over sp into the tp-sharded pool, and the output equals
    unsharded solo decode and JAX's batcher on the same mesh."""
    params, config = weights["params"], cfg()
    geometry = dict(max_batch=2, n_pages=32, page_size=4, max_pages_per_seq=8)
    jb = jax_batcher(params, config, mesh=jax_mesh(SP_TP), **geometry)
    r = jb.submit(RING_PROMPT, 5)
    jb.run_to_completion()
    solos = [jax_solo(params, config, RING_PROMPT, 5)]
    assert solos == [torch_solo(params, config, RING_PROMPT, 5)]
    check_case(sp_ranks, "ring", [jb.result(r)], jb, solos)
    for rec in sp_ranks:
        assert rec["ring"]["mesh_key"] == jb._mesh_key == "sp=2,tp=2"
        # replicated over sp, head-sharded over tp
        assert tuple(rec["ring"]["pool_shape"]) == (2, 32, 1, 4, 16)


def test_sp_prefix_interleaved_and_speculative(sp_ranks, weights):
    """The paths JAX runs under an sp mesh: a prefix hit's windows and an
    interleaved admission's (both ignore sp, as JAX's window program does)
    after a ring admission, and a speculative draft prefilled over sp;
    streams equal JAX's batcher on the same mesh and solo decode."""
    params, config = weights["params"], cfg()
    geometry = dict(max_batch=2, n_pages=32, page_size=4, max_pages_per_seq=8)
    jb = jax_batcher(params, config, mesh=jax_mesh(SP_TP), prefix_cache=True,
                     **geometry)
    hit = RING_PROMPT[:17] + [3, 1]
    r1 = jb.submit(RING_PROMPT, 4)
    jb.run_to_completion()
    r2 = jb.submit(hit, 4)
    r3 = jb.submit(ULYSSES_PROMPT, 4, interleave_admission=8)
    jb.run_to_completion()
    solos = [jax_solo(params, config, p, 4)
             for p in (RING_PROMPT, hit, ULYSSES_PROMPT)]
    check_case(sp_ranks, "prefix_interleaved",
               [jb.result(r) for r in (r1, r2, r3)], jb, solos)
    assert sp_ranks[0]["prefix_interleaved"]["host"]["prefix_stats"][
        "hits"] == 1
    jb = jax_batcher(params, config, mesh=jax_mesh(SP_TP),
                     draft_params=weights["draft_params"],
                     draft_config=cfg(n_layers=1), gamma=3, **geometry)
    r = jb.submit(RING_PROMPT, 5)
    jb.run_to_completion()
    check_case(sp_ranks, "speculative", [jb.result(r)], jb,
               [jax_solo(params, config, RING_PROMPT, 5)])


def test_sp_int8_pool_and_chunked_admission(sp_ranks, weights):
    """The int8 pool under sp=2 x tp=2 (the K/V gathered over sp, then
    quantized into the pool) and a chunked admission beside it (windows
    that ignore sp): streams and host state equal JAX's batcher on the same
    mesh, and each request its unsharded int8 solo decode."""
    params, config = weights["params"], cfg(kv_cache_dtype="int8")
    geometry = dict(max_batch=2, n_pages=32, page_size=4, max_pages_per_seq=8)
    jb = jax_batcher(params, config, mesh=jax_mesh(SP_TP), **geometry)
    r1 = jb.submit(RING_PROMPT, 4)
    r2 = jb.submit(ULYSSES_PROMPT, 4, prefill_chunk=8)
    jb.run_to_completion()
    solos = [jax_solo(params, config, p, 4)
             for p in (RING_PROMPT, ULYSSES_PROMPT)]
    check_case(sp_ranks, "int8_chunked", [jb.result(r1), jb.result(r2)], jb,
               solos)


def test_sp_requires_divisible_page_size(sp_ranks, weights):
    """JAX's test_serving_mesh.py:172, word for word."""
    with pytest.raises(ValueError, match="page_size") as err:
        jax_batcher(weights["params"], cfg(),
                    mesh=jax_mesh({"sp": 2, "tp": 1}), max_batch=2,
                    n_pages=16, page_size=3, max_pages_per_seq=4)
    for rec in sp_ranks[:2]:
        assert rec["page_size_error"] == ("ValueError", str(err.value))


def test_ulysses_sp_admission_validated_and_matches_solo(sp_ranks, weights):
    """JAX's test_serving_mesh.py:183: Ulysses refuses kv_heads=2 at sp=4
    at construction, with JAX's words, and admits at sp=2 equal to solo
    decode and JAX's batcher."""
    params, config = weights["params"], cfg(sp_attention="ulysses")
    geometry = dict(max_batch=2, n_pages=32, page_size=4, max_pages_per_seq=8)
    with pytest.raises(ValueError, match="ulysses") as err:
        jax_batcher(params, config, mesh=jax_mesh({"sp": 4, "tp": 1}),
                    **geometry)
    for rec in sp_ranks:
        assert rec["ulysses_error"] == ("ValueError", str(err.value))
    jb = jax_batcher(params, config, mesh=jax_mesh({"sp": 2, "tp": 1}),
                     **geometry)
    r = jb.submit(ULYSSES_PROMPT, 4)
    jb.run_to_completion()
    check_case(sp_ranks, "ulysses", [jb.result(r)], jb,
               [jax_solo(params, config, ULYSSES_PROMPT, 4)])


def test_step_records_keyed_by_mesh_shape(ranks, weights):
    """A tp batcher's steps land under ``"tp=2"``, as JAX's do."""
    params, config = weights["params"], cfg()
    jb = jax_batcher(params, config, max_batch=2, n_pages=16, page_size=4,
                     max_pages_per_seq=4)
    monitor = JaxDeviceMonitor(metrics=JaxRegistry())
    monitor.attach(jb)
    jb.submit(PROMPT, 6)
    jb.submit([1, 2, 3], 6)
    jb.run_to_completion()
    want = monitor.snapshot()
    for rank, rec in enumerate(ranks):
        got = rec["two_requests"]
        assert got["mesh_key"] == jb._mesh_key == "tp=2"
        assert got["step_meshes"] == ["tp=2"]
        assert (set(got["device_steps"]["by_shape"])
                == set(want["steps"]["by_shape"]) == {"tp=2"})
        assert (got["device_steps"]["by_shape"]["tp=2"]["steps"]
                == want["steps"]["by_shape"]["tp=2"]["steps"])
        for key in ("axes", "shape", "n_devices", "platform"):
            assert got["device_mesh"][key] == want["mesh"][key], key
        assert got["device_mesh"]["coords"] == {"tp": rank}


def test_engine_admission_error_fails_the_rank_under_a_mesh(weights):
    """A single-device Engine fails the ticket of a submit that raises and
    goes on; under a mesh the rank raises instead (the other ranks are in
    that admission's collectives), and the launcher reports its error."""
    payload = {"params": jax.tree.map(np.asarray, weights["params"])}
    with pytest.raises(RuntimeError, match="rank 0 failed:(?s:.*)rank 0's "
                       "admission fails on purpose"):
        spawn(W.engine_admission_fails_on_rank0, 2, device_type="cpu",
              args=(payload,), timeout=120)


def test_unported_paths_refuse(ranks):
    """One batcher serves over tp, sp and ep: a dp axis inside it is
    refused (data-parallel serving is ``ReplicatedEngine.build(meshes=)``),
    and so are fsdp (a training axis) and pp (the pipeline trains,
    ``forward_pipelined``); replicas need a dp x tp mesh. Generation over
    dp, training under the tp mesh and a model over pp build
    (tests/test_torch_generate_mesh.py, tests/test_torch_train_mesh.py and
    tests/test_torch_pipeline_transformer.py hold them to JAX)."""
    expect = {
        "dp": ("NotImplementedError", "ReplicatedEngine.build(meshes=...)"),
        "fsdp": ("NotImplementedError", "Transformer.make_train_step"),
        "pp": ("NotImplementedError", "forward_pipelined"),
        "replicas_over_a_tp_mesh": ("ValueError", "dp and tp"),
    }
    for rec in ranks:
        assert set(rec["refusals"]) == set(expect)
        for what, err in rec["refusals"].items():
            assert err is not None, what
            assert err[0] == expect[what][0], (what, err)
            assert expect[what][1] in err[1], (what, err)
        assert rec["ported"] == {"train_step": True, "init": True,
                                 "lora_train_step": True, "pp_model": True}