"""Tensor-parallel serving: the port's ``ContinuousBatcher(mesh=...)``
against the JAX package's.

Two ranks (gloo on the CPU, one spawn for the file) each build the same
batcher over ``make_mesh({"tp": 2}, device_type="cpu")`` and run every
scenario of ``tests/torch_tp_worker.py::serving_cases``; the JAX batchers
run here over a tp mesh of two of the 8 virtual devices. Checklist: every
tp case of the JAX package's tests/test_serving_mesh.py (:43 two requests,
:63 the int8 pool, :77 speculative, :93 prefix cache, :113 kv_heads,
:125 the snapshot across topologies, here in both directions), each held
to JAX's tp batcher and to unsharded solo decode token for token, with
the host bookkeeping equal to JAX's; a logprobs and a seeded sampled
request; the step records keyed ``"tp=2"``; every rank's streams the
same; and the paths not ported under a mesh refusing."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from bee_code_interpreter_tpu.models import serving as jax_serving
from bee_code_interpreter_tpu.models import transformer as jax_t
from bee_code_interpreter_tpu.observability.device import (
    DeviceMonitor as JaxDeviceMonitor,
)
from bee_code_interpreter_tpu.utils.metrics import Registry as JaxRegistry
from bee_code_interpreter_tpu_torch.models import transformer as torch_t
from bee_code_interpreter_tpu_torch.parallel import spawn
from bee_code_interpreter_tpu_torch.weights import params_from_jax
from tests import torch_tp_worker as W
from tests.torch_parity import host_state

PROMPT = W.PROMPT
LOGPROB_TOL = 1e-5


def cfg(**kw):
    return dataclasses.replace(jax_t.TransformerConfig.tiny(),
                               dtype=jnp.float32, n_kv_heads=2, **kw)


def tp_mesh() -> Mesh:
    return Mesh(np.array(jax.devices()[:2]), ("tp",))


@pytest.fixture(scope="module")
def weights():
    return {
        "params": jax_t.init_params(cfg(), jax.random.PRNGKey(0)),
        "draft_params": jax_t.init_params(cfg(n_layers=1),
                                          jax.random.PRNGKey(1)),
    }


@pytest.fixture(scope="module")
def ranks(weights):
    """Both ranks' records of every scenario (one spawn)."""
    payload = {k: jax.tree.map(np.asarray, v) for k, v in weights.items()}
    return spawn(W.serving_cases, 2, device_type="cpu", args=(payload,),
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


def jax_batcher(params, config, **kw):
    return jax_serving.ContinuousBatcher(params, config, mesh=tp_mesh(), **kw)


def check_case(ranks, name, results, jb, solos):
    """Rank 0's streams equal the JAX tp batcher's and the solo decodes;
    its host state equals the JAX batcher's; rank 1 equals rank 0."""
    got = ranks[0][name]
    assert got["results"] == results
    assert got["results"] == solos
    assert got["host"] == host_state(jb)
    assert ranks[1][name]["results"] == got["results"]
    assert ranks[1][name]["host"] == got["host"]


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


def test_every_rank_streams_the_same(ranks):
    streams = [{name: case["results"] for name, case in rec.items()
                if isinstance(case, dict) and "results" in case}
               for rec in ranks]
    assert len(streams[0]) == 7
    assert streams[0] == streams[1]


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


def test_unported_paths_refuse(ranks):
    """JAX serves these under a mesh through GSPMD; the port refuses them
    until they are ported (ROADMAP Queue 1, item 4)."""
    for rec in ranks:
        for what, err in rec["refusals"].items():
            assert err is not None, what
            assert err[0] == "NotImplementedError", (what, err)
            assert "ROADMAP Queue 1, item 4" in err[1], what
