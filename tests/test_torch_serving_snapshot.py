"""The port's serving snapshots (``ContinuousBatcher`` and ``Engine``
``state_dict`` / ``load_state_dict``) against the JAX package's, on the same
weights (tiny config, 2 KV heads, f32): a run snapshotted mid-decode,
pickled and resumed on a fresh batcher gives the uninterrupted run's tokens
and logprobs, and JAX's; host bookkeeping equals JAX's after the restore;
the geometry check raises JAX's errors, word for word; the pools are copied
into the receiving batcher's own tensors (their storage stays). Checklist:
the JAX package's tests/test_serving.py:580-685 and test_engine.py:301."""

import dataclasses
import pickle

import jax
import numpy as np
import pytest
import torch

from bee_code_interpreter_tpu.models import engine as jax_engine
from bee_code_interpreter_tpu.models import lora as jax_lora
from bee_code_interpreter_tpu.models import serving as jax_serving
from bee_code_interpreter_tpu_torch.models import engine as torch_engine
from bee_code_interpreter_tpu_torch.models import serving as torch_serving

from tests.torch_parity import host_state, lora_to_torch, tiny_configs, tiny_params

GEOMETRY = dict(max_batch=2, n_pages=24, page_size=4, max_pages_per_seq=6)
PROMPTS = [[5, 3, 7, 2, 9, 4, 1, 8], [1, 2, 3], [4, 4, 2, 6]]
MODS = (jax_serving, torch_serving)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = tiny_configs()
    return (jcfg, tcfg, *tiny_params(jcfg, tcfg))


def make(models, framework, **kw):
    jcfg, tcfg, jparams, tparams = models
    kw = {**GEOMETRY, **kw}
    if framework == 0:
        return jax_serving.ContinuousBatcher(jparams, jcfg, **kw)
    return torch_serving.ContinuousBatcher(tparams, tcfg, device="cpu", **kw)


def sampled(mod):
    return mod.SamplingParams(temperature=0.8, top_k=40, seed=7, logprobs=True)


def script(models, framework, interrupt: bool, **kw):
    """Two requests, 3 steps, then (optionally) a pickled snapshot restored
    into a fresh batcher, the rest of the run, and one request admitted
    after the restore."""
    mod = MODS[framework]
    b = make(models, framework, **kw)
    r0 = b.submit(PROMPTS[0], 6, sampling=sampled(mod))
    r1 = b.submit(PROMPTS[1], 6)
    for _ in range(3):
        b.step()
    restored = None
    if interrupt:
        blob = pickle.dumps(b.state_dict())
        b = make(models, framework, **kw)
        b.load_state_dict(pickle.loads(blob))
        restored = host_state(b)
    b.run_to_completion()
    r2 = b.submit(PROMPTS[2], 5)
    b.run_to_completion()
    return {
        "tokens": [b.result(r) for r in (r0, r1, r2)],
        "logprobs": b.result_logprobs(r0),
        "finish": [b.finish_reason(r) for r in (r0, r1, r2)],
        "state": host_state(b),
        "restored": restored,
    }


def test_snapshot_resume_matches_uninterrupted_and_jax(models):
    runs = {(f, i): script(models, f, i) for f in (0, 1) for i in (False, True)}
    port, port_ref, jax_run = runs[1, True], runs[1, False], runs[0, True]
    assert port["tokens"] == port_ref["tokens"] == jax_run["tokens"]
    assert port["logprobs"] == port_ref["logprobs"]  # bitwise
    np.testing.assert_allclose(port["logprobs"], jax_run["logprobs"], atol=1e-4)
    assert port["finish"] == jax_run["finish"]
    assert port["restored"] == jax_run["restored"]
    assert port["state"] == port_ref["state"] == jax_run["state"]


def test_load_copies_into_the_pool_tensors(models):
    a = make(models, 1)
    a.submit(PROMPTS[0], 6)
    a.step()
    snap = a.state_dict()
    b = make(models, 1)
    ptrs = {k: x.data_ptr() for k, x in b.cache.items()}
    b.load_state_dict(snap)
    assert {k: x.data_ptr() for k, x in b.cache.items()} == ptrs
    for k, x in b.cache.items():
        assert torch.equal(x, a.cache[k])
    # the snapshot owns its bytes: CPU tensors that share nothing
    for k, x in snap["device"]["cache"].items():
        assert x.device.type == "cpu" and x.data_ptr() != a.cache[k].data_ptr()


def test_snapshot_while_serving_continues_is_stable(models):
    a = make(models, 1)
    r = a.submit([5, 3, 7, 2, 9], 6)
    for _ in range(2):
        a.step()
    snap = a.state_dict()
    frozen = {k: v.clone() for k, v in snap["device"]["cache"].items()}
    a.run_to_completion()
    want = a.result(r)
    for k in frozen:
        assert torch.equal(frozen[k], snap["device"]["cache"][k])
    b = make(models, 1)
    b.load_state_dict(snap)
    b.run_to_completion()
    assert b.result(r) == want


def test_geometry_errors_match_jax(models):
    """Shapes and behaviour: each mismatch raises JAX's text (the configs
    print differently, so for them only the key is compared)."""
    mismatches = [dict(n_pages=32), dict(eos_id=2), dict(prefix_cache=True),
                  dict(max_batch=3), dict(page_size=2), dict(lora_scale=2.0)]
    msgs = []
    for f in (0, 1):
        snap = make(models, f).state_dict()
        for kw in mismatches:
            with pytest.raises(ValueError, match="geometry mismatch") as err:
                make(models, f, **kw).load_state_dict(snap)
            msgs.append(str(err.value))
        cfg = dataclasses.replace(models[f], kv_cache_dtype="int8")
        other = make((cfg, cfg, models[2], models[3]), f)
        with pytest.raises(ValueError, match="mismatch on 'config'"):
            other.load_state_dict(snap)
        skewed = {**snap, "meta": {**snap["meta"], "extra": 1}}
        with pytest.raises(ValueError, match="version skew") as err:
            make(models, f).load_state_dict(skewed)
        msgs.append(str(err.value))
    half = len(msgs) // 2
    assert msgs[:half] == msgs[half:]


def test_speculative_and_adapter_snapshot_matches_jax(models):
    """Snapshots carry the draft pool and the rows' adapters: the resumed
    run equals the uninterrupted one and JAX's, and the draft pool keeps its
    storage."""
    jcfg, tcfg, jparams, _ = models
    djcfg, dtcfg = tiny_configs(n_layers=1)
    djp, dtp = tiny_params(djcfg, dtcfg, seed=2)
    lora = jax_lora.init_lora(jcfg, jax.random.PRNGKey(1), rank=4)
    jad = [{t: {"A": ab["A"],
                "B": jax.random.normal(jax.random.PRNGKey(2), ab["B"].shape)
                * 0.25}
            for t, ab in lora.items()}]
    kws = ({"draft_params": djp, "draft_config": djcfg, "adapters": jad},
           {"draft_params": dtp, "draft_config": dtcfg,
            "adapters": [lora_to_torch(a) for a in jad]})

    def run(f, interrupt):
        kw = dict(kws[f], gamma=3, lora_scale=2.0, max_pages_per_seq=8,
                  n_pages=32)
        b = make(models, f, **kw)
        r0 = b.submit(PROMPTS[0], 8, adapter=0)
        r1 = b.submit(PROMPTS[1], 8, sampling=MODS[f].SamplingParams(
            temperature=0.9, seed=3))
        b.step()
        if interrupt:
            snap = pickle.loads(pickle.dumps(b.state_dict()))
            b = make(models, f, **kw)
            ptrs = [x.data_ptr() for x in b.draft_cache.values()] if f else None
            b.load_state_dict(snap)
            if f:
                assert [x.data_ptr() for x in b.draft_cache.values()] == ptrs
        b.run_to_completion()
        return [b.result(r) for r in (r0, r1)], host_state(b)

    port = run(1, True)
    assert port == run(1, False) == run(0, True)


def test_interleaved_admission_resumes_mid_prefill(models):
    def run(f, interrupt):
        b = make(models, f, n_pages=32, max_pages_per_seq=8)
        r0 = b.submit(PROMPTS[1], 6)
        r1 = b.submit(PROMPTS[0] * 2, 4, interleave_admission=4)
        b.step()
        if interrupt:
            assert b.prefill_state  # the snapshot lands mid-admission
            snap = pickle.loads(pickle.dumps(b.state_dict()))
            b = make(models, f, n_pages=32, max_pages_per_seq=8)
            b.load_state_dict(snap)
        b.run_to_completion()
        return [b.result(r) for r in (r0, r1)], host_state(b)

    assert run(1, True) == run(1, False) == run(0, True)


def test_engine_snapshot_resume_with_queued_requests_matches_jax(models):
    """Requests in flight and still queued (one under a priority): the
    fresh engine admits the queue in its order, ticket ids keep counting,
    and every output equals the uninterrupted run's and JAX's."""
    def run(f, interrupt):
        engine_mod = (jax_engine, torch_engine)[f]
        eng = engine_mod.Engine(make(models, f, max_batch=1))
        t0 = eng.submit(PROMPTS[0], 4)
        t1 = eng.submit([1, 2, 3], 4)
        t2 = eng.submit([4, 5, 6], 4, priority=5)
        for _ in range(2):
            eng.step()
        if interrupt:
            snap = pickle.dumps(eng.state_dict())
            eng = engine_mod.Engine(make(models, f, max_batch=1))
            eng.load_state_dict(pickle.loads(snap))
            t3 = eng.submit([9, 9], 3)
            assert t3 > t2
        eng.run_to_completion()
        return ({t: eng.result(t) for t in (t0, t1, t2)},
                host_state(eng.batcher))

    port = run(1, True)
    assert port[0] == run(1, False)[0]
    assert port == run(0, True)
