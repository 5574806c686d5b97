"""The port's serving stack against the JAX package's, on the same weights
(tiny config, 2 KV heads, f32): ContinuousBatcher and Engine streams token
for token, seeded sampling, stop sequences, eos, cancel, and the TextEngine.

Greedy equality across two frameworks needs prompts without near-ties: the
greedy test asserts a top-2 logit margin above 1e-3 at every generated
position (the logits agree to ~1e-5, so no argmax can flip)."""

import dataclasses

import numpy as np
import pytest
import torch

from bee_code_interpreter_tpu.models import engine as jax_engine
from bee_code_interpreter_tpu.models import serving as jax_serving
from bee_code_interpreter_tpu.models import text as jax_text
from bee_code_interpreter_tpu_torch.models import engine as torch_engine
from bee_code_interpreter_tpu_torch.models import serving as torch_serving
from bee_code_interpreter_tpu_torch.models import text as torch_text
from bee_code_interpreter_tpu_torch.models import transformer as torch_t

from tests.torch_parity import tiny_configs, tiny_params

PROMPTS = [[5, 3, 7, 2, 9, 4, 1, 8], [3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5, 8, 9, 7]]
NEW = 8
GEOMETRY = dict(max_batch=2, n_pages=24, page_size=4, max_pages_per_seq=8)
MARGIN = 1e-3


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = tiny_configs(paged_attention_kernel=True)
    jparams, tparams = tiny_params(jcfg, tcfg)
    return jcfg, tcfg, jparams, tparams


def batchers(models, **kw):
    jcfg, tcfg, jparams, tparams = models
    return (
        jax_serving.ContinuousBatcher(jparams, jcfg, **GEOMETRY, **kw),
        torch_serving.ContinuousBatcher(tparams, tcfg, **GEOMETRY, **kw,
                                        device="cpu"),
    )


def sampling_pair(**kw):
    return (jax_serving.SamplingParams(**kw),
            torch_serving.SamplingParams(**kw))


def assert_no_near_ties(models, prompt, generated):
    """Teacher-forced logits of prompt + generated: the top-2 margin at
    every position that chose a generated token is above MARGIN."""
    _, tcfg, _, tparams = models
    seq = torch.tensor([prompt + generated[:-1]])
    logits = torch_t.forward(tparams, seq, tcfg)[0, len(prompt) - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    assert (top2[:, 0] - top2[:, 1]).min().item() > MARGIN
    assert logits.argmax(-1).tolist() == generated


def test_batcher_greedy_streams_match_jax(models):
    """3 requests on 2 rows: the third admits when the first retires, so
    rows and pages recycle."""
    results = []
    for b in batchers(models):
        budgets = [NEW, NEW - 3, NEW]
        reqs = [b.submit(p, n) for p, n in zip(PROMPTS[:2], budgets)]
        with pytest.raises(Exception, match="no free batch row"):
            b.submit(PROMPTS[2], NEW)
        while b.active.all():
            b.step()
        reqs.append(b.submit(PROMPTS[2], budgets[2]))
        b.run_to_completion()
        results.append(([b.result(r) for r in reqs],
                        [b.finish_reason(r) for r in reqs],
                        b.stats["free_pages"]))
    assert results[1] == results[0]
    for prompt, out in zip(PROMPTS, results[1][0]):
        assert_no_near_ties(models, prompt, out)


def test_engine_greedy_and_streaming_match_jax(models):
    streams = []
    for b, eng_mod in zip(batchers(models), (jax_engine, torch_engine)):
        eng = eng_mod.Engine(b)
        tickets = [eng.submit(p, NEW) for p in PROMPTS]
        chunks = {t: [] for t in tickets}
        while eng.pending or b.busy:
            eng.step()
            for t in tickets:
                chunks[t].extend(eng.new_tokens(t))
        streams.append(([eng.result(t) for t in tickets],
                        [chunks[t] for t in tickets], eng.stats["queued"]))
    assert streams[1] == streams[0]
    assert streams[1][0] == streams[1][1]  # the stream concatenates to result


def test_seeded_sampling_and_logprobs_match_jax(models):
    kinds = [
        dict(temperature=0.9, top_k=20, seed=7, logprobs=True),
        dict(temperature=1.0, top_p=0.9, seed=8, logprobs=True),
    ]
    outs = []
    for i, b in enumerate(batchers(models)):
        reqs = [b.submit(p, NEW, sampling=sampling_pair(**kw)[i])
                for p, kw in zip(PROMPTS, kinds)]
        b.run_to_completion()
        outs.append(([b.result(r) for r in reqs],
                     [b.result_logprobs(r) for r in reqs]))
    assert outs[1][0] == outs[0][0]
    np.testing.assert_allclose(np.asarray(outs[1][1]), np.asarray(outs[0][1]),
                               atol=1e-4)


def test_stops_eos_and_cancel_match_jax(models):
    # the greedy stream of PROMPTS[0] picks the eos id and the stop sequence
    _, b = batchers(models)
    r = b.submit(PROMPTS[0], NEW)
    b.run_to_completion()
    greedy = b.result(r)
    eos, stop = greedy[3], tuple(greedy[1:3])
    outs = []
    for b, sp in zip(batchers(models, eos_id=eos),
                     sampling_pair(stop_sequences=(stop,))):
        r_eos = b.submit(PROMPTS[0], NEW)
        r_stop = b.submit(PROMPTS[0], NEW, sampling=sp)
        b.run_to_completion()
        r_cancel = b.submit(PROMPTS[1], NEW)
        b.step()
        b.cancel(r_cancel)
        b.cancel(r_cancel)  # racing completion: a no-op
        outs.append([(b.result(x), b.finish_reason(x))
                     for x in (r_eos, r_stop, r_cancel)])
        with pytest.raises(KeyError):
            b.cancel(99)
    assert outs[1] == outs[0]
    assert [reason for _, reason in outs[1]] == ["eos", "stop", "cancelled"]
    assert outs[1][0][0] == greedy[:4] and outs[1][1][0] == greedy[:1]


class ByteTokenizer:
    """Hermetic UTF-8 byte tokenizer: vocab 256, the tiny config's."""

    def encode(self, text):
        return list(text.encode("utf-8"))

    def decode(self, tokens):
        return bytes(tokens).decode("utf-8", errors="replace")


def test_text_engine_matches_jax(models):
    texts = []
    for b, eng_mod, text_mod in zip(batchers(models), (jax_engine, torch_engine),
                                    (jax_text, torch_text)):
        te = text_mod.TextEngine(eng_mod.Engine(b), ByteTokenizer())
        plain = te.submit("hello", NEW)
        te.run_to_completion()
        full = te.text(plain)
        stop = full[2:4] if len(full) >= 4 else full[-1:]
        t1 = te.submit("hello", NEW, stop=(stop,))
        t2 = te.submit("abc", NEW)
        streamed = ""
        while not (te.is_done(t1) and te.is_done(t2)):
            te.step()
            streamed += te.new_text(t2)
        streamed += te.new_text(t2)
        texts.append((full, te.text(t1), te.finish_reason(t1), te.text(t2),
                      te.finish_reason(t2), streamed))
    assert texts[1] == texts[0]
    assert texts[1][5] == texts[1][3]


def test_engine_queue_priorities_and_cancel(models):
    _, b = batchers(models)
    eng = torch_engine.Engine(b, max_queue=3)
    low = eng.submit(PROMPTS[0], 4)
    high = eng.submit(PROMPTS[1], 4, priority=5)
    gone = eng.submit(PROMPTS[2], 4)
    with pytest.raises(RuntimeError, match="queue full"):
        eng.submit(PROMPTS[2], 4)
    eng.cancel(gone)
    eng.step()  # admits high first, then low (two rows)
    assert b.row_request.tolist() == [0, 1]
    assert eng._state[high] == 0 and eng._state[low] == 1
    eng.run_to_completion()
    assert eng.finish_reason(gone) == "cancelled" and eng.result(gone) == []
    assert len(eng.result(low)) == 4 and eng.is_done(high)


def test_unported_features_raise(models):
    """What earlier slices refused and no longer do: an MoE batcher under a
    mesh, training under a mesh (held to JAX in
    tests/test_torch_train_mesh.py; serving under meshes in
    tests/test_torch_serving_mesh.py), the int8 pool, the prefix cache,
    chunked and interleaved admission, preemption, adapters, a draft
    model, snapshots and the metrics and monitor hooks."""
    from bee_code_interpreter_tpu_torch.observability import ServingMonitor
    from bee_code_interpreter_tpu_torch.utils.metrics import Registry
    from tests.torch_tp_worker import single_rank_mesh

    _, tcfg, _, tparams = models
    moe_cfg = dataclasses.replace(tcfg, n_experts=4)
    moe_params = torch_t.init_params(moe_cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    with single_rank_mesh({"ep": 1, "tp": 1}) as mesh:
        torch_serving.ContinuousBatcher(moe_params, moe_cfg, mesh=mesh)
        assert callable(torch_t.Transformer(moe_cfg, mesh).make_train_step())
    registry = Registry()
    monitor = ServingMonitor(metrics=registry)
    hooked = torch_serving.ContinuousBatcher(
        tparams, tcfg, device="cpu", metrics=registry, monitor=monitor,
    )
    assert hooked._metrics is registry and hooked._monitor is monitor
    hooked_engine = torch_engine.Engine(hooked, metrics=registry)
    assert hooked_engine._monitor is monitor  # inherited from the batcher
    assert "bci_serving_queue_depth" in registry.metrics
    torch_serving.ContinuousBatcher(
        tparams, dataclasses.replace(tcfg, kv_cache_dtype="int8"),
        device="cpu", prefix_cache=True,
    )
    torch_serving.ContinuousBatcher(tparams, tcfg, device="cpu",
                                    draft_params=tparams, draft_config=tcfg)
    _, b = batchers(models)
    with pytest.raises(ValueError, match="no adapters configured"):
        b.submit(PROMPTS[0], 2, adapter=0)
    assert b.prefix_credit(PROMPTS[0], adapter=0) == 0  # the cache is off
    eng = torch_engine.Engine(b)
    eng.load_state_dict(eng.state_dict())
    b.load_state_dict(b.state_dict())
    assert b.preempt(0) is False  # no such interleaved admission
    torch_engine.Engine(b, metrics=Registry(), monitor=monitor)


def test_validation_matches_jax(models):
    jb, tb = batchers(models)
    for args in (([], 4), ([1, 2], 0), (list(range(30)), 3)):
        for b in (jb, tb):
            with pytest.raises(ValueError):
                b.validate_request(*args)
    assert jb.validate_request([1] * 9, 5) == tb.validate_request([1] * 9, 5)
    jt, tt = jb.kv_telemetry(), tb.kv_telemetry()
    assert {k: jt[k] for k in tt} == tt
