"""Data-parallel serving replicas: the port's ``ReplicatedEngine`` against
the JAX package's, on the same submits.

The JAX engine places its replicas on the virtual devices of
``tests/conftest.py``; the port's are given ``devices=["cpu", "cpu"]``.
Checklist: the cases of the JAX package's tests/test_replicated.py, each
with ``replica_of`` per ticket, ``stats()`` and the streams equal to
JAX's and to solo decode. Two cases change: "live on distinct devices"
becomes "each replica's weights and pool lie on the device it was given",
and dp x tp (``meshes=``) is refused until it is ported."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bee_code_interpreter_tpu.models import replicated as jax_replicated
from bee_code_interpreter_tpu.models import transformer as jax_t
from bee_code_interpreter_tpu.models.text import TextEngine as JaxTextEngine
from bee_code_interpreter_tpu_torch.models import replicated as torch_replicated
from bee_code_interpreter_tpu_torch.models.text import TextEngine
from tests.torch_parity import tiny_configs, tiny_params

JCFG, TCFG = tiny_configs()
JPARAMS, TPARAMS = tiny_params(JCFG, TCFG)
DEVICES = ["cpu", "cpu"]


def solo(prompt, n):
    out = jax_t.Transformer(JCFG).generate_cached(
        JPARAMS, jnp.asarray(prompt, dtype=jnp.int32)[None, :],
        max_new_tokens=n,
    )
    return np.asarray(out[0, len(prompt):]).tolist()


def build(n_replicas=2, **kw):
    """(JAX engine, port engine) with the same geometry."""
    kw.setdefault("max_batch", 2)
    kw.setdefault("n_pages", 24)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_pages_per_seq", 6)
    return (
        jax_replicated.ReplicatedEngine.build(JPARAMS, JCFG, n_replicas, **kw),
        torch_replicated.ReplicatedEngine.build(
            TPARAMS, TCFG, n_replicas, devices=DEVICES[:n_replicas], **kw),
    )


def test_replicas_spread_load_and_stay_solo_equal():
    engines = build(2)
    prompts = [
        [int(x) for x in np.random.default_rng(i).integers(0, 200, 4 + i)]
        for i in range(6)
    ]
    got = []
    for eng in engines:
        tickets = [eng.submit(p, 4) for p in prompts]
        eng.run_to_completion()
        got.append({
            "replicas": [eng.replica_of(t) for t in tickets],
            "results": [eng.result(t) for t in tickets],
            "finish": [eng.finish_reason(t) for t in tickets],
            "stats": eng.stats,
        })
    assert got[1] == got[0]
    assert set(got[1]["replicas"]) == {0, 1}
    assert got[1]["results"] == [solo(p, 4) for p in prompts]
    assert got[1]["finish"] == ["length"] * 6
    st = got[1]["stats"]
    assert st["replicas"] == 2 and st["active_rows"] == 0


def test_replicas_live_on_the_devices_given():
    """Each replica's weights and pool lie on its device; replicas on one
    device share the weights' tensors and hold pools of their own."""
    _, eng = build(2)
    for engine, device in zip(eng.engines, DEVICES):
        batcher = engine.batcher
        assert batcher.device == torch.device(device)
        assert batcher.cache["k"].device == torch.device(device)
        assert batcher.params["layers"][0]["wq"].device == torch.device(device)
    a, b = (e.batcher for e in eng.engines)
    assert a.params["embed"] is b.params["embed"] is TPARAMS["embed"]
    assert a.cache["k"].data_ptr() != b.cache["k"].data_ptr()


def test_dp_times_tp_replicas_not_ported_yet():
    with pytest.raises(NotImplementedError, match="dp x tp"):
        torch_replicated.ReplicatedEngine.build(
            TPARAMS, TCFG, 2, meshes=[object(), object()], max_batch=2,
            n_pages=24, page_size=4, max_pages_per_seq=6)


def test_prefix_affinity_routes_repeats_to_same_replica():
    prompt = [7] * 9  # > 2 pages: a cacheable full-page prefix
    got = []
    for eng in build(2, prefix_affinity=True, prefix_cache=True):
        t1 = eng.submit(prompt, 3)
        eng.run_to_completion()
        t2 = eng.submit(prompt, 3)
        eng.run_to_completion()
        assert eng.replica_of(t1) == eng.replica_of(t2)
        hits = eng.engines[eng.replica_of(t2)].batcher.prefix_stats["hits"]
        assert hits >= 1  # the repeat reused pages
        got.append((eng.replica_of(t1), eng.result(t1), eng.result(t2),
                    eng.stats))
    assert got[1] == got[0]
    assert got[1][1] == got[1][2] == solo(prompt, 3)


def test_affinity_yields_to_load():
    got = []
    for eng in build(2, prefix_affinity=True, affinity_slack=0,
                     prefix_cache=True):
        prompt = np.asarray([7] * 9, dtype=np.int32)
        preferred = eng._route(prompt)
        # saturate the preferred replica's queue beyond the slack
        for _ in range(4):
            eng.engines[preferred].submit([1, 2, 3], 3)
        routed = eng._route(prompt)
        assert routed != preferred
        eng.run_to_completion()
        got.append((preferred, routed, eng.stats))
    assert got[1] == got[0]


def test_streaming_and_cancel_pass_through():
    got = []
    for eng in build(2):
        t = eng.submit([5, 3, 7, 2], 6)
        seen: list[int] = []
        for _ in range(60):
            eng.step()
            seen += eng.new_tokens(t)
            if eng.is_done(t):
                break
        seen += eng.new_tokens(t)
        assert seen == eng.result(t)
        t2 = eng.submit([1, 2, 3], 15)
        eng.step()
        eng.cancel(t2)
        eng.run_to_completion()
        assert eng.finish_reason(t2) == "cancelled"
        partial = eng.result(t2)
        eng.release(t2)
        with pytest.raises(KeyError):
            eng.result(t2)
        got.append((seen, partial, eng.replica_of(t), eng.stats))
    assert got[1] == got[0]
    assert got[1][0] == solo([5, 3, 7, 2], 6)


def test_build_validates_replica_count():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default devices exist")
    # the default devices are cards: none here, so none are taken
    with pytest.raises(ValueError, match="devices"):
        torch_replicated.ReplicatedEngine.build(TPARAMS, TCFG, 2)
    with pytest.raises(ValueError, match="devices"):
        jax_replicated.ReplicatedEngine.build(JPARAMS, JCFG, 99)
    with pytest.raises(ValueError, match="3 devices for 2 replicas"):
        torch_replicated.ReplicatedEngine.build(TPARAMS, TCFG, 2,
                                                devices=["cpu"] * 3)
    for cls in (jax_replicated.ReplicatedEngine,
                torch_replicated.ReplicatedEngine):
        with pytest.raises(ValueError, match="at least one"):
            cls([])


def test_full_queue_falls_back_to_other_replica():
    got = []
    for eng in build(2, max_queue=1):
        t1 = eng.submit([1, 2, 3], 3)
        t2 = eng.submit([1, 2, 3], 3)  # first replica full: falls back
        assert eng.replica_of(t1) != eng.replica_of(t2)
        with pytest.raises(RuntimeError, match="every replica"):
            eng.submit([1, 2, 3], 3)  # now every queue is full
        eng.run_to_completion()
        got.append(([eng.replica_of(t1), eng.replica_of(t2)],
                    [eng.result(t1), eng.result(t2)], eng.stats))
    assert got[1] == got[0]
    assert got[1][1] == [solo([1, 2, 3], 3)] * 2


def test_stats_distinguish_monotonic_from_live():
    got = []
    for eng in build(2):
        t1 = eng.submit([1, 2, 3], 3)
        t2 = eng.submit([4, 5, 6], 3)
        eng.run_to_completion()
        eng.release(t1)
        st = eng.stats
        assert st["requests_submitted"] == 2  # monotonic
        assert st["live_tickets"] == 1  # t2 still held
        got.append((st, eng.result(t2)))
    assert got[1] == got[0]
    assert got[1][1] == solo([4, 5, 6], 3)


class CharTokenizer:
    def encode(self, text):
        return [ord(ch) % JCFG.vocab_size for ch in text]

    def decode(self, tokens):
        return "".join(chr(32 + (t % 94)) for t in tokens)


def test_text_engine_composes_over_replicas():
    """TextEngine consumes the Engine surface only: a ReplicatedEngine
    drops in unchanged."""
    jax_eng, torch_eng = build(2)
    got = []
    for te in (JaxTextEngine(jax_eng, CharTokenizer()),
               TextEngine(torch_eng, CharTokenizer())):
        t1 = te.submit("hello world", 6)
        t2 = te.submit("other prompt", 6)
        te.run_to_completion()
        got.append((te.text(t1), te.text(t2), te.finish_reason(t1),
                    te.finish_reason(t2)))
    assert got[1] == got[0]
    tok = CharTokenizer()
    assert got[1][0] == tok.decode(solo(tok.encode("hello world"), 6))
    assert got[1][2:] == ("length", "length")
