"""Data-parallel serving replicas: the port's ``ReplicatedEngine`` against
the JAX package's, on the same submits.

The JAX engine places its replicas on the virtual devices of
``tests/conftest.py``; the port's are given ``devices=["cpu", "cpu"]``.
Checklist: the cases of the JAX package's tests/test_replicated.py, each
with ``replica_of`` per ticket, ``stats()`` and the streams equal to
JAX's and to solo decode. One case changes: "live on distinct devices"
becomes "each replica's weights and pool lie on the device it was given".

dp x tp (``meshes=``): four gloo CPU ranks as 2 replicas x tp=2 (one
spawn, ``tests/torch_tp_worker.py::replicated_cases``), rank 0 the front
end, against JAX's ``ReplicatedEngine`` over two tp=2 sub-meshes of the
virtual devices on the same calls: every ticket's tokens (and JAX's solo
decode), ``replica_of``, finish reasons, logprobs and ``stats``."""

import dataclasses
import types

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
from bee_code_interpreter_tpu_torch.parallel import mesh as M
from jax.sharding import Mesh
from tests import torch_tp_worker as W
from tests.torch_parity import tiny_configs, tiny_params

JCFG, TCFG = tiny_configs()
JPARAMS, TPARAMS = tiny_params(JCFG, TCFG)
DEVICES = ["cpu", "cpu"]
LOGPROB_TOL = 1e-5


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


@pytest.fixture(scope="module")
def mesh_ranks():
    """Every rank's records of the 2 replicas x tp=2 spawn."""
    return M.spawn(W.replicated_cases, 4, device_type="cpu",
                   args=({"params": jax.tree.map(np.asarray, JPARAMS)},),
                   timeout=600)


@pytest.fixture(scope="module")
def jax_mesh_records():
    """The same scenarios on JAX's dp x tp ReplicatedEngine."""
    devices = jax.devices()
    meshes = [Mesh(np.array(devices[0:2]), ("tp",)),
              Mesh(np.array(devices[2:4]), ("tp",))]

    class Front:
        """JAX's engine with the port front end's context manager."""

        def __init__(self, eng):
            self.eng, self.is_front_end = eng, True
            self.rounds = types.SimpleNamespace(exchange_ms=[])

        def __getattr__(self, name):
            return getattr(self.eng, name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            pass

    def build(**kw):
        return Front(jax_replicated.ReplicatedEngine.build(
            JPARAMS, JCFG, 2, meshes=meshes, **{**W.REPLICA_GEOMETRY, **kw}))

    return W._replicated_scenarios(build)


def without_exchanges(rec):
    return {k: v for k, v in rec.items() if k != "exchanges"}


def test_dp_times_tp_replicas(mesh_ranks, jax_mesh_records):
    """JAX's test_dp_times_tp_replicas: two tp=2 replicas over four ranks
    give the solo stream of each ticket, on the replicas JAX's engine
    picks."""
    got = mesh_ranks[0]["dp_times_tp"]
    assert without_exchanges(got) == without_exchanges(
        jax_mesh_records["dp_times_tp"])
    assert got["results"] == [solo([5, 3, 7, 2, 9, 4, 1, 8], 5),
                              solo([1, 2, 3], 5)]
    assert got["exchanges"] > 0


@pytest.mark.parametrize("scenario", ["spread", "affinity",
                                      "streaming_and_cancel", "full_queue",
                                      "logprobs"])
def test_dp_times_tp_front_end_matches_jax(mesh_ranks, jax_mesh_records,
                                           scenario):
    """Each of JAX's replicated scenarios through rank 0's front end:
    routing (least outstanding, prefix affinity, the full queue's spill),
    streaming, cancel and release, logprobs, and every stat, equal to
    JAX's dp x tp engine on the same calls (logprobs within LOGPROB_TOL:
    f32 log-softmaxes of logits the two frameworks sum in other orders)."""
    got = without_exchanges(mesh_ranks[0][scenario])
    want = without_exchanges(jax_mesh_records[scenario])
    if "logprobs" in want:
        for g, w in zip(got.pop("logprobs"), want.pop("logprobs")):
            np.testing.assert_allclose(g, w, atol=LOGPROB_TOL, rtol=0)
    assert got == want


def test_dp_times_tp_affinity_and_cancel_through_the_front_end(mesh_ranks):
    aff = mesh_ranks[0]["affinity"]
    assert aff["replicas"][0] == aff["replicas"][1]
    hits = aff["stats"]["per_replica"][aff["replicas"][1]]["prefix_cache"]
    assert hits["hits"] >= 1  # the repeat reused pages on its replica
    assert aff["results"] == [solo([7] * 9, 3)] * 2
    rec = mesh_ranks[0]["streaming_and_cancel"]
    assert rec["seen"] == rec["result"] == solo([5, 3, 7, 2], 6)
    assert rec["finish"] == "cancelled"
    assert rec["released"][0] == "KeyError"
    # a queued ticket answers as a queued Engine ticket does
    assert rec["queued"][0][0] == rec["queued"][1][0] == "RuntimeError"
    assert rec["queued"][2:] == [[], False]


def test_dp_times_tp_ranks_hold_their_replica(mesh_ranks):
    """Rank r is replica r // 2's tp rank r % 2: a tp=2 shard and pool;
    only rank 0 serves, and a mesh of the wrong dp size is refused."""
    for r, rec in enumerate(mesh_ranks):
        place = rec["placement"]
        assert place["replica"] == r // 2 and place["tp_rank"] == r % 2
        assert place["is_leader"] == (r % 2 == 0)
        assert place["front"] == (r == 0)
        assert place["pool_heads"] == JCFG.kv_heads // 2
        assert place["wq_shape"] == (JCFG.d_model, JCFG.d_model // 2)
        assert place["wrong_dp"][0] == "ValueError"
        if r:
            assert place["follower_refuses"][0] == "RuntimeError"


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
