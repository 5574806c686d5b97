"""The port's serving observability against the JAX package's: the same
traffic through both stacks (registry, trace store, flight recorder and
ServingMonitor over an Engine and ContinuousBatcher; tiny config, 2 KV heads,
f32, the same weights) gives the same step records, request records, wide
events and metric values. Exact equality wherever no wall time enters: the
step records field by field but ``duration_ms`` and ``ts``; the request
records but their times and trace ids; the sequence of wide-event kinds,
names and outcomes; every metric's name, type and help text; every counter's
value, every histogram's count and the final gauge values (the throughput
gauge, a rate of the wall clock, excepted).

The scenarios are those of the JAX package's tests/test_serving_trace.py:
the hand-driven lifecycle, reject / requeue / preempt accounting and step
ring, then the engine runs (lifecycle, page churn with prefix reuse,
saturation, preempting an interleaved prefill, speculative commit
accounting)."""

import time

import numpy as np
import pytest

from bee_code_interpreter_tpu.models import engine as jax_engine
from bee_code_interpreter_tpu.models import serving as jax_serving
from bee_code_interpreter_tpu.observability import (
    FlightRecorder as JaxFlightRecorder,
)
from bee_code_interpreter_tpu.observability import (
    ServingMonitor as JaxServingMonitor,
)
from bee_code_interpreter_tpu.observability import TraceStore as JaxTraceStore
from bee_code_interpreter_tpu.utils.metrics import Registry as JaxRegistry
from bee_code_interpreter_tpu_torch.models import engine as torch_engine
from bee_code_interpreter_tpu_torch.models import serving as torch_serving
from bee_code_interpreter_tpu_torch.observability import (
    FlightRecorder,
    ServingMonitor,
    TraceStore,
)
from bee_code_interpreter_tpu_torch.utils.metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
)

from tests.torch_parity import tiny_configs, tiny_params

LONG = [int(x) for x in np.random.default_rng(7).integers(0, 200, 21)]
SHORT = [5, 3, 7, 2]
JAX = (jax_serving, jax_engine, JaxRegistry, JaxTraceStore,
       JaxFlightRecorder, JaxServingMonitor)
PORT = (torch_serving, torch_engine, Registry, TraceStore, FlightRecorder,
        ServingMonitor)
# the fields of the records that hold wall times or random ids
STEP_TIMES = {"duration_ms", "ts"}
REQUEST_TIMES = {"ts", "queued_ms", "ttft_ms", "duration_ms", "trace_id"}
RATE_GAUGES = {"bci_serving_tokens_per_second"}


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = tiny_configs()
    return (jcfg, tcfg, *tiny_params(jcfg, tcfg))


class Stack:
    """Registry + store + recorder + monitor over an engine of one
    framework: the JAX test's ``monitored_stack``."""

    def __init__(self, mods, cfg, params, *, max_batch=2, n_pages=32,
                 max_queue=None, max_steps=512, max_requests=256,
                 engine=True, **batcher_kw):
        (self.serving, self.engine_mod, registry, store, recorder,
         monitor) = mods
        self.metrics = registry()
        self.store = store()
        self.recorder = recorder(metrics=self.metrics)
        self.monitor = monitor(metrics=self.metrics, store=self.store,
                               recorder=self.recorder, max_steps=max_steps,
                               max_requests=max_requests)
        if not engine:
            return
        batcher_kw.setdefault("page_size", 4)
        batcher_kw.setdefault("max_pages_per_seq", 8)
        if self.serving is torch_serving:
            batcher_kw["device"] = "cpu"
        batcher = self.serving.ContinuousBatcher(
            params, cfg, max_batch=max_batch, n_pages=n_pages,
            metrics=self.metrics, **batcher_kw,
        )
        self.engine = self.engine_mod.Engine(batcher, max_queue=max_queue,
                                             metrics=self.metrics)
        self.monitor.attach(self.engine)


def observed(stack: Stack) -> dict:
    """Everything the two stacks must agree on, times and ids left out."""
    snap = stack.monitor.snapshot(steps=10_000)
    steps = [{k: v for k, v in s.items() if k not in STEP_TIMES}
             for s in snap["steps"]["last"]]
    requests = [
        {**{k: v for k, v in r.items() if k not in REQUEST_TIMES},
         **{f"{k}_set": r[k] is not None
            for k in ("queued_ms", "ttft_ms")}}
        for r in stack.monitor.requests()
    ]
    events = [(e["kind"], e["name"], e["outcome"],
               {k: v for k, v in e.get("serving", {}).items()
                if k != "ttft_ms"})
              for e in stack.recorder.events()]
    registry = {name: (type(m).__name__, m.help)
                for name, m in stack.metrics.metrics.items()}
    values = {}
    for name, m in stack.metrics.metrics.items():
        if type(m).__name__ == "Counter":
            values[name] = dict(m._values)
        elif type(m).__name__ == "Histogram":
            values[name] = dict(m._totals)
        elif name not in RATE_GAUGES:
            values[name] = {k: fn() for k, fn in m._fns.items()}
    snap.pop("steps")
    snap["requests"].pop("active")
    return {"steps": steps, "requests": requests, "events": events,
            "registry": registry, "values": values,
            "recorded_steps": len(steps), "snapshot": snap}


# ------------------------------------------------- hand-driven monitor units


def hand_lifecycle(stack):
    mon = stack.monitor
    mon.on_ticket_queued(1)
    time.sleep(0.002)
    mon.on_ticket_admitting(1)
    mon.on_submit(
        7, prompt_tokens=5, max_new_tokens=4, pages=2, prefix_pages=1,
        adapter=None, speculative=True, interleaved=False,
    )
    mon.on_first_token(7)
    mon.on_commit(7, accepted=2, rejected=1)
    mon.on_done(7, "length", tokens=4)


def hand_reject_requeue_preempt(stack):
    mon = stack.monitor
    mon.on_ticket_rejected("queue_full")
    mon.on_ticket_rejected("queue_full")
    mon.on_ticket_queued(3)
    mon.on_ticket_requeued(3)
    mon.on_submit(
        9, prompt_tokens=3, max_new_tokens=2, pages=1, prefix_pages=0,
        adapter=None, speculative=False, interleaved=True,
    )
    mon.on_preempt(9)
    mon.on_ticket_queued(4)
    mon.on_ticket_failed(4, "ValueError('x')")
    mon.on_ticket_queued(5)
    mon.on_ticket_cancelled(5)


def hand_step_ring(stack):
    for i in range(10):
        stack.monitor.on_step({"duration_ms": float(i), "decode_tokens": i})


@pytest.mark.parametrize("script", [hand_lifecycle,
                                    hand_reject_requeue_preempt,
                                    hand_step_ring],
                         ids=lambda f: f.__name__)
def test_hand_driven_hooks_match_jax(script):
    got = {}
    for name, mods in (("jax", JAX), ("port", PORT)):
        stack = Stack(mods, None, None, engine=False, max_steps=4,
                      max_requests=3)
        script(stack)
        got[name] = observed(stack)
        event_ids = {e.get("trace_id") for e in stack.recorder.events()}
        assert all(t.trace_id in event_ids for t in stack.store.traces())
    assert got["port"] == got["jax"]


# ------------------------------------------------------- engine scenarios


def run_lifecycle(stack):
    engine = stack.engine
    tickets = [engine.submit(SHORT, 4), engine.submit(LONG, 4)]
    engine.run_to_completion()
    out = [engine.result(t) for t in tickets]
    for t in tickets:
        engine.release(t)
    return out


def run_prefix_reuse(stack):
    engine = stack.engine
    out = []
    for _ in range(2):  # the second pass revives the first's parked pages
        ticket = engine.submit(LONG, 3)
        engine.run_to_completion()
        out.append(engine.result(ticket))
        engine.release(ticket)
    kv = engine.batcher.kv_telemetry()
    assert kv["prefix"]["hits"] >= 1
    assert (kv["pages_allocated_total"] - kv["pages_released_total"]
            == kv["pages_held"] == 0)
    return out


def run_saturation(stack):
    engine = stack.engine
    queued = [engine.submit(LONG, 3)]
    # a capacity race: the queue believes the pages are there (an
    # over-reported prefix credit), the batcher's own arithmetic says no
    batcher = engine.batcher
    real_credit, free_backup = batcher.prefix_credit, batcher.free_pages
    batcher.prefix_credit = lambda prompt, adapter: 10_000
    batcher.free_pages = []
    engine._admit_ready()
    batcher.prefix_credit, batcher.free_pages = real_credit, free_backup
    queued.append(engine.submit(SHORT, 3))
    for _ in range(3):  # the queue is full (2): every submit bounces
        with pytest.raises(RuntimeError, match="queue full"):
            engine.submit(SHORT, 3)
    engine.run_to_completion()
    return [engine.result(t) for t in queued]


def run_preempt_interleaved(stack):
    engine = stack.engine
    decoding = engine.submit(SHORT, 8)
    ticket = engine.submit(LONG, 4, interleave_admission=4)
    engine.step()  # admits both; LONG starts its windowed prefill
    assert engine.partial_result(ticket) == []
    assert engine.preempt(decoding) is False
    assert engine.preempt(ticket) is True
    engine.run_to_completion()
    return [engine.result(ticket), engine.result(decoding)]


def run_speculative(stack):
    engine = stack.engine
    ticket = engine.submit(SHORT, 6)
    engine.run_to_completion()
    return [engine.result(ticket)]


def run_cancel_and_errors(stack):
    """Cancel mid-decode and mid-prefill, a constraint that permits no
    first token, and a constraint that raises at the first token."""
    engine, sp = stack.engine, stack.serving.SamplingParams

    def boom(_):
        raise ValueError("no")

    a = engine.submit(SHORT, 8)
    b = engine.submit(LONG, 6, interleave_admission=4)
    engine.step()
    engine.cancel(a)
    engine.cancel(b)
    c = engine.submit(SHORT, 3, sampling=sp(allowed_tokens=lambda _: []))
    d = engine.submit(SHORT, 3, sampling=sp(allowed_tokens=boom))
    engine.run_to_completion()
    return [engine.finish_reason(t) for t in (a, b, c, d)]


SCENARIOS = {
    "lifecycle": (run_lifecycle, {}),
    "prefix_reuse": (run_prefix_reuse, dict(prefix_cache=True)),
    "saturation": (run_saturation, dict(max_queue=2)),
    "preempt_interleaved": (run_preempt_interleaved, {}),
    "speculative": (run_speculative, dict(draft_params=True, gamma=2)),
    "cancel_and_errors": (run_cancel_and_errors, {}),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_scenario_matches_jax(models, name):
    jcfg, tcfg, jparams, tparams = models
    script, kw = SCENARIOS[name]
    got = {}
    for fw, mods, cfg, params in (("jax", JAX, jcfg, jparams),
                                  ("port", PORT, tcfg, tparams)):
        stack_kw = dict(kw)
        if "draft_params" in stack_kw:
            stack_kw.update(draft_params=params, draft_config=cfg)
        stack = Stack(mods, cfg, params, **stack_kw)
        tokens = script(stack)
        got[fw] = {"tokens": tokens, **observed(stack)}
        if fw == "port":
            # the port's own surfaces agree with each other
            for row in stack.monitor.requests():
                trace = stack.store.get(row["trace_id"])
                assert trace is not None and all(
                    s.duration_s is not None for s in trace.spans)
            steps = got[fw]["steps"]
            assert steps and all(s["mesh"] == "1" for s in steps)
    for key in got["jax"]:
        assert got["port"][key] == got["jax"][key], key


def test_step_records_price_the_step_and_ttft_exemplar_names_the_trace(models):
    """On the port alone: a step record's time covers the step (it is at
    least the sum of its windows' and decode's work, here: positive, and the
    step histogram counts every step), and the TTFT histogram's exemplar
    carries the request's trace id, as the wide event does."""
    _, tcfg, _, tparams = models
    stack = Stack(PORT, tcfg, tparams)
    ticket = stack.engine.submit(SHORT, 4)
    stack.engine.run_to_completion()
    assert len(stack.engine.result(ticket)) == 4
    steps = stack.monitor.snapshot()["steps"]["last"]
    assert all(s["duration_ms"] > 0 for s in steps)
    step_hist = stack.metrics.metrics["bci_serving_step_seconds"]
    assert step_hist._totals[()] == len(steps)
    (row,) = stack.monitor.requests()
    exposition = stack.metrics.expose(openmetrics=True)
    ttft_lines = [line for line in exposition.splitlines()
                  if line.startswith("bci_serving_ttft_seconds_bucket")
                  and "trace_id" in line]
    assert ttft_lines and all(row["trace_id"] in line for line in ttft_lines)
    (event,) = stack.recorder.events(kind="serving")
    assert event["trace_id"] == row["trace_id"]


def test_metric_classes_are_the_registry_kinds():
    """The comparison above reads metric kinds by class name: the port's
    registry hands out its own Counter / Gauge / Histogram."""
    r = Registry()
    assert isinstance(r.counter("a_total", "a"), Counter)
    assert isinstance(r.gauge("b", "b", lambda: 1.0), Gauge)
    assert isinstance(r.histogram("c_seconds", "c"), Histogram)
    with pytest.raises(ValueError, match="already registered"):
        r.histogram("a_total", "a")


def test_failed_interleaved_submit_closes_its_request_record(models,
                                                             monkeypatch):
    """The port's intended divergence (ROADMAP Queue 3): a fault inside the
    interleaved branch of ``submit`` returns the pages and the row, and the
    monitor closes the request as an error (JAX leaks both, and its record
    stays live)."""
    _, tcfg, _, tparams = models
    stack = Stack(PORT, tcfg, tparams)
    batcher = stack.engine.batcher

    def fault(*args, **kwargs):
        raise RuntimeError("injected")

    monkeypatch.setattr(batcher, "_prefill_record", fault)
    with pytest.raises(RuntimeError, match="injected"):
        batcher.submit(LONG, 4, interleave_admission=8)
    (row,) = stack.monitor.requests()
    assert row["outcome"] == "error" and row["active"] is False
    assert "injected" in row["error"]
    assert stack.store.get(row["trace_id"]).status == "error"
    assert batcher.kv_telemetry()["pages_held"] == 0
