"""The port's accelerator observability against the JAX package's:
``TrackedJit`` over torch programs (one report per new signature, JAX's
``float32[4]`` rendering, the unmonitored pass-through), ``DeviceMonitor``'s
surfaces (a first call's wide event, counter and backdated span sharing one
trace id; the CPU-estimated memory snapshot and the CUDA rows read from
``torch.cuda.memory_stats``; step telemetry under the shape ``"1"``), and the
forced-retrace scenario of the JAX package's tests/test_device_monitor.py on
both stacks: the same ``(function, trigger)`` events, the retrace inside the
second request's trace, the same KV-pool join."""

import collections
import functools

import numpy as np
import pytest
import torch

from bee_code_interpreter_tpu.models import engine as jax_engine
from bee_code_interpreter_tpu.models import serving as jax_serving
from bee_code_interpreter_tpu.observability import (
    DeviceMonitor as JaxDeviceMonitor,
)
from bee_code_interpreter_tpu.observability import (
    FlightRecorder as JaxFlightRecorder,
)
from bee_code_interpreter_tpu.observability import (
    ServingMonitor as JaxServingMonitor,
)
from bee_code_interpreter_tpu.observability import TraceStore as JaxTraceStore
from bee_code_interpreter_tpu.parallel.mesh import (
    mesh_descriptor as jax_mesh_descriptor,
)
from bee_code_interpreter_tpu.utils.metrics import Registry as JaxRegistry
from bee_code_interpreter_tpu_torch.models import engine as torch_engine
from bee_code_interpreter_tpu_torch.models import serving as torch_serving
from bee_code_interpreter_tpu_torch.observability import (
    DeviceMonitor,
    FlightRecorder,
    ServingMonitor,
    Trace,
    TraceStore,
    activate_trace,
    mesh_descriptor,
    mesh_shape_key,
)
from bee_code_interpreter_tpu_torch.utils.jitwatch import (
    TrackedJit,
    abstract_signature,
)
from bee_code_interpreter_tpu_torch.utils.metrics import Registry

from tests.torch_parity import tiny_configs, tiny_params

JAX = (jax_serving, jax_engine, JaxRegistry, JaxTraceStore,
       JaxFlightRecorder, JaxServingMonitor, JaxDeviceMonitor)
PORT = (torch_serving, torch_engine, Registry, TraceStore, FlightRecorder,
        ServingMonitor, DeviceMonitor)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = tiny_configs()
    return (jcfg, tcfg, *tiny_params(jcfg, tcfg))


def counter_value(metrics, needle: str) -> float:
    for line in metrics.expose().splitlines():
        if line.startswith(needle + " ") or line.startswith(needle + "{"):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


class Hook:
    def __init__(self) -> None:
        self.compiles = []

    def on_compile(self, name, *, signature, duration_ms, trigger):
        self.compiles.append({"name": name, "signature": signature,
                              "trigger": trigger, "duration_ms": duration_ms})


# ------------------------------------------------------------- TrackedJit


def test_tracked_program_reports_each_signature_once():
    hook = Hook()
    fn = TrackedJit(lambda x: x * 2, "double", lambda: hook)
    torch.testing.assert_close(fn(torch.ones(4)), torch.full((4,), 2.0))
    assert [c["trigger"] for c in hook.compiles] == ["first_call"]
    assert hook.compiles[0]["name"] == "double"
    assert hook.compiles[0]["signature"] == "(float32[4])"
    assert hook.compiles[0]["duration_ms"] > 0.0

    fn(torch.zeros(4))  # the same signature: no report
    assert len(hook.compiles) == 1

    fn(torch.ones(8))  # a new shape: one retrace, reported once
    fn(torch.ones(8))
    fn(torch.ones(8, dtype=torch.bfloat16))  # a new dtype: another
    assert [c["trigger"] for c in hook.compiles] == [
        "first_call", "retrace", "retrace",
    ]
    assert [c["signature"] for c in hook.compiles[1:]] == [
        "(float32[8])", "(bfloat16[8])",
    ]


def test_unmonitored_pass_through_and_signature_rendering():
    fn = TrackedJit(functools.partial(torch.add, other=1), "inc",
                    lambda: None)
    assert int(fn(torch.tensor(1))) == 2  # no monitor: a plain call
    assert fn.keywords == {"other": 1}  # attributes pass through
    assert fn._signatures == set()  # nothing recorded while unmonitored
    assert abstract_signature((torch.ones(2, 3),), {"n": 4}) == (
        "(float32[2,3], n=4)"
    )
    # the rendering of JAX's module for the same shapes (numpy arrays,
    # statics, a container summarised past four leaves)
    from bee_code_interpreter_tpu.utils.jitwatch import (
        abstract_signature as jax_signature,
    )

    big = {f"w{i}": np.ones((2, 2), np.float32) for i in range(5)}
    args = (np.zeros((3,), np.int32), None, 2.5, big,
            [np.ones((1,), np.float32)])
    assert abstract_signature(args, {"n": 4}) == jax_signature(args, {"n": 4})
    torch_big = {k: torch.from_numpy(v) for k, v in big.items()}
    assert abstract_signature((torch.zeros(3, dtype=torch.int32), torch_big)) \
        == jax_signature((np.zeros((3,), np.int32), big))


# ----------------------------------------------------------- DeviceMonitor


def test_on_compile_event_counter_and_backdated_span_share_trace_id():
    metrics = Registry()
    recorder = FlightRecorder(metrics=metrics)
    monitor = DeviceMonitor(metrics=metrics, recorder=recorder)
    trace = Trace("request", request_id="req-1")
    with activate_trace(trace):
        monitor.on_compile("decode_step", signature="(float32[2,4])",
                           duration_ms=120.0, trigger="retrace")

    (event,) = recorder.events(kind="compile")
    assert event["function"] == "decode_step"
    assert event["trigger"] == "retrace"
    assert event["trace_id"] == trace.trace_id
    assert event["request_id"] == "req-1"
    (span,) = [s for s in trace.spans if s.name == "xla.compile"]
    assert span.duration_ms == pytest.approx(120.0, rel=0.05)
    assert span.attributes["trigger"] == "retrace"
    assert counter_value(metrics, 'bci_compile_total{trigger="retrace"}') == 1
    snap = monitor.snapshot()
    assert snap["compile"]["recent"][0]["trace_id"] == trace.trace_id


def test_compile_ledger_and_registry_match_jax():
    """The same hand-driven first calls, with and without an ambient trace,
    give the JAX monitor's ledger, registry and event kinds."""
    got = {}
    for name, (registry, recorder_cls, monitor_cls) in (
        ("jax", (JaxRegistry, JaxFlightRecorder, JaxDeviceMonitor)),
        ("port", (Registry, FlightRecorder, DeviceMonitor)),
    ):
        metrics = registry()
        recorder = recorder_cls(metrics=metrics)
        monitor = monitor_cls(metrics=metrics, recorder=recorder)
        monitor.on_compile("prefill", signature="(int32[8])", duration_ms=5.0,
                           trigger="first_call")
        monitor.on_compile("prefill", signature="(int32[12])",
                           duration_ms=7.0, trigger="retrace")
        monitor.on_compile("decode", signature="(int32[2,1])",
                           duration_ms=3.0, trigger="first_call")
        compile_ = monitor.snapshot()["compile"]
        compile_["recent"] = [{k: v for k, v in r.items() if k != "ts"}
                              for r in compile_["recent"]]
        got[name] = {
            "compile": compile_,
            "events": [(e["kind"], e["function"], e["trigger"],
                        "trace_id" in e)
                       for e in recorder.events(kind="compile")],
            "registry": {n: (type(m).__name__, m.help)
                         for n, m in metrics.metrics.items()},
            "counts": counter_value(metrics,
                                    'bci_compile_total{trigger="first_call"}'),
            "fleet": {k: v for k, v in monitor.fleet_summary().items()
                      if k != "hbm"},
        }
    assert got["port"] == got["jax"]


def test_cpu_memory_degradation_snapshot():
    """Without CUDA: one row estimated from the live tensors, marked
    estimated, a running-max peak, no limit; the gauges are registered."""
    metrics = Registry()
    monitor = DeviceMonitor(metrics=metrics)
    keep = torch.ones((256, 256), dtype=torch.float32)
    rows = monitor.sample_memory()
    assert [r["device"] for r in rows] == ["cpu:0"]
    assert rows[0]["estimated"] and rows[0]["limit_bytes"] is None
    assert rows[0]["platform"] == "cpu"
    assert rows[0]["live_bytes"] >= keep.nbytes
    assert rows[0]["peak_bytes"] >= rows[0]["live_bytes"]

    snap = monitor.snapshot()
    assert snap["attached"] is False
    assert snap["memory"]["estimated"] is True
    assert snap["memory"]["samples"] >= 2  # the constructor takes one
    assert snap["kv_pool"] is None and snap["mesh"] is None

    fleet = monitor.fleet_summary()
    assert fleet["hbm"]["estimated"] is True
    assert fleet["hbm"]["limit_bytes"] is None
    assert fleet["hbm"]["live_bytes"] >= keep.nbytes
    assert fleet["mesh"] is None and fleet["compiles"] == 0
    assert counter_value(
        metrics, 'bci_device_hbm_bytes{device="cpu:0",kind="live"}'
    ) >= keep.nbytes
    del keep


def test_cuda_rows_come_from_the_allocator_and_never_fall_back(monkeypatch):
    """The CUDA branch, on fake allocator answers: live and peak are the
    allocated bytes, the limit is mem_get_info's total, nothing estimated;
    a failing memory_stats raises instead of estimating."""
    stats = {"allocated_bytes.all.current": 1000,
             "allocated_bytes.all.peak": 3000,
             "reserved_bytes.all.current": 4096}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: stats)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (7, 80 << 30))
    metrics = Registry()
    monitor = DeviceMonitor(metrics=metrics)
    rows = monitor.snapshot()["memory"]["devices"]
    assert rows == [
        {"device": f"gpu:{d}", "platform": "gpu", "live_bytes": 1000,
         "peak_bytes": 3000, "limit_bytes": 80 << 30, "estimated": False}
        for d in (0, 1)
    ]
    assert monitor.fleet_summary()["hbm"] == {
        "live_bytes": 2000, "limit_bytes": 2 * (80 << 30), "estimated": False,
    }
    assert counter_value(
        metrics, 'bci_device_hbm_bytes{device="gpu:1",kind="limit"}'
    ) == 80 << 30

    def broken(d):
        raise RuntimeError("no allocator")

    monkeypatch.setattr(torch.cuda, "memory_stats", broken)
    with pytest.raises(RuntimeError, match="no allocator"):
        monitor.sample_memory()


def test_step_telemetry_under_shape_one_matches_jax():
    got = {}
    for name, monitor_cls, descriptor in (
        ("jax", JaxDeviceMonitor, jax_mesh_descriptor),
        ("port", DeviceMonitor, mesh_descriptor),
    ):
        monitor = monitor_cls(metrics=(JaxRegistry if name == "jax"
                                       else Registry)())
        monitor.record_step(10.0)  # no mesh: the single-device "1" bucket
        monitor.set_mesh(descriptor(None))
        monitor.record_step(20.0)
        monitor.record_step(30.0, shape="dp=2,tp=4")
        snap = monitor.snapshot()
        got[name] = {"steps": snap["steps"], "mesh": snap["mesh"]}
    assert got["port"] == got["jax"]
    shapes = got["port"]["steps"]["by_shape"]
    assert shapes["1"]["steps"] == 2
    assert shapes["1"]["total_ms"] == pytest.approx(30.0)


def test_mesh_shape_key_and_descriptor():
    """No mesh, and a mesh of one CPU rank, keyed and described as JAX
    keys and describes a one-device mesh (tensor-parallel keys such as
    ``"tp=2"`` are held to JAX's in tests/test_torch_parallel_mesh.py and
    tests/test_torch_serving_mesh.py)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from bee_code_interpreter_tpu.parallel.mesh import (
        mesh_shape_key as jax_mesh_shape_key,
    )
    from tests.torch_tp_worker import single_rank_mesh

    assert mesh_shape_key(None) == "1"
    assert mesh_descriptor(None) == jax_mesh_descriptor(None)
    assert mesh_descriptor(None, torch.device("cuda", 0))["platform"] == "gpu"
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))
    with single_rank_mesh({"dp": 1, "tp": 1}) as mesh:
        assert mesh_shape_key(mesh) == jax_mesh_shape_key(jmesh) == "dp=1,tp=1"
        assert mesh_descriptor(mesh) == jax_mesh_descriptor(jmesh)
    with pytest.raises(ValueError, match="not a DeviceMesh"):
        mesh_shape_key(object())


# ------------------------------------------------- e2e: retrace under load


def monitored_stack(mods, cfg, params):
    """Both monitors over a tiny engine (the JAX test's wiring): page_size 4,
    so a 3-token prompt pads to one page and a 6-token prompt to two, and
    the second prefill shape is a new signature mid-serving."""
    serving, engine_mod, registry, store_cls, recorder_cls, serving_cls, \
        device_cls = mods
    metrics = registry()
    store = store_cls()
    recorder = recorder_cls(metrics=metrics, max_events=256)
    serving_monitor = serving_cls(metrics=metrics, store=store,
                                  recorder=recorder)
    device = device_cls(metrics=metrics, recorder=recorder)
    kw = dict(device="cpu") if serving is torch_serving else {}
    batcher = serving.ContinuousBatcher(
        params, cfg, max_batch=2, n_pages=16, page_size=4,
        max_pages_per_seq=4, metrics=metrics, **kw,
    )
    engine = engine_mod.Engine(batcher, max_queue=4, metrics=metrics)
    serving_monitor.attach(engine)
    device.attach(engine)
    return engine, device, metrics, store, recorder


def test_forced_retrace_during_serving_matches_jax(models):
    jcfg, tcfg, jparams, tparams = models
    got = {}
    for name, mods, cfg, params in (("jax", JAX, jcfg, jparams),
                                    ("port", PORT, tcfg, tparams)):
        engine, device, metrics, store, recorder = monitored_stack(
            mods, cfg, params)
        t_a = engine.submit([1, 2, 3], 4)  # one page: first calls
        engine.run_to_completion()
        assert device.snapshot()["compile"]["by_trigger"].get(
            "retrace", 0) == 0
        t_b = engine.submit([5, 3, 7, 2, 9, 11], 4)  # two pages: a retrace
        engine.run_to_completion()
        events = recorder.events(kind="compile")
        retraces = [e for e in events if e["trigger"] == "retrace"]
        trace_ids = {e.get("trace_id") for e in retraces}
        assert len(trace_ids) == 1 and None not in trace_ids
        trace = store.get(trace_ids.pop())
        assert trace.request_id == "serving-1"  # request B's trace
        compile_spans = [s for s in trace.spans if s.name == "xla.compile"]
        assert len(compile_spans) == len(retraces)
        snap = device.snapshot()
        assert snap["compile"]["total"] == len(events)
        assert counter_value(
            metrics, 'bci_compile_total{trigger="retrace"}') == len(retraces)
        got[name] = {
            "tokens": [engine.result(t_a), engine.result(t_b)],
            "compiles": collections.Counter(
                (e["function"], e["trigger"], "trace_id" in e)
                for e in events),
            "spans": sorted((s.attributes["function"],
                             s.attributes["trigger"])
                            for s in compile_spans),
            "kv_pool": snap["kv_pool"],
            "steps": {k: v["steps"]
                      for k, v in snap["steps"]["by_shape"].items()},
            "step_count": metrics.metrics["bci_device_step_seconds"]._totals,
        }
    assert got["port"] == got["jax"]
    assert got["port"]["compiles"][("prefill_forward", "retrace", True)] == 1
