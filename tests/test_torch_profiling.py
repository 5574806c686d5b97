"""The port's ``torch.profiler`` captures on the CPU: a serving capture steps
a real engine and writes a Chrome trace, returning the JAX capture's keys;
overlapping captures are refused (and a refused or failed capture leaves the
profiler free); the device capture takes the probe path when nothing is
attached and the serving path when an engine is. The CUDA side (kernels in
the trace) is checked on the card by ``chip_smoke.py``'s serving_profile
phase."""

import json
import threading
from pathlib import Path

import pytest
import torch

from bee_code_interpreter_tpu.observability import (
    ServingProfiler as JaxServingProfiler,
)
from bee_code_interpreter_tpu_torch.models import engine as torch_engine
from bee_code_interpreter_tpu_torch.models import serving as torch_serving
from bee_code_interpreter_tpu_torch.observability import (
    DeviceProfiler,
    ProfilerUnavailable,
    ServingMonitor,
    ServingProfiler,
)

from tests.torch_parity import tiny_configs, tiny_params


class NoOp:
    def step(self) -> None:
        pass


@pytest.fixture(scope="module")
def monitored_engine():
    _, tcfg = tiny_configs()
    _, tparams = tiny_params(*tiny_configs())
    batcher = torch_serving.ContinuousBatcher(
        tparams, tcfg, max_batch=2, n_pages=32, page_size=4,
        max_pages_per_seq=8, device="cpu",
    )
    engine = torch_engine.Engine(batcher)
    monitor = ServingMonitor()
    monitor.attach(engine)
    return engine, monitor


def test_serving_capture_writes_a_trace_with_the_jax_keys(
    monitored_engine, tmp_path
):
    engine, monitor = monitored_engine
    tickets = [engine.submit([5, 3, 7, 2], 6), engine.submit([1, 2, 3], 6)]
    out = ServingProfiler(monitor, trace_root=tmp_path).capture(3)
    want = JaxServingProfiler(NoOp(), trace_root=tmp_path).capture(1)
    assert set(out) == set(want)
    assert out["steps"] == 3 and out["duration_ms"] > 0
    assert out["files"] == ["trace.json"]
    assert Path(out["trace_dir"]).parent == tmp_path
    trace = json.loads((Path(out["trace_dir"]) / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)  # the steps' ops
    engine.run_to_completion()
    assert all(len(engine.result(t)) == 6 for t in tickets)


def test_overlapping_captures_are_refused(monitored_engine, tmp_path):
    engine, _ = monitored_engine
    entered, release = threading.Event(), threading.Event()

    class Blocking:
        def step(self):
            entered.set()
            assert release.wait(30)

    profiler = ServingProfiler(Blocking(), trace_root=tmp_path)
    results = []
    worker = threading.Thread(
        target=lambda: results.append(profiler.capture(1)))
    worker.start()
    try:
        assert entered.wait(30)
        assert profiler.capturing
        with pytest.raises(ProfilerUnavailable, match="in progress"):
            profiler.capture(1)
    finally:
        release.set()
        worker.join(30)
    assert not worker.is_alive() and len(results) == 1
    assert not profiler.capturing  # free again
    with pytest.raises(ValueError, match="steps"):
        profiler.capture(0)


def test_failed_start_leaves_no_directory_and_frees_the_profiler(
    monkeypatch, tmp_path
):
    def refuse(*args, **kwargs):
        raise RuntimeError("no profiler backend")

    monkeypatch.setattr(torch.profiler.profile, "__enter__", refuse)
    profiler = ServingProfiler(NoOp(), trace_root=tmp_path)
    with pytest.raises(ProfilerUnavailable, match="no profiler backend"):
        profiler.capture(1)
    assert list(tmp_path.iterdir()) == []
    assert not profiler.capturing


def test_device_profiler_probe_and_serving_paths(monitored_engine, tmp_path):
    probe = DeviceProfiler(trace_root=tmp_path)
    assert probe.available
    out = probe.capture(2)
    assert out["source"] == "probe" and out["steps"] == 2
    assert out["files"] == ["trace.json"]
    # a ServingMonitor with nothing attached is not a stepper yet
    assert DeviceProfiler(ServingMonitor(), tmp_path).capture(1)[
        "source"] == "probe"
    engine, monitor = monitored_engine
    ticket = engine.submit([4, 4, 2], 3)
    served = DeviceProfiler(monitor, trace_root=tmp_path).capture(2)
    assert served["source"] == "serving"
    engine.run_to_completion()
    assert len(engine.result(ticket)) == 3
