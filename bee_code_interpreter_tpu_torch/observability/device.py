"""Accelerator observability: the port's counterpart of
``bee_code_interpreter_tpu/observability/device.py``.

:class:`DeviceMonitor` is the runtime-signal layer over the port's batcher,
with the JAX monitor's three signals and its snapshot:

- **First calls of programs** (the JAX monitor's compile/retrace tracking):
  the batcher's programs are wrapped in
  :class:`~bee_code_interpreter_tpu_torch.utils.jitwatch.TrackedJit`, which
  calls :meth:`on_compile` on the first call of a program at each new
  signature. Each is one ``kind="compile"`` wide event, one
  ``bci_compile_total{trigger}`` increment, one ``bci_compile_seconds``
  observation and, under an active request trace (the batcher activates the
  request's trace around admission), one backdated ``xla.compile`` span in
  that request's span tree, all naming the same trace id. The names are
  JAX's, so a dashboard reads both packages alike.
- **Device memory**: on CUDA, each visible card's caching-allocator counts
  from ``torch.cuda.memory_stats``: ``live_bytes`` is
  ``allocated_bytes.all.current`` and ``peak_bytes``
  ``allocated_bytes.all.peak`` (the bytes held by live tensors; the
  allocator's ``reserved`` bytes are larger, since they include its cached
  free blocks), and ``limit_bytes`` the card's total memory from
  ``torch.cuda.mem_get_info``. Without CUDA, JAX's CPU degradation: one row
  estimated from the storages of the live tensors (a ``gc`` walk, the
  counterpart of ``jax.live_arrays()``), marked ``estimated``, its peak a
  running maximum, no limit. Published as ``bci_device_hbm_bytes{device,
  kind=live|peak|limit}``; the snapshot joins the attached batcher's
  ``kv_telemetry()``.
- **Step telemetry per mesh shape**: the batcher reports each step's wall
  time under its mesh's shape key (``"1"`` on one card, ``"tp=2"`` for a
  tensor-parallel batcher, JAX's keys; ``parallel/mesh.py``).

The monitor is duck-typed from the ``models/`` side: the batcher calls the
hooks when one is attached and pays one ``None`` check otherwise.
"""

from __future__ import annotations

import asyncio
import gc
import threading
import time
from collections import deque

import torch

from bee_code_interpreter_tpu_torch.observability.tracing import current_trace
from bee_code_interpreter_tpu_torch.parallel import mesh as _mesh

# histogram buckets for the stall of a first call: 10 ms (a small program)
# to minutes (a cold process building its kernels); the serving-latency
# buckets top out far too low to see them
COMPILE_SECONDS_BUCKETS = (
    0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)


def _platform(device: torch.device | None) -> str:
    """A device's platform as JAX names it (``gpu`` for CUDA); with no
    device, this process's default one."""
    if device is None:
        return "gpu" if torch.cuda.is_available() else "cpu"
    return "gpu" if device.type == "cuda" else device.type


def mesh_shape_key(mesh) -> str:
    """Stable key for a mesh's axis sizes (``"tp=2"``); ``"1"`` with no
    mesh (one card)."""
    return _mesh.mesh_shape_key(mesh)


def mesh_descriptor(mesh, device: torch.device | None = None) -> dict:
    """JAX's ``parallel.mesh.mesh_descriptor`` (``parallel/mesh.py``): axes,
    shape key, device counts, this rank and its coordinates, platform.
    Without a mesh, the single-device degradation (axes ``{}``, shape
    ``"1"``) with the platform of ``device`` (or of this process's default
    device)."""
    out = _mesh.mesh_descriptor(mesh)
    if mesh is None:
        out["platform"] = _platform(device)
    return out


def _live_tensor_bytes() -> int:
    """Bytes of the distinct CPU storages behind the live tensors."""
    seen: dict[int, int] = {}
    for obj in gc.get_objects():
        # type(), not isinstance(): the latter reads __class__, which some
        # deprecated torch objects answer with a warning
        if not issubclass(type(obj), torch.Tensor) or obj.device.type != "cpu":
            continue
        try:
            storage = obj.untyped_storage()
            seen[storage.data_ptr()] = storage.nbytes()
        except (RuntimeError, NotImplementedError):
            continue  # a tensor without a plain storage (sparse, meta)
    return sum(seen.values())


class DeviceMonitor:
    """First-call tracking, device-memory accounting and per-mesh-shape
    step telemetry. The constructor registers the metrics and takes one
    memory sample, so the HBM gauges exist before any sampler runs;
    :meth:`attach` binds a ``models.engine.Engine`` or bare
    ``ContinuousBatcher`` and injects the monitor into its tracked
    programs.
    """

    def __init__(
        self,
        *,
        metrics=None,
        recorder=None,  # flightrecorder.FlightRecorder
        sample_interval_s: float = 10.0,
        max_compiles: int = 256,
    ) -> None:
        self._recorder = recorder
        self._metrics = metrics
        self._sample_interval_s = sample_interval_s
        self._lock = threading.Lock()
        self._compiles: deque[dict] = deque(maxlen=max(1, max_compiles))
        self._compile_seq = 0
        self._compile_by_trigger: dict[str, int] = {}
        # function name -> its ledger; the signature list is the function's
        # signature set in first-seen order, so a retrace names the shape
        # that caused it next to every shape seen before
        self._functions: dict[str, dict] = {}
        self._mesh: dict | None = None
        self._shapes: dict[str, dict] = {}
        self._memory: list[dict] = []
        self._memory_unix: float | None = None
        self._memory_samples = 0
        self._peak_estimate: dict[str, int] = {}
        self._gauged: set[tuple[str, str]] = set()
        self._engine = None
        self._batcher = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._sampler_task: asyncio.Task | None = None
        self._compile_total = None
        self._compile_seconds = None
        self._step_seconds = None
        if metrics is not None:
            self._compile_total = metrics.counter(
                "bci_compile_total",
                "XLA compilations observed by the tracked jits, by trigger "
                "(first_call|retrace)",
            )
            self._compile_seconds = metrics.histogram(
                "bci_compile_seconds",
                "Wall time of one XLA compilation (the stall the caller felt)",
                buckets=COMPILE_SECONDS_BUCKETS,
            )
            self._step_seconds = metrics.histogram(
                "bci_device_step_seconds",
                "Batcher/dryrun step wall time, by mesh shape",
            )
        self.sample_memory()

    # ------------------------------------------------------------ wiring

    def attach(self, target) -> None:
        """Bind a ``models.engine.Engine`` (or a bare ``ContinuousBatcher``)
        so its tracked programs report first calls here, its step timings
        land in the per-shape aggregates, and the snapshot joins its KV-pool
        telemetry and mesh descriptor."""
        batcher = getattr(target, "batcher", target)
        self._engine = target if batcher is not target else None
        self._batcher = batcher
        batcher.set_device_monitor(self)
        self.set_mesh(mesh_descriptor(getattr(batcher, "mesh", None),
                                      getattr(batcher, "device", None)))
        try:
            self._loop = asyncio.get_running_loop()
        except RuntimeError:
            pass

    @property
    def available(self) -> bool:
        return self._batcher is not None

    def set_mesh(self, descriptor: dict | None) -> None:
        """Record the current mesh context (``mesh_descriptor``); later
        first calls and step records carry its shape key."""
        with self._lock:
            self._mesh = descriptor

    def arm_loop(self, loop: asyncio.AbstractEventLoop | None = None) -> None:
        """Bind the loop wide events are delivered on when ``on_compile``
        fires off-loop (a profiler capture thread, the bench)."""
        self._loop = loop if loop is not None else asyncio.get_running_loop()

    def start(self) -> None:
        """Start the periodic memory sampler (from a running loop); also
        arms the event-delivery loop."""
        self.arm_loop()
        if self._sampler_task is None or self._sampler_task.done():
            self._sampler_task = asyncio.get_running_loop().create_task(
                self._sample_loop(), name="device-monitor-sampler"
            )

    def stop(self) -> None:
        if self._sampler_task is not None:
            self._sampler_task.cancel()
            self._sampler_task = None

    async def _sample_loop(self) -> None:
        while True:
            await asyncio.sleep(self._sample_interval_s)
            # off the loop: the CPU estimate walks every live object
            await asyncio.to_thread(self.sample_memory)

    # ----------------------------------------------------- compile hook

    def on_compile(
        self,
        name: str,
        *,
        signature: str,
        duration_ms: float,
        trigger: str,
    ) -> None:
        """A program ran at a new signature (TrackedJit calls this): one
        wide event, one counter increment and, when a request trace is
        active, one backdated ``xla.compile`` span, all naming the same
        trace id."""
        trace = current_trace()
        trace_id = request_id = None
        if trace is not None:
            duration_s = duration_ms / 1000.0
            s = trace.start_span(
                "xla.compile",
                parent_id=trace.root.span_id,
                attributes={
                    "function": name,
                    "signature": signature,
                    "trigger": trigger,
                },
            )
            # backdate: the call already happened (the wrapper timed it)
            s.start_mono -= duration_s
            s.start_unix -= duration_s
            trace.end_span(s)
            trace_id, request_id = trace.trace_id, trace.request_id
        with self._lock:
            self._compile_seq += 1
            self._compile_by_trigger[trigger] = (
                self._compile_by_trigger.get(trigger, 0) + 1
            )
            fn = self._functions.setdefault(
                name,
                {
                    "compiles": 0,
                    "triggers": {},
                    "signatures": [],
                    "last_compile_ms": None,
                },
            )
            fn["compiles"] += 1
            fn["triggers"][trigger] = fn["triggers"].get(trigger, 0) + 1
            if signature not in fn["signatures"]:
                fn["signatures"].append(signature)
            fn["last_compile_ms"] = duration_ms
            mesh_shape = self._mesh["shape"] if self._mesh else None
            record = {
                "seq": self._compile_seq,
                "ts": time.time(),
                "function": name,
                "signature": signature,
                "trigger": trigger,
                "duration_ms": duration_ms,
                "mesh": mesh_shape,
                "trace_id": trace_id,
            }
            self._compiles.append(record)
        if self._compile_total is not None:
            self._compile_total.inc(trigger=trigger)
        if self._compile_seconds is not None:
            # observed while the request's trace is still ambient, so the
            # exemplar names the same trace id as the event
            self._compile_seconds.observe(duration_ms / 1000.0)
        event: dict = {
            "kind": "compile",
            "name": "xla.compile",
            "outcome": "ok",
            "function": name,
            "signature": signature,
            "trigger": trigger,
            "duration_ms": duration_ms,
            "mesh": mesh_shape,
        }
        if trace_id is not None:
            event["trace_id"] = trace_id
        if request_id is not None:
            event["request_id"] = request_id
        self._emit(event)

    # -------------------------------------------------------- step hook

    def record_step(self, duration_ms: float, shape: str | None = None) -> None:
        """One batcher step finished under mesh shape ``shape`` (default:
        the attached mesh's key, else ``"1"``), aggregated per shape."""
        with self._lock:
            if shape is None:
                shape = self._mesh["shape"] if self._mesh else "1"
            agg = self._shapes.setdefault(
                shape,
                {
                    "steps": 0,
                    "total_ms": 0.0,
                    "min_ms": None,
                    "max_ms": 0.0,
                    "last_ms": 0.0,
                },
            )
            agg["steps"] += 1
            agg["total_ms"] += duration_ms
            agg["min_ms"] = (
                duration_ms
                if agg["min_ms"] is None
                else min(agg["min_ms"], duration_ms)
            )
            agg["max_ms"] = max(agg["max_ms"], duration_ms)
            agg["last_ms"] = duration_ms
        if self._step_seconds is not None:
            self._step_seconds.observe(duration_ms / 1000.0, mesh=shape)

    # ----------------------------------------------------- memory sampler

    def sample_memory(self) -> list[dict]:
        """One device-memory sample: every visible card's allocator counts
        when CUDA is available (a failure raises: a card never gets the
        estimate), else the CPU's live-tensor estimate. Registers the
        per-(device, kind) ``bci_device_hbm_bytes`` gauges on first
        sight."""
        rows: list[dict] = []
        if torch.cuda.is_available():
            for d in range(torch.cuda.device_count()):
                stats = torch.cuda.memory_stats(d)
                # an allocator that has not allocated yet reports no keys
                live = int(stats.get("allocated_bytes.all.current", 0))
                rows.append(
                    {
                        "device": f"gpu:{d}",
                        "platform": "gpu",
                        "live_bytes": live,
                        "peak_bytes": int(
                            stats.get("allocated_bytes.all.peak", live)
                        ),
                        "limit_bytes": int(torch.cuda.mem_get_info(d)[1]),
                        "estimated": False,
                    }
                )
        else:
            key = "cpu:0"
            live = _live_tensor_bytes()
            peak = max(self._peak_estimate.get(key, 0), live)
            self._peak_estimate[key] = peak
            rows.append(
                {
                    "device": key,
                    "platform": "cpu",
                    "live_bytes": live,
                    "peak_bytes": peak,
                    "limit_bytes": None,
                    "estimated": True,
                }
            )
        with self._lock:
            self._memory = rows
            self._memory_unix = time.time()
            self._memory_samples += 1
        if self._metrics is not None:
            for row in rows:
                for kind in ("live", "peak", "limit"):
                    gauge_key = (row["device"], kind)
                    if gauge_key in self._gauged:
                        continue
                    self._gauged.add(gauge_key)
                    self._metrics.gauge(
                        "bci_device_hbm_bytes",
                        "Device memory bytes by kind (live|peak|limit); "
                        "live-buffer estimate on backends without "
                        "memory_stats",
                        (
                            lambda d=row["device"], k=kind: float(
                                self._memory_value(d, k)
                            )
                        ),
                        device=row["device"],
                        kind=kind,
                    )
        return rows

    def _memory_value(self, device: str, kind: str) -> int:
        with self._lock:
            for row in self._memory:
                if row["device"] == device:
                    value = row.get(f"{kind}_bytes")
                    return int(value) if value is not None else 0
        return 0

    # ------------------------------------------------------------ queries

    def snapshot(self, recent: int = 16) -> dict:
        """The ``GET /v1/accelerator`` body: first-call totals, the
        per-function ledgers and the last ``recent`` records, the latest
        memory sample, the attached batcher's KV-pool telemetry, the mesh
        descriptor and the per-shape step aggregates. Host bookkeeping
        only."""
        with self._lock:
            functions = {
                name: {
                    "compiles": fn["compiles"],
                    "triggers": dict(fn["triggers"]),
                    "signatures": list(fn["signatures"]),
                    "last_compile_ms": fn["last_compile_ms"],
                }
                for name, fn in self._functions.items()
            }
            memory_rows = [dict(row) for row in self._memory]
            body: dict = {
                "attached": self._batcher is not None,
                "compile": {
                    "total": self._compile_seq,
                    "by_trigger": dict(self._compile_by_trigger),
                    "functions": functions,
                    "recent": (
                        list(self._compiles)[-recent:] if recent > 0 else []
                    ),
                },
                "memory": {
                    "sampled_unix": self._memory_unix,
                    "samples": self._memory_samples,
                    "estimated": (
                        any(row["estimated"] for row in memory_rows)
                        if memory_rows
                        else None
                    ),
                    "devices": memory_rows,
                },
                "mesh": dict(self._mesh) if self._mesh else None,
                "steps": {
                    "by_shape": {
                        shape: dict(agg)
                        for shape, agg in self._shapes.items()
                    }
                },
            }
        body["kv_pool"] = (
            self._batcher.kv_telemetry() if self._batcher is not None else None
        )
        return body

    def fleet_summary(self) -> dict:
        """The compact ``accelerator`` section a fleet router reads: first
        calls, retraces, mesh shape and memory headroom."""
        with self._lock:
            limits = [
                row["limit_bytes"]
                for row in self._memory
                if row["limit_bytes"] is not None
            ]
            return {
                "compiles": self._compile_seq,
                "retraces": self._compile_by_trigger.get("retrace", 0),
                "mesh": self._mesh["shape"] if self._mesh else None,
                "hbm": {
                    "live_bytes": sum(
                        row["live_bytes"] for row in self._memory
                    ),
                    "limit_bytes": sum(limits) if limits else None,
                    "estimated": (
                        any(row["estimated"] for row in self._memory)
                        if self._memory
                        else None
                    ),
                },
            }

    # ------------------------------------------------------------ private

    def _emit(self, event: dict) -> None:
        if self._recorder is None:
            return
        try:
            # remember the loop whenever one is running here, so first calls
            # that later fire off-loop know where to deliver
            self._loop = asyncio.get_running_loop()
        except RuntimeError:
            # off-loop caller: hand the event to the recorder's loop, whose
            # follower queues a foreign thread must not poke directly
            loop = self._loop
            if loop is not None and loop.is_running():
                loop.call_soon_threadsafe(self._recorder.record, event)
                return
            # no loop was ever armed: nothing async can be following the
            # recorder, so the direct call only touches the ring
        self._recorder.record(event)
