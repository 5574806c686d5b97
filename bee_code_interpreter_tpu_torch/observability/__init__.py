"""Observability of the port's serving engine: the JAX package's serving
and accelerator observability, copied or re-founded on PyTorch.

- ``tracing``: request traces on contextvars and their bounded store;
- ``flightrecorder``: the wide-event ring;
- ``serving_trace``: ``ServingMonitor``, per-request lifecycle traces, step
  records and KV-cache telemetry of a batcher or engine;
- ``device``: ``DeviceMonitor``, first calls of the batcher's programs,
  ``torch.cuda`` memory and per-mesh-shape step telemetry;
- ``profiling``: ``torch.profiler`` captures of serving steps or a probe.

The monitors are duck-typed from ``models/``, which never imports this
package. The metrics registry they publish into is ``utils/metrics.py``.
"""

from bee_code_interpreter_tpu_torch.observability.device import (
    COMPILE_SECONDS_BUCKETS,
    DeviceMonitor,
    mesh_descriptor,
    mesh_shape_key,
)
from bee_code_interpreter_tpu_torch.observability.flightrecorder import (
    FlightRecorder,
    event_matches,
    register_stream_metrics,
)
from bee_code_interpreter_tpu_torch.observability.profiling import (
    DeviceProfiler,
    ProfilerUnavailable,
    ServingProfiler,
)
from bee_code_interpreter_tpu_torch.observability.serving_trace import (
    ServingMonitor,
)
from bee_code_interpreter_tpu_torch.observability.tracing import (
    Span,
    Trace,
    TraceStore,
    activate_trace,
    current_ids,
    current_span,
    current_trace,
)

__all__ = [
    "COMPILE_SECONDS_BUCKETS",
    "DeviceMonitor",
    "DeviceProfiler",
    "FlightRecorder",
    "ProfilerUnavailable",
    "ServingMonitor",
    "ServingProfiler",
    "Span",
    "Trace",
    "TraceStore",
    "activate_trace",
    "current_ids",
    "current_span",
    "current_trace",
    "event_matches",
    "mesh_descriptor",
    "mesh_shape_key",
    "register_stream_metrics",
]
