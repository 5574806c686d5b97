"""Dependency-free Prometheus-style metrics: the port's copy of
``bee_code_interpreter_tpu/utils/metrics.py``.

The same counters, gauges and histograms, the same text exposition (classic
Prometheus and OpenMetrics 1.0 with exemplars) and the same label
cardinality guard, so a registry filled by the port's batcher and monitors
reads exactly as one filled by the JAX package's. Exemplars read the ambient
trace of the port's own ``observability.tracing``.
"""

from __future__ import annotations

import time
from bisect import bisect_left
from collections import defaultdict
from typing import Callable, Iterable

# Latency buckets (seconds) spanning a warm local exec (~50ms) through a cold
# TPU pod spawn (~60s, reference kubernetes_code_executor.py:239-241).
DEFAULT_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

# Token-cadence buckets (seconds) for the serving engine: TTFT and
# inter-token latency live in the 1ms-10s decade, far below request buckets.
TOKEN_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0,
)

# The Prometheus text exposition format scrapers negotiate on; a bare
# ``text/plain`` makes version-aware scrapers fall back to heuristics.
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# OpenMetrics 1.0: what a scraper sends in ``Accept`` to opt in, and what the
# endpoint answers with. Only this format carries exemplars.
OPENMETRICS_MEDIA_TYPE = "application/openmetrics-text"
OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)

def accepts_openmetrics(accept_header: str) -> bool:
    """True when the ``Accept`` header asks for the OpenMetrics exposition.
    A bare substring test would serve OpenMetrics to a client that sent
    ``application/openmetrics-text;q=0`` (RFC 9110: q=0 means "not
    acceptable"), so the media-range's q-value is honored."""
    for entry in accept_header.split(","):
        media_type, _, params = entry.strip().partition(";")
        if media_type.strip().lower() != OPENMETRICS_MEDIA_TYPE:
            continue
        q = 1.0
        for param in params.split(";"):
            name, _, value = param.strip().partition("=")
            if name.strip().lower() == "q":
                try:
                    q = float(value.strip())
                except ValueError:
                    q = 0.0  # malformed quality → treat as refused
        if q > 0.0:
            return True
    return False


# Resolved lazily on the first traced observation: utils must not import the
# observability package at module load (observability wires *into* metrics,
# not the other way around), but exemplars need the ambient trace ids.
_exemplar_ids: Callable[[], tuple[str, str]] | None = None


def _active_trace_ids() -> tuple[str, str] | None:
    """(trace_id, span_id) of the ambient trace, or None when no trace is
    active (or tracing is unavailable) — the exemplar hook, shaped to never
    raise on the observation hot path."""
    global _exemplar_ids
    if _exemplar_ids is None:
        try:
            from bee_code_interpreter_tpu_torch.observability.tracing import (
                current_ids,
            )
        except Exception:
            return None
        _exemplar_ids = current_ids
    trace_id, span_id = _exemplar_ids()
    if trace_id == "-":
        return None
    return trace_id, span_id


def _escape(value: str) -> str:
    # Prometheus exposition label-value escaping: backslash, quote, newline.
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_num(value: float) -> str:
    # %g rounds to 6 significant digits, visibly corrupting counters past 1e6;
    # emit integers exactly and floats at full precision like prometheus_client.
    if float(value).is_integer() and abs(value) < 2**53:
        return str(int(value))
    return repr(float(value))


class Counter:
    def __init__(self, name: str, help_text: str) -> None:
        self.name, self.help = name, help_text
        self._values: dict[tuple, float] = defaultdict(float)
        # Registry-installed label-cardinality clamp (None for bare metrics).
        self._clamp: Callable[[dict], dict] | None = None

    def inc(self, value: float = 1.0, **labels: str) -> None:
        if self._clamp is not None and labels:
            labels = self._clamp(labels)
        self._values[tuple(sorted(labels.items()))] += value

    def collect(self, openmetrics: bool = False) -> Iterable[str]:
        # OpenMetrics names the counter *family* without the _total suffix;
        # the sample keeps it. The classic format uses the full name both
        # places — scrapers of each format expect exactly their spelling.
        family = (
            self.name[: -len("_total")]
            if openmetrics and self.name.endswith("_total")
            else self.name
        )
        yield f"# HELP {family} {self.help}"
        yield f"# TYPE {family} counter"
        for key, v in sorted(self._values.items()):
            yield f"{self.name}{_fmt_labels(dict(key))} {_fmt_num(v)}"


class Gauge:
    """Gauges read from callbacks at scrape time (pool sizes, queue depths,
    breaker states). One ``Gauge`` object per metric name; each label set
    maps to its own callback (e.g. ``bci_breaker_state{breaker="k8s-spawn"}``).

    A raising callback — a pool property read during executor teardown, say —
    must never abort the whole ``/metrics`` exposition: the failure is
    contained to that one sample, emitted as ``NaN``."""

    def __init__(self, name: str, help_text: str) -> None:
        self.name, self.help = name, help_text
        self._fns: dict[tuple, Callable[[], float]] = {}
        self._clamp: Callable[[dict], dict] | None = None

    def set_fn(self, fn: Callable[[], float], **labels: str) -> None:
        if self._clamp is not None and labels:
            labels = self._clamp(labels)
        self._fns[tuple(sorted(labels.items()))] = fn

    def collect(self, openmetrics: bool = False) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} gauge"
        for key, fn in sorted(self._fns.items()):
            try:
                value = _fmt_num(fn())
            except Exception:
                value = "NaN"
            yield f"{self.name}{_fmt_labels(dict(key))} {value}"


class Histogram:
    def __init__(
        self, name: str, help_text: str, buckets: tuple[float, ...] = DEFAULT_BUCKETS
    ) -> None:
        self.name, self.help = name, help_text
        self._buckets = tuple(sorted(buckets))
        # PER-BUCKET (non-cumulative) counts, one overflow-free list per
        # label set; the Prometheus-cumulative view is produced at collect
        # time. observe() is the serving hot path (called per batcher step
        # and per token-latency sample): a bisect + one increment beats
        # walking every bucket bound per observation ~10x in-loop.
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = defaultdict(float)
        self._totals: dict[tuple, int] = defaultdict(int)
        # label key -> le string -> (value, trace_id, span_id, unix_ts): the
        # most recent traced observation per bucket, exposed as an
        # OpenMetrics exemplar so a dashboard can jump spike -> trace.
        self._exemplars: dict[tuple, dict[str, tuple[float, str, str, float]]] = {}
        self._clamp: Callable[[dict], dict] | None = None

    def observe(self, value: float, **labels: str) -> None:
        if self._clamp is not None and labels:
            labels = self._clamp(labels)
        key = tuple(sorted(labels.items())) if labels else ()
        counts = self._counts.get(key)
        if counts is None:
            counts = self._counts.setdefault(key, [0] * len(self._buckets))
        # first bucket whose bound >= value (le semantics); == len(buckets)
        # means only the implicit +Inf bucket catches it
        idx = bisect_left(self._buckets, value)
        if idx < len(counts):
            counts[idx] += 1
        self._sums[key] += value
        self._totals[key] += 1
        ids = _active_trace_ids()
        if ids is not None:
            exemplar_le = (
                f"{self._buckets[idx]:g}" if idx < len(counts) else "+Inf"
            )
            self._exemplars.setdefault(key, {})[exemplar_le] = (
                value, ids[0], ids[1], time.time(),
            )

    def per_bucket_counts(self, key: tuple) -> list[int]:
        """Non-cumulative per-bucket counts for one label set, with the
        overflow (+Inf) bucket appended — the shape OTLP wants."""
        counts = self._counts.get(key, [0] * len(self._buckets))
        return [*counts, self._totals[key] - sum(counts)]

    def time(self, **labels: str) -> "_Timer":
        return _Timer(self, labels)

    def _exemplar_suffix(self, key: tuple, le: str) -> str:
        ex = self._exemplars.get(key, {}).get(le)
        if ex is None:
            return ""
        value, trace_id, span_id, ts = ex
        return (
            f' # {{trace_id="{trace_id}",span_id="{span_id}"}}'
            f" {_fmt_num(value)} {ts:.3f}"
        )

    def collect(self, openmetrics: bool = False) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} histogram"
        for key in sorted(self._totals):
            base = dict(key)
            counts = self._counts.get(key, [0] * len(self._buckets))
            cumulative = 0
            for bound, c in zip(self._buckets, counts):
                cumulative += c
                le = f"{bound:g}"
                yield (
                    f"{self.name}_bucket"
                    f"{_fmt_labels({**base, 'le': le})} {cumulative}"
                    + (self._exemplar_suffix(key, le) if openmetrics else "")
                )
            yield (
                f"{self.name}_bucket{_fmt_labels({**base, 'le': '+Inf'})} "
                f"{self._totals[key]}"
                + (self._exemplar_suffix(key, "+Inf") if openmetrics else "")
            )
            yield f"{self.name}_sum{_fmt_labels(base)} {_fmt_num(self._sums[key])}"
            yield f"{self.name}_count{_fmt_labels(base)} {self._totals[key]}"


class _Timer:
    def __init__(self, hist: Histogram, labels: dict[str, str]) -> None:
        self._hist, self._labels = hist, labels

    def __enter__(self) -> "_Timer":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self._hist.observe(time.monotonic() - self._t0, **self._labels)


# Labels whose VALUES are client-influenced get a cardinality bound by
# default in every registry: the tenant label is stamped from (bounded)
# resolved ids, but defense in depth means even a buggy caller passing raw
# ids cannot OOM /metrics.
DEFAULT_LABEL_BOUNDS = {"tenant": 32}


class Registry:
    """Metrics are deduplicated by name: asking twice for the same counter
    (e.g. two components sharing ``bci_breaker_transitions_total``) returns
    the same object, so the exposition never emits duplicate metric blocks.

    Label-cardinality guard (docs/tenancy.md "Cardinality"): labels
    registered via :meth:`bound_label` (the ``tenant`` label by default,
    ``APP_METRICS_MAX_TENANT_LABELS``) admit at most N distinct values;
    further values collapse into ``other`` and every collapsed observation
    is counted in ``bci_metrics_label_overflow_total{label}`` — a
    tenant-id flood can widen one bucket, never the exposition."""

    def __init__(self) -> None:
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._label_bounds: dict[str, int] = dict(DEFAULT_LABEL_BOUNDS)
        self._label_seen: dict[str, set[str]] = {}
        self._label_overflow_total = self.counter(
            "bci_metrics_label_overflow_total",
            "Observations whose bounded label value collapsed into 'other' "
            "(cardinality guard), by label name",
        )

    def bound_label(self, label: str, limit: int) -> None:
        """(Re)bound a label's distinct-value budget; existing seen values
        keep their series, new ones past the limit collapse to 'other'."""
        self._label_bounds[label] = max(1, limit)

    def _clamp_labels(self, labels: dict) -> dict:
        clamped = None
        for name, limit in self._label_bounds.items():
            value = labels.get(name)
            if value is None or value == "other":
                continue
            seen = self._label_seen.setdefault(name, set())
            if value in seen:
                continue
            if len(seen) < limit:
                seen.add(value)
                continue
            if clamped is None:
                clamped = dict(labels)
            clamped[name] = "other"
            self._label_overflow_total.inc(label=name)
        return labels if clamped is None else clamped

    @property
    def metrics(self) -> dict[str, "Counter | Gauge | Histogram"]:
        """Read-only view of registered metrics by name (conventions lint,
        introspection)."""
        return dict(self._metrics)

    def _get_or_create(self, name: str, kind: type, factory):
        existing = self._metrics.get(name)
        if existing is not None:
            if not isinstance(existing, kind):
                # Same name, different type: the exposition would emit one
                # block with the wrong TYPE for half its users — a silent
                # data bug. Fail at registration, where the blame is local.
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(existing).__name__}, requested {kind.__name__}"
                )
            return existing
        m = factory()
        # Registry-owned metrics share the cardinality clamp; the overflow
        # counter itself stays clamp-free (its label values are label
        # NAMES, inherently bounded — and exempting it forecloses any
        # clamp→overflow→clamp recursion).
        if name != "bci_metrics_label_overflow_total":
            m._clamp = self._clamp_labels
        self._metrics[name] = m
        return m

    def counter(self, name: str, help_text: str) -> Counter:
        return self._get_or_create(name, Counter, lambda: Counter(name, help_text))

    def gauge(
        self, name: str, help_text: str, fn: Callable[[], float], **labels: str
    ) -> Gauge:
        m = self._get_or_create(name, Gauge, lambda: Gauge(name, help_text))
        m.set_fn(fn, **labels)
        return m

    def histogram(
        self, name: str, help_text: str, buckets: tuple[float, ...] = DEFAULT_BUCKETS
    ) -> Histogram:
        return self._get_or_create(
            name, Histogram, lambda: Histogram(name, help_text, buckets)
        )

    def expose(self, openmetrics: bool = False) -> str:
        lines: list[str] = []
        for m in self._metrics.values():
            try:
                lines.extend(m.collect(openmetrics=openmetrics))
            except Exception:
                # One misbehaving metric must not take down the whole scrape.
                lines.append(f"# {m.name} failed to collect")
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"
