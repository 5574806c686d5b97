"""Serving bench: tokens/s and TTFT with an instrumentation A/B, the port's
counterpart of ``bee_code_interpreter_tpu/models/serving_bench.py``.

The same arithmetic as the JAX bench, as library code a benchmark script, a
smoke run on the card and a CPU test all call:

- **Throughput**: steady-state tokens/s of a continuous-batching run, after
  a warm-up pass of each arm (the first calls of every program happen
  there), on two arms: one with the whole observability stack attached
  (metrics registry, ServingMonitor, DeviceMonitor: the production wiring)
  and one bare. The arms alternate round by round; each round takes the
  best of ``inner`` passes per arm. Throughput is each arm's best pass; the
  overhead is the median of the rounds' instrumented/bare time ratios (the
  first dropped when 3 or more remain), since a pair adjacent in time sees
  the same machine state.
- **Latency**: TTFT p50/p95 and the inter-token p50 from the instrumented
  arm's per-request lifecycle records (``requests(outcome="ok")``).

The workload is deterministic (seeded prompts, greedy or per-request seeded
sampling), so both arms decode the same tokens; the bench raises when they
do not, or when an arm's tokens drift between passes. Every request is
submitted at t=0: TTFT includes the queueing of a full batch's admissions.
By default the model is the tiny config in f32 with random weights from
seed 0; ``config``/``params`` run another model, and ``device`` resolves as
every entry point of the port does (the card unless the CPU is asked for).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from bee_code_interpreter_tpu_torch.device import resolve_device


def _percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile on a small sample (q in [0, 1])."""
    ordered = sorted(values)
    idx = min(len(ordered) - 1, max(0, round(q * (len(ordered) - 1))))
    return ordered[idx]


def run_serving_bench(
    n_requests: int = 8,
    max_new_tokens: int = 64,
    repeats: int = 7,
    prompt_len: int = 6,
    max_batch: int = 8,
    overhead_budget_pct: float = 5.0,
    inner: int = 2,
    temperature: float = 0.0,
    *,
    page_size: int = 4,
    config=None,
    params=None,
    device: torch.device | str | None = None,
    instruments: dict | None = None,
) -> dict:
    """One serving bench run; returns the JAX bench's dict. Prompt ``i`` has
    ``prompt_len + i % 3`` tokens from numpy seed ``i``; ``temperature`` > 0
    samples, each request from its own seed. ``params`` must live on
    ``device`` and match ``config`` (given together, or neither: the tiny
    f32 model). ``instruments``, when given, is filled with the
    instrumented arm's ``registry``, ``serving_monitor`` and
    ``device_monitor``, and both arms' ``engines`` (bare, instrumented)."""
    from bee_code_interpreter_tpu_torch.models import transformer as T
    from bee_code_interpreter_tpu_torch.models.engine import Engine
    from bee_code_interpreter_tpu_torch.models.serving import (
        ContinuousBatcher,
        SamplingParams,
    )
    from bee_code_interpreter_tpu_torch.observability import (
        DeviceMonitor,
        FlightRecorder,
        ServingMonitor,
        TraceStore,
    )
    from bee_code_interpreter_tpu_torch.utils.metrics import Registry

    if (config is None) != (params is None):
        raise ValueError("pass config and params together, or neither")
    dev = resolve_device(device)
    if config is None:
        config = dataclasses.replace(
            T.TransformerConfig.tiny(), dtype=torch.float32
        )
        params = T.init_params(
            config, torch.Generator(device=dev).manual_seed(0), device=dev
        )
    prompts = [
        np.random.default_rng(i).integers(
            0, config.vocab_size, prompt_len + (i % 3), dtype=np.int32
        )
        for i in range(n_requests)
    ]
    pages_per_seq = -(-(prompt_len + 2 + max_new_tokens) // page_size)
    geometry = dict(
        max_batch=max_batch,
        n_pages=1 + max_batch * pages_per_seq,
        page_size=page_size,
        max_pages_per_seq=pages_per_seq,
        device=dev,
    )

    def build(instrumented: bool):
        if instrumented:
            registry = Registry()
            recorder = FlightRecorder(metrics=registry)
            monitor = ServingMonitor(
                metrics=registry, store=TraceStore(), recorder=recorder
            )
            batcher = ContinuousBatcher(
                params, config, metrics=registry, **geometry
            )
            engine = Engine(batcher, metrics=registry)
            monitor.attach(engine)
            # the device monitor rides the instrumented arm too: the
            # overhead prices first-call tracking and step telemetry
            device_monitor = DeviceMonitor(metrics=registry, recorder=recorder)
            device_monitor.attach(engine)
            if instruments is not None:
                instruments.update(
                    registry=registry, serving_monitor=monitor,
                    device_monitor=device_monitor,
                )
            return engine, monitor
        return Engine(ContinuousBatcher(params, config, **geometry)), None

    sampling = [
        SamplingParams(temperature=temperature, seed=100 + i)
        if temperature > 0.0
        else None
        for i in range(n_requests)
    ]

    def run_once(engine) -> tuple[float, list[list[int]]]:
        t0 = time.perf_counter()
        tickets = [
            engine.submit(p, max_new_tokens, sampling=s)
            for p, s in zip(prompts, sampling)
        ]
        # every step ends in the host read of its tokens, so the last one
        # waited for the device
        engine.run_to_completion()
        dt = time.perf_counter() - t0
        outputs = []
        for ticket in tickets:
            outputs.append(engine.result(ticket))
            engine.release(ticket)
        return dt, outputs

    engines: dict[bool, object] = {}
    monitors: dict[bool, object] = {}
    want: dict[bool, list] = {}
    best: dict[bool, float] = {False: float("inf"), True: float("inf")}
    for instrumented in (False, True):
        engines[instrumented], monitors[instrumented] = build(instrumented)
        _, want[instrumented] = run_once(engines[instrumented])  # warm-up
    if instruments is not None:
        instruments["engines"] = (engines[False], engines[True])
    if want[False] != want[True]:
        raise RuntimeError(
            "instrumented and bare arms decoded different tokens"
        )
    tokens = sum(len(o) for o in want[True])
    ratios: list[float] = []
    for _ in range(max(1, repeats)):
        round_dt: dict[bool, float] = {}
        for instrumented in (False, True):  # alternating (see docstring)
            round_best = float("inf")
            for _inner in range(max(1, inner)):
                dt, outputs = run_once(engines[instrumented])
                if outputs != want[instrumented]:
                    raise RuntimeError(
                        "serving bench outputs drifted between passes"
                    )
                round_best = min(round_best, dt)
            best[instrumented] = min(best[instrumented], round_best)
            round_dt[instrumented] = round_best
        ratios.append(round_dt[True] / round_dt[False])

    on_tps = tokens / best[True]
    off_tps = tokens / best[False]
    # the first measured round still rides the machine's warm-up (clocks,
    # caches) disproportionately often: drop its ratio when enough rounds
    # remain for a median
    if len(ratios) >= 3:
        ratios = ratios[1:]
    overhead_pct = max(0.0, (_percentile(ratios, 0.50) - 1.0) * 100.0)

    # latency from the instrumented arm's lifecycle records (warm-up and
    # every pass: more samples of the same path)
    records = monitors[True].requests(outcome="ok")
    ttft_ms = [r["ttft_ms"] for r in records if r["ttft_ms"] is not None]
    itl_ms = [
        (r["duration_ms"] - r["ttft_ms"]) / (r["output_tokens"] - 1)
        for r in records
        if r["ttft_ms"] is not None
        and r["duration_ms"] is not None
        and r["output_tokens"] > 1
    ]
    dtype = str(config.dtype).removeprefix("torch.")
    model = (
        "tiny f32" if config == dataclasses.replace(
            T.TransformerConfig.tiny(), dtype=torch.float32)
        else f"{config.n_layers} layers d_model {config.d_model} {dtype}"
    )
    return {
        "tokens_per_s": round(on_tps, 1),
        "uninstrumented_tokens_per_s": round(off_tps, 1),
        "overhead_pct": round(overhead_pct, 2),
        "overhead_budget_pct": overhead_budget_pct,
        "overhead_ok": overhead_pct < overhead_budget_pct,
        "ttft_p50_ms": round(_percentile(ttft_ms, 0.50), 3) if ttft_ms else None,
        "ttft_p95_ms": round(_percentile(ttft_ms, 0.95), 3) if ttft_ms else None,
        "inter_token_p50_ms": (
            round(_percentile(itl_ms, 0.50), 3) if itl_ms else None
        ),
        "requests": n_requests,
        "max_new_tokens": max_new_tokens,
        "repeats": repeats,
        "config": (
            model + ", "
            + (f"sampled T={temperature}" if temperature > 0.0 else "greedy")
            + ", paged pool"
        ),
    }
