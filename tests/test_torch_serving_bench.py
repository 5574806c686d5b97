"""The port's ``run_serving_bench`` against the JAX package's: the same
returned keys with the same types and the same workload fields on a tiny run
on the CPU, JAX's weights carried across decode the tokens the JAX engine
decodes, and the guards raise when the arms decode different tokens or a
pass drifts. The overhead bound is computed, not asserted (a tiny model's
CPU step is a far harsher denominator than a real one), as in the JAX
package's test."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from bee_code_interpreter_tpu.models import engine as jax_engine
from bee_code_interpreter_tpu.models import serving as jax_serving
from bee_code_interpreter_tpu.models import transformer as jax_t
from bee_code_interpreter_tpu.models.serving_bench import (
    run_serving_bench as jax_bench,
)
from bee_code_interpreter_tpu_torch.models import engine as torch_engine
from bee_code_interpreter_tpu_torch.models import transformer as torch_t
from bee_code_interpreter_tpu_torch.models.serving_bench import (
    run_serving_bench,
)
from bee_code_interpreter_tpu_torch.weights import params_from_jax

TINY_RUN = dict(n_requests=2, max_new_tokens=8, repeats=2, inner=1,
                max_batch=2)


def test_bench_returns_the_jax_keys_and_types():
    want = jax_bench(**TINY_RUN)
    got = run_serving_bench(device="cpu", **TINY_RUN)
    assert {k: type(v) for k, v in got.items()} == {
        k: type(v) for k, v in want.items()
    }
    for key in ("overhead_budget_pct", "requests", "max_new_tokens",
                "repeats", "config"):
        assert got[key] == want[key], key
    assert got["tokens_per_s"] > 0 and got["uninstrumented_tokens_per_s"] > 0
    assert got["overhead_pct"] >= 0.0
    assert got["overhead_ok"] == (
        got["overhead_pct"] < got["overhead_budget_pct"]
    )
    assert got["ttft_p95_ms"] >= got["ttft_p50_ms"] > 0
    assert got["inter_token_p50_ms"] > 0


def test_bench_on_jax_weights_decodes_the_jax_engines_tokens(monkeypatch):
    """The bench's default model (tiny, f32, seed 0) in JAX, carried into
    the port by ``params_from_jax``: every pass of both arms decodes what
    the JAX engine decodes on the bench's prompts; the instrumented arm's
    monitors saw every request and step."""
    jcfg = dataclasses.replace(jax_t.TransformerConfig.tiny(),
                               dtype=jax.numpy.float32)
    tcfg = dataclasses.replace(torch_t.TransformerConfig.tiny(),
                               dtype=torch.float32)
    jparams = jax_t.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    n, new, plen = 3, 6, 6
    prompts = [np.random.default_rng(i).integers(
        0, jcfg.vocab_size, plen + i % 3, dtype=np.int32) for i in range(n)]
    pages = -(-(plen + 2 + new) // 4)
    jengine = jax_engine.Engine(jax_serving.ContinuousBatcher(
        jparams, jcfg, max_batch=2, n_pages=1 + 2 * pages, page_size=4,
        max_pages_per_seq=pages))
    tickets = [jengine.submit(p, new) for p in prompts]
    jengine.run_to_completion()
    want = [jengine.result(t) for t in tickets]

    seen = []
    result = torch_engine.Engine.result

    def spy(self, ticket):
        out = result(self, ticket)
        seen.append(out)
        return out

    monkeypatch.setattr(torch_engine.Engine, "result", spy)
    instruments = {}
    out = run_serving_bench(
        n_requests=n, max_new_tokens=new, repeats=2, inner=1, max_batch=2,
        prompt_len=plen, config=tcfg, params=tparams, device="cpu",
        instruments=instruments,
    )
    passes = 2 + 2 * 2  # a warm-up per arm, then repeats x inner x 2 arms
    assert len(seen) == passes * n
    assert all(seen[i:i + n] == want for i in range(0, len(seen), n))
    assert out["config"] == "tiny f32, greedy, paged pool"
    requests = instruments["serving_monitor"].requests(outcome="ok")
    assert len(requests) == (passes // 2) * n
    snap = instruments["device_monitor"].snapshot()
    assert snap["compile"]["by_trigger"] == {"first_call": 2}  # one shape
    steps = instruments["registry"].metrics["bci_serving_step_seconds"]
    assert steps._totals[()] == snap["steps"]["by_shape"]["1"]["steps"] > 0


def test_bench_raises_when_the_arms_or_passes_differ(monkeypatch):
    result = torch_engine.Engine.result

    def instrumented_differs(self, ticket):
        out = result(self, ticket)
        return out + [0] if self._metrics is not None else out

    monkeypatch.setattr(torch_engine.Engine, "result", instrumented_differs)
    with pytest.raises(RuntimeError, match="decoded different tokens"):
        run_serving_bench(device="cpu", **TINY_RUN)

    calls = [0]

    def drifting(self, ticket):
        calls[0] += 1
        out = result(self, ticket)
        # the warm-up passes read 2 x n_requests results; later ones drift
        return out + [0] if calls[0] > 4 else out

    monkeypatch.setattr(torch_engine.Engine, "result", drifting)
    with pytest.raises(RuntimeError, match="drifted"):
        run_serving_bench(device="cpu", **TINY_RUN)


def test_bench_refuses_a_config_without_params():
    with pytest.raises(ValueError, match="together"):
        run_serving_bench(device="cpu",
                          config=torch_t.TransformerConfig.tiny(),
                          **TINY_RUN)
