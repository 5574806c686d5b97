"""The port's Ulysses sequence parallelism (``parallel/ulysses.py``)
against the JAX package's.

Four ranks (gloo on the CPU, one spawn for the file) run
``tests/torch_sp_worker.py::ulysses_cases``: every case through
``ulysses_attention_sharded`` on an ``{"sp": 4}`` mesh, then the
decoder's ``forward`` on an sp=2 x tp=2 mesh under ring and under Ulysses.
The JAX side runs the same numpy inputs on the 8 virtual CPU devices.
Checklist: the forward cases of the JAX package's tests/test_ulysses.py
(causal and not, windows, ``use_flash``, GQA-compact K/V, fewer K/V heads
than sp, the ``lcm(KVH, sp)`` broadcast, the head-divisibility error, the
model-level ring/Ulysses switch), and the rank-level exchange under grad
mode; ``test_grad_flows`` is tests/test_torch_sp_backward.py's.

Tolerances: 2e-5 for the attention cases (JAX's own: the exchange moves
values exactly, the local attention is dense f32), 2e-4 for the
decoder's logits (two layers of f32 through two sequence-parallel
strategies and JAX's dp x sp x tp mesh, JAX's own bound for the switch).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bee_code_interpreter_tpu.models import transformer as jax_t
from bee_code_interpreter_tpu.parallel.mesh import make_mesh
from bee_code_interpreter_tpu.parallel.ring_attention import (
    reference_attention,
)
from bee_code_interpreter_tpu.parallel.ulysses import (
    ulysses_attention_sharded,
)
from bee_code_interpreter_tpu_torch.parallel import spawn
from tests import torch_sp_worker as W
from tests.torch_sp_worker import case, qkv

SP = 4
TOL, FORWARD_TOL = 2e-5, 2e-4

CASES = {
    # test_ulysses.py:22
    **{f"causal_{c}": case(10, (2, 4, 4, 64, 16), causal=c)
       for c in (True, False)},
    # :32, global positions equal local ones after the gather
    **{f"window_{w}": case(11, (1, 4, 4, 64, 16), causal=True, window=w)
       for w in (4, 24, 100)},
    # :43, use_flash=True forces the flash kernel's wrapper
    "use_flash": case(12, (2, 4, 4, 64, 16), causal=True, use_flash=True),
    # :56, KVH divides sp: compact K/V through the exchange
    "gqa_compact": case(13, (1, 8, 4, 64, 16), causal=True),
    # :72, KVH < sp: broadcast up first
    "gqa_fewer_kv_heads": case(14, (1, 4, 2, 32, 8), causal=True),
    # :145, H=8 over KVH=2 at sp=4: lcm(2, 4) = 4 heads, group-major kept
    "gqa_lcm": case(15, (1, 8, 2, 64, 16), causal=True),
    # :105, sp must divide the query heads
    "heads_must_divide": {**qkv(16, 1, 2, 2, 32, 8), "expect_error": True,
                          "kw": {}},
}


def forward_config():
    return dataclasses.replace(jax_t.TransformerConfig.tiny(),
                               dtype=jnp.float32, n_kv_heads=2)


@pytest.fixture(scope="module")
def forward_inputs():
    params = jax_t.init_params(forward_config(), jax.random.PRNGKey(0))
    return {"jax_params": params,
            "params": jax.tree.map(np.asarray, params),
            "tokens": np.random.default_rng(17).integers(0, 256, (4, 32))}


@pytest.fixture(scope="module")
def ranks(forward_inputs):
    payload = {k: v for k, v in forward_inputs.items() if k != "jax_params"}
    return spawn(W.ulysses_cases, SP, device_type="cpu",
                 args=(CASES, payload), timeout=300)


def jax_ulysses(c):
    mesh = make_mesh({"sp": SP})
    q, k, v = (jnp.asarray(c[n]) for n in ("q", "k", "v"))
    return ulysses_attention_sharded(mesh, q, k, v, **c["kw"])


OUTPUT_CASES = [n for n, c in CASES.items() if not c.get("expect_error")]


@pytest.mark.parametrize("name", OUTPUT_CASES)
def test_ulysses_matches_jax_and_reference(ranks, name):
    c = CASES[name]
    want = np.asarray(jax_ulysses(c))
    kw = {n: c["kw"][n] for n in ("causal", "window") if n in c["kw"]}
    ref = np.asarray(reference_attention(
        *(jnp.asarray(c[n]) for n in ("q", "k", "v")), **kw))
    for rec in ranks:
        got = rec[name]["out"]
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(got, ranks[0][name]["out"])


def test_heads_must_divide_sp(ranks):
    with pytest.raises(ValueError, match="must divide n_heads") as err:
        jax_ulysses(CASES["heads_must_divide"])
    for rec in ranks:
        assert rec["heads_must_divide"] == ("ValueError", str(err.value))


def test_forward_ulysses_matches_ring_and_jax(ranks, forward_inputs):
    """test_ulysses.py:113: ring and Ulysses give the same logits on an
    sp=2 x tp=2 mesh, and each rank's block of positions equals JAX's
    forward on its dp x sp x tp mesh."""
    cfg = forward_config()
    mesh = make_mesh({"dp": 2, "sp": 2, "tp": 2})
    params = jax_t.shard_params(forward_inputs["jax_params"], cfg, mesh)
    tokens = jnp.asarray(forward_inputs["tokens"])
    want = {name: np.asarray(jax_t.forward(
                params, tokens, dataclasses.replace(cfg, sp_attention=name),
                mesh))
            for name in ("ring", "ulysses")}
    L = tokens.shape[1] // 2
    for rec in ranks:
        block = slice(rec["sp_index"] * L, (rec["sp_index"] + 1) * L)
        for name in ("ring", "ulysses"):
            np.testing.assert_allclose(rec["forward"][name],
                                       want[name][:, block],
                                       atol=FORWARD_TOL, rtol=FORWARD_TOL)
        np.testing.assert_allclose(rec["forward"]["ring"],
                                   rec["forward"]["ulysses"],
                                   atol=FORWARD_TOL, rtol=FORWARD_TOL)


def test_ulysses_runs_under_grad_mode(ranks):
    """The rank-level exchange is differentiable (each all-to-all's
    backward is the inverse one): each rank's output and its block's
    gradients of the ranks' summed loss match JAX's dense reference
    (JAX's Ulysses gradient tolerance, 5e-4); it also runs under
    no_grad."""
    c = CASES[next(n for n, x in CASES.items() if not x.get("expect_error"))]
    q, k, v = (jnp.asarray(c[n][:, :, :8 * SP]) for n in ("q", "k", "v"))

    def attention(q, k, v):
        return reference_attention(q, k, v, causal=True)

    want = np.asarray(attention(q, k, v))
    grads = jax.grad(lambda *x: (attention(*x) ** 2).sum(),
                     argnums=(0, 1, 2))(q, k, v)
    for r, rec in enumerate(ranks):
        blk = slice(8 * r, 8 * (r + 1))
        got = rec["grad_mode"]
        np.testing.assert_allclose(got["out"], want[:, :, blk],
                                   atol=TOL, rtol=TOL)
        for g, w in zip(got["grads"], grads):
            np.testing.assert_allclose(g, np.asarray(w)[:, :, blk],
                                       atol=5e-4, rtol=5e-4)
        assert rec["no_grad_runs"] is None
