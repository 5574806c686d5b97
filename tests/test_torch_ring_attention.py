"""The port's ring attention (``parallel/ring_attention.py``) against the
JAX package's.

Four ranks (gloo on the CPU, one spawn for the file) run every case of
``tests/torch_sp_worker.py::attention_cases`` through
``ring_attention_sharded`` on an ``{"sp": 4}`` mesh; the JAX side runs the
same numpy inputs through its ``ring_attention_sharded`` (einsum hops) or
its flash-hop ring under ``shard_map`` (Pallas in interpret mode) on four
of the 8 virtual CPU devices. Checklist: the forward cases of the JAX
package's tests/test_parallel.py:44-211 (causal and not, bf16, GQA-compact
K/V, sliding windows in global positions, flash hops against the
reference and against the einsum hops, the two window validations), and
the rank-level ring under grad mode; the gradient cases of
tests/test_parallel.py are tests/test_torch_sp_backward.py's.

Tolerances: the f32 cases 2e-5 (einsum hops, JAX's own bound) and 2e-4
(flash hops, JAX's own bound: hops merged on their log-sum-exp), bf16 3e-2
(one bf16 rounding of the output, JAX's bound), all against JAX's output
and the dense reference alike.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bee_code_interpreter_tpu.parallel.mesh import make_mesh
from bee_code_interpreter_tpu.parallel.ring_attention import (
    reference_attention,
    ring_attention,
    ring_attention_sharded,
)
from bee_code_interpreter_tpu_torch.parallel import spawn
from tests import torch_sp_worker as W
from tests.torch_sp_worker import case, qkv

SP = 4
EINSUM_TOL, FLASH_TOL, BF16_TOL = 2e-5, 2e-4, 3e-2


CASES = {
    # test_parallel.py:44, causal and not
    **{f"causal_{c}": case(0, (2, 2, 2, 64, 16), causal=c)
       for c in (True, False)},
    # :73, bf16 in and out
    "bf16": {**qkv(1, 1, 2, 2, 32, 8), "bf16": True, "kw": {}},
    # :100, grouped-query K/V rotating compact
    **{f"gqa_{c}": case(2, (1, 4, 2, 64, 16), causal=c)
       for c in (True, False)},
    # :119, windows below, at, across and beyond one block (L_local 32)
    **{f"window_{w}": case(3, (1, 2, 2, 128, 16), causal=True, window=w)
       for w in (5, 16, 33, 64, 200)},
    # :133
    "window_gqa": case(4, (1, 4, 2, 128, 16), causal=True, window=40),
    # :147, the flash-hop ring with a window (own block, full hops,
    # straddling boundary blocks)
    **{f"flash_window_{w}": case(5, (1, 2, 2, 128, 32), causal=True,
                                 window=w, use_flash=True)
       for w in (16, 48, 100)},
    # :231, the flash-hop ring against the reference
    **{f"flash_causal_{c}": case(6, (1, 2, 2, 128, 32), causal=c,
                                 use_flash=True)
       for c in (True, False)},
    # :206-229, the validations
    "window_not_causal": {**qkv(7, 1, 2, 2, 32, 16), "expect_error": True,
                          "kw": {"causal": False, "window": 8}},
    **{f"window_zero_flash_{f}": {**qkv(7, 1, 2, 2, 32, 16),
                                  "expect_error": True,
                                  "kw": {"causal": True, "window": 0,
                                         "use_flash": f}}
       for f in (False, True)},
}


@pytest.fixture(scope="module")
def ranks():
    return spawn(W.attention_cases, SP, device_type="cpu",
                 args=("ring", CASES), timeout=300)


def jax_inputs(c):
    dtype = jnp.bfloat16 if c.get("bf16") else jnp.float32
    return [jnp.asarray(c[n], dtype=dtype) for n in ("q", "k", "v")]


def jax_ring(c):
    """JAX's output on the same inputs: its sharded entry (einsum hops off
    TPU), or, for the flash cases, its flash-hop ring under shard_map as
    tests/test_parallel.py runs it."""
    mesh = make_mesh({"sp": SP})
    q, k, v = jax_inputs(c)
    kw = dict(c["kw"])
    if kw.pop("use_flash", False):
        spec = jax.sharding.PartitionSpec(None, None, "sp", None)
        fn = jax.shard_map(
            functools.partial(ring_attention, axis_name="sp", use_flash=True,
                              **kw),
            mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
            check_vma=False,
        )
        return fn(q, k, v)
    return ring_attention_sharded(mesh, q, k, v, **kw)


def reference(c):
    q, k, v = jax_inputs(c)
    kw = {n: c["kw"][n] for n in ("causal", "window") if n in c["kw"]}
    return reference_attention(q, k, v, **kw)


def tolerance(name):
    if name == "bf16":
        return BF16_TOL
    return FLASH_TOL if name.startswith("flash") else EINSUM_TOL


OUTPUT_CASES = [n for n, c in CASES.items() if not c.get("expect_error")]


@pytest.mark.parametrize("name", OUTPUT_CASES)
def test_ring_matches_jax_and_reference(ranks, name):
    c = CASES[name]
    tol = tolerance(name)
    want = np.asarray(jax_ring(c), dtype=np.float32)
    ref = np.asarray(reference(c), dtype=np.float32)
    for rec in ranks:
        got = rec[name]
        assert got["dtype"] == ("torch.bfloat16" if c.get("bf16")
                                else "torch.float32")
        np.testing.assert_allclose(got["out"], want, atol=tol, rtol=tol)
        np.testing.assert_allclose(got["out"], ref, atol=tol, rtol=tol)
    # every rank gathers the same whole output
    for rec in ranks[1:]:
        np.testing.assert_array_equal(rec[name]["out"], ranks[0][name]["out"])


@pytest.mark.parametrize("w", (16, 48, 100))
def test_flash_hops_match_einsum_hops(ranks, w):
    """The K1-per-hop ring (its plain version on the CPU) and the einsum
    ring agree on the same windowed inputs (test_parallel.py:147 against
    :119), within the flash hops' tolerance."""
    einsum = dict(CASES[f"flash_window_{w}"])
    einsum["kw"] = {k: v for k, v in einsum["kw"].items() if k != "use_flash"}
    want = np.asarray(jax_ring(einsum))
    for rec in ranks:
        np.testing.assert_allclose(rec[f"flash_window_{w}"]["out"], want,
                                   atol=FLASH_TOL, rtol=FLASH_TOL)


def test_window_validations_match_jax(ranks):
    c = CASES["window_not_causal"]
    with pytest.raises(ValueError, match="window requires causal") as err:
        jax_ring(c)
    for rec in ranks:
        assert rec["window_not_causal"] == ("ValueError", str(err.value))
    for flash in (False, True):
        c = CASES[f"window_zero_flash_{flash}"]
        with pytest.raises(ValueError, match="window must be >= 1") as err:
            jax_ring(c)
        for rec in ranks:
            assert rec[f"window_zero_flash_{flash}"] == ("ValueError",
                                                         str(err.value))


def rank_level_grads(c, attention):
    """JAX's output and gradients of the whole-sequence loss that the
    ranks' shares ``(out_r ** 2).sum()`` add up to: the first 8 positions
    a rank over the first 8 x SP of ``c``."""
    q, k, v = (jnp.asarray(c[n][:, :, :8 * SP]) for n in ("q", "k", "v"))
    out = attention(q, k, v)
    grads = jax.grad(lambda *x: (attention(*x) ** 2).sum(),
                     argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def test_ring_runs_under_grad_mode(ranks):
    """The rank-level ring is differentiable (its backward runs the ring
    again): each rank's output and its block's gradients of the ranks'
    summed loss match JAX's dense reference within the einsum hops'
    gradient tolerance; it also runs under no_grad."""
    want, grads = rank_level_grads(
        CASES[OUTPUT_CASES[0]],
        lambda q, k, v: reference_attention(q, k, v, causal=True))
    for r, rec in enumerate(ranks):
        blk = slice(8 * r, 8 * (r + 1))
        got = rec["grad_mode"]
        np.testing.assert_allclose(got["out"], want[:, :, blk],
                                   atol=EINSUM_TOL, rtol=EINSUM_TOL)
        for g, w in zip(got["grads"], grads):
            np.testing.assert_allclose(g, w[:, :, blk], atol=1e-4, rtol=1e-4)
        assert rec["no_grad_runs"] is None
