"""The backward of the port's sequence parallelism (the ring of
``parallel/ring_attention.py`` and Ulysses of ``parallel/ulysses.py``)
against ``jax.grad`` through the JAX package's.

Four ranks (gloo on the CPU, one spawn for the file) run every case of
``tests/torch_sp_worker.py::grad_cases`` through the standalone entries
on an ``{"sp": 2}`` or ``{"sp": 4}`` mesh: every rank computes the loss
from the gathered output and gets the whole gradients of q, k and v. JAX
takes ``jax.grad`` of the same loss through its sharded entry (einsum
hops and Ulysses) or its flash-hop ring under ``shard_map`` (Pallas in
interpret mode), on the first 2 or 4 of the 8 virtual CPU devices.
Checklist: the gradient cases of the JAX package's tests/test_parallel.py
(:53 the einsum ring, :165 a window whose boundary straddles a hop, :238
the flash hops over compact GQA K/V) and tests/test_ulysses.py:87, widened
to causal and non-causal, GQA and windows with full and boundary hops on
both ring paths, and to Ulysses' windows and GQA broadcasts (fewer K/V
heads than sp, the partial ``lcm(KVH, sp)``, tests/test_ulysses.py:72,
:140).

Tolerances are JAX's own: 1e-4 for the einsum ring, 1e-3 for the flash
hops (merged on their log-sum-exp; the backward per hop against the
merged statistics), 5e-4 for Ulysses. Each is held against JAX's
gradient and against the dense reference's.
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
from bee_code_interpreter_tpu.parallel.ulysses import (
    ulysses_attention_sharded,
)
from bee_code_interpreter_tpu_torch.parallel import spawn
from tests import torch_sp_worker as W
from tests.torch_sp_worker import qkv

EINSUM_TOL, FLASH_TOL, ULYSSES_TOL = 1e-4, 1e-3, 5e-4


def grad_case(seed, shape, sp, entry, loss="square", **kw):
    return {**qkv(seed, *shape), "sp": sp, "entry": entry, "loss": loss,
            "kw": kw}


CASES = {
    # test_parallel.py:53: sp=2, the sum of the causal output
    "ring_sum_sp2": grad_case(20, (1, 1, 1, 16, 8), 2, "ring", loss="sum"),
    **{f"ring_causal_{c}": grad_case(21, (2, 2, 2, 64, 16), 4, "ring",
                                     causal=c) for c in (True, False)},
    "ring_gqa": grad_case(22, (1, 4, 2, 64, 16), 4, "ring", causal=True),
    # :165, window 24 over L_local 16: the hop one block back straddles
    "ring_window_24": grad_case(23, (1, 2, 2, 64, 16), 4, "ring",
                                causal=True, window=24),
    # :238, the flash hops over compact GQA K/V at sp=2
    "flash_gqa_sp2": grad_case(24, (1, 4, 2, 64, 16), 2, "ring",
                               use_flash=True),
    "flash_noncausal": grad_case(25, (1, 2, 2, 64, 16), 4, "ring",
                                 causal=False, use_flash=True),
    # window 40 over L_local 16: the own block windowed, the hop one block
    # back wholly visible (a kernel hop), the next a boundary block
    "flash_window_40": grad_case(26, (1, 4, 2, 64, 16), 4, "ring",
                                 causal=True, window=40, use_flash=True),
    # test_ulysses.py:87 at sp=2
    "ulysses_sp2": grad_case(27, (1, 2, 2, 32, 8), 2, "ulysses"),
    "ulysses_window": grad_case(29, (1, 4, 4, 64, 16), 4, "ulysses",
                                causal=True, window=24),
    # :72 and :140, a broadcast K/V head's gradient summed over its copies
    "ulysses_fewer_kv_heads": grad_case(30, (1, 4, 2, 32, 8), 4, "ulysses"),
    "ulysses_lcm": grad_case(31, (1, 8, 2, 64, 16), 4, "ulysses"),
}


@pytest.fixture(scope="module")
def ranks():
    return spawn(W.grad_cases, 4, device_type="cpu", args=(CASES,),
                 timeout=300)


def jax_fn(c):
    """The JAX function of a case: q, k, v -> the whole output."""
    mesh = make_mesh({"sp": c["sp"]}, devices=jax.devices()[:c["sp"]])
    kw = dict(c["kw"])
    if c["entry"] == "ulysses":
        return functools.partial(ulysses_attention_sharded, mesh, **kw)
    if kw.pop("use_flash", False):
        spec = jax.sharding.PartitionSpec(None, None, "sp", None)
        return jax.shard_map(
            functools.partial(ring_attention, axis_name="sp", use_flash=True,
                              **kw),
            mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
            check_vma=False,
        )
    return functools.partial(ring_attention_sharded, mesh, **kw)


def reference_fn(c):
    kw = {n: c["kw"][n] for n in ("causal", "window") if n in c["kw"]}
    H, KVH = c["q"].shape[1], c["k"].shape[1]

    def fn(q, k, v):
        if c["entry"] == "ulysses" and KVH != H:
            # tests/test_ulysses.py's reference: K/V repeated up to H
            k, v = (jnp.repeat(x, H // KVH, axis=1) for x in (k, v))
        return reference_attention(q, k, v, **kw)
    return fn


def grads_of(fn, c):
    """The output and the gradients of q, k, v (one compile)."""
    def loss(*x):
        out = fn(*x)
        return (out.sum() if c["loss"] == "sum" else (out ** 2).sum()), out

    args = [jnp.asarray(c[n]) for n in ("q", "k", "v")]
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def tolerance(c):
    if c["entry"] == "ulysses":
        return ULYSSES_TOL
    return FLASH_TOL if c["kw"].get("use_flash") else EINSUM_TOL


@pytest.mark.parametrize("name", list(CASES))
def test_sp_gradients_match_jax(ranks, name):
    c = CASES[name]
    tol = tolerance(c)
    want_out, want = grads_of(jax_fn(c), c)
    _, ref = grads_of(reference_fn(c), c)
    got_ranks = [rec[name] for rec in ranks[:c["sp"]]]
    for r, got in enumerate(got_ranks):
        np.testing.assert_allclose(got["out"], want_out, atol=tol, rtol=tol,
                                   err_msg=f"rank {r} output")
        for g, w, rf, n in zip(got["grads"], want, ref, ("dq", "dk", "dv")):
            np.testing.assert_allclose(g, w, atol=tol, rtol=tol,
                                       err_msg=f"rank {r} {n} vs JAX")
            np.testing.assert_allclose(g, rf, atol=tol, rtol=tol,
                                       err_msg=f"rank {r} {n} vs reference")
        # the loss counts once: every rank holds the same whole gradient
        for g, g0 in zip(got["grads"], got_ranks[0]["grads"]):
            np.testing.assert_array_equal(g, g0)
    # ranks outside the case's mesh ran nothing
    assert all(name not in rec for rec in ranks[c["sp"]:])
