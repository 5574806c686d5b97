"""The port's GPipe pipeline (``parallel/pipeline.py::spmd_pipeline``)
against the JAX package's ``spmd_pipeline`` and the sequential oracle.

The port's ranks are spawned with gloo on the CPU, once per world size (2
and 4), running ``tests/torch_pipeline_worker.py::pipeline_cases``; JAX
runs here on the virtual CPU devices, a mesh over the first 2 or 4 of
them. Checklist: the JAX package's tests/test_pipeline.py, (pp, M) in
{(2, 2), (4, 4), (4, 8)} against the sequential oracle and JAX's pipeline
(each with the gradients of ``(out ** 2).sum()``), its gradient case,
dp x pp (its ``{"dp": 2, "pp": 4}`` as ``{"dp": 2, "pp": 2}``: four ranks),
the divisibility errors, and the auxiliary loss (``with_aux``) counted on
real microbatches only, summed over pp, averaged over microbatches and dp,
with its gradient.

Tolerances are JAX's own: 1e-5 for outputs, 1e-4 for gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bee_code_interpreter_tpu.parallel import make_mesh, spmd_pipeline
from bee_code_interpreter_tpu_torch.parallel import spawn
from tests import torch_pipeline_worker as W

OUT_TOL, GRAD_TOL = 1e-5, 1e-4


def make_layers(n_layers: int, d: int, key=0):
    """tests/test_pipeline.py's layers."""
    ks = jax.random.split(jax.random.PRNGKey(key), n_layers)
    return {
        "w": jax.vmap(
            lambda k: jax.random.normal(k, (d, d), jnp.float32) / np.sqrt(d)
        )(ks),
        "b": jnp.zeros((n_layers, d), jnp.float32),
    }


def stage_fn(h, layer):
    return jax.nn.relu(h @ layer["w"] + layer["b"])


def stage_fn_aux(h, layer):
    h = stage_fn(h, layer)
    return h, (h ** 2).mean()


def sequential(layers, x, with_aux=False):
    """The oracle: the layers in turn over ``x``, and with ``with_aux``
    each layer's aux term of it."""
    def body(h, layer):
        if with_aux:
            h, a = stage_fn_aux(h, layer)
            return h, a
        return stage_fn(h, layer), None

    return jax.lax.scan(body, x, layers)


CASE_KEYS = {name: i + 1 for i, name in enumerate(W.PIPELINE_CASES)}


@pytest.fixture(scope="module")
def inputs():
    out = {"six_layers": jax.tree.map(np.asarray, make_layers(6, 8)),
           "eight_layers": jax.tree.map(np.asarray, make_layers(8, 8))}
    for name, (_, _, n_layers, d, rows, _) in W.PIPELINE_CASES.items():
        layers = make_layers(n_layers, d)
        x = jax.random.normal(jax.random.PRNGKey(CASE_KEYS[name]), (rows, d))
        out[name] = {"layers": jax.tree.map(np.asarray, layers),
                     "x": np.asarray(x)}
    return out


@pytest.fixture(scope="module")
def spawned(inputs):
    return {world: spawn(W.pipeline_cases, world, device_type="cpu",
                         args=(world, inputs), timeout=300)
            for world in (2, 4)}


def jax_case(name, inputs):
    """JAX's pipeline on the case: the output, aux, and the gradients of
    the layers and of x for ``(out ** 2).sum()`` (+ aux)."""
    axes, n_micro, _, _, _, with_aux = W.PIPELINE_CASES[name]
    mesh = make_mesh(axes, devices=jax.devices()[:W.world_of(axes)])
    layers = jax.tree.map(jnp.asarray, inputs[name]["layers"])
    x = jnp.asarray(inputs[name]["x"])
    batch_axes = ("dp",) if "dp" in axes else ()

    def run(layers, x):
        got = spmd_pipeline(stage_fn_aux if with_aux else stage_fn, layers,
                            x, mesh=mesh, n_microbatches=n_micro,
                            batch_axes=batch_axes, with_aux=with_aux)
        out, aux = got if with_aux else (got, jnp.float32(0.0))
        return (out ** 2).sum() + aux, (out, aux)

    (_, (out, aux)), grads = jax.jit(jax.value_and_grad(
        run, argnums=(0, 1), has_aux=True))(layers, x)
    return (np.asarray(out), float(aux),
            jax.tree.map(np.asarray, grads[0]), np.asarray(grads[1]))


def oracle(name, inputs):
    """The sequential oracle's output, and its aux: per microbatch the
    layers' terms summed, averaged over the microbatches (of each dp
    shard, then over the shards)."""
    axes, n_micro, _, _, _, with_aux = W.PIPELINE_CASES[name]
    layers = jax.tree.map(jnp.asarray, inputs[name]["layers"])
    x = jnp.asarray(inputs[name]["x"])
    out, _ = sequential(layers, x)
    if not with_aux:
        return np.asarray(out), 0.0
    n = axes.get("dp", 1) * n_micro
    auxes = [sequential(layers, mb, True)[1].sum()
             for mb in jnp.split(x, n, axis=0)]
    return np.asarray(out), float(np.mean(auxes))


def rows_of(full, rec, axes):
    n = axes.get("dp", 1)
    rows = full.shape[0] // n
    return full[rec["dp_index"] * rows:(rec["dp_index"] + 1) * rows]


@pytest.mark.parametrize("name", list(W.PIPELINE_CASES))
def test_pipeline_matches_jax_and_sequential(spawned, inputs, name):
    axes, _, n_layers, _, _, with_aux = W.PIPELINE_CASES[name]
    want, aux, layer_grads, x_grad = jax_case(name, inputs)
    seq, seq_aux = oracle(name, inputs)
    np.testing.assert_allclose(want, seq, atol=OUT_TOL, rtol=OUT_TOL)
    recs = spawned[W.world_of(axes)]
    per = n_layers // axes["pp"]
    for r, rec in enumerate(recs):
        rec = rec[name]
        # every stage returns the output (the last stage's, replicated)
        np.testing.assert_allclose(rec["out"], rows_of(want, rec, axes),
                                   atol=OUT_TOL, rtol=OUT_TOL,
                                   err_msg=f"rank {r} output")
        np.testing.assert_allclose(rec["x_grad"], rows_of(x_grad, rec, axes),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"rank {r} x gradient")
        if with_aux:
            np.testing.assert_allclose(rec["aux"], aux, rtol=1e-5)
            np.testing.assert_allclose(rec["aux"], seq_aux, rtol=1e-5)
        # the rank's block of layers, and their gradients
        assert len(rec["layer_grads"]) == per
        for i, got in enumerate(rec["layer_grads"]):
            li = rec["stage"] * per + i
            for k in ("w", "b"):
                want_g = layer_grads[k][li]
                np.testing.assert_allclose(
                    got[k], want_g, rtol=GRAD_TOL,
                    atol=GRAD_TOL * max(np.abs(want_g).max(), 1e-6),
                    err_msg=f"rank {r} layer {li} {k} gradient")


def test_pipeline_validates_divisibility(spawned):
    """tests/test_pipeline.py:80: layers that do not divide over pp, and a
    batch that does not divide into the microbatches."""
    for rec in spawned[4]:
        kind, msg = rec["layers_error"]
        assert kind == "ValueError" and "not divisible" in msg
        kind, msg = rec["microbatch_error"]
        assert kind == "ValueError" and "microbatches" in msg
    mesh = make_mesh({"pp": 4}, devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="not divisible"):
        spmd_pipeline(stage_fn, make_layers(6, 8), jnp.zeros((8, 8)),
                      mesh=mesh, n_microbatches=4)
