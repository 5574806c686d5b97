"""The port's pipelined decoder (``models/transformer.py::forward_pipelined``
and training through it) against the JAX package's.

The port's ranks are spawned with gloo on the CPU, once per world size (2
and 4), running ``tests/torch_pipeline_worker.py::transformer_cases``;
JAX runs here on the virtual CPU devices. Checklist: the cases of the JAX
package's tests/test_pipeline_transformer.py, its ``{"dp": 2, "pp": 4}``
as ``{"dp": 2, "pp": 2}``: the pipelined forward against JAX's and against
the standard forward (pp=2, and dp x pp), training through the pipeline
(the dense decoder at dp x pp, MoE with its aux at pp=2: each step's loss
equal to JAX's with optax.adamw(1e-2) on the same weights and batch,
falling), MoE logits and aux against JAX's and against the per-microbatch
oracle, drop-free MoE against the full forward, and the MoE refusal
without ``return_aux``. Every rank holds only its stage's layers.

Tolerances: logits 1e-4 (JAX's own), aux 1e-5 relative (JAX's), training
losses 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from bee_code_interpreter_tpu.models import transformer as jax_t
from bee_code_interpreter_tpu.parallel import make_mesh
from bee_code_interpreter_tpu_torch.parallel import spawn
from tests import torch_pipeline_worker as W

LOGIT_TOL, AUX_TOL, LOSS_TOL = 1e-4, 1e-5, 1e-5


def f32_tiny(**kw):
    return dataclasses.replace(jax_t.TransformerConfig.tiny(),
                               dtype=jnp.float32, **kw)


def ample_moe():
    return dataclasses.replace(jax_t.TransformerConfig.tiny_moe(),
                               dtype=jnp.float32, moe_capacity_factor=8.0)


JAX_CONFIGS = {"tiny": f32_tiny, "tiny4": lambda: f32_tiny(n_layers=4),
               "moe": ample_moe}
# case -> (params key, tokens key, token shape): the JAX tests' draws
DRAWS = {
    "forward": (0, 1, (4, 32)),
    "forward_dp": (0, 1, (8, 32)),
    "train_dp": (0, 1, (8, 33)),
    "moe_oracle": (0, 1, (4, 32)),
    "moe_drop_free_dp": (2, 3, (8, 16)),
    "moe_requires_aux": (0, 1, (4, 16)),
    "moe_train": (0, 1, (4, 17)),
}


def jax_mesh(axes):
    return make_mesh(axes, devices=jax.devices()[:W.world_of(axes)])


def forward(params, tokens, cfg, **kw):
    """JAX's ``forward``, jitted (one compile rather than op by op)."""
    return jax.jit(lambda p, t: jax_t.forward(p, t, cfg, **kw))(params,
                                                                tokens)


def pipelined(params, tokens, cfg, axes, **kw):
    """JAX's ``forward_pipelined`` on the case's mesh, 2 microbatches,
    jitted."""
    mesh = jax_mesh(axes)
    return jax.jit(lambda p, t: jax_t.forward_pipelined(
        p, t, cfg, mesh, n_microbatches=2, **kw))(params, tokens)


@pytest.fixture(scope="module")
def inputs():
    out = {}
    for name, (axes, which, _, _) in W.TRANSFORMER_CASES.items():
        pk, tk, shape = DRAWS[name]
        cfg = JAX_CONFIGS[which]()
        params = jax_t.init_params(cfg, jax.random.PRNGKey(pk))
        tokens = jax.random.randint(jax.random.PRNGKey(tk), shape, 0,
                                    cfg.vocab_size)
        out[name] = {"jax_params": params,
                     "params": jax.tree.map(np.asarray, params),
                     "tokens": np.asarray(tokens)}
    return out


@pytest.fixture(scope="module")
def spawned(inputs):
    payload = {name: {k: v[k] for k in ("params", "tokens")}
               for name, v in inputs.items()}
    return {world: spawn(W.transformer_cases, world, device_type="cpu",
                         args=(world, payload), timeout=300)
            for world in (2, 4)}


def recs_of(spawned, name):
    axes = W.TRANSFORMER_CASES[name][0]
    return [rec[name] for rec in spawned[W.world_of(axes)]], axes


def rows(full, rec, axes):
    n = axes.get("dp", 1)
    per = full.shape[0] // n
    return full[rec["dp_index"] * per:(rec["dp_index"] + 1) * per]


def held(recs, axes, cfg):
    """Each rank holds its stage's block of layers."""
    return all(r["layers_held"] == cfg.n_layers // axes["pp"] for r in recs)


@pytest.mark.parametrize("name", ["forward", "forward_dp"])
def test_pipelined_forward_matches_jax_and_standard(spawned, inputs, name):
    """test_pipeline_transformer.py:15 and :27."""
    recs, axes = recs_of(spawned, name)
    cfg = JAX_CONFIGS[W.TRANSFORMER_CASES[name][1]]()
    params = inputs[name]["jax_params"]
    tokens = jnp.asarray(inputs[name]["tokens"])
    want = np.asarray(forward(params, tokens, cfg))
    got_jax = np.asarray(pipelined(params, tokens, cfg, axes))
    assert held(recs, axes, cfg)
    for r, rec in enumerate(recs):
        for ref in (want, got_jax):
            np.testing.assert_allclose(rec["logits"], rows(ref, rec, axes),
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                       err_msg=f"rank {r}")


def jax_losses(name, inputs, moe: bool):
    """JAX's training test on the case's mesh: ``W.TRAIN_STEPS`` steps of
    optax.adamw(1e-2) on the loss through ``forward_pipelined``."""
    axes, which, n_micro, _ = W.TRANSFORMER_CASES[name]
    cfg = JAX_CONFIGS[which]()
    mesh = jax_mesh(axes)
    params = inputs[name]["jax_params"]
    tokens = jnp.asarray(inputs[name]["tokens"])
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}

    def loss_fn(params):
        got = jax_t.forward_pipelined(params, batch["tokens"], cfg, mesh,
                                      n_microbatches=n_micro, return_aux=moe)
        logits, aux = got if moe else (got, 0.0)
        logz = jax.scipy.special.logsumexp(logits, axis=-1)
        target = jnp.take_along_axis(
            logits, batch["targets"][..., None], axis=-1)[..., 0]
        return (logz - target).mean() + cfg.moe_aux_weight * aux

    optimizer = optax.adamw(1e-2)
    opt_state = optimizer.init(params)

    @jax.jit
    def step(params, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for _ in range(W.TRAIN_STEPS):
        params, opt_state, loss = step(params, opt_state)
        losses.append(float(loss))
    return losses, cfg


@pytest.mark.parametrize("name", ["train_dp", "moe_train"])
def test_pipelined_training_matches_jax(spawned, inputs, name):
    """test_pipeline_transformer.py:39 (dp x pp) and :160 (MoE with its aux
    in the objective): the same losses as JAX's at every step, falling."""
    recs, axes = recs_of(spawned, name)
    want, cfg = jax_losses(name, inputs, moe=name.startswith("moe"))
    assert held(recs, axes, cfg)
    for r, rec in enumerate(recs):
        np.testing.assert_allclose(rec["losses"], want, atol=LOSS_TOL,
                                   rtol=LOSS_TOL, err_msg=f"rank {r}")
        assert rec["losses"] == recs[0]["losses"]
    assert want[-1] < want[0] and all(np.isfinite(want))


def test_pipelined_moe_matches_microbatched_oracle(spawned, inputs):
    """test_pipeline_transformer.py:93: logits and aux against JAX's
    pipeline and the standard forward on each microbatch; the aux not
    dropped."""
    recs, axes = recs_of(spawned, "moe_oracle")
    cfg = ample_moe()
    params = inputs["moe_oracle"]["jax_params"]
    tokens = jnp.asarray(inputs["moe_oracle"]["tokens"])
    got, aux = pipelined(params, tokens, cfg, axes, return_aux=True)
    mb_logits, mb_aux = [], []
    for mb in jnp.split(tokens, 2, axis=0):
        lg, ax = forward(params, mb, cfg, return_aux=True)
        mb_logits.append(lg)
        mb_aux.append(float(ax))
    oracle = np.asarray(jnp.concatenate(mb_logits, axis=0))
    for r, rec in enumerate(recs):
        for ref in (np.asarray(got), oracle):
            np.testing.assert_allclose(rec["logits"], ref, atol=LOGIT_TOL,
                                       rtol=LOGIT_TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(rec["aux"], float(aux), rtol=AUX_TOL)
        np.testing.assert_allclose(rec["aux"], np.mean(mb_aux), rtol=AUX_TOL)
        assert rec["aux"] > 0.0


def test_pipelined_moe_drop_free_matches_full_forward(spawned, inputs):
    """test_pipeline_transformer.py:120 at dp x pp."""
    recs, axes = recs_of(spawned, "moe_drop_free_dp")
    cfg = ample_moe()
    params = inputs["moe_drop_free_dp"]["jax_params"]
    tokens = jnp.asarray(inputs["moe_drop_free_dp"]["tokens"])
    want = np.asarray(forward(params, tokens, cfg))
    got, _ = pipelined(params, tokens, cfg, axes, return_aux=True)
    for r, rec in enumerate(recs):
        for ref in (want, np.asarray(got)):
            np.testing.assert_allclose(rec["logits"], rows(ref, rec, axes),
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                       err_msg=f"rank {r}")


def test_pipelined_moe_requires_return_aux(spawned, inputs):
    """test_pipeline_transformer.py:135: the same ValueError as JAX's."""
    recs, axes = recs_of(spawned, "moe_requires_aux")
    with pytest.raises(ValueError, match="return_aux=True") as err:
        jax_t.forward_pipelined(
            inputs["moe_requires_aux"]["jax_params"],
            jnp.zeros((4, 16), dtype=jnp.int32), ample_moe(),
            jax_mesh(axes), n_microbatches=2)
    for rec in recs:
        assert rec["error"] == ("ValueError", str(err.value))
