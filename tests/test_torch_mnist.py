"""The port's MNIST MLP (``bee_code_interpreter_tpu_torch/models/mnist.py``)
against the JAX package's ``models/mnist.py``.

The layout (``[{w [n_in, n_out], b}]`` for 784 -> 512 -> 256 -> 10, f32),
the forward and one ``optax.sgd(0.1, momentum=0.9)`` step on JAX's weights
(``TOL``), and JAX's ``tests/test_models.py:119`` on two gloo CPU ranks at
dp=2 (``tests/torch_vision_worker.py::mnist_dp``): 30 steps on one random
batch of 256 rows, each rank its 128, the loss falling below half its first
value, every loss within ``STEP_TOL`` of JAX's unsharded steps and the two
ranks' parameters bitwise equal.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from bee_code_interpreter_tpu.models.mnist import MnistMlp as JaxMlp
from bee_code_interpreter_tpu_torch.models.mnist import MnistMlp
from bee_code_interpreter_tpu_torch.parallel import mesh as M
from bee_code_interpreter_tpu_torch.weights import replicated_params_from_jax
from tests import torch_vision_worker as W

TOL = 1e-5
# 30 SGD steps with momentum from the gradients of a loss summed in another
# order: the f32 drift stays far under the loss's own scale (~2.3 to ~0.1)
STEP_TOL = 1e-4


@pytest.fixture(scope="module")
def inputs():
    model = JaxMlp(hidden_sizes=(64,))
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    batch = {"image": rng.standard_normal((256, 784)).astype(np.float32),
             "label": rng.integers(0, 10, 256).astype(np.int32)}
    return {"model": model, "jax_params": params,
            "params": jax.tree.map(np.asarray, params), "batch": batch}


def test_layout_matches_jax():
    want = JaxMlp().init(jax.random.PRNGKey(0))
    got = MnistMlp().init(torch.Generator().manual_seed(0), "cpu")
    assert [tuple(layer[k].shape) for layer in got for k in ("w", "b")] == [
        tuple(layer[k].shape) for layer in want for k in ("w", "b")]
    assert [s for s in MnistMlp().sizes] == [784, 512, 256, 10]
    assert all(layer[k].dtype == torch.float32 and layer[k].requires_grad
               for layer in got for k in ("w", "b"))


def test_forward_and_sgd_step_match_optax(inputs):
    model, params = inputs["model"], inputs["jax_params"]
    batch = jax.tree.map(jax.numpy.asarray, inputs["batch"])
    loss, grads = jax.value_and_grad(model.loss)(params, batch)
    optimizer = optax.sgd(0.1, momentum=0.9)
    updates, _ = optimizer.update(grads, optimizer.init(params))
    want = optax.apply_updates(params, updates)
    mlp = MnistMlp(hidden_sizes=(64,))
    ours = replicated_params_from_jax(inputs["params"], device="cpu",
                                 requires_grad=True)
    batch_t = W.tensors(inputs["batch"])
    np.testing.assert_allclose(
        mlp.apply(ours, batch_t["image"]).detach().numpy(),
        np.asarray(model.apply(params, batch["image"])), atol=TOL, rtol=TOL)
    step, _ = mlp.make_train_step(0.1)
    ours, _, got_loss = step(ours, None, batch_t)
    assert abs(float(got_loss) - float(loss)) <= TOL
    for layer, ref in zip(ours, want, strict=True):
        for k in ("w", "b"):
            np.testing.assert_allclose(layer[k].detach().numpy(),
                                       np.asarray(ref[k]), atol=TOL, rtol=TOL)


@pytest.fixture(scope="module")
def spawned(inputs):
    payload = {k: inputs[k] for k in ("params", "batch")}
    return M.spawn(W.mnist_dp, 2, device_type="cpu", args=(payload,),
                   timeout=600)


def test_dp_training_converges_like_jax(spawned, inputs):
    model = inputs["model"]
    optimizer = optax.sgd(0.1, momentum=0.9)
    params = inputs["jax_params"]
    state = optimizer.init(params)
    batch = jax.tree.map(jax.numpy.asarray, inputs["batch"])
    want = []
    for _ in range(W.MNIST_STEPS):
        loss, grads = jax.value_and_grad(model.loss)(params, batch)
        updates, state = optimizer.update(grads, state)
        params = optax.apply_updates(params, updates)
        want.append(float(loss))
    for rec in spawned:
        losses = rec["losses"]
        assert losses[-1] < losses[0] * 0.5, losses[::10]
        np.testing.assert_allclose(losses, want, atol=STEP_TOL, rtol=STEP_TOL)
    for a, b in zip(spawned[0]["params"], spawned[1]["params"], strict=True):
        for k in ("w", "b"):
            np.testing.assert_array_equal(a[k], b[k])
