"""The port's ResNet (``bee_code_interpreter_tpu_torch/models/vision.py``)
against the JAX package's ``models/vision.py`` on the same weights and
inputs.

``ResNetConfig.tiny()`` in f32, images and labels from numpy seeds: the
forward on 32x32 and 33x33 images (the odd size puts XLA's ``SAME`` odd
pixel at the end of the stem, the strided 3x3 and the max pool, where a
symmetric padding shifts the windows) within ``FWD_TOL``; ``group_norm`` at
C=48 with 32 groups (clamped to 24) within ``FWD_TOL``; every gradient and
one ``optax.sgd(0.1, momentum=0.9)`` step (``TOL``); ResNet-50's parameter
count and layout (JAX's ``test_resnet50_structure``). On two gloo CPU ranks
at dp=2 (``tests/torch_vision_worker.py::dp_cases``, JAX's
``tests/test_vision.py:37-75``): each rank's logits against the unsharded
JAX forward, and one SGD step's loss, gradients (summed over dp) and
parameters against JAX's unsharded step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bee_code_interpreter_tpu.models import vision as jr
from bee_code_interpreter_tpu_torch.models import vision as R
from bee_code_interpreter_tpu_torch.parallel import mesh as M
from bee_code_interpreter_tpu_torch.weights import replicated_params_from_jax
from tests import torch_vision_worker as W

# f32 on both sides; XLA's convs and cuDNN-free CPU convs sum in other
# orders (the forward reads ~6e-7 of logits ~2)
FWD_TOL = 1e-5
TOL = 1e-5
# tests/test_torch_training.py's GRAD_TOL: 1e-4 of the leaf's largest
# element
GRAD_TOL = 1e-4


def jax_config():
    return dataclasses.replace(jr.ResNetConfig.tiny(), dtype=jnp.float32)


def port_config():
    return dataclasses.replace(R.ResNetConfig.tiny(), dtype=torch.float32)


def as_port(tree) -> list:
    """A JAX ResNet tree's leaves in ``vision.param_leaves``' order, convs
    turned OIHW."""
    leaves = []

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            x = np.asarray(x)
            leaves.append(x.transpose(3, 2, 0, 1) if x.ndim == 4 else x)

    walk(tree)
    return leaves


@pytest.fixture(scope="module")
def inputs():
    params = jr.init_params(jax_config(), jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    batch = {"images": rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, 4).astype(np.int32)}
    return {"jax_params": params, "params": jax.tree.map(np.asarray, params),
            "batch": batch}


def port_params(inputs, requires_grad=False):
    return replicated_params_from_jax(inputs["params"], device="cpu",
                                  requires_grad=requires_grad)


@pytest.mark.parametrize("size", [32, 33])
def test_forward_matches_jax(inputs, size):
    images = np.random.default_rng(size).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jr.forward(inputs["jax_params"], jnp.asarray(images),
                                 jax_config()))
    got = R.forward(port_params(inputs), torch.as_tensor(images),
                    port_config())
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("size,kernel,stride,pads", [
    (224, 7, 2, (2, 3)), (56, 3, 2, (0, 1)), (112, 3, 2, (0, 1)),
    (56, 3, 1, (1, 1)), (33, 7, 2, (3, 3)),
])
def test_same_padding_puts_the_odd_pixel_last(size, kernel, stride, pads):
    assert R.same_pads(size, kernel, stride) == pads


def test_group_norm_clamps_groups_like_jax():
    x = np.random.default_rng(0).standard_normal((2, 4, 4, 48)).astype(
        np.float32)
    scale = np.random.default_rng(1).standard_normal(48).astype(np.float32)
    bias = np.random.default_rng(2).standard_normal(48).astype(np.float32)
    want = np.asarray(jr.group_norm(jnp.asarray(x), jnp.asarray(scale),
                                    jnp.asarray(bias), groups=32))
    got = R.group_norm(torch.as_tensor(x), torch.as_tensor(scale),
                       torch.as_tensor(bias), groups=32)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)
    # the largest divisor of 48 not above 32 is 24 (JAX's docstring says 16;
    # its code, which the port follows, gives 24): 24 groups of 2 channels,
    # each normalized to mean 0, variance 1
    unit = R.group_norm(torch.as_tensor(x), torch.ones(48), torch.zeros(48),
                        groups=32).numpy().reshape(2, 4, 4, 24, 2)
    np.testing.assert_allclose(unit.mean(axis=(1, 2, 4)), 0.0, atol=1e-5)
    np.testing.assert_allclose(unit.var(axis=(1, 2, 4)), 1.0, atol=1e-3)


def test_gradients_and_sgd_step_match_optax(inputs):
    batch = {k: jnp.asarray(v) for k, v in inputs["batch"].items()}
    params = inputs["jax_params"]
    loss, grads = jax.value_and_grad(jr.loss_fn)(params, batch, jax_config())
    optimizer = optax.sgd(0.1, momentum=0.9)
    updates, _ = optimizer.update(grads, optimizer.init(params), params)
    want = as_port(optax.apply_updates(params, updates))
    model = R.ResNet(port_config())
    got, opt, got_loss = model.make_train_step()(
        port_params(inputs, requires_grad=True), None,
        W.tensors(inputs["batch"]))
    assert abs(float(got_loss) - float(loss)) <= TOL
    for w, g in zip(R.param_leaves(got), as_port(grads), strict=True):
        scale = max(np.abs(g).max(), 1e-30)
        np.testing.assert_allclose(w.grad.numpy(), g, atol=GRAD_TOL * scale,
                                   rtol=GRAD_TOL)
    for w, x in zip(R.param_leaves(got), want, strict=True):
        np.testing.assert_allclose(w.detach().numpy(), x, atol=TOL, rtol=TOL)


def shapes_by_path(tree, prefix=()) -> dict:
    """``{path: shape}`` of a tree of dicts and lists, convs OIHW."""
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items()
                for p, s in shapes_by_path(v, (*prefix, k)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: s for i, v in enumerate(tree)
                for p, s in shapes_by_path(v, (*prefix, i)).items()}
    shape = tuple(tree.shape)
    return {prefix: (shape[3], shape[2], shape[0], shape[1])
            if len(shape) == 4 and not isinstance(tree, torch.Tensor)
            else shape}


def test_resnet50_structure():
    config = jr.ResNetConfig.resnet50()
    jax_shapes = jax.eval_shape(lambda k: jr.init_params(config, k),
                                jax.random.PRNGKey(0))
    params = R.init_params(R.ResNetConfig.resnet50(),
                           torch.Generator().manual_seed(0), "cpu")
    n = R.n_params(params)
    assert 25_000_000 < n < 26_500_000, n
    assert tuple(params["fc"]["w"].shape) == (2048, 1000)
    assert len(params["stage2"]) == 6
    assert shapes_by_path(params) == shapes_by_path(jax_shapes)


# ---------------------------------------------------------------- dp=2


@pytest.fixture(scope="module")
def spawned(inputs):
    payload = {k: inputs[k] for k in ("params", "batch")}
    return M.spawn(W.resnet_dp, 2, device_type="cpu", args=(payload,),
                   timeout=600)


def test_resnet_dp2_matches_unsharded_jax(spawned, inputs):
    batch = {k: jnp.asarray(v) for k, v in inputs["batch"].items()}
    params = inputs["jax_params"]
    logits = np.asarray(jr.forward(params, batch["images"], jax_config()))
    loss, grads = jax.value_and_grad(jr.loss_fn)(params, batch, jax_config())
    optimizer = optax.sgd(0.1, momentum=0.9)
    updates, _ = optimizer.update(grads, optimizer.init(params), params)
    want = as_port(optax.apply_updates(params, updates))
    for rec in spawned:
        dp = rec["coords"]["dp"]
        np.testing.assert_allclose(rec["logits"], logits[2 * dp:2 * dp + 2],
                                   atol=FWD_TOL, rtol=FWD_TOL)
        assert abs(rec["loss"] - float(loss)) <= TOL
        for g, x in zip(rec["grads"], as_port(grads), strict=True):
            scale = max(np.abs(x).max(), 1e-30)
            np.testing.assert_allclose(g, x, atol=GRAD_TOL * scale,
                                       rtol=GRAD_TOL)
        for w, x in zip(R.param_leaves(rec["params"]), want, strict=True):
            np.testing.assert_allclose(w, x, atol=TOL, rtol=TOL)


def test_non_batch_axes_are_refused(spawned):
    """The ResNet and the MNIST MLP shard only their batch: a tp mesh is
    refused, naming the axis (ROADMAP Queue 3, an intended divergence:
    JAX computes them replicated over it)."""
    for rec in spawned:
        for what, err in rec["refusals"].items():
            assert err is not None, what
            assert err[0] == "NotImplementedError" and "tp" in err[1], err
