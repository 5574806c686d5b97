"""Rank functions of the vision family's mesh parity tests
(tests/test_torch_vit.py, tests/test_torch_vision.py,
tests/test_torch_mnist.py).

``parallel.spawn`` starts each rank as a fresh process that imports this
module by name, so it imports no JAX: the JAX side runs in the test
process, and the weights, images and labels cross as numpy arrays.
"""

from __future__ import annotations

import dataclasses

import torch

from bee_code_interpreter_tpu_torch.models import vision as R
from bee_code_interpreter_tpu_torch.models import vit as V
from bee_code_interpreter_tpu_torch.models.mnist import MnistMlp
from bee_code_interpreter_tpu_torch.parallel import mesh as M
from bee_code_interpreter_tpu_torch.weights import (
    replicated_params_from_jax,
    vit_params_from_jax,
)
from tests.torch_tp_worker import error_of, to_np

# several ranks share the CPU with the other test workers
torch.set_num_threads(1)

# case -> (mesh axes, sp_attention); four ranks each
VIT_CASES = {
    "dp2_tp2": ({"dp": 2, "tp": 2}, "ring"),
    "fsdp2_tp2": ({"fsdp": 2, "tp": 2}, "ring"),
    "sp4_ring": ({"sp": 4}, "ring"),
    "sp4_ulysses": ({"sp": 4}, "ulysses"),
}
MNIST_STEPS = 30


def vit_config(sp_attention: str = "ring") -> V.ViTConfig:
    return dataclasses.replace(V.ViTConfig.tiny(), dtype=torch.float32,
                               sp_attention=sp_attention)


def coords(mesh) -> dict:
    return {a: M.axis_index(mesh, a) for a in M.axis_sizes(mesh)}


def tensors(batch_np: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch_np.items()}


def vit_cases(rank: int, inputs: dict) -> dict:
    """Each ``VIT_CASES`` mesh: the forward of the rank's rows, one AdamW
    train step (its loss, the rank's gradients after the sums over the
    batch axes and sp, and its shards after the step) and the specs."""
    out = {}
    for name, (axes, attention) in VIT_CASES.items():
        cfg = vit_config(attention)
        mesh = M.make_mesh(axes, device_type="cpu")
        model = V.ViT(cfg, mesh)
        params = vit_params_from_jax(inputs["params"], cfg, mesh=mesh,
                                     requires_grad=True)
        batch = model.batch_slice(tensors(inputs["batch"]))
        with torch.no_grad():
            logits = model.apply(params, batch["images"])
        params, _, loss = model.make_train_step()(params, None, batch)
        out[name] = {"logits": logits.numpy(), "loss": float(loss),
                     "grads": [w.grad.numpy() for w in V.param_leaves(params)],
                     "params": to_np(params), "coords": coords(mesh),
                     "specs": V.param_specs(cfg, mesh)}
    return out


def resnet_dp(rank: int, inputs: dict) -> dict:
    """Two ranks at dp=2: the ResNet's forward of its rows and one SGD
    step; then the refusal of a tp mesh by the ResNet and the MLP."""
    mesh = M.make_mesh({"dp": 2}, device_type="cpu")
    cfg = dataclasses.replace(R.ResNetConfig.tiny(), dtype=torch.float32)
    model = R.ResNet(cfg, mesh)
    params = replicated_params_from_jax(inputs["params"], mesh=mesh,
                                    requires_grad=True)
    batch = model.batch_slice(tensors(inputs["batch"]))
    with torch.no_grad():
        logits = model.apply(params, batch["images"])
    params, _, loss = model.make_train_step()(params, None, batch)
    tp = M.make_mesh({"tp": 2}, device_type="cpu")
    return {"logits": logits.numpy(), "loss": float(loss),
            "grads": [w.grad.numpy() for w in R.param_leaves(params)],
            "params": to_np(params), "coords": coords(mesh),
            "refusals": {"resnet_tp": error_of(lambda: R.ResNet(cfg, tp)),
                         "mnist_tp": error_of(lambda: MnistMlp(mesh=tp))}}


def mnist_dp(rank: int, inputs: dict) -> dict:
    """Two ranks at dp=2: the MNIST MLP's ``MNIST_STEPS`` SGD steps on one
    batch, each rank its rows."""
    mesh = M.make_mesh({"dp": 2}, device_type="cpu")
    mlp = MnistMlp(hidden_sizes=(64,), mesh=mesh)
    params = replicated_params_from_jax(inputs["params"], mesh=mesh,
                                   requires_grad=True)
    step, _ = mlp.make_train_step(0.1)
    batch = mlp.batch_slice(tensors(inputs["batch"]))
    losses, opt = [], None
    for _ in range(MNIST_STEPS):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    return {"losses": losses, "params": to_np(params)}
