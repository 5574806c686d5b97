"""MNIST MLP under data parallelism: the counterpart of the JAX package's
``models/mnist.py``.

An MLP, cross-entropy and SGD with momentum; the parameters are replicated
on every rank and the batch is sharded over the mesh's ``dp`` axis
(``batch_slice``). Where XLA inserts the gradient all-reduce, the port sums
the gradients over dp with ``reduce_gradients`` after the backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bee_code_interpreter_tpu_torch.device import resolve_device
from bee_code_interpreter_tpu_torch.parallel.mesh import (
    all_reduce_partial,
    batch_shard_of,
    batch_slice,
    mesh_groups,
    reduce_gradients,
)


class MnistMlp:
    def __init__(self, hidden_sizes: tuple[int, ...] = (512, 256),
                 n_classes: int = 10, input_dim: int = 784,
                 mesh=None) -> None:
        self.sizes = (input_dim, *hidden_sizes, n_classes)
        self.mesh = mesh
        self.groups = mesh_groups(mesh)
        others = [a for a in ("fsdp", "tp", "sp", "ep", "pp")
                  if self.groups.size(a) > 1]
        if others:
            raise NotImplementedError(
                f"the MNIST MLP shards only its batch over dp, not {others}")

    def init(self, generator: torch.Generator,
             device: torch.device | str | None = None) -> list[dict]:
        """``[{w [n_in, n_out], b [n_out]}, ...]``: He-normal weights and
        zero biases in f32 that require grad (JAX's distributions; the
        numbers differ from ``jax.random``'s), whole on every rank. The
        device defaults to the mesh's device type, else CUDA."""
        if device is None and self.mesh is not None:
            device = self.mesh.device_type
        device = resolve_device(device)
        params = []
        for n_in, n_out in zip(self.sizes[:-1], self.sizes[1:]):
            w = torch.randn(n_in, n_out, generator=generator, device=device)
            params.append({
                "w": w.mul_((2.0 / n_in) ** 0.5).requires_grad_(),
                "b": torch.zeros(n_out, device=device, requires_grad=True),
            })
        return params

    def apply(self, params: list[dict], x: torch.Tensor) -> torch.Tensor:
        for layer in params[:-1]:
            x = F.relu(x @ layer["w"] + layer["b"])
        return x @ params[-1]["w"] + params[-1]["b"]

    def loss(self, params: list[dict], batch: dict) -> torch.Tensor:
        """Mean softmax cross-entropy of ``batch`` (``image``, ``label``);
        under dp ``batch`` is the rank's rows and the value the global
        batch's."""
        logits = self.apply(params, batch["image"])
        losses = F.cross_entropy(logits, batch["label"].long(),
                                 reduction="none")
        if self.groups.dp is None:
            return losses.mean()
        n_shards = batch_shard_of(self.groups.dp)[1]
        return all_reduce_partial(losses.sum() / (losses.numel() * n_shards),
                                  self.groups.dp)

    def batch_slice(self, batch: dict) -> dict:
        """The rank's rows of a global batch (JAX's ``P("dp")``)."""
        if self.mesh is None:
            return dict(batch)
        return {k: batch_slice(x, self.mesh) for k, x in batch.items()}

    def make_train_step(self, learning_rate: float = 0.1):
        """``(train_step, optimizer)`` as JAX returns them: ``optimizer`` is
        ``optax.sgd(learning_rate, momentum=0.9)`` as a factory over the
        params (PyTorch's SGD without dampening is the same update), and
        ``train_step(params, opt_state, batch) -> (params, opt_state,
        loss)`` steps in place, ``opt_state`` None on the first call."""
        def optimizer(params):
            leaves = [w for layer in params for w in (layer["w"], layer["b"])]
            return torch.optim.SGD(leaves, lr=learning_rate, momentum=0.9)

        def train_step(params, opt_state, batch):
            if opt_state is None:
                opt_state = optimizer(params)
            opt_state.zero_grad(set_to_none=True)
            loss = self.loss(params, batch)
            loss.backward()
            if self.mesh is not None:
                reduce_gradients([(w, ()) for layer in params
                                  for w in (layer["w"], layer["b"])],
                                 self.groups)
            opt_state.step()
            return params, opt_state, loss.detach()

        return train_step, optimizer
