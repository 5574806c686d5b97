"""ResNet-style vision model in PyTorch: the counterpart of the JAX
package's ``models/vision.py`` (bottleneck blocks, GroupNorm, NHWC).

The activations keep JAX's NHWC layout at every public function: a conv
sees them as PyTorch's NCHW through a permuted view, which is the
channels-last memory format, so nothing is copied between layers and
cuDNN runs its channels-last kernels. The convolutions are cuDNN's
(``F.conv2d``), as JAX leaves them to XLA: the ResNet runs none of the
port's kernels. Conv weights are PyTorch's OIHW (``weights.
replicated_params_from_jax`` turns JAX's HWIO into it), f32 masters cast to
``config.dtype`` at every conv; GroupNorm keeps f32 statistics and the
head runs in f32.

JAX's ``SAME`` padding puts the odd pixel of a strided window at the end:
the stem's 7x7 at stride 2 on 224 pads (2, 3), a stride-2 3x3 on 56 pads
(0, 1), the 3x3 max pool at stride 2 on 112 pads (0, 1) with -inf.
``conv`` and ``max_pool_same`` pad explicitly where the two sides differ
(``nn.Conv2d(padding=3)`` would give the right shape over shifted windows).

Under a mesh the parameters are replicated and the batch is sharded over
the batch axes (dp, then fsdp): each rank runs its rows, the loss is the
global batch's, and ``reduce_gradients`` sums the gradients.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

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

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 1000
    stage_sizes: tuple[int, ...] = (3, 4, 6, 3)  # resnet50 bottleneck depths
    width: int = 64  # stem channels; stage c is width * 2**c (x4 expanded)
    norm_groups: int = 32
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def resnet50(cls) -> "ResNetConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "ResNetConfig":
        """Test/dry-run size (2 stages, 8-wide stem)."""
        return cls(num_classes=10, stage_sizes=(1, 1), width=8, norm_groups=4)


# ---------------------------------------------------------------- primitives


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial dim: (before, after), the odd
    pixel after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC x OIHW -> NHWC, ``SAME`` padding (JAX's ``conv``)."""
    kh, kw = w.shape[2], w.shape[3]
    (top, bottom), (left, right) = (same_pads(x.shape[1], kh, stride),
                                    same_pads(x.shape[2], kw, stride))
    xc = x.permute(0, 3, 1, 2)  # NCHW, channels-last in memory
    w = w.contiguous(memory_format=torch.channels_last)
    if top == bottom and left == right:
        y = F.conv2d(xc, w, stride=stride, padding=(top, left))
    else:
        y = F.conv2d(F.pad(xc, (left, right, top, bottom)), w, stride=stride)
    return y.permute(0, 2, 3, 1)


def max_pool_same(x: torch.Tensor, window: int = 3,
                  stride: int = 2) -> torch.Tensor:
    """JAX's ``reduce_window(x, -inf, max, (1, w, w, 1), (1, s, s, 1),
    "SAME")`` on NHWC: the padding is -inf, never a real value."""
    (top, bottom), (left, right) = (same_pads(x.shape[1], window, stride),
                                    same_pads(x.shape[2], window, stride))
    xc = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom),
               value=float("-inf"))
    return F.max_pool2d(xc, window, stride).permute(0, 2, 3, 1)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int) -> torch.Tensor:
    """Per-sample normalization of NHWC ``x`` over (H, W, C/groups) with
    f32 statistics; ``groups`` is clamped to the largest divisor of C not
    exceeding it (C=48 with groups=32 normalizes in 24 groups of 2), as
    JAX's code does."""
    N, H, W, C = x.shape
    g = min(groups, C)
    while C % g:
        g -= 1
    xf = x.float().reshape(N, H, W, g, C // g)
    mean = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = xf.var(dim=(1, 2, 4), keepdim=True, unbiased=False)
    xf = ((xf - mean) * torch.rsqrt(var + 1e-5)).reshape(N, H, W, C)
    return (xf * scale.float() + bias.float()).to(x.dtype)


# ------------------------------------------------------------------- weights


def _block_stride(stage: int, block: int) -> int:
    """Downsampling policy, the one source for init and forward."""
    return 2 if (block == 0 and stage > 0) else 1


def init_params(config: ResNetConfig, generator: torch.Generator,
                device: torch.device | str | None = None,
                requires_grad: bool = False) -> Params:
    """f32 weights with the JAX ``init_params`` distributions (He normal
    convs, ones/zeros norms, normal / sqrt(fan_in) head) on ``device``
    (default CUDA; raises without it). The numbers differ from
    ``jax.random``'s: tests load JAX's weights through
    ``weights.replicated_params_from_jax``."""
    c = config
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(
            f"generator is on {generator.device}, weights go to {device}")

    def conv_w(kh, kw, c_in, c_out):
        w = torch.randn(c_out, c_in, kh, kw, generator=generator, device=device)
        return w.mul_(math.sqrt(2.0 / (kh * kw * c_in)))

    def norm(ch):
        return {"scale": torch.ones(ch, device=device),
                "bias": torch.zeros(ch, device=device)}

    params: Params = {"stem": conv_w(7, 7, 3, c.width),
                      "stem_norm": norm(c.width)}
    c_in = c.width
    for s, depth in enumerate(c.stage_sizes):
        c_mid = c.width * 2 ** s
        blocks = []
        for b in range(depth):
            stride, c_out = _block_stride(s, b), 4 * c_mid
            block = {"conv1": conv_w(1, 1, c_in, c_mid), "n1": norm(c_mid),
                     "conv2": conv_w(3, 3, c_mid, c_mid), "n2": norm(c_mid),
                     "conv3": conv_w(1, 1, c_mid, c_out), "n3": norm(c_out)}
            if stride != 1 or c_in != c_out:
                block["proj"] = conv_w(1, 1, c_in, c_out)
                block["nproj"] = norm(c_out)
            blocks.append(block)
            c_in = c_out
        params[f"stage{s}"] = blocks
    w = torch.randn(c_in, c.num_classes, generator=generator, device=device)
    params["fc"] = {"w": w.div_(math.sqrt(c_in)),
                    "b": torch.zeros(c.num_classes, device=device)}
    for leaf in param_leaves(params):
        leaf.requires_grad_(requires_grad)
    return params


def param_leaves(params) -> list[torch.Tensor]:
    """Every weight, in the tree's order (dicts in insertion order, lists
    in order): what the optimizer steps."""
    if isinstance(params, dict):
        return [w for v in params.values() for w in param_leaves(v)]
    if isinstance(params, (list, tuple)):
        return [w for v in params for w in param_leaves(v)]
    return [params]


def n_params(params: Params) -> int:
    return sum(w.numel() for w in param_leaves(params))


# ------------------------------------------------------------------- forward


def _block_apply(x, p, config: ResNetConfig, stride: int):
    g, dt = config.norm_groups, config.dtype
    y = F.relu(group_norm(conv(x, p["conv1"].to(dt)), **p["n1"], groups=g))
    y = F.relu(group_norm(conv(y, p["conv2"].to(dt), stride), **p["n2"],
                          groups=g))
    y = group_norm(conv(y, p["conv3"].to(dt)), **p["n3"], groups=g)
    shortcut = x
    if "proj" in p:
        shortcut = group_norm(conv(x, p["proj"].to(dt), stride), **p["nproj"],
                              groups=g)
    return F.relu(y + shortcut)


def forward(params: Params, images: torch.Tensor,
            config: ResNetConfig) -> torch.Tensor:
    """Logits ``[N, num_classes]`` (f32) of ``images [N, H, W, 3]`` (NHWC,
    any float dtype; under a mesh the rank's rows)."""
    c = config
    x = images.to(c.dtype)
    x = conv(x, params["stem"].to(c.dtype), stride=2)
    x = F.relu(group_norm(x, **params["stem_norm"], groups=c.norm_groups))
    x = max_pool_same(x)
    for s, depth in enumerate(c.stage_sizes):
        for b in range(depth):
            x = _block_apply(x, params[f"stage{s}"][b], c, _block_stride(s, b))
    pooled = x.mean(dim=(1, 2)).float()  # global average pool, in dtype
    return pooled @ params["fc"]["w"] + params["fc"]["b"]


def _check_mesh(mesh):
    groups = mesh_groups(mesh)
    others = [a for a in ("tp", "sp", "ep", "pp") if groups.size(a) > 1]
    if others:
        raise NotImplementedError(
            f"the ResNet shards only its batch (dp, fsdp), not {others}")
    return groups


def loss_fn(params: Params, batch: dict[str, torch.Tensor],
            config: ResNetConfig, mesh=None) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels, f32; under a mesh
    ``batch`` is the rank's rows and the value the global batch's."""
    logits = forward(params, batch["images"], config)
    losses = F.cross_entropy(logits, batch["labels"].long(), reduction="none")
    batch_groups = _check_mesh(mesh).batch
    if not batch_groups:
        return losses.mean()
    n_shards = batch_shard_of(batch_groups)[1]
    return all_reduce_partial(losses.sum() / (losses.numel() * n_shards),
                              batch_groups)


def _sgd(params: Params, *, lr: float, momentum: float):
    # optax.sgd(lr, momentum): trace = g + momentum * trace, p -= lr * trace,
    # the trace starting at zero: PyTorch's SGD without dampening
    return torch.optim.SGD(param_leaves(params), lr=lr, momentum=momentum)


class ResNet:
    """Config + mesh bundle with the JAX ``ResNet``'s entry points."""

    def __init__(self, config: ResNetConfig, mesh=None) -> None:
        self.config = config
        self.mesh = mesh
        self.groups = _check_mesh(mesh)

    def init(self, generator: torch.Generator,
             device: torch.device | str | None = None) -> Params:
        """f32 masters that require grad, whole on every rank."""
        if self.mesh is not None and device is None:
            device = self.mesh.device_type
        return init_params(self.config, generator, device, requires_grad=True)

    def apply(self, params: Params, images: torch.Tensor) -> torch.Tensor:
        return forward(params, images, self.config)

    def batch_slice(self, batch: dict[str, torch.Tensor]) -> dict:
        """The rank's rows of a global batch (JAX's ``batch_sharding()``)."""
        if self.mesh is None:
            return dict(batch)
        return {k: batch_slice(x, self.mesh) for k, x in batch.items()}

    def make_optimizer(self, learning_rate: float = 0.1,
                       momentum: float = 0.9):
        """JAX's default ``optax.sgd(0.1, momentum=0.9)`` as a factory."""
        return lambda params: _sgd(params, lr=learning_rate, momentum=momentum)

    def make_train_step(self, optimizer=None):
        """``train_step(params, opt_state, batch) -> (params, opt_state,
        loss)``, in place; ``opt_state`` is ``optimizer(params)`` or None on
        the first step. Under a mesh the gradients are summed over the
        batch axes before the step."""
        optimizer = optimizer or self.make_optimizer()
        config, mesh, groups = self.config, self.mesh, self.groups

        def train_step(params, opt_state, batch):
            if opt_state is None:
                opt_state = optimizer(params)
            opt_state.zero_grad(set_to_none=True)
            loss = loss_fn(params, batch, config, mesh)
            loss.backward()
            if mesh is not None:
                reduce_gradients([(w, ()) for w in param_leaves(params)],
                                 groups)
            opt_state.step()
            return params, opt_state, loss.detach()

        return train_step
