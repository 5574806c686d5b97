"""Vision Transformer (encoder) in PyTorch: the counterpart of the JAX
package's ``models/vit.py``.

Patches attend all-to-all through the decoder's attention dispatch
(``transformer._attention`` with ``causal=False``): the flash attention
``autograd.Function`` on the rank's own tokens (the forward kernel K1 and
the backward kernels K3/K4 on CUDA tensors, at ViT-B/16's head dim 64; the
plain versions on CPU tensors), ring attention or Ulysses across an ``sp``
mesh axis.

Parameters are a plain dict: ``patch_embed`` (the patchify conv,
``[d_model, 3, P, P]``, PyTorch's OIHW; ``weights.vit_params_from_jax``
turns JAX's HWIO into it), ``pos_embed [n_patches, d_model]``, ``layers``
(a list of per-layer dicts, where JAX stacks them for ``lax.scan``), ``ln_f``
and ``head`` (``w [d_model, classes]``, ``b``); projections keep JAX's
``[d_in, d_out]``. The masters are f32 and every einsum casts them to
``config.dtype``; the mean pool and the head run in f32, as in JAX.

Under a mesh each rank holds its shard (``param_specs``: Megatron columns
and rows over ``tp``, the other dim of each projection over ``fsdp``, the
patchify conv's output channels over ``tp``) and the rank's rows of the
batch (``ViT.batch_slice``: dp then fsdp). The model makes the collectives
itself, as ``models/transformer.py`` does: the patchify conv's channels
gathered over tp, the row-parallel ``wo``/``w_down`` reduced, fsdp leaves
gathered a layer at a time. Under ``sp`` a rank runs its contiguous block of
the patch tokens (each adds its slice of ``pos_embed``) and attends across
the sp ranks; the mean pool is a sum over sp divided by the patch count,
and the head, which is linear, runs on each rank's share of the pool with
the bias on the first rank, the logits summed over sp (Megatron's row
split): every rank's gradients are then its share, as ``reduce_gradients``
expects.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F

from bee_code_interpreter_tpu_torch.device import resolve_device
from bee_code_interpreter_tpu_torch.models.transformer import (
    _attention,
    rms_norm,
)
from bee_code_interpreter_tpu_torch.parallel.mesh import (
    all_reduce_partial,
    batch_shard_of,
    batch_slice,
    copy_to_group,
    gather_from_group,
    gather_shards,
    group_rank,
    group_size,
    mesh_groups,
    reduce_gradients,
    shard_tensor,
)

Params = dict[str, Any]
LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    num_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16
    sp_attention: str = "ring"  # sequence-parallel strategy over sp meshes

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def vit_b16(cls) -> "ViTConfig":
        """The classic ViT-Base/16 shape (~86M params, head dim 64)."""
        return cls()

    @classmethod
    def tiny(cls) -> "ViTConfig":
        return cls(image_size=32, patch_size=8, d_model=64, n_layers=2,
                   n_heads=4, d_ff=128, num_classes=10)


# ------------------------------------------------------------------- weights


def param_shapes(config: ViTConfig) -> dict:
    """Every leaf's shape: the top-level leaves and one layer's (for every
    layer)."""
    c = config
    d, p = c.d_model, c.patch_size
    return {
        "patch_embed": (d, 3, p, p),
        "pos_embed": (c.n_patches, d),
        "layers": {"ln1": (d,), "wq": (d, d), "wk": (d, d), "wv": (d, d),
                   "wo": (d, d), "ln2": (d,), "w_up": (d, c.d_ff),
                   "w_down": (c.d_ff, d)},
        "ln_f": (d,),
        "head": {"w": (d, c.num_classes), "b": (c.num_classes,)},
    }


def param_specs(config: ViTConfig, mesh) -> Params:
    """JAX's Megatron col/row specs over whichever of (fsdp, tp) the mesh
    has, as tuples of axis names per dim (``transformer.param_specs``'
    convention; ``layers`` holds one layer's specs, for every layer, where
    JAX's stacked specs add a leading None): column-parallel ``wq``/``wk``/
    ``wv``/``w_up`` ``(fsdp, tp)``, row-parallel ``wo``/``w_down`` ``(tp,
    fsdp)``, the patchify conv's output channels over tp (JAX's HWIO ``(None,
    None, None, tp)`` is OIHW's ``(tp, None, None, None)``), the rest
    replicated (the head too: num_classes rarely divides tp)."""
    return _specs(tuple(mesh.mesh_dim_names) if mesh is not None else ())


def _specs(names: tuple[str, ...]) -> Params:
    tp = "tp" if "tp" in names else None
    fsdp = "fsdp" if "fsdp" in names else None
    col, row, rep = (fsdp, tp), (tp, fsdp), ()
    return {
        "patch_embed": (tp, None, None, None),
        "pos_embed": (),
        "layers": {"ln1": rep, "ln2": rep, "wq": col, "wk": col, "wv": col,
                   "wo": row, "w_up": col, "w_down": row},
        "ln_f": (),
        "head": {"w": (None, None), "b": ()},
    }


def param_leaves(params: Params) -> list[torch.Tensor]:
    """Every weight in one fixed order (patch_embed, pos_embed, each
    layer's leaves, ln_f, head w, b): what the optimizer steps."""
    return ([params["patch_embed"], params["pos_embed"]]
            + [layer[k] for layer in params["layers"] for k in LAYER_KEYS]
            + [params["ln_f"], params["head"]["w"], params["head"]["b"]])


def leaf_specs(params: Params, specs: Params) -> list[tuple]:
    """``(leaf, spec)`` of every weight, in ``param_leaves``' order."""
    return ([(params["patch_embed"], specs["patch_embed"]),
             (params["pos_embed"], specs["pos_embed"])]
            + [(layer[k], specs["layers"][k]) for layer in params["layers"]
               for k in LAYER_KEYS]
            + [(params["ln_f"], specs["ln_f"]),
               (params["head"]["w"], specs["head"]["w"]),
               (params["head"]["b"], specs["head"]["b"])])


def n_params(params: Params) -> int:
    return sum(w.numel() for w in param_leaves(params))


def init_params(config: ViTConfig, generator: torch.Generator,
                device: torch.device | str | None = None,
                requires_grad: bool = False, mesh=None) -> Params:
    """f32 weights with the JAX ``init_params`` distributions (normal /
    sqrt(fan_in), ``pos_embed`` 0.02 normal, ones for the norms, a zero
    bias) on ``device`` (default CUDA; raises without it); ``generator``
    must live there. The numbers differ from ``jax.random``'s: tests load
    JAX's weights through ``weights.vit_params_from_jax``. With ``mesh``
    every leaf is drawn whole and the rank keeps its shard."""
    c = config
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(
            f"generator is on {generator.device}, weights go to {device}")
    shapes = param_shapes(c)

    def dense(fan_in, shape):
        w = torch.randn(shape, generator=generator, device=device)
        return w.div_(math.sqrt(fan_in))

    def ones(shape):
        return torch.ones(shape, device=device)

    d, p, s = c.d_model, c.patch_size, shapes["layers"]
    patch = dense(p * p * 3, shapes["patch_embed"])
    pos = 0.02 * torch.randn(shapes["pos_embed"], generator=generator,
                             device=device)
    layers = []
    for _ in range(c.n_layers):
        layer = {"ln1": ones(s["ln1"])}
        for name in ("wq", "wk", "wv", "wo"):
            layer[name] = dense(d, s[name])
        layer["ln2"] = ones(s["ln2"])
        layer["w_up"] = dense(d, s["w_up"])
        layer["w_down"] = dense(c.d_ff, s["w_down"])
        layers.append(layer)
    params = {"patch_embed": patch, "pos_embed": pos, "layers": layers,
              "ln_f": ones((d,)),
              "head": {"w": dense(d, shapes["head"]["w"]),
                       "b": torch.zeros(c.num_classes, device=device)}}
    if mesh is not None:
        return shard_params(params, c, mesh, device, requires_grad)
    for w in param_leaves(params):
        w.requires_grad_(requires_grad)
    return params


def _map_leaves(params: Params, fn, specs: Params) -> Params:
    """``fn(leaf, spec)`` over every leaf, in the tree's layout."""
    return {
        "patch_embed": fn(params["patch_embed"], specs["patch_embed"]),
        "pos_embed": fn(params["pos_embed"], specs["pos_embed"]),
        "layers": [{k: fn(layer[k], specs["layers"][k]) for k in LAYER_KEYS}
                   for layer in params["layers"]],
        "ln_f": fn(params["ln_f"], specs["ln_f"]),
        "head": {k: fn(params["head"][k], specs["head"][k])
                 for k in ("w", "b")},
    }


def shard_params(params: Params, config: ViTConfig, mesh,
                 device: torch.device | str | None = None,
                 requires_grad: bool = False) -> Params:
    """This rank's shard of every leaf under ``param_specs``, each a
    contiguous tensor of its own on ``device`` (default the mesh's device
    type); ``params`` (whole, anywhere) is only read."""
    device = resolve_device(device if device is not None
                            else mesh.device_type)
    return _map_leaves(
        params,
        lambda w, spec: shard_tensor(w, spec, mesh, device).requires_grad_(
            requires_grad),
        param_specs(config, mesh))


# ------------------------------------------------------------------- forward


def _whole_over_fsdp(layer: Params, fsdp_group) -> Params:
    """One layer's weights whole over fsdp: each leaf ``param_specs``
    shards over fsdp gathered along that dim (``gather_shards``, whose
    backward reduce-scatters the gradient)."""
    if fsdp_group is None:
        return layer
    specs = _specs(("fsdp",))["layers"]
    return {k: gather_shards(w, fsdp_group, specs[k].index("fsdp"))
            if "fsdp" in specs[k] else w for k, w in layer.items()}


def _patchify(params: Params, images: torch.Tensor, config: ViTConfig,
              tp_group) -> torch.Tensor:
    """The tokens ``[B, n_patches, d_model]`` in ``config.dtype``: one
    strided conv (JAX's NHWC x HWIO, here NCHW x OIHW over the same
    numbers), its output channels gathered over tp."""
    c = config
    x = images.to(c.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW (a view)
    y = F.conv2d(x, params["patch_embed"].to(c.dtype), stride=c.patch_size)
    y = gather_from_group(y, tp_group, 1)
    return y.permute(0, 2, 3, 1).reshape(y.shape[0], c.n_patches, c.d_model)


def _block(h: torch.Tensor, layer: Params, config: ViTConfig, groups):
    """One encoder layer on the rank's tokens ``[B, T, d_model]``."""
    c = config
    layer = _whole_over_fsdp(layer, groups.fsdp)
    tp = groups.tp
    B, T = h.shape[0], h.shape[1]
    nh, dh = c.n_heads // group_size(tp), c.head_dim
    x = copy_to_group(rms_norm(h, layer["ln1"]), tp)

    def proj(w):
        out = torch.einsum("btd,dk->btk", x, w.to(c.dtype))
        return out.reshape(B, T, nh, dh).transpose(1, 2).contiguous()

    q, k, v = proj(layer["wq"]), proj(layer["wk"]), proj(layer["wv"])
    attn = _attention(q, k, v, c.sp_attention, groups.sp, causal=False)
    attn = attn.transpose(1, 2).reshape(B, T, nh * dh)
    o = torch.einsum("btk,kd->btd", attn, layer["wo"].to(c.dtype))
    h = h + all_reduce_partial(o, tp)
    y = copy_to_group(rms_norm(h, layer["ln2"]), tp)
    up = torch.einsum("btd,df->btf", y, layer["w_up"].to(c.dtype))
    mlp = torch.einsum("btf,fd->btd", F.gelu(up, approximate="tanh"),
                       layer["w_down"].to(c.dtype))
    return h + all_reduce_partial(mlp, tp)


def forward(params: Params, images: torch.Tensor, config: ViTConfig,
            mesh=None) -> torch.Tensor:
    """Logits ``[B, num_classes]`` (f32) of ``images [B, H, W, 3]`` (NHWC,
    any float dtype; under batch axes the rank's rows, ``ViT.batch_slice``)."""
    c = config
    g = mesh_groups(mesh)
    if g.pp is not None or g.ep is not None:
        raise NotImplementedError(
            "the ViT runs over dp, fsdp, tp and sp (as JAX's: no pp or ep)")
    h = _patchify(params, images, c, g.tp) + params["pos_embed"].to(c.dtype)
    if g.sp is not None:
        # the rank's block of the tokens (a plain narrow: only the block's
        # gradient flows back, the rank's share that reduce_gradients sums)
        n, rest = divmod(c.n_patches, group_size(g.sp))
        if rest:
            raise ValueError(f"{c.n_patches} patches do not split over "
                             f"sp={group_size(g.sp)}")
        h = h.narrow(1, group_rank(g.sp) * n, n)
    for layer in params["layers"]:
        h = _block(h, layer, c, g)
    h = rms_norm(h, params["ln_f"])
    w, b = params["head"]["w"].float(), params["head"]["b"].float()
    if g.sp is None:
        pooled = h.mean(dim=1).float()  # global average pool, in dtype
        return pooled @ w + b
    # the rank's share of the pool through the (linear) head; the bias once
    # (times 0 on the other ranks, so every rank's b has a gradient and
    # reduce_gradients makes the same sums on each)
    share = h.float().sum(dim=1) / c.n_patches
    bias = b * float(group_rank(g.sp) == 0)
    return all_reduce_partial(share @ w + bias, g.sp)


def loss_fn(params: Params, batch: dict[str, torch.Tensor], config: ViTConfig,
            mesh=None) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels (optax's
    ``softmax_cross_entropy_with_integer_labels``), f32. Under batch axes
    ``batch`` is the rank's rows and the value is the global batch's on
    every rank (the ranks' shares summed), its gradient the rank's share."""
    logits = forward(params, batch["images"], config, mesh)
    losses = F.cross_entropy(logits, batch["labels"].long(), reduction="none")
    batch_groups = mesh_groups(mesh).batch
    if not batch_groups:
        return losses.mean()
    n_shards = batch_shard_of(batch_groups)[1]
    return all_reduce_partial(losses.sum() / (losses.numel() * n_shards),
                              batch_groups)


def _adamw(params: Params, *, lr: float, weight_decay: float):
    # optax.adamw(lr, weight_decay=wd) with its defaults b1 0.9, b2 0.999,
    # eps 1e-8 over every leaf: the same algebra as PyTorch's AdamW (see
    # transformer._adamw)
    return torch.optim.AdamW(param_leaves(params), lr=lr, betas=(0.9, 0.999),
                             weight_decay=weight_decay, eps=1e-8)


class ViT:
    """Config + mesh bundle with the JAX ``ViT``'s entry points: ``init``
    (f32 masters that require grad, the rank's shard under a mesh),
    ``apply``, ``make_train_step`` and ``batch_slice`` (the rank's rows of a
    global batch, JAX's ``batch_sharding()``)."""

    def __init__(self, config: ViTConfig, mesh=None) -> None:
        self.config = config
        self.mesh = mesh
        self.groups = mesh_groups(mesh)

    def init(self, generator: torch.Generator,
             device: torch.device | str | None = None) -> Params:
        if self.mesh is not None and device is None:
            device = self.mesh.device_type
        return init_params(self.config, generator, device, requires_grad=True,
                           mesh=self.mesh)

    def apply(self, params: Params, images: torch.Tensor) -> torch.Tensor:
        return forward(params, images, self.config, self.mesh)

    def batch_slice(self, batch: dict[str, torch.Tensor]) -> dict:
        if self.mesh is None:
            return dict(batch)
        return {k: batch_slice(x, self.mesh) for k, x in batch.items()}

    def make_optimizer(self, learning_rate: float = 3e-4,
                       weight_decay: float = 0.05):
        """JAX's default ``optax.adamw(3e-4, weight_decay=0.05)`` as a
        factory over the params."""
        return functools.partial(_adamw, lr=learning_rate,
                                 weight_decay=weight_decay)

    def make_train_step(self, optimizer=None):
        """``train_step(params, opt_state, batch) -> (params, opt_state,
        loss)``, in place (JAX donates params and state); ``opt_state`` is
        ``optimizer(params)`` or None on the first step. Under a mesh each
        gradient is summed over the batch axes and sp where its leaf is
        whole (``reduce_gradients``) before the step."""
        optimizer = optimizer or self.make_optimizer()
        config, mesh = self.config, self.mesh

        def train_step(params, opt_state, batch):
            if opt_state is None:
                opt_state = optimizer(params)
            opt_state.zero_grad(set_to_none=True)
            loss = loss_fn(params, batch, config, mesh)
            loss.backward()
            if mesh is not None:
                reduce_gradients(leaf_specs(params, param_specs(config, mesh)),
                                 self.groups)
            opt_state.step()
            return params, opt_state, loss.detach()

        return train_step
