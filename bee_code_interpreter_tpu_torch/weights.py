"""Weight bridge: the JAX package's parameter pytree, as numpy arrays, into
the port's parameter dict.

The JAX pytree (``models/transformer.py::init_params`` there) is ``embed``,
``ln_f``, ``lm_head`` and ``layers``, whose leaves are stacked on a leading
``n_layers`` axis for ``lax.scan``. The port keeps one dict per layer, so the
stack is split here. Serving casts the weights once, to ``dtype`` (default
``config.dtype``), on the way in; the JAX code casts its f32 masters at
every einsum instead, to the same values. Training takes them as f32 masters
that require grad (``dtype=torch.float32, requires_grad=True``) and casts at
every einsum as JAX does.

Weight-only-int8 leaves (``{"q": int8, "s": f32}``, ``ops/weight_quant.py``)
cross as they are: ``q`` stays int8 and ``s`` f32 whatever ``dtype`` says,
split per layer like every other leaf. A Mixture-of-Experts tree's
``layers.moe`` dict (``router``, ``we_gate``, ``we_up``, ``we_down``, each
stacked ``[n_layers, ...]``) becomes each layer's ``moe`` dict, cast like
the dense leaves.

Under a mesh (``mesh=``) the tree feeds ``transformer.shard_params``: the
rank keeps its shard on its device, the slice of each leaf that JAX's
``shard_params`` puts on the device at the rank's mesh coordinates (a
Mixture-of-Experts layer's experts over ep, each expert's d_ff over tp,
the other dim of a projection over fsdp; under pp only the rank's stage
block of the layers), trainable masters with ``requires_grad``.

``cache_from_jax`` carries a JAX decode cache or page pool the same way, so
tests can seed both frameworks with the same K/V state.

The vision family crosses the same way, as f32 masters by default (JAX
keeps f32 masters and casts at every einsum or conv):
``vit_params_from_jax`` (the stacked layers split per layer) and
``replicated_params_from_jax`` (the ResNet's and the MNIST MLP's trees,
whole on every rank). JAX's convs are
HWIO (the ViT's ``patch_embed`` and every ResNet conv); the port's are
PyTorch's OIHW, and this is the one place the layout changes.
"""

from __future__ import annotations

import numpy as np
import torch

from bee_code_interpreter_tpu_torch.device import resolve_device
from bee_code_interpreter_tpu_torch.models.moe import MOE_KEYS

LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w_gate", "w_up", "w_down")
MOE_LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "moe")


def params_from_jax(params_np: dict, config, device=None,
                    dtype: torch.dtype | None = None,
                    requires_grad: bool = False, mesh=None) -> dict:
    """``params_np`` is the JAX pytree with numpy leaves (e.g.
    ``jax.tree.map(np.asarray, params)``). ``device`` defaults to CUDA and
    raises without it; ``requires_grad`` makes every leaf a trainable
    master. With ``mesh`` the result is this rank's shard
    (``transformer.shard_params``; with ``requires_grad``, trainable masters
    for ``Transformer.make_train_step`` under that mesh), the whole tree
    crossing on the CPU first; ``device`` then defaults to the mesh's
    device type."""
    if mesh is not None:
        from bee_code_interpreter_tpu_torch.models.transformer import (
            param_leaves,
            shard_params,
        )

        full = params_from_jax(params_np, config, device="cpu", dtype=dtype)
        shard = shard_params(full, config, mesh, device)
        for leaf in param_leaves(shard):
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
                leaf.requires_grad_(requires_grad)
        return shard
    device = resolve_device(device)
    dtype = dtype or config.dtype

    def leaf(x):
        if isinstance(x, dict):  # weight-only int8: {"q", "s"} as they are
            return {name: torch.from_numpy(np.array(x[name])).to(device)
                    for name in ("q", "s")}
        arr = np.array(x, dtype=np.float32)  # a writable copy
        out = torch.from_numpy(arr).to(device=device, dtype=dtype)
        return out.requires_grad_(requires_grad)

    def layer_slice(x, i):
        if isinstance(x, dict):
            return {name: np.asarray(v)[i] for name, v in x.items()}
        return np.asarray(x)[i]

    stacked = params_np["layers"]
    if ("moe" in stacked) != bool(config.n_experts):
        raise ValueError(
            f"the pytree {'has' if 'moe' in stacked else 'lacks'} an MoE "
            f"tree (layers.moe) and the config has n_experts="
            f"{config.n_experts}"
        )
    keys = MOE_LAYER_KEYS if config.n_experts else LAYER_KEYS
    unknown = set(stacked) - set(keys)
    if unknown:
        raise ValueError(f"unexpected layer leaves {sorted(unknown)}")
    if config.n_experts:
        moe = stacked["moe"]
        if set(moe) != set(MOE_KEYS):
            raise ValueError(f"unexpected MoE leaves {sorted(moe)}")
        n_experts = np.asarray(moe["router"]).shape[-1]
        if n_experts != config.n_experts:
            raise ValueError(
                f"pytree has {n_experts} experts, config says "
                f"{config.n_experts}"
            )
    wq = stacked["wq"]
    n_layers = int(np.asarray(wq["q"] if isinstance(wq, dict) else wq).shape[0])
    if n_layers != config.n_layers:
        raise ValueError(
            f"pytree has {n_layers} layers, config says {config.n_layers}"
        )

    def layer_leaf(name, i):
        if name == "moe":
            return {k: leaf(np.asarray(stacked["moe"][k])[i]) for k in MOE_KEYS}
        return leaf(layer_slice(stacked[name], i))

    layers = [{name: layer_leaf(name, i) for name in keys}
              for i in range(n_layers)]
    return {
        "embed": leaf(params_np["embed"]),
        "layers": layers,
        "ln_f": leaf(params_np["ln_f"]),
        "lm_head": leaf(params_np["lm_head"]),
    }


def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array as a torch tensor of the same dtype (bfloat16 arrays,
    which numpy only knows through ml_dtypes, cross as their bits)."""
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(arr).view(np.uint16).astype(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def cache_from_jax(cache: dict, device=None) -> dict:
    """A JAX contiguous decode cache (``alloc_decode_cache``: leaves
    ``[n_layers, B, kvh, max, ·]``) or page pool (``alloc_paged_cache``:
    ``[n_layers, n_pages, kvh, ps, ·]``), bf16/f32 or int8 with ``k_s``/
    ``v_s`` scales, given as numpy arrays, in the port's layout: the same
    stacked leaves and dtypes, on ``device`` (default CUDA; raises without
    it)."""
    device = resolve_device(device)
    return {name: _tensor(np.asarray(x), device) for name, x in cache.items()}


def _master(x, device, dtype, requires_grad: bool) -> torch.Tensor:
    """One numpy leaf as a tensor of ``dtype`` on ``device``; 4-D arrays
    are JAX's HWIO conv kernels and become OIHW."""
    arr = np.array(x, dtype=np.float32)  # a writable copy
    if arr.ndim == 4:
        arr = np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
    out = torch.from_numpy(arr).to(device=device, dtype=dtype)
    return out.requires_grad_(requires_grad)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, fn) for v in x]
    return fn(x)


def vit_params_from_jax(params_np: dict, config, device=None,
                        dtype: torch.dtype = torch.float32,
                        requires_grad: bool = False, mesh=None) -> dict:
    """The JAX ViT pytree (``models/vit.py::init_params`` there, numpy
    leaves) in ``models/vit.py``'s layout: ``layers`` split per layer,
    ``patch_embed`` OIHW. ``device`` defaults to CUDA (raises without it);
    with ``mesh`` the rank's shard (``vit.shard_params``), ``device`` then
    defaulting to the mesh's device type."""
    from bee_code_interpreter_tpu_torch.models import vit

    if mesh is not None:
        full = vit_params_from_jax(params_np, config, "cpu", dtype)
        return vit.shard_params(full, config, mesh, device, requires_grad)
    device = resolve_device(device)
    stacked = params_np["layers"]
    if set(stacked) != set(vit.LAYER_KEYS):
        raise ValueError(f"unexpected ViT layer leaves {sorted(stacked)}")
    n_layers = int(np.asarray(stacked["wq"]).shape[0])
    if n_layers != config.n_layers:
        raise ValueError(
            f"pytree has {n_layers} layers, config says {config.n_layers}")

    def leaf(x):
        return _master(x, device, dtype, requires_grad)

    return {
        "patch_embed": leaf(params_np["patch_embed"]),
        "pos_embed": leaf(params_np["pos_embed"]),
        "layers": [{k: leaf(np.asarray(stacked[k])[i]) for k in vit.LAYER_KEYS}
                   for i in range(n_layers)],
        "ln_f": leaf(params_np["ln_f"]),
        "head": {k: leaf(params_np["head"][k]) for k in ("w", "b")},
    }


def replicated_params_from_jax(params_np, device=None,
                               dtype: torch.dtype = torch.float32,
                               requires_grad: bool = False, mesh=None):
    """A JAX tree whose parameters every rank holds whole (the ResNet's,
    ``models/vision.py::init_params`` there, and the MNIST MLP's ``[{w,
    b}, ...]``) in the same layout, every conv OIHW, on ``device``
    (default the mesh's device type, else CUDA)."""
    if device is None and mesh is not None:
        device = mesh.device_type
    device = resolve_device(device)
    return _tree(params_np,
                 lambda x: _master(x, device, dtype, requires_grad))
