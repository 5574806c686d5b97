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
"""

from __future__ import annotations

import numpy as np
import torch

from bee_code_interpreter_tpu_torch.device import resolve_device

LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w_gate", "w_up", "w_down")


def params_from_jax(params_np: dict, config, device=None,
                    dtype: torch.dtype | None = None,
                    requires_grad: bool = False) -> dict:
    """``params_np`` is the JAX pytree with numpy leaves (e.g.
    ``jax.tree.map(np.asarray, params)``). ``device`` defaults to CUDA and
    raises without it; ``requires_grad`` makes every leaf a trainable
    master."""
    device = resolve_device(device)
    dtype = dtype or config.dtype

    def leaf(x) -> torch.Tensor:
        if isinstance(x, dict):
            raise NotImplementedError(
                "weight-only int8 leaves are not ported yet (ROADMAP Queue 1)"
            )
        arr = np.array(x, dtype=np.float32)  # a writable copy
        out = torch.from_numpy(arr).to(device=device, dtype=dtype)
        return out.requires_grad_(requires_grad)

    stacked = params_np["layers"]
    if "moe" in stacked:
        raise NotImplementedError("MoE is not ported yet (ROADMAP Queue 1)")
    unknown = set(stacked) - set(LAYER_KEYS)
    if unknown:
        raise ValueError(f"unexpected layer leaves {sorted(unknown)}")
    n_layers = int(np.asarray(stacked["wq"]).shape[0])
    if n_layers != config.n_layers:
        raise ValueError(
            f"pytree has {n_layers} layers, config says {config.n_layers}"
        )
    layers = [
        {name: leaf(np.asarray(stacked[name])[i]) for name in LAYER_KEYS}
        for i in range(n_layers)
    ]
    return {
        "embed": leaf(params_np["embed"]),
        "layers": layers,
        "ln_f": leaf(params_np["ln_f"]),
        "lm_head": leaf(params_np["lm_head"]),
    }
