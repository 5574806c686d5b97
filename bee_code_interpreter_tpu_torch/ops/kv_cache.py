"""Int8 KV-cache quantization for the contiguous decode path.

The counterpart of ``bee_code_interpreter_tpu/ops/kv_cache.py``. K/V stored
as int8 with one f32 absmax scale per (token, head) row halve the bytes a
decode step streams against bf16 (the scales add 4 bytes a 128-wide row).

Symmetric per-row quantization: ``s = absmax(x) / 127`` over the head_dim
axis, ``q = round(x / s)`` (half to even, as ``jnp.round``), all in f32 and
in the JAX order of operations, so the int8 values agree bitwise with the
JAX package's on identical inputs. A zero row gets scale 0 and exact zeros.

The layout is self-describing: scale leaves (``k_s``/``v_s``) select the
int8 strategy in ``cache_append``/``cache_read``, on one layer's views and
on the whole ``[n_layers, ...]`` stack alike. Where JAX returns updated
arrays, ``cache_append`` writes in place and returns the same dict.
"""

from __future__ import annotations

import torch


def quantize(x: torch.Tensor, dim: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 values of ``x``'s shape, f32 scales with ``dim`` of size 1)."""
    xf = x.float()
    scale = xf.abs().amax(dim=dim, keepdim=True) / 127.0
    q = torch.where(scale > 0.0, torch.round(xf / scale.clamp_min(1e-30)), 0.0)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def cache_append(c_layer: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: int) -> dict:
    """Write W new K/V rows at positions ``pos..pos+W-1`` of the -2 axis,
    in place. As ``lax.dynamic_update_slice`` does, a start that would run
    past the end is moved back so the W rows fit. The int8 layout quantizes
    each (token, head) row on its own, so a window append is bitwise equal
    to W single appends."""
    size, W = c_layer["k"].shape[-2], k_new.shape[-2]
    start = min(max(int(pos), 0), size - W)

    def put(name: str, val: torch.Tensor) -> None:
        c_layer[name].narrow(-2, start, W).copy_(val)

    if "k_s" in c_layer:
        for name, new in (("k", k_new), ("v", v_new)):
            q, s = quantize(new)
            put(name, q)
            put(name + "_s", s)
    else:
        put("k", k_new)
        put("v", v_new)
    return c_layer


def cache_read(c_layer: dict, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(K in f32 for the scores einsum, V for the output einsum): the int8
    layout dequantizes V to ``dtype``, the plain layout's V is the stored
    tensor (in the compute dtype), as in JAX."""
    if "k_s" in c_layer:
        return (dequantize(c_layer["k"], c_layer["k_s"]),
                dequantize(c_layer["v"], c_layer["v_s"], dtype))
    return c_layer["k"].float(), c_layer["v"]
