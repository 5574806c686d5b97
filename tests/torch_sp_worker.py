"""Rank functions of the sequence-parallel parity tests
(tests/test_torch_ring_attention.py, tests/test_torch_ulysses.py and the
sp cases of tests/test_torch_serving_mesh.py).

Like ``tests/torch_tp_worker.py``, this module imports no JAX: each rank is
a fresh process spawned by ``parallel.spawn`` with gloo on the CPU, the
inputs cross as numpy arrays, and every rank returns plain records that
the tests hold against the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bee_code_interpreter_tpu_torch.models import transformer as T
from bee_code_interpreter_tpu_torch.models.serving import ContinuousBatcher
from bee_code_interpreter_tpu_torch.parallel import mesh as M
from bee_code_interpreter_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ring_attention_sharded,
)
from bee_code_interpreter_tpu_torch.parallel.ulysses import (
    ulysses_attention,
    ulysses_attention_sharded,
)
from bee_code_interpreter_tpu_torch.weights import params_from_jax
from tests.torch_tp_worker import error_of, host_state, tiny_config

torch.set_num_threads(1)


def qkv(seed, B, H, KVH, L, D) -> dict:
    """q ``[B, H, L, D]`` and k/v ``[B, KVH, L, D]``, f32 normal draws of
    numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    return {"q": rng.standard_normal((B, H, L, D), dtype=np.float32),
            "k": rng.standard_normal((B, KVH, L, D), dtype=np.float32),
            "v": rng.standard_normal((B, KVH, L, D), dtype=np.float32)}


def case(seed, shape, **kw) -> dict:
    """One attention case: ``qkv(seed, *shape)`` and the entry's keyword
    arguments."""
    return {**qkv(seed, *shape), "kw": kw}


def _tensors(case: dict) -> list[torch.Tensor]:
    return [torch.from_numpy(np.asarray(case[n])) for n in ("q", "k", "v")]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


def attention_cases(rank: int, fn_name: str, cases: dict) -> dict:
    """Each case of ``cases`` (name -> q/k/v numpy arrays and keyword
    arguments) through ``ring_attention_sharded`` or
    ``ulysses_attention_sharded`` on an sp mesh over every rank; the whole
    output of each, and the errors of the refusal cases."""
    sharded = {"ring": ring_attention_sharded,
               "ulysses": ulysses_attention_sharded}[fn_name]
    mesh = M.make_mesh({"sp": M.world_size()}, device_type="cpu")
    out: dict = {}
    for name, case in cases.items():
        q, k, v = _tensors(case)
        if case.get("bf16"):
            q, k, v = _bf16(q), _bf16(k), _bf16(v)
        kw = case.get("kw", {})
        if case.get("expect_error"):
            out[name] = error_of(lambda: sharded(mesh, q, k, v, **kw))
            continue
        got = sharded(mesh, q, k, v, **kw)
        out[name] = {"dtype": str(got.dtype),
                     "out": got.float().numpy()}
    # the rank-level op under grad mode: its output and the gradients of
    # its rank's block (tests/test_torch_sp_backward.py holds the whole
    # gradients to JAX's); and under no_grad
    group = M.sp_group(mesh)
    q, k, v = (x.narrow(2, 8 * rank, 8).clone().requires_grad_()
               for x in _tensors(next(iter(cases.values()))))
    local = {"ring": ring_attention, "ulysses": ulysses_attention}[fn_name]
    o = local(q, k, v, group=group)
    (o ** 2).sum().backward()
    out["grad_mode"] = {"out": o.detach().numpy(),
                        "grads": [x.grad.numpy() for x in (q, k, v)]}
    with torch.no_grad():
        out["no_grad_runs"] = error_of(lambda: local(q, k, v, group=group))
    return out


def grad_cases(rank: int, cases: dict) -> dict:
    """Each case (q/k/v numpy arrays, ``sp``, the entry's name and keyword
    arguments) through ``ring_attention_sharded`` or
    ``ulysses_attention_sharded`` on an ``{"sp": sp}`` mesh over the first
    sp ranks: the whole output and the whole gradients of q, k and v of
    the loss ``(out ** 2).sum()`` (``out.sum()`` where ``loss == "sum"``),
    which every rank computes from the gathered output."""
    entries = {"ring": ring_attention_sharded,
               "ulysses": ulysses_attention_sharded}
    meshes = {sp: M.make_mesh({"sp": sp}, device_type="cpu")
              for sp in sorted({c["sp"] for c in cases.values()})}
    out: dict = {}
    for name, case in cases.items():
        if rank >= case["sp"]:
            continue
        q, k, v = (x.requires_grad_() for x in _tensors(case))
        got = entries[case["entry"]](meshes[case["sp"]], q, k, v,
                                     **case.get("kw", {}))
        loss = got.sum() if case.get("loss") == "sum" else (got ** 2).sum()
        loss.backward()
        out[name] = {"out": got.detach().numpy(),
                     "grads": [x.grad.numpy() for x in (q, k, v)]}
    return out


def serving_sp_cases(rank: int, inputs: dict) -> dict:
    """The sp cases of the JAX package's tests/test_serving_mesh.py
    (:153-210) on four ranks: ring admission on sp=2 x tp=2, the
    page_size refusal on sp=2, and Ulysses (its refusal at sp=4, a valid
    admission at sp=2); plus ring admission under a prefix cache,
    interleaved admission, a speculative draft, the int8 pool and chunked
    admission at sp=2 x tp=2."""
    cfg = tiny_config()
    full = params_from_jax(inputs["params"], cfg, device="cpu")
    geometry = dict(max_batch=2, n_pages=32, page_size=4, max_pages_per_seq=8)
    out: dict = {}

    mesh = M.make_mesh({"sp": 2, "tp": 2}, device_type="cpu")
    b = ContinuousBatcher(full, cfg, mesh=mesh, **geometry)
    r = b.submit(inputs["ring_prompt"], 5)
    b.run_to_completion()
    out["ring"] = {"results": [b.result(r)], "host": host_state(b),
                   "mesh_key": b._mesh_key,
                   "pool_shape": tuple(b.cache["k"].shape)}

    # the paths JAX runs under the same mesh: a prefix hit's windows, an
    # interleaved admission's windows, and a draft prefilled over sp
    b = ContinuousBatcher(full, cfg, mesh=mesh, prefix_cache=True,
                          **geometry)
    r1 = b.submit(inputs["ring_prompt"], 4)
    b.run_to_completion()
    r2 = b.submit(inputs["ring_prompt"][:17] + [3, 1], 4)
    r3 = b.submit(inputs["ulysses_prompt"], 4, interleave_admission=8)
    b.run_to_completion()
    out["prefix_interleaved"] = {
        "results": [b.result(r1), b.result(r2), b.result(r3)],
        "host": host_state(b)}
    dcfg = tiny_config(n_layers=1)
    draft = params_from_jax(inputs["draft_params"], dcfg, device="cpu")
    b = ContinuousBatcher(full, cfg, mesh=mesh, draft_params=draft,
                          draft_config=dcfg, gamma=3, **geometry)
    r = b.submit(inputs["ring_prompt"], 5)
    b.run_to_completion()
    out["speculative"] = {"results": [b.result(r)], "host": host_state(b)}
    # the int8 pool under sp (the gathered K/V quantized into it), and a
    # chunked admission, which ignores sp as JAX's prefill_chunked does
    cfg8 = tiny_config(kv_cache_dtype="int8")
    b = ContinuousBatcher(full, cfg8, mesh=mesh, **geometry)
    r1 = b.submit(inputs["ring_prompt"], 4)
    r2 = b.submit(inputs["ulysses_prompt"], 4, prefill_chunk=8)
    b.run_to_completion()
    out["int8_chunked"] = {"results": [b.result(r1), b.result(r2)],
                           "host": host_state(b)}

    # every rank builds each mesh; those over the first two ranks serve
    # on those two only (the others hold no coordinate of them)
    sp2 = M.make_mesh({"sp": 2, "tp": 1}, device_type="cpu")
    uly = tiny_config(sp_attention="ulysses")
    sp4 = M.make_mesh({"sp": 4, "tp": 1}, device_type="cpu")
    out["ulysses_error"] = error_of(lambda: ContinuousBatcher(
        full, uly, mesh=sp4, **geometry))
    if rank < 2:
        out["page_size_error"] = error_of(lambda: ContinuousBatcher(
            full, cfg, mesh=sp2, max_batch=2, n_pages=16, page_size=3,
            max_pages_per_seq=4))
        b = ContinuousBatcher(full, uly, mesh=sp2, **geometry)
        r = b.submit(inputs["ulysses_prompt"], 4)
        b.run_to_completion()
        out["ulysses"] = {"results": [b.result(r)], "host": host_state(b)}
    return out


def ulysses_cases(rank: int, cases: dict, forward_inputs: dict) -> dict:
    """``attention_cases`` of Ulysses, then the model-level switch
    (tests/test_ulysses.py:113): the same params and tokens through
    ``forward`` on an sp=2 x tp=2 mesh under ring and under Ulysses; the
    rank's block of positions of each."""
    out = attention_cases(rank, "ulysses", cases)
    cfg = tiny_config()
    mesh = M.make_mesh({"sp": 2, "tp": 2}, device_type="cpu")
    groups = M.serving_groups(mesh)
    full = params_from_jax(forward_inputs["params"], cfg, device="cpu")
    shard = T.shard_params(full, cfg, mesh)
    tokens = torch.as_tensor(forward_inputs["tokens"])
    out["forward"] = {
        name: T.forward(shard, tokens,
                        dataclasses.replace(cfg, sp_attention=name),
                        tp_group=groups.tp, sp_group=groups.sp).numpy()
        for name in ("ring", "ulysses")}
    out["sp_index"] = M.axis_index(mesh, "sp")
    return out
