"""Rank functions of the tensor-parallel parity tests
(tests/test_torch_parallel_mesh.py, tests/test_torch_serving_mesh.py).

``parallel.spawn`` starts each rank as a fresh process that imports this
module by name, so it imports no JAX: the JAX side runs in the test
process, and the weights and inputs cross as numpy arrays. Each rank runs
every scenario of its file in one spawn and returns plain records (numpy
arrays, lists, strings) that the tests hold against the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from bee_code_interpreter_tpu_torch.models import transformer as T
from bee_code_interpreter_tpu_torch.models.engine import Engine
from bee_code_interpreter_tpu_torch.models.lora import make_lora_train_step
from bee_code_interpreter_tpu_torch.models.replicated import ReplicatedEngine
from bee_code_interpreter_tpu_torch.models.serving import (
    ContinuousBatcher,
    SamplingParams,
)
from bee_code_interpreter_tpu_torch.observability import (
    DeviceMonitor,
    ServingMonitor,
)
from bee_code_interpreter_tpu_torch.ops.paged_kv_cache import (
    alloc_paged_cache,
    seed_prefill,
)
from bee_code_interpreter_tpu_torch.parallel import mesh as M
from bee_code_interpreter_tpu_torch.utils.metrics import Registry
from bee_code_interpreter_tpu_torch.weights import params_from_jax

# several ranks share the CPU with the other test workers
torch.set_num_threads(1)

PROMPT = [5, 3, 7, 2, 9, 4, 1, 8]


def tiny_config(**kw) -> T.TransformerConfig:
    """The JAX tests' tiny decoder in f32 (4 heads over 2 KV heads)."""
    return dataclasses.replace(T.TransformerConfig.tiny(),
                               dtype=torch.float32, **{"n_kv_heads": 2, **kw})


@contextlib.contextmanager
def single_rank_mesh(axes: dict):
    """A CPU mesh over a group of one (this process), the group destroyed
    on exit."""
    try:
        yield M.make_mesh(axes, device_type="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def to_np(tree):
    """Tensors of a (nested) record as numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_np(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def host_state(b) -> dict:
    """The batcher bookkeeping ``tests/torch_parity.py::host_state``
    compares (that module imports JAX)."""
    return {
        "prefix_index": dict(b.prefix_index),
        "page_hash": dict(b.page_hash),
        "page_ref": b.page_ref.tolist(),
        "free_pages": list(b.free_pages),
        "evictable": list(b.evictable),
        "prefix_stats": dict(b.prefix_stats),
        "block_table": b.block_table.tolist(),
        "pos": b.pos.tolist(),
        "active": b.active.tolist(),
        "prefilling": sorted(b.prefill_state),
        "kv_telemetry": b.kv_telemetry(),
        "stats": b.stats,
    }


def error_of(call) -> tuple[str, str] | None:
    """(exception type, message) that ``call()`` raised, or None."""
    try:
        call()
    except Exception as e:  # noqa: BLE001 - the test reads the type
        return type(e).__name__, str(e)
    return None


def leaf_shapes(params) -> dict:
    """Each weight's shape, ``{q, s}`` leaves as two entries."""
    def flat(prefix, leaf):
        if isinstance(leaf, dict):
            return {f"{prefix}.{k}": tuple(v.shape) for k, v in leaf.items()}
        return {prefix: tuple(leaf.shape)}

    out = {}
    for name in ("embed", "ln_f", "lm_head"):
        out.update(flat(name, params[name]))
    for name, leaf in params["layers"][0].items():
        out.update(flat(f"layers.{name}", leaf))
    return out


# ------------------------------------------------------- parallel / model


def paged_decode_logits(params, cfg, tokens, feed, tp_group=None):
    """Prefill ``tokens`` [B, L] into a paged pool (pages of 4, rows on
    their own pages), then decode ``feed`` [B, n] teacher-forced with
    ``decode_step_paged``: the logits of every step [B, n, V]."""
    B, L = tokens.shape
    P = 8
    kvh = cfg.kv_heads // M.group_size(tp_group)
    pool = alloc_paged_cache(cfg, 1 + B * P, 4, "cpu", kv_heads=kvh)
    table = torch.as_tensor(1 + np.arange(B * P).reshape(B, P),
                            dtype=torch.int32)
    _, (k, v) = T.forward(params, tokens, cfg, return_kv=True,
                          tp_group=tp_group)
    for b in range(B):
        seed_prefill(pool, table[b, :-(-L // 4)], k[:, b], v[:, b])
    out = []
    pos = torch.full((B,), L, dtype=torch.int32)
    for s in range(feed.shape[1]):
        logits, pool = T.decode_step_paged(params, feed[:, s:s + 1], pos + s,
                                           pool, table, cfg,
                                           tp_group=tp_group)
        out.append(logits[:, 0])
    return torch.stack(out, dim=1)


def parallel_cases(rank: int, world: int, inputs: dict) -> dict:
    """The mesh helpers, ``shard_params`` and the tp model functions on
    this rank of a ``world``-rank CPU group."""
    out = {
        "initialized_again": M.initialize_distributed(device_type="cpu"),
        "world_size": M.world_size(),
        "local_device_count": M.local_device_count("cpu"),
    }
    mesh = M.make_mesh({"tp": world}, device_type="cpu")
    out["tp_key"] = M.mesh_shape_key(mesh)
    out["tp_descriptor"] = M.mesh_descriptor(mesh)
    out["batch_axes"] = M.batch_axes(mesh)
    out["too_big"] = error_of(
        lambda: M.make_mesh({"dp": 2 * world, "tp": 4}, device_type="cpu"))
    out["backend_mismatch"] = error_of(
        lambda: M.make_mesh({"tp": world}, device_type="cpu",
                            backend="nccl"))
    auto = M.auto_mesh(device_type="cpu")
    out["auto"] = (tuple(auto.mesh_dim_names), tuple(auto.mesh.shape))
    auto_sp = M.auto_mesh(sp=2, device_type="cpu")
    out["auto_sp"] = (tuple(auto_sp.mesh_dim_names),
                      tuple(auto_sp.mesh.shape))
    if world == 4:
        grid = M.make_mesh({"dp": 2, "tp": 2}, device_type="cpu")
        out["grid_key"] = M.mesh_shape_key(grid)
        out["grid_descriptor"] = M.mesh_descriptor(grid)
        out["grid_batch_axes"] = M.batch_axes(grid)
        sub = M.make_mesh({"tp": 2}, device_type="cpu")
        out["sub_descriptor"] = M.mesh_descriptor(sub)
    # collectives: the rank-major concatenation, and an exact f32 sum
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    out["gather_last"] = to_np(M.all_gather_cat(x, M.tp_group(mesh)))
    out["gather_first"] = to_np(M.all_gather_cat(x.to(torch.int8),
                                                 M.tp_group(mesh), dim=0))
    out["reduce_bf16"] = to_np(M.all_reduce_partial(
        torch.full((3,), 0.5 + rank, dtype=torch.bfloat16),
        M.tp_group(mesh)).float())

    cfg = tiny_config(n_kv_heads=4)
    g = M.tp_group(mesh)
    full = params_from_jax(inputs["params"], cfg, device="cpu")
    shard = T.shard_params(full, cfg, mesh)
    out["specs"] = T.param_specs(cfg, mesh)
    out["shard"] = to_np(shard)
    out["shard_shapes"] = leaf_shapes(shard)
    out["spec_shapes"] = {
        name: M.local_shape(shape, spec, mesh)
        for name, shape, spec in _spec_rows(full, out["specs"])
    }
    out["shard_via_loader"] = to_np(params_from_jax(inputs["params"], cfg,
                                                    mesh=mesh))
    q_full = params_from_jax(inputs["params_int8"], cfg, device="cpu")
    out["shard_int8"] = to_np(T.shard_params(q_full, cfg, mesh))
    out["own_storage"] = all(
        shard["layers"][0][k].untyped_storage().data_ptr()
        != full["layers"][0][k].untyped_storage().data_ptr()
        for k in ("wq", "ln1"))

    tokens = torch.as_tensor(inputs["tokens"])
    logits, (k, v) = T.forward(shard, tokens, cfg, return_kv=True,
                               tp_group=g)
    out["forward"] = to_np({"logits": logits, "k": k, "v": v})
    out["forward_int8"] = to_np(T.forward(T.shard_params(q_full, cfg, mesh),
                                          tokens, cfg, tp_group=g))
    feed = torch.as_tensor(inputs["feed"])
    out["paged"] = to_np(paged_decode_logits(shard, cfg, tokens, feed, g))
    out["paged_kernel_gate"] = to_np(paged_decode_logits(
        shard, dataclasses.replace(cfg, paged_attention_kernel=True), tokens,
        feed, g))
    last, cache = T.prefill_chunked(shard, tokens, cfg, tokens.shape[1] + 4,
                                    chunk=3, tp_group=g)
    out["chunked"] = to_np({"last": last, "k": cache["k"]})
    model = T.Transformer(cfg, mesh)
    out["generate_cached"] = to_np(model.generate_cached(
        shard, tokens, max_new_tokens=5))
    out["generate_cached_chunked"] = to_np(model.generate_cached(
        shard, tokens, max_new_tokens=5, prefill_chunk=3))
    out["generate_cached_int8_cache"] = to_np(T.Transformer(
        dataclasses.replace(cfg, kv_cache_dtype="int8"), mesh
    ).generate_cached(shard, tokens, max_new_tokens=5))
    out["generate"] = to_np(model.generate(shard, tokens, max_new_tokens=3))
    if world == 4:
        out.update(mesh_forward_cases(rank, inputs))
    return out


def mesh_forward_cases(rank: int, inputs: dict) -> dict:
    """Four ranks: the K/V broadcast to ``lcm(kv_heads, tp)`` heads
    (n_heads=8 over kv_heads=2 at tp=4), the sequence-parallel forward
    (ring and Ulysses, with and without a window, on sp=4 and sp=2 x
    tp=2) and Mixture-of-Experts layers over tp, ep and sp; each rank's
    logits (its block of positions under sp) and its K/V."""
    out = {}
    tokens = torch.as_tensor(inputs["sp_tokens"])
    cfg = tiny_config(n_heads=8)
    full = params_from_jax(inputs["params_h8"], cfg, device="cpu")
    mesh = M.make_mesh({"tp": 4}, device_type="cpu")
    shard = T.shard_params(full, cfg, mesh)
    logits, (k, v) = T.forward(shard, tokens, cfg, return_kv=True,
                               tp_group=M.tp_group(mesh))
    out["lcm"] = to_np({"logits": logits, "k": k, "v": v,
                        "wk_shape": tuple(shard["layers"][0]["wk"].shape)})

    cfg = tiny_config()
    full = params_from_jax(inputs["params_kv2"], cfg, device="cpu")
    for axes in ({"sp": 4}, {"sp": 2, "tp": 2}):
        mesh = M.make_mesh(axes, device_type="cpu")
        groups = M.serving_groups(mesh)
        shard = T.shard_params(full, cfg, mesh)
        key = M.mesh_shape_key(mesh)
        out[f"sp_index {key}"] = M.axis_index(mesh, "sp")
        for attn in ("ring", "ulysses"):
            for window in (None, 5):
                c = dataclasses.replace(cfg, sp_attention=attn,
                                        sliding_window=window)
                logits, (k, v) = T.forward(shard, tokens, c, return_kv=True,
                                           tp_group=groups.tp,
                                           sp_group=groups.sp)
                out[f"sp {key} {attn} {window}"] = to_np(
                    {"logits": logits, "k": k})
        # the generators under sp: the prompt (13 tokens) padded to a
        # multiple of sp for the prefill, decode steps ignoring sp
        model = T.Transformer(cfg, mesh)
        prompt = tokens[:, :13]
        out[f"sp_generate {key}"] = to_np({
            "cached": model.generate_cached(shard, prompt, max_new_tokens=5),
            "plain": model.generate(shard, prompt, max_new_tokens=3)})

    out.update(sp_padding_cases(tokens))
    mcfg = tiny_config(n_experts=4)
    mfull = params_from_jax(inputs["params_moe"], mcfg, device="cpu")
    for axes in ({"ep": 2, "tp": 2}, {"tp": 4}, {"ep": 4}, {"sp": 4},
                 {"sp": 2, "ep": 2}):
        mesh = M.make_mesh(axes, device_type="cpu")
        groups = M.serving_groups(mesh)
        shard = T.shard_params(mfull, mcfg, mesh)
        key = M.mesh_shape_key(mesh)
        logits, aux = T.forward(shard, tokens, mcfg, return_aux=True,
                                tp_group=groups.tp, sp_group=groups.sp,
                                ep_group=groups.ep)
        # the loader's shard of an MoE tree is shard_params'
        loaded = params_from_jax(inputs["params_moe"], mcfg, mesh=mesh)
        same = all(torch.equal(loaded["layers"][li]["moe"][n], leaf)
                   for li, layer in enumerate(shard["layers"])
                   for n, leaf in layer["moe"].items())
        out[f"moe {key}"] = to_np({
            "logits": logits, "aux": aux, "sp_index": M.axis_index(mesh, "sp"),
            "loader_equal": same,
            "shapes": {n: tuple(x.shape)
                       for n, x in shard["layers"][0]["moe"].items()}})
    return out


# ROADMAP Queue 3's capacity-routed MoE under sp with a prompt padded to sp
# (fixed): name -> (mesh axes, config overrides, prompt length)
SP_PADDING_CASES = {
    "capacity sp=4 L=13": ({"sp": 4}, dict(n_experts=4,
                                           moe_capacity_factor=0.5), 13),
    "capacity sp=4 L=12": ({"sp": 4}, dict(n_experts=4,
                                           moe_capacity_factor=0.5), 12),
    "default capacity sp=4 L=13": ({"sp": 4}, dict(n_experts=4), 13),
    "capacity sp=2 L=13": ({"sp": 2, "ep": 2},
                           dict(n_experts=4, moe_capacity_factor=0.5), 13),
    "dense sp=4 L=13": ({"sp": 4}, {}, 13),
    "moe_exact sp=4 L=13": ({"sp": 4}, dict(n_experts=4, moe_dropless=True,
                                            moe_group_size=1), 13),
}


def sp_padding_cases(tokens) -> dict:
    """``generate_cached`` of port params from seed 0 on each
    ``SP_PADDING_CASES`` mesh, and the same without a mesh: the pads that
    round the prompt up to a multiple of sp stay out of MoE routing."""
    out = {}
    for name, (axes, extra, L) in SP_PADDING_CASES.items():
        cfg = tiny_config(**extra)
        params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        mesh = M.make_mesh(axes, device_type="cpu")
        prompt = tokens[:, :L]
        out[f"sp_padding {name}"] = to_np({
            "mesh": T.Transformer(cfg, mesh).generate_cached(
                T.shard_params(params, cfg, mesh), prompt, max_new_tokens=6),
            "unsharded": T.Transformer(cfg).generate_cached(
                params, prompt, max_new_tokens=6)})
    return out


def _spec_rows(params, specs):
    """(name, full shape, spec) of the leaves ``leaf_shapes`` names."""
    rows = [(n, tuple(params[n].shape), specs[n])
            for n in ("embed", "ln_f", "lm_head")]
    rows += [(f"layers.{n}", tuple(leaf.shape), specs["layers"][n])
             for n, leaf in params["layers"][0].items()]
    return rows


def failing_rank(rank: int) -> int:
    """Raises on rank 1: ``spawn`` must fail the whole run."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank


def sleeping_rank(rank: int) -> int:
    """Outlasts any short ``spawn`` timeout."""
    time.sleep(120)
    return rank


# ---------------------------------------------------------------- serving


def _batcher(params, cfg, mesh, **kw):
    return ContinuousBatcher(params, cfg, mesh=mesh, **kw)


def engine_admission_fails_on_rank0(rank: int, inputs: dict) -> None:
    """An ``Engine`` over a tp=2 batcher whose admission raises on rank 0
    alone: rank 0 must raise out of the step, not fail the ticket and go
    on while rank 1 waits in the prefill's all-reduces."""
    mesh = M.make_mesh({"tp": 2}, device_type="cpu")
    cfg = tiny_config()
    b = _batcher(params_from_jax(inputs["params"], cfg, device="cpu"), cfg,
                 mesh, max_batch=2, n_pages=16, page_size=4,
                 max_pages_per_seq=4)
    if rank == 0:
        def fail(*args, **kwargs):
            raise RuntimeError("rank 0's admission fails on purpose")

        b._full_admit = fail
    engine = Engine(b)
    engine.submit(PROMPT, 4)
    engine.submit(PROMPT[:5], 4)
    engine.run_to_completion()


def serving_cases(rank: int, inputs: dict) -> dict:
    """Every tp case of the JAX package's tests/test_serving_mesh.py (its
    batchers at tp=2), the snapshot in both directions, a logprobs and a
    sampled request, the mesh key of the step records and the refusals."""
    mesh = M.make_mesh({"tp": 2}, device_type="cpu")
    cfg = tiny_config()
    full = params_from_jax(inputs["params"], cfg, device="cpu")
    out: dict = {}

    # :43, unsharded solo decode of two requests at once
    b = _batcher(full, cfg, mesh, max_batch=2, n_pages=16, page_size=4,
                 max_pages_per_seq=4)
    registry = Registry()
    device_monitor = DeviceMonitor(metrics=registry)
    device_monitor.attach(b)
    serving_monitor = ServingMonitor(metrics=registry)
    serving_monitor.attach(b)
    r1 = b.submit(PROMPT, 6)
    r2 = b.submit([1, 2, 3], 6)
    b.run_to_completion()
    out["two_requests"] = {
        "results": [b.result(r1), b.result(r2)],
        "host": host_state(b),
        "param_shapes": leaf_shapes(b.params),
        "pool_shape": tuple(b.cache["k"].shape),
        "mesh_key": b._mesh_key,
        "device_steps": device_monitor.snapshot()["steps"],
        "device_mesh": device_monitor.snapshot()["mesh"],
        "step_meshes": sorted({
            s["mesh"]
            for s in serving_monitor.snapshot(steps=256)["steps"]["last"]}),
    }

    # :63, the int8 pool and its scale planes
    cfg8 = tiny_config(kv_cache_dtype="int8")
    b = _batcher(full, cfg8, mesh, max_batch=2, n_pages=16, page_size=4,
                 max_pages_per_seq=4)
    r = b.submit(PROMPT, 5)
    b.run_to_completion()
    out["int8_pool"] = {"results": [b.result(r)], "host": host_state(b),
                        "pool_shapes": {k: tuple(x.shape)
                                        for k, x in b.cache.items()}}

    # :77, speculative decoding with a one-layer draft
    dcfg = tiny_config(n_layers=1)
    draft = params_from_jax(inputs["draft_params"], dcfg, device="cpu")
    b = _batcher(full, cfg, mesh, max_batch=2, n_pages=32, page_size=4,
                 max_pages_per_seq=6, draft_params=draft, draft_config=dcfg,
                 gamma=3)
    r = b.submit(PROMPT, 6)
    b.run_to_completion()
    out["speculative"] = {"results": [b.result(r)], "host": host_state(b),
                          "draft_pool_shape": tuple(b.draft_cache["k"].shape),
                          "draft_shapes": leaf_shapes(b.draft_params)}

    # :93, prefix-cached suffix admission on shared pages
    b = _batcher(full, cfg, mesh, max_batch=2, n_pages=32, page_size=4,
                 max_pages_per_seq=8, prefix_cache=True)
    p1, p2 = PROMPT + [1, 2], PROMPT + [3]
    r1 = b.submit(p1, 4)
    b.run_to_completion()
    r2 = b.submit(p2, 4)
    b.run_to_completion()
    out["prefix"] = {"results": [b.result(r1), b.result(r2)],
                     "host": host_state(b)}

    # :113, kv_heads that do not divide over tp
    cfg1 = tiny_config(n_kv_heads=1)
    out["kv_heads_error"] = error_of(lambda: _batcher(
        full, cfg1, mesh, max_batch=2, n_pages=16, page_size=4,
        max_pages_per_seq=4))

    # :125 and its reverse: a snapshot moves between topologies
    geometry = dict(max_batch=2, n_pages=16, page_size=4, max_pages_per_seq=4)
    a = ContinuousBatcher(full, cfg, device="cpu", **geometry)
    r = a.submit(PROMPT, 6)
    for _ in range(2):
        a.step()
    snap_one = a.state_dict()
    b = _batcher(full, cfg, mesh, **geometry)
    ptrs = {k: x.data_ptr() for k, x in b.cache.items()}
    b.load_state_dict(snap_one)
    b.run_to_completion()
    out["snapshot_to_tp"] = {
        "results": [b.result(r)], "host": host_state(b),
        "kept_storage": ptrs == {k: x.data_ptr() for k, x in b.cache.items()},
    }
    a = _batcher(full, cfg, mesh, **geometry)
    r = a.submit(PROMPT, 6)
    for _ in range(2):
        a.step()
    snap_tp = a.state_dict()
    b = ContinuousBatcher(full, cfg, device="cpu", **geometry)
    b.load_state_dict(snap_tp)
    b.run_to_completion()
    out["snapshot_from_tp"] = {"results": [b.result(r)], "host": host_state(b)}
    out["snapshot_pools"] = to_np({"one": snap_one["device"]["cache"],
                                   "tp": snap_tp["device"]["cache"]})

    # logprobs on a greedy row and a seeded sampled row
    b = _batcher(full, cfg, mesh, max_batch=2, n_pages=16, page_size=4,
                 max_pages_per_seq=4)
    r1 = b.submit(PROMPT, 6, sampling=SamplingParams(logprobs=True))
    r2 = b.submit([1, 2, 3], 6, sampling=SamplingParams(
        temperature=0.8, top_k=50, seed=7, logprobs=True))
    b.run_to_completion()
    out["sampling"] = {"results": [b.result(r1), b.result(r2)],
                       "logprobs": [b.result_logprobs(r1),
                                    b.result_logprobs(r2)],
                       "host": host_state(b)}

    # JAX's test_multilora_serving.py:254 at tp=2: the bank whole on each
    # rank, every attention projection targeted
    adapters = [{t: {k: torch.from_numpy(np.array(x)) for k, x in ab.items()}
                 for t, ab in a.items()} for a in inputs["adapters"]]
    b = _batcher(full, cfg, mesh, max_batch=3, n_pages=40, page_size=4,
                 max_pages_per_seq=8, adapters=adapters,
                 lora_scale=inputs["lora_scale"])
    rs = [b.submit(PROMPT, 5, adapter=0), b.submit([9, 8, 7], 5),
          b.submit([1, 2, 3, 4, 5], 5, adapter=1)]
    b.run_to_completion()
    out["lora_tp"] = {"results": [b.result(r) for r in rs],
                      "host": host_state(b)}

    # Mixture-of-Experts: dropless per-token routing (moe_exact) at tp=2 and
    # at ep=2, capacity routing at tp=2
    for name, axes, extra in (
        ("moe_exact_tp", {"tp": 2}, dict(moe_dropless=True, moe_group_size=1)),
        ("moe_exact_ep", {"ep": 2}, dict(moe_dropless=True, moe_group_size=1)),
        ("moe_capacity_tp", {"tp": 2}, dict(moe_capacity_factor=0.25)),
    ):
        mcfg = tiny_config(n_experts=4, **extra)
        mfull = params_from_jax(inputs["moe_params"], mcfg, device="cpu")
        b = _batcher(mfull, mcfg, M.make_mesh(axes, device_type="cpu"),
                     max_batch=4, n_pages=40, page_size=4,
                     max_pages_per_seq=8)
        rs = [b.submit(p, 6) for p in inputs["moe_prompts"]]
        b.run_to_completion()
        out[name] = {"results": [b.result(r) for r in rs],
                     "host": host_state(b),
                     "moe_shapes": {k: tuple(x.shape) for k, x in
                                    b.params["layers"][0]["moe"].items()}}

    # what one batcher does not serve over, and what is not ported yet; the
    # training entry points under tp (tests/test_torch_train_mesh.py) and a
    # model over pp (tests/test_torch_pipeline_transformer.py) now build
    dp_mesh = M.make_mesh({"dp": 2, "tp": 1}, device_type="cpu")
    fsdp_mesh = M.make_mesh({"fsdp": 2}, device_type="cpu")
    pp_mesh = M.make_mesh({"pp": 2}, device_type="cpu")
    kw = dict(max_batch=2, n_pages=16, page_size=4, max_pages_per_seq=4)
    out["refusals"] = {
        "dp": error_of(lambda: _batcher(full, cfg, dp_mesh, **kw)),
        "fsdp": error_of(lambda: _batcher(full, cfg, fsdp_mesh, **kw)),
        "pp": error_of(lambda: _batcher(full, cfg, pp_mesh, **kw)),
        "replicas_over_a_tp_mesh": error_of(lambda: ReplicatedEngine.build(
            full, cfg, 1, meshes=mesh, **kw)),
    }
    out["ported"] = {
        "train_step": callable(T.Transformer(cfg, mesh).make_train_step()),
        "init": T.Transformer(cfg, mesh).init(
            torch.Generator(), device="cpu")["layers"][0]["wq"].requires_grad,
        "lora_train_step": callable(
            make_lora_train_step(cfg, mesh=mesh)[0]),
        "pp_model": callable(T.Transformer(cfg, pp_mesh).make_train_step(
            n_microbatches=2)),
    }
    return out


# ------------------------------------------------------- dp x tp replicas


REPLICA_GEOMETRY = dict(max_batch=2, n_pages=24, page_size=4,
                        max_pages_per_seq=6)


def _replicated_scenarios(build) -> dict:
    """JAX's tests/test_replicated.py scenarios, on the surface
    ``ReplicatedEngine`` gives rank 0 (``build(**kw)`` makes one, on every
    rank)."""
    out = {}

    def serve(name, scenario, **kw):
        eng = build(**kw)
        if not eng.is_front_end:
            eng.follow()
            return
        with eng:
            out[name] = scenario(eng)
            out[name]["exchanges"] = len(eng.rounds.exchange_ms)

    def dp_times_tp(eng):
        p1, p2 = [5, 3, 7, 2, 9, 4, 1, 8], [1, 2, 3]
        t1, t2 = eng.submit(p1, 5), eng.submit(p2, 5)
        eng.run_to_completion()
        return {"results": [eng.result(t1), eng.result(t2)],
                "replicas": [eng.replica_of(t1), eng.replica_of(t2)]}

    def spread(eng):
        prompts = [[int(x) for x in
                    np.random.default_rng(i).integers(0, 200, 4 + i)]
                   for i in range(6)]
        tickets = [eng.submit(p, 4) for p in prompts]
        eng.run_to_completion()
        return {"replicas": [eng.replica_of(t) for t in tickets],
                "results": [eng.result(t) for t in tickets],
                "finish": [eng.finish_reason(t) for t in tickets],
                "stats": eng.stats}

    def affinity(eng):
        prompt = [7] * 9
        t1 = eng.submit(prompt, 3)
        eng.run_to_completion()
        t2 = eng.submit(prompt, 3)
        eng.run_to_completion()
        return {"replicas": [eng.replica_of(t1), eng.replica_of(t2)],
                "results": [eng.result(t1), eng.result(t2)],
                "stats": eng.stats}

    def streaming_and_cancel(eng):
        t = eng.submit([5, 3, 7, 2], 6)
        seen: list[int] = []
        for _ in range(60):
            eng.step()
            seen += eng.new_tokens(t)
            if eng.is_done(t):
                break
        seen += eng.new_tokens(t)
        rec = {"seen": seen, "result": eng.result(t)}
        t2 = eng.submit([1, 2, 3], 15)
        rec["queued"] = [error_of(lambda: eng.result(t2)),
                         error_of(lambda: eng.release(t2)),
                         eng.partial_result(t2), eng.is_done(t2)]
        eng.step()
        eng.cancel(t2)
        eng.run_to_completion()
        rec.update(finish=eng.finish_reason(t2), partial=eng.result(t2))
        eng.release(t2)
        rec["released"] = error_of(lambda: eng.result(t2))
        rec["replica"] = eng.replica_of(t)
        rec["stats"] = eng.stats
        return rec

    def full_queue(eng):
        t1 = eng.submit([1, 2, 3], 3)
        t2 = eng.submit([1, 2, 3], 3)
        rec = {"replicas": [eng.replica_of(t1), eng.replica_of(t2)],
               "third": error_of(lambda: eng.submit([1, 2, 3], 3))}
        eng.run_to_completion()
        rec.update(results=[eng.result(t1), eng.result(t2)],
                   stats=eng.stats)
        return rec

    def logprobs(eng):
        tickets = [eng.submit(p, 5, sampling=SamplingParams(logprobs=True))
                   for p in ([5, 3, 7, 2, 9], [1, 2, 3], [4, 4, 4, 4])]
        rec = {"validation": error_of(lambda: eng.submit([1, 2, 3], 99))}
        eng.run_to_completion()
        rec.update(results=[eng.result(t) for t in tickets],
                   logprobs=[eng.result_logprobs(t) for t in tickets],
                   errors=[eng.ticket_error(t) for t in tickets],
                   replicas=[eng.replica_of(t) for t in tickets])
        return rec

    serve("dp_times_tp", dp_times_tp)
    serve("spread", spread)
    serve("affinity", affinity, prefix_affinity=True, prefix_cache=True)
    serve("streaming_and_cancel", streaming_and_cancel)
    serve("full_queue", full_queue, max_queue=1)
    serve("logprobs", logprobs)
    return out


def replicated_cases(rank: int, inputs: dict) -> dict:
    """Four ranks as 2 replicas x tp=2 (``ReplicatedEngine.build(meshes=
    ...)``): rank 0 runs JAX's replicated scenarios through the front end,
    the others follow; rank 0's records, and what each rank's replica
    is."""
    cfg = tiny_config()
    full = params_from_jax(inputs["params"], cfg, device="cpu")
    mesh = M.make_mesh({"dp": 2, "tp": 2}, device_type="cpu")

    def build(**kw):
        return ReplicatedEngine.build(full, cfg, 2, meshes=mesh,
                                      **{**REPLICA_GEOMETRY, **kw})

    out = _replicated_scenarios(build)
    eng = build()
    out["placement"] = {
        "replica": eng.rounds.replica, "is_leader": eng.rounds.is_leader,
        "front": eng.is_front_end,
        "tp_rank": M.axis_index(M.replica_mesh(mesh), "tp"),
        "pool_heads": tuple(eng.rounds.engine.batcher.cache["k"].shape)[2],
        "wq_shape": tuple(
            eng.rounds.engine.batcher.params["layers"][0]["wq"].shape),
        "follower_refuses": None if eng.is_front_end else error_of(
            lambda: eng.submit([1, 2, 3], 2)),
        "wrong_dp": error_of(lambda: ReplicatedEngine.build(
            full, cfg, 3, meshes=mesh, **REPLICA_GEOMETRY)),
    }
    if eng.is_front_end:
        eng.close()
    else:
        eng.follow()
    return out
