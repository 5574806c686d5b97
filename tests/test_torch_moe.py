"""The port's Mixture-of-Experts (``models/moe.py`` and the MoE branch of
``models/transformer.py``) against the JAX package's on the same weights
and inputs, f32 on the CPU.

Checklist: the JAX package's tests/test_moe.py, every case but the mesh
train step (meshes are not ported), plus a zero router whose ties JAX
breaks to the lower expert index. Both of the port's expert forms run
every case: every expert on every token (decode-sized calls) and each
expert on its routed tokens (prefills, training). Routing must give the
same dispatch sets exactly; outputs agree within 1e-5 and the aux loss
within 1e-6 (XLA and PyTorch sum in different orders). Transformer-level
cases take tests/test_torch_training.py's tolerances. A second oracle:
``transformers.MixtralForCausalLM`` built in memory, against the dropless
per-token config."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bee_code_interpreter_tpu.models import moe as jax_moe
from bee_code_interpreter_tpu.models import transformer as jax_t
from bee_code_interpreter_tpu.ops.paged_kv_cache import (
    alloc_paged_cache as jax_alloc,
)
from bee_code_interpreter_tpu.ops.weight_quant import (
    quantize_weights as jax_quantize,
)
from bee_code_interpreter_tpu_torch.models import moe
from bee_code_interpreter_tpu_torch.models import transformer as torch_t
from bee_code_interpreter_tpu_torch.ops.weight_quant import (
    quantize_weights,
    quantized_nbytes,
)
from bee_code_interpreter_tpu_torch.utils.checkpoint import TrainCheckpointer

from tests.torch_parity import tiny_configs, tiny_params, to_np

OUT_TOL = 1e-5
AUX_TOL = 1e-6
# tests/test_torch_training.py's tolerances: losses and logits, gradients
TOL = 1e-5
GRAD_TOL = 1e-4
LOGIT_TOL = 1e-4
KV_TOL = 1e-5
MOE_KEYS = ("router", "we_gate", "we_up", "we_down")

# the JAX side compiled once per shape (op by op it compiles every op)
jax_route = jax.jit(jax_moe._route_group,
                    static_argnames=("n_experts", "top_k", "capacity"))
jax_moe_mlp = jax.jit(jax_moe.moe_mlp, static_argnames=(
    "n_experts", "top_k", "capacity_factor", "dtype", "group_size",
    "dropless"))
jax_forward = jax.jit(jax_t.forward, static_argnames=(
    "config", "mesh", "return_kv", "return_aux"))


@pytest.fixture(params=["every_expert", "routed"])
def form(request, monkeypatch):
    """Which of the port's two expert forms every call takes."""
    limit = 1 << 30 if request.param == "every_expert" else 0
    monkeypatch.setattr(moe, "EVERY_EXPERT_MAX_TOKENS", limit)
    return request.param


def moe_params(D, ff, E, seed=0):
    """JAX's ``init_moe_params`` weights, as (JAX dict, port dict)."""
    jp = jax_moe.init_moe_params(jax.random.PRNGKey(seed), D, ff, E)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def jax_x(shape, seed=1):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                      jnp.float32))


def port_dispatch(r: moe.Routing, E: int, C: int):
    """The port's routing as JAX's dispatch/combine ``[g, E, C]``."""
    expert, slot, keep, gate = (to_np(t) for t in (r.expert, r.slot, r.keep,
                                                   r.gate))
    dispatch = np.zeros(expert.shape[:1] + (E, C), np.float32)
    combine = np.zeros_like(dispatch)
    for t, j in zip(*np.nonzero(keep)):
        dispatch[t, expert[t, j], slot[t, j]] = 1.0
        combine[t, expert[t, j], slot[t, j]] = gate[t, j]
    return dispatch, combine


def assert_routing_equal(xf, jrouter, trouter, E, k, C):
    """One routing group: the same dispatch set exactly, combine weights
    and aux within tolerance; returns JAX's dispatch."""
    jd, jc, jaux = jax_route(jnp.asarray(xf), jrouter, n_experts=E, top_k=k,
                             capacity=C)
    r = moe._route_group(torch.from_numpy(xf) @ trouter, n_experts=E,
                         top_k=k, capacity=C)
    d, c = port_dispatch(r, E, C)
    np.testing.assert_array_equal(d, np.asarray(jd))
    np.testing.assert_allclose(c, np.asarray(jc), atol=AUX_TOL, rtol=AUX_TOL)
    np.testing.assert_allclose(r.aux.item(), float(jaux), atol=AUX_TOL,
                               rtol=AUX_TOL)
    return np.asarray(jd)


def check_moe_mlp(x, jp, tp, **kw):
    """``moe_mlp`` in both frameworks: the routing of every group equal,
    outputs and aux within tolerance. Returns the port's output."""
    E, k = kw["n_experts"], kw.get("top_k", 2)
    group_size = kw.get("group_size", 1024)
    G = x.shape[0] * x.shape[1]
    n_groups = max(1, G // group_size)
    if G % n_groups:
        n_groups = 1
    g = G // n_groups
    C = moe.expert_capacity(g, E, k, kw.get("capacity_factor", 1.25),
                            kw.get("dropless", False))
    for xs in x.reshape(n_groups, g, -1):
        assert_routing_equal(xs, jp["router"], tp["router"], E, k, C)
    want, want_aux = jax_moe_mlp(jp, jnp.asarray(x), dtype=jnp.float32, **kw)
    got, aux = moe.moe_mlp(tp, torch.from_numpy(x), dtype=torch.float32, **kw)
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=OUT_TOL,
                               rtol=OUT_TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=AUX_TOL,
                               rtol=AUX_TOL)
    return to_np(got)


# ------------------------------------------------------ moe_mlp (test_moe.py)


def test_single_expert_matches_dense_swiglu(form):
    jp, tp = moe_params(32, 64, 1)
    x = jax_x((2, 8, 32))
    got = check_moe_mlp(x, jp, tp, n_experts=1, top_k=1, capacity_factor=2.0)
    w = {k: np.asarray(v[0]) for k, v in jp.items() if k != "router"}
    gate, up = x @ w["we_gate"], x @ w["we_up"]
    dense = (gate / (1 + np.exp(-gate)) * up) @ w["we_down"]
    np.testing.assert_allclose(got, dense, atol=1e-5, rtol=1e-5)


def test_capacity_drops_overflow_tokens(form):
    jp, tp = moe_params(16, 32, 2)
    x = jax_x((1, 64, 16))
    got = check_moe_mlp(x, jp, tp, n_experts=2, top_k=1, capacity_factor=0.01)
    per_token = np.abs(got[0]).sum(axis=-1)
    assert moe.expert_capacity(64, 2, 1, 0.01) == 8
    nonzero = int((per_token > 0).sum())
    assert 0 < nonzero <= 2 * 8
    # a dropped token's output is exactly zero
    assert (per_token == 0).sum() == 64 - nonzero


def test_capacity_pressure_drops_choices(form):
    """tiny_moe widths, top-2 at factor 0.5: some choices get dropped."""
    jp, tp = moe_params(64, 128, 4)
    x = jax_x((2, 40, 64), seed=3)
    check_moe_mlp(x, jp, tp, n_experts=4, top_k=2, capacity_factor=0.5)
    C = moe.expert_capacity(80, 4, 2, 0.5)
    d = assert_routing_equal(x.reshape(80, 64), jp["router"], tp["router"],
                             4, 2, C)
    assert (d.sum(axis=(1, 2)) < 2).any()


@pytest.mark.parametrize("args,want", [
    ((128, 4, 2, 1.0), 64), ((10, 8, 1, 1.0), 8), ((1024, 8, 2, 1.25), 320),
    ((1, 8, 2, 1.25, True), 8), ((33, 4, 2, 1.25, True), 40),
    ((16384, 8, 2, 1.25), 5120), ((7, 3, 2, 0.3), 8),
])
def test_capacity_rounding(args, want):
    assert moe.expert_capacity(*args) == jax_moe.expert_capacity(*args) == want


@pytest.mark.parametrize("group_size", [32, 1 << 30, 48])
def test_grouped_routing_matches_jax(form, group_size):
    """Groups of 32 (four of them), one global group, and a size that does
    not divide the 128 tokens (one global group)."""
    jp, tp = moe_params(16, 32, 4)
    x = jax_x((2, 64, 16))
    check_moe_mlp(x, jp, tp, n_experts=4, top_k=2, capacity_factor=8.0,
                  group_size=group_size)


def test_grouped_routing_matches_single_group_with_ample_capacity(form):
    jp, tp = moe_params(16, 32, 4)
    x = torch.from_numpy(jax_x((2, 64, 16)))
    kw = dict(n_experts=4, top_k=2, capacity_factor=8.0, dtype=torch.float32)
    out_g, aux_g = moe.moe_mlp(tp, x, group_size=32, **kw)
    out_s, aux_s = moe.moe_mlp(tp, x, group_size=1 << 30, **kw)
    np.testing.assert_allclose(to_np(out_g), to_np(out_s), atol=1e-5, rtol=1e-5)
    assert 0.5 < aux_g.item() < 4 and 0.5 < aux_s.item() < 4


def test_dropless_capacity_never_drops():
    E, g, D = 4, 32, 16
    jp, tp = moe_params(D, 32, E)
    router = np.zeros((D, E), np.float32)
    router[:, 0] = 10.0  # every token's top-1 is expert 0
    xf = jax_x((1, g, D)).reshape(g, D)
    c_drop = moe.expert_capacity(g, E, 2, 1.25)
    c_free = moe.expert_capacity(g, E, 2, 1.25, dropless=True)
    assert c_free >= g
    d_drop = assert_routing_equal(xf, jnp.asarray(router),
                                  torch.from_numpy(router), E, 2, c_drop)
    d_free = assert_routing_equal(xf, jnp.asarray(router),
                                  torch.from_numpy(router), E, 2, c_free)
    assert (d_drop.sum(axis=(1, 2)) < 2).any()
    np.testing.assert_array_equal(d_free.sum(axis=(1, 2)), np.full(g, 2.0))


@pytest.mark.parametrize("E", [8, 64])
def test_zero_router_ties_go_to_the_lower_expert(form, E):
    """Every probability ties: JAX routes each token to experts 0 and 1
    (``lax.top_k``), so must the port (bare ``torch.topk`` does not)."""
    jp, tp = moe_params(16, 32, E)
    jp = {**jp, "router": jnp.zeros((16, E))}
    tp = {**tp, "router": torch.zeros(16, E)}
    x = jax_x((1, 16, 16), seed=4)
    r = moe._route_group(torch.from_numpy(x[0]) @ tp["router"], n_experts=E,
                         top_k=2, capacity=64)
    assert r.expert.tolist() == [[0, 1]] * 16
    check_moe_mlp(x, jp, tp, n_experts=E, top_k=2, dropless=True)
    check_moe_mlp(x, jp, tp, n_experts=E, top_k=2, capacity_factor=0.25)


def test_both_forms_agree_bitwise():
    """The decode form and the routed form on one input: the same f32
    sums of the same products."""
    jp, tp = moe_params(64, 128, 4)
    x = torch.from_numpy(jax_x((2, 40, 64), seed=5))
    outs = []
    for limit in (1 << 30, 0):
        moe.EVERY_EXPERT_MAX_TOKENS, saved = limit, moe.EVERY_EXPERT_MAX_TOKENS
        try:
            outs.append(moe.moe_mlp(tp, x, n_experts=4, dtype=torch.float32,
                                    capacity_factor=0.5))
        finally:
            moe.EVERY_EXPERT_MAX_TOKENS = saved
    torch.testing.assert_close(outs[0][0], outs[1][0], atol=1e-6, rtol=1e-6)
    assert outs[0][1].item() == outs[1][1].item()


# ----------------------------------------------------------- the transformer


def moe_configs(**kw):
    """tiny_moe (4 experts, top-2) with 2 KV heads, f32, as (JAX, port)."""
    return tiny_configs(n_experts=4, **kw)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = moe_configs()
    jparams, tparams = tiny_params(jcfg, tcfg)
    return jcfg, tcfg, jparams, tparams


def test_configs_match_jax():
    for name in ("tiny_moe", "mixtral_8x7b"):
        j = getattr(jax_t.TransformerConfig, name)()
        t = getattr(torch_t.TransformerConfig, name)()
        fields = [f.name for f in dataclasses.fields(j) if f.name != "dtype"]
        assert {f: getattr(t, f) for f in fields} == {
            f: getattr(j, f) for f in fields}
        assert t.moe_exact is j.moe_exact is False
    for dropless, group, exact in ((True, 1, True), (True, 2, False),
                                   (False, 1, False)):
        j = dataclasses.replace(jax_t.TransformerConfig.tiny_moe(),
                                moe_dropless=dropless, moe_group_size=group)
        t = dataclasses.replace(torch_t.TransformerConfig.tiny_moe(),
                                moe_dropless=dropless, moe_group_size=group)
        assert t.moe_exact is j.moe_exact is exact
    assert torch_t.TransformerConfig.tiny().moe_exact


def test_init_params_layout_matches_jax():
    jcfg, tcfg = moe_configs()
    jparams = jax.eval_shape(lambda k: jax_t.init_params(jcfg, k),
                             jax.random.PRNGKey(0))
    params = torch_t.init_params(tcfg, torch.Generator().manual_seed(0),
                                 device="cpu", dtype=torch.float32)
    layer = params["layers"][0]
    assert list(layer) == list(torch_t.layer_shapes(tcfg))
    assert set(layer) == set(jparams["layers"])
    for k in MOE_KEYS:
        assert tuple(layer["moe"][k].shape) == jparams["layers"]["moe"][k].shape[1:]
    leaves = torch_t.param_leaves(params)
    assert len(leaves) == 3 + tcfg.n_layers * 10
    assert torch_t.n_params(params) == sum(
        x.size for x in jax.tree.leaves(jparams))
    # normal / sqrt(fan_in): the down projection's fan-in is d_ff
    std = layer["moe"]["we_down"].std().item() * np.sqrt(tcfg.ff_dim)
    assert 0.9 < std < 1.1


def test_forward_and_aux_match_jax(models, form):
    jcfg, tcfg, jparams, tparams = models
    tokens = np.random.default_rng(1).integers(0, 256, (2, 13)).astype(np.int32)
    want, (wk, wv), want_aux = jax_forward(jparams, jnp.asarray(tokens), jcfg,
                                           return_kv=True, return_aux=True)
    got, (k, v), aux = torch_t.forward(tparams, torch.from_numpy(tokens), tcfg,
                                       return_kv=True, return_aux=True)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    np.testing.assert_allclose(to_np(k), np.asarray(wk), atol=KV_TOL, rtol=KV_TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=TOL, rtol=TOL)
    assert aux.item() > 0


def make_batch(seed=1, B=2, L=16):
    seq = np.random.default_rng(seed).integers(0, 256, (B, L + 1)).astype(np.int32)
    return {"tokens": seq[:, :-1], "targets": seq[:, 1:]}


def test_loss_and_every_gradient_match_jax(form):
    jcfg, tcfg = moe_configs(z_loss=1e-2, moe_aux_weight=0.5)
    jparams, tparams = tiny_params(jcfg, tcfg, requires_grad=True)
    batch = make_batch()
    want, jgrads = jax.jit(jax.value_and_grad(jax_t.loss_fn),
                           static_argnums=2)(
        jparams, {k: jnp.asarray(x) for k, x in batch.items()}, jcfg)
    loss = torch_t.loss_fn(tparams, {k: torch.from_numpy(x)
                                     for k, x in batch.items()}, tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), atol=TOL, rtol=TOL)
    pairs = [(n, jgrads[n], tparams[n]) for n in ("embed", "ln_f", "lm_head")]
    for i, layer in enumerate(tparams["layers"]):
        for name, w in layer.items():
            if name == "moe":
                pairs += [(f"{i}.moe.{k}", jgrads["layers"]["moe"][k][i],
                           w[k]) for k in MOE_KEYS]
            else:
                pairs.append((f"{i}.{name}", jgrads["layers"][name][i], w))
    assert len(pairs) == len(torch_t.param_leaves(tparams))
    for name, jg, w in pairs:
        jg = np.asarray(jg)
        scale = max(np.abs(jg).max(), 1e-6)
        np.testing.assert_allclose(to_np(w.grad), jg, atol=GRAD_TOL * scale,
                                   rtol=GRAD_TOL, err_msg=name)
    # the aux term reaches the router: its gradient moves with the weight
    router = [layer["moe"]["router"] for layer in tparams["layers"]]
    before = [r.grad.clone() for r in router]
    for r in router:
        r.grad = None
    torch_t.loss_fn(tparams, {k: torch.from_numpy(x) for k, x in batch.items()},
                    dataclasses.replace(tcfg, moe_aux_weight=0.0)).backward()
    assert all(not torch.allclose(a, r.grad) for a, r in zip(before, router))


def test_moe_aux_loss_feeds_training(models):
    jcfg, tcfg, jparams, tparams = models
    batch = {k: torch.from_numpy(x) for k, x in make_batch().items()}
    base = torch_t.loss_fn(tparams, batch, tcfg)
    heavier = torch_t.loss_fn(tparams, batch,
                              dataclasses.replace(tcfg, moe_aux_weight=1.0))
    assert heavier.item() > base.item()


def test_prefill_and_decode_logits_agree_dropfree(form):
    """JAX's own pin at ample capacity, port against JAX at every step."""
    jcfg, tcfg = moe_configs(moe_capacity_factor=8.0)
    jparams, tparams = tiny_params(jcfg, tcfg)
    tokens = np.random.default_rng(2).integers(0, 256, (2, 12)).astype(np.int32)
    full = to_np(torch_t.forward(tparams, torch.from_numpy(tokens), tcfg))
    _, (k_pre, v_pre) = torch_t.forward(tparams, torch.from_numpy(tokens[:, :8]),
                                        tcfg, return_kv=True)
    cache = torch_t.init_decode_cache(tcfg, 2, 12, k_pre, v_pre)
    _, (jk, jv) = jax_t.forward(jparams, jnp.asarray(tokens[:, :8]), jcfg,
                                return_kv=True)
    jcache = jax_t.init_decode_cache(jcfg, 2, 12, jk, jv)
    for pos in range(8, 12):
        step, cache = torch_t.decode_step(
            tparams, torch.from_numpy(tokens[:, pos:pos + 1]), pos, cache, tcfg)
        want, jcache = jax_t.decode_step(
            jparams, jnp.asarray(tokens[:, pos:pos + 1]), jnp.int32(pos),
            jcache, jcfg)
        np.testing.assert_allclose(to_np(step), np.asarray(want),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        np.testing.assert_allclose(to_np(step[:, 0]), full[:, pos], atol=1e-4,
                                   rtol=1e-4)


CHUNK_PROMPT = np.random.default_rng(7).integers(0, 256, (2, 13)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_chunked(models):
    """JAX's side of the chunked-prefill test, made once for both forms."""
    jcfg, _, jparams, _ = models
    logits, cache = jax_t.prefill_chunked(jparams, jnp.asarray(CHUNK_PROMPT),
                                          jcfg, total_len=20, chunk=5)
    streams = {
        chunk: np.asarray(jax_t.Transformer(jcfg).generate_cached(
            jparams, jnp.asarray(CHUNK_PROMPT), max_new_tokens=6,
            prefill_chunk=chunk)).tolist()
        for chunk in (None, 5)
    }
    return np.asarray(logits), np.asarray(cache["k"]), streams


def test_prefill_chunked_and_generate_cached_match_jax(models, jax_chunked,
                                                        form):
    """The chunked prefill (windows of 5 over a 13-token prompt: every
    chunk routes on its own) and greedy ``generate_cached`` through it
    and through the one-shot prefill."""
    _, tcfg, _, tparams = models
    want, want_k, streams = jax_chunked
    got, cache = torch_t.prefill_chunked(tparams, torch.from_numpy(CHUNK_PROMPT),
                                         tcfg, total_len=20, chunk=5)
    np.testing.assert_allclose(to_np(got), want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_allclose(to_np(cache["k"]), want_k, atol=KV_TOL,
                               rtol=KV_TOL)
    for chunk, want_tokens in streams.items():
        got = torch_t.Transformer(tcfg).generate_cached(
            tparams, torch.from_numpy(CHUNK_PROMPT), max_new_tokens=6,
            prefill_chunk=chunk)
        assert got.tolist() == want_tokens


def test_dropless_routing_is_batch_independent(form):
    """Per-token groups: a row's routing does not see its batch-mates, and
    in the every-expert form (decode-sized calls, where every expert's
    product has one row per token whatever routes where) nor do its
    outputs, bitwise. In the routed form an expert's product has as many
    rows as tokens chose it, so its GEMM, and with it the reduction order,
    changes with the batch: equal to reduction-order ulps, as a shared
    dropless group is."""
    for group_size, exact in ((1, True), (1024, False)):
        jcfg, tcfg = moe_configs(moe_dropless=True, moe_group_size=group_size)
        assert tcfg.moe_exact is exact
        jparams, tparams = tiny_params(jcfg, tcfg)
        toks = np.random.default_rng(3).integers(0, 256, (4, 6)).astype(np.int32)
        solo = torch_t.forward(tparams, torch.from_numpy(toks[:1]), tcfg)
        batch = torch_t.forward(tparams, torch.from_numpy(toks), tcfg)
        want = jax_t.forward(jparams, jnp.asarray(toks), jcfg)
        np.testing.assert_allclose(to_np(batch), np.asarray(want),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        if exact and form == "every_expert":
            assert torch.equal(solo[0], batch[0])
        else:
            np.testing.assert_allclose(to_np(solo[0]), to_np(batch[0]),
                                       atol=1e-5, rtol=1e-4)


def test_routing_pool_coupling_demonstrated(form):
    """tests/test_beam.py's proof, on the port: 16 identical decode rows
    at capacity factor 0.25 route differently by pool position, and the
    logits equal JAX's row for row."""
    jcfg, tcfg = moe_configs(moe_capacity_factor=0.25)
    jparams, tparams = tiny_params(jcfg, tcfg)
    prompt = np.random.default_rng(4).integers(0, 256, (1, 5)).astype(np.int32)
    _, (k_pre, v_pre) = torch_t.forward(tparams, torch.from_numpy(prompt), tcfg,
                                        return_kv=True)
    _, (jk, jv) = jax_t.forward(jparams, jnp.asarray(prompt), jcfg,
                                return_kv=True)
    W = 16
    cache = torch_t.init_decode_cache(tcfg, 1, 8, k_pre, v_pre)
    cache = {n: x.repeat_interleave(W, dim=1) for n, x in cache.items()}
    jcache = jax.tree.map(lambda x: jnp.repeat(x, W, axis=1),
                          jax_t.init_decode_cache(jcfg, 1, 8, jk, jv))
    tok = np.full((W, 1), 7, np.int32)
    got, _ = torch_t.decode_step(tparams, torch.from_numpy(tok), 5, cache, tcfg)
    want, _ = jax_t.decode_step(jparams, jnp.asarray(tok), jnp.int32(5), jcache,
                                jcfg)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    assert (got - got[:1]).abs().max().item() > 1e-3


def decode_case(jcfg, seed=2):
    rng = np.random.default_rng(seed)
    n_pages, ps, P, B = 14, 4, 3, 3
    shape = jax_alloc(jcfg, n_pages, ps)["k"].shape
    pool = {name: rng.standard_normal(shape, dtype=np.float32)
            for name in ("k", "v")}
    bt = (1 + rng.permutation(n_pages - 1)[: B * P]).reshape(B, P)
    return pool, bt.astype(np.int32)


@pytest.mark.parametrize("W,kernel", [(1, False), (1, True), (3, False)])
def test_paged_decode_matches_jax(models, form, W, kernel):
    """``decode_step_paged`` (einsum attention and the paged decode
    kernel's branch) and ``decode_window_paged`` at W = 3, MoE MLPs."""
    jcfg, tcfg, jparams, tparams = models
    jcfg = dataclasses.replace(jcfg, paged_attention_kernel=kernel)
    tcfg = dataclasses.replace(tcfg, paged_attention_kernel=kernel)
    pool, bt = decode_case(jcfg, seed=W)
    pos = np.asarray([3, 8, 0], dtype=np.int32)
    tokens = np.random.default_rng(5).integers(0, 256, (3, W)).astype(np.int32)
    fn_j = jax_t.decode_step_paged if W == 1 else jax_t.decode_window_paged
    fn_t = torch_t.decode_step_paged if W == 1 else torch_t.decode_window_paged
    want, want_pool = fn_j(jparams, jnp.asarray(tokens), jnp.asarray(pos),
                           {n: jnp.asarray(x) for n, x in pool.items()},
                           jnp.asarray(bt), jcfg)
    mine = {n: torch.from_numpy(x.copy()) for n, x in pool.items()}
    got, got_pool = fn_t(tparams, torch.from_numpy(tokens), torch.from_numpy(pos),
                         mine, torch.from_numpy(bt), tcfg)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(to_np(got_pool[name]),
                                   np.asarray(want_pool[name]), atol=KV_TOL,
                                   rtol=KV_TOL)


def test_three_train_steps_match_jax():
    """``make_train_step`` (AdamW) on tiny_moe: the losses of three steps
    within TOL, the expert weights within a tenth of the learning rate.
    AdamW's first step moves every weight by about lr whatever the size of
    its gradient, so a weight whose gradient is f32 noise (~1e-8, an expert
    row few tokens reach) moves by a fraction of lr that differs between
    the two frameworks' sums."""
    jcfg, tcfg = moe_configs()
    jparams, tparams = tiny_params(jcfg, tcfg, requires_grad=True)
    batch = make_batch(seed=7)
    jmodel, tmodel = jax_t.Transformer(jcfg), torch_t.Transformer(tcfg)
    jopt = jmodel.make_optimizer()
    jstep, jstate = jmodel.make_train_step(jopt), jopt.init(jparams)
    tstep, tstate = tmodel.make_train_step(), None
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    tb = {k: torch.from_numpy(x) for k, x in batch.items()}
    for _ in range(3):
        jparams, jstate, jloss = jstep(jparams, jstate, jb)
        tparams, tstate, tloss = tstep(tparams, tstate, tb)
        np.testing.assert_allclose(tloss.item(), float(jloss), atol=TOL,
                                   rtol=TOL)
    lr = tstate.param_groups[0]["lr"]
    for k in MOE_KEYS:
        for i, layer in enumerate(tparams["layers"]):
            np.testing.assert_allclose(
                to_np(layer["moe"][k]), np.asarray(jparams["layers"]["moe"][k][i]),
                atol=0.1 * lr, rtol=0)


def test_train_checkpointer_round_trips_moe_state(tmp_path):
    """An MoE train state, nested ``moe`` leaves and AdamW moments
    included, saved mid-run and restored gives the uninterrupted run's
    numbers bitwise."""
    _, tcfg = moe_configs()
    model = torch_t.Transformer(tcfg)
    batch = {k: torch.from_numpy(x) for k, x in make_batch(seed=8).items()}
    step = model.make_train_step()

    def fresh():
        return model.init(torch.Generator().manual_seed(3), device="cpu")

    straight, state = fresh(), None
    for _ in range(3):
        straight, state, _ = step(straight, state, batch)
    params, opt = fresh(), None
    params, opt, _ = step(params, opt, batch)
    ckpt = TrainCheckpointer(tmp_path / "ckpt")
    ckpt.save(1, {"params": params, "opt_state": opt.state_dict()})
    del params, opt
    restored = ckpt.restore()
    params = restored["params"]
    assert isinstance(params["layers"][0]["moe"], dict)
    assert all(w.requires_grad for w in torch_t.param_leaves(params))
    opt = model.make_optimizer()(params)
    opt.load_state_dict(restored["opt_state"])
    for _ in range(2):
        params, opt, _ = step(params, opt, batch)
    for a, b in zip(torch_t.param_leaves(params),
                    torch_t.param_leaves(straight)):
        assert torch.equal(a, b)


def test_quantize_weights_leaves_the_experts_alone(models):
    """Weight-only int8 on a tiny_moe tree: the dense projections' q/s
    bitwise JAX's, the MoE leaves the same tensors, the bytes counted."""
    jcfg, tcfg, jparams, tparams = models
    jq = jax_quantize(jparams)
    assert "moe" in jq["layers"] and not isinstance(
        jq["layers"]["moe"]["router"], dict)
    q = quantize_weights(tparams)
    for i, layer in enumerate(q["layers"]):
        assert layer["moe"] is tparams["layers"][i]["moe"]
        for name in ("wq", "wk", "wv", "wo"):
            for part in ("q", "s"):
                np.testing.assert_array_equal(
                    to_np(layer[name][part]),
                    np.asarray(jq["layers"][name][part][i]))
    np.testing.assert_array_equal(to_np(q["lm_head"]["q"]),
                                  np.asarray(jq["lm_head"]["q"]))
    assert quantized_nbytes(q) == sum(x.nbytes for x in jax.tree.leaves(jq))
    tokens = np.random.default_rng(6).integers(0, 256, (2, 9)).astype(np.int32)
    np.testing.assert_allclose(
        to_np(torch_t.forward(q, torch.from_numpy(tokens), tcfg)),
        np.asarray(jax_forward(jq, jnp.asarray(tokens), jcfg)),
        atol=LOGIT_TOL, rtol=LOGIT_TOL)


# ------------------------------------------------- second oracle: HF Mixtral


def test_dropless_forward_matches_transformers_mixtral():
    """A tiny ``transformers.MixtralForCausalLM`` (no download), its state
    dict mapped to the port's layout here: HF's dropless top-2 MoE is the
    port's ``moe_dropless`` + ``moe_group_size=1`` forward."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.MixtralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    model = transformers.MixtralForCausalLM(hf_cfg).eval()
    sd = {k: v.detach().float() for k, v in model.state_dict().items()}
    layers = []
    for i in range(2):
        p = f"model.layers.{i}"
        experts = [f"{p}.block_sparse_moe.experts.{e}" for e in range(4)]
        layers.append({
            "ln1": sd[f"{p}.input_layernorm.weight"],
            **{w: sd[f"{p}.self_attn.{w[1]}_proj.weight"].T.contiguous()
               for w in ("wq", "wk", "wv", "wo")},
            "ln2": sd[f"{p}.post_attention_layernorm.weight"],
            "moe": {
                "router": sd[f"{p}.block_sparse_moe.gate.weight"].T.contiguous(),
                **{name: torch.stack([sd[f"{e}.{w}.weight"].T for e in experts])
                   for name, w in (("we_gate", "w1"), ("we_up", "w3"),
                                   ("we_down", "w2"))},
            },
        })
    params = {"embed": sd["model.embed_tokens.weight"], "layers": layers,
              "ln_f": sd["model.norm.weight"],
              "lm_head": sd["lm_head.weight"].T.contiguous()}
    cfg = dataclasses.replace(
        torch_t.TransformerConfig.tiny_moe(), n_kv_heads=2, rope_theta=10000.0,
        moe_dropless=True, moe_group_size=1, dtype=torch.float32)
    tokens = np.random.default_rng(9).integers(0, 256, (2, 12))
    with torch.no_grad():
        want = model(torch.from_numpy(tokens)).logits
        got = torch_t.forward(params, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-4, rtol=1e-4)
